"""One whole time step of the port against the JAX Simulation, on CPU.

The flagship blowout-wake deck (``__graft_entry__._DECK``) at 63^2 x 16
runs one step through hipace_tpu (XLA scatter/gather paths, x64) and,
from the same carried-over beam state (``hipace_tpu_torch.convert``),
through hipace_tpu_torch on CPU tensors, i.e. through the plain versions
of K1-K3. Every slice's fields, the re-binned beam and the multigrid
V-cycle count of every slice must agree. Also: the port never imports
jax, accepts the TPU tuning keys as no-ops and refuses keys it lacks.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import hipace_tpu.fields.multigrid as jmg
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from hipace_tpu_torch.pipeline.step import DIAG_COMPS

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = __graft_entry__._DECK.format(nxy=63, nz=16, npart=4000) \
    + "hipace.use_banded = 0\n"

# Fields: float64 roundoff through 16 slices of a blowout (the port fuses
# the Sx/Sy deposit that the JAX scatter path does per stencil, and sums
# in another order); measured ~1e-14, so 1e-10 leaves four decades.
FIELD_RTOL = 1e-10
BEAM_RTOL = 1e-12


def _counting_solve(cycles):
    """The XLA branch of hipace_tpu's MultiGrid.solve with its V-cycle
    count sent to the host (that solve keeps the count inside a
    while_loop)."""
    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2, fused=None):
        acfs = self._coarsen_acf(acf)
        res0 = jnp.max(jnp.abs(rhs - self.apply_op(u0, acfs[0], 0)))
        target = jnp.maximum(tol_abs, jnp.maximum(tol_rel, 1e-16)
                             * jnp.maximum(res0, jnp.max(jnp.abs(rhs))))

        def body(c):
            u, _, it = c
            u = self._vcycle(u, rhs, acfs, 0, nu1, nu2)
            return (u, jnp.max(jnp.abs(rhs - self.apply_op(u, acfs[0], 0))),
                    it + 1)

        u, _, it = jax.lax.while_loop(
            lambda c: (c[1] > target) & (c[2] < max_iters), body,
            (u0, res0, jnp.zeros((), jnp.int32)))
        jax.debug.callback(lambda n: cycles.append(int(n)), it, ordered=True)
        return u
    return solve


@pytest.fixture(scope="module")
def step_pair():
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(DECK), verbose=0)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(DECK), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time,
                [b.total_charge for b in jsim.beam_cfgs])
    tres = tsim.run_step(0)
    # a second step from each package's own pushed beam
    jsim.binned, jsim.time = jres["binned"], jsim.time + jsim.dt
    jres2 = jsim.run_step(1)
    tsim.binned, tsim.time = tres["binned"], tsim.time + tsim.dt
    tres2 = tsim.run_step(1)
    return jres, tres, cycles, jres2, tres2


def test_counting_solve_is_the_xla_solve():
    mg = jmg.MultiGrid(31, 31, 0.1, 0.1, jnp.float64)
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((2, 31, 31)))
    acf = jnp.asarray(np.abs(rng.standard_normal((31, 31))))
    cycles = []
    got = _counting_solve(cycles)(mg, jnp.zeros_like(rhs), rhs, acf)
    jax.effects_barrier()
    ref = mg.solve(jnp.zeros_like(rhs), rhs, acf, fused=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert len(cycles) == 1 and cycles[0] > 0


@pytest.mark.parametrize("comp", DIAG_COMPS)
def test_slice_fields_match(step_pair, comp):
    jres, tres = step_pair[:2]
    i = DIAG_COMPS.index(comp)
    ref = np.asarray(jres["diag"])[:, i]
    got = tres["diag"][:, i].numpy()
    assert got.shape == ref.shape == (16, 63, 63)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=FIELD_RTOL * max(np.abs(ref).max(),
                                                     1e-300))


@pytest.mark.parametrize("step", [0, 1])
def test_rebinned_beam_matches(step_pair, step):
    jres, tres = step_pair[3:] if step else step_pair[:2]
    jb, tb = jres["binned"], tres["binned"]
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    assert valid.sum() > 3000
    for k in ("nsub", "beam_id"):
        np.testing.assert_array_equal(tb[k].numpy()[valid],
                                      np.asarray(jb[k])[valid])
    for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
        ref = np.asarray(jb[k])[valid]
        np.testing.assert_allclose(tb[k].numpy()[valid], ref, rtol=0,
                                   atol=BEAM_RTOL * np.abs(ref).max())
    assert tb["n_dropped"] == int(jb["n_dropped"])


def test_multigrid_cycles_match(step_pair):
    _, tres, cycles, _, tres2 = step_pair
    assert len(cycles) == 32
    assert tres["mg_cycles"] + tres2["mg_cycles"] == cycles


def test_second_step_fields_match(step_pair):
    jres, tres = step_pair[3:]
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    for i, comp in enumerate(DIAG_COMPS):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))


SI_DECK = """
amr.n_cell = 31 31 8
my_constants.ne = 1.25e24
my_constants.wp = sqrt(ne * q_e^2 / (epsilon0 * m_e))
my_constants.kp_inv = clight / wp
max_step = 0
hipace.dt = 20. / wp
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -4.*kp_inv -4.*kp_inv -6.*kp_inv
geometry.prob_hi =  4.*kp_inv  4.*kp_inv  2.*kp_inv
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 2000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.*kp_inv
beam.position_std = 0.3*kp_inv 0.3*kp_inv 1.41*kp_inv
beam.density = 3.*ne
beam.u_mean = 0. 0. 2000.
plasmas.names = plasma
plasma.density(x,y,z) = ne
plasma.ppc = 1 1
diagnostic.output_period = 0
"""


def test_si_units_step_matches():
    """The same blowout in SI units: constants, volumes and the u*c
    momentum scaling take the non-normalized branches."""
    jsim = JSimulation(Inputs(SI_DECK), verbose=0)
    jres = jsim.run_step(0)
    tsim = Simulation(TInputs(SI_DECK), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time,
                [b.total_charge for b in jsim.beam_cfgs])
    tres = tsim.run_step(0)
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    for i, comp in enumerate(DIAG_COMPS):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))
    valid = np.asarray(jres["binned"]["valid"])
    np.testing.assert_array_equal(tres["binned"]["valid"].numpy(), valid)
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        ref_k = np.asarray(jres["binned"][k])[valid]
        np.testing.assert_allclose(tres["binned"][k].numpy()[valid], ref_k,
                                   rtol=0, atol=BEAM_RTOL
                                   * np.abs(ref_k).max())


def _small(extra=""):
    return TInputs(__graft_entry__._DECK.format(nxy=31, nz=8, npart=1000)
                   + extra)


def test_tpu_tuning_keys_are_noops():
    keys = ("hipace.use_banded = 1\nhipace.banded_W = 16\n"
            "hipace.banded_K = 256\nhipace.banded_gather_K = 256\n"
            "hipace.banded_WX = 64\nhipace.banded_backend = pallas\n"
            "hipace.banded_sort_period = 2\nhipace.pallas_S = 256\n"
            "hipace.pallas_WXS = 256\nhipace.pallas_h = 4\n"
            "hipace.pallas_precision = bf16\nhipace.beam_pallas_W = 32\n"
            "hipace.beam_pallas_h = 8\nhipace.beam_chunk = 128\n"
            "hipace.beam_buckets = 2\n")
    ref = Simulation(_small(), device="cpu", verbose=0).run_step(0)
    got = Simulation(_small(keys), device="cpu", verbose=0).run_step(0)
    assert torch.equal(ref["diag"], got["diag"])
    for k in ("x", "uz", "valid"):
        assert torch.equal(ref["binned"][k], got["binned"][k])


# the decks each refused with SALAME's or mesh refinement's queue item until
# both were ported: the port now does with each what the JAX package does
# (amr.max_level without mr_lev1.* is a missing key in both)
FORMER_REFUSALS = [
    "plasma.ionization_product = ions\namr.max_level = 1",
    "hipace.max_time = 10.\nhipace.collisions = c1\namr.max_level = 1",
    "lasers.names = laser\namr.max_level = 1",
    "amr.max_level = 1",
    "beam.do_salame = 1",
    "plasma.initial_ion_level = 1\nbeam.do_salame = 1",
    "hipace.collisions = c1\nc1.species = plasma plasma\n"
    "beam.do_salame = 1",
    "plasma.fine_ppc = 2 2",
    "hipace.dt = adaptive\nbeam.do_salame = 1",
    "plasma.fine_patch(x,y) = x*x + y*y < 1.",
    "plasma.fine_transition_cells = 5",
    "plasma.can_ionize = 1\namr.max_level = 1",
    "lasers.names = laser1 laser2\nplasma.can_ionize = 1\n"
    "beam.do_salame = 1",
]
# collisions in normalized units without hipace.background_density_SI: the
# JAX package constructs and its collisions divide by a zero plasma
# frequency; the port refuses at construction (test_torch_collisions.py::
# test_normalized_collisions_need_the_background_density)
PORT_REFUSES = {FORMER_REFUSALS[6]: ValueError}


@pytest.mark.parametrize("extra", FORMER_REFUSALS)
def test_unsupported_keys_raise(extra):
    """Each deck that a refusal once named: the port constructs where the
    JAX package constructs and raises the JAX package's exception type
    where it raises."""
    def outcome(make):
        try:
            make()
        except Exception as exc:      # noqa: BLE001 - compared by type
            return type(exc)
        return None

    deck = __graft_entry__._DECK.format(nxy=31, nz=8, npart=1000) + extra
    ref = outcome(lambda: JSimulation(Inputs(deck + "\n"), verbose=0))
    got = outcome(lambda: Simulation(TInputs(deck + "\n"), device="cpu",
                                     verbose=0))
    assert got == PORT_REFUSES.get(extra, ref), (got, ref)
    assert got is not NotImplementedError


def test_port_never_imports_jax(tmp_path):
    """Importing the port, the CLI and a CPU step leave jax unimported."""
    deck = tmp_path / "deck"
    deck.write_text(__graft_entry__._DECK.format(nxy=15, nz=4, npart=200))
    code = (
        "import sys\n"
        "from hipace_tpu_torch.__main__ import main\n"
        f"assert main([{str(deck)!r}, 'hipace.verbose=0', '--device', "
        "'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert "Finished Evolve" in out.stdout
