"""The predictor-corrector Bx/By solver, open boundaries, the MG and
periodic Poisson solvers, fields.do_symmetrize and
hipace.do_beam_jz_minus_rho through the port, against the JAX package on
CPU in float64.

The temporary plasma push is held to the JAX function at 1e-12 relative to
the largest value (the same float64 expressions, as in
test_torch_modules.py). One predictor-corrector solve and whole time steps
are held at 1e-10 relative to each field's largest value (float64 roundoff
through up to 30 iterations per slice and the slices after them; measured
~1e-13), with equal iteration counts on every slice and equal multigrid
V-cycle counts where the explicit solver runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
import hipace_tpu.pipeline.step as jstep
from hipace_tpu.fields.open_boundary import OpenBoundary as JOpenBoundary
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import plasma as jpl
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import BLOWOUT_WAKE, PC_OPEN
from hipace_tpu_torch.fields.open_boundary import OpenBoundary
from hipace_tpu_torch.fields.poisson import make_poisson_solver
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline import step as tstep
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_modules import (GEOM, PC, TGEOM, TPC, _close, _fields,
                                _plasma_state, _to_torch)
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
FIELD_RTOL = 1e-10
BEAM_RTOL = 1e-12
NO_BANDED = "hipace.use_banded = 0\n"
# a slower beam, so that its rho - jz/c is ~1e-3 of its charge density
SLOW_BEAM = "beam.u_mean = 0. 0. 20.\n"

# name: (base deck, deck lines); 31^2 x 8 unless the lines say otherwise
STEP_CASES = {
    "pc open": (PC_OPEN, ""),
    "pc dirichlet even 32^2": (PC_OPEN, "boundary.field = Dirichlet\n"
                               "amr.n_cell = 32 32 8\n"),
    "pc mg dirichlet": (PC_OPEN, "fields.poisson_solver = MGDirichlet\n"),
    "pc fft periodic": (PC_OPEN, "boundary.field = Periodic\n"
                        "boundary.particle = Periodic\n"
                        "fields.poisson_solver = FFTPeriodic\n"),
    "explicit open": (BLOWOUT_WAKE, "boundary.field = Open\n"),
    "explicit symmetrize": (BLOWOUT_WAKE, "fields.do_symmetrize = 1\n"),
    "explicit jz minus rho": (BLOWOUT_WAKE, SLOW_BEAM
                              + "hipace.do_beam_jz_minus_rho = 1\n"),
    "pc jz minus rho": (PC_OPEN, SLOW_BEAM
                        + "hipace.do_beam_jz_minus_rho = 1\n"),
}


# ---------------------------------------------------------------- the push
@pytest.mark.parametrize("n_subcycles", [1, 2])
def test_advance_plasma_temp_slice(n_subcycles):
    """The trial push: every subcycle gathers at the unchanged x_prev/y_prev
    and the half-step state comes back as it went in."""
    jcfg, tcfg, p = _plasma_state(21)
    jcfg = dataclasses.replace(jcfg, n_subcycles=n_subcycles)
    tcfg = dataclasses.replace(tcfg, n_subcycles=n_subcycles)
    f = _fields(22, ("Psi", "Ez", "Bx", "By", "Bz"))
    ref = jpl.advance_plasma({k: jnp.asarray(v) for k, v in p.items()},
                             {k: jnp.asarray(v) for k, v in f.items()},
                             GEOM, jcfg, PC, temp_slice=True, order=2)
    tp = _to_torch(p)
    got = tpl.advance_plasma(tp, {k: torch.tensor(v) for k, v in f.items()},
                             TGEOM, tcfg, TPC, order=2, temp_slice=True)
    v = p["valid"]
    for k in got:
        _close(got[k].numpy()[v].astype(np.float64),
               np.asarray(ref[k])[v].astype(np.float64))
    for k in ("x_prev", "y_prev", "ux_half", "uy_half", "psi_half"):
        assert got[k] is tp[k]
    assert not np.array_equal(got["x"].numpy()[v], p["x_prev"][v])
    # the full push from the same state moves the half-step state
    full = tpl.advance_plasma(tp, {k: torch.tensor(v) for k, v in f.items()},
                              TGEOM, tcfg, TPC, order=2)
    assert torch.equal(full["x"], got["x"]) == (n_subcycles == 1)
    assert not torch.equal(full["ux_half"], tp["ux_half"])


# ---------------------------------------------------------------- one solve
@pytest.fixture(scope="module")
def pc_pair():
    """One pc_bxby_solve of each package on the same fields, plasma and
    beam slice: a 31^2 x 8 PC_OPEN deck's configs, its first beam slice as
    the Next slice, random This/Previous/PCPrevIter fields."""
    deck = PC_OPEN.format(nxy=31, nz=8, npart=1000) + NO_BANDED
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    jcfg, tcfg = jsim.cfg, tsim.cfg
    g = jcfg.geom
    rng = np.random.default_rng(23)

    def plane(scale):
        return scale * rng.standard_normal(g.slice_shape)

    f = {"This": {c: plane(0.1) for c in tstep.THIS_COMPS_PC},
         "Previous": {c: plane(0.1) for c in ("Bx", "By", "jx", "jy")},
         "PCPrevIter": {c: plane(0.1) for c in ("Bx", "By")}}
    p = {k: np.array(v) for k, v in jpl.init_plasma(
        jcfg.plasmas[0], g, jax.random.PRNGKey(0), jnp.float64).items()}
    p["x"] = np.clip(p["x"] + 0.1 * rng.standard_normal(p["x"].size),
                     g.prob_lo[0], g.prob_hi[0])
    p["ux_half"] = 0.1 * rng.standard_normal(p["x"].size)
    isl = int(np.argmax(np.asarray(jsim.binned["valid"]).sum(axis=1)))
    beam = {k: np.array(v[isl]) for k, v in jsim.binned.items()
            if k != "n_dropped"}
    jf = {s: {c: jnp.asarray(v) for c, v in d.items()} for s, d in f.items()}
    jres, jerr, jit = jstep._pc_bxby_solve(
        jf, [{k: jnp.asarray(v) for k, v in p.items()}],
        {k: jnp.asarray(v) for k, v in beam.items()}, jcfg,
        jstep.make_poisson_solver(jcfg.poisson_solver, g, jnp.float64),
        JOpenBoundary(g, jnp.float64))
    tf = {s: {c: torch.tensor(v) for c, v in d.items()} for s, d in f.items()}
    tbeam = {k: torch.tensor(v) for k, v in beam.items()}
    tbeam["nsub"] = tbeam["nsub"].to(torch.int32)
    tbeam["beam_id"] = tbeam["beam_id"].to(torch.int32)
    tres, terr, tit = tstep.pc_bxby_solve(
        tf, [_to_torch(p)], tbeam, tcfg,
        make_poisson_solver(tcfg.poisson_solver, tcfg.geom, "cpu",
                            torch.float64),
        OpenBoundary(tcfg.geom, device="cpu"))
    return jres, float(jerr), int(jit), tres, terr, tit


def test_pc_bxby_solve_matches(pc_pair):
    jres, jerr, jit, tres, terr, tit = pc_pair
    assert tit == jit and 1 <= tit <= 30
    assert isinstance(tit, int) and isinstance(terr, float)
    np.testing.assert_allclose(terr, jerr, rtol=FIELD_RTOL)
    for s, comps in (("This", ("Bx", "By")), ("PCIter", ("Bx", "By")),
                     ("PCPrevIter", ("Bx", "By"))):
        for c in comps:
            _close(tres[s][c], jres[s][c], FIELD_RTOL)


# ---------------------------------------------------------------- steps
@pytest.fixture(scope="module", params=list(STEP_CASES))
def step_case(request):
    """One time step of a 31^2 x 8 deck through both packages from the same
    beam: (JAX result, port result, the JAX package's V-cycles per slice
    where the explicit solver runs, the port's simulation)."""
    base, extra = STEP_CASES[request.param]
    deck = base.format(nxy=31, nz=8, npart=1000) + NO_BANDED + extra
    explicit = base is BLOWOUT_WAKE
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        if explicit:
            mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(deck), verbose=0)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time,
                [b.total_charge for b in jsim.beam_cfgs])
    tres = tsim.run_step(0)
    return jres, tres, cycles, tsim


def test_step_fields_match(step_case):
    """Every dataset of field_data = all, every slice."""
    jres, tres, _, tsim = step_case
    comps = tsim.cfg.diag_comps
    if tsim.cfg.explicit:
        assert comps == tstep.DIAG_COMPS
    else:
        assert comps == tstep.THIS_COMPS_PC
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    assert got.shape == ref.shape == (tsim.geom.nz, len(comps),
                                      tsim.geom.ny, tsim.geom.nx)
    for i, comp in enumerate(comps):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))


def test_step_iterations_match(step_case):
    """pc_iters on every slice (the port lists them head first); the
    explicit solver's V-cycles per slice."""
    jres, tres, cycles, tsim = step_case
    nz = tsim.geom.nz
    want = np.asarray(jres["pc_iters"]).tolist()[::-1]
    assert tres["pc_iters"] == want and len(want) == nz
    if tsim.cfg.explicit:
        assert tres["mg_cycles"] == cycles and len(cycles) == nz
        assert tres["pc_iters"] == [0] * nz
    else:
        assert all(n > 0 for n in want)
        assert all(0.0 <= e for e in tres["pc_err"])


def test_step_beam_matches(step_case):
    jres, tres, _, _ = step_case
    jb, tb = jres["binned"], tres["binned"]
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    assert valid.sum() > 500
    for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
        ref = np.asarray(jb[k])[valid]
        np.testing.assert_allclose(tb[k].numpy()[valid], ref, rtol=0,
                                   atol=BEAM_RTOL * np.abs(ref).max())
