"""Even (cell-centered) transverse sizes through the port, against the JAX
package on CPU in float64.

The cell-centered multigrid (zero at the cell faces: the 4/3 edge stencil, a
per-cell diagonal, the 2-cell-average restriction and injection) is held to
hipace_tpu's MultiGrid XLA solve at 1e-10 relative to the largest value
(float64 roundoff; measured ~1e-15) with equal V-cycle counts, and its
converged solution to the independent dense operator of
tests/test_solvers.py. MGDirichlet at an even size and one whole explicit
time step at 32^2 x 16 are held to the JAX package the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
from hipace_tpu.fields.poisson import MGDirichletPoissonSolver as JMGD
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import BLOWOUT_WAKE
from hipace_tpu_torch.fields.multigrid import MultiGrid
from hipace_tpu_torch.fields.poisson import MGDirichletPoissonSolver
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_solvers import _mg_operator_dense
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
RTOL = 1e-10
DX, DY = 0.11, 0.13


def _jax_solve(jm, u0, rhs, acf, **kw):
    """hipace_tpu's XLA MultiGrid solve and its V-cycle count, run eagerly
    (one small solve compiles slower than it runs)."""
    cycles = []
    with jax.disable_jit():
        u = _counting_solve(cycles)(jm, u0, rhs, acf, **kw)
    jax.effects_barrier()
    return np.asarray(u), cycles[0]


def _problem(ny, nx, C, acf_kind, seed):
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((C, ny, nx) if C > 1 else (ny, nx))
    acf = (np.abs(rng.standard_normal((ny, nx))) if acf_kind == "2-D"
           else 0.5)
    return rhs, acf


# each grid with both kinds of acf and its own channel count (cases that
# share shapes share the JAX package's per-shape compiles)
@pytest.mark.parametrize("ny,nx,C", [(32, 32, 3), (32, 64, 2), (48, 48, 1)])
@pytest.mark.parametrize("acf_kind", ["2-D", "scalar"])
def test_cell_centered_solve_matches_jax(ny, nx, C, acf_kind):
    """32^2 and 32 x 64 go down to 2 cells, 48^2 stops at 3."""
    rhs, acf = _problem(ny, nx, C, acf_kind, ny + nx + C)
    jm = jmg.MultiGrid(nx, ny, DX, DY, jnp.float64)
    ref, cycles = _jax_solve(
        jm, jnp.zeros(rhs.shape), jnp.asarray(rhs),
        jnp.asarray(acf) if acf_kind == "2-D" else acf, tol_rel=1e-10)
    tm = MultiGrid(nx, ny, DX, DY)
    assert tm.cell_centered and tm.shapes == jm.shapes
    got = tm.solve(torch.zeros(rhs.shape, dtype=torch.float64),
                   torch.tensor(rhs),
                   torch.tensor(acf) if acf_kind == "2-D" else acf,
                   tol_rel=1e-10)
    assert tm.last_cycles == cycles > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


def test_ladder_and_parity():
    """Levels halve while both sizes are even and n / 2 >= 2: 1024 goes down
    to 2, 96 stops at 3; the JAX package's ladder. Mixed parity raises."""
    mg = MultiGrid(1024, 1024, 0.1, 0.1)
    assert mg.shapes[-1] == (2, 2) and mg.nlevels == 10
    mg = MultiGrid(96, 64, 0.1, 0.1)
    assert mg.shapes == jmg.MultiGrid(96, 64, 0.1, 0.1, jnp.float64).shapes
    assert mg.shapes[-1] == (2, 3)
    assert not MultiGrid(31, 63, 0.1, 0.1).cell_centered
    with pytest.raises(ValueError, match="parity"):
        MultiGrid(32, 31, 0.1, 0.1)


@pytest.mark.parametrize("n", [32, 64])
def test_cell_centered_solution_satisfies_the_dense_operator(n):
    """The converged solution against the independent dense cell-centered
    operator of tests/test_solvers.py (face Dirichlet, one-sided 4/3
    stencils at the edges)."""
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((n, n))
    acf = np.abs(rng.standard_normal((n, n))) * 2.0
    mg = MultiGrid(n, n, DX, DY)
    u = mg.solve(torch.zeros(n, n, dtype=torch.float64), torch.tensor(rhs),
                 torch.tensor(acf), tol_rel=1e-12, max_iters=100).numpy()
    res = _mg_operator_dense(u, acf, DX, DY, cell_centered=True) - rhs
    assert np.abs(res).max() < 1e-9 * np.abs(rhs).max()
    # the port's own operator is the same one
    lap = mg.apply_op(torch.tensor(u), torch.tensor(acf)).numpy()
    np.testing.assert_allclose(
        lap, _mg_operator_dense(u, acf, DX, DY, cell_centered=True),
        rtol=0, atol=1e-11 * np.abs(lap).max())


def test_mgdirichlet_even_matches_jax():
    """MGDirichlet (zero acf, tol_rel 1e-11) at 32^2, C = 3."""
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((3, 32, 32))
    jsolver = JMGD(32, 32, DX, DY, jnp.float64)
    ref, cycles = _jax_solve(jsolver.mg, jnp.zeros(rhs.shape),
                             jnp.asarray(rhs), 0.0, tol_rel=jsolver.tol_rel)
    tsolver = MGDirichletPoissonSolver(32, 32, DX, DY)
    got = tsolver.solve(torch.tensor(rhs))
    assert tsolver.mg.cell_centered
    assert tsolver.mg.last_cycles == cycles > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


@pytest.fixture(scope="module")
def even_step():
    """One explicit step of the flagship deck at 32^2 x 16 through both
    packages from the same beam."""
    deck = BLOWOUT_WAKE.format(nxy=32, nz=16, npart=2000) \
        + "hipace.use_banded = 0\n"
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(deck), verbose=0)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time,
                [b.total_charge for b in jsim.beam_cfgs])
    return jres, tsim.run_step(0), cycles, tsim


def test_even_step_fields_match(even_step):
    jres, tres, _, tsim = even_step
    assert tsim.slice_step.mg.cell_centered
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    assert got.shape == ref.shape == (16, len(tsim.cfg.diag_comps), 32, 32)
    for i, comp in enumerate(tsim.cfg.diag_comps):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=RTOL * max(np.abs(ref[:, i]).max(), 1e-300))


def test_even_step_cycles_and_beam_match(even_step):
    jres, tres, cycles, _ = even_step
    assert tres["mg_cycles"] == cycles and len(cycles) == 16
    valid = np.asarray(jres["binned"]["valid"])
    np.testing.assert_array_equal(tres["binned"]["valid"].numpy(), valid)
    for k in ("x", "uy", "uz"):
        ref = np.asarray(jres["binned"][k])[valid]
        np.testing.assert_allclose(tres["binned"][k].numpy()[valid], ref,
                                   rtol=0, atol=1e-12 * np.abs(ref).max())
