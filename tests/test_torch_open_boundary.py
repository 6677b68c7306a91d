"""The port's open boundary and Poisson solver family against the JAX
package, on CPU in float64, and the open-boundary physics check.

``OpenBoundary`` takes the moments as one product against a table of
source powers and the edge potentials as a second product, where the JAX
package scans the orders and sums each plane: the same float64 terms summed
in another order. Tolerances: 1e-12 relative to the largest value compared
for the open boundary and the periodic FFT solve, 1e-10 for the multigrid
Poisson solve (V-cycles to a 1e-11 relative residual, so the two sides'
roundoff is amplified by the solve's conditioning), with equal V-cycle
counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
from hipace_tpu.fields import poisson as jpoisson
from hipace_tpu.fields.open_boundary import OpenBoundary as JOpenBoundary
from hipace_tpu.geometry import Geometry
from hipace_tpu_torch.fields import poisson as tpoisson
from hipace_tpu_torch.fields.open_boundary import OpenBoundary
from hipace_tpu_torch.geometry import Geometry as TGeometry
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_open_boundary import DECK as CAN_BEAM_DECK
from test_open_boundary import X_MID, Y_MID, _theory
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
RTOL = 1e-12
MG_RTOL = 1e-10

# (n_cell, prob_lo, prob_hi): odd and centred, even and centred, odd and
# off centre
GRIDS = {
    "odd 31^2": ((31, 31, 4), (-8.0, -8.0, -2.0), (8.0, 8.0, 2.0)),
    "even 32x48": ((32, 48, 4), (-4.0, -6.0, -2.0), (4.0, 6.0, 2.0)),
    "off-centre 31x27": ((31, 27, 4), (-3.0, -5.0, -2.0), (6.0, 4.0, 2.0)),
}


def _geoms(name):
    n, lo, hi = GRIDS[name]
    return (Geometry(n_cell=n, prob_lo=lo, prob_hi=hi, nguards=2),
            TGeometry(n_cell=n, prob_lo=lo, prob_hi=hi, nguards=2))


@pytest.fixture(scope="module", params=list(GRIDS))
def boundary_pair(request):
    jg, tg = _geoms(request.param)
    rng = np.random.default_rng(7)
    src = rng.standard_normal((3, jg.ny, jg.nx)) + 0.5
    return (JOpenBoundary(jg, jnp.float64),
            OpenBoundary(tg, device="cpu", dtype=torch.float64), src)


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def test_moments_match(boundary_pair):
    job, tob, src = boundary_pair
    ref = np.stack([np.asarray(job.moments(jnp.asarray(s))) for s in src])
    got = tob.moments(torch.tensor(src))
    assert got.shape == (3, 19)
    # order by order: the high orders are far smaller than the monopole
    for o in range(19):
        _close(got[:, o], ref[:, o])


@pytest.mark.parametrize("monopole", [True, False])
def test_edge_potential_matches(boundary_pair, monopole):
    job, tob, src = boundary_pair
    ms = np.stack([np.asarray(job.moments(jnp.asarray(s))) for s in src])
    ref = np.stack([np.asarray(job.edge_potential(jnp.asarray(m), monopole))
                    for m in ms])
    got = tob.edge_potential(torch.tensor(ms), monopole)
    _close(got, ref)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("monopole", [True, False])
def test_apply_matches(boundary_pair, C, monopole):
    job, tob, src = boundary_pair
    ref = np.stack([np.asarray(job.apply(jnp.asarray(s), monopole))
                    for s in src[:C]])
    rhs = torch.tensor(src[:C])
    got = tob.apply(rhs, monopole)
    _close(got, ref)
    # a new tensor: the caller's right-hand side is left as it was
    assert torch.equal(rhs, torch.tensor(src[:C]))


@pytest.mark.parametrize("lo,hi,raises", [
    ((0.0, -4.0, -2.0), (8.0, 4.0, 2.0), True),
    ((-8.0, -4.0, -2.0), (8.0, 0.0, 2.0), True),
    # not holding x = 0 either, but the JAX package's check takes |prob_lo|
    # and accepts it (ROADMAP.md section 3, R10): the port does the same
    ((0.5, -4.0, -2.0), (8.0, 4.0, 2.0), False),
])
def test_domain_without_the_origin_raises(lo, hi, raises):
    n = (15, 15, 4)
    for make in (lambda: JOpenBoundary(Geometry(n_cell=n, prob_lo=lo,
                                                prob_hi=hi), jnp.float64),
                 lambda: OpenBoundary(TGeometry(n_cell=n, prob_lo=lo,
                                                prob_hi=hi), device="cpu")):
        if raises:
            with pytest.raises(ValueError, match="x=0, y=0"):
                make()
        else:
            make()


@pytest.mark.parametrize("shape", [(31, 27), (32, 48)])
def test_periodic_solver_matches(shape):
    ny, nx = shape
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal((3, ny, nx))
    ref = jpoisson.PeriodicPoissonSolver(nx, ny, 0.3, 0.2, jnp.float64) \
        .solve(jnp.asarray(rhs))
    got = tpoisson.PeriodicPoissonSolver(nx, ny, 0.3, 0.2).solve(
        torch.tensor(rhs))
    _close(got, ref)


def test_mg_dirichlet_solver_matches():
    ny, nx = 31, 27
    rng = np.random.default_rng(9)
    rhs = rng.standard_normal((3, ny, nx))
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        ref = jpoisson.MGDirichletPoissonSolver(nx, ny, 0.3, 0.2,
                                                jnp.float64) \
            .solve(jnp.asarray(rhs))
        jax.effects_barrier()
    solver = tpoisson.MGDirichletPoissonSolver(nx, ny, 0.3, 0.2)
    got = solver.solve(torch.tensor(rhs))
    _close(got, ref, MG_RTOL)
    assert cycles == [solver.mg.last_cycles] and 0 < cycles[0] <= 40
    # the multigrid's answer is the DST solver's, to its tolerance
    dst = tpoisson.DirichletPoissonSolver(nx, ny, 0.3, 0.2).solve(
        torch.tensor(rhs))
    _close(got, dst, 1e-9)


def test_make_poisson_solver_names():
    _, tg = _geoms("odd 31^2")
    kinds = {"FFTDirichletFast": tpoisson.DirichletPoissonSolver,
             "FFTDirichletExpanded": tpoisson.DirichletPoissonSolver,
             "FFTDirichletDirect": tpoisson.DirichletPoissonSolver,
             "MGDirichlet": tpoisson.MGDirichletPoissonSolver,
             "FFTPeriodic": tpoisson.PeriodicPoissonSolver}
    for name, kind in kinds.items():
        assert isinstance(tpoisson.make_poisson_solver(name, tg, "cpu",
                                                       torch.float64), kind)
    with pytest.raises(ValueError, match="unknown"):
        tpoisson.make_poisson_solver("FFTNope", tg, "cpu", torch.float64)


def test_open_boundary_can_beam():
    """The JAX package's physics check (tests/test_open_boundary.py) through
    the port: an off-centre can beam in vacuum, predictor-corrector with
    open boundaries on a 128^2 grid, against the analytic field, with the
    same thresholds."""
    sim = Simulation(TInputs(CAN_BEAM_DECK), device="cpu", verbose=0)
    res = sim.run_step(0)
    comps = sim.cfg.diag_comps
    diag = res["diag"].numpy()
    g = sim.geom
    isl = g.nz // 2
    xs = g.prob_lo[0] + (np.arange(g.nx) + 0.5) * g.dx
    ys = g.prob_lo[1] + (np.arange(g.ny) + 0.5) * g.dy
    iy_mid = int(np.argmin(np.abs(ys - Y_MID)))
    ix_mid = int(np.argmin(np.abs(xs - X_MID)))

    by = diag[isl, comps.index("By")][iy_mid, :]
    by_th = _theory(xs - X_MID)
    err_by = np.sum((by - by_th) ** 2) / np.sum(by_th ** 2)
    assert err_by < 0.015, f"By error {err_by}"

    bx = diag[isl, comps.index("Bx")][:, ix_mid]
    bx_th = -_theory(ys - Y_MID)
    err_bx = np.sum((bx - bx_th) ** 2) / np.sum(bx_th ** 2)
    assert err_bx < 0.005, f"Bx error {err_bx}"

    ex = diag[isl, comps.index("ExmBy")][iy_mid, :] + by
    err_ex = np.sum((ex - by_th) ** 2) / np.sum(by_th ** 2)
    assert err_ex < 0.015, f"Ex error {err_ex}"

    ey = diag[isl, comps.index("EypBx")][:, ix_mid] - bx
    err_ey = np.sum((ey + bx_th) ** 2) / np.sum(bx_th ** 2)
    assert err_ey < 0.005, f"Ey error {err_ey}"
