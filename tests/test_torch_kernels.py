"""The port's kernel reference versions against the JAX package, on CPU.

K1 (deposit), K2 (main-fields gather) and K3 (multigrid) of
hipace_tpu_torch run their plain PyTorch versions on CPU tensors. Each is
held here to the JAX package's Pallas kernel in interpret mode and to its
exact XLA counterpart, on the same numpy inputs in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.fields.multigrid import MultiGrid as JMultiGrid
from hipace_tpu.geometry import Geometry
from hipace_tpu.ops.deposit import deposit_multi
from hipace_tpu.ops.gather import gather_main_fields
from hipace_tpu.ops.pallas_banded import (pallas_deposit,
                                          pallas_deposit_blocks,
                                          pallas_gather_main)
from hipace_tpu.ops.pallas_mg import FusedMG
from hipace_tpu_torch.fields.multigrid import MultiGrid
from hipace_tpu_torch.ops.deposit import deposit, deposit_plain
from hipace_tpu_torch.ops.gather import gather_main

torch.set_num_threads(1)

# float64 roundoff: the kernels sum the same terms in another order
RTOL = 1e-12


def _lanes(seed, N, NY, NX, n_dead=0, margin=3.0):
    """Guard-offset cell positions inside the grid (margin cells from the
    edge) with n_dead lanes at the 2*NY sentinel."""
    rng = np.random.default_rng(seed)
    ym = rng.uniform(margin, NY - margin - 1.0, N)
    xm = rng.uniform(margin, NX - margin - 1.0, N)
    ym[N - n_dead:] = 2.0 * NY
    xm[N - n_dead:] = 2.0 * NX
    return ym, xm


def _assert_close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_deposit_matches_pallas(order):
    NY, NX, N = 40, 36, 1024
    ym, xm = _lanes(order, N, NY, NX, n_dead=64)
    vals = np.random.default_rng(10 + order).standard_normal((3, N))
    ref, _ = pallas_deposit(jnp.zeros((3, NY, NX)), jnp.asarray(ym),
                            jnp.asarray(xm), jnp.asarray(vals), NY, NX,
                            order, interpret=True)
    got = deposit(torch.zeros(3, NY, NX, dtype=torch.float64),
                  torch.tensor(ym), torch.tensor(xm), torch.tensor(vals),
                  order)
    _assert_close(got, ref)


@pytest.mark.parametrize("deriv_type,blocks", [
    (0, (("w", "w", 1), ("dw", "w", 1), ("w", "dw", 1))),
    (1, (("w", "w", 1), ("dw", "w", 1), ("w", "dw", 1))),
    (2, (("w", "w", 1), ("dw", "w", 1), ("w", "dw", 1))),
    (2, (("w", "w", 13),))])
def test_deposit_blocks_match_pallas(deriv_type, blocks):
    NY, NX, N, order = 40, 36, 1024, 2
    C = sum(n for _, _, n in blocks)
    ym, xm = _lanes(20 + deriv_type, N, NY, NX, n_dead=32)
    vals = np.random.default_rng(30 + C).standard_normal((C, N))
    ref, _ = pallas_deposit_blocks(jnp.zeros((C, NY, NX)), jnp.asarray(ym),
                                   jnp.asarray(xm), jnp.asarray(vals),
                                   blocks, NY, NX, order, deriv_type,
                                   interpret=True)
    got = deposit(torch.zeros(C, NY, NX, dtype=torch.float64),
                  torch.tensor(ym), torch.tensor(xm), torch.tensor(vals),
                  order, deriv_type, blocks)
    _assert_close(got, ref)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_matches_deposit_multi(order):
    """Against the exact scatter on physical positions, with lanes whose
    stencils reach past the grid edge (their outside taps are dropped)."""
    g = Geometry(n_cell=(31, 27, 8), prob_lo=(-2.0, -1.5, -1.0),
                 prob_hi=(2.0, 1.5, 1.0))
    NY, NX = g.slice_shape
    rng = np.random.default_rng(40 + order)
    N = 800
    xp = rng.uniform(-2.3, 2.3, N)
    yp = rng.uniform(-1.8, 1.8, N)
    vals = rng.standard_normal((2, N))
    ref = deposit_multi(jnp.zeros((2, NY, NX)), jnp.asarray(xp),
                        jnp.asarray(yp), [jnp.asarray(v) for v in vals], g,
                        order)
    G = g.nguards
    ym = torch.tensor((yp - g.y_pos_offset) / g.dy + G)
    xm = torch.tensor((xp - g.x_pos_offset) / g.dx + G)
    got = deposit(torch.zeros(2, NY, NX, dtype=torch.float64), ym, xm,
                  torch.tensor(vals), order)
    _assert_close(got, ref)


def test_deposit_rejects_missing_derivative():
    with pytest.raises(ValueError):
        deposit_plain(torch.zeros(1, 8, 8, dtype=torch.float64),
                      torch.ones(2, dtype=torch.float64),
                      torch.ones(2, dtype=torch.float64),
                      torch.ones(1, 2, dtype=torch.float64), 0, 0,
                      (("dw", "w", 1),))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_matches_pallas(order):
    """At order 3 the Pallas kernel evaluates the nodal derivative factor
    -B4' at every window cell, which reaches one cell past the 5-tap
    stencil of the XLA gather (ROADMAP fault R8); the port follows the XLA
    gather there (test_gather_matches_gather_main_fields), so the two Psi
    derivative channels are compared at orders 1 and 2 only."""
    NY, NX, N = 40, 36, 1024
    ym, xm = _lanes(50 + order, N, NY, NX, n_dead=100)
    stack = np.random.default_rng(60 + order).standard_normal((5, NY, NX))
    ref = pallas_gather_main(jnp.asarray(stack), jnp.asarray(ym),
                             jnp.asarray(xm), NY, NX, order, interpret=True)
    got = gather_main(torch.tensor(stack), torch.tensor(ym),
                      torch.tensor(xm), order)
    for i in range(2 if order == 3 else 0, 6):
        _assert_close(got[i], ref[i])
    if order == 3:
        assert not np.allclose(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_matches_gather_main_fields(order):
    # the deck's guard width for this order (Geometry.from_inputs)
    g = Geometry(n_cell=(31, 27, 8), prob_lo=(-2.0, -1.5, -1.0),
                 prob_hi=(2.0, 1.5, 1.0), nguards=(order + 1) // 2 + 1)
    NY, NX = g.slice_shape
    rng = np.random.default_rng(70 + order)
    N = 900
    xp = rng.uniform(-2.0, 2.0, N)
    yp = rng.uniform(-1.5, 1.5, N)
    f = rng.standard_normal((5, NY, NX))
    ref = gather_main_fields(jnp.asarray(xp), jnp.asarray(yp),
                             *[jnp.asarray(a) for a in f], g, order)
    G = g.nguards
    out = gather_main(torch.tensor(f),
                      torch.tensor((yp - g.y_pos_offset) / g.dy + G),
                      torch.tensor((xp - g.x_pos_offset) / g.dx + G), order)
    got = [out[0] / g.dx, out[1] / g.dy] + [out[i] for i in range(2, 6)]
    for a, b in zip(got, ref):
        _assert_close(a, b)


def _mg_problem(ny, nx, nchan, seed):
    rng = np.random.default_rng(seed)
    return (np.zeros((nchan, ny, nx)), rng.standard_normal((nchan, ny, nx)),
            np.abs(rng.standard_normal((ny, nx))))


@pytest.mark.parametrize("ny,nx,nchan", [(31, 31, 2), (15, 127, 2),
                                         (63, 63, 1)])
def test_multigrid_matches_xla(ny, nx, nchan):
    """Same algorithm as the XLA path: agreement to float64 roundoff."""
    u0, rhs, acf = _mg_problem(ny, nx, nchan, ny + nx)
    ref = JMultiGrid(nx, ny, 0.05, 0.07, jnp.float64).solve(
        jnp.asarray(u0), jnp.asarray(rhs), jnp.asarray(acf), tol_rel=1e-6,
        max_iters=30, fused=False)
    mg = MultiGrid(nx, ny, 0.05, 0.07)
    got = mg.solve(torch.tensor(u0), torch.tensor(rhs), torch.tensor(acf),
                   tol_rel=1e-6, max_iters=30)
    assert 0 < mg.last_cycles < 30
    # a few V-cycles of float64 roundoff in another summation order
    _assert_close(got, ref, rtol=1e-10)


@pytest.mark.parametrize("ny,nx,nchan", [(31, 31, 2)])
def test_multigrid_matches_fused_interpret(ny, nx, nchan):
    """Against the Pallas kernel: the same tolerance as the JAX package's
    own fused-vs-XLA test, since the TPU kernel sweeps the coarsest level
    8 times where the XLA path (the port's contract) sweeps nu1 + 8."""
    u0, rhs, acf = _mg_problem(ny, nx, nchan, 7)
    jmg = JMultiGrid(nx, ny, 0.05, 0.07, jnp.float64)
    ref = FusedMG(jmg, nchan).solve(jnp.asarray(u0), jnp.asarray(rhs),
                                    jnp.asarray(acf), tol_rel=1e-6,
                                    max_iters=30, interpret=True)
    got = MultiGrid(nx, ny, 0.05, 0.07).solve(
        torch.tensor(u0), torch.tensor(rhs), torch.tensor(acf),
        tol_rel=1e-6, max_iters=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-7)


def test_multigrid_scalar_acf_and_2d():
    """Scalar acf and an unbatched (ny, nx) system."""
    ny = nx = 31
    _, rhs, _ = _mg_problem(ny, nx, 1, 3)
    ref = JMultiGrid(nx, ny, 0.1, 0.1, jnp.float64).solve(
        jnp.zeros((ny, nx)), jnp.asarray(rhs[0]), 0.0, tol_rel=1e-8,
        max_iters=50, fused=False)
    got = MultiGrid(nx, ny, 0.1, 0.1).solve(
        torch.zeros(ny, nx, dtype=torch.float64), torch.tensor(rhs[0]), 0.0,
        tol_rel=1e-8, max_iters=50)
    _assert_close(got, ref, rtol=1e-10)


def test_multigrid_rejects_even_sizes():
    """An even size is cell-centered and takes an even size in the other
    dimension: an even size beside an odd one is refused. Even grids run
    (tests/test_torch_even.py)."""
    for nx, ny in ((32, 31), (31, 32)):
        with pytest.raises(ValueError, match="parity"):
            MultiGrid(nx, ny, 0.1, 0.1)
    assert MultiGrid(32, 32, 0.1, 0.1).cell_centered


def test_jax_reference_is_float64():
    assert jax.config.jax_enable_x64
