"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Marked ``gpu``: they build the kernels with nvcc and need a CUDA device, so
they skip on a CPU-only machine. On the GPU machine, which has no JAX, run
them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances are relative to the largest output: float64 1e-12 and float32
1e-5 for the atomic deposit and the gather (summation order), 1e-9 / 1e-4
for the multigrid (roundoff carried through the V-cycles).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype, f64, f32):
    return f64 if dtype == torch.float64 else f32


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order,deriv_type,blocks", [
    (0, -1, None), (1, -1, None), (2, -1, None), (3, -1, None),
    (2, 2, None), (2, 0, (("w", "w", 1), ("dw", "w", 1), ("w", "dw", 1))),
    (3, 1, (("dw", "w", 2), ("w", "dw", 1)))])
def test_deposit_kernel(cuda, dtype, order, deriv_type, blocks):
    from hipace_tpu_torch.ops.deposit import deposit_cuda, deposit_plain
    rng = np.random.default_rng(order + 4 * (deriv_type + 1))
    NY, NX, N, C = 70, 66, 20000, 3
    ym = torch.tensor(rng.uniform(-3, NY + 3, N), dtype=dtype, device=cuda)
    xm = torch.tensor(rng.uniform(-3, NX + 3, N), dtype=dtype, device=cuda)
    ym[::11] = 2.0 * NY
    vals = torch.tensor(rng.standard_normal((C, N)), dtype=dtype,
                        device=cuda)
    zero = torch.zeros((C, NY, NX), dtype=dtype, device=cuda)
    got = deposit_cuda(zero.clone(), ym, xm, vals, order, deriv_type, blocks)
    ref = deposit_plain(zero.clone(), ym, xm, vals, order, deriv_type,
                        blocks)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_gather_kernel(cuda, dtype, order):
    from hipace_tpu_torch.ops.gather import gather_main_cuda, gather_main_plain
    rng = np.random.default_rng(order)
    NY, NX, N = 70, 66, 20000
    ym = torch.tensor(rng.uniform(-3, NY + 3, N), dtype=dtype, device=cuda)
    xm = torch.tensor(rng.uniform(-3, NX + 3, N), dtype=dtype, device=cuda)
    ym[::7] = 2.0 * NY
    stack = torch.tensor(rng.standard_normal((5, NY, NX)), dtype=dtype,
                         device=cuda)
    got = gather_main_cuda(stack, ym, xm, order)
    ref = gather_main_plain(stack, ym, xm, order)
    torch.cuda.synchronize()
    assert _rel(got, ref) < _tol(dtype, 1e-12, 1e-5)
    assert bool((got[:, ::7] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ny,nx,nchan", [(31, 31, 2), (63, 31, 1),
                                         (15, 127, 2), (255, 255, 2)])
def test_multigrid_kernel(cuda, dtype, ny, nx, nchan):
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    rng = np.random.default_rng(ny + nx)
    mg = MultiGrid(nx, ny, 0.05, 0.07, device=cuda, dtype=dtype)
    rhs = torch.tensor(rng.standard_normal((nchan, ny, nx)), dtype=dtype,
                       device=cuda)
    acf = torch.tensor(np.abs(rng.standard_normal((ny, nx))), dtype=dtype,
                       device=cuda)
    u0 = torch.zeros_like(rhs)
    got = mg_solve(mg, u0, rhs, acf, tol_rel=1e-4)
    cycles = mg.last_cycles
    ref = mg.solve_plain(u0, rhs, acf, tol_rel=1e-4)
    torch.cuda.synchronize()
    assert cycles == mg.last_cycles
    assert _rel(got, ref) < _tol(dtype, 1e-9, 1e-4)


def test_kernels_count_launches(cuda):
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    pos = torch.full((4,), 5.0, device=cuda)
    before = (deposit.launches, gather_main.launches)
    deposit(torch.zeros((1, 12, 12), device=cuda), pos, pos,
            torch.ones((1, 4), device=cuda), 2)
    gather_main(torch.zeros((5, 12, 12), device=cuda), pos, pos, 2)
    # no lanes, no launch, no count
    empty = pos[:0]
    deposit(torch.zeros((1, 12, 12), device=cuda), empty, empty,
            torch.ones((1, 0), device=cuda), 2)
    gather_main(torch.zeros((5, 12, 12), device=cuda), empty, empty, 2)
    assert (deposit.launches, gather_main.launches) == (before[0] + 1,
                                                        before[1] + 1)
