"""Where the time of the port's K1 and K3 kernels goes, on a GPU.

    python3 tools/time_torch_kernels.py

K3: the cost of one V-cycle by grid size (a solve that never converges, cut
at 11 and at 21 V-cycles; the difference over 10), which separates the
single-block ladder, each tile level and level 0, and the host's time to
enqueue one solve. K1: one plasma-like call (1 lane per cell of 1023^2,
order 2, deriv_type 2) by channel count, with and without the lattice hint,
for lanes moved by up to half a cell and by up to three cells, with the
share of blocks on the kernel's direct path. float32 and float64, CUDA
events, times per call. Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops import deposit as dep
    from hipace_tpu_torch.ops.mg_kernel import mg_solve, plan

    def cuda_ms(fn, reps=10):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def enqueue_us(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * t / reps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for C in (2, 1):
            for n in (1023, 511, 255, 127, 63, 31):
                mg = MultiGrid(n, n, 16 / n, 16 / n, device="cuda",
                               dtype=dtype)
                rhs = torch.randn((C, n, n), generator=gen, device="cuda",
                                  dtype=dtype)
                acf = 1 + 0.1 * torch.rand((n, n), generator=gen,
                                           device="cuda", dtype=dtype)
                u0 = torch.zeros_like(rhs)

                def solve(cycles):
                    # tol_rel 1e-30 is never met: the solve ends at max_iters
                    return mg_solve(mg, u0, rhs, acf, max_iters=cycles,
                                    tol_rel=1e-30)
                t11 = cuda_ms(lambda: solve(11))
                t21 = cuda_ms(lambda: solve(21))
                halo, lc, smem = plan(mg.shapes, C, rhs.element_size(), 2, 2)
                print(f"K3 {name} C={C} {n}^2: first single-block level "
                      f"{lc} of {mg.nlevels}, {smem} B shared; "
                      f"{100 * (t21 - t11):.1f} us per V-cycle; enqueue "
                      f"{enqueue_us(lambda: solve(0)):.1f} us", flush=True)

        ny = nx = 1023
        G = 2
        NY, NX = ny + 2 * G, nx + 2 * G
        N = ny * nx
        iy, ix = torch.meshgrid(torch.arange(ny, device="cuda"),
                                torch.arange(nx, device="cuda"),
                                indexing="ij")
        for spread in (0.5, 3.0):
            move = (torch.rand((2, N), generator=gen, device="cuda",
                               dtype=torch.float64) - 0.5) * 2 * spread
            ym = (iy.reshape(-1) + G + move[0]).to(dtype)
            xm = (ix.reshape(-1) + G + move[1]).to(dtype)
            for C in (13, 4, 1):
                vals = torch.randn((C, N), generator=gen, device="cuda",
                                   dtype=dtype)
                f = torch.zeros((C, NY, NX), dtype=dtype, device="cuda")
                for width in (nx, None):
                    dep.reset_block_counts()
                    dep.deposit_cuda(f, ym, xm, vals, 2, 2,
                                     lattice_width=width)
                    direct = dep.direct_block_count("cuda")
                    blocks = dep.deposit.blocks
                    ms = cuda_ms(lambda: dep.deposit_cuda(
                        f, ym, xm, vals, 2, 2, lattice_width=width))
                    print(f"K1 {name} C={C} lanes moved by up to {spread} "
                          f"cells, lattice width {width}: {ms:.4f} ms, "
                          f"direct-path blocks {direct} of {blocks}",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
