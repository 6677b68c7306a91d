"""Where the time of the port's kernels goes, on a GPU.

    python3 tools/time_torch_kernels.py [--only k1,k2,k3] [--root CHECKOUT]

K3: the cost of one V-cycle by grid size (a solve that never converges, cut
at 11 and at 21 V-cycles; the difference over 10), which separates the
single-block ladder, each tile level and level 0, and the host's time to
enqueue one solve; odd sizes (node-centered) and even ones (cell-centered,
skipped for a checkout whose multigrid refuses them). K1: one plasma-like
call (1 lane per cell of 1023^2, order 2, deriv_type 2) by channel count,
with and without the lattice hint, for lanes moved by up to half a cell and
by up to 3, 6 and 10 cells, with the share of blocks on the kernel's direct
path. K2: the registers, stack frame
and spills of its kernels; its order-2 plasma call (1 lane per cell of
1023^2 in lattice order, moved by up to half a cell) and a 30k-lane
gaussian beam slice, each timed on the device and by the host's time to
enqueue one call as the pushers make it, and the host's time per slice for
K2's 11 calls (1 plasma, 10 beam) and the two pushes' preparation of the
planes (a stacked copy, where the wrapper takes only a stack). float32 and
float64, CUDA events around calls queued behind a device sleep, times per
call.

``--root`` times the kernels of another checkout (say the parent commit,
unpacked with ``git archive``) with this script, so that two versions are
compared in one call on one card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLEEP_CYCLES = 50_000_000   # ~25 ms: longer than enqueueing the timed calls


def _chip_smoke():
    """This checkout's chip_smoke.py (its ptxas parser), whatever --root."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="k1,k2,k3",
                    help="comma-separated sections to run")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose hipace_tpu_torch is timed")
    args = ap.parse_args()
    only = set(args.only.split(","))
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    import hipace_tpu_torch
    if Path(hipace_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"hipace_tpu_torch was not imported from {root}",
              file=sys.stderr)
        return 2

    def cuda_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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
    print(f"timing the kernels of {root}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        if "k3" in only:
            k3_section(torch, dtype, gen, cuda_ms, enqueue_us)
        if "k1" in only:
            k1_section(torch, dtype, gen, cuda_ms)
    if "k2" in only:
        k2_section(torch, gen, cuda_ms, enqueue_us)
    return 0


def k3_section(torch, dtype, gen, cuda_ms, enqueue_us):
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve, plan
    name = str(dtype).split(".")[1]
    for C in (2, 1):
        for n in (1023, 1024, 511, 512, 255, 256, 127, 128, 63, 64, 31, 32):
            try:
                mg = MultiGrid(n, n, 16 / n, 16 / n, device="cuda",
                               dtype=dtype)
            except NotImplementedError as err:
                print(f"K3 {name} C={C} {n}^2: {err}", flush=True)
                continue
            rhs = torch.randn((C, n, n), generator=gen, device="cuda",
                              dtype=dtype)
            acf = 1 + 0.1 * torch.rand((n, n), generator=gen, device="cuda",
                                       dtype=dtype)
            u0 = torch.zeros_like(rhs)

            def solve(cycles):
                # tol_rel 1e-30 is never met: the solve ends at max_iters
                return mg_solve(mg, u0, rhs, acf, max_iters=cycles,
                                tol_rel=1e-30)
            t11 = cuda_ms(lambda: solve(11))
            t21 = cuda_ms(lambda: solve(21))
            halo, lc, smem = plan(mg.shapes, C, rhs.element_size(), 2, 2)
            print(f"K3 {name} C={C} {n}^2"
                  f"{' cell-centered' if n % 2 == 0 else ''}: first "
                  f"single-block level "
                  f"{lc} of {mg.nlevels}, {smem} B shared; "
                  f"{100 * (t21 - t11):.1f} us per V-cycle; enqueue "
                  f"{enqueue_us(lambda: solve(0)):.1f} us", flush=True)


def _plasma_lanes(torch, gen, dtype, n, G, spread):
    """1 lane per cell of an n^2 grid in lattice order, moved by up to
    `spread` cells, as guard-offset positions."""
    iy, ix = torch.meshgrid(torch.arange(n, device="cuda"),
                            torch.arange(n, device="cuda"), indexing="ij")
    move = (torch.rand((2, n * n), generator=gen, device="cuda",
                       dtype=torch.float64) - 0.5) * 2 * spread
    return ((iy.reshape(-1) + G + move[0]).to(dtype),
            (ix.reshape(-1) + G + move[1]).to(dtype))


def k1_section(torch, dtype, gen, cuda_ms):
    from hipace_tpu_torch.ops import deposit as dep
    name = str(dtype).split(".")[1]
    n, G = 1023, 2
    NY, NX = n + 2 * G, n + 2 * G
    N = n * n
    for spread in (0.5, 3.0, 6.0, 10.0):
        ym, xm = _plasma_lanes(torch, gen, dtype, n, G, spread)
        for C in (13, 4, 1):
            vals = torch.randn((C, N), generator=gen, device="cuda",
                               dtype=dtype)
            f = torch.zeros((C, NY, NX), dtype=dtype, device="cuda")
            for width in (n, None):
                dep.reset_block_counts()
                dep.deposit_cuda(f, ym, xm, vals, 2, 2, lattice_width=width)
                direct = dep.direct_block_count("cuda")
                blocks = dep.deposit.blocks
                ms = cuda_ms(lambda: dep.deposit_cuda(
                    f, ym, xm, vals, 2, 2, lattice_width=width))
                print(f"K1 {name} C={C} lanes moved by up to {spread} "
                      f"cells, lattice width {width}: {ms:.4f} ms, "
                      f"direct-path blocks {direct} of {blocks}", flush=True)


def k2_section(torch, gen, cuda_ms, enqueue_us):
    from hipace_tpu_torch.ops import cuda_lib
    from hipace_tpu_torch.ops import gather as gat
    from hipace_tpu_torch.particles import plasma
    log = cuda_lib.library().compiler_output
    demanglers = (str(Path(cuda_lib.nvcc_path()).parent / "cu++filt"),
                  "c++filt")
    for name, regs, stack, stores, loads in _chip_smoke().ptxas_kernels(
            log, demanglers):
        if "gather" in name:
            print(f"K2 ptxas {name}: {regs} registers, {stack} bytes stack "
                  f"frame, {stores} bytes spill stores, {loads} bytes spill "
                  "loads", flush=True)
    # a wrapper without PLANE_NAMES takes only the (5, NY, NX) stack, which
    # its pushers build once per push with gather_stack
    in_place = hasattr(gat, "PLANE_NAMES")
    n, G = 1023, 2
    NY, NX = n + 2 * G, n + 2 * G
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        fields = {c: torch.randn((NY, NX), generator=gen, device="cuda",
                                 dtype=dtype)
                  for c in ("Psi", "Ez", "Bx", "By", "Bz")}
        prepare = plasma.field_planes if in_place else plasma.gather_stack
        form = prepare(fields)
        prep_us = enqueue_us(lambda: prepare(fields))
        ym, xm = _plasma_lanes(torch, gen, dtype, n, G, 0.5)
        ym[::97] = 2.0 * NY
        # the beam's call: a gaussian slice, sigma 0.3 of a 16-wide box
        nb = 30000
        pos = torch.randn((2, nb), generator=gen, device="cuda",
                          dtype=torch.float64) * (0.3 * n / 16)
        bym = (pos[0] + G + n / 2).to(dtype)
        bxm = (pos[1] + G + n / 2).to(dtype)
        bym[torch.rand(nb, generator=gen, device="cuda") < 0.15] = 2.0 * NY
        host = {}
        for label, y, x in (("plasma 1023^2 lattice order", ym, xm),
                            ("beam 30k gaussian", bym, bxm)):
            ts = [cuda_ms(lambda: gat.gather_main_cuda(form, y, x, 2),
                          reps=20) for _ in range(3)]
            host[label] = [enqueue_us(lambda: gat.gather_main(form, y, x, 2))
                           for _ in range(3)]
            print(f"K2 {name} {label}: {', '.join(f'{t:.5f}' for t in ts)} "
                  f"ms; enqueue {', '.join(f'{t:.1f}' for t in host[label])} "
                  "us", flush=True)
        per_slice = [p + 10 * b + 2 * prep_us
                     for p, b in zip(*host.values())]
        print(f"K2 {name} host per slice, 1 plasma + 10 beam calls + 2 pushes'"
              f" {prepare.__name__} of {prep_us:.1f} us: "
              f"{', '.join(f'{t:.1f}' for t in per_slice)} us", flush=True)


if __name__ == "__main__":
    sys.exit(main())
