"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 deposit, K2 gather, K3 multigrid) from
``hipace_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the main path's shapes (1023^2 grid, ~1.05M plasma
particles) in float32 and float64, checks a small time step on the kernels
against the same step on the CPU plain path, then drives the port's main
path -- a ``Simulation`` of the flagship blowout-wake deck
(``hipace_tpu_torch.decks.BLOWOUT_WAKE``) at 1023^2 x 64 slices in float32
-- for one warm-up and two timed steps, and checks that every kernel ran as
often as the slice structure predicts. It imports nothing but the port.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Without a usable GPU, or without the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NXY, NZ = 1023, 64
NPART = NXY * NXY * 10 * NZ // 1000   # the bench's beam scaling
SMALL_NXY, SMALL_NZ = 63, 16
# tolerance on max|kernel - plain| / max|plain|, per dtype
TOL = {"K1": {"float32": 1e-5, "float64": 1e-12},
       "K2": {"float32": 1e-5, "float64": 1e-12},
       "K3": {"float32": 1e-4, "float64": 1e-9}}
KERNELS = {
    "K1": ("deposit", "hipace_tpu_torch/csrc/deposit.cu",
           "hipace_tpu/ops/pallas_banded.py:392"),
    "K2": ("gather_main", "hipace_tpu_torch/csrc/gather.cu",
           "hipace_tpu/ops/pallas_banded.py:663"),
    "K3": ("mg_solve", "hipace_tpu_torch/csrc/multigrid.cu",
           "hipace_tpu/ops/pallas_mg.py:204"),
}

failures: list = []


def phase(name):
    """Run a phase; record and print a failure instead of raising."""
    def wrap(fn):
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception:
                failures.append(name)
                print(f"FAIL {name}:\n{traceback.format_exc()}", flush=True)
                return None
        return run
    return wrap


def cuda_ms(fn, reps=5):
    """Mean device time of fn() over reps calls after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel, dtype_name, got, ref):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / scale if scale > 0 else err
    tol = TOL[kernel][dtype_name]
    ok = rel <= tol
    return ok, err, rel, tol


def plasma_lanes(torch, g, dtype):
    """Main-path plasma lanes, shared by the K1 and K2 phases: 1 ppc at cell
    centres moved by up to half a cell, as guard-offset cell positions,
    with every 97th lane dead (the 2 NY sentinel)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    G = g.nguards
    iy, ix = torch.meshgrid(torch.arange(g.ny, device="cuda"),
                            torch.arange(g.nx, device="cuda"), indexing="ij")
    jit = torch.rand((2, g.ny * g.nx), generator=gen, device="cuda",
                     dtype=torch.float64) - 0.5
    ym = (iy.reshape(-1) + G + jit[0]).to(dtype)
    xm = (ix.reshape(-1) + G + jit[1]).to(dtype)
    ym[::97] = 2.0 * g.slice_shape[0]
    return ym, xm


@phase("K1")
def k1_phase(torch, g, dtype, lanes, results):
    from hipace_tpu_torch.ops import deposit as dep
    name = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    NY, NX = g.slice_shape
    cases = []
    ym, xm = lanes
    vals = torch.randn((13, ym.numel()), generator=gen, device="cuda",
                       dtype=dtype)
    cases.append(("plasma C=13 deriv_type 2", ym, xm, vals, 2))
    # gaussian beam slice: sigma 0.3 of a 16-wide box, ~30k lanes, 15% dead
    nb = 30000
    pos = torch.randn((2, nb), generator=gen, device="cuda",
                      dtype=torch.float64) * (0.3 / g.dx)
    bym = (pos[0] + g.nguards + g.ny / 2).to(dtype)
    bxm = (pos[1] + g.nguards + g.nx / 2).to(dtype)
    bym[torch.rand(nb, generator=gen, device="cuda") < 0.15] = 2.0 * NY
    bvals = torch.randn((2, nb), generator=gen, device="cuda", dtype=dtype)
    cases.append(("gaussian beam C=2", bym, bxm, bvals, -1))
    for label, y, x, v, dtyp in cases:
        C = v.shape[0]
        zero = torch.zeros((C, NY, NX), dtype=dtype, device="cuda")
        got = dep.deposit_cuda(zero.clone(), y, x, v, 2, dtyp)
        ref = dep.deposit_plain(zero.clone(), y, x, v, 2, dtyp)
        torch.cuda.synchronize()
        ok, err, rel, tol = compare("K1", name, got, ref)
        scratch = zero.clone()
        ms = cuda_ms(lambda: dep.deposit_cuda(scratch, y, x, v, 2, dtyp))
        plain_ms = cuda_ms(lambda: dep.deposit_plain(scratch, y, x, v, 2,
                                                      dtyp))
        print(f"K1 {name} {label} N={y.numel()} on {NY}x{NX}: max abs err "
              f"{err:.3e}, / max {rel:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        if not ok:
            raise AssertionError(f"K1 {name} {label} outside tolerance")
        if label.startswith("plasma"):
            results[("K1", name)] = (err, ms, plain_ms)


@phase("K2")
def k2_phase(torch, g, dtype, lanes, results):
    from hipace_tpu_torch.ops import gather as gat
    name = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    NY, NX = g.slice_shape
    ym, xm = lanes
    stack = torch.randn((5, NY, NX), generator=gen, device="cuda",
                        dtype=dtype)
    got = gat.gather_main_cuda(stack, ym, xm, 2)
    ref = gat.gather_main_plain(stack, ym, xm, 2)
    torch.cuda.synchronize()
    ok, err, rel, tol = compare("K2", name, got, ref)
    ms = cuda_ms(lambda: gat.gather_main_cuda(stack, ym, xm, 2))
    plain_ms = cuda_ms(lambda: gat.gather_main_plain(stack, ym, xm, 2))
    print(f"K2 {name} N={ym.numel()} on {NY}x{NX}: max abs err {err:.3e}, "
          f"/ max {rel:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    if not ok:
        raise AssertionError(f"K2 {name} outside tolerance")
    results[("K2", name)] = (err, ms, plain_ms)


@phase("K3")
def k3_phase(torch, g, dtype, results):
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    name = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(4)
    mg = MultiGrid(g.nx, g.ny, g.dx, g.dy, device="cuda", dtype=dtype)
    rhs = torch.randn((2, g.ny, g.nx), generator=gen, device="cuda",
                      dtype=dtype)
    acf = 1.0 + 0.1 * torch.rand((g.ny, g.nx), generator=gen, device="cuda",
                                 dtype=dtype)
    u0 = torch.zeros_like(rhs)
    got = mg_solve(mg, u0, rhs, acf)
    cycles = mg.last_cycles
    ref = mg.solve_plain(u0, rhs, acf)
    plain_cycles = mg.last_cycles
    torch.cuda.synchronize()
    ok, err, rel, tol = compare("K3", name, got, ref)
    ms = cuda_ms(lambda: mg_solve(mg, u0, rhs, acf), reps=3)
    plain_ms = cuda_ms(lambda: mg.solve_plain(u0, rhs, acf), reps=3)
    print(f"K3 {name} C=2 on {g.ny}x{g.nx}, {mg.nlevels} levels: V-cycles "
          f"{cycles} (plain {plain_cycles}); max abs err {err:.3e}, / max "
          f"{rel:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    if not ok or cycles != plain_cycles:
        raise AssertionError(f"K3 {name} outside tolerance or V-cycle counts "
                             "differ")
    results[("K3", name)] = (err, ms, plain_ms)


@phase("reference")
def reference_phase(torch):
    """A 63^2 x 16 float64 step on the kernels against the same step on the
    CPU plain path (which the CPU tests hold to the JAX package)."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(blowout_wake(SMALL_NXY, SMALL_NZ, 4000), device="cpu",
                     verbose=0)
    gpu = Simulation(blowout_wake(SMALL_NXY, SMALL_NZ, 4000), device="cuda",
                     dtype=torch.float64, verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time)
    ref = cpu.run_step(0)
    got = gpu.run_step(0)
    d_ref, d_got = ref["diag"], got["diag"].cpu()
    rel = float((d_got - d_ref).abs().max() / d_ref.abs().max())
    v = ref["binned"]["valid"]
    same_valid = bool((got["binned"]["valid"].cpu() == v).all())
    zrel = float((got["binned"]["uz"].cpu()[v] - ref["binned"]["uz"][v])
                 .abs().max() / ref["binned"]["uz"][v].abs().max())
    ok = rel < 1e-8 and same_valid and zrel < 1e-12 \
        and got["mg_cycles"] == ref["mg_cycles"]
    print(f"reference {SMALL_NXY}^2 x {SMALL_NZ} float64, kernels vs CPU "
          f"plain path: fields max rel err {rel:.3e} (tol 1e-8), beam uz "
          f"{zrel:.3e} (tol 1e-12), same valid lanes {same_valid}, MG "
          f"cycles equal {got['mg_cycles'] == ref['mg_cycles']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("small-step reference mismatch")


@phase("main path")
def main_path(torch, sim, counts):
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    t_timed = 0.0
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_step(step)
        torch.cuda.synchronize()
        if step:
            t_timed += time.perf_counter() - t0
        sim.binned = res["binned"]
        sim.time += sim.dt
        finite = bool(torch.isfinite(res["diag"]).all())
        n = int(sim.binned["valid"].sum())
        print(f"main path step {step}: fields {tuple(res['diag'].shape)} "
              f"finite {finite}, beam particles {n} (start {n0}), MG "
              f"V-cycles per slice {min(res['mg_cycles'])}-"
              f"{max(res['mg_cycles'])}", flush=True)
        if not finite or n != n0:
            raise AssertionError("non-finite fields or beam particles lost")
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches})
    g = sim.geom
    pcfg, bcfg = sim.plasma_cfgs[0], sim.beam_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (pcfg.n_subcycles + bcfg.n_subcycles),
                "K3": g.nz}
    slices = g.nz * (steps - 1)
    print(f"main path {NXY}^2 x {NZ} float32, {NPART} beam particles: "
          f"{slices / t_timed:.3f} slices/s, {1e3 * t_timed / slices:.3f} "
          "ms/slice over 2 timed steps after 1 warm-up", flush=True)
    for k, (fn_name, _, _) in KERNELS.items():
        want = per_step[k] * steps
        print(f"launches {k} {fn_name}: {counts[k]} (slice structure "
              f"predicts {want})", flush=True)
        if counts[k] != want or counts[k] == 0:
            raise AssertionError(f"{k} launch count {counts[k]} != {want}")


def main() -> int:
    if not (ROOT / "hipace_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60)
    smi_line = (smi.stdout.strip().splitlines()[0] if smi.stdout
                else smi.stderr.strip())
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 plain matmuls
    torch.backends.cudnn.allow_tf32 = False

    import hipace_tpu_torch
    if Path(hipace_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print("hipace_tpu_torch was not imported from this checkout",
              file=sys.stderr)
        return 2
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.ops import cuda_lib
    from hipace_tpu_torch.pipeline.simulation import Simulation

    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"build: {' '.join(lib.command)}")
    print(f"build: {'compiled' if lib.built else 'cached'} in "
          f"{lib.build_seconds:.1f} s ({time.perf_counter() - t0:.1f} s "
          "with loading)", flush=True)
    if lib.built:
        (lib.path.parent / "nvcc.log").write_text(lib.compiler_output)
        regs = [int(w) for line in lib.compiler_output.splitlines()
                if "Used" in line and "registers" in line
                for w in [line.split("Used")[1].split()[0]]]
        spills = [line.strip() for line in lib.compiler_output.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes "
                  "spill loads" not in line]
        print(f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers, {len(spills)} with spills {spills[:4]} (full "
              f"log {lib.path.parent / 'nvcc.log'})")

    # the main path's simulation; its geometry sets the kernel phases' shapes
    sim = Simulation(blowout_wake(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    results: dict = {}
    for dtype in (torch.float32, torch.float64):
        lanes = plasma_lanes(torch, g, dtype)
        k1_phase(torch, g, dtype, lanes, results)
        k2_phase(torch, g, dtype, lanes, results)
        k3_phase(torch, g, dtype, results)
    reference_phase(torch)
    counts: dict = {}
    main_path(torch, sim, counts)

    if failures:
        print(f"chip_smoke FAILED phases: {failures}", file=sys.stderr)
        return 1
    kernels = []
    for k, (fn_name, source, replaces) in KERNELS.items():
        err, ms, plain_ms = results[(k, "float32")]
        kernels.append({"name": f"{k} {fn_name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": counts[k], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
