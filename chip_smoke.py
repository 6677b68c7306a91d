"""Build and kernel checks of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 deposit, K2 gather, K3 multigrid, the
fused beam and plasma pushes, the plasma deposit's values) from
``hipace_tpu_torch/csrc`` with nvcc and
prints each kernel's registers, stack frame and spills (K2's order-2 kernels
must use no local memory). Then each kernel alone against its plain PyTorch
version, in float32 and float64, timed on CUDA events beside its bound: K1
and K2 at the main path's shapes (1023^2 grid, ~1.05M plasma lanes, also
shuffled, moved by up to 40 cells and a 30k-lane beam slice), K3 at 1023^2
and on the cell-centered and complex ladders, the Poisson solvers, the fused
beam push on the benchmark's 2047^2 beam slices and the fused plasma push and
the deposit-values kernel on both benchmark cells' 2047^2 species, bit for
bit against their plain versions.

Then the paths at production width (1023^2 or 1024^2 x 64 in float32 unless
stated), each for a few steps with the checks that need that width: the
launches of every kernel against what the slice structure predicts, the
host's synchronizing reads of the device (``sync_counted``), finite fields
and conserved beams, and float32 against float64 where the path has such a
check. The paths: the flagship blowout wake (main), the predictor-corrector
with open boundaries, the pdf beam with output (json files, the in-situ beam
weight), the two-species even deck (and one step on MGDirichlet), drive +
witness beams (K2 on the witness's own lanes), the laser (complex K3, the
peak |a|, the laser's own device time, step 0 against float64 and the plain
float32 step), adaptive dt, ionization (K2 at the ions' x_prev), collisions
(ROADMAP R19 in float32; a float64 step's energy against the same step
without collisions), SALAME (a fresh step 0 with SALAME and step 1 without;
the on-axis Ez spread; K3 on a SALAME solve), mesh refinement (a 511^2
level; K1, K2 and K3 at the level's shapes; a coupler product against the
CPU's), the pipeline (two stages on cuda:0, the final beam against the
serial loop's within PIPE_F32_TOL) and the ranks (two processes on cuda:0
over gloo; with two cards, also one NCCL rank per card). Files go under
``build/chip_smoke``. No phase times whole steps: the benchmark
(``python3 -m benchmark.run``) measures the program.

Card against CPU at small sizes in float64 is the ``gpu`` tests' job
(``tests/test_torch_gpu*.py``), and the float32 physics gate is ``python -m
hipace_tpu_torch.gpu_check``. Each phase prints its seconds. It imports
nothing but the port.

Beside each kernel's time (CUDA events around calls queued behind a device
sleep) it prints the kernel's bound: the least time the card could take, the
larger of the bytes the function must move (each input read once, each
output written once; for K2 the plane cells under the live lanes' stencils)
over the HBM rate and its operations over the peak rate of their type
(NVIDIA's H100 SXM data sheet).

The second-to-last line is a JSON summary of the kernels (per entry its
launches in the path named); the last line is ``{"ok": true, "device":
{...}}``. Any failed phase exits non-zero before that line. Without a usable
GPU, or without the repository beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NXY, NZ = 1023, 64
# the reference deck's beam: nxy^2 * 10 particles per 1000 slices
NPART = NXY * NXY * 10 * NZ // 1000
SMALL_NZ = 16      # the even path's step on MGDirichlet
OUT = ROOT / "build" / "chip_smoke"
# the pdf path's output: an xz diagnostic of every comp and rho, in-situ
# records every step, the beam at the last step
PDF_OUTPUT = """
max_step = 2
hipace.openpmd_backend = json
diagnostic.output_period = 1
diagnostic.diag_type = xz
diagnostic.field_data = all rho
diagnostic.beam_output_period = -1
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""
# in-situ records: (folder, deck key of its prefix, record name)
INSITU = (("insitu", "beam", "beam"), ("plasma_insitu", "plasma", "plasma"),
          ("field_insitu", "fields", "field"))
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

# the fused beam push, beside the three TPU kernels' ports
ALL_KERNELS = dict(KERNELS, **{"beam push": (
    "beam_push", "hipace_tpu_torch/csrc/beam_push.cu",
    "hipace_tpu/particles/beam.py advance_beam_slice (the subcycle loop) and "
    "its K2 calls, hipace_tpu/ops/pallas_banded.py:663"), "plasma push": (
    "plasma_push", "hipace_tpu_torch/csrc/plasma_push.cu",
    "hipace_tpu/particles/plasma.py:619 advance_plasma (the push loop) and "
    "its K2 calls, hipace_tpu/ops/pallas_banded.py:663"), "deposit values": (
    "deposit_values", "hipace_tpu_torch/csrc/deposit_values.cu",
    "the lane algebra of hipace_tpu/particles/plasma.py "
    "fused_plasma_deposits before its K1 call "
    "(hipace_tpu/ops/pallas_banded.py:512) and its gather_laser_aabs, "
    "both on XLA")})

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, non-tensor FLOP/s by itemsize
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


# ~25 ms of device clock cycles: longer than the host takes to enqueue the
# calls that cuda_ms times
SLEEP_CYCLES = 50_000_000

failures: list = []
# the card's name and power limit, as nvidia-smi reports them
CARD = {"line": "not read"}


def phase(name):
    """Run a phase; record and print a failure instead of raising, and print
    the phase's seconds on the host clock."""
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except Exception:
                failures.append(name)
                print(f"FAIL {name}:\n{traceback.format_exc()}", flush=True)
                return None
            finally:
                print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
        return run
    return wrap


def cuda_ms(fn, reps=5):
    """Mean device time of fn() over reps calls after one warm-up call. The
    calls queue behind a sleep on the device, so a call shorter than the
    host's time to enqueue it is timed on the device, not on the host."""
    import torch
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


def wall_ms(fn, reps=5):
    """Mean host time of fn() over reps calls, device work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def bound(nbytes, flops, itemsize):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_flops = 1e3 * flops / PEAK_FLOPS[itemsize]
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def bound_line(kernel, name, ms, nbytes, flops, itemsize):
    b_ms, by = bound(nbytes, flops, itemsize)
    print(f"{kernel} {name} bound: {nbytes / 1e6:.3f} MB moved once, "
          f"{flops / 1e9:.4f} GFLOP -> {b_ms:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s / "
          f"{PEAK_FLOPS[itemsize] / 1e12:.0f} TFLOP/s, bound by {by}; "
          f"kernel {ms:.4f} ms = {100 * b_ms / ms:.1f}% of the bound's rate",
          flush=True)
    return b_ms, by


def compare(kernel, dtype_name, got, ref):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / scale if scale > 0 else err
    tol = TOL[kernel][dtype_name]
    ok = rel <= tol
    return ok, err, rel, tol


def ptxas_kernels(log, demanglers=("c++filt",)):
    """Per entry function of an `nvcc -Xptxas -v` log: [name, registers,
    stack frame bytes, spill store bytes, spill load bytes]; the names
    demangled by the first of `demanglers` that runs."""
    rows, props = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            rows.setdefault(line.split("'")[1], [0, 0, 0, 0])
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "bytes stack frame" in line and props in rows:
            rows[props][1:] = [int(w) for w in re.findall(r"(\d+) bytes",
                                                          line)[:3]]
        elif "Used" in line and "registers" in line and props in rows:
            rows[props][0] = int(line.split("Used")[1].split()[0])
    names = list(rows)
    for tool in demanglers:
        try:
            res = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            # "void ns::kernel<(int)2, float>(float*, ...)" -> "ns::kernel<2, float>"
            names = [re.sub(r"\([^()]*\)\s*$", "", n).replace("(int)", "")
                     .replace("void ", "", 1) for n in res.stdout.splitlines()]
            break
    return [[n] + r for n, r in zip(names, rows.values())]


@phase("ptxas")
def ptxas_phase(log, nvcc):
    """One line per kernel; K2's order-2 kernels keep no stack frame and
    spill nothing."""
    kernels = ptxas_kernels(log, (str(Path(nvcc).parent / "cu++filt"),
                                  "c++filt"))
    if not kernels:
        raise AssertionError("no ptxas lines in the build log")
    for name, regs, stack, stores, loads in kernels:
        print(f"ptxas {name}: {regs} registers, {stack} bytes stack frame, "
              f"{stores} bytes spill stores, {loads} bytes spill loads")
    k2 = [k for k in kernels if "gather_main" in k[0]
          and ("<2," in k[0] or "ILi2E" in k[0])]
    if len(k2) != 2 or any(sum(k[2:]) for k in k2):
        raise AssertionError(f"K2's order-2 kernels use local memory: {k2}")


def beam_k2(sim):
    """K2 launches per slice of the beam pushes on a slice where no fine
    level is active: one per subcycle of each species that keeps the
    subcycle loop; a species that takes the fused beam push launches no K2
    (ops/beam_push.py takes_kernel)."""
    from hipace_tpu_torch.ops.beam_push import takes_kernel
    return sum(c.n_subcycles for c in sim.beam_cfgs if not takes_kernel(c))


def fused_pushes(sim):
    """Fused beam push launches per slice: one per species that takes it."""
    from hipace_tpu_torch.ops.beam_push import takes_kernel
    return sum(takes_kernel(c) for c in sim.beam_cfgs)


def plasma_k2(sim):
    """K2 launches per slice of the plasma pushes on a slice where no fine
    level is active: one per subcycle of each species where the deck's
    pusher keeps the push loop (AB5); the leapfrog takes the fused plasma
    push, which launches no K2 (ops/plasma_push.py takes_kernel)."""
    from hipace_tpu_torch.ops.plasma_push import takes_kernel
    if takes_kernel(sim.cfg.plasma_pusher):
        return 0
    return sum(p.n_subcycles for p in sim.plasma_cfgs)


def plasma_pushes(sim):
    """Fused plasma push launches per slice where no fine level is active:
    one per species where the deck's pusher takes it."""
    from hipace_tpu_torch.ops.plasma_push import takes_kernel
    return (len(sim.plasma_cfgs) if takes_kernel(sim.cfg.plasma_pusher)
            else 0)


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


def lane_cases(torch, g, dtype, lanes):
    """The lanes of the K1 and K2 phases, from one generator: the main
    path's plasma lanes in lattice order, the same shuffled (perm), moved by
    up to 40 cells (fym, fxm), and a gaussian beam slice (bym, bxm), with
    14 plasma and 3 beam channel values for K1."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    NY, _ = g.slice_shape
    ym, xm = lanes
    N = ym.numel()
    c = {"ym": ym, "xm": xm}
    c["vals"] = torch.randn((14, N), generator=gen, device="cuda", dtype=dtype)
    c["perm"] = torch.randperm(N, generator=gen, device="cuda")
    # every lane moved by up to +-40 cells: patches no longer fit a tile
    far = (torch.rand((2, N), generator=gen, device="cuda",
                      dtype=torch.float64) - 0.5) * 80.0
    live = ym < 1.5 * NY
    c["fym"] = torch.where(live, ym + far[0].to(dtype), ym)
    c["fxm"] = xm + far[1].to(dtype)
    # gaussian beam slice: sigma 0.3 of a 16-wide box, ~30k lanes, 15% dead
    nb = 30000
    pos = torch.randn((2, nb), generator=gen, device="cuda",
                      dtype=torch.float64) * (0.3 / g.dx)
    c["bym"] = (pos[0] + g.nguards + g.ny / 2).to(dtype)
    c["bxm"] = (pos[1] + g.nguards + g.nx / 2).to(dtype)
    c["bym"][torch.rand(nb, generator=gen, device="cuda") < 0.15] = 2.0 * NY
    c["bvals"] = torch.randn((2, nb), generator=gen, device="cuda",
                             dtype=dtype)
    return c


@phase("K1")
def k1_phase(torch, g, dtype, lc, results):
    from hipace_tpu_torch.ops import deposit as dep
    name = str(dtype).split(".")[1]
    NY, NX = g.slice_shape
    ym, xm, vals, perm = lc["ym"], lc["xm"], lc["vals"], lc["perm"]
    # label, ym, xm, values, deriv_type, lattice width, results key (the
    # calls whose bound is printed and kept)
    v13 = vals[:13].contiguous()
    b2 = lc["bvals"][:2].contiguous()
    cases = [
        ("plasma C=13 deriv_type 2, lattice order with the hint", ym, xm,
         v13, 2, g.nx, "K1"),
        ("the same lanes, lattice order without the hint", ym, xm, v13, 2,
         None, None),
        ("the same lanes shuffled, no hint", ym[perm], xm[perm],
         v13[:, perm].contiguous(), 2, None, None),
        ("lanes moved by up to 40 cells, with the hint", lc["fym"],
         lc["fxm"], v13, 2, g.nx, None),
        ("gaussian beam C=2 (the PC path's beam Next jx/jy)", lc["bym"],
         lc["bxm"], b2, -1, None, "K1 PC beam C=2"),
        ("plasma C=14 with rho (the pdf path), lattice order with the hint",
         ym, xm, vals, 2, g.nx, None),
        ("plasma C=4 (the PC path's jx/jy/jz/rhomjz), lattice order with "
         "the hint", ym, xm, vals[:4].contiguous(), -1, g.nx,
         "K1 PC plasma C=4"),
        ("plasma C=2 (the PC path's trial jx/jy), lattice order with the "
         "hint", ym, xm, vals[:2].contiguous(), -1, g.nx,
         "K1 PC plasma C=2"),
        ("gaussian beam C=3 (the PC path's beam jx/jy/jz)", lc["bym"],
         lc["bxm"], lc["bvals"], -1, None, "K1 PC beam C=3"),
    ]
    for label, y, x, v, dtyp, width, key in cases:
        C = v.shape[0]
        zero = torch.zeros((C, NY, NX), dtype=dtype, device="cuda")
        dep.reset_block_counts()
        got = dep.deposit_cuda(zero.clone(), y, x, v, 2, dtyp,
                               lattice_width=width)
        direct, blocks = dep.direct_block_count("cuda"), dep.deposit.blocks
        ref = dep.deposit_plain(zero.clone(), y, x, v, 2, dtyp)
        torch.cuda.synchronize()
        ok, err, rel, tol = compare("K1", name, got, ref)
        scratch = zero.clone()
        ms = cuda_ms(lambda: dep.deposit_cuda(scratch, y, x, v, 2, dtyp,
                                              lattice_width=width))
        plain_ms = cuda_ms(lambda: dep.deposit_plain(scratch, y, x, v, 2,
                                                      dtyp))
        print(f"K1 {name} {label} N={y.numel()} on {NY}x{NX}: max abs err "
              f"{err:.3e}, / max {rel:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; direct-path blocks {direct} of "
              f"{blocks}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms",
              flush=True)
        if not ok:
            raise AssertionError(f"K1 {name} {label} outside tolerance")
        if key:
            # lanes and values in, the field stack in and out; per live lane
            # and channel 3 x 3 nonzero taps of a multiply and an add
            size = zero.element_size()
            nbytes = size * ((2 + C) * y.numel() + 2 * C * NY * NX)
            flops = 2 * 9 * C * int((y < 1.5 * NY).sum())
            b_ms, by = bound_line(key, name, ms, nbytes, flops, size)
            results[(key, name)] = (err, ms, plain_ms, b_ms, by)


def stencil_cells(torch, ym, xm, NY, NX, order):
    """Cells of the grid under the live lanes' nodal stencils: what a gather
    of these lanes must read."""
    from hipace_tpu_torch.ops.shape import stencil_i0
    live = ym < 1.5 * NY
    iy0 = stencil_i0(ym[live], order, 1)
    ix0 = stencil_i0(xm[live], order, 1)
    hit = torch.zeros(NY * NX, dtype=torch.bool, device=ym.device)
    for a in range(order + 2):
        for b in range(order + 2):
            r, c = iy0 + a, ix0 + b
            inside = (r >= 0) & (r < NY) & (c >= 0) & (c < NX)
            hit[(r * NX + c)[inside]] = True
    return int(hit.sum())


@phase("K2")
def k2_phase(torch, g, dtype, lc, results):
    from hipace_tpu_torch.ops import gather as gat
    name = str(dtype).split(".")[1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    NY, NX = g.slice_shape
    ym, xm, perm = lc["ym"], lc["xm"], lc["perm"]
    stack = torch.randn((5, NY, NX), generator=gen, device="cuda",
                        dtype=dtype)
    # the five planes as separate tensors, as the pushers pass them
    planes = [p.clone() for p in stack]
    # label, ym, xm, planes: the K1 phase's lanes
    cases = [
        ("plasma, lattice order, five planes", ym, xm, planes),
        ("the same lanes, stack", ym, xm, stack),
        ("the same lanes shuffled, five planes", ym[perm], xm[perm], planes),
        ("lanes moved by up to 40 cells, stack", lc["fym"], lc["fxm"],
         stack),
        ("gaussian beam, five planes", lc["bym"], lc["bxm"], planes),
    ]
    for i, (label, y, x, pl) in enumerate(cases):
        got = gat.gather_main_cuda(pl, y, x, 2)
        ref = gat.gather_main_plain(pl, y, x, 2)
        torch.cuda.synchronize()
        ok, err, rel, tol = compare("K2", name, got, ref)
        dead = y >= 1.5 * NY
        dead_zero = bool((got[:, dead] == 0).all())
        ms = cuda_ms(lambda: gat.gather_main_cuda(pl, y, x, 2))
        plain_ms = cuda_ms(lambda: gat.gather_main_plain(pl, y, x, 2))
        print(f"K2 {name} {label} N={y.numel()} on {NY}x{NX}: max abs err "
              f"{err:.3e}, / max {rel:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; {int(dead.sum())} dead lanes read "
              f"0: {dead_zero}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms",
              flush=True)
        if not ok or not dead_zero:
            raise AssertionError(f"K2 {name} {label} outside tolerance or a "
                                 "dead lane read nonzero")
        if i in (0, 4):
            # the five planes' cells under the live lanes' stencils and the
            # lanes in, six values per lane out; per live lane 6 outputs x
            # 4 x 4 taps of a multiply and an add
            size, N = stack.element_size(), y.numel()
            b_ms, by = bound_line(
                "K2", f"{name} {'plasma' if i == 0 else 'beam'}", ms,
                size * (5 * stencil_cells(torch, y, x, NY, NX, 2) + 8 * N),
                2 * 6 * 16 * int((~dead).sum()), size)
            if i == 0:
                results[("K2", name)] = (err, ms, plain_ms, b_ms, by)


# the fused beam push's cases: (label, nxy, dtype name, lanes); the
# benchmark's explicit.2047 slices hold ~42k beam lanes on average and ~95k
# at the fullest, the 1023^2 flagship's ~30k
PUSH_CASES = (("2047^2, 42k lanes", 2047, "float64", 42_000),
              ("2047^2, 95k lanes", 2047, "float64", 95_000),
              ("1023^2 flagship, 30k lanes", 1023, "float32", 30_000))
# per live lane and subcycle, besides the gather's 2 x 6 x 16: the push's
# multiplies, adds, divisions and roots (three gammas, the half and full
# position steps, the cell positions, the momentum update)
PUSH_FLOPS = 82


def push_lanes(torch, g, n, dtype, min_z):
    """A beam slice of n lanes (benchmark/configs/transverse_explicit.json's
    beam): gaussian x and y (sigma 0.3), z over the slice above min_z, uz
    2000 with a spread, every lane live and at its first subcycle."""
    gen = torch.Generator(device="cuda").manual_seed(n)

    def normal(scale, mean=0.0):
        return (mean + scale * torch.randn(n, generator=gen, device="cuda",
                                           dtype=torch.float64)).to(dtype)

    z = min_z + g.dz * torch.rand(n, generator=gen, device="cuda",
                                  dtype=torch.float64)
    zero = torch.zeros(n, dtype=dtype, device="cuda")
    return {"x": normal(0.3), "y": normal(0.3), "z": z.to(dtype),
            "ux": normal(1.0), "uy": normal(1.0), "uz": normal(20.0, 2000.0),
            "w": torch.full((n,), 1e-3, dtype=dtype, device="cuda"),
            "sx": zero, "sy": zero, "sz": zero,
            "valid": torch.ones(n, dtype=torch.bool, device="cuda"),
            "nsub": torch.zeros(n, dtype=torch.int32, device="cuda"),
            "beam_id": torch.zeros(n, dtype=torch.int32, device="cuda")}


@phase("beam push")
def beam_push_phase(torch, g_flag, results):
    """The fused beam push at the main paths' shapes against its plain
    version (the subcycle loop) on the card: valid and nsub equal, the
    floats within K2's tolerances of each attribute's largest value; its
    device time, its bound and the loop's device and host times."""
    from hipace_tpu_torch.constants import make_constants
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops import beam_push as bpo
    from hipace_tpu_torch.particles.beam import BeamConfig
    from hipace_tpu_torch.particles.plasma import cell_positions
    pc = make_constants(True)
    cfg = BeamConfig(particle_boundary="Periodic")
    for label, nxy, name, n in PUSH_CASES:
        dtype = getattr(torch, name)
        g = g_flag if nxy == g_flag.nx else Geometry(
            (nxy, nxy, 32), (-8.0, -8.0, -6.0), (8.0, 8.0, 2.0))
        min_z = g.prob_lo[2] + (g.nz // 2) * g.dz
        lanes = push_lanes(torch, g, n, dtype, min_z)
        gen = torch.Generator(device="cuda").manual_seed(nxy)
        NY, NX = g.slice_shape
        planes = {c: 0.5 * torch.randn((NY, NX), generator=gen,
                                       device="cuda", dtype=dtype)
                  for c in ("Psi", "Ez", "Bx", "By", "Bz")}

        def kernel():
            return bpo.beam_push_cuda(lanes, planes, g, cfg, pc, 1.0, min_z)

        def plain():
            return bpo.beam_push_plain(lanes, planes, g, cfg, pc, 1.0, min_z)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], ref[k]) for k in ("valid", "nsub"))
        worst = max((compare("K2", name, got[k], ref[k])
                     for k in bpo.LANE_ATTRS), key=lambda c: c[2])
        ok = same and worst[0]
        slipped = int((got["nsub"] > 0).sum())
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        plain_wall = wall_ms(plain)
        print(f"beam push {name} {label} on {NY}x{NX}, {cfg.n_subcycles} "
              f"subcycles: valid and nsub equal {same} ({slipped} lanes "
              f"stopped below min_z), floats max abs err {worst[1]:.3e}, / "
              f"max {worst[2]:.3e} (tol {worst[3]:g}) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms on the device, {plain_wall:.3f} ms host "
              f"wall; {CARD['line']}", flush=True)
        if not ok:
            raise AssertionError(f"beam push {name} {label} differs from "
                                 "the loop")
        # the lanes read and written once (seven floats, valid, nsub) and
        # the five planes' cells under the lanes' stencils at their start
        size = planes["Psi"].element_size()
        ym, xm = cell_positions(lanes["x"], lanes["y"], lanes["valid"], g)
        cells = stencil_cells(torch, ym, xm, NY, NX, 2)
        nbytes = 2 * n * (7 * size + 1 + 4) + 5 * size * cells
        flops = n * cfg.n_subcycles * (2 * 6 * 16 + PUSH_FLOPS)
        b_ms, by = bound_line("beam push", f"{name} {label}", ms, nbytes,
                              flops, size)
        # per dtype the last case's, as for K1 and K2: float32 the flagship's
        results[("beam push", name)] = (worst[1], ms, plain_ms, b_ms, by)


# the fused plasma push's cases: (label, nxy, dtype name, the deck's box,
# laser): the benchmark's two cells' species and the 1023^2 flagship's
PLASMA_PUSH_CASES = (
    ("explicit.2047", 2047, "float64", ((-8.0, -8.0, -6.0), (8.0, 8.0, 2.0)),
     False),
    ("laser.2047", 2047, "float64",
     ((-20.0, -20.0, -7.5), (20.0, 20.0, 6.0)), True),
    ("1023^2 flagship", 1023, "float32", None, False))
# per lane and subcycle at order 2: six substeps of 83 operations (93 with
# the laser; a division counts one), the cell positions, scalings and the
# position push (~22), K2's nodal gather (~360: the weights, 16 taps of six
# sums, the rows' weights); with the laser its |a|^2 gather (~150: the
# weights, 9 taps of three weighted terms, the three sums)
PLASMA_PUSH_FLOPS = 6 * 83 + 22 + 360
LASER_PUSH_FLOPS = 6 * 10 + 150


def species_slice(torch, pl, cfg, g, dtype, laser, seed):
    """A species on g's lattice for the plasma push and deposit-values
    phases: (lanes, fields). The lanes moved by a tenth of a cell, with
    momenta (the half-step ones, which the push reads, and the same as the
    current ones, which the deposit reads); the five planes and, with the
    laser, an |a|^2 plane."""
    gen = torch.Generator(device="cuda").manual_seed(seed + int(laser))

    def noise(shape, scale):
        return (scale * torch.randn(shape, generator=gen, device="cuda",
                                    dtype=torch.float64)).to(dtype)

    p = pl.init_plasma(cfg, g, "cuda", dtype)
    n = p["x"].numel()
    x = p["x"] + noise(n, 0.1 * g.dx)
    y = p["y"] + noise(n, 0.1 * g.dy)
    ux, uy = noise(n, 0.05), noise(n, 0.05)
    psi = 1.0 + noise(n, 0.02).abs()
    p.update(x=x, y=y, x_prev=x, y_prev=y, ux=ux, uy=uy, psi=psi, ux_half=ux,
             uy_half=uy, psi_half=psi)
    NY, NX = g.slice_shape
    f = {c: noise((NY, NX), 0.05) for c in ("Psi", "Ez", "Bx", "By", "Bz")}
    if laser:
        f["aabs"] = (2.0 * torch.rand((NY, NX), generator=gen, device="cuda",
                                      dtype=torch.float64)).to(dtype)
    return p, f


@phase("plasma push")
def plasma_push_phase(torch, g_flag, results):
    """The fused plasma push on the cells' and the flagship's species
    against its plain version (the push loop) on the card: every output
    equal bit for bit; its device time, its bound (the lanes read and
    written once, the planes read once) and the loop's device and host
    times."""
    from hipace_tpu_torch.constants import make_constants
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops import plasma_push as ppo
    from hipace_tpu_torch.particles import plasma as pl
    pc = make_constants(True)
    cfg = pl.PlasmaConfig()
    for label, nxy, name, box, laser in PLASMA_PUSH_CASES:
        dtype = getattr(torch, name)
        g = g_flag if box is None else Geometry((nxy, nxy, 32), *box)
        p, f = species_slice(torch, pl, cfg, g, dtype, laser, nxy)
        NY, NX = g.slice_shape
        n = p["x"].numel()

        def kernel():
            return ppo.plasma_push_cuda(p, f, g, cfg, pc, 2, False, laser)

        def plain():
            return ppo.plasma_push_plain(p, f, g, cfg, pc, 2,
                                         use_laser=laser)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        same = got.keys() == ref.keys() and all(
            torch.equal(got[k], ref[k]) for k in ref)
        err = max(float((got[k].double() - ref[k].double()).abs().max())
                  for k in ppo.LANE_OUT[:-1])
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        plain_wall = wall_ms(plain)
        print(f"plasma push {name} {label} ({'with' if laser else 'no'} "
              f"laser) on {NY}x{NX}, {n} lanes: every output equal {same}, "
              f"floats max abs err {err:.3e} {'ok' if same else 'FAIL'}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms on the device, "
              f"{plain_wall:.3f} ms host wall; {CARD['line']}", flush=True)
        if not same:
            raise AssertionError(f"plasma push {name} {label} differs from "
                                 "the loop")
        # each lane's six floats and valid read and eight floats written
        # (Periodic: w and valid come back as given), the planes read once
        size = p["x"].element_size()
        nbytes = (n * (6 * size + 1 + 8 * size)
                  + (5 + int(laser)) * NY * NX * size)
        flops = n * cfg.n_subcycles * (PLASMA_PUSH_FLOPS
                                       + LASER_PUSH_FLOPS * int(laser))
        b_ms, by = bound_line("plasma push", f"{name} {label}", ms, nbytes,
                              flops, size)
        # per dtype the last case's: float32 the flagship's
        results[("plasma push", name)] = (err, ms, plain_ms, b_ms, by)
        del p, f, got, ref
        torch.cuda.empty_cache()


# per lane: the values' arithmetic (~60 operations: 1/psi, the velocities,
# gamma, the main, coefficient and derivative channels, the positions); with
# the laser its |a|^2 value (~60: the weights and 9 weighted taps at order 2)
VALUES_FLOPS = 60
LASER_VALUES_FLOPS = 60


@phase("deposit values")
def deposit_values_phase(torch, g_flag, results):
    """The deposit-values kernel on the cells' and the flagship's species
    (PLASMA_PUSH_CASES, the cells' four main channels) against its plain
    version (the lane algebra) on the card: the rows, positions, w and
    valid equal bit for bit; its device time, its bound (the lanes read
    and the rows, positions, w and valid written once, the |a|^2 plane read
    once) and the plain version's device and host times."""
    from hipace_tpu_torch.constants import make_constants
    from hipace_tpu_torch.geometry import Geometry
    from hipace_tpu_torch.ops import deposit_values as dvo
    from hipace_tpu_torch.particles import plasma as pl
    pc = make_constants(True)
    cfg = pl.PlasmaConfig()
    comps = ["jx", "jy", "chi", "rhomjz"]
    for label, nxy, name, box, laser in PLASMA_PUSH_CASES:
        dtype = getattr(torch, name)
        g = g_flag if box is None else Geometry((nxy, nxy, 32), *box)
        p, f = species_slice(torch, pl, cfg, g, dtype, laser, nxy)
        NY, NX = g.slice_shape
        n = p["x"].numel()
        args = (p, comps, f, g, cfg, pc, 2, True)

        def kernel():
            return dvo.deposit_values_cuda(*args, use_laser=laser)

        def plain():
            return dvo.deposit_values_plain(*args, use_laser=laser)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got[:4], ref[:4]))
        C = got[0].shape[0]
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        plain_wall = wall_ms(plain)
        print(f"deposit values {name} {label} ({'with' if laser else 'no'} "
              f"laser, C = {C}) on {NY}x{NX}, {n} lanes: every output equal "
              f"{same}, floats max abs err {err:.3e} "
              f"{'ok' if same else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms on the device, {plain_wall:.3f} ms host "
              f"wall; {CARD['line']}", flush=True)
        if not same:
            raise AssertionError(f"deposit values {name} {label} differ "
                                 "from the plain version")
        # each lane's six floats and valid read, C rows, two positions and
        # w written and valid written, the |a|^2 plane read once
        size = p["x"].element_size()
        nbytes = (n * (6 * size + 1 + (C + 3) * size + 1)
                  + int(laser) * NY * NX * size)
        flops = n * (VALUES_FLOPS + LASER_VALUES_FLOPS * int(laser))
        b_ms, by = bound_line("deposit values", f"{name} {label}", ms,
                              nbytes, flops, size)
        # per dtype the last case's: float32 the flagship's
        results[("deposit values", name)] = (err, ms, plain_ms, b_ms, by)
        del p, f, got, ref
        torch.cuda.empty_cache()


def k3_case(torch, dtype, ny, nx, dx, dy, C, acf_kind, max_iters, seed):
    """One solve on the kernel and on the plain version: (label, mg, args,
    kwargs, got, ref, cycles, plain cycles, device launches)."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mg = MultiGrid(nx, ny, dx, dy, device="cuda", dtype=dtype)
    shape = (C, ny, nx) if C else (ny, nx)
    rhs = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    acf = 1.0 + 0.1 * torch.rand((ny, nx), generator=gen, device="cuda",
                                 dtype=dtype) if acf_kind == "2-D" else 1.05
    u0 = torch.zeros_like(rhs)
    kwargs = {"max_iters": max_iters}
    before = mg_solve.kernel_launches
    got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kwargs)
    launches = mg_solve.kernel_launches - before
    ref = mg.solve_plain(u0, rhs, acf, **kwargs)
    torch.cuda.synchronize()
    label = (f"C={C or 'none'} on {ny}x{nx}, {mg.nlevels} levels, {acf_kind} "
             f"acf, max_iters {max_iters}")
    return (label, mg, (u0, rhs, acf), kwargs, got, ref, int(cycles),
            mg.last_cycles, launches)


@phase("K3")
def k3_phase(torch, g, dtype, results):
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    name = str(dtype).split(".")[1]
    # (ny, nx, C, acf, max_iters); the first is the main path's solve
    cases = [(g.ny, g.nx, 2, "2-D", 40), (g.ny, g.nx // 2, 1, "2-D", 40),
             (g.ny, g.nx, 2, "scalar", 40), (g.ny, g.nx, 0, "2-D", 2)]
    for i, (ny, nx, C, acf_kind, max_iters) in enumerate(cases):
        (label, mg, args, kwargs, got, ref, cycles, plain_cycles,
         launches) = k3_case(torch, dtype, ny, nx, g.dx, g.dy, C, acf_kind,
                             max_iters, 4 + i)
        ok, err, rel, tol = compare("K3", name, got, ref)
        print(f"K3 {name} {label}: V-cycles {cycles} (plain {plain_cycles}), "
              f"device launches per solve {launches}; max abs err {err:.3e}, "
              f"/ max {rel:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok or cycles != plain_cycles or launches > 3:
            raise AssertionError(f"K3 {name} {label}: outside tolerance, "
                                 "V-cycle counts differ or too many launches")
        if max_iters == 2 and cycles != 2:
            raise AssertionError(f"K3 {name} {label} did not end at max_iters")
        if i:
            continue
        ms = cuda_ms(lambda: mg_solve(mg, *args, **kwargs), reps=10)
        host_ms = wall_ms(lambda: mg_solve(mg, *args, **kwargs), reps=10)
        plain_ms = cuda_ms(lambda: mg.solve_plain(*args, **kwargs), reps=3)
        print(f"K3 {name} main-path solve: kernel {ms:.3f} ms between events, "
              f"{host_ms:.3f} ms on the host clock; plain {plain_ms:.3f} ms",
              flush=True)
        # u0, rhs and acf in, u out; per V-cycle and cell of every level the
        # sweeps (7 operations each), the residual (9), the transfers (~5)
        size = got.element_size()
        cells = sum(h * w for h, w in mg.shapes)
        nbytes = size * (3 * C + 1) * ny * nx
        flops = cycles * C * cells * (7 * 4 + 9 + 5)
        b_ms, by = bound_line("K3", name, ms, nbytes, flops, size)
        results[("K3", name)] = (err, ms, plain_ms, b_ms, by)


# the cell-centered K3 phase's grids (ny, nx): full width (the even path's
# Bx/By solve), a 2:1 grid, a ladder ending at 3 cells, two small ones
CC_GRIDS = ((1024, 1024), (512, 1024), (64, 96), (32, 64), (32, 32))
CC_TOL = {"float32": 1e-5, "float64": 1e-12}


@phase("K3 cell-centered")
def k3_cc_phase(torch, results):
    """K3's cell-centered levels (even sizes) against solve_plain on the
    card, float32 and float64: every grid of CC_GRIDS with C = 2 and a 2-D
    acf (the Bx/By solve) and C = 3 with a scalar acf 0 at MGDirichlet's
    tol_rel 1e-11; equal V-cycle counts; the full-width shapes timed."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    dx = dy = 16.0 / 1024
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for i, (ny, nx) in enumerate(CC_GRIDS):
            mg = MultiGrid(nx, ny, dx, dy, device="cuda", dtype=dtype)
            gen = torch.Generator(device="cuda").manual_seed(8 + i)
            for C, acf_kind, tol_rel, key in (
                    (2, "2-D", 1e-4, "K3 CC Bx/By"),
                    (3, "scalar", 1e-11, "K3 CC MGDirichlet")):
                rhs = torch.randn((C, ny, nx), generator=gen, device="cuda",
                                  dtype=dtype)
                acf = (1.0 + 0.1 * torch.rand((ny, nx), generator=gen,
                                              device="cuda", dtype=dtype)
                       if acf_kind == "2-D" else 0.0)
                u0 = torch.zeros_like(rhs)
                kw = {"tol_rel": tol_rel, "max_iters": 40}
                before = mg_solve.kernel_launches
                got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kw)
                launches = mg_solve.kernel_launches - before
                cycles = int(cycles)
                ref = mg.solve_plain(u0, rhs, acf, **kw)
                plain_cycles = mg.last_cycles
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rel = err / float(ref.abs().max())
                ok = (rel <= CC_TOL[name] and cycles == plain_cycles
                      and launches <= 3)
                print(f"K3 {name} cell-centered C={C} on {ny}x{nx}, "
                      f"{mg.nlevels} levels down to {mg.shapes[-1]}, "
                      f"{acf_kind} acf, tol_rel {tol_rel:g}: V-cycles "
                      f"{cycles} (plain {plain_cycles}), device launches "
                      f"{launches}; max abs err {err:.3e}, / max {rel:.3e} "
                      f"(tol {CC_TOL[name]:g}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"K3 {name} cell-centered C={C} on "
                                         f"{ny}x{nx}: outside tolerance, "
                                         "V-cycle counts differ or too many "
                                         "launches")
                if i:
                    continue
                args = (mg, u0, rhs, acf)
                ms = cuda_ms(lambda: mg_solve(*args, **kw), reps=5)
                plain_ms = cuda_ms(lambda: mg.solve_plain(*args[1:], **kw),
                                   reps=1)
                print(f"K3 {name} cell-centered {key[6:]} solve: kernel "
                      f"{ms:.3f} ms ({ms / max(cycles, 1):.4f} per V-cycle),"
                      f" plain {plain_ms:.3f} ms", flush=True)
                # as k3_phase: u0 (C = 2), rhs and acf in, u out; per
                # V-cycle and cell of every level ~42 operations
                size = got.element_size()
                cells = sum(h * w for h, w in mg.shapes)
                planes = 3 * C + 1 if acf_kind == "2-D" else 2 * C
                b_ms, by = bound_line(f"{key}", name, ms,
                                      size * planes * ny * nx,
                                      cycles * C * cells * (7 * 4 + 9 + 5),
                                      size)
                results[(key, name)] = (err, ms, plain_ms, b_ms, by)


@phase("main path")
def main_path(torch, sim, counts):
    from hipace_tpu_torch.ops.deposit import (deposit, direct_block_count,
                                              reset_block_counts)
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.beam_push import beam_push
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.ops.deposit_values import deposit_values
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.particles.beam import advance_beam_slice
    from hipace_tpu_torch.particles.plasma import advance_plasma
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve, beam_push, plasma_push,
               deposit_values):
        fn.launches = 0
    advance_beam_slice.general_calls = 0
    advance_plasma.general_calls = 0
    mg_solve.kernel_launches = 0
    reset_block_counts()
    for step in range(steps):
        res = sim.run_step(step)
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
                   "K3": mg_solve.launches, "beam push": beam_push.launches,
                   "beam loop": advance_beam_slice.general_calls,
                   "plasma push": plasma_push.launches,
                   "plasma loop": advance_plasma.general_calls,
                   "deposit values": deposit_values.launches})
    mg_launches = mg_solve.kernel_launches
    direct, blocks = direct_block_count("cuda"), deposit.blocks
    g = sim.geom
    pcfg = sim.plasma_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (plasma_k2(sim) + beam_k2(sim)),
                "K3": g.nz, "beam push": g.nz * fused_pushes(sim),
                "beam loop": 0, "plasma push": g.nz * plasma_pushes(sim),
                "plasma loop": 0,
                "deposit values": g.nz * len(sim.plasma_cfgs)}
    print(f"main path K1 blocks on the direct path: {direct} of {blocks} "
          f"({100 * direct / blocks:.2f}%)", flush=True)
    print(f"main path K3 device launches per solve: "
          f"{mg_launches / counts['K3']:.2f}", flush=True)
    if mg_launches > 3 * counts["K3"]:
        raise AssertionError("a multigrid solve took more than 3 launches")
    for k, fn_name in [(k, v[0]) for k, v in KERNELS.items()] + [
            ("beam push", "beam_push"), ("beam loop", "general_calls"),
            ("plasma push", "plasma_push"), ("plasma loop", "general_calls"),
            ("deposit values", "deposit_values")]:
        want = per_step[k] * steps
        print(f"launches {k} {fn_name}: {counts[k]} (slice structure "
              f"predicts {want})", flush=True)
        if counts[k] != want or (counts[k] == 0
                                 and k not in ("K2", "beam loop",
                                               "plasma loop")):
            raise AssertionError(f"{k} launch count {counts[k]} != {want}")


@phase("PC path")
def pc_path(torch, counts):
    """PC_OPEN at 1023^2 x 64 in float32 for three steps, the host's
    synchronizing reads of the device counted in the first; finite fields,
    the beam conserved, the launch counts against the run's own iterations."""
    from hipace_tpu_torch.decks import pc_open
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(pc_open(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    pcfg = sim.plasma_cfgs[0]
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve, plasma_push):
        fn.launches = 0
    iters, copies = [], None
    for step in range(steps):
        if step == 0:
            # every read of a device value by the host synchronizes: count
            # them through the sync debug mode's warnings
            res, copies = sync_counted(torch, lambda: sim.run_step(step))
        else:
            res = sim.run_step(step)
        sim.binned = res["binned"]
        sim.time += sim.dt
        iters.append(res["pc_iters"])
        finite = bool(torch.isfinite(res["diag"]).all())
        n = int(sim.binned["valid"].sum())
        print(f"PC path step {step}: fields {tuple(res['diag'].shape)} "
              f"finite {finite}, beam particles {n} (start {n0}), "
              f"iterations {sum(res['pc_iters'])} ({min(res['pc_iters'])}-"
              f"{max(res['pc_iters'])} per slice), last error per slice "
              f"{min(res['pc_err']):.3e}-{max(res['pc_err']):.3e}",
              flush=True)
        if not finite or n != n0:
            raise AssertionError("non-finite fields or beam particles lost")
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches,
                   "plasma push": plasma_push.launches})
    total = sum(map(sum, iters))
    flat = sorted(i for it in iters for i in it)
    median = flat[len(flat) // 2]
    print(f"PC path iterations per slice over {steps} steps: min {flat[0]}, "
          f"median {median}, max {flat[-1]}, total {total}, mean "
          f"{total / len(flat):.3f}", flush=True)
    mean0 = sum(iters[0]) / g.nz
    print(f"PC path device-to-host copies per slice (synchronizing reads, "
          f"first step): {copies / g.nz:.3f}, with {mean0:.3f} iterations "
          f"per slice (at least the beam's 2 + iterations = "
          f"{2 + mean0:.3f}; limit 2.05 + iterations + 0.1 = "
          f"{2.15 + mean0:.3f})", flush=True)
    want = {"K1": steps * (g.nz * 2 + int(pcfg.neutralize_background))
            + 2 * total,
            "K2": steps * g.nz * (plasma_k2(sim) + beam_k2(sim))
            + plasma_k2(sim) * total,
            "K3": 0,
            "plasma push": (steps * g.nz + total) * plasma_pushes(sim)}
    for k, count in counts.items():
        print(f"PC path launches {k}: {count} (slice structure and the run's "
              f"iterations predict {want[k]})", flush=True)
    if counts != want or not 2 + mean0 <= copies / g.nz <= 2.15 + mean0:
        raise AssertionError("PC path launch counts or device-to-host "
                             "copies wrong")


@phase("Poisson solvers")
def poisson_phase(torch, g, results):
    """MGDirichlet through K3 at 1023^2, C=3, scalar acf 0, in float32 and
    float64 against solve_plain on the card, equal V-cycle counts; the open
    boundary's apply at C=2 and 3 timed."""
    from hipace_tpu_torch.fields.open_boundary import OpenBoundary
    from hipace_tpu_torch.fields.poisson import MGDirichletPoissonSolver
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        gen = torch.Generator(device="cuda").manual_seed(6)
        solver = MGDirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy,
                                          device="cuda", dtype=dtype)
        mg = solver.mg
        rhs = torch.randn((3, g.ny, g.nx), generator=gen, device="cuda",
                          dtype=dtype)
        before = mg_solve.launches
        got = solver.solve(rhs)
        cycles = mg.last_cycles
        launched = mg_solve.launches - before
        ref = mg.solve_plain(torch.zeros_like(rhs), rhs, 0.0,
                             tol_rel=solver.tol_rel)
        plain_cycles = mg.last_cycles
        ok, err, rel, tol = compare("K3", name, got, ref)
        ms = cuda_ms(lambda: solver.solve(rhs), reps=3)
        plain_ms = cuda_ms(lambda: mg.solve_plain(
            torch.zeros_like(rhs), rhs, 0.0, tol_rel=solver.tol_rel), reps=1)
        print(f"K3 {name} MGDirichlet C=3 on {g.ny}x{g.nx}, scalar acf 0, "
              f"tol_rel {solver.tol_rel:g}: V-cycles {cycles} (plain "
              f"{plain_cycles}), K3 solves {launched}; max abs err "
              f"{err:.3e}, / max {rel:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        if not ok or cycles != plain_cycles or launched != 1:
            raise AssertionError(f"K3 {name} MGDirichlet mismatch")
        size = got.element_size()
        cells = sum(h * w for h, w in mg.shapes)
        # rhs in, u out; per V-cycle and cell of every level as K3's bound
        b_ms, by = bound_line("K3 PC MGDirichlet C=3", name, ms,
                              size * 2 * 3 * g.ny * g.nx,
                              cycles * 3 * cells * (7 * 4 + 9 + 5), size)
        results[("K3 PC MGDirichlet C=3", name)] = (err, ms, plain_ms, b_ms,
                                                    by)
    ob = OpenBoundary(g, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for C in (2, 3):
        rhs = torch.randn((C, g.ny, g.nx), generator=gen, device="cuda")
        ms = cuda_ms(lambda: ob.apply(rhs, True), reps=10)
        print(f"OpenBoundary.apply float32 C={C} on {g.ny}x{g.nx}: {ms:.4f} "
              f"ms per call (source table {ob.src_table.numel() * 4 / 1e6:.1f}"
              f" MB; matmul TF32 {torch.backends.cuda.matmul.allow_tf32}, "
              f"float32 matmul precision "
              f"{torch.get_float32_matmul_precision()})", flush=True)


EVEN_NXY = 1024          # ION_MOTION_EVEN's full width


@phase("even path")
def even_path(torch, counts):
    """ION_MOTION_EVEN at 1024^2 x 64 in float32 for three steps; finite
    fields, the beam conserved, V-cycles per slice, the K1/K2/
    K3 launches against the slice structure with two species. Then one
    1024^2 x 16 step of the deck on MGDirichlet (cell-centered K3 at C = 3
    for the Poisson solve), its K3 solves counted."""
    from hipace_tpu_torch.decks import ion_motion_even
    from hipace_tpu_torch.ops.deposit import (deposit, direct_block_count,
                                              reset_block_counts)
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(ion_motion_even(EVEN_NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve, plasma_push):
        fn.launches = 0
    reset_block_counts()
    res = run_steps(sim, steps)
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches,
                   "plasma push": plasma_push.launches})
    direct, blocks = direct_block_count("cuda"), deposit.blocks
    print(f"even path K1 blocks on the direct path: {direct} of {blocks} "
          f"({100 * direct / blocks:.2f}%)", flush=True)
    n = int(sim.binned["valid"].sum())
    finite = bool(torch.isfinite(res["diag"]).all())
    cyc = res["mg_cycles"]
    lanes = [int(p.ppc[0] * p.ppc[1] * g.nx * g.ny) for p in sim.plasma_cfgs]
    print(f"even path {EVEN_NXY}^2 x {NZ} float32, {NPART} beam particles, "
          f"species {[p.name for p in sim.plasma_cfgs]} with {lanes} lanes, "
          f"cell-centered {sim.slice_step.mg.cell_centered} ("
          f"{sim.slice_step.mg.nlevels} levels): fields "
          f"{tuple(res['diag'].shape)} finite {finite}, beam particles {n} "
          f"(start {n0}), V-cycles per slice {min(cyc)}-{max(cyc)} (mean "
          f"{sum(cyc) / len(cyc):.3f}, last step)", flush=True)
    cfgs = sim.plasma_cfgs
    per_step = {
        "K1": sum(int(p.neutralize_background) for p in cfgs)
        + g.nz * (len(cfgs) + 2),
        "K2": g.nz * (plasma_k2(sim) + beam_k2(sim)),
        "K3": g.nz, "plasma push": g.nz * plasma_pushes(sim)}
    for k, count in counts.items():
        print(f"even path launches {k}: {count} (slice structure with "
              f"{len(cfgs)} species predicts {per_step[k] * steps})",
              flush=True)
    del res, sim
    torch.cuda.empty_cache()
    mgd = Simulation(ion_motion_even(
        EVEN_NXY, SMALL_NZ, NPART // 4, "fields.poisson_solver = "
        "MGDirichlet\n"), device="cuda", dtype=torch.float32, verbose=0)
    mg_solve.launches = 0
    mres = mgd.run_step(0)
    mg_finite = bool(torch.isfinite(mres["diag"]).all())
    counts["K3 MGDirichlet"] = mg_solve.launches - SMALL_NZ
    print(f"even path on MGDirichlet, {EVEN_NXY}^2 x {SMALL_NZ} float32: "
          f"K3 solves {mg_solve.launches} (Bx/By and Poisson per slice: "
          f"{2 * SMALL_NZ} predicted), fields finite {mg_finite}",
          flush=True)
    if (not finite or n != n0 or not mg_finite
            or mg_solve.launches != 2 * SMALL_NZ
            or any(c != per_step[k] * steps for k, c in counts.items()
                   if k in per_step)):
        raise AssertionError("even path: fields, beam or launch counts "
                             "wrong")


@phase("witness path")
def witness_path(torch, counts, results):
    """DRIVE_WITNESS at 1023^2 x 64 in float32 for three steps; finite
    fields and momenta, each beam's count conserved (by
    beam_id), the witness's |s| within 1e-5 of 1, the K1/K2/K3 launches
    against the slice structure with two beam species (the beam pushes'
    K2 launches counted apart: the witness's loop; the drive's fused beam
    push counted too); then K2 on the witness path's own beam
    lanes (its fullest witness slice, the witness pass) against its plain
    version, timed, with its bound."""
    from hipace_tpu_torch.decks import drive_witness
    from hipace_tpu_torch.ops import gather as gat
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.beam_push import beam_push
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.particles import beam as bm
    from hipace_tpu_torch.particles.plasma import cell_positions
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(drive_witness(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    nb = len(sim.beam_cfgs)

    def per_beam(binned):
        v, bid = binned["valid"], binned["beam_id"]
        return [int((v & (bid == i)).sum()) for i in range(nb)]

    n0 = per_beam(sim.binned)
    steps = 3
    # the beam pushes' K2 launches, counted around each push
    beam_k2_calls = [0]
    orig = bm.advance_all_beams

    def counted(*args, **kwargs):
        before = gather_main.launches
        out = orig(*args, **kwargs)
        beam_k2_calls[0] += gather_main.launches - before
        return out

    for fn in (deposit, gather_main, mg_solve, beam_push):
        fn.launches = 0
    bm.advance_all_beams = counted
    try:
        res = run_steps(sim, steps)
    finally:
        bm.advance_all_beams = orig
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches, "K2 beam": beam_k2_calls[0],
                   "beam push": beam_push.launches})
    b = sim.binned
    n = per_beam(b)
    finite = bool(torch.isfinite(res["diag"]).all()) and all(
        bool(torch.isfinite(b[k][b["valid"]]).all())
        for k in bm.BEAM_ATTRS)
    wit = b["valid"] & (b["beam_id"] == 1)
    snorm = torch.sqrt(b["sx"][wit].double() ** 2 + b["sy"][wit].double() ** 2
                       + b["sz"][wit].double() ** 2)
    sdev = float((snorm - 1.0).abs().max())
    turned = float((b["sx"][wit].double() - 1.0).abs().max())
    gam = torch.sqrt(1.0 + (b["ux"][wit].double() ** 2
                            + b["uy"][wit].double() ** 2
                            + b["uz"][wit].double() ** 2))
    cyc = res["mg_cycles"]
    print(f"witness path {NXY}^2 x {NZ} float32, beams "
          f"{[c.name for c in sim.beam_cfgs]} with {n0} particles, "
          f"subcycles {[c.n_subcycles for c in sim.beam_cfgs]}: fields "
          f"{tuple(res['diag'].shape)} and beams finite {finite}, particles "
          f"per beam after {steps} steps {n} (start {n0}), witness |s| - 1 "
          f"max {sdev:.3e} (tol 1e-5), spin turned by up to {turned:.3e}, "
          f"witness mean gamma {float(gam.mean()):.6f}, V-cycles per slice "
          f"{min(cyc)}-{max(cyc)} (last step); {CARD['line']}", flush=True)
    pcfg = sim.plasma_cfgs[0]
    # the drive beam takes the fused push, the witness (spin, radiation
    # reaction) keeps the subcycle loop
    sub = beam_k2(sim)
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (plasma_k2(sim) + sub), "K3": g.nz,
                "K2 beam": g.nz * sub, "beam push": g.nz * fused_pushes(sim)}
    for k, count in counts.items():
        print(f"witness path launches {k}: {count} (slice structure with "
              f"{nb} beam species predicts {per_step[k] * steps}; per slice "
              f"K2 {plasma_k2(sim)} + {sub} (the loops' subcycles), "
              f"{fused_pushes(sim)} fused beam push)", flush=True)
    # K2 on the witness pass's lanes of the slice that holds most of the
    # witness: every lane of the merged slice, the drive's dead
    fullest = int((b["valid"] & (b["beam_id"] == 1)).sum(1).argmax())
    lanes = {k: v[fullest] for k, v in b.items() if torch.is_tensor(v)}
    mask = lanes["valid"] & (lanes["beam_id"] == 1)
    ym, xm = cell_positions(lanes["x"], lanes["y"], mask, g)
    NY, NX = g.slice_shape
    gen = torch.Generator(device="cuda").manual_seed(9)
    planes = [torch.randn((NY, NX), generator=gen, device="cuda")
              for _ in range(5)]
    got = gat.gather_main_cuda(planes, ym, xm, 2)
    ref = gat.gather_main_plain(planes, ym, xm, 2)
    torch.cuda.synchronize()
    ok, err, rel, tol = compare("K2", "float32", got, ref)
    ms = cuda_ms(lambda: gat.gather_main_cuda(planes, ym, xm, 2))
    plain_ms = cuda_ms(lambda: gat.gather_main_plain(planes, ym, xm, 2))
    live = int(mask.sum())
    print(f"K2 float32 witness path beam lanes (slice {fullest}, witness "
          f"pass) N={ym.numel()}, {live} live: max abs err {err:.3e}, / max "
          f"{rel:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms; {CARD['line']}",
          flush=True)
    b_ms, by = bound_line("K2 witness beam", "float32", ms,
                          4 * (5 * stencil_cells(torch, ym, xm, NY, NX, 2)
                               + 8 * ym.numel()),
                          2 * 6 * 16 * live, 4)
    results[("K2 witness beam", "float32")] = (err, ms, plain_ms, b_ms, by)
    if (not finite or n != n0 or sdev > 1e-5 or not ok
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("witness path: fields, beams, spin, K2 or "
                             "launch counts wrong")


# ------------------------------------------------------- the laser, adaptive dt
# complex K3: (ny, nx) grids; the first of each convention is timed
K3C_GRIDS = ((1023, 1023), (255, 255), (31, 63), (1024, 1024), (64, 96),
             (32, 32))
LASER_NZ = 64


def laser_acf(torch, mg, gen, dtype):
    """The laser's multigrid system on mg's grid as LaserAdvance builds it
    for LASER_WAKE (c = 1, dt = 1, dz = 13.5 / 64, lambda0 0.8e-6 in the
    deck's units, djn = 0): a random complex rhs and first guess, the real
    plane chi + 3 / (c dt dz) + 2 / (c dt)^2 with a plasma chi of ~1, and
    the imaginary scalar -2 k0 / (c dt) as a 0-d device tensor."""
    import math
    ny, nx = mg.shapes[0]
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    rhs = torch.randn((ny, nx), generator=gen, device="cuda", dtype=ctype)
    u0 = 0.5 * torch.randn((ny, nx), generator=gen, device="cuda",
                           dtype=ctype)
    chi = 1.0 + 0.2 * torch.rand((ny, nx), generator=gen, device="cuda",
                                 dtype=dtype)
    dz = 13.5 / LASER_NZ
    acf_r = 3.0 / dz + 2.0 + chi
    ai = torch.tensor(-2.0 * 2.0 * math.pi / 0.8e-6, device="cuda",
                      dtype=dtype)
    return u0, rhs, (acf_r, torch.complex(torch.zeros_like(ai), ai)), chi


@phase("K3 complex")
def k3_complex_phase(torch, results):
    """Complex K3 (the laser envelope's solve) against solve_plain on the
    card, float32 and float64, node-centered (1023^2 with the laser's own
    acf, 255^2, 63 x 31) and cell-centered (1024^2, 96 x 64, 32^2), at the
    laser's tolerance 1e-4 and at 1e-9; equal V-cycle counts; the two
    full-width solves timed, beside a real C = 2 solve on the same grid."""
    from hipace_tpu_torch.fields.multigrid import MultiGrid
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    dx = dy = 40.0 / 1024
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for i, (ny, nx) in enumerate(K3C_GRIDS):
            mg = MultiGrid(nx, ny, dx, dy, device="cuda", dtype=dtype)
            gen = torch.Generator(device="cuda").manual_seed(20 + i)
            u0, rhs, acf, chi = laser_acf(torch, mg, gen, dtype)
            for tol_rel in (1e-4, 1e-9):
                kw = {"tol_rel": tol_rel, "max_iters": 40}
                before = mg_solve.complex_launches
                got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kw)
                cycles = int(cycles)
                ref = mg.solve_plain(u0, rhs, acf, **kw)
                plain_cycles = mg.last_cycles
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rel = err / float(ref.abs().max())
                ok = (rel <= CC_TOL[name] and cycles == plain_cycles
                      and mg_solve.complex_launches == before + 1)
                print(f"K3 complex {name} "
                      f"{'cell' if mg.cell_centered else 'node'}-centered "
                      f"on {ny}x{nx}, {mg.nlevels} levels, tol_rel "
                      f"{tol_rel:g}: V-cycles {cycles} (plain "
                      f"{plain_cycles}); max abs err {err:.3e}, / max "
                      f"{rel:.3e} (tol {CC_TOL[name]:g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"K3 complex {name} {ny}x{nx}: "
                                         "outside tolerance or V-cycle "
                                         "counts differ")
            if i not in (0, 3):
                continue
            kw = {"tol_rel": 1e-4, "max_iters": 40}
            got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kw)
            cycles = int(cycles)
            ms = cuda_ms(lambda: mg_solve(mg, u0, rhs, acf, **kw), reps=10)
            plain_ms = cuda_ms(lambda: mg.solve_plain(u0, rhs, acf, **kw),
                               reps=2)
            # the real C = 2 solve on the same grid and the real acf plane,
            # run for the same number of V-cycles
            real_rhs = torch.stack([rhs.real, rhs.imag]).contiguous()
            real_kw = {"tol_rel": 0.0, "max_iters": max(cycles, 1)}
            real_ms = cuda_ms(lambda: mg_solve(
                mg, torch.zeros_like(real_rhs), real_rhs, acf[0],
                **real_kw), reps=10)
            key = "K3 complex" + (" CC" if mg.cell_centered else "")
            print(f"{key} {name} {ny}x{nx} solve: kernel {ms:.3f} ms for "
                  f"{cycles} V-cycles ({ms / max(cycles, 1):.4f} per "
                  f"V-cycle), plain {plain_ms:.3f} ms; the real C=2 solve "
                  f"on the same grid {real_ms:.3f} ms for "
                  f"{real_kw['max_iters']} V-cycles "
                  f"({real_ms / real_kw['max_iters']:.4f} per V-cycle); "
                  f"{CARD['line']}", flush=True)
            # u0 and rhs (two planes each), the acf's real plane and its
            # imaginary scalar in, u (two planes) out; per V-cycle and cell
            # of every level ~4 complex half-sweeps of 16 operations, the
            # residual (18) and the transfers (10)
            size = torch.empty((), dtype=dtype).element_size()
            cells = sum(h * w for h, w in mg.shapes)
            b_ms, by = bound_line(key, name, ms, size * (7 * ny * nx + 1),
                                  cycles * cells * (16 * 4 + 18 + 10), size)
            results[(key, name)] = (err, ms, plain_ms, b_ms, by)


def sync_counted(torch, fn):
    """fn() and the host's synchronizing reads of the device during it,
    counted through the sync debug mode's warnings (its own notice that it
    is a prototype, which some torch versions give on being turned on,
    is not a read)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


@phase("laser path")
def laser_path(torch, counts, results):
    """LASER_WAKE at 1023^2 x 64 in float32 for three steps, the host's reads
    of the device counted in the first; the launches of K1, K2, real and
    complex K3 against the slice structure, finite fields and envelope, the
    peak |a| of step 0 within 5% of a0; the laser's own device time per
    slice from its own calls; step 0 against the same step in float64 and
    in float32 on the plain versions."""
    import math
    from hipace_tpu_torch.decks import laser_wake
    from hipace_tpu_torch.ops import deposit_values as dvo
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.ops.plasma_push import plasma_push
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(laser_wake(NXY, LASER_NZ), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    a0 = sim.laser_cfg.pulses[0].a0
    steps = 3
    for fn in (deposit, gather_main, mg_solve, plasma_push,
               dvo.deposit_values):
        fn.launches = 0
    mg_solve.complex_launches = 0
    peaks, copies = [], None
    for step in range(steps):
        if step == 0:
            res, copies = sync_counted(torch, lambda: sim.run_step(0))
        else:
            res = sim.run_step(step)
        sim.time += sim.dt
        n00, np1 = res["laser_stream"][1], res["laser_stream"][0]
        if step == 0:       # held against the float64 step below
            diag0, env0 = res["diag"].clone(), np1.clone()
        finite = (bool(torch.isfinite(res["diag"]).all())
                  and bool(torch.isfinite(torch.view_as_real(np1)).all()))
        peaks.append(float(n00.abs().max()))
        cyc, lcyc = res["mg_cycles"], res["laser_cycles"]
        print(f"laser path step {step}: fields {tuple(res['diag'].shape)} "
              f"and envelope {tuple(np1.shape)} finite {finite}, peak |a| "
              f"{peaks[-1]:.6f} (a0 {a0}), real V-cycles per slice "
              f"{min(cyc)}-{max(cyc)} (mean {sum(cyc) / len(cyc):.3f}, "
              f"{sum(c == 40 for c in cyc)} slices at max_iters 40), "
              f"complex {min(lcyc)}-{max(lcyc)} (mean "
              f"{sum(lcyc) / len(lcyc):.3f})", flush=True)
        if not finite:
            raise AssertionError("non-finite fields or envelope")
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches,
                   "K3 complex": mg_solve.complex_launches,
                   "plasma push": plasma_push.launches,
                   "deposit values": dvo.deposit_values.launches})
    pcfg = sim.plasma_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + g.nz,
                "K2": g.nz * plasma_k2(sim), "K3": g.nz,
                "K3 complex": g.nz, "plasma push": g.nz * plasma_pushes(sim),
                "deposit values": g.nz * len(sim.plasma_cfgs)}
    for k, count in counts.items():
        print(f"laser path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps}: per slice one plasma deposit with its "
              f"values, fused push and Bx/By solve and one envelope solve; no "
              f"beam)",
              flush=True)
    print(f"laser path device-to-host copies per slice (synchronizing reads, "
          f"first step): {copies / g.nz:.3f} (the flagship's: the beam's "
          f"2.05; the laser adds none)", flush=True)
    # the laser's own device work per slice, each part timed alone on the
    # path's shapes: the advance (its complex K3 solve included) and the
    # deposit's |a|^2 gather on the plasma's lanes, inside the values kernel
    # (with the laser less without; the push's runs inside the fused plasma
    # push)
    st = sim.slice_step
    lg = sim.laser_geom
    state = {k: res["laser_stream"][1][g.nz // 2] for k in
             ("n00j00", "n00jp1", "n00jp2", "nm1j00", "nm1jp1", "nm1jp2",
              "np1jp1", "np1jp2")}
    chi = torch.ones(lg.slice_shape, device="cuda")
    adv_ms = cuda_ms(lambda: st.laser_advance(state, chi, sim.dt, 1))
    p = sim.plasma_cfgs[0]
    from hipace_tpu_torch.particles.plasma import init_plasma
    lanes = init_plasma(p, g, "cuda", torch.float32)
    aabs = {"aabs": torch.abs(state["n00j00"]) ** 2}
    comps = sim.slice_step._plasma_comps(p)

    def values(laser):
        return cuda_ms(lambda: dvo.deposit_values_cuda(
            lanes, comps, aabs, g, p, sim.cfg.pc, 2, sim.cfg.normalized_units,
            use_laser=laser))

    gat_ms = values(True) - values(False)
    laser_ms = adv_ms + gat_ms
    print(f"laser path, the laser's device time per slice: advance "
          f"{adv_ms:.3f} ms (with its complex K3 solve), the deposit's "
          f"|a|^2 gather inside the values kernel {gat_ms:.3f} ms = "
          f"{laser_ms:.3f} ms; "
          f"{CARD['line']}", flush=True)
    print(f"laser path real V-cycles per slice of the last step, head "
          f"first: {res['mg_cycles']}", flush=True)
    sim_comps = sim.cfg.diag_comps
    del res, sim
    torch.cuda.empty_cache()
    # the same deck's first step in float64, and in float32 on the plain
    # versions (the JAX package's arithmetic) on the card: whether the Bx/By
    # solves that run to max_iters in float32 do so in float64, and the
    # float32 kernel step held against both. The float32 stopping target
    # lies within the rounding floor of a float32 residual there
    # (tools/laser_f32_solve.py: the JAX package's float32 solve stalls so
    # at 511^2), and float32 moves this deck's fields by up to 35% of their
    # max at 1023^2, the plain versions as much as the kernels. So the
    # kernel step must lie (1) within 1e-2 of the plain float32 step in
    # every field's checksum sum|f| (tests/test_f32_physics.py's measure),
    # (2) no farther from float64 than twice the plain float32 step's
    # max|d| / max|f64|, field by field, and (3) within 5e-2 of float64 in
    # every checksum; the advanced envelope within 1e-4 (the envelope
    # solve's tol_rel) of float64 and of the plain step.
    def step0(dtype, plain=False):
        from hipace_tpu_torch.ops import cuda_lib
        kernel_rule = cuda_lib.use_kernel
        if plain:
            cuda_lib.use_kernel = lambda tensor: False
        try:
            run = Simulation(laser_wake(NXY, LASER_NZ), device="cuda",
                             dtype=dtype, verbose=0).run_step(0)
        finally:
            cuda_lib.use_kernel = kernel_rule
        return (run["diag"].double(), run["laser_stream"][0].to(
            torch.complex128), run["mg_cycles"])

    d64, e64, cyc64 = step0(torch.float64)
    print(f"laser path in float64, step 0: real V-cycles per slice, head "
          f"first: {cyc64} (mean {sum(cyc64) / len(cyc64):.3f})",
          flush=True)
    dp, ep, cycp = step0(torch.float32, plain=True)
    print(f"laser path in float32 on the plain versions, step 0: real "
          f"V-cycles per slice, head first: {cycp}", flush=True)

    def checksum(a, b):
        sa, sb = float(a.abs().sum()), float(b.abs().sum())
        return abs(sa - sb) / sb if sb else sa

    def pointwise(a, b):
        top = float(b.abs().max())
        d = float((a - b).abs().max())
        return d / top if top else d

    drift, f32_ok = [], True
    for i, c in enumerate(sim_comps):
        k, p, r = diag0[:, i].double(), dp[:, i], d64[:, i]
        cs_kp, cs_k = checksum(k, p), checksum(k, r)
        pt_k, pt_p = pointwise(k, r), pointwise(p, r)
        f32_ok = (f32_ok and cs_kp <= 1e-2 and cs_k <= 5e-2
                  and pt_k <= 2 * pt_p + 1e-12)
        drift.append(f"{c} {cs_kp:.2e} {cs_k:.2e}/{pt_k:.2e} ({pt_p:.2e})")
    env = pointwise(env0.to(e64.dtype), e64)
    env_p = pointwise(env0.to(e64.dtype), ep)
    f32_ok = f32_ok and env <= 1e-4 and env_p <= 1e-4
    print(f"laser path step 0 in float32 on the kernels, per field: checksum "
          f"against the plain float32 step, checksum against float64 / "
          f"max|d| / max|f64| (the plain float32 step's): {', '.join(drift)};"
          f" advanced envelope max|d| / max against float64 {env:.3e}, "
          f"against the plain step {env_p:.3e}; tolerances 1e-2, 5e-2, twice "
          f"the plain step's, 1e-4 {'ok' if f32_ok else 'FAIL'}", flush=True)
    del d64, e64, dp, ep, diag0, env0
    torch.cuda.empty_cache()
    ok = (all(c == per_step[k] * steps for k, c in counts.items())
          and abs(peaks[0] - a0) <= 0.05 * a0
          and copies / g.nz <= 0.1 and math.isfinite(laser_ms) and f32_ok)
    if not ok:
        raise AssertionError("laser path: launch counts, peak |a|, host "
                             "reads or float32 against float64 wrong")


@phase("adaptive flagship")
def adaptive_flagship(torch):
    """The flagship deck with hipace.dt = adaptive at 1023^2 x 16 float32,
    three steps through the time loop: dt per step and the host's reads of
    the device in each step, against one step of the same deck at a fixed
    dt: adaptive dt may add the one read of the step's moments, no read per
    slice."""
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    nz = 16

    def deck(extra):
        return blowout_wake(NXY, nz, NXY * NXY * 10 * nz // 1000, extra)

    fixed = Simulation(deck(""), device="cuda", dtype=torch.float32,
                       verbose=0)
    _, base = sync_counted(torch, lambda: fixed.advance(0, False))
    del fixed
    sim = Simulation(deck("hipace.dt = adaptive\n"), device="cuda",
                     dtype=torch.float32, verbose=0)
    lines, worst = [], 0
    for step in range(3):
        sim.set_dt()
        dt = sim.dt
        _, copies = sync_counted(
            torch, lambda: sim.advance(step, write_output=False))
        worst = max(worst, copies)
        lines.append(f"step {step} dt {dt:.9g}, {copies} reads "
                     f"({copies / nz:.3f} per slice)")
    ok = worst <= base + 1 and sim.dt > 0
    print(f"adaptive flagship {NXY}^2 x {nz} float32: " + "; ".join(lines)
          + f"; next dt {sim.dt:.9g}; at a fixed dt {base} reads "
          f"({base / nz:.3f} per slice: the beam's 2 per slice and the "
          f"step's own) {'ok' if ok else 'FAIL'}; {CARD['line']}",
          flush=True)
    if not ok:
        raise AssertionError("adaptive flagship: host reads or dt wrong")


# ------------------------------------------------- ionization, collisions
def rel_err(got, ref):
    got, ref = got.cpu().double(), ref.cpu().double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


def counted_ionization(torch):
    """Count the K2 launches of the ionization modules, and keep the
    arguments of one call; returns (counts, kept, undo)."""
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.particles import plasma as pl
    orig, counts, kept = pl.ionization_module, {"K2": 0, "calls": 0}, {}

    def counted(*args, **kwargs):
        before = gather_main.launches
        out = orig(*args, **kwargs)
        counts["K2"] += gather_main.launches - before
        # the middle slice of the first step, behind the beam
        if counts["calls"] == args[3].nz // 2:
            kept["args"] = args
        counts["calls"] += 1
        return out

    pl.ionization_module = counted

    def undo():
        pl.ionization_module = orig
    return counts, kept, undo


@phase("ionization path")
def ionization_path(torch, counts, results):
    """IONIZATION_WAKE at 1023^2 x 64 in float32 with rho deposited, three
    steps, the host's reads of the device counted in the second; the
    K1/K2/K3 launches against the slice structure with two species and one
    ionization gather per slice, finite fields, the beam's lanes conserved,
    the ionization events per step, no charge ahead of the beam's head
    (below 1e-3 qe ne, test_ionization.py's bound); then the ionization
    module's device time per slice and K2 on the path's own ion lanes at
    x_prev against its plain version, timed, with its bound."""
    from hipace_tpu_torch.decks import ionization_wake
    from hipace_tpu_torch.ops import gather as gat
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.deposit_values import deposit_values
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.particles import plasma as pl
    from hipace_tpu_torch.particles.plasma import cell_positions
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(ionization_wake(NXY, NZ, 0, "diagnostic.field_data = "
                                     "all rho\n"),
                     device="cuda", dtype=torch.float32, verbose=0)
    g = sim.geom
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve, deposit_values):
        fn.launches = 0
    ion_k2, kept, undo = counted_ionization(torch)
    events, copies = [], 0
    try:
        for step in range(steps):
            if step == 1:
                # counted after the first step's one-time copies (the ADK
                # table)
                res, copies = sync_counted(torch, lambda: sim.run_step(1))
            else:
                res = sim.run_step(step)
            events.append(int(res["ionized"]))
            sim.binned = res["binned"]
            sim.time += sim.dt
    finally:
        undo()
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches, "K2 ionization": ion_k2["K2"],
                   "deposit values": deposit_values.launches})
    cfgs = sim.plasma_cfgs
    per_step = {"K1": sum(int(p.neutralize_background) for p in cfgs)
                + g.nz * (len(cfgs) + 2),
                "K2": g.nz * (plasma_k2(sim) + beam_k2(sim) + 1),
                "K3": g.nz, "K2 ionization": g.nz,
                "deposit values": g.nz * len(cfgs)}
    n = int(sim.binned["valid"].sum())
    finite = bool(torch.isfinite(res["diag"]).all())
    comps = sim.cfg.diag_comps
    rho = res["diag"][:, comps.index("rho")]
    zeta = g.prob_lo[2] + (torch.arange(g.nz, device="cuda") + 0.5) * g.dz
    qe, ne = 1.602176634e-19, 1.25e24
    ahead = float(rho[zeta > 25e-6].abs().max()) / (qe * ne)
    near = float(rho.abs().max()) / (qe * ne)
    ion, elec = res["plasma"][1], res["plasma"][0]
    print(f"ionization path {NXY}^2 x {NZ} float32, species "
          f"{[p.name for p in cfgs]} with lanes "
          f"{[int(p['x'].numel()) for p in res['plasma']]}, {n0} beam "
          f"particles: fields finite {finite}, beam particles {n} (start "
          f"{n0}), ionization events per step {events}, electrons live "
          f"{int(elec['valid'].sum())}, ions at level 1 "
          f"{int((ion['ion_lev'] > 0).sum())}; |rho| ahead of the beam's "
          f"head {ahead:.3e} qe ne (tol 1e-3), largest {near:.3e} qe ne; "
          f"{CARD['line']}", flush=True)
    print(f"ionization path device-to-host copies per slice (synchronizing "
          f"reads, second step): {copies / g.nz:.3f} (the flagship's, "
          f"the beam's two per slice and the step's own four: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"ionization path launches {k}: {count} (slice structure "
              f"predicts {per_step[k] * steps}: per slice two species' "
              f"deposits with their values and fused pushes, the beam's "
              f"fused push (K2 in the "
              f"loops: {plasma_k2(sim) + beam_k2(sim)}), one ionization "
              f"gather)", flush=True)
    # the module and its gather alone, on the kept call's arguments
    args = kept["args"]
    draw = torch.rand(args[0]["x"].numel(), device="cuda")
    mod_ms = cuda_ms(lambda: pl.ionization_module(*args[:-1], draw))
    print(f"ionization path, the ionization module's device time per slice "
          f"(one call on the path's state, its K2 gather included): "
          f"{mod_ms:.4f} ms; {CARD['line']}", flush=True)
    ion_state, fields = args[0], args[2]
    planes = pl.field_planes(fields)
    ym, xm = cell_positions(ion_state["x_prev"], ion_state["y_prev"],
                            ion_state["valid"], g)
    got = gat.gather_main_cuda(planes, ym, xm, 2)
    ref = gat.gather_main_plain(planes, ym, xm, 2)
    torch.cuda.synchronize()
    ok_k2, err, rel, tol = compare("K2", "float32", got, ref)
    ms = cuda_ms(lambda: gat.gather_main_cuda(planes, ym, xm, 2))
    plain_ms = cuda_ms(lambda: gat.gather_main_plain(planes, ym, xm, 2))
    NY, NX = g.slice_shape
    live = int((ym < 1.5 * NY).sum())
    print(f"K2 float32 ionization path, ADK gather at the ions' x_prev "
          f"N={ym.numel()}, {live} live: max abs err {err:.3e}, / max "
          f"{rel:.3e} (tol {tol:g}) {'ok' if ok_k2 else 'FAIL'}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms; {CARD['line']}", flush=True)
    b_ms, by = bound_line("K2 ionization", "float32", ms,
                          4 * (5 * stencil_cells(torch, ym, xm, NY, NX, 2)
                               + 8 * ym.numel()), 2 * 6 * 16 * live, 4)
    results[("K2 ionization", "float32")] = (err, ms, plain_ms, b_ms, by)
    if (not finite or n != n0 or not ok_k2 or min(events) <= 0
            or ahead >= 1e-3 or copies > 2 * g.nz + 4
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("ionization path: fields, beam, events, charge "
                             "ahead of the beam, K2, host reads or launch "
                             "counts wrong")


def plasma_energy(p):
    """The plasma's weighted kinetic energy sum w (gamma - 1), float64."""
    v = p["valid"]
    ux, uy, psi = (p[k][v].double() for k in ("ux", "uy", "psi"))
    g = (1.0 + ux * ux + uy * uy + psi * psi) / (2.0 * psi)
    return float((p["w"][v].double() * (g - 1.0)).sum())


def nonfinite(res, beam):
    """Non-finite (plasma lanes, beam lanes, field values) after a step."""
    import torch
    p = res["plasma"][0]
    lanes = (~torch.isfinite(p["ux"]) | ~torch.isfinite(p["psi"])) \
        & p["valid"]
    blanes = (~torch.isfinite(beam["uz"]) | ~torch.isfinite(beam["ux"])) \
        & beam["valid"]
    return (int(lanes.sum()), int(blanes.sum()),
            int((~torch.isfinite(res["diag"])).sum()))


@phase("collision path")
def collision_path(torch, counts, results):
    """COLLISION_WAKE at 1023^2 x 64 in float32 for three steps, the host's
    reads of the device counted in the second; the K1/K2/K3 launches equal
    to the flagship's (collisions launch none of the three), the
    collisions' device time and launches per slice on the path's own state,
    and what float32 does to them (ROADMAP R19: their guards and products
    leave float32's range, in the JAX package as here,
    tools/collision_f32.py): the non-finite lanes after each step, and one
    slice's kicks against float64's. Then one step in float64 at 1023^2 x
    64 with collisions and one without from the same beam: fields and
    momenta finite, the plasma's weighted energy within 1e-3 of the step
    without collisions."""
    from torch.autograd import DeviceType
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import blowout_wake, collision_wake
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.particles import collisions as coll
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(collision_wake(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g, st = sim.geom, sim.slice_step
    orig, kept = st.collide, {"nb": 0}

    def keep(plasmas, emit, dt):
        # the first step's fullest slice: float32 leaves later steps'
        # states non-finite (R19)
        if sim.time == 0.0 and emit["x"].numel() >= kept["nb"]:
            kept.update(args=(plasmas, emit, dt), nb=emit["x"].numel())
        return orig(plasmas, emit, dt)

    st.collide = keep
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    copies, bad = 0, []
    for step in range(steps):
        if step == 1:
            res, copies = sync_counted(torch, lambda: sim.run_step(1))
        else:
            res = sim.run_step(step)
        bad.append(nonfinite(res, res["binned"]))
        sim.binned = res["binned"]
        sim.time += sim.dt
    st.collide = orig
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches})
    pcfg, bcfg = sim.plasma_cfgs[0], sim.beam_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (plasma_k2(sim) + beam_k2(sim)),
                "K3": g.nz}
    print(f"collision path {NXY}^2 x {NZ} float32, {NPART} beam particles, "
          f"collisions {sim.cfg.collisions}: non-finite (plasma lanes, beam "
          f"lanes, field values) after each step {bad} (ROADMAP R19); "
          f"{CARD['line']}", flush=True)
    print(f"collision path device-to-host copies per slice (synchronizing "
          f"reads, second step): {copies / g.nz:.3f} (the flagship's, "
          f"the beam's two per slice and the step's own four: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"collision path launches {k}: {count} (the flagship's "
              f"{per_step[k] * steps})", flush=True)
    # the collisions alone on the first step's fullest slice: device time and
    # launches per call (one call per slice)
    plasmas, emit, dt = kept["args"]
    ms = cuda_ms(lambda: st.collide(plasmas, emit, dt))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        st.collide(plasmas, emit, dt)
        torch.cuda.synchronize()
    launches = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, nb = plasmas[0]["x"].numel(), emit["x"].numel()
    d = {"sort": torch.rand(n, generator=gen, device="cuda"),
         "pick": torch.rand(nb, generator=gen, device="cuda"),
         "kick": torch.rand((4, nb), generator=gen, device="cuda")}
    dpp = {"sort": d["sort"], "kick": torch.rand((4, n), generator=gen,
                                                 device="cuda"),
           "wrap kick": torch.rand((4, n), generator=gen, device="cuda")}
    cfg, kick = sim.cfg, {}
    # the same-species collision alone: its kicks do not stay (R18)
    pp_ms = cuda_ms(lambda: coll.plasma_plasma_collision(
        plasmas[0], None, g, pcfg, pcfg, cfg.pc, -1.0,
        cfg.background_density_SI, True, dpp, True))
    print(f"collision path, the collisions of one slice (the first step's "
          f"fullest slice, {kept['nb']} beam lanes, "
          f"{plasmas[0]['x'].numel()} plasma lanes): {ms:.4f} ms (CUDA "
          f"events), {launches} launches; the same-species collision "
          f"alone {pp_ms:.4f} ms; "
          f"{CARD['line']}", flush=True)
    # float32 against float64 on that state, the same draws
    for dtype in (torch.float32, torch.float64):
        def cast(t):
            return {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in t.items()}
        bo, po = coll.beam_plasma_collision(
            cast(emit), cast(plasmas[0]), g, bcfg, pcfg, cfg.pc, -1.0,
            cfg.background_density_SI, True, cast(d), dt)
        qo, _ = coll.plasma_plasma_collision(
            cast(plasmas[0]), None, g, pcfg, pcfg, cfg.pc, -1.0,
            cfg.background_density_SI, True, cast(dpp), True)
        duz = (bo["uz"].double() - emit["uz"].double()).abs()
        kick[dtype] = (float(duz.nan_to_num(0.0).max()),
                       int((~torch.isfinite(bo["uz"])).sum()),
                       int((~torch.isfinite(qo["ux"])
                            & plasmas[0]["valid"]).sum()))
    f32, f64 = kick[torch.float32], kick[torch.float64]
    print(f"collision path, one slice's collisions in float32 against "
          f"float64 (the same state and draws): largest finite beam uz kick "
          f"{f32[0]:.4e} against {f64[0]:.4e}, non-finite beam uz "
          f"{f32[1]} against {f64[1]} of {nb}, non-finite same-species ux "
          f"{f32[2]} against {f64[2]} (ROADMAP R19)", flush=True)
    del res, sim, plasmas, emit, kept, st
    torch.cuda.empty_cache()
    # float64 at full width: one step with and one without collisions from
    # one beam
    runs = []
    for fn in (collision_wake, blowout_wake):
        s64 = Simulation(fn(NXY, NZ, NPART), device="cuda",
                         dtype=torch.float64, verbose=0)
        if runs:
            carry_state(s64, {k: v.cpu().numpy() for k, v in beam.items()
                              if torch.is_tensor(v)}, s64.dt, s64.time)
        else:
            beam = s64.binned
        r = s64.run_step(0)
        runs.append((plasma_energy(r["plasma"][0]),
                     nonfinite(r, r["binned"])))
        del s64, r
        torch.cuda.empty_cache()
    (e_coll, bad64), (e_none, _) = runs
    rel = abs(e_coll - e_none) / abs(e_none)
    print(f"collision path in float64, {NXY}^2 x {NZ}, one step: non-finite "
          f"(plasma lanes, beam lanes, field values) {bad64}; the plasma's "
          f"weighted energy {e_coll!r} with collisions, {e_none!r} without "
          f"from the same beam, relative change {rel:.3e} (tol 1e-3); "
          f"{CARD['line']}", flush=True)
    if (copies > 2 * g.nz + 4 or rel >= 1e-3 or any(bad64)
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("collision path: host reads, float64 momenta "
                             "or energy, or launch counts wrong")


def read_insitu(path):
    """An in-situ file's records: a JSON dtype header, then the records."""
    import numpy as np
    raw = Path(path).read_bytes()
    head, offset = json.JSONDecoder().raw_decode(raw.decode("latin-1"))
    return np.frombuffer(raw, dtype=np.dtype(head), offset=offset)


def output_files(folder):
    """The openPMD files and in-situ files a run wrote under folder."""
    files = sorted((folder / "openpmd").glob("openpmd_*.json"))
    files += [folder / sub / f"reduced_{name}.0000.txt"
              for sub, _, name in INSITU]
    return files


def output_lines(folder):
    """Deck lines that send the openPMD and in-situ files under folder."""
    return (f"hipace.file_prefix = {folder}/openpmd\n"
            + "".join(f"{key}.insitu_file_prefix = {folder}/{sub}\n"
                      for sub, key, _ in INSITU))


def output_deck(deck_fn, nxy, nz, npart, extra, folder):
    return deck_fn(nxy, nz, npart, extra + output_lines(folder))


def run_steps(sim, steps, write=False):
    """Run `steps` steps from step 0, writing each step's output with
    write=True; the last step's result."""
    for step in range(steps):
        pre = sim.binned
        res = sim.run_step(step)
        if write:
            sim.write_output(step, res, pre)
        sim.binned = res["binned"]
        sim.time += sim.dt
    return res


@phase("pdf path")
def pdf_path(torch):
    """PDF_BEAM at 1023^2 x 64 float32 with its output: files, finite
    fields, the beam count, the in-situ beam weight and the launch
    counts."""
    import shutil
    from hipace_tpu_torch.decks import pdf_beam
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.pipeline.simulation import Simulation
    folder = OUT / "pdf"
    shutil.rmtree(folder, ignore_errors=True)
    sim = Simulation(output_deck(pdf_beam, NXY, NZ, NPART, PDF_OUTPUT,
                                 folder), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    steps = sim.max_step + 1
    channels = 4 + len(sim.cfg.rho_comps()) + 9
    n0 = int(sim.binned["valid"].sum())
    w0 = float(sim.binned["w"][sim.binned["valid"]].double().sum())
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    res = run_steps(sim, steps, write=True)
    counts = {"K1": deposit.launches, "K2": gather_main.launches,
              "K3": mg_solve.launches}
    n = int(sim.binned["valid"].sum())
    finite = bool(torch.isfinite(res["diagf_lev0"]).all())
    files = output_files(folder)
    missing = [str(f) for f in files if not f.exists()]
    if len(files) != steps + 3:
        missing.append(f"{steps} openPMD files expected")
    beam_rec = read_insitu(folder / "insitu" / "reduced_beam.0000.txt")
    sw = beam_rec["sum(w)"].sum(axis=1)
    w_rel = float(abs(sw - w0).max() / w0)
    print(f"pdf path {NXY}^2 x {NZ} float32, {NPART} beam particles, plasma "
          f"deposit C={channels}: xz fields {tuple(res['diagf_lev0'].shape)}"
          f" finite {finite}, beam particles {n} (start {n0}), files "
          f"{len(files)} missing {missing}, in-situ beam sum(w) per step "
          f"{', '.join(f'{v:.9g}' for v in sw)} vs the beam's {w0:.9g} (max "
          f"rel {w_rel:.3e}, tol 1e-5)", flush=True)
    pcfg = sim.plasma_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (plasma_k2(sim) + beam_k2(sim)),
                "K3": g.nz}
    for k, count in counts.items():
        print(f"pdf path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps})", flush=True)
    if (not finite or n != n0 or missing or w_rel > 1e-5
            or channels != 14
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("pdf path: files, fields, beam, in-situ weight "
                             "or launch counts wrong")


# ------------------------------------------------- SALAME, mesh refinement
# the MR path: inside the level, away from its edge (|x| < 1.5), the fine
# on-axis Ez within this fraction of the coarse on-axis Ez's largest value
# (PERF.md, written before the first call from CPU runs at 127^2 and 255^2)
MR_AXIS_BOUND = 0.05


class CallKeeper:
    """Counts the calls of module.name for which want(args, kwargs) holds,
    adds up the launches that the kernel wrapper `counter` counts inside
    those calls, and keeps the arguments of the keep-th such call; undo()
    restores the function."""

    def __init__(self, module, name, want, counter, keep=0):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.launches, self.kept = 0, 0, None

        def counted(*args, **kwargs):
            if not want(args, kwargs):
                return self.orig(*args, **kwargs)
            if self.calls == keep:
                self.kept = (args, kwargs)
            self.calls += 1
            before = counter.launches
            out = self.orig(*args, **kwargs)
            self.launches += counter.launches - before
            return out

        setattr(module, name, counted)

    def undo(self):
        setattr(self.module, self.name, self.orig)


def k3_entry(torch, key, mg, args, kwargs, results):
    """K3 on a kept solve: against its plain version, timed, its bound."""
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    u0, rhs, acf = args
    got, cycles, _ = mg_solve(mg, u0, rhs, acf, **kwargs)
    ref = mg.solve_plain(u0, rhs, acf, **kwargs)
    torch.cuda.synchronize()
    ok, err, rel, tol = compare("K3", "float32", got, ref)
    cycles = int(cycles)
    same = cycles == mg.last_cycles
    ms = cuda_ms(lambda: mg_solve(mg, u0, rhs, acf, **kwargs), reps=5)
    plain_ms = cuda_ms(lambda: mg.solve_plain(u0, rhs, acf, **kwargs),
                       reps=2)
    C, ny, nx = rhs.shape
    print(f"K3 float32 {key} ({C} channels on {ny}x{nx}, "
          f"{'cell' if mg.cell_centered else 'node'}-centered, "
          f"{mg.nlevels} levels): V-cycles {cycles} (plain {mg.last_cycles})"
          f"; max abs err {err:.3e}, / max {rel:.3e} (tol {tol:g}) "
          f"{'ok' if ok and same else 'FAIL'}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms; {CARD['line']}", flush=True)
    size = got.element_size()
    cells = sum(h * w for h, w in mg.shapes)
    b_ms, by = bound_line(key, "float32", ms, size * (3 * C + 1) * ny * nx,
                          max(cycles, 1) * C * cells * (7 * 4 + 9 + 5), size)
    results[(key, "float32")] = (err, ms, plain_ms, b_ms, by)
    return ok and same


def on_axis_ez(res, sim):
    """Level 0's Ez along the x axis (the middle row) per slice."""
    g = sim.geom
    ez = res["diag"][:, sim.cfg.diag_comps.index("Ez")]
    mid = g.ny // 2
    line = ez[:, mid, :] if g.ny % 2 else 0.5 * (ez[:, mid - 1, :]
                                                 + ez[:, mid, :])
    return line.double().cpu()


@phase("SALAME path")
def salame_path(torch, counts, results):
    """SALAME_WAKE at 1023^2 x 64 in float32 (a 669,778-particle drive and a
    223,259-particle witness with do_salame): a first simulation's step 0
    warms the kernels; a fresh one's step 0 (SALAME) and step 1 (none)
    have their host reads counted, their K1/K2/K3 launches held to
    the slice structure with the step's SALAME slices; the witness's
    weights finite and not all zero, the drive's unchanged; the on-axis Ez
    spread across the witness below 0.4 of the same deck's with
    witness.do_salame = 0 (test_salame.py:69-91), whose step 0 takes one
    host read fewer; then K3 on one of SALAME's solves against its plain
    version, timed, with its bound."""
    from hipace_tpu_torch.decks import salame_wake
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.pipeline import step as stp
    from hipace_tpu_torch.pipeline.simulation import Simulation

    def make(extra=""):
        return Simulation(salame_wake(NXY, NZ, NPART, extra), device="cuda",
                          dtype=torch.float32, verbose=0)

    warm = make()
    warm.run_step(0)
    del warm
    # the debug mode's first switch in a process is itself counted
    sync_counted(torch, lambda: None)
    sim = make()
    g = sim.geom
    w0 = sim.binned["w"].clone()
    valid0, bid0 = sim.binned["valid"], sim.binned["beam_id"]
    fns = {"K1": deposit, "K2": gather_main, "K3": mg_solve}
    # one SALAME solve kept: the first of the third SALAME slice
    keep = {"slices": 0, "mg": None, "K3": 0}
    orig_sal, orig_solve = stp.salame_slice, sim.slice_step.mg.solve

    def sal(*args, **kwargs):
        keep["slices"] += 1
        before = mg_solve.launches
        out = orig_sal(*args, **kwargs)
        keep["K3"] += mg_solve.launches - before
        return out

    def solve(*args, **kwargs):
        if keep["slices"] == 3 and keep["mg"] is None:
            keep["mg"] = (args, kwargs)
        return orig_solve(*args, **kwargs)

    stp.salame_slice, sim.slice_step.mg.solve = sal, solve
    res, copies, per_step = [], [], []
    try:
        for step in range(2):
            for f in fns.values():
                f.launches = 0
            r, c = sync_counted(torch, lambda: sim.run_step(step))
            copies.append(c)
            per_step.append({k: f.launches for k, f in fns.items()})
            res.append(r)
            sim.binned = r["binned"]
            sim.time += sim.dt
    finally:
        stp.salame_slice = orig_sal
        del sim.slice_step.mg.solve
    nos = make("witness.do_salame = 0\n")
    r_n, copies_n = sync_counted(torch, lambda: nos.run_step(0))
    n_sal = int(res[0]["salame_is_sal"].sum())
    n_sal1 = int(res[1]["salame_is_sal"].sum())
    sub = beam_k2(sim)
    pcfg = sim.plasma_cfgs[0]
    it = sim.cfg.salame_n_iter
    base = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
            "K2": g.nz * (plasma_k2(sim) + sub), "K3": g.nz}
    # per SALAME slice and iteration: K1 the trial jx/jy, SALAME's jz, the
    # plasma's response, the jz redeposit; K2 SALAME's B gather (and the
    # trial push where it keeps the loop); K3 two solves
    extra = {"K1": 4 * it, "K2": (1 + plasma_k2(sim)) * it, "K3": 2 * it}
    want = [{k: base[k] + extra[k] * n for k in base} for n in (n_sal, 0)]
    counts.update({k: per_step[0][k] + per_step[1][k] for k in fns})
    # K3's own count inside SALAME's calls, both steps
    counts["K3 SALAME"] = keep["K3"]
    zeta = g.prob_lo[2] + (torch.arange(g.nz, dtype=torch.float64) + 0.5) \
        * g.dz
    inside = (zeta > -2.35) & (zeta < -1.5)
    mid = g.nx // 2
    spread_s = float(on_axis_ez(res[0], sim)[inside, mid].max()
                     - on_axis_ez(res[0], sim)[inside, mid].min())
    spread_n = float(on_axis_ez(r_n, nos)[inside, mid].max()
                     - on_axis_ez(r_n, nos)[inside, mid].min())
    b = res[0]["binned"]
    wit = b["valid"] & (b["beam_id"] == 1)
    drv = b["valid"] & (b["beam_id"] == 0)
    ww = b["w"][wit].double()
    w_ok = bool(torch.isfinite(ww).all()) and float(ww.sum()) > 0 \
        and float(ww.std() / ww.mean()) > 0.01
    drive_ok = bool((b["w"][drv] == w0[valid0 & (bid0 == 0)][0]).all())
    finite = all(bool(torch.isfinite(r["diag"]).all()) for r in res)
    sal_cyc = [c for v in res[0]["salame_cycles"].values() for c in v]
    print(f"SALAME path {NXY}^2 x {NZ} float32, beams "
          f"{[int((valid0 & (bid0 == i)).sum()) for i in range(2)]} "
          f"particles: {n_sal} SALAME slices at step 0 ({n_sal1} at step 1),"
          f" fields finite {finite}, witness weights finite, not all zero "
          f"and adapted {w_ok} (std/mean {float(ww.std() / ww.mean()):.4f}),"
          f" drive weights unchanged {drive_ok}; on-axis Ez spread across "
          f"the witness {spread_s:.5e} against {spread_n:.5e} without SALAME"
          f", ratio {spread_s / spread_n:.4f} (tol 0.4); SALAME's K3 "
          f"V-cycles {min(sal_cyc)}-{max(sal_cyc)} over {len(sal_cyc)} "
          f"solves, K3 launches inside salame_slice {keep['K3']} (predicted"
          f" {extra['K3'] * n_sal}); {CARD['line']}", flush=True)
    print(f"SALAME path host reads of the device (synchronizing copies): "
          f"step 0 {copies[0]}, step 1 {copies[1]}, step 0 of the same deck "
          f"without SALAME {copies_n}", flush=True)
    for i, (got, exp) in enumerate(zip(per_step, want)):
        print(f"SALAME path launches step {i}: {got} (slice structure "
              f"predicts {exp}: per slice {base['K1'] // g.nz} / "
              f"{pcfg.n_subcycles} + {sub} / 1, per SALAME slice "
              f"{extra['K1']} / {extra['K2']} / {extra['K3']} more)",
              flush=True)
    ok_k3 = k3_entry(torch, "K3 SALAME", orig_solve.__self__,
                     *keep["mg"], results)
    if (not finite or not w_ok or not drive_ok or n_sal == 0 or n_sal1
            or spread_s >= 0.4 * spread_n or copies[0] != copies_n + 1
            or copies[1] > copies_n or per_step != want or not ok_k3
            or keep["K3"] != extra["K3"] * n_sal):
        raise AssertionError("SALAME path: fields, weights, Ez flattening, "
                             "host reads, launch counts or K3 wrong")


@phase("MR path")
def mr_path(torch, counts, results):
    """MR_WAKE at 1023^2 x 64 in float32 with a 511^2 level (4,186,116
    plasma slots), three steps, the host's reads counted in the second:
    finite fields on both levels, the
    beam's lanes conserved, the K1/K2/K3 launches against the slice
    structure and the level's active slices, the fine on-axis Ez inside the
    level within MR_AXIS_BOUND of the coarse; a coupler product on the card
    against the CPU's in float64 (full float32, no TF32); K1's direct-path
    share on a fine-level plasma deposit; then K1, K2 and K3 at the level's
    shapes against their plain versions, timed, with their bounds."""
    from hipace_tpu_torch.decks import mr_wake
    from hipace_tpu_torch.fields.mr import LevelCoupler
    from hipace_tpu_torch.ops import deposit as dep
    from hipace_tpu_torch.ops import gather as gat
    from hipace_tpu_torch.ops.beam_push import beam_push
    from hipace_tpu_torch.ops.deposit_values import deposit_values
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.particles import plasma as pl
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(mr_wake(NXY, NZ, NPART, NXY // 2), device="cuda",
                     dtype=torch.float32, verbose=0)
    g, lv = sim.geom, sim.mr_levels[0]
    fg = lv.geom
    n_act = lv.zeta_hi - lv.zeta_lo + 1
    n0 = int(sim.binned["valid"].sum())
    fine_shape = fg.slice_shape

    def on_fine(planes):
        return tuple(planes[0].shape) == fine_shape

    # the level's K1 plasma deposit (13 channels), K2 gathers and K3 solve;
    # each kept at the middle active slice of the second step
    middle = n_act + n_act // 2
    k1 = CallKeeper(pl, "deposit", lambda a, k: tuple(a[0].shape[1:])
                    == fine_shape and a[0].shape[0] == 13, dep.deposit,
                    keep=middle)
    # every fine gather (the plasma push's first in a slice, then the
    # beam's subcycles) goes through plasma.gather_fields
    per_slice_k2 = sim.plasma_cfgs[0].n_subcycles \
        + sim.beam_cfgs[0].n_subcycles
    k2p = CallKeeper(pl, "gather_main", lambda a, k: on_fine(a[0]),
                     gat.gather_main, keep=middle * per_slice_k2)
    k3 = CallKeeper(sim.slice_step.fine_mgs[0], "solve",
                    lambda a, k: True, mg_solve, keep=middle)
    for f in (dep.deposit, gat.gather_main, mg_solve, beam_push,
              deposit_values):
        f.launches = 0
    steps, copies = 3, 0
    try:
        for step in range(steps):
            if step == 1:
                res, copies = sync_counted(torch, lambda: sim.run_step(1))
            else:
                res = sim.run_step(step)
            sim.binned = res["binned"]
            sim.time += sim.dt
    finally:
        for k in (k1, k2p, k3):
            k.undo()
    counts.update({"K1": dep.deposit.launches, "K2": gat.gather_main.launches,
                   "K3": mg_solve.launches, "beam push": beam_push.launches,
                   "deposit values": deposit_values.launches})
    # the kernels' own counts inside the level's calls
    counts["K1 fine"] = k1.launches
    counts["K2 fine"] = k2p.launches
    counts["K3 fine"] = k3.launches
    pcfg = sim.plasma_cfgs[0]
    # on the level's active slices every plasma and beam push keeps its
    # loop and gathers on both levels; on the others the fused pushes take
    # them
    all_sub = sum(c.n_subcycles for c in sim.beam_cfgs)
    per_step = {"K1": 2 * int(pcfg.neutralize_background) + 3 * (g.nz + n_act),
                "K2": 2 * n_act * pcfg.n_subcycles
                + (g.nz - n_act) * (plasma_k2(sim) + beam_k2(sim))
                + 2 * n_act * all_sub,
                "K3": g.nz + n_act, "K1 fine": n_act,
                "K2 fine": n_act * (pcfg.n_subcycles + all_sub),
                "K3 fine": n_act,
                "beam push": (g.nz - n_act) * fused_pushes(sim),
                "deposit values": len(sim.plasma_cfgs) * (g.nz + n_act)}
    n = int(sim.binned["valid"].sum())
    rows = slice(lv.zeta_lo, lv.zeta_hi + 1)
    fine_line = res["diagf_lev1"][rows, 0].double().cpu()
    finite = (bool(torch.isfinite(res["diag"]).all())
              and bool(torch.isfinite(fine_line).all()))
    # the fine on-axis Ez against the coarse one at the fine cell centres
    x0 = g.prob_lo[0] + (torch.arange(g.nx, dtype=torch.float64) + 0.5) \
        * g.dx
    xf = fg.prob_lo[0] + (torch.arange(fg.nx, dtype=torch.float64) + 0.5) \
        * fg.dx
    inside = xf.abs() < 1.5
    coarse = on_axis_ez(res, sim)[rows]
    i = torch.clamp(torch.searchsorted(x0, xf[inside]) - 1, 0, g.nx - 2)
    t = (xf[inside] - x0[i]) / g.dx
    coarse_f = coarse[:, i] * (1 - t) + coarse[:, i + 1] * t
    axis_err = float((fine_line[:, inside] - coarse_f).abs().max()
                     / coarse_f.abs().max())
    print(f"MR path {NXY}^2 x {NZ} float32 with a {fg.nx}^2 level over "
          f"slices {lv.zeta_lo}-{lv.zeta_hi} ({n_act} active), "
          f"{pl.plasma_count(pcfg, g)} plasma slots, {n0} beam particles: "
          f"fields finite on both levels {finite}, beam particles {n} (start "
          f"{n0}); fine on-axis Ez inside |x| < 1.5 within {axis_err:.4f} of "
          f"the coarse's largest (bound {MR_AXIS_BOUND}); {CARD['line']}",
          flush=True)
    print(f"MR path device-to-host copies per slice (synchronizing reads, "
          f"second step): {copies / g.nz:.3f} (the flagship's: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"MR path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps}: per slice 3 / "
              f"{pcfg.n_subcycles} + the beam's / 1 on each running level "
              f"on the {n_act} active slices (the loops' K2, the beam's "
              f"{all_sub} per level), 3 / {plasma_k2(sim) + beam_k2(sim)} / "
              f"1 on the others (the fused pushes), one background "
              f"deposit per level and step)", flush=True)
    # a coupler product on the card against the CPU's in float64
    coup = sim.slice_step.couplers[0]
    c_gpu = res["diag"][g.nz // 2].new_zeros(g.slice_shape)
    c_gpu[2:-2, 2:-2] = res["diag"][lv.zeta_lo + n_act // 2,
                                    sim.cfg.diag_comps.index("Ez")]
    cpu_coup = LevelCoupler(g, fg, torch.float64, "cpu")
    up_err = rel_err(coup.up_full(c_gpu), cpu_coup.up_full(c_gpu.double()
                                                            .cpu()))
    up_ms = cuda_ms(lambda: coup.up_full(c_gpu))
    print(f"MR path coupler up_full on the card (float32 matmuls, TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}) against the CPU's in "
          f"float64: {up_err:.3e} of the largest (tol 1e-6), "
          f"{up_ms:.4f} ms per product; {CARD['line']}", flush=True)
    # K1 at the level's plasma deposit: plain, timed, direct-path share
    (fields, ym, xm, values, order), kw = k1.kept
    got = dep.deposit_cuda(fields.clone(), ym, xm, values, order, **kw)
    ref = dep.deposit_plain(fields.clone(), ym, xm, values, order,
                            kw.get("deriv_type", -1), kw.get("blocks"))
    torch.cuda.synchronize()
    ok1, err1, rel1, tol1 = compare("K1", "float32", got, ref)
    dep.reset_block_counts()
    dep.deposit_cuda(fields.clone(), ym, xm, values, order, **kw)
    direct, blocks = dep.direct_block_count("cuda"), dep.deposit.blocks
    ms1 = cuda_ms(lambda: dep.deposit_cuda(fields.clone(), ym, xm, values,
                                           order, **kw))
    plain1 = cuda_ms(lambda: dep.deposit_plain(
        fields.clone(), ym, xm, values, order, kw.get("deriv_type", -1),
        kw.get("blocks")), reps=2)
    C, NYf, NXf = fields.shape
    live = int((ym < 1.5 * NYf).sum())
    print(f"K1 float32 MR fine level: C={C} on {NYf}x{NXf}, {ym.numel()} "
          f"lanes ({live} live, the rest masked to the dead row): max abs err"
          f" {err1:.3e}, / max {rel1:.3e} (tol {tol1:g}) "
          f"{'ok' if ok1 else 'FAIL'}; blocks on the direct path {direct} of "
          f"{blocks} ({100 * direct / blocks:.2f}%); kernel {ms1:.4f} ms, "
          f"plain {plain1:.3f} ms; {CARD['line']}", flush=True)
    b1 = bound_line("K1 MR fine", "float32", ms1,
                    4 * (2 * fields.numel() + 2 * ym.numel() + C * live),
                    2 * C * 9 * live, 4)
    results[("K1 MR fine", "float32")] = (err1, ms1, plain1) + b1
    # K2 at the level's plasma gather
    (planes, gym, gxm, gorder), _ = k2p.kept
    got = gat.gather_main_cuda(planes, gym, gxm, gorder)
    ref = gat.gather_main_plain(planes, gym, gxm, gorder)
    torch.cuda.synchronize()
    ok2, err2, rel2, tol2 = compare("K2", "float32", got, ref)
    ms2 = cuda_ms(lambda: gat.gather_main_cuda(planes, gym, gxm, gorder))
    plain2 = cuda_ms(lambda: gat.gather_main_plain(planes, gym, gxm, gorder))
    live2 = int((gym < 1.5 * NYf).sum())
    print(f"K2 float32 MR fine level: plasma gather on {NYf}x{NXf}, "
          f"{gym.numel()} lanes ({live2} live): max abs err {err2:.3e}, / max"
          f" {rel2:.3e} (tol {tol2:g}) {'ok' if ok2 else 'FAIL'}; kernel "
          f"{ms2:.4f} ms, plain {plain2:.3f} ms; {CARD['line']}", flush=True)
    b2 = bound_line("K2 MR fine", "float32", ms2,
                    4 * (5 * stencil_cells(torch, gym, gxm, NYf, NXf, 2)
                         + 8 * gym.numel()), 2 * 6 * 16 * live2, 4)
    results[("K2 MR fine", "float32")] = (err2, ms2, plain2) + b2
    ok3 = k3_entry(torch, "K3 MR fine", k3.orig.__self__, *k3.kept, results)
    if (not finite or n != n0 or axis_err >= MR_AXIS_BOUND or up_err >= 1e-6
            or not (ok1 and ok2 and ok3) or copies > 2 * g.nz + 4
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("MR path: fields, beam, on-axis Ez, coupler, "
                             "kernels, host reads or launch counts wrong")


# ------------------------------------------------------------ the pipeline
PIPE_STAGES = 2
# the pipelined flagship's final beam against the serial loop's in float32:
# the two runs give the same lanes to every kernel call in the same order
# and differ by the order of float32 atomic adds, which moves two serial
# runs' ux by ~7e-5 of its largest value (NVIDIA H100 80GB HBM3, 700 W)
PIPE_F32_TOL = 5e-4


class StepKeeper:
    """Keeps, per time step of a simulation's time loop in step order, its
    V-cycles per slice and a device flag of its fields' finiteness: from
    sim.run_step (the serial loop) and from each stage of every pipelined
    window; undo() restores both."""

    def __init__(self, torch, sim):
        from hipace_tpu_torch.parallel import pipeline as pp
        self.pp, self.sim, self.steps = pp, sim, []
        self.window = pp.pipelined_window
        run = sim.run_step

        def keep(res):
            diag = res["diag"]
            # slice by slice: isfinite on the whole stack would hold a copy
            # of it and add to the peak memory the path reports
            finite = torch.stack([torch.isfinite(d).all() for d in diag])
            self.steps.append({"mg_cycles": res["mg_cycles"],
                               "finite": finite.all()})

        def run_step(step):
            res = run(step)
            keep(res)
            return res

        def window(*args, **kwargs):
            win = self.window(*args, **kwargs)
            for res in win["stages"]:
                keep(res)
            return win
        sim.run_step = run_step
        pp.pipelined_window = window

    def undo(self):
        self.pp.pipelined_window = self.window
        del self.sim.run_step


def beam_rel(torch, got, ref, sort=False):
    """(max|got - ref| / max|ref|, its attribute), the largest over x, y, z,
    ux, uy and uz of the valid lanes of two binned beams (each attribute
    sorted with sort=True); raises where the valid lane counts differ."""
    gv, rv = got["valid"].cpu(), ref["valid"].cpu()
    if int(gv.sum()) != int(rv.sum()):
        raise AssertionError(f"valid lanes {int(gv.sum())} != "
                             f"{int(rv.sum())}")
    worst = (0.0, "")
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        a = got[k].cpu()[gv].double()
        b = ref[k].cpu()[rv].double()
        if sort:
            a, b = a.sort().values, b.sort().values
        worst = max(worst, (float((a - b).abs().max() / b.abs().max()), k))
    return worst


@phase("pipeline path")
def pipeline_path(torch, counts):
    """The flagship at 1023^2 x 64 in float32 through evolve_pipelined with
    two stages on cuda:0: one window, in which the host's reads of the
    device are counted (the stages built before it), then two windows (4
    steps) from the same beam: the K1/K2/K3 launches against the serial
    slice structure, finite fields on every stage, a conserved beam and the
    peak memory; then the serial loop's 4 steps from the same beam, twice,
    with their peak memory: the pipelined final beam held to the serial
    one, beside the spread between the two serial runs."""
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.parallel.ranks import generator_probe
    from hipace_tpu_torch.pipeline.simulation import Simulation
    devices = [torch.device("cuda:0")] * PIPE_STAGES
    steps = 2 * PIPE_STAGES

    def flagship(max_step):
        return Simulation(blowout_wake(NXY, NZ, NPART,
                                       f"max_step = {max_step}\n"),
                          device="cuda", dtype=torch.float32, verbose=0)

    def from_start(sim, max_step):
        sim.binned = {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in beam0.items()}
        sim.time, sim.dt, sim.max_step = 0.0, dt0, max_step

    # the stages built first, then a window in which the host's reads are
    # counted, then the counted windows from the same beam
    sim = flagship(PIPE_STAGES - 1)
    g = sim.geom
    probe = generator_probe(sim)
    beam0 = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in sim.binned.items()}
    dt0, n0 = sim.dt, int(beam0["valid"].sum())
    sim.stage_slice_steps(devices)
    _, reads = sync_counted(torch, lambda: sim.evolve_pipelined(
        devices=devices, write_output=False))
    from_start(sim, steps - 1)
    keeper = StepKeeper(torch, sim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    try:
        sim.evolve_pipelined(devices=devices, write_output=False)
        counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                       "K3": mg_solve.launches})
    finally:
        keeper.undo()
    peak_pipe = torch.cuda.max_memory_allocated()
    finite = all(bool(s["finite"]) for s in keeper.steps)
    cycles = [c for s in keeper.steps for c in s["mg_cycles"]]
    n = int(sim.binned["valid"].sum())
    pipe_binned = sim.binned
    pcfg, loop_k2 = sim.plasma_cfgs[0], plasma_k2(sim) + beam_k2(sim)
    del sim
    torch.cuda.empty_cache()

    # the serial loop twice from the same beam: its peak memory, and how
    # far f32 atomics alone move the final beam
    finals = []
    for _ in range(2):
        serial = flagship(steps - 1)
        serial.binned = {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in beam0.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        serial.evolve(write_output=False)
        peak_serial = torch.cuda.max_memory_allocated()
        finals.append(serial.binned)
        del serial
        torch.cuda.empty_cache()
    diff = beam_rel(torch, pipe_binned, finals[0], sort=True)
    spread = beam_rel(torch, finals[1], finals[0], sort=True)

    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * loop_k2,
                "K3": g.nz}
    # the serial structure (two lane counts per slice, at the beam push),
    # one receive-row binning per tick and a few per window
    read_bound = (2 * PIPE_STAGES * g.nz + g.nz + 2 * (PIPE_STAGES - 1)
                  + 5)
    print(f"pipeline path host reads of the device per slice (the first "
          f"window, all stages' slices): "
          f"{reads / (PIPE_STAGES * g.nz):.3f} "
          f"({reads} reads over {PIPE_STAGES * g.nz} slices; bound "
          f"{read_bound})", flush=True)
    print(f"pipeline path {NXY}^2 x {NZ} float32, {NPART} beam particles, "
          f"{PIPE_STAGES} stages on one card, peak memory: "
          f"{peak_pipe / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f} GiB held "
          f"before the counted windows), {peak_serial / 2 ** 30:.3f} GiB "
          f"serial (ratio {peak_pipe / peak_serial:.3f}); {CARD['line']}",
          flush=True)
    print(f"pipeline path: fields finite on every stage {finite}, V-cycles "
          f"per slice {min(cycles)}-{max(cycles)} over {len(keeper.steps)} "
          f"steps, beam particles {n} (start {n0}); final beam against the "
          f"serial loop's, each attribute sorted: max rel err {diff[0]:.3e} "
          f"({diff[1]}; tol {PIPE_F32_TOL:g}); the serial loop against "
          f"itself {spread[0]:.3e} ({spread[1]}: float32 atomics alone)",
          flush=True)
    ok = finite and n == n0 and len(keeper.steps) == steps \
        and diff[0] <= PIPE_F32_TOL and reads <= read_bound
    for k, (fn_name, _, _) in KERNELS.items():
        want = per_step[k] * steps
        print(f"pipeline path launches {k} {fn_name}: {counts[k]} (the "
              f"serial slice structure predicts {want})", flush=True)
        ok &= counts[k] == want
    if not ok:
        raise AssertionError("pipeline path failed its checks")
    # the references of the ranks path
    return {"beam": pipe_binned, "serial": finals[0], "spread": spread[0],
            "lanes": n0, "probe": probe, "per_step": per_step}


# ------------------------------------------------------------- the ranks
RANK_TIMEOUT = 300      # seconds for one spawn of two ranks


def card_steps(results):
    """Every step's record (V-cycles per slice, finite fields) of a rank run,
    keyed by step, over its ranks; and each step's rank."""
    steps, owner = {}, {}
    for r, res in enumerate(results):
        for s, rec in res["runs"][-1]["steps"].items():
            steps[s], owner[s] = rec, r
    return steps, owner


@phase("ranks path")
def ranks_path(torch, pipe, counts):
    """The 1023^2 x 64 float32 flagship of the pipeline path as two ranks on
    cuda:0 (gloo): one window, then two windows (4 steps) from the same
    beam. Each rank's K1/K2/K3 launches in the two windows against the
    serial slice structure of its 2 steps, finite fields, a conserved beam,
    every rank's generator draws equal to this process's, the final beam
    against the pipeline path's single-process pipeline within PIPE_F32_TOL
    (beside the serial loop's and the spread of two serial runs), each
    rank's peak memory. Where there are two cards, the same with one rank
    per card over NCCL; counts gets the launches of the ranks on cuda:0,
    summed."""
    from hipace_tpu_torch.decks import BLOWOUT_WAKE
    from hipace_tpu_torch.parallel import ranks
    if pipe is None:
        raise AssertionError('"pipeline path" did not run')
    steps = 2 * PIPE_STAGES
    job = ranks.Job(BLOWOUT_WAKE.format(nxy=NXY, nz=NZ, npart=NPART),
                    dtype="float32", write_output=False, keep_steps=True,
                    max_steps=(PIPE_STAGES - 1, steps - 1), verbose=0)
    legs = [(f"{PIPE_STAGES} ranks on cuda:0", ["cuda:0"] * PIPE_STAGES)]
    if torch.cuda.device_count() >= PIPE_STAGES:
        legs.append((f"{PIPE_STAGES} ranks on {PIPE_STAGES} cards",
                     [f"cuda:{i}" for i in range(PIPE_STAGES)]))
    else:
        print(f"ranks path: the NCCL leg (one rank per card) did not run: "
              f"{torch.cuda.device_count()} card", flush=True)
    ok = True
    for leg, devices in legs:
        res = ranks.spawn(job, devices, timeout=RANK_TIMEOUT)
        counted = [r["runs"][-1] for r in res]
        rec, owner = card_steps(res)
        final = res[0]["final"]["binned"]
        n = int(final["valid"].sum())
        diff = beam_rel(torch, final, pipe["beam"], sort=True)
        vs_serial = beam_rel(torch, final, pipe["serial"], sort=True)
        launches = [r["launches"] for r in counted]
        want = {k: v * steps // PIPE_STAGES
                for k, v in pipe["per_step"].items()}
        good = (sorted(rec) == list(range(steps))
                and all(owner[s] == s % PIPE_STAGES for s in rec)
                and all(r["finite"] for r in rec.values())
                and n == pipe["lanes"] == res[0]["lanes"]
                and all(r["probe"] == pipe["probe"] for r in res)
                and diff[0] <= PIPE_F32_TOL
                and all(c == want for c in launches))
        ok &= good
        cycles = [c for r in rec.values() for c in r["mg_cycles"]]
        print(f"ranks path {NXY}^2 x {NZ} float32, {leg}: peak memory per "
              "rank " + ", ".join(f"{r['peak_bytes'] / 2 ** 30:.3f}"
                                  for r in counted)
              + f" GiB; {CARD['line']}", flush=True)
        print(f"ranks path {leg}: launches per rank "
              + "; ".join(", ".join(f"{k} {v}" for k, v in c.items())
                          for c in launches)
              + " (the serial slice structure of 2 steps predicts "
              + ", ".join(f"{k} {v}" for k, v in want.items())
              + f"); fields finite {all(r['finite'] for r in rec.values())},"
              f" V-cycles per slice {min(cycles)}-{max(cycles)}, steps per "
              f"rank {owner}; beam particles {n} (start {pipe['lanes']}); "
              f"generator draws equal on every rank "
              f"{all(r['probe'] == pipe['probe'] for r in res)}; final beam "
              f"against the single-process pipeline's {diff[0]:.3e} "
              f"({diff[1]}; tol {PIPE_F32_TOL:g}), against the serial loop's "
              f"{vs_serial[0]:.3e} (two serial runs {pipe['spread']:.3e}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        if devices[0] == devices[-1]:
            counts.update({k: sum(c[k] for c in launches) for k in want})
    if not ok:
        raise AssertionError("ranks path failed its checks")


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
    from hipace_tpu_torch.device import card_line
    smi_line = card_line()
    print(smi_line)
    CARD["line"] = smi_line
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    # the port never turns TF32 on: the MR couplers' matmuls need full f32
    print(f"torch's default matmul TF32: "
          f"{torch.backends.cuda.matmul.allow_tf32}")
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
    for cmd in lib.commands:
        print(f"build: {' '.join(cmd)}")
    print(f"build: {'compiled' if lib.built else 'cached'} in "
          f"{lib.build_seconds:.1f} s ({time.perf_counter() - t0:.1f} s "
          "with loading)", flush=True)
    ptxas_phase(lib.compiler_output, cuda_lib.nvcc_path())

    # the main path's simulation; its geometry sets the kernel phases' shapes
    sim = Simulation(blowout_wake(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    results: dict = {}
    for dtype in (torch.float32, torch.float64):
        lc = lane_cases(torch, g, dtype, plasma_lanes(torch, g, dtype))
        k1_phase(torch, g, dtype, lc, results)
        k2_phase(torch, g, dtype, lc, results)
        k3_phase(torch, g, dtype, results)
    beam_push_phase(torch, g, results)
    plasma_push_phase(torch, g, results)
    deposit_values_phase(torch, g, results)
    counts: dict = {}
    main_path(torch, sim, counts)
    del sim
    torch.cuda.empty_cache()
    pc_counts: dict = {}
    pc_path(torch, pc_counts)
    torch.cuda.empty_cache()
    poisson_phase(torch, g, results)
    pdf_path(torch)
    torch.cuda.empty_cache()
    k3_cc_phase(torch, results)
    even_counts: dict = {}
    even_path(torch, even_counts)
    torch.cuda.empty_cache()
    witness_counts: dict = {}
    witness_path(torch, witness_counts, results)
    torch.cuda.empty_cache()
    k3_complex_phase(torch, results)
    laser_counts: dict = {}
    laser_path(torch, laser_counts, results)
    torch.cuda.empty_cache()
    adaptive_flagship(torch)
    torch.cuda.empty_cache()
    ion_counts: dict = {}
    ionization_path(torch, ion_counts, results)
    torch.cuda.empty_cache()
    collision_counts: dict = {}
    collision_path(torch, collision_counts, results)
    torch.cuda.empty_cache()
    salame_counts: dict = {}
    salame_path(torch, salame_counts, results)
    torch.cuda.empty_cache()
    mr_counts: dict = {}
    mr_path(torch, mr_counts, results)
    torch.cuda.empty_cache()
    pipe_counts: dict = {}
    pipe_ref = pipeline_path(torch, pipe_counts)
    torch.cuda.empty_cache()
    rank_counts: dict = {}
    ranks_path(torch, pipe_ref, rank_counts)
    del pipe_ref

    if failures:
        print(f"chip_smoke FAILED phases: {failures}", file=sys.stderr)
        return 1
    kernels = []
    # the flagship's calls with its counts, then the PC path's kernels at
    # its dominant shapes with the PC path's counts
    entries = [(k, k, f"{k} {fn}", counts[k])
               for k, (fn, _, _) in KERNELS.items()]
    entries += [("K1", "K1 PC plasma C=2",
                 "K1 deposit, PC path (trial plasma jx/jy, C=2)",
                 pc_counts["K1"]),
                ("plasma push", "plasma push",
                 "plasma push, PC path (the push and every trial push)",
                 pc_counts["plasma push"]),
                ("K3", "K3 CC Bx/By",
                 "K3 mg_solve, even path (cell-centered Bx/By, C=2)",
                 even_counts["K3"]),
                ("K3", "K3 CC MGDirichlet",
                 "K3 mg_solve, even path on MGDirichlet (cell-centered "
                 "Poisson, C=3)", even_counts["K3 MGDirichlet"]),
                ("K2", "K2 witness beam",
                 "K2 gather_main, witness path (the witness beam's "
                 "subcycles; the drive beam takes the fused beam push)",
                 witness_counts["K2 beam"]),
                ("K3", "K3 complex",
                 "K3 mg_solve, laser path (complex envelope, "
                 "node-centered)", laser_counts["K3 complex"]),
                ("K2", "K2 ionization",
                 "K2 gather_main, ionization path (ADK field gather at the "
                 "ions' previous positions)", ion_counts["K2 ionization"]),
                ("K1", "K1 MR fine",
                 "K1 deposit, MR fine level (C = 13, masked lanes, 511^2)",
                 mr_counts["K1 fine"]),
                ("K2", "K2 MR fine", "K2 gather_main, MR fine level",
                 mr_counts["K2 fine"]),
                ("K3", "K3 MR fine",
                 "K3, MR fine Bx/By (511^2, C = 2, Dirichlet data from the "
                 "parent)", mr_counts["K3 fine"]),
                ("K3", "K3 SALAME",
                 "K3, SALAME Bx/By (1023^2, C = 2, max_iters 40)",
                 salame_counts["K3 SALAME"])]
    # the fused beam push: the flagship's beam slice, the flagship's count
    entries += [("beam push", "beam push",
                 "beam push, main path (the beam's subcycles, one launch "
                 "per slice)", counts["beam push"])]
    # the fused plasma push: the flagship's species, the flagship's count
    entries += [("plasma push", "plasma push",
                 "plasma push, main path (the plasma's push, one launch per "
                 "species and slice)", counts["plasma push"])]
    # the deposit values: the flagship's species, the flagship's count
    entries += [("deposit values", "deposit values",
                 "deposit values, main path (the plasma deposit's values, "
                 "one launch per species and slice)",
                 counts["deposit values"])]
    # the pipelined flagship runs the flagship's calls: their times, the
    # pipeline path's counts
    entries += [(k, k, f"{k} {fn}, pipelined flagship ({PIPE_STAGES} stages "
                 "on one card)", pipe_counts[k])
                for k, (fn, _, _) in KERNELS.items()]
    # the rank-per-stage pipeline runs them in its ranks: their launches,
    # summed over the ranks
    entries += [(k, k, f"{k} {fn}, pipelined flagship ({PIPE_STAGES} ranks "
                 "on one card, one process each, launches summed)",
                 rank_counts[k]) for k, (fn, _, _) in KERNELS.items()]
    for k, key, label, launches in entries:
        _, source, replaces = ALL_KERNELS[k]
        err, ms, plain_ms, bound_ms, bound_by = results[(key, "float32")]
        # no single PyTorch call computes any of the three functions
        kernels.append({"name": label, "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": launches, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
