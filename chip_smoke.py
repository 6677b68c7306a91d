"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 deposit, K2 gather, K3 multigrid, the
fused beam push) from ``hipace_tpu_torch/csrc`` with nvcc, prints each
kernel's registers, stack frame and spills (K2's order-2 kernels must use no
local memory), holds each kernel against its plain PyTorch version at the
main path's shapes (1023^2 grid, ~1.05M plasma particles; K1 and K2 also on
the same lanes shuffled, moved by up to 40 cells, and on a 30k-lane beam
slice) in float32 and float64 (the fused beam push on the benchmark's 2047^2
beam slices of ~42k and ~95k lanes in float64 and the flagship's 30k in
float32, equal valid lanes and resume counters), checks a small time step on the kernels against the same step on
the CPU plain path, then drives the port's main path -- a ``Simulation`` of
the flagship blowout-wake deck (``hipace_tpu_torch.decks.BLOWOUT_WAKE``) at
1023^2 x 64 slices in float32 -- for one warm-up and two timed steps, and
checks that every kernel ran as often as the slice structure predicts (a
beam species' push one fused launch per slice, unless it keeps the subcycle
loop with its K2 launches: external fields, spin, radiation reaction, an
active mesh-refinement level), that
a multigrid solve is at most three device launches, and prints the share of
deposit blocks that took the kernel's direct path. Two more timed steps
follow the counted ones.

Output: a 63^2 x 16 float64 run of the fixed_weight_pdf deck
(``hipace_tpu_torch.decks.PDF_BEAM``) with named field diagnostics of every
kind, beam output and in-situ records, json backend, on the card and on the
CPU from the same beam, whose files must agree; then the pdf path, the same
deck at 1023^2 x 64 in float32 with an xz diagnostic of every comp and rho
(K1 at 14 channels), in-situ records every step and the beam at the last,
checked for its files, finite fields, a conserved beam, the in-situ beam
weight and the launch counts, and timed with and without output. Files go
under ``build/chip_smoke``.

The predictor-corrector: a 63^2 x 16 float64 step of the
predictor-corrector deck with open boundaries
(``hipace_tpu_torch.decks.PC_OPEN``) on the card against the CPU, with equal
iterations on every slice, and the open boundary and the MGDirichlet and
FFTPeriodic Poisson solvers on the card against the CPU; then the PC path,
that deck at 1023^2 x 64 in float32 for one warm-up and two timed steps,
whose K1 and K2 launches must equal what its slice structure and its own
iteration counts predict (no K3 launch), and whose host reads of the device
per slice (counted in the warm-up step) must be the beam's two plus one per
iteration, within 0.15; then MGDirichlet through K3 at 1023^2 with three
channels and a scalar zero acf against its plain version in float32 and
float64, and the open boundary's time per call. K1 is also checked and
timed at the PC path's channel counts (plasma 4 and 2, beam 3 and 2).

Even sizes and the plasma paths: K3's cell-centered levels against their
plain version in float32 and float64 (1024^2, 1024 x 512, 96 x 64 whose
ladder ends at 3 cells, 64 x 32 and 32^2; C = 2 with a 2-D acf, C = 3 with
MGDirichlet's scalar zero acf; equal V-cycle counts; the full-width solves
timed); a 64^2 x 16 float64 step of the two-species
``hipace_tpu_torch.decks.ION_MOTION_EVEN`` on the card against the CPU, from
the same beam and temperature draws, with the leapfrog, AB5 and derivative
types 0 and 1; then the even path, that deck at 1024^2 x 64 in float32 for
one warm-up and two timed steps, its launches against the slice structure
with two species, and one 1024^2 x 16 step of it on MGDirichlet.

The beam paths: "beam paths, small", 63^2 x 16 float64 runs of two steps on
the card against the CPU from the same beams, fields within 1e-8 and equal
V-cycles on every slice, for the drive + witness deck
(``hipace_tpu_torch.decks.DRIVE_WITNESS``: spin tracking and radiation
reaction on the witness), the same with external fields (E under beams.,
the witness's own B, a function of t) and a grid-current deck
(``hipace_tpu_torch.decks.GRID_CURRENT``); then the witness path,
DRIVE_WITNESS at 1023^2 x 64 in float32 for one warm-up and two timed
steps: the K1/K2/K3 launches against the slice structure with two beam
species (K2 1 + 10 + 10 per slice), finite fields, each beam's count
conserved, the witness's |s| within 1e-5 of 1, and K2 held against its
plain version on the witness path's own beam lanes.

The laser and adaptive dt: K3's complex path (the laser envelope's solve)
against its plain version in float32 and float64, node-centered at 1023^2
with the laser's own acf (a chi plane plus an imaginary scalar), 255^2 and
63 x 31, cell-centered at 1024^2, 96 x 64 and 32^2, equal V-cycle counts,
the full-width solves timed beside a real C = 2 solve; "laser, small", two
63^2 x 16 float64 steps of ``hipace_tpu_torch.decks.LASER_WAKE`` on both
laser solvers and both Bx/By solvers with laser_diag output and in-situ
laser records, on the card against the CPU (fields and envelope within
1e-8, real and complex V-cycles and PC iterations equal on every slice,
every output file within 1e-8); the laser path, LASER_WAKE at 1023^2 x 64
in float32 for one warm-up and two timed steps: the launches of K1, K2 and
real and complex K3 against the slice structure, the envelope finite, the
peak |a| of step 0 within 5% of a0, the host's reads per slice, the laser's
own time per slice, and the same deck's first step in float64 for its
V-cycles; "adaptive dt, small", ``ADAPTIVE_VACUUM`` at 32^2 x 32 float64
for 20 steps on the card against the CPU (the dt sequence equal to 1e-12,
landing on max_time, then a dt = 0 step); and the flagship with
``hipace.dt = adaptive`` at 1023^2 x 16, its dt per step and its host reads
against a fixed-dt step.

Ionization and collisions: "ionization, small", a 64^2 x 16 float64 step of
``hipace_tpu_torch.decks.IONIZATION_WAKE`` and of the same under
LASER_WAKE's pulse, and "collisions, small", one of ``COLLISION_WAKE``, on
the card against the CPU from the same beam and the same slice draws
(recorded on the CPU, replayed on the card): fields within 1e-8, equal ion
levels and electron lanes, spawned positions within 1e-12, momenta within
1e-10, V-cycles equal; one slice's beam-plasma collision with many beam
lanes sharing a plasma lane, and the case where the last picker's kick
must stay (ROADMAP R17), on the card as on the CPU. Then the ionization
path, IONIZATION_WAKE at 1023^2 x 64 in float32 (K1/K2/K3 against the slice
structure with one ionization gather per slice, the events per step, no
charge ahead of the beam, the host's reads, the module's time, K2 on the
ions' x_prev against its plain version with its bound), and the collision
path, COLLISION_WAKE at 1023^2 x 64 in float32 (the flagship's launch
counts, the host's reads, the collisions' time and launches per slice,
the non-finite lanes that float32 leaves, ROADMAP R19, in the JAX package
as here, and float32's kicks against float64's on one slice), then one
float64 step of it at full width, its fields and momenta finite and the
plasma's energy within 1e-3 of the same step without collisions.

SALAME and mesh refinement: "SALAME, small", step 0 of
``hipace_tpu_torch.decks.SALAME_WAKE`` at 32^2 x 64 in float64, alone and
with a level, on the card against the CPU from the same beams (fields of
every level within 1e-8, the SALAME slices equal, W within 1e-10, the
witness's weights within 1e-10, V-cycles equal on every slice); "MR, small",
the JAX package's MR test deck in float64 on the card against the CPU with
an even and an odd level, the predictor-corrector, two levels and a laser
(fields of every level within 1e-8, equal V-cycles and iterations), then in
float32 the level's Ez against a uniformly fine 128^2 run at the JAX test's
thresholds; the SALAME path, SALAME_WAKE at 1023^2 x 64 in float32 (a
warm-up simulation, then a fresh one's step 0 with SALAME and step 1
without: launches against the slice structure and its SALAME slices, one
host read more at step 0 than without SALAME, the witness's weights, the
on-axis Ez spread across the witness below 0.4 of the spread without
SALAME, K3 on one of SALAME's solves); the MR path, ``MR_WAKE`` at 1023^2 x
64 in float32 with a 511^2 level (launches against the slice structure and
the level's 33 slices, the flagship's host reads, the fine on-axis Ez
within MR_AXIS_BOUND of the coarse, a coupler product on the card against
the CPU's in float64, and K1, K2 and K3 at the level's shapes against their
plain versions, with K1's direct-path share).

The pipeline: "pipeline, small", the flagship at 63^2 x 16 in float64
through ``Simulation.evolve_pipelined`` with two stages on cuda:0 (one
window, then the serial tail) against the same on the CPU and against the
card's serial loop from the same beam (fields and the final beam within
1e-8, equal V-cycles on every slice of every stage, every per-step openPMD
and in-situ file within 1e-8); then the pipeline path, the flagship at
1023^2 x 64 in float32 with two stages on cuda:0: a warm-up window in
which the host's reads of the device are counted (at most two per slice,
one per tick and five more), two timed windows whose
K1/K2/K3 launches must equal the serial slice structure's for their 4
steps, finite fields on every stage, a conserved beam, the peak memory, and
the serial loop's 4 steps from the same beam twice: its slices/s and peak
memory, the pipelined final beam against the serial one within
PIPE_F32_TOL, beside the spread of the two serial runs.

The ranks (one process per stage, ``hipace_tpu_torch.parallel.ranks``,
``Simulation.evolve_ranks``): "ranks, small", two ranks sharing cuda:0 over
gloo, spawned with ``ranks.spawn``, run the 63^2 x 16 float64 flagship of
"pipeline, small" from its beam, and every openPMD and in-situ file, the
final beam and the V-cycles of every slice must agree with the single-process
two-stage runs on cuda:0 and on the CPU within 1e-8; then the ranks path,
the 1023^2 x 64 float32 flagship as two ranks on cuda:0, one warm-up window
and two timed ones from the pipeline path's beam: each rank's K1/K2/K3
launches against the serial slice structure of the steps it ran, finite
fields, a conserved beam, equal generator draws on every rank and in this
process, the final beam against the single-process pipeline's within
PIPE_F32_TOL, slices/s over all ranks' slices against the pipeline path's
serial loop and single-process pipeline, and each rank's peak memory.
Where there are two cards, the same on one NCCL rank per card.

The bench and the physics gate: "bench" runs the port's bench
(``hipace_tpu_torch.bench``) on its pdf deck at 1023^2 x 64, one warm-up
step and three runs of two measured steps, and prints its JSON line;
"physics gate" runs ``hipace_tpu_torch.gpu_check``: the first seven of its
nine decks (GATE_CASES) at small size for two steps on the CPU in float64,
on the card in float64 and on the card in float32 from one beam and one
set of draws, held by the checksum method's sums (card f64 within 1e-8 of
the CPU, card f32 within each case's pinned tolerance of card f64), and the
flagship at 1023^2 x 64 in float32 against float64 on the card, with K1, K2
and K3 counted over the phase; its record goes to
``build/chip_smoke/gpu_check.json``; its reference leg does not run (it
runs only on a reference checkout named to the gate). Each phase prints its
seconds. It imports nothing but the port.

Beside each kernel's time (CUDA events around calls queued behind a device
sleep) it prints the kernel's bound: the least time the card could take, the
larger of the bytes the function must move (each input read once, each
output written once; for K2 the plane cells under the live lanes' stencils)
over the HBM rate and its operations over the peak rate of their type
(NVIDIA's H100 SXM data sheet).

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Without a usable GPU, or without the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import io
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
NPART = NXY * NXY * 10 * NZ // 1000   # the bench's beam scaling
SMALL_NXY, SMALL_NZ = 63, 16
OUT = ROOT / "build" / "chip_smoke"
# named field diagnostics of every kind, beam output and the three in-situ
# records (the CPU tests' set, tests/test_torch_diagnostics.py)
NAMED_DIAGS = """
max_step = 1
hipace.openpmd_backend = json
diagnostic.output_period = 1
diagnostic.names = lev0 side top integ coarse2 coarse3 patch
diagnostic.field_data = all remove_Sx rho
side.diag_type = xz
top.diag_type = yz
top.field_data = Ez rho_plasma jz_beam
top.output_period = 2
integ.diag_type = xy_integrated
integ.field_data = Ez Psi rho
coarse2.coarsening = 2 2 2
coarse2.field_data = Ez Bx jx
coarse3.diag_type = xz
coarse3.coarsening = 3 3 3
coarse3.include_ghost_cells = 1
coarse3.field_data = Psi By rho_plasma
patch.patch_lo = -2. -1. -4.
patch.patch_hi = 2. 3. 0.
patch.field_data = Ez ExmBy chi
diagnostic.beam_data = beam
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""
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
    "its K2 calls, hipace_tpu/ops/pallas_banded.py:663")})

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, non-tensor FLOP/s by itemsize
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}

# the physics gate's ladder cases run here, cut from the end to keep the two
# last phases near 90 s: salame_wake and mr_wake run in `python -m
# hipace_tpu_torch.gpu_check`
GATE_CASES = 7

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
    from hipace_tpu_torch.ops.deposit import (deposit, direct_block_count,
                                              reset_block_counts)
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.beam_push import beam_push
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.particles.beam import advance_beam_slice
    n0 = int(sim.binned["valid"].sum())
    steps, extra_steps = 3, 2
    for fn in (deposit, gather_main, mg_solve, beam_push):
        fn.launches = 0
    advance_beam_slice.general_calls = 0
    mg_solve.kernel_launches = 0
    reset_block_counts()
    step_seconds = []
    for step in range(steps + extra_steps):
        if step == steps:
            # the counted run ends here; the extra steps are only timed
            counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                           "K3": mg_solve.launches,
                           "beam push": beam_push.launches,
                           "beam loop": advance_beam_slice.general_calls})
            mg_launches = mg_solve.kernel_launches
            direct, blocks = direct_block_count("cuda"), deposit.blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_step(step)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
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
    g = sim.geom
    pcfg = sim.plasma_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (pcfg.n_subcycles + beam_k2(sim)),
                "K3": g.nz, "beam push": g.nz * fused_pushes(sim),
                "beam loop": 0}
    t_timed = sum(step_seconds[1:steps])
    slices = g.nz * (steps - 1)
    print(f"main path {NXY}^2 x {NZ} float32, {NPART} beam particles: "
          f"{slices / t_timed:.3f} slices/s, {1e3 * t_timed / slices:.3f} "
          "ms/slice over 2 timed steps after 1 warm-up", flush=True)
    print("main path slices/s per timed step: "
          + ", ".join(f"{g.nz / t:.3f}" for t in step_seconds[1:]),
          flush=True)
    print(f"main path K1 blocks on the direct path: {direct} of {blocks} "
          f"({100 * direct / blocks:.2f}%)", flush=True)
    print(f"main path K3 device launches per solve: "
          f"{mg_launches / counts['K3']:.2f}", flush=True)
    if mg_launches > 3 * counts["K3"]:
        raise AssertionError("a multigrid solve took more than 3 launches")
    for k, fn_name in [(k, v[0]) for k, v in KERNELS.items()] + [
            ("beam push", "beam_push"), ("beam loop", "general_calls")]:
        want = per_step[k] * steps
        print(f"launches {k} {fn_name}: {counts[k]} (slice structure "
              f"predicts {want})", flush=True)
        if counts[k] != want or (counts[k] == 0 and k != "beam loop"):
            raise AssertionError(f"{k} launch count {counts[k]} != {want}")


@phase("PC, small")
def pc_small_phase(torch):
    """A 63^2 x 16 float64 step of PC_OPEN on the kernels against the same
    step on the CPU plain path: fields within 1e-8, equal iterations on
    every slice; then the open boundary and the MGDirichlet and FFTPeriodic
    solvers on the card against the CPU."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import pc_open
    from hipace_tpu_torch.fields.open_boundary import OpenBoundary
    from hipace_tpu_torch.fields.poisson import make_poisson_solver
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(pc_open(SMALL_NXY, SMALL_NZ, 4000), device="cpu",
                     verbose=0)
    gpu = Simulation(pc_open(SMALL_NXY, SMALL_NZ, 4000), device="cuda",
                     dtype=torch.float64, verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time)
    ref, got = cpu.run_step(0), gpu.run_step(0)
    d_ref, d_got = ref["diag"], got["diag"].cpu()
    rel = float((d_got - d_ref).abs().max() / d_ref.abs().max())
    same_iters = got["pc_iters"] == ref["pc_iters"]
    ok = rel < 1e-8 and same_iters
    print(f"PC, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 PC_OPEN step, "
          f"kernels vs CPU plain path: fields max rel err {rel:.3e} (tol "
          f"1e-8), iterations per slice equal {same_iters} "
          f"({sum(ref['pc_iters'])} in all, {min(ref['pc_iters'])}-"
          f"{max(ref['pc_iters'])} per slice) {'ok' if ok else 'FAIL'}",
          flush=True)
    g = cpu.geom
    rhs = torch.randn((3, g.ny, g.nx), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5))
    worst = {}
    for name, on_card, on_cpu in (
            ("OpenBoundary.apply monopole",
             OpenBoundary(g, device="cuda").apply(rhs.cuda(), True),
             OpenBoundary(g, device="cpu").apply(rhs, True)),
            ("OpenBoundary.apply no monopole",
             OpenBoundary(g, device="cuda").apply(rhs.cuda(), False),
             OpenBoundary(g, device="cpu").apply(rhs, False))):
        worst[name] = float((on_card.cpu() - on_cpu).abs().max()
                            / on_cpu.abs().max())
    for name in ("MGDirichlet", "FFTPeriodic"):
        card = make_poisson_solver(name, g, "cuda", torch.float64)
        host = make_poisson_solver(name, g, "cpu", torch.float64)
        on_card, on_cpu = card.solve(rhs.cuda()).cpu(), host.solve(rhs)
        worst[name] = float((on_card - on_cpu).abs().max()
                            / on_cpu.abs().max())
        if name == "MGDirichlet" and card.mg.last_cycles != \
                host.mg.last_cycles:
            worst[name + " V-cycles"] = float("inf")
    print("PC, small: card vs CPU, float64, C=3: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + " (tol 1e-9)",
        flush=True)
    if not ok or max(worst.values()) > 1e-9:
        raise AssertionError("PC small step or solver mismatch")


@phase("PC path")
def pc_path(torch, counts):
    """PC_OPEN at 1023^2 x 64 in float32: one warm-up step, in which the
    host's synchronizing reads of the device are counted, two timed steps;
    finite fields, the beam conserved, the launch counts against the run's
    own iterations."""
    from hipace_tpu_torch.decks import pc_open
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(pc_open(NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    pcfg = sim.plasma_cfgs[0]
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    iters, step_seconds, copies = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 0:
            # every read of a device value by the host synchronizes: count
            # them through the sync debug mode's warnings
            res, copies = sync_counted(torch, lambda: sim.run_step(step))
        else:
            res = sim.run_step(step)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
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
                   "K3": mg_solve.launches})
    total = sum(map(sum, iters))
    flat = sorted(i for it in iters for i in it)
    median = flat[len(flat) // 2]
    print(f"PC path iterations per slice over {steps} steps: min {flat[0]}, "
          f"median {median}, max {flat[-1]}, total {total}, mean "
          f"{total / len(flat):.3f}", flush=True)
    t_timed = sum(step_seconds[1:])
    slices = g.nz * (steps - 1)
    print(f"PC path {NXY}^2 x {NZ} float32, {NPART} beam particles: "
          f"{slices / t_timed:.3f} slices/s, {1e3 * t_timed / slices:.3f} "
          f"ms/slice, {1e3 * t_timed / sum(map(sum, iters[1:])):.3f} ms per "
          f"iteration over {steps - 1} timed steps after 1 warm-up",
          flush=True)
    mean0 = sum(iters[0]) / g.nz
    print(f"PC path device-to-host copies per slice (synchronizing reads, "
          f"warm-up step): {copies / g.nz:.3f}, with {mean0:.3f} iterations "
          f"per slice (at least the beam's 2 + iterations = "
          f"{2 + mean0:.3f}; limit 2.05 + iterations + 0.1 = "
          f"{2.15 + mean0:.3f})", flush=True)
    want = {"K1": steps * (g.nz * 2 + int(pcfg.neutralize_background))
            + 2 * total,
            "K2": steps * g.nz * (pcfg.n_subcycles + beam_k2(sim))
            + pcfg.n_subcycles * total,
            "K3": 0}
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
EVEN_SMALL = 64
# the "even, small" variants: deck lines added to ION_MOTION_EVEN
EVEN_VARIANTS = (("leapfrog, deriv_type 2", ""),
                 ("AB5", "hipace.plasma_pusher = ab5\n"),
                 ("deriv_type 0", "hipace.depos_derivative_type = 0\n"),
                 ("deriv_type 1", "hipace.depos_derivative_type = 1\n"))


def same_draws(torch, cpu):
    """Make the next two steps -- the CPU simulation's, then the card's --
    draw the same temperature normals: the CPU generator's, moved to the
    card for the second. Returns the function that undoes it."""
    from hipace_tpu_torch.particles import plasma as pl
    orig = pl.plasma_draws
    draws = [orig(p, cpu.geom, cpu.generator, "cpu", torch.float64)
             for p in cpu.plasma_cfgs]
    queue = draws + draws

    def fake(cfg, geom, generator, device, dtype):
        d = queue.pop(0)
        return None if d is None else d.to(device=device, dtype=dtype)

    pl.plasma_draws = fake

    def undo():
        pl.plasma_draws = orig
    return undo


@phase("even, small")
def even_small_phase(torch):
    """A 64^2 x 16 float64 step of ION_MOTION_EVEN (two species, electron
    temperature, cell-centered Bx/By) on the kernels against the same step
    on the CPU plain path, from the same beam and temperature draws, for
    the leapfrog, AB5 and derivative types 0 and 1: fields within 1e-8,
    equal V-cycles on every slice."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import ion_motion_even
    from hipace_tpu_torch.pipeline.simulation import Simulation
    bad = []
    for label, extra in EVEN_VARIANTS:
        deck = ion_motion_even(EVEN_SMALL, SMALL_NZ, 4000, extra)
        cpu = Simulation(deck, device="cpu", verbose=0)
        gpu = Simulation(ion_motion_even(EVEN_SMALL, SMALL_NZ, 4000, extra),
                         device="cuda", dtype=torch.float64, verbose=0)
        carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                          if torch.is_tensor(v)}, cpu.dt, cpu.time)
        undo = same_draws(torch, cpu)
        try:
            ref, got = cpu.run_step(0), gpu.run_step(0)
        finally:
            undo()
        d_ref, d_got = ref["diag"], got["diag"].cpu()
        rel = float((d_got - d_ref).abs().max() / d_ref.abs().max())
        same = got["mg_cycles"] == ref["mg_cycles"]
        ok = rel < 1e-8 and same and gpu.slice_step.mg.cell_centered
        print(f"even, small: {EVEN_SMALL}^2 x {SMALL_NZ} float64 "
              f"ION_MOTION_EVEN, {label}, kernels vs CPU plain path: fields "
              f"max rel err {rel:.3e} (tol 1e-8), V-cycles per slice equal "
              f"{same} ({min(ref['mg_cycles'])}-{max(ref['mg_cycles'])}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
    if bad:
        raise AssertionError(f"even small step mismatch: {bad}")


@phase("even path")
def even_path(torch, counts):
    """ION_MOTION_EVEN at 1024^2 x 64 in float32: one warm-up and two timed
    steps; finite fields, the beam conserved, V-cycles per slice, the K1/K2/
    K3 launches against the slice structure with two species. Then one
    1024^2 x 16 step of the deck on MGDirichlet (cell-centered K3 at C = 3
    for the Poisson solve), its K3 solves counted."""
    from hipace_tpu_torch.decks import ion_motion_even
    from hipace_tpu_torch.ops.deposit import (deposit, direct_block_count,
                                              reset_block_counts)
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(ion_motion_even(EVEN_NXY, NZ, NPART), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    n0 = int(sim.binned["valid"].sum())
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    reset_block_counts()
    res, times = timed_steps(torch, sim, steps, write=False)
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches})
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
    slices = g.nz * (steps - 1)
    t_step = sum(t for t, _ in times[1:])
    print(f"even path: {slices / t_step:.3f} slices/s, "
          f"{1e3 * t_step / slices:.3f} ms/slice over {steps - 1} timed "
          f"steps after 1 warm-up; per timed step "
          + ", ".join(f"{g.nz / t:.3f}" for t, _ in times[1:]), flush=True)
    cfgs = sim.plasma_cfgs
    per_step = {
        "K1": sum(int(p.neutralize_background) for p in cfgs)
        + g.nz * (len(cfgs) + 2),
        "K2": g.nz * (sum(p.n_subcycles for p in cfgs) + beam_k2(sim)),
        "K3": g.nz}
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = mgd.run_step(0)
    torch.cuda.synchronize()
    t_mgd = time.perf_counter() - t0
    mg_finite = bool(torch.isfinite(mres["diag"]).all())
    counts["K3 MGDirichlet"] = mg_solve.launches - SMALL_NZ
    print(f"even path on MGDirichlet, {EVEN_NXY}^2 x {SMALL_NZ} float32: "
          f"K3 solves {mg_solve.launches} (Bx/By and Poisson per slice: "
          f"{2 * SMALL_NZ} predicted), fields finite {mg_finite}, "
          f"{1e3 * t_mgd / SMALL_NZ:.3f} ms/slice (one step, compiled)",
          flush=True)
    if (not finite or n != n0 or not mg_finite
            or mg_solve.launches != 2 * SMALL_NZ
            or any(c != per_step[k] * steps for k, c in counts.items()
                   if k in per_step)):
        raise AssertionError("even path: fields, beam or launch counts "
                             "wrong")


# the "beam paths, small" decks: (label, deck function, deck lines added)
BEAM_VARIANTS = (
    ("DRIVE_WITNESS", "drive_witness", ""),
    ("DRIVE_WITNESS + external fields", "drive_witness",
     "beams.external_E(x,y,z,t) = 0.02*x*(1.+0.1*t) 0.02*y 0.01\n"
     "witness.external_B(x,y,z,t) = 0.01*y 0.005*x 0.\n"),
    ("GRID_CURRENT", "grid_current", ""),
)


@phase("beam paths, small")
def beam_small_phase(torch):
    """Two 63^2 x 16 float64 steps of each BEAM_VARIANTS deck on the kernels
    against the same steps on the CPU plain path from the same beams:
    fields within 1e-8 of their largest value, equal V-cycles on every
    slice, the same live lanes, the beams (positions, momenta, spins)
    within 1e-8."""
    from hipace_tpu_torch import decks
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.particles.beam import BEAM_ATTRS
    from hipace_tpu_torch.pipeline.simulation import Simulation
    bad = []
    for label, fn, extra in BEAM_VARIANTS:
        def deck():
            return getattr(decks, fn)(SMALL_NXY, SMALL_NZ, 4000, extra)
        cpu = Simulation(deck(), device="cpu", verbose=0)
        gpu = Simulation(deck(), device="cuda", dtype=torch.float64,
                         verbose=0)
        carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                          if torch.is_tensor(v)}, cpu.dt, cpu.time,
                    [b.total_charge for b in cpu.beam_cfgs])
        rel, brel, same = 0.0, 0.0, True
        for step in range(2):
            ref = cpu.advance(step, write_output=False)
            got = gpu.advance(step, write_output=False)
            d_ref, d_got = ref["diag"], got["diag"].cpu()
            rel = max(rel, float((d_got - d_ref).abs().max()
                                 / d_ref.abs().max()))
            same = same and got["mg_cycles"] == ref["mg_cycles"]
            v = ref["binned"]["valid"]
            same = same and bool((got["binned"]["valid"].cpu() == v).all())
            for k in BEAM_ATTRS:
                r = ref["binned"][k][v]
                if r.numel() and float(r.abs().max()) > 0:
                    brel = max(brel, float(
                        (got["binned"][k].cpu()[v] - r).abs().max()
                        / r.abs().max()))
        cfgs = gpu.beam_cfgs
        ok = rel < 1e-8 and brel < 1e-8 and same
        print(f"beam paths, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 "
              f"{label}, {len(cfgs)} beam(s) (spin "
              f"{[b.do_spin_tracking for b in cfgs]}, radiation reaction "
              f"{[b.do_radiation_reaction for b in cfgs]}, external fields "
              f"{[b.use_external_fields for b in cfgs]}, grid current "
              f"{gpu.cfg.grid_current is not None}), 2 steps, kernels vs CPU"
              f" plain path: fields max rel err {rel:.3e} (tol 1e-8), beams "
              f"{brel:.3e} (tol 1e-8), V-cycles per slice and live lanes "
              f"equal {same} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
    if bad:
        raise AssertionError(f"beam paths small step mismatch: {bad}")


@phase("witness path")
def witness_path(torch, counts, results):
    """DRIVE_WITNESS at 1023^2 x 64 in float32: one warm-up and two timed
    steps; finite fields and momenta, each beam's count conserved (by
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
        res, times = timed_steps(torch, sim, steps, write=False)
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
    slices = g.nz * (steps - 1)
    t_step = sum(t for t, _ in times[1:])
    print(f"witness path: {slices / t_step:.3f} slices/s, "
          f"{1e3 * t_step / slices:.3f} ms/slice over {steps - 1} timed "
          f"steps after 1 warm-up; per timed step "
          + ", ".join(f"{g.nz / t:.3f}" for t, _ in times[1:])
          + f"; {CARD['line']}", flush=True)
    pcfg = sim.plasma_cfgs[0]
    # the drive beam takes the fused push, the witness (spin, radiation
    # reaction) keeps the subcycle loop
    sub = beam_k2(sim)
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (pcfg.n_subcycles + sub), "K3": g.nz,
                "K2 beam": g.nz * sub, "beam push": g.nz * fused_pushes(sim)}
    for k, count in counts.items():
        print(f"witness path launches {k}: {count} (slice structure with "
              f"{nb} beam species predicts {per_step[k] * steps}; per slice "
              f"K2 {pcfg.n_subcycles} + {sub} (the loop's subcycles), "
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
LASER_BOX = ("geometry.prob_lo = -10. -10. -7.5\n"
             "geometry.prob_hi = 10. 10. 6.\n")
# "laser, small": (label, deck lines); both laser solvers, both Bx/By
# solvers. The predictor-corrector runs in a (-10..10)^2 box: in
# LASER_WAKE's own (-20..20)^2 box at 63^2 its loop runs 30 iterations on
# every slice and its fields depend on the last bits of a0 (the JAX
# package's as the port's), so no two runs can agree there
LASER_VARIANTS = (
    ("explicit + multigrid", ""),
    ("predictor-corrector + FFT, (-10..10)^2 box",
     "hipace.bxby_solver = predictor-corrector\nlasers.solver_type = fft\n"
     + LASER_BOX),
)
LASER_OUTPUT = """
max_step = 1
diagnostic.output_period = 1
hipace.openpmd_backend = json
diagnostic.names = lev0 laser_diag
lev0.field_data = all
lasers.insitu_period = 1
"""


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


def all_files(folder):
    return sorted(p for p in folder.rglob("*") if p.is_file())


@phase("laser, small")
def laser_small_phase(torch):
    """Two 63^2 x 16 float64 steps of LASER_WAKE per LASER_VARIANTS on the
    kernels against the same steps on the CPU plain path, each writing
    openPMD files (json; lev0 with every field and laser_diag,
    laserEnvelope included) and in-situ laser records: each field of the
    stack and the laser stream within 1e-8, real
    and complex V-cycles and PC iterations equal on every slice, every
    output file within 1e-8."""
    import shutil
    from hipace_tpu_torch.decks import laser_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    bad = []
    for i, (label, extra) in enumerate(LASER_VARIANTS):
        sims, res = {}, {}
        for dev in ("cpu", "cuda"):
            folder = OUT / f"laser_small_{i}_{dev}"
            shutil.rmtree(folder, ignore_errors=True)
            sims[dev] = Simulation(laser_wake(
                SMALL_NXY, SMALL_NZ, 0, extra + LASER_OUTPUT
                + f"hipace.file_prefix = {folder}/openpmd\n"
                + f"lasers.insitu_file_prefix = {folder}/laser_insitu\n"),
                device=dev, dtype=torch.float64, verbose=0)
            res[dev] = []
            for step in range(2):
                sims[dev].set_dt()
                res[dev].append(sims[dev].advance(step))
        # each field of the lev0 stack (field_data = all) on its own scale
        rel, srel, same = 0.0, 0.0, True
        comps = sims["cpu"].cfg.diag_comps
        for ref, got in zip(res["cpu"], res["cuda"]):
            d_ref, d_got = ref["diag"], got["diag"].cpu()
            per = ((d_got - d_ref).abs().amax(dim=(0, 2, 3))
                   / d_ref.abs().amax(dim=(0, 2, 3)).clamp_min(1e-300))
            rel = max(rel, float(per.max()))
            for k in (0, 1):
                s_ref = ref["laser_stream"][k]
                srel = max(srel, float(
                    (got["laser_stream"][k].cpu() - s_ref).abs().max()
                    / s_ref.abs().max()))
            for key in ("mg_cycles", "laser_cycles", "pc_iters"):
                same = same and got[key] == ref[key]
        files = {dev: all_files(OUT / f"laser_small_{i}_{dev}")
                 for dev in sims}
        names = [f.relative_to(OUT / f"laser_small_{i}_cpu")
                 for f in files["cpu"]]
        worst = [0.0, ""]
        if [f.relative_to(OUT / f"laser_small_{i}_cuda")
                for f in files["cuda"]] != names or len(names) != 3:
            raise AssertionError(f"the runs wrote different files: {files}")
        # the first |a|^2 moments in x and y cancel over the symmetric
        # pulse: they are held on the scale of the sum of |a|^2 times the
        # box's half width
        g = sims["cpu"].geom
        half = max(abs(v) for v in g.prob_lo[:2] + g.prob_hi[:2])
        for got_f, ref_f in zip(files["cuda"], files["cpu"]):
            if got_f.suffix == ".json":
                compare_tree(json.loads(got_f.read_text()),
                             json.loads(ref_f.read_text()), got_f.name,
                             worst)
                continue
            got_r, ref_r = read_insitu(got_f), read_insitu(ref_f)
            first = ("[|a|^2*x]", "[|a|^2*y]")
            for k in ref_r.dtype.names:
                if k not in first:
                    compare_tree(got_r[k], ref_r[k], f"{got_f.name}[{k}]",
                                 worst)
            scale = half * float(abs(ref_r["[|a|^2]"]).max())
            for k in first:
                mrel = float(abs(got_r[k] - ref_r[k]).max()) / scale
                if mrel > worst[0]:
                    worst[:] = [mrel, f"{got_f.name}[{k}] (/ half width x "
                                      "sum |a|^2)"]
        last = res["cuda"][-1]
        ok = rel < 1e-8 and srel < 1e-8 and same and worst[0] < 1e-8
        print(f"laser, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 LASER_WAKE "
              f"{label}, 2 steps, kernels vs CPU plain path: fields "
              f"({len(comps)}: {' '.join(comps)}) max rel err {rel:.3e} (each "
              f"on its own max), envelope {srel:.3e}, {len(names)} files "
              f"({', '.join(map(str, names))}) worst {worst[0]:.3e} "
              f"({worst[1]}) (tol 1e-8); real V-cycles, complex V-cycles "
              f"and PC iterations per slice equal {same} (last step: "
              f"{last['mg_cycles']}, {last['laser_cycles']}, "
              f"{last['pc_iters']}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
    if bad:
        raise AssertionError(f"laser small step mismatch: {bad}")


@phase("laser path")
def laser_path(torch, counts, results):
    """LASER_WAKE at 1023^2 x 64 in float32: one warm-up step, in which the
    host's reads of the device are counted, and two timed steps; the
    launches of K1, K2, real and complex K3 against the slice structure,
    finite fields and envelope, the peak |a| of step 0 within 5% of a0; the
    laser's time per slice from its own calls; step 0 against the same step
    in float64 and in float32 on the plain versions."""
    import math
    from hipace_tpu_torch.decks import laser_wake
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_laser_aabs, gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(laser_wake(NXY, LASER_NZ), device="cuda",
                     dtype=torch.float32, verbose=0)
    g = sim.geom
    a0 = sim.laser_cfg.pulses[0].a0
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    mg_solve.complex_launches = 0
    times, peaks, copies = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 0:
            res, copies = sync_counted(torch, lambda: sim.run_step(0))
        else:
            res = sim.run_step(step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
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
                   "K3 complex": mg_solve.complex_launches})
    pcfg = sim.plasma_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + g.nz,
                "K2": g.nz * pcfg.n_subcycles, "K3": g.nz,
                "K3 complex": g.nz}
    for k, count in counts.items():
        print(f"laser path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps}: per slice one plasma deposit, push "
              f"and Bx/By solve and one envelope solve; no beam)",
              flush=True)
    slices = g.nz * (steps - 1)
    t_step = sum(times[1:])
    print(f"laser path {NXY}^2 x {g.nz} float32, {sim.laser_geom.slice_shape}"
          f" complex envelope, no beam: {slices / t_step:.3f} slices/s, "
          f"{1e3 * t_step / slices:.3f} ms/slice over {steps - 1} timed "
          f"steps after 1 warm-up; per timed step "
          + ", ".join(f"{g.nz / t:.3f}" for t in times[1:])
          + f"; {CARD['line']}", flush=True)
    print(f"laser path device-to-host copies per slice (synchronizing reads, "
          f"warm-up step): {copies / g.nz:.3f} (the flagship's: the beam's "
          f"2.05; the laser adds none)", flush=True)
    # the laser's own device work per slice, each part timed alone on the
    # path's shapes: the advance (its complex K3 solve apart) and the |a|^2
    # gathers of the deposit and of the push on the plasma's lanes
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
    aabs = torch.abs(state["n00j00"]) ** 2
    gat_ms = cuda_ms(lambda: gather_laser_aabs(lanes["x"], lanes["y"], aabs,
                                               g, 2))
    laser_ms = adv_ms + 2 * gat_ms
    print(f"laser path, the laser's device time per slice: advance "
          f"{adv_ms:.3f} ms (with its complex K3 solve), |a|^2 gather "
          f"{gat_ms:.3f} ms x 2 (deposit and push) = {laser_ms:.3f} ms, "
          f"{100 * laser_ms / (1e3 * t_step / slices):.1f}% of the wall "
          f"time per slice; {CARD['line']}", flush=True)
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


@phase("adaptive dt, small")
def adaptive_small_phase(torch):
    """ADAPTIVE_VACUUM at 32^2 x 32 float64 through the time loop for 20
    steps on the kernels and on the CPU plain path: equal dt sequences to
    1e-12, landing on max_time, then one step with dt = 0."""
    from hipace_tpu_torch.decks import adaptive_vacuum
    from hipace_tpu_torch.pipeline.simulation import Simulation
    dts = {}
    for dev in ("cpu", "cuda"):
        sim = Simulation(adaptive_vacuum(32, 32, 20, 80.0), device=dev,
                         dtype=torch.float64, verbose=0)
        dts[dev] = []
        for step in range(sim.max_step + 1):
            sim.set_dt()
            dts[dev].append(sim.dt)
            sim.advance(step, write_output=False)
            if sim._has_last_step:
                break
        dts[dev + " time"] = sim.time
    ref, got = dts["cpu"], dts["cuda"]
    rel = max(abs(a - b) / max(abs(b), 1e-300) for a, b in zip(got, ref))
    ok = (len(got) == len(ref) == 20 and rel <= 1e-12 and got[-1] == 0.0
          and dts["cuda time"] == 80.0)
    print(f"adaptive dt, small: 32^2 x 32 float64 ADAPTIVE_VACUUM, "
          f"{len(got)} steps on the card (CPU {len(ref)}), dt max rel err "
          f"{rel:.3e} (tol 1e-12), time at the end {dts['cuda time']!r} "
          f"(max_time 80.0), dt per step {', '.join(f'{d:.9g}' for d in got)}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("adaptive dt sequence mismatch")


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
ION_SMALL = 64
# LASER_WAKE's pulse (a0 4.5, w0 4 and L0 2 plasma skin depths, at the
# origin, lambda0 0.8 um) over IONIZATION_WAKE's plasma, in its SI units
ION_LASER = """
lasers.names = laser
lasers.lambda0 = .8e-6
lasers.solver_type = multigrid
laser.a0 = 4.5
laser.position_mean = 0. 0. 0.
laser.w0 = 4. * kp_inv
laser.L0 = 2. * kp_inv
"""


def card_and_cpu(torch, deck_fn):
    """One float64 step of the deck deck_fn() on the CPU plain path and on
    the kernels, from the CPU simulation's beam and with its slice draws
    (recorded on the CPU, replayed on the card). Returns (cpu simulation,
    card simulation, CPU result, card result)."""
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(deck_fn(), device="cpu", verbose=0)
    gpu = Simulation(deck_fn(), device="cuda", dtype=torch.float64,
                     verbose=0)
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time,
                [b.total_charge for b in cpu.beam_cfgs])
    drawn, own = [], cpu.slice_step.draws

    def record(name, *shape):
        drawn.append(own(name, *shape))
        return drawn[-1]

    cpu.slice_step.draws = record
    ref = cpu.run_step(0)
    gpu.slice_step.draws = lambda name, *shape: drawn.pop(0).to("cuda")
    got = gpu.run_step(0)
    if drawn:
        raise AssertionError(f"the card took {len(drawn)} draws fewer")
    return cpu, gpu, ref, got


def rel_err(got, ref):
    got, ref = got.cpu().double(), ref.cpu().double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


def a0_sensitivity(torch):
    """How far the spawned electrons' positions of the laser variant move
    on the CPU when a0 moves by one unit in the last place: the deck's own
    sensitivity to roundoff (electrons born at rest inside a pulse of a0
    4.5 reach |u| ~ 10^5 c)."""
    from hipace_tpu_torch.decks import ionization_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    elec = []
    for a0 in ("4.5", "4.500000000000001"):
        sim = Simulation(ionization_wake(ION_SMALL, SMALL_NZ, 0, ION_LASER
                                         .replace("laser.a0 = 4.5",
                                                  f"laser.a0 = {a0}")),
                         device="cpu", verbose=0)
        elec.append(sim.run_step(0)["plasma"][0])
    live = elec[0]["valid"] & elec[1]["valid"]
    return max(rel_err(elec[1][k][live], elec[0][k][live])
               for k in ("x", "y"))


@phase("ionization, small")
def ionization_small_phase(torch):
    """A 64^2 x 16 float64 step of IONIZATION_WAKE, and of the same with
    LASER_WAKE's pulse over its plasma, on the kernels against the CPU plain
    path from the same beam and draws: fields within 1e-8, the ions' levels
    and the electrons' live lanes equal, V-cycles equal on every slice, the
    spawned electrons' positions within 1e-12, with the laser within a
    hundred times the distance a one-ulp change of a0 moves them on the CPU
    (the kernels' atomics reorder sums on every slice, not once)."""
    from hipace_tpu_torch.decks import ionization_wake
    bad = []
    for label, extra in (("", ""), (", with a laser", ION_LASER)):
        pos_tol = 100 * a0_sensitivity(torch) if extra else 1e-12
        _, _, ref, got = card_and_cpu(torch, lambda: ionization_wake(
            ION_SMALL, SMALL_NZ, 0, extra))
        rel = rel_err(got["diag"], ref["diag"])
        (e_ref, i_ref), (e_got, i_got) = ref["plasma"], got["plasma"]
        same_lev = bool((i_got["ion_lev"].cpu() == i_ref["ion_lev"]).all())
        live = e_ref["valid"]
        same_live = bool((e_got["valid"].cpu() == live).all())
        pos = max(rel_err(e_got[k][live.cuda()], e_ref[k][live])
                  for k in ("x", "y"))
        cycles = got["mg_cycles"] == ref["mg_cycles"]
        events = (int(got["ionized"]), int(ref["ionized"]))
        ok = (rel < 1e-8 and same_lev and same_live and pos < pos_tol
              and cycles and events[0] == events[1] > 0)
        print(f"ionization, small: {ION_SMALL}^2 x {SMALL_NZ} float64 "
              f"IONIZATION_WAKE{label}, kernels vs CPU plain path: fields max"
              f" rel err {rel:.3e} (tol 1e-8), ion levels equal {same_lev}, "
              f"electron lanes equal {same_live} ({int(live.sum())} live), "
              f"spawned positions {pos:.3e} (tol {pos_tol:.3e}), ionization "
              f"events "
              f"{events[0]} (CPU {events[1]}), V-cycles equal {cycles} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label or "no laser")
    if bad:
        raise AssertionError(f"ionization small step mismatch: {bad}")


def duplicate_partner_case(torch, device, order):
    """The R17 case: beam lanes A and B in one cell with one plasma lane, A
    rejecting the plasma lane's kick and B taking it, in the given order.
    Returns whether the plasma lane moved."""
    from hipace_tpu_torch.decks import collision_wake
    from hipace_tpu_torch.particles import collisions as coll
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(collision_wake(16, 4, 100), device="cpu", verbose=0)
    g, f64 = sim.geom, dict(dtype=torch.float64, device=device)
    x0, y0 = g.prob_lo[0] + 5.5 * g.dx, g.prob_lo[1] + 7.5 * g.dy
    lanes = {"A": (0.3, -0.2, 1500., 0.5, 0.9),
             "B": (-0.1, 0.4, 2500., 0.5, 0.1)}
    ux, uy, uz, w, r2 = (torch.tensor(v, **f64)
                         for v in zip(*(lanes[c] for c in order)))
    beam = {"x": torch.full((2,), x0, **f64), "y": torch.full((2,), y0, **f64),
            "ux": ux, "uy": uy, "uz": uz, "w": w,
            "valid": torch.ones(2, dtype=torch.bool, device=device)}
    plasma = {"x": torch.tensor([x0 + 0.1 * g.dx], **f64),
              "y": torch.tensor([y0], **f64),
              "ux": torch.tensor([0.01], **f64),
              "uy": torch.tensor([-0.02], **f64),
              "psi": torch.ones(1, **f64), "w": torch.ones(1, **f64),
              "valid": torch.ones(1, dtype=torch.bool, device=device)}
    draws = {"sort": torch.tensor([0.5], **f64),
             "pick": torch.tensor([0.3, 0.6], **f64),
             "kick": torch.stack([torch.full((2,), 0.4, **f64),
                                  torch.full((2,), 0.7, **f64),
                                  torch.zeros(2, **f64), r2])}
    _, out = coll.beam_plasma_collision(
        beam, plasma, g, sim.beam_cfgs[0], sim.plasma_cfgs[0], sim.pc, -1.0,
        1e24, True, draws, 1.0)
    return bool(out["ux"][0] != plasma["ux"][0])


@phase("collisions, small")
def collisions_small_phase(torch):
    """A 64^2 x 16 float64 step of COLLISION_WAKE on the kernels against
    the CPU plain path from the same beam and draws: the plasma's and the
    beam's momenta within 1e-10, fields within 1e-8. Then the duplicate
    partners: one slice's beam-plasma collision on the card against the CPU
    with the same draws, many beam lanes sharing a plasma lane, within
    1e-10; and the R17 case, where the card must keep the last picker's
    kick as the CPU does."""
    from hipace_tpu_torch.decks import collision_wake
    from hipace_tpu_torch.particles import collisions as coll
    cap = {}
    cpu, gpu, ref, got = card_and_cpu(torch, lambda: collision_wake(
        ION_SMALL, SMALL_NZ, 4000))
    rel = rel_err(got["diag"], ref["diag"])
    p_ref, p_got = ref["plasma"][0], got["plasma"][0]
    prel = max(rel_err(p_got[k], p_ref[k]) for k in ("ux", "uy", "psi"))
    v = ref["binned"]["valid"]
    brel = max(rel_err(got["binned"][k][v.cuda()], ref["binned"][k][v])
               for k in ("ux", "uy", "uz"))
    cycles = got["mg_cycles"] == ref["mg_cycles"]
    # one slice's beam-plasma collision from the CPU run's own state
    orig = cpu.slice_step.collide

    def capture(plasmas, emit, dt):
        if len(emit["x"]) > len(cap.get("emit", {"x": ()})["x"]):
            cap.update(plasma=plasmas[0], emit=emit, dt=dt)
        return orig(plasmas, emit, dt)

    cpu.slice_step.collide = capture
    cpu.run_step(1)
    emit, plasma = cap["emit"], cap["plasma"]
    cells, _ = coll._cell_of(emit["x"], emit["y"], cpu.geom)
    per_cell = torch.bincount(cells, minlength=cpu.geom.nx * cpu.geom.ny + 1)
    shared = int((per_cell[:-1] > 1).sum())
    gen = torch.Generator().manual_seed(5)
    nb, n = emit["x"].numel(), plasma["x"].numel()
    draws = {"sort": torch.rand(n, generator=gen, dtype=torch.float64),
             "pick": torch.rand(nb, generator=gen, dtype=torch.float64),
             "kick": torch.rand((4, nb), generator=gen, dtype=torch.float64)}
    args = (cpu.geom, cpu.beam_cfgs[0], cpu.plasma_cfgs[0], cpu.pc, -1.0,
            1e24, True)
    b_ref, q_ref = coll.beam_plasma_collision(emit, plasma, *args, draws,
                                              cap["dt"])

    def on_card(d):
        return {k: t.cuda() for k, t in d.items()}

    b_got, q_got = coll.beam_plasma_collision(
        on_card(emit), on_card(plasma), *args, on_card(draws), cap["dt"])
    drel = max([rel_err(b_got[k], b_ref[k]) for k in ("ux", "uy", "uz")]
               + [rel_err(q_got[k], q_ref[k]) for k in ("ux", "uy", "psi")])
    moved = ((q_got["ux"].cpu() != plasma["ux"])
             == (q_ref["ux"] != plasma["ux"])).all()
    r17 = {(dev, order): duplicate_partner_case(torch, dev, order)
           for dev in ("cpu", "cuda") for order in ("AB", "BA")}
    r17_ok = all(r17[(dev, "AB")] and not r17[(dev, "BA")]
                 for dev in ("cpu", "cuda"))
    ok = (rel < 1e-8 and prel < 1e-10 and brel < 1e-10 and cycles
          and drel < 1e-10 and bool(moved) and r17_ok and shared > 0)
    print(f"collisions, small: {ION_SMALL}^2 x {SMALL_NZ} float64 "
          f"COLLISION_WAKE, kernels vs CPU plain path: fields max rel err "
          f"{rel:.3e} (tol 1e-8), plasma momenta {prel:.3e}, beam momenta "
          f"{brel:.3e} (tol 1e-10), V-cycles equal {cycles}; one slice's "
          f"beam-plasma collision ({nb} beam lanes, {shared} cells where "
          f"several pick the cell's one plasma lane) card vs CPU {drel:.3e} "
          f"(tol 1e-10), the same plasma lanes kicked {bool(moved)}; R17 "
          f"case (the plasma lane moves when the accepting lane is last): "
          f"{r17} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("collision small step mismatch")


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
    """IONIZATION_WAKE at 1023^2 x 64 in float32 with rho deposited: one
    warm-up step and two timed steps, in the first of which the host's
    reads of the device are counted; the K1/K2/K3 launches against the slice structure with
    two species and one ionization gather per slice, finite fields, the
    beam's lanes conserved, the ionization events per step, no charge ahead
    of the beam's head (below 1e-3 qe ne, test_ionization.py's bound); then
    the ionization module's device time per slice and K2 on the path's own
    ion lanes at x_prev against its plain version, timed, with its bound."""
    from hipace_tpu_torch.decks import ionization_wake
    from hipace_tpu_torch.ops import gather as gat
    from hipace_tpu_torch.ops.deposit import deposit
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
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    ion_k2, kept, undo = counted_ionization(torch)
    times, events, copies = [], [], 0
    try:
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1:
                # counted after the warm-up's one-time copies (the ADK table)
                res, copies = sync_counted(torch, lambda: sim.run_step(1))
            else:
                res = sim.run_step(step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            events.append(int(res["ionized"]))
            sim.binned = res["binned"]
            sim.time += sim.dt
    finally:
        undo()
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches, "K2 ionization": ion_k2["K2"]})
    cfgs = sim.plasma_cfgs
    per_step = {"K1": sum(int(p.neutralize_background) for p in cfgs)
                + g.nz * (len(cfgs) + 2),
                "K2": g.nz * (sum(p.n_subcycles for p in cfgs)
                              + beam_k2(sim) + 1),
                "K3": g.nz, "K2 ionization": g.nz}
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
    slices = g.nz * (steps - 1)
    t_step = sum(times[1:])
    print(f"ionization path: {slices / t_step:.3f} slices/s, "
          f"{1e3 * t_step / slices:.3f} ms/slice over {steps - 1} timed steps"
          f" after 1 warm-up; per timed step "
          + ", ".join(f"{g.nz / t:.3f}" for t in times[1:])
          + f"; {CARD['line']}", flush=True)
    print(f"ionization path device-to-host copies per slice (synchronizing "
          f"reads, first timed step): {copies / g.nz:.3f} (the flagship's, "
          f"the beam's two per slice and the step's own four: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"ionization path launches {k}: {count} (slice structure "
              f"predicts {per_step[k] * steps}: per slice two species' "
              f"deposits and pushes, the beam's fused push (K2 in its loop: "
              f"{beam_k2(sim)}), one ionization gather)", flush=True)
    # the module and its gather alone, on the kept call's arguments
    args = kept["args"]
    draw = torch.rand(args[0]["x"].numel(), device="cuda")
    mod_ms = cuda_ms(lambda: pl.ionization_module(*args[:-1], draw))
    print(f"ionization path, the ionization module's device time per slice "
          f"(one call on the path's state, its K2 gather included): "
          f"{mod_ms:.4f} ms, {100 * mod_ms / (1e3 * t_step / slices):.1f}% "
          f"of the wall time per slice; {CARD['line']}", flush=True)
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
    """COLLISION_WAKE at 1023^2 x 64 in float32: one warm-up step and two
    timed steps, in the first of which the host's reads of the device are
    counted; the
    K1/K2/K3 launches equal to the flagship's (collisions launch none of
    the three), the collisions' device time and launches per slice on the
    path's own state, and what float32 does to them (ROADMAP R19: their
    guards and products leave float32's range, in the JAX package as here,
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
        # the warm-up step's fullest slice: float32 leaves later steps'
        # states non-finite (R19)
        if sim.time == 0.0 and emit["x"].numel() >= kept["nb"]:
            kept.update(args=(plasmas, emit, dt), nb=emit["x"].numel())
        return orig(plasmas, emit, dt)

    st.collide = keep
    steps = 3
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    times, copies, bad = [], 0, []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == 1:
            res, copies = sync_counted(torch, lambda: sim.run_step(1))
        else:
            res = sim.run_step(step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad.append(nonfinite(res, res["binned"]))
        sim.binned = res["binned"]
        sim.time += sim.dt
    st.collide = orig
    counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                   "K3": mg_solve.launches})
    pcfg, bcfg = sim.plasma_cfgs[0], sim.beam_cfgs[0]
    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (pcfg.n_subcycles + beam_k2(sim)),
                "K3": g.nz}
    slices = g.nz * (steps - 1)
    t_step = sum(times[1:])
    print(f"collision path {NXY}^2 x {NZ} float32, {NPART} beam particles, "
          f"collisions {sim.cfg.collisions}: non-finite (plasma lanes, beam "
          f"lanes, field values) after each step {bad} (ROADMAP R19); "
          f"{slices / t_step:.3f} slices/s, {1e3 * t_step / slices:.3f} "
          f"ms/slice over {steps - 1} timed steps after 1 warm-up; per timed "
          f"step " + ", ".join(f"{g.nz / t:.3f}" for t in times[1:])
          + f"; {CARD['line']}", flush=True)
    print(f"collision path device-to-host copies per slice (synchronizing "
          f"reads, first timed step): {copies / g.nz:.3f} (the flagship's, "
          f"the beam's two per slice and the step's own four: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"collision path launches {k}: {count} (the flagship's "
              f"{per_step[k] * steps})", flush=True)
    # the collisions alone on the warm-up's fullest slice: device time and
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
    print(f"collision path, the collisions of one slice (the warm-up "
          f"step's fullest slice, {kept['nb']} beam lanes, "
          f"{plasmas[0]['x'].numel()} plasma lanes): {ms:.4f} ms (CUDA "
          f"events), {launches} launches, "
          f"{100 * ms / (1e3 * t_step / slices):.1f}% of the wall time per "
          f"slice; the same-species collision alone {pp_ms:.4f} ms; "
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


def worst_rel(got, ref, where, worst):
    """Record max|got - ref| / max|ref| of one dataset in worst[0], and raise
    where the shapes or the integer and string values differ."""
    import numpy as np
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"{where}: shape {got.shape} != {ref.shape}")
    if ref.dtype.kind not in "fc":
        if not np.array_equal(got, ref):
            raise AssertionError(f"{where}: {got} != {ref}")
        return
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    rel = err / scale if scale > 0 else err
    if rel > worst[0]:
        worst[:] = [rel, where]


def compare_tree(got, ref, where, worst):
    """Walk two openPMD json documents or in-situ records together."""
    if isinstance(ref, dict):
        if sorted(got) != sorted(ref):
            raise AssertionError(f"{where}: keys {sorted(got)} != "
                                 f"{sorted(ref)}")
        for k in ref:
            compare_tree(got[k], ref[k], f"{where}/{k}", worst)
    elif getattr(getattr(ref, "dtype", None), "names", None):
        for k in ref.dtype.names:
            compare_tree(got[k], ref[k], f"{where}[{k}]", worst)
    elif isinstance(ref, (list, float, int)) or hasattr(ref, "dtype"):
        worst_rel(got, ref, where, worst)
    elif got != ref:
        raise AssertionError(f"{where}: {got!r} != {ref!r}")


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


@phase("output, small")
def output_small_phase(torch):
    """The 63^2 x 16 float64 pdf deck with named diagnostics of every kind,
    beam output and in-situ records on the card and on the CPU from the same
    beam: every dataset and record within 1e-8, equal V-cycle counts."""
    import shutil
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import pdf_beam
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sims, cycles = {}, {}
    for dev in ("cpu", "cuda"):
        folder = OUT / f"small_{dev}"
        shutil.rmtree(folder, ignore_errors=True)
        sims[dev] = Simulation(
            output_deck(pdf_beam, SMALL_NXY, SMALL_NZ, 4000, NAMED_DIAGS,
                        folder), device=dev, dtype=torch.float64, verbose=0)
    cpu, gpu = sims["cpu"], sims["cuda"]
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time)
    for dev, sim in sims.items():
        cycles[dev] = [sim.advance(step)["mg_cycles"]
                       for step in range(sim.max_step + 1)]
    files = {dev: output_files(OUT / f"small_{dev}") for dev in sims}
    names = [f.relative_to(OUT / "small_cpu") for f in files["cpu"]]
    if [f.relative_to(OUT / "small_cuda") for f in files["cuda"]] != names \
            or len(names) != 5 or not all(f.exists() for f in files["cuda"]):
        raise AssertionError(f"the runs wrote different files: {files}")
    worst = [0.0, ""]
    for got, ref in zip(files["cuda"], files["cpu"]):
        if got.suffix == ".json":
            compare_tree(json.loads(got.read_text()),
                         json.loads(ref.read_text()), got.name, worst)
        else:
            compare_tree(read_insitu(got), read_insitu(ref), got.name, worst)
    ok = worst[0] < 1e-8 and cycles["cuda"] == cycles["cpu"]
    print(f"output, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 pdf deck, "
          f"{len(names)} files ({', '.join(map(str, names))}), kernels vs "
          f"CPU plain path: worst dataset max rel err {worst[0]:.3e} "
          f"({worst[1]}; tol 1e-8), MG cycles equal "
          f"{cycles['cuda'] == cycles['cpu']} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("small output run mismatch")


def timed_steps(torch, sim, steps, write):
    """Run `steps` steps from step 0; per step (step seconds, write
    seconds), the step on the host clock around a synchronize."""
    times = []
    for step in range(steps):
        pre = sim.binned
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_step(step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if write:
            sim.write_output(step, res, pre)
        times.append((t1 - t0, time.perf_counter() - t1))
        sim.binned = res["binned"]
        sim.time += sim.dt
    return res, times


@phase("pdf path")
def pdf_path(torch):
    """PDF_BEAM at 1023^2 x 64 float32 with its output: files, finite
    fields, the beam count, the in-situ beam weight and the launch counts;
    slices/s with and without output."""
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
    res, times = timed_steps(torch, sim, steps, write=True)
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
                "K2": g.nz * (pcfg.n_subcycles + beam_k2(sim)),
                "K3": g.nz}
    for k, count in counts.items():
        print(f"pdf path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps})", flush=True)
    slices = g.nz * (steps - 1)
    t_step = sum(t for t, _ in times[1:])
    t_write = sum(w for _, w in times[1:])
    print(f"pdf path with output: {slices / (t_step + t_write):.3f} slices/s"
          f" with the writes, {slices / t_step:.3f} slices/s for the steps "
          f"alone over {steps - 1} timed steps after 1 warm-up; seconds "
          f"writing per step: "
          + ", ".join(f"{w:.3f}" for _, w in times), flush=True)
    del res, sim
    quiet = Simulation(pdf_beam(NXY, NZ, NPART), device="cuda",
                       dtype=torch.float32, verbose=0)
    _, qtimes = timed_steps(torch, quiet, steps, write=False)
    q_step = sum(t for t, _ in qtimes[1:])
    print(f"pdf path without output (output periods 0): "
          f"{slices / q_step:.3f} slices/s over {steps - 1} timed steps",
          flush=True)
    if (not finite or n != n0 or missing or w_rel > 1e-5
            or channels != 14
            or any(c != per_step[k] * steps for k, c in counts.items())):
        raise AssertionError("pdf path: files, fields, beam, in-situ weight "
                             "or launch counts wrong")


# ------------------------------------------------- SALAME, mesh refinement
# the JAX package's MR test deck (tests/test_mr.py:15-55): a 32^2 x 24 grid
# with a 32^2 level over (-2..2)^2 at z -4..0 and an 8 x 8 ppc fine plasma
# patch; {nx} the coarse width, {extra} the MR lines or none
MR_TEST_BASE = """
amr.n_cell = {nx} {nx} 24
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 30000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 0.01
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 2 2
plasma.element = electron
diagnostic.output_period = 1
hipace.openpmd_backend = json
{extra}
"""
MR_TEST_LEVEL = """amr.max_level = 1
mr_lev1.n_cell = 32 32
mr_lev1.patch_lo = -2. -2. -4.
mr_lev1.patch_hi =  2.  2.  0.
plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)
plasma.fine_ppc = 8 8
diagnostic.names = lev0 lev1
lev1.base_geometry = level_1
lev1.field_data = all
"""
# "MR, small": (label, deck lines added to the MR test deck)
MR_VARIANTS = (
    ("explicit, even 32^2 level (cell-centered fine K3)", ""),
    ("explicit, odd 33^2 level (node-centered fine K3)",
     "mr_lev1.n_cell = 33 33\n"),
    # 4 x 4 fine ppc: the CPU half of 8 x 8 takes ~1 min
    ("predictor-corrector, fine ppc 4 x 4",
     "hipace.bxby_solver = predictor-corrector\nplasma.fine_ppc = 4 4\n"),
    ("two levels", "amr.max_level = 2\nmr_lev2.n_cell = 32 32\n"
     "mr_lev2.patch_lo = -0.9 -0.9 -3.\nmr_lev2.patch_hi = 0.9 0.9 -1.\n"
     "diagnostic.names = lev0 lev1 lev2\nlev2.base_geometry = level_2\n"
     "lev2.field_data = all\n"),
    ("laser", "lasers.names = laser\nlasers.lambda0 = .8e-6\n"
     "lasers.solver_type = multigrid\nlaser.a0 = 1.\n"
     "laser.position_mean = 0. 0. 0.\nlaser.w0 = 2.\nlaser.L0 = 1.\n"),
)
# test_salame_with_mr's level over SALAME_WAKE, with the level's fields
SALAME_MR = ("amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
             "mr_lev1.patch_lo = -2. -2. -7.\nmr_lev1.patch_hi = 2. 2. 5.\n"
             "plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)\n"
             "plasma.fine_ppc = 4 4\ndiagnostic.names = lev0 lev1\n"
             "lev1.base_geometry = level_1\nlev1.field_data = all\n"
             "lev1.output_period = 1\nhipace.openpmd_backend = json\n")
# the MR path: inside the level, away from its edge (|x| < 1.5), the fine
# on-axis Ez within this fraction of the coarse on-axis Ez's largest value
# (PERF.md, written before the first call from CPU runs at 127^2 and 255^2)
MR_AXIS_BOUND = 0.05


def same_cycles(got, ref):
    """Equal V-cycles (and PC iterations) on every slice, every solve."""
    keys = [k for k in ref if k in ("mg_cycles", "pc_iters", "salame_cycles")
            or k.startswith("mg_cycles_lev") or k == "laser_cycles"]
    return all(got[k] == ref[k] for k in keys), keys


def level_errors(got, ref):
    """rel_err of level 0's fields and of each level's diagnostic."""
    errs = {"level 0": rel_err(got["diag"], ref["diag"])}
    for k in ref:
        if k.startswith("diagf_"):
            errs[k[6:]] = rel_err(got[k], ref[k])
    return errs


@phase("SALAME, small")
def salame_small_phase(torch):
    """SALAME_WAKE at 32^2 x 64 in float64, step 0 on the kernels against
    the CPU plain path from the same beams, alone and with
    test_salame_with_mr's level: fields of every level within 1e-8, the
    SALAME slices equal, W within 1e-10, the witness's weights within 1e-10
    of their largest, V-cycles equal on every slice (the level-0 solve,
    SALAME's solves, the level's)."""
    from hipace_tpu_torch.decks import salame_wake
    bad = []
    for label, extra in (("SALAME_WAKE", ""), ("with MR", SALAME_MR)):
        cpu, gpu, ref, got = card_and_cpu(
            torch, lambda: salame_wake(32, 64, 30000, extra))
        errs = level_errors(got, ref)
        w_err = float((got["salame_W"].cpu() - ref["salame_W"]).abs().max())
        sal_eq = torch.equal(got["salame_is_sal"].cpu(), ref["salame_is_sal"])
        b = ref["binned"]
        wit = b["valid"] & (b["beam_id"] == 1)
        w_rel = rel_err(got["binned"]["w"].cpu()[wit], b["w"][wit])
        cyc_eq, _ = same_cycles(got, ref)
        n_sal = int(ref["salame_is_sal"].sum())
        sal_cyc = [c for v in ref["salame_cycles"].values() for c in v]
        ok = (max(errs.values()) < 1e-8 and w_err < 1e-10 and sal_eq
              and w_rel < 1e-10 and cyc_eq and n_sal > 0)
        print(f"SALAME, small: 32^2 x 64 float64 {label}, {n_sal} SALAME "
              f"slices, SALAME's V-cycles {min(sal_cyc)}-{max(sal_cyc)}, "
              f"kernels vs CPU plain path: fields "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol 1e-8), W max abs err {w_err:.3e} (tol 1e-10), "
              f"SALAME slices equal {sal_eq}, witness weights {w_rel:.3e} "
              f"(tol 1e-10), V-cycles per slice equal {cyc_eq} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
    if bad:
        raise AssertionError(f"SALAME small step mismatch: {bad}")


@phase("MR, small")
def mr_small_phase(torch):
    """The JAX package's MR test deck in float64 on the kernels against the
    CPU plain path from the same beam, in each MR_VARIANTS form: fields of
    every level within 1e-8, each level's diagnostic of the CPU's shape,
    V-cycles and PC iterations equal on every slice. Then in float32 on the
    card, the level's Ez against a uniformly fine 128^2 run at slices 14
    and 7, at the JAX test's thresholds (test_mr.py:81-86): within 0.10 of
    the truth's largest value and within 0.35 of the coarse run's error."""
    from hipace_tpu_torch.parser import Inputs
    from hipace_tpu_torch.pipeline.simulation import Simulation
    bad = []
    for label, extra in MR_VARIANTS:
        deck = MR_TEST_BASE.format(nx=32, extra=MR_TEST_LEVEL + extra)
        t0 = time.perf_counter()
        cpu, gpu, ref, got = card_and_cpu(torch, lambda: Inputs(deck))
        errs = level_errors(got, ref)
        shapes = all(got[k].shape == ref[k].shape for k in ref
                     if k.startswith("diagf_"))
        cyc_eq, keys = same_cycles(got, ref)
        ok = max(errs.values()) < 1e-8 and shapes and cyc_eq
        print(f"MR, small: {label}, levels "
              f"{[lv.geom.n_cell[:2] for lv in gpu.mr_levels]} float64, "
              f"kernels vs CPU plain path: fields "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol 1e-8), diagnostic shapes equal {shapes}, {keys} "
              f"equal on every slice {cyc_eq}, PC iterations "
              f"{sum(ref['pc_iters'])}; {time.perf_counter() - t0:.1f} s "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
    # float32 on the card: the level against a uniformly fine truth
    runs = {}
    for name, nx, extra in (("mr", 32, MR_TEST_LEVEL), ("truth", 128, ""),
                            ("coarse", 32, "")):
        sim = Simulation(Inputs(MR_TEST_BASE.format(nx=nx, extra=extra)),
                         device="cuda", dtype=torch.float32, verbose=0)
        runs[name] = (sim, sim.run_step(0))
    s_mr, r_mr = runs["mr"]
    gf = s_mr.mr_levels[0].geom
    xt = (torch.arange(gf.nx, dtype=torch.float64) + 0.5) * gf.dx \
        + gf.prob_lo[0]
    it = torch.round((xt + 8.0) / 0.125 - 0.5).long()
    itc = torch.round((xt + 8.0) / 0.5 - 0.5).long()
    errs32 = []
    for z in (14, 7):
        fine = r_mr["diagf_lev1"][z, s_mr.cfg.diags[1].comps.index("Ez")]
        fine = fine.double().cpu()
        tr = runs["truth"][1]["diag"][z, runs["truth"][0].cfg.diag_comps
                                      .index("Ez")].double().cpu()
        co = runs["coarse"][1]["diag"][z, runs["coarse"][0].cfg.diag_comps
                                       .index("Ez")].double().cpu()
        truth = tr[it][:, it]
        coarse = co[itc][:, itc]
        den = float(truth.abs().max())
        e_f = float((fine - truth).abs().max()) / den
        e_c = float((coarse - truth).abs().max()) / den
        errs32.append((z, e_f, e_c))
    ok32 = all(e_f < 0.10 and e_f < 0.35 * e_c for _, e_f, e_c in errs32)
    print("MR, small: float32 on the card, the level's Ez against a "
          "uniformly fine 128^2 run: "
          + "; ".join(f"slice {z}: fine {e_f:.4f} (tol 0.10), coarse "
                      f"{e_c:.4f}, ratio {e_f / e_c:.3f} (tol 0.35)"
                      for z, e_f, e_c in errs32)
          + f" {'ok' if ok32 else 'FAIL'}; {CARD['line']}", flush=True)
    if not ok32:
        bad.append("float32 fine vs truth")
    if bad:
        raise AssertionError(f"MR small mismatch: {bad}")


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
    warms the kernels; a fresh one's step 0 (SALAME) and step 1 (none) are
    timed apart, their host reads counted, their K1/K2/K3 launches held to
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
    res, times, copies, per_step = [], [], [], []
    try:
        for step in range(2):
            for f in fns.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, c = sync_counted(torch, lambda: sim.run_step(step))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
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
            "K2": g.nz * (pcfg.n_subcycles + sub), "K3": g.nz}
    # per SALAME slice and iteration: K1 the trial jx/jy, SALAME's jz, the
    # plasma's response, the jz redeposit; K2 the trial push and SALAME's
    # B gather; K3 two solves
    extra = {"K1": 4 * it, "K2": 2 * it, "K3": 2 * it}
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
    print(f"SALAME path: step 0 (SALAME) {g.nz / times[0]:.3f} slices/s, "
          f"{1e3 * times[0] / g.nz:.3f} ms/slice; step 1 "
          f"{g.nz / times[1]:.3f} slices/s, {1e3 * times[1] / g.nz:.3f} "
          f"ms/slice (a first simulation's step 0 warmed the kernels); "
          f"{CARD['line']}", flush=True)
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
    plasma slots), one warm-up and two timed steps, the host's reads
    counted in the first timed one: finite fields on both levels, the
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
    # each kept at the middle active slice of the first timed step
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
    for f in (dep.deposit, gat.gather_main, mg_solve, beam_push):
        f.launches = 0
    steps, times, copies = 3, [], 0
    try:
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1:
                res, copies = sync_counted(torch, lambda: sim.run_step(1))
            else:
                res = sim.run_step(step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            sim.binned = res["binned"]
            sim.time += sim.dt
    finally:
        for k in (k1, k2p, k3):
            k.undo()
    counts.update({"K1": dep.deposit.launches, "K2": gat.gather_main.launches,
                   "K3": mg_solve.launches, "beam push": beam_push.launches})
    # the kernels' own counts inside the level's calls
    counts["K1 fine"] = k1.launches
    counts["K2 fine"] = k2p.launches
    counts["K3 fine"] = k3.launches
    pcfg = sim.plasma_cfgs[0]
    # on the level's active slices every beam push keeps the subcycle loop
    # and gathers on both levels; on the others the fused push takes it
    all_sub = sum(c.n_subcycles for c in sim.beam_cfgs)
    per_step = {"K1": 2 * int(pcfg.neutralize_background) + 3 * (g.nz + n_act),
                "K2": (g.nz + n_act) * pcfg.n_subcycles
                + (g.nz - n_act) * beam_k2(sim) + 2 * n_act * all_sub,
                "K3": g.nz + n_act, "K1 fine": n_act,
                "K2 fine": n_act * (pcfg.n_subcycles + all_sub),
                "K3 fine": n_act,
                "beam push": (g.nz - n_act) * fused_pushes(sim)}
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
    slices = g.nz * (steps - 1)
    t_step = sum(times[1:])
    print(f"MR path {NXY}^2 x {NZ} float32 with a {fg.nx}^2 level over "
          f"slices {lv.zeta_lo}-{lv.zeta_hi} ({n_act} active), "
          f"{pl.plasma_count(pcfg, g)} plasma slots, {n0} beam particles: "
          f"fields finite on both levels {finite}, beam particles {n} (start "
          f"{n0}); fine on-axis Ez inside |x| < 1.5 within {axis_err:.4f} of "
          f"the coarse's largest (bound {MR_AXIS_BOUND}); {CARD['line']}",
          flush=True)
    print(f"MR path: {slices / t_step:.3f} slices/s, "
          f"{1e3 * t_step / slices:.3f} ms/slice over {steps - 1} timed steps"
          f" after 1 warm-up; per timed step "
          + ", ".join(f"{g.nz / t:.3f}" for t in times[1:])
          + f"; {CARD['line']}", flush=True)
    print(f"MR path device-to-host copies per slice (synchronizing reads, "
          f"first timed step): {copies / g.nz:.3f} (the flagship's: "
          f"{(2 * g.nz + 4) / g.nz:.3f})", flush=True)
    for k, count in counts.items():
        print(f"MR path launches {k}: {count} (slice structure predicts "
              f"{per_step[k] * steps}: per slice 3 / "
              f"{pcfg.n_subcycles} + the beam's / 1 on each running level, "
              f"the beam's K2 {all_sub} per level on the {n_act} active "
              f"slices and {beam_k2(sim)} on the others, one background "
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
# a window and the serial tail, every kind of per-step output but the named
# diagnostics (the output phase's)
PIPE_OUTPUT = """
max_step = 2
hipace.openpmd_backend = json
diagnostic.output_period = 1
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""


class StepKeeper:
    """Keeps, per time step of a simulation's time loop in step order, its
    V-cycles per slice, with fields=True its fields on the host, else a
    device flag of their finiteness: from sim.run_step (the serial loop)
    and from each stage of every pipelined window; undo() restores both."""

    def __init__(self, torch, sim, fields):
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
                               "diag": diag.cpu() if fields else None,
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


@phase("pipeline, small")
def pipeline_small_phase(torch):
    """The flagship at 63^2 x 16 in float64, two pipeline stages on cuda:0
    (one window, then the serial tail) against the same on the CPU and
    against the card's serial loop, from the same beam: fields and the beam
    at the end within 1e-8, equal V-cycles on every slice of every stage,
    and every per-step openPMD and in-situ file within 1e-8."""
    import shutil
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    runs = {}
    for name, dev, piped in (("cpu", "cpu", True), ("card", "cuda", True),
                             ("serial", "cuda", False)):
        folder = OUT / f"pipe_{name}"
        shutil.rmtree(folder, ignore_errors=True)
        sim = Simulation(blowout_wake(SMALL_NXY, SMALL_NZ, 4000,
                                      PIPE_OUTPUT + output_lines(folder)),
                         device=dev, dtype=torch.float64, verbose=0)
        if runs:
            cpu = runs["cpu"][0]
            carry_state(sim, {k: v.numpy() for k, v in cpu.binned0.items()
                              if torch.is_tensor(v)}, cpu.dt, 0.0)
        sim.binned0 = sim.binned
        keeper = StepKeeper(torch, sim, fields=True)
        try:
            if piped:
                sim.evolve_pipelined(devices=[torch.device(dev)]
                                     * PIPE_STAGES)
            else:
                sim.evolve()
        finally:
            keeper.undo()
        runs[name] = (sim, keeper.steps, output_files(folder))
    ref_sim, ref_steps, ref_files = runs["card"]
    lines, ok = [], len(ref_steps) == 3
    for name in ("cpu", "serial"):
        sim, steps, files = runs[name]
        fields = max(float((a["diag"] - b["diag"]).abs().max()
                           / b["diag"].abs().max())
                     for a, b in zip(ref_steps, steps))
        same_cycles = [a["mg_cycles"] for a in ref_steps] == [
            b["mg_cycles"] for b in steps]
        beam = beam_rel(torch, ref_sim.binned, sim.binned)[0]
        worst = [0.0, ""]
        if [f.name for f in files] != [f.name for f in ref_files] or \
                not all(f.exists() for f in files):
            raise AssertionError(f"the runs wrote different files: {files}")
        for got, ref in zip(ref_files, files):
            if got.suffix == ".json":
                compare_tree(json.loads(got.read_text()),
                             json.loads(ref.read_text()), got.name, worst)
            else:
                compare_tree(read_insitu(got), read_insitu(ref), got.name,
                             worst)
        ok &= (fields < 1e-8 and beam < 1e-8 and worst[0] < 1e-8
               and same_cycles and len(steps) == 3)
        lines.append(f"against the {name} run: fields {fields:.3e}, beam "
                     f"{beam:.3e}, worst file dataset {worst[0]:.3e} "
                     f"({worst[1]}) over {len(files)} files, V-cycles equal "
                     f"on every slice of every stage {same_cycles}")
    print(f"pipeline, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 flagship, "
          f"{PIPE_STAGES} stages on cuda:0 (steps 0-1 in one window, step 2 "
          "serial): " + "; ".join(lines) + f" (tol 1e-8) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("small pipelined run mismatch")
    return runs


@phase("pipeline path")
def pipeline_path(torch, counts):
    """The flagship at 1023^2 x 64 in float32 through evolve_pipelined with
    two stages on cuda:0: one warm-up window, in which the host's reads of
    the device are counted (the stages built before it), then two timed
    windows (4 steps) from the same beam: the K1/K2/K3 launches against the
    serial slice structure, the slices per second over all stages' slices,
    finite fields on every stage, a conserved beam and the peak memory; then
    the serial loop's 4 steps from the same beam, twice, timed, with their
    peak memory: the pipelined final beam held to the serial one, beside the
    spread between the two serial runs."""
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

    # the stages built first, then a warm-up window in which the host's
    # reads are counted, then the timed windows from the same beam
    sim = flagship(PIPE_STAGES - 1)
    g = sim.geom
    probe = generator_probe(sim)
    beam0 = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in sim.binned.items()}
    dt0, n0 = sim.dt, int(beam0["valid"].sum())
    sim.stage_slice_steps(devices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, reads = sync_counted(torch, lambda: sim.evolve_pipelined(
        devices=devices, write_output=False))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    from_start(sim, steps - 1)
    keeper = StepKeeper(torch, sim, fields=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for fn in (deposit, gather_main, mg_solve):
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        sim.evolve_pipelined(devices=devices, write_output=False)
        torch.cuda.synchronize()
        t_pipe = time.perf_counter() - t0
        counts.update({"K1": deposit.launches, "K2": gather_main.launches,
                       "K3": mg_solve.launches})
    finally:
        keeper.undo()
    peak_pipe = torch.cuda.max_memory_allocated()
    finite = all(bool(s["finite"]) for s in keeper.steps)
    cycles = [c for s in keeper.steps for c in s["mg_cycles"]]
    n = int(sim.binned["valid"].sum())
    pipe_binned = sim.binned
    pcfg, loop_k2 = sim.plasma_cfgs[0], beam_k2(sim)
    del sim
    torch.cuda.empty_cache()

    # the serial loop twice from the same beam: its time and peak memory,
    # and how far f32 atomics alone move the final beam
    finals = []
    for _ in range(2):
        serial = flagship(steps - 1)
        serial.binned = {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in beam0.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        serial.evolve(write_output=False)
        torch.cuda.synchronize()
        t_serial = time.perf_counter() - t0
        peak_serial = torch.cuda.max_memory_allocated()
        finals.append(serial.binned)
        del serial
        torch.cuda.empty_cache()
    diff = beam_rel(torch, pipe_binned, finals[0], sort=True)
    spread = beam_rel(torch, finals[1], finals[0], sort=True)

    per_step = {"K1": int(pcfg.neutralize_background) + 3 * g.nz,
                "K2": g.nz * (pcfg.n_subcycles + loop_k2),
                "K3": g.nz}
    slices = g.nz * steps
    print(f"pipeline path {NXY}^2 x {NZ} float32, {NPART} beam particles, "
          f"{PIPE_STAGES} stages on one card: {slices / t_pipe:.3f} slices/s"
          f" over {steps} steps in {steps // PIPE_STAGES} timed windows "
          f"(every stage's slices; {1e3 * t_pipe / slices:.3f} ms/slice); "
          f"the serial loop from the same beam {slices / t_serial:.3f} "
          f"slices/s; warm-up window {t_warm:.3f} s; "
          f"{CARD['line']}",
          flush=True)
    # the serial structure (two lane counts per slice, at the beam push),
    # one receive-row binning per tick and a few per window
    read_bound = (2 * PIPE_STAGES * g.nz + g.nz + 2 * (PIPE_STAGES - 1)
                  + 5)
    print(f"pipeline path host reads of the device per slice (the warm-up "
          f"window, all stages' slices): "
          f"{reads / (PIPE_STAGES * g.nz):.3f} "
          f"({reads} reads over {PIPE_STAGES * g.nz} slices; bound "
          f"{read_bound})", flush=True)
    print(f"pipeline path peak memory: {peak_pipe / 2 ** 30:.3f} GiB with "
          f"{PIPE_STAGES} stages ({held / 2 ** 30:.3f} GiB held before the "
          f"timed windows), {peak_serial / 2 ** 30:.3f} GiB serial (ratio "
          f"{peak_pipe / peak_serial:.3f})", flush=True)
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
            "lanes": n0, "probe": probe, "per_step": per_step,
            "slices_per_s": slices / t_pipe,
            "serial_slices_per_s": slices / t_serial}


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


@phase("ranks, small")
def ranks_small_phase(torch, pipe):
    """The 63^2 x 16 float64 flagship of "pipeline, small" (one window, then
    the serial tail, every per-step output) as two ranks sharing cuda:0
    over gloo (ranks.spawn, Simulation.evolve_ranks) from the CPU run's
    beam: every openPMD and in-situ file and the final beam within 1e-8 of
    the single-process two-stage runs on cuda:0 and on the CPU, equal
    V-cycles on every slice of every step, each step on its rank."""
    import shutil
    from hipace_tpu_torch.decks import BLOWOUT_WAKE
    from hipace_tpu_torch.parallel import ranks
    if pipe is None:
        raise AssertionError('"pipeline, small" did not run')
    folder = OUT / "ranks_small"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    cpu = pipe["cpu"][0]
    start = folder / "start.pt"
    torch.save({"binned": {k: v for k, v in cpu.binned0.items()
                           if torch.is_tensor(v)}, "dt": cpu.dt}, start)
    deck = (BLOWOUT_WAKE.format(nxy=SMALL_NXY, nz=SMALL_NZ, npart=4000)
            + PIPE_OUTPUT + output_lines(folder))
    t0 = time.perf_counter()
    res = ranks.spawn(ranks.Job(deck, dtype="float64", start=str(start),
                                keep_steps=True, verbose=0),
                      ["cuda:0"] * PIPE_STAGES, timeout=RANK_TIMEOUT)
    t_spawn = time.perf_counter() - t0
    final = res[0]["final"]["binned"]
    steps, owner = card_steps(res)
    files = output_files(folder)
    lines = []
    ok = (sorted(steps) == [0, 1, 2] and owner == {0: 0, 1: 1, 2: 0}
          and all(f.exists() for f in files))
    for name in ("card", "cpu"):
        sim, ref_steps, ref_files = pipe[name]
        same_cycles = [steps[s]["mg_cycles"] for s in sorted(steps)] == [
            r["mg_cycles"] for r in ref_steps]
        beam = beam_rel(torch, final, sim.binned)[0]
        worst = [0.0, ""]
        if [f.name for f in files] != [f.name for f in ref_files]:
            raise AssertionError(f"the ranks wrote {files}")
        for got, ref in zip(files, ref_files):
            if got.suffix == ".json":
                compare_tree(json.loads(got.read_text()),
                             json.loads(ref.read_text()), got.name, worst)
            else:
                compare_tree(read_insitu(got), read_insitu(ref), got.name,
                             worst)
        ok &= beam < 1e-8 and worst[0] < 1e-8 and same_cycles
        lines.append(f"against the single-process {name} run: beam "
                     f"{beam:.3e}, worst file dataset {worst[0]:.3e} "
                     f"({worst[1]}) over {len(files)} files, V-cycles equal "
                     f"on every slice of every step {same_cycles}")
    print(f"ranks, small: {SMALL_NXY}^2 x {SMALL_NZ} float64 flagship, "
          f"{PIPE_STAGES} ranks on cuda:0 (steps 0-1 in one window, step 2 "
          f"serial on rank 0; spawn {t_spawn:.1f} s): " + "; ".join(lines)
          + f" (tol 1e-8) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("small rank run mismatch")


@phase("ranks path")
def ranks_path(torch, pipe, counts):
    """The 1023^2 x 64 float32 flagship of the pipeline path as two ranks on
    cuda:0 (gloo): one warm-up window, then two timed windows (4 steps)
    from the same beam. Each rank's K1/K2/K3 launches in the timed windows
    against the serial slice structure of its 2 steps, finite fields, a
    conserved beam, every rank's generator draws equal to this process's,
    the final beam against the pipeline path's single-process pipeline
    within PIPE_F32_TOL (beside the serial loop's and the spread of two
    serial runs), slices/s over all ranks' slices against the pipeline
    path's two runs, each rank's peak memory. Where there are two cards,
    the same with one rank per card over NCCL; counts gets the launches of
    the ranks on cuda:0, summed."""
    import os
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
        t0 = time.perf_counter()
        res = ranks.spawn(job, devices, timeout=RANK_TIMEOUT)
        t_spawn = time.perf_counter() - t0
        timed = [r["runs"][-1] for r in res]
        rec, owner = card_steps(res)
        final = res[0]["final"]["binned"]
        n = int(final["valid"].sum())
        diff = beam_rel(torch, final, pipe["beam"], sort=True)
        vs_serial = beam_rel(torch, final, pipe["serial"], sort=True)
        rate = NZ * steps / timed[0]["seconds"]
        launches = [r["launches"] for r in timed]
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
        print(f"ranks path {NXY}^2 x {NZ} float32, {leg} "
              f"({res[0]['runs'][0]['seconds']:.3f} s warm-up window, spawn "
              f"{t_spawn:.1f} s): {rate:.3f} slices/s over {steps} steps "
              f"(every rank's slices; {rate / pipe['slices_per_s']:.3f}x the "
              f"single-process pipeline's {pipe['slices_per_s']:.3f}, "
              f"{rate / pipe['serial_slices_per_s']:.3f}x the serial "
              f"loop's {pipe['serial_slices_per_s']:.3f}); peak memory per "
              "rank " + ", ".join(f"{r['peak_bytes'] / 2 ** 30:.3f}"
                                  for r in timed)
              + f" GiB; {os.cpu_count()} host cores; {CARD['line']}",
              flush=True)
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


@phase("bench")
def bench_phase(torch):
    """The port's bench (hipace_tpu_torch.bench) in this process on its
    pdf deck at 1023^2 x 64: one warm-up step, then 3 runs of 2 measured
    steps; its JSON line on a line of its own. It must name this card and
    have launched K1, K2 and K3 on every slice."""
    from hipace_tpu_torch import bench
    rec = bench.run(nxy=NXY, nz=NZ, steps=3, runs=3, log=sys.stdout)
    print(json.dumps(rec), flush=True)
    low = [k for k, n in rec["launches_per_slice"].items() if n < 1]
    if rec["device"] != torch.cuda.get_device_name(0) or low:
        raise AssertionError(f"bench on {rec['device']}, kernels under one "
                             f"launch per slice: {low}")


@phase("physics gate")
def gate_phase(torch):
    """hipace_tpu_torch.gpu_check's small ladder (CPU f64, card f64, card
    f32 from one beam and one set of draws) on its first GATE_CASES cases,
    its full-width leg (card f32 against card f64 at 1023^2 x 64) and its
    reference leg; the record under build/chip_smoke/gpu_check.json. Fails
    where a case fails or a kernel was not launched."""
    from hipace_tpu_torch import gpu_check
    from hipace_tpu_torch.ops.deposit import deposit
    from hipace_tpu_torch.ops.gather import gather_main
    from hipace_tpu_torch.ops.mg_kernel import mg_solve
    kernels = {"K1": deposit, "K2": gather_main, "K3": mg_solve}
    for fn in kernels.values():
        fn.launches = 0
    record = gpu_check.gate([c.name for c in gpu_check.CASES[:GATE_CASES]],
                            log=io.StringIO())
    launches = {k: fn.launches for k, fn in kernels.items()}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gpu_check.json").write_text(json.dumps(record, indent=1) + "\n")

    def pair(e, k):
        p = e[k]
        return f"{p['max_rel']:.3e} ({p['key']}; tol {p['tol']:g})"

    for e in record["cases"] + [record["full_width"]]:
        legs = ", ".join(f"{leg} {e['mg_cycles'][leg]}/{e['pc_iters'][leg]}/"
                         f"{e['seconds'][leg]:.1f} s" for leg in e["seconds"])
        f64 = (f"card f64 vs CPU {pair(e, 'f64_vs_cpu')}, "
               if "f64_vs_cpu" in e else "")
        print(f"physics gate {e['case']}, {e['steps']} steps: {f64}card "
              f"f32 vs f64 {pair(e, 'f32_vs_f64')}; V-cycles/PC iterations"
              f"/seconds {legs} {'ok' if e['ok'] else 'FAIL'}", flush=True)
    for s in record["skipped"]:
        print(f"physics gate {s['case']}: skipped ({s['skipped']})")
    print(f"physics gate reference leg: {record['reference']}")
    print(f"physics gate record: {OUT / 'gpu_check.json'}; launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items()), flush=True)
    if not record["ok"] or not all(launches.values()):
        raise AssertionError("the physics gate failed")


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
    reference_phase(torch)
    counts: dict = {}
    main_path(torch, sim, counts)
    del sim
    torch.cuda.empty_cache()
    pc_small_phase(torch)
    pc_counts: dict = {}
    pc_path(torch, pc_counts)
    torch.cuda.empty_cache()
    poisson_phase(torch, g, results)
    output_small_phase(torch)
    pdf_path(torch)
    torch.cuda.empty_cache()
    k3_cc_phase(torch, results)
    even_small_phase(torch)
    even_counts: dict = {}
    even_path(torch, even_counts)
    torch.cuda.empty_cache()
    beam_small_phase(torch)
    witness_counts: dict = {}
    witness_path(torch, witness_counts, results)
    torch.cuda.empty_cache()
    k3_complex_phase(torch, results)
    laser_small_phase(torch)
    laser_counts: dict = {}
    laser_path(torch, laser_counts, results)
    torch.cuda.empty_cache()
    adaptive_small_phase(torch)
    adaptive_flagship(torch)
    torch.cuda.empty_cache()
    ionization_small_phase(torch)
    collisions_small_phase(torch)
    ion_counts: dict = {}
    ionization_path(torch, ion_counts, results)
    torch.cuda.empty_cache()
    collision_counts: dict = {}
    collision_path(torch, collision_counts, results)
    torch.cuda.empty_cache()
    salame_small_phase(torch)
    mr_small_phase(torch)
    salame_counts: dict = {}
    salame_path(torch, salame_counts, results)
    torch.cuda.empty_cache()
    mr_counts: dict = {}
    mr_path(torch, mr_counts, results)
    torch.cuda.empty_cache()
    pipe_small = pipeline_small_phase(torch)
    pipe_counts: dict = {}
    pipe_ref = pipeline_path(torch, pipe_counts)
    torch.cuda.empty_cache()
    ranks_small_phase(torch, pipe_small)
    del pipe_small
    rank_counts: dict = {}
    ranks_path(torch, pipe_ref, rank_counts)
    del pipe_ref
    torch.cuda.empty_cache()
    bench_phase(torch)
    torch.cuda.empty_cache()
    gate_phase(torch)

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
                ("K2", "K2", "K2 gather_main, PC path (plasma pushes)",
                 pc_counts["K2"]),
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
