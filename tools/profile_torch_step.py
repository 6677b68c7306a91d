"""Where the time of one time step of the PyTorch/CUDA port goes, on a GPU.

    python3 tools/profile_torch_step.py
        [--deck flagship|pdf|pc|even|witness|laser|ionization|collision|
                salame|mr]
        [--insitu] [--xz] [--nxy 1023] [--nz 64] [--steps 2]

Runs a deck of ``hipace_tpu_torch.decks`` (the flagship blowout wake, its
fixed_weight_pdf variant, its predictor-corrector variant with open
boundaries, the two-species ION_MOTION_EVEN at an even size, 1024^2 by
default, with the flagship's beam, DRIVE_WITNESS, the flagship with a
second, spin-tracked and radiating witness beam, LASER_WAKE, the
laser-driven blowout with no beam, IONIZATION_WAKE, a beam ionizing
hydrogen, or COLLISION_WAKE, the flagship with intra-species and
beam-plasma collisions) in float32 on ``cuda``:
one warm-up step, ``--steps`` timed steps on the host clock, then one step
under ``torch.profiler``. It prints the device time and launch count per
slice of each group of device activities (the port's kernels K1-K3, PyTorch
elementwise kernels, copies, FFT, the rest), the device-to-host copies per
slice (each one a wait of the host for the device), the busiest kernels, and
the busy share: profiled device time per slice over the unprofiled wall time
per slice. With ``--deck pc`` it prints the predictor-corrector's
iterations per slice and, per iteration, the launches and device ms of each
group: the difference between the profiled step and a profiled step of the
same deck capped at one iteration per slice, over the difference in
iterations. With ``--deck laser`` the complex K3 solves are a group of their
own, and the device time of the laser's two named parts is printed apart:
the envelope advance (every kernel it launches, its complex K3 solve
included) and the |a|^2 gathers of the plasma deposit and push, with their
share of the step's device time. With ``--deck ionization`` the ionization
module (its K2 field gather included) is such a named range, with
``--deck collision`` the slice's collisions. ``--deck salame`` runs
SALAME_WAKE, whose SALAME runs at step 0 only: the profiled step is a fresh
simulation's step 0, after the warm-up and timed steps of another, and its
named range is SALAME's work per SALAME slice. ``--deck mr`` runs MR_WAKE
(a 511^2 level at full width, half the grid's width), whose named ranges
are the level's parts (its initialization, deposits, Psi/Ez/Bz and Bx/By
solves and the pushes' gathers from it) with the coupler products apart:
the level's device ms and launches per active slice.

Output: ``--insitu`` turns on the in-situ beam, plasma and field records
every step, ``--xz`` an xz field diagnostic of every comp and rho every step
(json, under ``build/profile_output``; it takes the place of the full 3D
record the deck keeps otherwise). Each step's output is written after the
step, outside the profiled and timed sweep, and its seconds are printed per
step. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# first match wins: (group, substrings of the device activity's name)
GROUPS = [
    ("K1 deposit", ("hipace::deposit_kernel",)),
    ("K2 gather", ("hipace::gather_main_kernel",)),
    ("K3 multigrid, complex (laser)", ("MgParams<float, true>",
                                       "MgParams<double, true>")),
    ("K3 multigrid", ("hipace::mg_solve_kernel",)),
    ("FFT (DST)", ("fft", "FFT")),
    ("GEMM (open-boundary moments, MR couplers)", ("gemm", "Gemm",
                                                   "cutlass", "xmma")),
    ("cat / copy / memcpy / memset", ("Cat", "copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel",)),
]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_activities(prof):
    """Per group of the profiled step's device activities: (ms, launches),
    per activity name [ms, count], and the device-to-host copies."""
    from torch.autograd import DeviceType
    ms = defaultdict(float)
    count = defaultdict(int)
    per_kernel = defaultdict(lambda: [0.0, 0])
    readbacks = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in ALL_RANGES:
            continue    # the named ranges' device spans are no activity
        dur = e.time_range.elapsed_us() / 1e3
        g = group_of(e.name)
        readbacks += "DtoH" in e.name
        ms[g] += dur
        count[g] += 1
        per_kernel[e.name][0] += dur
        per_kernel[e.name][1] += 1
    return ms, count, per_kernel, readbacks


# the parts named around their calls, per deck
LASER_RANGES = ("laser: envelope advance", "laser: |a|^2 gather")
MR_RANGES = ("MR: level init", "MR: level deposits", "MR: level Psi/Ez/Bz",
             "MR: level Bx/By", "MR: level gathers")
RANGES = {"laser": LASER_RANGES, "ionization": ("ionization module",),
          "salame": ("SALAME",),
          "mr": MR_RANGES + ("MR: coupler products (inside the above)",),
          "collision": ("collisions",)}
ALL_RANGES = tuple(r for labels in RANGES.values() for r in labels)


def named(fn, label):
    """fn inside a profiler range called label."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def name_mr_ranges(sim, plasma, stp):
    """Put the mesh-refinement level's parts of the slice step into named
    ranges: its InitializeSlices, deposits (the calls on its geometry), its
    two solves, the pushes' gathers on its grid; the coupler products in a
    range of their own, nested in those."""
    import torch

    from hipace_tpu_torch.fields import mr
    ss, fg = sim.slice_step, sim.mr_levels[0].geom
    ss._init_fine = named(ss._init_fine, MR_RANGES[0])
    ss._fine_explicit_bxby = named(ss._fine_explicit_bxby, MR_RANGES[3])
    stp.solve_fine_psi_ez_bz = named(stp.solve_fine_psi_ez_bz, MR_RANGES[2])

    def on_level(fn, label, geom_at):
        def wrapped(*args, **kwargs):
            if geom_at(args, kwargs) == fg:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return wrapped

    for mod, name in ((plasma, "fused_plasma_deposits"),
                      (plasma, "deposit_plasma"),
                      (stp.bm, "deposit_beam_slice")):
        setattr(mod, name, on_level(getattr(mod, name), MR_RANGES[1],
                                    lambda a, k: a[3]))
    plasma.gather_fields = on_level(plasma.gather_fields, MR_RANGES[4],
                                    lambda a, k: a[4])
    stp.bm.gather_fields = plasma.gather_fields
    for meth in ("up_full", "bc_values"):
        setattr(mr.LevelCoupler, meth, named(getattr(mr.LevelCoupler, meth),
                                             RANGES["mr"][-1]))


def range_ms(prof, labels):
    """Per named range: the device ms of the activities inside its device
    spans (the spans of one stream hold exactly the kernels the range
    launched; the ctypes-launched K3 included), its calls and those
    activities' count."""
    import bisect
    from torch.autograd import DeviceType
    spans = {label: [] for label in labels}
    acts = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        else:
            acts.append((e.time_range.start, e.time_range.elapsed_us()))
    out = {}
    for label, sp in spans.items():
        sp.sort()
        starts = [a for a, _ in sp]
        us, n = 0.0, 0
        for t0, dur in acts:
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t0 < sp[i][1]:
                us += dur
                n += 1
        out[label] = [us / 1e3, len(sp), n]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deck", choices=("flagship", "pdf", "pc", "even",
                                       "witness", "laser", "ionization",
                                       "collision", "salame", "mr"),
                    default="flagship")
    ap.add_argument("--insitu", action="store_true",
                    help="in-situ beam, plasma and field records every step")
    ap.add_argument("--xz", action="store_true",
                    help="an xz diagnostic of all comps and rho every step")
    ap.add_argument("--nxy", type=int, default=None,
                    help="grid width (1023; 1024 for --deck even)")
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3

    from hipace_tpu_torch.decks import (blowout_wake, collision_wake,
                                        drive_witness, ion_motion_even,
                                        ionization_wake, laser_wake, mr_wake,
                                        pc_open, pdf_beam, salame_wake)
    from hipace_tpu_torch.particles import plasma
    from hipace_tpu_torch.pipeline import step as stp
    from hipace_tpu_torch.pipeline.simulation import Simulation

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    if args.nxy is None:
        args.nxy = 1024 if args.deck == "even" else 1023
    # the bench's beam scaling on the odd width (an even grid gets the beam
    # of the odd one below it)
    odd = args.nxy - (args.nxy + 1) % 2
    npart = odd * odd * 10 * args.nz // 1000
    out = ROOT / "build" / "profile_output"
    extra = (f"hipace.file_prefix = {out}/openpmd\n"
             "hipace.openpmd_backend = json\n")
    if args.insitu:
        extra += "".join(
            f"{key}.insitu_period = 1\n{name}.insitu_file_prefix = "
            f"{out}/{name}_insitu\n"
            for key, name in (("beams", "beam"), ("plasmas", "plasma"),
                              ("fields", "fields")))
        extra += f"witness.insitu_file_prefix = {out}/witness_insitu\n"
    if args.xz:
        extra += ("diagnostic.output_period = 1\ndiagnostic.diag_type = xz\n"
                  "diagnostic.field_data = all rho\n"
                  "diagnostic.beam_output_period = 0\n")
    deck = {"flagship": blowout_wake, "pdf": pdf_beam,
            "pc": pc_open, "even": ion_motion_even,
            "witness": drive_witness, "laser": laser_wake,
            "ionization": ionization_wake,
            "collision": collision_wake, "salame": salame_wake,
            "mr": lambda nxy, nz, n, e: mr_wake(nxy, nz, n, nxy // 2, e)
            }[args.deck]
    if args.deck in ("laser", "ionization"):
        npart = 0       # no beam, or a fixed_ppc one
    sim = Simulation(deck(args.nxy, args.nz, npart, extra), device="cuda",
                     dtype=torch.float32, verbose=0)
    if args.deck == "laser":
        adv = sim.slice_step.laser_advance
        sim.slice_step.laser_advance = named(adv, LASER_RANGES[0])
        sim.slice_step.laser_advance.mg = adv.mg
        plasma.gather_laser_aabs = named(plasma.gather_laser_aabs,
                                         LASER_RANGES[1])
    if args.deck == "ionization":
        plasma.ionization_module = named(plasma.ionization_module,
                                         RANGES["ionization"][0])
    if args.deck == "collision":
        sim.slice_step.collide = named(sim.slice_step.collide,
                                       RANGES["collision"][0])
    if args.deck == "salame":
        stp.salame_slice = named(stp.salame_slice, RANGES["salame"][0])
    if args.deck == "mr":
        name_mr_ranges(sim, plasma, stp)
    write_s = []

    def step(sim, profiled=False):
        pre = sim.binned
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) if profiled \
                else contextlib.nullcontext() as prof:
            # the step's index: the laser starts from its initial envelope
            # at step 0 only
            res = sim.run_step(len(write_s))
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.write_output(len(write_s), res, pre)
        write_s.append(time.perf_counter() - t0)
        sim.binned = res["binned"]
        sim.time += sim.dt
        return prof, res

    step(sim)                                       # warm-up
    t0 = time.perf_counter()
    iters = []
    for _ in range(args.steps):
        iters.append(sum(step(sim)[1]["pc_iters"]))
    # the sweeps alone: the writes after them are timed apart
    sweep_s = time.perf_counter() - t0 - sum(write_s[1:])
    wall_ms = 1e3 * sweep_s / (args.steps * args.nz)

    pre = sim.binned
    if args.deck == "salame":
        # SALAME runs at step 0 only: profile a fresh simulation's step 0
        sim = Simulation(deck(args.nxy, args.nz, npart, extra),
                         device="cuda", dtype=torch.float32, verbose=0)
        write_s.clear()
    prof, res = step(sim, profiled=True)
    ms, count, per_kernel, readbacks = device_activities(prof)
    total = sum(ms.values())
    nz = args.nz
    print(f"deck {args.deck} {args.nxy}^2 x {nz}, {npart} beam particles, "
          f"float32, in-situ {'on' if args.insitu else 'off'}, xz diagnostic "
          f"{'on' if args.xz else 'off'}; unprofiled {wall_ms:.3f} ms/slice "
          f"({1e3 / wall_ms:.3f} slices/s) over {args.steps} steps after 1 "
          "warm-up")
    print(f"profiled step: {sum(count.values())} device activities, device "
          f"time {total / nz:.3f} ms/slice, busy share "
          f"{total / nz / wall_ms:.3f} of the unprofiled slice")
    print(f"{'group':<30} {'device ms/slice':>16} {'launches/slice':>15}")
    for g in sorted(ms, key=ms.get, reverse=True):
        print(f"{g:<30} {ms[g] / nz:16.3f} {count[g] / nz:15.2f}")
    print(f"device-to-host copies: {readbacks / nz:.2f} per slice "
          f"({readbacks} in the step)")
    print("seconds writing output after each step: "
          + ", ".join(f"{s:.3f}" for s in write_s))
    if args.deck == "pc":
        it = res["pc_iters"]
        print(f"predictor-corrector iterations: {sum(it)} in the profiled "
              f"step, {min(it)}-{max(it)} per slice, {sum(it) / nz:.3f} per "
              "slice; in the timed steps " + ", ".join(map(str, iters)))
        # the same deck capped at one iteration per slice: the difference
        # is what the extra iterations cost
        one = Simulation(deck(args.nxy, args.nz, npart, extra
                              + "hipace.predcorr_max_iterations = 1\n"),
                         device="cuda", dtype=torch.float32, verbose=0)
        # from the profiled step's beam: the work outside the loop is the
        # same
        one.binned = pre
        prof1, res1 = step(one, profiled=True)
        ms1, count1, _, _ = device_activities(prof1)
        d_it = sum(it) - sum(res1["pc_iters"])
        print(f"per iteration (the profiled step against one capped at 1 "
              f"iteration per slice, {d_it} iterations apart):")
        print(f"{'group':<30} {'device ms/iter':>16} {'launches/iter':>15}")
        for g in sorted(ms, key=ms.get, reverse=True):
            print(f"{g:<30} {(ms[g] - ms1[g]) / d_it:16.4f} "
                  f"{(count[g] - count1[g]) / d_it:15.2f}")
        print(f"{'total':<30} {(total - sum(ms1.values())) / d_it:16.4f} "
              f"{(sum(count.values()) - sum(count1.values())) / d_it:15.2f}")
    if args.deck in RANGES:
        parts = range_ms(prof, RANGES[args.deck])
        part = sum(t for t, _, _ in parts.values())
        for label, (t, n, acts) in parts.items():
            print(f"{label:<30} {t / nz:16.3f} ms/slice in {n / nz:.2f} "
                  f"calls/slice, {acts / nz:.2f} launches/slice")
        print(f"the {args.deck} part's share of the step's device time: "
              f"{part / total:.3f} ({part / nz:.3f} of {total / nz:.3f} "
              "ms/slice)")
    if args.deck == "salame":
        n_sal = int(res["salame_is_sal"].sum())
        t = parts["SALAME"][0]
        cyc = [c for v in res["salame_cycles"].values() for c in v]
        print(f"SALAME slices in the profiled step: {n_sal}; SALAME's device "
              f"ms per SALAME slice {t / max(n_sal, 1):.3f}; its K3 V-cycles "
              f"{min(cyc)}-{max(cyc)} over {len(cyc)} solves")
    if args.deck == "mr":
        lv = sim.mr_levels[0]
        n_act = lv.zeta_hi - lv.zeta_lo + 1
        lev = [parts[r] for r in MR_RANGES]
        t = sum(p[0] for p in lev)
        print(f"the level ({lv.geom.nx}^2 on {n_act} of {nz} slices): "
              f"{t / n_act:.3f} device ms and {sum(p[2] for p in lev) / n_act:.2f}"
              f" launches per active slice; the coupler products "
              f"{parts[RANGES['mr'][-1]][0] / t:.3f} of it")
    if "ionized" in res:
        print(f"ionization events in the profiled step: "
              f"{int(res['ionized'])}")
    print("busiest device activities over the profiled step:")
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (t, n) in top[:15]:
        print(f"  {t:9.3f} ms {n:7d}x  {name[:100]}")
    return 0 if total > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
