"""On-card float32 physics gate of the port.

    python -m hipace_tpu_torch.gpu_check [--out record.json]
                                         [--reference DIR]

The method of the JAX package's on-chip gate (``tools/tpu_check.py``) made
for a card that runs float64: run a deck in the production precision on the
card and hold the checksum method's sums -- sum |Q| of every field and of
every beam attribute of the last step's openPMD output, accumulated in
float64 (ref tests/checksum/checksum.py:44-80) -- to a float64 run of the
same deck.

Small ladder: each case of CASES runs for two steps in three legs from the
same beam (the card float64 leg's, moved with ``convert.carry_state``) and
the same random draws (that leg's temperature normals and slice uniforms,
recorded and replayed): (a) the CPU in float64 on the plain PyTorch
versions, (b) the card in float64 on the kernels, (c) the card in float32
on the kernels. A case passes when (b) is within F64_RTOL of (a) on every
sum and (c) within the case's pass_rtol of (b). The CPU cannot run float32
(``device.resolve``), so the float32 drift is measured against float64 on
the same card, where tools/tpu_check.py took off a CPU float32 floor. The
CPU legs run in worker processes beside the card's legs.

Full-width leg: FULL, the flagship at 1023^2 x 64 for one step, card
float32 against card float64 from the same beam; no CPU leg at that width
(the small legs hold the card's float64 kernels to the CPU).

Reference leg: where a checkout of the reference (HiPACE++) is given with
``--reference DIR``, the port's copy of tools/tpu_check.py's two cases runs
that checkout's input decks in float32 on the card and is held to its
benchmark JSONs (tests/checksum/benchmarks_json) after taking off 3x the
per-key float32 floor |card f32 - card f64|; a field of the JSON that the
run did not write fails the case. Without ``--reference`` the record says
the leg did not run.

The record is one JSON object: per case each pair of legs' worst relative
deviation and its key, the tolerance and pass or fail, the V-cycles and PC
iterations of each leg, the card's name and power limit. The exit code is
non-zero if any case fails. Without a card it raises.

The sums are taken by SumsWriter, which stands in for the simulation's
openPMD writer and reduces exactly the arrays the writer would write (the
top-level field datasets and each beam's records) instead of writing them:
a 1023^2 x 64 JSON file could not be written, and the card's machine has no
h5py.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import decks
from .convert import carry_state
from .device import card_line
from .parser import Inputs
from .pipeline.simulation import Simulation

# the benchmark JSONs inside a reference checkout
BENCH = "tests/checksum/benchmarks_json"

# openPMD particle records by checksum attribute (tools/tpu_check.py:45-47)
BEAM_MAP = {"x": "position/x", "y": "position/y", "z": "position/z",
            "ux": "momentum/x", "uy": "momentum/y", "uz": "momentum/z",
            "w": "weighting"}
SXSYCHI = ("Sy", "Sx", "chi")
# card float64 against the CPU's float64 (the gpu tests' card-against-CPU
# comparisons, tests/test_torch_gpu_steps.py)
F64_RTOL = 1e-8
NXY, NZ = 63, 16
# the CPU legs' worker processes and their threads (the card's legs hold a
# core of the host; the legs at 63^2 are bound by the interpreter)
CPU_WORKERS, CPU_THREADS = 3, 2


@dataclass(frozen=True)
class Case:
    """A deck at its size, the steps it runs, the float32 tolerance (card
    f32 against card f64; pinned at ~3x the deviation measured on the card)
    and the fields left out of the sums' comparison."""
    name: str
    deck: Callable[[], Inputs]
    pass_rtol: float
    skip_fields: tuple = ()
    steps: int = 2


# Ordered as they are cut when the ladder runs over its time: from the end.
# Each pass_rtol is ~3x the largest card f32 against card f64 deviation
# measured on an NVIDIA H100 80GB HBM3 at 700 W in four runs (python -m
# hipace_tpu_torch.gpu_check; the first from the CPU's beam, three from the
# card's), the worst key beside it.
CASES = (
    # 1.14e-5 to 1.32e-5 (Ez)
    Case("blowout_wake", lambda: decks.blowout_wake(NXY, NZ, 4000), 4e-5),
    # 1.07e-5 to 1.17e-5 (Ez)
    Case("pdf_beam", lambda: decks.pdf_beam(NXY, NZ, 4000), 4e-5),
    # 2.72e-4 to 3.15e-4 (Bz); equal PC iterations in f32 and f64 (842)
    Case("pc_open", lambda: decks.pc_open(NXY, NZ, 4000), 1e-3),
    # 2.29e-6 to 2.92e-6 (Sx, Sy)
    Case("ion_motion_even", lambda: decks.ion_motion_even(64, NZ, 4000),
         1e-5),
    # 5.54e-5 to 1.09e-4 (Bz); R15's stalled f32 solves are at full width
    Case("laser_wake", lambda: decks.laser_wake(NXY, NZ), 3.5e-4),
    # 1.21e-5 to 1.47e-5 (Ez)
    Case("drive_witness", lambda: decks.drive_witness(NXY, NZ, 4000), 5e-5),
    # 6.83e-5 from the CPU's beam, 6.22e-3 to 6.28e-3 from the card's (Sy):
    # f32 ionizes other lanes than f64 (discrete events), 90 against 92
    # V-cycles
    Case("ionization_wake", lambda: decks.ionization_wake(NXY, NZ), 2e-2),
    # 3.90e-6 to 1.28e-5 (Ez, the deck's only field)
    Case("salame_wake", lambda: decks.salame_wake(32, 64, 30000), 4e-5),
    # 1.09e-5 to 1.16e-5 (Ez)
    Case("mr_wake", lambda: decks.mr_wake(NXY, NZ, 2000, 31), 4e-5),
)
# decks the float32 ladder leaves out, with the ROADMAP fault that does
SKIPPED = {"collision_wake": "R19"}
# The flagship at full width. Bz, its worst kept sum: 3.15e-3 and 3.63e-3
# in two runs. Left out, their sums being dominated by cancellation: rhomjz
# (1.34e-2 to 1.45e-2; each cell is the difference of the electrons' and the
# ions' O(1) charge, mean |rhomjz| 0.015, and its f32 error, sum |f32 - f64|
# 4.0e4, equals chi's, whose sum moves 3.7e-8), Sx and Sy (6.1e-4 to 8.1e-4;
# f32 leaves 40x f64's sum in the far field |x| or |y| > 6), as
# tools/tpu_check.py left out Sx, Sy and chi.
FULL = Case("blowout_wake 1023^2 x 64",
            lambda: decks.blowout_wake(1023, 64, 1023 * 1023 * 10 * 64
                                       // 1000), 1.1e-2,
            skip_fields=("rhomjz", "Sx", "Sy"), steps=1)
# tools/tpu_check.py's CASES through the port: (benchmark json, deck
# inside the reference checkout, overrides, pass_rtol, skip_fields); the
# overrides are the reference's tests/*.sh command lines, as
# tests/test_checksums.py runs them; hipace.use_banded, a TPU key, is a
# no-op here and left out
REF_CASES = (
    ("linear_wake.normalized.1Rank", "examples/linear_wake/inputs_normalized",
     ["diagnostic.field_data=all rho"], 3e-3, ()),
    ("blowout_wake_explicit.2Rank", "examples/blowout_wake/inputs_normalized",
     ["max_step=1"], 6e-3, SXSYCHI),
)


def _abs_sum(arr) -> float:
    """sum |Q| accumulated in float64 (a complex field's modulus)."""
    return float(np.abs(np.asarray(arr)).sum(dtype=np.float64))


def sums(fields: dict, beams: dict) -> dict:
    """{"lev=0": {field: sum|Q|}, beam: {attr: sum|Q|}} of the top-level
    field datasets (names without "/": a named diagnostic's are groups,
    which the checksum reduction skips) and of each beam's records,
    accumulated in float64 (tools/tpu_check.py:83-102)."""
    out = {"lev=0": {}}
    for name, arr in fields.items():
        if "/" not in name:
            out["lev=0"][name] = _abs_sum(arr)
    for beam, rec in beams.items():
        out[beam] = {attr: _abs_sum(rec[attr]) for attr in BEAM_MAP}
    return out


class SumsWriter:
    """Stands in for a Simulation's openPMD writer: keeps sums() of what
    each write would have written, by iteration."""

    def __init__(self):
        self.sums: dict = {}

    def write(self, it, time, dt, fields, geom, beams=None,
              field_geom=None, field_meta=None):
        self.sums[it] = sums(fields or {}, beams or {})


def compare(ours: dict, ref: dict, skip_fields, floor=None):
    """(worst relative deviation, its key) of our sums against a reference
    sum dict, with the noise floors of tests/test_checksums.py
    (tools/tpu_check.py:105-154). floor: per-key absolute float32 floors,
    3x of which is taken off each absolute deviation first."""
    worst = (0.0, None)
    fvals = [abs(v) for v in ref["lev=0"].values()]
    fabs = max(1e-5, 1e-8 * (max(fvals) if fvals else 1.0))

    def dev(key, got, r, abs_floor):
        d = abs(got - r)
        if floor is not None:
            d = max(0.0, d - 3.0 * floor.get(key, 0.0))
        if d <= abs_floor:
            return None
        return d / max(abs(r), 1e-300)

    for field, r in ref["lev=0"].items():
        if field in skip_fields or field not in ours["lev=0"]:
            continue
        rel = dev(field, ours["lev=0"][field], r, fabs)
        if rel is not None and rel > worst[0]:
            worst = (rel, field)
    for species, attrs in ref.items():
        if species.startswith("lev=") or species not in ours:
            continue
        pvals = [abs(v) for a, v in attrs.items() if a in BEAM_MAP]
        pabs = max(1e-8, 1e-8 * (max(pvals) if pvals else 1.0))
        for attr, r in attrs.items():
            if attr not in BEAM_MAP or attr not in ours[species]:
                continue
            rel = dev(f"{species}.{attr}", ours[species][attr], r, pabs)
            if rel is not None and rel > worst[0]:
                worst = (rel, f"{species}.{attr}")
    return worst


def f32_floor(s32: dict, s64: dict) -> dict:
    """Per-key absolute float32 floor |s32 - s64| (tools/tpu_check.py
    f32_floor)."""
    out = {}
    for field, v in s64.get("lev=0", {}).items():
        if field in s32.get("lev=0", {}):
            out[field] = abs(s32["lev=0"][field] - v)
    for species, attrs in s64.items():
        if species.startswith("lev=") or species not in s32:
            continue
        for attr, v in attrs.items():
            if attr in s32[species]:
                out[f"{species}.{attr}"] = abs(s32[species][attr] - v)
    return out


class DrawTape:
    """The random draws of one simulation's run -- each step's temperature
    normals (Simulation.plasma_draws) and each slice's uniforms
    (SliceStep.draws) -- recorded in the order taken, for replay in another
    simulation of the same deck on any device and dtype."""

    def __init__(self):
        self.tape: list = []

    def record(self, sim) -> None:
        own_plasma, own_slice = sim.plasma_draws, sim.slice_step.draws

        def plasma_draws():
            self.tape.append(("plasma", own_plasma()))
            return self.tape[-1][1]

        def slice_draws(name, *shape):
            self.tape.append((name, own_slice(name, *shape)))
            return self.tape[-1][1]
        sim.plasma_draws, sim.slice_step.draws = plasma_draws, slice_draws

    def cpu(self) -> "DrawTape":
        """The tape with its draws on the CPU (to send to another
        process)."""
        out = DrawTape()
        out.tape = [(name, [None if t is None else t.cpu() for t in d]
                     if isinstance(d, list) else d.cpu())
                    for name, d in self.tape]
        return out

    def replay(self, sim) -> Callable[[], None]:
        """Feed the tape to sim in order; returns the check, to call after
        the run, that every draw was taken."""
        queue = list(self.tape)

        def take(name):
            if not queue or queue[0][0] != name:
                got = queue[0][0] if queue else "nothing"
                raise RuntimeError(f"the replayed run asked for a {name!r} "
                                   f"draw where the tape holds {got}")
            return queue.pop(0)[1]

        def to(d):
            return None if d is None else d.to(device=sim.device,
                                               dtype=sim.dtype)

        sim.plasma_draws = lambda: [to(d) for d in take("plasma")]
        sim.slice_step.draws = lambda name, *shape: to(take(name))

        def check():
            if queue:
                raise RuntimeError(f"{len(queue)} recorded draws were not "
                                   "taken")
        return check


def build(case: Case, device, dtype, out_dir: str):
    """The case's Simulation on device/dtype, writing its last step only,
    through a SumsWriter."""
    deck = case.deck()
    for key, value in (("max_step", case.steps - 1),
                       ("diagnostic.output_period", -1),
                       ("hipace.openpmd_backend", "json"),
                       ("hipace.file_prefix", out_dir)):
        deck.override(key, value)
    sim = Simulation(deck, device=device, dtype=dtype, verbose=0)
    sim.writer = SumsWriter()
    return sim


def start_of(sim) -> tuple:
    """What carry_state needs to start another simulation of the same deck
    from sim's beam: (binned as numpy copies, dt, time, total charges)."""
    return ({k: v.cpu().numpy().copy() for k, v in sim.binned.items()
             if torch.is_tensor(v)}, sim.dt, sim.time,
            [b.total_charge for b in sim.beam_cfgs])


def run_leg(sim, steps: int) -> dict:
    """Run sim's time loop for `steps` steps; its last step's sums, the
    V-cycles and PC iterations summed over every slice of every step, and
    the seconds on the host clock."""
    t0 = time.perf_counter()
    cycles = iters = 0
    for step in range(steps):
        sim.set_dt()
        res = sim.advance(step)
        cycles += sum(int(c) for c in res["mg_cycles"])
        iters += sum(int(c) for c in res["pc_iters"])
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    return {"sums": sim.writer.sums[steps - 1], "mg_cycles": cycles,
            "pc_iters": iters, "seconds": time.perf_counter() - t0}


def pair(got: dict, ref: dict, skip_fields, tol: float) -> dict:
    rel, key = compare(got["sums"], ref["sums"], skip_fields)
    return {"max_rel": rel, "key": key, "tol": tol, "ok": rel <= tol}


def card_legs(case: Case) -> tuple:
    """The card's legs of a case: float64, its beam and draws recorded,
    then float32 from both. Returns (start, tape on the CPU, legs)."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = build(case, "cuda", torch.float64, tmp)
        start = start_of(sim)
        tape = DrawTape()
        tape.record(sim)
        legs = {"card_f64": run_leg(sim, case.steps)}
        del sim
        torch.cuda.empty_cache()
        sim = build(case, "cuda", torch.float32, tmp)
        carry_state(sim, *start)
        check = tape.replay(sim)
        legs["card_f32"] = run_leg(sim, case.steps)
        check()
        del sim
        torch.cuda.empty_cache()
    return start, tape.cpu(), legs


def cpu_leg(case: Case | str, start: tuple, tape: "DrawTape") -> dict:
    """The CPU float64 leg of a case (or of the CASES entry of that name),
    from the card's beam and draws."""
    if isinstance(case, str):
        case = next(c for c in CASES if c.name == case)
    with tempfile.TemporaryDirectory() as tmp:
        sim = build(case, "cpu", torch.float64, tmp)
        carry_state(sim, *start)
        check = tape.replay(sim)
        leg = run_leg(sim, case.steps)
        check()
    return leg


def entry(case: Case, legs: dict) -> dict:
    """A case's record: card f64 against the CPU (where there is a CPU
    leg), card f32 against card f64, each leg's sums, V-cycles, PC
    iterations and seconds."""
    out = {"case": case.name, "steps": case.steps,
           "skip_fields": list(case.skip_fields)}
    if "cpu_f64" in legs:
        out["f64_vs_cpu"] = pair(legs["card_f64"], legs["cpu_f64"],
                                 case.skip_fields, F64_RTOL)
    out["f32_vs_f64"] = pair(legs["card_f32"], legs["card_f64"],
                             case.skip_fields, case.pass_rtol)
    for k in ("mg_cycles", "pc_iters", "seconds", "sums"):
        out[k] = {leg: v[k] for leg, v in legs.items()}
    out["ok"] = all(out[k]["ok"] for k in ("f64_vs_cpu", "f32_vs_f64")
                    if k in out)
    return out


def run_case(case: Case) -> dict:
    """One case of the small ladder, its three legs in this process."""
    start, tape, legs = card_legs(case)
    legs["cpu_f64"] = cpu_leg(case, start, tape)
    return entry(case, legs)


def _cpu_worker_init() -> None:
    torch.set_num_threads(CPU_THREADS)


def run_reference(reference: str | None) -> list | str:
    """tools/tpu_check.py's cases on the card in float32 against the
    benchmark JSONs of the reference checkout `reference`, 3x the per-key
    float32 floor |card f32 - card f64| taken off; a string where no
    checkout is given."""
    if reference is None:
        return "not run: no reference given (--reference DIR)"
    if not os.path.isdir(reference):
        raise FileNotFoundError(f"no reference checkout at {reference}")
    out = []
    for name, path, overrides, tol, skip in REF_CASES:
        with open(os.path.join(reference, BENCH, f"{name}.json")) as f:
            ref = json.load(f)

        def deck(path=os.path.join(reference, path), overrides=overrides):
            return Inputs.from_file(path, overrides)
        steps = deck().query("max_step", 0, int) + 1
        legs = card_legs(Case(name, deck, tol, skip, steps))[2]
        s32, s64 = legs["card_f32"]["sums"], legs["card_f64"]["sums"]
        missing = sorted(f for f in ref["lev=0"]
                         if f not in skip and f not in s32["lev=0"])
        raw = compare(s32, ref, skip)
        adj = compare(s32, ref, skip, floor=f32_floor(s32, s64))
        out.append({"case": name, "pass_rtol": tol,
                    "max_rel_vs_reference_raw": raw[0],
                    "argmax_vs_reference_raw": raw[1],
                    "max_rel_vs_reference_floor_adjusted": adj[0],
                    "argmax_floor_adjusted": adj[1],
                    "fields_not_written": missing,
                    "ok": adj[0] <= tol and not missing})
    return out


def gate(names=None, log=sys.stdout, reference=None) -> dict:
    """The gate's record: the small ladder (the cases named in `names`, all
    by default), the full-width leg and the reference leg (on the
    reference checkout `reference`, where one is given). The card's legs run here one case after another; each case's CPU
    leg goes to one of CPU_WORKERS processes as soon as its card legs are
    done, so the CPU legs run beside the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gate runs on a CUDA device, and "
                           "torch.cuda.is_available() is False")
    record = {"gate": "the port's on-card float32 physics checksum ladder",
              "criterion": "sum|Q| of every field and beam attribute of the "
                           "last step (ref tests/checksum/checksum.py:44-80)"
                           f"; card f64 within {F64_RTOL} of CPU f64, card "
                           "f32 within each case's pass_rtol of card f64, "
                           "from the same beam and draws",
              "device": torch.cuda.get_device_name(0), "card": card_line(),
              "cases": [], "skipped": [{"case": k, "skipped": v}
                                       for k, v in SKIPPED.items()]}
    cases = [c for c in CASES if names is None or c.name in names]
    with ProcessPoolExecutor(max_workers=CPU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_cpu_worker_init) as pool:
        pending = []
        for case in cases:
            start, tape, legs = card_legs(case)
            pending.append((case, legs,
                            pool.submit(cpu_leg, case.name, start, tape)))
        record["full_width"] = entry(FULL, card_legs(FULL)[2])
        for case, legs, future in pending:
            legs["cpu_f64"] = future.result()
            record["cases"].append(entry(case, legs))
            print(json.dumps(record["cases"][-1]), file=log, flush=True)
    print(json.dumps(record["full_width"]), file=log, flush=True)
    record["reference"] = run_reference(reference)
    parts = record["cases"] + [record["full_width"]] + (
        record["reference"] if isinstance(record["reference"], list)
        else [])
    record["ok"] = all(e["ok"] for e in parts)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hipace_tpu_torch.gpu_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the record to this file")
    ap.add_argument("--reference", metavar="DIR",
                    help="a checkout of the reference (HiPACE++): also hold "
                         "its two checksum cases to its benchmark JSONs")
    args = ap.parse_args(argv)
    record = gate(log=sys.stderr, reference=args.reference)
    text = json.dumps(record, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
