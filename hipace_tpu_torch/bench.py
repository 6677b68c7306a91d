"""Benchmark of the port: zeta-slices per second on one card.

    python -m hipace_tpu_torch.bench [--device cpu]

The port's counterpart of the JAX package's ``bench.py``. It runs a deck of
``hipace_tpu_torch.decks`` -- by default ``pdf_beam``, the in-repo stand-in
for the reference's ``examples/benchmarks/inputs_transverse_benchmark`` (a
fixed_weight_pdf beam, a 1 ppc plasma, the explicit solver) -- at nxy = 1023,
reduced to HIPACE_BENCH_NZ slices with the beam's particle count scaled to
keep the reference's beam density per slice (nxy^2 * 10 per 1000 slices, ref
inputs_transverse_benchmark:29), with max_step = 0, hipace.dt = 1.0 and no
output.

One warm-up step (the kernels' nvcc build happens in it, outside every timed
window), then HIPACE_BENCH_RUNS runs of the measured loop: STEPS - 1 steps,
each carrying the beam, time and dt on, timed on the host clock and ended
by ``torch.cuda.synchronize()``. Calls of one code vary ~2x on the card and
runs of one call by 10-20%, so the line reports the median run and every
run.

Stderr: the measured seconds and pushes, ns/push (subcycles counted) and
ns/cell (ref Hipace.cpp:509-553, counted as bench.py counts them), K1/K2/K3
and fused beam push launches per slice from the wrappers' counters, the
peak device memory and the kernels' build seconds. The last line of stdout
is one JSON object: metric, value (the median slices/s), unit, runs (each
run's slices/s), ns_per_push, ns_per_cell, device (the card's name) and
power_limit (the ``nvidia-smi --query-gpu=name,power.limit`` line, or "not
read").

The card is the default and the bench raises without one. ``--device cpu``
is the rehearsal: the plain PyTorch versions in float64; its line says
"device": "cpu" and names no card.

Environment (the names and defaults of bench.py): HIPACE_BENCH_NXY (1023),
HIPACE_BENCH_NZ (128), HIPACE_BENCH_STEPS (4: 1 warm-up, 3 measured),
HIPACE_BENCH_NPART (nxy^2 * 10 * nz / 1000), HIPACE_BENCH_OVERRIDES
(";"-separated key=value deck lines); and HIPACE_BENCH_RUNS (5) and
HIPACE_BENCH_DECK (pdf_beam: the name of a decks.py function of (nxy, nz,
npart)).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from . import decks
from .device import card_line, resolve
from .ops import cuda_lib
from .ops.beam_push import beam_push
from .ops.deposit import deposit
from .ops.gather import gather_main
from .ops.mg_kernel import mg_solve
from .pipeline.simulation import Simulation


def push_counts(sim, n_slices: int, measured: int) -> dict:
    """Plasma pushes, beam pushes and cell updates of `measured` steps of
    n_slices slices in all, subcycles counted (bench.py:94-106)."""
    g = sim.geom
    n_plasma = sum(g.nx * g.ny * p.ppc[0] * p.ppc[1] * max(1, p.n_subcycles)
                   for p in sim.plasma_cfgs)
    beam = sum((b.num_particles or 0) * max(1, b.n_subcycles)
               for b in sim.beam_cfgs) * measured
    return {"plasma_pushes": n_plasma * n_slices, "beam_pushes": beam,
            "cells": g.nx * g.ny * n_slices}


def run(nxy: int = 1023, nz: int = 128, steps: int = 4, runs: int = 5,
        npart: int | None = None, deck: str = "pdf_beam", overrides=(),
        device=None, log=sys.stderr) -> dict:
    """Build the deck, take the warm-up step and `runs` measured loops;
    print the counters to `log` and return the JSON record."""
    dev, _ = resolve(device)
    on_card = dev.type == "cuda"
    if npart is None:
        npart = max(1024, int(nxy * nxy * 10 * nz / 1000))
    inputs = getattr(decks, deck)(nxy, nz, npart)
    for line in ["max_step=0", "hipace.dt=1.0",
                 "diagnostic.output_period=0", *overrides]:
        key, _, value = line.partition("=")
        inputs.override(key.strip(), value.strip())

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        loaded = cuda_lib._LIBRARY is not None
        torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulation(inputs, device=dev, verbose=0)
    t0 = time.perf_counter()
    res = sim.run_step(0)
    sync()
    warmup = time.perf_counter() - t0
    build = "none (CPU)"
    if on_card:
        lib = cuda_lib.library()
        build = ("loaded before the bench" if loaded
                 else f"{lib.build_seconds:.1f} s" if lib.built
                 else "loaded from the build directory")

    measured = max(1, steps - 1)
    n_slices = nz * measured
    kernels = {"K1": deposit, "K2": gather_main, "K3": mg_solve,
               "beam push": beam_push}
    for fn in kernels.values():
        fn.launches = 0
    walls, step = [], 1
    for r in range(runs):
        t0 = time.perf_counter()
        for _ in range(measured):
            sim.binned = res["binned"]
            sim.time += float(sim.dt)
            res = sim.run_step(step)
            step += 1
        sync()
        walls.append(time.perf_counter() - t0)
        print(f"# run {r}: {walls[-1]:.3f} s for {n_slices} slices, "
              f"{n_slices / walls[-1]:.3f} slices/s", file=log, flush=True)
    launches = {k: fn.launches / (runs * n_slices)
                for k, fn in kernels.items()}

    rates = [n_slices / w for w in walls]
    value = statistics.median(rates)
    wall = n_slices / value
    counts = push_counts(sim, n_slices, measured)
    pushes = counts["plasma_pushes"] + counts["beam_pushes"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    print(f"# measured: {wall:.3f} s (median of {runs} runs) for {n_slices}"
          f" slices ({counts['plasma_pushes']:.3g} plasma + "
          f"{counts['beam_pushes']:.3g} beam pushes)", file=log)
    print(f"# ns/push (all, subcycled): {1e9 * wall / pushes:.3f}", file=log)
    print(f"# ns/cell: {1e9 * wall / counts['cells']:.3f}", file=log)
    print("# launches per slice: " + ", ".join(
        f"{k} {n:.3f}" for k, n in launches.items())
        + ("" if on_card else " (the CPU runs the plain versions)"),
        file=log)
    print("# peak device memory: "
          + (f"{peak:.3f} GiB" if on_card else "not measured (CPU)"),
          file=log)
    print(f"# kernel build: {build}, inside the {warmup:.1f} s warm-up step,"
          " outside every timed run", file=log, flush=True)
    return {"metric": f"zeta-slices/sec at {nxy}^2 x {nz} ({deck} deck)",
            "value": value, "unit": "slices/s", "runs": rates,
            "ns_per_push": 1e9 * wall / pushes,
            "ns_per_cell": 1e9 * wall / counts["cells"], **counts,
            "launches_per_slice": launches,
            "peak_gib": peak, "warmup_s": warmup, "build": build,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "power_limit": card_line() if on_card else "not read"}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if argv[:1] == ["--device"] and len(argv) == 2:
        device = argv[1]
    elif argv:
        print("usage: python -m hipace_tpu_torch.bench [--device cpu]",
              file=sys.stderr)
        return 1
    env = os.environ.get
    nxy = int(env("HIPACE_BENCH_NXY", "1023"))
    nz = int(env("HIPACE_BENCH_NZ", "128"))
    npart = env("HIPACE_BENCH_NPART")
    record = run(nxy=nxy, nz=nz, steps=int(env("HIPACE_BENCH_STEPS", "4")),
                 runs=int(env("HIPACE_BENCH_RUNS", "5")),
                 npart=int(npart) if npart else None,
                 deck=env("HIPACE_BENCH_DECK", "pdf_beam"),
                 overrides=[o for o in env("HIPACE_BENCH_OVERRIDES", "")
                            .split(";") if o],
                 device=device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
