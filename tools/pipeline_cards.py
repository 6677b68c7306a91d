"""The pipelined flagship across the cards of one host, against the serial
loop on one card, in one run.

    python3 tools/pipeline_cards.py [--steps 8]

On a machine with two or more GPUs it runs the flagship
(``hipace_tpu_torch.decks.BLOWOUT_WAKE`` at chip_smoke.py's 1023^2 x 64,
float32) from one beam:

- the serial loop on cuda:0;
- ``Simulation.evolve_pipelined`` with two stages sharing cuda:0;
- ``evolve_pipelined`` with one stage on each of cuda:0 .. cuda:n-1, for
  n = 2 and n = the card count (one host thread drives every stage).

Each run has a warm-up (one step or one window, its stages built before it)
in which the host's reads of the device are counted, then --steps timed
steps (a multiple of every n) from the same beam. It prints each run's
slices per second over all stages' slices, its ratio to the serial loop's,
the reads per slice, each card's peak memory, and its final beam against
the serial loop's (each attribute sorted; chip_smoke.py's PIPE_F32_TOL,
beside a second serial run's spread), then the cards' names and power
limits, and as its last line a JSON object of these numbers, also written to
``build/pipeline_cards.json``. It exits non-zero where a final beam
is off or a lane is lost.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < 2:
        print("needs two or more CUDA devices", file=sys.stderr)
        return 2
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.ops import cuda_lib
    from hipace_tpu_torch.pipeline.simulation import Simulation
    n_cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60).stdout.strip().splitlines()
    cuda_lib.library()
    steps = args.steps
    cuda = [torch.device("cuda", i) for i in range(n_cards)]
    runs = [("serial", None), ("2 stages on cuda:0", [cuda[0]] * 2)]
    runs += [(f"{n} stages on {n} cards", cuda[:n])
             for n in sorted({2, n_cards})]
    if any(steps % len(devs) for _, devs in runs if devs):
        raise SystemExit(f"--steps {steps} is not a multiple of every "
                         "stage count")

    def flagship():
        return Simulation(blowout_wake(cs.NXY, cs.NZ, cs.NPART),
                          device="cuda:0", dtype=torch.float32, verbose=0)

    def from_start(sim, max_step):
        sim.binned = {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in beam0.items()}
        sim.time, sim.dt, sim.max_step = 0.0, dt0, max_step

    def run(sim, devices):
        if devices is None:
            sim.evolve(write_output=False)
        else:
            sim.evolve_pipelined(devices=devices, write_output=False)

    beam0 = dt0 = None
    out, finals = {}, {}
    for name, devices in runs + [("serial again", None)]:
        sim = flagship()
        if beam0 is None:
            beam0 = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in sim.binned.items()}
            dt0 = sim.dt
        n = len(devices) if devices else 1
        if devices:
            sim.stage_slice_steps(devices)
        from_start(sim, n - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, reads = cs.sync_counted(torch, lambda: run(sim, devices))
        for c in cuda:
            torch.cuda.synchronize(c)
        t_warm = time.perf_counter() - t0
        from_start(sim, steps - 1)
        for c in cuda:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        run(sim, devices)
        for c in cuda:
            torch.cuda.synchronize(c)
        t = time.perf_counter() - t0
        peaks = [torch.cuda.max_memory_allocated(c) / 2 ** 30
                 for c in cuda[:n]] if devices else [
            torch.cuda.max_memory_allocated(cuda[0]) / 2 ** 30]
        finals[name] = sim.binned
        slices = cs.NZ * steps
        out[name] = {"devices": [str(d) for d in devices or [cuda[0]]],
                     "slices_per_s": slices / t, "seconds": t,
                     "warmup_seconds": t_warm,
                     "reads_per_slice": reads / (cs.NZ * n),
                     "peak_gib": peaks,
                     "lanes": int(sim.binned["valid"].sum())}
        del sim
        torch.cuda.empty_cache()
    n0 = int(beam0["valid"].sum())
    base = out["serial"]["slices_per_s"]
    ok = True
    for name, rec in out.items():
        diff = cs.beam_rel(torch, finals[name], finals["serial"], sort=True)
        rec["vs_serial"] = rec["slices_per_s"] / base
        rec["beam_rel"] = diff[0]
        good = diff[0] <= cs.PIPE_F32_TOL and rec["lanes"] == n0
        ok &= good
        print(f"{name}: {rec['slices_per_s']:.3f} slices/s over {steps} "
              f"steps ({rec['vs_serial']:.3f} of the serial loop's), "
              f"{rec['reads_per_slice']:.3f} host reads per slice in the "
              f"warm-up ({rec['warmup_seconds']:.3f} s), peak "
              + ", ".join(f"{p:.3f}" for p in rec["peak_gib"])
              + f" GiB per card, final beam against the serial loop's "
              f"{diff[0]:.3e} ({diff[1]}; tol {cs.PIPE_F32_TOL:g}), lanes "
              f"{rec['lanes']} of {n0} {'ok' if good else 'FAIL'}",
              flush=True)
    for line in smi:
        print(line)
    result = {"ok": ok, "grid": [cs.NXY, cs.NXY, cs.NZ], "steps": steps,
              "cards": smi, "runs": out}
    dest = ROOT / "build"
    dest.mkdir(exist_ok=True)
    (dest / "pipeline_cards.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
