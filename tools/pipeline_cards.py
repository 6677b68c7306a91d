"""The pipelined flagship across the cards of one host, against the serial
loop on one card, in one run.

    python3 tools/pipeline_cards.py [--steps 8] [--rounds 2]

On a machine with two or more GPUs it runs the flagship
(``hipace_tpu_torch.decks.BLOWOUT_WAKE`` at chip_smoke.py's 1023^2 x 64,
float32) from one beam:

- the serial loop on cuda:0;
- ``Simulation.evolve_pipelined`` (one host thread drives every stage) with
  two stages sharing cuda:0, and with one stage on each of cuda:0 ..
  cuda:n-1, for n = 2 and n = the card count;
- the rank pipeline (``hipace_tpu_torch.parallel.ranks.spawn``, one process
  per stage, ``Simulation.evolve_ranks``): two ranks sharing cuda:0 (gloo),
  and one rank on each of cuda:0 .. cuda:n-1 (NCCL), for the same n.

The pipelined runs go in turns, --rounds times (each round in the reverse
order of the one before), between two serial runs. Each run has a warm-up
(one step or one window, a one-thread run's stages built before it; in a
one-thread run the host's reads of the device are counted), then --steps
timed steps (a multiple of every n) from the same beam. It prints each
run's slices per second over all stages' slices, its ratio to the first
serial run's, each card's or rank's peak memory, and its final beam against
the serial loop's (each attribute sorted; chip_smoke.py's PIPE_F32_TOL,
beside the second serial run's spread), then the cards' name and power
limit and the host's cores, and as its last line a JSON object of these
numbers, also written to ``build/pipeline_cards.json``. It exits non-zero
where a final beam is off, a lane is lost or a rank's generator draws
differ from this process's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < 2:
        print("needs two or more CUDA devices", file=sys.stderr)
        return 2
    from hipace_tpu_torch.decks import BLOWOUT_WAKE, blowout_wake
    from hipace_tpu_torch.device import card_line
    from hipace_tpu_torch.ops import cuda_lib
    from hipace_tpu_torch.parallel import ranks
    from hipace_tpu_torch.pipeline.simulation import Simulation
    n_cards = torch.cuda.device_count()
    card = card_line()
    cuda_lib.library()
    steps = args.steps
    cuda = [torch.device("cuda", i) for i in range(n_cards)]
    counts = sorted({2, n_cards})
    piped = [("2 stages on cuda:0", "thread", [cuda[0]] * 2),
             ("2 ranks on cuda:0", "ranks", [cuda[0]] * 2)]
    for n in counts:
        piped += [(f"{n} stages on {n} cards", "thread", cuda[:n]),
                  (f"{n} ranks on {n} cards", "ranks", cuda[:n])]
    order = [("serial", "serial", None)]
    for r in range(args.rounds):
        order += piped if r % 2 == 0 else piped[::-1]
    order += [("serial again", "serial", None)]
    if any(steps % len(devs) for _, _, devs in piped):
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

    def in_process(devices):
        """A serial or one-thread pipelined run in this process."""
        sim = flagship()
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
                 for c in (devices or [cuda[0]])[:n]]
        rec = {"seconds": t, "warmup_seconds": t_warm,
               "reads_per_slice": reads / (cs.NZ * n), "peak_gib": peaks}
        return sim.binned, rec

    job = ranks.Job(BLOWOUT_WAKE.format(nxy=cs.NXY, nz=cs.NZ, npart=cs.NPART),
                    dtype="float32", write_output=False, verbose=0)

    def rank_run(devices):
        """A rank pipeline: one process per entry of devices."""
        n = len(devices)
        t0 = time.perf_counter()
        res = ranks.spawn(dataclasses.replace(job, max_steps=(n - 1,
                                                              steps - 1)),
                          devices, timeout=900)
        timed = [r["runs"][-1] for r in res]
        final = {k: v.to(cuda[0]) if torch.is_tensor(v) else v
                 for k, v in res[0]["final"]["binned"].items()}
        rec = {"seconds": timed[0]["seconds"],
               "warmup_seconds": res[0]["runs"][0]["seconds"],
               "spawn_seconds": time.perf_counter() - t0,
               "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in timed],
               "probes_equal": all(r["probe"] == probe for r in res)}
        return final, rec

    sim = flagship()
    beam0 = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in sim.binned.items()}
    dt0, n0 = sim.dt, int(beam0["valid"].sum())
    probe = ranks.generator_probe(sim)
    del sim
    out, finals = [], []
    for name, kind, devices in order:
        if kind == "ranks":
            final, rec = rank_run(devices)
        else:
            final, rec = in_process(devices)
        torch.cuda.empty_cache()
        rec.update(name=name, kind=kind,
                   devices=[str(d) for d in devices or [cuda[0]]],
                   slices_per_s=cs.NZ * steps / rec["seconds"],
                   lanes=int(final["valid"].sum()))
        out.append(rec)
        finals.append(final)
        print(f"{name}: {rec['slices_per_s']:.3f} slices/s over {steps} "
              f"steps, warm-up {rec['warmup_seconds']:.3f} s", flush=True)
    base = out[0]["slices_per_s"]
    ok = True
    for rec, final in zip(out, finals):
        diff = cs.beam_rel(torch, final, finals[0], sort=True)
        rec["vs_serial"] = rec["slices_per_s"] / base
        rec["beam_rel"] = diff[0]
        good = (diff[0] <= cs.PIPE_F32_TOL and rec["lanes"] == n0
                and rec.get("probes_equal", True))
        ok &= good
        extra = (f"{rec['reads_per_slice']:.3f} host reads per slice in the "
                 "warm-up" if "reads_per_slice" in rec else
                 f"spawn {rec['spawn_seconds']:.1f} s, generator draws equal"
                 f" on every rank {rec['probes_equal']}")
        print(f"{rec['name']}: {rec['slices_per_s']:.3f} slices/s "
              f"({rec['vs_serial']:.3f} of the serial loop's), {extra}, peak "
              + ", ".join(f"{p:.3f}" for p in rec["peak_gib"])
              + f" GiB per card or rank, final beam against the serial "
              f"loop's {diff[0]:.3e} ({diff[1]}; tol {cs.PIPE_F32_TOL:g}), "
              f"lanes {rec['lanes']} of {n0} {'ok' if good else 'FAIL'}",
              flush=True)
    print(card)
    print(f"host cores: {os.cpu_count()}")
    result = {"ok": ok, "grid": [cs.NXY, cs.NXY, cs.NZ], "steps": steps,
              "card": card, "cards": n_cards, "host_cores": os.cpu_count(),
              "runs": out}
    dest = ROOT / "build"
    dest.mkdir(exist_ok=True)
    (dest / "pipeline_cards.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
