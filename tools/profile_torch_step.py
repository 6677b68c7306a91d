"""Where the time of one time step of the PyTorch/CUDA port goes, on a GPU.

    python3 tools/profile_torch_step.py [--nxy 1023] [--nz 64] [--steps 2]

Runs the flagship blowout-wake deck (``hipace_tpu_torch.decks``) in float32
on ``cuda``: one warm-up step, ``--steps`` timed steps on the host clock,
then one step under ``torch.profiler``. It prints the device time and
launch count per slice of each group of device activities (the port's
kernels K1-K3, PyTorch elementwise kernels, copies, FFT, the rest), the
busiest kernels, and the busy share: profiled device time per slice over
the unprofiled wall time per slice. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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
    ("K3 multigrid", ("hipace::mg_",)),
    ("FFT (DST)", ("fft", "FFT")),
    ("cat / copy / memcpy / memset", ("Cat", "copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel",)),
]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nxy", type=int, default=1023)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3

    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    npart = args.nxy * args.nxy * 10 * args.nz // 1000
    sim = Simulation(blowout_wake(args.nxy, args.nz, npart), device="cuda",
                     dtype=torch.float32, verbose=0)

    def step():
        res = sim.run_step(0)
        sim.binned = res["binned"]
        sim.time += sim.dt
        torch.cuda.synchronize()

    step()                                          # warm-up
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    wall_ms = 1e3 * (time.perf_counter() - t0) / (args.steps * args.nz)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    ms = defaultdict(float)
    count = defaultdict(int)
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        dur = e.time_range.elapsed_us() / 1e3
        g = group_of(e.name)
        ms[g] += dur
        count[g] += 1
        per_kernel[e.name][0] += dur
        per_kernel[e.name][1] += 1
    total = sum(ms.values())
    nz = args.nz
    print(f"deck {args.nxy}^2 x {nz}, {npart} beam particles, float32; "
          f"unprofiled {wall_ms:.3f} ms/slice ({1e3 / wall_ms:.3f} slices/s) "
          f"over {args.steps} steps after 1 warm-up")
    print(f"profiled step: {sum(count.values())} device activities, device "
          f"time {total / nz:.3f} ms/slice, busy share "
          f"{total / nz / wall_ms:.3f} of the unprofiled slice")
    print(f"{'group':<30} {'device ms/slice':>16} {'launches/slice':>15}")
    for g in sorted(ms, key=ms.get, reverse=True):
        print(f"{g:<30} {ms[g] / nz:16.3f} {count[g] / nz:15.2f}")
    print("busiest device activities over the profiled step:")
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (t, n) in top[:15]:
        print(f"  {t:9.3f} ms {n:7d}x  {name[:100]}")
    return 0 if total > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
