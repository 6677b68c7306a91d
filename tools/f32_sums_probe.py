#!/usr/bin/env python3
"""Where the flagship's float32 fields leave float64's on the card.

    python3 tools/f32_sums_probe.py [--nxy 255 511 1023] [--nz 64]

For each width: one step of the flagship deck (``decks.blowout_wake``, the
bench's beam scaling) on the card in float64, then from the same beam in
float32, in float64 with the beam's x and y moved by one part in 1e7, and in
float64 again (only the order of the kernels' atomic adds differs). For
every field of the diagnostic stack against the first float64 run: sum|Q|
of both (the checksum method's sum), their relative difference, sum|diff|,
max|diff|, and sum|Q| over the far field (|x| > 6 or |y| > 6, outside the
wake). It reads what ``hipace_tpu_torch.gpu_check`` leaves out at full
width and why. Needs one CUDA card; ~1 min at 1023^2.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from hipace_tpu_torch.convert import carry_state  # noqa: E402
from hipace_tpu_torch.decks import blowout_wake  # noqa: E402
from hipace_tpu_torch.pipeline.simulation import Simulation  # noqa: E402

RUNS = (("f32", torch.float32), ("f64, beam moved 1e-7", torch.float64),
        ("f64 again", torch.float64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nxy", type=int, nargs="+", default=[255, 511, 1023])
    ap.add_argument("--nz", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(sys.argv[0], "on", torch.cuda.get_device_name(0), flush=True)
    for nxy in args.nxy:
        deck = (nxy, args.nz, nxy * nxy * 10 * args.nz // 1000)
        ref = Simulation(blowout_wake(*deck), device="cuda",
                         dtype=torch.float64, verbose=0)
        start = ({k: v.cpu().numpy().copy() for k, v in ref.binned.items()
                  if torch.is_tensor(v)}, ref.dt, ref.time)
        comps, g = ref.cfg.diag_comps, ref.geom
        base = ref.run_step(0)["diag"]
        del ref
        x = (g.prob_lo[0] + g.dx * (0.5 + torch.arange(
            g.nx, device="cuda", dtype=torch.float64))).abs()
        far = (x[None, :] > 6) | (x[:, None] > 6)
        for label, dtype in RUNS:
            sim = Simulation(blowout_wake(*deck), device="cuda", dtype=dtype,
                             verbose=0)
            carry_state(sim, *start)
            if "moved" in label:
                for k in ("x", "y"):
                    sim.binned[k] = sim.binned[k] * (1 + 1e-7)
            other = sim.run_step(0)["diag"]
            del sim
            print(f"{nxy}^2 x {args.nz}: float64 against {label}", flush=True)
            for i, c in enumerate(comps):
                a, b = base[:, i], other[:, i].double()
                s_a, s_b = float(a.abs().sum()), float(b.abs().sum())
                if s_a == 0:
                    continue
                d = (b - a).abs()
                print(f"  {c:8s} sum|Q| {s_a:.6e} {s_b:.6e} rel "
                      f"{abs(s_b - s_a) / s_a:.3e} sum|diff| "
                      f"{float(d.sum()):.3e} max|diff| {float(d.max()):.3e}"
                      f" (max|Q| {float(a.abs().max()):.3e}) far field "
                      f"{float(a[:, far].abs().sum()):.3e} "
                      f"{float(b[:, far].abs().sum()):.3e}", flush=True)
            del other
            torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
