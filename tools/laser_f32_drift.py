"""How far float32 moves LASER_WAKE's fields, on the card: step 0 in
float64 on the kernels as the reference, against float64 with a0 moved by
1e-7 (the deck's sensitivity to a change of float32's size in its input),
float32 on the kernels, and float32 on the plain versions (every kernel
wrapper's plain PyTorch version on the card: the JAX package's arithmetic).

Per field it prints the relative difference of the checksum sum|f| (the
measure tests/test_f32_physics.py holds) and max|d| / max|reference|, and the
advanced envelope's max|d| / max; with the Bx/By V-cycles per slice of each
run.

    python3 tools/laser_f32_drift.py --nxy 511 1023
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hipace_tpu_torch.decks import LASER_WAKE  # noqa: E402
from hipace_tpu_torch.ops import cuda_lib  # noqa: E402
from hipace_tpu_torch.parser import Inputs  # noqa: E402
from hipace_tpu_torch.pipeline.simulation import Simulation  # noqa: E402


def step0(nxy, nz, dtype, a0="4.5", plain=False):
    """(lev0 stack, advanced envelope, V-cycles, comps) of step 0, on the
    host in float64; plain=True sends every wrapper to its plain version."""
    kernel_rule = cuda_lib.use_kernel
    if plain:
        cuda_lib.use_kernel = lambda tensor: False
    try:
        t0 = time.perf_counter()
        deck = LASER_WAKE.replace("laser.a0 = 4.5", f"laser.a0 = {a0}")
        sim = Simulation(Inputs(deck.format(nxy=nxy, nz=nz, npart=0)),
                         device="cuda", dtype=dtype, verbose=0)
        r = sim.run_step(0)
        torch.cuda.synchronize()
        out = (r["diag"].double().cpu(),
               r["laser_stream"][0].to(torch.complex128).cpu(),
               r["mg_cycles"], sim.cfg.diag_comps)
        print(f"  {nxy}^2 {str(dtype).split('.')[1]} a0 {a0}"
              f"{' plain' if plain else ''}: {time.perf_counter() - t0:.1f} "
              f"s, Bx/By V-cycles {r['mg_cycles']}", flush=True)
        return out
    finally:
        cuda_lib.use_kernel = kernel_rule
        torch.cuda.empty_cache()


def compare(label, got, ref):
    parts = []
    for i, c in enumerate(ref[3]):
        top = float(ref[0][:, i].abs().max())
        if not top:
            continue
        s_got = float(got[0][:, i].abs().sum())
        s_ref = float(ref[0][:, i].abs().sum())
        pt = float((got[0][:, i] - ref[0][:, i]).abs().max()) / top
        parts.append(f"{c} {abs(s_got - s_ref) / s_ref:.2e}/{pt:.2e}")
    env = float((got[1] - ref[1]).abs().max() / ref[1].abs().max())
    print(f"{label}, checksum / max|d| / max: " + ", ".join(parts)
          + f"; advanced envelope {env:.2e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nxy", type=int, nargs="+", default=[1023])
    ap.add_argument("--nz", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip() or torch.cuda.get_device_name(0), flush=True)
    for nxy in args.nxy:
        ref = step0(nxy, args.nz, torch.float64)
        compare(f"{nxy}^2 float64, a0 * (1 + 1e-7), against float64",
                step0(nxy, args.nz, torch.float64, a0="4.50000045"), ref)
        k32 = step0(nxy, args.nz, torch.float32)
        compare(f"{nxy}^2 float32 kernels against float64", k32, ref)
        p32 = step0(nxy, args.nz, torch.float32, plain=True)
        compare(f"{nxy}^2 float32 plain versions against float64", p32, ref)
        compare(f"{nxy}^2 float32 kernels against float32 plain versions",
                k32, p32)


if __name__ == "__main__":
    main()
