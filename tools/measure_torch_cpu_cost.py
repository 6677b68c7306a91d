"""The port's CPU cost per slice and per cell, on one thread in float64.

    python tools/measure_torch_cpu_cost.py [--nz 50]

Times one step of the flagship deck (``hipace_tpu_torch.decks.BLOWOUT_WAKE``,
explicit solver, a 5000-particle beam) at 32^2 and 64^2 x nz, and of its
predictor-corrector variant (``PC_OPEN``), of the laser-driven blowout
(``LASER_WAKE``, the multigrid envelope solver) and of the flagship with
collisions (``COLLISION_WAKE``) at 64^2, on CPU tensors, and fits seconds per
slice = A + B * cells: A is the per-slice cost (the beam's subcycles and the
eager ops' overhead), B the cost per cell of one plasma species; the
predictor-corrector's, the laser's and the collisions' factors are their
times over the explicit one's at 64^2. Field ionization
(``IONIZATION_WAKE``, two species, its product's slots counted as a
species) is printed as its time over the reckoning's A + 2 B cells at 64^2.
tests/torch_checksum_cases.py reckons each checksum case's time from these
numbers.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hipace_tpu_torch.decks import (blowout_wake,  # noqa: E402
                                    collision_wake, ionization_wake,
                                    laser_wake, pc_open)
from hipace_tpu_torch.pipeline.simulation import Simulation  # noqa: E402


def seconds_per_slice(deck_fn, nxy: int, nz: int) -> float:
    sim = Simulation(deck_fn(nxy, nz, 5000), device="cpu", verbose=0)
    t0 = time.perf_counter()
    sim.run_step(0)
    return (time.perf_counter() - t0) / nz


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=50)
    nz = ap.parse_args().nz
    torch.set_num_threads(1)
    t32 = seconds_per_slice(blowout_wake, 32, nz)
    t64 = seconds_per_slice(blowout_wake, 64, nz)
    pc64 = seconds_per_slice(pc_open, 64, nz)
    laser64 = seconds_per_slice(laser_wake, 64, nz)
    coll64 = seconds_per_slice(collision_wake, 64, nz)
    ion64 = seconds_per_slice(ionization_wake, 64, nz)
    b = (t64 - t32) / (64 * 64 - 32 * 32)
    a = t32 - b * 32 * 32
    print(f"explicit 32^2: {1e3 * t32:.2f} ms/slice; 64^2: {1e3 * t64:.2f} "
          f"ms/slice; predictor-corrector 64^2: {1e3 * pc64:.2f} ms/slice; "
          f"laser 64^2: {1e3 * laser64:.2f} ms/slice; collisions 64^2: "
          f"{1e3 * coll64:.2f} ms/slice; ionization 64^2: "
          f"{1e3 * ion64:.2f} ms/slice")
    print(f"A = {1e3 * a:.2f} ms per slice, B = {1e6 * b:.3f} us per cell, "
          f"predictor-corrector factor {pc64 / t64:.2f}, laser factor "
          f"{laser64 / t64:.2f}, collision factor {coll64 / t64:.2f}, "
          f"ionization over A + 2 B cells "
          f"{ion64 / (a + 2 * b * 64 * 64):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
