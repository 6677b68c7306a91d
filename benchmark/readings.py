"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.readings --workload <cell> --seeds <n> [<n> ...]
        [--dtype float32]

Runs the cell once per seed in this one process, each run with the
shortest window (one step past the warm-up) and its check, and prints one
JSON line per seed with the numbers compared. ``--dtype float32`` runs the
control: the program in the nearest precision below the configuration's
float64, which the limits have to fail. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import manifest
from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.Manifest()
    dtype = getattr(torch, args.dtype) if args.dtype else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        line, lines = run_cell(man, args.workload, seed, 0.0, False,
                               dtype=dtype, t0=t0)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or "configured",
                          "correct": line["correct"],
                          "seconds": time.perf_counter() - t0,
                          "notes": lines[:2],
                          "checks": {k: c["value"] for k, c
                                     in line["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
