"""How far float32 moves the JAX package's flagship sums, on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_f32_sums.py [--nxy 255 511] [--nz 64]

One step of the flagship deck (``__graft_entry__._DECK``, the bench's beam
scaling) through ``hipace_tpu`` with x64 on, once in float64 and once in
float32 from the float64 run's beam; for every field of the diagnostic
stack, sum|Q| (the checksum method's sum) of both, their relative
difference and sum|diff|. The JAX-package counterpart of the port's
``tools/f32_sums_probe.py``, which reads the same on the card: whether the
port's float32 behaviour is the JAX package's. Imports nothing of the port.
~1 min at 255^2 and ~5 min at 511^2 on 8 cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nxy", type=int, nargs="+", default=[255, 511])
    ap.add_argument("--nz", type=int, default=64)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _DECK
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation

    for nxy in args.nxy:
        text = _DECK.format(nxy=nxy, nz=args.nz,
                            npart=nxy * nxy * 10 * args.nz // 1000)
        diag, beam = {}, None
        for dtype in (jnp.float64, jnp.float32):
            t0 = time.perf_counter()
            sim = Simulation(Inputs(text), dtype=dtype, verbose=0)
            if beam is None:
                beam = {k: np.asarray(v) for k, v in sim.binned.items()}
            else:
                sim.binned = {k: jnp.asarray(v, dtype=dtype)
                              if np.issubdtype(v.dtype, np.floating)
                              else jnp.asarray(v) for k, v in beam.items()}
            diag[dtype] = np.asarray(sim.run_step(0)["diag"],
                                     dtype=np.float64)
            comps = sim.cfg.diag_comps
            print(f"{nxy}^2 x {args.nz} {jnp.dtype(dtype).name}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        a, b = diag[jnp.float64], diag[jnp.float32]
        for i, c in enumerate(comps):
            s_a, s_b = np.abs(a[:, i]).sum(), np.abs(b[:, i]).sum()
            if s_a == 0:
                continue
            print(f"  {c:8s} sum|Q| {s_a:.6e} {s_b:.6e} rel "
                  f"{abs(s_b - s_a) / s_a:.3e} sum|diff| "
                  f"{np.abs(b[:, i] - a[:, i]).sum():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
