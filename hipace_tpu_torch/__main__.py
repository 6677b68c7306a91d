"""CLI: ``python -m hipace_tpu_torch deck [key=value ...] [--device cuda]``.

Mirrors ``python -m hipace_tpu``: an inputs deck plus command-line
overrides, running InitData + Evolve (ref main.cpp:15-25). The device sets
the precision: the CPU runs float64, ``--device cuda`` runs float32 on the
GPU through the port's kernels.
"""

from __future__ import annotations

import sys
import time


def _parse(argv):
    device = None
    rest = []
    it = iter(argv)
    for arg in it:
        key, eq, val = arg.partition("=")
        if key == "--device":
            device = val if eq else next(it, None)
            if device is None:
                raise SystemExit("--device needs a value")
        else:
            rest.append(arg)
    return device, rest


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = _parse(argv)
    if not rest:
        print("usage: python -m hipace_tpu_torch <inputs_file> [key=value ...]"
              " [--device cpu|cuda]")
        return 1
    import torch

    from hipace_tpu.parser import Inputs

    from .pipeline.simulation import Simulation

    inputs = Inputs.from_file(rest[0], overrides=rest[1:])
    t0 = time.perf_counter()
    sim = Simulation(inputs, device=device)
    sim.evolve()
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    wall = time.perf_counter() - t0
    g = sim.geom
    n_steps = sim.max_step + 1
    print(f"Finished Evolve after {wall:.6g} seconds on {sim.device}")
    n_plasma = sum(p.ppc[0] * p.ppc[1] * max(1, p.n_subcycles)
                   for p in sim.plasma_cfgs) * g.nx * g.ny
    pushes = (n_plasma * g.nz + sum(b.num_particles * max(1, b.n_subcycles)
                                    for b in sim.beam_cfgs)) * n_steps
    if pushes:
        print(f"Total time per particle push: {1e9 * wall / pushes:.4g} "
              "nanoseconds")
    cells = g.nx * g.ny * g.nz * n_steps
    print(f"Total time per cell update: {1e9 * wall / cells:.4g} nanoseconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
