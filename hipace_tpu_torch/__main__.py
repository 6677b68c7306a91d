"""CLI: ``python -m hipace_tpu_torch deck [key=value ...] [--device cpu]``.

Mirrors ``python -m hipace_tpu``: an inputs deck plus command-line
overrides, running InitData + Evolve (ref main.cpp:15-25) and writing the
deck's openPMD and in-situ output. Without ``--device`` the run is on the
GPU, float32, through the port's kernels, and raises where there is no GPU;
``--device cpu`` asks for the float64 run on the plain PyTorch versions.
With more than one GPU the time loop is a pipeline, one process (rank) per
GPU on a ring (``parallel/ranks.py``, ``Simulation.evolve_ranks``; the
reference's ``mpiexec -n N`` mode, ref Hipace.cpp:400-401), unless the deck
sets ``hipace.pipeline = 0``. Under ``torchrun`` (``WORLD_SIZE`` set) each
process it started is a rank of that group.
``hipace.profile = <dir>`` runs the time loop under ``torch.profiler`` (CPU
activity, and CUDA activity on the card) and writes its trace to that
directory (``<worker>.<ms>.pt.trace.json``).
"""

from __future__ import annotations

import os
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


def _profiled(trace_dir: str, device):
    """A torch.profiler context writing its trace to trace_dir (CPU
    activity, and CUDA activity on the card), or a null context."""
    import contextlib
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def report(sim, wall: float, n_ranks: int) -> None:
    """The closing lines of a run: its seconds on n_ranks ranks, the time
    per particle push and per cell update."""
    g = sim.geom
    n_steps = sim.max_step + 1
    print(f"Finished Evolve after {wall:.6g} seconds using {n_ranks} rank"
          f"{'s' if n_ranks > 1 else ''} on {sim.device}")
    n_plasma = sum(p.ppc[0] * p.ppc[1] * max(1, p.n_subcycles)
                   for p in sim.plasma_cfgs) * g.nx * g.ny
    pushes = (n_plasma * g.nz + sum(b.num_particles * max(1, b.n_subcycles)
                                    for b in sim.beam_cfgs)) * n_steps
    if pushes:
        print(f"Total time per particle push: {1e9 * wall / pushes:.4g} "
              "nanoseconds")
    cells = g.nx * g.ny * g.nz * n_steps
    print(f"Total time per cell update: {1e9 * wall / cells:.4g} nanoseconds",
          flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device, rest = _parse(argv)
    if not rest:
        print("usage: python -m hipace_tpu_torch <inputs_file> [key=value ...]"
              " [--device cpu|cuda]")
        return 1
    import torch

    from . import device as dev_policy
    from .parallel import ranks
    from .parser import Inputs

    with open(rest[0]) as f:
        deck = f.read()
    inputs = Inputs(deck, overrides=rest[1:])
    job = ranks.Job(deck, tuple(rest[1:]), cli=True)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun started this process as one rank of a group
        ring = ranks.Ring.from_env(device)
        try:
            ranks.run_job(ring, job)
        finally:
            ring.close()
        return 0
    dev, _ = dev_policy.resolve(device)
    n_ranks = (torch.cuda.device_count() if dev.type == "cuda"
               and inputs.query("hipace.pipeline", True, bool) else 1)
    if n_ranks > 1:
        ranks.spawn(job, [torch.device("cuda", i) for i in range(n_ranks)],
                    timeout=None)
        return 0
    return _serial(inputs, device)


def _serial(inputs, device) -> int:
    """The serial time loop in this process."""
    import torch

    from .pipeline.simulation import Simulation

    # hipace.profile = <trace dir>: a profiler trace of the run (the
    # reference's TinyProfiler regions), viewable in Perfetto or TensorBoard
    trace_dir = inputs.query("hipace.profile", "", str)
    t0 = time.perf_counter()
    sim = Simulation(inputs, device=device)
    with _profiled(trace_dir, sim.device):
        sim.evolve()
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    report(sim, time.perf_counter() - t0, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
