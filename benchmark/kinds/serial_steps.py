"""Traffic kind ``serial_steps``: the serial time loop of one process on one
card, whole steps back to back, the beam and the time carried from step to
step as the program's own time loop carries them.

Set-up draws the beam from the seed, writes it for the deck's ``from_file``
injection, builds the ``Simulation`` and takes the mix's warm-up steps
through ``Simulation.run_step``, the window's own call. The window then
takes steps until its seconds have passed and ends in
``torch.cuda.synchronize()``; the traced window takes the mix's
``trace_steps`` under the profiler instead. Once a window has closed, one
step more through ``run_step`` holds each slice's fields as the slice step
leaves them, and the check runs the reference on that step (``check.py``).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import torch

from .. import beam as beam_mod
from .. import check
from ..reference import qsa
from ..trace import K1Calls, Spans, TraceRun, device_events, profiled

FLOATS = ("x", "y", "z", "ux", "uy", "uz", "w")


class Run:
    """One cell's run: set_up, then window or traced, then compare."""

    rate_metric = "slices_per_s"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.dtype = dtype or getattr(torch, cfg["dtype"])
        self.dk = qsa.Deck.from_config(cfg)
        self.folder = tempfile.mkdtemp(prefix="hipace_bench_")
        self.sim = self.res = self.prev = None
        self.step = 0
        # (what, seconds) of each part of the set-up, for stderr
        self.phases = []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def close(self):
        shutil.rmtree(self.folder, ignore_errors=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- set-up
    def set_up(self):
        t = time.perf_counter()

        def phase(what):
            nonlocal t
            self.sync()
            now = time.perf_counter()
            self.phases.append((what, now - t))
            t = now

        from hipace_tpu_torch.parser import Inputs
        from hipace_tpu_torch.pipeline.simulation import Simulation
        phase("import the program")
        beam = beam_mod.draw(self.cfg, self.seed, self.device)
        path = beam_mod.write_openpmd(beam, self.folder)
        phase("draw and write the beam")
        deck = "\n".join(self.cfg["deck"]).format(beam_file=path)
        self.sim = Simulation(Inputs(deck), device=self.device,
                              dtype=self.dtype, verbose=0)
        phase("build the Simulation (read the beam file, bin)")
        # the program's start, kept on the host for the check
        self.start = {k: v.cpu() for k, v in self.sim.binned.items()
                      if k in FLOATS + ("valid",)}
        for _ in range(self.mix["warmup_steps"]):
            self.advance()
        phase("warm-up steps")

    def advance(self):
        """One step through the program's run_step, carrying the beam and
        the time as its time loop does."""
        sim = self.sim
        if self.res is not None:
            sim.binned = self.res["binned"]
            sim.time += float(sim.dt)
        self.prev = sim.binned
        self.res = sim.run_step(self.step)
        self.step += 1

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        """Whole steps until `seconds` have passed on the host clock; the
        slices and seconds of the window, ended by a synchronize."""
        marks = [time.perf_counter()]
        while True:
            self.advance()
            marks.append(time.perf_counter())
            if marks[-1] - marks[0] >= seconds:
                break
        self.sync()
        wall = time.perf_counter() - marks[0]
        steps = len(marks) - 1
        # each step's seconds on the host clock, for stderr: run_step reads
        # its counts from the device at its end, so the host is at most a
        # few launches ahead there
        self.phases.append(("window steps (min, median, max)", sorted(
            b - a for a, b in zip(marks, marks[1:]))))
        return {"steps": steps, "slices": steps * self.dk.nz, "seconds": wall}

    def traced(self) -> TraceRun:
        """The mix's trace_steps under the profiler, each step and slice in a
        span of the benchmark's, K1's launch shapes recorded."""
        spans, k1 = Spans(), K1Calls()
        sim = self.sim
        inner_sweep = sim.sweep_slice
        sim.sweep_slice = spans.wrap(inner_sweep, "slice step")
        cycles = []
        try:
            with k1.installed(), profiled() as box:
                t0 = time.time_ns()
                for _ in range(self.mix["trace_steps"]):
                    with spans.span("time step"):
                        self.advance()
                    cycles += [int(c) for c in self.res["mg_cycles"]]
                self.sync()
                t1 = time.time_ns()
        finally:
            sim.sweep_slice = inner_sweep
        return TraceRun(events=device_events(box[0]), window=(t0, t1),
                        n_slices=self.mix["trace_steps"] * self.dk.nz,
                        spans=spans.spans, k1_calls=k1.calls,
                        mg_cycles=cycles, config=self.cfg)

    def peak_bytes(self) -> int:
        """The card's peak allocation since the run began."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_name(self) -> str:
        return torch.cuda.get_device_name(self.device)

    # ----------------------------------------------------------------- check
    def held_step(self) -> dict:
        """One step more through run_step, the window's own call, holding
        each slice's fields as the slice step leaves them in its carry
        (check.slice_fields), by islice."""
        sim, fields = self.sim, {}
        inner = sim.sweep_slice

        def sweep(st, islice, *args, **kwargs):
            emitted = inner(st, islice, *args, **kwargs)
            fields[islice] = check.slice_fields(st["carry"]["fields"],
                                                self.dk)
            return emitted

        sim.sweep_slice = sweep
        try:
            self.advance()
        finally:
            sim.sweep_slice = inner
        return fields

    def compare(self) -> dict:
        """The numbers compared: the start, and a step after the window
        against the reference run from the program's beam at its start. The
        program's state is freed first, but for what the check reads."""
        fields = self.held_step()
        out_binned, in_binned = self.res["binned"], self.prev
        self.sim = self.res = self.prev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        drawn = beam_mod.draw(self.cfg, self.seed, self.device)
        nums = {"start_gap": check.start_gap(self.start, drawn, self.dk)}
        nums.update(check.last_step(fields, out_binned, in_binned, self.dk))
        del nums["flat"]
        return nums
