"""Traffic kind ``laser_steps``: the serial time loop of one process on one
card for a deck driven by a laser envelope, with no beam:
whole steps back to back, the time carried from step to step and the
envelope stream (n00, nm1) as ``Simulation.run_step`` carries it.

Set-up builds the ``Simulation`` from the configuration's deck (which
draws nothing at random: the seed is recorded and draws nothing) and
takes the mix's warm-up steps through ``run_step``, the window's own call;
after step 0 it compares the envelope that step formed from the deck's
pulse with the reference's (``check_laser.start_gap``). The window and the
traced window are ``serial_steps``'; the traced window also records the
envelope solve's V-cycles per slice (``laser_cycles``). Once a window has
closed, one step more through ``run_step`` holds each slice's fields on
the host as the slice step leaves them, and the check runs the reference
on that step from the program's stream at its start (``check_laser.py``).
"""

from __future__ import annotations

import math
import time

import torch

from .. import check_laser
from ..reference import laser
from . import serial_steps

# where the held step's fields wait for the reference: the host, beside
# which the card keeps only the streams the check reads
HOLD = torch.device("cpu")


class Run(serial_steps.Run):
    """One cell's run: set_up, then window or traced, then compare."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, dtype=None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.dtype = dtype or getattr(torch, cfg["dtype"])
        self.ld = laser.LaserDeck.from_config(cfg)
        self.dk = self.ld.dk
        self.sim = self.res = self.prev = None
        self.step = 0
        self.phases = []
        self.start_gap = math.inf
        # the envelope solves' V-cycles of the steps taken while recording
        self.recording = None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def close(self):
        pass

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
        self.sim = Simulation(Inputs("\n".join(self.cfg["deck"])),
                              device=self.device, dtype=self.dtype,
                              verbose=0)
        phase("build the Simulation")
        for i in range(self.mix["warmup_steps"]):
            self.advance()
            if i == 0:
                # the stream's nm1 after step 0 is step 0's n00
                self.start_gap = check_laser.start_gap(
                    self.sim.laser_stream[1], self.ld)
        phase("warm-up steps")

    def advance(self):
        super().advance()
        if self.recording is not None:
            self.recording += [int(c) for c in self.res["laser_cycles"]]

    def traced(self):
        self.recording = []
        try:
            tr = super().traced()
        finally:
            cycles, self.recording = self.recording, None
        tr.laser_cycles = cycles
        return tr

    # ----------------------------------------------------------------- check
    def held_step(self) -> dict:
        """One step more through run_step, holding each slice's fields on
        the host as the slice step leaves them in its carry, by islice."""
        sim, fields = self.sim, {}
        inner = sim.sweep_slice

        def sweep(st, islice, *args, **kwargs):
            emitted = inner(st, islice, *args, **kwargs)
            fields[islice] = check_laser.slice_fields(st["carry"]["fields"],
                                                      self.dk, HOLD)
            return emitted

        sim.sweep_slice = sweep
        try:
            self.advance()
        finally:
            sim.sweep_slice = inner
        return fields

    def compare(self) -> dict:
        """The numbers compared: the start, and a step after the window
        against the reference run from the program's envelope stream at its
        start. The program's state is freed first, but for what the check
        reads."""
        stream, step = self.sim.laser_stream, self.step
        fields = self.held_step()
        np1 = self.sim.laser_stream[0]
        nums = {"start_gap": self.start_gap,
                "beam_gap": check_laser.beam_gap(self.res["binned"])}
        self.sim = self.res = self.prev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        nums.update(check_laser.last_step(fields, np1, stream, step,
                                          self.ld))
        return nums
