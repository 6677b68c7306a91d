"""The traced window: the device's activities from torch.profiler (CUDA
activity only, so the host runs at its untraced pace), the benchmark's own
spans on the host clock, and what the per-layer readers read from them.

Timestamps are wall-clock nanoseconds (the profiler puts its device
activities on the host's clock; the spans are ``time.time_ns()``).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

from . import yardstick as ys


@dataclasses.dataclass
class TraceRun:
    """What a traced window left for the readers."""
    events: list            # (name, start_ns, end_ns) of device activities
    window: tuple           # (start_ns, end_ns)
    n_slices: int
    spans: list             # (name, start_ns, end_ns), the benchmark's
    k1_calls: list          # (C, lanes, NY, NX, itemsize) per K1 launch
    mg_cycles: list         # V-cycles of each traced slice's Bx/By solve
    config: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self):
        t0, t1 = self.window
        return [e for e in self.events if e[2] > t0 and e[1] < t1]

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran: the
        union of the activities' intervals."""
        t0, t1 = self.window
        busy, end = 0, t0
        for _, s, e in sorted((e for e in self.in_window()),
                              key=lambda e: e[1]):
            s, e = max(s, end), min(e, t1)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e9

    def gaps(self):
        """(start_ns, end_ns, name of the activity before) of every idle
        stretch of the device in the window."""
        t0, t1 = self.window
        out, end, before = [], t0, "window start"
        for name, s, e in sorted(self.in_window(), key=lambda e: e[1]):
            if s > end:
                out.append((end, s, before))
            if e > end:
                end, before = e, name
        if t1 > end:
            out.append((end, t1, before))
        return out


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of the profile's device activities."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in evs if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        # torch without the kineto results' accessors: the slower walk
        out = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                out.append((e.name, int(e.time_range.start * 1e3),
                            int(e.time_range.end * 1e3)))
        return out


@contextlib.contextmanager
def profiled():
    """torch.profiler over the device alone (the host's activity where
    torch has no CUDA: a rehearsal on the CPU, which records no device
    activity); yields a list that holds the profile once the block has
    ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    box = []
    act = (ProfilerActivity.CUDA if torch.cuda.is_available()
           else ProfilerActivity.CPU)
    with profile(activities=[act]) as prof:
        yield box
    box.append(prof)


class Spans:
    """The benchmark's spans on the host clock: around each call into the
    time step and into the slice step."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def wrap(self, fn, name):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


class K1Calls:
    """Records the shapes of each K1 launch while installed: the benchmark's
    wrapper around the port's launcher, which it leaves as it found it."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def installed(self):
        from hipace_tpu_torch.ops import deposit as dep
        inner = dep.deposit_cuda

        def recording(fields, ym, *args, **kwargs):
            C, NY, NX = fields.shape
            self.calls.append((C, ym.numel(), NY, NX, fields.element_size()))
            return inner(fields, ym, *args, **kwargs)

        dep.deposit_cuda = recording
        try:
            yield self
        finally:
            dep.deposit_cuda = inner


def groups_per_slice(run: TraceRun) -> dict:
    """Per group of yardstick.GROUPS: (device ms, activities) per slice."""
    ms, count = defaultdict(float), defaultdict(int)
    for name, s, e in run.in_window():
        g = ys.group_of(name)
        ms[g] += (e - s) / 1e6 / run.n_slices
        count[g] += 1
    return {g: (ms[g], count[g] / run.n_slices)
            for g in sorted(ms, key=lambda g: -ms[g])}


def breakdown(run: TraceRun, top: int = 10) -> dict:
    """The device activities that took the most time, and the longest idle
    stretches by what the host was doing: inside a slice, between slices
    of a step, or after a device-to-host read."""
    ops = defaultdict(float)
    for name, s, e in run.in_window():
        ops[name] += (e - s) / 1e9
    spans = sorted(run.spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle = defaultdict(float)
    for s, e, before in run.gaps():
        what = "between steps"
        # the innermost span that holds the gap's start: the latest
        # started one that has not ended
        for j in range(bisect.bisect_right(starts, s) - 1, -1, -1):
            name, a, b = spans[j]
            if s < b:
                what = name
                break
        if ys.DTOH in before:
            what += ", after a device-to-host read"
        idle[what] += (e - s) / 1e9
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top]}
