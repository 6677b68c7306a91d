"""The program's own spans inside a traced window, for the per-layer metrics
of source ``program_span``.

The port records its spans (``hipace_tpu_torch/tracing.py``: the phases of
the time step and the slice step, and each read of the device) while a
profiler runs, so the traced window holds them. Each span has its host
milliseconds, from ``time.time_ns()`` at its ends (the clock of the
window), and, on the card, its
device-clock milliseconds, from the CUDA events at its ends: the kernels
it launched and the device's idle between them. A program without the
module gives None here, and the readers report nothing.

The profiler places its device activities on the host clock by its own
conversion, which can stray from ``time.time_ns()`` by milliseconds within
one window. ``idle_by_span`` therefore maps the device's times onto the
spans' clock through the reads: the host waits inside each "read:" span
for its device-to-host copy, so each copy lies inside its span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import yardstick as ys

READ = "read: "
OUTSIDE = "outside the program's spans"


def window_spans(run):
    """The program's spans that lie inside the run's window, in the order
    they started; None where the program records none."""
    try:
        from hipace_tpu_torch import tracing
    except ImportError:
        return None
    t0, t1 = run.window
    return [s for s in tracing.spans() if t0 <= s.start_ns and s.end_ns <= t1]


def _children(spans) -> dict:
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def per_name(spans) -> dict:
    """Per span name: its count, host ms and device-clock ms (None where a
    span has no device time), and both less the time of the spans nested
    directly inside (self times)."""
    kids = _children(spans)
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                      "host_self_ms": 0.0, "device_ms": 0.0,
                                      "device_self_ms": 0.0})
        inner = kids.get(s.sid, ())
        row["count"] += 1
        row["host_ms"] += s.host_ms
        row["host_self_ms"] += s.host_ms - sum(k.host_ms for k in inner)
        if s.device_ms is None or row["device_ms"] is None:
            row["device_ms"] = row["device_self_ms"] = None
            continue
        row["device_ms"] += s.device_ms
        row["device_self_ms"] += s.device_ms - sum(k.device_ms or 0.0
                                                   for k in inner)
    return out


def device_ms_per_slice(run, *names):
    """Device-clock ms per slice of the window's spans named `names`; None
    where there are none, or they have no device time (the CPU)."""
    spans = window_spans(run)
    if not spans:
        return None
    mine = [s for s in spans if s.name in names]
    if not mine or any(s.device_ms is None for s in mine):
        return None
    return sum(s.device_ms for s in mine) / run.n_slices


def reads_inside(spans, top) -> list:
    """The "read:" spans nested at any depth inside the span top."""
    kids = _children(spans)
    out, todo = [], [top]
    while todo:
        for k in kids.get(todo.pop().sid, ()):
            todo.append(k)
            if k.name.startswith(READ):
                out.append(k)
    return out


def device_to_host(run, spans):
    """A map of the profile's device times onto the spans' host clock: the
    n-th device-to-host copy of the window belongs in the n-th "read:"
    span, each pair gives the offset that puts the copy in the middle of
    the room its span leaves, and between pairs the offset is interpolated
    (held beyond them). The identity where the counts differ."""
    reads = sorted((s for s in spans if s.name.startswith(READ)),
                   key=lambda s: s.start_ns)
    copies = sorted((e for e in run.in_window() if ys.DTOH in e[0]),
                    key=lambda e: e[1])
    if not reads or len(reads) != len(copies):
        return lambda t: t
    at = [a for _, a, _ in copies]
    off = [(r.start_ns - a + r.end_ns - b) / 2
           for r, (_, a, b) in zip(reads, copies)]

    def shift(t):
        i = bisect.bisect_right(at, t)
        if i == 0 or i == len(at):
            return t + off[min(i, len(at) - 1)]
        w = (t - at[i - 1]) / (at[i] - at[i - 1])
        return t + off[i - 1] + w * (off[i] - off[i - 1])
    return shift


def idle_by_span(run, spans, anchored: bool = True) -> dict:
    """Seconds of the window's device idle (run.gaps()) per program span:
    each gap goes to the innermost span that held its start on the host
    clock, the latest started one that had not ended; the gap's start
    through device_to_host where anchored."""
    shift = device_to_host(run, spans) if anchored else (lambda t: t)
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    idle = defaultdict(float)
    for a, b, _ in run.gaps():
        what, t = OUTSIDE, shift(a)
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t < spans[j].end_ns:
                what = spans[j].name
                break
        idle[what] += (b - a) / 1e9
    return dict(idle)
