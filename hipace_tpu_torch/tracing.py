"""The port's spans: the named phases of the time step and the slice step,
timed on the host clock and, on the card, on CUDA events.

``span(name)`` is a context manager. Spans are on while a ``torch.profiler``
runs (its own enabled flag) and off otherwise; off, ``span`` returns one
shared no-op object, which allocates nothing and makes no CUDA call.

On, each span records its name, its parent (the innermost open span of the
thread), the step and the slice it belongs to (given where the span opens,
else its parent's), its start and end from ``time.time_ns()`` (the clock on
which the profiler places its device activities) and, where its device is a
card, two timing events recorded on that device's current stream at entry
and exit. Their elapsed time is the span's device-clock milliseconds: the
kernels it launched, and any idle of the device while the host launched
them. Events become milliseconds once they have completed: when a
top-level span ends (the time step's end follows its last read of the
device, so its spans are complete there), and when ``spans()`` is read;
their events then go back to a pool.

The spans of a run are kept in memory, the newest ``MAX_SPANS`` of them.
``spans()`` returns them without draining them; ``clear()`` drops them.

Inside ``named_ranges()``, which the CLI's ``hipace.profile`` opens around
its profiler of the host's activity, each span also enters
``torch.profiler.record_function`` of its name, so that the written trace
shows the spans as ranges. A profiler of the device alone (the benchmark's
traced window) gets no such ranges: they would add annotations to its
device activities.

Names: "time step", "plasma init", "slice step", "slice init", "deposit",
"field solve", "diagnostics", "plasma push", "beam push", "shift", "re-bin",
"output", "ring exchange", "ring wait"; the optional paths' "laser: envelope
advance", "laser: |a|^2 gather", "ionization module", "collisions",
"SALAME", "MR: level init", "MR: level deposits", "MR: level Psi/Ez/Bz",
"MR: level Bx/By"; and "read: <site>" around each read of the device that
the host waits for. No span opens inside a loop over lanes, subcycles or
predictor-corrector iterations.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# the newest spans kept
MAX_SPANS = 200_000
# spans whose events wait to be read, at most; beyond, the oldest waits
MAX_PENDING = 8192

_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_pending: collections.deque = collections.deque()
_pool: dict = {}
_streams: dict = {}
_ids = itertools.count()
_local = threading.local()
_ranges = 0


class _Off:
    """The shared span of a run that is not profiled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span. start_ns and end_ns on the host clock
    (``time.time_ns()``; end_ns None while it is open); device_ms the
    device-clock milliseconds between its events, None where it ran on no
    card or they have not been read yet; parent the sid of the enclosing
    span, None at the top."""

    __slots__ = ("name", "sid", "parent", "step", "slice", "device",
                 "start_ns", "end_ns", "device_ms", "_events", "_range")

    def __init__(self, name, step, slice, device):
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.name = name
        self.sid = next(_ids)
        self.step, self.slice, self.device = step, slice, device
        self.parent = None
        self.end_ns = self.device_ms = self._events = self._range = None
        self.start_ns = 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        stack = _stack()
        if stack:
            up = stack[-1]
            self.parent = up.sid
            if self.step is None:
                self.step = up.step
            if self.slice is None:
                self.slice = up.slice
            if self.device is None:
                self.device = up.device
        stack.append(self)
        _records.append(self)
        if _ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            stream = _stream(dev)
            self._events = (_event(dev), _event(dev), stream)
            self._events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._events[2])
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._events is not None:
            _pending.append(self)
            if len(_pending) > MAX_PENDING:
                _resolve(_pending.popleft(), wait=True)
        if not stack:
            _resolve_done()
        return False


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _stream(dev):
    """The device's current stream: the object kept from the last call
    while the stream is the same (building one costs ~10 us)."""
    raw = torch._C._cuda_getCurrentRawStream(dev.index)
    kept = _streams.get(dev)
    if kept is None or kept[0] != raw:
        kept = _streams[dev] = (raw, torch.cuda.current_stream(dev))
    return kept[1]


def _event(dev):
    free = _pool.get(dev)
    if free:
        return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _resolve(sp: Span, wait: bool) -> bool:
    """Read a span's device milliseconds from its events and give them
    back to the pool; False where its end has not completed (and wait is
    off)."""
    ev0, ev1, _ = sp._events
    if not wait and not ev1.query():
        return False
    ev1.synchronize()
    sp.device_ms = ev0.elapsed_time(ev1)
    sp._events = None
    _pool.setdefault(sp.device, []).extend((ev0, ev1))
    return True


def _resolve_done() -> None:
    """The spans whose events have completed, oldest first, per device: a
    stream completes its events in order, so each device's first span not
    complete ends its turn."""
    blocked = set()
    keep = collections.deque()
    while _pending:
        sp = _pending.popleft()
        if sp.device in blocked or not _resolve(sp, wait=False):
            blocked.add(sp.device)
            keep.append(sp)
    _pending.extend(keep)


def span(name: str, step: int | None = None, slice: int | None = None,
         device=None):
    """A span named `name`: the shared no-op where no profiler runs. step,
    slice and device default to the enclosing span's; device is where its
    events are recorded (none on the CPU)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, step, slice, device)


def traced(name: str):
    """Decorate a function so that each call runs inside span(name)."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorate


def spans() -> list:
    """The recorded spans that have ended, in the order they started, each
    with its device milliseconds read (waiting for the device where it has
    not reached them)."""
    while _pending:
        _resolve(_pending.popleft(), wait=True)
    return [s for s in _records if s.end_ns is not None]


def clear() -> None:
    """Drop every recorded span."""
    spans()
    _records.clear()


@contextlib.contextmanager
def named_ranges():
    """Inside, every span also enters torch.profiler.record_function of its
    name: for a profiler that records the host's activity."""
    global _ranges
    _ranges += 1
    try:
        yield
    finally:
        _ranges -= 1
