"""The readers of the program's own spans: a small configuration traced
through run_cell on the CPU reports the two host metrics and leaves out the
five device-clock ones (the CPU has no events); program_spans' arithmetic
on made-up spans."""

import types

import pytest

from benchmark import manifest, program_spans, run
from benchmark.trace import TraceRun

HOST = ("host_enqueue_ms_per_slice", "host_wait_ms_per_slice")
DEVICE = ("deposit_ms_per_slice", "solve_ms_per_slice",
          "plasma_push_ms_per_slice", "beam_push_ms_per_slice",
          "diag_fill_ms_per_slice")


def test_a_traced_cpu_run_reports_the_host_metrics(man, small):
    line, _ = run.run_cell(man, "explicit.2047", 11, 0.0, True,
                           device="cpu", cfg=small("explicit.2047"))
    assert line["correct"]
    got = line["metrics"]
    for name in HOST:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    assert not set(DEVICE) & set(got)
    assert {m["name"] for m in man.metrics("per_layer", "explicit.2047")} \
        >= set(HOST + DEVICE)


def _span(name, sid, parent, t0, t1, dev):
    return types.SimpleNamespace(name=name, sid=sid, parent=parent,
                                 start_ns=t0, end_ns=t1,
                                 host_ms=(t1 - t0) / 1e6, device_ms=dev)


SPANS = [_span("time step", 0, None, 10, 990, 0.9),
         _span("slice step", 1, 0, 20, 500, 0.4),
         _span("deposit", 2, 1, 30, 100, 0.1),
         _span("beam push", 3, 1, 100, 480, 0.25),
         _span("read: beam compaction", 4, 3, 400, 470, 0.05),
         _span("read: re-bin counts", 5, 0, 600, 700, 0.01)]


def made_up(cfg):
    # busy 0-35, 150-420, 800-1000: gaps at 35 (deposit), 420 (a read),
    # 1000 (none: the window's end)
    events = [("k", 0, 35), ("k", 150, 420), ("k", 800, 1000)]
    return TraceRun(events=events, window=(0, 1200), n_slices=2, spans=[],
                    k1_calls=[], mg_cycles=[], config=cfg)


def test_per_name_and_idle(small):
    rows = program_spans.per_name(SPANS)
    assert rows["slice step"]["count"] == 1
    assert rows["slice step"]["host_self_ms"] == pytest.approx(
        (480 - 70 - 380) / 1e6)
    assert rows["slice step"]["device_self_ms"] == pytest.approx(0.05)
    assert rows["beam push"]["device_self_ms"] == pytest.approx(0.2)
    tr = made_up(small("explicit.2047"))
    idle = program_spans.idle_by_span(tr, SPANS)
    assert idle == pytest.approx({"deposit": 115e-9,
                                  "read: beam compaction": 380e-9,
                                  program_spans.OUTSIDE: 200e-9})


def test_idle_anchored_at_the_reads(small):
    """The profile's device clock 400 ns ahead of the spans': anchored at
    the copy inside the read span, the gap after it is the read's."""
    d2h = "Memcpy DtoH (Device -> Pinned)"
    spans = [_span("time step", 0, None, 0, 3000, None),
             _span("beam push", 1, 0, 100, 1000, None),
             _span("read: beam compaction", 2, 1, 500, 700, None),
             _span("shift", 3, 0, 1000, 1500, None)]
    # on the spans' clock: a kernel 200-600, the copy 600-620, idle until
    # a kernel at 1600
    events = [("k", 600, 1000), (d2h, 1000, 1020), ("k", 2000, 2100)]
    tr = TraceRun(events=events, window=(0, 3000), n_slices=1, spans=[],
                  k1_calls=[], mg_cycles=[], config=small("explicit.2047"))
    assert program_spans.idle_by_span(tr, spans, anchored=False) == \
        pytest.approx({"time step": 1500e-9, "shift": 980e-9})
    assert program_spans.idle_by_span(tr, spans) == pytest.approx(
        {program_spans.OUTSIDE: 600e-9, "read: beam compaction": 980e-9,
         "time step": 900e-9})


def test_readers_on_made_up_spans(small, monkeypatch):
    tr = made_up(small("explicit.2047"))
    monkeypatch.setattr(program_spans, "window_spans", lambda run: SPANS)

    def read(name):
        return manifest.reader(name)(tr)

    assert read("deposit_ms_per_slice") == pytest.approx(0.05)
    assert read("beam_push_ms_per_slice") == pytest.approx(0.125)
    assert read("solve_ms_per_slice") is None
    # the slice step's 480 ns less its read's 70 ns, over 2 slices
    assert read("host_enqueue_ms_per_slice") == pytest.approx(410e-6 / 2)
    assert read("host_wait_ms_per_slice") == pytest.approx(170e-6 / 2)
