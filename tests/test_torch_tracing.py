"""The port's spans (``hipace_tpu_torch/tracing.py``) on the CPU: off
without a profiler, where ``span`` returns the shared no-op and nothing is
recorded; under ``torch.profiler`` the span tree of a step of the
benchmark's ``transverse_explicit`` configuration cut to 31^2 x 8 (names,
parents, step and slice ids, one "read:" span per read of the device);
fields and beam equal bit for bit with the spans on and off; and a
two-rank gloo run under ``hipace.profile`` that writes the ring's spans
into each rank's trace."""

import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import beam as bench_beam
from benchmark import manifest
from benchmark.tests.conftest import small_config
from hipace_tpu_torch import tracing
from hipace_tpu_torch.parallel import ranks
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
CPU = torch.device("cpu")
NZ = 8
SLICE_SPANS = ("slice init", "deposit", "field solve", "diagnostics",
               "plasma push", "beam push", "shift")


def _sim(tmp_path):
    """The configuration's deck at 31^2 x 8 on the CPU, its beam drawn and
    written as the benchmark does."""
    cfg = small_config(manifest.Manifest().config("transverse_explicit"),
                       nz=NZ)
    path = bench_beam.write_openpmd(bench_beam.draw(cfg, 5, CPU),
                                    str(tmp_path))
    deck = "\n".join(cfg["deck"]).format(beam_file=path)
    return Simulation(Inputs(deck), device="cpu", dtype=torch.float64,
                      verbose=0)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Step 0 of two simulations of the same deck and beam: one under the
    profiler (its spans), one without."""
    tmp = tmp_path_factory.mktemp("tracing")
    tracing.clear()
    off = _sim(tmp).run_step(0)
    recorded_off = tracing.spans()
    sim = _sim(tmp)
    with profile(activities=[ProfilerActivity.CPU]):
        on = sim.run_step(0)
    spans = tracing.spans()
    tracing.clear()
    return off, on, spans, recorded_off


def test_off_is_the_shared_no_op(steps):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("slice step") is tracing.OFF
    assert tracing.span("deposit", step=1, slice=2) is tracing.OFF
    # a whole step without a profiler recorded nothing
    assert steps[3] == []


def test_the_span_tree_of_a_step(steps):
    spans = steps[2]
    by_id = {s.sid: s for s in spans}
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["time step"]
    step = top[0]

    def parent(s):
        return by_id[s.parent].name

    assert all(s.step == 0 for s in spans)
    # no events on the CPU
    assert all(s.device == CPU and s.device_ms is None for s in spans)
    for s in spans:
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    for name in ("plasma init", "slice step", "read: step counts", "re-bin"):
        assert {parent(s) for s in spans if s.name == name} == {"time step"}
    slices = [s for s in spans if s.name == "slice step"]
    # the sweep runs from the head, slice nz - 1, to the tail
    assert [s.slice for s in slices] == list(range(NZ - 1, -1, -1))
    for sl in slices:
        inner = [s for s in spans if s.parent == sl.sid]
        # SliceStep's spans in code order (deposit and field solve twice:
        # the beam's Next deposit and the Bx/By solve after the Psi solve),
        # then the copies into the step's buffers
        assert [s.name for s in inner] == [
            "slice init", "deposit", "field solve", "deposit", "field solve",
            "diagnostics", "plasma push", "beam push", "shift",
            "diagnostics"]
        assert all(s.slice == sl.slice for s in inner)
        for s in inner:
            assert sl.start_ns <= s.start_ns <= s.end_ns <= sl.end_ns
    reads = [s for s in spans if s.name == "read: beam compaction"]
    assert {parent(s) for s in reads} == {"beam push"}
    assert {parent(s) for s in spans
            if s.name == "read: re-bin counts"} == {"re-bin"}
    assert set(Counter(s.name for s in spans)) == {
        "time step", "plasma init", "slice step", "read: step counts",
        "re-bin", "read: beam compaction", "read: re-bin counts",
        *SLICE_SPANS}


def test_one_read_span_per_read_of_the_device(steps):
    """Two per slice (the beam's compaction), the step's counts and the
    re-binning's two: the device-to-host copies of a step on the card."""
    reads = Counter(s.name for s in steps[2] if s.name.startswith("read: "))
    assert sum(reads.values()) == 2 * NZ + 3
    assert reads == {"read: beam compaction": 2 * NZ,
                     "read: step counts": 1, "read: re-bin counts": 2}


def test_spans_change_no_result(steps):
    off, on = steps[0], steps[1]
    assert torch.equal(off["diag"], on["diag"])
    assert off["mg_cycles"] == on["mg_cycles"]
    for k, v in off["binned"].items():
        if torch.is_tensor(v):
            assert torch.equal(v, on["binned"][k]), k
        else:
            assert v == on["binned"][k], k


def test_spans_are_kept_until_cleared():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("time step", step=3):
            with tracing.span("read: x", slice=1):
                pass
    first = tracing.spans()
    assert [(s.name, s.step, s.slice) for s in first] == [
        ("time step", 3, None), ("read: x", 3, 1)]
    assert first[1].parent == first[0].sid
    # reading does not drain
    assert tracing.spans() == first
    tracing.clear()
    assert tracing.spans() == []


RING_DECK = """
amr.n_cell = 15 15 8
hipace.normalized_units = 1
max_step = 1
hipace.dt = 2.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -6. -6. -6.
geometry.prob_hi =  6.  6.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 500
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -5.
beam.zmax = 1.8
beam.density = 1.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def test_ranks_write_the_ring_spans(tmp_path):
    """Two gloo ranks under hipace.profile, one window: each rank's trace
    holds its ring exchanges and their waits, and its slice steps."""
    trace = tmp_path / "trace"
    job = ranks.Job(RING_DECK + f"hipace.profile = {trace}\n", cli=True,
                    workdir=str(tmp_path / "work"), verbose=0)
    ranks.spawn(job, [CPU] * 2, timeout=120.0, tmp=tmp_path, threads=1)
    files = sorted(trace.glob("*.pt.trace.json"))
    assert len(files) == 2
    for path in files:
        names = Counter(e.get("name") for e in
                        json.loads(path.read_text())["traceEvents"])
        # one exchange per tick (nz + 2 ticks) and one for the slip carry
        assert names["ring exchange"] == NZ + 2 + 1
        assert names["ring wait"] == 2 * names["ring exchange"]
        assert names["slice step"] == NZ
        assert names["time step"] == 1
