"""The laser's spans (``hipace_tpu_torch/tracing.py``) on the CPU: a step of
``LASER_WAKE`` at 31^2 x 8 under ``torch.profiler`` puts the slice's
envelope row and |a|^2 plane under "laser: slice init" inside "slice init",
the envelope advance inside "field solve", the deposit's |a|^2 gather inside
"deposit" and the slice's rows of the next step's stream under "laser:
stream rows" inside "slice step", one of each per slice; the stream and the
fields are equal bit for bit with the spans on and off."""

from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from hipace_tpu_torch import tracing
from hipace_tpu_torch.decks import laser_wake
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
NZ = 8


def _step():
    return Simulation(laser_wake(31, NZ), device="cpu", dtype=torch.float64,
                      verbose=0).run_step(0)


def test_laser_spans_of_a_step():
    tracing.clear()
    off = _step()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _step()
    spans = tracing.spans()
    tracing.clear()
    by_id = {s.sid: s for s in spans}
    laser = Counter((s.name, by_id[s.parent].name) for s in spans
                    if s.name.startswith("laser: "))
    assert laser == {("laser: slice init", "slice init"): NZ,
                     ("laser: |a|^2 gather", "deposit"): NZ,
                     ("laser: envelope advance", "field solve"): NZ,
                     ("laser: stream rows", "slice step"): NZ}
    for s in spans:
        if s.name.startswith("laser: "):
            up = by_id[s.parent]
            assert s.slice == up.slice
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    for a, b in zip(off["laser_stream"], on["laser_stream"]):
        assert torch.equal(a, b)
    assert torch.equal(off["diag"], on["diag"])
    assert off["laser_cycles"] == on["laser_cycles"]
