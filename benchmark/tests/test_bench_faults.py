"""A run with the timed path broken underneath reads correct = false: once
for each fault these single-card cells can have (a step that returns its
state unchanged; half of the plasma's lanes left out, the rest weighed
double; a field altered where the slice step produces it, in its carry).
The cells run on one card, so no exchange between cards can be left
out."""

import pytest
import torch

from benchmark import run
from hipace_tpu_torch.particles import plasma as pl
from hipace_tpu_torch.pipeline import step as stp
from hipace_tpu_torch.pipeline.simulation import Simulation

CELLS = ("explicit.2047",)


def _run(man, small, cell):
    line, lines = run.run_cell(man, cell, 2**32 + 77, 0.0, False,
                               device="cpu", cfg=small(cell))
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(man, small, cell, monkeypatch):
    inner = Simulation.run_step

    def unchanged(self, step):
        res = inner(self, step)
        res["binned"] = self.binned
        return res

    monkeypatch.setattr(Simulation, "run_step", unchanged)
    line = _run(man, small, cell)
    assert not line["correct"]
    assert line["checks"]["beam_gap"]["value"] != 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_plasma_left_out(man, small, cell, monkeypatch):
    def halved(fn):
        def wrapped(p, *args, **kwargs):
            w = p["w"].clone()
            w[1::2] = 0.0
            w[0::2] *= 2.0
            return fn(dict(p, w=w), *args, **kwargs)
        return wrapped

    monkeypatch.setattr(pl, "fused_plasma_deposits",
                        halved(pl.fused_plasma_deposits))
    monkeypatch.setattr(pl, "deposit_plasma", halved(pl.deposit_plasma))
    line = _run(man, small, cell)
    assert not line["correct"]
    assert line["checks"]["fields_gap"]["value"] > 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_a_field_altered_where_produced(man, small, cell, monkeypatch):
    inner = stp.SliceStep.__call__

    def altered(self, carry, islice, *args, **kwargs):
        carry, out = inner(self, carry, islice, *args, **kwargs)
        if islice == 3:
            f = carry["fields"]
            this = dict(f["This"], Ez=f["This"]["Ez"] * (1.0 + 1e-2))
            carry = dict(carry, fields=dict(f, This=this))
        return carry, out

    monkeypatch.setattr(stp.SliceStep, "__call__", altered)
    line = _run(man, small, cell)
    assert not line["correct"]
    assert line["checks"]["fields_gap"]["value"] > 1e-3


def test_sound_run_is_correct(man, small):
    assert _run(man, small, "explicit.2047")["correct"]
    assert torch.get_default_dtype() == torch.float32
