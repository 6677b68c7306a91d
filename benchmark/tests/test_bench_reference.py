"""The plain reference against the port's CPU path, on a small grid of each
configuration in float64: a whole run of the cell (set-up, window, check)
on the CPU, and the reference's step against the port's first step."""

import pytest
import torch

from benchmark import check, run
from benchmark.reference import qsa
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

CELLS = ("explicit.2047",)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_cpu_is_correct(man, small, cell):
    line, lines = run.run_cell(man, cell, 2**33 + 5, 0.0, False,
                               device="cpu", cfg=small(cell))
    assert line["correct"], lines
    checks = line["checks"]
    assert checks["start_gap"]["value"] == 0.0
    assert checks["fields_gap"]["value"] < 1e-12
    assert checks["beam_gap"]["value"] < 1e-13
    assert line["attempted"] == 8 and line["metrics"]["slices_per_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_step_against_the_port(man, small, cell, tmp_path):
    """Step 0 of the port from its own fixed_weight beam against the
    reference from the same lanes: every compared field of every slice, as
    the slice step leaves it in its carry, the V-cycles of each slice, and
    the beam it leaves."""
    cfg = small(cell, nxy=63, nz=8, npart=3000)
    deck = "\n".join(cfg["deck"]).replace(
        "beam.injection_type = from_file", "\n".join([
            "beam.injection_type = fixed_weight",
            "beam.num_particles = 3000", "beam.profile = gaussian",
            "beam.position_mean = 0. 0. -1.",
            "beam.position_std = 0.3 0.3 1.41", "beam.zmin = -5.9",
            "beam.zmax = 1.9", "beam.density = 3.",
            "beam.u_mean = 0. 0. 2000."])).format(beam_file="")
    sim = Simulation(Inputs(deck), device="cpu", verbose=0)
    b = sim.binned
    flat = {k: b[k][b["valid"]] for k in qsa.BEAM_FLOAT + ("nsub",)}
    flat["valid"] = torch.ones_like(flat["x"], dtype=torch.bool)
    dk = qsa.Deck.from_config(cfg)
    held, inner = {}, sim.sweep_slice

    def sweep(st, islice, *args):
        emitted = inner(st, islice, *args)
        held[islice] = check.slice_fields(st["carry"]["fields"], dk)
        return emitted

    sim.sweep_slice = sweep
    res = sim.run_step(0)
    assert sorted(held) == list(range(dk.nz))
    step = qsa.Step(dk, "cpu", torch.float64)
    sweep = step.run(flat)
    worst = 0.0
    while True:
        try:
            isl, this = next(sweep)
        except StopIteration as done:
            out = done.value
            break
        for c, p in held[isl].items():
            r = qsa.interior(this[c], dk)
            scale = max(float(r.abs().max()), 1e-300)
            worst = max(worst, float((p - r).abs().max()) / scale)
    assert worst < 1e-12
    assert step.cycles == res["mg_cycles"]
    rb = qsa.bin_beam(out, dk)
    pb = res["binned"]
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        p = torch.cat([pb[k][i][pb["valid"][i]] for i in range(dk.nz)])
        r = torch.cat([s[k] for s in rb])
        assert p.shape == r.shape
        assert float((p - r).abs().max()) <= 1e-12 * float(r.abs().max())
