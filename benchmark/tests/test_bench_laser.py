"""The laser envelope configuration (``laser.2047``) on the CPU at 63^2 x 16
in float64: the plain reference (``reference/laser.py``) against the
port's step, cold and with a seeded plasma temperature; a whole
``laser_steps`` run; the faults that must read correct = false; the new
readers on a made-up trace; the frozen complex K3 counts; a run that loads
no JAX. On the card (``-m gpu``): the float32 control at the cell's own
size reads correct = false and the program, float64, true."""

import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import check_laser, manifest, program_spans, run
from benchmark import yardstick_laser as ysl
from benchmark.reference import laser, qsa
from benchmark.tests.conftest import small_config
from benchmark.trace import TraceRun
from hipace_tpu_torch.particles import plasma as pl
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline import step as stp
from hipace_tpu_torch.pipeline.simulation import Simulation

CELL = "laser.2047"
ROOT = Path(__file__).resolve().parents[2]


def laser_config(man, nxy: int = 63, nz: int = 16) -> dict:
    return small_config(man.config(man.cell(CELL)["config"]), nxy, nz)


def _run(man, cfg=None, trace=False):
    line, lines = run.run_cell(man, CELL, 2**32 + 19, 0.0, trace,
                               device="cpu", cfg=cfg or laser_config(man))
    return line, lines


def test_cell_on_the_cpu_is_correct(man):
    line, lines = _run(man)
    assert line["correct"], lines
    checks = line["checks"]
    assert checks["start_gap"]["value"] < 1e-15
    assert checks["fields_gap"]["value"] < 1e-10
    assert checks["beam_gap"]["value"] == 0.0
    assert line["attempted"] == 16 and line["metrics"]["slices_per_s"]


@pytest.mark.parametrize("temperature", [None, "0.05 0.05 0.05"])
def test_reference_steps_against_the_port(man, temperature):
    """Steps 0 and 1 of the port against the reference's, each from the
    port's envelope stream and plasma at the step's start: every compared
    field of every slice as the slice step leaves it, the advanced
    envelope, the V-cycles of both solves. With a temperature the lanes
    leave their lattice from the first slice on."""
    cfg = laser_config(man)
    deck = "\n".join(cfg["deck"]) + (
        f"\nplasma.u_std = {temperature}" if temperature else "")
    sim = Simulation(Inputs(deck), device="cpu", dtype=torch.float64,
                     verbose=0)
    ld = laser.LaserDeck.from_config(cfg)
    held, start = {}, {}
    inner_sweep, inner_state = sim.sweep_slice, sim.step_state

    def sweep(st, islice, *args):
        emitted = inner_sweep(st, islice, *args)
        held[islice] = check_laser.slice_fields(st["carry"]["fields"],
                                                ld.dk, "cpu")
        return emitted

    def state(*args, **kwargs):
        st = inner_state(*args, **kwargs)
        start["plasma"] = {k: v.clone() for k, v
                           in st["carry"]["plasma"][0].items()}
        return st

    sim.sweep_slice, sim.step_state = sweep, state
    for step in (0, 1):
        nz = ld.dk.nz
        stream = sim.laser_stream or tuple(
            torch.zeros((nz,) + ld.dk.shape, dtype=torch.complex128)
            for _ in range(2))
        res = sim.run_step(step)
        sim.binned = res["binned"]
        sim.time += float(sim.dt)
        ref = laser.Step(ld, "cpu", torch.float64)
        worst = 0.0
        for isl, this, np1 in ref.run(stream, step, start["plasma"]):
            pairs = [(held[isl][c], qsa.interior(this[c], ld.dk))
                     for c in held[isl]]
            pairs.append((sim.laser_stream[0][isl], np1))
            for p, r in pairs:
                scale = max(float(r.abs().max()), 1e-300)
                worst = max(worst, float((p - r).abs().max()) / scale)
        assert worst < 1e-10, (step, worst)
        assert ref.cycles == res["mg_cycles"]
        assert ref.laser_cycles == res["laser_cycles"]
        # the envelope is there and moves
        assert float(sim.laser_stream[0].abs().max()) > 1.0
    if temperature:
        assert float(start["plasma"]["ux"].abs().max()) > 0.05


def test_start_gap_reads_the_initial_envelope(man):
    ld = laser.LaserDeck.from_config(laser_config(man, 31, 8))
    rows = torch.stack([laser.envelope_slice(ld, i, torch.float64, "cpu")
                        for i in range(8)])
    assert check_laser.start_gap(rows, ld) == 0.0
    rows[3] *= 1.0 + 1e-6
    assert check_laser.start_gap(rows, ld) > 1e-7


def _altered_slice_step(monkeypatch, alter):
    inner = stp.SliceStep.__call__

    def altered(self, carry, islice, *args, **kwargs):
        carry, out = inner(self, carry, islice, *args, **kwargs)
        return alter(carry, out, islice)

    monkeypatch.setattr(stp.SliceStep, "__call__", altered)


def test_a_field_altered_where_produced(man, monkeypatch):
    def alter(carry, out, islice):
        if islice == 7:
            f = carry["fields"]
            this = dict(f["This"], Ez=f["This"]["Ez"] * (1.0 + 1e-2))
            carry = dict(carry, fields=dict(f, This=this))
        return carry, out

    _altered_slice_step(monkeypatch, alter)
    line, lines = _run(man)
    assert not line["correct"]
    assert line["checks"]["fields_gap"]["value"] > 1e-3


def test_an_envelope_slice_altered(man, monkeypatch):
    def alter(carry, out, islice):
        if islice == 8:
            out = dict(out, laser_np1=out["laser_np1"] * (1.0 + 1e-2))
        return carry, out

    _altered_slice_step(monkeypatch, alter)
    line, lines = _run(man)
    assert not line["correct"]
    assert line["checks"]["fields_gap"]["value"] > 1e-3
    assert "worst field laser_np1" in "\n".join(lines)


def test_the_push_without_its_laser_terms(man, monkeypatch):
    def dropped(x, y, aabs, geom, order, lnorm, pc):
        z = torch.zeros_like(x)
        return z, z, z

    monkeypatch.setattr(pl, "_laser_terms", dropped)
    line, lines = _run(man)
    assert not line["correct"]
    assert line["checks"]["fields_gap"]["value"] > 1e-3


def test_a_beam_lane_in_the_program_fails():
    binned = {"valid": torch.zeros((4, 3), dtype=torch.bool)}
    assert check_laser.beam_gap(binned) == 0.0
    binned["valid"][2, 1] = True
    assert check_laser.beam_gap(binned) == float("inf")


def test_a_traced_cpu_run_reads_the_laser_counter(man):
    line, lines = _run(man, laser_config(man, 31, 8), trace=True)
    assert line["correct"], lines
    got = line["metrics"]
    assert got["laser_vcycles_per_slice"]["value"] == 1.0
    # no device: the device-clock and device-trace readers read nothing
    for name in ("laser_advance_ms_per_slice", "aabs_gather_ms_per_slice",
                 "k3_complex_roofline_pct"):
        assert name not in got


def _span(name, sid, parent, t0, t1, dev):
    return types.SimpleNamespace(name=name, sid=sid, parent=parent,
                                 start_ns=t0, end_ns=t1,
                                 host_ms=(t1 - t0) / 1e6, device_ms=dev)


K3C = ("void hipace::mg_solve_kernel<double, false, true, 1024>"
       "(hipace::MgParams<double, true>)")
K3R = ("void hipace::mg_solve_kernel<double, false, false, 1024>"
       "(hipace::MgParams<double, false>)")


def test_readers_on_a_made_up_trace(man, monkeypatch):
    cfg = laser_config(man, 2047, 2)
    spans = [_span("slice step", 0, None, 0, 500, 4.0),
             _span("laser: |a|^2 gather", 1, 0, 10, 60, 0.7),
             _span("laser: envelope advance", 2, 0, 100, 200, 1.5),
             _span("slice step", 3, None, 500, 990, 4.0),
             _span("laser: |a|^2 gather", 4, 3, 510, 560, 0.9),
             _span("laser: envelope advance", 5, 3, 600, 700, 1.7)]
    monkeypatch.setattr(program_spans, "window_spans", lambda run: spans)
    # two complex solves of 1.5 ms each, one real one: only the complex
    # ones count
    events = [(K3C, 0, 1_500_000), (K3R, 1_500_000, 3_000_000),
              (K3C, 3_000_000, 4_500_000)]
    tr = TraceRun(events=events, window=(0, 5_000_000), n_slices=2,
                  spans=[], k1_calls=[], mg_cycles=[3, 3], config=cfg)

    def read(name):
        return manifest.reader(name)(tr)

    assert read("k3_complex_roofline_pct") is None
    tr.laser_cycles = [1, 2]
    assert read("laser_vcycles_per_slice") == pytest.approx(1.5)
    assert read("laser_advance_ms_per_slice") == pytest.approx(1.6)
    assert read("aabs_gather_ms_per_slice") == pytest.approx(0.8)
    least = sum(ysl.k3_complex_counts(2047, 2047, c, 8)[0] / 3.35e12
                for c in (1, 2))
    assert read("k3_complex_roofline_pct") == pytest.approx(
        100.0 * least / 3e-3)
    tr.laser_cycles = [1]
    assert read("k3_complex_roofline_pct") is None
    tr.laser_cycles = [0, 0]
    assert read("laser_vcycles_per_slice") is None


def test_complex_k3_counts_by_hand():
    # chip_smoke.py's complex bound: 29.303 MB for one V-cycle at 1023^2
    # in float32
    nbytes, _ = ysl.k3_complex_counts(1023, 1023, 1, 4)
    assert nbytes == 4 * (7 * 1023 * 1023 + 1)
    assert round(nbytes / 1e6, 3) == 29.303
    cells = 31 * 15 + 15 * 7 + 7 * 3
    assert ysl.k3_complex_counts(15, 31, 3, 8) == (8 * (7 * 31 * 15 + 1),
                                                   3 * 2 * cells * 42)
    assert ysl.is_k3_complex(K3C) and not ysl.is_k3_complex(K3R)
    assert not ysl.is_k3_complex("MgParams<double, true> elsewhere")


def test_a_laser_run_loads_no_jax():
    code = (
        "from benchmark import manifest, run\n"
        "from benchmark.tests.conftest import small_config\n"
        "man = manifest.Manifest()\n"
        "cfg = small_config(man.config('laser_blowout_explicit'))\n"
        "run.run_cell(man, 'laser.2047', 7, 0.0, True, device='cpu',"
        " cfg=cfg)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_control_fails_and_the_program_passes(man, card):
    seed = 2**31 + 2025
    line, lines = run.run_cell(man, CELL, seed, 0.0, False, device=card)
    assert line["correct"], lines
    torch.cuda.empty_cache()
    line, lines = run.run_cell(man, CELL, seed, 0.0, False, device=card,
                               dtype=torch.float32)
    assert not line["correct"], lines
