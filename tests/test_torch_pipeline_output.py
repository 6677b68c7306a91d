"""The port's pipelined time loop (``Simulation.evolve_pipelined``) on CPU in
float64, its stages on a list of CPU devices.

Every per-step openPMD (json) and in-situ file of a two-stage run of an
in-repo deck, one window and the serial tail, equals the serial loop's
(rtol 1e-9 / atol 1e-12): the checksum method's end-to-end comparison for
this path, which needs no reference checkout. Then the loop's serial
fallbacks (the tail, a hipace.max_time crossing inside a window, a density
table, one device), the device policy of the stages, the adaptive dt ladder
and the dt after a window against the JAX package's evolve_pipelined,
ROADMAP R22 (every stage of a window takes the same plasma draws, as in the
JAX package), and the statistics of pipelined ionization and collisions
against serial runs at the JAX package's thresholds
(``tests/test_pipeline_rng_stats.py``, ``tests/test_pipeline_banded.py``).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hipace_tpu.parallel import pipeline as jpp
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import blowout_wake
from hipace_tpu_torch.diagnostics.openpmd import read_field
from hipace_tpu_torch.parallel import pipeline as tpp
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_pipeline_banded import COLL_DECK
from test_pipeline_rng_stats import DECK as ION_DECK

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import read_insitu_diagnostics as rid  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")

# every kind of output, each step
OUTPUT = """
max_step = 2
hipace.openpmd_backend = json
diagnostic.output_period = 1
diagnostic.names = lev0 side integ
diagnostic.field_data = all rho
side.diag_type = xz
side.field_data = Ez jz_beam rho
integ.diag_type = xy_integrated
integ.field_data = Ez Psi
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""


def _in(folder, fn):
    cwd = os.getcwd()
    folder.mkdir()
    os.chdir(folder)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _close_json(got, ref, where):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for k in ref:
            _close_json(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        a, b = np.asarray(got), np.asarray(ref)
        if a.dtype.kind in "fiub" and b.dtype.kind in "fiub":
            assert a.shape == b.shape, where
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                       err_msg=where)
        else:
            assert len(got) == len(ref), where
            for i, (g, r) in enumerate(zip(got, ref)):
                _close_json(g, r, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, rel=1e-9, abs=1e-12), where
    else:
        assert got == ref, where


def _close_records(got, ref, where):
    assert got.dtype == ref.dtype, where
    for name in ref.dtype.names:
        if ref.dtype[name].names:
            _close_records(got[name], ref[name], f"{where}/{name}")
        else:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-9,
                                       atol=1e-12, err_msg=f"{where}/{name}")


def test_output_matches_the_serial_loop(tmp_path):
    """max_step 2 with two stages: steps 0 and 1 in one window, step 2 in
    the serial tail. The files (names, steps, times, dt, fields, the
    pre-push beam, the in-situ records) equal the serial loop's."""
    def run(piped):
        sim = Simulation(blowout_wake(15, 8, 1000, OUTPUT), device="cpu",
                         verbose=0)
        if piped:
            sim.evolve_pipelined(devices=[CPU, CPU])
        else:
            sim.evolve()
        return sim
    ser = _in(tmp_path / "ser", lambda: run(False))
    par = _in(tmp_path / "par", lambda: run(True))
    assert par.time == ser.time and par.dt == ser.dt
    files = sorted(p.relative_to(tmp_path / "ser")
                   for p in (tmp_path / "ser").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "par")
                           for p in (tmp_path / "par").rglob("*")
                           if p.is_file())
    assert [f.name for f in files if f.suffix == ".json"] == [
        f"openpmd_{s:06d}.json" for s in range(3)]
    assert sum(f.suffix == ".txt" for f in files) == 3
    for f in files:
        a, b = tmp_path / "par" / f, tmp_path / "ser" / f
        if f.suffix == ".json":
            _close_json(json.loads(a.read_text()), json.loads(b.read_text()),
                        str(f))
        else:
            ga, gb = rid.read_file(str(a)), rid.read_file(str(b))
            assert list(ga["step"]) == list(gb["step"]) == [0, 1, 2]
            _close_records(ga, gb, str(f))


# ---------------------------------------------------------------- the loop
SMALL = """
amr.n_cell = 8 8 8
hipace.normalized_units = 1
max_step = 2
hipace.dt = 2.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -6. -6. -6.
geometry.prob_hi =  6.  6.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 200
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.density = 1.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def _calls(monkeypatch, sim):
    """Record the windows (base step, dt ladder) and the serial loop's
    start steps of sim's pipelined loop."""
    seen = []
    evolve, window = sim.evolve, tpp.pipelined_window

    def serial(write_output=True, start_step=0):
        seen.append(("serial", start_step))
        return evolve(write_output, start_step)

    def win(s, binned, dts, times, base, *a, **k):
        seen.append(("window", base, list(dts)))
        return window(s, binned, dts, times, base, *a, **k)
    monkeypatch.setattr(sim, "evolve", serial)
    monkeypatch.setattr(tpp, "pipelined_window", win)
    return seen


@pytest.mark.parametrize("extra,want", [
    ("", [("window", 0, [2.0, 2.0]), ("serial", 2)]),
    ("hipace.max_time = 5.\n", [("window", 0, [2.0, 2.0]), ("serial", 2)]),
    ("hipace.max_time = 3.\n", [("serial", 0)]),
    ("max_step = 3\n", [("window", 0, [2.0, 2.0]),
                        ("window", 2, [2.0, 2.0])]),
    ("max_step = 0\n", [("serial", 0)]),
])
def test_fallbacks_to_serial(monkeypatch, extra, want):
    """The tail (fewer steps left than stages) and a max_time crossing
    inside a window run the serial loop from that step; max_time is landed
    on either way."""
    sim = Simulation(TInputs(SMALL + extra), device="cpu", verbose=0)
    seen = _calls(monkeypatch, sim)
    sim.evolve_pipelined(devices=[CPU, CPU], write_output=False)
    assert seen == want
    if "max_time" in extra:
        assert sim.time == float(extra.split("=")[1])


def test_density_table_and_one_device_run_serial(monkeypatch, tmp_path):
    table = tmp_path / "table"
    table.write_text("0. 1.\n10. 1.5\n")
    sim = Simulation(TInputs(SMALL + f"plasma.density_table_file = {table}\n"
                             "max_step = 1\n"), device="cpu", verbose=0)
    seen = _calls(monkeypatch, sim)
    sim.evolve_pipelined(devices=[CPU, CPU], write_output=False)
    sim2 = Simulation(TInputs(SMALL + "max_step = 1\n"), device="cpu",
                      verbose=0)
    seen2 = _calls(monkeypatch, sim2)
    sim2.evolve_pipelined(write_output=False)     # the default: [cpu]
    assert seen == seen2 == [("serial", 0)]


def test_a_cuda_stage_needs_the_card():
    """A device list that names CUDA raises where there is no GPU, as the
    simulation's own device would (a CPU run refuses CUDA stages)."""
    sim = Simulation(TInputs(SMALL), device="cpu", verbose=0)
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err):
        sim.evolve_pipelined(devices=[torch.device("cuda:0")] * 2)


ADAPTIVE = SMALL.replace("hipace.dt = 2.0", """hipace.dt = adaptive
hipace.nt_per_betatron = 20
hipace.adaptive_phase_tolerance = 1e-3
hipace.adaptive_phase_substeps = 200""").replace(
    "plasma.density(x,y,z) = 1.", "plasma.density(x,y,z) = 1. + 0.05*z*z")


def test_adaptive_ladder_matches_the_jax_pipeline(monkeypatch):
    """hipace.dt = adaptive, one window of two stages from the JAX
    package's beam: the window's dt ladder (the phase-advance control per
    stage, cutting each stage's dt differently on this density ramp) equals
    the JAX package's evolve_pipelined's, and so does the dt after the
    window (the last stage's beam moments, predicted with numprocs = 2)."""
    deck = ADAPTIVE + "max_step = 1\n"
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, 0.0, [b.total_charge for b in jsim.beam_cfgs],
                min_uz_mq=jsim._min_uz_mq)
    jdts = []
    jwin = jpp.pipelined_window
    monkeypatch.setattr(jpp, "pipelined_window",
                        lambda cfg, dtype, b, dts, *a, **k:
                        jdts.append(list(dts)) or jwin(cfg, dtype, b, dts,
                                                       *a, **k))
    seen = _calls(monkeypatch, tsim)
    jsim.evolve_pipelined(devices=jax.devices()[:2], write_output=False)
    tsim.evolve_pipelined(devices=[CPU, CPU], write_output=False)
    tdts = [c[2] for c in seen if c[0] == "window"]
    assert len(jdts) == len(tdts) == 1 and jdts[0][0] != jdts[0][1]
    np.testing.assert_allclose(tdts, jdts, rtol=1e-12, atol=0.0)
    assert tsim.time == pytest.approx(jsim.time, rel=1e-12)
    assert tsim.dt != tdts[0][1]
    np.testing.assert_allclose(tsim.dt, jsim.dt, rtol=1e-9)
    np.testing.assert_allclose(tsim.min_uz_mq, jsim._min_uz_mq, rtol=1e-9)


# ------------------------------------------------- draws and statistics
def test_stages_take_the_same_plasma_draws_r22(monkeypatch):
    """ROADMAP R22: every stage of a window initializes its plasma from the
    same temperature draws (the JAX package's one key per window), where
    the serial loop draws anew for every step."""
    deck = SMALL + "plasma.u_std = 0.01 0.01 0.01\nmax_step = 1\n"
    seen = []
    init = tpl.init_plasma

    def record(*a, **k):
        seen.append(k["draws"].clone())
        return init(*a, **k)
    monkeypatch.setattr(tpl, "init_plasma", record)
    Simulation(TInputs(deck), device="cpu", verbose=0).evolve_pipelined(
        devices=[CPU, CPU], write_output=False)
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    seen.clear()
    Simulation(TInputs(deck), device="cpu", verbose=0).evolve(
        write_output=False)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])


def _pair(tmp_path, deck, overrides, monkeypatch):
    """A serial and a two-stage pipelined run of deck, their output under
    tmp_path/ser and tmp_path/par. The serial run takes its first step's
    plasma draws at every step, as the pipelined window's stages do (R22),
    so that the two differ by the streams of the stochastic module alone,
    which is what the JAX package's thresholds hold."""
    def run(piped):
        sim = Simulation(TInputs(deck, overrides=overrides), device="cpu",
                         verbose=0)
        if piped:
            return sim.evolve_pipelined(devices=[CPU, CPU])
        draws = sim.plasma_draws()
        monkeypatch.setattr(sim, "plasma_draws", lambda: draws)
        return sim.evolve()
    _in(tmp_path / "ser", lambda: run(False))
    _in(tmp_path / "par", lambda: run(True))


def test_pipelined_ionization_statistics(tmp_path, monkeypatch):
    """The JAX package's threshold (test_pipeline_rng_stats.py): the charge
    of the last step's ionized plasma within 0.15 of the serial run's."""
    _pair(tmp_path, ION_DECK, ["hipace.openpmd_backend=json"], monkeypatch)
    a, b = (float(np.abs(read_field(
        str(tmp_path / sub / "diags/hdf5/openpmd_000001.json"), 1,
        "rhomjz")).sum()) for sub in ("ser", "par"))
    assert a > 0 and b > 0
    assert abs(a - b) / a < 0.15, (a, b)


def test_pipelined_collision_statistics(tmp_path, monkeypatch):
    """The JAX package's thresholds (test_pipeline_banded.py): the plasma's
    [ux^2] and [ga] within 0.05 and [uy^2] within 0.2 of the serial run's
    at the last step."""
    _pair(tmp_path, COLL_DECK, ["plasmas.insitu_period=1",
                                "diagnostic.output_period=0"], monkeypatch)
    a, b = (rid.read_file(str(tmp_path / sub / "diags/plasma_insitu/"
                              "reduced_plasma.*.txt")) for sub in ("ser",
                                                                   "par"))
    assert a.shape == b.shape and a.shape[0] == 2
    for comp, rtol in (("[ux^2]", 0.05), ("[ga]", 0.05), ("[uy^2]", 0.2)):
        sa = float(np.sum(a[comp][-1]))
        sb = float(np.sum(b[comp][-1]))
        assert sa > 0 and sb > 0
        assert abs(sa - sb) / sa < rtol, (comp, sa, sb)


def test_cli_pipelines_only_on_several_gpus(tmp_path, monkeypatch, capsys):
    """hipace.pipeline is on by default; the CLI pipelines only with more
    than one GPU (the JAX CLI: more than one device), so a CPU run is one
    rank on the serial loop."""
    from hipace_tpu_torch.__main__ import main
    deck = tmp_path / "deck"
    deck.write_text(SMALL)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Simulation, "evolve_pipelined", None)
    assert main([str(deck), "hipace.pipeline = 1", "max_step = 0",
                 "hipace.verbose = 0", "--device", "cpu"]) == 0
    assert "using 1 rank on cpu" in capsys.readouterr().out
