"""The port's measurement entry points on the CPU: the bench (python -m
hipace_tpu_torch.bench) -- its CPU rehearsal's last line, its push and cell
counts against the JAX package's bench.py formula on a JAX Simulation of
the same deck, its refusal to run without a card unless the CPU is asked
for -- and the CLI's hipace.profile and hipace.output_input, read as the
JAX package reads them (hipace_tpu/__main__.py:38-42,
hipace_tpu/pipeline/simulation.py:50-53)."""

import contextlib
import io
import json
import statistics

import pytest
import torch

from hipace_tpu.parser import Inputs as JInputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch import bench, decks
from hipace_tpu_torch.__main__ import main as cli
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
NXY, NZ, RUNS, MEASURED = 15, 4, 2, 3
NPART = max(1024, int(NXY * NXY * 10 * NZ / 1000))
ENV = {"HIPACE_BENCH_NXY": str(NXY), "HIPACE_BENCH_NZ": str(NZ),
       "HIPACE_BENCH_RUNS": str(RUNS)}
KEYS = {"metric", "value", "unit", "runs", "ns_per_push", "ns_per_cell",
        "device", "power_limit"}
# the bench's deck and overrides, and two keys its echo must print as given
DECK = decks.PDF_BEAM.format(nxy=NXY, nz=NZ, npart=NPART)
OVERRIDES = ["max_step=0", "hipace.dt=1.0", "diagnostic.output_period=0"]
ECHO = ["hipace.output_input = 1", "my_constants.kp = 2.",
        "plasma.radius = 1./kp"]


@pytest.fixture(scope="module")
def rehearsal():
    """The last line of the CPU rehearsal's stdout, through main() as the
    command runs it, parsed."""
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert bench.main(["--device", "cpu"]) == 0
    finally:
        mp.undo()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_sim():
    """The JAX package's Simulation of the bench's deck with the echo on,
    and what its construction printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sim = JSimulation(JInputs(DECK, overrides=OVERRIDES + ECHO),
                          verbose=0)
    return sim, out.getvalue()


def test_cpu_rehearsal_prints_a_parsable_last_line(rehearsal):
    rec = rehearsal
    assert KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["power_limit"] == "not read"
    assert rec["unit"] == "slices/s" and "vs_baseline" not in rec
    assert len(rec["runs"]) == RUNS and all(r > 0 for r in rec["runs"])
    assert rec["value"] == statistics.median(rec["runs"])
    # ns/push and ns/cell of the median run
    wall = NZ * MEASURED / rec["value"]
    pushes = rec["plasma_pushes"] + rec["beam_pushes"]
    assert rec["ns_per_push"] == pytest.approx(1e9 * wall / pushes,
                                               rel=1e-12)
    assert rec["ns_per_cell"] == pytest.approx(1e9 * wall / rec["cells"],
                                               rel=1e-12)


def test_counts_follow_bench_py_on_a_jax_simulation(rehearsal, jax_sim):
    """bench.py:94-106 evaluated on the JAX package's Simulation of the
    same deck (PDF_BEAM with the bench's overrides and npart)."""
    sim, _ = jax_sim
    n_slices = NZ * MEASURED
    n_plasma = sum(sim.geom.nx * sim.geom.ny * p.ppc[0] * p.ppc[1]
                   * max(1, p.n_subcycles) for p in sim.plasma_cfgs)
    beam_pushes = sum((b.num_particles or 0) * max(1, b.n_subcycles)
                      for b in sim.beam_cfgs) * MEASURED
    assert rehearsal["plasma_pushes"] == n_plasma * n_slices
    assert rehearsal["beam_pushes"] == beam_pushes > 0
    assert rehearsal["cells"] == sim.geom.nx * sim.geom.ny * n_slices


def test_bench_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_output_input_prints_the_jax_lines(jax_sim, capsys):
    _, want = jax_sim
    Simulation(Inputs(DECK, overrides=OVERRIDES + ECHO), device="cpu",
               verbose=0)
    got = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert lines == sorted(lines) and "plasma.radius = 1./kp" in lines
    assert "hipace.output_input = 1" in lines and len(lines) > 20
    Simulation(Inputs(DECK, overrides=OVERRIDES), device="cpu", verbose=0)
    assert capsys.readouterr().out == ""


def test_profile_writes_a_trace(tmp_path, capsys):
    deck = tmp_path / "deck"
    deck.write_text(DECK)
    trace = tmp_path / "trace"
    assert cli([str(deck), "--device", "cpu", "hipace.verbose=0",
                f"hipace.profile={trace}"]) == 0
    assert "Finished Evolve" in capsys.readouterr().out
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # the program's spans, as named ranges
    names = {e.get("name") for e in events}
    assert {"slice step", "field solve", "beam push"} <= names


def test_no_trace_without_the_profile_key(tmp_path, capsys):
    deck = tmp_path / "deck"
    deck.write_text(DECK)
    assert cli([str(deck), "--device", "cpu", "hipace.verbose=0"]) == 0
    capsys.readouterr()
    assert [p.name for p in tmp_path.iterdir()] == ["deck"]
