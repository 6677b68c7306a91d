"""The pipeline as one process per rank (``parallel/ranks.py``,
``Simulation.evolve_ranks``) on the CPU in float64: gloo ranks on a ring,
started by ``ranks.spawn`` (each rank ``python -m
hipace_tpu_torch.parallel.ranks``, meeting through a FileStore under the
test's temporary directory), against the single-process
``Simulation.evolve_pipelined(devices=[cpu] * n)`` from the same deck and
seed, which ``tests/test_torch_pipeline.py`` holds to the JAX package's
``pipelined_evolve``. Everything is compared bit for bit: every openPMD and
in-situ file byte for byte, the final beam, time, dt and laser stream with
``torch.equal``, the V-cycles of every slice of every step.

- DECK (``tests/test_pipeline_parallel.py``) at 2 ranks, one window and the
  serial tail, with per-step output of every kind
  (``tests/test_torch_pipeline_output.py``'s OUTPUT); DECK at 3 ranks (the
  ring's wrap with an odd n); LASER_DECK at 2 ranks (the laser rows, the
  stream after the window); the adaptive-dt deck at 2 ranks for two windows
  (each window's ladder, rank 1's beam moments broadcast), its dt and time
  per step in its in-situ and openPMD files.
- No rank imports jax or hipace_tpu.
- A rank that raises: spawn raises with its traceback within its timeout,
  and no rank is left running.
- The CLI's choice between spawning ranks, joining torchrun's group and the
  serial loop, with the GPU count monkeypatched.
"""

import os
import threading
import time
from pathlib import Path

import pytest
import torch

from hipace_tpu_torch import __main__ as cli
from hipace_tpu_torch.parallel import pipeline as tpp
from hipace_tpu_torch.parallel import ranks
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_pipeline_parallel import DECK, LASER_DECK
from test_torch_pipeline_output import ADAPTIVE, OUTPUT

torch.set_num_threads(1)
CPU = torch.device("cpu")
TIMEOUT = 120.0

CASES = {
    # one window (steps 0-1) and the serial tail (step 2), every output
    "deck": (DECK + OUTPUT, 2),
    # steps 0-1 in one window, laser rows on every tick
    "laser": (LASER_DECK + "max_step = 1\n", 2),
    # two windows of the adaptive ladder, dt and time per step on file
    "adaptive": (ADAPTIVE + """max_step = 3
hipace.openpmd_backend = json
diagnostic.output_period = 1
diagnostic.field_data = Ez
beams.insitu_period = 1
""", 2),
    # one window of three ranks
    "three": (DECK + "max_step = 2\n", 3),
}


def _pipelined(deck, n, folder):
    """evolve_pipelined over [cpu] * n in folder: the simulation
    and the V-cycles per slice of every step."""
    cycles = {}
    window = tpp.pipelined_window

    def keep(sim, binned, dts, times, base, *a):
        win = window(sim, binned, dts, times, base, *a)
        for d, res in enumerate(win["stages"]):
            cycles[base + d] = list(res["mg_cycles"])
        return win
    folder.mkdir(parents=True)
    cwd = os.getcwd()
    # the fixture's main thread meanwhile uses absolute paths only
    os.chdir(folder)
    tpp.pipelined_window = keep
    try:
        sim = Simulation(Inputs(deck), device="cpu", verbose=0)
        run = sim.run_step

        def serial(step):
            res = run(step)
            cycles[step] = list(res["mg_cycles"])
            return res
        sim.run_step = serial
        sim.evolve_pipelined(devices=[CPU] * n)
    finally:
        tpp.pipelined_window = window
        os.chdir(cwd)
    return sim, cycles


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through spawned ranks (the cases of two ranks in one
    spawn, one after another) and, in a thread meanwhile, through
    evolve_pipelined."""
    tmp = tmp_path_factory.mktemp("ranks")
    ref = {}

    def pipelined():
        for name, (deck, n) in CASES.items():
            ref[name] = _pipelined(deck, n, tmp / name / "pipelined")
    thread = threading.Thread(target=pipelined)
    thread.start()
    try:
        jobs = {name: ranks.Job(deck, workdir=str(tmp / name / "ranks"),
                                keep_steps=True, verbose=0)
                for name, (deck, _) in CASES.items()}
        two = [name for name, (_, n) in CASES.items() if n == 2]
        got = dict(zip(two, ranks.spawn([jobs[k] for k in two], [CPU] * 2,
                                        timeout=TIMEOUT, tmp=tmp,
                                        threads=1)))
        got["three"] = ranks.spawn(jobs["three"], [CPU] * 3,
                                   timeout=TIMEOUT, tmp=tmp, threads=1)
    finally:
        thread.join()
    assert sorted(ref) == sorted(CASES)
    return tmp, got, ref


def _files(folder):
    return sorted(p.relative_to(folder) for p in folder.rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_the_single_process_pipeline(runs, name):
    """The final beam, time and dt (and the laser stream) on rank 0, and
    every rank's V-cycles on every slice of the steps it ran, equal
    evolve_pipelined's bit for bit; each step ran on the rank the window
    gives it, the serial tail on rank 0."""
    _, got, ref = runs
    sim, cycles = ref[name]
    n = CASES[name][1]
    final = got[name][0]["final"]
    assert final["time"] == sim.time and final["dt"] == sim.dt
    for k, v in sim.binned.items():
        if torch.is_tensor(v):
            assert torch.equal(final["binned"][k], v), k
    assert int(sim.binned["valid"].sum()) > 100
    if sim.laser_stream is not None:
        assert float(sim.laser_stream[0].abs().max()) > 0
        for a, b in zip(final["laser_stream"], sim.laser_stream):
            assert torch.equal(a, b)
    kept = {}
    for r, res in enumerate(got[name]):
        steps = res["runs"][0]["steps"]
        # a window's step base + r on rank r; the serial tail on rank 0
        assert all(s % n == r or r == 0 for s in steps), (r, steps)
        assert all(rec["finite"] for rec in steps.values())
        kept.update((s, rec["mg_cycles"]) for s, rec in steps.items())
    assert kept == cycles
    assert sorted(cycles) == list(range(sim.max_step + 1))


@pytest.mark.parametrize("name", ["deck", "adaptive"])
def test_ranks_write_the_same_files(runs, name):
    """Every openPMD file (rank d writes step base + d's) and every in-situ
    file (rank 0 appends every rank's records in step order) equals
    evolve_pipelined's byte for byte: the fields, the pre-push beam, and
    each step's time and dt, which under adaptive dt are each window's
    ladder and the dt that rank 1's broadcast moments give."""
    tmp, _, _ = runs
    a, b = tmp / name / "ranks", tmp / name / "pipelined"
    files = _files(b)
    assert files == _files(a)
    steps = {"deck": 3, "adaptive": 4}[name]
    assert sum(f.suffix == ".json" for f in files) == steps
    assert any(f.suffix == ".txt" for f in files)
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_no_rank_imports_jax(runs):
    _, got, _ = runs
    for results in got.values():
        for res in results:
            assert res["modules"] == []


def _rank_processes():
    """The pids of this process's children that run a rank."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        if (int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid()
                and b"hipace_tpu_torch.parallel.ranks" in cmd):
            out.append(int(pid))
    return out


def test_a_rank_that_raises_fails_the_run(tmp_path):
    """Rank 1 cannot write step 1's openPMD file (a directory stands in its
    place) while rank 0 waits for its in-situ records: spawn raises with
    rank 1's traceback well within its timeout, and no rank is left."""
    work = tmp_path / "work"
    (work / "diags" / "hdf5" / "openpmd_000001.json").mkdir(parents=True)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="IsADirectoryError"):
        ranks.spawn(ranks.Job(CASES["adaptive"][0], workdir=str(work),
                              verbose=0),
                    [CPU] * 2, timeout=TIMEOUT, tmp=tmp_path, threads=1)
    assert time.monotonic() - t0 < TIMEOUT / 2
    assert _rank_processes() == []


def test_backend_follows_the_devices():
    assert ranks.choose_backend(["cpu"] * 3) == (
        "gloo", "3 ranks on the CPU: gloo")
    assert ranks.choose_backend(["cuda:0", "cuda:0"]) == (
        "gloo", "2 ranks share cuda:0: gloo")
    assert ranks.choose_backend(["cuda:0", "cuda:1"])[0] == "nccl"
    with pytest.raises(ValueError):
        ranks.choose_backend(["cpu", "cuda:0"])


def test_cli_spawns_ranks_on_several_gpus(tmp_path, monkeypatch, capsys):
    """With more than one GPU and hipace.pipeline on (the default), the CLI
    spawns one rank per card with the deck and its overrides; under
    torchrun (WORLD_SIZE set) it joins that group as one rank; with one
    GPU, or hipace.pipeline = 0, it runs the serial loop."""
    deck = tmp_path / "deck"
    deck.write_text(CASES["three"][0])
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(ranks, "spawn",
                        lambda job, devices, **kw: calls.append(
                            ("spawn", job, devices)))
    monkeypatch.setattr(cli, "_serial", lambda inputs, device: calls.append(
        ("serial", inputs.query("hipace.pipeline", True, bool))) or 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for gpus, extra in ((2, []), (1, []), (4, ["hipace.pipeline = 0"])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda g=gpus: g)
        assert cli.main([str(deck), "max_step = 0"] + extra) == 0
    assert [c[0] for c in calls] == ["spawn", "serial", "serial"]
    _, job, devices = calls[0]
    assert devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert job.cli and job.deck == deck.read_text()
    assert job.overrides == ("max_step = 0",)
    assert calls[2][1] is False

    class FakeRing:
        closed = False

        def close(self):
            FakeRing.closed = True
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(ranks.Ring, "from_env",
                        classmethod(lambda cls, device=None: FakeRing()))
    monkeypatch.setattr(ranks, "run_job", lambda ring, job: calls.append(
        ("rank", job)))
    assert cli.main([str(deck), "--device", "cpu"]) == 0
    assert calls[-1][0] == "rank" and calls[-1][1].cli and FakeRing.closed
