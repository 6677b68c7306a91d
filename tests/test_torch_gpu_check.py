"""The port's on-card physics gate (python -m hipace_tpu_torch.gpu_check),
its parts that run on the CPU: the comparison against tools/tpu_check.py's
on the same sums, the sum|Q| reduction of an openPMD file written by the
JAX package against tools/tpu_check.py's reduction of that file, the
SumsWriter against the file the writer writes, the recorded and replayed
draws, the refusal without a card, and the reference leg end to end on a
reference checkout laid out under a temporary directory."""

import json

import numpy as np
import pytest
import torch

from hipace_tpu.parser import Inputs as JInputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch import decks
from hipace_tpu_torch import gpu_check as gc
from hipace_tpu_torch.diagnostics.openpmd import read_beam, read_field
from hipace_tpu_torch.pipeline.simulation import Simulation
from tools import tpu_check

torch.set_num_threads(1)


def _random_sums(rng, species=("beam", "witness")):
    fields = {f: float(v) for f, v in zip(
        ("Ez", "Bx", "By", "Psi", "Sx", "Sy", "chi", "tiny"),
        np.concatenate([rng.uniform(1, 1e3, 7), [1e-7]]))}
    out = {"lev=0": fields}
    for s in species:
        out[s] = {a: float(rng.uniform(1e-3, 1e3)) for a in gc.BEAM_MAP}
        out[s]["id"] = 1.0      # not a checksum attribute
    return out


def _perturbed(rng, ref, scale):
    out = {}
    for group, vals in ref.items():
        out[group] = {k: v * (1 + scale * rng.standard_normal())
                      for k, v in vals.items()}
    # a group only one side has, and a key only one side has
    out["lev=0"].pop("By")
    out["extra_species"] = {"x": 1.0}
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("skip", [(), gc.SXSYCHI])
def test_compare_matches_tpu_check(seed, skip):
    rng = np.random.default_rng(seed)
    ref = _random_sums(rng)
    ours = _perturbed(rng, ref, 10.0 ** -rng.uniform(2, 9))
    assert gc.compare(ours, ref, skip) == tpu_check.compare(ours, ref, skip)


@pytest.mark.parametrize("seed", range(2))
def test_floor_and_floored_compare_match_tpu_check(seed):
    rng = np.random.default_rng(10 + seed)
    s64 = _random_sums(rng)
    s32 = _perturbed(rng, s64, 1e-4)
    ref = _perturbed(rng, s64, 1e-3)
    floor = gc.f32_floor(s32, s64)
    assert floor == tpu_check.f32_floor(s32, s64)
    assert gc.compare(s32, ref, (), floor) == tpu_check.compare(
        s32, ref, (), floor)


def _tpu_check_reduction(path, it):
    """tools/tpu_check.py:83-102, run on a written file."""
    import h5py
    sums = {"lev=0": {}}
    with h5py.File(path) as f:
        mesh = f[f"data/{it}/fields"]
        for field in mesh:
            ds = mesh[field]
            if hasattr(ds, "shape"):
                sums["lev=0"][field] = float(
                    np.sum(np.abs(np.asarray(ds, dtype=np.float64))))
        pgroup = f[f"data/{it}/particles"]
        for species in pgroup:
            sums[species] = {}
            for attr, p in tpu_check.BEAM_MAP.items():
                if p in pgroup[species]:
                    sums[species][attr] = float(np.sum(np.abs(
                        np.asarray(pgroup[species][p], dtype=np.float64))))
    return sums


def file_sums(path: str, it: int) -> dict:
    """gpu_check.sums of the fields and beams of iteration `it` of an
    openPMD file (h5 or json, as the port and the JAX package write
    them)."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)["data"][str(it)]
        names = [k for k, v in data["fields"].items() if "data" in v]
        beams = list(data["particles"])
    else:
        import h5py
        with h5py.File(path, "r") as f:
            names = [k for k, v in f[f"data/{it}/fields"].items()
                     if hasattr(v, "shape")]
            beams = list(f[f"data/{it}/particles"])
    return gc.sums({n: read_field(path, it, n) for n in names},
                   {b: read_beam(path, it, b) for b in beams})


def test_file_sums_of_a_jax_file_match_the_checksum_reduction(tmp_path):
    """A JAX-package CPU run of the pdf deck with two named diagnostics
    (their groups are not summed) writes h5; both reductions agree."""
    deck = decks.PDF_BEAM.format(nxy=15, nz=4, npart=500) + (
        "diagnostic.output_period = 1\n"
        "diagnostic.names = lev0 side\n"
        "side.diag_type = xz\n"
        f"hipace.file_prefix = {tmp_path}\n")
    JSimulation(JInputs(deck), verbose=0).evolve()
    path = str(tmp_path / "openpmd_000000.h5")
    ref = _tpu_check_reduction(path, 0)
    got = file_sums(path, 0)
    assert got == ref
    assert len(got["lev=0"]) > 10 and set(got["beam"]) == set(gc.BEAM_MAP)


def test_sums_writer_equals_the_written_json(tmp_path):
    """The SumsWriter's sums of a port run equal file_sums of the json
    file the run's own writer writes (every field, named diagnostic and
    beam record)."""
    deck = decks.drive_witness(15, 4, 400, "max_step = 1\n"
                               "hipace.openpmd_backend = json\n"
                               "diagnostic.output_period = -1\n"
                               "diagnostic.names = lev0 side\n"
                               "side.diag_type = xz\n"
                               f"hipace.file_prefix = {tmp_path}\n")
    sim = Simulation(deck, device="cpu", verbose=0)
    writer, sums = sim.writer, gc.SumsWriter()

    class Both:
        def write(self, *args, **kwargs):
            writer.write(*args, **kwargs)
            sums.write(*args, **kwargs)

    sim.writer = Both()
    sim.evolve()
    assert list(sums.sums) == [1]
    got = file_sums(str(tmp_path / "openpmd_000001.json"), 1)
    assert sums.sums[1] == got
    assert set(got) == {"lev=0", "beam", "witness"}


@pytest.mark.parametrize("case", [
    gc.Case("ionization", lambda: decks.ionization_wake(16, 8), 1e-2),
    gc.Case("temperature", lambda: decks.ion_motion_even(16, 8, 500),
            1e-2)], ids=lambda c: c.name)
def test_replayed_draws_repeat_the_run(tmp_path, case):
    """A CPU leg started from a first simulation's beam and fed its
    recorded draws gives the same sums bit for bit; a simulation with its
    own draws does not."""
    first = gc.build(case, "cpu", torch.float64, str(tmp_path))
    start = gc.start_of(first)
    tape = gc.DrawTape()
    tape.record(first)
    ref = gc.run_leg(first, case.steps)
    assert len(tape.tape) >= case.steps
    got = gc.cpu_leg(case, start, tape.cpu())
    assert got["sums"] == ref["sums"]
    assert got["mg_cycles"] == ref["mg_cycles"]
    other = gc.build(case, "cpu", torch.float64, str(tmp_path))
    other.generator.manual_seed(12345)
    gc.carry_state(other, *start)
    assert gc.run_leg(other, case.steps)["sums"] != ref["sums"]


def test_replay_refuses_a_different_run(tmp_path):
    case = gc.Case("ionization", lambda: decks.ionization_wake(16, 8), 1e-2,
                   steps=1)
    sim = gc.build(case, "cpu", torch.float64, str(tmp_path))
    tape = gc.DrawTape()
    tape.record(sim)
    gc.run_leg(sim, 1)
    sim = gc.build(case, "cpu", torch.float64, str(tmp_path))
    check = tape.replay(sim)
    with pytest.raises(RuntimeError, match="recorded draws were not taken"):
        check()
    with pytest.raises(RuntimeError, match="asked for a 'kick' draw"):
        sim.slice_step.draws("kick", 3)


def test_gate_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gc.main([])


def test_reference_leg_needs_a_given_checkout(tmp_path):
    """No checkout given: the leg does not run. A checkout given that is
    not there: an error, not a silent skip."""
    assert gc.run_reference(None) == ("not run: no reference given "
                                      "(--reference DIR)")
    with pytest.raises(FileNotFoundError, match="no reference checkout"):
        gc.run_reference(str(tmp_path / "absent"))


# small stand-ins for the reference's two decks, in its input syntax
REF_DECKS = {
    "examples/linear_wake/inputs_normalized": decks.BLOWOUT_WAKE.format(
        nxy=15, nz=8, npart=400).replace("beam.density = 3.",
                                         "beam.density = 0.01"),
    "examples/blowout_wake/inputs_normalized": decks.BLOWOUT_WAKE.format(
        nxy=15, nz=8, npart=400),
}


@pytest.fixture(scope="module")
def reference_sums(tmp_path_factory):
    """Each reference case's deck under a checkout's layout, and the sums
    of the h5 file a CPU run of the deck with the case's overrides writes
    at its last step (tools/tpu_check.py's reduction), in the layout of
    the reference's benchmark JSONs (bookkeeping attributes included)."""
    root = tmp_path_factory.mktemp("reference")
    out = {}
    for name, path, overrides, _, _ in gc.REF_CASES:
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).write_text(REF_DECKS[path])
        prefix = root / "runs" / name
        sim = Simulation(gc.Inputs.from_file(
            str(root / path), list(overrides) + [
                "diagnostic.output_period = -1",
                f"hipace.file_prefix = {prefix}"]), device="cpu", verbose=0)
        sim.evolve()
        it = sim.max_step
        sums = _tpu_check_reduction(str(prefix / f"openpmd_{it:06d}.h5"),
                                    it)
        for species in sums:
            if species != "lev=0":
                sums[species].update(charge=-1.0, id=1e6, mass=1.0)
        out[name] = sums
    return root, out


@pytest.mark.parametrize("fault", [None, "deviation", "field not written"])
def test_reference_leg_on_a_checkout(reference_sums, monkeypatch, fault):
    """The reference leg on a checkout laid out as the reference's: its
    decks through the port's parser, its JSONs, the float32 floors and the
    pass decision, with the card's legs run on the CPU in float64 (both
    legs alike, so every floor is 0). JSONs from the same deck pass; a
    field 10x the case's tolerance off, or a field the run does not
    write, fails the case and names the field."""
    root, good = reference_sums
    bench = root / gc.BENCH
    bench.mkdir(parents=True, exist_ok=True)
    for name, sums in good.items():
        sums = json.loads(json.dumps(sums))
        if fault == "deviation" and name == gc.REF_CASES[1][0]:
            sums["lev=0"]["Ez"] *= 1 + 10 * gc.REF_CASES[1][3]
        if fault == "field not written" and name == gc.REF_CASES[0][0]:
            sums["lev=0"]["jz_not_a_field"] = 1.0
        (bench / f"{name}.json").write_text(json.dumps(sums))
    build = gc.build
    monkeypatch.setattr(gc, "build", lambda case, device, dtype, out:
                        build(case, "cpu", torch.float64, out))
    rec = gc.run_reference(str(root))
    assert [r["case"] for r in rec] == [c[0] for c in gc.REF_CASES]
    for r, case in zip(rec, gc.REF_CASES):
        assert r["pass_rtol"] == case[3]
        faulty = ((fault == "deviation" and case is gc.REF_CASES[1])
                  or (fault == "field not written"
                      and case is gc.REF_CASES[0]))
        assert r["ok"] is not faulty, r
        if fault == "deviation" and faulty:
            assert r["argmax_floor_adjusted"] == "Ez"
            assert r["max_rel_vs_reference_floor_adjusted"] == pytest.approx(
                10 * case[3] / (1 + 10 * case[3]), rel=1e-6)
        else:
            assert r["max_rel_vs_reference_floor_adjusted"] < 1e-10
        assert r["fields_not_written"] == (
            ["jz_not_a_field"] if fault == "field not written" and faulty
            else [])
        assert (r["max_rel_vs_reference_raw"]
                == r["max_rel_vs_reference_floor_adjusted"])


def test_ladder_lists_its_cases():
    """The nine decks of the ladder, and collision_wake out of it for R19."""
    assert [c.name for c in gc.CASES] == [
        "blowout_wake", "pdf_beam", "pc_open", "ion_motion_even",
        "laser_wake", "drive_witness", "ionization_wake", "salame_wake",
        "mr_wake"]
    assert gc.SKIPPED == {"collision_wake": "R19"}
    assert all(c.steps == 2 for c in gc.CASES) and gc.FULL.steps == 1
