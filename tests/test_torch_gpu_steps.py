"""Whole steps of the port on a GPU against the same steps on the CPU.

Each test runs a small deck in float64 on the kernels and on the plain
PyTorch versions from the same beam (and, where the deck draws, the CPU's
recorded draws replayed on the card), and holds the card's fields, beams,
V-cycles and output files to the CPU's. Marked ``gpu``: they skip on a
CPU-only machine. On the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_steps.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

NXY, NZ = 63, 16
# the in-situ records: (folder, deck key of its prefix, record name)
INSITU = (("insitu", "beam", "beam"), ("plasma_insitu", "plasma", "plasma"),
          ("field_insitu", "fields", "field"))
# named field diagnostics of every kind, beam output and the three in-situ
# records (the CPU tests' set, tests/test_torch_diagnostics.py)
NAMED_DIAGS = """
max_step = 1
hipace.openpmd_backend = json
diagnostic.output_period = 1
diagnostic.names = lev0 side top integ coarse2 coarse3 patch
diagnostic.field_data = all remove_Sx rho
side.diag_type = xz
top.diag_type = yz
top.field_data = Ez rho_plasma jz_beam
top.output_period = 2
integ.diag_type = xy_integrated
integ.field_data = Ez Psi rho
coarse2.coarsening = 2 2 2
coarse2.field_data = Ez Bx jx
coarse3.diag_type = xz
coarse3.coarsening = 3 3 3
coarse3.include_ghost_cells = 1
coarse3.field_data = Psi By rho_plasma
patch.patch_lo = -2. -1. -4.
patch.patch_hi = 2. 3. 0.
patch.field_data = Ez ExmBy chi
diagnostic.beam_data = beam
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    """max|got - ref| / max|ref|, in float64 (complex128) on the host."""
    got, ref = got.cpu(), ref.cpu()
    if not ref.is_complex():
        got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


def _carry(gpu, cpu, charges=None):
    """Give the card's simulation the CPU simulation's beam."""
    from hipace_tpu_torch.convert import carry_state
    carry_state(gpu, {k: v.numpy() for k, v in cpu.binned.items()
                      if torch.is_tensor(v)}, cpu.dt, cpu.time, charges)


def _card_and_cpu(cuda, make):
    """One float64 step of the deck make() on the CPU and on the card, from
    the CPU simulation's beam and with its slice draws (recorded on the
    CPU, replayed on the card). Returns (CPU simulation, CPU result, card
    result)."""
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(make(), device="cpu", verbose=0)
    gpu = Simulation(make(), device=cuda, dtype=torch.float64, verbose=0)
    _carry(gpu, cpu, [b.total_charge for b in cpu.beam_cfgs])
    drawn, own = [], cpu.slice_step.draws

    def record(name, *shape):
        drawn.append(own(name, *shape))
        return drawn[-1]

    cpu.slice_step.draws = record
    ref = cpu.run_step(0)
    gpu.slice_step.draws = lambda name, *shape: drawn.pop(0).to(cuda)
    got = gpu.run_step(0)
    assert not drawn, f"the card took {len(drawn)} draws fewer"
    return cpu, ref, got


# ------------------------------------------------------- output files
def _read_insitu(path):
    """An in-situ file's records: a JSON dtype header, then the records."""
    raw = Path(path).read_bytes()
    head, offset = json.JSONDecoder().raw_decode(raw.decode("latin-1"))
    return np.frombuffer(raw, dtype=np.dtype(head), offset=offset)


def _worst(got, ref, where, worst):
    """Walk two openPMD json documents or in-situ records together: equal
    keys, shapes, strings and integers; the largest max|got - ref| /
    max|ref| of a float dataset kept in worst as [value, where]."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for k in ref:
            _worst(got[k], ref[k], f"{where}/{k}", worst)
        return
    if getattr(getattr(ref, "dtype", None), "names", None):
        for k in ref.dtype.names:
            _worst(got[k], ref[k], f"{where}[{k}]", worst)
        return
    if not isinstance(ref, (list, float, int)) and not hasattr(ref, "dtype"):
        assert got == ref, where
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, where
    if ref.dtype.kind not in "fc":
        assert np.array_equal(got, ref), where
        return
    if ref.size:
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        rel = err / scale if scale > 0 else err
        if rel > worst[0]:
            worst[:] = [rel, where]


def _file_worst(got_files, ref_files, worst=None):
    """_worst over pairs of openPMD json and in-situ files."""
    worst = [0.0, ""] if worst is None else worst
    for got, ref in zip(got_files, ref_files):
        if got.suffix == ".json":
            _worst(json.loads(got.read_text()), json.loads(ref.read_text()),
                   got.name, worst)
        else:
            _worst(_read_insitu(got), _read_insitu(ref), got.name, worst)
    return worst


def _output_files(folder):
    """The openPMD files and in-situ files a run wrote under folder."""
    files = sorted((folder / "openpmd").glob("openpmd_*.json"))
    return files + [folder / sub / f"reduced_{name}.0000.txt"
                    for sub, _, name in INSITU]


def _output_lines(folder):
    """Deck lines that send the openPMD and in-situ files under folder."""
    return (f"hipace.file_prefix = {folder}/openpmd\n"
            + "".join(f"{key}.insitu_file_prefix = {folder}/{sub}\n"
                      for sub, key, _ in INSITU))


# ------------------------------------------------------------ the flagship
def test_flagship_step_on_the_card_matches_the_cpu(cuda):
    """A 63^2 x 16 float64 step of the flagship on the kernels against the
    CPU plain path from the same beam: fields within 1e-8, the same live
    beam lanes, beam uz within 1e-12, equal V-cycles on every slice."""
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    cpu = Simulation(blowout_wake(NXY, NZ, 4000), device="cpu", verbose=0)
    gpu = Simulation(blowout_wake(NXY, NZ, 4000), device=cuda,
                     dtype=torch.float64, verbose=0)
    _carry(gpu, cpu)
    ref, got = cpu.run_step(0), gpu.run_step(0)
    assert _rel(got["diag"], ref["diag"]) < 1e-8
    v = ref["binned"]["valid"]
    assert torch.equal(got["binned"]["valid"].cpu(), v)
    assert _rel(got["binned"]["uz"].cpu()[v], ref["binned"]["uz"][v]) < 1e-12
    assert got["mg_cycles"] == ref["mg_cycles"]


def test_output_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The 63^2 x 16 float64 pdf deck with named diagnostics of every kind,
    beam output and in-situ records, json, on the card and on the CPU from
    the same beam: the same five files, every dataset and record within
    1e-8, equal V-cycles."""
    from hipace_tpu_torch.decks import pdf_beam
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sims = {dev: Simulation(pdf_beam(NXY, NZ, 4000, NAMED_DIAGS
                                     + _output_lines(tmp_path / dev)),
                            device=dev, dtype=torch.float64, verbose=0)
            for dev in ("cpu", "cuda")}
    _carry(sims["cuda"], sims["cpu"])
    cycles = {dev: [sim.advance(step)["mg_cycles"]
                    for step in range(sim.max_step + 1)]
              for dev, sim in sims.items()}
    files = {dev: _output_files(tmp_path / dev) for dev in sims}
    assert ([f.relative_to(tmp_path / "cuda") for f in files["cuda"]]
            == [f.relative_to(tmp_path / "cpu") for f in files["cpu"]])
    assert len(files["cuda"]) == 5
    assert all(f.exists() for f in files["cuda"])
    worst = _file_worst(files["cuda"], files["cpu"])
    assert worst[0] < 1e-8, worst
    assert cycles["cuda"] == cycles["cpu"]


# the beam paths: (deck function, deck lines added)
BEAM_VARIANTS = {
    "DRIVE_WITNESS": ("drive_witness", ""),
    "DRIVE_WITNESS + external fields": (
        "drive_witness",
        "beams.external_E(x,y,z,t) = 0.02*x*(1.+0.1*t) 0.02*y 0.01\n"
        "witness.external_B(x,y,z,t) = 0.01*y 0.005*x 0.\n"),
    "GRID_CURRENT": ("grid_current", ""),
}


@pytest.mark.parametrize("variant", list(BEAM_VARIANTS))
def test_beam_path_steps_on_the_card_match_the_cpu(cuda, variant):
    """Two 63^2 x 16 float64 steps of DRIVE_WITNESS (spin tracking and
    radiation reaction on the witness), the same with external fields, and
    GRID_CURRENT, on the kernels against the CPU plain path from the same
    beams: fields within 1e-8, equal V-cycles on every slice, the same live
    lanes, the beams (positions, momenta, spins) within 1e-8 of their
    largest value."""
    from hipace_tpu_torch import decks
    from hipace_tpu_torch.particles.beam import BEAM_ATTRS
    from hipace_tpu_torch.pipeline.simulation import Simulation
    fn, extra = BEAM_VARIANTS[variant]

    def deck():
        return getattr(decks, fn)(NXY, NZ, 4000, extra)

    cpu = Simulation(deck(), device="cpu", verbose=0)
    gpu = Simulation(deck(), device=cuda, dtype=torch.float64, verbose=0)
    _carry(gpu, cpu, [b.total_charge for b in cpu.beam_cfgs])
    for step in range(2):
        ref = cpu.advance(step, write_output=False)
        got = gpu.advance(step, write_output=False)
        assert _rel(got["diag"], ref["diag"]) < 1e-8
        assert got["mg_cycles"] == ref["mg_cycles"]
        v = ref["binned"]["valid"]
        assert torch.equal(got["binned"]["valid"].cpu(), v)
        for k in BEAM_ATTRS:
            r = ref["binned"][k][v]
            if r.numel() and float(r.abs().max()) > 0:
                assert _rel(got["binned"][k].cpu()[v], r) < 1e-8, k


# ------------------------------------------------------------- the laser
LASER_BOX = ("geometry.prob_lo = -10. -10. -7.5\n"
             "geometry.prob_hi = 10. 10. 6.\n")
# both laser solvers, both Bx/By solvers. The predictor-corrector runs in a
# (-10..10)^2 box: in LASER_WAKE's own (-20..20)^2 box at 63^2 its loop runs
# 30 iterations on every slice and its fields depend on the last bits of a0
# (the JAX package's as the port's), so no two runs can agree there
LASER_VARIANTS = {
    "explicit + multigrid": "",
    "predictor-corrector + FFT, (-10..10)^2 box":
        "hipace.bxby_solver = predictor-corrector\n"
        "lasers.solver_type = fft\n" + LASER_BOX,
}
LASER_OUTPUT = """
max_step = 1
diagnostic.output_period = 1
hipace.openpmd_backend = json
diagnostic.names = lev0 laser_diag
lev0.field_data = all
lasers.insitu_period = 1
"""


@pytest.mark.parametrize("variant", list(LASER_VARIANTS))
def test_laser_steps_on_the_card_match_the_cpu(cuda, tmp_path, variant):
    """Two 63^2 x 16 float64 steps of LASER_WAKE on the kernels against the
    CPU plain path, each writing openPMD files (json; lev0 with every field
    and laser_diag) and in-situ laser records: each field of the stack on
    its own scale and both parts of the laser stream within 1e-8, real and
    complex V-cycles and PC iterations equal on every slice, the same three
    files, every dataset within 1e-8 (the first |a|^2 moments in x and y,
    which cancel over the symmetric pulse, on the scale of the sum of
    |a|^2 times the box's half width)."""
    from hipace_tpu_torch.decks import laser_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sims, res = {}, {}
    for dev in ("cpu", "cuda"):
        folder = tmp_path / dev
        sims[dev] = Simulation(laser_wake(
            NXY, NZ, 0, LASER_VARIANTS[variant] + LASER_OUTPUT
            + f"hipace.file_prefix = {folder}/openpmd\n"
            + f"lasers.insitu_file_prefix = {folder}/laser_insitu\n"),
            device=dev, dtype=torch.float64, verbose=0)
        res[dev] = []
        for step in range(2):
            sims[dev].set_dt()
            res[dev].append(sims[dev].advance(step))
    for ref, got in zip(res["cpu"], res["cuda"]):
        d_ref, d_got = ref["diag"], got["diag"].cpu()
        per = ((d_got - d_ref).abs().amax(dim=(0, 2, 3))
               / d_ref.abs().amax(dim=(0, 2, 3)).clamp_min(1e-300))
        assert float(per.max()) < 1e-8
        for k in (0, 1):
            assert _rel(got["laser_stream"][k],
                        ref["laser_stream"][k]) < 1e-8
        for key in ("mg_cycles", "laser_cycles", "pc_iters"):
            assert got[key] == ref[key], key
    files = {dev: sorted(p for p in (tmp_path / dev).rglob("*")
                         if p.is_file()) for dev in sims}
    names = [f.relative_to(tmp_path / "cpu") for f in files["cpu"]]
    assert [f.relative_to(tmp_path / "cuda") for f in files["cuda"]] == names
    assert len(names) == 3
    g = sims["cpu"].geom
    half = max(abs(v) for v in g.prob_lo[:2] + g.prob_hi[:2])
    first = ("[|a|^2*x]", "[|a|^2*y]")
    worst = [0.0, ""]
    for got_f, ref_f in zip(files["cuda"], files["cpu"]):
        if got_f.suffix == ".json":
            _file_worst([got_f], [ref_f], worst)
            continue
        got_r, ref_r = _read_insitu(got_f), _read_insitu(ref_f)
        for k in ref_r.dtype.names:
            if k not in first:
                _worst(got_r[k], ref_r[k], f"{got_f.name}[{k}]", worst)
        scale = half * float(abs(ref_r["[|a|^2]"]).max())
        for k in first:
            assert float(abs(got_r[k] - ref_r[k]).max()) / scale < 1e-8, k
    assert worst[0] < 1e-8, worst


# ------------------------------------------------- ionization, collisions
ION_NXY = 64
# LASER_WAKE's pulse (a0 4.5, w0 4 and L0 2 plasma skin depths, at the
# origin, lambda0 0.8 um) over IONIZATION_WAKE's plasma, in its SI units
ION_LASER = """
lasers.names = laser
lasers.lambda0 = .8e-6
lasers.solver_type = multigrid
laser.a0 = 4.5
laser.position_mean = 0. 0. 0.
laser.w0 = 4. * kp_inv
laser.L0 = 2. * kp_inv
"""


def _a0_sensitivity():
    """How far the spawned electrons' positions of the laser deck move on
    the CPU when a0 moves by one unit in the last place: the deck's own
    sensitivity to roundoff (electrons born at rest inside a pulse of a0
    4.5 reach |u| ~ 10^5 c)."""
    from hipace_tpu_torch.decks import ionization_wake
    from hipace_tpu_torch.pipeline.simulation import Simulation
    elec = []
    for a0 in ("4.5", "4.500000000000001"):
        sim = Simulation(ionization_wake(ION_NXY, NZ, 0, ION_LASER.replace(
            "laser.a0 = 4.5", f"laser.a0 = {a0}")), device="cpu", verbose=0)
        elec.append(sim.run_step(0)["plasma"][0])
    live = elec[0]["valid"] & elec[1]["valid"]
    return max(_rel(elec[1][k][live], elec[0][k][live]) for k in ("x", "y"))


@pytest.mark.parametrize("laser", [False, True])
def test_ionization_step_on_the_card_matches_the_cpu(cuda, laser):
    """A 64^2 x 16 float64 step of IONIZATION_WAKE, and of the same under
    LASER_WAKE's pulse, on the kernels against the CPU plain path from the
    same beam and draws: fields within 1e-8, the ions' levels and the
    electrons' live lanes equal, equal ionization events, V-cycles equal on
    every slice, the spawned electrons' positions within 1e-12, with the
    laser within a hundred times the distance a one-ulp change of a0 moves
    them on the CPU (the kernels' atomics reorder sums on every slice)."""
    from hipace_tpu_torch.decks import ionization_wake
    pos_tol = 100 * _a0_sensitivity() if laser else 1e-12
    _, ref, got = _card_and_cpu(cuda, lambda: ionization_wake(
        ION_NXY, NZ, 0, ION_LASER if laser else ""))
    assert _rel(got["diag"], ref["diag"]) < 1e-8
    (e_ref, i_ref), (e_got, i_got) = ref["plasma"], got["plasma"]
    assert torch.equal(i_got["ion_lev"].cpu(), i_ref["ion_lev"])
    live = e_ref["valid"]
    assert torch.equal(e_got["valid"].cpu(), live)
    for k in ("x", "y"):
        assert _rel(e_got[k].cpu()[live], e_ref[k][live]) < pos_tol, k
    assert got["mg_cycles"] == ref["mg_cycles"]
    assert int(got["ionized"]) == int(ref["ionized"]) > 0


def _duplicate_partner_moves(device, order):
    """The R17 case: beam lanes A and B in one cell with one plasma lane, A
    rejecting the plasma lane's kick and B taking it, in the given order.
    Returns whether the plasma lane moved."""
    from hipace_tpu_torch.decks import collision_wake
    from hipace_tpu_torch.particles import collisions as coll
    from hipace_tpu_torch.pipeline.simulation import Simulation
    sim = Simulation(collision_wake(16, 4, 100), device="cpu", verbose=0)
    g, f64 = sim.geom, dict(dtype=torch.float64, device=device)
    x0, y0 = g.prob_lo[0] + 5.5 * g.dx, g.prob_lo[1] + 7.5 * g.dy
    lanes = {"A": (0.3, -0.2, 1500., 0.5, 0.9),
             "B": (-0.1, 0.4, 2500., 0.5, 0.1)}
    ux, uy, uz, w, r2 = (torch.tensor(v, **f64)
                         for v in zip(*(lanes[c] for c in order)))
    beam = {"x": torch.full((2,), x0, **f64), "y": torch.full((2,), y0, **f64),
            "ux": ux, "uy": uy, "uz": uz, "w": w,
            "valid": torch.ones(2, dtype=torch.bool, device=device)}
    plasma = {"x": torch.tensor([x0 + 0.1 * g.dx], **f64),
              "y": torch.tensor([y0], **f64),
              "ux": torch.tensor([0.01], **f64),
              "uy": torch.tensor([-0.02], **f64),
              "psi": torch.ones(1, **f64), "w": torch.ones(1, **f64),
              "valid": torch.ones(1, dtype=torch.bool, device=device)}
    draws = {"sort": torch.tensor([0.5], **f64),
             "pick": torch.tensor([0.3, 0.6], **f64),
             "kick": torch.stack([torch.full((2,), 0.4, **f64),
                                  torch.full((2,), 0.7, **f64),
                                  torch.zeros(2, **f64), r2])}
    _, out = coll.beam_plasma_collision(
        beam, plasma, g, sim.beam_cfgs[0], sim.plasma_cfgs[0], sim.pc, -1.0,
        1e24, True, draws, 1.0)
    return bool(out["ux"][0] != plasma["ux"][0])


def test_collision_step_on_the_card_matches_the_cpu(cuda):
    """A 64^2 x 16 float64 step of COLLISION_WAKE on the kernels against
    the CPU plain path from the same beam and draws: fields within 1e-8,
    the plasma's and the beam's momenta within 1e-10, V-cycles equal. Then
    one slice's beam-plasma collision of the CPU run's step 1, where
    several beam lanes pick a cell's one plasma lane, on the card against
    the CPU with the same draws: within 1e-10, the same plasma lanes
    kicked."""
    from hipace_tpu_torch.decks import collision_wake
    from hipace_tpu_torch.particles import collisions as coll
    cpu, ref, got = _card_and_cpu(cuda, lambda: collision_wake(
        ION_NXY, NZ, 4000))
    assert _rel(got["diag"], ref["diag"]) < 1e-8
    p_ref, p_got = ref["plasma"][0], got["plasma"][0]
    for k in ("ux", "uy", "psi"):
        assert _rel(p_got[k], p_ref[k]) < 1e-10, k
    v = ref["binned"]["valid"]
    for k in ("ux", "uy", "uz"):
        assert _rel(got["binned"][k].cpu()[v], ref["binned"][k][v]) < 1e-10
    assert got["mg_cycles"] == ref["mg_cycles"]
    # one slice's beam-plasma collision from the CPU run's own state
    cap, orig = {}, cpu.slice_step.collide

    def capture(plasmas, emit, dt):
        if len(emit["x"]) > len(cap.get("emit", {"x": ()})["x"]):
            cap.update(plasma=plasmas[0], emit=emit, dt=dt)
        return orig(plasmas, emit, dt)

    cpu.slice_step.collide = capture
    cpu.run_step(1)
    emit, plasma = cap["emit"], cap["plasma"]
    cells, _ = coll._cell_of(emit["x"], emit["y"], cpu.geom)
    per_cell = torch.bincount(cells, minlength=cpu.geom.nx * cpu.geom.ny + 1)
    assert int((per_cell[:-1] > 1).sum()) > 0
    gen = torch.Generator().manual_seed(5)
    nb, n = emit["x"].numel(), plasma["x"].numel()
    draws = {"sort": torch.rand(n, generator=gen, dtype=torch.float64),
             "pick": torch.rand(nb, generator=gen, dtype=torch.float64),
             "kick": torch.rand((4, nb), generator=gen, dtype=torch.float64)}
    args = (cpu.geom, cpu.beam_cfgs[0], cpu.plasma_cfgs[0], cpu.pc, -1.0,
            1e24, True)
    b_ref, q_ref = coll.beam_plasma_collision(emit, plasma, *args, draws,
                                              cap["dt"])

    def on_card(d):
        return {k: t.to(cuda) for k, t in d.items()}

    b_got, q_got = coll.beam_plasma_collision(
        on_card(emit), on_card(plasma), *args, on_card(draws), cap["dt"])
    for k in ("ux", "uy", "uz"):
        assert _rel(b_got[k], b_ref[k]) < 1e-10, k
    for k in ("ux", "uy", "psi"):
        assert _rel(q_got[k], q_ref[k]) < 1e-10, k
    assert torch.equal(q_got["ux"].cpu() != plasma["ux"],
                       q_ref["ux"] != plasma["ux"])


def test_last_picker_kick_stays_on_the_card_r17(cuda):
    """ROADMAP R17 on the card as on the CPU: of two beam lanes picking one
    plasma lane, the last picker's kick stays."""
    for dev in ("cpu", cuda):
        assert _duplicate_partner_moves(dev, "AB")
        assert not _duplicate_partner_moves(dev, "BA")


# ------------------------------------------------- SALAME, mesh refinement
# test_salame_with_mr's level over SALAME_WAKE, with the level's fields
SALAME_MR = ("amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
             "mr_lev1.patch_lo = -2. -2. -7.\nmr_lev1.patch_hi = 2. 2. 5.\n"
             "plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)\n"
             "plasma.fine_ppc = 4 4\ndiagnostic.names = lev0 lev1\n"
             "lev1.base_geometry = level_1\nlev1.field_data = all\n"
             "lev1.output_period = 1\nhipace.openpmd_backend = json\n")


def _same_cycles(got, ref):
    """Equal V-cycles (and PC iterations) on every slice, every solve."""
    keys = [k for k in ref if k in ("mg_cycles", "pc_iters", "salame_cycles",
                                    "laser_cycles")
            or k.startswith("mg_cycles_lev")]
    return all(got[k] == ref[k] for k in keys)


def _level_errors(got, ref):
    """_rel of level 0's fields and of each level's diagnostic."""
    errs = {"level 0": _rel(got["diag"], ref["diag"])}
    errs.update({k: _rel(got[k], ref[k]) for k in ref
                 if k.startswith("diagf_")})
    return errs


@pytest.mark.parametrize("level", [False, True])
def test_salame_step_on_the_card_matches_the_cpu(cuda, level):
    """SALAME_WAKE at 32^2 x 64 in float64, step 0 on the kernels against
    the CPU plain path from the same beams, alone and with
    test_salame_with_mr's level: fields of every level within 1e-8, the
    SALAME slices equal, W within 1e-10, the witness's weights within 1e-10
    of their largest, V-cycles equal on every slice (the level-0 solve,
    SALAME's solves, the level's)."""
    from hipace_tpu_torch.decks import salame_wake
    _, ref, got = _card_and_cpu(cuda, lambda: salame_wake(
        32, 64, 30000, SALAME_MR if level else ""))
    errs = _level_errors(got, ref)
    assert max(errs.values()) < 1e-8, errs
    assert float((got["salame_W"].cpu() - ref["salame_W"]).abs().max()) \
        < 1e-10
    assert torch.equal(got["salame_is_sal"].cpu(), ref["salame_is_sal"])
    assert int(ref["salame_is_sal"].sum()) > 0
    b = ref["binned"]
    wit = b["valid"] & (b["beam_id"] == 1)
    assert _rel(got["binned"]["w"].cpu()[wit], b["w"][wit]) < 1e-10
    assert _same_cycles(got, ref)


# the JAX package's MR test deck (tests/test_mr.py:15-55): a 32^2 x 24 grid
# with a 32^2 level over (-2..2)^2 at z -4..0 and an 8 x 8 ppc fine plasma
# patch; {nx} the coarse width, {extra} the MR lines or none
MR_TEST_BASE = """
amr.n_cell = {nx} {nx} 24
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 30000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 0.01
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 2 2
plasma.element = electron
diagnostic.output_period = 1
hipace.openpmd_backend = json
{extra}
"""
MR_TEST_LEVEL = """amr.max_level = 1
mr_lev1.n_cell = 32 32
mr_lev1.patch_lo = -2. -2. -4.
mr_lev1.patch_hi =  2.  2.  0.
plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)
plasma.fine_ppc = 8 8
diagnostic.names = lev0 lev1
lev1.base_geometry = level_1
lev1.field_data = all
"""
# deck lines added to the MR test deck
MR_VARIANTS = {
    "explicit, even 32^2 level (cell-centered fine K3)": "",
    "explicit, odd 33^2 level (node-centered fine K3)":
        "mr_lev1.n_cell = 33 33\n",
    # 4 x 4 fine ppc: the CPU half of 8 x 8 takes ~1 min
    "predictor-corrector, fine ppc 4 x 4":
        "hipace.bxby_solver = predictor-corrector\nplasma.fine_ppc = 4 4\n",
    "two levels": "amr.max_level = 2\nmr_lev2.n_cell = 32 32\n"
    "mr_lev2.patch_lo = -0.9 -0.9 -3.\nmr_lev2.patch_hi = 0.9 0.9 -1.\n"
    "diagnostic.names = lev0 lev1 lev2\nlev2.base_geometry = level_2\n"
    "lev2.field_data = all\n",
    "laser": "lasers.names = laser\nlasers.lambda0 = .8e-6\n"
    "lasers.solver_type = multigrid\nlaser.a0 = 1.\n"
    "laser.position_mean = 0. 0. 0.\nlaser.w0 = 2.\nlaser.L0 = 1.\n",
}


@pytest.mark.parametrize("variant", list(MR_VARIANTS))
def test_mr_test_deck_on_the_card_matches_the_cpu(cuda, variant):
    """The JAX package's MR test deck in float64 on the kernels against the
    CPU plain path from the same beam: fields of every level within 1e-8,
    each level's diagnostic of the CPU's shape, V-cycles and PC iterations
    equal on every slice."""
    from hipace_tpu_torch.parser import Inputs
    deck = MR_TEST_BASE.format(nx=32, extra=MR_TEST_LEVEL
                               + MR_VARIANTS[variant])
    _, ref, got = _card_and_cpu(cuda, lambda: Inputs(deck))
    errs = _level_errors(got, ref)
    assert max(errs.values()) < 1e-8, errs
    for k in ref:
        if k.startswith("diagf_"):
            assert got[k].shape == ref[k].shape, k
    assert _same_cycles(got, ref)


def test_mr_level_in_float32_against_a_uniformly_fine_run(cuda):
    """The MR test deck in float32 on the card: the level's Ez against a
    uniformly fine 128^2 run at slices 14 and 7, at the JAX test's
    thresholds (test_mr.py:81-86): within 0.10 of the truth's largest value
    and within 0.35 of the coarse run's error."""
    from hipace_tpu_torch.parser import Inputs
    from hipace_tpu_torch.pipeline.simulation import Simulation
    runs = {}
    for name, nx, extra in (("mr", 32, MR_TEST_LEVEL), ("truth", 128, ""),
                            ("coarse", 32, "")):
        sim = Simulation(Inputs(MR_TEST_BASE.format(nx=nx, extra=extra)),
                         device=cuda, dtype=torch.float32, verbose=0)
        runs[name] = (sim, sim.run_step(0))
    s_mr, r_mr = runs["mr"]
    gf = s_mr.mr_levels[0].geom
    xt = (torch.arange(gf.nx, dtype=torch.float64) + 0.5) * gf.dx \
        + gf.prob_lo[0]
    it = torch.round((xt + 8.0) / 0.125 - 0.5).long()
    itc = torch.round((xt + 8.0) / 0.5 - 0.5).long()

    def ez(name, z):
        sim, res = runs[name]
        return res["diag"][z, sim.cfg.diag_comps.index("Ez")].double().cpu()

    for z in (14, 7):
        fine = r_mr["diagf_lev1"][z, s_mr.cfg.diags[1].comps.index("Ez")]
        fine = fine.double().cpu()
        truth = ez("truth", z)[it][:, it]
        coarse = ez("coarse", z)[itc][:, itc]
        den = float(truth.abs().max())
        e_f = float((fine - truth).abs().max()) / den
        e_c = float((coarse - truth).abs().max()) / den
        assert e_f < 0.10 and e_f < 0.35 * e_c, (z, e_f, e_c)


# ------------------------------------------------------ pipeline and ranks
PIPE_STAGES = 2
# a window and the serial tail, every kind of per-step output but the named
# diagnostics
PIPE_OUTPUT = """
max_step = 2
hipace.openpmd_backend = json
diagnostic.output_period = 1
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""


def _beam_rel(got, ref):
    """The largest _rel over x, y, z, ux, uy and uz of the valid lanes of
    two binned beams, whose valid lane counts must be equal."""
    gv, rv = got["valid"].cpu(), ref["valid"].cpu()
    assert int(gv.sum()) == int(rv.sum())
    return max(_rel(got[k].cpu()[gv], ref[k].cpu()[rv])
               for k in ("x", "y", "z", "ux", "uy", "uz"))


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    """The flagship at 63^2 x 16 in float64 with every per-step output:
    two pipeline stages on the CPU ("cpu") and on cuda:0 ("card"), and the
    card's serial loop ("serial"), all from the CPU run's beam. Per run:
    (simulation, per time step its V-cycles and fields on the host, the
    files it wrote)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hipace_tpu_torch.convert import carry_state
    from hipace_tpu_torch.decks import blowout_wake
    from hipace_tpu_torch.parallel import pipeline as pp
    from hipace_tpu_torch.pipeline.simulation import Simulation
    root = tmp_path_factory.mktemp("pipe")
    runs = {}
    for name, dev, piped in (("cpu", "cpu", True), ("card", "cuda", True),
                             ("serial", "cuda", False)):
        folder = root / name
        sim = Simulation(blowout_wake(NXY, NZ, 4000,
                                      PIPE_OUTPUT + _output_lines(folder)),
                         device=dev, dtype=torch.float64, verbose=0)
        if runs:
            cpu = runs["cpu"][0]
            carry_state(sim, {k: v.numpy() for k, v in cpu.binned0.items()
                              if torch.is_tensor(v)}, cpu.dt, 0.0)
        sim.binned0 = sim.binned
        steps, run, window = [], sim.run_step, pp.pipelined_window

        def keep(res):
            steps.append({"mg_cycles": res["mg_cycles"],
                          "diag": res["diag"].cpu()})

        def run_step(step):
            res = run(step)
            keep(res)
            return res

        def kept_window(*args, **kwargs):
            win = window(*args, **kwargs)
            for res in win["stages"]:
                keep(res)
            return win

        sim.run_step, pp.pipelined_window = run_step, kept_window
        try:
            if piped:
                sim.evolve_pipelined(devices=[torch.device(dev)]
                                     * PIPE_STAGES)
            else:
                sim.evolve()
        finally:
            pp.pipelined_window = window
            del sim.run_step
        runs[name] = (sim, steps, _output_files(folder))
    return runs


@pytest.mark.parametrize("name", ["cpu", "serial"])
def test_pipelined_output_on_the_card_matches(cuda, pipe_runs, name):
    """The two stages on cuda:0 (steps 0-1 in one window, step 2 serial)
    against the same on the CPU and against the card's serial loop: fields
    and the final beam within 1e-8, equal V-cycles on every slice of every
    stage, every per-step openPMD and in-situ file within 1e-8."""
    ref_sim, ref_steps, ref_files = pipe_runs["card"]
    sim, steps, files = pipe_runs[name]
    assert len(ref_steps) == len(steps) == 3
    assert max(_rel(a["diag"], b["diag"])
               for a, b in zip(ref_steps, steps)) < 1e-8
    assert [a["mg_cycles"] for a in ref_steps] == [b["mg_cycles"]
                                                   for b in steps]
    assert _beam_rel(ref_sim.binned, sim.binned) < 1e-8
    assert [f.name for f in files] == [f.name for f in ref_files]
    assert all(f.exists() for f in files)
    worst = _file_worst(ref_files, files)
    assert worst[0] < 1e-8, worst


def test_ranks_on_the_card_match_one_process(cuda, pipe_runs, tmp_path):
    """The same run as two ranks sharing cuda:0 over gloo (ranks.spawn,
    Simulation.evolve_ranks) from the CPU run's beam: each step on its rank,
    every openPMD and in-situ file and the final beam within 1e-8 of the
    single-process two-stage runs on cuda:0 and on the CPU, equal V-cycles
    on every slice of every step."""
    from hipace_tpu_torch.decks import BLOWOUT_WAKE
    from hipace_tpu_torch.parallel import ranks
    cpu = pipe_runs["cpu"][0]
    start = tmp_path / "start.pt"
    torch.save({"binned": {k: v for k, v in cpu.binned0.items()
                           if torch.is_tensor(v)}, "dt": cpu.dt}, start)
    folder = tmp_path / "ranks"
    deck = (BLOWOUT_WAKE.format(nxy=NXY, nz=NZ, npart=4000) + PIPE_OUTPUT
            + _output_lines(folder))
    res = ranks.spawn(ranks.Job(deck, dtype="float64", start=str(start),
                                keep_steps=True, verbose=0),
                      ["cuda:0"] * PIPE_STAGES, timeout=300)
    steps, owner = {}, {}
    for r, out in enumerate(res):
        for s, rec in out["runs"][-1]["steps"].items():
            steps[s], owner[s] = rec, r
    assert sorted(steps) == [0, 1, 2] and owner == {0: 0, 1: 1, 2: 0}
    files = _output_files(folder)
    assert all(f.exists() for f in files)
    final = res[0]["final"]["binned"]
    for name in ("card", "cpu"):
        sim, ref_steps, ref_files = pipe_runs[name]
        assert [steps[s]["mg_cycles"] for s in sorted(steps)] == [
            r["mg_cycles"] for r in ref_steps]
        assert _beam_rel(final, sim.binned) < 1e-8
        assert [f.name for f in files] == [f.name for f in ref_files]
        worst = _file_worst(files, ref_files)
        assert worst[0] < 1e-8, (name, worst)
