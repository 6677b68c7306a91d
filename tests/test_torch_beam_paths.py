"""The beam paths through the port against the JAX package on CPU in
float64: several beams, external fields, spin tracking, radiation reaction
and the analytic grid current.

The same numpy inputs go through both packages: the beam configurations of
a two-beam deck that uses both forms of the external fields, the initial
spin and the merge of two beams, one slice's push (external fields, spin,
radiation reaction in normalized and in SI units, two species with their
own subcycles, charge and mass) within 1e-12, the two-beam deposit and the
grid current's plane within 1e-12. Two whole 31^2 x 8 runs of two steps
carry the paths end to end: a drive and a witness beam with spin,
radiation reaction and external fields that depend on t (fields within
1e-10, V-cycles equal on every slice, both beams within 1e-12, each beam's
openPMD records and in-situ file), and a grid current with no beam. A JAX
whole step compiles for ~20 s on one core, so the file holds two.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
import test_beam_extras as jbe
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import beam as jbm
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import DRIVE_WITNESS, GRID_CURRENT
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.pipeline.simulation import Simulation
from hipace_tpu_torch.pipeline.step import grid_current_plane
from test_torch_diagnostics import (_compare_openpmd, _compare_records,
                                    _insitu)
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
FIELD_RTOL = 1e-10
BEAM_RTOL = 1e-12
NO_BANDED = "hipace.use_banded = 0\n"
SMALL = dict(nxy=31, nz=8, npart=1000, nwit=250)
# both forms of the external fields: three expressions under beams., one
# (the x component) for the witness's own B
EXTERNAL = ("beams.external_E(x,y,z,t) = 0.02*x*(1.+0.1*t) 0.02*y 0.01\n"
            "witness.external_B(x,y,z,t) = 0.01*y\n")
TWO_BEAMS = (DRIVE_WITNESS.format(**SMALL) + NO_BANDED + EXTERNAL
             + "beams.spin_anom = 0.1\n")
# two species that differ in subcycles, charge and mass
SPECIES = (DRIVE_WITNESS.format(**SMALL) + NO_BANDED
           + "witness.element = proton\nwitness.n_subcycles = 4\n"
           "witness.do_radiation_reaction = 0\n")
CFG_FIELDS = ("name", "injection_type", "charge", "mass", "num_particles",
              "density", "total_charge", "profile", "zmin", "zmax", "radius",
              "position_mean", "position_std", "u_mean", "u_std",
              "n_subcycles", "do_z_push", "use_external_fields",
              "external_fields_expr", "do_radiation_reaction",
              "do_spin_tracking", "initial_spin", "spin_anom")


def _sims(deck):
    return (JSimulation(Inputs(deck), verbose=0),
            Simulation(TInputs(deck), device="cpu", verbose=0))


@pytest.fixture(scope="module")
def two_beams():
    return _sims(TWO_BEAMS)


def test_beam_configs_match_jax(two_beams):
    jsim, tsim = two_beams
    assert len(tsim.beam_cfgs) == 2
    for j, t in zip(jsim.beam_cfgs, tsim.beam_cfgs):
        for f in CFG_FIELDS:
            assert getattr(t, f) == getattr(j, f), (t.name, f)
    drive, wit = tsim.beam_cfgs
    assert drive.external_fields_expr == (
        "0.02*x*(1.+0.1*t)", "0.02*y", "0.01", "0", "0", "0")
    assert wit.external_fields_expr[3:] == ("0.01*y", "0", "0")
    assert wit.do_spin_tracking and wit.do_radiation_reaction
    assert drive.spin_anom == wit.spin_anom == 0.1
    assert tsim.cfg.background_density_SI == 1e24


def test_init_spin_and_merge_match_jax(two_beams):
    """The normalized initial spin (also of a spin that is not a unit
    vector) and the merge of two beams with their beam_id, within 1e-15."""
    jsim, tsim = two_beams
    for spin in ((1.0, 0.0, 0.0), (0.3, -2.0, 1.1)):
        jc = dataclasses.replace(jsim.beam_cfgs[1], initial_spin=spin)
        tc = dataclasses.replace(tsim.beam_cfgs[1], initial_spin=spin)
        ref = jbm._init_spin(jc, 7, jnp.float64)
        got = tbm.init_spin(tc, torch.zeros(7, dtype=torch.float64))
        for k in ("sx", "sy", "sz"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-15, atol=1e-15)
    off = tbm.init_spin(tsim.beam_cfgs[0], torch.ones(3, dtype=torch.float64))
    assert all(not v.any() for v in off.values())
    rng = np.random.default_rng(0)
    flats = []
    for n in (5, 3):
        f = {k: rng.standard_normal(n) for k in tbm.BEAM_ATTRS}
        f["valid"] = rng.random(n) < 0.8
        f["nsub"] = rng.integers(0, 3, n).astype(np.int32)
        flats.append(f)
    ref = jbm.merge_beams([{k: jnp.asarray(v) for k, v in f.items()}
                           for f in flats])
    got = tbm.merge_beams([{k: torch.as_tensor(v) for k, v in f.items()}
                           for f in flats])
    assert sorted(got) == sorted(ref)
    assert got["beam_id"].dtype == torch.int32
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=1e-15, atol=0, err_msg=k)


def _lanes(rng, geom, c, n, islice, nbeams, spin):
    """One slice's lanes: positions over the box, some slipped below the
    slice, some invalid, resume counters 0-3, the species at random;
    momenta u*c."""
    lo = geom.prob_lo[2] + islice * geom.dz
    span = 0.4 * (geom.prob_hi[0] - geom.prob_lo[0])
    b = {"x": rng.uniform(-span, span, n), "y": rng.uniform(-span, span, n),
         "z": rng.uniform(lo - 0.2 * geom.dz, lo + geom.dz, n),
         "ux": c * rng.normal(0, 3, n), "uy": c * rng.normal(0, 3, n),
         "uz": c * (2000 + rng.normal(0, 20, n)),
         "w": rng.uniform(0.5, 1.5, n),
         "valid": rng.random(n) < 0.9,
         "nsub": rng.integers(0, 4, n).astype(np.int32),
         "beam_id": rng.integers(0, nbeams, n).astype(np.int32)}
    s = rng.standard_normal((3, n))
    s = s / np.linalg.norm(s, axis=0) if spin else 0.0 * s
    b.update(sx=s[0], sy=s[1], sz=s[2])
    return b, lo


def _planes(rng, geom, si):
    NY, NX = geom.slice_shape
    e, bf = (1e8, 0.3) if si else (0.5, 0.5)
    return {"Psi": e * geom.dx * rng.standard_normal((NY, NX)),
            "Ez": e * rng.standard_normal((NY, NX)),
            "Bx": bf * rng.standard_normal((NY, NX)),
            "By": bf * rng.standard_normal((NY, NX)),
            "Bz": bf * rng.standard_normal((NY, NX))}


PUSH_CASES = {
    # name: (deck, beams pushed, time)
    "external fields": (TWO_BEAMS + "witness.do_spin_tracking = 0\n"
                        "witness.do_radiation_reaction = 0\n", (0,), 0.7),
    "spin": (TWO_BEAMS + "witness.do_radiation_reaction = 0\n", (1,), 0.7),
    "rr normalized": (TWO_BEAMS + "witness.do_spin_tracking = 0\n", (1,),
                      0.7),
    "rr SI": (jbe.DECK_RR + "beam.do_radiation_reaction = 1\n", (0,), 0.0),
    "two species": (SPECIES, (0, 1), 0.0),
}


@pytest.mark.parametrize("case", list(PUSH_CASES))
def test_advance_beam_slice_matches_jax(case):
    deck, beams, time = PUSH_CASES[case]
    jsim, tsim = _sims(deck)
    jcfgs = tuple(jsim.beam_cfgs[i] for i in beams)
    tcfgs = tuple(tsim.beam_cfgs[i] for i in beams)
    rr = any(c.do_radiation_reaction for c in tcfgs)
    spin = any(c.do_spin_tracking for c in tcfgs)
    assert rr == (case.startswith("rr"))
    assert spin == (case in ("spin", "two species"))
    assert all(c.use_external_fields for c in tcfgs) == (case != "two "
                                                         "species")
    rng = np.random.default_rng(len(case))
    si = not tsim.normalized_units
    bp, min_z = _lanes(rng, tsim.geom, tsim.pc.c, 600, 3, len(beams),
                       spin)
    planes = _planes(rng, tsim.geom, si)
    dt = tsim.dt
    bgd = tsim.cfg.background_density_SI
    ref = jbm.advance_all_beams(
        {k: jnp.asarray(v) for k, v in bp.items()},
        {k: jnp.asarray(v) for k, v in planes.items()}, jsim.geom, jcfgs,
        jsim.pc, dt, min_z, order=2, time=time, background_density_SI=bgd)
    got = tbm.advance_all_beams(
        {k: torch.as_tensor(v) for k, v in bp.items()},
        {k: torch.as_tensor(v) for k, v in planes.items()}, tsim.geom,
        tcfgs, tsim.pc, dt, min_z, order=2,
        time=torch.tensor(time, dtype=torch.float64),
        background_density_SI=bgd)
    for k in ("valid", "nsub", "beam_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    moved = np.asarray(ref["uz"]) != bp["uz"]
    assert moved.sum() > 300
    for k in tbm.BEAM_ATTRS:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, err_msg=k,
                                   atol=BEAM_RTOL * max(np.abs(r).max(),
                                                        1e-300))
    if spin:
        s = np.stack([got[k].numpy() for k in ("sx", "sy", "sz")])
        assert np.abs(np.linalg.norm(s, axis=0) - 1.0).max() < 1e-13
        # it turned (a proton's spin turns by ~1e-6 here)
        assert np.abs(s - np.stack([bp["sx"], bp["sy"], bp["sz"]])).max() \
            > 1e-7


def test_two_beam_deposit_matches_jax():
    """One deposit over both beams' lanes, each lane with its species'
    charge (a proton witness), in normalized and SI units."""
    for deck in (SPECIES, SPECIES.replace("hipace.normalized_units = 1",
                                          "hipace.normalized_units = 0")):
        jsim, tsim = _sims(deck)
        rng = np.random.default_rng(3)
        bp, _ = _lanes(rng, tsim.geom, tsim.pc.c, 800, 3, 2, False)
        NY, NX = tsim.geom.slice_shape
        names = {"jx": "jx", "jy": "jy", "jz": "jz", "rhomjz": "rhomjz"}
        zero = {v: np.zeros((NY, NX)) for v in names.values()}
        ref = jbm.deposit_beam_slice(
            {k: jnp.asarray(v) for k, v in bp.items()}, names,
            {k: jnp.asarray(v) for k, v in zero.items()}, jsim.geom,
            tuple(jsim.beam_cfgs), jsim.pc, 2, jsim.normalized_units)
        consts = tbm.beam_constants(tsim.beam_cfgs, "cpu", torch.float64)
        got = tbm.deposit_beam_slice(
            {k: torch.as_tensor(v) for k, v in bp.items()}, names,
            {k: torch.as_tensor(v) for k, v in zero.items()}, tsim.geom,
            tsim.beam_cfgs, tsim.pc, 2, tsim.normalized_units,
            consts["charges"])
        assert consts["charges"].tolist() == [b.charge for b in
                                              tsim.beam_cfgs]
        for k in names:
            r = np.asarray(ref[k])
            assert np.abs(r).max() > 0
            np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                       atol=BEAM_RTOL * np.abs(r).max(),
                                       err_msg=k)


def test_grid_current_plane_matches_jax():
    """The plane the slice step adds to jz_beam, times its longitudinal
    factor, against the JAX package's expression (its step.py, the grid
    current before the Psi/Ez/Bz solve) on several slices."""
    deck = GRID_CURRENT.format(nxy=31, nz=8, npart=100) \
        + "grid_current.position_mean = 0.5 -1. 0.3\n"
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    cfg, g = tsim.cfg, tsim.geom
    peak, mean, std = cfg.grid_current
    assert (peak, mean, std) == (0.2, (0.5, -1.0, 0.3), (0.3, 0.3, 1.41))
    plane = grid_current_plane(cfg, "cpu", torch.float64)
    G = g.nguards
    NY, NX = g.slice_shape
    for islice in (0, 3, 7):
        z_sl = g.prob_lo[2] + jnp.float64(islice) * g.dz
        dz_n = (z_sl - mean[2]) / std[2]
        long_fac = jnp.exp(-0.5 * dz_n * dz_n)
        xs = (jnp.arange(NX, dtype=jnp.float64) - G + 0.5) * g.dx \
            + g.prob_lo[0]
        ys = (jnp.arange(NY, dtype=jnp.float64) - G + 0.5) * g.dy \
            + g.prob_lo[1]
        dxn = (xs[None, :] - mean[0]) / std[0]
        dyn = (ys[:, None] - mean[1]) / std[1]
        ref = np.array(peak * jnp.exp(-0.5 * (dxn * dxn + dyn * dyn))
                         * long_fac)
        ref[:G], ref[NY - G:], ref[:, :G], ref[:, NX - G:] = 0, 0, 0, 0
        dzn = (g.prob_lo[2] + islice * g.dz - mean[2]) / std[2]
        got = (plane * math.exp(-0.5 * dzn * dzn)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=BEAM_RTOL * np.abs(ref).max())


def test_fixed_weight_flattop_runs_as_gaussian():
    """R12: a fixed_weight beam of any profile but can is drawn as the
    gaussian, in both packages (the JAX package's _init_fixed_weight)."""
    base = DRIVE_WITNESS.format(**SMALL) + NO_BANDED
    flat = base + "beam.profile = flattop\nwitness.profile = flattop\n"
    for sim_cls, inputs_cls, kw in ((JSimulation, Inputs, {}),
                                    (Simulation, TInputs,
                                     {"device": "cpu"})):
        ref = sim_cls(inputs_cls(base), verbose=0, **kw)
        got = sim_cls(inputs_cls(flat), verbose=0, **kw)
        assert [b.profile for b in got.beam_cfgs] == ["flattop"] * 2
        for k in ("x", "y", "z", "uz", "w", "valid"):
            np.testing.assert_array_equal(np.asarray(got.binned[k]),
                                          np.asarray(ref.binned[k]))


def test_rr_in_normalized_units_needs_the_density():
    deck = TWO_BEAMS.replace("hipace.background_density_SI = 1e24\n", "")
    with pytest.raises(ValueError, match="background_density_SI"):
        Simulation(TInputs(deck), device="cpu", verbose=0)


OUTPUT = """max_step = 1
hipace.openpmd_backend = h5
diagnostic.output_period = 1
beams.insitu_period = 1
"""
STEP_DECKS = {
    "drive witness": TWO_BEAMS,
    "grid current": GRID_CURRENT.format(nxy=31, nz=8, npart=100)
    + NO_BANDED + "beams.names = no_beam\n"
    "plasmas.names = plasma\nplasma.density(x,y,z) = 1.\n"
    "plasma.ppc = 1 1\n",
}


def _step_deck(case, out):
    return (STEP_DECKS[case] + OUTPUT + f"hipace.file_prefix = {out}/openpmd\n"
            + f"beam.insitu_file_prefix = {out}/insitu\n"
            + f"witness.insitu_file_prefix = {out}/insitu\n")


@pytest.fixture(scope="module", params=list(STEP_DECKS))
def steps(request, tmp_path_factory):
    """Two steps of each package from the same beams, each step's output
    written as each time loop writes it: (case, JAX results, port results,
    the JAX package's V-cycles per slice, JAX and port output folders)."""
    case = request.param
    root = tmp_path_factory.mktemp(case.replace(" ", "_"))
    jdir, tdir = root / "jax", root / "port"
    cycles, jres = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(_step_deck(case, jdir)), verbose=0)
        tsim = Simulation(TInputs(_step_deck(case, tdir)), device="cpu",
                          verbose=0)
        carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                    jsim.dt, jsim.time,
                    [b.total_charge for b in jsim.beam_cfgs])
        for step in range(2):
            pre = jsim.binned
            res = jsim.run_step(step)
            jax.effects_barrier()
            jsim._write_diagnostics(step, res, pre)
            jsim._write_insitu(step, res)
            jsim.binned, jsim.time = res["binned"], jsim.time + jsim.dt
            jres.append(res)
    tres = [tsim.advance(step) for step in range(2)]
    return case, jres, tres, cycles, jdir, tdir


def test_steps_fields_and_cycles_match(steps):
    """Both steps' fields within 1e-10 of each one's largest value, the
    V-cycles equal on every slice."""
    _, jres, tres, cycles, *_ = steps
    for jr, tr in zip(jres, tres):
        ref, got = np.asarray(jr["diag"]), tr["diag"].numpy()
        assert got.shape == ref.shape and ref.shape[:1] == (8,)
        for i in range(ref.shape[1]):
            np.testing.assert_allclose(
                got[:, i], ref[:, i], rtol=0, err_msg=str(i),
                atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))
    assert tres[0]["mg_cycles"] + tres[1]["mg_cycles"] == cycles
    assert len(cycles) == 16


def test_steps_beams_match(steps):
    """Both beams after each step: the same lanes, species, resume counters
    and, within 1e-12, positions, momenta, weights and spins; the witness's
    spin keeps its norm and has turned."""
    case, jres, tres, *_ = steps
    if case != "drive witness":
        assert not tres[0]["binned"]["valid"].any()
        return
    for jr, tr in zip(jres, tres):
        jb, tb = jr["binned"], tr["binned"]
        valid = np.asarray(jb["valid"])
        np.testing.assert_array_equal(tb["valid"].numpy(), valid)
        for k in ("nsub", "beam_id"):
            np.testing.assert_array_equal(tb[k].numpy()[valid],
                                          np.asarray(jb[k])[valid])
        bid = np.asarray(jb["beam_id"])[valid]
        assert (bid == 0).sum() > 900 and (bid == 1).sum() > 200
        for k in tbm.BEAM_ATTRS:
            ref = np.asarray(jb[k])[valid]
            np.testing.assert_allclose(tb[k].numpy()[valid], ref, rtol=0,
                                       err_msg=k,
                                       atol=BEAM_RTOL * np.abs(ref).max())
    tb = tres[1]["binned"]
    wit = tb["valid"] & (tb["beam_id"] == 1)
    s = torch.stack([tb[k][wit] for k in ("sx", "sy", "sz")])
    assert float((s.norm(dim=0) - 1.0).abs().max()) < 1e-13
    assert float(s[1].abs().max()) > 1e-6
    assert not tb["sx"][tb["valid"] & (tb["beam_id"] == 0)].any()


def test_steps_output_matches(steps):
    """Each step's openPMD file (every field, each beam's records holding
    only its own particles) and each beam's in-situ file equal the JAX
    package's within 1e-10."""
    case, jres, _, _, jdir, tdir = steps
    ref = _compare_openpmd(tdir, jdir)
    beams = {k.split("/")[3] for k in ref if "/particles/" in f"/{k}"}
    if case != "drive witness":
        assert not beams
        return
    assert beams == {"beam", "witness"}
    pre = jres[0]["binned"]
    valid, bid = np.asarray(pre["valid"]), np.asarray(pre["beam_id"])
    for ib, name in enumerate(("beam", "witness")):
        n = ref[f"data/1/particles/{name}/position/x"][0].size
        assert n == int((valid & (bid == ib)).sum())
        fname = f"reduced_{name}.0000.txt"
        rec = _insitu(jdir / "insitu" / fname)
        assert rec.shape == (2,) and list(rec["step"]) == [0, 1]
        _compare_records(_insitu(tdir / "insitu" / fname), rec, fname)
