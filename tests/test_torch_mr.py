"""Transverse mesh refinement through the port, against the JAX package on
CPU in float64.

Function by function at 1e-12 relative to the largest value (the same
float64 expressions in another order): the level parser and its nesting
error, the level coupler's interpolation, edge bands and Van Loan
correction, the lanes' level tags, the fine plasma patch's lanes, the
masked fine-level deposits and the push's fine gathers with their stale
values. Whole steps of ``MR_WAKE`` at 32^2 x 16 with a level on slices 4-12
(a strict subset of the 16: the port runs a level on its own slices only,
the JAX package on every slice) at 1e-10 relative to each field's largest
value, with equal V-cycles and predictor-corrector iterations on every
slice: the explicit solver at odd and even fine sizes, the
predictor-corrector, two levels (nested in z, and not), a laser on both
solvers, the level's background interpolated from level 0; each level's
diagnostics over its slices, the beam, and the openPMD file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.mr as jmr
import hipace_tpu.fields.multigrid as jmg
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import plasma as jpl
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import MR_WAKE
from hipace_tpu_torch.fields import mr as tmr
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_diagnostics import _close as _close_item
from test_torch_diagnostics import _h5_items, _same_attrs
from test_torch_modules import (GEOM, PC, TGEOM, TPC, _close, _fields,
                                _plasma_state, _to_torch)
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
FIELD_RTOL = 1e-10
BEAM_RTOL = 1e-12
NO_BANDED = "hipace.use_banded = 0\n"
LASER = ("lasers.names = laser\nlasers.lambda0 = .8e-6\n"
         "lasers.solver_type = multigrid\nlaser.a0 = 1.\n"
         "laser.position_mean = 0. 0. 0.\nlaser.w0 = 2.\nlaser.L0 = 1.\n")
# the level's every comp in 3-D, and MR_WAKE's own on-axis xz line
ALL_LEV1 = ("diagnostic.names = lev0 lev1 axis1\n"
            "lev1.base_geometry = level_1\nlev1.field_data = all\n"
            "lev1.diag_type = xyz\naxis1.base_geometry = level_1\n"
            "axis1.field_data = Ez\naxis1.diag_type = xz\n"
            "axis1.output_period = 1\n")
TWO_LEVELS = ("amr.max_level = 2\nmr_lev2.n_cell = 32 32\n"
              "mr_lev2.patch_lo = -0.9 -0.9 -3.\n"
              "mr_lev2.patch_hi = 0.9 0.9 -1.\n"
              "diagnostic.names = lev0 lev1 axis1 lev2\n"
              "lev2.base_geometry = level_2\nlev2.field_data = all\n"
              "lev2.output_period = 1\n")
PC_SOLVER = "hipace.bxby_solver = predictor-corrector\n"
# name: (fine size, deck lines) on MR_WAKE at 32^2 x 16 with 1000 particles
STEP_CASES = {
    "explicit odd 31^2": (31, ""),
    "explicit even 32^2": (32, ""),
    "predictor-corrector": (31, PC_SOLVER),
    "two levels": (32, TWO_LEVELS),
    "laser": (31, LASER),
    "predictor-corrector laser": (31, PC_SOLVER + LASER),
    "interpolated background": (
        31, "hipace.interpolate_neutralizing_background = 1\n"),
    # level 2's z range reaches past level 1's: every level on every slice
    "two levels, the finer one longer": (32, TWO_LEVELS.replace(
        "mr_lev2.patch_lo = -0.9 -0.9 -3.", "mr_lev2.patch_lo = -0.9 -0.9 -5.")),
}


def _deck(nfine, extra):
    return (MR_WAKE.format(nxy=32, nz=16, npart=1000, nfine=nfine)
            + NO_BANDED + ALL_LEV1 + extra)


def _geoms(nfine=31):
    """The level's geometry in both packages, parsed from one deck."""
    deck = _deck(nfine, "")
    jinp, tinp = Inputs(deck), TInputs(deck)
    from hipace_tpu.geometry import Geometry as JG
    from hipace_tpu_torch.geometry import Geometry as TG
    jg0, tg0 = JG.from_inputs(jinp), TG.from_inputs(tinp)
    return (jmr.parse_mr_levels(jinp, jg0), tmr.parse_mr_levels(tinp, tg0),
            jg0, tg0)


# ---------------------------------------------------------------- functions
def test_parse_mr_levels_matches():
    jl, tl, _, _ = _geoms()
    assert len(jl) == len(tl) == 1
    for a, b in zip(jl, tl):
        assert (a.zeta_lo, a.zeta_hi) == (b.zeta_lo, b.zeta_hi) == (4, 12)
        assert a.geom.n_cell == b.geom.n_cell == (31, 31, 9)
        np.testing.assert_allclose(b.geom.prob_lo, a.geom.prob_lo, rtol=0,
                                   atol=1e-15)
        np.testing.assert_allclose(b.geom.prob_hi, a.geom.prob_hi, rtol=0,
                                   atol=1e-15)


def test_parse_mr_levels_nesting_error():
    """A level that reaches the domain's edge raises in both packages."""
    deck = _deck(31, "mr_lev1.patch_lo = -7.9 -2. -4.\n")
    from hipace_tpu.geometry import Geometry as JG
    from hipace_tpu_torch.geometry import Geometry as TG
    with pytest.raises(ValueError, match="nested"):
        jmr.parse_mr_levels(Inputs(deck), JG.from_inputs(Inputs(deck)))
    with pytest.raises(ValueError, match="nested"):
        tmr.parse_mr_levels(TInputs(deck), TG.from_inputs(TInputs(deck)))


@pytest.fixture(scope="module")
def couplers():
    jl, tl, jg0, tg0 = _geoms()
    return (jmr.LevelCoupler(jg0, jl[0].geom, jnp.float64),
            tmr.LevelCoupler(tg0, tl[0].geom, torch.float64, "cpu"), jg0)


def test_level_coupler_up_full(couplers):
    jc, tc, g0 = couplers
    c = np.random.default_rng(1).standard_normal(g0.slice_shape)
    _close(tc.up_full(torch.tensor(c)), jc.up_full(jnp.asarray(c)))


@pytest.mark.parametrize("outer,inner", [(1, -1), (0, -1), (0, -2), (2, 0)])
def test_level_coupler_up_boundary(couplers, outer, inner):
    """Every band the step uses: the sources' (1, -G+1) and (0, -G+1), the
    Sx/Sy and trial currents' (0, -G), the ghost fill's (G, 0)."""
    jc, tc, g0 = couplers
    rng = np.random.default_rng(2)
    c = rng.standard_normal(g0.slice_shape)
    f = rng.standard_normal(tc.fine.slice_shape)
    _close(tc.up_boundary(torch.tensor(f), torch.tensor(c), outer, inner),
           jc.up_boundary(jnp.asarray(f), jnp.asarray(c), outer, inner))
    assert tc.up_boundary(torch.tensor(f), torch.tensor(c), 1, 1).numpy() \
        .tolist() == f.tolist()


@pytest.mark.parametrize("offset,factor", [(1.0, 1.0), (0.5, 8.0 / 3.0)])
def test_level_coupler_apply_bc(couplers, offset, factor):
    jc, tc, g0 = couplers
    rng = np.random.default_rng(3)
    c = rng.standard_normal(g0.slice_shape)
    rhs = rng.standard_normal((tc.fine.ny, tc.fine.nx))
    _close(tc.apply_bc(torch.tensor(rhs), torch.tensor(c), offset, factor),
           jc.apply_bc(jnp.asarray(rhs), jnp.asarray(c), offset, factor))


def test_tag_by_level_matches():
    """Two nested levels; lanes inside, outside, on the edges, invalid."""
    deck = _deck(32, TWO_LEVELS)
    from hipace_tpu.geometry import Geometry as JG
    from hipace_tpu_torch.geometry import Geometry as TG
    jl = jmr.parse_mr_levels(Inputs(deck), JG.from_inputs(Inputs(deck)))
    tl = tmr.parse_mr_levels(TInputs(deck), TG.from_inputs(TInputs(deck)))
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-3, 3, 2000), [-2.0, 2.0, -0.9, 0.9]])
    y = np.concatenate([rng.uniform(-3, 3, 2000), [0.0, 0.0, 0.0, -0.9]])
    valid = rng.uniform(size=x.size) > 0.1
    ref = jmr.tag_by_level(jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(valid), [lv.geom for lv in jl])
    got = tmr.tag_by_level(torch.tensor(x), torch.tensor(y),
                           torch.tensor(valid), [lv.geom for lv in tl])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert set(np.unique(np.asarray(ref)).tolist()) == {0, 1, 2}


@pytest.mark.parametrize("transition", [5, 2])
def test_fine_patch_positions_match(transition):
    """The fine patch's lanes, with the transition counter and the
    smoothstep, and plasma_count."""
    deck = _deck(31, f"plasma.fine_transition_cells = {transition}\n"
                 "plasma.ppc = 1 2\nplasma.fine_ppc = 3 2\n")
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    jcfg, tcfg = jsim.plasma_cfgs[0], tsim.plasma_cfgs[0]
    assert tcfg.fine_patch_expr and tcfg.fine_ppc == (3, 2)
    assert tcfg.fine_transition_cells == transition
    ref = jpl._fine_patch_positions(jcfg, jsim.geom, jnp.float64, True)
    got = tpl._fine_patch_positions(tcfg, tsim.geom, True)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-13)
    n = jpl.plasma_count(jcfg, jsim.geom, jnp.float64)
    assert tpl.plasma_count(tcfg, tsim.geom) == n == 32 * 32 * 6
    p = tpl.init_plasma(tcfg, tsim.geom, "cpu", torch.float64)
    jp = jpl.init_plasma(jcfg, jsim.geom, jax.random.PRNGKey(0), jnp.float64)
    for k in ("x", "y", "w", "valid"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-13)


def _fine_setup():
    """A fine level over part of GEOM, the plasma state of
    test_torch_modules with its lanes tagged by that level."""
    from hipace_tpu.geometry import Geometry as JG
    from hipace_tpu_torch.geometry import Geometry as TG
    kw = dict(n_cell=(24, 20, 16), prob_lo=(-1.5, -1.25, -6.0),
              prob_hi=(1.5, 1.25, 2.0), nguards=2)
    jfg, tfg = JG(**kw), TG(**kw)
    jcfg, tcfg, p = _plasma_state(31)
    tag = np.asarray(jmr.tag_by_level(jnp.asarray(p["x"]), jnp.asarray(p["y"]),
                                      jnp.asarray(p["valid"]), [jfg]))
    return jfg, tfg, jcfg, tcfg, p, tag


@pytest.mark.parametrize("comps", [["jx", "jy", "chi", "rhomjz"],
                                   ["jx", "jy", "jz", "rhomjz", "rho"]])
def test_masked_fine_deposit(comps):
    """deposit_plasma on a fine level: the tagged lanes at the level-0
    density; the returned state keeps every lane as the JAX package's."""
    jfg, tfg, jcfg, tcfg, p, tag = _fine_setup()
    assert 0 < (tag == 1).sum() < p["x"].size
    zero = {c: np.zeros(jfg.slice_shape) for c in comps}
    ref, jp = jpl.deposit_plasma(
        {k: jnp.asarray(v) for k, v in p.items()}, comps,
        {c: jnp.asarray(v) for c, v in zero.items()}, jfg, jcfg, PC, 2, True,
        extra_mask=jnp.asarray(tag >= 1), geom0=GEOM)
    got, tp = tpl.deposit_plasma(
        _to_torch(p), comps, {c: torch.tensor(v) for c, v in zero.items()},
        tfg, tcfg, TPC, 2, True, extra_mask=torch.tensor(tag >= 1),
        geom0=TGEOM)
    for c in comps:
        _close(got[c], ref[c])
        assert np.abs(np.asarray(ref[c])).max() > 0
    np.testing.assert_array_equal(tp["valid"].numpy(), np.asarray(jp["valid"]))


@pytest.mark.parametrize("deriv_type", [2, 1])
def test_masked_fine_explicit_deposit(deriv_type):
    """The fused fine deposit's main comps and, combined on fine fields, its
    Sx/Sy against the JAX package's deposit_plasma + explicit_deposition
    with the mask, from a state the level-0 deposit has already held to
    the QSA bound (as the step's is)."""
    jfg, tfg, jcfg, tcfg, p, tag = _fine_setup()
    # the level-0 deposit invalidates the QSA-violating lanes first
    _, p0 = jpl.deposit_plasma({k: jnp.asarray(v) for k, v in p.items()},
                               ["rhomjz"], {"rhomjz": jnp.zeros(
                                   GEOM.slice_shape)}, GEOM, jcfg, PC, 2, True)
    p = {k: np.array(v) for k, v in p0.items()}
    comps = ["jx", "jy", "chi", "rhomjz"]
    f = {**{c: np.zeros(jfg.slice_shape) for c in comps + ["Sx", "Sy"]},
         **{c: 0.1 * np.random.default_rng(5).standard_normal(
             jfg.slice_shape) for c in ("Ez", "Bz", "ExmBy", "EypBx")}}
    mask = tag >= 1
    ref, _ = jpl.deposit_plasma({k: jnp.asarray(v) for k, v in p.items()},
                                comps, {c: jnp.asarray(v)
                                        for c, v in f.items()},
                                jfg, jcfg, PC, 2, True,
                                extra_mask=jnp.asarray(mask), geom0=GEOM)
    ref = jpl.explicit_deposition({k: jnp.asarray(v) for k, v in p.items()},
                                  ref, jfg, jcfg, PC, 2, deriv_type, True,
                                  extra_mask=jnp.asarray(mask), geom0=GEOM)
    got, _, dg = tpl.fused_plasma_deposits(
        _to_torch(p), comps, {c: torch.tensor(v) for c, v in f.items()}, tfg,
        tcfg, TPC, 2, True, deriv_type=deriv_type,
        extra_mask=torch.tensor(mask), geom0=TGEOM)
    got = tpl.combine_explicit_sxsy(got, dg, TPC, tfg)
    for c in comps + ["Sx", "Sy"]:
        _close(got[c], ref[c])


@pytest.mark.parametrize("n_subcycles", [1, 3])
def test_fine_gathers_with_stale_values(n_subcycles):
    """advance_plasma with a fine level: a tagged lane gathers from the
    level, and keeps the last subcycle's values once it has left it."""
    import dataclasses
    jfg, tfg, jcfg, tcfg, p, tag = _fine_setup()
    jcfg = dataclasses.replace(jcfg, n_subcycles=n_subcycles)
    tcfg = dataclasses.replace(tcfg, n_subcycles=n_subcycles)
    # fast lanes, so that subcycles carry some out of the level
    p["ux_half"] = 3.0 * p["ux_half"]
    names = ("Psi", "Ez", "Bx", "By", "Bz")
    f0 = _fields(6, names)
    rng = np.random.default_rng(7)
    ff = {n: 0.1 * rng.standard_normal(jfg.slice_shape) for n in names}
    ref = jpl.advance_plasma(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in f0.items()}, GEOM, jcfg, PC,
        temp_slice=False, order=2,
        fine_levels=(({k: jnp.asarray(v) for k, v in ff.items()}, jfg),),
        tag=jnp.asarray(tag))
    got = tpl.advance_plasma(
        _to_torch(p), {k: torch.tensor(v) for k, v in f0.items()}, TGEOM,
        tcfg, TPC, order=2,
        fine_levels=(({k: torch.tensor(v) for k, v in ff.items()}, tfg),),
        tag=torch.tensor(tag))
    v = p["valid"]
    for k in ("x", "y", "ux", "uy", "psi", "ux_half", "psi_half"):
        _close(got[k].numpy()[v], np.asarray(ref[k])[v])
    # the level changed the push
    plain = tpl.advance_plasma(_to_torch(p), {k: torch.tensor(v)
                                              for k, v in f0.items()},
                               TGEOM, tcfg, TPC, order=2)
    assert not np.allclose(plain["ux"].numpy()[v], got["ux"].numpy()[v])


# ---------------------------------------------------------------- steps
@pytest.fixture(scope="module", params=list(STEP_CASES))
def step_case(request, tmp_path_factory):
    """One time step of MR_WAKE at 32^2 x 16 through both packages from the
    same beam, each writing its openPMD output (h5): (JAX result, port
    result, the port's simulation, the two output folders, the JAX
    package's V-cycles of every multigrid solve in call order)."""
    nfine, extra = STEP_CASES[request.param]
    base = tmp_path_factory.mktemp("mr")
    dirs = {k: base / k for k in ("jax", "port")}
    decks = {k: _deck(nfine, extra) + f"hipace.file_prefix = {d}\n"
             "hipace.openpmd_backend = h5\n" for k, d in dirs.items()}
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(decks["jax"]), verbose=0)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(decks["port"]), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs],
                laser_stream=None)
    pre_t = tsim.binned
    jsim._write_diagnostics(0, jres, jsim.binned)
    tres = tsim.run_step(0)
    tsim.write_output(0, tres, pre_t)
    return jres, tres, tsim, dirs, cycles


def test_step_fields_match(step_case):
    """Level 0's every comp on every slice; each level's every comp on its
    own slices."""
    jres, tres, tsim, _, _ = step_case
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    assert got.shape == ref.shape
    for i, comp in enumerate(tsim.cfg.diag_comps):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))
    diags = [dg for dg in tsim.cfg.diags if dg.base != "level_0"]
    assert {dg.base for dg in diags} == {f"level_{i + 1}" for i in range(
        len(tsim.mr_levels))}
    for dg in diags:
        name, lv = dg.name, tsim.mr_levels[int(dg.base[-1]) - 1]
        rows = slice(lv.zeta_lo, lv.zeta_hi + 1)
        r = np.asarray(jres["diagf_" + name])[rows]
        t = tres["diagf_" + name].numpy()[rows]
        assert t.shape == r.shape and t.shape[-1] == lv.geom.nx
        for i in range(r.shape[1]):
            np.testing.assert_allclose(
                t[:, i], r[:, i], rtol=0, err_msg=f"{name} {i}",
                atol=FIELD_RTOL * max(np.abs(r[:, i]).max(), 1e-300))
        # where the port runs a level on its own slices only, it leaves the
        # rows outside them zero
        if tsim.slice_step.mr_skip:
            assert not tres["diagf_" + name][:lv.zeta_lo].any()
    lvs = tsim.mr_levels
    if len(lvs) == 2 and lvs[1].zeta_lo < lvs[0].zeta_lo:
        assert not tsim.slice_step.mr_skip


def test_step_iterations_match(step_case):
    """PC iterations on every slice; under the explicit solver the V-cycles
    of every multigrid solve, every level's."""
    jres, tres, tsim, _, cycles = step_case
    want = np.asarray(jres["pc_iters"]).tolist()[::-1]
    assert tres["pc_iters"] == want
    if not tsim.cfg.explicit:
        assert sum(want) > tsim.geom.nz
        return
    nz, lvs = tsim.geom.nz, tsim.mr_levels
    runs = [range(lv.zeta_lo, lv.zeta_hi + 1) if tsim.slice_step.mr_skip
            else range(nz) for lv in lvs]
    for i, r in enumerate(runs):
        assert sorted(tres[f"mg_cycles_lev{i + 1}"]) == list(r)
    if tsim.cfg.use_laser:
        return      # the envelope's complex solves interleave in the JAX list
    # per slice, head first: level 0's solve, then every level's (the JAX
    # package solves each level on every slice; the port on those it runs)
    got, ref = [], []
    for k, isl in enumerate(range(nz - 1, -1, -1)):
        got.append(tres["mg_cycles"][k])
        ref.append(cycles[k * (1 + len(lvs))])
        for i, r in enumerate(runs):
            if isl in r:
                got.append(tres[f"mg_cycles_lev{i + 1}"][isl])
                ref.append(cycles[k * (1 + len(lvs)) + 1 + i])
    assert len(cycles) == nz * (1 + len(lvs))
    assert got == ref


def test_step_beam_matches(step_case):
    jres, tres, _, _, _ = step_case
    jb, tb = jres["binned"], tres["binned"]
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
        ref = np.asarray(jb[k])[valid]
        np.testing.assert_allclose(tb[k].numpy()[valid], ref, rtol=0,
                                   atol=BEAM_RTOL * np.abs(ref).max())


def test_step_openpmd_matches(step_case):
    """The step's openPMD file, level diagnostics included: every group,
    dataset and attribute (the levels' spacings and offsets)."""
    _, _, _, dirs, _ = step_case
    name = "openpmd_000000.h5"
    ref = _h5_items(dirs["jax"] / name)
    got = _h5_items(dirs["port"] / name)
    assert sorted(got) == sorted(ref)
    assert any("lev1" in k for k in ref)
    for item, (data, attrs) in ref.items():
        _same_attrs(got[item][1], attrs, item)
        if data is not None:
            _close_item(got[item][0], data, item)


def test_port_never_turns_tf32_on(tmp_path):
    """The couplers' matmuls need full float32 on the card: no source of the
    port turns TF32 on, and a CLI run leaves PyTorch's defaults."""
    import pathlib
    from hipace_tpu_torch.__main__ import main
    root = pathlib.Path(tmr.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "allow_tf32" not in text, path
        assert "set_float32_matmul_precision" not in text, path
    deck = tmp_path / "deck"
    deck.write_text(MR_WAKE.format(nxy=16, nz=8, npart=200, nfine=15)
                    + f"hipace.file_prefix = {tmp_path}/out\n"
                    "hipace.verbose = 0\n")
    assert main([str(deck), "--device", "cpu"]) == 0
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


ION_MR = """
amr.max_level = 1
mr_lev1.n_cell = 32 32
mr_lev1.patch_lo = -6.e-6 -6.e-6 -10.e-6
mr_lev1.patch_hi = 6.e-6 6.e-6 20.e-6
ion.fine_patch(x,y) = (abs(x)<7.e-6)*(abs(y)<7.e-6)
ion.fine_ppc = 2 2
diagnostic.names = lev0 lev1
lev1.base_geometry = level_1
lev1.field_data = all
lev1.output_period = 1
hipace.openpmd_backend = json
"""


def test_ionization_with_mr_matches():
    """IONIZATION_WAKE at 32^2 x 16 with a level and a fine patch on the
    ionizing species, the port on the JAX package's uniforms: both levels'
    fields at 1e-10."""
    from hipace_tpu_torch.decks import IONIZATION_WAKE
    from jax_draws import JaxSliceDraws
    deck = IONIZATION_WAKE.format(nxy=32, nz=16) + NO_BANDED + ION_MR
    jsim = JSimulation(Inputs(deck), verbose=0)
    draws = JaxSliceDraws(jsim)
    jres = jsim.run_step(0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs])
    tsim.slice_step.draws = draws
    tres = tsim.run_step(0)
    lv = tsim.mr_levels[0]
    rows = slice(lv.zeta_lo, lv.zeta_hi + 1)
    for k, sl_ in (("diag", slice(None)), ("diagf_lev1", rows)):
        ref = np.asarray(jres[k])[sl_]
        np.testing.assert_allclose(tres[k].numpy()[sl_], ref, rtol=0,
                                   atol=FIELD_RTOL * np.abs(ref).max())
    assert int(tres["ionized"]) > 0
