"""SALAME beam loading through the port, against the JAX package on CPU in
float64, and the JAX package's SALAME checks through the port.

Functions at 1e-12 relative to the largest value: the SALAME-only beam
deposit, the plasma-only Sx/Sy that SALAME adds back (the port combines the
fused deposit's coefficient grids; the JAX package deposits again), and
salame_slice on two consecutive slices from the same state (a fresh block,
then a carried one, under a zeta-dependent target). Whole steps of
``SALAME_WAKE`` at 32^2 x 64 alone and with test_salame_with_mr's level at
1e-10 relative to each field's largest value: fields, the per-slice W,
SALAME slices and sums, the beams' weights, and the V-cycles of every solve
in order. ROADMAP R20 and the JAX package's SALAME checks are in
``test_torch_salame_physics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
import hipace_tpu.pipeline.step as jstep
from hipace_tpu.parser import Inputs, compile_function
from hipace_tpu.particles import beam as jbm
from hipace_tpu.particles import plasma as jpl
from hipace_tpu.pipeline import salame as jsal
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import SALAME_WAKE
from hipace_tpu_torch.fields.multigrid import MultiGrid
from hipace_tpu_torch.fields.poisson import make_poisson_solver
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.parser import TorchFunction
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline import salame as tsal
from hipace_tpu_torch.pipeline import step as tstep
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_modules import _close
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
FIELD_RTOL = 1e-10
NO_BANDED = "hipace.use_banded = 0\n"
# test_salame_with_mr's level and fine plasma patch, with its fields written
MR = ("amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
      "mr_lev1.patch_lo = -2. -2. -7.\nmr_lev1.patch_hi = 2. 2. 5.\n"
      "plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)\n"
      "plasma.fine_ppc = 4 4\ndiagnostic.names = lev0 lev1\n"
      "lev1.base_geometry = level_1\nlev1.field_data = all\n"
      "lev1.output_period = 1\n")
TARGET = "Ez_initial*(1. + 0.05*(zeta - zeta_initial))"


def _deck(nxy=32, nz=64, npart=30000, extra=""):
    return (SALAME_WAKE.format(nxy=nxy, nz=nz, npart=npart,
                               nwitness=npart // 3) + NO_BANDED + extra)


@pytest.fixture(scope="module")
def sims():
    """Both packages' simulations of a 32^2 x 64 SALAME_WAKE with a
    zeta-dependent target, and the slice of the binned beam that holds
    most of the witness."""
    deck = _deck(extra="hipace.salame_Ez_target(zeta,zeta_initial,"
                 f"Ez_initial) = {TARGET}\n")
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    b = {k: np.array(v) for k, v in jsim.binned.items() if k != "n_dropped"}
    isl = int(np.argmax((b["valid"] & (b["beam_id"] == 1)).sum(axis=1)))
    return jsim, tsim, b, isl


def _slice(b, i, j=None):
    """The binned lanes of slice i (followed by those of slice j), in both
    packages' types."""
    lanes = {k: v[i] if j is None else np.concatenate([v[i], v[j]])
             for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in lanes.items()},
            {k: torch.tensor(v).to(torch.int32) if v.dtype.kind == "i"
             else torch.tensor(v) for k, v in lanes.items()})


def test_deck_reads_the_salame_keys(sims):
    jsim, tsim, _, _ = sims
    jc, tc = jsim.cfg, tsim.cfg
    assert tc.salame_active and jc.salame_active
    assert (tc.salame_n_iter, tc.salame_do_advance, tc.salame_tolerance) == \
        (jc.salame_n_iter, jc.salame_do_advance, jc.salame_tolerance) \
        == (4, True, 1e-4)
    assert [b.do_salame for b in tsim.beam_cfgs] == [False, True]


@pytest.mark.parametrize("quantities", [("jz",), ("jx", "jy", "jz",
                                                  "rhomjz")])
def test_only_salame_deposit(sims, quantities):
    """The SALAME beam's lanes alone, from the merged lanes of both beams
    (the witness's fullest slice and the drive's)."""
    jsim, tsim, b, isl = sims
    drive = int(np.argmax((b["valid"] & (b["beam_id"] == 0)).sum(axis=1)))
    jb, tb = _slice(b, isl, drive)
    g = jsim.geom
    cmap = {q: q for q in quantities}
    zero = {q: np.zeros(g.slice_shape) for q in quantities}
    ref = jbm.deposit_beam_slice(jb, cmap, {q: jnp.asarray(v)
                                            for q, v in zero.items()},
                                 g, jsim.cfg.beams, jsim.pc, 2, True,
                                 only_salame=True)
    charges = tbm.beam_constants(tsim.beam_cfgs, "cpu",
                                 torch.float64)["charges"]
    got = tbm.deposit_beam_slice(tb, cmap, {q: torch.tensor(v)
                                            for q, v in zero.items()},
                                 tsim.geom, tsim.beam_cfgs, tsim.pc, 2, True,
                                 charges, only_salame=True)
    every = tbm.deposit_beam_slice(tb, cmap, {q: torch.tensor(v)
                                              for q, v in zero.items()},
                                   tsim.geom, tsim.beam_cfgs, tsim.pc, 2,
                                   True, charges)
    for q in quantities:
        _close(got[q], ref[q])
    # the beams move along z only: jx and jy are zero
    assert float(got["jz"].abs().max()) > 0
    assert not torch.equal(got["jz"], every["jz"])


def _state(sims, seed):
    """A slice's fields after its level-0 Bx/By solve (chi positive), the
    plasma after its deposit, its fused deposit's coefficient grids, and
    the Next/Previous beam currents, in both packages' types."""
    jsim, tsim, b, isl = sims
    g, tg = jsim.geom, tsim.geom
    rng = np.random.default_rng(seed)
    this = {c: 0.05 * rng.standard_normal(g.slice_shape)
            for c in tstep.THIS_COMPS}
    this["chi"] = 1.0 + 0.1 * rng.uniform(size=g.slice_shape)
    p = {k: np.array(v) for k, v in jpl.init_plasma(
        jsim.plasma_cfgs[0], g, jax.random.PRNGKey(0), jnp.float64).items()}
    n = p["x"].size
    p["x"] = np.clip(p["x"] + 0.05 * rng.standard_normal(n),
                     g.prob_lo[0] + 1e-3, g.prob_hi[0] - 1e-3)
    for k in ("ux", "uy", "ux_half", "uy_half"):
        p[k] = 0.05 * rng.standard_normal(n)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tp["ion_lev"] = tp["ion_lev"].to(torch.int32)
    tthis = {c: torch.tensor(v) for c, v in this.items()}
    _, tp, dg = tpl.fused_plasma_deposits(
        tp, ["jx", "jy", "chi", "rhomjz"], dict(tthis), tg,
        tsim.plasma_cfgs[0], tsim.pc, 2, True)
    p = {k: v.numpy() for k, v in tp.items()}
    nxt = {c: 0.01 * rng.standard_normal(g.slice_shape)
           for c in ("jx_beam", "jy_beam")}
    prv = {c: 0.01 * rng.standard_normal(g.slice_shape)
           for c in ("jx_beam", "jy_beam")}
    return this, p, tp, dg, nxt, prv


def test_plasma_only_sxsy_equals_a_second_deposit(sims):
    """SALAME's plasma Sx/Sy backup: the fused grids combined on zero Sx/Sy
    against the JAX package's explicit_deposition on zero Sx/Sy."""
    jsim, tsim, _, _ = sims
    this, p, _, dg, _, _ = _state(sims, 11)
    f = {c: jnp.asarray(this[c]) for c in ("Bz", "Ez", "ExmBy", "EypBx")}
    f.update(Sx=jnp.zeros(jsim.geom.slice_shape),
             Sy=jnp.zeros(jsim.geom.slice_shape))
    ref = jpl.explicit_deposition({k: jnp.asarray(v) for k, v in p.items()},
                                  f, jsim.geom, jsim.plasma_cfgs[0], jsim.pc,
                                  2, 2, True)
    t = {c: torch.tensor(v) for c, v in this.items()}
    got = tpl.combine_explicit_sxsy(dict(t, Sx=torch.zeros_like(t["Sx"]),
                                         Sy=torch.zeros_like(t["Sy"])),
                                    dg, tsim.pc, tsim.geom)
    for c in ("Sx", "Sy"):
        _close(got[c], ref[c])


def test_salame_slice_matches(sims):
    """Two consecutive SALAME slices (a fresh block, then the carried
    state) from the same fields, plasma and beams: the fields SALAME
    writes, the new weights and the state."""
    jsim, tsim, b, isl = sims
    jcfg, tcfg = jsim.cfg, tsim.cfg
    g = jsim.geom
    jsolver = jstep.make_poisson_solver(jcfg.poisson_solver, g, jnp.float64)
    jmgrid = jmg.MultiGrid(g.nx, g.ny, g.dx, g.dy, jnp.float64)
    target_j = compile_function(TARGET, ("zeta", "zeta_initial",
                                         "Ez_initial"), jcfg.salame_consts)
    tsolver = make_poisson_solver(tcfg.poisson_solver, tsim.geom, "cpu",
                                  torch.float64)
    tmgrid = MultiGrid(g.nx, g.ny, g.dx, g.dy, device="cpu",
                       dtype=torch.float64)
    target_t = TorchFunction(TARGET, ("zeta", "zeta_initial", "Ez_initial"),
                             dict(tcfg.salame_consts))
    charges = tbm.beam_constants(tsim.beam_cfgs, "cpu",
                                 torch.float64)["charges"]
    jst = jsal.empty_salame_state(g, jnp.float64)
    tst = tsal.empty_salame_state(tsim.geom, "cpu", torch.float64)
    for k, i in enumerate((isl, isl - 1)):
        this, p, tp, dg, nxt, prv = _state(sims, 12 + k)
        jb, tb = _slice(b, i)
        j_this, j_beam, jst = jsal.salame_slice(
            jcfg, {c: jnp.asarray(v) for c, v in this.items()},
            {c: jnp.asarray(v) for c, v in nxt.items()},
            {c: jnp.asarray(v) for c, v in prv.items()},
            [{k2: jnp.asarray(v) for k2, v in p.items()}], jb, jst,
            jnp.asarray(i), jsolver, jmgrid, jnp.float64, target_j)
        t_this, t_beam, tst, cycles = tsal.salame_slice(
            tcfg, {c: torch.tensor(v) for c, v in this.items()},
            {c: torch.tensor(v) for c, v in nxt.items()},
            {c: torch.tensor(v) for c, v in prv.items()}, [tp], [dg], tb,
            tst, i, tsolver, tmgrid, target_t, charges)
        assert len(cycles) == 2 * tcfg.salame_n_iter
        for c in ("Bx", "By", "Sx", "Sy", "jz_beam"):
            _close(t_this[c], j_this[c])
        _close(t_beam["w"], j_beam["w"])
        for key in ("W_last", "dbg", "ez_target", "zeta_initial"):
            _close(tst[key], jst[key])
        for key in ("prev_was_salame", "overloaded"):
            assert bool(tst[key]) == bool(jst[key])
        w0 = b["w"][i]
        wit = b["valid"][i] & (b["beam_id"][i] == 1)
        assert wit.any() and not np.allclose(t_beam["w"].numpy()[wit],
                                             w0[wit])
        np.testing.assert_array_equal(t_beam["w"].numpy()[~wit], w0[~wit])


# ---------------------------------------------------------------- steps
@pytest.fixture(scope="module", params=["alone", "with MR"])
def step_case(request):
    """Step 0 of SALAME_WAKE at 32^2 x 64 through both packages from the
    same beams, with the JAX package's V-cycles of every solve in call
    order."""
    deck = _deck(extra=MR if request.param == "with MR" else "")
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(deck), verbose=0)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs])
    return jres, tsim.run_step(0), tsim, cycles


def test_step_fields_match(step_case):
    jres, tres, tsim, _ = step_case
    keys = ["diag"] + [k for k in jres if k.startswith("diagf_")]
    for k in keys:
        ref, got = np.asarray(jres[k]), tres[k].numpy()
        if k != "diag":
            lv = tsim.mr_levels[0]
            ref, got = (a[lv.zeta_lo:lv.zeta_hi + 1] for a in (ref, got))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, err_msg=k,
                                   atol=FIELD_RTOL * np.abs(ref).max())
    assert len(keys) == 1 + len(tsim.mr_levels)


def test_step_salame_outputs_match(step_case):
    """The per-slice W, SALAME slices and sums, and the beams' weights."""
    jres, tres, _, _ = step_case
    np.testing.assert_array_equal(tres["salame_is_sal"].numpy(),
                                  np.asarray(jres["salame_is_sal"]))
    assert int(tres["salame_is_sal"].sum()) == 6
    for k in ("salame_W", "salame_dbg"):
        ref = np.asarray(jres[k])
        np.testing.assert_allclose(tres[k].numpy(), ref, rtol=0,
                                   atol=FIELD_RTOL * np.abs(ref).max())
    jb, tb = jres["binned"], tres["binned"]
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    ref = np.asarray(jb["w"])[valid]
    np.testing.assert_allclose(tb["w"].numpy()[valid], ref, rtol=0,
                               atol=FIELD_RTOL * ref.max())


def test_step_cycles_match(step_case):
    """Every K3 solve's V-cycles in call order: per slice (head first) the
    level-0 solve, SALAME's, then each level's (the JAX package solves a
    level on every slice, the port on the level's own; the JAX package's
    solves of a level outside its slices are dropped here)."""
    _, tres, tsim, cycles = step_case
    lvs = tsim.mr_levels
    got, want, pos = [], [], 0
    for isl in range(tsim.geom.nz - 1, -1, -1):
        sal = tres.get("salame_cycles", {}).get(isl, [])
        got += [tres["mg_cycles"][tsim.geom.nz - 1 - isl]] + sal + [
            tres[f"mg_cycles_lev{i + 1}"][isl] for i, lv in enumerate(lvs)
            if lv.zeta_lo <= isl <= lv.zeta_hi]
        n = 1 + len(sal)
        want += cycles[pos:pos + n]
        pos += n
        for lv in lvs:
            if lv.zeta_lo <= isl <= lv.zeta_hi:
                want.append(cycles[pos])
            pos += 1
    assert pos == len(cycles)
    assert got == want
