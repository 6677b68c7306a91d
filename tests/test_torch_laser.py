"""The port's laser envelope against the JAX package's, on CPU in float64.

Module by module, from the same inputs made with numpy: the complex
multigrid's plain version (both grid conventions, a complex acf plane and a
real plane plus a complex scalar, equal V-cycle counts), the initial
envelope (gaussian pulses, several summed, a parsed one), the envelope
advance (multigrid and FFT solvers, the first-step and the centred
variant), the |a|^2 gather, the laser terms of the plasma push, deposit and
explicit Sx/Sy deposit, the cross-grid interpolation, the in-situ laser
moments and record, and the from-file reader in its xyt, xyz and rt layouts
on files written here. Then whole runs of two steps of the laser-driven
blowout (``hipace_tpu_torch.decks.LASER_WAKE``, 31^2 x 8): explicit Bx/By
with the multigrid laser solver and a separate, even (cell-centred) laser
grid, each writing openPMD files (``laserEnvelope`` included) and in-situ
laser records that must match the JAX package's file for file; and the
predictor-corrector with the FFT laser solver, in a (-10..10)^2 box (in the
deck's own (-20..20)^2 box at 31^2 the predictor-corrector runs its 30
iterations on 7 of 8 slices and a change of a0 by 2e-15 moves slice 0's By
by 0.3%, in either package: no comparison can hold there). Every value
within 1e-10 of the JAX package's (relative to the largest of its array),
real and complex V-cycles and PC iterations equal on every slice.
"""

import json
import math
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.constants import NORMALIZED as JPC
from hipace_tpu.diagnostics import insitu as jins
from hipace_tpu.fields import laser as jlz
from hipace_tpu.fields import multigrid as jmg
from hipace_tpu.fields.mr import GridInterp as JGridInterp
from hipace_tpu.geometry import Geometry as JGeometry
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import plasma as jpl
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.constants import NORMALIZED as TPC
from hipace_tpu_torch.decks import LASER_WAKE
from hipace_tpu_torch.diagnostics import insitu as tins
from hipace_tpu_torch.fields import laser as tlz
from hipace_tpu_torch.fields.grid_interp import GridInterp
from hipace_tpu_torch.fields.multigrid import MultiGrid
from hipace_tpu_torch.geometry import Geometry
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
RTOL = 1e-10
ATOL = 1e-14


def _close(got, ref, what="", rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype.kind in "iubS":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = np.abs(ref).max() if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=max(ATOL, rtol * scale), err_msg=what)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _counting_solve(cycles):
    """The XLA branch of hipace_tpu's MultiGrid.solve, its V-cycle count
    and whether the system is complex sent to the host."""
    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2, fused=None):
        acfs = self._coarsen_acf(acf)
        res0 = jnp.max(jnp.abs(rhs - self.apply_op(u0, acfs[0], 0)))
        target = jnp.maximum(tol_abs, jnp.maximum(tol_rel, 1e-16)
                             * jnp.maximum(res0, jnp.max(jnp.abs(rhs))))

        def body(c):
            u, _, it = c
            u = self._vcycle(u, rhs, acfs, 0, nu1, nu2)
            return (u, jnp.max(jnp.abs(rhs - self.apply_op(u, acfs[0], 0))),
                    it + 1)

        u, _, it = jax.lax.while_loop(
            lambda c: (c[1] > target) & (c[2] < max_iters), body,
            (u0, res0, jnp.zeros((), jnp.int32)))
        cplx = bool(jnp.iscomplexobj(u0))
        jax.debug.callback(lambda n: cycles.append((cplx, int(n))), it,
                           ordered=True)
        return u
    return solve


# ---------------------------------------------------------------- multigrid
@pytest.mark.parametrize("ny,nx,acf_kind,tol_rel", [
    (31, 31, "plane", 1e-4), (63, 31, "plane+scalar", 1e-9),
    (32, 32, "plane+scalar", 1e-4), (96, 64, "plane", 1e-9)])
def test_complex_multigrid_matches_jax(ny, nx, acf_kind, tol_rel):
    rng = np.random.default_rng(ny * nx)
    dx, dy = 0.3, 0.4
    c = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    rhs, u0 = c((ny, nx)), 0.1 * c((ny, nx))
    chi = np.abs(rng.standard_normal((ny, nx)))
    acf_r, acf_i = 20.0 + chi, -15.0
    acf = acf_r + 1j * acf_i
    if acf_kind == "plane":
        tacf = _t(acf)
    else:
        tacf = (_t(acf_r), torch.tensor(complex(0.0, acf_i)))
    cycles = []
    jm = jmg.MultiGrid(nx, ny, dx, dy, jnp.float64)
    ref = _counting_solve(cycles)(jm, jnp.asarray(u0), jnp.asarray(rhs),
                                  jnp.asarray(acf), tol_rel=tol_rel)
    jax.effects_barrier()
    mg = MultiGrid(nx, ny, dx, dy)
    got = mg.solve(_t(u0), _t(rhs), tacf, tol_rel=tol_rel)
    assert got.dtype == torch.complex128
    _close(got.numpy(), ref)
    assert cycles == [(True, mg.last_cycles)] and mg.last_cycles > 0


def test_complex_apply_op_and_acf_forms():
    """apply_op of a complex system, the two acf forms give one solve, and
    the node-centred acf denominator is exactly one."""
    rng = np.random.default_rng(1)
    mg = MultiGrid(31, 31, 0.2, 0.2)
    u = rng.standard_normal((31, 31)) + 1j * rng.standard_normal((31, 31))
    acf = 5.0 + rng.random((31, 31)) - 3j
    jm = jmg.MultiGrid(31, 31, 0.2, 0.2, jnp.float64)
    _close(mg.apply_op(_t(u), _t(acf)).numpy(),
           np.asarray(jm.apply_op(jnp.asarray(u), jnp.asarray(acf), 0)))
    a = mg.solve(_t(u), _t(u), _t(acf))
    b = mg.solve(_t(u), _t(u), (_t(acf.real), -3j))
    assert torch.equal(a, b)
    for lev in range(mg.nlevels - 1):
        assert torch.equal(getattr(mg, f"acf_den{lev}"),
                           torch.ones_like(getattr(mg, f"acf_den{lev}")))


# ------------------------------------------------------------ laser config
PULSES = """
lasers.names = l1 l2 l3
lasers.lambda0 = .8e-6
l1.a0 = 2.
l1.w0 = 3.
l1.L0 = 1.5
l1.position_mean = 0.5 -0.3 1.
l1.focal_distance = 2.
l1.CEP = 0.3
l2.a0 = 1.
l2.w0 = 2.
l2.L0 = 1.
l2.position_mean = 0. 0. -2.
l2.propagation_angle_yz = 0.01
l2.PFT_yz = 1.4
l3.laser_real(x,y,z) = 0.1*exp(-(x*x+y*y)/4.-z*z)
l3.laser_imag(x,y,z) = 0.05*x*exp(-(x*x+y*y)/4.-z*z)
"""
GEOM = dict(n_cell=(31, 33, 12), prob_lo=(-6., -7., -4.),
            prob_hi=(6., 7., 4.), nguards=2)


def _configs(deck):
    jcfg = jlz.LaserConfig.from_inputs(Inputs(deck), JPC)
    tcfg = tlz.LaserConfig.from_inputs(TInputs(deck), TPC)
    return jcfg, tcfg


def test_laser_config_reads_the_deck():
    jcfg, tcfg = _configs(PULSES)
    assert len(tcfg.pulses) == 3 and tcfg.solver_type == "multigrid"
    for jp, tp in zip(jcfg.pulses, tcfg.pulses):
        for k in ("init_type", "a0", "w0", "L0", "CEP", "focal_distance",
                  "position_mean", "propagation_angle_yz", "PFT_yz"):
            assert getattr(jp, k) == getattr(tp, k), k


@pytest.mark.parametrize("z", [-3.1, -0.2, 0.0, 1.7])
def test_envelope_slice_matches(z):
    jcfg, tcfg = _configs(PULSES)
    ref = jlz.envelope_slice(jcfg, JGeometry(**GEOM), z, jnp.float64)
    got = tlz.envelope_slice(tcfg, Geometry(**GEOM), z, torch.float64)
    _close(got.numpy(), np.asarray(ref))


def test_geometry_chi_and_phase_match():
    deck = LASER_WAKE.format(nxy=31, nz=8, npart=0) + (
        "lasers.n_cell = 40 36\nlasers.patch_lo = -9. -8. -3.\n"
        "lasers.patch_hi = 9. 8. 2.\n")
    jg0, tg0 = (JGeometry.from_inputs(Inputs(deck)),
                Geometry.from_inputs(TInputs(deck)))
    jg, *jz = jlz.make_laser_geometry(Inputs(deck), jg0)
    tg, *tz = tlz.make_laser_geometry(TInputs(deck), tg0)
    assert tz == jz and tg.n_cell == jg.n_cell
    np.testing.assert_allclose(tg.prob_lo, jg.prob_lo, rtol=1e-15)
    np.testing.assert_allclose(tg.prob_hi, jg.prob_hi, rtol=1e-15)
    same = LASER_WAKE.format(nxy=31, nz=8, npart=0)
    assert tlz.make_laser_geometry(TInputs(same), tg0)[0] is tg0
    jps = (jpl.PlasmaConfig.from_inputs(Inputs(deck), "plasma", JPC,
                                        "Periodic"),)
    tps = (tpl.PlasmaConfig.from_inputs(TInputs(deck), "plasma", TPC,
                                        "Periodic"),)
    _close(tlz.initial_chi(tps, tg, TPC, 0.5, torch.float64).numpy(),
           np.asarray(jlz.initial_chi(None, jps, jg, JPC, 0.5, jnp.float64)))
    rng = np.random.default_rng(2)
    for shape in ((35, 35), (36, 40), (37, 36)):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        g = dict(GEOM, n_cell=(shape[1] - 4, shape[0] - 4, 4))
        assert float(tlz.on_axis_phase(_t(a), Geometry(**g))) == \
            pytest.approx(float(jlz._on_axis_phase(jnp.asarray(a),
                                                   JGeometry(**g))),
                          abs=1e-15)


def _random_state(shape, rng):
    return {k: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            for k in tlz.STATE_KEYS}


@pytest.mark.parametrize("solver", ["multigrid", "fft"])
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("even", [False, True])
def test_laser_advance_matches(solver, step, even):
    n = 32 if even else 31
    deck = (PULSES + f"lasers.solver_type = {solver}\n"
            + ("lasers.MG_average_rhs = 0\n" if step else ""))
    jcfg, tcfg = _configs(deck)
    geom = dict(GEOM, n_cell=(n, n, 12))
    jg, tg = JGeometry(**geom), Geometry(**geom)
    rng = np.random.default_rng(10 + step)
    state = _random_state(tg.slice_shape, rng)
    chi = np.abs(rng.standard_normal(tg.slice_shape))
    dt = 3.0
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        ref = jlz.make_laser_advance(jcfg, jg, JPC, jnp.float64)(
            {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(chi),
            dt, step)
        jax.effects_barrier()
    adv = tlz.make_laser_advance(tcfg, tg, TPC, torch.float64)
    got = adv({k: _t(v) for k, v in state.items()}, _t(chi), dt, step)
    _close(got.numpy(), np.asarray(ref))
    if solver == "multigrid":
        assert cycles == [(True, adv.mg.last_cycles)]
    else:
        assert adv.mg is None and cycles == []


# ------------------------------------------------------- gather and plasma
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_gather_laser_aabs_matches(order):
    from hipace_tpu.ops.gather import gather_laser_aabs as jgather
    from hipace_tpu_torch.ops.gather import gather_laser_aabs
    rng = np.random.default_rng(order)
    geom = dict(GEOM, nguards=(order + 1) // 2 + 1)
    jg, tg = JGeometry(**geom), Geometry(**geom)
    x = rng.uniform(-7, 7, 3000)
    y = rng.uniform(-8, 8, 3000)
    aabs = rng.random(tg.slice_shape)
    ref = jgather(jnp.asarray(x), jnp.asarray(y), jnp.asarray(aabs), jg,
                  order)
    got = gather_laser_aabs(_t(x), _t(y), _t(aabs), tg, order)
    for r, gv in zip(ref, got):
        _close(gv.numpy(), np.asarray(r))


def _plasma_case(seed):
    """A warm plasma slice (all lanes valid) and a slice's fields with an
    |a|^2 plane, as numpy."""
    rng = np.random.default_rng(seed)
    deck = LASER_WAKE.format(nxy=31, nz=8, npart=0)
    g = Geometry.from_inputs(TInputs(deck))
    pcfg = tpl.PlasmaConfig.from_inputs(TInputs(deck), "plasma", TPC,
                                        "Periodic")
    p = {k: v.numpy() for k, v in tpl.init_plasma(
        pcfg, g, "cpu", torch.float64).items()}
    n = p["x"].size
    for k, s in (("ux", .3), ("uy", .3), ("ux_half", .3), ("uy_half", .3)):
        p[k] = p[k] + s * rng.standard_normal(n)
    # moved by up to a cell, kept a cell inside the box like pushed lanes
    for k, d in (("x", g.dx), ("y", g.dy), ("x_prev", g.dx),
                 ("y_prev", g.dy)):
        ax = 0 if k[0] == "x" else 1
        p[k] = np.clip(p[k] + d * rng.uniform(-1, 1, n),
                       g.prob_lo[ax] + d, g.prob_hi[ax] - d)
    p["psi"] = p["psi"] * (1 + 0.1 * rng.random(n))
    p["psi_half"] = p["psi"].copy()
    fields = {c: 0.1 * rng.standard_normal(g.slice_shape)
              for c in ("Psi", "Ez", "Bx", "By", "Bz", "ExmBy", "EypBx",
                        "Sx", "Sy", "jx", "jy", "jz", "chi", "rhomjz")}
    fields["aabs"] = 4.0 * rng.random(g.slice_shape)
    return deck, g, pcfg, p, fields


@pytest.mark.parametrize("pusher", ["leapfrog", "ab5"])
def test_plasma_push_laser_terms_match(pusher):
    deck, g, pcfg, p, fields = _plasma_case(3)
    if pusher == "ab5":
        rng = np.random.default_rng(5)
        for f in tpl.AB5_FIELDS:
            for i in range(1, 6):
                p[f"{f}{i}"] = 0.01 * rng.standard_normal(p["x"].size)
    jg = JGeometry.from_inputs(Inputs(deck))
    jcfg = jpl.PlasmaConfig.from_inputs(Inputs(deck), "plasma", JPC,
                                        "Periodic")
    ref = jpl.advance_plasma({k: jnp.asarray(v) for k, v in p.items()},
                             {k: jnp.asarray(v) for k, v in fields.items()},
                             jg, jcfg, JPC, temp_slice=False, order=2,
                             use_laser=True, pusher=pusher)
    got = tpl.advance_plasma({k: _t(v) for k, v in p.items()},
                             {k: _t(v) for k, v in fields.items()}, g, pcfg,
                             TPC, order=2, use_laser=True, pusher=pusher)
    no_laser = tpl.advance_plasma({k: _t(v) for k, v in p.items()},
                                  {k: _t(v) for k, v in fields.items()}, g,
                                  pcfg, TPC, order=2, pusher=pusher)
    for k in ("x", "y", "ux", "uy", "psi", "ux_half", "uy_half",
              "psi_half"):
        _close(got[k].numpy(), np.asarray(ref[k]), k)
    assert not torch.allclose(no_laser["ux"], got["ux"])


def test_plasma_deposits_laser_terms_match():
    """deposit_plasma's gamma and the explicit Sx/Sy deposit with the sixth
    channel against the JAX package's scatter deposit and
    explicit_deposition."""
    deck, g, pcfg, p, fields = _plasma_case(4)
    p["valid"] = np.ones(p["x"].size, bool)
    jg = JGeometry.from_inputs(Inputs(deck))
    jcfg = jpl.PlasmaConfig.from_inputs(Inputs(deck), "plasma", JPC,
                                        "Periodic")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tp_ = {k: _t(v) for k, v in p.items()}
    tf = {k: _t(v) for k, v in fields.items()}
    comps = ["jx", "jy", "jz", "rhomjz", "chi"]
    ref, rp = jpl.deposit_plasma(jp, comps, jf, jg, jcfg, JPC, 2, True,
                                 use_laser=True)
    got, gp = tpl.deposit_plasma(tp_, comps, tf, g, pcfg, TPC, 2, True,
                                 use_laser=True)
    for c in comps:
        _close(got[c].numpy(), np.asarray(ref[c]), c)
    np.testing.assert_array_equal(gp["valid"].numpy(), np.asarray(rp["valid"]))
    # the explicit solver: the port's fused deposit and combine
    ref_main, rp = jpl.deposit_plasma(jp, ["jx", "jy", "chi", "rhomjz"], jf,
                                      jg, jcfg, JPC, 2, True, use_laser=True)
    ref_s = jpl.explicit_deposition(rp, ref_main, jg, jcfg, JPC, 2, 2, True,
                                    use_laser=True)
    out, _, dg = tpl.fused_plasma_deposits(
        tp_, ["jx", "jy", "chi", "rhomjz"], tf, g, pcfg, TPC, 2, True,
        use_laser=True)
    assert dg[0].shape[0] == 6
    out = tpl.combine_explicit_sxsy(out, dg, TPC, g)
    for c in ("jx", "jy", "chi", "rhomjz", "Sx", "Sy"):
        _close(out[c].numpy(), np.asarray(ref_s[c]), c)


# ---------------------------------------------------- interp and moments
@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("valid_only", [False, True])
def test_grid_interp_matches(order, valid_only):
    src = dict(n_cell=(31, 29, 8), prob_lo=(-8., -7., -2.),
               prob_hi=(8., 7., 2.), nguards=2)
    dst = dict(n_cell=(40, 36, 8), prob_lo=(-5., -4., -2.),
               prob_hi=(5., 4., 2.), nguards=2)
    a = np.random.default_rng(order).standard_normal((33, 35))
    ref = JGridInterp(JGeometry(**src), JGeometry(**dst), jnp.float64,
                      order=order, valid_only=valid_only).apply(
                          jnp.asarray(a))
    got = GridInterp(Geometry(**src), Geometry(**dst), torch.float64,
                     order=order, valid_only=valid_only).apply(_t(a))
    _close(got.numpy(), np.asarray(ref))


def test_laser_moments_and_record_match():
    rng = np.random.default_rng(6)
    geom = dict(GEOM, n_cell=(31, 33, 12))
    env = rng.standard_normal((37, 35)) + 1j * rng.standard_normal((37, 35))
    ref = jins.laser_slice_moments(jnp.asarray(env), JGeometry(**geom))
    got = tins.laser_slice_moments(_t(env), Geometry(**geom))
    _close(got.numpy(), np.asarray(ref))
    mom = np.stack([np.asarray(ref)] * 3)
    jrec = jins.laser_record(4, 1.5, mom, JGeometry(**geom), True)
    trec = tins.laser_record(4, 1.5, mom, Geometry(**geom), True)
    assert list(trec) == list(jrec)
    for k in jrec:
        _close(trec[k], jrec[k], k)


# ------------------------------------------------------------- from file
def _write_envelope(path, layout, arr, spacing, offset):
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data/3/fields/laserEnvelope", data=arr)
        labels = {"xyt": ["t", "y", "x"], "xyz": ["z", "y", "x"],
                  "rt": ["t", "r"]}[layout]
        ds.attrs["axisLabels"] = np.array([np.bytes_(a) for a in labels])
        ds.attrs["gridSpacing"] = np.array(spacing)
        ds.attrs["gridGlobalOffset"] = np.array(offset)
        ds.attrs["position"] = np.zeros(len(labels))
        ds.attrs["unitSI"] = 0.5


@pytest.mark.parametrize("layout", ["xyt", "xyz", "rt"])
def test_envelope_file_reader_matches(layout, tmp_path):
    rng = np.random.default_rng(7)
    path = tmp_path / f"{layout}.h5"
    if layout == "rt":
        arr = rng.standard_normal((3, 20, 12)) + 1j * rng.standard_normal(
            (3, 20, 12))
        _write_envelope(path, layout, arr, [0.4, 0.6], [0.0, 0.0])
    else:
        arr = rng.standard_normal((20, 30, 28)) + 1j * rng.standard_normal(
            (20, 30, 28))
        _write_envelope(path, layout, arr, [0.4, 0.5, 0.45],
                        [-3.5, -7.2, -6.1])
    deck = (f"lasers.names = f g\nf.init_type = from_file\n"
            f"f.input_file = {path}\nf.iteration = 3\n"
            "g.a0 = 1.\ng.w0 = 2.\ng.L0 = 1.\n")
    jcfg, tcfg = _configs(deck)
    ref = jlz.load_laser_from_file(jcfg, JGeometry(**GEOM), jnp.float64,
                                   zeta_lo=2, nz_global=16, clight=1.0)
    got = tlz.load_laser_from_file(tcfg, Geometry(**GEOM), torch.float64,
                                   zeta_lo=2, nz_global=16, clight=1.0)
    assert np.abs(np.asarray(ref)).max() > 0.1
    _close(got.numpy(), np.asarray(ref))


def test_from_file_needs_h5py(monkeypatch):
    """Where h5py does not import a from-file deck raises when the
    simulation is built, naming h5py."""
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    deck = LASER_WAKE.format(nxy=15, nz=4, npart=0) + (
        "laser.init_type = from_file\nlaser.input_file = none.h5\n")
    with pytest.raises(RuntimeError, match="h5py"):
        Simulation(TInputs(deck), device="cpu", verbose=0)


# ------------------------------------------------------------ whole runs
RUNS = {
    # explicit Bx/By, multigrid laser solver, laser on the field grid, all
    # output
    "explicit-mg": "",
    # predictor-corrector, FFT laser solver, a box whose loop is stable
    "pc-fft": ("hipace.bxby_solver = predictor-corrector\n"
               "lasers.solver_type = fft\n"
               "geometry.prob_lo = -10. -10. -7.5\n"
               "geometry.prob_hi = 10. 10. 6.\n"),
    # a separate, even laser grid on part of the box: the cell-centred
    # complex multigrid and the cross-grid interpolation
    "laser-grid": ("lasers.n_cell = 32 32\n"
                   "lasers.patch_lo = -10. -10. -5.\n"
                   "lasers.patch_hi = 10. 10. 4.\n"),
}
OUTPUT = """
max_step = 1
diagnostic.output_period = 1
diagnostic.names = lev0 laser_diag laser_xz
lev0.field_data = Ez Bx By chi aabs
laser_xz.base_geometry = laser
laser_xz.diag_type = xz
laser_xz.coarsening = 2 1 1
lasers.insitu_period = 1
"""


@pytest.fixture(scope="module", params=list(RUNS))
def laser_run(request, tmp_path_factory):
    """(name, JAX results, port results, JAX cycles, output dirs) of two
    steps through each package's time loop."""
    name = request.param
    root = tmp_path_factory.mktemp(name)
    out = OUTPUT if name != "pc-fft" else "max_step = 1\n"

    def deck(d):
        return (LASER_WAKE.format(nxy=31, nz=8, npart=0)
                + "hipace.use_banded = 0\n" + RUNS[name] + out
                + f"hipace.file_prefix = {d}/openpmd\n"
                + f"lasers.insitu_file_prefix = {d}/laser_insitu\n")

    cycles, jres = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(deck(root / "jax")), verbose=0)
        run = jsim.run_step
        mp.setattr(jsim, "run_step", lambda s: jres.append(run(s))
                   or jres[-1])
        jsim.evolve()
        jax.effects_barrier()
    tsim = Simulation(TInputs(deck(root / "port")), device="cpu", verbose=0)
    tres = []
    for step in range(2):
        tsim.set_dt()
        tres.append(tsim.advance(step))
    return name, jres, tres, cycles, root, tsim


def test_laser_run_fields_match(laser_run):
    name, jres, tres, _, _, tsim = laser_run
    for jr, tr in zip(jres, tres):
        ref, got = np.asarray(jr["diag"]), tr["diag"].numpy()
        for i, c in enumerate(tsim.cfg.diag_comps):
            _close(got[:, i], ref[:, i], f"{name} {c}")
        for k in (0, 1):
            _close(tr["laser_stream"][k].numpy(),
                   np.asarray(jr["laser_stream"][k]), f"{name} stream {k}")
    assert float(tres[0]["laser_stream"][1].abs().max()) > 4.0


def test_carried_laser_stream_gives_the_second_step(laser_run):
    """convert.carry_state moves the JAX package's envelope stream, beam,
    dt and time after step 0 into a fresh port simulation, whose step 1
    then equals the JAX package's."""
    from hipace_tpu_torch.convert import carry_state
    name, jres, _, _, root, tsim = laser_run
    fresh = Simulation(tsim.inputs, device="cpu", verbose=0)
    carry_state(fresh, {k: np.array(v) for k, v in jres[0]["binned"].items()},
                tsim.dt, tsim.dt,
                laser_stream=[np.asarray(a) for a in jres[0]["laser_stream"]])
    got = fresh.run_step(1)
    ref = np.asarray(jres[1]["diag"])
    for i, c in enumerate(fresh.cfg.diag_comps):
        _close(got["diag"][:, i].numpy(), ref[:, i], f"{name} {c}")
    _close(got["laser_stream"][0].numpy(),
           np.asarray(jres[1]["laser_stream"][0]), name)


def test_laser_run_cycles_match(laser_run):
    name, jres, tres, cycles, _, tsim = laser_run
    jreal = [n for c, n in cycles if not c]
    jcplx = [n for c, n in cycles if c]
    real = sum((r["mg_cycles"] for r in tres), [])
    cplx = sum((r["laser_cycles"] for r in tres), [])
    if name == "pc-fft":
        assert jreal == jcplx == [] and set(real) == set(cplx) == {0}
        for jr, tr in zip(jres, tres):
            assert list(np.asarray(jr["pc_iters"])[::-1]) == tr["pc_iters"]
        assert max(tres[0]["pc_iters"]) > 1
        return
    assert cplx == jcplx and len(cplx) == 16 and max(cplx) > 0
    assert len(real) == len(jreal) == 16
    # the slices ahead of the laser have no source at all: the port's
    # plasma and background deposits cancel bit for bit and its Bx/By solve
    # takes no V-cycle, while the JAX package's leave ~1e-15 of rhomjz,
    # on which it takes a few
    hi = tsim.laser_zeta[1]
    ahead = [i > hi for i in range(7, -1, -1)] * 2
    assert [n for n, a in zip(real, ahead) if not a] == \
        [n for n, a in zip(jreal, ahead) if not a]
    assert all(n == 0 for n, a in zip(real, ahead) if a)
    assert any(ahead) == (name == "laser-grid")


def _h5_items(path):
    out = {"/": (None, None)}
    with h5py.File(path, "r") as f:
        out["/"] = (None, dict(f.attrs))

        def visit(n, obj):
            data = np.array(obj) if isinstance(obj, h5py.Dataset) else None
            out[n] = (data, dict(obj.attrs))
        f.visititems(visit)
    return out


def _insitu(path):
    with open(path, "rb") as f:
        raw = f.read()
    head, offset = json.JSONDecoder().raw_decode(raw.decode("latin-1"))
    return np.frombuffer(raw, dtype=np.dtype(head), offset=offset)


@pytest.mark.parametrize("laser_run", ["explicit-mg", "laser-grid"],
                         indirect=True)
def test_laser_run_output_matches(laser_run):
    name, _, _, _, root, _ = laser_run
    jdir, tdir = root / "jax", root / "port"
    files = sorted(os.listdir(jdir / "openpmd"))
    assert files == ["openpmd_000000.h5", "openpmd_000001.h5"]
    assert sorted(os.listdir(tdir / "openpmd")) == files
    for fname in files:
        ref = _h5_items(jdir / "openpmd" / fname)
        got = _h5_items(tdir / "openpmd" / fname)
        assert sorted(got) == sorted(ref), fname
        assert any("laserEnvelope" in k for k in ref)
        for item, (data, attrs) in ref.items():
            assert sorted(got[item][1]) == sorted(attrs), item
            for k in attrs:
                np.testing.assert_array_equal(np.asarray(got[item][1][k]),
                                              np.asarray(attrs[k]),
                                              err_msg=f"{item} {k}")
            if data is not None:
                _close(got[item][0], data, f"{fname}:{item}")
    fname = "reduced_laser.0000.txt"
    ref = _insitu(jdir / "laser_insitu" / fname)
    got = _insitu(tdir / "laser_insitu" / fname)
    assert got.dtype == ref.dtype and list(ref["step"]) == [0, 1]
    # the first moments in x and y cancel over the symmetric pulse: their
    # scale is the sum of |a|^2 times the box's half width (20)
    first = 20.0 * np.abs(ref["[|a|^2]"]).max()
    for k in ref.dtype.names:
        scale = first if k in ("[|a|^2*x]", "[|a|^2*y]") else None
        if scale is None:
            _close(got[k], ref[k], k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=RTOL * scale, err_msg=k)
