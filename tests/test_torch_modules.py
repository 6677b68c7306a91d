"""The port's modules against their JAX counterparts, on CPU in float64.

Each test feeds the same seeded numpy inputs to a hipace_tpu function and
to its hipace_tpu_torch port. Unless a test says otherwise the tolerance
is 1e-12 relative to the largest value: both sides compute the same
float64 expressions, in a different operation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.constants import make_constants
from hipace_tpu.fields import poisson as jpoisson
from hipace_tpu.fields import slices as jsl
from hipace_tpu.geometry import Geometry
from hipace_tpu.ops import dst as jdst
from hipace_tpu.ops import shape as jshape
from hipace_tpu.parser import Inputs, compile_function
from hipace_tpu.particles import beam as jbm
from hipace_tpu.particles import plasma as jpl
from hipace_tpu_torch import device as tdevice
from hipace_tpu_torch.constants import make_constants as tmake_constants
from hipace_tpu_torch.fields import poisson as tpoisson
from hipace_tpu_torch.fields import slices as tsl
from hipace_tpu_torch.geometry import Geometry as TGeometry
from hipace_tpu_torch.ops import dst as tdst
from hipace_tpu_torch.ops import shape as tshape
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.parser import TorchFunction
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.particles import plasma as tpl

torch.set_num_threads(1)
RTOL = 1e-12

GEOM = Geometry(n_cell=(31, 27, 16), prob_lo=(-4.0, -3.0, -6.0),
                prob_hi=(4.0, 3.0, 2.0), nguards=2)
PC = make_constants(True)
# the port's own copies of the same geometry and constants
TGEOM = TGeometry(n_cell=GEOM.n_cell, prob_lo=GEOM.prob_lo,
                  prob_hi=GEOM.prob_hi, nguards=GEOM.nguards)
TPC = tmake_constants(True)

DECK = """
amr.n_cell = 31 27 16
hipace.normalized_units = 1
geometry.prob_lo = -4. -3. -6.
geometry.prob_hi =  4.  3.  2.
boundary.particle = {bc}
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 1000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.41
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.n_subcycles = 4
plasmas.names = plasma
plasma.density(x,y,z) = 1. + 0.05*x*x
plasma.radius = 2.5
plasma.ppc = 2 1
plasma.element = electron
"""


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.tensor(np.asarray(a))


def _fields(seed, names, scale=0.1):
    rng = np.random.default_rng(seed)
    return {n: scale * rng.standard_normal(GEOM.slice_shape) for n in names}


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("p,deriv_type", [(0, -1), (1, -1), (2, -1), (3, -1),
                                          (1, 0), (2, 0), (3, 0), (0, 1),
                                          (2, 1), (3, 1), (1, 2), (2, 2),
                                          (3, 2)])
def test_shape_factors(p, deriv_type):
    x = np.random.default_rng(p).uniform(2.0, 30.0, 500)
    if deriv_type < 0:
        ri, rw = jshape.shape_weights(jnp.asarray(x), p)
        gi, gw = tshape.shape_weights(_t(x), p)
        _close(gw, rw)
    else:
        ri, rw, rd = jshape.shape_weights_derivative(jnp.asarray(x), p,
                                                     deriv_type)
        gi, gw, gd = tshape.shape_weights_derivative(_t(x), p, deriv_type)
        _close(gw, rw)
        _close(gd, rd)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("fn,n", [("dst1", 30), ("dst1", 31),
                                  ("dst1_fast", 31), ("dst1_fast", 63)])
def test_dst_1d(fn, n):
    x = np.random.default_rng(n).standard_normal((3, 5, n))
    for axis in (-1, 1):
        ref = getattr(jdst, fn)(jnp.asarray(x), axis=axis) if axis == -1 \
            else getattr(jdst, fn)(jnp.asarray(np.swapaxes(x, 1, 2)), axis=1)
        arg = x if axis == -1 else np.swapaxes(x, 1, 2)
        _close(getattr(tdst, fn)(_t(arg), dim=axis), ref)


@pytest.mark.parametrize("fn", ["dst1_2d", "dst1_2d_fast"])
def test_dst_2d(fn):
    x = np.random.default_rng(4).standard_normal((3, 31, 63))
    _close(getattr(tdst, fn)(_t(x)), getattr(jdst, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("variant,nx,ny", [("fast", 31, 27),
                                           ("expanded", 31, 27),
                                           ("fast", 32, 27)])
def test_poisson_solver(variant, nx, ny):
    rhs = np.random.default_rng(nx).standard_normal((3, ny, nx))
    ref = jpoisson.DirichletPoissonSolver(nx, ny, 0.1, 0.2, jnp.float64,
                                          variant=variant).solve(
        jnp.asarray(rhs))
    solver = tpoisson.DirichletPoissonSolver(nx, ny, 0.1, 0.2,
                                             variant=variant)
    _close(solver.solve(_t(rhs)), ref)


def test_slice_derivatives():
    f = np.random.default_rng(5).standard_normal(GEOM.slice_shape)
    for name in ("interior", "ddx_interior", "ddy_interior"):
        _close(getattr(tsl, name)(_t(f), TGEOM),
               getattr(jsl, name)(jnp.asarray(f), GEOM))
    for a, b in zip(tsl.grad_neg_full(_t(f), TGEOM),
                    jsl.grad_neg_full(jnp.asarray(f), GEOM)):
        _close(a, b)


@pytest.mark.parametrize("expr", ["1.", "1. + 0.05*x*x", "exp(-(x^2+y^2)/2)",
                                  "if(x > 0, 2., 0.5) * pow(y, 2)",
                                  "sqrt(abs(x)) + max(x, y) + kp"])
def test_parser_matches_numpy_evaluation(expr):
    consts = {"kp": 1.5}
    rng = np.random.default_rng(6)
    x, y, z = rng.standard_normal((3, 50))
    ref = np.broadcast_to(compile_function(expr, ("x", "y", "z"),
                                           tuple(consts.items()),
                                           use_numpy=True)(x, y, z), x.shape)
    got = TorchFunction(expr, ("x", "y", "z"), consts)(_t(x), _t(y), _t(z))
    _close(got, ref)


def test_device_policy():
    """The card unless the caller asks for the CPU; never a silent CPU
    run."""
    assert tdevice.resolve("cpu") == (torch.device("cpu"), torch.float64)
    with pytest.raises(ValueError):
        tdevice.resolve("cpu", torch.float32)
    if torch.cuda.is_available():
        assert tdevice.resolve() == (torch.device("cuda"), torch.float32)
    else:
        for asked in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tdevice.resolve(asked)


# ---------------------------------------------------------------- plasma
def _plasma_cfgs(bc="Periodic"):
    deck = DECK.format(bc=bc)
    return (jpl.PlasmaConfig.from_inputs(Inputs(deck), "plasma", PC, bc),
            tpl.PlasmaConfig.from_inputs(TInputs(deck), "plasma", TPC, bc))


def _to_torch(p):
    return {k: _t(v) for k, v in p.items() if k != "ion_lev"}


def _plasma_state(seed, bc="Periodic"):
    """JAX init_plasma, then randomized momenta/positions (numpy) with some
    invalid and QSA-violating lanes."""
    jcfg, tcfg = _plasma_cfgs(bc)
    p = {k: np.array(v) for k, v in jpl.init_plasma(
        jcfg, GEOM, jax.random.PRNGKey(0), jnp.float64).items()}
    rng = np.random.default_rng(seed)
    n = p["x"].size
    # moved, but kept inside the box as the particle BC keeps them
    for d, k in enumerate(("x", "y")):
        p[k] = np.clip(p[k] + 0.3 * rng.standard_normal(n),
                       GEOM.prob_lo[d] + 1e-3, GEOM.prob_hi[d] - 1e-3)
        p[f"{k}_prev"] = p[k]
    for k in ("ux", "uy"):
        p[k] = 0.3 * rng.standard_normal(n)
        p[f"{k}_half"] = 0.3 * rng.standard_normal(n)
    p["psi"] = 1.0 + 0.2 * rng.standard_normal(n)
    p["psi_half"] = 1.0 + 0.2 * rng.standard_normal(n)
    p["psi"][::37] = 0.05          # QSA violation (gamma_psi > 35)
    p["valid"][::29] = False
    return jcfg, tcfg, p


def test_init_plasma_and_pad():
    jcfg, tcfg = _plasma_cfgs()
    ref = jpl.pad_plasma(jpl.init_plasma(jcfg, GEOM, jax.random.PRNGKey(0),
                                         jnp.float64), 7)
    got = tpl.pad_plasma(tpl.init_plasma(tcfg, TGEOM, "cpu", torch.float64),
                         7)
    assert not bool(got["valid"].all())       # the radius cut bites
    for k in got:
        _close(got[k].to(torch.float64), np.asarray(ref[k], np.float64))


@pytest.mark.parametrize("mode", ["Periodic", "Reflecting", "Absorbing"])
def test_particle_bc(mode):
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-6, 6, 400), rng.uniform(-5, 5, 400)
    ux, uy, w = rng.standard_normal((3, 400))
    valid = rng.uniform(size=400) > 0.1
    ref = jpl.enforce_particle_bc(*[jnp.asarray(a) for a in
                                    (x, y, ux, uy, w, valid)], GEOM, mode)
    got = tpl.enforce_particle_bc(*[_t(a) for a in (x, y, ux, uy, w, valid)],
                                  TGEOM, mode)
    for a, b in zip(got, ref):
        _close(a.to(torch.float64), np.asarray(b, np.float64))


def test_advance_plasma():
    """The leapfrog with the second-order correction: the port's explicit
    directional derivative against jax.jvp. Invalid lanes read zero fields
    on the port's gather (the JAX package's banded convention) and are not
    compared."""
    jcfg, tcfg, p = _plasma_state(8)
    f = _fields(9, ("Psi", "Ez", "Bx", "By", "Bz"))
    ref = jpl.advance_plasma({k: jnp.asarray(v) for k, v in p.items()},
                             {k: jnp.asarray(v) for k, v in f.items()},
                             GEOM, jcfg, PC, temp_slice=False, order=2)
    got = tpl.advance_plasma(_to_torch(p), {k: _t(v) for k, v in f.items()},
                             TGEOM, tcfg, TPC, order=2)
    v = p["valid"]
    for k in got:
        _close(got[k].numpy()[v].astype(np.float64),
               np.asarray(ref[k])[v].astype(np.float64))


def test_fused_deposit_and_combine():
    """Main currents + Sx/Sy through one fused deposit and the grid
    combine, against the JAX package's separate deposit_plasma and
    per-stencil explicit_deposition."""
    jcfg, tcfg, p = _plasma_state(10)
    comps = ["jx", "jy", "chi", "rhomjz"]
    f0 = _fields(11, comps)
    jf, jp = jpl.deposit_plasma({k: jnp.asarray(v) for k, v in p.items()},
                                comps, {k: jnp.asarray(v) for k, v in
                                        f0.items()}, GEOM, jcfg, PC, 2, True)
    tf, tp, dg = tpl.fused_plasma_deposits(_to_torch(p), comps,
                                           {k: _t(v) for k, v in f0.items()},
                                           TGEOM, tcfg, TPC, 2, True)
    for c in comps:
        _close(tf[c], jf[c])
    for k in ("w", "valid"):
        _close(tp[k].to(torch.float64), np.asarray(jp[k], np.float64))
    solved = _fields(12, ("Bz", "Ez", "ExmBy", "EypBx", "Sx", "Sy"))
    ref = jpl.explicit_deposition(jp, {k: jnp.asarray(v) for k, v in
                                       solved.items()}, GEOM, jcfg, PC, 2, 2,
                                  True)
    got = tpl.combine_explicit_sxsy({k: _t(v) for k, v in solved.items()},
                                    dg, TPC)
    for c in ("Sx", "Sy"):
        _close(got[c], ref[c])


def test_background_deposit():
    jcfg, tcfg, p = _plasma_state(13)
    zero = np.zeros(GEOM.slice_shape)
    jf, _ = jpl.deposit_plasma({k: jnp.asarray(v) for k, v in p.items()},
                               ["rhomjz", "jz", "rho"],
                               {c: jnp.asarray(zero) for c in
                                ("rhomjz", "jz", "rho")}, GEOM, jcfg, PC, 2,
                               True, flip_charge=True)
    tf, _ = tpl.deposit_plasma(_to_torch(p), ["rhomjz", "jz", "rho"],
                               {c: _t(zero) for c in ("rhomjz", "jz", "rho")},
                               TGEOM, tcfg, TPC, 2, True, flip_charge=True)
    for c in ("rhomjz", "jz", "rho"):
        _close(tf[c], jf[c])


# ---------------------------------------------------------------- beam
def _beam_cfgs(bc="Absorbing"):
    deck = DECK.format(bc=bc)
    return (jbm.BeamConfig.from_inputs(Inputs(deck), "beam", PC, GEOM, True),
            tbm.BeamConfig.from_inputs(TInputs(deck), "beam", TPC, TGEOM,
                                       True))


def _beam_lanes(seed, n=600):
    rng = np.random.default_rng(seed)
    b = {"x": rng.normal(0.0, 1.2, n), "y": rng.normal(0.0, 1.0, n),
         "z": rng.uniform(-1.1, -0.4, n), "ux": rng.normal(0, 2.0, n),
         "uy": rng.normal(0, 2.0, n), "uz": rng.normal(2000, 50, n),
         "w": rng.uniform(0.5, 1.5, n)}
    b["x"][:20] = 3.95                        # leave the box: absorbed
    for k in ("sx", "sy", "sz"):
        b[k] = np.zeros(n)
    b["nsub"] = rng.integers(0, 3, n).astype(np.int32)
    b["beam_id"] = np.zeros(n, np.int32)
    b["valid"] = rng.uniform(size=n) > 0.1
    return b


def test_beam_config_matches():
    jcfg, tcfg = _beam_cfgs()
    for name in ("charge", "mass", "total_charge", "position_std", "u_mean",
                 "n_subcycles", "zmin", "zmax", "particle_boundary"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_init_beam_symmetrize_and_can():
    """The mirrored quadruples and the flat-top z of a fixed_weight beam
    (random streams differ from jax.random, so this checks structure)."""
    deck = DECK.format(bc="Absorbing") + (
        "beam.do_symmetrize = 1\nbeam.profile = can\nbeam.zmin = -2.\n"
        "beam.zmax = -1.\nbeam.u_std = 0.5 0.5 1.\nbeam.total_charge = -3.\n")
    cfg = tbm.BeamConfig.from_inputs(TInputs(deck), "beam", TPC, TGEOM, True)
    b = tbm.init_beam(cfg, TGEOM, torch.Generator().manual_seed(0), "cpu",
                      torch.float64, TPC)
    assert b["x"].shape == (1000,)
    q = {k: b[k].reshape(-1, 4) for k in ("x", "y", "z", "ux", "uy")}
    torch.testing.assert_close(q["x"][:, 0], -q["x"][:, 1])
    torch.testing.assert_close(q["y"][:, 0], -q["y"][:, 2])
    torch.testing.assert_close(q["ux"][:, 3], -q["ux"][:, 2])
    assert bool((q["z"] == q["z"][:, :1]).all())
    assert float(b["z"].min()) >= -2.0 and float(b["z"].max()) <= -1.0
    assert bool(torch.allclose(b["w"], torch.full_like(b["w"], 3.0 / 1000)))


@pytest.mark.parametrize("bc", ["Absorbing", "Periodic"])
def test_advance_beam_slice(bc):
    jcfg, tcfg = _beam_cfgs(bc)
    b = _beam_lanes(14)
    f = _fields(15, ("Psi", "Ez", "Bx", "By", "Bz"))
    min_z = -0.8                               # some lanes slip below
    ref = jbm.advance_beam_slice({k: jnp.asarray(v) for k, v in b.items()},
                                 {k: jnp.asarray(v) for k, v in f.items()},
                                 GEOM, jcfg, PC, 0.5, min_z, order=2)
    got = tbm.advance_all_beams({k: _t(v) for k, v in b.items()},
                                {k: _t(v) for k, v in f.items()}, TGEOM,
                                (tcfg,), TPC, 0.5, min_z, order=2)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    v = np.asarray(ref["valid"])
    assert 0 < v.sum() < b["valid"].sum() or bc == "Periodic"
    for k in ("x", "y", "z", "ux", "uy", "uz", "w", "nsub"):
        _close(got[k].numpy()[v].astype(np.float64),
               np.asarray(ref[k])[v].astype(np.float64))


def test_beam_deposit():
    jcfg, tcfg = _beam_cfgs()
    b = _beam_lanes(16)
    zero = np.zeros(GEOM.slice_shape)
    cmap = {"jx": "jx", "jy": "jy", "jz": "jz", "rhomjz": "rhomjz"}
    ref = jbm.deposit_beam_slice({k: jnp.asarray(v) for k, v in b.items()},
                                 cmap, {c: jnp.asarray(zero) for c in cmap},
                                 GEOM, (jcfg,), PC, 2, True)
    got = tbm.deposit_beam_slice({k: _t(v) for k, v in b.items()}, cmap,
                                 {c: _t(zero) for c in cmap}, TGEOM, (tcfg,),
                                 TPC, 2, True)
    for c in ("jx", "jy", "jz"):
        _close(got[c], ref[c])
    # rho - jz/c carries 1 - v_z ~ 1/(2 gamma^2) ~ 1e-7 at uz = 2000, so a
    # one-ulp difference in gamma between the two libraries' sqrt grows
    # ~1e7-fold there
    _close(got["rhomjz"], ref["rhomjz"], rtol=1e-8)


def test_bin_unbin_beam():
    b = _beam_lanes(17, n=3000)
    b["z"] = np.random.default_rng(18).uniform(-6.5, 2.5, 3000)
    ref = jbm.bin_beam({k: jnp.asarray(v) for k, v in b.items()}, GEOM, 150)
    got = tbm.bin_beam({k: _t(v) for k, v in b.items()}, TGEOM, 150)
    assert got["n_dropped"] == int(ref["n_dropped"]) > 0
    for k in tbm.ALL_ATTRS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    flat = tbm.unbin_beam(got)
    assert flat["x"].shape == (GEOM.nz * 150,)
    assert tbm.plan_capacity({k: _t(v) for k, v in b.items()}, TGEOM) > 0
