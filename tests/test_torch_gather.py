"""K2's two input forms against the JAX package, on CPU.

``gather_main`` takes the five field planes either as a (5, NY, NX) stack,
the JAX package's layout, or as five separate (NY, NX) tensors, which the
pushers pass as they stand. Both forms go through the plain version here and
are held to ``pallas_gather_main`` in interpret mode and to the exact XLA
``gather_main_fields`` on the same numpy inputs in float64; lanes past the
grid's edges are held to a loop over their taps; and the pushers hand K2
their slice's planes themselves, no stack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.geometry import Geometry
from hipace_tpu.ops.gather import gather_main_fields
from hipace_tpu.ops.pallas_banded import pallas_gather_main
from hipace_tpu_torch.constants import make_constants
from hipace_tpu_torch.geometry import Geometry as TGeometry
from hipace_tpu_torch.ops.gather import PLANE_NAMES, as_planes, gather_main
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.particles import plasma as tpl

torch.set_num_threads(1)

# float64 roundoff: the kernels sum the same terms in another order
RTOL = 1e-12
FORMS = ["stack", "planes"]


def _form(stack: np.ndarray, form: str):
    t = torch.tensor(stack)
    return t if form == "stack" else [p.clone() for p in t]


def _assert_close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _lanes(seed, N, NY, NX):
    """Lanes over the grid and past its edges, every 11th dead."""
    rng = np.random.default_rng(seed)
    ym = rng.uniform(-3.0, NY + 3.0, N)
    xm = rng.uniform(-3.0, NX + 3.0, N)
    ym[::11] = 2.0 * NY
    return torch.tensor(ym), torch.tensor(xm)


def _bspline(u, p):
    """B_p(u) of one number, piece by piece (ref ShapeFactors.H)."""
    a = abs(u)
    if p == 0:
        return 1.0 if -0.5 <= u < 0.5 else 0.0
    if p == 1:
        return max(1.0 - a, 0.0)
    if p == 2:
        return 0.75 - a * a if a <= 0.5 else (
            0.5 * (1.5 - a) ** 2 if a < 1.5 else 0.0)
    return (4.0 - 6.0 * a * a + 3.0 * a ** 3) / 6.0 if a <= 1.0 else (
        (2.0 - a) ** 3 / 6.0 if a < 2.0 else 0.0)


def _leftmost(x, p):
    """The first cell of the order-p stencil (ref ShapeFactors.H)."""
    if p in (0, 2):
        return int(np.floor(x + 0.5)) - p // 2
    return int(np.floor(x)) - (p - 1) // 2


def _gather_loop(stack, ym, xm, order):
    """The six sums of each lane by a loop over its taps inside the grid."""
    _, NY, NX = stack.shape
    out = np.zeros((6, ym.size))
    for p, (y, x) in enumerate(zip(ym, xm)):
        if y >= 1.5 * NY:
            continue
        iy0, ix0 = _leftmost(y, order + 1), _leftmost(x, order + 1)
        for a in range(order + 2):
            for b in range(order + 2):
                r, c = iy0 + a, ix0 + b
                if not (0 <= r < NY and 0 <= c < NX):
                    continue
                uy, ux = y - r, x - c
                wy, wx = _bspline(uy, order), _bspline(ux, order)
                dwy = _bspline(uy - 0.5, order) - _bspline(uy + 0.5, order)
                dwx = _bspline(ux - 0.5, order) - _bspline(ux + 0.5, order)
                f = stack[:, r, c]
                out[:, p] += [wy * dwx * f[0], dwy * wx * f[0], wy * wx * f[1],
                              wy * wx * f[2], wy * wx * f[3], wy * wx * f[4]]
    return out


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_gather_planes_equal_stack(order):
    NY, NX = 30, 26
    ym, xm = _lanes(order, 700, NY, NX)
    stack = np.random.default_rng(80 + order).standard_normal((5, NY, NX))
    got = gather_main(_form(stack, "planes"), ym, xm, order)
    ref = gather_main(_form(stack, "stack"), ym, xm, order)
    assert torch.equal(got, ref)
    assert bool((got[:, ::11] == 0).all())


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_gather_drops_the_taps_outside_the_grid(order):
    """Lanes over the whole grid and up to 3 cells past each edge, against a
    loop that sums only the taps inside the grid."""
    NY, NX = 14, 11
    ym, xm = _lanes(130 + order, 400, NY, NX)
    stack = np.random.default_rng(140 + order).standard_normal((5, NY, NX))
    got = gather_main(_form(stack, "planes"), ym, xm, order)
    _assert_close(got, _gather_loop(stack, ym.numpy(), xm.numpy(), order))


@pytest.mark.parametrize("order", [0, 2])
def test_gather_at_repeated_positions(order):
    """The plain gather keeps the stencils of its last few CPU calls: calls
    that alternate two sets of positions over three sets of planes, and a
    call after positions changed in place, each equal the loop over the
    taps."""
    NY, NX = 14, 11
    lanes = [_lanes(150 + order, 300, NY, NX), _lanes(160 + order, 300, NY,
                                                        NX)]
    rng = np.random.default_rng(170 + order)
    for stack in [rng.standard_normal((5, NY, NX)) for _ in range(3)]:
        for ym, xm in lanes:
            got = gather_main(_form(stack, "planes"), ym, xm, order)
            _assert_close(got, _gather_loop(stack, ym.numpy(), xm.numpy(),
                                            order))
    ym, xm = lanes[0]
    ym[3] += 0.37
    got = gather_main(_form(stack, "stack"), ym, xm, order)
    _assert_close(got, _gather_loop(stack, ym.numpy(), xm.numpy(), order))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_forms_match_pallas(form, order):
    """At order 3 the Pallas kernel's Psi derivatives take a sixth tap
    (ROADMAP fault R8) and only the four interpolated fields compare."""
    NY, NX, N = 40, 36, 1024
    rng = np.random.default_rng(100 + order)
    ym = rng.uniform(3.0, NY - 4.0, N)
    xm = rng.uniform(3.0, NX - 4.0, N)
    ym[-100:] = 2.0 * NY
    xm[-100:] = 2.0 * NX
    stack = rng.standard_normal((5, NY, NX))
    ref = pallas_gather_main(jnp.asarray(stack), jnp.asarray(ym),
                             jnp.asarray(xm), NY, NX, order, interpret=True)
    got = gather_main(_form(stack, form), torch.tensor(ym), torch.tensor(xm),
                      order)
    for i in range(2 if order == 3 else 0, 6):
        _assert_close(got[i], ref[i])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_gather_forms_match_gather_main_fields(form, order):
    """Lanes anywhere in the box, some stencils in the guard cells."""
    g = Geometry(n_cell=(31, 27, 8), prob_lo=(-2.0, -1.5, -1.0),
                 prob_hi=(2.0, 1.5, 1.0), nguards=(order + 1) // 2 + 1)
    NY, NX = g.slice_shape
    rng = np.random.default_rng(110 + order)
    N = 900
    xp = rng.uniform(-2.0, 2.0, N)
    yp = rng.uniform(-1.5, 1.5, N)
    f = rng.standard_normal((5, NY, NX))
    ref = gather_main_fields(jnp.asarray(xp), jnp.asarray(yp),
                             *[jnp.asarray(a) for a in f], g, order)
    G = g.nguards
    out = gather_main(_form(f, form),
                      torch.tensor((yp - g.y_pos_offset) / g.dy + G),
                      torch.tensor((xp - g.x_pos_offset) / g.dx + G), order)
    got = [out[0] / g.dx, out[1] / g.dy] + [out[i] for i in range(2, 6)]
    for a, b in zip(got, ref):
        _assert_close(a, b)


def test_gather_rejects_malformed_planes():
    plane = torch.zeros((8, 8), dtype=torch.float64)
    pos = torch.full((3,), 4.0, dtype=torch.float64)
    bad = [[plane] * 4,
           [plane] * 4 + [torch.zeros((8, 9), dtype=torch.float64)],
           [plane] * 4 + [plane.float()],
           [plane] * 4 + [torch.zeros(64, dtype=torch.float64)],
           torch.zeros((4, 8, 8), dtype=torch.float64)]
    for planes in bad:
        with pytest.raises(ValueError):
            gather_main(planes, pos, pos, 2)
    assert all(p is plane for p in as_planes([plane] * 5))


DECK = """
amr.n_cell = 31 27 16
hipace.normalized_units = 1
geometry.prob_lo = -4. -3. -6.
geometry.prob_hi =  4.  3.  2.
boundary.particle = Periodic
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


def test_pushers_gather_from_the_planes_in_place(monkeypatch):
    """The plasma and beam pushes hand K2 the slice's own five planes on
    every subcycle, never a stacked copy."""
    geom = TGeometry(n_cell=(31, 27, 16), prob_lo=(-4.0, -3.0, -6.0),
                     prob_hi=(4.0, 3.0, 2.0), nguards=2)
    pc = make_constants(True)
    inputs = Inputs(DECK)
    pcfg = tpl.PlasmaConfig.from_inputs(inputs, "plasma", pc, "Periodic")
    bcfg = tbm.BeamConfig.from_inputs(inputs, "beam", pc, geom, True)
    rng = np.random.default_rng(120)
    fields = {c: torch.tensor(0.1 * rng.standard_normal(geom.slice_shape))
              for c in PLANE_NAMES}
    calls = []
    real = tpl.gather_main

    def spy(planes, ym, xm, order):
        calls.append(tuple(planes))
        return real(planes, ym, xm, order)

    monkeypatch.setattr(tpl, "gather_main", spy)
    p = tpl.init_plasma(pcfg, geom, "cpu", torch.float64)
    tpl.advance_plasma(p, fields, geom, pcfg, pc, order=2)
    n = 300
    b = {"x": rng.normal(0.0, 1.2, n), "y": rng.normal(0.0, 1.0, n),
         "z": rng.uniform(-1.1, -0.4, n), "ux": rng.normal(0, 2.0, n),
         "uy": rng.normal(0, 2.0, n), "uz": rng.normal(2000, 50, n),
         "w": rng.uniform(0.5, 1.5, n), "sx": np.zeros(n),
         "sy": np.zeros(n), "sz": np.zeros(n),
         "nsub": np.zeros(n, np.int32), "beam_id": np.zeros(n, np.int32),
         "valid": np.ones(n, bool)}
    tbm.advance_all_beams({k: torch.tensor(v) for k, v in b.items()}, fields,
                          geom, (bcfg,), pc, 0.5, -2.0, order=2)
    assert len(calls) == pcfg.n_subcycles + bcfg.n_subcycles
    for planes in calls:
        assert all(a is fields[c] for a, c in zip(planes, PLANE_NAMES))
