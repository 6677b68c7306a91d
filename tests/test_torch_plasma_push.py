"""The plasma push's choice between the fused kernel and the push loop, and
the loop itself, on the CPU in float64.

A species' push on a slice takes the fused kernel on the card
(``ops/plasma_push.py`` ``takes_kernel``) with the leapfrog and no fine
level active on the slice; the AB5 pusher and an active fine level keep the
loop. On the CPU every push runs the loop (``plasma_push_plain``), which is
also the kernel's plain version; here it is held bit for bit to the
leapfrog loop as it stood inside ``advance_plasma`` before it moved
(``_loop_before``), on lattice lanes moved about the box, some dead, some
near its edges with momenta that carry them across, with and without the
laser, ionizing and not, for each particle boundary, with and without the
trial push, one and two subcycles, orders 0-3, in normalized units and
with c = 1.7. The counters count only on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hipace_tpu_torch.constants import NORMALIZED, PhysConst
from hipace_tpu_torch.decks import ion_motion_even, pdf_beam
from hipace_tpu_torch.geometry import Geometry
from hipace_tpu_torch.ops import cuda_lib
from hipace_tpu_torch.ops import plasma_push as pp_ops
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
BOUNDARIES = ("Periodic", "Reflecting", "Absorbing")
GEOM = Geometry((23, 21, 8), (-4.0, -3.5, -3.0), (4.0, 3.5, 1.0))
# units in which c is not 1, so that 1/c and 1/c^2 round
C17 = PhysConst(c=1.7, ep0=1.0, mu0=1.0, q_e=1.0, m_e=1.0, m_p=1836.0)
UNITS = {"normalized": (NORMALIZED, 1.0), "c 1.7": (C17, 1.3)}


def _loop_before(p, fields, geom, cfg, pc, order, temp_slice, use_laser):
    """The leapfrog loop of advance_plasma before it moved to
    ops/plasma_push.py, without the branches of the AB5 pusher and the
    fine levels."""
    clight_inv = 1.0 / pc.c
    q_m_c = cfg.charge / (cfg.mass * pc.c)
    dz = geom.dz / cfg.n_subcycles
    x, y = p["x"], p["y"]
    xprev, yprev = p["x_prev"], p["y_prev"]
    ux_h, uy_h, psi_h = p["ux_half"], p["uy_half"], p["psi_half"]
    valid, w = p["valid"], p["w"]
    planes = tpl.field_planes(fields)
    lnorm = tpl.laser_norm(cfg, pc)
    if cfg.can_ionize:
        ion = p["ion_lev"].to(x.dtype)
        q_m_c = q_m_c * ion
        lnorm = lnorm * ion * ion
    laser = None
    for _ in range(cfg.n_subcycles):
        exmby, eypbx, ez, bx, by, bz = tpl.gather_fields(
            planes, xprev, yprev, valid, geom, order)
        fvals = (exmby, eypbx, ez, bx * pc.c, by * pc.c, bz)
        if use_laser:
            laser = tpl._laser_terms(xprev, yprev, fields["aabs"], geom,
                                     order, lnorm, pc)
        nsub = 4
        sdz = dz / nsub
        ux, uy, psi = ux_h, uy_h, psi_h
        for _s in range(nsub):
            ux, uy, psi = tpl._second_order_substep(
                ux, uy, psi, sdz, fvals, clight_inv, q_m_c, laser)
        xnew = xprev + dz * clight_inv * (ux / psi)
        ynew = yprev + dz * clight_inv * (uy / psi)
        x, y, ux, uy, w, valid = tpl.enforce_particle_bc(
            xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        if not temp_slice:
            ux_h, uy_h, psi_h = ux, uy, psi
            xprev, yprev = x, y
        for _s in range(nsub // 2):
            ux, uy, psi = tpl._second_order_substep(
                ux, uy, psi, sdz, fvals, clight_inv, q_m_c, laser)
    out = dict(p)
    out.update(x=x, y=y, w=w, valid=valid, ux=ux, uy=uy, psi=psi)
    if not temp_slice:
        out.update(x_prev=xprev, y_prev=yprev, ux_half=ux_h, uy_half=uy_h,
                   psi_half=psi_h)
    return out


def push_case(seed, geom=GEOM):
    """(lanes, fields) as numpy float64 / bool / int32: a species' lattice
    lanes moved by up to half a cell, every 13th dead, a quarter within
    half a cell of the box's transverse edges with momenta that carry many
    across, ion levels 0-3; the five planes and an |a|^2 plane."""
    rng = np.random.default_rng(seed)
    NY, NX = geom.slice_shape
    iy, ix = np.meshgrid(np.arange(geom.ny), np.arange(geom.nx),
                         indexing="ij")
    jit = rng.uniform(-0.5, 0.5, (2, ix.size))
    x = geom.prob_lo[0] + (ix.ravel() + 0.5 + jit[0]) * geom.dx
    y = geom.prob_lo[1] + (iy.ravel() + 0.5 + jit[1]) * geom.dy
    n = x.size
    edge = rng.random(n) < 0.25
    for arr, lo, hi, d in ((x, geom.prob_lo[0], geom.prob_hi[0], geom.dx),
                           (y, geom.prob_lo[1], geom.prob_hi[1], geom.dy)):
        side = np.where(rng.random(n) < 0.5, lo, hi)
        arr[edge] = (side + rng.uniform(-0.5, 0.5, n) * d)[edge]
    ux = 0.3 * rng.standard_normal(n)
    uy = 0.3 * rng.standard_normal(n)
    ux[edge] = 4.0 * rng.standard_normal(int(edge.sum()))
    uy[edge] = 4.0 * rng.standard_normal(int(edge.sum()))
    psi = 1.0 + 0.2 * rng.random(n)
    valid = np.ones(n, bool)
    valid[::13] = False
    lanes = {"x": x, "y": y, "x_prev": x.copy(), "y_prev": y.copy(),
             "ux": ux, "uy": uy, "psi": psi, "ux_half": ux.copy(),
             "uy_half": uy.copy(), "psi_half": psi.copy(),
             "w": rng.uniform(0.5, 1.5, n) * valid, "valid": valid,
             "ion_lev": rng.integers(0, 4, n).astype(np.int32)}
    fields = {c: 0.1 * rng.standard_normal((NY, NX))
              for c in ("Psi", "Ez", "Bx", "By", "Bz")}
    fields["aabs"] = 2.0 * rng.random((NY, NX))
    return lanes, fields


def push_cfg(units, boundary, n_subcycles, ionizing):
    """A species for the push: the units' charge over mass, the boundary,
    the subcycles, ion levels where ionizing."""
    _, mass = UNITS[units]
    return tpl.PlasmaConfig(mass=mass, particle_boundary=boundary,
                            n_subcycles=n_subcycles, can_ionize=ionizing)


# (use_laser, ionizing, temp_slice, n_subcycles, units) of every push
VARIANTS = [(laser, ion, temp, nsub, units)
            for laser in (False, True) for ion in (False, True)
            for temp in (False, True) for nsub in (1, 2) for units in UNITS]


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _same(got, ref, what):
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (what, k)
        assert torch.equal(got[k], ref[k]), (what, k)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_plain_push_equals_the_loop_before(boundary, order):
    """advance_plasma (plasma_push on the CPU) and plasma_push_plain against
    the loop before it moved, bit for bit, in every variant."""
    lanes, fields = push_case(10 * order + len(boundary))
    for use_laser, ion, temp, nsub, units in VARIANTS:
        what = (use_laser, ion, temp, nsub, units)
        pc = UNITS[units][0]
        cfg = push_cfg(units, boundary, nsub, ion)
        ref = _loop_before(_torch(lanes), _torch(fields), GEOM, cfg, pc,
                           order, temp, use_laser)
        got = tpl.advance_plasma(_torch(lanes), _torch(fields), GEOM, cfg,
                                 pc, order=order, temp_slice=temp,
                                 use_laser=use_laser)
        plain = pp_ops.plasma_push_plain(_torch(lanes), _torch(fields), GEOM,
                                         cfg, pc, order, temp,
                                         use_laser=use_laser)
        _same(got, ref, what)
        _same(plain, ref, what)
        for k in ("x", "y", "ux", "uy", "psi"):
            assert bool(torch.isfinite(got[k]).all()), (what, k)
        crossed = ((got["x"] - torch.as_tensor(lanes["x_prev"])).abs()
                   > GEOM.dx)
        assert int(crossed.sum()) > 20, what
        if boundary == "Absorbing":
            assert int(got["valid"].sum()) < int(lanes["valid"].sum()), what
        else:
            assert torch.equal(got["valid"], torch.as_tensor(lanes["valid"]))
        if temp:
            assert torch.equal(got["x_prev"], torch.as_tensor(lanes["x_prev"]))
        else:
            assert got["x_prev"] is got["x"] and got["y_prev"] is got["y"]


def test_the_laser_and_the_ion_levels_move_the_push():
    """The variants differ: the laser's terms and the lanes' ion levels
    each change the pushed momenta."""
    lanes, fields = push_case(3)
    pc = NORMALIZED
    outs = {}
    for use_laser in (False, True):
        for ion in (False, True):
            cfg = push_cfg("normalized", "Periodic", 1, ion)
            outs[use_laser, ion] = pp_ops.plasma_push_plain(
                _torch(lanes), _torch(fields), GEOM, cfg, pc, 2,
                use_laser=use_laser)["ux"]
    assert not torch.equal(outs[False, False], outs[True, False])
    assert not torch.equal(outs[False, False], outs[False, True])
    assert not torch.equal(outs[True, True], outs[True, False])


def _fine_level(geom):
    NY, NX = geom.slice_shape
    return ({c: torch.zeros((NY, NX), dtype=torch.float64)
             for c in ("Psi", "Ez", "Bx", "By", "Bz", "aabs")}, geom)


CHOICES = {
    # case: (pusher, fine levels on the slice, whether the push takes the
    # kernel)
    "leapfrog": ("leapfrog", (), True),
    "leapfrog, levels none active": ("leapfrog", (None, None), True),
    "leapfrog, an active level": ("leapfrog", (None, "level"), False),
    "ab5": ("ab5", (), False),
    "ab5, levels none active": ("ab5", (None,), False),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_the_kernel_is_chosen_by_the_pusher_and_the_slice(case):
    pusher, levels, want = CHOICES[case]
    levels = tuple(None if lvl is None else _fine_level(GEOM)
                   for lvl in levels)
    assert pp_ops.takes_kernel(pusher, levels) is want


DECKS = {
    # case: (deck, whether its plasma pushes take the kernel)
    "main path": (pdf_beam(31, 8, 1000), True),
    "ab5": (ion_motion_even(32, 8, 1000, "hipace.plasma_pusher = ab5\n"),
            False),
}


@pytest.mark.parametrize("case", list(DECKS))
def test_decks_choose_by_their_pusher(case):
    deck, want = DECKS[case]
    sim = Simulation(deck, device="cpu", verbose=0)
    assert pp_ops.takes_kernel(sim.cfg.plasma_pusher) is want


def test_a_level_of_nones_is_the_plain_push():
    """A fine-level tuple of Nones (the predictor-corrector's trial push on
    a slice where no level is active) changes nothing in the loop."""
    lanes, fields = push_case(4)
    cfg = push_cfg("normalized", "Reflecting", 2, False)
    tag = torch.zeros(lanes["x"].size, dtype=torch.int32)
    for temp in (False, True):
        ref = pp_ops.plasma_push_plain(_torch(lanes), _torch(fields), GEOM,
                                       cfg, NORMALIZED, 2, temp,
                                       use_laser=True)
        got = pp_ops.plasma_push_plain(_torch(lanes), _torch(fields), GEOM,
                                       cfg, NORMALIZED, 2, temp,
                                       use_laser=True,
                                       fine_levels=[None, None], tag=tag)
        _same(got, ref, temp)


def test_the_loop_is_counted_only_on_the_card(monkeypatch):
    """On the CPU neither the kernel's launches nor the loop's pushes
    count. With a device that takes kernels the AB5 and active-level pushes
    count as the loop's and the leapfrog as the kernel's: here the device
    test and the two pushes are stand-ins that record their calls."""
    lanes, fields = push_case(5)
    cfg = push_cfg("normalized", "Periodic", 1, False)
    before = (pp_ops.plasma_push.launches, tpl.advance_plasma.general_calls)
    ab5 = tpl.init_plasma(cfg, GEOM, "cpu", torch.float64, ab5=True)
    tpl.advance_plasma(ab5, _torch(fields), GEOM, cfg, NORMALIZED,
                       pusher="ab5")
    tpl.advance_plasma(_torch(lanes), _torch(fields), GEOM, cfg, NORMALIZED)
    assert (pp_ops.plasma_push.launches,
            tpl.advance_plasma.general_calls) == before

    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda t: True)
    monkeypatch.setattr(pp_ops, "plasma_push",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(pp_ops, "plasma_push_plain",
                        lambda *a, **k: calls.append("loop"))
    level = (_fine_level(GEOM),)
    tag = torch.ones(lanes["x"].size, dtype=torch.int32)
    for pusher, levels in (("leapfrog", ()), ("ab5", ()),
                           ("leapfrog", level), ("leapfrog", (None,))):
        tpl.advance_plasma(_torch(lanes), _torch(fields), GEOM, cfg,
                           NORMALIZED, pusher=pusher, fine_levels=levels,
                           tag=tag)
    assert calls == ["kernel", "loop", "loop", "kernel"]
    assert tpl.advance_plasma.general_calls == before[1] + 2
    tpl.advance_plasma.general_calls = before[1]


def test_push_params_are_the_loops_scalars():
    """The kernel's scalars are the Python floats the loop hands its ops,
    and the cell positions' 1/dx in the working type."""
    cfg = dataclasses.replace(push_cfg("c 1.7", "Reflecting", 2, False),
                              particle_bounds=(-3.0, -2.5, 3.5, 3.0))
    prm = dict(zip(pp_ops.PARAMS,
                   pp_ops.push_params(GEOM, cfg, C17, torch.float32)))
    dz = GEOM.dz / 2
    assert prm["dz_ci"] == dz * (1.0 / 1.7)
    assert prm["half_sdz2"] == 0.5 * (dz / 4) * (dz / 4)
    assert prm["qmc_ci"] == (-1.0 / (1.3 * 1.7)) * (1.0 / 1.7)
    assert prm["lnorm"] == tpl.laser_norm(cfg, C17)
    assert (prm["lo0"], prm["hi1"], prm["two_lx"]) == (-3.0, 3.0, 13.0)
    assert prm["inv_dx_pos"] == float(np.float32(1.0)
                                      / np.float32(GEOM.dx))
    assert prm["inv_dx"] == 1.0 / GEOM.dx
