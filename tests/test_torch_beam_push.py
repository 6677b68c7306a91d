"""The beam push's choice between the fused kernel and the subcycle loop,
and the loop itself, on the CPU in float64.

A species' push on a slice takes the fused kernel on the card
(``ops/beam_push.py`` ``takes_kernel``) when it has no external fields,
spin tracking or radiation reaction and no fine level is active: the main
path's beam and DRIVE_WITNESS's drive beam do, its witness and the other
cases keep the loop. On the CPU every push runs the loop
(``beam_push_plain``), which is also the kernel's plain version; here it is
held bit for bit to the loop as it stood inside ``advance_beam_slice``
before it moved (``_loop_before``, the branches of the kernel's pushes),
over the lanes of ``test_torch_beam_paths.py`` and over lanes built the same
way that cross the box, for each particle boundary and orders 0-3. The
counters count only on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_beam_extras as jbe
from hipace_tpu_torch.decks import drive_witness, mr_wake, pdf_beam
from hipace_tpu_torch.ops import beam_push as bp_ops
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.particles.plasma import (enforce_particle_bc,
                                               field_planes, gather_fields)
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_beam_paths import SPECIES, _lanes, _planes

torch.set_num_threads(1)
BOUNDARIES = ("Periodic", "Reflecting", "Absorbing")


@pytest.fixture(scope="module")
def drive_wit():
    """DRIVE_WITNESS at 31^2 x 8: a drive beam and a witness with spin
    tracking and radiation reaction."""
    return Simulation(drive_witness(31, 8, 1000), device="cpu", verbose=0)


def _loop_before(bp, fields, geom, cfg, pc, dt, min_z, order, species_mask):
    """The subcycle loop of advance_beam_slice before it moved to
    ops/beam_push.py, without the branches of external fields, spin,
    radiation reaction and fine levels."""
    n_sub = cfg.n_subcycles
    dt = dt / n_sub
    clight = pc.c
    inv_c2 = 1.0 / (pc.c * pc.c)
    q_m = cfg.charge / cfg.mass
    x, y, z = bp["x"], bp["y"], bp["z"]
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    w, valid = bp["w"], bp["valid"]
    nsub0 = bp["nsub"]
    stopped = torch.zeros_like(valid)
    nsub_out = nsub0
    planes = field_planes(fields)
    for i in range(n_sub):
        slipped = z < min_z
        active = valid & (nsub0 <= i) & ~stopped & ~slipped
        if species_mask is not None:
            active = active & species_mask
        stopped = stopped | (slipped & valid & (nsub0 <= i))
        gam_inv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                                   * inv_c2)
        xh = x + dt * 0.5 * ux * gam_inv
        yh = y + dt * 0.5 * uy * gam_inv
        xh, yh, ux_b, uy_b, w_b, val_b = enforce_particle_bc(
            xh, yh, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        gmask = val_b if species_mask is None else val_b & species_mask
        exmby, eypbx, ez, bx, by, bz = gather_fields(planes, xh, yh, gmask,
                                                     geom, order)
        ux_next = ux_b + dt * q_m * (exmby + (clight - uz * gam_inv) * by
                                     + uy_b * gam_inv * bz)
        uy_next = uy_b + dt * q_m * (eypbx + (uz * gam_inv - clight) * bx
                                     - ux_b * gam_inv * bz)
        ux_mid = 0.5 * (ux_next + ux_b)
        uy_mid = 0.5 * (uy_next + uy_b)
        uz_mid = uz + dt * 0.5 * q_m * ez
        gam_mid_inv = 1.0 / torch.sqrt(
            1.0 + (ux_mid * ux_mid + uy_mid * uy_mid + uz_mid * uz_mid)
            * inv_c2)
        uz_next = uz + dt * q_m * (ez + (ux_mid * by - uy_mid * bx)
                                   * gam_mid_inv)
        gam_next_inv = 1.0 / torch.sqrt(
            1.0 + (ux_next * ux_next + uy_next * uy_next
                   + uz_next * uz_next) * inv_c2)
        xn = xh + dt * 0.5 * ux_next * gam_next_inv
        yn = yh + dt * 0.5 * uy_next * gam_next_inv
        zn = (z + dt * (uz_next * gam_next_inv - clight) if cfg.do_z_push
              else z)
        x = torch.where(active, xn, x)
        y = torch.where(active, yn, y)
        z = torch.where(active, zn, z)
        ux = torch.where(active, ux_next, ux)
        uy = torch.where(active, uy_next, uy)
        uz = torch.where(active, uz_next, uz)
        w = torch.where(active, w_b, w)
        valid = torch.where(active, val_b, valid)
        nsub_out = torch.where(active, torch.full_like(nsub_out, i + 1),
                               nsub_out)
    done = nsub_out >= n_sub
    if species_mask is not None:
        done = done & species_mask
    nsub_out = torch.where(done, torch.zeros_like(nsub_out), nsub_out)
    out = dict(bp)
    out.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, w=w, valid=valid,
               nsub=nsub_out)
    return out


def _kernel_cfgs(sim, **changes):
    """The simulation's beams with external fields, spin and radiation
    reaction off, and `changes`."""
    return tuple(dataclasses.replace(c, use_external_fields=False,
                                     do_spin_tracking=False,
                                     do_radiation_reaction=False, **changes)
                 for c in sim.beam_cfgs)


def _edge_lanes(sim, seed):
    """test_torch_beam_paths' lanes of two species, a third of them moved
    to within half a cell of the box's transverse edges with transverse
    momenta that carry many across."""
    g = sim.geom
    rng = np.random.default_rng(seed)
    bp, min_z = _lanes(rng, g, sim.pc.c, 900, 3, 2, False)
    edge = rng.random(900) < 1 / 3
    for k, lo, hi in (("x", g.prob_lo[0], g.prob_hi[0]),
                      ("y", g.prob_lo[1], g.prob_hi[1])):
        side = np.where(rng.random(900) < 0.5, lo, hi)
        near = side + rng.uniform(-0.5, 0.5, 900) * g.dx
        bp[k] = np.where(edge, near, bp[k])
    for k in ("ux", "uy"):
        bp[k] = np.where(edge, 60.0 * rng.standard_normal(900), bp[k])
    return bp, min_z, _planes(rng, g, False)


def _same(got, ref):
    for k in tbm.ALL_ATTRS:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_plain_push_equals_the_loop_before(drive_wit, boundary, order):
    """advance_all_beams over two species that take the kernel, on lanes
    across the box's edges, against the loop before it moved, bit for bit;
    with do_z_push off too."""
    sim = drive_wit
    bp, min_z, planes = _edge_lanes(sim, 10 * order + len(boundary))
    for z_push in (True, False):
        cfgs = _kernel_cfgs(sim, particle_boundary=boundary,
                            do_z_push=z_push)
        assert all(bp_ops.takes_kernel(c) for c in cfgs)
        got = tbm.advance_all_beams(_torch(bp), _torch(planes), sim.geom,
                                    cfgs, sim.pc, 1.0, min_z, order=order)
        ref = _torch(bp)
        for b, cfg in enumerate(cfgs):
            ref = _loop_before(ref, _torch(planes), sim.geom, cfg, sim.pc,
                               1.0, min_z, order, ref["beam_id"] == b)
        _same(got, ref)
        moved = got["x"] != torch.as_tensor(bp["x"])
        assert int(moved.sum()) > 300
        if boundary == "Absorbing":
            assert int(got["valid"].sum()) < int(bp["valid"].sum())
        else:
            assert torch.equal(got["valid"], torch.as_tensor(bp["valid"]))
        if not z_push:
            assert torch.equal(got["z"], torch.as_tensor(bp["z"]))


LANE_CASES = {
    # case: (deck, species pushed, SI units)
    "one species": (SPECIES, 1, False),
    "two species": (SPECIES, 2, False),
    "SI units": (jbe.DECK_RR, 1, True),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_plain_push_equals_the_loop_before_on_beam_paths_lanes(case):
    """test_torch_beam_paths' lanes and planes: its two species that differ
    in subcycles, charge and mass, the first alone, and its SI deck."""
    deck, nbeams, si = LANE_CASES[case]
    sim = Simulation(TInputs(deck), device="cpu", verbose=0)
    rng = np.random.default_rng(len(case))
    bp, min_z = _lanes(rng, sim.geom, sim.pc.c, 600, 3, nbeams, False)
    planes = _planes(rng, sim.geom, si)
    cfgs = _kernel_cfgs(sim)[:nbeams]
    got = tbm.advance_all_beams(_torch(bp), _torch(planes), sim.geom, cfgs,
                                sim.pc, sim.dt, min_z, order=2)
    ref = _torch(bp)
    for b, cfg in enumerate(cfgs):
        ref = _loop_before(ref, _torch(planes), sim.geom, cfg, sim.pc,
                           sim.dt, min_z, 2,
                           ref["beam_id"] == b if nbeams > 1 else None)
    _same(got, ref)
    assert int((got["uz"] != torch.as_tensor(bp["uz"])).sum()) > 300
    assert int((got["nsub"] > 0).sum()) > 0


def _fine_level(sim):
    NY, NX = sim.geom.slice_shape
    return ({c: torch.zeros((NY, NX), dtype=torch.float64)
             for c in ("Psi", "Ez", "Bx", "By", "Bz")}, sim.geom)


CHOICES = {
    # case: (deck, the species pushed, a fine level active on the slice,
    # whether the push takes the kernel)
    "main path": (pdf_beam(31, 8, 1000), 0, False, True),
    "DRIVE_WITNESS drive": (drive_witness(31, 8, 1000), 0, False, True),
    "DRIVE_WITNESS witness": (drive_witness(31, 8, 1000), 1, False, False),
    "spin": (drive_witness(31, 8, 1000,
                           "witness.do_radiation_reaction = 0\n"), 1, False,
             False),
    "radiation reaction": (drive_witness(31, 8, 1000,
                                         "witness.do_spin_tracking = 0\n"),
                           1, False, False),
    "external fields": (drive_witness(
        31, 8, 1000, "beams.external_E(x,y,z,t) = 0.02*x 0.02*y 0.01\n"),
        0, False, False),
    "active fine level": (mr_wake(31, 8, 1000, 15), 0, True, False),
    "fine level not active": (mr_wake(31, 8, 1000, 15), 0, False, True),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_the_kernel_is_chosen_by_the_species_and_the_slice(case):
    """The wrapper's choice through takes_kernel, with each species'
    external field functions as the slice step hands them over and the
    fine levels active on the slice."""
    deck, species, fine, want = CHOICES[case]
    sim = Simulation(deck, device="cpu", verbose=0)
    cfg = sim.beam_cfgs[species]
    external = tbm.beam_constants(sim.beam_cfgs, "cpu",
                                  torch.float64)["external"][species]
    levels = (_fine_level(sim),) if fine else ()
    assert bp_ops.takes_kernel(cfg, external, levels) is want
    if case == "active fine level":
        assert sim.cfg.mr_levels


def test_counters_count_only_on_the_card(drive_wit):
    """On the CPU neither the kernel's launches nor the loop's pushes on
    the card count, whichever way each species goes."""
    sim = drive_wit
    bp, min_z, planes = _edge_lanes(sim, 5)
    before = (bp_ops.beam_push.launches,
              tbm.advance_beam_slice.general_calls)
    external = tbm.beam_constants(sim.beam_cfgs, "cpu",
                                  torch.float64)["external"]
    assert [bp_ops.takes_kernel(c, e) for c, e in
            zip(sim.beam_cfgs, external)] == [True, False]
    tbm.advance_all_beams(_torch(bp), _torch(planes), sim.geom,
                          sim.beam_cfgs, sim.pc, 1.0, min_z,
                          background_density_SI=sim.cfg.background_density_SI,
                          external=external)
    assert (bp_ops.beam_push.launches,
            tbm.advance_beam_slice.general_calls) == before
