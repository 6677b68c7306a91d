"""The beam push: one beam species' subcycles on one slice.

Port of the subcycle loop of the JAX package's ``advance_beam_slice``
(``hipace_tpu/particles/beam.py``, ref BeamParticleAdvance.cpp:19-336),
whose gathers run on K2 (``pallas_gather_main``,
``hipace_tpu/ops/pallas_banded.py:663``).

``beam_push_plain`` is that loop in PyTorch on any device: per subcycle the
slip and stop test, the half-step position, the transverse boundary, K2 at
the half-step position, the momentum and position update, with external
fields, TBMT spin precession, Tamburini radiation reaction and fine levels
where the push asks for them. ``beam_push`` runs a push that asks for none
of them (``takes_kernel``): CPU tensors take ``beam_push_plain``, CUDA
tensors launch ``csrc/beam_push.cu``, which runs every subcycle of every
lane in one launch, lane by lane as the loop does on the card, and counts
its launches in ``beam_push.launches``. Every other push runs the loop on
any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as cst
from ..constants import PhysConst
from ..fields.mr import in_level_bounds
from ..geometry import Geometry
from ..particles.plasma import enforce_particle_bc, field_planes, gather_fields
from . import cuda_lib
from .gather import plane_pointers

# the lanes' floating-point attributes the push reads and writes, in the
# kernel's order
LANE_ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w")
BOUNDARIES = {"Periodic": 0, "Reflecting": 1, "Absorbing": 2}
# the kernel's scalars (PushParams in csrc/beam_push.cu), in its order
PARAMS = ("min_z", "half_dt", "dt", "dt_qm", "half_dt_qm", "clight",
          "inv_c2", "lo0", "lo1", "hi0", "hi1", "lx", "ly", "two_lx",
          "two_ly", "x_off", "y_off", "inv_dx_pos", "inv_dy_pos", "guards",
          "inv_dx", "inv_dy")


def takes_kernel(cfg, external_fields=None, fine_levels=()) -> bool:
    """Whether a species' push on a slice is one kernel launch on the card:
    no external fields, spin tracking or radiation reaction, and no fine
    level active on the slice."""
    return not (cfg.use_external_fields or external_fields is not None
                or cfg.do_spin_tracking or cfg.do_radiation_reaction
                or fine_levels)


def beam_push_plain(bp: dict, fields: dict, geom: Geometry, cfg,
                    pc: PhysConst, dt, min_z, order: int = 2,
                    external_fields=None, time=0.0,
                    background_density_SI: float = 0.0, species_mask=None,
                    fine_levels=()):
    """Push the beam particles of one slice forward by dt in n_subcycles
    (ref BeamParticleAdvance.cpp:19-336), with the external fields (six
    functions of x, y, z, t) added to the gathered ones, TBMT spin
    precession (:218-241) and Tamburini radiation reaction (:244-299) where
    the species asks for them. Particles that slip below min_z stop; their
    remaining subcycles run on their new slice (resume counter 'nsub').
    With species_mask only those lanes move, and only they are gathered.
    fine_levels: (fields, geometry) of each fine level active on this slice,
    level 1 first; a lane inside a level gathers from it (K2 on the level's
    grid), the finest such level winning (ref
    BeamParticleAdvance.cpp:165-186)."""
    n_sub = cfg.n_subcycles
    dt = dt / n_sub
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = 1.0 / (pc.c * pc.c)
    q_m = cfg.charge / cfg.mass
    spin = cfg.do_spin_tracking
    rr = cfg.do_radiation_reaction
    normalized = pc.c == 1.0
    if rr:
        inv_c_SI = 1.0 / cst.SI_c
        q_over_mc = (q_m / cst.SI_c * cst.SI_q_e / cst.SI_m_e
                     if normalized else q_m / cst.SI_c)
        rr_coeff = (2.0 / 3.0) * cst.SI_r_e * q_over_mc * q_over_mc
        wp_inv = (1.0 / cst.plasma_frequency_SI(background_density_SI)
                  if normalized else 1.0)
        E0 = (cst.SI_m_e * cst.SI_c / wp_inv / cst.SI_q_e
              if normalized else 1.0)
    x, y, z = bp["x"], bp["y"], bp["z"]
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    w, valid = bp["w"], bp["valid"]
    sx, sy, sz = bp["sx"], bp["sy"], bp["sz"]
    nsub0 = bp["nsub"]
    stopped = torch.zeros_like(valid)
    nsub_out = nsub0
    planes = field_planes(fields)
    fine_planes = [field_planes(ff) for ff, _ in fine_levels]
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
        for fp, (_, fg) in zip(fine_planes, fine_levels):
            inb = in_level_bounds(xh, yh, fg)
            fine = gather_fields(fp, xh, yh, gmask & inb, fg, order)
            exmby, eypbx, ez, bx, by, bz = (
                torch.where(inb, f, c) for f, c in zip(
                    fine, (exmby, eypbx, ez, bx, by, bz)))
        if external_fields is not None:
            ex_e, ey_e, ez_e, bx_e, by_e, bz_e = (
                f(xh, yh, z, time) for f in external_fields)
            exmby = exmby + ex_e - clight * by_e
            eypbx = eypbx + ey_e + clight * bx_e
            ez, bx, by, bz = ez + ez_e, bx + bx_e, by + by_e, bz + bz_e
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
        if spin:
            # TBMT precession as a Cayley rotation, which keeps |s|
            ex_v = exmby + clight * by
            ey_v = eypbx - clight * bx
            ubx, uby, ubz = ux_mid * inv_c, uy_mid * inv_c, uz_mid * inv_c
            btx, bty, btz = (ubx * gam_mid_inv, uby * gam_mid_inv,
                             ubz * gam_mid_inv)
            g1 = gam_mid_inv / (1.0 + gam_mid_inv)
            bxe_x = (bty * ez - btz * ey_v) * inv_c
            bxe_y = (btz * ex_v - btx * ez) * inv_c
            bxe_z = (btx * ey_v - bty * ex_v) * inv_c
            bdotb = btx * bx + bty * by + btz * bz
            aqm = abs(q_m)
            a = cfg.spin_anom
            omx = aqm * (bx * gam_mid_inv - bxe_x * g1
                         + a * (bx - g1 * ubx * bdotb - bxe_x))
            omy = aqm * (by * gam_mid_inv - bxe_y * g1
                         + a * (by - g1 * uby * bdotb - bxe_y))
            omz = aqm * (bz * gam_mid_inv - bxe_z * g1
                         + a * (bz - g1 * ubz * bdotb - bxe_z))
            hx, hy, hz = omx * dt * 0.5, omy * dt * 0.5, omz * dt * 0.5
            spx = sx + (hy * sz - hz * sy)
            spy = sy + (hz * sx - hx * sz)
            spz = sz + (hx * sy - hy * sx)
            o = 1.0 / (1.0 + hx * hx + hy * hy + hz * hz)
            hdots = hx * spx + hy * spy + hz * spz
            sx_n = o * (spx + hdots * hx + (hy * spz - hz * spy))
            sy_n = o * (spy + hdots * hy + (hz * spx - hx * spz))
            sz_n = o * (spz + hdots * hz + (hx * spy - hy * spx))
            sx = torch.where(active, sx_n, sx)
            sy = torch.where(active, sy_n, sy)
            sz = torch.where(active, sz_n, sz)
        uz_next = uz + dt * q_m * (ez + (ux_mid * by - uy_mid * bx)
                                   * gam_mid_inv)
        if rr:
            # the Tamburini force in SI units
            ex_v = exmby + clight * by
            ey_v = eypbx - clight * bx
            ez_v, bx_v, by_v, bz_v = ez, bx, by, bz
            if normalized:
                ex_v, ey_v, ez_v = ex_v * E0, ey_v * E0, ez_v * E0
                bx_v = bx_v * E0 * inv_c_SI
                by_v = by_v * E0 * inv_c_SI
                bz_v = bz_v * E0 * inv_c_SI
            gam_mid = 1.0 / gam_mid_inv
            vx_n = ux_mid * gam_mid_inv * cst.SI_c * inv_c
            vy_n = uy_mid * gam_mid_inv * cst.SI_c * inv_c
            vz_n = uz_mid * gam_mid_inv * cst.SI_c * inv_c
            if normalized:
                bx_n, by_n, bz_n = (vx_n * inv_c_SI, vy_n * inv_c_SI,
                                    vz_n * inv_c_SI)
            else:
                bx_n, by_n, bz_n = (vx_n / cst.SI_c, vy_n / cst.SI_c,
                                    vz_n / cst.SI_c)
            flx = ex_v + vy_n * bz_v - vz_n * by_v
            fly = ey_v + vz_n * bx_v - vx_n * bz_v
            flz = ez_v + vx_n * by_v - vy_n * bx_v
            fl2 = flx * flx + fly * fly + flz * flz
            bdote = bx_n * ex_v + by_n * ey_v + bz_n * ez_v
            coeff = gam_mid * gam_mid * (fl2 - bdote * bdote)
            frx = rr_coeff * (cst.SI_c * (fly * bz_v - flz * by_v)
                              + bdote * ex_v - coeff * bx_n)
            fry = rr_coeff * (cst.SI_c * (flz * bx_v - flx * bz_v)
                              + bdote * ey_v - coeff * by_n)
            frz = rr_coeff * (cst.SI_c * (flx * by_v - fly * bx_v)
                              + bdote * ez_v - coeff * bz_n)
            fac = dt * wp_inv * clight * inv_c_SI if normalized else dt
            ux_next = ux_next + frx * fac
            uy_next = uy_next + fry * fac
            uz_next = uz_next + frz * fac
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
    # completed particles reset their counter for the next step
    done = nsub_out >= n_sub
    if species_mask is not None:
        done = done & species_mask
    nsub_out = torch.where(done, torch.zeros_like(nsub_out), nsub_out)
    out = dict(bp)
    out.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, w=w, valid=valid,
               sx=sx, sy=sy, sz=sz, nsub=nsub_out)
    return out


def push_params(geom: Geometry, cfg, pc: PhysConst, dt, min_z,
                dtype) -> list:
    """The kernel's scalars (PARAMS), each the Python float that the loop
    hands its op, so that the kernel's cast to the working type is the op's;
    1/dx and 1/dy of the cell positions are the working type's own, as
    PyTorch's division of a CUDA tensor by a scalar multiplies by them."""
    dt = float(dt) / cfg.n_subcycles
    q_m = cfg.charge / cfg.mass
    if cfg.particle_bounds is not None:
        lo0, lo1, hi0, hi1 = cfg.particle_bounds
    else:
        lo0, lo1 = geom.prob_lo[0], geom.prob_lo[1]
        hi0, hi1 = geom.prob_hi[0], geom.prob_hi[1]
    lx, ly = hi0 - lo0, hi1 - lo1
    one = np.float32 if dtype == torch.float32 else np.float64
    vals = {"min_z": min_z, "half_dt": dt * 0.5, "dt": dt,
            "dt_qm": dt * q_m, "half_dt_qm": dt * 0.5 * q_m,
            "clight": pc.c, "inv_c2": 1.0 / (pc.c * pc.c),
            "lo0": lo0, "lo1": lo1, "hi0": hi0, "hi1": hi1, "lx": lx,
            "ly": ly, "two_lx": 2 * lx, "two_ly": 2 * ly,
            "x_off": geom.x_pos_offset, "y_off": geom.y_pos_offset,
            "inv_dx_pos": one(1.0) / one(geom.dx),
            "inv_dy_pos": one(1.0) / one(geom.dy),
            "guards": geom.nguards, "inv_dx": 1.0 / geom.dx,
            "inv_dy": 1.0 / geom.dy}
    return [float(vals[k]) for k in PARAMS]


def beam_push_cuda(bp: dict, fields: dict, geom: Geometry, cfg,
                   pc: PhysConst, dt, min_z, order: int = 2, species=None):
    """Launch the fused beam push on CUDA tensors: the lanes of `species`
    (every lane where None) pushed through every subcycle."""
    if not 0 <= order <= 3:
        raise ValueError(f"unsupported order {order}")
    if cfg.particle_boundary not in BOUNDARIES:
        raise ValueError(f"unknown particle boundary "
                         f"{cfg.particle_boundary!r}")
    ptrs, NY, NX, dtype, device = plane_pointers(field_planes(fields))
    N = bp["x"].shape[0]
    for k in LANE_ATTRS:
        cuda_lib.require(bp[k], k, dtype=dtype, shape=(N,), device=device)
    cuda_lib.require(bp["valid"], "valid", dtype=torch.bool, shape=(N,),
                     device=device)
    cuda_lib.require(bp["nsub"], "nsub", dtype=torch.int32, shape=(N,),
                     device=device)
    if species is not None:
        cuda_lib.require(bp["beam_id"], "beam_id", dtype=torch.int32,
                         shape=(N,), device=device)
    out = torch.empty((len(LANE_ATTRS), N), dtype=dtype, device=device)
    valid = torch.empty_like(bp["valid"])
    nsub = torch.empty_like(bp["nsub"])
    if N:
        lanes = (ctypes.c_void_p * len(LANE_ATTRS))(
            *[bp[k].data_ptr() for k in LANE_ATTRS])
        planes = (ctypes.c_void_p * len(ptrs))(*ptrs)
        prm = (ctypes.c_double * len(PARAMS))(
            *push_params(geom, cfg, pc, dt, min_z, dtype))
        fn = cuda_lib.library().fn("hipace_beam_push", dtype)
        cuda_lib.launch(
            fn, bp["x"], out.data_ptr(), valid.data_ptr(), nsub.data_ptr(),
            lanes, bp["valid"].data_ptr(), bp["nsub"].data_ptr(),
            None if species is None else bp["beam_id"].data_ptr(), planes,
            prm, N, NY, NX, order, cfg.n_subcycles,
            -1 if species is None else species,
            BOUNDARIES[cfg.particle_boundary], int(cfg.do_z_push),
            cuda_lib.stream_ptr(bp["x"]), what="beam_push")
        beam_push.launches += 1
    res = dict(bp)
    res.update(zip(LANE_ATTRS, out))
    res.update(valid=valid, nsub=nsub)
    return res


def beam_push(bp: dict, fields: dict, geom: Geometry, cfg, pc: PhysConst,
              dt, min_z, order: int = 2, species=None):
    """A push that takes_kernel: the lanes of `species` (every lane where
    None) through the species' subcycles. CUDA tensors launch the kernel,
    CPU tensors take beam_push_plain."""
    if cuda_lib.use_kernel(bp["x"]):
        return beam_push_cuda(bp, fields, geom, cfg, pc, dt, min_z, order,
                              species)
    mask = None if species is None else bp["beam_id"] == species
    return beam_push_plain(bp, fields, geom, cfg, pc, dt, min_z, order,
                           species_mask=mask)


beam_push.launches = 0
