"""The plasma push: one plasma species' push on one slice.

Port of the push loop of the JAX package's ``advance_plasma``
(``hipace_tpu/particles/plasma.py``, ref PlasmaParticleAdvance.cpp:29-305),
whose field gathers run on K2 (``pallas_gather_main``,
``hipace_tpu/ops/pallas_banded.py:663``) and whose |a|^2 gathers run on XLA
(``gather_laser_aabs``).

``plasma_push_plain`` is that loop in PyTorch on any device: per subcycle
K2 at the lanes' previous positions, the laser's ponderomotive terms where
the deck has a laser, a tagged lane's fields from its fine level, and the
leapfrog's second-order momentum push, the position push and the transverse
boundary, or the AB5 pusher's multistep push. ``plasma_push`` runs a push
that ``takes_kernel`` (the leapfrog with no fine level active on the slice):
CPU tensors take ``plasma_push_plain``, CUDA tensors launch
``csrc/plasma_push.cu``, which runs every subcycle of every lane in one
launch, lane by lane as the loop does on the card (K2's gather and the
|a|^2 gather inline), and counts its launches in ``plasma_push.launches``.
Every other push runs the loop on any device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import NORMALIZED, PhysConst
from ..fields.mr import in_level_bounds
from ..geometry import Geometry
from ..particles import plasma as pl
from . import cuda_lib
from .gather import plane_pointers

# the lanes' attributes the kernel reads, in its order (and valid)
LANE_IN = ("x_prev", "y_prev", "ux_half", "uy_half", "psi_half", "w")
# the attributes it writes, in its order: the half-step momenta but on the
# trial push, w (and valid) only where the boundary absorbs; x_prev and
# y_prev are the new x and y
LANE_OUT = ("x", "y", "ux", "uy", "psi", "ux_half", "uy_half", "psi_half",
            "w")
# the kernel's scalars (PlasmaParams in csrc/plasma_push.cu), in its order
PARAMS = ("dz_ci", "sdz", "half_sdz2", "ci", "c2", "clight", "qmc", "qmc_ci",
          "qmc_c2", "lnorm", "lo0", "lo1", "hi0", "hi1", "lx", "ly", "two_lx",
          "two_ly", "x_off", "y_off", "inv_dx_pos", "inv_dy_pos", "guards",
          "inv_dx", "inv_dy")


def takes_kernel(pusher: str, fine_levels=()) -> bool:
    """Whether a species' push on a slice is one kernel launch on the card:
    the leapfrog, with no fine level active on the slice (fine_levels empty
    or every entry None, where the loop's fine-level values change
    nothing)."""
    return pusher == "leapfrog" and all(lvl is None for lvl in fine_levels)


def plasma_push_plain(p: dict, fields: dict, geom: Geometry, cfg,
                      pc: PhysConst, order: int = 2,
                      temp_slice: bool = False, pusher: str = "leapfrog",
                      use_laser: bool = False, fine_levels=(), tag=None):
    """Push a plasma species' lanes one zeta slice (ref
    PlasmaParticleAdvance.cpp:29-305), by the leapfrog or, with pusher
    "ab5", the Adams-Bashforth 5 multistep push (ref
    PlasmaParticleAdvance.cpp:218-305 under HIPACE_USE_AB5_PUSH), whose
    state carries init_plasma(ab5=True)'s force history. With use_laser the
    ponderomotive terms of fields["aabs"] join each subcycle's push. With
    temp_slice (the predictor-corrector's trial push on its current Bx/By
    guess) every subcycle gathers at the unchanged x_prev/y_prev and pushes
    from the unchanged half-step momenta, and only x, y, ux, uy, psi, w and
    valid come back updated; otherwise the half-step state (and the AB5
    history) advances too. fine_levels: (fields, geometry) of each fine
    level, level 1 first (None for a level no lane is tagged with), with
    tag the lanes' levels (fields.mr.tag_by_level): a tagged lane gathers
    from its level (K2 on the level's grid), and where a subcycle has moved
    it out of the level it keeps the values of the subcycle before (ref
    PlasmaParticleAdvance.cpp:94,114-135)."""

    clight_inv = 1.0 / pc.c
    q_m_c = cfg.charge / (cfg.mass * pc.c)
    dz = geom.dz / cfg.n_subcycles
    x, y = p["x"], p["y"]
    xprev, yprev = p["x_prev"], p["y_prev"]
    ux_h, uy_h, psi_h = p["ux_half"], p["uy_half"], p["psi_half"]
    valid, w = p["valid"], p["w"]
    planes = pl.field_planes(fields)
    lnorm = pl.laser_norm(cfg, pc)
    if cfg.can_ionize:
        # each lane's charge is its level times the species' (R16)
        ion = p["ion_lev"].to(x.dtype)
        q_m_c = q_m_c * ion
        lnorm = lnorm * ion * ion
    laser = None
    fine_planes = [pl.field_planes(lvl[0]) if lvl is not None else None
                   for lvl in fine_levels]
    stale = None
    for _ in range(cfg.n_subcycles):
        exmby, eypbx, ez, bx, by, bz = pl.gather_fields(
            planes, xprev, yprev, valid, geom, order)
        fvals = (exmby, eypbx, ez, bx * pc.c, by * pc.c, bz)
        if use_laser:
            laser = pl._laser_terms(xprev, yprev, fields["aabs"], geom,
                                    order, lnorm, pc)
        if fine_levels:
            vals = fvals + (laser if use_laser else ())
            if stale is None:
                stale = vals
            for li, lvl in enumerate(fine_levels):
                if lvl is None:
                    continue
                ff, fg = lvl
                sel = tag == li + 1
                e1, e2, e3, b1, b2, b3 = pl.gather_fields(
                    fine_planes[li], xprev, yprev, valid & sel, fg, order)
                fine = (e1, e2, e3, b1 * pc.c, b2 * pc.c, b3)
                if use_laser:
                    fine = fine + pl._laser_terms(xprev, yprev, ff["aabs"],
                                                  fg, order, lnorm, pc)
                inb = in_level_bounds(xprev, yprev, fg)
                vals = tuple(torch.where(sel, torch.where(inb, fv, sv), cv)
                             for fv, sv, cv in zip(fine, stale, vals))
            stale = vals
            fvals = vals[:6]
            laser = vals[6:] if use_laser else None
        if pusher == "ab5":
            # the derivative at the current state becomes history slot 1;
            # the push sums the five history terms
            psi_inv_h = 1.0 / psi_h
            dz_ux, dz_uy, dz_psi = pl._momentum_derivative(
                ux_h, uy_h, psi_inv_h, *fvals, clight_inv, q_m_c, laser)
            hist = {"Fx1": clight_inv * ux_h * psi_inv_h,
                    "Fy1": clight_inv * uy_h * psi_inv_h,
                    "Fux1": dz_ux, "Fuy1": dz_uy, "Fpsi1": dz_psi}
            hist.update({f"{f}{i}": p[f"{f}{i}"] for i in range(2, 6)
                         for f in pl.AB5_FIELDS})
            xnew, ynew = xprev, yprev
            ux, uy, psi = ux_h, uy_h, psi_h
            for i in range(5):
                a_dz = pl.AB5_COEFFS[i] * dz
                xnew = xnew + a_dz * hist[f"Fx{i + 1}"]
                ynew = ynew + a_dz * hist[f"Fy{i + 1}"]
                ux = ux + a_dz * hist[f"Fux{i + 1}"]
                uy = uy + a_dz * hist[f"Fuy{i + 1}"]
                psi = psi + a_dz * hist[f"Fpsi{i + 1}"]
            x, y, ux, uy, w, valid = pl.enforce_particle_bc(
                xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
                bounds=cfg.particle_bounds)
            if not temp_slice:
                ux_h, uy_h, psi_h = ux, uy, psi
                xprev, yprev = x, y
            continue
        # full momentum push t-1/2 -> t+1/2 in 4 substeps
        nsub = 4
        sdz = dz / nsub
        ux, uy, psi = ux_h, uy_h, psi_h
        for _s in range(nsub):
            ux, uy, psi = pl._second_order_substep(
                ux, uy, psi, sdz, fvals, clight_inv, q_m_c, laser)
        # position push t -> t+1 with momentum at t+1/2
        xnew = xprev + dz * clight_inv * (ux / psi)
        ynew = yprev + dz * clight_inv * (uy / psi)
        x, y, ux, uy, w, valid = pl.enforce_particle_bc(
            xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        if not temp_slice:
            ux_h, uy_h, psi_h = ux, uy, psi
            xprev, yprev = x, y
        # half momentum push t+1/2 -> t+1 (deposit values only)
        for _s in range(nsub // 2):
            ux, uy, psi = pl._second_order_substep(
                ux, uy, psi, sdz, fvals, clight_inv, q_m_c, laser)
    out = dict(p)
    out.update(x=x, y=y, w=w, valid=valid, ux=ux, uy=uy, psi=psi)
    if not temp_slice:
        out.update(x_prev=xprev, y_prev=yprev, ux_half=ux_h, uy_half=uy_h,
                   psi_half=psi_h)
        if pusher == "ab5":
            # shift the force history (ref PlasmaParticleAdvance.cpp:276-305)
            out.update({f"{f}{i}": hist[f"{f}{i - 1}"]
                        for f in pl.AB5_FIELDS for i in range(5, 1, -1)})
    return out


def push_params(geom: Geometry, cfg, pc: PhysConst, dtype) -> list:
    """The kernel's scalars (PARAMS), each the Python float that the loop
    hands its op, so that the kernel's cast to the working type is the op's;
    1/dx and 1/dy of the cell positions are the working type's own, as
    PyTorch's division of a CUDA tensor by a scalar multiplies by them."""
    clight_inv = 1.0 / pc.c
    c2 = clight_inv * clight_inv
    q_m_c = cfg.charge / (cfg.mass * pc.c)
    dz = geom.dz / cfg.n_subcycles
    sdz = dz / 4
    if cfg.particle_bounds is not None:
        lo0, lo1, hi0, hi1 = cfg.particle_bounds
    else:
        lo0, lo1 = geom.prob_lo[0], geom.prob_lo[1]
        hi0, hi1 = geom.prob_hi[0], geom.prob_hi[1]
    lx, ly = hi0 - lo0, hi1 - lo1
    one = np.float32 if dtype == torch.float32 else np.float64
    vals = {"dz_ci": dz * clight_inv, "sdz": sdz, "half_sdz2": 0.5 * sdz * sdz,
            "ci": clight_inv, "c2": c2, "clight": pc.c, "qmc": q_m_c,
            "qmc_ci": q_m_c * clight_inv, "qmc_c2": q_m_c * c2,
            "lnorm": pl.laser_norm(cfg, pc),
            "lo0": lo0, "lo1": lo1, "hi0": hi0, "hi1": hi1, "lx": lx,
            "ly": ly, "two_lx": 2 * lx, "two_ly": 2 * ly,
            "x_off": geom.x_pos_offset, "y_off": geom.y_pos_offset,
            "inv_dx_pos": one(1.0) / one(geom.dx),
            "inv_dy_pos": one(1.0) / one(geom.dy),
            "guards": geom.nguards, "inv_dx": 1.0 / geom.dx,
            "inv_dy": 1.0 / geom.dy}
    return [float(vals[k]) for k in PARAMS]


def plasma_push_cuda(p: dict, fields: dict, geom: Geometry, cfg,
                     pc: PhysConst, order: int = 2, temp_slice: bool = False,
                     use_laser: bool = False):
    """Launch the fused plasma push on CUDA tensors: every lane through the
    species' subcycles of the leapfrog."""
    if not 0 <= order <= 3:
        raise ValueError(f"unsupported order {order}")
    if cfg.particle_boundary not in cuda_lib.BOUNDARIES:
        raise ValueError(f"unknown particle boundary "
                         f"{cfg.particle_boundary!r}")
    if cfg.n_subcycles < 1:
        raise ValueError(f"n_subcycles {cfg.n_subcycles}: the fused push "
                         "takes one or more")
    ptrs, NY, NX, dtype, device = plane_pointers(pl.field_planes(fields))
    N = p["x_prev"].shape[0]
    for k in LANE_IN:
        cuda_lib.require(p[k], k, dtype=dtype, shape=(N,), device=device)
    cuda_lib.require(p["valid"], "valid", dtype=torch.bool, shape=(N,),
                     device=device)
    ion = p["ion_lev"] if cfg.can_ionize else None
    if ion is not None:
        cuda_lib.require(ion, "ion_lev", dtype=torch.int32, shape=(N,),
                         device=device)
    aabs = fields["aabs"] if use_laser else None
    if aabs is not None:
        cuda_lib.require(aabs, "aabs", dtype=dtype, shape=(NY, NX),
                         device=device)
    absorbing = cfg.particle_boundary == "Absorbing"
    names = [k for k in LANE_OUT
             if not (temp_slice and k.endswith("_half"))
             and (k != "w" or absorbing)]
    rows = dict(zip(names, torch.empty((len(names), N), dtype=dtype,
                                       device=device)))
    valid = torch.empty_like(p["valid"]) if absorbing else None
    if N:
        outs = (ctypes.c_void_p * len(LANE_OUT))(
            *[rows[k].data_ptr() if k in rows else None for k in LANE_OUT])
        lanes = (ctypes.c_void_p * len(LANE_IN))(
            *[p[k].data_ptr() for k in LANE_IN])
        planes = (ctypes.c_void_p * len(ptrs))(*ptrs)
        prm = (ctypes.c_double * len(PARAMS))(
            *push_params(geom, cfg, pc, dtype))
        fn = cuda_lib.library().fn("hipace_plasma_push", dtype)
        cuda_lib.launch(
            fn, p["x_prev"], outs, None if valid is None else valid.data_ptr(),
            lanes, p["valid"].data_ptr(),
            None if ion is None else ion.data_ptr(), planes,
            None if aabs is None else aabs.data_ptr(), prm, N, NY, NX, order,
            cfg.n_subcycles, cuda_lib.BOUNDARIES[cfg.particle_boundary],
            int(temp_slice), cuda_lib.stream_ptr(p["x_prev"]),
            what="plasma_push")
        plasma_push.launches += 1
    res = dict(p)
    res.update(rows)
    if valid is not None:
        res["valid"] = valid
    if not temp_slice:
        res.update(x_prev=rows["x"], y_prev=rows["y"])
    return res


def plasma_push(p: dict, fields: dict, geom: Geometry, cfg, pc: PhysConst,
                order: int = 2, temp_slice: bool = False,
                use_laser: bool = False):
    """A push that takes_kernel: every lane of the species through its
    subcycles of the leapfrog. CUDA tensors launch the kernel, CPU tensors
    take plasma_push_plain."""
    if cuda_lib.use_kernel(p["x_prev"]):
        return plasma_push_cuda(p, fields, geom, cfg, pc, order, temp_slice,
                                use_laser)
    return plasma_push_plain(p, fields, geom, cfg, pc, order, temp_slice,
                             use_laser=use_laser)


plasma_push.launches = 0


def laser_gather_cuda(xp, yp, aabs, geom: Geometry, order: int):
    """The |a|^2 gather of the fused push and the deposit-values kernel
    alone on CUDA tensors (csrc/laser_gather.cuh), for its tests against
    ops/gather.py gather_laser_aabs: (a2, a2_dx, a2_dy), each (N,)."""
    if not 0 <= order <= 3:
        raise ValueError(f"unsupported order {order}")
    NY, NX = aabs.shape
    N = xp.shape[0]
    cuda_lib.require(aabs, "aabs", shape=(NY, NX))
    for name, t in (("xp", xp), ("yp", yp)):
        cuda_lib.require(t, name, dtype=aabs.dtype, shape=(N,),
                         device=aabs.device)
    out = torch.empty((3, N), dtype=aabs.dtype, device=aabs.device)
    if N:
        cfg = pl.PlasmaConfig()
        prm = (ctypes.c_double * len(PARAMS))(
            *push_params(geom, cfg, NORMALIZED, aabs.dtype))
        fn = cuda_lib.library().fn("hipace_laser_gather", aabs.dtype)
        cuda_lib.launch(fn, aabs, out.data_ptr(), xp.data_ptr(),
                        yp.data_ptr(), aabs.data_ptr(), prm, N, NY, NX, order,
                        cuda_lib.stream_ptr(aabs), what="laser_gather")
    return tuple(out)
