"""Plasma particle species: init, zeta pusher, deposits.

Port of the explicit-solver main path of ``hipace_tpu/particles/plasma.py``
(ref PlasmaParticleContainer, PlasmaParticleAdvance.cpp:29-305,
PlasmaDepositCurrent.cpp, ExplicitDeposition.cpp). A species is a dict of
flat (N,) tensors. The leapfrog's second-order dual-number correction
(ref PlasmaParticleAdvance.cpp:136-217), a jax.jvp in the JAX package, is
the explicit directional derivative of the momentum derivative along
itself. Deposits go through K1 (``ops/deposit.py``) and the gather through
K2 (``ops/gather.py``) at guard-offset cell positions, with invalid
particles at the dead-lane sentinel.

Not ported: ionization, temperature, density tables, the MR fine patch,
the AB5 pusher, the laser terms and derivative types 0/1.
"""

from __future__ import annotations

import dataclasses

import torch

from hipace_tpu.constants import SI_c, PhysConst
from hipace_tpu.geometry import Geometry
from hipace_tpu.parser import Inputs

from ..ops.deposit import deposit
from ..ops.gather import gather_main
from .. import unsupported
from ..parser import TorchFunction, deck_function


@dataclasses.dataclass(frozen=True)
class PlasmaConfig:
    """Per-species configuration (ref PlasmaParticleContainer.cpp)."""
    name: str = "plasma"
    charge: float = -1.0
    mass: float = 1.0
    ppc: tuple = (1, 1)
    n_subcycles: int = 1
    radius: float = float("inf")
    hollow_core_radius: float = 0.0
    max_qsa_weighting_factor: float = 35.0
    neutralize_background: bool = True
    u_mean: tuple = (0.0, 0.0, 0.0)
    min_density: float = 0.0
    # "Periodic" | "Reflecting" | "Absorbing"
    particle_boundary: str = "Periodic"
    # optional tighter particle box (lo0, lo1, hi0, hi1)
    particle_bounds: tuple | None = None
    density_expr: str = "1."
    consts: tuple = ()

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst,
                    particle_boundary: str) -> "PlasmaConfig":
        pp = inputs.prefix(name)
        pa = inputs.prefix("plasmas")
        pblo = inputs.query_list("boundary.particle_lo", [], float)
        pbhi = inputs.query_list("boundary.particle_hi", [], float)
        pbounds = (tuple(pblo[:2]) + tuple(pbhi[:2])
                   if len(pblo) >= 2 and len(pbhi) >= 2 else None)

        def q(key, default, dtype=None):
            return pp.query(key, pa.query(key, default, dtype), dtype)

        for key, what in (("initial_ion_level", unsupported.IONIZATION),
                          ("can_ionize", unsupported.IONIZATION),
                          ("ionization_product", unsupported.IONIZATION),
                          ("density_table_file", unsupported.OTHER_PATHS),
                          ("fine_ppc", unsupported.MR)):
            if pp.contains(key):
                unsupported.fail(f"{name}.{key}", what)
        if f"{name}.fine_patch" in inputs._funcs:
            unsupported.fail(f"{name}.fine_patch", unsupported.MR)
        if any(s != 0.0 for s in pp.query_list("u_std", [0.0, 0.0, 0.0])):
            unsupported.fail(f"{name}.u_std", unsupported.OTHER_PATHS)

        element = pp.query("element", "electron", str)
        if element == "electron":
            charge, mass = -pc.q_e, pc.m_e
        elif element == "positron":
            charge, mass = pc.q_e, pc.m_e
        elif element == "proton":
            charge, mass = pc.q_e, pc.m_p
        else:
            from hipace_tpu.utils.atomic_data import ATOMIC_WEIGHTS_DA
            charge = pc.q_e
            mass = pc.m_p * ATOMIC_WEIGHTS_DA.get(element, 1.007276466621) \
                / 1.007276466621
        if pp.contains("mass_Da"):
            mass = pc.m_p * pp.get("mass_Da") / 1.007276466621
        mass = pp.query("mass", mass)
        charge = pp.query("charge", charge)
        dens = deck_function(inputs, (f"{name}.density", "plasmas.density"),
                             ("x", "y", "z"), default="1.")
        return cls(
            name=name, charge=charge, mass=mass,
            ppc=tuple(pp.query_list("ppc", pa.query_list("ppc", [1, 1], int),
                                    int)),
            n_subcycles=q("n_subcycles", 1, int),
            radius=q("radius", float("inf")),
            hollow_core_radius=q("hollow_core_radius", 0.0),
            max_qsa_weighting_factor=q("max_qsa_weighting_factor", 35.0),
            neutralize_background=q("neutralize_background", True, bool),
            u_mean=tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0])),
            min_density=q("min_density", 0.0),
            particle_boundary=particle_boundary,
            particle_bounds=pbounds,
            density_expr=dens.expr,
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
        )

    def density_fn(self) -> TorchFunction:
        return TorchFunction(self.density_expr, ("x", "y", "z"),
                             dict(self.consts))


def pad_plasma(st: dict, extra: int) -> dict:
    """Append `extra` invalid lanes; psi pads with 1 so 1/psi stays
    finite."""
    if not extra:
        return st
    return {k: torch.cat([v, torch.full(
        (extra,), 1.0 if k in ("psi", "psi_half") else 0,
        dtype=v.dtype, device=v.device)]) for k, v in st.items()}


def init_plasma(cfg: PlasmaConfig, geom: Geometry, device, dtype,
                c_t: float = 0.0, normalized_units: bool = True) -> dict:
    """Fixed ppc per transverse cell, weight = density / ppc (ref
    PlasmaParticleContainerInit.cpp:17-378). Ordering: ppc slowest, then
    y, then x fastest."""
    nx, ny = geom.nx, geom.ny
    px, py = cfg.ppc
    nppc = px * py
    f64 = dict(dtype=torch.float64, device=device)
    sx = (torch.arange(px, **f64) + 0.5) / px
    sy = (torch.arange(py, **f64) + 0.5) / py
    X = geom.prob_lo[0] + (torch.arange(nx, **f64)[None, None, None, :]
                           + sx[:, None, None, None]) * geom.dx
    Y = geom.prob_lo[1] + (torch.arange(ny, **f64)[None, None, :, None]
                           + sy[None, :, None, None]) * geom.dy
    shape = (px, py, ny, nx)
    x = torch.broadcast_to(X, shape).reshape(-1).to(dtype)
    y = torch.broadcast_to(Y, shape).reshape(-1).to(dtype)
    if nppc == 0:
        scale = 0.0
    elif normalized_units:
        scale = 1.0 / nppc
    else:
        scale = geom.dx * geom.dy * geom.dz / nppc

    dens = cfg.density_fn()(x, y, torch.full_like(x, c_t))
    rsq = x * x + y * y
    valid = ((dens > cfg.min_density) & (rsq <= cfg.radius ** 2)
             & (rsq >= cfg.hollow_core_radius ** 2))
    if cfg.particle_bounds is not None:
        lo0, lo1, hi0, hi1 = cfg.particle_bounds
        valid = valid & (x >= lo0) & (x < hi0) & (y >= lo1) & (y < hi1)
    w = torch.where(valid, dens * scale, torch.zeros_like(x))
    u0, u1, u2 = (torch.full_like(x, v) for v in cfg.u_mean)
    psi = torch.sqrt(1.0 + u0 * u0 + u1 * u1 + u2 * u2) - u2
    # momenta stored as proper velocity u*c (ref Init.cpp:296-297); psi
    # comes from the dimensionless u first
    if not normalized_units:
        u0, u1 = u0 * SI_c, u1 * SI_c
    return {"x": x, "y": y, "w": w, "ux": u0, "uy": u1, "psi": psi,
            "x_prev": x, "y_prev": y, "ux_half": u0, "uy_half": u1,
            "psi_half": psi, "valid": valid}


# ----------------------------------------------------------------------
def _momentum_derivative(ux, uy, psi_inv, exmby, eypbx, ez, bx_c, by_c, bz,
                         clight_inv, q_m_c):
    """PlasmaMomentumPush (ref PushPlasmaParticles.H:39-75), no laser."""
    gamma_psi = 0.5 * psi_inv * psi_inv * (
        1.0 + ux * ux * clight_inv * clight_inv
        + uy * uy * clight_inv * clight_inv) + 0.5
    dz_ux = q_m_c * (gamma_psi * exmby + by_c + uy * bz * psi_inv)
    dz_uy = q_m_c * (gamma_psi * eypbx - bx_c - ux * bz * psi_inv)
    dz_psi = (q_m_c * clight_inv
              * ((ux * exmby + uy * eypbx) * clight_inv * psi_inv - ez))
    return dz_ux, dz_uy, dz_psi


def _momentum_derivative_jvp(ux, uy, psi, dux, duy, dpsi, fields,
                             clight_inv, q_m_c):
    """Directional derivative of _momentum_derivative at (ux, uy, psi)
    along (dux, duy, dpsi): the dual part of the reference's dual-number
    push (ref utils/DualNumbers.H)."""
    exmby, eypbx, ez, bx_c, by_c, bz = fields
    c2 = clight_inv * clight_inv
    psi_inv = 1.0 / psi
    dpsi_inv = -psi_inv * psi_inv * dpsi
    s = 1.0 + ux * ux * c2 + uy * uy * c2
    ds = 2.0 * (ux * dux + uy * duy) * c2
    dgamma = psi_inv * dpsi_inv * s + 0.5 * psi_inv * psi_inv * ds
    d_ux = q_m_c * (dgamma * exmby + bz * (duy * psi_inv + uy * dpsi_inv))
    d_uy = q_m_c * (dgamma * eypbx - bz * (dux * psi_inv + ux * dpsi_inv))
    d_psi = q_m_c * c2 * ((dux * exmby + duy * eypbx) * psi_inv
                          + (ux * exmby + uy * eypbx) * dpsi_inv)
    return d_ux, d_uy, d_psi


def _second_order_substep(ux, uy, psi, sdz, fields, clight_inv, q_m_c):
    """One leapfrog substep with the second-order correction
    (ref PlasmaParticleAdvance.cpp:148-168)."""
    d = _momentum_derivative(ux, uy, 1.0 / psi, *fields, clight_inv, q_m_c)
    d2 = _momentum_derivative_jvp(ux, uy, psi, *d, fields, clight_inv, q_m_c)
    half = 0.5 * sdz * sdz
    return (ux + sdz * d[0] + half * d2[0], uy + sdz * d[1] + half * d2[1],
            psi + sdz * d[2] + half * d2[2])


def enforce_particle_bc(x, y, ux, uy, w, valid, geom: Geometry, mode: str,
                        bounds=None):
    """Transverse particle boundary (ref GetAndSetPosition.H:31-101)."""
    if bounds is not None:
        lo0, lo1, hi0, hi1 = bounds
    else:
        lo0, lo1 = geom.prob_lo[0], geom.prob_lo[1]
        hi0, hi1 = geom.prob_hi[0], geom.prob_hi[1]
    out = (x < lo0) | (x > hi0) | (y < lo1) | (y > hi1)
    lx, ly = hi0 - lo0, hi1 - lo1
    if mode == "Periodic":
        x = torch.where(out, lo0 + torch.remainder(x - lo0, lx), x)
        y = torch.where(out, lo1 + torch.remainder(y - lo1, ly), y)
        return x, y, ux, uy, w, valid
    if mode == "Reflecting":
        xm = torch.remainder(x - lo0, 2 * lx)
        refx = xm > lx
        xn = torch.where(refx, 2 * lx - xm, xm) + lo0
        ym = torch.remainder(y - lo1, 2 * ly)
        refy = ym > ly
        yn = torch.where(refy, 2 * ly - ym, ym) + lo1
        return (torch.where(out, xn, x), torch.where(out, yn, y),
                torch.where(out & refx, -ux, ux),
                torch.where(out & refy, -uy, uy), w, valid)
    if mode != "Absorbing":
        raise ValueError(f"unknown particle boundary {mode!r}")
    return x, y, ux, uy, torch.where(out, torch.zeros_like(w), w), \
        valid & ~out


def cell_positions(x, y, mask, geom: Geometry):
    """Guard-offset cell positions (ym, xm) for K1/K2; masked-out lanes at
    the dead-lane sentinel (2 NY, 2 NX)."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    xm = (x - geom.x_pos_offset) / geom.dx + G
    ym = (y - geom.y_pos_offset) / geom.dy + G
    return (torch.where(mask, ym, torch.full_like(ym, 2.0 * NY)),
            torch.where(mask, xm, torch.full_like(xm, 2.0 * NX)))


def gather_stack(fields: dict) -> torch.Tensor:
    """The (5, NY, NX) stack [Psi, Ez, Bx, By, Bz] that K2 reads; built
    once per push, not once per subcycle."""
    return torch.stack([fields[c] for c in ("Psi", "Ez", "Bx", "By", "Bz")])


def gather_fields(stack, x, y, mask, geom: Geometry, order: int):
    """K2 at (x, y) from a gather_stack: (ExmBy, EypBx, Ez, Bx, By, Bz),
    zero on masked-out lanes."""
    ym, xm = cell_positions(x, y, mask, geom)
    out = gather_main(stack, ym, xm, order)
    return (out[0] * (1.0 / geom.dx), out[1] * (1.0 / geom.dy),
            out[2], out[3], out[4], out[5])


def advance_plasma(p: dict, fields: dict, geom: Geometry, cfg: PlasmaConfig,
                   pc: PhysConst, order: int = 2):
    """Advance plasma particles one zeta slice, leapfrog (ref
    PlasmaParticleAdvance.cpp:29-305). The explicit solver never pushes a
    temporary slice, so the half-step state always advances."""
    clight_inv = 1.0 / pc.c
    q_m_c = cfg.charge / (cfg.mass * pc.c)
    dz = geom.dz / cfg.n_subcycles
    x, y = p["x"], p["y"]
    xprev, yprev = p["x_prev"], p["y_prev"]
    ux_h, uy_h, psi_h = p["ux_half"], p["uy_half"], p["psi_half"]
    valid, w = p["valid"], p["w"]
    stack = gather_stack(fields)
    for _ in range(cfg.n_subcycles):
        exmby, eypbx, ez, bx, by, bz = gather_fields(stack, xprev, yprev,
                                                     valid, geom, order)
        fvals = (exmby, eypbx, ez, bx * pc.c, by * pc.c, bz)
        # full momentum push t-1/2 -> t+1/2 in 4 substeps
        nsub = 4
        sdz = dz / nsub
        ux, uy, psi = ux_h, uy_h, psi_h
        for _s in range(nsub):
            ux, uy, psi = _second_order_substep(ux, uy, psi, sdz, fvals,
                                                clight_inv, q_m_c)
        # position push t -> t+1 with momentum at t+1/2
        xnew = xprev + dz * clight_inv * (ux / psi)
        ynew = yprev + dz * clight_inv * (uy / psi)
        x, y, ux, uy, w, valid = enforce_particle_bc(
            xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        ux_h, uy_h, psi_h = ux, uy, psi
        xprev, yprev = x, y
        # half momentum push t+1/2 -> t+1 (deposit values only)
        for _s in range(nsub // 2):
            ux, uy, psi = _second_order_substep(ux, uy, psi, sdz, fvals,
                                                clight_inv, q_m_c)
    out = dict(p)
    out.update(x=x, y=y, w=w, valid=valid, ux=ux, uy=uy, psi=psi,
               x_prev=xprev, y_prev=yprev, ux_half=ux_h, uy_half=uy_h,
               psi_half=psi_h)
    return out


# ----------------------------------------------------------------------
def _qsa_mask(p, gamma_psi, psi_inv, cfg):
    """Weight mask of particles violating the quasi-static approximation
    (ref PlasmaDepositCurrent.cpp:197-204) and the bad-lane flags."""
    bad = ((gamma_psi < 0.0) | (gamma_psi > cfg.max_qsa_weighting_factor)
           | (psi_inv < 0.0))
    ok = p["valid"] & ~bad
    return ok.to(psi_inv.dtype), bad


def deposit_plasma(p: dict, stack_comps, fields: dict, geom: Geometry,
                   cfg: PlasmaConfig, pc: PhysConst, order: int,
                   normalized_units: bool, flip_charge: bool = False):
    """Deposit plasma currents/densities through K1 (ref
    PlasmaDepositCurrent.cpp:22-257). stack_comps is a subset of
    jx, jy, jz, rho, chi, rhomjz. Returns (fields, p) with QSA-violating
    particles invalidated."""
    charge = -cfg.charge if flip_charge else cfg.charge
    clight_inv = 1.0 / pc.c
    invvol = 1.0 if normalized_units else 1.0 / (geom.dx * geom.dy * geom.dz)
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv
    vy_c = p["uy"] * psi_inv
    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    gamma_psi = 0.5 * (psi_inv * psi_inv + vx_c * vx_c * clight_inv ** 2
                       + vy_c * vy_c * clight_inv ** 2 + 1.0)
    wmask, bad = _qsa_mask(p, gamma_psi, psi_inv, cfg)
    q_invvol = q_invvol * wmask
    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * pc.c,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }
    ym, xm = cell_positions(p["x"], p["y"], p["valid"], geom)
    stack = torch.stack([fields[c] for c in stack_comps])
    deposit(stack, ym, xm, torch.stack([values[c] for c in stack_comps]),
            order)
    out = dict(fields)
    out.update(zip(stack_comps, stack))
    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out, new_p


def fused_plasma_deposits(p: dict, stack_comps, fields: dict, geom: Geometry,
                          cfg: PlasmaConfig, pc: PhysConst, order: int,
                          normalized_units: bool):
    """Main currents and the explicit Sx/Sy coefficient channels in ONE K1
    deposit (the deriv_type 2 branch of the JAX function): the centered
    derivative channels deposit with plain weights and become grid
    differences in combine_explicit_sxsy. Returns (fields, p, dgrids)."""
    charge = cfg.charge
    cin = 1.0 / pc.c
    invvol = 1.0 if normalized_units else 1.0 / (geom.dx * geom.dy * geom.dz)
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv            # velocity * c
    vy_c = p["uy"] * psi_inv
    vx = vx_c * cin                      # dimensionless
    vy = vy_c * cin
    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    q_m = charge / cfg.mass
    gamma_psi = 0.5 * (psi_inv * psi_inv + vx * vx + vy * vy + 1.0)
    wmask, bad = _qsa_mask(p, gamma_psi, psi_inv, cfg)
    q_invvol = q_invvol * wmask
    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * pc.c,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }
    # explicit Sx/Sy coefficient channels (ref ExplicitDeposition.cpp)
    cd_mu0 = charge * invvol * pc.mu0 * p["w"] * wmask
    base = cd_mu0 * (q_m * psi_inv)
    chans = [base * vx, base * vy, base * vx * vy * cin,
             base * (gamma_psi - vy * vy) * cin,
             base * (gamma_psi - vx * vx) * cin]
    cdc = cd_mu0 * pc.c
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    v2 = [cdc * dx_inv * vx * vy,
          cdc * dx_inv * (gamma_psi - vx * vx - 1.0)]
    v3 = [-cdc * dy_inv * (gamma_psi - vy * vy - 1.0),
          -cdc * dy_inv * vx * vy]
    vall = [values[c] for c in stack_comps] + chans + v2 + v3
    Cm, C1 = len(stack_comps), len(chans)
    acc = torch.cat([torch.stack([fields[c] for c in stack_comps]),
                     torch.zeros((C1 + 4,) + geom.slice_shape,
                                 dtype=psi_inv.dtype,
                                 device=psi_inv.device)])
    ym, xm = cell_positions(p["x"], p["y"], p["valid"], geom)
    deposit(acc, ym, xm, torch.stack(vall), order, deriv_type=2)
    dgrids = (acc[Cm:Cm + C1], acc[Cm + C1:Cm + C1 + 2], acc[Cm + C1 + 2:])
    out = dict(fields)
    out.update(zip(stack_comps, acc[:Cm]))
    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out, new_p, dgrids


def combine_explicit_sxsy(fields: dict, dgrids, pc: PhysConst):
    """Pointwise combine of the fused coefficient grids into Sy/Sx after
    ExmBy/EypBx/Ez/Bz are solved (ref ExplicitDeposition.cpp:187-258); the
    centered derivative is the grid difference D[i] = (E[i+1] - E[i-1])/2."""
    d1, d2, d3 = dgrids
    z = torch.zeros_like(d2[:, :, :1])
    d2 = 0.5 * (torch.cat([d2[:, :, 1:], z], dim=2)
                - torch.cat([z, d2[:, :, :-1]], dim=2))
    zr = torch.zeros_like(d3[:, :1, :])
    d3 = 0.5 * (torch.cat([d3[:, 1:, :], zr], dim=1)
                - torch.cat([zr, d3[:, :-1, :]], dim=1))
    cin = 1.0 / pc.c
    bz_f, ez_f = fields["Bz"], fields["Ez"]
    exmby_f, eypbx_f = fields["ExmBy"], fields["EypBx"]
    out = dict(fields)
    out["Sy"] = (fields["Sy"] + bz_f * d1[0] - cin * ez_f * d1[1]
                 + exmby_f * d1[2] - eypbx_f * d1[3] + d2[0] + d3[0])
    out["Sx"] = (fields["Sx"] + bz_f * d1[1] + cin * ez_f * d1[0]
                 + exmby_f * d1[4] - eypbx_f * d1[2] + d2[1] + d3[1])
    return out

