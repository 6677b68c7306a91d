"""Plasma particle species: init, zeta pusher, deposits.

Port of ``hipace_tpu/particles/plasma.py`` for both Bx/By solvers (ref
PlasmaParticleContainer, PlasmaParticleAdvance.cpp:29-305,
PlasmaDepositCurrent.cpp, ExplicitDeposition.cpp): any number of species
(electrons, positrons, ions by element or mass), temperature (u_std), a
density table, the leapfrog and AB5 pushers (their loop in
``ops/plasma_push.py``, the leapfrog one kernel on the card) and the
explicit solver's deposit for every derivative type. A species is a dict of
flat (N,) tensors. The leapfrog's second-order dual-number correction (ref
PlasmaParticleAdvance.cpp:136-217), a jax.jvp in the JAX package, is the
explicit directional derivative of the momentum derivative along itself.
Deposits go through K1 (``ops/deposit.py``) and the gather through K2
(``ops/gather.py``) at guard-offset cell positions, with invalid particles
at the dead-lane sentinel.

Temperature is split as the pdf beam's init is: ``plasma_draws`` takes the
three normals from the simulation's generator as tensors and
``init_plasma`` is the transform of the draws it is given, so a test can
feed it the JAX package's own draws (the two generators' streams differ).

With a laser envelope, |a|^2 (the slice's ``aabs`` plane) enters as the
ponderomotive terms (ref PushPlasmaParticles.H, PlasmaDepositCurrent.cpp,
ExplicitDeposition.cpp): gathered at each lane by ``gather_laser_aabs`` with
its centred derivatives (on the card inside the fused push and the explicit
deposit's values kernel), scaled by ``laser_norm`` = ((q/e)(m_e/m))^2, into
the push's gamma and forces, the deposits' gamma, and the explicit
deposit's sixth Sx/Sy channel, combined with the grid differences of
|a|^2. The explicit deposit's lane algebra is ``ops/deposit_values.py``'s,
one kernel launch per species and slice on the card.

Field ionization (ref PlasmaParticleContainer.cpp:263-461): an ionizable
species carries its lanes' ion level ``ion_lev`` (int32) and a particle
identity ``pid``; the level scales each lane's charge in the pushes and
deposits (q_m_c and the charge density by the level, the laser's factor by
its square), as in the JAX package, on top of a configured charge that
``initial_ion_level`` >= 1 has already multiplied (ROADMAP R16).
``ionization_module`` is the ADK step of one slice on given uniforms; its
field gather is K2. A species that does not ionize has ``ion_lev`` 1 and
its arithmetic is unchanged.

Mesh refinement (``fields/mr.py``): a species with ``fine_patch(x,y)`` and
``fine_ppc`` places fine_ppc lanes per cell inside the patch, morphing from
the coarse layout over ``fine_transition_cells`` cells
(``_fine_patch_positions``, host numpy once per geometry); the lanes keep
the lattice order (slot slowest, then y, then x). A fine level's deposits
take the lanes tagged at or above it (``extra_mask``, which scales the
weights and never invalidates a lane) at the level-0 density
(``geom0``); the push gathers each tagged lane's fields from its level,
keeping the last values where a subcycle leaves the level.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..constants import SI_c, PhysConst
from ..geometry import Geometry
from ..ops import cuda_lib
from ..ops import deposit_values as dv_ops
from ..ops import plasma_push as push_ops
from ..ops.deposit import deposit
from ..ops.gather import PLANE_NAMES, gather_laser_aabs, gather_main
from ..ops.shape import DW_KIND, W_KIND
from ..parser import Inputs, TorchFunction, deck_function
from ..tracing import span
from .. import constants as cst
from ..utils.atomic_data import ATOMIC_WEIGHTS_DA, IONIZATION_ENERGIES_EV


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
    # field ionization (ref PlasmaParticleContainer.cpp:380-461): the
    # species' starting level (-1: not given), the product species' name
    # and the per-level ADK constants (power, prefactor, exp_prefactor),
    # which Simulation attaches once dz and the background density are known
    can_ionize: bool = False
    init_ion_lev: int = -1
    ionization_product: str = ""
    adk: tuple = ()
    u_mean: tuple = (0.0, 0.0, 0.0)
    u_std: tuple = (0.0, 0.0, 0.0)
    min_density: float = 0.0
    # "Periodic" | "Reflecting" | "Absorbing"
    particle_boundary: str = "Periodic"
    # optional tighter particle box (lo0, lo1, hi0, hi1)
    particle_bounds: tuple | None = None
    density_expr: str = "1."
    consts: tuple = ()
    element: str = "electron"
    # density table: ((position, density_expr), ...) sorted by position; the
    # expression of the smallest position >= c*t is used each step (ref
    # <plasma name>.density_table_file, parameters.rst:405-411)
    density_table: tuple = ()
    # the fine plasma patch of mesh refinement (ref
    # PlasmaParticleContainer.H:166-171, Init.cpp:95-160): fine_ppc inside
    # fine_patch(x, y) > 0, morphing from the coarse layout over
    # fine_transition_cells cells (ParticleUtil.H:66-104)
    fine_patch_expr: str = ""
    fine_ppc: tuple = (0, 0)
    fine_transition_cells: int = 5

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

        element = pp.query("element", "electron", str)
        if element == "electron":
            charge, mass = -pc.q_e, pc.m_e
        elif element == "positron":
            charge, mass = pc.q_e, pc.m_e
        elif element == "proton":
            charge, mass = pc.q_e, pc.m_p
        else:
            charge = pc.q_e
            mass = pc.m_p * ATOMIC_WEIGHTS_DA.get(element, 1.007276466621) \
                / 1.007276466621
        if pp.contains("mass_Da"):
            mass = pc.m_p * pp.get("mass_Da") / 1.007276466621
        mass = pp.query("mass", mass)
        charge = pp.query("charge", charge)
        init_ion_lev = pp.query("initial_ion_level", -1, int)
        can_ionize = pp.query("can_ionize", init_ion_lev >= 0, bool)
        if init_ion_lev >= 1:
            # the level multiplies the configured charge here, and the
            # lanes' ion_lev multiplies it again in the pushes and
            # deposits, as in the JAX package (ROADMAP R16)
            charge = (abs(charge) * init_ion_lev if charge > 0
                      else charge * init_ion_lev)
        dens = deck_function(inputs, (f"{name}.density", "plasmas.density"),
                             ("x", "y", "z"), default="1.")
        table = read_density_table(pp.query("density_table_file", "", str))
        fine = pp.get_function("fine_patch", ("x", "y"))
        return cls(
            name=name, charge=charge, mass=mass,
            ppc=tuple(pp.query_list("ppc", pa.query_list("ppc", [1, 1], int),
                                    int)),
            n_subcycles=q("n_subcycles", 1, int),
            radius=q("radius", float("inf")),
            hollow_core_radius=q("hollow_core_radius", 0.0),
            max_qsa_weighting_factor=q("max_qsa_weighting_factor", 35.0),
            neutralize_background=q("neutralize_background", not can_ionize,
                                    bool),
            can_ionize=can_ionize, init_ion_lev=init_ion_lev,
            ionization_product=pp.query("ionization_product", "", str),
            u_mean=tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0])),
            u_std=tuple(pp.query_list("u_std", [0.0, 0.0, 0.0])),
            min_density=q("min_density", 0.0),
            particle_boundary=particle_boundary,
            particle_bounds=pbounds,
            density_expr=table[0][1] if table else dens.expr,
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
            element=element,
            density_table=table,
            fine_patch_expr=fine.expr if fine is not None else "",
            fine_ppc=tuple(pp.query_list("fine_ppc", [0, 0], int)),
            fine_transition_cells=pp.query("fine_transition_cells", 5, int),
        )

    def density_fn(self) -> TorchFunction:
        return TorchFunction(self.density_expr, ("x", "y", "z"),
                             dict(self.consts))

    def density_at(self, c_t: float) -> str:
        """The density expression of the table at c*t: the entry of the
        smallest position >= c_t, else the last one; without a table the
        configured expression."""
        if not self.density_table:
            return self.density_expr
        return next((e for pos, e in self.density_table if pos >= c_t),
                    self.density_table[-1][1])


def read_density_table(path: str) -> tuple:
    """((position, density expression), ...) sorted by position from a
    density_table_file: one "position expression" pair per line; lines
    whose first word is not a number are skipped. No path, no table."""
    if not path:
        return ()
    table = []
    with open(path) as fh:
        for line in fh:
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            try:
                pos = float(parts[0])
            except ValueError:
                continue
            table.append((pos, parts[1].strip()))
    table.sort(key=lambda t: t[0])
    return tuple(table)


# the AB5 pusher's force history: slot i of field f is f"{f}{i}", i = 1..5
AB5_FIELDS = ("Fx", "Fy", "Fux", "Fuy", "Fpsi")
# Adams-Bashforth 5 coefficients, newest first
AB5_COEFFS = (1901.0 / 720.0, -1387.0 / 360.0, 109.0 / 30.0,
              -637.0 / 360.0, 251.0 / 720.0)


def has_fine_patch(cfg: PlasmaConfig) -> bool:
    """The species has a fine plasma patch: an expression and fine_ppc."""
    return bool(cfg.fine_patch_expr) and cfg.fine_ppc[0] * cfg.fine_ppc[1] > 0


def plasma_count(cfg: PlasmaConfig, geom: Geometry) -> int:
    """The lanes init_plasma makes: one per cell and ppc, or per cell and
    fine_ppc with a fine patch."""
    ppc = cfg.fine_ppc if has_fine_patch(cfg) else cfg.ppc
    return geom.nx * geom.ny * ppc[0] * ppc[1]


@functools.lru_cache(maxsize=4)
def _fine_patch_lanes(expr, fine_ppc, transition, ppc, consts, geom,
                      normalized_units, device, dtype):
    """_fine_patch_positions' lanes as (x, y, init_mask, weight scale)
    tensors on the device, made once per patch, grid and device."""
    cfg = PlasmaConfig(fine_patch_expr=expr, fine_ppc=fine_ppc,
                       fine_transition_cells=transition, ppc=ppc,
                       consts=consts)
    x, y, mask, scale = _fine_patch_positions(cfg, geom, normalized_units)
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device),
            torch.tensor(mask, device=device),
            torch.tensor(scale, dtype=dtype, device=device))


def _fine_patch_positions(cfg: PlasmaConfig, geom: Geometry,
                          normalized_units: bool):
    """The lanes of a species with a fine plasma patch (ref
    PlasmaParticleContainerInit.cpp:95-160, ParticleUtil.H:66-104), host
    numpy in float64. Every cell holds
    fine_ppc slots: outside the patch and its transition only the first ppc
    initialize, at the coarse layout; inside the transition the positions
    morph from the coarse layout, duplicated, to the fine one with the
    smoothstep s = 1.5 t - 0.5 t^3 of the per-cell transition counter t.
    Returns flat (x, y, init_mask, weight scale) in the slot-slowest, then
    y, then x order."""
    nx, ny = geom.nx, geom.ny
    pxc, pyc = cfg.ppc
    pxf, pyf = cfg.fine_ppc
    n_coarse, n_fine = pxc * pyc, pxf * pyf
    T = cfg.fine_transition_cells
    fp = TorchFunction(cfg.fine_patch_expr, ("x", "y"), dict(cfg.consts))
    xc = geom.prob_lo[0] + (np.arange(nx) + 0.5) * geom.dx
    yc = geom.prob_lo[1] + (np.arange(ny) + 0.5) * geom.dy
    Xc, Yc = np.meshgrid(xc, yc)
    inside = fp(torch.from_numpy(Xc), torch.from_numpy(Yc)).numpy() > 0
    # the transition counter: T + 1 inside, falling by one per cell outward
    a = np.where(inside, T + 1, 0)
    for _ in range(T):
        b = a.copy()
        b[:, 1:] = np.maximum(b[:, 1:], a[:, :-1] - 1)
        b[:, :-1] = np.maximum(b[:, :-1], a[:, 1:] - 1)
        b[1:, :] = np.maximum(b[1:, :], a[:-1, :] - 1)
        b[:-1, :] = np.maximum(b[:-1, :], a[1:, :] - 1)
        a = b
    i_part = np.arange(n_fine)
    ixf, iyf = i_part % pxf, i_part // pxf
    r_fine_x, r_fine_y = (0.5 + ixf) / pxf, (0.5 + iyf) / pyf
    r_coarse_x = (0.5 + (i_part % pxc)) / pxc
    r_coarse_y = (0.5 + np.minimum(i_part // pxc, pyc - 1)) / pyc
    r_dup_x = (0.5 + (ixf * pxc) // pxf) / pxc
    r_dup_y = (0.5 + (iyf * pyc) // pyf) / pyc
    A = a[None, :, :]
    s = A.astype(float) / (T + 1)
    s = 1.5 * s - 0.5 * s ** 3
    in_tr = A > 0
    rx = np.where(in_tr, r_dup_x[:, None, None] * (1.0 - s)
                  + r_fine_x[:, None, None] * s,
                  r_coarse_x[:, None, None] + 0.0 * s)
    ry = np.where(in_tr, r_dup_y[:, None, None] * (1.0 - s)
                  + r_fine_y[:, None, None] * s,
                  r_coarse_y[:, None, None] + 0.0 * s)
    do_init = in_tr | (i_part[:, None, None] < n_coarse)
    x = geom.prob_lo[0] + (np.arange(nx)[None, None, :] + rx) * geom.dx
    y = geom.prob_lo[1] + (np.arange(ny)[None, :, None] + ry) * geom.dy
    vol = 1.0 if normalized_units else geom.dx * geom.dy * geom.dz
    sc_c = vol / n_coarse if n_coarse else 0.0
    # coarse weights outside the patch and its transition, fine inside
    # (ref Init.cpp:290-292)
    wsc = np.where(in_tr, vol / n_fine, sc_c) + 0.0 * rx
    shape = (n_fine, ny, nx)
    return tuple(np.ascontiguousarray(np.broadcast_to(v, shape)).reshape(-1)
                 for v in (x, y, do_init, wsc))


def plasma_draws(cfg: PlasmaConfig, geom: Geometry, generator, device,
                 dtype):
    """The three standard normals per lane of a species with a temperature
    (u_std), drawn from `generator` on the device, as a (3, N) tensor; None
    for a cold species."""
    if not any(s != 0.0 for s in cfg.u_std):
        return None
    return torch.randn((3, plasma_count(cfg, geom)), generator=generator,
                       device=device, dtype=dtype)


def pad_plasma(st: dict, extra: int) -> dict:
    """Append `extra` invalid lanes (an ionization product's slots); psi
    pads with 1 so 1/psi stays finite, every other attribute (ion_lev and
    pid included) with 0."""
    if not extra:
        return st
    return {k: torch.cat([v, torch.full(
        (extra,), 1.0 if k in ("psi", "psi_half") else 0,
        dtype=v.dtype, device=v.device)]) for k, v in st.items()}


def init_plasma(cfg: PlasmaConfig, geom: Geometry, device, dtype,
                c_t: float = 0.0, normalized_units: bool = True,
                draws=None, ab5: bool = False) -> dict:
    """Fixed ppc per transverse cell, weight = density / ppc (ref
    PlasmaParticleContainerInit.cpp:17-378), or the fine patch's lanes
    (_fine_patch_positions). Ordering: ppc slowest, then y, then x
    fastest. A species with a temperature takes its momenta from
    `draws`, plasma_draws' (3, N) normals: u = u_mean + u_std * draw. With
    ab5 the state holds the AB5 pusher's 25 force-history slots, zero.
    Every lane has an int32 ion_lev: init_ion_lev for an ionizable species
    (0 is neutral), else 1; an ionizable species' lanes also carry their
    index as pid."""
    if has_fine_patch(cfg):
        # copies of the lanes made once on the device: no copy from the host
        # per step
        x, y, init_mask, scale = (v.clone() for v in _fine_patch_lanes(
            cfg.fine_patch_expr, cfg.fine_ppc, cfg.fine_transition_cells,
            cfg.ppc, cfg.consts, geom, normalized_units, torch.device(device),
            dtype))
    else:
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
        init_mask = None
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
    if init_mask is not None:
        valid = valid & init_mask
    if cfg.particle_bounds is not None:
        lo0, lo1, hi0, hi1 = cfg.particle_bounds
        valid = valid & (x >= lo0) & (x < hi0) & (y >= lo1) & (y < hi1)
    w = torch.where(valid, dens * scale, torch.zeros_like(x))
    if any(s != 0.0 for s in cfg.u_std):
        if draws is None or tuple(draws.shape) != (3, x.numel()):
            raise ValueError(f"{cfg.name}: a plasma with u_std needs (3, "
                             f"{x.numel()}) draws (plasma_draws)")
        u0, u1, u2 = (m + s * d for m, s, d in zip(cfg.u_mean, cfg.u_std,
                                                   draws.to(dtype)))
    else:
        u0, u1, u2 = (torch.full_like(x, v) for v in cfg.u_mean)
    psi = torch.sqrt(1.0 + u0 * u0 + u1 * u1 + u2 * u2) - u2
    # momenta stored as proper velocity u*c (ref Init.cpp:296-297); psi
    # comes from the dimensionless u first
    if not normalized_units:
        u0, u1 = u0 * SI_c, u1 * SI_c
    lev0 = cfg.init_ion_lev if cfg.can_ionize else 1
    out = {"x": x, "y": y, "w": w, "ux": u0, "uy": u1, "psi": psi,
           "x_prev": x, "y_prev": y, "ux_half": u0, "uy_half": u1,
           "psi_half": psi,
           "ion_lev": torch.full((x.numel(),), lev0, dtype=torch.int32,
                                 device=device),
           "valid": valid}
    if cfg.can_ionize:
        out["pid"] = torch.arange(x.numel(), dtype=torch.int32,
                                  device=device)
    if ab5:
        # ref PlasmaParticleContainer.H:21-46 under HIPACE_USE_AB5_PUSH
        z = torch.zeros_like(x)
        out.update({f"{f}{i}": z for i in range(1, 6) for f in AB5_FIELDS})
    return out


# ----------------------------------------------------------------------
def _momentum_derivative(ux, uy, psi_inv, exmby, eypbx, ez, bx_c, by_c, bz,
                         clight_inv, q_m_c, laser=None):
    """PlasmaMomentumPush (ref PushPlasmaParticles.H:39-75); laser, where
    given, is the lanes' scaled (a2, a2_dx, a2_dy)."""
    if laser is None:
        gamma_psi = 0.5 * psi_inv * psi_inv * (
            1.0 + ux * ux * clight_inv * clight_inv
            + uy * uy * clight_inv * clight_inv) + 0.5
    else:
        gamma_psi = 0.5 * psi_inv * psi_inv * (
            1.0 + laser[0] + ux * ux * clight_inv * clight_inv
            + uy * uy * clight_inv * clight_inv) + 0.5
    dz_ux = q_m_c * (gamma_psi * exmby + by_c + uy * bz * psi_inv)
    dz_uy = q_m_c * (gamma_psi * eypbx - bx_c - ux * bz * psi_inv)
    if laser is not None:
        dz_ux = dz_ux - laser[1] * psi_inv
        dz_uy = dz_uy - laser[2] * psi_inv
    dz_psi = (q_m_c * clight_inv
              * ((ux * exmby + uy * eypbx) * clight_inv * psi_inv - ez))
    return dz_ux, dz_uy, dz_psi


def _momentum_derivative_jvp(ux, uy, psi, dux, duy, dpsi, fields,
                             clight_inv, q_m_c, laser=None):
    """Directional derivative of _momentum_derivative at (ux, uy, psi)
    along (dux, duy, dpsi): the dual part of the reference's dual-number
    push (ref utils/DualNumbers.H)."""
    exmby, eypbx, ez, bx_c, by_c, bz = fields
    c2 = clight_inv * clight_inv
    psi_inv = 1.0 / psi
    dpsi_inv = -psi_inv * psi_inv * dpsi
    if laser is None:
        s = 1.0 + ux * ux * c2 + uy * uy * c2
    else:
        s = 1.0 + laser[0] + ux * ux * c2 + uy * uy * c2
    ds = 2.0 * (ux * dux + uy * duy) * c2
    dgamma = psi_inv * dpsi_inv * s + 0.5 * psi_inv * psi_inv * ds
    d_ux = q_m_c * (dgamma * exmby + bz * (duy * psi_inv + uy * dpsi_inv))
    d_uy = q_m_c * (dgamma * eypbx - bz * (dux * psi_inv + ux * dpsi_inv))
    if laser is not None:
        d_ux = d_ux - laser[1] * dpsi_inv
        d_uy = d_uy - laser[2] * dpsi_inv
    d_psi = q_m_c * c2 * ((dux * exmby + duy * eypbx) * psi_inv
                          + (ux * exmby + uy * eypbx) * dpsi_inv)
    return d_ux, d_uy, d_psi


def _second_order_substep(ux, uy, psi, sdz, fields, clight_inv, q_m_c,
                          laser=None):
    """One leapfrog substep with the second-order correction
    (ref PlasmaParticleAdvance.cpp:148-168)."""
    d = _momentum_derivative(ux, uy, 1.0 / psi, *fields, clight_inv, q_m_c,
                             laser)
    d2 = _momentum_derivative_jvp(ux, uy, psi, *d, fields, clight_inv, q_m_c,
                                  laser)
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


def field_planes(fields: dict) -> list:
    """The slice's five planes [Psi, Ez, Bx, By, Bz] as they lie, for K2."""
    return [fields[c] for c in PLANE_NAMES]


def gather_fields(planes, x, y, mask, geom: Geometry, order: int):
    """K2 at (x, y) from field_planes: (ExmBy, EypBx, Ez, Bx, By, Bz), zero
    on masked-out lanes."""
    ym, xm = cell_positions(x, y, mask, geom)
    out = gather_main(planes, ym, xm, order)
    return (out[0] * (1.0 / geom.dx), out[1] * (1.0 / geom.dy),
            out[2], out[3], out[4], out[5])


def _laser_terms(x, y, aabs, geom: Geometry, order: int, lnorm, pc):
    """The push's ponderomotive terms: |a|^2 and its derivatives at the
    lanes, scaled by the species' laser_norm."""
    a2, a2dx, a2dy = gather_laser_aabs(x, y, aabs, geom, order)
    return (a2 * 0.5 * lnorm, a2dx * 0.25 * pc.c * lnorm,
            a2dy * 0.25 * pc.c * lnorm)


def laser_norm(cfg: PlasmaConfig, pc: PhysConst, charge=None) -> float:
    """((q/e)(m_e/m))^2, the species' factor on |a|^2."""
    q = cfg.charge if charge is None else charge
    return ((q / pc.q_e) * (pc.m_e / cfg.mass)) ** 2


def advance_plasma(p: dict, fields: dict, geom: Geometry, cfg: PlasmaConfig,
                   pc: PhysConst, order: int = 2, temp_slice: bool = False,
                   pusher: str = "leapfrog", use_laser: bool = False,
                   fine_levels=(), tag=None):
    """Advance plasma particles one zeta slice (ops/plasma_push.py
    plasma_push_plain says how). A push that takes_kernel (the leapfrog, no
    fine level active) is one kernel launch on the card (plasma_push); every
    other (the AB5 pusher, an active fine level) runs the loop
    (plasma_push_plain), counted on the card in
    advance_plasma.general_calls."""
    if push_ops.takes_kernel(pusher, fine_levels):
        return push_ops.plasma_push(p, fields, geom, cfg, pc, order,
                                    temp_slice, use_laser)
    if cuda_lib.use_kernel(p["x_prev"]):
        advance_plasma.general_calls += 1
    return push_ops.plasma_push_plain(p, fields, geom, cfg, pc, order,
                                      temp_slice, pusher, use_laser,
                                      fine_levels, tag)


advance_plasma.general_calls = 0


# ----------------------------------------------------------------------
def _qsa_mask(p, gamma_psi, psi_inv, cfg):
    """Weight mask of particles violating the quasi-static approximation
    (ref PlasmaDepositCurrent.cpp:197-204) and the bad-lane flags."""
    bad = ((gamma_psi < 0.0) | (gamma_psi > cfg.max_qsa_weighting_factor)
           | (psi_inv < 0.0))
    ok = p["valid"] & ~bad
    return ok.to(psi_inv.dtype), bad


def deposit_invvol(geom: Geometry, geom0: Geometry | None,
                   normalized_units: bool) -> float:
    """A plasma or beam deposit's 1 / cell volume; in normalized units
    (level-0 cell area) / (this level's cell area), so that a fine level
    sees the same density (ref PlasmaDepositCurrent.cpp:71-73,
    BeamDepositCurrent.cpp:72-81)."""
    if not normalized_units:
        return 1.0 / (geom.dx * geom.dy * geom.dz)
    if geom0 is None:
        return 1.0
    return geom0.dx * geom0.dy / (geom.dx * geom.dy)


def _deposit_positions(p, geom, extra_mask, geom0):
    """K1's cell positions of a species' lanes and its lattice hint: lanes
    that are invalid, or outside extra_mask, at the dead-lane sentinel (a
    masked lane's weight is zero). The lanes keep the species' lattice order
    on every level, so the hint is level 0's width."""
    mask = p["valid"] if extra_mask is None else p["valid"] & extra_mask
    ym, xm = cell_positions(p["x"], p["y"], mask, geom)
    return ym, xm, (geom0 if geom0 is not None else geom).nx


def deposit_plasma(p: dict, stack_comps, fields: dict, geom: Geometry,
                   cfg: PlasmaConfig, pc: PhysConst, order: int,
                   normalized_units: bool, flip_charge: bool = False,
                   use_laser: bool = False, extra_mask=None,
                   geom0: Geometry | None = None):
    """Deposit plasma currents/densities through K1 (ref
    PlasmaDepositCurrent.cpp:22-257). stack_comps is a subset of
    jx, jy, jz, rho, rho_<species>, chi, rhomjz; with use_laser |a|^2 from
    fields["aabs"] enters gamma. On a fine level (geom, with level 0's
    geom0) only the lanes of extra_mask deposit (ref
    PlasmaDepositCurrent.cpp:130). Returns (fields, p) with QSA-violating
    particles invalidated."""
    charge = -cfg.charge if flip_charge else cfg.charge
    clight_inv = 1.0 / pc.c
    invvol = deposit_invvol(geom, geom0, normalized_units)
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv
    vy_c = p["uy"] * psi_inv
    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    lnorm = laser_norm(cfg, pc, charge)
    if cfg.can_ionize:
        ion = p["ion_lev"].to(psi_inv.dtype)
        q_invvol = q_invvol * ion
        q_mu0_m = q_mu0_m * ion
        lnorm = lnorm * ion * ion
    if use_laser:
        with span("laser: |a|^2 gather"):
            a2 = gather_laser_aabs(p["x"], p["y"], fields["aabs"], geom,
                                   order)[0] * lnorm
        gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                           + vx_c * vx_c * clight_inv ** 2
                           + vy_c * vy_c * clight_inv ** 2 + 1.0)
    else:
        gamma_psi = 0.5 * (psi_inv * psi_inv + vx_c * vx_c * clight_inv ** 2
                           + vy_c * vy_c * clight_inv ** 2 + 1.0)
    wmask, bad = _qsa_mask(p, gamma_psi, psi_inv, cfg)
    q_invvol = q_invvol * wmask
    if extra_mask is not None:
        q_invvol = q_invvol * extra_mask.to(q_invvol.dtype)
    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * pc.c,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }
    ym, xm, lattice = _deposit_positions(p, geom, extra_mask, geom0)
    stack = torch.stack([fields[c] for c in stack_comps])
    # rho_<species> deposits the same charge density as rho
    deposit(stack, ym, xm, torch.stack([
        values["rho" if c.startswith("rho_") else c] for c in stack_comps]),
        order, lattice_width=lattice)
    out = dict(fields)
    out.update(zip(stack_comps, stack))
    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out, new_p


def fused_plasma_deposits(p: dict, stack_comps, fields: dict, geom: Geometry,
                          cfg: PlasmaConfig, pc: PhysConst, order: int,
                          normalized_units: bool, deriv_type: int = 2,
                          use_laser: bool = False, extra_mask=None,
                          geom0: Geometry | None = None):
    """Main currents and the explicit Sx/Sy coefficient channels in ONE K1
    deposit (ref ExplicitDeposition.cpp; the JAX function's two branches).
    The lanes' values, K1's cell positions and the species' new w and valid
    come from ops/deposit_values.py: one kernel launch on the card (|a|^2
    gathered inside it), the plain lane algebra (deposit_values_plain) on
    the CPU. deriv_type 2: the centered derivative channels deposit with
    plain weights and become grid differences in combine_explicit_sxsy.
    deriv_type 0 or 1: they deposit with the derivative weights of that
    type, dw along y for the two dy channels and along x for the two dx
    channels, on order + deriv_type + 1 taps. stack_comps: jx, jy, chi,
    rhomjz and, where the deck asks, rho and rho_<species>. With use_laser |a|^2 enters gamma and a sixth
    coefficient channel (q/m)^2 mu0 rho / (4 psi^2) joins the plain-weight
    ones. extra_mask and geom0 as in deposit_plasma; on a fine level the
    returned state is the caller's to drop. Returns (fields, p, dgrids)."""
    args = (p, stack_comps, fields, geom, cfg, pc, order, normalized_units,
            deriv_type, use_laser, extra_mask, geom0)
    values, ym, xm, w, valid = dv_ops.deposit_values(*args)
    Cm, C1 = len(stack_comps), 5 + int(use_laser)
    acc = torch.cat([torch.stack([fields[c] for c in stack_comps]),
                     torch.zeros((C1 + 4,) + geom.slice_shape,
                                 dtype=values.dtype, device=values.device)])
    # the lanes keep the species' lattice order on every level
    lattice = (geom0 if geom0 is not None else geom).nx
    if deriv_type == 2:
        deposit(acc, ym, xm, values, order, deriv_type=2,
                lattice_width=lattice)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1:Cm + C1 + 2],
                  acc[Cm + C1 + 2:], True)
    else:
        deposit(acc, ym, xm, values, order, deriv_type=deriv_type,
                blocks=((W_KIND, W_KIND, Cm + C1), (DW_KIND, W_KIND, 2),
                        (W_KIND, DW_KIND, 2)), lattice_width=lattice)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1 + 2:],
                  acc[Cm + C1:Cm + C1 + 2], False)
    out = dict(fields)
    out.update(zip(stack_comps, acc[:Cm]))
    new_p = dict(p)
    new_p["w"] = w
    new_p["valid"] = valid
    return out, new_p, dgrids



def combine_explicit_sxsy(fields: dict, dgrids, pc: PhysConst,
                          geom: Geometry | None = None):
    """Pointwise combine of the fused coefficient grids into Sy/Sx after
    ExmBy/EypBx/Ez/Bz are solved (ref ExplicitDeposition.cpp:187-258). For
    deriv_type 2 (need_diff) the centered derivative is the grid difference
    D[i] = (E[i+1] - E[i-1])/2; the other types deposited theirs. With the
    laser's sixth channel, the clamped-edge centred differences of
    fields["aabs"] (geom's cell sizes) join Sy and Sx."""
    d1, d2, d3, need_diff = dgrids
    if need_diff:
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
    if d1.shape[0] == 6:
        aab = fields["aabs"]
        lf = (pc.m_e / pc.q_e) ** 2 * pc.c
        a2dx_f = (torch.cat([aab[:, 1:], aab[:, -1:]], dim=1)
                  - torch.cat([aab[:, :1], aab[:, :-1]], dim=1)
                  ) * (0.5 * (1.0 / geom.dx) * lf)
        a2dy_f = (torch.cat([aab[1:, :], aab[-1:, :]], dim=0)
                  - torch.cat([aab[:1, :], aab[:-1, :]], dim=0)
                  ) * (0.5 * (1.0 / geom.dy) * lf)
        out["Sy"] = out["Sy"] + a2dy_f * d1[5]
        out["Sx"] = out["Sx"] - a2dx_f * d1[5]
    return out



# ----------------------------------------------------------------------
def adk_constants(cfg: PlasmaConfig, dz: float, normalized_units: bool,
                  background_density_SI: float) -> tuple:
    """Per-level ADK constants (power, prefactor, exp_prefactor) of the
    species' element, host arithmetic on floats (ref
    PlasmaParticleContainer.cpp:415-453, Chen JCP 236 (2013) eq. 2). In
    normalized units the slice's time step dz / omega_p needs the
    background density."""
    energies = IONIZATION_ENERGIES_EV[cfg.element]
    alpha = 0.0072973525693
    r_e = 2.8179403227e-15
    a3 = alpha ** 3
    a4 = a3 * alpha
    wa = a3 * cst.SI_c / r_e
    Ea = cst.SI_m_e * cst.SI_c ** 2 / cst.SI_q_e * a4 / r_e
    UH = IONIZATION_ENERGIES_EV["H"][0]
    l_eff = math.sqrt(UH / energies[0]) - 1.0
    if normalized_units:
        dt = dz / cst.plasma_frequency_SI(background_density_SI)
    else:
        dt = dz / cst.SI_c
    out = []
    for i, Uion in enumerate(energies):
        n_eff = (i + 1) * math.sqrt(UH / Uion)
        C2 = 2.0 ** (2 * n_eff) / (n_eff * math.gamma(n_eff + l_eff + 1)
                                   * math.gamma(n_eff - l_eff))
        power = -(2 * n_eff - 1)
        prefactor = dt * wa * C2 * (Uion / (2 * UH)) \
            * (2 * (Uion / UH) ** 1.5 * Ea) ** (2 * n_eff - 1)
        exp_prefactor = -2.0 / 3.0 * (Uion / UH) ** 1.5 * Ea
        out.append((power, prefactor, exp_prefactor))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _adk_table(adk: tuple, dtype, device) -> torch.Tensor:
    """The ADK constants as an (nlev, 3) tensor on the device, made once:
    a copy to the card on every slice would wait for it."""
    return torch.tensor(adk, dtype=dtype, device=device)


def ionization_module(ion: dict, elec: dict, fields: dict, geom: Geometry,
                      ion_cfg: PlasmaConfig, pc: PhysConst, order: int,
                      normalized_units: bool, background_density_SI: float,
                      spawn_base: int, elec_init_ion_lev: int, draw):
    """ADK field ionization of one slice (ref
    PlasmaParticleContainer.cpp:263-440), the JAX package's static slot
    mode. The fields (ExmBy, EypBx, Ez, Bx, By, Bz) are gathered through K2
    at each ion's previous position (the envelope's field is not part of
    it, as in the JAX package); with the ADK rate of its level the ion's
    probability over the slice is 1 - exp(-w dtau), and it ionizes where
    its uniform `draw` ((n,), in the simulation's dtype; an ionizable
    species reads it at its pid) lies below. An ionized lane's level rises
    by one and an electron at rest is written into the product species
    `elec`, in the slot spawn_base + i * nlev + level that lane i owns
    for that level. The JAX package takes this mode where the parent's
    lane order is stable over the slices; the port never reorders plasma
    lanes, so it always is, every product has its slot and none can be
    lost. Each attribute of the product is one scatter into n_elec + 1
    lanes whose last is a drop bucket for the lanes that did not ionize;
    nothing is read back to the host. Returns (ion, elec)."""
    nlev = len(ion_cfg.adk)
    x, y = ion["x_prev"], ion["y_prev"]
    n = x.numel()
    dtype, device = x.dtype, x.device
    exmby, eypbx, ez, bx, by, bz = gather_fields(
        field_planes(fields), x, y, ion["valid"], geom, order)
    ex = exmby + by * pc.c
    ey = eypbx - bx * pc.c
    if normalized_units:
        E0 = (cst.plasma_frequency_SI(background_density_SI) * cst.SI_m_e
              * cst.SI_c / cst.SI_q_e)
    else:
        E0 = 1.0
    Ep = torch.clamp(torch.sqrt(ex * ex + ey * ey + ez * ez) * E0,
                     min=1e-30)
    clight_sq = 1.0 / (pc.c * pc.c)
    psi_h = ion["psi_half"]
    gammap = (1.0 + ion["ux_half"] ** 2 * clight_sq
              + ion["uy_half"] ** 2 * clight_sq
              + psi_h * psi_h) / (2.0 * psi_h)
    lev = torch.clamp(ion["ion_lev"], 0, nlev - 1).long()
    table = _adk_table(ion_cfg.adk, dtype, device)[lev]
    w_dtau = (gammap / psi_h * table[:, 1] * Ep ** table[:, 0]
              * torch.exp(table[:, 2] / Ep))
    prob = 1.0 - torch.exp(-w_dtau)
    if "pid" in ion:
        draw = draw[ion["pid"].long()]
    ionized = ion["valid"] & (ion["ion_lev"] < nlev) & (draw < prob)

    new_ion = dict(ion)
    new_ion["ion_lev"] = ion["ion_lev"] + ionized.to(torch.int32)
    n_elec = elec["x"].numel()
    slot = torch.where(ionized, spawn_base + torch.arange(
        n, device=device) * nlev + lev, torch.full_like(lev, n_elec))

    def put(arr, vals):
        ext = torch.cat([arr, arr.new_zeros(1)])
        return ext.index_put_((slot,), vals)[:-1]

    zero, one = torch.zeros_like(x), torch.ones_like(x)
    new_elec = dict(elec)
    for k, v in (("x", ion["x"]), ("y", ion["y"]), ("w", ion["w"]),
                 ("ux", zero), ("uy", zero), ("psi", one),
                 ("x_prev", x), ("y_prev", y), ("ux_half", zero),
                 ("uy_half", zero), ("psi_half", one),
                 ("ion_lev", torch.full((n,), max(elec_init_ion_lev, 1),
                                        dtype=torch.int32, device=device)),
                 ("valid", ionized)):
        new_elec[k] = put(elec[k], v)
    return new_ion, new_elec
