"""Beam particle species: init, per-slice binning, time pusher, deposits.

Port of the main path of ``hipace_tpu/particles/beam.py`` (ref
BeamParticleContainer, BeamParticleContainerInit.cpp:348-475, BoxSort.cpp,
BeamParticleAdvance.cpp:19-336, BeamDepositCurrent.cpp). The beam is flat
(N,) tensors binned into per-slice (nz, cap) arrays with a validity mask;
momenta are proper velocities u = gamma*beta*c. The subcycle gather runs on
K2 and the current deposits on K1.

Not ported: the fixed_weight_pdf, fixed_ppc and from_file inits, spin,
radiation reaction, external fields, SALAME and several beams.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hipace_tpu.constants import PhysConst
from hipace_tpu.geometry import Geometry
from hipace_tpu.parser import Inputs

from .. import unsupported
from ..ops.deposit import deposit
from ..parser import TorchFunction
from .plasma import (cell_positions, enforce_particle_bc, gather_fields,
                     gather_stack)

# spin components are carried (zero) so the per-slice layout matches the
# JAX package's
BEAM_ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w", "sx", "sy", "sz")
# subcycle resume counter + species id
BEAM_INT_ATTRS = ("nsub", "beam_id")
ALL_ATTRS = BEAM_ATTRS + BEAM_INT_ATTRS + ("valid",)


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    name: str = "beam"
    charge: float = -1.0
    mass: float = 1.0
    num_particles: int = 0
    total_charge: float = 0.0            # in units of beam charge * weight
    profile: str = "gaussian"            # gaussian | can
    zmin: float = -float("inf")
    zmax: float = float("inf")
    radius: float = float("inf")
    position_mean: tuple = ("0.", "0.", 0.0)   # x(z), y(z) expressions, z
    position_std: tuple = (0.0, 0.0, 0.0)
    u_mean: tuple = (0.0, 0.0, 0.0)
    u_std: tuple = (0.0, 0.0, 0.0)
    duz_per_uz0_dzeta: float = 0.0
    do_symmetrize: bool = False
    z_foc: float = 0.0
    n_subcycles: int = 10
    do_z_push: bool = True
    particle_boundary: str = "Absorbing"
    particle_bounds: tuple | None = None
    consts: tuple = ()

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst,
                    geom: Geometry, normalized_units: bool) -> "BeamConfig":
        pp = inputs.prefix(name)
        pa = inputs.prefix("beams")

        def q(key, default, dtype=None):
            return pp.query(key, pa.query(key, default, dtype), dtype)

        injection = pp.get("injection_type", str)
        if injection == "fixed_weight_pdf":
            unsupported.fail(f"{name}.injection_type", unsupported.PDF_BEAM)
        if injection != "fixed_weight":
            unsupported.fail(f"{name}.injection_type", unsupported.OTHER_PATHS)
        if pp.query("do_salame", False, bool):
            unsupported.fail(f"{name}.do_salame", unsupported.SALAME)
        for key in ("do_radiation_reaction", "do_spin_tracking"):
            if q(key, False, bool):
                unsupported.fail(f"{name}.{key}", unsupported.OTHER_PATHS)
        for key in ("external_E(x,y,z,t)", "external_B(x,y,z,t)"):
            if inputs.raw(f"{name}.{key}") or inputs.raw(f"beams.{key}"):
                unsupported.fail(f"{name}.{key}", unsupported.OTHER_PATHS)
        profile = pp.query("profile", "gaussian", str)
        if profile not in ("gaussian", "can"):
            unsupported.fail(f"{name}.profile", unsupported.OTHER_PATHS)

        element = pp.query("element", "electron", str)
        if element == "positron":
            charge, mass = pc.q_e, pc.m_e
        elif element == "proton":
            charge, mass = pc.q_e, pc.m_p
        else:
            charge, mass = -pc.q_e, pc.m_e
        mass = pp.query("mass", mass)
        charge = pp.query("charge", charge)
        for dep in ("dx_per_dzeta", "dy_per_dzeta"):
            if pp.contains(dep):
                raise ValueError(
                    f"{name}.{dep} is no longer supported; use "
                    f"{name}.position_mean with expressions of z instead")
        num_particles = pp.query("num_particles", 0, int)
        do_symmetrize = pp.query("do_symmetrize", False, bool)
        if do_symmetrize and num_particles % 4:
            raise ValueError(f"{name}.do_symmetrize requires "
                             f"{name}.num_particles ({num_particles}) to be "
                             "divisible by 4")
        density = pp.query("density", 0.0)
        position_std = tuple(pp.query_list("position_std", [0.0, 0.0, 0.0]))
        pos_mean = pp.query_list("position_mean", ["0.", "0.", "0."], str)
        # total weight = total charge / charge (ref
        # BeamParticleContainer.cpp:167-194)
        if pp.contains("total_charge"):
            total_charge = pp.get("total_charge") / charge
        else:
            total_charge = density
            for std in position_std:
                total_charge *= std * math.sqrt(2.0 * math.pi)
            if normalized_units:
                total_charge /= geom.dx * geom.dy * geom.dz
        pblo = inputs.query_list("boundary.particle_lo", [], float)
        pbhi = inputs.query_list("boundary.particle_hi", [], float)
        return cls(
            name=name, charge=charge, mass=mass,
            num_particles=num_particles, total_charge=total_charge,
            profile=profile,
            zmin=pp.query("zmin", -float("inf")),
            zmax=pp.query("zmax", float("inf")),
            radius=pp.query("radius", float("inf")),
            position_mean=(str(pos_mean[0]), str(pos_mean[1]),
                           float(inputs._eval_scalar(str(pos_mean[2])))),
            position_std=position_std,
            u_mean=tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0])),
            u_std=tuple(pp.query_list("u_std", [0.0, 0.0, 0.0])),
            duz_per_uz0_dzeta=pp.query("duz_per_uz0_dzeta", 0.0),
            do_symmetrize=do_symmetrize,
            z_foc=pp.query("z_foc", 0.0),
            n_subcycles=q("n_subcycles", 10, int),
            do_z_push=q("do_z_push", True, bool),
            particle_boundary=inputs.query("boundary.particle", "Absorbing",
                                           str),
            particle_bounds=(tuple(pblo[:2]) + tuple(pbhi[:2])
                             if len(pblo) >= 2 and len(pbhi) >= 2 else None),
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
        )

    def mean_fn(self, comp: int) -> TorchFunction:
        return TorchFunction(self.position_mean[comp], ("z",),
                             dict(self.consts))


def init_beam(cfg: BeamConfig, geom: Geometry, generator: torch.Generator,
              device, dtype, pc: PhysConst) -> dict:
    """fixed_weight beam (ref BeamParticleContainerInit.cpp:348-475) as flat
    tensors. Deck momenta are gamma*beta; stored momenta are u*c."""
    n = cfg.num_particles
    nd = n // 4 if cfg.do_symmetrize else n

    def normal():
        return torch.randn(nd, generator=generator, dtype=dtype,
                           device=device)

    if cfg.profile == "can":
        z = cfg.zmin + (cfg.zmax - cfg.zmin) * torch.rand(
            nd, generator=generator, dtype=dtype, device=device)
        z_mean = 0.5 * (cfg.zmin + cfg.zmax)
    else:
        z_mean = cfg.position_mean[2]
        z = z_mean + cfg.position_std[2] * normal()
    x = cfg.position_std[0] * normal()
    y = cfg.position_std[1] * normal()
    ux = cfg.u_mean[0] + cfg.u_std[0] * normal()
    uy = cfg.u_mean[1] + cfg.u_std[1] * normal()
    uz = cfg.u_mean[2] + cfg.u_std[2] * normal()
    # z-correlated energy chirp (ref GetInitialMomentum.H:47)
    uz = uz + (z - z_mean) * cfg.duz_per_uz0_dzeta * cfg.u_mean[2]
    valid = ((z >= cfg.zmin) & (z <= cfg.zmax)
             & (x * x + y * y <= cfg.radius ** 2))
    # ballistic propagation to the focal plane (ref Init.cpp:445-447)
    x = x - cfg.z_foc * ux / uz
    y = y - cfg.z_foc * uy / uz
    if cfg.do_symmetrize:
        # mirrored transverse deviations and momenta (ref Init.cpp:458-472)
        sx = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dtype, device=device)
        sy = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dtype, device=device)
        x = (x[:, None] * sx).reshape(-1)
        y = (y[:, None] * sy).reshape(-1)
        ux = (ux[:, None] * sx).reshape(-1)
        uy = (uy[:, None] * sy).reshape(-1)
        z, uz, valid = (t.repeat_interleave(4) for t in (z, uz, valid))
        n = 4 * nd
    x = x + cfg.mean_fn(0)(z)
    y = y + cfg.mean_fn(1)(z)
    w = torch.where(valid, torch.full_like(
        x, cfg.total_charge / max(cfg.num_particles, 1)), torch.zeros_like(x))
    zero = torch.zeros_like(x)
    izero = torch.zeros(n, dtype=torch.int32, device=device)
    return {"x": x, "y": y, "z": z, "ux": ux * pc.c, "uy": uy * pc.c,
            "uz": uz * pc.c, "w": w, "sx": zero, "sy": zero, "sz": zero,
            "nsub": izero, "beam_id": izero, "valid": valid}


# ----------------------------------------------------------------------
def slice_index(z, geom: Geometry):
    """Beam slice binning (ref BoxSort.cpp:40-46): floor((z - lo_z)/dz)."""
    return torch.floor((z - geom.prob_lo[2]) / geom.dz).to(torch.int64)


def plan_capacity(beam: dict, geom: Geometry) -> int:
    """Per-slice capacity: 1.25 x the fullest slice + 16."""
    isl = slice_index(beam["z"], geom).cpu().numpy()
    isl = isl[beam["valid"].cpu().numpy() & (isl >= 0) & (isl < geom.nz)]
    if isl.size == 0:
        return 1
    return int(np.bincount(isl, minlength=geom.nz).max() * 1.25) + 16


def bin_beam(beam: dict, geom: Geometry, cap: int) -> dict:
    """Scatter a flat beam into per-slice (nz, cap) arrays, ranking by flat
    position within each slice; particles beyond a slice's capacity or
    outside the z domain are dropped and counted in 'n_dropped'."""
    nz = geom.nz
    isl = slice_index(beam["z"], geom)
    ok = beam["valid"] & (isl >= 0) & (isl < nz)
    isl_c = torch.where(ok, isl, torch.full_like(isl, nz))
    isl_sorted, order = torch.sort(isl_c, stable=True)
    starts = torch.searchsorted(isl_sorted, torch.arange(
        nz + 1, device=isl.device))
    rank = torch.arange(isl.numel(), device=isl.device) \
        - starts[isl_sorted.clamp(0, nz)]
    keep = (rank < cap) & (isl_sorted < nz)
    dst = torch.where(keep, isl_sorted * cap + rank,
                      torch.full_like(rank, nz * cap))
    out = {}
    for k in BEAM_ATTRS + BEAM_INT_ATTRS:
        src = beam[k][order]
        flat = torch.zeros(nz * cap + 1, dtype=src.dtype, device=src.device)
        flat[dst] = src
        out[k] = flat[:-1].reshape(nz, cap)
    vflat = torch.zeros(nz * cap + 1, dtype=torch.bool, device=isl.device)
    vflat[dst] = ok[order] & keep
    out["valid"] = vflat[:-1].reshape(nz, cap)
    out["n_dropped"] = int(ok.sum()) - int(out["valid"].sum())
    return out


def unbin_beam(binned: dict) -> dict:
    """Flatten per-slice arrays back to flat tensors."""
    return {k: binned[k].reshape(-1) for k in ALL_ATTRS}


# ----------------------------------------------------------------------
def advance_all_beams(bp: dict, fields: dict, geom: Geometry, cfgs,
                      pc: PhysConst, dt, min_z, order: int = 2):
    """Push the beam of the merged slice arrays. The port runs one beam
    species: ``unsupported.check_deck`` refuses several."""
    (cfg,) = cfgs
    return advance_beam_slice(bp, fields, geom, cfg, pc, dt, min_z,
                              order=order)


def advance_beam_slice(bp: dict, fields: dict, geom: Geometry,
                       cfg: BeamConfig, pc: PhysConst, dt, min_z,
                       order: int = 2):
    """Push the beam particles of one slice forward by dt in n_subcycles
    (ref BeamParticleAdvance.cpp:19-336). Particles that slip below min_z
    stop; their remaining subcycles run on their new slice (resume counter
    'nsub')."""
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
    stack = gather_stack(fields)
    for i in range(n_sub):
        slipped = z < min_z
        active = valid & (nsub0 <= i) & ~stopped & ~slipped
        stopped = stopped | (slipped & valid & (nsub0 <= i))

        gam_inv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                                   * inv_c2)
        xh = x + dt * 0.5 * ux * gam_inv
        yh = y + dt * 0.5 * uy * gam_inv
        xh, yh, ux_b, uy_b, w_b, val_b = enforce_particle_bc(
            xh, yh, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        exmby, eypbx, ez, bx, by, bz = gather_fields(stack, xh, yh, val_b,
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
    # completed particles reset their counter for the next step
    done = nsub_out >= n_sub
    nsub_out = torch.where(done, torch.zeros_like(nsub_out), nsub_out)
    out = dict(bp)
    out.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, w=w, valid=valid,
               nsub=nsub_out)
    return out


def _beam_deposit_values(bp, quantities, cfgs, pc: PhysConst, invvol):
    """Per-lane deposit values and the deposit mask (one beam species, as
    in advance_all_beams)."""
    (cfg,) = cfgs
    clight_sq = 1.0 / (pc.c * pc.c)
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    gam_inv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                               * clight_sq)
    mask = bp["valid"]
    wq = torch.where(mask, cfg.charge * bp["w"] * invvol,
                     torch.zeros_like(ux))
    vx, vy, vz = ux * gam_inv, uy * gam_inv, uz * gam_inv
    values = {"jx": wq * vx, "jy": wq * vy, "jz": wq * vz,
              "rhomjz": wq * (1.0 - vz * (1.0 / pc.c))}
    return [values[q] for q in quantities], mask


def deposit_beam_slice(bp: dict, comp_map: dict, fields: dict,
                       geom: Geometry, cfgs, pc: PhysConst, order: int,
                       normalized_units: bool):
    """Deposit beam currents through K1 (ref BeamDepositCurrent.cpp:
    60-200). comp_map maps quantity (jx, jy, jz, rhomjz) to field name."""
    invvol = 1.0 if normalized_units else 1.0 / (geom.dx * geom.dy * geom.dz)
    quantities = list(comp_map)
    vals, mask = _beam_deposit_values(bp, quantities, cfgs, pc, invvol)
    stack = torch.stack([fields[comp_map[q]] for q in quantities])
    ym, xm = cell_positions(bp["x"], bp["y"], mask, geom)
    deposit(stack, ym, xm, torch.stack(vals), order)
    out = dict(fields)
    out.update((comp_map[q], stack[i]) for i, q in enumerate(quantities))
    return out
