"""Beam particle species: init, per-slice binning, time pusher, deposits.

Port of ``hipace_tpu/particles/beam.py`` (ref BeamParticleContainer,
BeamParticleContainerInit.cpp:119-695, BoxSort.cpp,
BeamParticleAdvance.cpp:19-336, BeamDepositCurrent.cpp). Every beam of the
deck is flat (N,) tensors, merged into one set of lanes with a ``beam_id``
per lane and binned into per-slice (nz, cap) arrays with a validity mask;
momenta are proper velocities u = gamma*beta*c. The push runs one masked
pass per species (``ops/beam_push.py``): on the card one kernel launch for
every subcycle of the species' lanes, or, where the species asks for
external fields, TBMT spin precession or Tamburini radiation reaction or a
fine level is active, the subcycle loop with its gathers on K2 (each pass
gathers only its own lanes); the current deposits are one K1 call over the
merged lanes with a per-lane charge.

Inits: fixed_weight, fixed_weight_pdf, fixed_ppc and from_file. The
fixed_weight_pdf init is split into its random draws (``pdf_draws``, from
the simulation's generator) and the transform of those draws
(``init_fixed_weight_pdf``), so that the transform can be fed any draws.

SALAME (``pipeline/salame.py``) reweights the lanes of the beams with
``do_salame``; its deposits take those lanes alone (``only_salame``). Under
mesh refinement a fine level's deposits take the lanes inside it
(``extra_mask``) at the level-0 density (``geom0``), and the push gathers
each lane's fields from the finest active level that holds it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import PhysConst
from ..diagnostics.openpmd import read_beam
from ..geometry import Geometry
from ..ops import cuda_lib
from ..ops.beam_push import beam_push, beam_push_plain, takes_kernel
from ..ops.deposit import deposit
from ..parser import Inputs, TorchFunction
from ..tracing import span
from .plasma import cell_positions, deposit_invvol

# spin components are carried (zero without spin tracking) so the per-slice
# layout is the same for every species
BEAM_ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w", "sx", "sy", "sz")
# subcycle resume counter + species id
BEAM_INT_ATTRS = ("nsub", "beam_id")
ALL_ATTRS = BEAM_ATTRS + BEAM_INT_ATTRS + ("valid",)
# the fixed_weight_pdf init's draws, in the JAX package's order: one
# uniform for z, then normals for x, y, ux, uy, uz
PDF_DRAWS = ("u", "x", "y", "ux", "uy", "uz")
INJECTION_TYPES = ("fixed_weight", "fixed_weight_pdf", "fixed_ppc",
                   "from_file")


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    name: str = "beam"
    injection_type: str = "fixed_weight"
    charge: float = -1.0
    mass: float = 1.0
    num_particles: int = 0
    density: float = 0.0
    total_charge: float = 0.0            # in units of beam charge * weight
    # fixed_weight: gaussian | can; fixed_ppc: flattop | gaussian | parsed
    profile: str = "gaussian"
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
    ppc: tuple = (1, 1, 1)
    density_expr: str = "1."
    n_subcycles: int = 10
    do_z_push: bool = True
    particle_boundary: str = "Absorbing"
    particle_bounds: tuple | None = None
    consts: tuple = ()
    # fixed_weight_pdf (ref BeamParticleContainer.cpp:200-250): expressions
    # of z for the pdf, the position mean/std (x, y) and the momentum
    # mean/std (x, y, z)
    pdf_expr: str = "1."
    pdf_pos_mean_expr: tuple = ("0.", "0.")
    pdf_pos_std_expr: tuple = ("0.", "0.")
    pdf_u_mean_expr: tuple = ("0.", "0.", "0.")
    pdf_u_std_expr: tuple = ("0.", "0.", "0.")
    pdf_ref_ratio: int = 4
    peak_density_is_specified: bool = False
    # from_file (ref BeamParticleContainer.cpp:252-276)
    input_file: str = ""
    file_iteration: int = 0
    # external fields: six expressions of (x, y, z, t) for Ex, Ey, Ez, Bx,
    # By, Bz (ref BeamParticleContainer.cpp:72-88, ExternalFields.H)
    use_external_fields: bool = False
    external_fields_expr: tuple = ("0", "0", "0", "0", "0", "0")
    do_radiation_reaction: bool = False
    do_spin_tracking: bool = False
    # SALAME beam loading (ref Salame.cpp): this beam's weights are adapted
    do_salame: bool = False
    initial_spin: tuple = (0.0, 0.0, 1.0)
    spin_anom: float = 0.00115965218128   # electron anomalous moment

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst,
                    geom: Geometry, normalized_units: bool) -> "BeamConfig":
        pp = inputs.prefix(name)
        pa = inputs.prefix("beams")

        def q(key, default, dtype=None):
            return pp.query(key, pa.query(key, default, dtype), dtype)

        injection = pp.get("injection_type", str)
        if injection not in INJECTION_TYPES:
            raise NotImplementedError(f"injection_type {injection}")
        # a fixed_weight beam of any profile but can is drawn as gaussian,
        # as the JAX package draws it; fixed_ppc knows three profiles
        profile = pp.query("profile", "gaussian", str)
        if injection == "fixed_ppc" and profile not in ("flattop", "gaussian",
                                                        "parsed"):
            raise NotImplementedError(f"beam profile {profile}")
        pdf = injection == "fixed_weight_pdf"

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
        # the pdf beam's position and momentum parameters are expressions
        # of z, kept apart below
        position_std = ((0.0, 0.0, 0.0) if pdf else
                        tuple(pp.query_list("position_std", [0.0, 0.0, 0.0])))
        pos_mean = (["0.", "0.", "0."] if pdf else
                    pp.query_list("position_mean", ["0.", "0.", "0."], str))
        # total weight = total charge / charge (ref
        # BeamParticleContainer.cpp:167-194)
        total_charge = 0.0
        if injection == "fixed_weight":
            if pp.contains("total_charge"):
                total_charge = pp.get("total_charge") / charge
            else:
                total_charge = density
                for std in position_std:
                    total_charge *= std * math.sqrt(2.0 * math.pi)
                if normalized_units:
                    total_charge /= geom.dx * geom.dy * geom.dz
        elif pdf and pp.contains("total_charge"):
            total_charge = pp.get("total_charge") / charge
        dens_fn = pp.get_function("density", ("x", "y", "z"))
        pblo = inputs.query_list("boundary.particle_lo", [], float)
        pbhi = inputs.query_list("boundary.particle_hi", [], float)

        def exprs(key, default):
            return tuple(pp.query_list(key, default, str)[:len(default)]) \
                if pdf else tuple(default)

        # external_E/B: three expressions of (x, y, z, t), or one, which is
        # the x component; the species' own, else the beams.' ones
        def three(key):
            raw = inputs.raw(f"{name}.{key}(x,y,z,t)")
            if raw is None:
                raw = inputs.raw(f"beams.{key}(x,y,z,t)")
            if raw is None:
                return None
            toks = inputs._split(raw)
            return tuple(toks) if len(toks) == 3 else (raw, "0", "0")

        e3, b3 = three("external_E"), three("external_B")

        return cls(
            name=name, injection_type=injection, charge=charge, mass=mass,
            num_particles=num_particles, density=density,
            total_charge=total_charge, profile=profile,
            zmin=pp.query("zmin", -float("inf")),
            zmax=pp.query("zmax", float("inf")),
            radius=pp.query("radius", float("inf")),
            position_mean=(str(pos_mean[0]), str(pos_mean[1]),
                           float(inputs._eval_scalar(str(pos_mean[2])))
                           if injection != "fixed_ppc" else 0.0),
            position_std=position_std,
            u_mean=((0.0, 0.0, 0.0) if pdf else
                    tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0]))),
            u_std=((0.0, 0.0, 0.0) if pdf else
                   tuple(pp.query_list("u_std", [0.0, 0.0, 0.0]))),
            duz_per_uz0_dzeta=pp.query("duz_per_uz0_dzeta", 0.0),
            do_symmetrize=do_symmetrize,
            z_foc=pp.query("z_foc", 0.0),
            ppc=tuple(pp.query_list("ppc", [1, 1, 1], int)),
            density_expr=dens_fn.expr if dens_fn is not None else "1.",
            n_subcycles=q("n_subcycles", 10, int),
            do_z_push=q("do_z_push", True, bool),
            particle_boundary=inputs.query("boundary.particle", "Absorbing",
                                           str),
            particle_bounds=(tuple(pblo[:2]) + tuple(pbhi[:2])
                             if len(pblo) >= 2 and len(pbhi) >= 2 else None),
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
            pdf_expr=inputs.raw(f"{name}.pdf(z)") or "1.",
            pdf_pos_mean_expr=exprs("position_mean", ["0.", "0."]),
            pdf_pos_std_expr=exprs("position_std", ["0.", "0."]),
            pdf_u_mean_expr=exprs("u_mean", ["0.", "0.", "0."]),
            pdf_u_std_expr=exprs("u_std", ["0.", "0.", "0."]),
            pdf_ref_ratio=pp.query("pdf_ref_ratio", 4, int),
            peak_density_is_specified=pp.contains("density"),
            input_file=pp.query("input_file", "", str),
            file_iteration=pp.query("iteration", 0, int),
            use_external_fields=e3 is not None or b3 is not None,
            external_fields_expr=(e3 or ("0", "0", "0"))
            + (b3 or ("0", "0", "0")),
            do_radiation_reaction=q("do_radiation_reaction", False, bool),
            do_spin_tracking=q("do_spin_tracking", False, bool),
            do_salame=pp.query("do_salame", False, bool),
            initial_spin=tuple(pp.query_list("initial_spin",
                                             [0.0, 0.0, 1.0])),
            spin_anom=q("spin_anom", 0.00115965218128),
        )

    def fn(self, expr: str, argnames=("z",)) -> TorchFunction:
        return TorchFunction(expr, argnames, dict(self.consts))

    def mean_fn(self, comp: int) -> TorchFunction:
        return self.fn(self.position_mean[comp])

    def external_field_fns(self):
        """The six external fields (Ex, Ey, Ez, Bx, By, Bz) as functions of
        (x, y, z, t), broadcast to the lanes; None without external
        fields."""
        if not self.use_external_fields:
            return None
        return tuple(self.fn(e, ("x", "y", "z", "t"))
                     for e in self.external_fields_expr)


def init_beam(cfg: BeamConfig, geom: Geometry, generator: torch.Generator,
              device, dtype, pc: PhysConst,
              normalized_units: bool = True) -> dict:
    """The beam as flat tensors, by injection type (ref
    BeamParticleContainerInit.cpp). Deck momenta are gamma*beta; stored
    momenta are u*c."""
    if cfg.injection_type == "fixed_weight":
        out = _init_fixed_weight(cfg, generator, device, dtype)
    elif cfg.injection_type == "fixed_weight_pdf":
        out = init_fixed_weight_pdf(
            cfg, geom, pdf_draws(cfg, generator, device, dtype),
            normalized_units)
    elif cfg.injection_type == "fixed_ppc":
        out = _init_fixed_ppc(cfg, geom, device, dtype, normalized_units)
    else:
        out = _init_from_file(cfg, device, dtype)
    n = out["x"].numel()
    izero = torch.zeros(n, dtype=torch.int32, device=out["x"].device)
    out.update(ux=out["ux"] * pc.c, uy=out["uy"] * pc.c, uz=out["uz"] * pc.c,
               nsub=izero, beam_id=izero)
    out.update(init_spin(cfg, out["x"]))
    return out


def init_spin(cfg: BeamConfig, like: torch.Tensor) -> dict:
    """The lanes' initial spin, initial_spin normalized, where the species
    tracks spin, else zeros (ref BeamParticleContainerInit.cpp:390-396);
    shaped like `like`."""
    if not cfg.do_spin_tracking:
        zero = torch.zeros_like(like)
        return {"sx": zero, "sy": zero, "sz": zero}
    s0 = torch.tensor(cfg.initial_spin, dtype=like.dtype, device=like.device)
    s0 = s0 / torch.sqrt(torch.sum(s0 * s0))
    return {k: s0[i].expand_as(like).clone()
            for i, k in enumerate(("sx", "sy", "sz"))}


def merge_beams(flats: list) -> dict:
    """Several beams' flat tensors as one set of lanes, in deck order, with
    each lane's species in 'beam_id' (int32)."""
    out = {k: torch.cat([f[k] for f in flats])
           for k in BEAM_ATTRS + ("valid", "nsub")}
    out["beam_id"] = torch.cat([
        torch.full((f["x"].numel(),), i, dtype=torch.int32,
                   device=f["x"].device) for i, f in enumerate(flats)])
    return out


def _init_fixed_weight(cfg: BeamConfig, generator, device, dtype) -> dict:
    """fixed_weight beam (ref BeamParticleContainerInit.cpp:348-475)."""
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
    x = x + cfg.mean_fn(0)(z)
    y = y + cfg.mean_fn(1)(z)
    w = torch.where(valid, torch.full_like(
        x, cfg.total_charge / max(cfg.num_particles, 1)), torch.zeros_like(x))
    return {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz, "w": w,
            "valid": valid}


def pdf_draws(cfg: BeamConfig, generator: torch.Generator, device,
              dtype) -> dict:
    """The fixed_weight_pdf init's random numbers (PDF_DRAWS), from the
    simulation's generator on its device."""
    n = cfg.num_particles
    out = {"u": torch.rand(n, generator=generator, dtype=dtype,
                           device=device)}
    for k in PDF_DRAWS[1:]:
        out[k] = torch.randn(n, generator=generator, dtype=dtype,
                             device=device)
    return out


def init_fixed_weight_pdf(cfg: BeamConfig, geom: Geometry, draws: dict,
                          normalized_units: bool) -> dict:
    """Longitudinal-pdf beam from its draws (ref
    BeamParticleContainerInit.cpp:477-695): z by the inverse CDF of the
    piecewise-linear pdf on the refined nz * pdf_ref_ratio grid; the
    transverse and momentum moments are expressions of z. The pdf and its
    CDF are evaluated once, in float64, on the draws' device."""
    u = draws["u"]
    dtype, device = u.dtype, u.device
    n = u.numel()
    f64 = dict(dtype=torch.float64, device=device)
    nzf = geom.nz * cfg.pdf_ref_ratio
    edges_np = np.linspace(geom.prob_lo[2], geom.prob_hi[2], nzf + 1)
    edges = torch.as_tensor(edges_np, **f64)
    dz = float(edges_np[1] - edges_np[0])
    pdf_e = cfg.fn(cfg.pdf_expr)(edges).clamp(min=0.0)
    # piecewise-linear pdf -> piecewise-quadratic CDF
    seg_w = 0.5 * (pdf_e[:-1] + pdf_e[1:])
    cdf = torch.cat([torch.zeros(1, **f64), torch.cumsum(seg_w, 0)])
    integral = cdf[-1]
    cdf = cdf / integral

    seg = (torch.searchsorted(cdf.to(dtype), u) - 1).clamp(0, nzf - 1)
    # invert the quadratic CDF within the segment (ref Init.cpp:645-652)
    pdf_t = pdf_e.to(dtype)
    lo_w, hi_w = pdf_t[seg], pdf_t[seg + 1]
    frac = (u - cdf.to(dtype)[seg]) \
        / (cdf[1:] - cdf[:-1]).to(dtype)[seg].clamp(min=1e-300)
    use_taylor = torch.minimum(lo_w, hi_w) * 1.1 > torch.maximum(lo_w, hi_w)
    denom_e = torch.where((hi_w - lo_w).abs() > 0, hi_w - lo_w,
                          torch.ones_like(hi_w))
    z_t = frac - frac * (frac - 1.0) * (hi_w - lo_w) \
        / (hi_w + lo_w).clamp(min=1e-300)
    z_e = (torch.sqrt(lo_w ** 2 + frac * (hi_w ** 2 - lo_w ** 2)) - lo_w) \
        / denom_e
    z = edges[:-1].to(dtype)[seg] + dz * torch.where(use_taylor, z_t, z_e)

    pos = [cfg.fn(e)(z) for e in cfg.pdf_pos_mean_expr + cfg.pdf_pos_std_expr]
    mom = [cfg.fn(e)(z) for e in cfg.pdf_u_mean_expr + cfg.pdf_u_std_expr]
    x = pos[2] * draws["x"]
    y = pos[3] * draws["y"]
    valid = x * x + y * y <= cfg.radius ** 2
    ux = mom[0] + mom[3] * draws["ux"]
    uy = mom[1] + mom[4] * draws["uy"]
    uz = mom[2] + mom[5] * draws["uz"]
    x = x - cfg.z_foc * ux / uz + pos[0]
    y = y - cfg.z_foc * uy / uz + pos[1]

    # total weight (ref Init.cpp:514-542)
    if cfg.peak_density_is_specified:
        mids = torch.as_tensor(0.5 * (edges_np[:-1] + edges_np[1:]), **f64)
        xs_std = cfg.fn(cfg.pdf_pos_std_expr[0])(mids)
        ys_std = cfg.fn(cfg.pdf_pos_std_expr[1])(mids)
        max_density = torch.max(seg_w / (dz * xs_std * ys_std * 2.0
                                         * math.pi))
        total_weight = cfg.density * float(integral) / float(max_density)
    else:
        total_weight = cfg.total_charge
    if normalized_units:
        total_weight /= geom.dx * geom.dy * geom.dz
    w = torch.where(valid, torch.full_like(x, total_weight / max(n, 1)),
                    torch.zeros_like(x))
    return {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz, "w": w,
            "valid": valid}


def _init_fixed_ppc(cfg: BeamConfig, geom: Geometry, device, dtype,
                    normalized_units: bool) -> dict:
    """Fixed particles per cell on the full 3D grid (ref
    BeamParticleContainerInit.cpp:119-347); x slowest, z fastest."""
    f64 = dict(dtype=torch.float64, device=device)
    axes = []
    for p, n, d, lo in zip(cfg.ppc, geom.n_cell, (geom.dx, geom.dy, geom.dz),
                           geom.prob_lo):
        off = (torch.arange(p, **f64) + 0.5) / p
        axes.append((lo + (torch.arange(n, **f64)[None, :] + off[:, None])
                     * d).reshape(-1))
    x, y, z = (a.reshape(-1).to(dtype)
               for a in torch.meshgrid(*axes, indexing="ij"))
    prof = _beam_profile_density(cfg, x, y, z)
    # the radius cut is relative to the z-dependent transverse centre
    rx = x - cfg.mean_fn(0)(z)
    ry = y - cfg.mean_fn(1)(z)
    valid = ((z >= cfg.zmin) & (z <= cfg.zmax)
             & (rx * rx + ry * ry <= cfg.radius ** 2) & (prof > 0.0))
    nppc = cfg.ppc[0] * cfg.ppc[1] * cfg.ppc[2]
    scale = 1.0 / nppc if normalized_units else \
        geom.dx * geom.dy * geom.dz / nppc
    w = torch.where(valid, prof * scale, torch.zeros_like(prof))
    ux, uy, uz = (torch.full_like(x, v) for v in cfg.u_mean)
    return {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz, "w": w,
            "valid": valid}


def _beam_profile_density(cfg: BeamConfig, x, y, z):
    """The fixed_ppc beam's density at (x, y, z): flattop, gaussian about
    position_mean(z) with position_std, or the deck's density(x,y,z)."""
    if cfg.profile == "flattop":
        return torch.full_like(x, cfg.density)
    if cfg.profile == "parsed":
        return cfg.fn(cfg.density_expr, ("x", "y", "z"))(x, y, z)
    means = (cfg.mean_fn(0)(z), cfg.mean_fn(1)(z), cfg.position_mean[2])
    arg = torch.zeros_like(x)
    for v, m, s in zip((x, y, z), means, cfg.position_std):
        if s > 0:
            arg = arg + (v - m) ** 2 / (2 * s ** 2)
    return cfg.density * torch.exp(-arg)


def _init_from_file(cfg: BeamConfig, device, dtype) -> dict:
    """A beam read from an openPMD file written by this package, the JAX
    package or the reference (ref BeamParticleContainerInit.cpp:698+)."""
    b = read_beam(cfg.input_file, cfg.file_iteration, cfg.name)
    out = {k: torch.as_tensor(b[k]).to(device=device, dtype=dtype)
           for k in ("x", "y", "z", "ux", "uy", "uz", "w")}
    out["valid"] = torch.ones(out["x"].numel(), dtype=torch.bool,
                              device=device)
    return out


# ----------------------------------------------------------------------
def slice_index(z, geom: Geometry):
    """Beam slice binning (ref BoxSort.cpp:40-46): floor((z - lo_z)/dz)."""
    return torch.floor((z - geom.prob_lo[2]) / geom.dz).to(torch.int64)


def plan_capacity(beam: dict, geom: Geometry) -> int:
    """Per-slice capacity: 1.25 x the fullest slice + 16."""
    with span("read: plan capacity"):
        isl = slice_index(beam["z"], geom).cpu().numpy()
        valid = beam["valid"].cpu().numpy()
    isl = isl[valid & (isl >= 0) & (isl < geom.nz)]
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
    with span("read: re-bin counts"):
        n_ok = int(ok.sum())
    with span("read: re-bin counts"):
        out["n_dropped"] = n_ok - int(out["valid"].sum())
    return out


def unbin_beam(binned: dict) -> dict:
    """Flatten per-slice arrays back to flat tensors."""
    return {k: binned[k].reshape(-1) for k in ALL_ATTRS}


# ----------------------------------------------------------------------
def beam_constants(cfgs, device, dtype) -> dict:
    """The merged beams' per-species constants, built once per SliceStep:
    each species' external field functions (None where it has none) and,
    with several beams, the charge of each species as a device tensor that
    the deposits index by beam_id."""
    return {"external": tuple(b.external_field_fns() for b in cfgs),
            "charges": (torch.tensor([b.charge for b in cfgs], dtype=dtype,
                                     device=device)
                        if len(cfgs) > 1 else None)}


def advance_all_beams(bp: dict, fields: dict, geom: Geometry, cfgs,
                      pc: PhysConst, dt, min_z, order: int = 2, time=0.0,
                      background_density_SI: float = 0.0,
                      external=None, fine_levels=()):
    """Push every beam species of the merged slice lanes: one masked pass
    per species with its own subcycles, charge and mass (ref
    BeamParticleAdvance.cpp, one call per container). `external` holds each
    species' external field functions (beam_constants), evaluated at
    `time`; fine_levels as in advance_beam_slice."""
    if external is None:
        external = tuple(b.external_field_fns() for b in cfgs)
    out = bp
    for b, cfg in enumerate(cfgs):
        out = advance_beam_slice(
            out, fields, geom, cfg, pc, dt, min_z, order=order,
            external_fields=external[b], time=time,
            background_density_SI=background_density_SI,
            species=b if len(cfgs) > 1 else None, fine_levels=fine_levels)
    return out


def advance_beam_slice(bp: dict, fields: dict, geom: Geometry,
                       cfg: BeamConfig, pc: PhysConst, dt, min_z,
                       order: int = 2, external_fields=None, time=0.0,
                       background_density_SI: float = 0.0, species=None,
                       fine_levels=()):
    """Push the beam particles of one species on one slice forward by dt in
    its n_subcycles (ops/beam_push.py); with species (a beam_id) only that
    species' lanes move, else every lane. A push that takes_kernel is one
    kernel launch on the card (beam_push); every other runs the subcycle
    loop (beam_push_plain), counted on the card in
    advance_beam_slice.general_calls."""
    if takes_kernel(cfg, external_fields, fine_levels):
        return beam_push(bp, fields, geom, cfg, pc, dt, min_z, order,
                         species)
    if cuda_lib.use_kernel(bp["x"]):
        advance_beam_slice.general_calls += 1
    mask = None if species is None else bp["beam_id"] == species
    return beam_push_plain(bp, fields, geom, cfg, pc, dt, min_z, order,
                           external_fields, time, background_density_SI,
                           mask, fine_levels)


advance_beam_slice.general_calls = 0


def salame_lanes(bp, cfgs):
    """The lanes of the beams with do_salame."""
    if len(cfgs) == 1:
        return bp["valid"] if cfgs[0].do_salame else torch.zeros_like(
            bp["valid"])
    flags = [b.do_salame for b in cfgs]
    if all(flags):
        return bp["valid"]
    bid = bp["beam_id"]
    sel = torch.zeros_like(bp["valid"])
    for b, flag in enumerate(flags):
        if flag:
            sel = sel | (bid == b)
    return bp["valid"] & sel


def _beam_deposit_values(bp, quantities, cfgs, pc: PhysConst, invvol,
                         charges=None, only_salame: bool = False,
                         extra_mask=None):
    """Per-lane deposit values and the deposit mask. With several beams
    each lane's charge is `charges` (beam_constants' table) at its
    beam_id. only_salame keeps the lanes of the beams with do_salame;
    extra_mask, where given, joins the mask."""
    clight_sq = 1.0 / (pc.c * pc.c)
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    gam_inv = 1.0 / torch.sqrt(1.0 + (ux * ux + uy * uy + uz * uz)
                               * clight_sq)
    mask = salame_lanes(bp, cfgs) if only_salame else bp["valid"]
    if extra_mask is not None:
        mask = mask & extra_mask
    charge = (cfgs[0].charge if len(cfgs) == 1 else
              charges[bp["beam_id"].clamp(0, len(cfgs) - 1).long()])
    wq = torch.where(mask, charge * bp["w"] * invvol, torch.zeros_like(ux))
    vx, vy, vz = ux * gam_inv, uy * gam_inv, uz * gam_inv
    values = {"jx": wq * vx, "jy": wq * vy, "jz": wq * vz,
              "rhomjz": wq * (1.0 - vz * (1.0 / pc.c))}
    return [values[q] for q in quantities], mask


def deposit_beam_slice(bp: dict, comp_map: dict, fields: dict,
                       geom: Geometry, cfgs, pc: PhysConst, order: int,
                       normalized_units: bool, charges=None,
                       only_salame: bool = False, extra_mask=None,
                       geom0: Geometry | None = None):
    """Deposit the merged beams' currents in one K1 call (ref
    BeamDepositCurrent.cpp:60-200). comp_map maps quantity (jx, jy, jz,
    rhomjz) to field name; charges, only_salame and extra_mask as in
    _beam_deposit_values. On a fine level (geom, with level 0's geom0) the
    normalized density is level 0's (ref BeamDepositCurrent.cpp:72-81)."""
    invvol = deposit_invvol(geom, geom0, normalized_units)
    quantities = list(comp_map)
    vals, mask = _beam_deposit_values(bp, quantities, cfgs, pc, invvol,
                                      charges, only_salame, extra_mask)
    stack = torch.stack([fields[comp_map[q]] for q in quantities])
    ym, xm = cell_positions(bp["x"], bp["y"], mask, geom)
    deposit(stack, ym, xm, torch.stack(vals), order)
    out = dict(fields)
    out.update((comp_map[q], stack[i]) for i, q in enumerate(quantities))
    return out
