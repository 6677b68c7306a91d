"""The per-slice solve of the explicit Bx/By solver: the hot loop.

Port of the explicit, non-MR, non-laser branch of
``hipace_tpu/pipeline/step.py`` ``make_slice_step`` (ref
Hipace::SolveOneSlice, Hipace.cpp:557-728). The JAX package scans a jitted
slice function; here ``SliceStep`` is called once per slice, head to tail,
by an eager Python loop. Per slice: the fused 13-channel plasma deposit
(K1), the beam jz deposit (K1), the batched Psi/Ez/Bz DST solve, the beam
Next jx/jy deposit (K1), the Sx/Sy assembly, the Bx/By multigrid (K3), the
plasma push (K2) and the beam push (K2 per subcycle), the slip of beam
particles that left the slice, and the slice shift.

The slipped-beam buffer has no fixed capacity: every particle that stopped
mid-subcycles moves on, in the order the JAX package's stable sort gives,
so no overflow retry is needed (ref SliceSort.H:16-24).
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import PhysConst
from ..fields import slices as sl
from ..fields.multigrid import MultiGrid
from ..fields.poisson import VARIANTS, DirichletPoissonSolver
from ..geometry import Geometry
from ..particles import beam as bm
from ..particles import plasma as pl


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of the explicit-solver slice step."""
    geom: Geometry
    pc: PhysConst
    normalized_units: bool = True
    depos_order_xy: int = 2
    do_beam_jx_jy_deposition: bool = True
    MG_tolerance_rel: float = 1e-4
    MG_tolerance_abs: float = 0.0
    poisson_solver: str = "FFTDirichletFast"
    plasmas: tuple = ()
    beams: tuple = ()


THIS_COMPS = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "Ez", "Bx", "By", "Bz",
              "Psi", "jx_beam", "jy_beam", "jz_beam", "jx", "jy", "rhomjz")
# the per-slice field record, in the JAX package's field_data=all order
DIAG_COMPS = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi", "jx_beam",
              "jy_beam", "jz_beam", "jx", "jy", "rhomjz", "chi", "Sx", "Sy")
ZERO_COMPS = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "jz_beam", "rhomjz")


def init_field_state(cfg: SimConfig, device, dtype) -> dict:
    """The zeroed slice field sets (ref Fields::AllocData)."""
    g = cfg.geom
    return {
        "This": sl.make_field_set(THIS_COMPS, g, device, dtype),
        "Next": sl.make_field_set(("jx_beam", "jy_beam"), g, device, dtype),
        "Previous": sl.make_field_set(("jx_beam", "jy_beam"), g, device,
                                      dtype),
        "RhomJzIons": sl.make_field_set(("rhomjz",), g, device, dtype),
    }


def solve_psi_ez_bz(this: dict, cfg: SimConfig, solver) -> dict:
    """SolvePoissonPsiExmByEypBxEzBz (ref Fields.cpp:840-957): the three
    Poisson equations in one batched DST solve, then ExmBy = -dx Psi and
    EypBx = -dy Psi."""
    g, pc = cfg.geom, cfg.pc
    rhs_psi = -1.0 / pc.ep0 * sl.interior(this["rhomjz"], g)
    rhs_ez = (sl.ddx_interior(this["jx"], g)
              + sl.ddy_interior(this["jy"], g)) / (pc.ep0 * pc.c)
    rhs_bz = pc.mu0 * (sl.ddy_interior(this["jx"], g)
                       - sl.ddx_interior(this["jy"], g))
    sol = solver.solve(torch.stack([rhs_psi, rhs_ez, rhs_bz]))
    out = dict(this)
    for i, c in enumerate(("Psi", "Ez", "Bz")):
        out[c] = sl.set_interior(this[c], sol[i], g)
    out["ExmBy"], out["EypBx"] = sl.grad_neg_full(out["Psi"], g)
    return out


def init_sx_sy_with_beam(f: dict, cfg: SimConfig) -> dict:
    """Beam contribution to Sx/Sy via finite differences (ref
    Hipace.cpp:745-790)."""
    g = cfg.geom
    mu0 = cfg.pc.mu0
    dz2_inv = 1.0 / (2.0 * g.dz)
    dx_jzb = sl.ddx_interior(f["This"]["jz_beam"], g)
    dy_jzb = sl.ddy_interior(f["This"]["jz_beam"], g)
    dz_jxb = (sl.interior(f["Previous"]["jx_beam"], g)
              - sl.interior(f["Next"]["jx_beam"], g)) * dz2_inv
    dz_jyb = (sl.interior(f["Previous"]["jy_beam"], g)
              - sl.interior(f["Next"]["jy_beam"], g)) * dz2_inv
    this = dict(f["This"])
    this["Sy"] = sl.set_interior(this["Sy"], mu0 * (-dy_jzb + dz_jyb), g)
    this["Sx"] = sl.set_interior(this["Sx"], -mu0 * (-dx_jzb + dz_jxb), g)
    return dict(f, This=this)


def explicit_bxby_solve(this: dict, cfg: SimConfig, mg: MultiGrid) -> dict:
    """ExplicitMGSolveBxBy (ref Hipace.cpp:793-933): Laplacian(B) - chi B =
    (Sy, Sx), the previous slice's B as first guess, through K3."""
    g = cfg.geom
    b0 = torch.stack([sl.interior(this["Bx"], g), sl.interior(this["By"], g)])
    rhs = torch.stack([sl.interior(this["Sy"], g), sl.interior(this["Sx"], g)])
    b = mg.solve(b0, rhs, sl.interior(this["chi"], g),
                 tol_rel=cfg.MG_tolerance_rel, tol_abs=cfg.MG_tolerance_abs,
                 max_iters=40)
    out = dict(this)
    out["Bx"] = sl.set_interior(this["Bx"], b[0], g)
    out["By"] = sl.set_interior(this["By"], b[1], g)
    return out


class SliceStep:
    """The per-slice function; holds the field solvers."""

    def __init__(self, cfg: SimConfig, device, dtype):
        g = cfg.geom
        self.cfg = cfg
        self.solver = DirichletPoissonSolver(
            g.nx, g.ny, g.dx, g.dy, device=device, dtype=dtype,
            variant=VARIANTS[cfg.poisson_solver])
        self.mg = MultiGrid(g.nx, g.ny, g.dx, g.dy, device=device,
                            dtype=dtype)

    def __call__(self, carry: dict, islice: int, beam_this: dict,
                 beam_next: dict):
        """One slice. carry: fields, plasma (list), slip, dt. Returns
        (carry, out) with out = {beam_out: emitted lanes, diag: (16, ny,
        nx) field record, mg_cycles: the solve's V-cycle count, an int on
        the CPU and an unread 0-d device tensor on the card}."""
        cfg = self.cfg
        g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
        f = carry["fields"]
        dt = carry["dt"]
        min_z = g.prob_lo[2] + islice * g.dz

        # ---- InitializeSlices (ref Fields.cpp:536-586)
        this = dict(f["This"])
        for c in ZERO_COMPS:
            this[c] = torch.zeros_like(this[c])
        f = dict(f, Next={c: torch.zeros_like(v)
                          for c, v in f["Next"].items()})

        # ---- plasma deposits on This: currents + Sx/Sy channels (K1)
        plasmas, dgrids_list = [], []
        for p, pcfg in zip(carry["plasma"], cfg.plasmas):
            this, p, dg = pl.fused_plasma_deposits(
                p, ["jx", "jy", "chi", "rhomjz"], this, g, pcfg, pc, order,
                cfg.normalized_units)
            plasmas.append(p)
            dgrids_list.append(dg)

        # ---- beam jz deposit on This (K1)
        if cfg.beams:
            this = bm.deposit_beam_slice(beam_this, {"jz": "jz_beam"}, this,
                                         g, cfg.beams, pc, order,
                                         cfg.normalized_units)
        # ---- AddRhoIons (ref Fields.cpp:606-615)
        this["rhomjz"] = this["rhomjz"] + f["RhomJzIons"]["rhomjz"]

        # ---- Psi/ExmBy/EypBx/Ez/Bz
        this = solve_psi_ez_bz(this, cfg, self.solver)
        f = dict(f, This=this)

        # ---- beam Next jx/jy deposit (K1), Sx/Sy, Bx/By (K3)
        if cfg.do_beam_jx_jy_deposition and cfg.beams:
            f["Next"] = bm.deposit_beam_slice(
                beam_next, {"jx": "jx_beam", "jy": "jy_beam"}, f["Next"], g,
                cfg.beams, pc, order, cfg.normalized_units)
        f = init_sx_sy_with_beam(f, cfg)
        this = f["This"]
        for dg in dgrids_list:
            this = pl.combine_explicit_sxsy(this, dg, pc)
        this = explicit_bxby_solve(this, cfg, self.mg)
        diag = torch.stack([sl.interior(this[c], g) for c in DIAG_COMPS])

        # ---- push plasma (K2)
        plasmas = [pl.advance_plasma(p, this, g, pcfg, pc, order=order)
                   for p, pcfg in zip(plasmas, cfg.plasmas)]

        # ---- push beam: slipped carry first, then this slice (K2)
        slip = carry["slip"]
        combined = {k: torch.cat([slip[k], beam_this[k]])
                    for k in bm.ALL_ATTRS}
        if cfg.beams:
            combined = bm.advance_all_beams(combined, this, g, cfg.beams, pc,
                                            dt, min_z, order=order)
            # particles that stopped mid-subcycles slip to the next slice
            # every boolean index waits for the device, so each set is
            # indexed by one index tensor
            incomplete = combined["valid"] & (combined["nsub"] > 0)
            slip_idx = incomplete.nonzero().squeeze(1)
            emit_idx = (~incomplete & combined["valid"]).nonzero().squeeze(1)
            slip = {k: v[slip_idx] for k, v in combined.items()}
            emit = {k: v[emit_idx] for k, v in combined.items()}
        else:
            emit = {k: v[combined["valid"]] for k, v in combined.items()}

        # ---- ShiftSlices (ref Fields.cpp:588-604)
        new_this = dict(this)
        for c in ("jx", "jy"):
            new_this[f"{c}_beam"] = f["Next"][f"{c}_beam"]
            new_this[c] = f["Next"][f"{c}_beam"]
        f = dict(f, This=new_this, Previous={"jx_beam": this["jx_beam"],
                                             "jy_beam": this["jy_beam"]})
        carry = dict(carry, fields=f, plasma=plasmas, slip=slip)
        return carry, {"beam_out": emit, "diag": diag,
                       "mg_cycles": self.mg.cycles}


def empty_slip(device, dtype) -> dict:
    out = {k: torch.zeros(0, dtype=dtype, device=device)
           for k in bm.BEAM_ATTRS}
    for k in bm.BEAM_INT_ATTRS:
        out[k] = torch.zeros(0, dtype=torch.int32, device=device)
    out["valid"] = torch.zeros(0, dtype=torch.bool, device=device)
    return out
