"""The per-slice solve of both Bx/By solvers: the hot loop.

Port of ``hipace_tpu/pipeline/step.py`` ``make_slice_step`` (ref
Hipace::SolveOneSlice, Hipace.cpp:557-728). The JAX package scans a jitted
slice function; here ``SliceStep`` is called once per slice, head to tail,
by an eager Python loop.

Per slice of the explicit solver: per plasma species the fused 13-channel
deposit (K1; 14-15 channels with hipace.deposit_rho and
deposit_rho_individual; the Sx/Sy channels with derivative weights for
hipace.depos_derivative_type 0 and 1), the
beam jz deposit (K1), the batched Psi/Ez/Bz solve, the beam Next jx/jy
deposit (K1), the Sx/Sy assembly and the Bx/By multigrid (K3). Per slice
of the predictor-corrector solver: the plasma jx/jy/jz/rhomjz deposit (K1),
the beam jx/jy/jz deposit (K1), the Psi/Ez/Bz solve, then the
predictor-corrector loop (``pc_bxby_solve``), each iteration a trial plasma
push (K2), its jx/jy deposit and the beam's Next jx/jy deposit (K1) and a
2-channel Poisson solve. Then, for both: the slice's field diagnostics and
in-situ moments, the plasma push (K2), the beam push (per species, K2 per
subcycle), the slip of beam particles that left the slice, and the slice
shift. An analytic grid current (grid_current.use_grid_current) joins the
beam's jz before the Psi/Ez/Bz solve. The Poisson solver is
fields.poisson_solver's (``fields/poisson.py``, K3 for MGDirichlet); open
boundaries (``fields/open_boundary.py``) correct each solve's right-hand
side.

The diagnostics stay on the device: the identity diagnostics' comps are one
(C, ny, nx) stack, every other diagnostic a cropped and coarsened payload,
xy_integrated ones a running sum in the carry, and the in-situ moments one
raw vector per species, plasma or beam (``diagnostics/insitu.py``).

The slipped-beam buffer has no fixed capacity: every particle that stopped
mid-subcycles moves on, in the order the JAX package's stable sort gives,
so no overflow retry is needed (ref SliceSort.H:16-24).

With a laser (``SimConfig.laser``), on either Bx/By solver: the slice's
envelope state is assembled from the stream (at step 0 from the pulses'
initial envelope), |a|^2 goes into the slice's ``aabs`` plane (interpolated
from a separate laser grid where the laser has one), the plasma deposits and
pushes take the ponderomotive terms, and after the Psi/Ez/Bz solve the
envelope advances one step (``fields/laser.py``; K3's complex path under
the multigrid laser solver) on the plasma's chi, trusted away from the
field grid's edge and taken from the density profile elsewhere; the laser
diagnostics and in-situ moments read the slice's envelope. Under adaptive
dt the beam's weighted uz moments and its minimum uz over the emitted lanes
accumulate in 0-d device tensors, read once per step.

Field ionization runs after the slice's diagnostics and before the plasma
push, one ``ionization_module`` per (ion, product) pair in deck order;
Coulomb collisions run after the beam push and the slip split, one per
``hipace.collisions`` entry in deck order, a beam-plasma one on the
emitted lanes of its beam (``particles/collisions.py``). Their uniforms
come from ``SliceStep.draws``, a ``UniformDraws`` on the simulation's
generator unless a caller substitutes another provider: per slice, each
ionization pair's, then each collision's, in deck order.

SALAME (``pipeline/salame.py``) runs after the level-0 Bx/By solve of the
explicit solver on the slices the step's ``salame_slices`` name. Mesh
refinement (``fields/mr.py``): each fine level is initialized on its first
slice from its parent, deposits the plasma lanes tagged at or above it and
the beam lanes inside it (K1), solves Psi/Ez/Bz and Bx/By with the parent's
solution as Dirichlet data (K3 for Bx/By under the explicit solver; inside
the predictor-corrector loop under the other), and the pushes gather a
lane's fields from its level (K2). Where a level's z range holds every
finer level's, it runs on its own slices only.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..constants import PhysConst
from ..diagnostics import insitu as ins
from ..fields import slices as sl
from ..fields.grid_interp import GridInterp, trusted_laser_cells
from ..fields.laser import (LaserAdvance, envelope_slice, shift_laser_slices)
from ..fields.mr import LevelCoupler, in_level_bounds, tag_by_level
from ..fields.multigrid import MultiGrid
from ..fields.open_boundary import OpenBoundary
from ..fields.poisson import make_poisson_solver
from ..geometry import Geometry
from ..particles import beam as bm
from ..particles import collisions as coll
from ..particles import plasma as pl
from ..tracing import OFF, span
from .salame import salame_slice


@dataclasses.dataclass(frozen=True)
class DiagConfig:
    """One named field diagnostic (ref diagnostics/Diagnostic.{H,cpp};
    parameter surface docs/source/run/parameters.rst:932-1110). Crops and
    coarsening are inclusive cell-index ranges and ratios of the base
    geometry, applied on the device slice by slice."""
    name: str = "lev0"
    base: str = "level_0"
    diag_type: str = "xyz"         # xyz | xz | yz | xy_integrated
    comps: tuple = ()
    coarsening: tuple = (1, 1, 1)  # (cx, cy, cz)
    include_ghosts: bool = False
    # inclusive cell index ranges (lo, hi) in x, y, z
    patch_x: tuple = (0, -1)
    patch_y: tuple = (0, -1)
    patch_z: tuple = (0, -1)
    period: int = -1


def _coarsen_axis(a, axis, r):
    """First-order-interpolated coarsening by the integer ratio r (ref
    Fields::Copy coarsening, Fields.cpp:413-533)."""
    if r == 1:
        return a
    a = a.narrow(axis, 0, (a.shape[axis] // r) * r)

    def every(start):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(start, None, r)
        return a[tuple(idx)]

    if r % 2 == 1:
        return every(r // 2)
    return 0.5 * (every(r // 2 - 1) + every(r // 2))


def _process_diag_slice(arrs, dg: DiagConfig, geom: Geometry):
    """The slice's payload (C, ...) of a diagnostic from its comps' padded
    (NY, NX) planes: the xz/yz mid line or the xyz/xy_integrated plane,
    cropped to the patch (without ghosts) and coarsened."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    if dg.diag_type == "xz":
        mid = G + geom.ny // 2
        row = torch.stack([a[mid, :] for a in arrs])
        if geom.ny % 2 == 0:
            row = 0.5 * (torch.stack([a[mid - 1, :] for a in arrs]) + row)
        if not dg.include_ghosts:
            row = row[:, G:NX - G][:, dg.patch_x[0]:dg.patch_x[1] + 1]
        return _coarsen_axis(row, 1, dg.coarsening[0])
    if dg.diag_type == "yz":
        mid = G + geom.nx // 2
        col = torch.stack([a[:, mid] for a in arrs])
        if geom.nx % 2 == 0:
            col = 0.5 * (torch.stack([a[:, mid - 1] for a in arrs]) + col)
        if not dg.include_ghosts:
            col = col[:, G:NY - G][:, dg.patch_y[0]:dg.patch_y[1] + 1]
        return _coarsen_axis(col, 1, dg.coarsening[1])
    if not dg.include_ghosts:
        arrs = [a[G:NY - G, G:NX - G][dg.patch_y[0]:dg.patch_y[1] + 1,
                                       dg.patch_x[0]:dg.patch_x[1] + 1]
                for a in arrs]
    a = _coarsen_axis(torch.stack(arrs), 1, dg.coarsening[1])
    return _coarsen_axis(a, 2, dg.coarsening[0])


def is_full_interior(dg: DiagConfig, geom: Geometry) -> bool:
    """True when the diag is the whole interior of every slice: its comps
    come from the full-interior stack of SimConfig.diag_comps (the union of
    such diagnostics' comps), with no per-slice processing."""
    return (dg.base == "level_0" and dg.diag_type == "xyz"
            and dg.coarsening[:2] == (1, 1) and not dg.include_ghosts
            and dg.patch_x == (0, geom.nx - 1)
            and dg.patch_y == (0, geom.ny - 1))


def diag_slice_shape(dg: DiagConfig, geom: Geometry):
    """The per-slice payload shape of a processed diagnostic."""
    if dg.diag_type == "xz":
        n = (geom.slice_shape[1] if dg.include_ghosts
             else dg.patch_x[1] - dg.patch_x[0] + 1)
        return (len(dg.comps), n // dg.coarsening[0])
    if dg.diag_type == "yz":
        n = (geom.slice_shape[0] if dg.include_ghosts
             else dg.patch_y[1] - dg.patch_y[0] + 1)
        return (len(dg.comps), n // dg.coarsening[1])
    if dg.include_ghosts:
        ny, nx = geom.slice_shape
    else:
        ny = dg.patch_y[1] - dg.patch_y[0] + 1
        nx = dg.patch_x[1] - dg.patch_x[0] + 1
    return (len(dg.comps), ny // dg.coarsening[1], nx // dg.coarsening[0])


THIS_COMPS = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "Ez", "Bx", "By", "Bz",
              "Psi", "jx_beam", "jy_beam", "jz_beam", "jx", "jy", "rhomjz")
THIS_COMPS_PC = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi",
                 "jx", "jy", "jz", "rhomjz")
# every comp a field diagnostic's field_data=all writes, in the JAX
# package's order: the explicit solver's, and THIS_COMPS_PC under the
# predictor-corrector
DIAG_COMPS = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi", "jx_beam",
              "jy_beam", "jz_beam", "jx", "jy", "rhomjz", "chi", "Sx", "Sy")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of the slice step."""
    geom: Geometry
    pc: PhysConst
    normalized_units: bool = True
    # hipace.bxby_solver: explicit, else predictor-corrector
    explicit: bool = True
    depos_order_xy: int = 2
    # the explicit Sx/Sy deposit's derivative weights (ref
    # ExplicitDeposition.cpp): 2 centered grid differences, 0/1 the shape
    # derivative of order p / p + 1
    depos_derivative_type: int = 2
    # "leapfrog" or "ab5" (the reference's HIPACE_USE_AB5_PUSH build option,
    # hipace.plasma_pusher in the JAX package)
    plasma_pusher: str = "leapfrog"
    do_beam_jx_jy_deposition: bool = True
    # the beam's rho - jz/c in the Psi source (ref Hipace.cpp:853-857)
    do_beam_jz_minus_rho: bool = False
    do_symmetrize: bool = False
    # boundary.field = Open (ref OpenBoundary.H)
    open_boundary: bool = False
    # predictor-corrector knobs (ref Hipace.H:210-222)
    predcorr_B_error_tolerance: float = 4e-2
    predcorr_max_iterations: int = 30
    predcorr_B_mixing_factor: float = 0.05
    MG_tolerance_rel: float = 1e-4
    MG_tolerance_abs: float = 0.0
    poisson_solver: str = "FFTDirichletFast"
    plasmas: tuple = ()
    beams: tuple = ()
    # the full-interior stack: union of the identity diagnostics' comps
    diag_comps: tuple = DIAG_COMPS
    # named field diagnostics (ref diagnostic.names)
    diags: tuple = ()
    deposit_rho: bool = False
    deposit_rho_individual: bool = False
    # in-situ diagnostics periods (0 = off) and radius
    insitu_beam_period: int = 0
    insitu_field_period: int = 0
    insitu_plasma_period: int = 0
    insitu_radius: float = float("inf")
    # hipace.background_density_SI: radiation reaction's plasma frequency
    # in normalized units
    background_density_SI: float = 0.0
    # analytic grid current (ref utils/GridCurrent.{H,cpp}): (peak current
    # density, mean (x, y, z), std (x, y, z)) or None
    grid_current: tuple | None = None
    # the laser (fields.laser.LaserConfig) or None; its own grid (None = the
    # field grid) and the (zeta_lo, zeta_hi) slices it lives on
    laser: object = None
    laser_geom: Geometry | None = None
    laser_zeta: tuple | None = None
    insitu_laser_period: int = 0
    # accumulate the beam's uz moments for the adaptive time step
    adaptive_dt: bool = False
    # field ionization: (ion species, product species, the product's first
    # spawn slot, the product's initial_ion_level) per ionizing species
    ionization_pairs: tuple = ()
    # Coulomb collisions (ref CoulombCollision.cpp:8-60): ("pp", plasma,
    # plasma, same species, Coulomb log) or ("bp", beam, plasma, False,
    # Coulomb log), in deck order; a Coulomb log <= 0 is computed per pair
    collisions: tuple = ()
    # transverse mesh refinement: the fine levels (fields.mr.MRLevel),
    # level 1 first (ref Hipace.cpp:327-374)
    mr_levels: tuple = ()
    # SALAME (ref Hipace.H:285-301, salame/Salame.cpp): iterations, the
    # plasma's response by temporary momenta (else by chi), the relative
    # tolerance, the target salame_Ez_target(zeta, zeta_initial,
    # Ez_initial) and the deck's constants it reads
    salame_n_iter: int = 3
    salame_do_advance: bool = True
    salame_tolerance: float = 1e-4
    salame_target_expr: str = "Ez_initial"
    salame_consts: tuple = ()

    @property
    def use_laser(self) -> bool:
        return self.laser is not None

    @property
    def salame_active(self) -> bool:
        """A beam asks for SALAME. Only the explicit solver runs it: the
        JAX package's predictor-corrector step has no SALAME block and runs
        such a deck without it (ROADMAP R20)."""
        return self.explicit and any(b.do_salame for b in self.beams)

    def rho_comps(self) -> tuple:
        """The charge densities the plasma deposits besides the currents:
        rho, then rho_<species> for each plasma."""
        return ((("rho",) if self.deposit_rho else ())
                + (tuple(f"rho_{p.name}" for p in self.plasmas)
                   if self.deposit_rho_individual else ()))

    def zero_comps(self) -> tuple:
        """The This comps InitializeSlices zeroes (ref Fields.cpp:536-586)."""
        if self.explicit:
            comps = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "jz_beam",
                     "rhomjz") + (("rhomjz_beam",)
                                  if self.do_beam_jz_minus_rho else ())
        else:
            comps = ("ExmBy", "EypBx", "jx", "jy", "jz", "rhomjz")
        return comps + self.rho_comps()

    def beam_this_map(self) -> dict:
        """The beam's This deposit: quantity -> field."""
        if self.explicit:
            cmap = {"jz": "jz_beam"}
            if self.do_beam_jz_minus_rho:
                cmap["rhomjz"] = "rhomjz_beam"
            return cmap
        cmap = ({"jx": "jx", "jy": "jy", "jz": "jz"}
                if self.do_beam_jx_jy_deposition else {"jz": "jz"})
        if self.do_beam_jz_minus_rho:
            cmap["rhomjz"] = "rhomjz"
        return cmap


def init_field_state(cfg: SimConfig, device, dtype) -> dict:
    """The zeroed slice field sets of the solver (ref Fields::AllocData),
    and the same sets of each fine level as mr<level> on its grid."""

    def sets(g):
        def fs(names):
            return sl.make_field_set(names, g, device, dtype)

        if cfg.explicit:
            return {
                "This": fs(THIS_COMPS + cfg.rho_comps() + (
                    ("rhomjz_beam",) if cfg.do_beam_jz_minus_rho else ())
                    + (("aabs",) if cfg.use_laser else ())),
                "Next": fs(("jx_beam", "jy_beam")),
                "Previous": fs(("jx_beam", "jy_beam")),
                "RhomJzIons": fs(("rhomjz",)),
            }
        return {
            "This": fs(THIS_COMPS_PC + cfg.rho_comps()
                       + (("chi", "aabs") if cfg.use_laser else ())),
            "Next": fs(("jx", "jy")),
            "Previous": fs(("Bx", "By", "jx", "jy")),
            "PCIter": fs(("Bx", "By")),
            "PCPrevIter": fs(("Bx", "By")),
            "RhomJzIons": fs(("rhomjz",)),
        }

    out = sets(cfg.geom)
    for i, lv in enumerate(cfg.mr_levels):
        out[f"mr{i + 1}"] = sets(lv.geom)
    return out


def solve_fine_psi_ez_bz(fth: dict, parent: dict, cfg: SimConfig,
                         fg: Geometry, coup, solver) -> dict:
    """The Psi/Ez/Bz solve of a fine level (ref Fields.cpp:840-957, lev >
    0): the sources' edge band from the parent level (ref
    Fields.cpp:862-877), the parent's solution as Dirichlet data (the Van
    Loan correction of the right-hand side), the ghost cells filled from
    the parent (ref Fields.cpp:924-929), then ExmBy and EypBx."""
    G, pc = cfg.geom.nguards, cfg.pc
    fth = dict(fth)
    fth["rhomjz"] = coup.up_boundary(fth["rhomjz"], parent["rhomjz"], 0,
                                     -G + 1)
    fth["jx"] = coup.up_boundary(fth["jx"], parent["jx"], 1, -G + 1)
    fth["jy"] = coup.up_boundary(fth["jy"], parent["jy"], 1, -G + 1)
    rhom = fth["rhomjz"]
    if cfg.explicit and cfg.do_beam_jz_minus_rho:
        rhom = rhom + fth["rhomjz_beam"]
    rhs = [-1.0 / pc.ep0 * sl.interior(rhom, fg),
           (sl.ddx_interior(fth["jx"], fg) + sl.ddy_interior(fth["jy"], fg))
           / (pc.ep0 * pc.c),
           pc.mu0 * (sl.ddy_interior(fth["jx"], fg)
                     - sl.ddx_interior(fth["jy"], fg))]
    comps = ("Psi", "Ez", "Bz")
    sol = solver.solve(torch.stack([coup.apply_bc(r, parent[c], 1.0, 1.0)
                                    for r, c in zip(rhs, comps)]))
    for i, c in enumerate(comps):
        fth[c] = coup.up_boundary(sl.set_interior(fth[c], sol[i], fg),
                                  parent[c], G, 0)
    fth["ExmBy"], fth["EypBx"] = sl.grad_neg_full(fth["Psi"], fg)
    return fth


def solve_psi_ez_bz(this: dict, cfg: SimConfig, solver,
                    ob: OpenBoundary | None = None) -> dict:
    """SolvePoissonPsiExmByEypBxEzBz (ref Fields.cpp:840-957): the three
    Poisson equations in one batched solve, then ExmBy = -dx Psi and
    EypBx = -dy Psi. With fields.do_symmetrize the sources are symmetrized
    first (and kept so); with open boundaries Psi's right-hand side takes
    the monopole, Ez's and Bz's, pure derivatives, do not (ref
    Fields.cpp:735-739)."""
    g, pc = cfg.geom, cfg.pc
    if cfg.do_symmetrize:
        this = dict(this)
        this["rhomjz"] = sl.symmetrize(this["rhomjz"], 1, 1)
        this["jx"] = sl.symmetrize(this["jx"], -1, 1)
        this["jy"] = sl.symmetrize(this["jy"], 1, -1)
    rhomjz = this["rhomjz"]
    if cfg.explicit and cfg.do_beam_jz_minus_rho:
        rhomjz = rhomjz + this["rhomjz_beam"]
    rhs_psi = -1.0 / pc.ep0 * sl.interior(rhomjz, g)
    rhs_ez = (sl.ddx_interior(this["jx"], g)
              + sl.ddy_interior(this["jy"], g)) / (pc.ep0 * pc.c)
    rhs_bz = pc.mu0 * (sl.ddy_interior(this["jx"], g)
                       - sl.ddx_interior(this["jy"], g))
    rhs = torch.stack([rhs_psi, rhs_ez, rhs_bz])
    if ob is not None:
        rhs = torch.cat([ob.apply(rhs[:1], monopole=True),
                         ob.apply(rhs[1:], monopole=False)])
    sol = solver.solve(rhs)
    out = dict(this)
    for i, c in enumerate(("Psi", "Ez", "Bz")):
        out[c] = sl.set_interior(this[c], sol[i], g)
    out["ExmBy"], out["EypBx"] = sl.grad_neg_full(out["Psi"], g)
    return out


def init_sx_sy_with_beam(f: dict, cfg: SimConfig,
                         g: Geometry | None = None) -> dict:
    """Beam contribution to Sx/Sy via finite differences (ref
    Hipace.cpp:745-790), on level 0 or the fine level of geometry g."""
    g = cfg.geom if g is None else g
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
    chi = sl.interior(this["chi"], g)
    sy, sx = sl.interior(this["Sy"], g), sl.interior(this["Sx"], g)
    if cfg.do_symmetrize:
        chi = sl.symmetrize(chi, 1, 1)
        sx = sl.symmetrize(sx, -1, 1)
        sy = sl.symmetrize(sy, 1, -1)
    b0 = torch.stack([sl.interior(this["Bx"], g), sl.interior(this["By"], g)])
    b = mg.solve(b0, torch.stack([sy, sx]), chi,
                 tol_rel=cfg.MG_tolerance_rel, tol_abs=cfg.MG_tolerance_abs,
                 max_iters=40)
    out = dict(this)
    out["Bx"] = sl.set_interior(this["Bx"], b[0], g)
    out["By"] = sl.set_interior(this["By"], b[1], g)
    return out


def explicit_fine_bxby_solve(fth: dict, parent: dict, cfg: SimConfig,
                             fg: Geometry, coup, mg: MultiGrid) -> dict:
    """The explicit Bx/By solve of a fine level (ref ExplicitMGSolveBxBy,
    Hipace.cpp:793-933, lev > 0), after its Sx/Sy are assembled: the edge
    band of Sx, Sy and chi from the parent (ref Hipace.cpp:823-829), the
    parent's Bx/By as Dirichlet data (offset 0.5 and factor 8/3 on the
    cell-centered multigrid of an even size, 1 and 1 on the node-centered
    one of an odd size; ref Hipace.cpp:839-853), K3 from the level's last
    Bx/By, and the ghost cells filled from the parent (ref
    Hipace.cpp:928-933)."""
    G = cfg.geom.nguards
    fth = dict(fth)
    fth["Sy"] = coup.up_boundary(fth["Sy"], parent["Sy"], 0, -G)
    fth["Sx"] = coup.up_boundary(fth["Sx"], parent["Sx"], 0, -G)
    fth["chi"] = coup.up_boundary(fth["chi"], parent["chi"], 0, -G + 1)
    off, fac = (0.5, 8.0 / 3.0) if fg.nx % 2 == 0 else (1.0, 1.0)
    rhs = torch.stack([
        coup.apply_bc(sl.interior(fth["Sy"], fg), parent["Bx"], off, fac),
        coup.apply_bc(sl.interior(fth["Sx"], fg), parent["By"], off, fac)])
    b0 = torch.stack([sl.interior(fth["Bx"], fg), sl.interior(fth["By"], fg)])
    b = mg.solve(b0, rhs, sl.interior(fth["chi"], fg),
                 tol_rel=cfg.MG_tolerance_rel, tol_abs=cfg.MG_tolerance_abs,
                 max_iters=40)
    for i, c in enumerate(("Bx", "By")):
        fth[c] = coup.up_boundary(sl.set_interior(fth[c], b[i], fg),
                                  parent[c], G, 0)
    return fth


def _b_norms(bx, by, bx_it, by_it, geom: Geometry):
    """The interior sums of |B| and |B - B_it| (ref Fields.cpp:1228-1286)."""
    b = torch.sum(torch.sqrt(sl.interior(bx, geom) ** 2
                             + sl.interior(by, geom) ** 2))
    bd = torch.sum(torch.sqrt(sl.interior(bx - bx_it, geom) ** 2
                              + sl.interior(by - by_it, geom) ** 2))
    return b, bd


def rel_b_field_error(bx, by, bx_it, by_it, geom: Geometry, fine=()):
    """ComputeRelBFieldError (ref Fields.cpp:1228-1286): the sum over the
    interior of |B - B_it| over that of |B|, 0 where B is 0; a 0-d tensor.
    fine: (bx, by, bx_it, by_it, geometry) of each active fine level, whose
    sums join level 0's."""
    b, bd = _b_norms(bx, by, bx_it, by_it, geom)
    for *pair, fg in fine:
        fb, fbd = _b_norms(*pair, fg)
        b, bd = b + fb, bd + fbd
    return torch.where(b > 0.0, bd / b, torch.zeros_like(b))


def pc_bxby_solve(f: dict, plasmas: list, beam_next: dict, cfg: SimConfig,
                  solver, ob: OpenBoundary | None = None, charges=None,
                  mr=None):
    """PredictorCorrectorLoopToSolveBxBy (ref Hipace.cpp:936-1031).

    From a guess mixed from the previous slice's B and its predictor-
    corrector history (ref Fields.cpp:1149-1171), each iteration pushes the
    plasma to the next slice on the current Bx/By (a trial push, K2),
    deposits its jx/jy and the beam's Next jx/jy (K1), solves Bx/By from
    those currents and this slice's jz (ref Fields.cpp:1008-1078), and mixes
    the solution in (MixAndShiftBfields, ref Fields.cpp:1173-1226), until
    the relative change is at most predcorr_B_error_tolerance or
    predcorr_max_iterations have run. The exit is the host's, as in the
    reference: each iteration reads its error once, the loop's one
    device-to-host copy; the mixing factor, the weights and the previous
    error stay on the device. Returns (fields, error, iterations) with the
    error a float and the iterations an int. charges: the beams' per-lane
    charge table (particles.beam.beam_constants).

    mr: (the fine levels' state, each a dict of field sets or None where
    the level does not run on this slice; their activity; the couplers;
    the fine Poisson solvers; the plasma tags). The running levels iterate
    in the same loop, each solving from its trial currents (edge band from
    the parent) with the parent's solution of the same iteration as
    Dirichlet data; the error sums over level 0 and the active levels (ref
    Fields.cpp:1228-1286), and every level mixes with the same weights.
    Their results are written into the fine state."""
    g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
    G = g.nguards
    tol = cfg.predcorr_B_error_tolerance
    mix = cfg.predcorr_B_mixing_factor
    this, prev, ppi = f["This"], f["Previous"], f["PCPrevIter"]
    fine, act, coups, fsolvers, tags = mr if mr is not None else (
        [], [], [], [], None)
    levels = [i for i, fl in enumerate(fine) if fl is not None]

    def fine_pairs(states):
        return [(*states[i][:4], cfg.mr_levels[i].geom) for i in levels
                if act[i]]

    err0 = rel_b_field_error(
        prev["Bx"], prev["By"], ppi["Bx"], ppi["By"], g,
        fine_pairs({i: (fine[i]["Previous"]["Bx"], fine[i]["Previous"]["By"],
                        fine[i]["PCPrevIter"]["Bx"],
                        fine[i]["PCPrevIter"]["By"]) for i in levels}))
    mixf = torch.exp(-0.5 * (err0 / (2.5 * tol)) ** 2)

    def guess(prev_d, ppi_d):
        bx = (1.0 + mixf) * prev_d["Bx"] - mixf * ppi_d["Bx"]
        by = (1.0 + mixf) * prev_d["By"] - mixf * ppi_d["By"]
        # (B, B_it, B_prev_iter) per component
        return [bx, by, torch.zeros_like(bx), torch.zeros_like(by), bx, by]

    st = {-1: guess(prev, ppi)}
    for i in levels:
        # a fine level starts with B_it = the guess and B_prev_iter = 0, so
        # that its first mix takes 0 for the previous iterate, as the JAX
        # package's fine state unpacks its guess (ROADMAP R21)
        bx, by = guess(fine[i]["Previous"], fine[i]["PCPrevIter"])[:2]
        st[i] = [bx, by, bx, by, torch.zeros_like(bx), torch.zeros_like(by)]
        # this slice's jz is fixed over the loop: its edge band from the
        # parent once (ref Fields.cpp:1029-1031)
        parent = this if i == 0 else fine[i - 1]["This"]
        fine[i]["This"] = dict(fine[i]["This"], jz=coups[i].up_boundary(
            fine[i]["This"]["jz"], parent["jz"], 1, -G + 1))

    jz = this["jz"]
    rhs_bx_static = -pc.mu0 * sl.ddy_interior(jz, g)
    rhs_by_static = pc.mu0 * sl.ddx_interior(jz, g)
    dz2_inv = 1.0 / (2.0 * g.dz)
    prev_jx_i = sl.interior(prev["jx"], g)
    prev_jy_i = sl.interior(prev["jy"], g)
    # the tolerance in the run's dtype, as the JAX package's device-side
    # test compares it
    tol_dt = float(torch.tensor(tol, dtype=jz.dtype))
    err, err_prev, it = 1.0, None, 0
    while err > tol_dt and it < cfg.predcorr_max_iterations:
        fields_it = dict(this, Bx=st[-1][0], By=st[-1][1])
        fine_it = [None] * len(fine)
        for i in levels:
            if act[i]:
                fine_it[i] = (dict(fine[i]["This"], Bx=st[i][0],
                                   By=st[i][1]), cfg.mr_levels[i].geom)
        nxt = {"jx": torch.zeros_like(jz), "jy": torch.zeros_like(jz)}
        fnxt = {i: {c: torch.zeros_like(fine[i]["This"]["jz"])
                    for c in ("jx", "jy")} for i in levels}
        for ip, (p, pcfg) in enumerate(zip(plasmas, cfg.plasmas)):
            p_tmp = pl.advance_plasma(
                p, fields_it, g, pcfg, pc, order=order, temp_slice=True,
                pusher=cfg.plasma_pusher, use_laser=cfg.use_laser,
                fine_levels=fine_it if tags is not None else (),
                tag=tags[ip] if tags is not None else None)
            nxt, _ = pl.deposit_plasma(p_tmp, ["jx", "jy"], nxt, g, pcfg, pc,
                                       order, cfg.normalized_units)
            for i in levels:
                if tags is None:
                    continue
                fnxt[i], _ = pl.deposit_plasma(
                    p_tmp, ["jx", "jy"], fnxt[i], cfg.mr_levels[i].geom,
                    pcfg, pc, order, cfg.normalized_units,
                    extra_mask=tags[ip] >= i + 1, geom0=g)
        if cfg.do_beam_jx_jy_deposition and cfg.beams:
            nxt = bm.deposit_beam_slice(beam_next, {"jx": "jx", "jy": "jy"},
                                        nxt, g, cfg.beams, pc, order,
                                        cfg.normalized_units, charges)
            for i in levels:
                fg = cfg.mr_levels[i].geom
                if act[i]:
                    fnxt[i] = bm.deposit_beam_slice(
                        beam_next, {"jx": "jx", "jy": "jy"}, fnxt[i], fg,
                        cfg.beams, pc, order, cfg.normalized_units, charges,
                        extra_mask=in_level_bounds(beam_next["x"],
                                                   beam_next["y"], fg),
                        geom0=g)
        # SolvePoissonBxBy (ref Fields.cpp:1008-1078)
        rhs_bx = rhs_bx_static + pc.mu0 * dz2_inv * (
            prev_jy_i - sl.interior(nxt["jy"], g))
        rhs_by = rhs_by_static - pc.mu0 * dz2_inv * (
            prev_jx_i - sl.interior(nxt["jx"], g))
        rhs = torch.stack([rhs_bx, rhs_by])
        if ob is not None:
            rhs = ob.apply(rhs, monopole=True)
        sol = solver.solve(rhs)
        st[-1][2] = sl.set_interior(st[-1][2], sol[0], g)
        st[-1][3] = sl.set_interior(st[-1][3], sol[1], g)
        parent_pc = st[-1][2:4]
        for i in levels:
            fg, coup, fl = cfg.mr_levels[i].geom, coups[i], fine[i]
            # the trial currents' edge band from the parent's
            parent_nxt = nxt if i == 0 else fnxt[i - 1]
            fjx = coup.up_boundary(fnxt[i]["jx"], parent_nxt["jx"], 0, -G)
            fjy = coup.up_boundary(fnxt[i]["jy"], parent_nxt["jy"], 0, -G)
            fjz = fl["This"]["jz"]
            frhs = torch.stack([
                coup.apply_bc(-pc.mu0 * sl.ddy_interior(fjz, fg)
                              + pc.mu0 * dz2_inv
                              * (sl.interior(fl["Previous"]["jy"], fg)
                                 - sl.interior(fjy, fg)),
                              parent_pc[0], 1.0, 1.0),
                coup.apply_bc(pc.mu0 * sl.ddx_interior(fjz, fg)
                              - pc.mu0 * dz2_inv
                              * (sl.interior(fl["Previous"]["jx"], fg)
                                 - sl.interior(fjx, fg)),
                              parent_pc[1], 1.0, 1.0)])
            fsol = fsolvers[i].solve(frhs)
            for k in (0, 1):
                st[i][2 + k] = coup.up_boundary(
                    sl.set_interior(st[i][2 + k], fsol[k], fg),
                    parent_pc[k], G, 0)
            parent_pc = st[i][2:4]

        err_new = rel_b_field_error(*st[-1][:4], g, fine_pairs(st))
        if err_prev is None:
            err_prev = err_new
        # MixAndShiftBfields: every level with the weights of the last two
        # errors
        denom = err_new + err_prev
        w_it = torch.where(denom > 0.0,
                           err_prev / torch.clamp(denom, min=1e-30), 0.5)
        w_pp = torch.where(denom > 0.0,
                           err_new / torch.clamp(denom, min=1e-30), 0.5)
        for k, (bx, by, pcx, pcy, ppx, ppy) in st.items():
            st[k] = [(1.0 - mix) * bx + mix * (w_it * pcx + w_pp * ppx),
                     (1.0 - mix) * by + mix * (w_it * pcy + w_pp * ppy),
                     pcx, pcy, pcx, pcy]
        err_prev = err_new
        err = float(err_new)
        it += 1
    for i in levels:
        bx, by, pcx, pcy, ppx, ppy = st[i]
        fine[i]["This"] = dict(fine[i]["This"], Bx=bx, By=by)
        fine[i]["PCPrevIter"] = {"Bx": ppx, "By": ppy}
        fine[i]["PCIter"] = {"Bx": pcx, "By": pcy}
    bx, by, pcx, pcy, ppx, ppy = st[-1]
    f = dict(f, This=dict(this, Bx=bx, By=by),
             PCPrevIter={"Bx": ppx, "By": ppy}, PCIter={"Bx": pcx, "By": pcy})
    return f, err, it


class UniformDraws:
    """The uniforms in [0, 1) that a slice's stochastic processes take:
    drawn from `generator` on its device in the simulation's dtype, as the
    JAX package's jax.random.uniform draws in the run's dtype. A call
    names its draw ("ionization"; a collision's "sort", "pick", "kick" or
    "wrap kick") and its shape; this provider does not read the name. A
    substitute with the same call (a test's, the smoke run's) may feed
    other draws: SliceStep asks for them in a fixed order."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def __call__(self, name: str, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.device, dtype=self.dtype)


class SliceStep:
    """The per-slice function; holds the field solvers and the provider of
    the slice's uniforms (draws)."""

    def __init__(self, cfg: SimConfig, device, dtype, draws: UniformDraws):
        g = cfg.geom
        self.cfg = cfg
        self.draws = draws
        self.solver = make_poisson_solver(cfg.poisson_solver, g, device,
                                          dtype)
        # the explicit solver's Bx/By multigrid
        self.mg = (MultiGrid(g.nx, g.ny, g.dx, g.dy, device=device,
                             dtype=dtype) if cfg.explicit else None)
        self.ob = (OpenBoundary(g, device=device, dtype=dtype)
                   if cfg.open_boundary else None)
        self.beam_consts = bm.beam_constants(cfg.beams, device, dtype)
        self.grid_current = (grid_current_plane(cfg, device, dtype)
                             if cfg.grid_current is not None else None)
        self.device, self.dtype = device, dtype
        if cfg.use_laser:
            lg = cfg.laser_geom if cfg.laser_geom is not None else g
            self.laser_geom = lg
            self.laser_zeta = (cfg.laser_zeta if cfg.laser_zeta is not None
                               else (0, g.nz - 1))
            self.laser_advance = LaserAdvance(cfg.laser, lg, cfg.pc,
                                              device=device, dtype=dtype)
            self.separate_laser_grid = lg != g
            if self.separate_laser_grid:
                # field -> laser grid for chi, laser -> field grid for
                # |a|^2 (ref MultiLaser::InterpolateChi, UpdateLaserAabs)
                order_l = cfg.laser.interp_order
                self.f2l = GridInterp(g, lg, dtype, order=order_l,
                                      device=device)
                self.l2f = GridInterp(lg, g, dtype, order=order_l,
                                      valid_only=True, device=device)
                self.laser_trust = trusted_laser_cells(g, lg, device)
            else:
                # the field's chi is trusted 2 guard widths inside the edge
                G2 = 2 * g.nguards
                NY, NX = g.slice_shape
                trust = torch.zeros((NY, NX), dtype=torch.bool, device=device)
                trust[G2:NY - G2, G2:NX - G2] = True
                self.laser_trust = trust
        # mesh refinement: per fine level its coupler to the parent level,
        # its Poisson solver and, for the explicit solver, its multigrid
        self.couplers, self.fine_solvers, self.fine_mgs = [], [], []
        parent = g
        for lv in cfg.mr_levels:
            fg = lv.geom
            self.couplers.append(LevelCoupler(parent, fg, dtype, device))
            self.fine_solvers.append(make_poisson_solver(
                cfg.poisson_solver, fg, device, dtype))
            self.fine_mgs.append(MultiGrid(fg.nx, fg.ny, fg.dx, fg.dy,
                                           device=device, dtype=dtype)
                                 if cfg.explicit else None)
            parent = fg
        # a level whose z range holds every finer level's runs only on its
        # own slices: its state is reset on entry, so the slices before
        # change nothing (tests/test_torch_mr.py holds it to the JAX
        # package, which runs every level on every slice); otherwise every
        # level runs on every slice
        zr = [(lv.zeta_lo, lv.zeta_hi) for lv in cfg.mr_levels]
        self.mr_skip = all(zr[i][0] >= zr[i - 1][0] and zr[i][1] <= zr[i - 1][1]
                           for i in range(1, len(zr)))
        if cfg.salame_active:
            from ..parser import TorchFunction
            self.salame_target = TorchFunction(
                cfg.salame_target_expr, ("zeta", "zeta_initial",
                                         "Ez_initial"),
                dict(cfg.salame_consts))

    def _init_fine(self, f: dict, this: dict, islice: int, run: list):
        """InitializeSlices of the fine levels (ref Fields.cpp:541-575):
        on a level's first slice (its zeta_hi, the sweep runs head to tail)
        the explicit solver takes the shifted beam currents from the parent
        and restarts Bx/By from zero, the predictor-corrector takes the
        parent's B history and previous currents; then the This comps of
        the solver are zeroed and Next cleared. Returns each level's field
        sets, None where the level does not run."""
        cfg = self.cfg
        fine = []
        for i, lv in enumerate(cfg.mr_levels):
            if not run[i]:
                fine.append(None)
                continue
            coup = self.couplers[i]
            fl = {k: dict(v) for k, v in f[f"mr{i + 1}"].items()}
            if islice == lv.zeta_hi:
                pf = f if i == 0 else fine[i - 1]
                parent_this = this if i == 0 else pf["This"]
                fth, fpv = fl["This"], fl["Previous"]
                if cfg.explicit:
                    for c in ("jx_beam", "jy_beam"):
                        fth[c] = coup.up_full(parent_this[c])
                        fpv[c] = coup.up_full(pf["Previous"][c])
                    fth["jx"], fth["jy"] = fth["jx_beam"], fth["jy_beam"]
                    for c in ("Bx", "By"):
                        fth[c] = torch.zeros_like(fth[c])
                else:
                    for c in ("Bx", "By"):
                        fl["PCPrevIter"][c] = coup.up_full(
                            pf["PCPrevIter"][c])
                    for c in ("Bx", "By", "jx", "jy"):
                        fpv[c] = coup.up_full(pf["Previous"][c])
            for c in cfg.zero_comps():
                fl["This"][c] = torch.zeros_like(fl["This"][c])
            fl["Next"] = {c: torch.zeros_like(v) for c, v in fl["Next"].items()}
            fine.append(fl)
        return fine

    def __call__(self, carry: dict, islice: int, beam_this: dict,
                 beam_next: dict, laser_rows=None):
        """One slice. carry: fields, plasma (list), slip, dt, time (the
        step's, which the beams' external fields read), step (the host's
        step index), with xy_integrated diagnostics diag_int (name ->
        running sum), with a laser the envelope state (laser) and chi from
        the density profile (chi_initial), under adaptive dt the beam's
        moments (beam_moments, min_uz), with SALAME its state (salame) and
        the host's list of the slices it runs on this step
        (salame_slices). laser_rows: this slice's (n00, nm1) rows of the
        laser stream. Returns
        (carry, out) with out = {beam_out: emitted lanes, diag: the
        (len(cfg.diag_comps), ny, nx) stack or None, diagf_<name>: the
        payload of each other written diagnostic (a fine level's only on
        the slices the level runs), insitu_beam /
        insitu_plasma / insitu_field: the raw in-situ sums where their
        period is on (insitu_beam one row per beam species; the field's
        under the explicit solver only, as in the JAX package), mg_cycles:
        the explicit Bx/By solve's V-cycle count, an int on the CPU and an
        unread 0-d device tensor on the card (0 under the
        predictor-corrector), pc_iters and pc_err: the
        predictor-corrector's iterations (int) and last error (float), 0
        under the explicit solver; with a laser laser_np1 and laser_n00,
        the slice's advanced and current envelope, insitu_laser and
        laser_cycles, the complex multigrid's V-cycles (0 under the FFT
        solver); with SALAME salame_W and salame_dbg, the state's last W
        and its (target, no-SALAME, SALAME-only averages, sum of jz), and
        on a SALAME slice salame_cycles, the V-cycles of its solves; under
        the explicit solver mg_cycles_lev<N>, a running fine level's
        Bx/By V-cycles}."""
        cfg = self.cfg
        g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
        f = carry["fields"]
        dt = carry["dt"]
        min_z = g.prob_lo[2] + islice * g.dz
        charges = self.beam_consts["charges"]
        mr = cfg.mr_levels

        with span("slice init"):
            # ---- InitializeSlices (ref Fields.cpp:536-586)
            this = dict(f["This"])
            for c in cfg.zero_comps():
                this[c] = torch.zeros_like(this[c])
            if cfg.explicit:
                f = dict(f, Next={c: torch.zeros_like(v)
                                  for c, v in f["Next"].items()})
            # ---- mesh refinement: the fine levels' InitializeSlices and
            # the plasma lanes' levels (TagByLevel gated by the levels' z
            # activity)
            if mr:
                with span("MR: level init"):
                    act = [lv.active(islice) for lv in mr]
                    run = act if self.mr_skip else [True] * len(mr)
                    fine = self._init_fine(f, this, islice, run)
                    tags = ([tag_by_level(p["x"], p["y"], p["valid"],
                                          [lv.geom if a else None
                                           for lv, a in zip(mr, act)])
                             for p in carry["plasma"]] if any(act) else None)
            else:
                act, fine, tags = [], [], None
            levels = [i for i, fl in enumerate(fine) if fl is not None]

            # ---- the laser: this slice's envelope state and |a|^2 (ref
            # Hipace.cpp:603 UpdateLaserAabs)
            if cfg.use_laser:
                with span("laser: slice init"):
                    lg = self.laser_geom
                    lz_lo, lz_hi = self.laser_zeta
                    has_laser = lz_lo <= islice <= lz_hi
                    n00_row, nm1_row = laser_rows
                    if carry["step"] == 0 and not cfg.laser.from_file:
                        n00j00 = envelope_slice(
                            cfg.laser, lg, g.z_pos_offset + islice * g.dz,
                            self.dtype, self.device)
                    else:
                        n00j00 = n00_row
                    if not has_laser:
                        n00j00 = torch.zeros_like(n00j00)
                    lstate = dict(carry["laser"], n00j00=n00j00,
                                  nm1j00=nm1_row)
                    aabs_l = torch.abs(n00j00) ** 2
                    this["aabs"] = (self.l2f.apply(aabs_l)
                                    if self.separate_laser_grid else aabs_l)

        with span("deposit"):
            # ---- plasma deposits on This (K1): explicit, the currents and
            # the Sx/Sy channels; predictor-corrector, the currents
            plasmas, dgrids_list = [], []
            for p, pcfg in zip(carry["plasma"], cfg.plasmas):
                if cfg.explicit:
                    this, p, dg = pl.fused_plasma_deposits(
                        p, self._plasma_comps(pcfg), this, g, pcfg, pc,
                        order, cfg.normalized_units,
                        deriv_type=cfg.depos_derivative_type,
                        use_laser=cfg.use_laser)
                    dgrids_list.append(dg)
                else:
                    this, p = pl.deposit_plasma(
                        p, self._plasma_comps(pcfg), this, g, pcfg, pc,
                        order, cfg.normalized_units, use_laser=cfg.use_laser)
                plasmas.append(p)

            # ---- beam deposit on This (K1)
            if cfg.beams:
                this = bm.deposit_beam_slice(beam_this, cfg.beam_this_map(),
                                             this, g, cfg.beams, pc, order,
                                             cfg.normalized_units, charges)
            # ---- the fine levels' deposits (K1; a level deposits the
            # plasma lanes tagged at or above it, ref
            # PlasmaDepositCurrent.cpp:130, and the beam lanes inside it)
            # and AddRhoIons
            fine_dgrids = {}
            with span("MR: level deposits") if levels else OFF:
                for i in levels:
                    fine_dgrids[i] = self._fine_deposits(
                        i, fine, this, plasmas, tags, act, beam_this)
            # ---- AddRhoIons (ref Fields.cpp:606-615)
            this = self._add_rho_ions(this, f)
            # ---- the analytic grid current into the beam's jz (ref
            # GridCurrent.cpp:26-71), at z = lo + islice * dz
            if self.grid_current is not None:
                _, mean, std = cfg.grid_current
                dz_n = (g.prob_lo[2] + islice * g.dz - mean[2]) / std[2]
                tgt = "jz_beam" if cfg.explicit else "jz"
                this[tgt] = this[tgt] + self.grid_current * math.exp(
                    -0.5 * dz_n * dz_n)

        with span("field solve"):
            # ---- Psi/ExmBy/EypBx/Ez/Bz, then each fine level's
            this = solve_psi_ez_bz(this, cfg, self.solver, self.ob)
            f = dict(f, This=this)
            with span("MR: level Psi/Ez/Bz") if levels else OFF:
                for i in levels:
                    fine[i]["This"] = solve_fine_psi_ez_bz(
                        fine[i]["This"],
                        this if i == 0 else fine[i - 1]["This"], cfg,
                        mr[i].geom, self.couplers[i], self.fine_solvers[i])

            # ---- the envelope advance (ref Hipace.cpp:637 AdvanceSlice)
            # on chi: the plasma's inside the trusted region, the density
            # profile's elsewhere (ref MultiLaser.cpp:335-405
            # InterpolateChi)
            laser_cycles = 0
            if cfg.use_laser:
                with span("laser: envelope advance"):
                    chi_src = (self.f2l.apply(this["chi"])
                               if self.separate_laser_grid else this["chi"])
                    chi_laser = torch.where(self.laser_trust, chi_src,
                                            carry["chi_initial"])
                    np1j00 = self.laser_advance(lstate, chi_laser, dt,
                                                carry["step"])
                    if not has_laser:
                        np1j00 = torch.zeros_like(np1j00)
                    if self.laser_advance.mg is not None:
                        laser_cycles = self.laser_advance.mg.cycles

        out = {}
        if cfg.explicit:
            # ---- beam Next jx/jy deposit (K1), Sx/Sy, Bx/By (K3)
            if cfg.do_beam_jx_jy_deposition and cfg.beams:
                with span("deposit"):
                    f["Next"] = bm.deposit_beam_slice(
                        beam_next, {"jx": "jx_beam", "jy": "jy_beam"},
                        f["Next"], g, cfg.beams, pc, order,
                        cfg.normalized_units, charges)
            with span("field solve"):
                f = init_sx_sy_with_beam(f, cfg)
                this = f["This"]
                for dg in dgrids_list:
                    this = pl.combine_explicit_sxsy(this, dg, pc, g)
                this = explicit_bxby_solve(this, cfg, self.mg)
                cycles = self.mg.cycles
                pc_err, pc_iters = 0.0, 0
                # ---- SALAME (ref Hipace.cpp:673-678), on level 0, before
                # the fine levels' Bx/By so that they take the final
                # weights
                is_sal = False
                if cfg.salame_active:
                    is_sal = carry["salame_slices"][islice]
                    sal = carry["salame"]
                    if is_sal:
                        with span("SALAME"):
                            (this, beam_this, sal,
                             out["salame_cycles"]) = salame_slice(
                                cfg, this, f["Next"], f["Previous"], plasmas,
                                dgrids_list, beam_this, sal, islice,
                                self.solver, self.mg, self.salame_target,
                                charges)
                    else:
                        sal = dict(sal, prev_was_salame=torch.zeros_like(
                            sal["prev_was_salame"]))
                    carry = dict(carry, salame=sal)
                    out.update(salame_W=sal["W_last"], salame_dbg=sal["dbg"])
                f = dict(f, This=this)
                with span("MR: level Bx/By") if levels else OFF:
                    for i in levels:
                        fine[i] = self._fine_explicit_bxby(
                            i, fine[i],
                            this if i == 0 else fine[i - 1]["This"],
                            fine_dgrids[i], beam_this, beam_next, act[i],
                            is_sal)
                        out[f"mg_cycles_lev{i + 1}"] = self.fine_mgs[i].cycles
        else:
            cycles = 0
            # ---- the predictor-corrector loop (K2, K1, the solver), the
            # fine levels in it
            with span("field solve"):
                f, pc_err, pc_iters = pc_bxby_solve(
                    f, plasmas, beam_next, cfg, self.solver, self.ob,
                    charges, mr=(fine, act, self.couplers, self.fine_solvers,
                                 tags) if levels else None)
            this = f["This"]

        with span("diagnostics"):
            carry = self._diagnostics(carry, out, this, fine,
                                      n00j00 if cfg.use_laser else None,
                                      plasmas)

        # ---- field ionization (ref Hipace.cpp:693-696), K2 for the field
        if cfg.ionization_pairs:
            with span("ionization module"):
                for ip, ie, spawn_base, prod_lev in cfg.ionization_pairs:
                    plasmas[ip], plasmas[ie] = pl.ionization_module(
                        plasmas[ip], plasmas[ie], this, g, cfg.plasmas[ip],
                        pc, order, cfg.normalized_units,
                        cfg.background_density_SI, spawn_base, prod_lev,
                        self.draws("ionization", plasmas[ip]["x"].numel()))

        # ---- push plasma (K2), a tagged lane on its level's fields
        fine_push = tuple((fine[i]["This"], mr[i].geom) if act[i] else None
                          for i in range(len(fine)))
        with span("plasma push"):
            plasmas = [pl.advance_plasma(p, this, g, pcfg, pc, order=order,
                                         pusher=cfg.plasma_pusher,
                                         use_laser=cfg.use_laser,
                                         fine_levels=fine_push if tags
                                         else (),
                                         tag=tags[ip] if tags else None)
                       for ip, (p, pcfg) in enumerate(zip(plasmas,
                                                          cfg.plasmas))]

        with span("beam push"):
            # ---- push beam: slipped carry first, then this slice (K2)
            slip = carry["slip"]
            combined = {k: torch.cat([slip[k], beam_this[k]])
                        for k in bm.ALL_ATTRS}
            if cfg.insitu_beam_period and cfg.beams:
                # each beam's moments before the push (ref Hipace.cpp:681)
                with span("diagnostics"):
                    out["insitu_beam"] = ins.beams_slice_raw(
                        combined, len(cfg.beams), pc, cfg.insitu_radius)
            if cfg.beams:
                combined = bm.advance_all_beams(
                    combined, this, g, cfg.beams, pc, dt, min_z, order=order,
                    time=carry["time"],
                    background_density_SI=cfg.background_density_SI,
                    external=self.beam_consts["external"],
                    fine_levels=tuple(lv for lv in fine_push
                                      if lv is not None))
                # particles that stopped mid-subcycles slip to the next
                # slice; every boolean index waits for the device, so each
                # set is indexed by one index tensor
                incomplete = combined["valid"] & (combined["nsub"] > 0)
                with span("read: beam compaction"):
                    slip_idx = incomplete.nonzero().squeeze(1)
                with span("read: beam compaction"):
                    emit_idx = (~incomplete
                                & combined["valid"]).nonzero().squeeze(1)
                slip = {k: v[slip_idx] for k, v in combined.items()}
                emit = {k: v[emit_idx] for k, v in combined.items()}
            else:
                # no beam: the binned lanes are all dead, nothing is emitted
                # (and nothing read back)
                emit = {k: v[:0] for k, v in combined.items()}

        # ---- Coulomb collisions (ref Hipace.cpp:712)
        if cfg.collisions:
            with span("collisions"):
                plasmas, emit = self.collide(plasmas, emit, dt)
        if cfg.beams and cfg.adaptive_dt:
            carry = dict(carry, **beam_uz_moments(emit, carry, pc.c))

        with span("shift"):
            # ---- ShiftSlices (ref Fields.cpp:588-604), on every running
            # level
            f = self._shift(f, this)
            for i in levels:
                f[f"mr{i + 1}"] = self._shift(fine[i], fine[i]["This"])
            carry = dict(carry, fields=f, plasma=plasmas, slip=slip)
            out.update(beam_out=emit,
                       mg_cycles=cycles,
                       pc_iters=pc_iters, pc_err=pc_err)
            if cfg.use_laser:
                # ShiftLaserSlices (ref MultiLaser.cpp:181-212)
                carry["laser"] = shift_laser_slices(lstate, np1j00)
                out.update(laser_np1=np1j00, laser_n00=lstate["n00j00"],
                           laser_cycles=laser_cycles)
        return carry, out

    def _fine_deposits(self, i: int, fine: list, this: dict, plasmas: list,
                       tags, act: list, beam_this: dict) -> list:
        """The deposits of fine level i+1 on its This (K1): the plasma lanes
        tagged at or above it (ref PlasmaDepositCurrent.cpp:130), the beam
        lanes inside it, then AddRhoIons; written into fine[i]. Returns the
        explicit solver's Sx/Sy grids of each species."""
        cfg = self.cfg
        g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
        fth, fg = fine[i]["This"], cfg.mr_levels[i].geom
        if cfg.use_laser:
            # ref MultiLaser.cpp:289-291: |a|^2 from the parent level
            parent = this if i == 0 else fine[i - 1]["This"]
            fth["aabs"] = self.couplers[i].up_full(parent["aabs"])
        dgrids = []
        for ip, (p, pcfg) in enumerate(zip(plasmas, cfg.plasmas)):
            if tags is None:
                break
            kw = dict(extra_mask=tags[ip] >= i + 1, geom0=g,
                      use_laser=cfg.use_laser)
            if cfg.explicit:
                fth, _, dg = pl.fused_plasma_deposits(
                    p, self._plasma_comps(pcfg), fth, fg, pcfg, pc,
                    order, cfg.normalized_units,
                    deriv_type=cfg.depos_derivative_type, **kw)
                dgrids.append(dg)
            else:
                fth, _ = pl.deposit_plasma(
                    p, self._plasma_comps(pcfg), fth, fg, pcfg, pc, order,
                    cfg.normalized_units, **kw)
        if cfg.beams and act[i]:
            fth = bm.deposit_beam_slice(
                beam_this, cfg.beam_this_map(), fth, fg, cfg.beams, pc,
                order, cfg.normalized_units, self.beam_consts["charges"],
                extra_mask=in_level_bounds(beam_this["x"],
                                           beam_this["y"], fg),
                geom0=g)
        fine[i]["This"] = self._add_rho_ions(fth, fine[i])
        return dgrids

    def _diagnostics(self, carry: dict, out: dict, this: dict, fine: list,
                     n00j00, plasmas: list) -> dict:
        """The slice's diagnostics (ref Diagnostic.cpp, Fields::Copy) into
        out: the stack, each other diagnostic's payload (an xy_integrated
        one summed into the carry, which is returned) and the in-situ
        moments (ref Hipace.cpp:681-688). n00j00: the laser's envelope
        slice, or None."""
        cfg = self.cfg
        g, pc, mr = cfg.geom, cfg.pc, cfg.mr_levels
        out["diag"] = (torch.stack([sl.interior(this[c], g)
                                    for c in cfg.diag_comps])
                       if cfg.diag_comps else None)
        for dg in cfg.diags:
            if is_full_interior(dg, g):
                continue
            if dg.base == "laser":
                srcs = [n00j00 if c == "laserEnvelope" else this[c]
                        for c in dg.comps]
                if any(torch.is_complex(a) for a in srcs):
                    srcs = [a.to(n00j00.dtype) for a in srcs]
                payload = _process_diag_slice(srcs, dg, self.laser_geom)
            elif dg.base != "level_0":
                li = int(dg.base[-1]) - 1
                if fine[li] is None:
                    continue
                payload = _process_diag_slice(
                    [fine[li]["This"][c] for c in dg.comps], dg, mr[li].geom)
            else:
                payload = _process_diag_slice([this[c] for c in dg.comps],
                                              dg, g)
            if dg.diag_type == "xy_integrated":
                di = dict(carry["diag_int"])
                di[dg.name] = di[dg.name] + payload
                carry = dict(carry, diag_int=di)
            else:
                out["diagf_" + dg.name] = payload
        if cfg.insitu_field_period and cfg.explicit:
            out["insitu_field"] = ins.field_slice_sums(this, g, pc)
        if cfg.insitu_plasma_period:
            out["insitu_plasma"] = torch.stack([
                ins.plasma_slice_raw(p, pc, cfg.insitu_radius)
                for p in plasmas])
        if cfg.use_laser and cfg.insitu_laser_period:
            out["insitu_laser"] = ins.laser_slice_moments(n00j00,
                                                          self.laser_geom)
        return carry

    def _plasma_comps(self, pcfg) -> list:
        """A species' This deposit: the solver's currents and the charge
        densities the deck asks for."""
        cfg = self.cfg
        comps = (["jx", "jy", "chi", "rhomjz"] if cfg.explicit else
                 ["jx", "jy", "jz", "rhomjz"]
                 + (["chi"] if cfg.use_laser else []))
        return comps + (["rho"] if cfg.deposit_rho else []) + (
            [f"rho_{pcfg.name}"] if cfg.deposit_rho_individual else [])

    def _add_rho_ions(self, this: dict, f: dict) -> dict:
        """AddRhoIons (ref Fields.cpp:606-615): the neutralizing background
        into rhomjz (and rho)."""
        ions = f["RhomJzIons"]["rhomjz"]
        this = dict(this, rhomjz=this["rhomjz"] + ions)
        if self.cfg.deposit_rho:
            this["rho"] = this["rho"] + ions
        return this

    def _shift(self, f: dict, this: dict) -> dict:
        """ShiftSlices (ref Fields.cpp:588-604) of one level's field sets:
        explicit, Next's beam currents become This's and This's the
        Previous; predictor-corrector, This's B and currents become the
        Previous and the Previous B the PCPrevIter."""
        if self.cfg.explicit:
            new_this = dict(this)
            for c in ("jx", "jy"):
                new_this[f"{c}_beam"] = f["Next"][f"{c}_beam"]
                new_this[c] = f["Next"][f"{c}_beam"]
            return dict(f, This=new_this,
                        Previous={"jx_beam": this["jx_beam"],
                                  "jy_beam": this["jy_beam"]})
        return dict(f, This=this,
                    Previous={c: this[c] for c in ("Bx", "By", "jx", "jy")},
                    PCPrevIter={"Bx": f["Previous"]["Bx"],
                                "By": f["Previous"]["By"]})

    def _fine_explicit_bxby(self, i: int, fl: dict, parent: dict, dgrids,
                            beam_this: dict, beam_next: dict, active: bool,
                            is_sal: bool) -> dict:
        """The explicit Bx/By of fine level i+1 (ref Hipace.cpp:793-933):
        its beam Next jx/jy (K1), after a SALAME slice its jz again with the
        final weights (the per-level STEP 4 redeposit, ref
        Salame.cpp:164-172), the beam's and the plasma's Sx/Sy, then
        explicit_fine_bxby_solve (K3)."""
        cfg = self.cfg
        g, pc, order = cfg.geom, cfg.pc, cfg.depos_order_xy
        fg = cfg.mr_levels[i].geom
        charges = self.beam_consts["charges"]
        fl = dict(fl)
        if cfg.do_beam_jx_jy_deposition and cfg.beams and active:
            fl["Next"] = bm.deposit_beam_slice(
                beam_next, {"jx": "jx_beam", "jy": "jy_beam"}, fl["Next"],
                fg, cfg.beams, pc, order, cfg.normalized_units, charges,
                extra_mask=in_level_bounds(beam_next["x"], beam_next["y"],
                                           fg), geom0=g)
        if is_sal and cfg.beams and active:
            fl["This"] = bm.deposit_beam_slice(
                beam_this, {"jz": "jz_beam"},
                dict(fl["This"], jz_beam=torch.zeros_like(
                    fl["This"]["jz_beam"])), fg, cfg.beams, pc, order,
                cfg.normalized_units, charges,
                extra_mask=in_level_bounds(beam_this["x"], beam_this["y"],
                                           fg), geom0=g)
        fth = init_sx_sy_with_beam(fl, cfg, fg)["This"]
        for dg in dgrids:
            fth = pl.combine_explicit_sxsy(fth, dg, pc, fg)
        fl["This"] = explicit_fine_bxby_solve(fth, parent, cfg, fg,
                                              self.couplers[i],
                                              self.fine_mgs[i])
        return fl

    def collide(self, plasmas: list, emit: dict, dt):
        """The slice's collisions in deck order, each with its draws from
        self.draws: a plasma pair after the push, a beam against a plasma
        on the beam's emitted lanes over the time step dt. Returns
        (plasmas, emit). As in the JAX package's step, a same-species
        pair's result is assigned to its species and then overwritten by
        the function's second return, its unchanged input, so the kicks of
        a same-species collision do not stay (ROADMAP R18)."""
        cfg = self.cfg
        plasmas = list(plasmas)
        draw = self.draws
        for kind, i1, i2, same, clog in cfg.collisions:
            if kind == "pp":
                n1, n2 = plasmas[i1]["x"].numel(), plasmas[i2]["x"].numel()
                if same:
                    d = {"sort": draw("sort", n1),
                         "kick": draw("kick", 4, n1),
                         "wrap kick": draw("wrap kick", 4, n1)}
                else:
                    d = {"sort": draw("sort", n2), "pick": draw("pick", n1),
                         "kick": draw("kick", 4, n1)}
                plasmas[i1], plasmas[i2] = coll.plasma_plasma_collision(
                    plasmas[i1], plasmas[i2], cfg.geom, cfg.plasmas[i1],
                    cfg.plasmas[i2], cfg.pc, clog, cfg.background_density_SI,
                    cfg.normalized_units, d, same)
                continue
            n1, n2 = emit["x"].numel(), plasmas[i2]["x"].numel()
            d = {"sort": draw("sort", n2), "pick": draw("pick", n1),
                 "kick": draw("kick", 4, n1)}
            sel = emit["valid"] & (emit["beam_id"] == i1)
            b_new, plasmas[i2] = coll.beam_plasma_collision(
                dict(emit, valid=sel), plasmas[i2], cfg.geom, cfg.beams[i1],
                cfg.plasmas[i2], cfg.pc, clog, cfg.background_density_SI,
                cfg.normalized_units, d, dt)
            emit = dict(emit, **{k: torch.where(sel, b_new[k], emit[k])
                                 for k in ("ux", "uy", "uz")})
        return plasmas, emit


def zero_moments(device, dtype) -> dict:
    """The adaptive time step's beam moments before the sweep."""
    z = torch.zeros((), dtype=dtype, device=device)
    return {"sum_w": z, "sum_w_uz": z, "sum_w_uz2": z}


def beam_uz_moments(emit: dict, carry: dict, clight: float):
    """The emitted lanes' weight, weighted uz and uz^2 (in units of c) added
    to carry's beam_moments, and its min_uz lowered to their least uz (ref
    AdaptiveTimeStep GatherMinUzSlice, after the push and the collisions):
    0-d device tensors, nothing read back."""
    c_inv = 1.0 / clight
    w_v, uz = emit["w"], emit["uz"]
    # a slice may emit no lane
    uz_min = uz.amin() if uz.numel() else torch.full_like(carry["min_uz"],
                                                          math.inf)
    mom = carry["beam_moments"]
    return {"min_uz": torch.minimum(carry["min_uz"], uz_min * c_inv),
            "beam_moments": {
                "sum_w": mom["sum_w"] + torch.sum(w_v),
                "sum_w_uz": mom["sum_w_uz"] + torch.sum(w_v * uz) * c_inv,
                "sum_w_uz2": mom["sum_w_uz2"]
                + torch.sum(w_v * uz ** 2) * c_inv ** 2}}


def grid_current_plane(cfg: SimConfig, device, dtype):
    """The grid current's transverse plane, peak * exp(-(dx^2 + dy^2)/2) at
    the cell centres, zero in the guard cells: the same on every slice,
    which scales it by its longitudinal factor."""
    g = cfg.geom
    peak, mean, std = cfg.grid_current
    G = g.nguards
    NY, NX = g.slice_shape
    xs = (torch.arange(NX, dtype=dtype, device=device) - G + 0.5) * g.dx \
        + g.prob_lo[0]
    ys = (torch.arange(NY, dtype=dtype, device=device) - G + 0.5) * g.dy \
        + g.prob_lo[1]
    dxn = (xs[None, :] - mean[0]) / std[0]
    dyn = (ys[:, None] - mean[1]) / std[1]
    plane = peak * torch.exp(-0.5 * (dxn * dxn + dyn * dyn))
    return sl.set_interior(torch.zeros_like(plane), sl.interior(plane, g), g)


def empty_slip(device, dtype) -> dict:
    out = {k: torch.zeros(0, dtype=dtype, device=device)
           for k in bm.BEAM_ATTRS}
    for k in bm.BEAM_INT_ATTRS:
        out[k] = torch.zeros(0, dtype=torch.int32, device=device)
    out["valid"] = torch.zeros(0, dtype=torch.bool, device=device)
    return out
