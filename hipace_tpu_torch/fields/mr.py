"""Transverse mesh refinement (MR): nested fine levels in (x, y).

Port of ``hipace_tpu/fields/mr.py`` (ref Hipace.cpp:327-374 for the
per-level geometry, Fields::LevelUp / LevelUpBoundary, Fields.cpp:762-838,
for the coarse-to-fine interpolation, and the lev > 0 branch of
Fields::SetBoundaryCondition, Fields.cpp:628-760, for the fine levels'
Dirichlet data). A fine level refines x and y only: it keeps the coarse dz,
and its z range snaps to coarse slices.

The coarse-to-fine evaluation at the fine cells' fixed positions is a pair
of dense order-2 B-spline matrices applied per axis, F = Wy C Wx^T, built
once on the host (``grid_interp``'s helpers) and applied by two plain
``torch.matmul`` products on the slice's device: the JAX package computes
them outside any kernel too. On the card these products must run in full
float32 (PyTorch's default; nothing in the port turns TF32 on).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Geometry
from ..parser import Inputs
from .grid_interp import _np_shape_weights


@dataclasses.dataclass(frozen=True)
class MRLevel:
    """One fine level: its geometry and the coarse slices it is active on."""
    geom: Geometry
    zeta_lo: int
    zeta_hi: int

    def active(self, islice: int) -> bool:
        return self.zeta_lo <= islice <= self.zeta_hi


def parse_mr_levels(inputs: Inputs, geom0: Geometry) -> tuple:
    """mr_lev<N>.n_cell / patch_lo / patch_hi for N = 1..amr.max_level (ref
    Hipace.cpp:327-374), each level nested in the one below it."""
    max_level = inputs.query("amr.max_level", 0, int)
    levels = []
    prev = geom0
    for lev in range(1, max_level + 1):
        pp = inputs.prefix(f"mr_lev{lev}")
        n_cell = pp.get_list("n_cell", int)
        patch_lo = pp.get_list("patch_lo")
        patch_hi = pp.get_list("patch_hi")
        # the z range snaps to coarse slices (ref Hipace.cpp:339-350)
        off_z = geom0.z_pos_offset
        zeta_lo = max(0, round((patch_lo[2] - off_z) / geom0.dz))
        zeta_hi = min(geom0.nz - 1, round((patch_hi[2] - off_z) / geom0.dz))
        g = Geometry(
            n_cell=(int(n_cell[0]), int(n_cell[1]), zeta_hi - zeta_lo + 1),
            prob_lo=(patch_lo[0], patch_lo[1],
                     (zeta_lo - 0.5) * geom0.dz + off_z),
            prob_hi=(patch_hi[0], patch_hi[1],
                     (zeta_hi + 0.5) * geom0.dz + off_z),
            nguards=geom0.nguards, is_periodic=(False, False, False))
        # nesting, with a few cells to spare (ref Hipace.cpp:358-370)
        if not (g.prob_lo[0] - 2 * g.dx - 2 * prev.dx > prev.prob_lo[0]
                and g.prob_hi[0] + 2 * g.dx + 2 * prev.dx < prev.prob_hi[0]
                and g.prob_lo[1] - 2 * g.dy - 2 * prev.dy > prev.prob_lo[1]
                and g.prob_hi[1] + 2 * g.dy + 2 * prev.dy < prev.prob_hi[1]):
            raise ValueError(
                f"mr_lev{lev} must be fully nested inside the next coarsest "
                "level (with a few cells to spare, ref Hipace.cpp:358-370)")
        levels.append(MRLevel(geom=g, zeta_lo=zeta_lo, zeta_hi=zeta_hi))
        prev = g
    return tuple(levels)


def interp_matrix_1d(fine_coords, coarse: Geometry, axis: int,
                     n_coarse_padded: int) -> np.ndarray:
    """(n_fine, n_coarse_padded) order-2 B-spline matrix evaluating a padded
    coarse axis at the fine coordinates; every tap must fall inside the
    padded coarse array."""
    G = coarse.nguards
    xmid = ((np.asarray(fine_coords, float) - coarse.pos_offset(axis))
            / coarse.cell_size(axis))
    i0, w = _np_shape_weights(xmid, 2)
    M = np.zeros((len(xmid), n_coarse_padded))
    rows = np.arange(len(xmid))
    for k in range(3):
        idx = i0 + k + G
        if (idx < 0).any() or (idx >= n_coarse_padded).any():
            raise ValueError("fine level not nested: interpolation stencil "
                             "leaves the padded coarse array")
        M[rows, idx] += w[:, k]
    return M


class LevelCoupler:
    """The coarse-to-fine operators of one fine level on padded (NY, NX)
    slices of both levels, on `device` in `dtype`."""

    def __init__(self, coarse: Geometry, fine: Geometry, dtype, device=None):
        self.coarse, self.fine = coarse, fine
        kw = dict(dtype=dtype, device=device)
        self._kw = kw
        G = fine.nguards
        NYc, NXc = coarse.slice_shape
        NYf, NXf = fine.slice_shape
        # the fine padded cell centres
        xf = (np.arange(NXf) - G + 0.5) * fine.dx + fine.prob_lo[0]
        yf = (np.arange(NYf) - G + 0.5) * fine.dy + fine.prob_lo[1]
        wx = interp_matrix_1d(xf, coarse, 0, NXc)
        wy = interp_matrix_1d(yf, coarse, 1, NYc)
        self.Wx = torch.as_tensor(wx, **kw)
        self.Wy = torch.as_tensor(wy, **kw)
        self.Wx_int = torch.as_tensor(wx[G:NXf - G], **kw)
        self.Wy_int = torch.as_tensor(wy[G:NYf - G], **kw)
        # the rows of the boundary nodes of the Van Loan correction: the
        # edge cells shifted outward by `offset` fine cells (ref
        # SetDirichletBoundaries, Fields.cpp:663-668)
        self._bc_rows = {}
        for offset in (1.0, 0.5):
            xlo = fine.prob_lo[0] + (0.5 - offset) * fine.dx
            xhi = fine.prob_hi[0] - (0.5 - offset) * fine.dx
            ylo = fine.prob_lo[1] + (0.5 - offset) * fine.dy
            yhi = fine.prob_hi[1] - (0.5 - offset) * fine.dy
            self._bc_rows[offset] = tuple(
                torch.as_tensor(interp_matrix_1d([v], coarse, ax, n)[0], **kw)
                for v, ax, n in ((xlo, 0, NXc), (xhi, 0, NXc),
                                 (ylo, 1, NYc), (yhi, 1, NYc)))
        self._band_masks = {}

    def up_full(self, c: torch.Tensor) -> torch.Tensor:
        """LevelUp (ref Fields.cpp:808-838): the whole padded fine slice
        interpolated from the padded coarse one."""
        return self.Wy @ c @ self.Wx.T

    def band(self, outer: int, inner: int) -> torch.Tensor:
        """The fine padded cells in grown(valid, outer) minus grown(valid,
        inner), the IntVect ranges of LevelUpBoundary (Fields.cpp:762-806),
        as a bool (NY, NX) tensor made once per band."""
        key = (outer, inner)
        if key not in self._band_masks:
            G = self.fine.nguards
            NYf, NXf = self.fine.slice_shape
            ny, nx = self.fine.ny, self.fine.nx

            def box(e):
                m = np.zeros((NYf, NXf), bool)
                m[max(0, G - e):min(NYf, G + ny + e),
                  max(0, G - e):min(NXf, G + nx + e)] = True
                return m

            self._band_masks[key] = torch.as_tensor(
                box(outer) & ~box(inner), device=self._kw["device"])
        return self._band_masks[key]

    def up_boundary(self, f: torch.Tensor, c: torch.Tensor, outer: int,
                    inner: int) -> torch.Tensor:
        """LevelUpBoundary: the band cells of the fine `f` replaced by the
        interpolated coarse `c`."""
        if outer == inner:
            return f
        return torch.where(self.band(outer, inner), self.up_full(c), f)

    def bc_values(self, c: torch.Tensor, offset: float):
        """The coarse solution at the fine level's four boundary edges
        (bottom, top, left, right), each along the fine interior axis."""
        rxlo, rxhi, rylo, ryhi = self._bc_rows[offset]
        return ((rylo @ c) @ self.Wx_int.T, (ryhi @ c) @ self.Wx_int.T,
                self.Wy_int @ (c @ rxlo), self.Wy_int @ (c @ rxhi))

    def apply_bc(self, rhs: torch.Tensor, c: torch.Tensor, offset: float,
                 factor: float) -> torch.Tensor:
        """The Van Loan correction of a fine interior right-hand side (ny,
        nx) by boundary values interpolated from the padded coarse solution
        c (ref SetDirichletBoundaries: rhs_edge -= bc factor / dcell^2)."""
        bot, top, left, right = self.bc_values(c, offset)
        ky = factor / (self.fine.dy * self.fine.dy)
        kx = factor / (self.fine.dx * self.fine.dx)
        out = rhs.clone()
        out[0, :] -= bot * ky
        out[-1, :] -= top * ky
        out[:, 0] -= left * kx
        out[:, -1] -= right * kx
        return out


def in_level_bounds(x, y, geom: Geometry):
    """CheckDomainBounds.contains in the transverse plane."""
    return ((x >= geom.prob_lo[0]) & (x < geom.prob_hi[0])
            & (y >= geom.prob_lo[1]) & (y < geom.prob_hi[1]))


def tag_by_level(x, y, valid, levels) -> torch.Tensor:
    """TagByLevel (ref PlasmaParticleContainer.cpp:220-259): the finest
    level whose transverse bounds hold the lane, 0 for level 0 and invalid
    lanes; levels are the fine levels' geometries, level 1 first, None
    for a level that takes no lane (one not active on the slice)."""
    tag = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i, g in enumerate(levels):
        if g is None:
            continue
        tag = torch.where(in_level_bounds(x, y, g),
                          torch.full_like(tag, i + 1), tag)
    return torch.where(valid, tag, torch.zeros_like(tag))
