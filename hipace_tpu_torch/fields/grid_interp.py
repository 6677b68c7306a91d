"""Cross-grid interpolation between the field grid and a laser grid.

The port's own copy of ``GridInterp`` and ``_cross_matrix_1d`` of
``hipace_tpu/fields/mr.py:213-256`` (with the numpy B-splines above them),
used where the laser has its own grid (``lasers.n_cell``, ``patch_lo``,
``patch_hi``; ref MultiLaser::InterpolateChi and UpdateLaserAabs): chi goes
from the field grid to the laser grid, |a|^2 from the laser grid to the
field grid. A padded slice is interpolated by two dense separable products,
dst = Wy src Wx^T, whose matrices are built once on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import Geometry


def _np_bspline(u, p):
    """The cardinal B-spline B_p(u) in numpy (mirrors ops/shape.py)."""
    au = np.abs(u)
    if p == 0:
        return np.where((u >= -0.5) & (u < 0.5), 1.0, 0.0)
    if p == 1:
        return np.maximum(0.0, 1.0 - au)
    if p == 2:
        return np.where(au <= 0.5, 0.75 - au * au,
                        np.where(au < 1.5, 0.5 * (1.5 - au) ** 2, 0.0))
    if p == 3:
        return np.where(au <= 1.0, (4.0 - 6.0 * au * au + 3.0 * au ** 3) / 6.0,
                        np.where(au < 2.0, ((2.0 - au) ** 3) / 6.0, 0.0))
    raise ValueError(f"unsupported shape order {p}")


def _np_shape_weights(xmid: np.ndarray, p: int):
    """Order-p shape factors: the leftmost cell and the p + 1 weights."""
    if p in (0, 2):
        i0 = np.floor(xmid + 0.5).astype(np.int64) - p // 2
    else:
        i0 = np.floor(xmid).astype(np.int64) - (p - 1) // 2
    u = xmid[:, None] - (i0[:, None] + np.arange(p + 1))
    return i0, _np_bspline(u, p)


def cross_matrix_1d(dst_coords, src_geom: Geometry, axis: int,
                    n_src_padded: int, order: int,
                    valid_only: bool) -> np.ndarray:
    """(n_dst, n_src_padded) order-`order` interpolation matrix; taps that
    fall outside the source array (or, with valid_only, outside the source's
    valid box) contribute zero, the clip of the reference's cross-grid laser
    interpolation (ref MultiLaser.cpp:269-283)."""
    G = src_geom.nguards
    d = src_geom.cell_size(axis)
    off = src_geom.pos_offset(axis)
    xmid = (np.asarray(dst_coords, float) - off) / d
    i0, w = _np_shape_weights(xmid, order)
    M = np.zeros((len(xmid), n_src_padded))
    rows = np.arange(len(xmid))
    lo = G if valid_only else 0
    hi = (n_src_padded - G) if valid_only else n_src_padded
    for k in range(order + 1):
        idx = i0 + k + G
        ok = (idx >= lo) & (idx < hi)
        M[rows[ok], idx[ok]] += w[ok, k]
    return M


class GridInterp:
    """Separable cross-grid interpolation of padded slices, dst = Wy src
    Wx^T (ref MultiLaser::InterpolateChi / UpdateLaserAabs)."""

    def __init__(self, src: Geometry, dst: Geometry, dtype, order: int = 1,
                 valid_only: bool = False, device=None):
        G = dst.nguards
        NYs, NXs = src.slice_shape
        NYd, NXd = dst.slice_shape
        xd = (np.arange(NXd) - G + 0.5) * dst.dx + dst.prob_lo[0]
        yd = (np.arange(NYd) - G + 0.5) * dst.dy + dst.prob_lo[1]
        kw = dict(dtype=dtype, device=device)
        self.Wx = torch.as_tensor(
            cross_matrix_1d(xd, src, 0, NXs, order, valid_only), **kw)
        self.Wy = torch.as_tensor(
            cross_matrix_1d(yd, src, 1, NYs, order, valid_only), **kw)

    def apply(self, a: torch.Tensor) -> torch.Tensor:
        return self.Wy @ a @ self.Wx.T


def trusted_laser_cells(field: Geometry, laser: Geometry, device=None):
    """The laser-grid cells inside the field's trusted chi region, the
    field's valid box shrunk by its guard cells (ref
    MultiLaser.cpp:358-373), as a (NY, NX) bool tensor of the laser grid."""
    G = field.nguards
    NYl, NXl = laser.slice_shape
    xl = (np.arange(NXl) - G + 0.5) * laser.dx + laser.prob_lo[0]
    yl = (np.arange(NYl) - G + 0.5) * laser.dy + laser.prob_lo[1]
    x_ok = ((xl >= field.prob_lo[0] + G * field.dx)
            & (xl <= field.prob_hi[0] - G * field.dx))
    y_ok = ((yl >= field.prob_lo[1] + G * field.dy)
            & (yl <= field.prob_hi[1] - G * field.dy))
    return torch.as_tensor(y_ok[:, None] & x_ok[None, :], device=device)
