"""Slice-array helpers: interior views, centered derivatives, field sets.

Port of ``hipace_tpu/fields/slices.py``. A slice field is a padded
(NY, NX) = (ny + 2G, nx + 2G) tensor; cell (ix, iy) lives at [iy+G, ix+G].
"""

from __future__ import annotations

import torch

from ..geometry import Geometry


def interior(f: torch.Tensor, geom: Geometry) -> torch.Tensor:
    G = geom.nguards
    NY, NX = geom.slice_shape
    return f[..., G:NY - G, G:NX - G]


def set_interior(f: torch.Tensor, u: torch.Tensor,
                 geom: Geometry) -> torch.Tensor:
    """Copy of f with its interior replaced by u."""
    out = f.clone()
    interior(out, geom).copy_(u)
    return out


def ddx_interior(f: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Centered x derivative of a padded array, on the interior."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    return (f[..., G:NY - G, G + 1:NX - G + 1]
            - f[..., G:NY - G, G - 1:NX - G - 1]) * (0.5 / geom.dx)


def ddy_interior(f: torch.Tensor, geom: Geometry) -> torch.Tensor:
    G = geom.nguards
    NY, NX = geom.slice_shape
    return (f[..., G + 1:NY - G + 1, G:NX - G]
            - f[..., G - 1:NY - G - 1, G:NX - G]) * (0.5 / geom.dy)


def grad_neg_full(psi: torch.Tensor, geom: Geometry):
    """(-dPsi/dx, -dPsi/dy) on the padded array except the outermost ring
    (ref Fields.cpp:931-956)."""
    exmby = torch.zeros_like(psi)
    eypbx = torch.zeros_like(psi)
    exmby[..., :, 1:-1] = -(psi[..., :, 2:] - psi[..., :, :-2]) * (
        0.5 / geom.dx)
    eypbx[..., 1:-1, :] = -(psi[..., 2:, :] - psi[..., :-2, :]) * (
        0.5 / geom.dy)
    return exmby, eypbx


def symmetrize(f: torch.Tensor, symm_x: int, symm_y: int) -> torch.Tensor:
    """4-fold transverse symmetrization of the last two axes, with parity
    symm_x in x and symm_y in y (ref Fields.cpp:1080-1114)."""
    fx = torch.flip(f, (-1,)) * symm_x
    fy = torch.flip(f, (-2,)) * symm_y
    fxy = torch.flip(f, (-2, -1)) * (symm_x * symm_y)
    return 0.25 * (f + fx + fy + fxy)


def make_field_set(names, geom: Geometry, device, dtype) -> dict:
    return {name: torch.zeros(geom.slice_shape, dtype=dtype, device=device)
            for name in names}
