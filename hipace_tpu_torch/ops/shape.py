"""B-spline particle shape factors, orders 0-3, on tensors.

Port of ``hipace_tpu/ops/shape.py`` (cardinal B-splines evaluated
branch-free on whole particle arrays, ref ShapeFactors.H) plus the
window-position weight function of the banded kernels (``_wfun`` in
``hipace_tpu/ops/pallas_banded.py``), which the deposit and gather kernels
and their plain versions share: a tap's weight is evaluated at its offset
u = pos - cell, so every stencil of every kind has one formula.

Derivative types (ref ShapeFactors.H:203-466):
  - 0 (analytic):  stencil p+1, dxf_i = -B_p'(x - c_i)
  - 1 (nodal):     stencil p+2, dxf_i = -B_{p+1}'(x - c_i)
  - 2 (centered):  stencil p+3, dxf_i = (w_{i+1} - w_{i-1}) / 2
"""

from __future__ import annotations

import torch

W_KIND, DW_KIND = "w", "dw"


def bspline(u: torch.Tensor, p: int) -> torch.Tensor:
    """Cardinal B-spline B_p(u), branch-free."""
    au = torch.abs(u)
    zero = torch.zeros_like(u)
    if p == 0:
        # half-open [-0.5, 0.5) to match floor(x+0.5) binning
        return torch.where((u >= -0.5) & (u < 0.5), torch.ones_like(u), zero)
    if p == 1:
        return torch.clamp(1.0 - au, min=0.0)
    if p == 2:
        inner = 0.75 - au * au
        t = 1.5 - au
        outer = 0.5 * (t * t)
        return torch.where(au <= 0.5, inner,
                           torch.where(au < 1.5, outer, zero))
    if p == 3:
        inner = (4.0 - 6.0 * au * au + 3.0 * (au * au * au)) / 6.0
        t = 2.0 - au
        outer = t * t * t / 6.0
        return torch.where(au <= 1.0, inner,
                           torch.where(au < 2.0, outer, zero))
    raise ValueError(f"unsupported shape order {p}")


def bspline_deriv(u: torch.Tensor, p: int) -> torch.Tensor:
    """dB_p/du via B_p'(u) = B_{p-1}(u+1/2) - B_{p-1}(u-1/2)."""
    return bspline(u + 0.5, p - 1) - bspline(u - 0.5, p - 1)


def leftmost(xmid: torch.Tensor, p: int) -> torch.Tensor:
    """Leftmost cell index (int64) of the order-p stencil."""
    if p in (0, 2):
        return torch.floor(xmid + 0.5).to(torch.int64) - p // 2
    return torch.floor(xmid).to(torch.int64) - (p - 1) // 2


def ntaps(order: int, deriv_type: int) -> int:
    """Stencil width; deriv_type -1 is the plain order-p shape."""
    return order + 1 if deriv_type < 0 else order + deriv_type + 1


def stencil_i0(xm: torch.Tensor, order: int, deriv_type: int):
    """Leftmost stencil index for a derivative type."""
    if deriv_type in (-1, 0):
        return leftmost(xm, order)
    if deriv_type == 1:
        return leftmost(xm, order + 1)
    if deriv_type == 2:
        return leftmost(xm, order) - 1
    raise ValueError(f"unsupported deriv_type {deriv_type}")


def wfun(u: torch.Tensor, order: int, deriv_type: int, kind: str):
    """Weight at offset u = pos - cell: kind "w" is the order-p shape,
    "dw" the derivative factor of `deriv_type`."""
    if kind == W_KIND:
        return bspline(u, order)
    if deriv_type == 0:
        return -bspline_deriv(u, order)
    if deriv_type == 1:
        return -bspline_deriv(u, order + 1)
    if deriv_type == 2:
        # w_{i+1} = B_p(u - 1) as a function of this cell's offset u
        return 0.5 * (bspline(u - 1.0, order) - bspline(u + 1.0, order))
    raise ValueError(f"unsupported deriv_type {deriv_type}")


def _offsets(xmid, i0, m):
    offs = torch.arange(m, device=xmid.device)
    return xmid[..., None] - (i0[..., None] + offs).to(xmid.dtype)


def shape_weights(xmid: torch.Tensor, p: int):
    """(i0 (N,), w (N, p+1)) with w_k = B_p(x - (i0 + k))."""
    i0 = leftmost(xmid, p)
    return i0, bspline(_offsets(xmid, i0, p + 1), p)


def shape_weights_derivative(xmid: torch.Tensor, p: int, deriv_type: int):
    """(i0 (N,), w (N, m), dxf (N, m)) with m = p + deriv_type + 1: the
    order-p shape embedded in the derivative stencil and the reference's
    dx_factor."""
    i0 = stencil_i0(xmid, p, deriv_type)
    m = ntaps(p, deriv_type)
    u = _offsets(xmid, i0, m)
    w = bspline(u, p)
    if deriv_type == 2:
        zero = torch.zeros_like(w[..., :1])
        dxf = 0.5 * (torch.cat([w[..., 1:], zero], dim=-1)
                     - torch.cat([zero, w[..., :-1]], dim=-1))
    else:
        dxf = wfun(u, p, deriv_type, DW_KIND)
    return i0, w, dxf
