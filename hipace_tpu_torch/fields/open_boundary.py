"""Open (free-space) transverse field boundaries by a multipole expansion.

Port of ``hipace_tpu/fields/open_boundary.py`` (ref OpenBoundary.H:34-52,
Fields.cpp:685-760 SetOpenBoundaryCondition). The potential at the ghost
nodes one cell outside the domain is

    phi(z) = dx dy / (4 pi) [ M_0 ln|zs|^2 - 2 sum_{o=1..18} Re(M_o w^o) / o ]

with zs = z * scale, w = 1 / zs and the complex source moments
M_o = sum_cells s (z' scale)^o. Sources outside 95% of the inscribed radius
are left out: the series converges only for |z'| < |z| (ref
Fields.cpp:710-714). The Dirichlet solve then takes phi as an inhomogeneous
ghost value: rhs_edge -= phi_ghost / d^2 (ref SetDirichletBoundaries with
BoundaryOffset 1, BoundaryFactor 1).

The JAX package takes the moments by a scan of 19 full-plane products and
sums per channel. Here the source powers (z' scale)^o, o = 0..18, are a
table built once per grid by the same recurrence (masked to the sources
the series keeps), so one real matrix product gives every channel's 19
moments; the powers w^o at the 2 nx + 2 ny ghost nodes are a second table,
and the edge potentials of every channel a second product. Plain torch:
this is XLA code in the JAX package, not a TPU kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import Geometry

N_ORDERS = 18


def _power_table(z: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """(len(z), last - first + 1) of z**o, o = first..last, by the
    recurrence zp = zp * z from z**first."""
    zp = torch.ones_like(z) if first == 0 else z
    cols = []
    for _ in range(first, last + 1):
        cols.append(zp)
        zp = zp * z
    return torch.stack(cols, dim=1)


class OpenBoundary:
    """The source and edge tables of one grid."""

    def __init__(self, geom: Geometry, device=None, dtype=torch.float64):
        g = geom
        lx = g.prob_hi[0] - g.prob_lo[0]
        ly = g.prob_hi[1] - g.prob_lo[1]
        self.scale = 3.0 / math.sqrt(lx * lx + ly * ly)
        radius = min(abs(g.prob_lo[0]), abs(g.prob_hi[0]),
                     abs(g.prob_lo[1]), abs(g.prob_hi[1]))
        if radius <= 0.0:
            raise ValueError(
                "open boundaries need x=0, y=0 inside the domain (expansion "
                "point, ref Fields.cpp:706-708)")
        cutoff_sq = (0.95 * radius * self.scale) ** 2
        self.nx, self.ny = g.nx, g.ny
        ctype = torch.complex64 if dtype == torch.float32 \
            else torch.complex128

        xs = (np.arange(g.nx) + 0.5) * g.dx + g.prob_lo[0]
        ys = (np.arange(g.ny) + 0.5) * g.dy + g.prob_lo[1]
        X, Y = np.meshgrid(xs * self.scale, ys * self.scale)
        keep = (X * X + Y * Y <= cutoff_sq).reshape(-1)
        zsrc = torch.as_tensor(np.where(keep, (X + 1j * Y).reshape(-1), 0.0),
                               dtype=ctype, device=device)
        # (ny nx, 2 (N+1)): Re and Im of the powers o = 0..N side by side,
        # zero where the series leaves the source out
        src = _power_table(zsrc, 0, N_ORDERS)
        src = src * torch.as_tensor(keep, device=device)[:, None]
        self.src_table = torch.view_as_real(src).reshape(zsrc.numel(), -1)

        # ghost nodes one cell beyond the edge cells: bottom (rhs[0, :]),
        # top (rhs[-1, :]), left (rhs[:, 0]), right (rhs[:, -1])
        zb = np.concatenate([
            xs + 1j * (ys[0] - g.dy), xs + 1j * (ys[-1] + g.dy),
            (xs[0] - g.dx) + 1j * ys, (xs[-1] + g.dx) + 1j * ys]) * self.scale
        zedge = torch.as_tensor(zb, dtype=ctype, device=device)
        self.dxdy_div_4pi = g.dx * g.dy / (4.0 * math.pi)
        self.log_r2 = torch.log(zedge.abs() ** 2)
        # -2 Re(M_o w^o) / o = [Re M_o, Im M_o] . [-2 Re w^o / o,
        # 2 Im w^o / o]: (2 N, n_edge)
        wp = _power_table(1.0 / zedge, 1, N_ORDERS)
        o = torch.arange(1, N_ORDERS + 1, device=device).to(dtype)
        self.edge_table = torch.cat([-2.0 * wp.real / o,
                                     2.0 * wp.imag / o], dim=1).T.contiguous()
        self.inv_dx2 = 1.0 / (g.dx * g.dx)
        self.inv_dy2 = 1.0 / (g.dy * g.dy)

    def moments(self, src: torch.Tensor) -> torch.Tensor:
        """Complex moments M_o, o = 0..18, of interior sources (C, ny, nx):
        (C, 19)."""
        C = src.shape[0]
        m = src.reshape(C, -1) @ self.src_table
        return torch.view_as_complex(m.reshape(C, N_ORDERS + 1, 2))

    def edge_potential(self, ms: torch.Tensor,
                       monopole: bool = True) -> torch.Tensor:
        """phi at the ghost nodes of each channel, (C, 2 nx + 2 ny)."""
        terms = torch.cat([ms.real[:, 1:], ms.imag[:, 1:]],
                          dim=1) @ self.edge_table
        if monopole:
            terms = ms.real[:, :1] * self.log_r2 + terms
        return terms * self.dxdy_div_4pi

    def apply(self, rhs: torch.Tensor, monopole: bool = True) -> torch.Tensor:
        """The interior right-hand sides (C, ny, nx) less their channels'
        open-boundary ghost values (ref SetDirichletBoundaries:
        rhs_edge -= phi_ghost / d^2); a new tensor."""
        nx, ny = self.nx, self.ny
        phi = self.edge_potential(self.moments(rhs), monopole)
        out = rhs.clone()
        out[:, 0, :] -= phi[:, :nx] * self.inv_dy2
        out[:, -1, :] -= phi[:, nx:2 * nx] * self.inv_dy2
        out[:, :, 0] -= phi[:, 2 * nx:2 * nx + ny] * self.inv_dx2
        out[:, :, -1] -= phi[:, 2 * nx + ny:] * self.inv_dx2
        return out
