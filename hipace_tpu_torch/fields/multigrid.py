"""2D geometric multigrid for Laplacian(u) - acf*u = rhs, Dirichlet BC.

Port of the real node-centered ``MultiGrid`` of
``hipace_tpu/fields/multigrid.py:80-296`` (the reference's hpmg solve1 for
Bx/By, ref HpMultiGrid.cpp). Odd grid sizes, recommended 2^N - 1, with
u = 0 at the ghost nodes: the DST solver's convention. Red-black
Gauss-Seidel (red = (ix + iy) even, swept first), full-weighting
restriction (coarse node ic sits at fine node 2ic+1, stencil [1, 2, 1]/4
per dimension), bilinear prolongation P = 2 R^T per dimension, V-cycles
until the max-norm residual is at most
max(tol_abs, max(tol_rel, 1e-16) * max(|res0|, |rhs|)) or max_iters.

``solve_plain`` is the plain PyTorch version and K3's reference: the
transfers are the dense separable products Ry r Rx^T of the XLA path.
``solve`` takes it for CPU tensors; CUDA tensors go to the hand-written
kernels of ``ops/mg_kernel.py``. Even (cell-centered) grids and the complex
laser system are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_lib

# Gauss-Seidel sweeps added on the coarsest level (after nu1)
COARSE_SWEEPS = 8


def restrict_matrix(nf: int) -> np.ndarray:
    """(nc, nf) full-weighting restriction, nc = (nf - 1) // 2."""
    nc = (nf - 1) // 2
    R = np.zeros((nc, nf))
    for ic in range(nc):
        R[ic, 2 * ic:2 * ic + 3] = (0.25, 0.5, 0.25)
    return R


class MultiGrid(torch.nn.Module):
    """Node-centered geometric multigrid; construct once per grid."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 device=None, dtype=torch.float64):
        super().__init__()
        if nx % 2 == 0 or ny % 2 == 0:
            raise NotImplementedError(
                "even (cell-centered) multigrid sizes are not ported: use "
                "odd transverse cell counts, 2^N - 1 preferred")
        self.dtype = dtype
        self.shapes = []
        self.facs = []
        n_x, n_y, ddx, ddy = nx, ny, dx, dy
        while True:
            self.shapes.append((n_y, n_x))
            self.facs.append((1.0 / (ddx * ddx), 1.0 / (ddy * ddy)))
            if ((n_x - 1) % 2 or (n_y - 1) % 2 or (n_x - 1) // 2 < 3
                    or (n_y - 1) // 2 < 3):
                break
            n_x, n_y = (n_x - 1) // 2, (n_y - 1) // 2
            ddx *= 2.0
            ddy *= 2.0
        self.nlevels = len(self.shapes)
        # diagonal of the Laplacian per level (node-centered: a scalar)
        self.diags = [-2.0 * (fx + fy) for fx, fy in self.facs]
        for lev in range(self.nlevels):
            n_y, n_x = self.shapes[lev]
            red = (np.add.outer(np.arange(n_y), np.arange(n_x)) % 2) == 0
            self.register_buffer(f"red{lev}", torch.as_tensor(
                red, device=device))
        for lev in range(self.nlevels - 1):
            n_y, n_x = self.shapes[lev]
            for name, n in (("Ry", n_y), ("Rx", n_x)):
                self.register_buffer(f"{name}{lev}", torch.as_tensor(
                    restrict_matrix(n), dtype=dtype, device=device))
        # V-cycles taken by the last solve (CPU or CUDA)
        self.last_cycles = 0

    # ------------------------------------------------------------------
    def _offdiag(self, u, lev):
        facx, facy = self.facs[lev]
        up = F.pad(u, (1, 1, 1, 1))
        uW, uE = up[..., 1:-1, :-2], up[..., 1:-1, 2:]
        uS, uN = up[..., :-2, 1:-1], up[..., 2:, 1:-1]
        return facx * (uW + uE) + facy * (uN + uS)

    def apply_op(self, u, acf, lev=0):
        """A(u) = Laplacian(u) - acf*u."""
        return self._offdiag(u, lev) + (self.diags[lev] - acf) * u

    def _smooth(self, u, rhs, acf, lev, sweeps):
        """Red-black Gauss-Seidel (each sweep = red + black)."""
        red = getattr(self, f"red{lev}")
        inv_diag = 1.0 / (self.diags[lev] - acf)
        for _ in range(sweeps):
            for mask in (red, ~red):
                upd = (rhs - self._offdiag(u, lev)) * inv_diag
                u = torch.where(mask, upd, u)
        return u

    def _restrict(self, r, lev):
        return getattr(self, f"Ry{lev}") @ r @ getattr(self, f"Rx{lev}").T

    def _prolong_add(self, u, c, lev):
        ry, rx = getattr(self, f"Ry{lev}"), getattr(self, f"Rx{lev}")
        return u + (2.0 * ry).T @ c @ (2.0 * rx)

    def coarsen_acf(self, acf):
        """Averaged-down a-coefficients per level (ref average_down_acoef).
        The node-centered averaging denominator Ry 1 Rx^T is exactly 1."""
        acfs = [acf]
        for lev in range(self.nlevels - 1):
            a = acfs[-1]
            acfs.append(a if not torch.is_tensor(a) or a.ndim == 0
                        else self._restrict(a, lev))
        return acfs

    def _vcycle(self, u, rhs, acfs, lev, nu1, nu2):
        u = self._smooth(u, rhs, acfs[lev], lev, nu1)
        if lev + 1 < self.nlevels:
            res = rhs - self.apply_op(u, acfs[lev], lev)
            crhs = self._restrict(res, lev)
            cu = self._vcycle(torch.zeros_like(crhs), crhs, acfs, lev + 1,
                              nu1, nu2)
            u = self._prolong_add(u, cu, lev)
            u = self._smooth(u, rhs, acfs[lev], lev, nu2)
        else:
            u = self._smooth(u, rhs, acfs[lev], lev, COARSE_SWEEPS)
        return u

    # ------------------------------------------------------------------
    def solve_plain(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0,
                    max_iters=40, nu1=2, nu2=2):
        """Plain PyTorch solve on any device. u0/rhs (C, ny, nx) or
        (ny, nx) sharing acf (ny, nx) or a scalar."""
        acfs = self.coarsen_acf(acf)
        resnorm = float(torch.max(torch.abs(
            rhs - self.apply_op(u0, acfs[0], 0))))
        target = convergence_target(resnorm, float(torch.max(
            torch.abs(rhs))), tol_rel, tol_abs, rhs.dtype)
        u, it = u0, 0
        while resnorm > target and it < max_iters:
            u = self._vcycle(u, rhs, acfs, 0, nu1, nu2)
            resnorm = float(torch.max(torch.abs(
                rhs - self.apply_op(u, acfs[0], 0))))
            it += 1
        self.last_cycles = it
        return u

    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2):
        """Solve Laplacian(u) - acf*u = rhs from u0: the plain version for
        CPU tensors, the K3 kernels for CUDA tensors."""
        if cuda_lib.use_kernel(u0):
            from ..ops.mg_kernel import mg_solve   # imports this module
            return mg_solve(self, u0, rhs, acf, tol_rel=tol_rel,
                            tol_abs=tol_abs, max_iters=max_iters, nu1=nu1,
                            nu2=nu2)
        return self.solve_plain(u0, rhs, acf, tol_rel=tol_rel,
                                tol_abs=tol_abs, max_iters=max_iters,
                                nu1=nu1, nu2=nu2)


def convergence_target(resnorm0: float, rhsnorm0: float, tol_rel: float,
                       tol_abs: float, dtype) -> float:
    """hpmg's stopping threshold (ref HpMultiGrid.cpp:1308-1380), rounded
    to the working dtype as the JAX package computes it."""
    t = max(tol_abs, max(tol_rel, 1e-16) * max(resnorm0, rhsnorm0))
    return float(torch.tensor(t, dtype=dtype))
