"""2D geometric multigrid for Laplacian(u) - acf*u = rhs, Dirichlet BC.

Port of the real ``MultiGrid`` of ``hipace_tpu/fields/multigrid.py:80-296``
(the reference's hpmg solve1 for Bx/By, ref HpMultiGrid.cpp) in both of its
grid conventions (ref HpMultiGrid.cpp:1050-1065), chosen by the parity of
the sizes, which must agree:

- odd sizes, recommended 2^N - 1 ("node-centered"): u = 0 at the ghost
  nodes, the DST solver's convention; full-weighting restriction (coarse
  node ic sits at fine node 2ic+1, stencil [1, 2, 1]/4 per dimension),
  bilinear prolongation; levels halve while (n - 1) / 2 >= 3.
- even sizes ("cell-centered"): u = 0 at the cell faces, so the
  boundary-facing neighbour of an edge cell weighs 4/3 and the edge cell's
  diagonal is -4 fac in that dimension (ref HpMultiGrid.cpp:163-182): the
  diagonal is a plane, not a scalar; 2-cell-average restriction,
  piecewise-constant prolongation; levels halve while both sizes are even
  and n / 2 >= 2, so 1024 goes down to 2 and 96 stops at 3.

Both: red-black Gauss-Seidel (red = (ix + iy) even, swept first),
prolongation P = 2 R^T per dimension, V-cycles until the max-norm residual
is at most max(tol_abs, max(tol_rel, 1e-16) * max(|res0|, |rhs|)) or
max_iters.

Real systems (hpmg solve1: Bx, By sharing one acf) and complex ones (hpmg
solve2: the laser envelope, ref MultiLaser.cpp:430-607; the JAX package's
complex path of ``MultiGrid.solve``): u0, rhs complex, acf a complex plane or
a real plane plus a complex scalar (``(plane, scalar)``). A complex solve
runs planar, each value as its real and imaginary planes on an axis of two
before the grid axes: the Laplacian and the transfers act on both planes
alike, the smoother and the residual couple them through the complex
products (diag - acf) u and (rhs - off) / (diag - acf), with the reciprocal
written out as conj(d) / |d|^2, each product and sum a separate rounding in
the order K3's complex path takes them; the max-norm is the modulus
(``torch.hypot``). The node-centered acf coarsening divides by the averaging
denominator Ry 1 Rx^T, which is exactly 1.

``solve_plain`` is the plain PyTorch version and K3's reference: the
transfers are the dense separable products Ry r Rx^T of the XLA path.
``solve`` takes it for CPU tensors; CUDA tensors go to the hand-written
kernel of ``ops/mg_kernel.py``. ``cycles`` holds the last solve's V-cycle
count as that path left it -- an int from the plain version, a 0-d device
tensor from the kernel, which no one has to read back -- and
``last_cycles`` reads it as an int.
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


def restrict_matrix_cc(nf: int) -> np.ndarray:
    """(nc, nf) 2-cell-average restriction, nc = nf // 2."""
    nc = nf // 2
    R = np.zeros((nc, nf))
    for ic in range(nc):
        R[ic, 2 * ic:2 * ic + 2] = 0.5
    return R


def cc_diag(n_y: int, n_x: int, facx: float, facy: float) -> np.ndarray:
    """The cell-centered diagonal plane in float64: -2 fac per dimension,
    -4 fac in the edge cells of that dimension."""
    dgx = np.full((n_x,), -2.0 * facx)
    dgx[0] = dgx[-1] = -4.0 * facx
    dgy = np.full((n_y,), -2.0 * facy)
    dgy[0] = dgy[-1] = -4.0 * facy
    return dgx[None, :] + dgy[:, None]


class MultiGrid(torch.nn.Module):
    """Geometric multigrid, node-centered at odd sizes and cell-centered at
    even ones; construct once per grid."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 device=None, dtype=torch.float64):
        super().__init__()
        if nx % 2 != ny % 2:
            raise ValueError(f"nx = {nx} and ny = {ny} must have the same "
                             "parity")
        self.cell_centered = nx % 2 == 0
        self.dtype = dtype
        self.shapes = []
        self.facs = []
        n_x, n_y, ddx, ddy = nx, ny, dx, dy
        while True:
            self.shapes.append((n_y, n_x))
            self.facs.append((1.0 / (ddx * ddx), 1.0 / (ddy * ddy)))
            if self.cell_centered:
                if n_x % 2 or n_y % 2 or n_x // 2 < 2 or n_y // 2 < 2:
                    break
                n_x, n_y = n_x // 2, n_y // 2
            else:
                if ((n_x - 1) % 2 or (n_y - 1) % 2 or (n_x - 1) // 2 < 3
                        or (n_y - 1) // 2 < 3):
                    break
                n_x, n_y = (n_x - 1) // 2, (n_y - 1) // 2
            ddx *= 2.0
            ddy *= 2.0
        self.nlevels = len(self.shapes)
        for lev in range(self.nlevels):
            n_y, n_x = self.shapes[lev]
            red = (np.add.outer(np.arange(n_y), np.arange(n_x)) % 2) == 0
            self.register_buffer(f"red{lev}", torch.as_tensor(
                red, device=device))
            if self.cell_centered:
                # the boundary-facing neighbour's 4/3 (ref
                # HpMultiGrid.cpp laplacian())
                coef = {s: np.ones((n_y, n_x)) for s in "WESN"}
                coef["E"][:, 0] = coef["W"][:, -1] = 4.0 / 3.0
                coef["N"][0, :] = coef["S"][-1, :] = 4.0 / 3.0
                for s, c in coef.items():
                    self.register_buffer(f"c{s}{lev}", torch.as_tensor(
                        c, dtype=dtype, device=device))
                self.register_buffer(f"diag{lev}", torch.as_tensor(
                    cc_diag(n_y, n_x, *self.facs[lev]), dtype=dtype,
                    device=device))
        rmat = restrict_matrix_cc if self.cell_centered else restrict_matrix
        for lev in range(self.nlevels - 1):
            n_y, n_x = self.shapes[lev]
            for name, n in (("Ry", n_y), ("Rx", n_x)):
                self.register_buffer(f"{name}{lev}", torch.as_tensor(
                    rmat(n), dtype=dtype, device=device))
            if not self.cell_centered:
                # the node-centered acf averaging denominator Ry 1 Rx^T
                self.register_buffer(f"acf_den{lev}", torch.as_tensor(
                    rmat(n_y) @ np.ones((n_y, n_x)) @ rmat(n_x).T,
                    dtype=dtype, device=device))
        # workspace layouts of the kernel's solves (ops/mg_kernel.py)
        self.kernel_layouts = {}
        # V-cycles taken by the last solve: an int (plain version) or a
        # 0-d device tensor (kernel)
        self.cycles = 0

    @property
    def last_cycles(self) -> int:
        """V-cycles taken by the last solve; on the kernel path this reads
        the device scalar, so it waits for the solve."""
        return int(self.cycles)

    # ------------------------------------------------------------------
    def _diag(self, lev):
        """The Laplacian's diagonal on level lev: a scalar node-centered,
        the plane diag<lev> cell-centered."""
        if self.cell_centered:
            return getattr(self, f"diag{lev}")
        facx, facy = self.facs[lev]
        return -2.0 * (facx + facy)

    def _offdiag(self, u, lev):
        facx, facy = self.facs[lev]
        up = F.pad(u, (1, 1, 1, 1))
        uW, uE = up[..., 1:-1, :-2], up[..., 1:-1, 2:]
        uS, uN = up[..., :-2, 1:-1], up[..., 2:, 1:-1]
        if self.cell_centered:
            cW, cE, cS, cN = (getattr(self, f"c{s}{lev}") for s in "WESN")
            return facx * (uW * cW + uE * cE) + facy * (uS * cS + uN * cN)
        return facx * (uW + uE) + facy * (uN + uS)

    def _coefs(self, acf, lev, cplx):
        """(dma, inv) of level lev: diag - acf and its reciprocal; complex,
        each a (re, im) pair of planes from the planar acf, the reciprocal
        conj(d) / |d|^2."""
        if not cplx:
            dma = self._diag(lev) - acf
            return dma, 1.0 / dma
        d_re = self._diag(lev) - acf[0]
        d_im = -acf[1]
        n = d_re * d_re + d_im * d_im
        return (d_re, d_im), (d_re / n, (-d_im) / n)

    @staticmethod
    def _mul(coef, u, cplx):
        """coef * u; complex, the planar product (a.re b.re - a.im b.im,
        a.re b.im + a.im b.re) on u's axis -3."""
        if not cplx:
            return coef * u
        a_re, a_im = coef
        u_re, u_im = u[..., 0, :, :], u[..., 1, :, :]
        return torch.stack([a_re * u_re - a_im * u_im,
                            a_re * u_im + a_im * u_re], dim=-3)

    @staticmethod
    def _norm(r, cplx):
        """Max-norm; the modulus of a planar complex r."""
        if cplx:
            return float(torch.max(torch.hypot(r[..., 0, :, :],
                                               r[..., 1, :, :])))
        return float(torch.max(torch.abs(r)))

    def apply_op(self, u, acf, lev=0):
        """A(u) = Laplacian(u) - acf*u; complex u or acf in complex
        tensors."""
        if torch.is_complex(u) or _is_complex_acf(acf):
            up = _planar(u if torch.is_complex(u) else u.to(
                complex_dtype(u.dtype)))
            dma, _ = self._coefs(planar_acf(acf, self.shapes[lev], up.dtype,
                                            up.device), lev, True)
            out = self._offdiag(up, lev) + self._mul(dma, up, True)
            return torch.complex(out[..., 0, :, :], out[..., 1, :, :])
        return self._offdiag(u, lev) + (self._diag(lev) - acf) * u

    def _smooth(self, u, rhs, inv, lev, sweeps, cplx):
        """Red-black Gauss-Seidel (each sweep = red + black)."""
        red = getattr(self, f"red{lev}")
        for _ in range(sweeps):
            for mask in (red, ~red):
                upd = self._mul(inv, rhs - self._offdiag(u, lev), cplx)
                u = torch.where(mask, upd, u)
        return u

    def _restrict(self, r, lev):
        return getattr(self, f"Ry{lev}") @ r @ getattr(self, f"Rx{lev}").T

    def _prolong_add(self, u, c, lev):
        ry, rx = getattr(self, f"Ry{lev}"), getattr(self, f"Rx{lev}")
        return u + (2.0 * ry).T @ c @ (2.0 * rx)

    def coarsen_acf(self, acf):
        """Averaged-down a-coefficients per level (ref average_down_acoef):
        the restriction of each level's, divided node-centered by the
        averaging denominator Ry 1 Rx^T (exactly 1), a 2x2 average where
        cell-centered. A planar complex acf restricts plane by plane."""
        acfs = [acf]
        for lev in range(self.nlevels - 1):
            a = acfs[-1]
            if not torch.is_tensor(a) or a.ndim == 0:
                acfs.append(a)
            elif self.cell_centered:
                acfs.append(self._restrict(a, lev))
            else:
                acfs.append(self._restrict(a, lev)
                            / getattr(self, f"acf_den{lev}"))
        return acfs

    def _vcycle(self, u, rhs, coefs, lev, nu1, nu2, cplx):
        dma, inv = coefs[lev]
        u = self._smooth(u, rhs, inv, lev, nu1, cplx)
        if lev + 1 < self.nlevels:
            res = rhs - (self._offdiag(u, lev) + self._mul(dma, u, cplx))
            crhs = self._restrict(res, lev)
            cu = self._vcycle(torch.zeros_like(crhs), crhs, coefs, lev + 1,
                              nu1, nu2, cplx)
            u = self._prolong_add(u, cu, lev)
            u = self._smooth(u, rhs, inv, lev, nu2, cplx)
        else:
            u = self._smooth(u, rhs, inv, lev, COARSE_SWEEPS, cplx)
        return u

    # ------------------------------------------------------------------
    def solve_plain(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0,
                    max_iters=40, nu1=2, nu2=2):
        """Plain PyTorch solve on any device. u0/rhs (C, ny, nx) or
        (ny, nx) sharing acf (ny, nx) or a scalar; complex u0/rhs with a
        complex acf plane or (real plane, complex scalar)."""
        cplx = torch.is_complex(u0)
        if cplx:
            u0, rhs = _planar(u0), _planar(rhs)
            acf = planar_acf(acf, self.shapes[0], u0.dtype, u0.device)
        coefs = [self._coefs(a, lev, cplx)
                 for lev, a in enumerate(self.coarsen_acf(acf))]

        def resnorm(u):
            dma = coefs[0][0]
            return self._norm(rhs - (self._offdiag(u, 0)
                                     + self._mul(dma, u, cplx)), cplx)

        res = resnorm(u0)
        target = convergence_target(res, self._norm(rhs, cplx), tol_rel,
                                    tol_abs, rhs.dtype)
        u, it = u0, 0
        while res > target and it < max_iters:
            u = self._vcycle(u, rhs, coefs, 0, nu1, nu2, cplx)
            res = resnorm(u)
            it += 1
        self.cycles = it
        if cplx:
            return torch.complex(u[..., 0, :, :], u[..., 1, :, :])
        return u

    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2):
        """Solve Laplacian(u) - acf*u = rhs from u0: the plain version for
        CPU tensors, the K3 kernel (real or complex) for CUDA tensors."""
        if cuda_lib.use_kernel(u0):
            from ..ops.mg_kernel import mg_solve   # imports this module
            u, self.cycles, _ = mg_solve(
                self, u0, rhs, acf, tol_rel=tol_rel, tol_abs=tol_abs,
                max_iters=max_iters, nu1=nu1, nu2=nu2)
            return u
        return self.solve_plain(u0, rhs, acf, tol_rel=tol_rel,
                                tol_abs=tol_abs, max_iters=max_iters,
                                nu1=nu1, nu2=nu2)


def complex_dtype(dtype):
    """The complex dtype of a real one's precision."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _is_complex_acf(acf) -> bool:
    return isinstance(acf, tuple) or (torch.is_tensor(acf)
                                      and torch.is_complex(acf))


def _planar(u):
    """A complex (..., ny, nx) tensor as real (..., 2, ny, nx) planes."""
    return torch.stack([u.real, u.imag], dim=-3)


def planar_acf(acf, shape, dtype, device):
    """A complex acf as its (2, ny, nx) real and imaginary planes: from a
    complex (ny, nx) plane or a pair (real plane, complex scalar), whose
    planes are plane + scalar.real and scalar.imag. The scalar may be a 0-d
    device tensor, which is spread on the device and never read back."""
    if isinstance(acf, tuple):
        plane, s = acf
        if torch.is_tensor(s):
            s = s.to(device=device)
            s_re = s.real if torch.is_complex(s) else s
            s_im = s.imag if torch.is_complex(s) else torch.zeros_like(s)
        else:
            s_re, s_im = complex(s).real, complex(s).imag
        re = plane.to(dtype) + s_re
        im = torch.zeros(shape, dtype=dtype, device=device) + s_im
        return torch.stack([re, im])
    if not (torch.is_tensor(acf) and acf.shape == tuple(shape)):
        raise ValueError("a complex acf is a (ny, nx) plane or a pair (real "
                         "plane, complex scalar)")
    acf = acf.to(complex_dtype(dtype))
    return torch.stack([acf.real, acf.imag])


def convergence_target(resnorm0: float, rhsnorm0: float, tol_rel: float,
                       tol_abs: float, dtype) -> float:
    """hpmg's stopping threshold (ref HpMultiGrid.cpp:1308-1380), rounded
    to the working dtype as the JAX package computes it."""
    t = max(tol_abs, max(tol_rel, 1e-16) * max(resnorm0, rhsnorm0))
    return float(torch.tensor(t, dtype=dtype))
