"""Transverse Dirichlet Poisson solver on slices, batched over components.

Port of ``DirichletPoissonSolver`` (``hipace_tpu/fields/poisson.py:33-135``)
with its two FFT variants. Solves Laplacian(u) = rhs with u = 0 at the
ghost nodes one cell outside the domain, the discretization a DST-I
diagonalizes (ref FFTPoissonSolverDirichletFast.cpp:224-248):

    lambda(kx, ky) = -4 [ sin^2((kx+1) pi / (2(nx+1))) / dx^2
                        + sin^2((ky+1) pi / (2(ny+1))) / dy^2 ]

The sine-matrix variants of the JAX package exist for the TPU's matrix
unit and are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.dst import dst1_2d, dst1_2d_fast

# fields.poisson_solver names served by each variant
VARIANTS = {"FFTDirichletFast": "fast", "FFTDirichletExpanded": "expanded",
            "FFTDirichletDirect": "expanded"}


class DirichletPoissonSolver(torch.nn.Module):
    """Batched DST-I Poisson solver; the eigenvalue table is a buffer."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 device=None, dtype=torch.float64, variant: str = "fast"):
        super().__init__()
        if variant not in ("fast", "expanded"):
            raise ValueError(f"unknown DST variant {variant!r}")
        if variant == "fast" and (nx % 2 == 0 or ny % 2 == 0):
            variant = "expanded"   # the fast DST needs odd sizes
        self.variant = variant
        self._dst2d = dst1_2d_fast if variant == "fast" else dst1_2d
        kx = np.arange(nx)
        ky = np.arange(ny)
        sinx2 = np.sin((kx + 1) * math.pi / (2 * (nx + 1))) ** 2
        siny2 = np.sin((ky + 1) * math.pi / (2 * (ny + 1))) ** 2
        lam = -4.0 * (sinx2[None, :] / (dx * dx) + siny2[:, None] / (dy * dy))
        # the inverse-DST normalization 4/((nx+1)(ny+1)) folded in
        norm = 4.0 / ((nx + 1) * (ny + 1))
        self.register_buffer("inv_eig", torch.as_tensor(
            norm / lam, dtype=dtype, device=device))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve Laplacian(u) = rhs; rhs (..., ny, nx)."""
        return self._dst2d(self._dst2d(rhs) * self.inv_eig)
