"""Transverse Poisson solvers on slices, batched over components.

Port of ``hipace_tpu/fields/poisson.py`` and of ``make_poisson_solver``
(``hipace_tpu/pipeline/step.py:699-720``), the fields.poisson_solver family
(ref Fields.cpp:29-44):

- ``DirichletPoissonSolver``: Laplacian(u) = rhs with u = 0 at the ghost
  nodes one cell outside the domain, the discretization a DST-I
  diagonalizes (ref FFTPoissonSolverDirichletFast.cpp:224-248):

      lambda(kx, ky) = -4 [ sin^2((kx+1) pi / (2(nx+1))) / dx^2
                          + sin^2((ky+1) pi / (2(ny+1))) / dy^2 ]

  in its two FFT variants (FFTDirichletFast; FFTDirichletExpanded and
  FFTDirichletDirect).
- ``MGDirichletPoissonSolver``: the same system through the multigrid with
  a zero a-coefficient (ref MGPoissonSolverDirichlet), K3 on the card;
  node-centered at odd sizes (the DST's ghost nodes), cell-centered at even
  ones (zero at the cell faces).
- ``PeriodicPoissonSolver``: a C2C FFT with spectral -(kx^2 + ky^2)
  division (ref FFTPoissonSolverPeriodic.cpp).

The sine-matrix variants of the JAX package exist for the TPU's matrix
unit and are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import Geometry
from ..ops.dst import dst1_2d, dst1_2d_fast
from .multigrid import MultiGrid

# fields.poisson_solver names served by each DST variant
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


class MGDirichletPoissonSolver:
    """Laplacian(u) = rhs by the multigrid from u = 0 (ref hpmg solve3 with
    a zero a-coefficient), to a relative residual of tol_rel or 40
    V-cycles; at odd sizes the ghost-node convention of the DST solvers."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 device=None, dtype=torch.float64, tol_rel: float = 1e-11):
        self.mg = MultiGrid(nx, ny, dx, dy, device=device, dtype=dtype)
        self.tol_rel = tol_rel

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.mg.solve(torch.zeros_like(rhs), rhs, 0.0,
                             tol_rel=self.tol_rel)


class PeriodicPoissonSolver(torch.nn.Module):
    """Batched periodic Poisson solver: C2C FFT, spectral eigenvalues, the
    k = 0 mode set to zero."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 device=None, dtype=torch.float64):
        super().__init__()
        kx = 2.0 * math.pi * np.fft.fftfreq(nx, d=dx)
        ky = 2.0 * math.pi * np.fft.fftfreq(ny, d=dy)
        k2 = kx[None, :] ** 2 + ky[:, None] ** 2
        inv = np.where(k2 == 0.0, 0.0, -1.0 / np.where(k2 == 0.0, 1.0, k2))
        self.register_buffer("inv_eig", torch.as_tensor(
            inv, dtype=dtype, device=device))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve Laplacian(u) = rhs; rhs (..., ny, nx)."""
        spec = torch.fft.fft2(rhs)
        return torch.fft.ifft2(spec * self.inv_eig).real


def make_poisson_solver(name: str, g: Geometry, device, dtype):
    """The solver a fields.poisson_solver name selects (ref
    Fields.cpp:29-44)."""
    if name in VARIANTS:
        return DirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy, device=device,
                                      dtype=dtype, variant=VARIANTS[name])
    if name == "MGDirichlet":
        return MGDirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy,
                                        device=device, dtype=dtype)
    if name == "FFTPeriodic":
        return PeriodicPoissonSolver(g.nx, g.ny, g.dx, g.dy, device=device,
                                     dtype=dtype)
    raise ValueError(f"unknown fields.poisson_solver {name}")
