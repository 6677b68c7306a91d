"""Discrete sine transforms (DST-I) on torch.fft.

Port of ``hipace_tpu/ops/dst.py``. DST-I here is the plain sine sum
    X[k] = sum_{n=0}^{N-1} x[n] sin(pi (n+1)(k+1) / (N+1))
so that dst1(dst1(x)) = (N+1)/2 * x.

- ``dst1``: odd extension + rfft of length 2(N+1) (the reference's
  "Expanded" variant, FFTPoissonSolverDirichletExpanded.cpp), any N.
- ``dst1_fast``: same-size rfft with sine/difference twiddles (the
  reference's "Fast" variant, FFTPoissonSolverDirichletFast.cpp:24-140),
  N + 1 even.
"""

from __future__ import annotations

import math

import torch


def dst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """DST-I along `dim` via odd extension + rfft."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    zeros = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    # odd extension: [0, x0..x_{n-1}, 0, -x_{n-1}..-x0], length 2(n+1)
    ext = torch.cat([zeros, x, zeros, -x.flip(-1)], dim=-1)
    spec = torch.fft.rfft(ext, dim=-1)
    out = (-0.5 * spec.imag[..., 1:n + 1]).to(x.dtype)
    return out.movedim(-1, dim)


def dst1_fast(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """DST-I via a same-size real FFT (Numerical-Recipes sinft): one rfft
    of an auxiliary length-(N+1) sequence gives the odd outputs as -Im and
    the even outputs as a prefix sum of Re."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    m = n + 1
    if m % 2:
        raise ValueError("dst1_fast needs an odd length (2^k - 1 preferred)")
    j = torch.arange(1, m, dtype=torch.float64, device=x.device)
    sin_j = torch.sin(j * (math.pi / m)).to(x.dtype)
    xr = x.flip(-1)
    y1 = sin_j * (x + xr) + 0.5 * (x - xr)
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(torch.cat([zero, y1], dim=-1), dim=-1)
    odd = -spec.imag[..., 1:]
    re = spec.real
    even = torch.cumsum(torch.cat([0.5 * re[..., :1], re[..., 1:-1]], dim=-1),
                        dim=-1)
    ne = even.shape[-1]
    out = torch.stack([even, odd[..., :ne]], dim=-1)
    out = out.reshape(x.shape[:-1] + (2 * ne,))[..., :n].to(x.dtype)
    return out.movedim(-1, dim)


def dst1_2d(x: torch.Tensor) -> torch.Tensor:
    """DST-I along the last two dims (y, x)."""
    return dst1(dst1(x, dim=-1), dim=-2)


def dst1_2d_fast(x: torch.Tensor) -> torch.Tensor:
    """Fast-variant DST-I along the last two dims."""
    return dst1_fast(dst1_fast(x, dim=-1), dim=-2)
