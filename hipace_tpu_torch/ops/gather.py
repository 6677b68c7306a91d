"""K2: fused main-fields gather onto particles.

Port of the gather contract of the Pallas kernel ``_gather_main_kernel``
(``hipace_tpu/ops/pallas_banded.py:546-748``, entry ``pallas_gather_main``),
whose exact XLA counterpart is ``hipace_tpu/ops/gather.py``
``gather_main_fields`` (ref FieldGather.H:45-97). From a (5, NY, NX) stack
[Psi, Ez, Bx, By, Bz] and nodal (deriv_type 1) order-p weights, per
particle: the raw Psi derivatives sum(Wy dWx Psi) and sum(dWy Wx Psi),
which the caller scales by 1/dx and 1/dy into ExmBy and EypBx, and Ez, Bx,
By, Bz interpolated with Wy Wx. Positions and dead lanes follow the
deposit's convention (``ops/deposit.py``); dead lanes read 0 and taps
outside the grid are dropped.

``gather_main`` returns a (6, N) tensor: CPU tensors take
``gather_main_plain``, CUDA tensors launch ``csrc/gather.cu``.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .deposit import LIVE_FRACTION
from .shape import shape_weights_derivative


def gather_main_plain(stack, ym, xm, order):
    """Plain PyTorch gather (any device), exact elementwise reads."""
    _, NY, NX = stack.shape
    live = ym < LIVE_FRACTION * NY
    iy0, wy, dwy = shape_weights_derivative(ym, order, 1)
    ix0, wx, dwx = shape_weights_derivative(xm, order, 1)
    m = order + 2
    offs = torch.arange(m, device=ym.device)
    iy = iy0[:, None] + offs
    ix = ix0[:, None] + offs
    oky = ((iy >= 0) & (iy < NY)).to(ym.dtype)
    okx = ((ix >= 0) & (ix < NX)).to(xm.dtype)
    wy, dwy = wy * oky, dwy * oky
    wx, dwx = wx * okx, dwx * okx
    lin = (iy.clamp(0, NY - 1)[:, :, None] * NX
           + ix.clamp(0, NX - 1)[:, None, :])                      # (N, m, m)
    vals = stack.reshape(5, NY * NX)[:, lin]                        # (5, N, m, m)
    w = wy[:, :, None] * wx[:, None, :]
    out = torch.stack([
        ((wy[:, :, None] * dwx[:, None, :]) * vals[0]).sum(dim=(1, 2)),
        ((dwy[:, :, None] * wx[:, None, :]) * vals[0]).sum(dim=(1, 2)),
    ] + [(w * vals[c]).sum(dim=(1, 2)) for c in range(1, 5)])
    return torch.where(live, out, torch.zeros_like(out))


def gather_main_cuda(stack, ym, xm, order):
    """Launch the K2 kernel on CUDA tensors."""
    _, NY, NX = stack.shape
    if not 0 <= order <= 3:
        raise ValueError(f"unsupported order {order}")
    N = ym.shape[0]
    dt = stack.dtype
    cuda_lib.require(stack, "stack", dtype=dt, shape=(5, NY, NX))
    cuda_lib.require(ym, "ym", dtype=dt, shape=(N,), device=stack.device)
    cuda_lib.require(xm, "xm", dtype=dt, shape=(N,), device=stack.device)
    out = torch.empty((6, N), dtype=dt, device=stack.device)
    if N == 0:
        return out
    fn = cuda_lib.library().fn("hipace_gather_main", dt)
    cuda_lib.check(fn(out.data_ptr(), stack.data_ptr(), ym.data_ptr(),
                      xm.data_ptr(), N, NY, NX, order,
                      cuda_lib.stream_ptr(stack)), "gather_main")
    gather_main.launches += 1
    return out


def gather_main(stack, ym, xm, order):
    """(exmby_raw, eypbx_raw, ez, bx, by, bz) as a (6, N) tensor."""
    if cuda_lib.use_kernel(stack):
        return gather_main_cuda(stack, ym, xm, order)
    return gather_main_plain(stack, ym, xm, order)


gather_main.launches = 0
