"""K2: fused main-fields gather onto particles.

Port of the gather contract of the Pallas kernel ``_gather_main_kernel``
(``hipace_tpu/ops/pallas_banded.py:546-748``, entry ``pallas_gather_main``),
whose exact XLA counterpart is ``hipace_tpu/ops/gather.py``
``gather_main_fields`` (ref FieldGather.H:45-97). From the five field planes
[Psi, Ez, Bx, By, Bz] and nodal (deriv_type 1) order-p weights, per
particle: the raw Psi derivatives sum(Wy dWx Psi) and sum(dWy Wx Psi),
which the caller scales by 1/dx and 1/dy into ExmBy and EypBx, and Ez, Bx,
By, Bz interpolated with Wy Wx. Positions and dead lanes follow the
deposit's convention (``ops/deposit.py``); dead lanes read 0 and taps
outside the grid are dropped.

The planes come either as a (5, NY, NX) tensor, the JAX package's layout,
or as a sequence of five (NY, NX) tensors, which the kernel reads where
they lie. ``gather_main`` returns a (6, N) tensor: CPU tensors take
``gather_main_plain``, CUDA tensors launch ``csrc/gather.cu``.

``gather_laser_aabs``, the laser's |a|^2 and its centred derivatives at the
plasma's lanes, is plain PyTorch on any device: the JAX package runs it on
XLA, not in a Pallas kernel. On the card the fused plasma push and the
plasma deposit's values kernel compute the same inline
(``csrc/laser_gather.cuh``); this one is their plain versions' gather, run
on the CPU and by the predictor-corrector's deposit.
"""

from __future__ import annotations

import collections
import threading

import torch

from . import cuda_lib
from .deposit import LIVE_FRACTION
from .shape import shape_weights, shape_weights_derivative

PLANE_NAMES = ("Psi", "Ez", "Bx", "By", "Bz")


def as_planes(planes) -> tuple:
    """The five (NY, NX) planes of a (5, NY, NX) tensor or of a sequence of
    five tensors of one shape, dtype and device."""
    if torch.is_tensor(planes):
        if planes.dim() != 3 or planes.shape[0] != 5:
            raise ValueError(f"a plane stack must be (5, NY, NX), got "
                             f"{tuple(planes.shape)}")
        return tuple(planes.unbind(0))
    planes = tuple(planes)
    if len(planes) != 5:
        raise ValueError(f"expected five planes, got {len(planes)}")
    first = planes[0]
    for name, plane in zip(PLANE_NAMES, planes):
        if (plane.dim() != 2 or plane.shape != first.shape
                or plane.dtype != first.dtype
                or plane.device != first.device):
            raise ValueError(f"plane {name} is {tuple(plane.shape)} "
                             f"{plane.dtype} on {plane.device}; Psi is "
                             f"{tuple(first.shape)} {first.dtype} on "
                             f"{first.device}")
    return planes


def _stencils(ym, xm, order, NY, NX):
    """The lanes' stencils: (live, the tap weights of the two raw Psi
    derivatives and of the interpolation, each (N, m, m), the taps' flat
    cell indices (N, m, m)), from the order-p weights and nodal derivative
    factors with the taps outside the grid zeroed."""
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
           + ix.clamp(0, NX - 1)[:, None, :])
    return (live, wy[:, :, None] * dwx[:, None, :],
            dwy[:, :, None] * wx[:, None, :], wy[:, :, None] * wx[:, None, :],
            lin)


# the stencils of the last few CPU calls of at most _CPU_TAPS taps, by their
# positions (a reused entry equals what it replaces: a cache, whose state
# changes no result): the predictor-corrector's trial pushes gather again and
# again at the same positions, a fine level's between the coarse level's
_CPU_STENCILS: collections.deque = collections.deque(maxlen=4)
_CPU_TAPS = 2 ** 20
_CPU_LOCK = threading.Lock()


def gather_main_plain(planes, ym, xm, order):
    """Plain PyTorch gather (any device), exact elementwise reads. On the
    CPU a call at the positions of one of the last few reuses its stencils
    (where they are small)."""
    planes = as_planes(planes)
    NY, NX = planes[0].shape
    cpu = (ym.device.type == "cpu"
           and ym.numel() * (order + 2) ** 2 <= _CPU_TAPS)
    key = (order, NY, NX, ym.dtype, ym.shape)
    st = None
    if cpu:
        with _CPU_LOCK:
            entries = list(_CPU_STENCILS)
        st = next((e[3] for e in entries if e[0] == key
                   and torch.equal(e[1], ym) and torch.equal(e[2], xm)),
                  None)
    if st is None:
        st = _stencils(ym, xm, order, NY, NX)
        if cpu:
            with _CPU_LOCK:
                _CPU_STENCILS.appendleft((key, ym.clone(), xm.clone(), st))
    live, wdx, wdy, w, lin = st
    # index_select reads what plane[lin] reads, faster on the CPU
    flat = lin.reshape(-1)
    vals = [plane.reshape(NY * NX).index_select(0, flat).view(lin.shape)
            for plane in planes]                                   # (N, m, m)
    out = torch.stack([(wdx * vals[0]).sum(dim=(1, 2)),
                       (wdy * vals[0]).sum(dim=(1, 2))]
                      + [(w * vals[c]).sum(dim=(1, 2)) for c in range(1, 5)])
    return torch.where(live, out, torch.zeros_like(out))


def plane_pointers(planes):
    """(data pointers of the five planes, NY, NX, dtype, device) of a
    (5, NY, NX) CUDA stack or of five CUDA planes, each checked once."""
    if torch.is_tensor(planes):
        if planes.dim() != 3:
            raise ValueError(f"a plane stack must be (5, NY, NX), got "
                             f"{tuple(planes.shape)}")
        _, NY, NX = planes.shape
        cuda_lib.require(planes, "planes", shape=(5, NY, NX))
        step = NY * NX * planes.element_size()
        base = planes.data_ptr()
        return ([base + c * step for c in range(5)], NY, NX, planes.dtype,
                planes.device)
    planes = tuple(planes)
    if len(planes) != 5:
        raise ValueError(f"expected five planes, got {len(planes)}")
    first = planes[0]
    if first.dim() != 2:
        raise ValueError(f"plane Psi must be (NY, NX), got "
                         f"{tuple(first.shape)}")
    NY, NX = first.shape
    dt, device = first.dtype, first.device
    for name, plane in zip(PLANE_NAMES, planes):
        cuda_lib.require(plane, name, dtype=dt, shape=(NY, NX), device=device)
    return [p.data_ptr() for p in planes], NY, NX, dt, device


def gather_main_cuda(planes, ym, xm, order):
    """Launch the K2 kernel on CUDA tensors."""
    if not 0 <= order <= 3:
        raise ValueError(f"unsupported order {order}")
    ptrs, NY, NX, dt, device = plane_pointers(planes)
    N = ym.shape[0]
    cuda_lib.require(ym, "ym", dtype=dt, shape=(N,), device=device)
    cuda_lib.require(xm, "xm", dtype=dt, shape=(N,), device=device)
    out = torch.empty((6, N), dtype=dt, device=device)
    if N == 0:
        return out
    fn = cuda_lib.library().fn("hipace_gather_main", dt)
    cuda_lib.launch(fn, ym, out.data_ptr(), *ptrs, ym.data_ptr(),
                    xm.data_ptr(), N, NY, NX, order, cuda_lib.stream_ptr(ym),
                    what="gather_main")
    gather_main.launches += 1
    return out


def gather_main(planes, ym, xm, order):
    """(exmby_raw, eypbx_raw, ez, bx, by, bz) as a (6, N) tensor, from a
    (5, NY, NX) plane stack or a sequence of five (NY, NX) planes."""
    first = planes if torch.is_tensor(planes) else planes[0]
    if cuda_lib.use_kernel(first):
        return gather_main_cuda(planes, ym, xm, order)
    return gather_main_plain(planes, ym, xm, order)


gather_main.launches = 0


def gather_laser_aabs(xp, yp, aabs, geom, order):
    """|a|^2 and its centred derivatives at the particles (ref
    FieldGather.H:236-280 doLaserGatherShapeN; the JAX package's
    ``hipace_tpu/ops/gather.py`` ``gather_laser_aabs``, which runs on XLA):
    plain PyTorch on any device, no kernel. Each lane reads one
    (m+2) x (m+2) block of the padded (NY, NX) plane around its order-p
    stencil (m = p + 1 taps; rows clipped to the plane, the block's first
    column clipped so the block fits), and the value, d/dx and d/dy are the
    stencil's weighted sums of the block's centre and of its centred
    differences. Returns (a2, a2_dx, a2_dy), each (N,)."""
    G = geom.nguards
    NY, NX = aabs.shape
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    ix0, wx = shape_weights((xp - geom.x_pos_offset) * dx_inv, order)
    iy0, wy = shape_weights((yp - geom.y_pos_offset) * dy_inv, order)
    m = order + 1
    mb = m + 2
    offs = torch.arange(mb, device=xp.device)
    rows = (iy0[:, None] - 1 + G + offs).clamp(0, NY - 1)
    cols = (ix0 - 1 + G).clamp(0, NX - mb)[:, None] + offs
    block = aabs.reshape(NY * NX)[rows[:, :, None] * NX + cols[:, None, :]]
    w = wy[:, :, None] * wx[:, None, :]
    a00 = block[:, 1:m + 1, 1:m + 1]
    ap1 = block[:, 1:m + 1, 2:m + 2]
    am1 = block[:, 1:m + 1, 0:m]
    bp1 = block[:, 2:m + 2, 1:m + 1]
    bm1 = block[:, 0:m, 1:m + 1]
    a_v = (w * a00).sum(dim=(1, 2))
    adx = (w * 0.5 * dx_inv * (ap1 - am1)).sum(dim=(1, 2))
    ady = (w * 0.5 * dy_inv * (bp1 - bm1)).sum(dim=(1, 2))
    return a_v, adx, ady
