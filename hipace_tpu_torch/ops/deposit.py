"""K1: particle deposit onto slice arrays.

Port of the deposit contract of the Pallas kernel ``_deposit_kernel``
(``hipace_tpu/ops/pallas_banded.py:254-540``, entries ``pallas_deposit`` and
``pallas_deposit_blocks``), whose exact XLA counterpart is
``hipace_tpu/ops/deposit.py`` ``deposit_multi``:

    F[c, iy, ix] += sum_p v[c, p] * Wy_c(ym_p - iy) * Wx_c(xm_p - ix)

ym/xm are guard-offset cell positions ((pos - pos_offset) / d + G); lanes
with ym >= 1.5 * NY are dead (callers put invalid particles at the sentinel
2 * NY). Channels come in blocks (ykind, xkind, count) with kinds "w" (the
order-p shape) or "dw" (the derivative factor of deriv_type). Taps outside
the grid are dropped.

``deposit`` adds into `fields` in place and returns it: CPU tensors take
``deposit_plain`` (exact index_add_ scatter), CUDA tensors launch the
hand-written kernel ``csrc/deposit.cu``, in which a block stages and bins
its lanes in shared memory, sums every touched cell in registers and adds
it to global memory once. A caller whose lanes are
in lattice order (lane p started at lattice cell (p // W, p % W), as the
plasma's are) passes W as `lattice_width`: blocks then take 2-D patches of
the lattice, whose stencils stay compact. It is a hint about locality only;
any value gives the same sums. A block whose stencil origins do not fit its
32 x 32 box deposits straight to global memory inside the same kernel;
``deposit.blocks`` and ``direct_block_count`` say how many did.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .shape import DW_KIND, W_KIND, ntaps, stencil_i0, wfun

LIVE_FRACTION = 1.5   # lanes with ym >= LIVE_FRACTION * NY are dead
# the kernel's block: a 16 x 16 lattice patch or 256 consecutive lanes
PATCH = 16
# per device: the kernel's count of blocks that took the direct path
_DIRECT_BLOCKS: dict = {}


def _blocks(blocks, C, order, deriv_type):
    blocks = ((W_KIND, W_KIND, C),) if blocks is None else tuple(blocks)
    if sum(n for _, _, n in blocks) != C:
        raise ValueError(f"blocks {blocks} do not cover {C} channels")
    for yk, xk, _ in blocks:
        if yk not in (W_KIND, DW_KIND) or xk not in (W_KIND, DW_KIND):
            raise ValueError(f"unknown weight kinds ({yk}, {xk})")
        if DW_KIND in (yk, xk) and (deriv_type < 0 or deriv_type + order
                                    < 1):
            raise ValueError(f"no derivative factor for order {order}, "
                             f"deriv_type {deriv_type}")
    return blocks


def deposit_plain(fields, ym, xm, values, order, deriv_type=-1, blocks=None):
    """Plain PyTorch deposit (any device): an exact index_add_ scatter with
    the kernel's weights and product order, (v * wy) * wx."""
    C, NY, NX = fields.shape
    blocks = _blocks(blocks, C, order, deriv_type)
    live = ym < LIVE_FRACTION * NY
    ym, xm, values = ym[live], xm[live], values[:, live]
    m = ntaps(order, deriv_type)
    offs = torch.arange(m, device=ym.device)
    iy = stencil_i0(ym, order, deriv_type)[:, None] + offs      # (N, m)
    ix = stencil_i0(xm, order, deriv_type)[:, None] + offs
    uy = ym[:, None] - iy.to(ym.dtype)
    ux = xm[:, None] - ix.to(xm.dtype)
    oky = ((iy >= 0) & (iy < NY)).to(ym.dtype)
    okx = ((ix >= 0) & (ix < NX)).to(xm.dtype)
    lin = (iy.clamp(0, NY - 1)[:, :, None] * NX
           + ix.clamp(0, NX - 1)[:, None, :]).reshape(-1)
    flat = fields.view(C, NY * NX)
    c = 0
    for yk, xk, n in blocks:
        wy = wfun(uy, order, deriv_type, yk) * oky
        wx = wfun(ux, order, deriv_type, xk) * okx
        for ci in range(c, c + n):
            w = (values[ci][:, None, None] * wy[:, :, None]) * wx[:, None, :]
            flat[ci].index_add_(0, lin, w.reshape(-1))
        c += n
    return fields


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _direct_counter(device) -> torch.Tensor:
    device = torch.device(device)
    if device.index is None:      # "cuda" is the current card
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _DIRECT_BLOCKS:
        _DIRECT_BLOCKS[device] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
    return _DIRECT_BLOCKS[device]


def direct_block_count(device) -> int:
    """Blocks that deposited straight to global memory on `device` since
    ``reset_block_counts`` (reads the kernel's device counter)."""
    return int(_direct_counter(device))


def reset_block_counts() -> None:
    deposit.blocks = 0
    for counter in _DIRECT_BLOCKS.values():
        counter.zero_()


def deposit_cuda(fields, ym, xm, values, order, deriv_type=-1, blocks=None,
                 lattice_width=None):
    """Launch the K1 kernel on CUDA tensors."""
    C, NY, NX = fields.shape
    blocks = _blocks(blocks, C, order, deriv_type)
    if C > 32:
        raise ValueError("the deposit kernel takes at most 32 channels")
    if not 0 <= order <= 3 or deriv_type not in (-1, 0, 1, 2):
        raise ValueError(f"unsupported order {order} / deriv_type "
                         f"{deriv_type}")
    N = ym.shape[0]
    dt = fields.dtype
    cuda_lib.require(fields, "fields", dtype=dt)
    cuda_lib.require(ym, "ym", dtype=dt, shape=(N,), device=fields.device)
    cuda_lib.require(xm, "xm", dtype=dt, shape=(N,), device=fields.device)
    cuda_lib.require(values, "values", dtype=dt, shape=(C, N),
                     device=fields.device)
    ymask = xmask = 0
    c = 0
    for yk, xk, n in blocks:
        for ci in range(c, c + n):
            ymask |= (yk == DW_KIND) << ci
            xmask |= (xk == DW_KIND) << ci
        c += n
    if N == 0:
        return fields
    lattice_w = int(lattice_width or 0)
    if lattice_w < 0:
        raise ValueError(f"lattice_width {lattice_width} is negative")
    if lattice_w:
        grid = (_ceil_div(_ceil_div(N, lattice_w), PATCH)
                * _ceil_div(lattice_w, PATCH))
    else:
        grid = _ceil_div(N, PATCH * PATCH)
    fn = cuda_lib.library().fn("hipace_deposit", dt)
    cuda_lib.launch(fn, fields, fields.data_ptr(), ym.data_ptr(),
                    xm.data_ptr(), values.data_ptr(), C, N, NY, NX, order,
                    deriv_type, ymask, xmask, lattice_w, grid,
                    _direct_counter(fields.device).data_ptr(),
                    cuda_lib.stream_ptr(fields), what="deposit")
    deposit.launches += 1
    deposit.blocks += grid
    return fields


def deposit(fields, ym, xm, values, order, deriv_type=-1, blocks=None,
            lattice_width=None):
    """Add the (C, N) channel values into fields (C, NY, NX) in place."""
    if cuda_lib.use_kernel(fields):
        return deposit_cuda(fields, ym, xm, values, order, deriv_type, blocks,
                            lattice_width)
    return deposit_plain(fields, ym, xm, values, order, deriv_type, blocks)


deposit.launches = 0
deposit.blocks = 0
