"""K3: the multigrid solves (Bx/By, the laser envelope) on the hand-written
kernel.

Port of the Pallas kernel ``_mg_kernel`` / ``FusedMG.solve``
(``hipace_tpu/ops/pallas_mg.py:62-249``), held to the XLA path of
``MultiGrid.solve`` (exact stencils, no reduced-precision transfers), in
both grid conventions: node-centered (odd sizes, the Pallas kernel's) and
cell-centered (even sizes, which the JAX package solves on XLA only). The
plain version is ``MultiGrid.solve_plain`` in ``fields/multigrid.py``;
``MultiGrid.solve`` sends CUDA tensors here.

One solve is ONE cooperative launch of the persistent kernel of
``csrc/multigrid.cu``: the acf coarsening, the first norms, the stopping
threshold and the V-cycle loop all run on the device, and the V-cycle count
and the last residual norm come back as device scalars that nobody has to
read. This module only lays out the solve: it picks the first level Lc
whose ladder fits one block's shared memory (by dtype and channel count),
carves the per-level buffers out of one workspace (the layout is worked out
once per MultiGrid and kind of solve), and hands the kernel the table of
pointers. If the launch is refused, the call raises.

A complex solve (the laser envelope, hpmg solve2) runs the kernel's
complex instantiation on planar values: u0 and rhs, complex tensors, are
laid out as (C, 2, ny, nx) real planes (a copy each) and the solution comes
back complex. The acf becomes two planes (real, imaginary): from a complex
plane, or from a real plane plus a complex scalar, ``(plane, scalar)``,
spread on the device.

``mg_solve.launches`` counts real solves and ``mg_solve.complex_launches``
complex ones; ``mg_solve.kernel_launches`` counts the cooperative kernel of
every solve plus each argument the wrapper had to lay out: made contiguous
or of the working type, or, for a complex solve, split into planes (u0,
rhs, the acf) and the solution joined back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_lib
from ..fields.multigrid import COARSE_SWEEPS

TILE_DIM = 64               # the kernel's tile array, halo included
MAX_SMEM = 227 * 1024       # dynamic shared memory one block may have
# blocks per SM the kernel is built for, by itemsize (csrc/multigrid.cu)
BLOCKS_PER_SM = {4: 2, 8: 1}
# rows of the kernel's table of per-level pointers
TABLE_ROWS = {"A": 0, "B": 1, "rhs": 2, "acf": 3}


def plan(shapes, C: int, itemsize: int, nu1: int, nu2: int,
         cplx: bool = False):
    """(halo, Lc, shared-memory bytes) of a solve on `shapes`; a complex
    cell is two values.

    The halo covers one cell per colour half-sweep plus the reach of the
    residual and of the restriction (one cell node-centered, none
    cell-centered, where the halo stays the same so that tile origins stay
    even). Lc is the first level from which the
    whole ladder -- per level u and rhs (C planes each), dma and invd, plus
    one residual scratch of level Lc -- fits the block's share of the SM."""
    halo = 2 * max(nu1, nu2) + 2
    if TILE_DIM - 2 * halo < 16:
        raise ValueError(f"nu1={nu1}, nu2={nu2} leave no room in a "
                         f"{TILE_DIM}-cell tile")
    cellsize = itemsize * (2 if cplx else 1)
    # u, and the residual or the coarse tile
    tile = 2 * (TILE_DIM + 2) ** 2 * cellsize
    # 1 KB per resident block is the system's
    budget = max(tile, MAX_SMEM // BLOCKS_PER_SM[itemsize] - 1024)
    cells = [ny * nx for ny, nx in shapes]
    for lc in range(len(shapes)):
        coarse = cellsize * ((2 * C + 2) * sum(cells[lc:]) + C * cells[lc])
        if coarse <= budget:
            # the tile stages run only above level Lc
            return halo, lc, max(coarse, tile if lc else 0)
    raise ValueError(f"the coarsest level of {shapes} with {C} channels does "
                     "not fit one block's shared memory")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a solve's per-level buffers lie in its one workspace."""
    halo: int
    Lc: int
    smem: int
    total: int               # workspace elements
    offsets: np.ndarray      # (4, L) element offsets by TABLE_ROWS, -1: none
    ny: np.ndarray
    nx: np.ndarray
    facx: np.ndarray
    facy: np.ndarray


def _layout(mg, C, itemsize, nu1, nu2, scalar_acf, cplx=False) -> Layout:
    """The layout of this kind of solve, worked out once per MultiGrid: A
    (the down-leg's u) for l < Lc; B (the final u), rhs and acf for
    1 <= l <= Lc; acf[0] for a scalar acf. A complex level holds two planes
    per channel and two acf planes."""
    key = (C, itemsize, nu1, nu2, scalar_acf, cplx)
    if key not in mg.kernel_layouts:
        halo, Lc, smem = plan(mg.shapes, C, itemsize, nu1, nu2, cplx)
        npl = 2 if cplx else 1
        cells = [npl * ny * nx for ny, nx in mg.shapes]
        sizes = {("A", l): C * cells[l] for l in range(Lc)}
        for l in range(1, Lc + 1):
            sizes["B", l] = sizes["rhs", l] = C * cells[l]
            sizes["acf", l] = cells[l]
        if scalar_acf:
            sizes["acf", 0] = cells[0]
        offsets = np.full((4, mg.nlevels), -1, np.int64)
        total = 0
        for (name, l), n in sizes.items():
            offsets[TABLE_ROWS[name], l] = total
            total += n
        mg.kernel_layouts[key] = Layout(
            halo, Lc, smem, total, offsets,
            np.array([s[0] for s in mg.shapes], np.int32),
            np.array([s[1] for s in mg.shapes], np.int32),
            np.array([f[0] for f in mg.facs], np.float64),
            np.array([f[1] for f in mg.facs], np.float64))
    return mg.kernel_layouts[key]


def mg_solve(mg, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
             nu1=2, nu2=2):
    """Solve Laplacian(u) - acf*u = rhs from u0 on CUDA tensors.

    Real: u0, rhs (C, ny, nx) or (ny, nx); acf a (ny, nx) tensor or a
    scalar. Complex: u0, rhs complex (C, ny, nx) or (ny, nx); acf a
    complex (ny, nx) tensor, a complex scalar or (real plane, complex
    scalar).
    Returns (u, cycles, resnorm): a new tensor laid out as u0, and the
    V-cycle count (int32) and the last max-norm residual as 0-d device
    tensors."""
    cplx = torch.is_complex(u0)
    launched = 1
    if cplx:
        if not torch.is_complex(rhs):
            raise ValueError("a complex u0 needs a complex rhs")
        squeeze = u0.ndim == 2
        if squeeze:
            u0, rhs = u0[None], rhs[None]
        u0 = torch.stack([u0.real, u0.imag], dim=1)
        rhs = torch.stack([rhs.real, rhs.imag], dim=1)
        launched += 2
        C, _, ny, nx = u0.shape
        full = (C, 2, ny, nx)
    else:
        squeeze = u0.ndim == 2
        if squeeze:
            u0, rhs = u0[None], rhs[None]
        C, ny, nx = u0.shape
        full = (C, ny, nx)
    if (ny, nx) != mg.shapes[0]:
        raise ValueError(f"grid {(ny, nx)} does not match the multigrid "
                         f"{mg.shapes[0]}")
    if max_iters < 0:
        raise ValueError(f"max_iters {max_iters} is negative")
    dt, dev = u0.dtype, u0.device
    if not u0.is_contiguous():
        u0, launched = u0.contiguous(), launched + 1
    if not rhs.is_contiguous():
        rhs, launched = rhs.contiguous(), launched + 1
    cuda_lib.require(u0, "u0", dtype=dt)
    cuda_lib.require(rhs, "rhs", dtype=dt, shape=full, device=dev)
    acf_plane = None
    if cplx:
        # the two acf planes, spread and summed on the device
        from ..fields.multigrid import planar_acf
        acf_plane = planar_acf(acf, (ny, nx), dt, dev).contiguous()
        launched += 1
        cuda_lib.require(acf_plane, "acf", dtype=dt, shape=(2, ny, nx),
                         device=dev)
    elif torch.is_tensor(acf):
        if acf.ndim == 0:       # no readback: spread the 0-d value
            acf = acf.expand(ny, nx)
        if acf.dtype != dt or not acf.is_contiguous():
            launched += 1
        acf_plane = acf.to(dtype=dt).contiguous()
        cuda_lib.require(acf_plane, "acf", shape=(ny, nx), device=dev)

    itemsize = u0.element_size()
    lay = _layout(mg, C, itemsize, nu1, nu2, acf_plane is None, cplx)
    work = torch.empty(lay.total, dtype=dt, device=dev)
    u = torch.empty_like(u0)
    # the norm slots, then the V-cycle count and the last norm, 8 bytes each
    stats = torch.empty(max_iters + 4, dtype=torch.int64, device=dev)
    table = np.where(lay.offsets >= 0,
                     work.data_ptr() + lay.offsets * itemsize, 0)
    table[TABLE_ROWS["B"], 0] = u.data_ptr()
    table[TABLE_ROWS["rhs"], 0] = rhs.data_ptr()
    if acf_plane is not None:
        table[TABLE_ROWS["acf"], 0] = acf_plane.data_ptr()
    table = table.astype(np.uint64)
    cycles_at = stats.data_ptr() + 8 * (max_iters + 2)

    fn = cuda_lib.library().fn("hipace_mg_solve", dt)
    cuda_lib.launch(
        fn, u0, u0.data_ptr(), table.ctypes.data, lay.ny.ctypes.data,
        lay.nx.ctypes.data, lay.facx.ctypes.data, lay.facy.ctypes.data, C,
        mg.nlevels, lay.Lc, nu1, nu2, COARSE_SWEEPS, lay.halo, max_iters,
        tol_rel, tol_abs, int(acf_plane is None),
        0.0 if acf_plane is not None else float(acf), int(mg.cell_centered), int(cplx), stats.data_ptr(), cycles_at,
        cycles_at + 8, lay.smem, cuda_lib.stream_ptr(u0), what="mg_solve")
    cycles = stats[max_iters + 2:max_iters + 3].view(torch.int32)[0]
    resnorm = stats[max_iters + 3:].view(dt)[0]
    if cplx:
        mg_solve.complex_launches += 1
    else:
        mg_solve.launches += 1
    if cplx:
        u = torch.complex(u[:, 0], u[:, 1])
        launched += 1
    mg_solve.kernel_launches += launched
    return (u[0] if squeeze else u), cycles, resnorm


mg_solve.launches = 0
mg_solve.complex_launches = 0
mg_solve.kernel_launches = 0
