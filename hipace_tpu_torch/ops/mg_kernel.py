"""K3: the multigrid Bx/By solve on the hand-written kernels.

Port of the Pallas kernel ``_mg_kernel`` / ``FusedMG.solve``
(``hipace_tpu/ops/pallas_mg.py:62-249``), held to the XLA path of
``MultiGrid.solve`` (exact stencils, no reduced-precision transfers). The
plain version is ``MultiGrid.solve_plain`` in ``fields/multigrid.py``;
``MultiGrid.solve`` sends CUDA tensors here.

A block's 227 KB of shared memory cannot hold the 1023^2 ladder, so this is
a host-driven V-cycle over the kernels of ``csrc/multigrid.cu``: one
launch per red-black colour, residual, stencil restriction and prolong-add
on the fine levels, and one single-block shared-memory kernel for every
level from the first one of at most COARSE_CELLS cells down. The per-level
invd = 1/(diag - acf) and dma = diag - acf are torch set-up (as in
``FusedMG.solve``); the acf coarsening runs on the restriction kernel. The
max-norm residual is read back once per V-cycle for the convergence test.

``mg_solve.launches`` counts solves, not kernel launches: a V-cycle
launches 11 kernels per fine level, the coarse kernel, and the residual
and max-abs kernels of the convergence test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from ..fields.multigrid import COARSE_SWEEPS, convergence_target

COARSE_CELLS = 1024      # levels of at most this many cells run in one block
MAX_SMEM = 227 * 1024


def _coarse_start(shapes) -> int:
    for lev, (ny, nx) in enumerate(shapes):
        if ny * nx <= COARSE_CELLS:
            return lev
    return len(shapes) - 1


def mg_solve(mg, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
             nu1=2, nu2=2):
    """Solve Laplacian(u) - acf*u = rhs from u0 on CUDA tensors.

    u0, rhs: (C, ny, nx) or (ny, nx); acf: (ny, nx) tensor or a scalar.
    Returns a new tensor; mg.last_cycles holds the V-cycle count."""
    squeeze = u0.ndim == 2
    if squeeze:
        u0, rhs = u0[None], rhs[None]
    C, ny, nx = u0.shape
    if (ny, nx) != mg.shapes[0]:
        raise ValueError(f"grid {(ny, nx)} does not match the multigrid "
                         f"{mg.shapes[0]}")
    dt, dev = u0.dtype, u0.device
    cuda_lib.require(u0, "u0", dtype=dt)
    rhs = rhs.contiguous()
    cuda_lib.require(rhs, "rhs", dtype=dt, shape=(C, ny, nx), device=dev)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_ptr(u0)
    L = mg.nlevels
    shapes = mg.shapes

    def call(name, *args):
        cuda_lib.check(lib.fn(name, dt)(*args, stream), name)

    # per-level coefficients
    if torch.is_tensor(acf) and acf.ndim == 2:
        acf0 = acf.to(dtype=dt).contiguous()
        cuda_lib.require(acf0, "acf", shape=(ny, nx), device=dev)
    else:
        acf0 = torch.full((ny, nx), float(acf), dtype=dt, device=dev)
    acfs = [acf0]
    for lev in range(1, L):
        a = torch.empty(shapes[lev], dtype=dt, device=dev)
        call("hipace_mg_restrict", a.data_ptr(), None, acfs[-1].data_ptr(),
             1, *shapes[lev - 1])
        acfs.append(a)
    dma = [mg.diags[lev] - acfs[lev] for lev in range(L)]
    invd = [1.0 / (mg.diags[lev] - acfs[lev]) for lev in range(L)]

    Lc = _coarse_start(shapes)
    u = [u0.clone()] + [torch.empty((C,) + shapes[lev], dtype=dt,
                                    device=dev) for lev in range(1, Lc + 1)]
    r = [rhs] + [torch.empty((C,) + shapes[lev], dtype=dt, device=dev)
                 for lev in range(1, Lc + 1)]
    res = torch.empty((C, ny, nx), dtype=dt, device=dev)
    bits = torch.empty(1, dtype={torch.float32: torch.int32,
                                 torch.float64: torch.int64}[dt], device=dev)

    itemsize = torch.empty((), dtype=dt).element_size()
    smem = C * itemsize * (2 * sum(shapes[lev][0] * shapes[lev][1]
                                   for lev in range(Lc, L))
                           + shapes[Lc][0] * shapes[Lc][1])
    if smem > MAX_SMEM:
        raise ValueError(f"coarse levels of {shapes} need {smem} B of "
                         "shared memory")
    lv_ny = np.array([s[0] for s in shapes], np.int32)
    lv_nx = np.array([s[1] for s in shapes], np.int32)
    lv_fx = np.array([f[0] for f in mg.facs], np.float64)
    lv_fy = np.array([f[1] for f in mg.facs], np.float64)
    lv_invd = np.array([t.data_ptr() for t in invd], np.uint64)
    lv_dma = np.array([t.data_ptr() for t in dma], np.uint64)

    def norm(x):
        call("hipace_mg_maxabs", bits.data_ptr(), x.data_ptr(), x.numel())
        return float(bits.view(dt).item())

    def resnorm():
        fx, fy = mg.facs[0]
        call("hipace_mg_residual", res.data_ptr(), u[0].data_ptr(),
             r[0].data_ptr(), dma[0].data_ptr(), C, ny, nx, fx, fy)
        return norm(res)

    def smooth(lev, sweeps):
        fx, fy = mg.facs[lev]
        for _ in range(sweeps):
            for color in (0, 1):
                call("hipace_mg_smooth", u[lev].data_ptr(), r[lev].data_ptr(),
                     invd[lev].data_ptr(), C, *shapes[lev], fx, fy, color)

    def vcycle():
        for lev in range(Lc):
            fx, fy = mg.facs[lev]
            smooth(lev, nu1)
            call("hipace_mg_residual", res.data_ptr(), u[lev].data_ptr(),
                 r[lev].data_ptr(), dma[lev].data_ptr(), C, *shapes[lev],
                 fx, fy)
            call("hipace_mg_restrict", r[lev + 1].data_ptr(),
                 u[lev + 1].data_ptr(), res.data_ptr(), C, *shapes[lev])
        call("hipace_mg_coarse", u[Lc].data_ptr(), r[Lc].data_ptr(), C, Lc,
             L, lv_ny.ctypes.data, lv_nx.ctypes.data, lv_fx.ctypes.data,
             lv_fy.ctypes.data, lv_invd.ctypes.data, lv_dma.ctypes.data,
             nu1, nu2, COARSE_SWEEPS, smem)
        for lev in range(Lc - 1, -1, -1):
            call("hipace_mg_prolong_add", u[lev].data_ptr(),
                 u[lev + 1].data_ptr(), C, *shapes[lev])
            smooth(lev, nu2)

    current = resnorm()
    target = convergence_target(current, norm(r[0]), tol_rel, tol_abs, dt)
    it = 0
    while current > target and it < max_iters:
        vcycle()
        current = resnorm()
        it += 1
    mg.last_cycles = it
    mg_solve.launches += 1
    return u[0][0] if squeeze else u[0]


mg_solve.launches = 0
