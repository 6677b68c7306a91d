"""The benchmark's frozen arithmetic: the card's peaks, the least time of a
kernel call from its shapes, the grouping of device activities by name, and
the reference's push and cell counts.

Frozen copies, so that a change to the program cannot move the yardstick:

- ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound`` and the byte and operation
  counts of K1 and K3 from ``chip_smoke.py`` (``bound``, ``k1_phase``,
  ``k3_phase``): each input read once and each output written once;
- ``GROUPS`` and ``group_of`` from ``tools/profile_torch_step.py``;
- ``push_counts`` from ``hipace_tpu_torch/bench.py`` (ref
  Hipace.cpp:509-553).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, non-tensor FLOP/s by itemsize;
# the rates of a card at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}

# first match wins: (group, substrings of the device activity's name)
GROUPS = [
    ("K1 deposit", ("hipace::deposit_kernel",)),
    ("K2 gather", ("hipace::gather_main_kernel",)),
    ("K3 multigrid, complex (laser)", ("MgParams<float, true>",
                                       "MgParams<double, true>")),
    ("K3 multigrid", ("hipace::mg_solve_kernel",)),
    ("FFT (DST)", ("fft", "FFT")),
    ("GEMM (open-boundary moments, MR couplers)", ("gemm", "Gemm",
                                                   "cutlass", "xmma")),
    ("cat / copy / memcpy / memset", ("Cat", "copy", "Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel",)),
]
K1_NAME = "hipace::deposit_kernel"
K3_NAME = "hipace::mg_solve_kernel"
DTOH = "Memcpy DtoH"


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over the FLOP peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[itemsize])


def k1_counts(C: int, lanes: int, NY: int, NX: int, itemsize: int,
              live: int | None = None) -> tuple:
    """(bytes, operations) of one K1 deposit of C channels from `lanes`
    lanes onto a (C, NY, NX) stack: each lane's two positions and C values
    read, the stack read and written; per live lane and channel 3 x 3
    nonzero taps of a multiply and an add. live: the lanes that deposit
    (all of them where not given)."""
    live = lanes if live is None else live
    nbytes = itemsize * ((2 + C) * lanes + 2 * C * NY * NX)
    return nbytes, 2 * 9 * C * live


def mg_level_shapes(nx: int, ny: int) -> list:
    """The node-centered multigrid's levels (ny, nx), finest first."""
    shapes = [(ny, nx)]
    while True:
        n_y, n_x = shapes[-1]
        if ((n_x - 1) % 2 or (n_y - 1) % 2 or (n_x - 1) // 2 < 3
                or (n_y - 1) // 2 < 3):
            return shapes
        shapes.append(((n_y - 1) // 2, (n_x - 1) // 2))


def k3_counts(C: int, nx: int, ny: int, cycles: int, itemsize: int) -> tuple:
    """(bytes, operations) of one K3 solve of C channels with a 2-D
    a-coefficient: u0, rhs and acf in, u out; per V-cycle and cell of every
    level the sweeps (7 operations each), the residual (9), the transfers
    (~5)."""
    cells = sum(h * w for h, w in mg_level_shapes(nx, ny))
    return itemsize * (3 * C + 1) * ny * nx, cycles * C * cells * (7 * 4 + 9
                                                                      + 5)


def push_counts(nx: int, ny: int, ppc: int, npart: int, beam_subcycles: int,
                n_slices: int, steps: int) -> dict:
    """Plasma pushes, beam pushes (subcycles counted) and cell updates of
    `steps` steps of n_slices slices in all."""
    return {"plasma_pushes": nx * ny * ppc * n_slices,
            "beam_pushes": npart * beam_subcycles * steps,
            "cells": nx * ny * n_slices}
