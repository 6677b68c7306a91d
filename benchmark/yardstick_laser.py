"""The benchmark's frozen arithmetic of the laser envelope's kernel: which
launches of K3 are its complex path, and the least time of one complex
solve from its shapes.

Frozen copies, so that a change to the program cannot move the yardstick:
the complex bound of ``chip_smoke.py`` (29.303 MB for one V-cycle at 1023^2
in float32: u0, rhs and u, two planes each, the acf's real plane and its
imaginary scalar, each read or written once) and K3's operation count
(``yardstick.k3_counts``), the envelope's real and imaginary planes
counted as K3's two channels.
"""

from __future__ import annotations

from . import yardstick as ys

# the template argument of K3's complex instances (CX = true)
K3_COMPLEX = ("MgParams<float, true>", "MgParams<double, true>")


def is_k3_complex(name: str) -> bool:
    return ys.K3_NAME in name and any(k in name for k in K3_COMPLEX)


def k3_complex_counts(nx: int, ny: int, cycles: int, itemsize: int) -> tuple:
    """(bytes, operations) of one complex K3 solve on an (ny, nx)
    node-centered grid: u0, rhs and u as two planes each and the acf's
    real plane, plus its imaginary scalar; per V-cycle and cell of every
    level K3's count for two channels."""
    cells = sum(h * w for h, w in ys.mg_level_shapes(nx, ny))
    return itemsize * (7 * ny * nx + 1), cycles * 2 * cells * (7 * 4 + 9 + 5)
