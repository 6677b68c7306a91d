"""Simulation geometry: 3D domain (x, y, zeta) with cell-centered slices.

The port's own copy of ``hipace_tpu/geometry.py:23-96`` (ref
Hipace.cpp:298-391 MakeGeometry): a static, hashable description. The
refined-level constructor stays behind with mesh refinement, which is not
ported. Cells are cell-centered:

    x_i = prob_lo_x + (i + 0.5) * dx      (i in [0, nx))

which matches GetPosOffset semantics of the reference (ref Fields.H:63-77).

Field slice arrays are stored as (ny + 2G, nx + 2G) with G ghost cells on
each transverse side; array index = cell index + G.
"""

from __future__ import annotations

import dataclasses

from .parser import Inputs


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static geometry of the grid. Frozen and hashable."""
    n_cell: tuple[int, int, int]          # (nx, ny, nz)
    prob_lo: tuple[float, float, float]
    prob_hi: tuple[float, float, float]
    nguards: int = 2                      # transverse ghost cells G
    is_periodic: tuple[bool, bool, bool] = (False, False, False)

    # ------------------------------------------------------------------
    @property
    def nx(self) -> int:
        return self.n_cell[0]

    @property
    def ny(self) -> int:
        return self.n_cell[1]

    @property
    def nz(self) -> int:
        return self.n_cell[2]

    def cell_size(self, d: int) -> float:
        return (self.prob_hi[d] - self.prob_lo[d]) / self.n_cell[d]

    @property
    def dx(self) -> float:
        return self.cell_size(0)

    @property
    def dy(self) -> float:
        return self.cell_size(1)

    @property
    def dz(self) -> float:
        return self.cell_size(2)

    def pos_offset(self, d: int) -> float:
        """x = i * dx + pos_offset(0);  i = round((x - pos_offset(0)) / dx)."""
        return self.prob_lo[d] + 0.5 * self.cell_size(d)

    @property
    def x_pos_offset(self) -> float:
        return self.pos_offset(0)

    @property
    def y_pos_offset(self) -> float:
        return self.pos_offset(1)

    @property
    def z_pos_offset(self) -> float:
        return self.pos_offset(2)

    # padded slice array shape (row=y, col=x)
    @property
    def slice_shape(self) -> tuple[int, int]:
        g = self.nguards
        return (self.ny + 2 * g, self.nx + 2 * g)

    def z_of_slice(self, islice) -> float:
        return self.z_pos_offset + islice * self.dz

    # ------------------------------------------------------------------
    @classmethod
    def from_inputs(cls, inputs: Inputs, depos_order_xy: int = 2) -> "Geometry":
        n_cell = tuple(inputs.get_list("amr.n_cell", int))
        prob_lo = tuple(inputs.get_list("geometry.prob_lo", float))
        prob_hi = tuple(inputs.get_list("geometry.prob_hi", float))
        # guard cells: (depos_order+1)/2 + 1, ref Fields.cpp:62-64
        g = (depos_order_xy + 1) // 2 + 1
        field_bc = inputs.query("boundary.field", "Dirichlet", str)
        per = field_bc.lower() == "periodic"
        return cls(n_cell=n_cell, prob_lo=prob_lo, prob_hi=prob_hi,
                   nguards=g, is_periodic=(per, per, False))
