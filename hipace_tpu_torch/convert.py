"""Carry a hipace_tpu simulation's state into a hipace_tpu_torch one.

The two packages draw their random beams from different generators
(jax.random and torch.Generator), so a parity run builds both simulations
from the same deck and moves the JAX package's state across: the binned
beam, dt and time, given as numpy arrays and floats (this module never
imports jax). Both then compute the same time step from the same inputs.
The configs' derived constants (beam total charge, geometry, constants)
come from the shared deck parser and are checked, not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .particles.beam import ALL_ATTRS, BEAM_INT_ATTRS


def carry_state(sim, binned: dict, dt: float, time: float,
                total_charge: float | None = None) -> None:
    """Load `binned` ((nz, cap) numpy arrays keyed like the JAX package's
    ``Simulation.binned``), dt and time into the port Simulation `sim`.
    total_charge, when given, must match the port's beam config."""
    nz = sim.geom.nz
    out = {}
    for k in ALL_ATTRS:
        a = np.array(binned[k])
        if a.ndim != 2 or a.shape[0] != nz:
            raise ValueError(f"binned[{k!r}] has shape {a.shape}, expected "
                             f"({nz}, cap)")
        dtype = (torch.int32 if k in BEAM_INT_ATTRS
                 else torch.bool if k == "valid" else sim.dtype)
        out[k] = torch.as_tensor(a).to(device=sim.device, dtype=dtype)
    out["n_dropped"] = int(np.asarray(binned.get("n_dropped", 0)))
    if total_charge is not None and sim.beam_cfgs and not np.isclose(
            sim.beam_cfgs[0].total_charge, total_charge, rtol=1e-12):
        raise ValueError(f"beam total charge {sim.beam_cfgs[0].total_charge}"
                         f" differs from the carried {total_charge}")
    sim.binned = out
    sim.beam_cap = out["x"].shape[1]
    sim.dt = float(dt)
    sim.time = float(time)
