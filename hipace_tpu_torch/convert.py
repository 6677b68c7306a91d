"""Carry a hipace_tpu simulation's state into a hipace_tpu_torch one.

The two packages draw their random beams from different generators
(jax.random and torch.Generator), so a parity run builds both simulations
from the same deck and moves the JAX package's state across: the binned
beam, dt and time, with a laser its envelope stream (two complex numpy
arrays), under adaptive dt the |min uz m/q| its phase-advance control reads,
given as numpy arrays and floats (this module never imports jax). Both then compute the same time step from the same inputs.
The configs' derived constants (beam total charge, geometry, constants)
come from the shared deck parser and are checked, not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.multigrid import complex_dtype
from .particles.beam import ALL_ATTRS, BEAM_INT_ATTRS


def carry_state(sim, binned: dict, dt: float, time: float,
                total_charges=None, laser_stream=None,
                min_uz_mq=None) -> None:
    """Load `binned` ((nz, cap) numpy arrays keyed like the JAX package's
    ``Simulation.binned``, every beam's lanes with their beam_id and spin),
    dt and time into the port Simulation `sim`. total_charges, when given,
    holds one total charge per beam in deck order, which must match the
    port's beam configs. laser_stream: the JAX package's
    ``Simulation.laser_stream``, (n00, nm1) complex (nz, NY, NX) arrays;
    min_uz_mq: its ``_min_uz_mq``."""
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
    if total_charges is not None:
        ours = [b.total_charge for b in sim.beam_cfgs]
        if len(ours) != len(total_charges) or not np.allclose(
                ours, total_charges, rtol=1e-12, atol=0.0):
            raise ValueError(f"beam total charges {ours} differ from the "
                             f"carried {list(total_charges)}")
    sim.binned = out
    sim.beam_cap = out["x"].shape[1]
    sim.dt = float(dt)
    sim.time = float(time)
    if laser_stream is not None:
        shape = (nz,) + sim.laser_geom.slice_shape
        stream = tuple(torch.as_tensor(np.asarray(a)).to(
            device=sim.device, dtype=complex_dtype(sim.dtype))
            for a in laser_stream)
        if any(tuple(a.shape) != shape for a in stream):
            raise ValueError(f"the laser stream must be two {shape} arrays")
        sim.laser_stream = stream
    if min_uz_mq is not None:
        sim.min_uz_mq = float(min_uz_mq)
