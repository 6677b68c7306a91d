"""Decks the port carries.

``BLOWOUT_WAKE`` is the repository's flagship case, the deck of
``__graft_entry__._DECK``: a blowout wake driven by a fixed_weight gaussian
beam through a 1 ppc electron plasma, with the explicit Bx/By solver. It is
kept here so that a run of the port needs nothing of the JAX package's
entry points; a test holds the two equal.
"""

from __future__ import annotations

from .parser import Inputs

BLOWOUT_WAKE = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = {npart}
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.41
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def blowout_wake(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """The flagship deck on an nxy^2 x nz grid with an npart-particle beam,
    followed by the deck lines in `extra`."""
    return Inputs(BLOWOUT_WAKE.format(nxy=nxy, nz=nz, npart=npart) + extra)
