"""Deck keys that select parts of hipace_tpu the port does not have yet.

Each raises NotImplementedError at configuration time, naming the item of
the port queue in ROADMAP.md that brings it, so a deck never silently runs
something other than what it asks for. The TPU tuning keys of the JAX
package (hipace.use_banded, banded_*, pallas_*, beam_pallas_*, beam_chunk,
beam_buckets) select no physics and are accepted as no-ops.
"""

from __future__ import annotations

from .parser import Inputs

OTHER_PATHS = "other beam and plasma paths"
LASER = "laser"
IONIZATION = "ionization"
COLLISIONS = "collisions"
SALAME = "SALAME"
MR = "mesh refinement"


def fail(key: str, item: str):
    raise NotImplementedError(
        f"{key}: {item} is not ported to hipace_tpu_torch yet "
        f"(ROADMAP.md port queue, item '{item}')")


def _names(inputs: Inputs, key: str, none: str) -> list:
    names = inputs.query_list(key, [], str)
    return [] if names == [none] else names


def check_deck(inputs: Inputs) -> None:
    """Raise for the first deck key that leaves the ported main path. The
    per-species keys are checked by the plasma and beam configs."""
    q = inputs.query
    explicit = q("hipace.bxby_solver", "explicit", str) == "explicit"
    poisson = q("fields.poisson_solver", "FFTDirichletFast", str)
    if _names(inputs, "lasers.names", "no_laser"):
        fail("lasers.names", LASER)
    if q("amr.max_level", 0, int) > 0:
        fail("amr.max_level", MR)
    if q("hipace.collisions", "", str):
        fail("hipace.collisions", COLLISIONS)
    if len(_names(inputs, "plasmas.names", "no_plasma")) > 1:
        fail("plasmas.names", OTHER_PATHS)
    if len(_names(inputs, "beams.names", "no_beam")) > 1:
        fail("beams.names", OTHER_PATHS)
    if inputs.raw("hipace.dt", "") == "adaptive":
        fail("hipace.dt", OTHER_PATHS)
    if inputs.contains("hipace.max_time"):
        fail("hipace.max_time", OTHER_PATHS)
    # the multigrid (the explicit solver's Bx/By, MGDirichlet) is
    # node-centered: odd sizes
    nx, ny = inputs.query_list("amr.n_cell", [1, 1, 1], int)[:2]
    if (nx % 2 == 0 or ny % 2 == 0) and (explicit or poisson == "MGDirichlet"):
        fail(f"amr.n_cell = {nx} {ny}: an even transverse size with a "
             "multigrid", OTHER_PATHS)
    if q("hipace.depos_derivative_type", 2, int) != 2:
        fail("hipace.depos_derivative_type", OTHER_PATHS)
    if q("grid_current.use_grid_current", False, bool):
        fail("grid_current.use_grid_current", OTHER_PATHS)
    if q("hipace.plasma_pusher", "leapfrog", str) != "leapfrog":
        fail("hipace.plasma_pusher", OTHER_PATHS)
