"""Deck keys that select parts of hipace_tpu the port does not have yet.

Each raises NotImplementedError at configuration time, naming the item of
the port queue in ROADMAP.md that brings it, so a deck never silently runs
something other than what it asks for. The TPU tuning keys of the JAX
package (hipace.use_banded, banded_*, pallas_*, beam_pallas_*, beam_chunk,
beam_buckets) select no physics and are accepted as no-ops.
"""

from __future__ import annotations

from hipace_tpu.parser import Inputs

PDF_BEAM = "fixed_weight_pdf beam and the transverse-benchmark deck"
PC_AND_OPEN = "predictor-corrector Bx/By solver and open boundaries"
DIAGNOSTICS = "diagnostics and openPMD output"
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
    if q("hipace.bxby_solver", "explicit", str) != "explicit":
        fail("hipace.bxby_solver", PC_AND_OPEN)
    if q("boundary.field", "Dirichlet", str).lower() != "dirichlet":
        fail("boundary.field", PC_AND_OPEN)
    if q("fields.poisson_solver", "FFTDirichletFast", str) not in (
            "FFTDirichletFast", "FFTDirichletExpanded", "FFTDirichletDirect"):
        fail("fields.poisson_solver", OTHER_PATHS)
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
    if q("hipace.depos_derivative_type", 2, int) != 2:
        fail("hipace.depos_derivative_type", OTHER_PATHS)
    for key in ("fields.do_symmetrize", "hipace.do_beam_jz_minus_rho",
                "grid_current.use_grid_current"):
        if q(key, False, bool):
            fail(key, OTHER_PATHS)
    if q("hipace.plasma_pusher", "leapfrog", str) != "leapfrog":
        fail("hipace.plasma_pusher", OTHER_PATHS)
    period = q("diagnostic.output_period", -1, int)
    for key, default in (("diagnostic.output_period", -1),
                         ("diagnostic.beam_output_period", period)):
        if q(key, default, int) != 0:
            fail(key, DIAGNOSTICS)
    for key in ("hipace.deposit_rho", "hipace.deposit_rho_individual"):
        if q(key, False, bool):
            fail(key, DIAGNOSTICS)
    insitu = ["beams.insitu_period", "plasmas.insitu_period",
              "fields.insitu_period"]
    insitu += [f"{n}.insitu_period" for n in
               _names(inputs, "beams.names", "no_beam")
               + _names(inputs, "plasmas.names", "no_plasma")]
    for key in insitu:
        if q(key, 0, int):
            fail(key, DIAGNOSTICS)
