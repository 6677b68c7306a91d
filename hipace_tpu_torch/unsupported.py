"""Deck keys that select parts of hipace_tpu the port does not have yet.

Each raises NotImplementedError at configuration time, naming the item of
the port queue in ROADMAP.md that brings it (its number and title, ITEMS),
so a deck never silently runs something other than what it asks for. The
TPU tuning keys of the JAX package (hipace.use_banded, banded_*, pallas_*,
beam_pallas_*, beam_chunk, beam_buckets) select no physics and are accepted
as no-ops.
"""

from __future__ import annotations

from .parser import Inputs

SALAME = "SALAME"
MR = "mesh refinement"
# ROADMAP.md port queue: item title -> item number
ITEMS = {SALAME: 8, MR: 9}


def fail(key: str, item: str):
    raise NotImplementedError(
        f"{key}: {item} is not ported to hipace_tpu_torch yet "
        f"(ROADMAP.md port queue, item {ITEMS[item]} '{item}')")


def check_deck(inputs: Inputs) -> None:
    """Raise for the first deck key that leaves the ported paths. The
    per-species keys are checked by the plasma and beam configs; a laser,
    ionization or collisions with mesh refinement meet the refusal of
    amr.max_level here."""
    if inputs.query("amr.max_level", 0, int) > 0:
        fail("amr.max_level", MR)
