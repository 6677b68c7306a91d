"""The comparison that decides ``correct`` for the laser envelope
configuration: what the timed path produced against the plain reference
(``reference/laser.py``).

Three numbers, each against its limit in the configuration's ``limits``
(the names of ``check.py``, read for a deck driven by a laser):

- ``start_gap``: the program's envelope at the start of the run (step 0's
  n00 on every slice, formed from the deck's gaussian pulse, as the stream
  holds it after step 0) against the reference's initial envelope: the
  largest modulus of the difference over the largest modulus.
- ``fields_gap``: the fields of every slice of a step taken after the
  window through the window's own call, as the slice step leaves them in
  its carry (``slice_fields``: ``check.py``'s fourteen and |a|^2), and the
  envelope that step advanced on every slice (np1, the next step's n00),
  against the reference's step from the program's envelope stream at that
  step's start: per component the largest gap over the largest reference
  value (moduli for the envelope), the worst component.
- ``beam_gap``: the deck has no beam; the step's re-binned beam against
  the reference's, which is empty: 0, infinite where the program holds a
  lane.
"""

from __future__ import annotations

import math

import torch

from . import check
from .reference import laser, qsa

FROM_THIS = check.FROM_THIS + ("aabs",)
FROM_PREVIOUS = check.FROM_PREVIOUS
ENVELOPE = "laser_np1"


def slice_fields(fields: dict, dk: qsa.Deck, device) -> dict:
    """A copy on `device` of the interior of each compared field of the
    slice just swept, from the field sets of the slice step's carry."""
    out = {c: qsa.interior(fields["This"][c], dk).to(device, copy=True)
           for c in FROM_THIS}
    out.update((c, qsa.interior(fields["Previous"][c], dk)
                .to(device, copy=True)) for c in FROM_PREVIOUS)
    return out


def _gap(p, r) -> float:
    d = float((p.to(device=r.device, dtype=r.dtype) - r).abs().max())
    return d if math.isfinite(d) else math.inf


def start_gap(n00_rows, ld: laser.LaserDeck) -> float:
    """The program's step-0 envelope, (nz, NY, NX) rows, against the
    reference's initial envelope."""
    dev = n00_rows.device
    gap = scale = 0.0
    for islice in range(ld.dk.nz):
        r = laser.envelope_slice(ld, islice, torch.float64, dev)
        gap = max(gap, _gap(n00_rows[islice], r))
        scale = max(scale, float(r.abs().max()))
    return gap / scale if scale > 0 else gap


def beam_gap(binned: dict) -> float:
    """0 where the program's re-binned beam holds no lane, as the
    reference's (the deck has no beam); infinite otherwise."""
    return math.inf if bool(binned["valid"].any()) else 0.0


def last_step(fields: dict, np1_rows, stream, step: int,
              ld: laser.LaserDeck, plasma=None) -> dict:
    """fields_gap of one step of the program: the reference runs that step
    from the program's envelope stream at its start (stream, the (n00,
    nm1) rows; plasma, the lanes at its start where the deck draws them)
    and is compared slice by slice with the program's fields (fields, by
    islice the slice_fields) and the envelope it advanced (np1_rows).
    Also returns the worst component, and the reference's V-cycles per
    slice of the Bx/By and the envelope solves."""
    dk = ld.dk
    dev = stream[0].device
    comps = FROM_THIS + FROM_PREVIOUS + (ENVELOPE,)
    ref = laser.Step(ld, dev, torch.float64)
    gap = {c: 0.0 for c in comps}
    scale = {c: 0.0 for c in comps}
    for islice, this, np1 in ref.run(stream, step, plasma):
        for c in comps:
            if c == ENVELOPE:
                r, p = np1, np1_rows[islice]
            else:
                r, p = qsa.interior(this[c], dk), fields[islice][c]
            gap[c] = max(gap[c], _gap(p, r))
            scale[c] = max(scale[c], float(r.abs().max()))
    rel = {c: gap[c] / scale[c] if scale[c] > 0 else gap[c] for c in comps}
    worst = max(comps, key=lambda c: rel[c])
    return {"fields_gap": rel[worst], "fields_worst": worst,
            "ref_cycles": ref.cycles, "ref_laser_cycles": ref.laser_cycles}
