"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/qsa.py``).

Three numbers, each against its limit in the configuration's ``limits``:

- ``start_gap``: the program's binned beam before its first step against
  the reference's binning of the drawn lanes (the start of the run, which
  the comparison of the held step skips): the largest gap of any float
  attribute over the valid lanes, relative to the attribute's largest
  value; infinite where the slices hold other lane counts.
- ``fields_gap``: the fields of every slice of a step taken after the
  window through the window's own call, as the slice step leaves them in
  its carry (``slice_fields``), against the reference's step from the
  program's beam at that step's start: per component the largest gap over
  the largest reference value, the worst component.
- ``beam_gap``: the beam that step emitted and re-binned, lane by lane in
  the program's order, against the reference's: per attribute of
  position and momentum the largest gap over the largest reference value,
  the worst attribute; infinite where the slices hold other lane counts.
  Both sides drop the lanes that leave the box through its z ends, which
  the deck's periodic boundaries do not hold (transverse only), so the
  count is not held to the start's.
"""

from __future__ import annotations

import math

import torch

from .reference import qsa

COMPARED = ("x", "y", "z", "ux", "uy", "uz")


def _valid_lanes(binned: dict, keys, dtype=torch.float64) -> tuple:
    """The valid lanes of a program's (nz, cap) binned beam: per slice the
    lane count, and each key's values in slice order."""
    valid = binned["valid"]
    counts = valid.sum(dim=1).tolist()
    return counts, {k: binned[k][valid].to(dtype) for k in keys}


def _rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    if p.numel() == 0:
        return 0.0
    r = r.to(p.device)
    scale = float(r.abs().max())
    gap = float((p - r).abs().max())
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0 else gap


def beam_gap(binned: dict, ref_slices: list, keys) -> float:
    """The worst relative gap of keys between a program's binned beam and
    the reference's per-slice lanes (qsa.bin_beam); infinite where their
    lane counts differ."""
    counts, prog = _valid_lanes(binned, keys)
    if counts != [int(s["x"].numel()) for s in ref_slices]:
        return math.inf
    return max(_rel_gap(prog[k], torch.cat([s[k] for s in ref_slices])
                        .to(torch.float64)) for k in keys)


def start_gap(binned: dict, flat_beam: dict, dk: qsa.Deck) -> float:
    """The program's initial binned beam against the reference's binning of
    the drawn lanes."""
    flat = dict(flat_beam, nsub=torch.zeros_like(flat_beam["x"],
                                                 dtype=torch.int32),
                valid=torch.ones_like(flat_beam["x"], dtype=torch.bool))
    return beam_gap(binned, qsa.bin_beam(flat, dk), qsa.BEAM_FLOAT)


# the explicit solver's fields of a slice that its carry holds once the
# slice step has shifted its field sets (pipeline/step.py _shift): This but
# for jx and jy, which the shift sets to the next slice's beam currents, and
# the slice's own jx_beam and jy_beam, which it keeps in Previous
FROM_THIS = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi", "jz_beam",
             "rhomjz", "chi", "Sx", "Sy")
FROM_PREVIOUS = ("jx_beam", "jy_beam")


def _interior(t: torch.Tensor, dk: qsa.Deck) -> torch.Tensor:
    gy, gx = (t.shape[-2] - dk.ny) // 2, (t.shape[-1] - dk.nx) // 2
    return t[..., gy:gy + dk.ny, gx:gx + dk.nx]


def slice_fields(fields: dict, dk: qsa.Deck) -> dict:
    """A copy of the interior of each compared field of the slice just
    swept, from the field sets of the slice step's carry."""
    out = {c: _interior(fields["This"][c], dk).clone() for c in FROM_THIS}
    out.update((c, _interior(fields["Previous"][c], dk).clone())
               for c in FROM_PREVIOUS)
    return out


def last_step(fields: dict, out_binned: dict | None, in_binned: dict,
              dk: qsa.Deck) -> dict:
    """fields_gap and beam_gap of one step of the program: the reference
    runs that step from the program's beam at its start (in_binned) and is
    compared slice by slice with the program's fields (fields, by islice
    the slice_fields) and, where out_binned is given, with the beam the
    step left. Also returns the reference's lanes after the step (flat)
    and its V-cycles per slice."""
    comps = FROM_THIS + FROM_PREVIOUS
    dev = in_binned["x"].device
    _, lanes = _valid_lanes(in_binned, qsa.BEAM_FLOAT + ("nsub",))
    lanes["nsub"] = lanes["nsub"].to(torch.int32)
    lanes["valid"] = torch.ones_like(lanes["x"], dtype=torch.bool)
    step = qsa.Step(dk, dev, torch.float64)
    gap = {c: 0.0 for c in comps}
    scale = {c: 0.0 for c in comps}
    sweep = step.run(lanes)
    while True:
        try:
            islice, this = next(sweep)
        except StopIteration as done:
            flat = done.value
            break
        for c in comps:
            r = qsa.interior(this[c], dk)
            p = fields[islice][c].to(device=dev, dtype=torch.float64)
            d = float((p - r).abs().max())
            gap[c] = max(gap[c], d if math.isfinite(d) else math.inf)
            scale[c] = max(scale[c], float(r.abs().max()))
    rel = {c: gap[c] / scale[c] if scale[c] > 0 else gap[c] for c in comps}
    worst = max(comps, key=lambda c: rel[c])
    out = {"fields_gap": rel[worst], "fields_worst": worst, "flat": flat,
           "ref_cycles": step.cycles}
    if out_binned is not None:
        out["beam_gap"] = beam_gap(out_binned, qsa.bin_beam(flat, dk),
                                   COMPARED)
    return out
