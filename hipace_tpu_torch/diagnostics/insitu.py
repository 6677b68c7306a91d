"""In-situ reduced diagnostics: per-slice weighted moments.

Port of ``hipace_tpu/diagnostics/insitu.py`` (ref utils/InsituUtil.H;
Fields.cpp:1288-1348; BeamParticleContainer.cpp:476-594;
PlasmaParticleContainer.cpp:443-505). The records and the writer are copies,
so the files have the reference's on-disk format: a JSON header, then one
NumPy structured record per step.

Each species' moments are one reduction: its per-lane quantities and their
products are rows of one (R, N) tensor, multiplied by the masked weights and
summed over the lanes, with the live-lane count Np last (a matrix product
of those rows with the weights is slower on the card: one GEMM tile per
slice walks the million lanes in turn). The slice step keeps these raw
vectors on the device; ``*_ORDER`` puts them in the JAX package's order once
per written step, on the host. The laser's per-slice moments (its peak and
integrated |a|^2 moments, the on-axis envelope) are one (8,) vector per
slice on the laser grid.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..fields.slices import interior

# moment orders match the reference reduce tuples
BEAM_NAMES = ("sum(w)", "[x]", "[x^2]", "[y]", "[y^2]", "[z]", "[z^2]",
              "[ux]", "[ux^2]", "[uy]", "[uy^2]", "[uz]", "[uz^2]",
              "[x*ux]", "[y*uy]", "[z*uz]", "[x*uy]", "[y*ux]",
              "[ux/uz]", "[uy/uz]", "[ga]", "[ga^2]", "Np")

PLASMA_NAMES = ("sum(w)", "[x]", "[x^2]", "[y]", "[y^2]",
                "[ux]", "[ux^2]", "[uy]", "[uy^2]", "[uz]", "[uz^2]",
                "[ga]", "[ga^2]", "[(ga-1)*(1-vz)]", "Np")

FIELD_NAMES = ("[Ex^2]", "[Ey^2]", "[Ez^2]", "[Bx^2]", "[By^2]", "[Bz^2]",
               "[ExmBy^2]", "[EypBx^2]", "[jz_beam]", "[Ez*jz_beam]")

# the raw vectors' entry of each name, in the names' order
# beam raw: sum(w); x y z ux uy uz; their squares; x*ux y*uy z*uz; x*uy
# y*ux; ux/uz uy/uz; ga ga^2; Np
BEAM_ORDER = (0, 1, 7, 2, 8, 3, 9, 4, 10, 5, 11, 6, 12, 13, 14, 15, 16, 17,
              18, 19, 20, 21, 22)
# plasma raw: sum(w); x y ux uy uz ga; their squares; (ga-1)*(1-vz); Np
PLASMA_ORDER = (0, 1, 7, 2, 8, 3, 9, 4, 10, 5, 11, 6, 12, 13, 14)


def _moments(rows, w, mask):
    """sum(w), the rows' sums weighted by w, then the live-lane count."""
    return torch.cat([w.sum()[None], (rows * w).sum(1),
                      mask.sum(dtype=w.dtype)[None]])


def beam_slice_raw(bp: dict, pc, insitu_radius: float = float("inf")):
    """(23,) raw weighted sums of a slice's beam lanes (BEAM_ORDER)."""
    q = torch.stack([bp[k] for k in ("x", "y", "z", "ux", "uy", "uz")])
    q[3:] *= 1.0 / pc.c
    sq = q * q
    m = bp["valid"] & (sq[0] + sq[1] <= insitu_radius ** 2)
    w = torch.where(m, bp["w"], 0.0)
    gam = torch.sqrt(1.0 + sq[3:].sum(0))
    uz = q[5]
    uz_inv = torch.where(uz == 0.0, 0.0, 1.0 / uz)
    rows = torch.cat([q, sq, q[:3] * q[3:], q[:2] * q[3:5].flip(0),
                      q[3:5] * uz_inv, gam[None], (gam * gam)[None]])
    return _moments(rows, w, m)


def beams_slice_raw(bp: dict, nbeams: int, pc,
                    insitu_radius: float = float("inf")):
    """(nbeams, 23) raw weighted sums of a slice's merged beam lanes, one
    row per species, its lanes by beam_id (BEAM_ORDER)."""
    return torch.stack([
        beam_slice_raw(dict(bp, valid=bp["valid"] & (bp["beam_id"] == b)),
                       pc, insitu_radius) for b in range(nbeams)])


def beam_slice_moments(bp: dict, pc, insitu_radius: float = float("inf")):
    """(23,) raw weighted sums (ref BeamParticleContainer.cpp:511-535)."""
    return beam_slice_raw(bp, pc, insitu_radius)[list(BEAM_ORDER)]


def plasma_slice_raw(p: dict, pc, insitu_radius: float = float("inf")):
    """(15,) raw weighted sums of a slice's plasma lanes (PLASMA_ORDER)."""
    q = torch.stack([p[k] for k in ("x", "y", "ux", "uy", "psi")])
    q[2:4] *= 1.0 / pc.c
    sq = q * q
    psi = q[4]
    m = p["valid"] & (sq[0] + sq[1] <= insitu_radius ** 2)
    w = torch.where(m, p["w"], 0.0)
    gam = (1.0 + sq[2:].sum(0)) / (2.0 * psi)
    uz = gam - psi
    # (ga-1)*(1-vz), 1-vz = psi/gam
    rows = torch.cat([q[:4], uz[None], gam[None], sq[:4], (uz * uz)[None],
                      (gam * gam)[None], ((gam - 1.0) * psi / gam)[None]])
    return _moments(rows, w, m)


def plasma_slice_moments(p: dict, pc, insitu_radius: float = float("inf")):
    """(15,) raw weighted sums (ref PlasmaParticleContainer.cpp:488-504)."""
    return plasma_slice_raw(p, pc, insitu_radius)[list(PLASMA_ORDER)]


def field_slice_sums(this: dict, geom, pc):
    """(10,) per-slice field sums in FIELD_NAMES' order; times the cell
    volume they are the moments."""
    c = pc.c
    planes = [this["ExmBy"] + this["By"] * c, this["EypBx"] - this["Bx"] * c,
              this["Ez"], this["Bx"], this["By"], this["Bz"], this["ExmBy"],
              this["EypBx"], this["jz_beam"]]
    f = torch.stack([interior(p, geom) for p in planes])
    f = f.reshape(f.shape[0], -1)
    return torch.cat([f[:8] * f[:8], f[8:], f[2:3] * f[8:]]).sum(1)


def field_slice_moments(this: dict, geom, pc, dxdydz):
    """(10,) per-slice field sums x cell volume (ref Fields.cpp:1322-1346)."""
    return field_slice_sums(this, geom, pc) * dxdydz


# ----------------------------------------------------------------------
LASER_NAMES = ("max(|a|^2)", "[|a|^2]", "[|a|^2*x]", "[|a|^2*x*x]",
               "[|a|^2*y]", "[|a|^2*y*y]")


def laser_slice_moments(env, geom):
    """(8,) per-slice laser moments (ref MultiLaser.H:241-256) of the
    complex envelope env on the laser geometry: max |a|^2, the sums of
    |a|^2, |a|^2 x, |a|^2 x^2, |a|^2 y, |a|^2 y^2, and the on-axis
    envelope's real and imaginary parts; on the device."""
    a = interior(env, geom)
    aabs = torch.abs(a) ** 2
    kw = dict(dtype=aabs.dtype, device=aabs.device)
    X = (geom.prob_lo[0] + (torch.arange(geom.nx, **kw) + 0.5)
         * geom.dx)[None, :]
    Y = (geom.prob_lo[1] + (torch.arange(geom.ny, **kw) + 0.5)
         * geom.dy)[:, None]
    ax = a[geom.ny // 2, geom.nx // 2]
    return torch.stack([
        torch.max(aabs), torch.sum(aabs), torch.sum(aabs * X),
        torch.sum(aabs * X * X), torch.sum(aabs * Y),
        torch.sum(aabs * Y * Y), ax.real, ax.imag])


def laser_record(step, time, moments, geom, normalized_units):
    """The laser's in-situ record of one step from its (nz, 8) moments."""
    m = np.asarray(moments, np.float64)
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(m.shape[0]),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "is_normalized_units": int(normalized_units),
    }
    dxdy = geom.dx * geom.dy
    rec["max(|a|^2)"] = m[:, 0]
    for i, name in enumerate(LASER_NAMES[1:], start=1):
        rec[name] = m[:, i] * dxdy
    rec["axis(a).re"] = m[:, 6]
    rec["axis(a).im"] = m[:, 7]
    return rec


def _dtype_json(record):
    """Build the JSON dtype description for one record (nested dicts become
    nested structured dtypes, like insitu_utils::write_header)."""
    names, formats = [], []
    for k, v in record.items():
        names.append(k)
        if isinstance(v, dict):
            formats.append(_dtype_json(v))
        elif isinstance(v, (int, np.integer)):
            formats.append("<i4")
        elif isinstance(v, float):
            formats.append("<f8")
        else:
            arr = np.asarray(v)
            t = "<i4" if arr.dtype.kind in "iu" else "<f8"
            formats.append(f"({arr.size},){t}")
    return {"names": names, "formats": formats}


def _pack(record, out: list):
    for k, v in record.items():
        if isinstance(v, dict):
            _pack(v, out)
        elif isinstance(v, (int, np.integer)):
            out.append(np.int32(v).tobytes())
        elif isinstance(v, float):
            out.append(np.float64(v).tobytes())
        else:
            arr = np.asarray(v)
            t = np.int32 if arr.dtype.kind in "iu" else np.float64
            out.append(np.ascontiguousarray(arr, t).tobytes())


class InsituWriter:
    """Appends one structured record per step; JSON header written once."""

    def __init__(self, prefix: str, name: str, rank: int = 0):
        self.prefix = prefix
        self.name = name
        self.rank = rank
        self._wrote_header = False

    def _file(self):
        os.makedirs(self.prefix, exist_ok=True)
        return os.path.join(self.prefix,
                            f"reduced_{self.name}.{self.rank:04d}.txt")

    def write_record(self, record: dict):
        payload: list = []
        _pack(record, payload)
        mode = "ab" if self._wrote_header else "wb"
        with open(self._file(), mode) as f:
            if not self._wrote_header:
                f.write(json.dumps(_dtype_json(record)).encode())
                self._wrote_header = True
            for p in payload:
                f.write(p)


def beam_record(step, time, moments, charge, mass, geom, normalized_units):
    """Assemble the beam record (ref BeamParticleContainer.cpp:620-686):
    per-slice moments normalized by the slice weight, plus 'average' and
    'total' sub-records. moments: (nslices, 23) raw sums."""
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    sw = m[:, 0]
    sw_inv = np.where(sw > 0, 1.0 / np.where(sw > 0, sw, 1.0), 0.0)
    tot = m.sum(axis=0)
    sw0 = tot[0] if tot[0] > 0 else 1.0
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "charge": float(charge), "mass": float(mass),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "normalized_density_factor": float(
            geom.dx * geom.dy * geom.dz if normalized_units else 1.0),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(BEAM_NAMES[1:-1], start=1):
        rec[name] = m[:, i] * sw_inv
    rec["sum(w)"] = sw
    rec["Np"] = m[:, 22].astype(np.int32)
    rec["average"] = {name: float(tot[i] / sw0)
                      for i, name in enumerate(BEAM_NAMES[1:-1], start=1)}
    rec["total"] = {"sum(w)": float(tot[0]), "Np": int(tot[22])}
    return rec


def plasma_record(step, time, moments, charge, mass, geom, normalized_units):
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    sw = m[:, 0]
    sw_inv = np.where(sw > 0, 1.0 / np.where(sw > 0, sw, 1.0), 0.0)
    tot = m.sum(axis=0)
    sw0 = tot[0] if tot[0] > 0 else 1.0
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "charge": float(charge), "mass": float(mass),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "normalized_density_factor": float(
            geom.dx * geom.dy * geom.dz if normalized_units else 1.0),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(PLASMA_NAMES[1:-1], start=1):
        rec[name] = m[:, i] * sw_inv
    rec["sum(w)"] = sw
    rec["Np"] = m[:, 14].astype(np.int32)
    rec["average"] = {name: float(tot[i] / sw0)
                      for i, name in enumerate(PLASMA_NAMES[1:-1], start=1)}
    rec["total"] = {"sum(w)": float(tot[0]), "Np": int(tot[14])}
    return rec


def field_record(step, time, moments, geom, normalized_units):
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(FIELD_NAMES):
        rec[name] = m[:, i]
    rec["sum"] = {name: float(m[:, i].sum())
                  for i, name in enumerate(FIELD_NAMES)}
    return rec
