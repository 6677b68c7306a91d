"""The deck's beam, drawn from the seed on the card, and its openPMD file.

The transverse benchmark deck's fixed_weight_pdf beam: z from the pdf
exp(-((z - mean) / std)^2 / 2) on the domain's z range, x and y gaussian,
every lane at the deck's momentum, and equal weights whose sum gives the
deck's peak density. The draw is one uniform and two normals per lane from
a ``torch.Generator`` seeded with the run's seed, in float64, on the device.

The program reads the beam through the deck's ``from_file`` injection: the
lanes are written once per run as an openPMD file, h5 where h5py imports,
else the openPMD-api json layout, with every value written exactly. The
reference takes the same tensors.
"""

from __future__ import annotations

import json
import math
import os

import torch

RECORDS = (("position", "x", "x"), ("position", "y", "y"),
           ("position", "z", "z"), ("weighting", None, "w"),
           ("momentum", "x", "ux"), ("momentum", "y", "uy"),
           ("momentum", "z", "uz"))


def draw(cfg: dict, seed: int, device) -> dict:
    """The beam's lanes (x, y, z, ux, uy, uz, w: float64 tensors on device)
    for the configuration's ``beam`` block and grid."""
    b = cfg["beam"]
    n = cfg["beam.num_particles"]
    nx, ny, nz = cfg["amr.n_cell"]
    lo, hi = cfg["geometry.prob_lo"], cfg["geometry.prob_hi"]
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    mean, std = b["z_mean"], b["z_std"]
    ca = 0.5 * math.erfc(-(lo[2] - mean) / (std * math.sqrt(2.0)))
    cb = 0.5 * math.erfc(-(hi[2] - mean) / (std * math.sqrt(2.0)))
    u = torch.rand(n, generator=gen, **f64)
    z = mean + std * torch.special.ndtri(ca + (cb - ca) * u)
    z = z.clamp(lo[2], math.nextafter(hi[2], lo[2]))
    sx, sy = b["position_std"]
    x = sx * torch.randn(n, generator=gen, **f64)
    y = sy * torch.randn(n, generator=gen, **f64)
    # peak density * the pdf's integral over z * 2 pi sx sy, in units of
    # the cell volume (normalized units)
    dx = (hi[0] - lo[0]) / nx
    dy = (hi[1] - lo[1]) / ny
    dz = (hi[2] - lo[2]) / nz
    total = (b["density"] * std * math.sqrt(2.0 * math.pi) * (cb - ca)
             * 2.0 * math.pi * sx * sy / (dx * dy * dz))
    ux, uy, uz = (torch.full((n,), float(v), **f64) for v in b["u_mean"])
    return {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz,
            "w": torch.full((n,), total / n, **f64)}


def _h5py():
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def write_openpmd(beam: dict, folder: str, name: str = "beam") -> str:
    """Write the lanes as iteration 0 of an openPMD file in folder; returns
    its path."""
    h5py = _h5py()
    host = {k: v.cpu().numpy() for k, v in beam.items()}
    if h5py is not None:
        path = os.path.join(folder, "beam_000000.h5")
        with h5py.File(path, "w") as f:
            f.attrs["openPMD"] = "1.1.0"
            f.attrs["basePath"] = "/data/%T/"
            f.attrs["particlesPath"] = "particles/"
            gp = f.create_group(f"data/0/particles/{name}")
            for rec, comp, key in RECORDS:
                ds = gp.create_dataset(rec if comp is None else
                                       f"{rec}/{comp}", data=host[key])
                ds.attrs["unitSI"] = 1.0
        return path
    path = os.path.join(folder, "beam_000000.json")
    marks = {}
    particles: dict = {}
    for rec, comp, key in RECORDS:
        mark = f"@{key}@"
        marks[mark] = host[key]
        node = {"attributes": {"unitSI": 1.0}, "datatype": "DOUBLE",
                "data": mark}
        if comp is None:
            particles[rec] = node
        else:
            particles.setdefault(rec, {})[comp] = node
    doc = {"attributes": {"openPMD": "1.1.0", "basePath": "/data/%T/",
                          "particlesPath": "particles/",
                          "iterationEncoding": "fileBased"},
           "data": {"0": {"attributes": {"time": 0.0, "dt": 0.0},
                          "particles": {name: particles}}}}
    text = json.dumps(doc)
    with open(path, "w") as f:
        start = 0
        for mark, arr in marks.items():
            at = text.index(f'"{mark}"', start)
            f.write(text[start:at])
            if arr.size and (arr == arr[0]).all():
                # a constant record: one exact repr repeated
                f.write("[" + ", ".join([repr(float(arr[0]))] * arr.size)
                        + "]")
            else:
                f.write(json.dumps(arr.tolist()))
            start = at + len(mark) + 2
        f.write(text[start:])
    return path
