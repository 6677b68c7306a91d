"""openPMD-layout output written with h5py (h5) or as JSON (json).

A copy of ``hipace_tpu/diagnostics/openpmd.py`` fed numpy arrays (ref
OpenPMDWriter.{H,cpp}): file-based series ``<prefix>/openpmd_%06T.<ext>``
with meshes (fields) and particle species; ``hipace.openpmd_backend``
selects h5 or json, and bp (ADIOS2) raises. The json backend mirrors the
openPMD-api JSON hierarchy and needs nothing beyond the standard library;
the h5 backend needs h5py, and a writer asked for h5 raises at construction
where h5py does not import.

Fields are written as (nz, ny, nx) datasets with axisLabels ("z","y","x");
beams as 1D particle record components x/y/z, w, ux/uy/uz (momenta stored as
gamma*beta like the reference, ref OpenPMDWriter.H:79-95). The laser's
complex ``laserEnvelope`` is written as it is: in h5 as h5py writes a complex
array (the JAX package's file), in json with the openPMD-api json backend's
datatype "CDOUBLE", each value a [re, im] pair.
"""

from __future__ import annotations

import json
import os

import numpy as np

BEAM_RECORDS = (("position/x", "x"), ("position/y", "y"),
                ("position/z", "z"), ("weighting", "w"),
                ("momentum/x", "ux"), ("momentum/y", "uy"),
                ("momentum/z", "uz"))


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise RuntimeError(
            "hipace.openpmd_backend=h5 needs h5py, which does not import "
            "here; use hipace.openpmd_backend=json") from err
    return h5py


class OpenPMDWriter:
    def __init__(self, file_prefix: str = "diags/hdf5",
                 normalized_units: bool = True, backend: str = "h5"):
        self.prefix = file_prefix
        self.normalized = normalized_units
        if backend == "default":
            backend = "h5"
        if backend == "bp":
            raise RuntimeError(
                "hipace.openpmd_backend=bp needs ADIOS2, which is not "
                "available in this environment; use h5 or json")
        if backend not in ("h5", "json"):
            raise ValueError(f"unknown openpmd_backend {backend}")
        if backend == "h5":
            _h5py()
        self.backend = backend
        os.makedirs(file_prefix, exist_ok=True)

    def _path(self, it: int) -> str:
        return os.path.join(self.prefix, f"openpmd_{it:06d}.{self.backend}")

    # ------------------------------------------------------------------
    def write(self, it: int, time: float, dt: float, fields: dict | None,
              geom, beams: dict | None = None, field_geom=None,
              field_meta: dict | None = None):
        """Write one iteration.

        fields: dict name -> np.ndarray (nz, ny, nx) (or (ny, nx) slices of
        reduced diagnostics). beams: dict beam-name -> dict of 1D arrays
        {x,y,z,w,ux,uy,uz} (already masked to valid particles).
        field_meta: optional dict name -> (spacing tuple, offset tuple)
        matching the dataset's trailing axes.
        """
        if self.backend == "json":
            return self._write_json(it, time, dt, fields, geom, beams,
                                    field_geom, field_meta)
        return self._write_h5(it, time, dt, fields, geom, beams,
                              field_geom, field_meta)

    @staticmethod
    def _field_attrs(name, arr, fg, field_meta):
        nd = arr.ndim
        labels = ["z", "y", "x"][-nd:]
        if name in field_meta:
            meta = field_meta[name]
            spacing = list(meta[0])[-nd:]
            offset = list(meta[1])[-nd:]
            if len(meta) > 2:
                labels = list(meta[2])[-nd:]
        else:
            spacing = [fg.dz, fg.dy, fg.dx][-nd:]
            offset = [fg.prob_lo[2], fg.prob_lo[1], fg.prob_lo[0]][-nd:]
        return labels, spacing, offset

    def _write_h5(self, it, time, dt, fields, geom, beams, field_geom,
                  field_meta):
        h5py = _h5py()
        fg = field_geom or geom
        field_meta = field_meta or {}
        with h5py.File(self._path(it), "w") as f:
            f.attrs["openPMD"] = np.bytes_("1.1.0")
            f.attrs["openPMDextension"] = np.uint32(0)
            f.attrs["basePath"] = np.bytes_("/data/%T/")
            f.attrs["meshesPath"] = np.bytes_("fields/")
            f.attrs["particlesPath"] = np.bytes_("particles/")
            f.attrs["iterationEncoding"] = np.bytes_("fileBased")
            f.attrs["iterationFormat"] = np.bytes_("openpmd_%06T")
            base = f.create_group(f"data/{it}")
            base.attrs["time"] = float(time)
            base.attrs["dt"] = float(dt)
            base.attrs["timeUnitSI"] = 1.0

            if fields:
                mesh = base.create_group("fields")
                for name, arr in fields.items():
                    arr = np.asarray(arr)
                    ds = mesh.create_dataset(name, data=arr)
                    labels, spacing, offset = self._field_attrs(
                        name, arr, fg, field_meta)
                    ds.attrs["axisLabels"] = np.array(
                        [np.bytes_(a) for a in labels])
                    ds.attrs["gridSpacing"] = np.array(spacing, np.float64)
                    ds.attrs["gridGlobalOffset"] = np.array(offset,
                                                            np.float64)
                    ds.attrs["position"] = np.array([0.5] * arr.ndim,
                                                    np.float64)
                    ds.attrs["dataOrder"] = np.bytes_("C")
                    ds.attrs["geometry"] = np.bytes_("cartesian")
                    ds.attrs["gridUnitSI"] = 1.0
                    ds.attrs["unitSI"] = 1.0
                    ds.attrs["unitDimension"] = np.zeros(7, np.float64)

            if beams:
                part = base.create_group("particles")
                for bname, b in beams.items():
                    gp = part.create_group(bname)
                    for comp, key in BEAM_RECORDS:
                        ds = gp.create_dataset(comp, data=np.asarray(b[key]))
                        ds.attrs["unitSI"] = 1.0
                        ds.attrs["unitDimension"] = np.zeros(7, np.float64)
                    if "id" in b:
                        gp.create_dataset("id", data=np.asarray(b["id"]))

    def _write_json(self, it, time, dt, fields, geom, beams, field_geom,
                    field_meta):
        """Nested-JSON mirror of the openPMD-api json backend layout."""
        fg = field_geom or geom
        field_meta = field_meta or {}

        def dset(arr, attrs):
            arr = np.asarray(arr)
            if np.iscomplexobj(arr):
                return {"attributes": attrs, "datatype": "CDOUBLE",
                        "data": np.stack([arr.real, arr.imag], -1).tolist()}
            return {"attributes": attrs,
                    "datatype": "DOUBLE",
                    "data": arr.tolist()}

        mesh: dict = {}
        for name, arr in (fields or {}).items():
            arr = np.asarray(arr)
            labels, spacing, offset = self._field_attrs(name, arr, fg,
                                                        field_meta)
            node = dset(arr, {
                "axisLabels": labels,
                "gridSpacing": list(map(float, spacing)),
                "gridGlobalOffset": list(map(float, offset)),
                "position": [0.5] * arr.ndim,
                "dataOrder": "C", "geometry": "cartesian",
                "gridUnitSI": 1.0, "unitSI": 1.0,
                "unitDimension": [0.0] * 7,
            })
            # nested names like "lev1/Ez"
            parts = name.split("/")
            d = mesh
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = node

        particles: dict = {}
        for bname, b in (beams or {}).items():
            gp: dict = {}
            for comp, key in BEAM_RECORDS:
                node = dset(b[key], {"unitSI": 1.0,
                                     "unitDimension": [0.0] * 7})
                parts = comp.split("/")
                d = gp
                for p in parts[:-1]:
                    d = d.setdefault(p, {})
                d[parts[-1]] = node
            particles[bname] = gp

        doc = {
            "attributes": {
                "openPMD": "1.1.0", "openPMDextension": 0,
                "basePath": "/data/%T/", "meshesPath": "fields/",
                "particlesPath": "particles/",
                "iterationEncoding": "fileBased",
                "iterationFormat": "openpmd_%06T",
            },
            "data": {str(it): {
                "attributes": {"time": float(time), "dt": float(dt),
                               "timeUnitSI": 1.0},
                "fields": mesh,
                "particles": particles,
            }},
        }
        with open(self._path(it), "w") as f:
            json.dump(doc, f)


def read_field(path: str, it: int, name: str):
    """One field dataset of an h5 or json file, as a numpy array."""
    if path.endswith(".json"):
        with open(path) as f:
            doc = json.load(f)
        d = doc["data"][str(it)]["fields"]
        for p in name.split("/"):
            d = d[p]
        arr = np.array(d["data"])
        if d.get("datatype") == "CDOUBLE":
            return arr[..., 0] + 1j * arr[..., 1]
        return arr
    with _h5py().File(path, "r") as f:
        return np.array(f[f"data/{it}/fields/{name}"])


def read_beam(path: str, it: int, beam: str):
    """A beam's x, y, z, w, ux, uy, uz of an h5 or json file."""
    out = {}
    if path.endswith(".json"):
        with open(path) as f:
            doc = json.load(f)
        gp = doc["data"][str(it)]["particles"][beam]
        for comp, key in BEAM_RECORDS:
            d = gp
            for p in comp.split("/"):
                d = d[p]
            out[key] = np.array(d["data"])
        return out
    with _h5py().File(path, "r") as f:
        gp = f[f"data/{it}/particles/{beam}"]
        for comp, key in BEAM_RECORDS:
            out[key] = np.array(gp[comp])
    return out
