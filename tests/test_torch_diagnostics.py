"""The port's output against the JAX package's, on CPU in float64.

The openPMD writers of both packages fed the same arrays; then a 31^2 x 8
flagship-like deck with named field diagnostics of every kind (xyz, xz, yz,
xy_integrated, coarsened by 2 and 3, a patch, ghost cells, field_data = all
remove_Sx rho, rho_plasma), beam output and all three in-situ records, run
for two steps through ``evolve`` by each package. The beam is the JAX
package's, carried across (a fixed_weight and a fixed_weight_pdf beam), or
built by each package from the deck (a fixed_ppc beam, which draws no random
numbers); the fixed_ppc deck also runs through the port's CLI. A deck shaped
like the reference's beam_in_vacuum checksum cases (no plasma, order 0,
absorbing walls) runs too. Every dataset of every openPMD file and every
field of every in-situ record must equal the JAX package's within 1e-10
relative to the largest value of its dataset (absolute floor 1e-14);
attributes must be equal.
"""

import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch

from hipace_tpu.diagnostics.openpmd import OpenPMDWriter as JWriter
from hipace_tpu.geometry import Geometry as JGeometry
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.__main__ import main
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.diagnostics import insitu as tins
from hipace_tpu_torch.diagnostics.openpmd import OpenPMDWriter, read_field
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
RTOL = 1e-10
ATOL = 1e-14

GRID = """
amr.n_cell = 31 31 8
hipace.normalized_units = 1
max_step = 1
hipace.dt = 1.0
hipace.use_banded = 0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
beams.names = beam
"""

BEAMS = {
    "fixed_weight": """
beam.injection_type = fixed_weight
beam.num_particles = 3000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.6 0.6 1.41
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0.5 0.5 2.
""",
    "fixed_weight_pdf": """
beam.injection_type = fixed_weight_pdf
beam.num_particles = 3000
beam.pdf(z) = exp(-0.5*((z+1.)/1.41)^2)
beam.position_mean = "0.1*(z+1.)" "0."
beam.position_std = "0.6" "0.6"
beam.u_mean = "0." "0." "2000."
beam.u_std = "0.5" "0.5" "2."
beam.density = 3.
""",
    "fixed_ppc": """
beam.injection_type = fixed_ppc
beam.profile = gaussian
beam.ppc = 1 1 1
beam.zmin = -3.
beam.zmax = 1.
beam.radius = 1.5
beam.position_mean = 0. 0. -1.
beam.position_std = 0.6 0.6 1.41
beam.density = 3.
beam.u_mean = 0. 0. 2000.
""",
}

OUTPUT = """
diagnostic.output_period = 1
diagnostic.names = lev0 side top integ coarse2 coarse3 patch
diagnostic.field_data = all remove_Sx rho
side.diag_type = xz
top.diag_type = yz
top.field_data = Ez rho_plasma jz_beam
top.output_period = 2
integ.diag_type = xy_integrated
integ.field_data = Ez Psi rho
coarse2.coarsening = 2 2 2
coarse2.field_data = Ez Bx jx
coarse3.diag_type = xz
coarse3.coarsening = 3 3 3
coarse3.include_ghost_cells = 1
coarse3.field_data = Psi By rho_plasma
patch.patch_lo = -2. -1. -4.
patch.patch_hi = 2. 3. 0.
patch.field_data = Ez ExmBy chi
diagnostic.beam_data = beam
beams.insitu_period = 1
plasmas.insitu_period = 1
fields.insitu_period = 1
"""


def _deck(beam, out):
    return (GRID + BEAMS[beam] + OUTPUT
            + f"hipace.file_prefix = {out}/openpmd\n"
            + f"beam.insitu_file_prefix = {out}/insitu\n"
            + f"plasma.insitu_file_prefix = {out}/plasma_insitu\n"
            + f"fields.insitu_file_prefix = {out}/field_insitu\n")


@pytest.fixture(scope="module", params=list(BEAMS))
def runs(request, tmp_path_factory):
    """(beam, JAX output dir, port output dir) after two steps each."""
    beam = request.param
    root = tmp_path_factory.mktemp(beam)
    jdir, tdir = root / "jax", root / "port"
    jsim = JSimulation(Inputs(_deck(beam, jdir)), verbose=0)
    tsim = Simulation(TInputs(_deck(beam, tdir)), device="cpu", verbose=0)
    if beam != "fixed_ppc":
        carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                    jsim.dt, jsim.time,
                    [b.total_charge for b in jsim.beam_cfgs])
    jsim.evolve()
    tsim.evolve()
    return beam, jdir, tdir


def _h5_items(path):
    """{name: (data or None, attrs)} of every group and dataset."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (None, dict(f.attrs))

        def visit(name, obj):
            data = np.array(obj) if isinstance(obj, h5py.Dataset) else None
            out[name] = (data, dict(obj.attrs))
        f.visititems(visit)
    return out


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "iub" or ref.dtype.kind == "S":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = np.abs(ref).max() if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=max(ATOL, RTOL * scale), err_msg=what)


def _same_attrs(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=f"{what} attribute {k}")


def _compare_openpmd(tdir, jdir):
    files = sorted(os.listdir(jdir / "openpmd"))
    assert files == ["openpmd_000000.h5", "openpmd_000001.h5"]
    assert sorted(os.listdir(tdir / "openpmd")) == files
    for name in files:
        ref = _h5_items(jdir / "openpmd" / name)
        got = _h5_items(tdir / "openpmd" / name)
        assert sorted(got) == sorted(ref), name
        for item, (data, attrs) in ref.items():
            what = f"{name}:{item}"
            _same_attrs(got[item][1], attrs, what)
            if data is not None:
                _close(got[item][0], data, what)
    return ref


def _insitu(path):
    with open(path, "rb") as f:
        raw = f.read()
    head, offset = json.JSONDecoder().raw_decode(raw.decode("latin-1"))
    return np.frombuffer(raw, dtype=np.dtype(head), offset=offset)


def _compare_records(got, ref, what):
    assert got.dtype == ref.dtype, what
    for name in ref.dtype.names:
        if ref.dtype[name].names:
            _compare_records(got[name], ref[name], f"{what}[{name}]")
        else:
            _close(got[name], ref[name], f"{what}[{name}]")


def _compare_insitu(tdir, jdir):
    for sub, name in (("insitu", "beam"), ("plasma_insitu", "plasma"),
                      ("field_insitu", "field")):
        fname = f"reduced_{name}.0000.txt"
        ref = _insitu(jdir / sub / fname)
        assert ref.shape == (2,) and list(ref["step"]) == [0, 1]
        _compare_records(_insitu(tdir / sub / fname), ref, fname)


def test_writers_write_the_same_files(tmp_path):
    rng = np.random.default_rng(0)
    jgeom = JGeometry(n_cell=(7, 5, 4), prob_lo=(-1.0, -2.0, -3.0),
                      prob_hi=(1.0, 2.0, 1.0), nguards=2)
    fields = {"Ez": rng.standard_normal((4, 5, 7)),
              "side/Bx": rng.standard_normal((4, 7)),
              "integ/rho": rng.standard_normal((5, 7))}
    meta = {"side/Bx": ((1.0, 0.25), (-3.0, -1.0), ("z", "x")),
            "integ/rho": ((0.8, 0.25), (-2.0, -1.0), ("y", "x"))}
    beams = {"beam": {k: rng.standard_normal(11)
                      for k in ("x", "y", "z", "w", "ux", "uy", "uz")}}
    for backend in ("h5", "json"):
        paths = []
        for cls, sub in ((JWriter, "jax"), (OpenPMDWriter, "port")):
            w = cls(str(tmp_path / backend / sub), True, backend=backend)
            w.write(3, 1.5, 0.5, fields, jgeom, beams=beams, field_meta=meta)
            paths.append(tmp_path / backend / sub
                         / f"openpmd_000003.{backend}")
        if backend == "json":
            assert paths[0].read_bytes() == paths[1].read_bytes()
            continue
        ref, got = _h5_items(paths[0]), _h5_items(paths[1])
        assert sorted(got) == sorted(ref) and len(ref) > 10
        for item, (data, attrs) in ref.items():
            _same_attrs(got[item][1], attrs, item)
            if data is not None:
                np.testing.assert_array_equal(got[item][0], data)
        np.testing.assert_array_equal(read_field(str(paths[1]), 3, "side/Bx"),
                                      fields["side/Bx"])


def test_writer_refuses_bp(tmp_path):
    with pytest.raises(RuntimeError, match="ADIOS2"):
        OpenPMDWriter(str(tmp_path), backend="bp")


def test_h5_writer_needs_h5py(tmp_path, monkeypatch):
    """Without h5py (as on the GPU machine) an h5 writer raises when it is
    made, and a deck that writes h5 raises when its Simulation is made; the
    json backend still writes."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        OpenPMDWriter(str(tmp_path / "h5"), backend="h5")
    deck = GRID + BEAMS["fixed_ppc"] + "diagnostic.output_period = 1\n"
    with pytest.raises(RuntimeError, match="h5py"):
        Simulation(TInputs(deck), device="cpu", verbose=0)
    OpenPMDWriter(str(tmp_path / "json"), backend="json").write(
        0, 0.0, 1.0, {"Ez": np.zeros((2, 3, 4))},
        JGeometry(n_cell=(4, 3, 2), prob_lo=(0.0, 0.0, 0.0),
                  prob_hi=(1.0, 1.0, 1.0), nguards=2))
    assert (tmp_path / "json" / "openpmd_000000.json").exists()


def test_openpmd_files_match(runs):
    beam, jdir, tdir = runs
    ref = _compare_openpmd(tdir, jdir)
    # every kind of output is there
    names = {k[len("data/1/"):] for k in ref if k.startswith("data/1/")}
    for want in ("fields/Ez", "fields/rho", "fields/side/rho",
                 "fields/top/rho_plasma", "fields/integ/Psi",
                 "fields/coarse2/jx", "fields/coarse3/rho_plasma",
                 "fields/patch/chi", "particles/beam/momentum/z"):
        assert want in names, want
    assert "fields/Sx" not in names and "fields/Sy" in names


def test_insitu_records_match(runs):
    _, jdir, tdir = runs
    _compare_insitu(tdir, jdir)


@pytest.mark.parametrize("runs", ["fixed_ppc"], indirect=True)
def test_cli_writes_the_same_output(runs, tmp_path):
    """The CLI draws its own beam: the fixed_ppc beam draws no random
    numbers, so the JAX package's files are the reference."""
    beam, jdir, _ = runs
    deck = tmp_path / "deck"
    deck.write_text(_deck(beam, tmp_path))
    assert main([str(deck), "hipace.verbose=0", "--device", "cpu"]) == 0
    _compare_openpmd(tmp_path, jdir)
    _compare_insitu(tmp_path, jdir)


def test_moments_match_the_jax_functions():
    """The port's one-reduction moments against the JAX package's sums."""
    from hipace_tpu.constants import make_constants
    from hipace_tpu.diagnostics import insitu as jins
    from hipace_tpu_torch.constants import make_constants as tmake
    from hipace_tpu_torch.geometry import Geometry
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n = 500
    bp = {"x": rng.normal(0, 1, n), "y": rng.normal(0, 1, n),
          "z": rng.uniform(-1, 0, n), "ux": rng.normal(0, 3, n),
          "uy": rng.normal(0, 3, n), "uz": rng.normal(2000, 10, n),
          "w": rng.uniform(0.5, 1.5, n), "valid": rng.uniform(size=n) > 0.2}
    bp["uz"][:5] = 0.0
    p = {"x": bp["x"], "y": bp["y"], "ux": bp["ux"], "uy": bp["uy"],
         "psi": rng.uniform(0.5, 2.0, n), "w": bp["w"],
         "valid": bp["valid"]}
    jgeom = JGeometry(n_cell=(9, 7, 4), prob_lo=(-1.0, -2.0, -3.0),
                      prob_hi=(1.0, 2.0, 1.0), nguards=2)
    tgeom = Geometry(n_cell=(9, 7, 4), prob_lo=(-1.0, -2.0, -3.0),
                     prob_hi=(1.0, 2.0, 1.0), nguards=2)
    planes = {c: rng.standard_normal(jgeom.slice_shape)
              for c in ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "jz_beam")}
    for normalized in (True, False):
        jpc, tpc = make_constants(normalized), tmake(normalized)
        # stored momenta are u * c
        b = {k: v * jpc.c if k in ("ux", "uy", "uz") else v
             for k, v in bp.items()}
        pp = {k: v * jpc.c if k in ("ux", "uy") else v
              for k, v in p.items()}
        for radius in (float("inf"), 1.2):
            pairs = [
                (tins.beam_slice_moments, jins.beam_slice_moments, b),
                (tins.plasma_slice_moments, jins.plasma_slice_moments, pp)]
            for tfn, jfn, lanes in pairs:
                got = tfn({k: torch.as_tensor(v) for k, v in lanes.items()},
                          tpc, radius).numpy()
                ref = np.asarray(jfn({k: jnp.asarray(v)
                                      for k, v in lanes.items()}, jpc,
                                     radius))
                _close(got, ref, tfn.__name__)
        got = tins.field_slice_moments(
            {k: torch.as_tensor(v) for k, v in planes.items()}, tgeom, tpc,
            0.3).numpy()
        ref = np.asarray(jins.field_slice_moments(
            {k: jnp.asarray(v) for k, v in planes.items()}, jgeom, jpc, 0.3))
        _close(got, ref, "field_slice_moments")


BEAM_IN_VACUUM = """
amr.n_cell = 31 31 16
hipace.normalized_units = 1
max_step = 1
hipace.dt = 3.
hipace.depos_order_xy = 0
hipace.MG_tolerance_rel = 1e-5
boundary.field = Dirichlet
boundary.particle = Absorbing
geometry.prob_lo = -4. -4. -2.
geometry.prob_hi = 4. 4. 2.
plasmas.names = no_plasma
beams.names = beam
beam.injection_type = fixed_ppc
beam.profile = gaussian
beam.position_std = 0.5 0.5 0.5
beam.position_mean = 0.3 -0.2 0.
beam.ppc = 2 2 1
beam.density = 1.
beam.radius = 1.5
beam.u_mean = 0. 0. 10.
beam.zmin = -1.5
beam.zmax = 1.5
diagnostic.output_period = 1
diagnostic.field_data = all rho
"""


def test_beam_in_vacuum_output_matches(tmp_path):
    """The shape of the reference's beam_in_vacuum checksum decks: no
    plasma, order-0 shapes, absorbing walls, a fixed_ppc beam, rho."""
    for cls, inputs, kw, sub in ((JSimulation, Inputs, {}, "jax"),
                                 (Simulation, TInputs, {"device": "cpu"},
                                  "port")):
        deck = (BEAM_IN_VACUUM
                + f"hipace.file_prefix = {tmp_path}/{sub}/openpmd\n")
        cls(inputs(deck), verbose=0, **kw).evolve()
    ref = _compare_openpmd(tmp_path / "port", tmp_path / "jax")
    assert "data/1/fields/rho" in ref and "data/1/particles/beam/weighting" \
        in ref
