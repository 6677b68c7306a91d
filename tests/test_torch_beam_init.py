"""The port's beam inits against the JAX package's, on CPU in float64.

fixed_weight_pdf: the port's transform of its draws against
``hipace_tpu.particles.beam._init_fixed_weight_pdf`` fed the same numpy
draws (jax.random.uniform / normal patched inside the test), within 1e-12
relative to each array's largest value. fixed_ppc: against
``_init_fixed_ppc`` for the flattop, gaussian and parsed profiles, within
1e-14. from_file: a beam written by the port's openPMD writer and read back
by the port's from_file init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.constants import make_constants
from hipace_tpu.geometry import Geometry
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import beam as jbm
from hipace_tpu_torch.constants import make_constants as tmake_constants
from hipace_tpu_torch.diagnostics.openpmd import OpenPMDWriter
from hipace_tpu_torch.geometry import Geometry as TGeometry
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import beam as tbm
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)
ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w")

GRID = """
amr.n_cell = 15 13 24
hipace.normalized_units = {norm}
geometry.prob_lo = -4. -3. -6.
geometry.prob_hi =  4.  3.  2.
beams.names = beam
"""

PDF = """
beam.injection_type = fixed_weight_pdf
beam.num_particles = 4000
beam.pdf(z) = exp(-0.5*((z+1.)/1.41)^2) + 0.3*exp(-(z+4.)^2)
beam.position_mean = "0.1*(z+1.)" "-0.05*z"
beam.position_std = "0.3+0.02*z" "0.25"
beam.u_mean = "1." "-2." "2000.+50.*z"
beam.u_std = "0.5" "0.4" "3.+z*z"
"""

PDF_CASES = {
    "total_charge": "beam.total_charge = -2.5\n",
    "peak_density": "beam.density = 3.\n",
    "z_foc": "beam.density = 3.\nbeam.z_foc = 1.5\n",
    "radius": "beam.total_charge = -2.5\nbeam.radius = 0.35\n",
    "SI": ("beam.total_charge = -1.e-9\nbeam.pdf_ref_ratio = 3\n"),
}

PPC = """
beam.injection_type = fixed_ppc
beam.ppc = 2 1 3
beam.zmin = -4.
beam.zmax = 1.
beam.radius = 2.
beam.position_mean = "0.2*z" 0.1 -1.
beam.u_mean = 0.5 0. 1000.
"""

PPC_CASES = {
    "flattop": "beam.profile = flattop\nbeam.density = 2.\n",
    "gaussian": ("beam.profile = gaussian\nbeam.density = 2.\n"
                 "beam.position_std = 0.7 0.5 1.3\n"),
    "parsed": ("beam.profile = parsed\n"
               "beam.density(x,y,z) = 1.+0.5*cos(x)*exp(-y*y)+0.1*z\n"),
}


def _configs(deck, norm):
    jin = Inputs(GRID.format(norm=norm) + deck)
    tin = TInputs(GRID.format(norm=norm) + deck)
    geom = Geometry.from_inputs(jin, 2)
    tgeom = TGeometry.from_inputs(tin, 2)
    jcfg = jbm.BeamConfig.from_inputs(jin, "beam", make_constants(norm),
                                      geom, norm)
    tcfg = tbm.BeamConfig.from_inputs(tin, "beam", tmake_constants(norm),
                                      tgeom, norm)
    return geom, tgeom, jcfg, tcfg


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, what
    if ref.dtype == bool:
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("case", list(PDF_CASES))
def test_fixed_weight_pdf_matches_with_the_same_draws(case, monkeypatch):
    norm = case != "SI"
    geom, tgeom, jcfg, tcfg = _configs(PDF + PDF_CASES[case], norm)
    for name in ("pdf_expr", "pdf_pos_mean_expr", "pdf_pos_std_expr",
                 "pdf_u_mean_expr", "pdf_u_std_expr", "pdf_ref_ratio",
                 "peak_density_is_specified", "density", "total_charge",
                 "z_foc", "radius", "num_particles"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    n = tcfg.num_particles
    rng = np.random.default_rng(7)
    draws = {"u": rng.uniform(size=n)}
    for k in tbm.PDF_DRAWS[1:]:
        draws[k] = rng.standard_normal(n)
    normals = iter([draws[k] for k in tbm.PDF_DRAWS[1:]])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype: jnp.asarray(draws["u"]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(next(normals)))
    ref = jbm._init_fixed_weight_pdf(jcfg, geom, jax.random.PRNGKey(0),
                                     jnp.float64, norm)
    got = tbm.init_fixed_weight_pdf(
        tcfg, tgeom, {k: torch.as_tensor(v) for k, v in draws.items()}, norm)
    for k in ATTRS + ("valid",):
        _close(got[k], ref[k], 1e-12, k)
    valid = np.asarray(ref["valid"])
    assert valid.sum() > (1000 if case == "radius" else n - 1)
    assert float(np.asarray(ref["w"])[valid].min()) > 0.0


def test_pdf_draws_come_from_the_generator():
    _, tgeom, _, tcfg = _configs(PDF + PDF_CASES["peak_density"], True)
    a = tbm.pdf_draws(tcfg, torch.Generator().manual_seed(3), "cpu",
                      torch.float64)
    b = tbm.pdf_draws(tcfg, torch.Generator().manual_seed(3), "cpu",
                      torch.float64)
    assert list(a) == list(tbm.PDF_DRAWS)
    for k in tbm.PDF_DRAWS:
        assert torch.equal(a[k], b[k]) and a[k].shape == (4000,)
    assert 0.0 <= float(a["u"].min()) and float(a["u"].max()) < 1.0
    beam = tbm.init_beam(tcfg, tgeom, torch.Generator().manual_seed(3),
                         "cpu", torch.float64, tmake_constants(True), True)
    ref = tbm.init_fixed_weight_pdf(tcfg, tgeom, a, True)
    for k in ATTRS:
        assert torch.equal(beam[k], ref[k]), k
    assert beam["nsub"].dtype == torch.int32 and not beam["sz"].any()


@pytest.mark.parametrize("case", list(PPC_CASES))
@pytest.mark.parametrize("norm", [True, False])
def test_fixed_ppc_matches(case, norm):
    geom, tgeom, jcfg, tcfg = _configs(PPC + PPC_CASES[case], norm)
    for name in ("ppc", "profile", "density", "position_mean",
                 "position_std", "u_mean", "zmin", "zmax", "radius"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    ref = jbm._init_fixed_ppc(jcfg, geom, jnp.float64, norm)
    got = tbm.init_beam(tcfg, tgeom, torch.Generator(), "cpu",
                        torch.float64, tmake_constants(norm), norm)
    c = tmake_constants(norm).c
    for k in ATTRS + ("valid",):
        _close(got[k] / c if k in ("ux", "uy", "uz") else got[k], ref[k],
               1e-14, k)
    assert 0 < int(np.asarray(ref["valid"]).sum()) < ref["x"].size


@pytest.mark.parametrize("backend", ["h5", "json"])
def test_from_file_round_trip(tmp_path, backend):
    rng = np.random.default_rng(11)
    n = 700
    beam = {"x": rng.normal(0, 0.3, n), "y": rng.normal(0, 0.3, n),
            "z": rng.uniform(-5, 1, n), "w": rng.uniform(0.1, 1.0, n),
            "ux": rng.normal(0, 1, n), "uy": rng.normal(0, 1, n),
            "uz": rng.normal(1000, 5, n)}
    OpenPMDWriter(str(tmp_path), True, backend=backend).write(
        4, 0.0, 1.0, {}, TGeometry.from_inputs(
            TInputs(GRID.format(norm=1)), 2), beams={"beam": beam})
    deck = (GRID.format(norm=1) + "plasmas.names = no_plasma\n"
            "diagnostic.output_period = 0\nmax_step = 0\n"
            "beam.injection_type = from_file\n"
            f"beam.input_file = {tmp_path}/openpmd_000004.{backend}\n"
            "beam.iteration = 4\n")
    sim = Simulation(TInputs(deck), device="cpu", verbose=0)
    flat = tbm.unbin_beam(sim.binned)
    v = flat["valid"]
    isl = np.floor((beam["z"] + 6.0) / (8.0 / 24)).astype(int)
    assert int(v.sum()) == n == int(((isl >= 0) & (isl < 24)).sum())
    order = np.argsort(flat["z"][v].numpy())
    ref_order = np.argsort(beam["z"])
    for k in ATTRS:
        np.testing.assert_array_equal(flat[k][v].numpy()[order],
                                      beam[k][ref_order], err_msg=k)
