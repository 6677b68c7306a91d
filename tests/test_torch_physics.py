"""The JAX package's reference-free physics checks, run through the port.

These need no reference checksum files: the linear wake against its
analytic response, the nonlinear blowout wake's explicit solver against the
predictor-corrector and its physical sanity, and a can beam in vacuum
against magnetostatic theory. Each takes its deck, its theory and its
threshold from the JAX package's own test (tests/test_linear_wake.py,
tests/test_blowout_wake.py, tests/test_beam_in_vacuum.py) and runs them
through hipace_tpu_torch on CPU tensors, i.e. the plain versions of K1-K3.
Their sizes are even (32^2, 48^2, 128^2): the explicit solver's Bx/By and
the beam-in-vacuum solve go through the cell-centered multigrid.
"""

import numpy as np
import pytest
import torch

import test_beam_in_vacuum as jbiv
import test_blowout_wake as jbw
import test_linear_wake as jlw
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)


def _run(deck, overrides=()):
    sim = Simulation(Inputs(deck, overrides=list(overrides)), device="cpu",
                     verbose=0)
    res = sim.run_step(0)
    return sim, res["diag"].numpy()


@pytest.mark.parametrize("solver,pusher", [
    ("explicit", "leapfrog"),
    ("predictor-corrector", "leapfrog"),
    ("explicit", "ab5"),
])
def test_linear_wake_rho(solver, pusher):
    """On-axis rho against the linear response to a flattop beam, L2 below
    0.025 (ref examples/linear_wake/analysis.py)."""
    sim, diag = _run(jlw.DECK, [f"hipace.bxby_solver={solver}",
                                f"hipace.plasma_pusher={pusher}"])
    assert sim.slice_step.mg is None or sim.slice_step.mg.cell_centered
    rho = diag[:, sim.cfg.diag_comps.index("rho")]
    g = sim.geom
    zeta = (np.arange(g.nz) + 0.5) * g.dz + g.prob_lo[2]
    nb = np.where((zeta >= -1.0) & (zeta <= 1.0), 0.01, 0.0)
    rho_th = jlw._rho_theory(zeta, g.dz, nb)
    err = np.sum((jbw._axis(rho) - rho_th) ** 2) / np.sum(rho_th ** 2)
    assert err < 0.025, f"L2 rel err {err} ({solver}, {pusher})"


@pytest.fixture(scope="module")
def blowout():
    """The 48^2 x 100 blowout deck on both Bx/By solvers."""
    return {s: _run(jbw.DECK, [f"hipace.bxby_solver={s}"])
            for s in ("explicit", "predictor-corrector")}


def test_blowout_explicit_vs_predictor_corrector(blowout):
    (sim, d_ex), (_, d_pc) = blowout["explicit"], blowout[
        "predictor-corrector"]
    i = sim.cfg.diag_comps.index("Ez")
    ez_ex, ez_pc = jbw._axis(d_ex[:, i]), jbw._axis(d_pc[:, i])
    err = np.sum((ez_ex - ez_pc) ** 2) / np.sum(ez_ex ** 2)
    assert err < 0.01, f"solver cross-validation L2 err {err}"


def test_blowout_cavity_and_field_sanity(blowout):
    """The JAX test's thresholds: a cavity (on-axis rho above 0.8 behind the
    driver), the decelerating and accelerating Ez, no field ahead of the
    beam, the ion column's focusing slope 1/2."""
    sim, diag = blowout["explicit"]
    comps = sim.cfg.diag_comps
    g = sim.geom
    zeta = (np.arange(g.nz) + 0.5) * g.dz + g.prob_lo[2]
    rho_axis = jbw._axis(diag[:, comps.index("rho")])
    ez = jbw._axis(diag[:, comps.index("Ez")])
    assert rho_axis[zeta < -1.0].max() > 0.8
    assert ez.min() < -0.35
    assert ez.max() > 0.15
    assert np.max(np.abs(ez[zeta > 5.0])) < 0.05
    exmby = diag[:, comps.index("ExmBy")]
    isl = np.argmin(np.abs(zeta + 2.0))
    ny, nx = exmby.shape[1:]
    x = (np.arange(nx) + 0.5) * g.dx + g.prob_lo[0]
    line = 0.5 * (exmby[isl, ny // 2 - 1] + exmby[isl, ny // 2])
    core = np.abs(x) < 0.75
    slope = np.polyfit(x[core], line[core], 1)[0]
    assert abs(slope - 0.5) < 0.15, f"ion-column slope {slope} != 0.5"


@pytest.fixture(scope="module")
def vacuum():
    return _run(jbiv.DECK)


def test_beam_in_vacuum_by_field(vacuum):
    """By of a can beam against mu0 jz0 x / 2 inside and mu0 jz0 R^2/(2x)
    outside, L2 below 0.015 (ref examples/beam_in_vacuum/analysis.py); Bx
    vanishes on the x axis."""
    sim, diag = vacuum
    comps = sim.cfg.diag_comps
    assert sim.slice_step.mg.cell_centered
    by = diag[4, comps.index("By")]
    ny, nx = by.shape
    x = (np.arange(nx) + 0.5) * sim.geom.dx + sim.geom.prob_lo[0]
    by_line = 0.5 * (by[ny // 2 - 1, :] + by[ny // 2, :])
    by_th = np.where(np.abs(x) < 1.0, -x / 2.0,
                     -1.0 / (2.0 * np.where(np.abs(x) < 1.0, 1.0, x)))
    err_l2 = np.sum((by_line - by_th) ** 2) / np.sum(by_th ** 2)
    assert err_l2 < 0.015, f"L2 rel err {err_l2}"
    bx = diag[4, comps.index("Bx")]
    bx_line = 0.5 * (bx[ny // 2 - 1, :] + bx[ny // 2, :])
    assert np.max(np.abs(bx_line)) < 0.01 * np.max(np.abs(by_th))


def test_beam_in_vacuum_exmby(vacuum):
    """Ex - c By of an ultrarelativistic beam is Ex / gamma^2: under 2% of
    Ex's theory."""
    sim, diag = vacuum
    exmby = diag[4, sim.cfg.diag_comps.index("ExmBy")]
    ny = exmby.shape[0]
    line = 0.5 * (exmby[ny // 2 - 1, :] + exmby[ny // 2, :])
    x = (np.arange(line.size) + 0.5) * sim.geom.dx + sim.geom.prob_lo[0]
    ex_th = np.where(np.abs(x) < 1.0, -x / 2.0,
                     -1.0 / (2.0 * np.where(np.abs(x) < 1.0, 1.0, x)))
    assert np.max(np.abs(line)) < 0.02 * np.max(np.abs(ex_th))
