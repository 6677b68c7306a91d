"""The JAX package's reference-free laser and adaptive-dt checks through the
port, at their own thresholds (no JAX run).

From ``tests/test_laser.py``: a gaussian pulse in vacuum diffracts with
w(z) = w0 sqrt(1 + (z - z_foc)^2 / zR^2) and a(z) = a0 w0 / w(z), on both
envelope solvers (64^2, cell-centred multigrid); from
``tests/test_laser_grid.py``: the same on a 64^2 laser grid inside a 16^2
field grid; from ``tests/test_adaptive_dt.py``: the cold-beam dt formula,
the phase-advance control (a uniform density keeps dt, a gradient cuts it)
and an adaptive run whose dt starts from the initial beam and hardly moves
in a uniform plasma.
"""

import math

import numpy as np
import pytest
import scipy.constants as scc
import torch

from hipace_tpu_torch.constants import NORMALIZED
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.particles.beam import BeamConfig
from hipace_tpu_torch.particles.plasma import PlasmaConfig
from hipace_tpu_torch.pipeline.simulation import Simulation
from hipace_tpu_torch.utils import adaptive_dt as adt

torch.set_num_threads(1)

VACUUM = """
max_step = 8
hipace.dt = 140.e-6/clight
amr.n_cell = 64 64 24
my_constants.kp_inv = 10.e-6
geometry.prob_lo = -6.*kp_inv -6.*kp_inv -8.*kp_inv
geometry.prob_hi =  6.*kp_inv  6.*kp_inv  6.*kp_inv
lasers.names = laser
lasers.lambda0 = .8e-6
laser.a0 = 1
laser.position_mean = 0. 0. 0
laser.w0 = 2.*kp_inv
laser.L0 = 2.*kp_inv
laser.focal_distance = 0.001
boundary.field = Dirichlet
boundary.particle = Periodic
beams.names = no_beam
plasmas.names = no_plasma
diagnostic.output_period = 0
"""
LAM, W0, ZFOC = 0.8e-6, 20.e-6, 0.001


def _diffraction(sim):
    """(z, rms width, peak |a|) after each step from the laser stream."""
    lg = sim.laser_geom
    G = lg.nguards
    NY, NX = lg.slice_shape
    x = (np.arange(lg.nx) + 0.5) * lg.dx + lg.prob_lo[0]
    zs, widths, amps = [], [], []
    for step in range(sim.max_step + 1):
        sim.run_step(step)
        sim.time += sim.dt
        a = sim.laser_stream[0].numpy()[:, G:NY - G, G:NX - G]
        aa = np.abs(a) ** 2
        widths.append(2.0 * math.sqrt(np.sum(aa * x[None, None, :] ** 2)
                                      / np.sum(aa)))
        amps.append(np.abs(a).max())
        zs.append(sim.time * scc.c)
    zs = np.array(zs)
    w_th = W0 * np.sqrt(1 + (zs - ZFOC) ** 2 / (math.pi * W0 ** 2 / LAM) ** 2)
    return (np.std((w_th - np.array(widths)) / w_th),
            np.std((W0 / w_th - np.array(amps)) / (W0 / w_th)))


@pytest.mark.parametrize("solver", ["fft", "multigrid"])
def test_laser_vacuum_diffraction(solver):
    sim = Simulation(Inputs(VACUUM, overrides=[
        f"lasers.solver_type={solver}"]), device="cpu", verbose=0)
    w_err, a_err = _diffraction(sim)
    assert w_err < 5e-3, w_err
    assert a_err < 8e-3, a_err


def test_fine_laser_grid_vacuum_diffraction():
    deck = (VACUUM.replace("amr.n_cell = 64 64 24", "amr.n_cell = 16 16 24")
            .replace("max_step = 8", "max_step = 6")
            + "lasers.solver_type = fft\nlasers.n_cell = 64 64\n"
            "lasers.patch_lo = -4.*kp_inv -4.*kp_inv -8.*kp_inv\n"
            "lasers.patch_hi =  4.*kp_inv  4.*kp_inv  6.*kp_inv\n")
    sim = Simulation(Inputs(deck), device="cpu", verbose=0)
    assert sim.laser_geom.n_cell[:2] == (64, 64)
    assert sim.laser_geom != sim.geom
    w_err, a_err = _diffraction(sim)
    assert w_err < 6e-3, w_err
    assert a_err < 9e-3, a_err


def test_dt_formula_cold_beam():
    cfg = adt.AdaptiveTimeStepConfig(enabled=True, nt_per_betatron=20.0,
                                     predict_step=False)
    beam = BeamConfig(charge=-1.0, mass=1.0, u_mean=(0, 0, 2000.0))
    plasma = PlasmaConfig(charge=-1.0, density_expr="1.")
    mom = {"sum_w": 1.0, "sum_w_uz": 2000.0, "sum_w_uz2": 2000.0 ** 2,
           "min_uz": 2000.0, "min_acc": 0.0}
    dt, min_uz_mq = adt.calculate_from_min_uz(cfg, mom, beam, (plasma,),
                                              NORMALIZED, 0.0, 1e30)
    omega_b = math.sqrt(1.0 / (2.0 * 2000.0))
    assert abs(dt - 2 * math.pi / omega_b / 20.0) / dt < 1e-12
    assert abs(min_uz_mq - 2000.0) < 1e-9


def test_phase_advance_uniform_density_keeps_dt():
    cfg = adt.AdaptiveTimeStepConfig(enabled=True)
    plasma = PlasmaConfig(density_expr="1.")
    assert adt.calculate_from_density(cfg, (plasma,), NORMALIZED, 0.0, 5.0,
                                      2000.0) == 5.0


def test_phase_advance_gradient_reduces_dt():
    cfg = adt.AdaptiveTimeStepConfig(enabled=True)
    plasma = PlasmaConfig(density_expr="1. + z/10.")
    dt = adt.calculate_from_density(cfg, (plasma,), NORMALIZED, 0.0, 10.0,
                                    2000.0)
    assert 0.0 < dt < 10.0


ADAPTIVE = """
amr.n_cell = 16 16 32
hipace.normalized_units = 1
max_step = 1
hipace.dt = adaptive
hipace.nt_per_betatron = 10
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -6. -6. -4.
geometry.prob_hi =  6.  6.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 500
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 0.5
beam.zmin = -3.9
beam.zmax = 1.9
beam.density = 1.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 10.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def test_e2e_adaptive_dt():
    sim = Simulation(Inputs(ADAPTIVE), device="cpu", verbose=0)
    # the initial dt from the initial beam: min uz ~ 1000 - 4 * 10
    omega_b = math.sqrt(1.0 / (2.0 * 960.0))
    assert abs(sim.dt - 2 * math.pi / omega_b / 10.0) / sim.dt < 0.05
    dt0 = sim.dt
    sim.evolve(write_output=False)
    assert np.isfinite(sim.dt) and sim.dt > 0
    # a uniform plasma: uz hardly changes over one step
    assert abs(sim.dt - dt0) / dt0 < 0.2
