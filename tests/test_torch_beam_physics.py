"""The JAX package's reference-free checks of the beam paths, run through
the port.

Each takes its deck, its theory and its threshold from the JAX package's
own test (tests/test_beam_extras.py) and runs them through hipace_tpu_torch
on CPU tensors: a beam in an external focusing field with and without
radiation reaction (the reference's RR validation,
examples/beam_in_vacuum/analysis_RR.py), spin precession in an external Bz,
and the field of an analytic grid current against magnetostatic theory.
"""

import math

import numpy as np
import scipy.constants as scc
import torch

import test_beam_extras as jbe
from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)


def _final_gamma(res):
    b = res["binned"]
    v = b["valid"]
    u2 = b["ux"][v] ** 2 + b["uy"][v] ** 2 + b["uz"][v] ** 2
    return torch.sqrt(1.0 + u2 / scc.c ** 2).numpy()


def _run_rr(overrides):
    """Two steps of the RR deck, the second at time dt, as the JAX test
    runs them."""
    sim = Simulation(Inputs(jbe.DECK_RR, overrides=overrides), device="cpu",
                     verbose=0)
    res = sim.run_step(0)
    sim.binned, sim.time = res["binned"], sim.dt
    return sim, sim.run_step(1)


def test_external_field_betatron_no_rr():
    sim, res = _run_rr(["beam.do_radiation_reaction=0"])
    assert sim.beam_cfgs[0].use_external_fields
    gam = _final_gamma(res)
    assert abs(gam.mean() - 2000.0) / 2000.0 < 2e-3
    b = res["binned"]
    x = b["x"][b["valid"]].numpy()
    wp = math.sqrt(5e24 * scc.e ** 2 / (scc.m_e * scc.epsilon_0))
    kp = wp / scc.c
    sigma_x0 = math.sqrt(313e-6 / kp / math.sqrt(2000.0 / 2.0))
    assert abs(np.std(x) - sigma_x0) / sigma_x0 < 0.15


def test_radiation_reaction_gamma_decay():
    """The mean gamma after two steps against gamma0 / (1 + nu t) (Deng et
    al. eq. 31), within a third of the decay."""
    sim, res = _run_rr(["beam.do_radiation_reaction=1"])
    assert sim.beam_cfgs[0].do_radiation_reaction
    gam = _final_gamma(res)
    wp = math.sqrt(5e24 * scc.e ** 2 / (scc.m_e * scc.epsilon_0))
    kp = wp / scc.c
    K = kp / math.sqrt(2.0)
    gamma0 = 2000.0
    taur = 2 * scc.physical_constants["classical electron radius"][0] \
        / (3 * scc.c)
    w_beta = K * scc.c / math.sqrt(gamma0)
    sigma_x0 = math.sqrt(313e-6 / kp / math.sqrt(gamma0 / 2.0))
    ux0 = 313e-6 / sigma_x0
    xmsq = sigma_x0 ** 2 + scc.c ** 2 * ux0 ** 2 / (w_beta ** 2 * gamma0 ** 2)
    nugamma = taur * scc.c ** 2 * K ** 4 * gamma0 * xmsq / 2.0
    gamma_theo = gamma0 / (1.0 + nugamma * 2 * sim.dt)
    err = abs(gam.mean() - gamma_theo) / gamma_theo
    assert err < (gamma0 - gamma_theo) / gamma_theo / 3.0, \
        f"gamma {gam.mean()} theo {gamma_theo} err {err}"


SPIN_DECK = """
amr.n_cell = 16 16 4
hipace.normalized_units = 1
hipace.dt = 1.0
max_step = 0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -4. -4. -2.
geometry.prob_hi =  4.  4.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.profile = gaussian
beam.position_mean = 0 0 0
beam.position_std = 0.1 0.1 0.5
beam.density = 1e-12
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
beam.num_particles = 100
beam.n_subcycles = 20
beam.do_spin_tracking = 1
beam.initial_spin = 1. 0. 0.
beam.spin_anom = 0.1
beam.do_z_push = 0
beams.external_B(x,y,z,t) = 0. 0. 0.01
diagnostic.output_period = 0
"""


def test_spin_precession_in_bz():
    """|s| kept; the spin turns about z by |q/m| (1 + a) Bz / gamma per unit
    time, within 2% (the JAX test's deck and threshold)."""
    sim = Simulation(Inputs(SPIN_DECK), device="cpu", verbose=0)
    b = sim.run_step(0)["binned"]
    v = b["valid"]
    sx, sy, sz = (b[k][v].numpy() for k in ("sx", "sy", "sz"))
    np.testing.assert_allclose(sx ** 2 + sy ** 2 + sz ** 2, 1.0, rtol=1e-9)
    gamma = math.sqrt(1 + 1000.0 ** 2)
    expected = 1.0 * (1.0 + 0.1) * 0.01 / gamma
    angle = np.arctan2(sy, sx)
    assert abs(abs(np.mean(angle)) - expected) / expected < 0.02


GRID_DECK = """
amr.n_cell = 64 64 4
hipace.normalized_units = 1
hipace.dt = 0.
max_step = 0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -16. -16. -2.
geometry.prob_hi =  16.  16.  2.
beams.names = no_beam
grid_current.use_grid_current = 1
grid_current.peak_current_density = -1.
grid_current.position_mean = 0. 0. 0.
grid_current.position_std = 1. 1. 100.
diagnostic.output_period = 0
"""


def test_grid_current_field():
    """By on the axis of a gaussian grid current against the free-space
    -jz0 sigma^2 / x (1 - exp(-x^2 / 2 sigma^2)), L2 below 0.05 (image
    fields of the box at +-16 make a few %)."""
    sim = Simulation(Inputs(GRID_DECK), device="cpu", verbose=0)
    diag = sim.run_step(0)["diag"].numpy()
    by = diag[2, sim.cfg.diag_comps.index("By")]
    ny, nx = by.shape
    x = (np.arange(nx) + 0.5) * sim.geom.dx + sim.geom.prob_lo[0]
    line = 0.5 * (by[ny // 2 - 1] + by[ny // 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        th = -1.0 / x * (1.0 - np.exp(-x ** 2 / 2.0))
    m = np.abs(x) > 0.5
    err = np.sum((line[m] - th[m]) ** 2) / np.sum(th[m] ** 2)
    assert err < 0.05, f"grid current By L2 err {err}"
