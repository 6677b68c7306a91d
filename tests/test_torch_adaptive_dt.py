"""The port's adaptive time step and max_time against the JAX package's, on
CPU in float64.

Every function of ``utils/adaptive_dt.py`` on the same inputs (the host
arithmetic must agree to 1e-15); a run of ``ADAPTIVE_VACUUM`` (a fixed_ppc
beam, so both packages build the same beam from the deck) for 20 steps
through each package's time loop, whose dt sequence must agree to 1e-12,
land on hipace.max_time and end with a dt = 0 step, with the fields and the
beam at the end within 1e-10; and ROADMAP R4: with two beams of different
mass, both packages take the first beam's mass and charge for the betatron
frequency of every beam's moments.
"""

import math

import numpy as np
import pytest
import torch

from hipace_tpu.constants import NORMALIZED as JPC
from hipace_tpu.parser import Inputs
from hipace_tpu.particles.beam import BeamConfig as JBeamConfig
from hipace_tpu.particles.plasma import PlasmaConfig as JPlasmaConfig
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu.utils import adaptive_dt as jadt
from hipace_tpu_torch.constants import NORMALIZED as TPC
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import ADAPTIVE_VACUUM
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles.beam import BeamConfig
from hipace_tpu_torch.particles.plasma import PlasmaConfig
from hipace_tpu_torch.pipeline.simulation import Simulation
from hipace_tpu_torch.utils import adaptive_dt as tadt

torch.set_num_threads(1)
RTOL = 1e-10

DECK = """
hipace.dt = adaptive
hipace.nt_per_betatron = 12.5
hipace.dt_max = 30.
hipace.adaptive_threshold_uz = 3.
hipace.adaptive_predict_step = 1
hipace.adaptive_phase_tolerance = 1e-3
hipace.adaptive_phase_substeps = 500
plasmas.adaptive_density = 0.5
"""


def test_config_and_initial_moments():
    j = jadt.AdaptiveTimeStepConfig.from_inputs(Inputs(DECK))
    t = tadt.AdaptiveTimeStepConfig.from_inputs(TInputs(DECK))
    assert t.enabled and dict(vars(t)) == dict(vars(j))
    assert not tadt.AdaptiveTimeStepConfig.from_inputs(
        TInputs("hipace.dt = 2.\n")).enabled
    jb = JBeamConfig(charge=-1.0, mass=1.0, u_mean=(0, 0, 500.0),
                     u_std=(0, 0, 5.0))
    tb = BeamConfig(charge=-1.0, mass=1.0, u_mean=(0, 0, 500.0),
                    u_std=(0, 0, 5.0))
    assert tadt.initial_moments(tb) == jadt.initial_moments(jb)


def _plasmas(expr):
    return ((JPlasmaConfig(charge=-1.0, density_expr=expr),
             JPlasmaConfig(charge=1.0, mass=1836., density_expr="0.3")),
            (PlasmaConfig(charge=-1.0, density_expr=expr),
             PlasmaConfig(charge=1.0, mass=1836., density_expr="0.3")))


@pytest.mark.parametrize("expr", ["1.", "1. + z/10.", "0.5*(1+tanh(z-3))"])
@pytest.mark.parametrize("numprocs", [1, 3])
@pytest.mark.parametrize("predict", [True, False])
def test_dt_functions_match(expr, numprocs, predict):
    jp, tp = _plasmas(expr)
    jcfg = jadt.AdaptiveTimeStepConfig(enabled=True, nt_per_betatron=15.0,
                                       predict_step=predict,
                                       adaptive_density=0.2)
    tcfg = tadt.AdaptiveTimeStepConfig(**vars(jcfg))
    jb = JBeamConfig(charge=-1.0, mass=1.0, u_mean=(0, 0, 800.0))
    tb = BeamConfig(charge=-1.0, mass=1.0, u_mean=(0, 0, 800.0))
    for mom in ({"sum_w": 2.0, "sum_w_uz": 1600.0, "sum_w_uz2": 1.30e6,
                 "min_uz": 700.0, "min_acc": 0.0},
                {"sum_w": 1.0, "sum_w_uz": 1.5, "sum_w_uz2": 3.0,
                 "min_uz": 1.0, "min_acc": 0.0},
                {"sum_w": 0.0, "sum_w_uz": 0.0, "sum_w_uz2": 0.0,
                 "min_uz": math.inf, "min_acc": 0.0}):
        for t in (0.0, 7.5):
            ref = jadt.calculate_from_min_uz(jcfg, mom, jb, jp, JPC, t, 3.0,
                                             numprocs)
            got = tadt.calculate_from_min_uz(tcfg, mom, tb, tp, TPC, t, 3.0,
                                             numprocs)
            np.testing.assert_allclose(got, ref, rtol=1e-15)
    for t, dt, mq in ((0.0, 20.0, 800.0), (5.0, 8.0, 60.0),
                      (1.0, 3.0, math.inf)):
        ref = jadt.calculate_from_density(jcfg, jp, JPC, t, dt, mq)
        got = tadt.calculate_from_density(tcfg, tp, TPC, t, dt, mq)
        assert got == pytest.approx(ref, rel=1e-15, abs=0.0)
        assert tadt.max_charge_density(tp, TPC, t, 0.2) == pytest.approx(
            jadt.max_charge_density(jp, JPC, t, 0.2), rel=1e-15)


def _record_dt(sim, dts):
    run = sim.run_step

    def run_step(step):
        dts.append(sim.dt)
        return run(step)
    return run_step


@pytest.fixture(scope="module")
def vacuum_runs():
    deck = ADAPTIVE_VACUUM.format(nxy=16, nz=16, max_step=20, max_time=80.0)
    jsim = JSimulation(Inputs(deck + "hipace.use_banded = 0\n"), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    jdts, tdts, jres, tres = [], [], [], []
    jrun = _record_dt(jsim, jdts)
    jsim.run_step = lambda s: jres.append(jrun(s)) or jres[-1]
    trun = _record_dt(tsim, tdts)
    tsim.run_step = lambda s: tres.append(trun(s)) or tres[-1]
    jsim.evolve(write_output=False)
    tsim.evolve(write_output=False)
    return jsim, tsim, jdts, tdts, jres, tres


def test_vacuum_dt_sequence_matches(vacuum_runs):
    jsim, tsim, jdts, tdts, _, _ = vacuum_runs
    assert len(tdts) == len(jdts) == 20
    np.testing.assert_allclose(tdts, jdts, rtol=1e-12, atol=0.0)
    # the dt changes with the beam's energy, the last full step lands on
    # max_time, and one more step runs with dt = 0
    assert tdts[0] != tdts[10] and tdts[-1] == 0.0
    assert tsim.time == 80.0 == jsim.time
    assert sum(tdts[:-1]) == pytest.approx(80.0, rel=1e-15)


def test_vacuum_run_ends_with_the_same_fields_and_beam(vacuum_runs):
    _, tsim, _, _, jres, tres = vacuum_runs
    ref, got = np.asarray(jres[-1]["diag"]), tres[-1]["diag"].numpy()
    for i, c in enumerate(tsim.cfg.diag_comps):
        np.testing.assert_allclose(got[:, i], ref[:, i], rtol=0, err_msg=c,
                                   atol=RTOL * max(np.abs(ref[:, i]).max(),
                                                   1e-300))
    jb, tb = jres[-1]["binned"], tres[-1]["binned"]
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    assert valid.sum() > 1000
    # the transverse momenta of this beam in vacuum stay below 1e-9, where
    # the pusher's rounding at uz ~2000 shows: momenta on the scale of uz
    uz = np.abs(np.asarray(jb["uz"])[valid]).max()
    for k in ("x", "y", "z", "ux", "uy", "uz"):
        r = np.asarray(jb[k])[valid]
        scale = uz if k[0] == "u" else np.abs(r).max()
        np.testing.assert_allclose(tb[k].numpy()[valid], r, rtol=0,
                                   atol=RTOL * scale, err_msg=k)


TWO_BEAMS = """
amr.n_cell = 15 15 8
hipace.normalized_units = 1
max_step = 0
hipace.dt = adaptive
hipace.use_banded = 0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = drive heavy
drive.injection_type = fixed_weight
drive.num_particles = 500
drive.position_mean = 0. 0. -1.
drive.position_std = 0.3 0.3 1.
drive.density = 3.
drive.u_mean = 0. 0. 2000.
drive.u_std = 0. 0. 20.
heavy.injection_type = fixed_weight
heavy.num_particles = 300
heavy.element = proton
heavy.position_mean = 0. 0. -4.
heavy.position_std = 0.3 0.3 0.5
heavy.density = 1.
heavy.u_mean = 0. 0. 50.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def test_first_beam_sets_the_betatron_frequency():
    """ROADMAP R4, in both packages: the moments of every beam's emitted
    lanes are taken with the FIRST beam's mass and charge (the reference
    takes each beam's own)."""
    jsim = JSimulation(Inputs(TWO_BEAMS), verbose=0)
    tsim = Simulation(TInputs(TWO_BEAMS), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs],
                min_uz_mq=jsim._min_uz_mq)
    jsim.evolve(write_output=False)
    tsim.set_dt()
    res = tsim.advance(0, write_output=False)
    assert tsim.dt == pytest.approx(jsim.dt, rel=1e-12)
    mom = {k: float(v) for k, v in res["beam_moments"].items()}
    mom["min_uz"] = float(res["min_uz"])
    cfg = tsim.adt_cfg
    first = tadt.calculate_from_min_uz(cfg, mom, tsim.beam_cfgs[0],
                                       tsim.plasma_cfgs, TPC, tsim.time,
                                       1.0)[0]
    own = tadt.calculate_from_min_uz(cfg, mom, tsim.beam_cfgs[1],
                                     tsim.plasma_cfgs, TPC, tsim.time,
                                     1.0)[0]
    assert tsim.dt == first != pytest.approx(own, rel=0.1)
    # the heavy beam's slow lanes set min_uz
    assert mom["min_uz"] < 100.0
