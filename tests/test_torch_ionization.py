"""Field ionization through the port against the JAX package on the CPU in
float64.

Function by function with the same inputs and draws (the ADK constants of
H, He and N, the species' configuration and state, ``ionization_module`` on
a hand-built state, the ion-level factors of the pushes and deposits with
a laser), a whole 32^2 x 16 step of ``IONIZATION_WAKE`` from the JAX
package's beam with its own uniforms (``jax_draws.JaxSliceDraws``), and the
JAX package's reference-free ionization checks run through the port with
their own deck and thresholds. ROADMAP R16 (the level multiplies the
charge twice) is marked in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.particles.plasma as jpl
from hipace_tpu.constants import SI as JSI
from hipace_tpu.geometry import Geometry as JGeometry
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.constants import SI
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import IONIZATION_WAKE
from hipace_tpu_torch.geometry import Geometry
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation
from jax_draws import JaxSliceDraws, ionization_draw
from test_ionization import DECK as JAX_DECK

torch.set_num_threads(1)
RTOL = 1e-12
FIELD_RTOL = 1e-10
GEOM_DECK = """
amr.n_cell = 24 20 4
geometry.prob_lo = -20.e-6 -18.e-6 -30.e-6
geometry.prob_hi =  20.e-6  18.e-6  30.e-6
"""


def _geoms():
    return (JGeometry.from_inputs(Inputs(GEOM_DECK), 2),
            Geometry.from_inputs(TInputs(GEOM_DECK), 2))


def _cfgs(lines, name="ion"):
    return (jpl.PlasmaConfig.from_inputs(Inputs(lines), name, JSI,
                                         "Periodic"),
            tpl.PlasmaConfig.from_inputs(TInputs(lines), name, SI,
                                         "Periodic"))


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=what,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("element", ["H", "He", "N"])
@pytest.mark.parametrize("normalized", [False, True])
def test_adk_constants_match(element, normalized):
    jcfg, tcfg = _cfgs(f"ion.element = {element}\n"
                       "ion.initial_ion_level = 0\n")
    ref = jpl.adk_constants(jcfg, 0.37, normalized, 2e24)
    got = tpl.adk_constants(tcfg, 0.37, normalized, 2e24)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)


def test_config_and_state_match():
    """can_ionize, the level, the product, neutralize_background's default,
    ion_lev and pid of init_plasma and their padding."""
    lines = ("ion.element = N\nion.initial_ion_level = 2\n"
             "ion.ionization_product = elec\nion.ppc = 2 1\n"
             "elec.ppc = 0 0\nplain.ppc = 1 1\n")
    jg, tg = _geoms()
    for name in ("ion", "elec", "plain"):
        jcfg, tcfg = _cfgs(lines, name)
        for k in ("charge", "mass", "can_ionize", "init_ion_lev",
                  "ionization_product", "neutralize_background"):
            assert getattr(tcfg, k) == getattr(jcfg, k), (name, k)
        ref = jpl.pad_plasma(jpl.init_plasma(
            jcfg, jg, jax.random.PRNGKey(0), jnp.float64, 0.0, False), 7)
        got = tpl.pad_plasma(tpl.init_plasma(tcfg, tg, "cpu",
                                             torch.float64,
                                             normalized_units=False), 7)
        assert set(got) == set(ref)
        for k in ("ion_lev", "pid"):
            if k in ref:
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(ref[k]))


def test_r16_level_two_acts_with_charge_four():
    """ROADMAP R16: initial_ion_level = 2 doubles the configured charge and
    ion_lev = 2 doubles it again in the push, in both packages: the level-2
    ion is pushed as a charge-4 species of the same mass."""
    jcfg, tcfg = _cfgs("ion.element = He\nion.initial_ion_level = 2\n"
                       "ion.ppc = 1 1\n")
    assert jcfg.charge == tcfg.charge == 2 * SI.q_e
    jg, tg = _geoms()
    rng = np.random.default_rng(3)
    NY, NX = tg.slice_shape
    fields = {c: rng.standard_normal((NY, NX)) * s for c, s in (
        ("Psi", 1e4), ("Ez", 1e9), ("Bx", 3.), ("By", 3.), ("Bz", 1.))}
    state = tpl.init_plasma(tcfg, tg, "cpu", torch.float64,
                            normalized_units=False)
    assert int(state["ion_lev"][0]) == 2
    jstate = jpl.init_plasma(jcfg, jg, jax.random.PRNGKey(0), jnp.float64,
                             0.0, False)
    ref = jpl.advance_plasma(jstate, {k: jnp.asarray(v)
                                      for k, v in fields.items()},
                             jg, jcfg, JSI, False)
    tf = {k: torch.tensor(v) for k, v in fields.items()}
    got = tpl.advance_plasma(state, tf, tg, tcfg, SI)
    import dataclasses
    four = tpl.advance_plasma(
        dict(state), tf, tg, dataclasses.replace(
            tcfg, charge=4 * SI.q_e, can_ionize=False), SI)
    for k in ("ux", "uy", "psi", "x"):
        _close(got[k], ref[k], what=k)
        _close(got[k], four[k].numpy(), rtol=1e-14, what=k)


def _ion_state(tcfg, tg, rng):
    """An ionizable species' lanes with moved positions and momenta, pid
    shuffled, one lane at the last level and one invalid."""
    p = tpl.init_plasma(tcfg, tg, "cpu", torch.float64,
                        normalized_units=False)
    n = p["x"].numel()
    for k in ("x", "y"):
        p[f"{k}_prev"] = p[k] + torch.tensor(rng.uniform(-1e-7, 1e-7, n))
    for k in ("ux_half", "uy_half"):
        p[k] = torch.tensor(rng.standard_normal(n)) * 3e6
    p["psi_half"] = 1.0 + torch.tensor(rng.uniform(-0.02, 0.02, n))
    p["ion_lev"] = torch.tensor(rng.integers(0, 2, n), dtype=torch.int32)
    p["ion_lev"][5] = len(tcfg.adk)       # at its last level: cannot ionize
    p["valid"][7] = False
    p["pid"] = torch.tensor(rng.permutation(n), dtype=torch.int32)
    return p


def test_ionization_module_matches():
    """ADK ionization of He on a hand-built state: the promoted levels, the
    spawned electrons in their static slots and the rest of the product
    untouched, equal to the JAX package's with its own draws."""
    import dataclasses
    jcfg, tcfg = _cfgs("ion.element = He\nion.initial_ion_level = 0\n"
                       "ion.ppc = 1 1\n")
    jg, tg = _geoms()
    adk = tpl.adk_constants(tcfg, tg.dz, False, 0.0)
    jcfg = dataclasses.replace(jcfg, adk=adk)
    tcfg = dataclasses.replace(tcfg, adk=adk)
    rng = np.random.default_rng(11)
    ion = _ion_state(tcfg, tg, rng)
    n = ion["x"].numel()
    ecfg = tpl.PlasmaConfig(ppc=(0, 0))
    elec = tpl.pad_plasma(tpl.init_plasma(ecfg, tg, "cpu", torch.float64,
                                          normalized_units=False),
                          3 + 2 * n)
    NY, NX = tg.slice_shape
    fields = {c: rng.standard_normal((NY, NX)) * s for c, s in (
        ("Psi", 2e4), ("Ez", 1.2e11), ("Bx", 60.), ("By", 60.), ("Bz", 5.))}
    key = jax.random.PRNGKey(7)
    to_j = {k: jnp.asarray(v.numpy()) for k, v in ion.items()}
    ref_ion, ref_elec = jpl.ionization_module(
        to_j, {k: jnp.asarray(v.numpy()) for k, v in elec.items()},
        {k: jnp.asarray(v) for k, v in fields.items()}, jg, jcfg, JSI, 2,
        False, 0.0, 3, -1, key)
    got_ion, got_elec = tpl.ionization_module(
        ion, elec, {k: torch.tensor(v) for k, v in fields.items()}, tg,
        tcfg, SI, 2, False, 0.0, 3, -1,
        torch.tensor(ionization_draw(key, n)))
    ionized = got_ion["ion_lev"] - ion["ion_lev"]
    assert 0.1 * n < int(ionized.sum()) < 0.9 * n
    assert int(ionized[5]) == 0 and int(ionized[7]) == 0
    np.testing.assert_array_equal(got_ion["ion_lev"].numpy(),
                                  np.asarray(ref_ion["ion_lev"]))
    assert set(got_elec) == set(ref_elec)
    for k, v in got_elec.items():
        if v.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref_elec[k]),
                                          err_msg=k)
        else:
            _close(v, ref_elec[k], what=k)
    assert int(got_elec["valid"].sum()) == int(ionized.sum())
    assert not bool(got_elec["valid"][:3].any())


@pytest.mark.parametrize("use_laser", [False, True])
def test_ion_level_factors_in_push_and_deposits(use_laser):
    """The push and the explicit deposit of a species with mixed levels
    (0, 1, 2), with and without the laser's terms, equal the JAX
    package's."""
    from hipace_tpu.constants import NORMALIZED as JN
    from hipace_tpu_torch.constants import NORMALIZED as TN
    lines = ("ion.element = He\nion.initial_ion_level = 0\nion.ppc = 1 1\n"
             "ion.mass = 20.\n")
    jcfg = jpl.PlasmaConfig.from_inputs(Inputs(lines), "ion", JN, "Periodic")
    tcfg = tpl.PlasmaConfig.from_inputs(TInputs(lines), "ion", TN,
                                        "Periodic")
    deck = "amr.n_cell = 24 20 4\ngeometry.prob_lo = -4. -4. -2.\n" \
        "geometry.prob_hi = 4. 4. 2.\n"
    jg = JGeometry.from_inputs(Inputs(deck), 2)
    tg = Geometry.from_inputs(TInputs(deck), 2)
    rng = np.random.default_rng(5)
    p = tpl.init_plasma(tcfg, tg, "cpu", torch.float64)
    n = p["x"].numel()
    p["ion_lev"] = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32)
    for k in ("ux", "uy", "ux_half", "uy_half"):
        p[k] = torch.tensor(0.1 * rng.standard_normal(n))
    NY, NX = tg.slice_shape
    names = ("Psi", "Ez", "Bx", "By", "Bz", "ExmBy", "EypBx", "Sx", "Sy",
             "aabs", "jx", "jy", "chi", "rhomjz")
    fields = {c: 0.1 * rng.standard_normal((NY, NX)) for c in names}
    fields["aabs"] = np.abs(fields["aabs"])
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    tf = {k: torch.tensor(v) for k, v in fields.items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    ref = jpl.advance_plasma(jp, jf, jg, jcfg, JN, False,
                             use_laser=use_laser)
    got = tpl.advance_plasma(p, tf, tg, tcfg, TN, use_laser=use_laser)
    for k in ("x", "ux", "uy", "psi"):
        _close(got[k], ref[k], what=k)
    comps = ["jx", "jy", "chi", "rhomjz"]
    ref_main, rp = jpl.deposit_plasma(jp, comps, jf, jg, jcfg, JN, 2, True,
                                      use_laser=use_laser)
    ref = jpl.explicit_deposition(rp, ref_main, jg, jcfg, JN, 2, 2, True,
                                  use_laser=use_laser)
    out, _, dg = tpl.fused_plasma_deposits(p, comps, tf, tg, tcfg, TN, 2,
                                           True, use_laser=use_laser)
    out = tpl.combine_explicit_sxsy(out, dg, TN, tg)
    for c in comps + ["Sx", "Sy"]:
        _close(out[c], ref[c], what=c)
    got, _ = tpl.deposit_plasma(p, comps, tf, tg, tcfg, TN, 2, True,
                                use_laser=use_laser)
    for c in comps:
        _close(got[c], ref_main[c], what=c)


def test_initial_chi_takes_the_level_squared():
    from hipace_tpu.fields import laser as jlz
    from hipace_tpu_torch.constants import NORMALIZED as TN
    from hipace_tpu_torch.fields import laser as tlz
    from hipace_tpu.constants import NORMALIZED as JN
    lines = ("plasmas.names = ion elec\nion.element = He\n"
             "ion.initial_ion_level = 1\nion.density(x,y,z) = 1. + x\n"
             "elec.density(x,y,z) = 2.\n")
    deck = "amr.n_cell = 16 12 4\ngeometry.prob_lo = -4. -4. -2.\n" \
        "geometry.prob_hi = 4. 4. 2.\n"
    jcfgs = [jpl.PlasmaConfig.from_inputs(Inputs(lines), n, JN, "Periodic")
             for n in ("ion", "elec")]
    tcfgs = [tpl.PlasmaConfig.from_inputs(TInputs(lines), n, TN, "Periodic")
             for n in ("ion", "elec")]
    ref = jlz.initial_chi(None, jcfgs, JGeometry.from_inputs(Inputs(deck), 2),
                          JN, 0.0, jnp.float64)
    got = tlz.initial_chi(tcfgs, Geometry.from_inputs(TInputs(deck), 2), TN,
                          0.0, torch.float64)
    _close(got, ref)


def test_normalized_ionization_needs_the_background_density():
    deck = IONIZATION_WAKE.format(nxy=16, nz=4) + \
        "hipace.normalized_units = 1\n"
    with pytest.raises(ValueError, match="hipace.background_density_SI"):
        Simulation(TInputs(deck), device="cpu", verbose=0)


@pytest.fixture(scope="module")
def ionization_step():
    """One 32^2 x 16 step of IONIZATION_WAKE in each package from the JAX
    package's beam, the port on the JAX package's uniforms; the JAX
    package's ionization events per slice counted as it runs."""
    deck = IONIZATION_WAKE.format(nxy=32, nz=16)
    jsim = JSimulation(Inputs(deck), verbose=0)
    events = []
    orig = jpl.ionization_module

    def counted(ion, *args, **kwargs):
        new_ion, new_elec = orig(ion, *args, **kwargs)
        jax.debug.callback(lambda c: events.append(int(c)),
                           jnp.sum(new_ion["ion_lev"] - ion["ion_lev"]),
                           ordered=True)
        return new_ion, new_elec

    draws = JaxSliceDraws(jsim)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "ionization_module", counted)
        jres = jsim.run_step(0)
        jax.effects_barrier()
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs])
    tsim.slice_step.draws = draws
    tres = tsim.run_step(0)
    assert draws.done() and draws.names == ["ionization"] * 16
    return jres, tres, events, tsim


def test_ionization_step_fields_match(ionization_step):
    jres, tres, _, tsim = ionization_step
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    assert got.shape == ref.shape
    for i, comp in enumerate(tsim.cfg.diag_comps):
        _close(got[:, i], ref[:, i], FIELD_RTOL, comp)


def test_ionization_step_count_and_beam_match(ionization_step):
    jres, tres, events, tsim = ionization_step
    assert len(events) == 16 and sum(events) > 100
    assert int(tres["ionized"]) == sum(events)
    ion, elec = tres["plasma"][1], tres["plasma"][0]
    assert int(ion["ion_lev"].sum()) == sum(events)
    # every event spawned an electron; the deposits' QSA cut drops some
    assert 0.5 * sum(events) < int(elec["valid"].sum()) <= sum(events)
    valid = np.asarray(jres["binned"]["valid"])
    np.testing.assert_array_equal(tres["binned"]["valid"].numpy(), valid)
    for k in ("x", "ux", "uz"):
        _close(tres["binned"][k].numpy()[valid],
               np.asarray(jres["binned"][k])[valid], RTOL, k)


# ---- the JAX package's reference-free checks through the port
def test_adk_constants_hydrogen():
    cfg = tpl.PlasmaConfig(element="H")
    adk = tpl.adk_constants(cfg, dz=1.2e-6, normalized_units=False,
                            background_density_SI=0.0)
    assert len(adk) == 1
    power, pref, exp_pref = adk[0]
    # hydrogen: n_eff = 1, l_eff = 0 -> power = -1, C2 = 4
    assert abs(power + 1.0) < 1e-12
    Ea = 9.1093837015e-31 * (299792458.0) ** 2 / 1.602176634e-19 \
        * 0.0072973525693 ** 4 / 2.8179403227e-15
    assert abs(exp_pref + 2.0 / 3.0 * Ea) / Ea < 1e-10
    assert pref > 0.0


def test_ionization_spawns_electrons():
    """test_ionization.py::test_ionization_spawns_electrons' charge checks
    on its own deck: ionized charge near the beam, none ahead of it."""
    sim = Simulation(TInputs(JAX_DECK + "hipace.deposit_rho = 1\n"
                             "diagnostic.field_data = Ez rho ExmBy\n"),
                     device="cpu", verbose=0)
    assert sim.ionization_pairs
    res = sim.run_step(0)
    comps = sim.cfg.diag_comps
    rho = res["diag"][:, comps.index("rho")].numpy()
    assert np.abs(rho).max() > 0.0, "no electrons were ionized"
    nz, ny, nx = rho.shape
    x = (np.arange(nx) + 0.5) * sim.geom.dx + sim.geom.prob_lo[0]
    y = (np.arange(ny) + 0.5) * sim.geom.dy + sim.geom.prob_lo[1]
    r = np.hypot(x[None, :], y[:, None])
    near = r < 10e-6
    qe, ne = 1.602176634e-19, 1.25e24
    assert np.abs(rho[:, near]).max() > 0.1 * qe * ne, \
        "no significant ionized charge near the beam"
    zeta = (np.arange(nz) + 0.5) * sim.geom.dz + sim.geom.prob_lo[2]
    ahead = zeta > 25e-6
    assert np.abs(rho[ahead]).max() < 1e-3 * qe * ne
