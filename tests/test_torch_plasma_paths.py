"""The plasma paths through the port against the JAX package on CPU in
float64: several species, temperature (u_std), density tables, the AB5
pusher and derivative types 0 and 1 of the explicit Sx/Sy deposit.

Every path runs in a whole 31^2 x 8 time step against the JAX package from
the same beam, with fields within 1e-10 of each one's largest value,
V-cycle counts equal on every slice and the beam within 1e-12. A JAX
step's compile takes ~20 s on one core, so two steps carry the paths:
"ion motion" (electrons with a temperature and mobile hydrogen ions, the
AB5 pusher, derivative type 0; each species' rho_<species> among the
fields, its in-situ record, and a neutralizing background for the
electrons beside the ions' none) and "density table" (a table read from a
file, derivative type 1). The temperature's draws are the JAX package's
own, fed to the port's transform: the two generators' streams differ. The
configuration, the temperature transform, the AB5 state and the table's
choice by c*t are also held to the JAX package on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.fields.multigrid as jmg
from hipace_tpu.parser import Inputs
from hipace_tpu.particles import plasma as jpl
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import BLOWOUT_WAKE, ION_MOTION_EVEN
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_diagnostics import _compare_records, _insitu
from test_torch_slice import _counting_solve

torch.set_num_threads(1)
FIELD_RTOL = 1e-10
BEAM_RTOL = 1e-12
NO_BANDED = "hipace.use_banded = 0\n"
TABLE = """# position  density(x,y,z)
3.   2.
-1.  0.5
0.5  1. + 0.1*x - 0.05*y
"""


def _decks(table_path, out="diags"):
    """The two cases' decks; out is the folder of the in-situ records."""
    return {
        "ion motion": ION_MOTION_EVEN.format(nxy=31, nz=8, npart=1000)
        + NO_BANDED + "hipace.plasma_pusher = ab5\n"
        "hipace.depos_derivative_type = 0\n"
        "elec.neutralize_background = 1\n"
        "diagnostic.field_data = all rho_elec rho_ions\n"
        "plasmas.insitu_period = 1\n"
        f"elec.insitu_file_prefix = {out}/elec\n"
        f"ions.insitu_file_prefix = {out}/ions\n",
        "density table": BLOWOUT_WAKE.format(nxy=31, nz=8, npart=1000)
        + NO_BANDED + "hipace.depos_derivative_type = 1\n"
        f"plasma.density_table_file = {table_path}\n",
    }


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("table") / "density_table.txt"
    path.write_text(TABLE)
    return str(path)


def _jax_draws(jsim, key):
    """The normals the JAX package's next step draws for each species' u_std
    (its _init_plasma_state from the step's key), None for a cold one."""
    _, key = jax.random.split(key)
    out = []
    for pcfg in jsim.plasma_cfgs:
        key, sub = jax.random.split(key)
        if any(s != 0.0 for s in pcfg.u_std):
            n = tpl.plasma_count(pcfg, jsim.geom)
            out.append(torch.tensor(np.stack([
                np.asarray(jax.random.normal(k, (n,), jnp.float64))
                for k in jax.random.split(sub, 3)])))
        else:
            out.append(None)
    return out


@pytest.fixture(scope="module", params=["ion motion", "density table"])
def step_case(request, table_path, tmp_path_factory):
    """One time step of each package from the same beam (the table applied
    for c*t first, as each time loop does) and its in-situ records: (JAX
    result, port result, the JAX package's V-cycles per slice, the port's
    simulation, the JAX simulation, the JAX and port record folders)."""
    root = tmp_path_factory.mktemp("records")
    jdir, tdir = root / "jax", root / "port"
    cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmg.MultiGrid, "solve", _counting_solve(cycles))
        jsim = JSimulation(Inputs(_decks(table_path, jdir)[request.param]),
                           verbose=0)
        draws = _jax_draws(jsim, jsim.key)
        jsim._apply_density_table()
        jres = jsim.run_step(0)
        jax.effects_barrier()
        jsim._write_insitu(0, jres)
    tsim = Simulation(TInputs(_decks(table_path, tdir)[request.param]),
                      device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time,
                [b.total_charge for b in jsim.beam_cfgs])
    with pytest.MonkeyPatch.context() as mp:
        queue = list(draws)
        mp.setattr(tpl, "plasma_draws", lambda *a, **k: queue.pop(0))
        tres = tsim.advance(0, write_output=True)
        assert not queue
    return jres, tres, cycles, tsim, jsim, jdir, tdir


def test_step_fields_match(step_case):
    jres, tres, _, tsim, *_ = step_case
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    assert got.shape == ref.shape == (8, len(tsim.cfg.diag_comps), 31, 31)
    for i, comp in enumerate(tsim.cfg.diag_comps):
        np.testing.assert_allclose(
            got[:, i], ref[:, i], rtol=0, err_msg=comp,
            atol=FIELD_RTOL * max(np.abs(ref[:, i]).max(), 1e-300))


def test_step_cycles_and_beam_match(step_case):
    jres, tres, cycles, *_ = step_case
    assert tres["mg_cycles"] == cycles and len(cycles) == 8
    valid = np.asarray(jres["binned"]["valid"])
    np.testing.assert_array_equal(tres["binned"]["valid"].numpy(), valid)
    assert valid.sum() > 500
    for k in ("x", "y", "ux", "uy", "uz"):
        ref = np.asarray(jres["binned"][k])[valid]
        np.testing.assert_allclose(tres["binned"][k].numpy()[valid], ref,
                                   rtol=0, atol=BEAM_RTOL * np.abs(ref).max())


def test_step_runs_the_path(step_case):
    """Each case's deck selects what it is meant to exercise; the two
    species' in-situ records match the JAX package's."""
    _, _, _, tsim, jsim, jdir, tdir = step_case
    cfg = tsim.cfg
    if len(cfg.plasmas) == 2:
        elec, ions = cfg.plasmas
        assert any(elec.u_std) and not any(ions.u_std)
        assert ions.charge > 0 and ions.mass > 1800 * elec.mass
        assert elec.neutralize_background and not ions.neutralize_background
        assert cfg.plasma_pusher == "ab5" and cfg.depos_derivative_type == 0
        assert {"rho_elec", "rho_ions"} <= set(cfg.diag_comps)
        for name in ("elec", "ions"):
            fname = f"reduced_{name}.0000.txt"
            ref = _insitu(jdir / name / fname)
            assert ref.shape == (1,)
            _compare_records(_insitu(tdir / name / fname), ref, fname)
    else:
        (p,) = cfg.plasmas
        assert p.density_expr == "1. + 0.1*x - 0.05*y"
        assert p.density_expr == jsim.plasma_cfgs[0].density_expr
        assert cfg.depos_derivative_type == 1


def test_config_matches_jax(table_path):
    """Every PlasmaConfig key the port reads, as the JAX package reads it."""
    for deck in _decks(table_path).values():
        jcfgs = JSimulation(Inputs(deck), verbose=0).plasma_cfgs
        tcfgs = Simulation(TInputs(deck), device="cpu",
                           verbose=0).plasma_cfgs
        assert len(jcfgs) == len(tcfgs)
        for j, t in zip(jcfgs, tcfgs):
            for f in ("name", "charge", "mass", "ppc", "n_subcycles",
                      "neutralize_background", "u_mean", "u_std",
                      "element", "density_table", "density_expr",
                      "min_density", "particle_boundary"):
                assert getattr(t, f) == getattr(j, f), f


def test_density_table_follows_c_t(table_path):
    """The expression of the smallest position >= c*t, else the last one,
    as the JAX package's time loop picks it."""
    deck = _decks(table_path)["density table"]
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    assert tsim.plasma_cfgs[0].density_table == tuple(
        (p, e) for p, e in jsim.plasma_cfgs[0].density_table)
    for t in (-3.0, -1.0, 0.0, 0.5, 0.6, 3.0, 7.0):
        jsim.time = tsim.time = t
        jsim._apply_density_table()
        tsim.apply_density_table()
        assert tsim.plasma_cfgs[0].density_expr == \
            jsim.plasma_cfgs[0].density_expr
        assert tsim.slice_step.cfg.plasmas == tsim.plasma_cfgs


def test_temperature_transform_matches_jax():
    """init_plasma with the JAX package's own normals gives its momenta and
    psi; plasma_draws takes three normals per lane from the generator, and
    none for a cold species."""
    deck = ION_MOTION_EVEN.format(nxy=15, nz=4, npart=100)
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    key = jax.random.PRNGKey(5)
    for jcfg, tcfg in zip(jsim.plasma_cfgs, tsim.plasma_cfgs):
        ref = jpl.init_plasma(jcfg, jsim.geom, key, jnp.float64, 0.0, True,
                              ab5=True)
        n = tpl.plasma_count(tcfg, tsim.geom)
        draws = (torch.tensor(np.stack([np.asarray(jax.random.normal(
            k, (n,), jnp.float64)) for k in jax.random.split(key, 3)]))
            if any(tcfg.u_std) else None)
        got = tpl.init_plasma(tcfg, tsim.geom, "cpu", torch.float64,
                              draws=draws, ab5=True)
        assert set(got) == set(ref)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]),
                                       rtol=1e-15, atol=0, err_msg=k)
        gen = torch.Generator().manual_seed(0)
        d = tpl.plasma_draws(tcfg, tsim.geom, gen, "cpu", torch.float64)
        assert (d is None) == (not any(tcfg.u_std))
        if d is not None:
            assert d.shape == (3, n) and abs(float(d.std()) - 1.0) < 0.1
            with pytest.raises(ValueError, match="draws"):
                tpl.init_plasma(tcfg, tsim.geom, "cpu", torch.float64)
