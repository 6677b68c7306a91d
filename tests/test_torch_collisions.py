"""Binary Coulomb collisions through the port against the JAX package on
the CPU in float64.

Function by function with the same inputs and the JAX package's own draws
(``jax_draws``): the cell sort with forced ties, ``_pair_kick``, the
same-species collision with odd and even cells, the inter-species one with
a forced duplicate partner (ROADMAP R17: the last picker's kick stays, in
both packages), the beam-plasma one. A whole 32^2 x 16 step of
``COLLISION_WAKE`` from the JAX package's beam with its uniforms, against
the JAX package's step run op by op (``jax.disable_jit``; its jitted step
differs from its op-by-op one by up to 6e-10 of Bz's largest value, the
fused arithmetic's roundoff carried through the lab-frame transform of
2000-gamma beam momenta); ROADMAP R18 (a same-species collision's kicks do
not stay in the step) marked in both packages. The JAX package's
reference-free collision checks run through the port with their own deck
and thresholds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipace_tpu.particles.collisions as jc
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import COLLISION_WAKE
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import collisions as tc
from hipace_tpu_torch.particles import plasma as tpl
from hipace_tpu_torch.pipeline.simulation import Simulation
from jax_draws import (JaxSliceDraws, as_torch, inter_species_draws,
                       same_species_draws)
from test_collisions import DECK as JAX_DECK

torch.set_num_threads(1)
RTOL = 1e-12
FIELD_RTOL = 1e-10
SMALL = COLLISION_WAKE.format(nxy=16, nz=4, npart=300)


def _close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=what,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def sims():
    return (JSimulation(Inputs(SMALL), verbose=0),
            Simulation(TInputs(SMALL), device="cpu", verbose=0))


def _warm_plasma(sim, rng, ppc=None):
    """The port's plasma lanes of sim with random momenta, a few invalid."""
    cfg = sim.plasma_cfgs[0]
    if ppc is not None:
        cfg = dataclasses.replace(cfg, ppc=ppc)
    p = tpl.init_plasma(cfg, sim.geom, "cpu", torch.float64)
    n = p["x"].numel()
    u = 0.05 * rng.standard_normal((3, n))
    p["ux"], p["uy"] = torch.tensor(u[0]), torch.tensor(u[1])
    p["psi"] = torch.tensor(np.sqrt(1 + (u ** 2).sum(0)) - u[2])
    p["x"] = p["x"] + torch.tensor(rng.uniform(-0.2, 0.2, n))
    p["valid"][::13] = False
    return p


def _jax(p):
    return {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def test_collision_config_matches():
    deck = SMALL.replace("hipace.collisions = pp bp",
                         "hipace.collisions = pp bp c3\n"
                         "c3.species = plasma beam\nc3.CoulombLog = 7.")
    ref = JSimulation(Inputs(deck), verbose=0).cfg.collisions
    got = Simulation(TInputs(deck), device="cpu", verbose=0).cfg.collisions
    assert got == ref == (("pp", 0, 0, True, -1.0), ("bp", 0, 0, False, -1.0),
                          ("bp", 0, 0, False, 7.0))


def test_normalized_collisions_need_the_background_density():
    deck = SMALL.replace("hipace.background_density_SI = 1e24\n", "")
    with pytest.raises(ValueError, match="hipace.background_density_SI"):
        Simulation(TInputs(deck), device="cpu", verbose=0)


@pytest.mark.parametrize("ties", [False, True])
def test_shuffled_cell_sort_matches(sims, ties):
    """The cell sort by (cell, uniform); with ties forced among the
    uniforms (f32 draws over a million lanes tie thousands of times), both
    stable sorts keep lane order as jnp.argsort does."""
    jsim, tsim = sims
    rng = np.random.default_rng(2)
    p = _warm_plasma(tsim, rng)
    cell, ok = tc._cell_of(p["x"], p["y"], tsim.geom)
    jcell, jok = jc._cell_of(jnp.asarray(p["x"].numpy()),
                             jnp.asarray(p["y"].numpy()), jsim.geom)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    n = cell.numel()
    r = rng.uniform(size=n)
    if ties:
        r = np.round(r * 7) / 7          # 8 distinct values
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(r))
        ref = jc._shuffled_cell_sort(jcell, jax.random.PRNGKey(0))
    got = tc._shuffled_cell_sort(cell, torch.tensor(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("normalized", [True, False])
def test_pair_kick_matches(normalized):
    """The kick of 500 pairs, normalized units and SI (momenta u c, masses
    and charges in SI), with and without a given Coulomb logarithm."""
    from hipace_tpu_torch.constants import SI_c, SI_m_e, SI_q_e
    rng = np.random.default_rng(4)
    n = 500
    u1 = rng.standard_normal((3, n)) * [[0.3], [0.3], [50.]]
    u2 = rng.standard_normal((3, n)) * 0.05
    g1 = np.sqrt(1 + (u1 ** 2).sum(0))
    g2 = np.sqrt(1 + (u2 ** 2).sum(0))
    dens = rng.uniform(0.5, 2, (3, n)) * 1e24
    dens[2] = np.minimum(dens[0], dens[1])
    w1, w2 = rng.uniform(0.2, 1, n), rng.uniform(0.2, 1, n)
    lmd = rng.uniform(1e-9, 1e-8, n)
    dt = rng.uniform(1e-15, 1e-14, n)
    q, m = (-1.0, 1.0) if normalized else (-SI_q_e, SI_m_e)
    if not normalized:
        u1, u2 = u1 * SI_c, u2 * SI_c
    keys = list(jax.random.split(jax.random.PRNGKey(9), 4))
    draws = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (n,)))
                                   for k in keys]))
    for clog in (-1.0, 5.0):
        args = (*u1, g1, *u2, g2, *dens, q, m, w1, q, m, w2, dt, clog, lmd,
                normalized)
        ref = jc._pair_kick(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args], keys)
        got = tc._pair_kick(*[torch.tensor(a) if isinstance(a, np.ndarray)
                              else a for a in args], draws)
        for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
            _close(g, r)


@pytest.mark.parametrize("ppc", [(2, 2), (3, 1)])
def test_plasma_plasma_collision_matches(sims, ppc):
    """Intra-species: even cells (4 lanes) and odd ones (3, the cyclic
    second pass)."""
    jsim, tsim = sims
    p = _warm_plasma(tsim, np.random.default_rng(ppc[0]), ppc)
    cfg = dataclasses.replace(tsim.plasma_cfgs[0], ppc=ppc)
    jcfg = dataclasses.replace(jsim.plasma_cfgs[0], ppc=ppc)
    key = jax.random.PRNGKey(ppc[0] + 10)
    ref, _ = jc.plasma_plasma_collision(_jax(p), None, jsim.geom, jcfg, jcfg,
                                        jsim.pc, -1.0, 1e24, True, key, True)
    got, _ = tc.plasma_plasma_collision(
        p, None, tsim.geom, cfg, cfg, tsim.pc, -1.0, 1e24, True,
        as_torch(same_species_draws(key, p["x"].numel())), True)
    moved = 0
    for k in ("ux", "uy", "psi"):
        _close(got[k], ref[k], what=k)
        moved += int((got[k] != p[k]).sum())
    assert moved > p["x"].numel() // 2


def test_inter_species_with_duplicate_partners_matches(sims):
    """Two plasma species, four lanes per cell against one: every
    species-2 lane is picked by up to four lanes, and the port's explicit
    choice (the last picker's kick, R17) gives the JAX package's scatter
    on the CPU."""
    jsim, tsim = sims
    rng = np.random.default_rng(6)
    p1 = _warm_plasma(tsim, rng, (2, 2))
    p1["valid"][:] = True
    p2 = _warm_plasma(tsim, rng, (1, 1))
    p2["valid"][:] = True
    p2["x"] = tpl.init_plasma(tsim.plasma_cfgs[0], tsim.geom, "cpu",
                              torch.float64)["x"]
    cfg = tsim.plasma_cfgs[0]
    key = jax.random.PRNGKey(21)
    n1, n2 = p1["x"].numel(), p2["x"].numel()
    d = as_torch(inter_species_draws(key, n1, n2))
    ref1, ref2 = jc.plasma_plasma_collision(
        _jax(p1), _jax(p2), jsim.geom, jsim.plasma_cfgs[0],
        jsim.plasma_cfgs[0], jsim.pc, -1.0, 1e24, True, key, False)
    got1, got2 = tc.plasma_plasma_collision(
        p1, p2, tsim.geom, cfg, cfg, tsim.pc, -1.0, 1e24, True, d, False)
    for k in ("ux", "uy", "psi"):
        _close(got1[k], ref1[k], what=k)
        _close(got2[k], ref2[k], what=k)
    assert int((got2["ux"] != p2["ux"]).sum()) > n2 // 4


@pytest.mark.parametrize("order", ["AB", "BA"])
def test_duplicate_partner_takes_the_last_kick_r17(sims, order):
    """ROADMAP R17 on a hand-built case: two beam lanes A and B in one cell
    with one plasma lane; A's draws reject the plasma lane's kick (take2
    false), B's accept it. In both packages the plasma lane moves when B is
    the later lane and stays when A is: the last pairing wins."""
    jsim, tsim = sims
    g = tsim.geom
    x0 = g.prob_lo[0] + 5.5 * g.dx
    y0 = g.prob_lo[1] + 7.5 * g.dy
    lanes = {"A": (0.3, -0.2, 1500., 0.5, 0.9), "B": (-0.1, 0.4, 2500., 0.5,
                                                      0.1)}
    ux, uy, uz, w, r2 = (np.array(v) for v in zip(*(lanes[c]
                                                     for c in order)))
    beam = {"x": np.full(2, x0), "y": np.full(2, y0), "ux": ux, "uy": uy,
            "uz": uz, "w": w, "valid": np.ones(2, bool)}
    plasma = {"x": np.array([x0 + 0.1 * g.dx]), "y": np.array([y0]),
              "ux": np.array([0.01]), "uy": np.array([-0.02]),
              "psi": np.array([1.0]), "w": np.array([1.0]),
              "valid": np.ones(1, bool)}
    draws = {"sort": np.array([0.5]), "pick": np.array([0.3, 0.6]),
             "kick": np.stack([np.full(2, 0.4), np.full(2, 0.7),
                               np.zeros(2), r2])}
    queue = [draws["sort"], draws["pick"]] + list(draws["kick"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(queue.pop(0)))
        jb, jp = jc.beam_plasma_collision(
            {k: jnp.asarray(v) for k, v in beam.items()},
            {k: jnp.asarray(v) for k, v in plasma.items()}, jsim.geom,
            jsim.beam_cfgs[0], jsim.plasma_cfgs[0], jsim.pc, -1.0, 1e24,
            True, jax.random.PRNGKey(0), 1.0)
    tb, tp = tc.beam_plasma_collision(
        {k: torch.tensor(v) for k, v in beam.items()},
        {k: torch.tensor(v) for k, v in plasma.items()}, g,
        tsim.beam_cfgs[0], tsim.plasma_cfgs[0], tsim.pc, -1.0, 1e24, True,
        as_torch(draws), 1.0)
    for k in ("ux", "uy", "uz"):
        _close(tb[k], jb[k], what=k)
    for k in ("ux", "uy", "psi"):
        _close(tp[k], jp[k], what=k)
    moved = bool(tp["ux"][0] != plasma["ux"][0])
    assert moved == bool(np.asarray(jp["ux"])[0] != plasma["ux"][0])
    assert moved == (order == "AB")


def test_beam_plasma_collision_matches(sims):
    jsim, tsim = sims
    rng = np.random.default_rng(8)
    p = _warm_plasma(tsim, rng)
    nb = 400
    b = {"x": rng.uniform(-2, 2, nb), "y": rng.uniform(-2, 2, nb),
         "ux": rng.standard_normal(nb), "uy": rng.standard_normal(nb),
         "uz": 2000 + 10 * rng.standard_normal(nb),
         "w": rng.uniform(0.5, 2, nb), "valid": rng.uniform(size=nb) > 0.1}
    key = jax.random.PRNGKey(13)
    jb, jp = jc.beam_plasma_collision(
        {k: jnp.asarray(v) for k, v in b.items()}, _jax(p), jsim.geom,
        jsim.beam_cfgs[0], jsim.plasma_cfgs[0], jsim.pc, -1.0, 1e24, True,
        key, 1.0)
    tb, tp = tc.beam_plasma_collision(
        {k: torch.tensor(v) for k, v in b.items()}, p, tsim.geom,
        tsim.beam_cfgs[0], tsim.plasma_cfgs[0], tsim.pc, -1.0, 1e24, True,
        as_torch(inter_species_draws(key, nb, p["x"].numel())), 1.0)
    for k in ("ux", "uy", "uz"):
        _close(tb[k], jb[k], what=k)
        assert not np.array_equal(tb[k].numpy(), b[k])
    for k in ("ux", "uy", "psi"):
        _close(tp[k], jp[k], what=k)
    assert not torch.equal(tp["ux"], p["ux"])


def _step(deck, eager):
    """One step of each package from the JAX package's beam, the port on
    the JAX package's uniforms; the JAX step op by op where eager."""
    jsim = JSimulation(Inputs(deck), verbose=0)
    draws = JaxSliceDraws(jsim)
    if eager:
        with jax.disable_jit():
            jres = jsim.run_step(0)
    else:
        jres = jsim.run_step(0)
    tsim = Simulation(TInputs(deck), device="cpu", verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, jsim.time, [b.total_charge for b in jsim.beam_cfgs])
    tsim.slice_step.draws = draws
    tres = tsim.run_step(0)
    assert draws.done()
    return jres, tres, tsim


def test_collision_step_matches():
    """COLLISION_WAKE at 32^2 x 16: fields within 1e-10 of each one's
    largest value, the beam's momenta within 1e-12 of their largest,
    against the JAX package's step run op by op."""
    jres, tres, tsim = _step(COLLISION_WAKE.format(nxy=32, nz=16,
                                                   npart=1000), eager=True)
    ref, got = np.asarray(jres["diag"]), tres["diag"].numpy()
    for i, comp in enumerate(tsim.cfg.diag_comps):
        _close(got[:, i], ref[:, i], FIELD_RTOL, comp)
    valid = np.asarray(jres["binned"]["valid"])
    np.testing.assert_array_equal(tres["binned"]["valid"].numpy(), valid)
    for k in ("x", "ux", "uy", "uz"):
        _close(tres["binned"][k].numpy()[valid],
               np.asarray(jres["binned"][k])[valid], RTOL, k)


def test_same_species_kicks_do_not_stay_r18():
    """ROADMAP R18: in the JAX package's step a same-species collision's
    result is overwritten by its unchanged input, so a deck whose only
    collision is the plasma with itself gives the fields of no collision,
    in both packages."""
    base = COLLISION_WAKE.format(nxy=16, nz=8, npart=500) \
        + "plasma.u_std = 0.01 0.01 0.01\n"
    decks = (base.replace("hipace.collisions = pp bp",
                          "hipace.collisions = pp"),
             base.replace("hipace.collisions = pp bp", ""))
    jref = [np.asarray(JSimulation(Inputs(d), verbose=0).run_step(0)["diag"])
            for d in decks]
    tgot = [Simulation(TInputs(d), device="cpu", verbose=0).run_step(0)[
        "diag"].numpy() for d in decks]
    np.testing.assert_array_equal(jref[0], jref[1])
    np.testing.assert_array_equal(tgot[0], tgot[1])


# ---- the JAX package's reference-free checks through the port
def _physics_case(deck):
    sim = Simulation(TInputs(deck), device="cpu", verbose=0)
    cfg = sim.plasma_cfgs[0]
    gen = torch.Generator().manual_seed(1)
    p = tpl.init_plasma(cfg, sim.geom, "cpu", torch.float64,
                        draws=tpl.plasma_draws(cfg, sim.geom, gen, "cpu",
                                               torch.float64))
    return sim, cfg, p, gen


def _energy(pp):
    v = pp["valid"]
    g = (1 + pp["ux"][v] ** 2 + pp["uy"][v] ** 2 + pp["psi"][v] ** 2) \
        / (2 * pp["psi"][v])
    return float((g - 1.0).sum())


def _collide(sim, cfg, p, gen):
    n = p["x"].numel()
    d = {"sort": torch.rand(n, generator=gen, dtype=torch.float64),
         "kick": torch.rand((4, n), generator=gen, dtype=torch.float64),
         "wrap kick": torch.rand((4, n), generator=gen, dtype=torch.float64)}
    return tc.plasma_plasma_collision(p, p, sim.geom, cfg, cfg, sim.pc, -1.0,
                                      1e28, True, d, True)[0]


def test_intra_species_isotropization():
    """test_collisions.py::test_intra_species_isotropization: 200
    collisions of an electron plasma with Tx >> Ty isotropize it and keep
    its energy within 2%."""
    sim, cfg, p0, gen = _physics_case(JAX_DECK)
    v = p0["valid"]
    sx0, sy0 = float(p0["ux"][v].std()), float(p0["uy"][v].std())
    assert sx0 > 5 * sy0
    p = p0
    for _ in range(200):
        p = _collide(sim, cfg, p, gen)
    sx1, sy1 = float(p["ux"][v].std()), float(p["uy"][v].std())
    assert sx1 < 0.95 * sx0, f"sx {sx0} -> {sx1}"
    assert sy1 > 1.5 * sy0, f"sy {sy0} -> {sy1}"
    e0, e1 = _energy(p0), _energy(p)
    assert abs(e1 - e0) / e0 < 0.02, f"energy {e0} -> {e1}"


def test_odd_cell_cyclic_reuse_collides_every_particle():
    """test_collisions.py::test_odd_cell_cyclic_reuse_collides_every_
    particle: with 3 lanes per cell every lane collides, and the kicks
    conserve energy to 1e-6."""
    sim, cfg, p0, gen = _physics_case(JAX_DECK.replace("plasma.ppc = 4 4",
                                                       "plasma.ppc = 3 1"))
    p1 = _collide(sim, cfg, p0, gen)
    v = p0["valid"]
    changed = (p1["ux"] != p0["ux"])[v].double().mean()
    assert float(changed) > 0.99, f"only {float(changed):.2%} collided"
    assert abs(_energy(p1) - _energy(p0)) / _energy(p0) < 1e-6
