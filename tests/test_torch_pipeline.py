"""The port's pipelined window (``hipace_tpu_torch/parallel/pipeline.py``)
on CPU in float64, its stages on a list of CPU devices.

The decks and the JAX runs are those of ``tests/test_pipeline_parallel.py``.
Every window starts from the JAX package's beam (``convert.carry_state``)
and must equal both the port's serial steps from that beam and the JAX
package's ``pipelined_evolve`` on the conftest's virtual mesh (one compile
per deck and stage count), with equal valid counts and the JAX tests' own
tolerances: DECK at 2 and 4 stages (beam; against the serial steps also
the V-cycles and fields of every slice of every stage), LASER_DECK (beam
and the laser stream after the window) and MR_DECK (beam; against the
serial steps also both levels' fields and V-cycles). ``pipelined_evolve``
returns no fields, and the JAX package's ``pipelined_window``, which does,
stops on MR_DECK with a leaked tracer in its level coupler, so the fields
are held to the port's serial steps, which ``tests/test_torch_mr.py`` and
``tests/test_torch_slice.py`` hold to the JAX package's steps. The receive
rows keep every lane where the JAX package's fixed capacity drops some.
``tests/test_torch_pipeline_output.py`` holds the time loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipace_tpu.geometry import Geometry as JGeometry
from hipace_tpu.parallel import pipeline as jpp
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.parallel import pipeline as tpp
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.particles import beam as bm
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_pipeline_parallel import DECK, LASER_DECK, MR_DECK

torch.set_num_threads(1)
CPU = torch.device("cpu")
ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w")
RTOL, ATOL = 1e-9, 1e-11


def _valid_lanes(b):
    """The valid lanes of a binned or flat beam as numpy arrays."""
    v = np.asarray(b["valid"]).reshape(-1)
    return {k: np.asarray(b[k]).reshape(-1)[v] for k in ATTRS}


def _same_beam(got, ref, rtol=RTOL, atol=ATOL):
    """Equal valid counts and lanes, matched by z (unique for these random
    beams), as the JAX package's pipeline tests match them."""
    g, r = _valid_lanes(got), _valid_lanes(ref)
    assert g["z"].size == r["z"].size, (g["z"].size, r["z"].size)
    ig, ir = np.argsort(g["z"], kind="stable"), np.argsort(r["z"],
                                                           kind="stable")
    for k in ATTRS:
        np.testing.assert_allclose(g[k][ig], r[k][ir], rtol=rtol, atol=atol,
                                   err_msg=k)


def _serial(tsim, n):
    """n serial steps of the port from tsim's beam: each step's result."""
    out, binned, stream = [], tsim.binned, None
    for s in range(n):
        res = tsim._time_step(binned, s * tsim.dt, tsim.dt, s, stream)
        out.append(res)
        binned = res["binned"]
        stream = res.get("laser_stream")
    return out


def _window(tsim, n):
    return tpp.pipelined_window(tsim, tsim.binned, [tsim.dt] * n,
                                [s * tsim.dt for s in range(n)], 0,
                                [CPU] * n)


def _from_jax(deck, overrides=()):
    """The JAX package's simulation of deck and the port's (with overrides
    that change no physics), which starts from the JAX beam."""
    jsim = JSimulation(Inputs(deck), verbose=0)
    tsim = Simulation(TInputs(deck, overrides=list(overrides)), device="cpu",
                      verbose=0)
    carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                jsim.dt, 0.0, [b.total_charge for b in jsim.beam_cfgs])
    return jsim, tsim


def _jax_window(jsim, n, seed):
    """The JAX package's pipelined_evolve of n steps on n mesh devices:
    (beam, laser stream or None)."""
    b0 = {k: v for k, v in jsim.binned.items() if k != "n_dropped"}
    beam, _, stream = jpp.pipelined_evolve(jsim.cfg, jsim.dtype, b0, jsim.dt,
                                           jax.random.PRNGKey(seed),
                                           devices=jax.devices()[:n])
    return beam, stream


def _rebinned(tsim, win):
    return bm.bin_beam(win["beam"], tsim.geom, tsim.beam_cap)


@pytest.fixture(scope="module")
def deck_runs():
    """DECK from the JAX package's beam: four serial port steps, the port's
    windows of 2 and 4 stages, and the JAX package's pipelined_evolve on
    two and four mesh devices (key 7, as its test; the plasma is cold)."""
    jsim, tsim = _from_jax(DECK)
    return {"serial": _serial(tsim, 4), 2: _window(tsim, 2),
            4: _window(tsim, 4), "sim": tsim,
            "jax": {n: _jax_window(jsim, n, 7)[0] for n in (2, 4)}}


@pytest.mark.parametrize("n", [2, 4])
def test_window_matches_serial(deck_runs, n):
    serial, win = deck_runs["serial"], deck_runs[n]
    ref = serial[n - 1]["binned"]
    flat = win["beam"]
    # no lane is dropped: the wrapped rows hold every lane the serial
    # re-binning keeps, and the window's re-binning drops none
    assert int(flat["valid"].sum()) == int(ref["valid"].sum()) > 1900
    got = _rebinned(deck_runs["sim"], win)
    assert got["n_dropped"] == 0
    _same_beam(got, ref)
    for d in range(n):
        res, sres = win["stages"][d], serial[d]
        assert res["mg_cycles"] == sres["mg_cycles"]
        np.testing.assert_allclose(res["diag"].numpy(), sres["diag"].numpy(),
                                   rtol=RTOL, atol=ATOL)
        # stage d's input is serial step d's pre-push beam
        if d:
            _same_beam(win["inputs"][d], serial[d - 1]["binned"])


def test_window_matches_the_jax_pipeline(deck_runs):
    _same_beam(_rebinned(deck_runs["sim"], deck_runs[2]),
               deck_runs["jax"][2])


def test_four_stage_window_matches_the_jax_pipeline(deck_runs):
    _same_beam(_rebinned(deck_runs["sim"], deck_runs[4]),
               deck_runs["jax"][4])


def test_laser_window_matches_serial():
    """LASER_DECK, two stages: the beam and the laser stream after the
    window against the port's serial steps and the JAX package's
    pipelined_evolve (key 3, as its test), at the JAX test's rtol 1e-9 /
    atol 1e-20 on the beam and 1e-9 / 1e-12 on the stream."""
    jsim, tsim = _from_jax(LASER_DECK)
    serial = _serial(tsim, 2)
    win = _window(tsim, 2)
    jbeam, jstream = _jax_window(jsim, 2, 3)
    got = _rebinned(tsim, win)
    assert got["n_dropped"] == 0
    for ref, stream in ((serial[-1]["binned"], serial[-1]["laser_stream"]),
                        (jbeam, jstream)):
        _same_beam(got, ref, atol=1e-20)
        for a, b in zip(win["laser_stream"], stream):
            b = np.asarray(b)
            assert np.abs(b).max() > 0.1
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)
    assert [r["laser_cycles"] for r in win["stages"]] == [
        r["laser_cycles"] for r in serial]


# the fine level's fields on every slice it runs, which the deck leaves out
MR_LEV1 = ["diagnostic.output_period = 1", "diagnostic.names = lev0 lev1",
           "lev1.base_geometry = level_1", "lev1.field_data = all"]


def test_mr_window_matches_serial():
    """MR_DECK, two stages: the beam after the window against the port's
    serial steps and the JAX package's pipelined_evolve; both levels'
    fields on every slice and their V-cycles against the serial steps."""
    jsim, tsim = _from_jax(MR_DECK, MR_LEV1)
    serial = _serial(tsim, 2)
    win = _window(tsim, 2)
    jbeam, _ = _jax_window(jsim, 2, 7)
    got = _rebinned(tsim, win)
    assert got["n_dropped"] == 0
    _same_beam(got, serial[-1]["binned"])
    _same_beam(got, jbeam)
    for res, sres in zip(win["stages"], serial):
        assert res["mg_cycles"] == sres["mg_cycles"]
        assert res["mg_cycles_lev1"] == sres["mg_cycles_lev1"]
        for k in ("diag", "diagf_lev1"):
            assert float(sres[k].abs().max()) > 0
            np.testing.assert_allclose(res[k].numpy(), sres[k].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_bin_block_keeps_what_the_jax_capacity_drops():
    """Three numpy-seeded blocks (a tenth dead, some lanes outside the z
    domain) binned one after the other: every valid lane inside the domain
    lands in its slice, as in the JAX package's _bin_block_into, whose
    capacity cap2 = 4 drops the lanes beyond it; the port keeps them.
    A row holds the later blocks first (a sweep emits from the head), a
    tail block (the slip carry) last."""
    inputs = Inputs(DECK)
    jg = JGeometry.from_inputs(inputs, 2)
    tsim = Simulation(TInputs(DECK), device="cpu", verbose=0)
    g, nz, cap2 = tsim.geom, tsim.geom.nz, 4
    rng = np.random.default_rng(11)
    jbuf = {k: jnp.zeros((nz, cap2), jnp.int32 if k in bm.BEAM_INT_ATTRS
                         else bool if k == "valid" else jnp.float64)
            for k in bm.ALL_ATTRS}
    counters = jnp.zeros((nz,), jnp.int32)
    rows = [[] for _ in range(nz)]
    blocks = []
    for ib in range(4):
        n = 200
        blk = {k: rng.normal(size=n) for k in bm.BEAM_ATTRS}
        blk["z"] = rng.uniform(g.prob_lo[2] - 0.5, g.prob_hi[2] + 0.5, n)
        blk["x"] = np.arange(n) + 1000.0 * ib        # the lane's name
        blk["nsub"] = np.zeros(n, np.int32)
        blk["beam_id"] = np.zeros(n, np.int32)
        blk["valid"] = rng.uniform(size=n) > 0.1
        blocks.append(blk)
        jbuf, counters = jpp._bin_block_into(
            jbuf, counters, {k: jnp.asarray(v) for k, v in blk.items()}, jg,
            cap2)
        tpp.bin_blocks_into([(rows, {k: torch.as_tensor(v)
                                     for k, v in blk.items()})], g,
                            tail=ib == 3)
    dropped = 0
    for i in range(nz):
        def lanes(ib):
            blk = blocks[ib]
            return [x for x, z, v in zip(blk["x"], blk["z"], blk["valid"])
                    if v and int(np.floor((z - g.prob_lo[2]) / g.dz)) == i]
        got = [float(x) for b in rows[i] for x in b["x"]]
        assert all(bool(b["valid"].all()) for b in rows[i])
        assert got == lanes(2) + lanes(1) + lanes(0) + lanes(3)
        want = lanes(0) + lanes(1) + lanes(2) + lanes(3)
        kept = list(np.asarray(jbuf["x"][i])[np.asarray(jbuf["valid"][i])])
        assert kept == want[:cap2]
        dropped += len(want) - len(kept)
    assert dropped > 50
