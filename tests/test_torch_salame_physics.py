"""SALAME through the port: ROADMAP R20 against the JAX package, and the
reference-free checks of ``tests/test_salame.py`` (the on-axis Ez flattened
across the witness, alone and with a mesh-refinement level) on the port
alone, at their own thresholds, on the CPU in float64."""

import numpy as np
import torch

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation as JSimulation
from hipace_tpu_torch.convert import carry_state
from hipace_tpu_torch.decks import salame_wake
from hipace_tpu_torch.parser import Inputs as TInputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_torch_salame import FIELD_RTOL, _deck

torch.set_num_threads(1)


def test_predictor_corrector_runs_without_salame_r20():
    """ROADMAP R20: the JAX package's predictor-corrector step has no SALAME
    block, so a do_salame deck runs without SALAME and without a word; the
    port matches: no SALAME output, the JAX package's fields and weights,
    and the same step as with witness.do_salame = 0."""
    deck = _deck(16, 32, 3000, "hipace.bxby_solver = predictor-corrector\n")
    jsim = JSimulation(Inputs(deck), verbose=0)
    jres = jsim.run_step(0)
    assert jsim.cfg.salame_active and "salame_W" not in jres
    runs = []
    for extra in ("", "witness.do_salame = 0\n"):
        tsim = Simulation(TInputs(deck + extra), device="cpu", verbose=0)
        carry_state(tsim, {k: np.array(v) for k, v in jsim.binned.items()},
                    jsim.dt, jsim.time)
        runs.append(tsim.run_step(0))
    assert not any(k.startswith("salame") for k in runs[0])
    assert torch.equal(runs[0]["diag"], runs[1]["diag"])
    assert torch.equal(runs[0]["binned"]["w"], runs[1]["binned"]["w"])
    ref = np.asarray(jres["diag"])
    np.testing.assert_allclose(runs[0]["diag"].numpy(), ref, rtol=0,
                               atol=FIELD_RTOL * np.abs(ref).max())
    assert runs[0]["pc_iters"] == np.asarray(jres["pc_iters"]).tolist()[::-1]


def _port_run(overrides=""):
    """tests/test_salame.py's _run through the port: the on-axis Ez (the
    four central cells' mean), zeta, the result."""
    sim = Simulation(salame_wake(32, 64, 30000, overrides), device="cpu",
                     verbose=0)
    res = sim.run_step(0)
    ez = res["diag"][:, 0].numpy()
    ny, nx = ez.shape[1:]
    line = 0.25 * (ez[:, ny // 2 - 1, nx // 2 - 1] + ez[:, ny // 2 - 1, nx // 2]
                   + ez[:, ny // 2, nx // 2 - 1] + ez[:, ny // 2, nx // 2])
    g = sim.geom
    zeta = (np.arange(g.nz) + 0.5) * g.dz + g.prob_lo[2]
    return line, zeta, res


def test_salame_flattens_ez():
    """test_salame.py::test_salame_flattens_ez through the port."""
    line_s, zeta, res_s = _port_run()
    line_n, _, _ = _port_run("witness.do_salame = 0\n")
    inside = (zeta > -2.35) & (zeta < -1.5)
    spread_s = np.ptp(line_s[inside])
    spread_n = np.ptp(line_n[inside])
    assert spread_s < 0.4 * spread_n, (spread_s, spread_n)
    b = res_s["binned"]
    bid, v, w = (b[k].reshape(-1).numpy() for k in ("beam_id", "valid", "w"))
    wit = v & (bid == 1)
    assert wit.sum() > 0 and w[wit].sum() > 0
    assert np.std(w[wit]) / np.mean(w[wit]) > 0.01
    drv = v & (bid == 0)
    assert np.allclose(np.std(w[drv]), 0.0)


def test_salame_with_mr():
    """test_salame.py::test_salame_with_mr through the port."""
    mr = ("amr.max_level = 1\nmr_lev1.n_cell = 32 32\n"
          "mr_lev1.patch_lo = -2. -2. -7.\nmr_lev1.patch_hi = 2. 2. 5.\n"
          "plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)\n"
          "plasma.fine_ppc = 4 4\n")
    line_s, zeta, res = _port_run(mr)
    line_n, _, _ = _port_run(mr + "witness.do_salame = 0\n")
    assert np.isfinite(res["diag"].numpy()).all()
    assert float(res["salame_W"].abs().max()) > 0
    inside = (zeta > -2.35) & (zeta < -1.5)
    spread_s = np.ptp(line_s[inside])
    spread_n = np.ptp(line_n[inside])
    assert spread_s < 0.4 * spread_n, (spread_s, spread_n)
