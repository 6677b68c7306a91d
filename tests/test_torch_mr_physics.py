"""The JAX package's reference-free mesh-refinement checks
(``tests/test_mr.py``) through the port, with their own decks and
thresholds, on the CPU in float64: the level's Ez against a uniformly fine
run and the coarse run's error, for the explicit solver and the
predictor-corrector, and two nested levels agreeing with each other. No
JAX run."""

import numpy as np
import torch

from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation

torch.set_num_threads(1)

# tests/test_mr.py:15-55
BASE = """
amr.n_cell = {nx} {nx} 24
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 30000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 0.01
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 2 2
plasma.element = electron
diagnostic.output_period = 1
hipace.openpmd_backend = json
{extra}
"""

MR = """amr.max_level = 1
mr_lev1.n_cell = 32 32
mr_lev1.patch_lo = -2. -2. -4.
mr_lev1.patch_hi =  2.  2.  0.
plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)
plasma.fine_ppc = 8 8
diagnostic.names = lev0 lev1
lev1.base_geometry = level_1
lev1.field_data = Ez
"""


def _run(nx, extra, overrides=""):
    sim = Simulation(Inputs(BASE.format(nx=nx, extra=extra) + overrides),
                     device="cpu", verbose=0)
    return sim, sim.run_step(0)


def _fine_vs_truth(overrides):
    """(err_fine, err_coarse) at slices 14 and 7, as test_mr.py reckons
    them."""
    s_mr, r_mr = _run(32, MR, overrides)
    s_tr, r_tr = _run(128, "", overrides)
    s_co, r_co = _run(32, "", overrides)
    gf = s_mr.mr_levels[0].geom
    assert (s_mr.mr_levels[0].zeta_lo, s_mr.mr_levels[0].zeta_hi) == (5, 18)
    xt = (np.arange(gf.nx) + 0.5) * gf.dx + gf.prob_lo[0]
    it = np.round((xt + 8.0) / 0.125 - 0.5).astype(int)
    itc = np.round((xt + 8.0) / 0.5 - 0.5).astype(int)
    cc = s_tr.cfg.diag_comps.index("Ez")
    ca = s_co.cfg.diag_comps.index("Ez")
    out = []
    for z in (14, 7):
        fine = r_mr["diagf_lev1"][z, 0].numpy()
        truth = r_tr["diag"][z, cc].numpy()[np.ix_(it, it)]
        coarse = r_co["diag"][z, ca].numpy()[np.ix_(itc, itc)]
        den = np.abs(truth).max()
        out.append((np.abs(fine - truth).max() / den,
                    np.abs(coarse - truth).max() / den))
    return out


def test_mr_fine_level_beats_coarse():
    """test_mr.py::test_mr_fine_level_beats_coarse."""
    for err_fine, err_coarse in _fine_vs_truth(""):
        assert err_fine < 0.10, err_fine
        assert err_fine < 0.35 * err_coarse, (err_fine, err_coarse)


def test_mr_predictor_corrector():
    """test_mr.py::test_mr_predictor_corrector."""
    for err_fine, err_coarse in _fine_vs_truth(
            "hipace.bxby_solver = predictor-corrector\n"):
        assert err_fine < 0.06, err_fine
        assert err_fine < 0.2 * err_coarse, (err_fine, err_coarse)


def test_mr_two_levels_smoke():
    """test_mr.py::test_mr_two_levels_smoke."""
    sim, res = _run(32, """amr.max_level = 2
mr_lev1.n_cell = 32 32
mr_lev1.patch_lo = -2. -2. -4.
mr_lev1.patch_hi =  2.  2.  0.
mr_lev2.n_cell = 32 32
mr_lev2.patch_lo = -0.9 -0.9 -3.
mr_lev2.patch_hi =  0.9  0.9 -1.
plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)
plasma.fine_ppc = 8 8
diagnostic.names = lev0 lev1 lev2
lev1.base_geometry = level_1
lev1.field_data = Ez
lev2.base_geometry = level_2
lev2.field_data = Ez
""")
    assert len(sim.mr_levels) == 2
    lv2 = sim.mr_levels[1]
    g1, g2 = sim.mr_levels[0].geom, lv2.geom
    z = (lv2.zeta_lo + lv2.zeta_hi) // 2
    ez1 = res["diagf_lev1"][z, 0].numpy()
    ez2 = res["diagf_lev2"][z, 0].numpy()
    assert np.isfinite(ez2).all()
    x2 = (np.arange(g2.nx) + 0.5) * g2.dx + g2.prob_lo[0]
    i1 = np.clip(((x2 - g1.prob_lo[0]) / g1.dx - 0.5).round().astype(int),
                 0, g1.nx - 1)
    ez1_on2 = ez1[np.ix_(i1, i1)]
    err = np.abs(ez2 - ez1_on2).max() / max(np.abs(ez1_on2).max(), 1e-30)
    assert err < 0.35, err
