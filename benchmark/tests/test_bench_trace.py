"""The traced window's arithmetic and the per-layer readers, on a made-up
trace."""

import pytest

from benchmark import manifest
from benchmark.trace import TraceRun, breakdown

K1 = "void hipace::deposit_kernel<double>(double*)"
K3 = "void hipace::mg_solve_kernel<double, false, false, 1024>(x)"
EW = "void at::native::vectorized_elementwise_kernel<4>(y)"
D2H = "Memcpy DtoH (Device -> Pinned)"


def made_up(cfg, k1_calls=((13, 4000, 35, 35, 8),), cycles=(3,)):
    # window 0..1000 ns; busy 100-300 (two overlapping), 500-600, 900-950;
    # the last activity lies outside the window
    events = [(K1, 100, 250), (EW, 200, 300), (D2H, 500, 600),
              (K3, 900, 950), (EW, 2000, 2100)]
    spans = [("time step", 50, 990), ("slice step", 60, 400),
             ("slice step", 450, 980)]
    return TraceRun(events=events, window=(0, 1000), n_slices=2,
                    spans=spans, k1_calls=list(k1_calls),
                    mg_cycles=list(cycles), config=cfg)


def test_union_gaps_breakdown(small):
    tr = made_up(small("explicit.2047"))
    assert tr.busy_s() == pytest.approx(350e-9)
    assert [(s, e) for s, e, _ in tr.gaps()] == [(0, 100), (300, 500),
                                                 (600, 900), (950, 1000)]
    bd = breakdown(tr)
    assert bd["device_ops"][0] == [K1, pytest.approx(150e-9)]
    idle = dict((k, v) for k, v in bd["idle_gaps"])
    assert idle["between steps"] == pytest.approx(100e-9)
    assert idle["slice step, after a device-to-host read"] == \
        pytest.approx(300e-9)
    assert idle["slice step"] == pytest.approx(250e-9)


def test_readers(small):
    cfg = small("explicit.2047")
    tr = made_up(cfg)

    def read(name, run=tr):
        return manifest.reader(name)(run)

    assert read("device_idle_pct") == pytest.approx(65.0)
    assert read("launches_per_slice") == 2.0
    assert read("host_syncs_per_slice") == 0.5
    assert read("elementwise_ms_per_slice") == pytest.approx(100e-6 / 2)
    # K1: 8 * (15 * 4000 + 2 * 13 * 35^2) bytes at 3.35e12 B/s in 150 ns
    k1 = 8 * (15 * 4000 + 2 * 13 * 35 * 35) / 3.35e12 / 150e-9 * 100
    assert read("k1_roofline_pct") == pytest.approx(k1)
    assert read("k1_roofline_pct", made_up(cfg, k1_calls=())) is None
    assert read("k3_roofline_pct") > 0
    assert read("k3_roofline_pct", made_up(cfg, cycles=(3, 3))) is None
    assert read("mg_vcycles_per_slice") == 3.0
