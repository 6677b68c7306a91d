"""The beam drawn from the seed, and its openPMD file."""

import math

import numpy as np
import torch

from benchmark import beam
from hipace_tpu_torch.diagnostics.openpmd import read_beam

SEED = 2**31 + 987654321          # above 32 signed bits


def test_same_seed_same_beam_other_seed_other(small):
    cfg = small("explicit.2047")
    a, b = beam.draw(cfg, SEED, "cpu"), beam.draw(cfg, SEED, "cpu")
    c = beam.draw(cfg, SEED + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    for k in ("x", "y", "z"):
        assert not torch.equal(a[k], c[k])


def test_beam_in_the_domain_with_the_deck_density(small):
    cfg = small("explicit.2047", nxy=63, nz=16, npart=50000)
    b = beam.draw(cfg, SEED, "cpu")
    lo, hi = cfg["geometry.prob_lo"], cfg["geometry.prob_hi"]
    assert b["z"].min() >= lo[2] and b["z"].max() < hi[2]
    assert abs(float(b["x"].std()) - 0.3) < 0.01
    # the mean of the normal pdf truncated to (-6, 2)
    a, c = (-6.0 + 1.0) / 1.41, (2.0 + 1.0) / 1.41
    phi = [math.exp(-0.5 * t * t) / math.sqrt(2 * math.pi) for t in (a, c)]
    cdf = [0.5 * math.erfc(-t / math.sqrt(2)) for t in (a, c)]
    mean = -1.0 + 1.41 * (phi[0] - phi[1]) / (cdf[1] - cdf[0])
    assert abs(float(b["z"].mean()) - mean) < 0.02
    # the weights' sum: peak density x integral of the pdf x 2 pi sx sy,
    # in cell volumes
    nx, ny, nz = cfg["amr.n_cell"]
    vol = 16.0 / nx * 16.0 / ny * 8.0 / nz
    integral = 1.41 * math.sqrt(2 * math.pi) * 0.5 * (
        math.erf((2.0 + 1.0) / (1.41 * math.sqrt(2)))
        - math.erf((-6.0 + 1.0) / (1.41 * math.sqrt(2))))
    want = 3.0 * integral * 2 * math.pi * 0.09 / vol
    assert abs(float(b["w"].sum()) / want - 1.0) < 1e-12
    assert torch.all(b["uz"] == 2000.0) and torch.all(b["ux"] == 0.0)


def test_openpmd_file_reads_back_exactly(small, tmp_path, monkeypatch):
    cfg = small("explicit.2047")
    b = beam.draw(cfg, SEED, "cpu")
    for h5 in (True, False):
        if not h5:
            # the card's machine has no h5py: the json layout
            monkeypatch.setattr(beam, "_h5py", lambda: None)
        folder = tmp_path / ("h5" if h5 else "json")
        folder.mkdir()
        path = beam.write_openpmd(b, str(folder))
        got = read_beam(path, 0, "beam")
        assert path.endswith(".h5" if h5 else ".json")
        for k, v in b.items():
            assert np.array_equal(got[k], v.numpy()), (h5, k)
