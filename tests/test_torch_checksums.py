"""The reference's checksum cases through the port, on CPU in float64.

The method of ``tests/test_checksums.py``: run a reference deck with the
case's overrides, sum |Q| over each field and beam attribute of the last
step's openPMD file, and compare with the reference's own benchmark JSON at
the JAX package's tolerances (the case list and tolerances are imported
from there). Only the cases off the ``HEAVY`` list run, and only where the
run is no larger than 128^2 cells x 256 slices x 3 steps. A case whose deck
selects a part the port does not have skips, and the reason names the item
of the port queue in ROADMAP.md. The whole file skips where the reference's
checkout is absent.
"""

import json
import os

import numpy as np
import pytest
import torch

from hipace_tpu_torch.parser import Inputs
from hipace_tpu_torch.pipeline.simulation import Simulation
from test_checksums import (ABS_NOISE, BEAM_MAP, BENCH, CASES, HEAVY, REF,
                            _find_field)

torch.set_num_threads(1)
MAX_CELL_STEPS = 128 * 128 * 256 * 3

LIGHT = [c for c in CASES if c[0] not in HEAVY]


@pytest.mark.parametrize(
    "name,deck,overrides,rtol,skip_fields,skip_particles", LIGHT,
    ids=[c[0] for c in LIGHT])
def test_reference_checksum_through_the_port(name, deck, overrides, rtol,
                                             skip_fields, skip_particles,
                                             tmp_path):
    if not os.path.isdir(REF):
        pytest.skip(f"{REF} is not present")
    if not os.path.isfile(deck):
        pytest.skip(f"{deck} is not present")
    import h5py
    with open(f"{BENCH}/{name}.json") as f:
        bench = json.load(f)
    prefix = str(tmp_path / "openpmd")
    inputs = Inputs.from_file(deck, overrides=list(overrides) + [
        f"hipace.file_prefix={prefix}", "hipace.openpmd_backend=h5"])
    nx, ny, nz = inputs.query_list("amr.n_cell", [1, 1, 1], int)
    steps = inputs.query("max_step", 0, int) + 1
    if nx * ny * nz * steps > MAX_CELL_STEPS:
        pytest.skip(f"{nx}x{ny}x{nz} cells x {steps} steps is above the "
                    "128^2 x 256 x 3 this file runs")
    try:
        sim = Simulation(inputs, device="cpu", verbose=0)
    except NotImplementedError as err:
        pytest.skip(str(err))
    # in-situ output, where the deck asks for it, goes to the test's folder
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        sim.evolve()
    finally:
        os.chdir(cwd)

    it = sim.max_step
    with h5py.File(os.path.join(prefix, f"openpmd_{it:06d}.h5")) as f:
        mesh = f[f"data/{it}/fields"]
        fmax = max(abs(v) for v in bench["lev=0"].values()) or 1.0
        fabs = max(ABS_NOISE, 1e-8 * fmax)
        for field, ref in bench["lev=0"].items():
            if field in skip_fields:
                continue
            ds = _find_field(mesh, field)
            assert ds is not None, f"{name}: field {field} not written"
            ours = float(np.sum(np.abs(np.array(ds))))
            assert ours == pytest.approx(ref, rel=rtol, abs=fabs), \
                f"{name}: {field} checksum {ours} vs reference {ref}"
        if skip_particles is True:
            return
        askip = skip_particles if isinstance(skip_particles, tuple) else ()
        for species, attrs in bench.items():
            if species.startswith("lev="):
                continue
            gp = f[f"data/{it}/particles/{species}"]
            pmax = max(abs(v) for a, v in attrs.items()
                       if a in BEAM_MAP) or 1.0
            pabs = max(1e-8, 1e-8 * pmax)
            for attr, ref in attrs.items():
                if attr not in BEAM_MAP or attr in askip:
                    continue
                ours = float(np.sum(np.abs(np.array(gp[BEAM_MAP[attr]]))))
                assert ours == pytest.approx(ref, rel=rtol, abs=pabs), \
                    f"{name}: {species}.{attr} {ours} vs reference {ref}"
