"""The reference's checksum cases through the port, shared by
tests/test_torch_checksums.py, test_torch_checksums_b.py and
test_torch_checksums_c.py.

The method of ``tests/test_checksums.py``: run a reference deck with the
case's overrides, sum |Q| over each field and beam attribute of the last
step's openPMD file, and compare with the reference's own benchmark JSON at
the JAX package's tolerances (the case list and tolerances are imported
from there). Only the cases off the ``HEAVY`` list run, split over the
three files by their position in that list (case i goes to file i % 3), so
that a run that spreads test files over workers spreads them too. A case
runs only where it is no larger than 128^2 cells x 256 slices x 3 steps and
its reckoned time fits what is left of its file's budget; a case whose deck
selects a part the port does not have skips, and the reason names the item
of the port queue in ROADMAP.md. Every case skips where the reference's
checkout is absent.

The reckoning: one step of a slice costs A + B * cells per plasma species
on one thread in float64, times the predictor-corrector's factor where that
solver runs (tools/measure_torch_cpu_cost.py: A = 37.76 ms, B = 3.861 us,
factor 5.24), times the laser's factor where a laser runs (1.73, the same
tool's LASER_WAKE against the flagship at 64^2, from a later run) and the
collisions' where hipace.collisions is set (1.46, COLLISION_WAKE against
the flagship at 64^2, from a later run), with a margin of 2 for the
machine's variation. Field ionization needs no factor: its product's spawn
slots count as a species, and IONIZATION_WAKE at 64^2 took 1.02 times what
A + B * cells reckons for its two species (the same run).
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
PARTS = 3
SLICE_S, CELL_S, PC_FACTOR, MARGIN = 37.76e-3, 3.861e-6, 5.24, 2.0
LASER_FACTOR = 1.73
COLLISION_FACTOR = 1.46
ARGS = "name,deck,overrides,rtol,skip_fields,skip_particles"

LIGHT = [c for c in CASES if c[0] not in HEAVY]


def part(k: int) -> list:
    """The cases of file k: every PARTS-th of LIGHT from the k-th."""
    return LIGHT[k::PARTS]


def reckon_seconds(inputs: Inputs) -> float:
    """The time a case's run should take on one thread, margin included."""
    nx, ny, nz = inputs.query_list("amr.n_cell", [1, 1, 1], int)
    steps = inputs.query("max_step", 0, int) + 1
    species = len([n for n in inputs.query_list("plasmas.names", [], str)
                   if n != "no_plasma"])
    per_slice = SLICE_S + CELL_S * nx * ny * max(species, 1)
    if inputs.query("hipace.bxby_solver", "explicit", str) != "explicit":
        per_slice *= PC_FACTOR
    if [n for n in inputs.query_list("lasers.names", [], str)
            if n != "no_laser"]:
        per_slice *= LASER_FACTOR
    if inputs.query_list("hipace.collisions", [], str):
        per_slice *= COLLISION_FACTOR
    return MARGIN * steps * nz * per_slice


class Budget:
    """The seconds a file's cases may take in all, spent in case order."""

    def __init__(self, seconds: float):
        self.left = seconds

    def take(self, seconds: float, what: str) -> None:
        if seconds > self.left:
            pytest.skip(f"{what}: reckoned {seconds:.0f} s, more than the "
                        f"{self.left:.0f} s left of this file's budget")
        self.left -= seconds


def run_case(name, deck, overrides, rtol, skip_fields, skip_particles,
             tmp_path, budget: Budget):
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
                    "128^2 x 256 x 3 these files run")
    try:
        sim = Simulation(inputs, device="cpu", verbose=0)
    except NotImplementedError as err:
        pytest.skip(str(err))
    budget.take(reckon_seconds(inputs), f"{nx}x{ny}x{nz} x {steps} steps")
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
