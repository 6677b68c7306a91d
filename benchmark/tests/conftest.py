"""Shared helpers of the benchmark's tests: the manifest, and a cell's
configuration cut to a size the CPU runs in seconds."""

import json

import pytest

from benchmark import manifest


@pytest.fixture(scope="session")
def man():
    return manifest.Manifest()


def small_config(cfg: dict, nxy: int = 31, nz: int = 8,
                 npart: int = 2000) -> dict:
    """cfg at nxy^2 x nz with an npart-lane beam, the rest as it is."""
    cfg = json.loads(json.dumps(cfg))
    cfg["amr.n_cell"] = [nxy, nxy, nz]
    cfg["beam.num_particles"] = npart
    cfg["deck"] = [f"amr.n_cell = {nxy} {nxy} {nz}"
                   if line.startswith("amr.n_cell") else line
                   for line in cfg["deck"]]
    return cfg


@pytest.fixture
def small(man):
    def make(cell: str, **kw) -> dict:
        return small_config(man.config(man.cell(cell)["config"]), **kw)
    return make
