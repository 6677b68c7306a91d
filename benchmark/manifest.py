"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
given in ``configs``, and a traffic mix, ``traffic/<mix>.json``, whose
``kind`` names a module ``kinds/<kind>.py``: its class ``Run`` runs the
cell (``set_up``, ``window`` or ``traced``, ``compare``, ``close``). A
per-layer metric is read by ``metrics/<name>.py``, whose ``read(run)``
returns a number or None. A metric with a ``workloads`` list is reported
in those cells only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        with open(path) as f:
            self.doc = json.load(f)
        self.root = Path(path).resolve().parent

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def metrics(self, section: str, cell: str) -> list:
        """The entries of a metric section that the cell reports."""
        return [m for m in self.doc[section]
                if cell in m.get("workloads", [cell])]


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kind(name: str):
    """The module of a traffic kind."""
    return importlib.import_module(f"{__package__}.kinds.{name}")


def reader(metric: str):
    """The read function of a per-layer metric's file."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
