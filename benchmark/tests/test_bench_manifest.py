"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric loads from its files by name, within the
contract's limits."""

import json
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(man):
    doc = man.doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"]
    assert doc["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= doc["run_seconds"] <= 51
    assert len(json.dumps(doc)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.Manifest().doc["workloads"]])
def test_cell_loads_by_name(man, cell):
    w = man.cell(cell)
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    cfg = man.config(w["config"])
    entry = next(c for c in man.doc["configs"] if c["name"] == w["config"])
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert set(cfg["limits"]) == {"start_gap", "fields_gap",
                                  "beam_gap"}
    mix = manifest.traffic(w["traffic"])
    assert hasattr(manifest.kind(mix["kind"]), "Run")
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in man.metrics("end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man.metrics("per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    manifest.Manifest().doc["per_layer"]])
def test_per_layer_reader_loads(man, metric):
    m = next(x for x in man.doc["per_layer"] if x["name"] == metric)
    assert callable(manifest.reader(metric))
    assert m["source"] in SOURCES and UNIT.match(m["unit"])
    assert m["moves"] in [e["name"] for e in man.doc["end_to_end"]]
    cells = [w["name"] for w in man.doc["workloads"]]
    assert set(m["workloads"]) <= set(cells)


def test_names_units_bounds(man):
    doc = man.doc
    names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in doc["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in doc["workloads"]}
    assert used == {c["name"] for c in doc["configs"]}
    assert all(NAME.match(n) for n in names)
