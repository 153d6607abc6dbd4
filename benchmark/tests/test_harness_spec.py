"""Every file a cell reads parses, and BENCHMARK.json keeps to the
benchmark's contract: keys, names, units, bounds, run length and budget."""

import json
import os
import re

import pytest

from harness_util import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in names
            names.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_bounds_and_budget():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    # a full check of 24 cells (14 runs each, at most 60 s over the window and
    # 180 s of compiling a cell, 1,200 s spare) fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse(cell):
    from benchmark.harness import spec

    c = spec.load_cell(cell)
    assert c.chips == 1
    assert c.mode in spec.MODES
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in SPEC["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert os.path.exists(os.path.join(ROOT, "benchmark", "families", f"{cfg['family']}.py"))
    assert cfg["assumed"]


def test_every_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        for w in m["workloads"]:
            assert w in CELLS
