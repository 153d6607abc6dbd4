"""What a run reads by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``), its correctness limits (``limits/<cell>.json``)
and the readers of its per-layer metrics (``metrics/<metric>.py``). A later
cell, configuration, mix or metric is a new file here; nothing else
changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MODES = ("score", "train", "serve")


def _load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    reader: Optional[Callable] = None  # per-layer metrics only


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _applies(metric: Dict[str, Any], cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def load_reader(metrics_dir: str, name: str) -> Callable:
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(workload: str, benchmark_json: Optional[str] = None) -> Cell:
    """The cell named ``workload`` in ``benchmark_json`` (the checkout's
    ``BENCHMARK.json`` by default), with everything it reads: configuration
    files relative to that file's directory, traffic, limits and metric
    readers from its ``benchmark/`` folder (or from the directory itself where
    it has none, as the harness's tests keep theirs). Raises ``KeyError`` for
    a name the file does not hold."""
    path = benchmark_json or os.path.join(ROOT, "BENCHMARK.json")
    root = os.path.dirname(os.path.abspath(path))
    data = os.path.join(root, "benchmark")
    data = data if os.path.isdir(data) else root
    metrics_dir = os.path.join(data, "metrics")
    metrics_dir = metrics_dir if os.path.isdir(metrics_dir) else os.path.join(BENCH_DIR, "metrics")
    spec = _load(path)
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {path}")
    config_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = _load(os.path.join(root, config_entry["file"]))
    traffic = _load(os.path.join(data, "traffic", f"{entry['traffic']}.json"))
    if traffic.get("mode") not in MODES:
        raise ValueError(f"traffic {entry['traffic']!r}: mode {traffic.get('mode')!r}, "
                         f"want one of {MODES}")
    limits = _load(os.path.join(data, "limits", f"{workload}.json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [
        Metric(m["name"], m["unit"], m["better"], load_reader(metrics_dir, m["name"]))
        for m in spec["per_layer"] if _applies(m, workload, e2e_names)
    ]
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[Metric(m["name"], m["unit"], m["better"]) for m in e2e],
        per_layer=per_layer,
    )
