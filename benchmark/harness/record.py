"""What one run gathers for its metrics and its result line."""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Any, Dict, List, Optional

from benchmark.harness.trace import SpanLog


@dataclasses.dataclass
class Run:
    cell: Any
    seed: int
    seconds: float
    trace: bool
    device: Any
    card: str
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-layer inputs: measured rates and times, counted work, the trace
    measured: Dict[str, float] = dataclasses.field(default_factory=dict)
    summary: Optional[Dict] = None
    shapes: Dict[str, List] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    checks: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: SpanLog = dataclasses.field(default_factory=SpanLog)

    @property
    def config(self):
        return self.cell.config

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: above it (or not finite), the
        run is not correct."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def result_line(run: Run) -> Dict[str, Any]:
    """The result object: ``correct``, ``attempted``, ``failed``, the
    metrics of this run's kind (end-to-end untraced, per-layer traced),
    ``device``, with a trace the ``breakdown``, and last the compared numbers
    beside their limits."""
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            v = m.reader(run)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        for m in run.cell.end_to_end:
            if m.name in run.end_to_end:
                metrics[m.name] = {"value": float(run.end_to_end[m.name]), "unit": m.unit}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": run.card, "count": run.cell.chips,
              "memory_peak_bytes": int(run.peak_bytes)}
    line: Dict[str, Any] = {"correct": run.correct, "attempted": int(run.attempted),
                            "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.summary:
        device["busy_s"] = run.summary["busy_s"]
        device["window_s"] = run.summary["window_s"]
        line["breakdown"] = {"device_ops": run.summary["device_ops"],
                             "idle_gaps": run.summary["idle_gaps"]}
    if run.trace and run.end_to_end:
        # the untraced part of the traced window, to read the tracing's cost
        run.notes["untraced_part"] = dict(run.end_to_end)
    if run.notes:
        line["notes"] = run.notes
    line["checks"] = run.checks
    return line


def emit(run: Run) -> Dict[str, Any]:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    line = result_line(run)
    for name, c in run.checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line
