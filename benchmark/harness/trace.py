"""The traced run's instruments: the benchmark's spans around calls into the
program's layers, a recorder of the attention kernels' shapes, and the
reduction of a ``torch.profiler`` slice to device time.

A span is a ``record_function`` range named ``bench/<layer>`` (for the
trace's viewer) and, while a slice is profiled, an entry on the host's clock
in the run's ``SpanLog`` from whatever thread it ran on; the slice's clock
mark maps those entries onto the trace's clock, so that an idle gap of the
device is labelled with the span the host was in."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

SPAN = "bench/"
CLOCK = "bench-clock"


class SpanLog:
    """The benchmark's spans of one run."""

    def __init__(self):
        self.on = False
        self.entries: List[Tuple[str, int, int]] = []  # name, start, end (ns)

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(SPAN + name):
            yield
        if self.on:
            self.entries.append((name, t0, time.perf_counter_ns()))


class ShapeRecorder:
    """Records the shapes of every ``attention_nhd`` forward and backward
    launch while ``on``, by wrapping the port's launch functions."""

    def __init__(self):
        self.on = False
        self.calls: Dict[str, List[Tuple]] = {"attention_nhd": [], "attention_nhd_bwd": []}
        self._saved = {}

    def install(self) -> "ShapeRecorder":
        from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca

        def wrap(kernel, fn):
            def launch(q, k, v, *rest):
                if self.on:
                    num_heads, key_mask, causal = rest[-4], rest[-3], rest[-2]
                    B, Tq, D = q.shape
                    self.calls[kernel].append(
                        (B, Tq, k.shape[1], int(num_heads), D // int(num_heads), bool(causal),
                         key_mask is not None, q.element_size()))
                return fn(q, k, v, *rest)
            return launch

        for kernel, attr in (("attention_nhd", "_attention_nhd_launch"),
                             ("attention_nhd_bwd", "_attention_nhd_bwd_launch")):
            self._saved[attr] = getattr(ca, attr)
            setattr(ca, attr, wrap(kernel, self._saved[attr]))
        return self

    def uninstall(self) -> None:
        from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca

        for attr, fn in self._saved.items():
            setattr(ca, attr, fn)
        self._saved = {}


@contextlib.contextmanager
def profiled(device, spans: SpanLog):
    """A ``torch.profiler`` over CPU and CUDA activity from a synchronise to
    a synchronise, with ``spans`` logged; yields a dict that receives
    ``prof``, ``wall_s``, the spans and the clock mark."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(CLOCK):
            out["mark_ns"] = time.perf_counter_ns()
        spans.entries, spans.on = [], True
        t0 = time.perf_counter()
        try:
            yield out
            torch.cuda.synchronize(device)
        finally:
            out["wall_s"] = time.perf_counter() - t0
            spans.on = False
    out["prof"] = prof
    out["spans"] = spans.entries


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, merged intervals) of [start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def _raw_events(prof):
    """(name, is a device operation, start ns, end ns) of every event the
    profiler's backend recorded, from every thread and stream."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        on_device = e.device_type() == cuda and not e.is_user_annotation()
        yield e.name(), on_device, start, start + e.duration_ns()


def summarize(p: Dict) -> Optional[Dict]:
    """Device time of a profiled slice: ``busy_s`` (the union of every device
    operation's interval), ``window_s`` (the slice's wall time), seconds by
    operation name, the ten longest operations by total time and the ten
    longest idle gaps, each labelled with the benchmark span the host was
    in. None where the trace holds no device operation."""
    device_ops, offset_ns = [], None
    for name, on_device, start, end in _raw_events(p["prof"]):
        if on_device and not name.startswith((SPAN, CLOCK)):
            device_ops.append((name, start, end))
        elif name == CLOCK and not on_device:
            offset_ns = p["mark_ns"] - start
    if not device_ops:
        return None
    host_spans = [] if offset_ns is None else [
        (n, s - offset_ns, t - offset_ns) for n, s, t in p["spans"]]
    busy_ns, merged = _union([(s, t) for _, s, t in device_ops])
    by_name: Dict[str, float] = {}
    for name, s, t in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(s, t):
        mid = (s + t) / 2
        inside = [(e - b, n) for n, b, e in host_spans if b <= mid <= e]
        return min(inside)[1] if inside else "outside_spans"

    idle_by_label: Dict[str, float] = {}
    for s, t in gaps:
        lab = label(s, t)
        idle_by_label[lab] = idle_by_label.get(lab, 0.0) + (t - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": p["wall_s"],
        "op_seconds": by_name,
        "device_ops": [[n[:120], s] for n, s in top],
        "idle_gaps": [[label(s, t), (t - s) / 1e9] for s, t in gaps[:10]],
        "idle_by_span": idle_by_label,
    }


def kernel_seconds(summary: Optional[Dict], fragment: str, exclude: str = "") -> float:
    """Device seconds of the operations whose name holds ``fragment`` (and not
    ``exclude``)."""
    if not summary:
        return 0.0
    return sum(s for n, s in summary["op_seconds"].items()
               if fragment in n and not (exclude and exclude in n))
