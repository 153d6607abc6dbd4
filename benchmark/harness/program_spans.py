"""The program's own spans and counters (``utils/profiling.recording()`` in
the port) read beside a profiled slice.

The port records each span on ``time.perf_counter_ns()``, the clock of the
slice's ``bench-clock`` mark (``trace.profiled``), so one offset puts the
spans on the device trace's clock. Each idle gap of the device is then
labelled with the innermost span open on the launching thread (the thread of
``score.evaluate``) at the gap's midpoint; under ``score.wait_batch`` the
prep thread's innermost span is appended (``score.wait_batch<prep.patches``):
what the launching thread was waiting for.

From the window's passes (profiler off) and the slice's (profiler on):

- ``prep_wait_share``: % of ``score.evaluate`` spent in ``score.wait_batch``;
- ``launch_ms_per_batch``: median over passes of ``engine.call`` ms a batch;
- ``prep_ms_per_batch``: median over passes of the prep thread's
  ``prep.load`` + ``prep.patches`` + ``prep.bucket`` + ``prep.pin`` ms a batch;
- ``text_pad_share``: % of the text positions run that are padding,
  ``1 - score.text_tokens / score.text_slots``;
- ``idle_waiting_prep_share``, ``idle_launching_share``: % of the slice's wall
  time in gaps labelled ``score.wait_batch...`` and ``engine.call``;
- ``profiler_launch_inflation``: ``engine.call``'s mean in the slice over its
  mean in the window."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.harness import trace

ROOT = "score.evaluate"
WAIT = "score.wait_batch"
LAUNCH = "engine.call"
PREP = ("prep.load", "prep.patches", "prep.bucket", "prep.pin")

# (name, thread, start ns, end ns) on one clock
Interval = Tuple[str, int, int, int]


def label_gaps(gaps: Sequence[Tuple[float, float]], spans: Iterable[Interval],
               launcher: int) -> List[str]:
    """Each gap's label: the innermost of ``spans`` open on the ``launcher``
    thread at the gap's midpoint (``outside_spans`` where none is), and under
    ``score.wait_batch`` ``<`` and the innermost span then open on another
    thread (the one whose span started last)."""
    events = []
    for name, thread, start, end in spans:
        events.append((start, 0, thread, name))
        events.append((end, 2, thread, name))
    events += [((s + e) / 2, 1, i, None) for i, (s, e) in enumerate(gaps)]
    events.sort(key=lambda ev: (ev[0], ev[1]))
    open_: Dict[int, List[Tuple[float, str]]] = {}
    labels = ["outside_spans"] * len(gaps)
    for t, kind, who, name in events:
        if kind == 0:
            open_.setdefault(who, []).append((t, name))
        elif kind == 2:
            stack = open_[who]
            for k in range(len(stack) - 1, -1, -1):
                if stack[k][1] == name:
                    del stack[k]
                    break
        else:
            mine = open_.get(launcher)
            if not mine:
                continue
            label = mine[-1][1]
            if label == WAIT:
                others = [s[-1] for th, s in open_.items() if th != launcher and s]
                if others:
                    label += "<" + max(others)[1]
            labels[who] = label
    return labels


def device_gaps(p: Dict) -> Optional[Tuple[float, List[Tuple[int, int]], Optional[int]]]:
    """(busy seconds, the idle gaps between device operations in trace ns,
    the offset from ``perf_counter_ns`` to the trace's clock) of a slice of
    ``trace.profiled``; None where it holds no device operation. The same
    operations and union as ``trace.summarize``."""
    ops, offset = [], None
    for name, on_device, start, end in trace._raw_events(p["prof"]):
        if on_device and not name.startswith((trace.SPAN, trace.CLOCK)):
            ops.append((start, end))
        elif name == trace.CLOCK and not on_device:
            offset = p["mark_ns"] - start
    if not ops:
        return None
    busy_ns, merged = trace._union(ops)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return busy_ns / 1e9, gaps, offset


def host_ranges(prof, names: Iterable[str]) -> Dict[str, List[int]]:
    """The start (trace ns) of every host ``record_function`` range of the
    profile named in ``names``, by name, in order."""
    import torch

    wanted, out = set(names), {}
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name() in wanted:
            out.setdefault(e.name(), []).append(e.start_ns())
    return {k: sorted(v) for k, v in out.items()}


def clock_errors(p: Dict, spans) -> Tuple[List[Tuple[float, float]], Dict[str, List[int]]]:
    """([(a span's start on the trace's clock, minus its ``record_function``
    range's start, in us; the span's time after the clock mark, in s)], and by
    name [program spans, host ranges in the trace]) for the program spans of
    the slice; spans are matched to ranges by name, in order, where the two
    counts of a name agree. The profiler records the ranges of the thread
    that started it, so the prep thread's spans go unmatched."""
    found = device_gaps(p)
    if not found or found[2] is None:
        return [], {}
    offset = found[2]
    by_name: Dict[str, List[int]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.start_ns - offset)
    ranges = host_ranges(p["prof"], by_name)
    errors, counts = [], {}
    for name, starts in by_name.items():
        kineto = ranges.get(name, [])
        counts[name] = [len(starts), len(kineto)]
        if len(kineto) == len(starts):
            errors += [((a - b) / 1e3, (a + offset - p["mark_ns"]) / 1e9)
                       for a, b in zip(sorted(starts), kineto)]
    return errors, counts


def passes(spans) -> Dict[int, Dict[str, List]]:
    """The spans of each ``score.evaluate`` (by its id), by name."""
    by_id = {s.id: s for s in spans}
    out: Dict[int, Dict[str, List]] = {}
    for s in spans:
        top = s
        while top.parent is not None and top.parent in by_id:
            top = by_id[top.parent]
        if top.name == ROOT:
            out.setdefault(top.id, {}).setdefault(s.name, []).append(s)
    return out


def _seconds(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def window_split(spans, counters: Dict[str, int]) -> Dict[str, float]:
    """The span metrics of passes recorded with the profiler off."""
    per = list(passes(spans).values())
    if not per:
        return {}
    launch = [1e3 * _seconds(p[LAUNCH]) / len(p[LAUNCH]) for p in per if p.get(LAUNCH)]
    prep = [1e3 * sum(_seconds(p.get(k, [])) for k in PREP) / len(p[LAUNCH])
            for p in per if p.get(LAUNCH)]
    out = {"prep_wait_share": 100.0 * sum(_seconds(p.get(WAIT, [])) for p in per)
           / sum(_seconds(p[ROOT]) for p in per),
           "launch_ms_per_batch": statistics.median(launch),
           "prep_ms_per_batch": statistics.median(prep)}
    if counters.get("score.text_slots"):
        out["text_pad_share"] = 100.0 * (1 - counters["score.text_tokens"]
                                         / counters["score.text_slots"])
    return out


def slice_split(p: Dict, spans) -> Optional[Dict]:
    """The idle gaps of a profiled slice labelled by the program's spans:
    ``idle_by_span`` (seconds by label, every gap), ``idle_gaps`` (the ten
    longest), ``busy_s``, ``window_s`` and the two idle shares. None where
    the slice holds no device operation or no clock mark."""
    found = device_gaps(p)
    roots = [s for s in spans if s.name == ROOT]
    if not found or found[2] is None or not roots:
        return None
    busy_s, gaps, offset = found
    on_clock = [(s.name, s.thread, s.start_ns - offset, s.end_ns - offset) for s in spans]
    labels = label_gaps(gaps, on_clock, roots[0].thread)
    by_label: Dict[str, float] = {}
    for lab, (s, e) in zip(labels, gaps):
        by_label[lab] = by_label.get(lab, 0.0) + (e - s) / 1e9
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])[:10]
    wall = p["wall_s"]
    return {
        "busy_s": busy_s,
        "window_s": wall,
        "idle_by_span": by_label,
        "idle_gaps": [[labels[i], (gaps[i][1] - gaps[i][0]) / 1e9] for i in longest],
        "idle_waiting_prep_share": 100.0 * sum(
            v for k, v in by_label.items() if k.startswith(WAIT)) / wall,
        "idle_launching_share": 100.0 * by_label.get(LAUNCH, 0.0) / wall,
    }


def launch_inflation(window_spans, slice_spans) -> Optional[float]:
    """``engine.call``'s mean in the slice over its mean in the window."""
    w = [s for s in window_spans if s.name == LAUNCH]
    t = [s for s in slice_spans if s.name == LAUNCH]
    if not w or not t:
        return None
    return (_seconds(t) / len(t)) / (_seconds(w) / len(w))

