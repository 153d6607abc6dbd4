"""The program's spans read beside a device trace (``harness/program_spans``)
on the CPU: the gap labeller takes the launching thread's innermost span and,
under a queue wait, the prep thread's; the labelled idle seconds never exceed
the slice's idle time; ``tools/span_split.py`` runs the tiny scoring cell
with its logits equal recorded and not, and no slice without a card; an
untraced run's line carries no program counters."""

import numpy as np
import pytest
import torch

from harness_util import ROOT, TINY, run_harness, tiny_args

from benchmark.harness import program_spans
from multimodal_content_moderation_tpu_torch.utils.profiling import Span

LAUNCHER, PREP = 1, 2


def test_label_gaps_names_the_launching_thread_and_what_it_waits_for():
    spans = [
        ("score.evaluate", LAUNCHER, 0, 100), ("score.wait_batch", LAUNCHER, 10, 20),
        ("engine.call", LAUNCHER, 20, 40), ("score.wait_batch", LAUNCHER, 40, 60),
        ("score.readback", LAUNCHER, 60, 70), ("bench/engine", LAUNCHER, -5, 105),
        ("prep.load", PREP, 5, 15), ("prep.patches", PREP, 15, 55),
        ("pipeline.put_wait", PREP, 65, 95),
    ]
    gaps = [(150, 160), (12, 14), (30, 32), (50, 52), (62, 64), (80, 90), (101, 103), (16, 18)]
    assert program_spans.label_gaps(gaps, spans, LAUNCHER) == [
        "outside_spans", "score.wait_batch<prep.load", "engine.call",
        "score.wait_batch<prep.patches", "score.readback", "score.evaluate", "bench/engine",
        "score.wait_batch<prep.patches"]
    # a wait while the prep thread is in no span is named alone
    assert program_spans.label_gaps([(12, 14)], spans[:2], LAUNCHER) == ["score.wait_batch"]


class _Event:
    def __init__(self, name, device, start, end):
        self._name, self._device, self._start, self._end = name, device, start, end

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._device == torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def _slice(g, n_ops=60, wall_ns=1_000_000):
    """A synthetic profiled slice: device operations at random inside the
    wall time (they end before its closing synchronise), the clock mark at
    trace time 1,000 = perf_counter 51,000, and the program's spans of one
    pass on two threads."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    starts = np.sort(g.integers(1_000, wall_ns - 20_000, size=n_ops))
    events = [_Event("kernel", cuda, int(s), int(s + g.integers(100, 20_000))) for s in starts]
    events.append(_Event("bench-clock", cpu, 1_000, 1_001))
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    offset = 50_000
    cuts = np.sort(g.integers(1_000, wall_ns, size=12)) + offset
    spans, sid = [Span(1, None, "score.evaluate", LAUNCHER, offset + 1_000,
                       offset + wall_ns, {})], 2
    for k in range(0, 12, 2):
        name = "score.wait_batch" if k % 4 == 0 else "engine.call"
        spans.append(Span(sid, 1, name, LAUNCHER, int(cuts[k]), int(cuts[k + 1]), {}))
        spans.append(Span(sid + 1, 1, "prep.load", PREP, int(cuts[k]) - 10, int(cuts[k]) + 50,
                          {}))
        sid += 2
    p = {"prof": prof, "mark_ns": 1_000 + offset, "wall_s": (wall_ns - 1_000) / 1e9}
    return p, spans


@pytest.mark.parametrize("seed", range(6))
def test_labelled_idle_never_exceeds_the_idle_share(seed):
    p, spans = _slice(np.random.default_rng(seed))
    out = program_spans.slice_split(p, spans)
    idle = 1 - out["busy_s"] / out["window_s"]
    labelled = sum(out["idle_by_span"].values()) / out["window_s"]
    assert 0 < labelled <= idle + 1e-12
    assert out["idle_waiting_prep_share"] + out["idle_launching_share"] <= 100 * labelled + 1e-9
    assert len(out["idle_gaps"]) == 10
    assert all(k in ("score.evaluate", "engine.call", "outside_spans")
               or k.startswith("score.wait_batch") for k in out["idle_by_span"])
    errors, counts = program_spans.clock_errors(p, spans)  # no host ranges in this trace
    assert errors == [] and counts["engine.call"] == [3, 0]


def test_window_split_reads_the_passes():
    spans, sid = [], 1
    for root_ns in (0, 10_000_000):
        root = sid
        spans.append(Span(root, None, "score.evaluate", LAUNCHER, root_ns, root_ns + 4_000_000,
                          {}))
        sid += 1
        for b in range(2):
            t = root_ns + 2_000_000 * b
            for name, thread, dur in (("score.wait_batch", LAUNCHER, 250_000),
                                      ("engine.call", LAUNCHER, 1_000_000),
                                      ("prep.load", PREP, 300_000),
                                      ("prep.patches", PREP, 200_000)):
                spans.append(Span(sid, root, name, thread, t, t + dur, {}))
                sid += 1
    spans.append(Span(sid, None, "engine.call", LAUNCHER, 0, 9_000_000, {}))  # no root: not read
    out = program_spans.window_split(spans, {"score.text_tokens": 30, "score.text_slots": 40})
    assert out == pytest.approx({"prep_wait_share": 12.5, "launch_ms_per_batch": 1.0,
                                 "prep_ms_per_batch": 0.5, "text_pad_share": 25.0})
    assert program_spans.window_split([], {}) == {}


def test_span_split_tool_on_the_cpu():
    rc, line, err = run_harness("--workload", "tiny-siglip.score", "--seed", "3000000019",
                                "--seconds", "1", "--device", "cpu", "--benchmark-json", TINY,
                                script=f"{ROOT}/benchmark/tools/span_split.py")
    assert rc == 0, err[-3000:]
    assert line["logits_equal"] is True and line["device"] == "cpu"
    assert set(line["window"]) == {"prep_wait_share", "launch_ms_per_batch",
                                   "prep_ms_per_batch", "text_pad_share"}
    assert 0 <= line["window"]["prep_wait_share"] <= 100
    assert "slice" not in line and "program_counters" not in line  # no device trace


def test_untraced_line_has_no_program_counters():
    rc, line, err = run_harness(*tiny_args("tiny-siglip.score", seed=3_000_000_019))
    assert rc == 0, err[-3000:]
    assert set(line["notes"]) == {"bucket_rows", "pass_s", "host_per_pass"}
    assert set(line["metrics"]) == {"score_rows_per_s", "setup_s"}
