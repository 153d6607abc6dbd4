"""On the card: one profiled pass of the scoring cell, recorded by the
program (``tools/span_split.py``). Each program span's start, put on the
trace's clock by the ``bench-clock`` mark, lies within 50 us of its own
``record_function`` range (median; the trace holds the ranges of the
launching thread alone); the labelled idle time is no more than
the idle share; the pass's counters hold every row and batch. Skips without
a card."""

import json
import os

import pytest

from harness_util import ROOT, run_harness

CELL = "siglip2-224.score-cached"


@pytest.mark.gpu
def test_program_spans_on_the_trace_clock(card):
    rc, line, err = run_harness("--workload", CELL, "--seed", "2718281829", "--seconds", "4",
                                script=os.path.join(ROOT, "benchmark", "tools", "span_split.py"),
                                timeout=900)
    assert rc == 0, err[-3000:]
    assert line["logits_equal"] is True
    with open(os.path.join(ROOT, "benchmark", "traffic", "score-cached-b64.json")) as f:
        mix = json.load(f)
    batches = -(-mix["rows"] // mix["batch"])
    # the trace holds the ranges of the thread that started the profiler:
    # the launching thread's spans (a wait, a launch and a readback a batch)
    clock = line["clock_error_us"]
    assert clock["n"] >= 3 * batches and clock["median"] < 50, clock
    s, idle = line["slice"], line["device_idle_share"]
    assert 100 * sum(s["idle_by_span"].values()) / s["window_s"] <= idle + 1e-6
    assert s["idle_waiting_prep_share"] + s["idle_launching_share"] <= idle
    c = line["program_counters"]
    assert c["score.rows"] == mix["rows"] and c["score.batches"] == batches
    assert sum(v for k, v in c.items() if k.startswith("score.bucket.")) == batches
