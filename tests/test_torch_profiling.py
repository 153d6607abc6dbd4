"""The port's trace helpers (``utils/profiling.py``: ``trace`` and
``annotate``, the JAX package's ``jax.profiler`` pair) on the CPU:
``trace`` writes a Chrome trace into its directory, and an ``annotate``
range inside it is named there; ``annotate`` alone is a no-op range.

The program's spans and counters: with no recording open, ``annotate`` and
``count`` touch neither the profiler nor CUDA and leave nothing; inside
``recording()`` spans take the innermost open span of their thread as their
parent, or the one handed to another thread, and the cap counts what it
drops."""

import json
import os
import threading

import torch

from multimodal_content_moderation_tpu_torch.utils import profiling
from multimodal_content_moderation_tpu_torch.utils.profiling import (
    annotate,
    count,
    recording,
    trace,
)


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("deploy/step"):
            torch.ones(8).add_(1)
        with annotate("deploy/other"):
            torch.zeros(2).sum()
    (name,) = os.listdir(log_dir)
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    with open(log_dir / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"deploy/step", "deploy/other"} <= names


def test_annotate_outside_a_trace():
    with annotate("no trace"):
        x = torch.arange(4) * 2
    assert x.tolist() == [0, 2, 4, 6]


def test_annotate_and_count_off_do_nothing(monkeypatch):
    def called(*args, **kwargs):
        raise AssertionError("called with no recording open")

    for module, name in ((torch.profiler, "record_function"), (torch.cuda, "is_available"),
                         (torch.cuda, "is_initialized")):
        monkeypatch.setattr(module, name, called)
    assert not profiling.is_recording() and profiling.current_span() is None
    with annotate("a", batch=1) as a, annotate("b") as b:
        count("c", 3)
        a.set(width=8)
    assert a is b and a.id is None
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_recording_parents_on_one_thread_and_handed_to_another():
    with recording() as rec:
        with annotate("outer", k=1) as outer:
            assert profiling.current_span() == outer.id
            with annotate("inner") as inner:
                assert profiling.current_span() == inner.id
                count("n")
                count("n", 2)

            def work():
                with annotate("handed", parent=outer.id):
                    with annotate("handed.child"):
                        pass
                with annotate("orphan"):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        inner.set(width=4)  # after it closed
    assert not profiling.is_recording()
    by = {s.name: s for s in rec.spans}
    assert by["outer"].parent is None and by["inner"].parent == outer.id
    assert by["handed"].parent == outer.id and by["handed.child"].parent == by["handed"].id
    assert by["orphan"].parent is None
    assert by["outer"].thread == by["inner"].thread == threading.get_ident()
    assert by["handed"].thread == by["orphan"].thread != by["outer"].thread
    o, i = by["outer"], by["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert o.attrs == {"k": 1} and i.attrs == {"width": 4}
    assert rec.counters == {"n": 3} and rec.seconds("inner") == (i.end_ns - i.start_ns) / 1e9


def test_recording_cap_counts_what_it_drops_and_nests(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with recording() as rec:
        for i in range(5):
            with annotate("s", i=i):
                pass
        with recording() as inner:
            with annotate("t"):
                count("m")
        count("after")
    assert [s.attrs["i"] for s in rec.named("s")] == [0, 1, 2]
    assert rec.counters == {"spans.dropped": 2, "after": 1}
    assert [s.name for s in inner.spans] == ["t"] and inner.counters == {"m": 1}


def test_trace_records_spans_into_the_open_recording(tmp_path):
    with recording() as rec:
        with trace(str(tmp_path)):
            with annotate("deploy/step"):
                pass
    assert [s.name for s in rec.spans] == ["deploy/step"]
