"""The port's trace helpers (``utils/profiling.py``: ``trace`` and
``annotate``, the JAX package's ``jax.profiler`` pair) on the CPU:
``trace`` writes a Chrome trace into its directory, and an ``annotate``
range inside it is named there; ``annotate`` alone is a no-op range."""

import json
import os

import torch

from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, trace


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
