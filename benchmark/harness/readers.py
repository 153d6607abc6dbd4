"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. A reader
that finds nothing to read returns None, and its metric is left out of the
run's line: a roofline or ``mfu`` share is never reported as 0."""

from __future__ import annotations

from typing import Optional

from benchmark.flops import attention_nhd, attention_nhd_bwd, peaks
from benchmark.harness import trace

COUNTS = {"attention_nhd": attention_nhd.count, "attention_nhd_bwd": attention_nhd_bwd.count}
# the fragment of the device kernels' names, and one their names must not hold
KERNEL_NAMES = {"attention_nhd": ("attention_nhd", "bwd"),
                "attention_nhd_bwd": ("attention_nhd_bwd", "")}


def measured(run, key: str) -> Optional[float]:
    return run.measured.get(key)


def roofline(run, kernel: str) -> Optional[float]:
    """% of the roofline bound: max(operations / bf16 peak, bytes / HBM
    peak) of the shapes the profiled slice launched, over the device time
    of that kernel's launches in the slice."""
    calls = run.shapes.get(kernel) if run.shapes else None
    fragment, exclude = KERNEL_NAMES[kernel]
    seconds = trace.kernel_seconds(run.summary, fragment, exclude)
    if not calls or seconds <= 0:
        return None
    flops = sum(COUNTS[kernel](*c)[0] for c in calls)
    nbytes = sum(COUNTS[kernel](*c)[1] for c in calls)
    bound = max(flops / peaks.peak("bf16_flops", run.card),
                nbytes / peaks.peak("hbm_bytes_per_s", run.card))
    return 100.0 * bound / seconds


def mfu(run) -> Optional[float]:
    """% of the bf16 peak: the model operations of the work the untraced
    window completed over its seconds."""
    if run.device.type != "cuda" or "model_flops" not in run.measured:
        return None
    rate = run.measured["model_flops"] / run.measured["model_seconds"]
    return 100.0 * rate / peaks.peak("bf16_flops", run.card)


def idle_share(run) -> Optional[float]:
    """% of the profiled slice's wall time in which no device operation
    ran (1 minus the union of their intervals over the slice)."""
    s = run.summary
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
