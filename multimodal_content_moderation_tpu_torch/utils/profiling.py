"""Tracing, step timing and finiteness checks (the JAX package's
``utils/profiling.py``: ``trace``, ``annotate``, ``StepTimer`` and
``assert_finite``).

``trace(log_dir)`` records ``torch.profiler`` (host and, with a card, CUDA
activity) and writes a Chrome trace into ``log_dir`` (Perfetto and
``chrome://tracing`` read it); ``annotate(name)`` names a host range in it,
and on the card also an NVTX range.

``StepTimer`` measures host wall time between ticks. A tick placed after a
step that was only enqueued on the card measures the enqueue rate, which
equals the device rate once the queue is full; a caller that wants the
device time of one step synchronises before the tick.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``trace_<pid>_<ns>.json`` (a Chrome trace) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in profiler traces (``record_function``), and an NVTX
    range where a card is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Rolling wall-time stats with warm-up steps skipped."""

    def __init__(self, warmup: int = 1, window: int = 100):
        self.warmup = warmup
        self.window = window
        self._times: list = []
        self._count = 0
        self._last: Optional[float] = None

    def reset_clock(self) -> None:
        """Forget the last tick (call after eval/checkpoint pauses so the gap
        is not recorded as a step); rolling stats are kept."""
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
                if len(self._times) > self.window:
                    self._times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    def samples_per_second(self, batch_size: int) -> float:
        s = self.mean_step_seconds
        return batch_size / s if s > 0 else 0.0


def assert_finite(tensors, name: str = "tree") -> None:
    """Raise with the offending names if any floating tensor of ``tensors``
    ({name: tensor}, e.g. ``dict(model.named_parameters())``) holds a NaN or
    an Inf. Synchronises with the device."""
    bad = [
        k for k, t in tensors.items()
        if torch.is_floating_point(t) and not bool(torch.isfinite(t).all())
    ]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
