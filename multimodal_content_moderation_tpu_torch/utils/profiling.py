"""Tracing, step timing and finiteness checks (the JAX package's
``utils/profiling.py``: ``trace``, ``annotate``, ``StepTimer`` and
``assert_finite``), and the program's spans and counters.

``annotate(name, **attrs)`` is the program's span. While a ``recording()``
block (or a ``trace``) is open it names a host range in profiler traces
(``record_function``), an NVTX range on the card, and appends a ``Span`` to
the recording: its id, its parent's id, name, thread, start and end on
``time.perf_counter_ns()`` (the clock a profiler trace can be mapped onto
from one mark taken in both) and its attributes. The parent is the innermost
span open on the same thread, or the ``parent`` id passed in for work handed
to another thread. ``count(name, n)`` adds to a counter of the recording.
With no recording open both cost one check of a module-level flag.

``trace(log_dir)`` records ``torch.profiler`` (host and, with a card, CUDA
activity) and writes a Chrome trace into ``log_dir`` (Perfetto and
``chrome://tracing`` read it); the spans of the thread that opened it are
named there (the profiler records that thread's ranges alone).

``StepTimer`` measures host wall time between ticks. A tick placed after a
step that was only enqueued on the card measures the enqueue rate, which
equals the device rate once the queue is full; a caller that wants the
device time of one step synchronises before the tick.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

MAX_SPANS = 1 << 18  # a recording's cap; spans past it count in "spans.dropped"


class Span(NamedTuple):
    """One closed span of a recording (times in ``perf_counter_ns``)."""

    id: int
    parent: Optional[int]
    name: str
    thread: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


class Recording:
    """The spans and counters of one ``recording()`` block."""

    def __init__(self):
        self.cap = MAX_SPANS
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.cap:
                self.spans.append(span)
            else:
                self.counters["spans.dropped"] = self.counters.get("spans.dropped", 0) + 1

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        """The summed duration of the spans called ``name``."""
        return sum(s.end_ns - s.start_ns for s in self.named(name)) / 1e9


_active: Optional[Recording] = None  # the open recording; None: spans and counters are off
_stacks = threading.local()  # each thread's open span ids, innermost last


class _Open:
    """An open span (``annotate`` while recording)."""

    __slots__ = ("rec", "id", "parent", "name", "attrs", "start_ns", "_range", "_nvtx")

    def __init__(self, rec: Recording, name: str, parent: Optional[int], attrs):
        self.rec, self.name, self.parent, self.attrs = rec, name, parent, attrs

    def set(self, **attrs) -> None:
        """Add attributes to the span's record, also once it has closed
        (what a batch is, its width say, may be known only after its load)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        stack = _stacks.__dict__.setdefault("ids", [])
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        _stacks.ids.pop()
        self.rec._add(Span(self.id, self.parent, self.name, threading.get_ident(),
                           self.start_ns, end_ns, self.attrs))
        return False


class _Off:
    """``annotate`` with no recording open: enters and leaves doing nothing."""

    id = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def annotate(name: str, parent: Optional[int] = None, **attrs):
    """The program's span (a context manager; ``as`` gives the span, whose
    ``id`` another thread's spans may take as their ``parent`` and whose
    ``set(**attrs)`` adds attributes). Outside a recording: nothing."""
    rec = _active
    if rec is None:
        return _OFF
    return _Open(rec, name, parent, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the recording's counter ``name``; nothing outside one."""
    rec = _active
    if rec is not None:
        rec._count(name, n)


def is_recording() -> bool:
    """Whether a recording is open (for counts that cost work to compute)."""
    return _active is not None


def current_span() -> Optional[int]:
    """The id of this thread's innermost open span, or None: the parent to
    hand to work started on another thread."""
    if _active is None:
        return None
    stack = getattr(_stacks, "ids", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the block's spans and counters (at most ``MAX_SPANS`` spans;
    the rest count in ``spans.dropped``) into the ``Recording`` it yields.
    A recording opened inside another holds the inner block's alone."""
    global _active
    outer, rec = _active, Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = outer


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``trace_<pid>_<ns>.json`` (a Chrome trace) into ``log_dir``; spans are
    recorded inside it (into the open recording, or a block's own)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with contextlib.ExitStack() as stack:
        if _active is None:
            stack.enter_context(recording())
        prof.start()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
