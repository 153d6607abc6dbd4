"""Background producer with a bounded queue.

``bounded_producer`` runs a host-side batch generator on a daemon thread
(decode, patch extraction, pinning) so that it overlaps the device work of
the consumer, without ever blocking forever on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Tuple

from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, current_span

_SENTINEL = object()


def bounded_producer(
    produce: Callable[[], Iterator[Any]], size: int = 2
) -> Tuple[queue.Queue, object, list, Callable[[], None]]:
    """Run ``produce()`` on a daemon thread, pushing items into a bounded
    queue without ever blocking forever.

    A plain ``q.put`` on a full bounded queue deadlocks the producer (and
    leaks the thread plus whatever it holds) if the consumer dies first; the
    returned ``cancel()`` MUST be called from a consumer ``finally`` — it
    flips the cancellation event the producer's timeout-put loop re-checks,
    drains the queue so the final sentinel put cannot block, and joins the
    thread. Producer exceptions are appended to the returned error list and
    should be re-raised by the consumer when it sees the sentinel.

    While a recording is open (``utils/profiling``), each item's put loop is
    a ``pipeline.put_wait`` span (``batch`` = the item's index), a child of
    the span open where ``bounded_producer`` was called.

    Returns ``(queue, sentinel, errors, cancel)``.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list = []
    cancelled = threading.Event()
    parent = current_span()  # the caller's span, for the worker's put waits

    def worker():
        try:
            for i, item in enumerate(produce()):
                # bounded put that re-checks cancellation: if the consumer
                # died, a plain q.put could block forever (bounded queue)
                with annotate("pipeline.put_wait", parent=parent, batch=i):
                    while not cancelled.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                if cancelled.is_set():
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            # The sentinel put must terminate too: after cancellation a
            # straggler item (a timeout-put that won the race with the
            # drain) can refill the queue with no consumer left — evict
            # to make room instead of blocking forever.
            while True:
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if cancelled.is_set():
                        try:
                            q.get_nowait()
                        except queue.Empty:  # pragma: no cover - racy
                            pass

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def cancel():
        cancelled.set()
        # drain so the producer's final q.put(_SENTINEL) cannot block
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)

    return q, _SENTINEL, err, cancel
