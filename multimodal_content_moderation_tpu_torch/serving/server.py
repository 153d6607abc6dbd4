"""Standalone HTTP model server with the SageMaker container contract:

    GET  /ping         -> 200 once the model is loaded and warmed
    POST /invocations  -> handler.input_fn -> predict_fn -> output_fn

400 for a body that does not parse, 404 for an unknown route, 500 for a
model or device failure. Bodies follow the JAX package's ``serving/``
schema. The classifier runs on the card (``device="cuda"``) unless the
caller asks for the CPU:

    python -m multimodal_content_moderation_tpu_torch.serving.server \\
        --model-dir DIR [--port 8080] [--device cpu]

Request threads share the card. Host work (base64 and JPEG decode,
tokenize) runs on each request's thread outside the lock; the lock covers
the device forward and its copy back to the host (``forward_batch``). The
hand-written kernels launch on the calling thread's current CUDA stream.

Knobs (environment): ``MMHARM_MICROBATCH_MS`` > 0 coalesces concurrent
requests into one device batch (``MicroBatcher``), with
``MMHARM_MICROBATCH_MAX`` (default 256) and ``MMHARM_MICROBATCH_BYPASS``
(default 16; 0 disables); ``MMHARM_WHOLE_REQUEST_LOCK=1`` serialises whole
requests instead; and the model knobs of ``handler.model_fn``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from multimodal_content_moderation_tpu_torch.serving import handler as h

logger = logging.getLogger(__name__)


class Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog of 128 connections. The
    standard library's default of 5 (which the JAX package's server keeps)
    makes the kernel drop or reset the connections of a burst of more than 5
    clients, which then retry after a second."""

    request_queue_size = 128


class _State:
    classifier = None
    lock = threading.Lock()
    batcher = None  # optional cross-request MicroBatcher
    whole_request_lock = False  # MMHARM_WHOLE_REQUEST_LOCK=1


class MicroBatcher:
    """Cross-request micro-batching for concurrent /invocations.

    A request enqueues its instances and blocks; a worker thread waits
    ``window_ms`` after the first arrival for stragglers, drains up to
    ``max_batch`` instances, runs them through ``predict`` and routes each
    requester its own slice (or the error). A request that already carries
    ``bypass_n`` or more instances is a device batch by itself: it skips the
    queue and runs on the calling thread (still serialised at the device by
    the lock inside ``predict``). ``bypass_n=0`` disables bypassing.
    ``close()`` stops the worker once the queue is served."""

    def __init__(
        self, predict, window_ms: float = 4.0, max_batch: int = 256, bypass_n: int = 16,
    ):
        self._predict = predict
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._bypass_n = bypass_n
        self._cv = threading.Condition()
        self._pending: list = []  # (instances, slot) tuples
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return
            # a request just arrived; hold the window open for stragglers
            time.sleep(self._window_s)
            with self._cv:
                batch = self._pending[: self._max_batch]
                del self._pending[: len(batch)]
            flat = [i for insts, _ in batch for i in insts]
            try:
                preds = self._predict(flat)
                k = 0
                for insts, s in batch:
                    s["out"] = preds[k : k + len(insts)]
                    k += len(insts)
            except Exception as e:  # noqa: BLE001 - fan the error out
                for _, s in batch:
                    s["err"] = e
            for _, s in batch:
                s["done"].set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join()

    def __call__(self, instances):
        if self._bypass_n and len(instances) >= self._bypass_n:
            return self._predict(instances)
        slot = {"done": threading.Event(), "out": None, "err": None}
        with self._cv:
            if self._closed:  # replaced by configure() while this request came in
                return self._predict(instances)
            self._pending.append((instances, slot))
            self._cv.notify()
        slot["done"].wait()
        if slot["err"] is not None:
            raise slot["err"]
        return slot["out"]


def _make_request_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        # a fresh connection per request, as SageMaker's router opens them
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):  # through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

        def _send(self, code: int, body: str, content_type="application/json"):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/ping":
                if state.classifier is not None:
                    self._send(200, "{}")
                else:
                    self._send(503, json.dumps({"error": "model not loaded"}))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            if self.path != "/invocations":
                self._send(404, json.dumps({"error": "not found"}))
                return
            # 400 only for malformed input (a client error); a model or device
            # failure is a 500, so that the router sees a server-side fault
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode("utf-8")
                instances = h.input_fn(
                    body, self.headers.get("Content-Type", "application/json")
                )
            except Exception as e:  # noqa: BLE001 - per-request error capture
                logger.exception("invocation rejected: bad input")
                self._send(400, json.dumps({"error": str(e)}))
                return
            try:
                if state.batcher is not None:
                    preds = state.batcher(instances)
                elif state.whole_request_lock:
                    with state.lock:
                        preds = h.predict_fn(instances, state.classifier)
                else:
                    preds = h.predict_fn(instances, state.classifier, device_lock=state.lock)
                self._send(200, h.output_fn(preds))
            except Exception as e:  # noqa: BLE001 - per-request error capture
                logger.exception("invocation failed")
                self._send(500, json.dumps({"error": str(e)}))

    return Handler


def configure(state: _State) -> None:
    """Set the request-path knobs of ``state`` from the environment; a
    batcher already there is closed first."""
    if state.batcher is not None:
        state.batcher.close()
    state.whole_request_lock = os.environ.get(
        "MMHARM_WHOLE_REQUEST_LOCK", ""
    ).lower() in ("1", "true", "yes")
    window_ms = float(os.environ.get("MMHARM_MICROBATCH_MS", "0") or 0)
    state.batcher = None
    if window_ms > 0:
        state.batcher = MicroBatcher(
            lambda insts: h.predict_fn(insts, state.classifier, device_lock=state.lock),
            window_ms=window_ms,
            max_batch=int(os.environ.get("MMHARM_MICROBATCH_MAX", "256")),
            bypass_n=int(os.environ.get("MMHARM_MICROBATCH_BYPASS", "16")),
        )
        logger.info("cross-request micro-batching on (window %.1f ms)", window_ms)


def serve(
    model_dir: str,
    encoder_dir: Optional[str] = None,
    port: int = 8080,
    host: str = "0.0.0.0",
    device: str = "cuda",
) -> Server:
    """Load and warm the model, then return a ready (not yet serving) HTTP
    server: callers run ``server.serve_forever()`` (tests from a thread)
    and ``shutdown()`` it. ``server.state`` holds the classifier and the
    knobs; ``configure(server.state)`` re-reads them from the environment."""
    state = _State()
    state.lock = threading.Lock()
    state.classifier = h.model_fn(model_dir, encoder_dir, device=device)
    configure(state)
    server = Server((host, port), _make_request_handler(state))
    server.state = state
    logger.info("model loaded; listening on %s:%d", host, server.server_address[1])
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a trained checkpoint over the SageMaker container "
        "HTTP contract (/ping, /invocations)"
    )
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--encoder-dir", default=None)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="where the model runs; cuda needs a card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = serve(args.model_dir, args.encoder_dir, args.port, args.host, args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        server.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
