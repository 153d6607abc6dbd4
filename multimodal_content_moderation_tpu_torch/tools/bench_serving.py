"""Serving-path benchmark: latency and sustained throughput of the port's
moderation endpoint (the JAX package's ``tools/bench_serving.py``).

The whole HTTP stack runs end to end (``serving/server.serve`` in this
process, clients on threads): base64 JPEG decode -> tokenization -> u8
wire -> the card's forward, with the engine knobs of the container's
``MMHARM_*`` environment contract. The model is a reference-format CLIP
ViT-B/32 fusion checkpoint (``model.safetensors``, random weights from
``--seed``) with a synthetic 49,408-entry BPE vocabulary; the payloads are
the committed JPEG fixtures as base64.

Workloads:
- single-instance requests, one after another: p50 / p95 / p99 latency;
- batch requests (``instances`` arrays) from ``--clients`` concurrent
  clients: sustained samples/s;
- ``--mixed``: B=1 loops and batch loops at once, each population's rate
  and latency (``--bypass_sweep``: the MicroBatcher's bypass thresholds as
  adjacent windows on one loaded engine);
- ``--coldstart``: model load (with the prewarm) + the first requests.

The server binds ``--port``; 0, the default, takes a free port. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
import urllib.request

from multimodal_content_moderation_tpu_torch.tools import _common as c

REFERENCE_OFFLINE = 381.5  # the reference's offline eval rate on its GPU
ENV_KEYS = ["MMHARM_ENGINE", "MMHARM_PRECISION", "MMHARM_ATTENTION", "MMHARM_IMAGE_BACKEND",
            "MMHARM_MICROBATCH_MS", "MMHARM_MICROBATCH_BYPASS", "MMHARM_SEQ_BUCKETS"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--port", type=int, default=0, help="the port to bind; 0 (the default) "
                    "takes a free one")
    ap.add_argument("--latency_requests", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=64,
                    help="instances per throughput request")
    ap.add_argument("--batch_requests", type=int, default=12)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--engine", default="fast")
    ap.add_argument("--precision", default="bf16_fast")
    ap.add_argument("--attention", default="pallas")
    ap.add_argument("--image_backend", default="native_scaled")
    ap.add_argument("--seq_buckets", default="auto",
                    help="MMHARM_SEQ_BUCKETS for the handler ('off' disables)")
    ap.add_argument("--microbatch_ms", type=float, default=0.0,
                    help=">0 enables cross-request micro-batching with this window")
    ap.add_argument("--microbatch_bypass", type=int, default=16,
                    help="requests carrying >= this many instances skip coalescing "
                    "(0 disables)")
    ap.add_argument("--mixed", action="store_true",
                    help="--small_clients B=1 loops run at once with the --clients batch "
                    "loops; each population's rate and latency")
    ap.add_argument("--small_clients", type=int, default=8)
    ap.add_argument("--mixed_seconds", type=float, default=30.0,
                    help="duration of the mixed-traffic window")
    ap.add_argument("--bypass_sweep", default="",
                    help="with --mixed: comma-separated bypass thresholds ('off' = no "
                    "MicroBatcher) swept as adjacent windows on one loaded engine")
    ap.add_argument("--coldstart", action="store_true",
                    help="time to first prediction only: model load (with the prewarm) "
                    "+ the first B=1 and first batch request")
    return ap.parse_args(argv)


def build_checkpoint(root: str, tiny: bool, seed: int, device) -> str:
    """A reference-format CLIP fusion checkpoint under ``root``."""
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

    model = FusionModel.create("clip", num_labels=len(c.CLASSES), seed=seed, device=device,
                               clip_config=c.encoder_config("clip", tiny))
    return c.write_reference_checkpoint(model, os.path.join(root, "checkpoint"), {})


def post(url: str, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def quantile(sorted_ms, p: float):
    return sorted_ms[min(len(sorted_ms) - 1, int(p * len(sorted_ms)))] if sorted_ms else None


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "bench-serving")
    card = c.card_line(device)
    saved = {k: os.environ.get(k) for k in ENV_KEYS}
    os.environ.update({
        "MMHARM_ENGINE": args.engine, "MMHARM_PRECISION": args.precision,
        "MMHARM_ATTENTION": args.attention, "MMHARM_IMAGE_BACKEND": args.image_backend,
        "MMHARM_MICROBATCH_MS": str(args.microbatch_ms),
        "MMHARM_MICROBATCH_BYPASS": str(args.microbatch_bypass),
        "MMHARM_SEQ_BUCKETS": args.seq_buckets,
    })
    tmp = tempfile.mkdtemp(prefix="bench_serving_")
    try:
        ckpt = build_checkpoint(tmp, args.tiny, args.seed, device)
        return _measure(args, ckpt, device, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _measure(args, ckpt: str, device, card: str) -> dict:
    from multimodal_content_moderation_tpu_torch.serving import server as srv

    c.warn("bench-serving", "model dir ready; loading server ...")
    counts = c.launch_counter()  # --coldstart counts from here: the load's prewarm included
    t_load0 = time.perf_counter()
    httpd = srv.serve(ckpt, None, port=args.port, host="127.0.0.1", device=device.type)
    load_s = time.perf_counter() - t_load0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/invocations"
    images = c.fixture_payloads()
    texts = [f"offensive tweet number {i} with several words" for i in range(512)]
    common = {"device": card, "seed": args.seed, "tiny": args.tiny, "engine": args.engine,
              "precision": args.precision, "attention": args.attention,
              "image_backend": args.image_backend, "seq_buckets": args.seq_buckets,
              "microbatch_ms": args.microbatch_ms,
              "images": f"the {len(images)} committed JPEG fixtures (testdata/jpeg), base64"}

    def single(i: int) -> dict:
        return {"text": texts[i % len(texts)], "image": images[i % len(images)]}

    def batch_body(cid: int, r: int) -> dict:
        return {"instances": [
            {"text": texts[(cid * 131 + r * 17 + i) % len(texts)],
             "image": images[(cid + r + i) % len(images)]}
            for i in range(args.batch_size)]}

    try:
        if args.coldstart:
            t0 = time.perf_counter()
            post(url, single(0))
            first_small = time.perf_counter() - t0
            t0 = time.perf_counter()
            post(url, batch_body(0, 0))
            first_batch = time.perf_counter() - t0
            return c.emit({
                "metric": "serving_time_to_first_prediction", "unit": "s",
                "value": load_s + first_small, "model_load_s": load_s,
                "first_small_request_s": first_small, "first_batch_request_s": first_batch,
                "compile_cache": os.environ.get("MMHARM_COMPILE_CACHE", ""),
                "launches": counts(),
                "launches_window": "model load (with the prewarm) and the first two requests",
                **common,
            })

        # warm up both padded batch shapes: 1 and batch_size
        post(url, single(0))
        post(url, batch_body(0, 0))
        counts = c.launch_counter()

        if args.mixed:
            result = _mixed(args, httpd, url, single, batch_body)
        else:
            lat = []
            for i in range(args.latency_requests):
                t0 = time.perf_counter()
                out = post(url, single(i))
                lat.append(time.perf_counter() - t0)
                if not ("predictions" in out or isinstance(out, list)):
                    raise RuntimeError(f"unexpected answer {out}")
            lat_ms = sorted(x * 1000 for x in lat)
            done = []
            lock = threading.Lock()

            def client(cid: int):
                for r in range(args.batch_requests // args.clients):
                    post(url, batch_body(cid, r))
                    with lock:
                        done.append(args.batch_size)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(args.clients)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            dt = time.perf_counter() - t0
            total = sum(done)
            if total == 0:
                raise SystemExit("bench-serving: --batch_requests must be at least --clients")
            result = {
                "metric": "serving_sustained_samples_per_s",
                "value": total / dt,
                "unit": "samples/s",
                "latency_p50_ms": quantile(lat_ms, 0.50),
                "latency_p95_ms": quantile(lat_ms, 0.95),
                "latency_p99_ms": quantile(lat_ms, 0.99),
                "latency_requests": args.latency_requests,
                "throughput_samples": total,
                "throughput_window_s": dt,
                "clients": args.clients,
                "request_batch": args.batch_size,
                # the reference's endpoint runs B=1 forwards per instance; its
                # offline eval rate was 381.5/s
                "vs_reference_offline_381.5": total / dt / REFERENCE_OFFLINE,
            }
        return c.emit({**result, "launches": counts(), **common})
    finally:
        httpd.shutdown()
        httpd.server_close()
        if httpd.state.batcher is not None:
            httpd.state.batcher.close()
        thread.join(timeout=10)


def _mixed(args, httpd, url, single, batch_body) -> dict:
    """Small B=1 loops and batch loops in the same window(s)."""

    def window() -> dict:
        stop = time.perf_counter() + args.mixed_seconds
        small_lat, batch_done = [], []
        lk = threading.Lock()

        def small_client(cid: int):
            i = 0
            while time.perf_counter() < stop:
                t0 = time.perf_counter()
                post(url, single(cid * 97 + i))
                with lk:
                    small_lat.append(time.perf_counter() - t0)
                i += 1

        def batch_client(cid: int):
            r = 0
            while time.perf_counter() < stop:
                post(url, batch_body(cid, r))
                with lk:
                    batch_done.append(args.batch_size)
                r += 1

        threads = ([threading.Thread(target=small_client, args=(k,))
                    for k in range(args.small_clients)]
                   + [threading.Thread(target=batch_client, args=(k,))
                      for k in range(args.clients)])
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        sl = sorted(x * 1000 for x in small_lat)
        return {
            "value": (len(small_lat) + sum(batch_done)) / dt,
            "small_requests_per_s": len(small_lat) / dt,
            "small_p50_ms": quantile(sl, 0.50),
            "small_p99_ms": quantile(sl, 0.99),
            "batch_samples_per_s": sum(batch_done) / dt,
            "window_s": dt,
        }

    common = {"unit": "samples/s", "small_clients": args.small_clients,
              "batch_clients": args.clients, "request_batch": args.batch_size}
    if not args.bypass_sweep:
        return {"metric": "serving_mixed_traffic", "microbatch_bypass": args.microbatch_bypass,
                **window(), **common}
    st = httpd.state
    if st.batcher is None:
        raise SystemExit("bench-serving: --bypass_sweep requires --microbatch_ms > 0")
    saved = st.batcher
    sweep = []
    try:
        for tok in (t.strip() for t in args.bypass_sweep.split(",")):
            if not tok:
                continue
            if tok == "off":
                st.batcher = None
            else:
                st.batcher = saved
                saved._bypass_n = int(tok)
            w = window()
            w["bypass"] = tok
            sweep.append(w)
            c.warn("bench-serving", json.dumps({"window": w}))
    finally:
        st.batcher = saved
    return {"metric": "serving_mixed_traffic_bypass_sweep",
            "value": max(w["value"] for w in sweep), "sweep": sweep, **common}


if __name__ == "__main__":
    main()
