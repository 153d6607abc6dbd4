"""The moderation endpoint under independent users: the port's HTTP server
(``serving/server.serve``: ``/invocations`` -> ``handler.predict_fn``) in
this process, on a free local port, configured through the container's
``MMHARM_*`` environment, and an open-loop Poisson load of single-post
requests (a text and a base64 JPEG) from a child process without torch
(``loadgen.py``).

``serve_p95_ms`` is the 95th percentile over every request of the window,
each timed from when it was due to be sent; a request that fails or never
answers counts as missing (its time runs to the deadline) and in
``failed``."""

from __future__ import annotations

import base64
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import assets, compare, port, trace, traffic, weights

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")


def recipe_env(recipe: Dict, mix: Dict) -> Dict[str, str]:
    """The container's knobs for the configuration's eval recipe."""
    return {
        "MMHARM_ENGINE": "fast" if recipe["wire"] == "u8" else "standard",
        "MMHARM_PRECISION": recipe["precision"],
        "MMHARM_ATTENTION": recipe["attention"],
        "MMHARM_IMAGE_BACKEND": recipe["image_backend"],
        "MMHARM_SEQ_BUCKETS": str(mix["seq_buckets"]),
        "MMHARM_MICROBATCH_MS": str(mix.get("microbatch_ms", 0)),
        "MMHARM_PREWARM": "1",
    }


def write_model_dir(cfg, sd: Dict[str, torch.Tensor], path: str) -> str:
    """A reference-format checkpoint as a user deploys it: the encoder's
    tokenizer and config files, ``inference_config.json`` and the weights
    (``pytorch_model.bin``)."""
    enc = assets.encoder_dir(cfg)
    shutil.copytree(enc, path)
    classes = cfg["head"]["class_names"]
    with open(os.path.join(path, "inference_config.json"), "w") as f:
        json.dump({"backend": cfg["family"], "head": "fusion",
                   "fusion_dim": cfg["head"]["fusion_dim"], "class_names": classes,
                   "thresholds": [0.5] * len(classes),
                   "max_text_length": cfg["max_text_length"]}, f)
    torch.save({k: v.detach().cpu() for k, v in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    return path


class Endpoint:
    """The port's server in a thread of this process."""

    def __init__(self, cfg, mix, seed: int, tmp: str, device):
        from multimodal_content_moderation_tpu_torch.serving import server as srv

        recipe = cfg["recipe"]["eval"]
        os.environ.update(recipe_env(recipe, mix))
        wdtype = torch.bfloat16 if recipe["precision"] == "bf16_fast" else torch.float32
        model_dir = write_model_dir(cfg, weights.draw(cfg, seed, device, wdtype),
                                    os.path.join(tmp, "model"))
        port.build_kernels(["patch_embed_u8", "attention_nhd"], device)
        self.server = srv.serve(model_dir, port=0, host="127.0.0.1", device=device.type)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        if self.server.state.batcher is not None:
            self.server.state.batcher.close()


def plan(seed: int, rate: float, seconds: float, mix: Dict) -> Dict:
    """The requests of a window: due offsets, texts and fixture indices."""
    names = assets.fixtures()
    offsets = traffic.arrivals(rate, seconds)
    n = len(offsets)
    imgs = traffic.images(seed, n)
    return {"offsets": offsets.tolist(), "texts": traffic.texts(seed, n, mix["words"]),
            "images": [names.index(i) for i in imgs], "image_names": imgs}


def drive(port_no: int, p: Dict, mix: Dict, tmp: str, on_start=None) -> Dict:
    """Run the load generator over plan ``p``; ``on_start(t0)`` is called
    with the wall time of offset 0. Returns its timings."""
    fx = assets.fixture_bytes()
    body = {"port": port_no, "offsets": p["offsets"], "texts": p["texts"],
            "images": p["images"], "threads": int(mix["client_threads"]),
            "grace_s": float(mix["grace_s"]),
            "payloads": [base64.b64encode(fx[n]).decode() for n in assets.fixtures()]}
    plan_path, out_path = os.path.join(tmp, "plan.json"), os.path.join(tmp, "timings.json")
    with open(plan_path, "w") as f:
        json.dump(body, f)
    child = subprocess.Popen([sys.executable, LOADGEN, plan_path, out_path],
                             stdout=subprocess.PIPE, text=True,
                             env={"PATH": os.environ.get("PATH", ""),
                                  "TMPDIR": os.environ.get("TMPDIR", tmp)})
    try:
        t0 = json.loads(child.stdout.readline())["t0"]
        if on_start is not None:
            on_start(t0)
        child.wait(timeout=p["offsets"][-1] + float(mix["grace_s"]) + 60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(out_path) as f:
        out = json.load(f)
    out["t0"] = t0
    return out


def latencies_ms(t: Dict, grace_s: float) -> np.ndarray:
    """Each request's time from due to answer (ms); a failed or unanswered
    one runs to the generator's deadline."""
    due = np.asarray(t["due"], float)
    deadline = float(due[-1]) + grace_s if len(due) else 0.0
    done = np.asarray([d if (d is not None and s == 200) else np.nan
                       for d, s in zip(t["done"], t["status"])], float)
    lat = (done - due) * 1e3
    lat[np.isnan(lat)] = (deadline - due[np.isnan(lat)]) * 1e3
    return lat


def p95(lat: np.ndarray) -> float:
    s = np.sort(lat)
    return float(s[max(int(math.ceil(0.95 * len(s))) - 1, 0)])


def probabilities(t: Dict, classes: List[str]) -> np.ndarray:
    """[requests, classes] answered probabilities (NaN where none)."""
    out = np.full((len(t["answer"]), len(classes)), np.nan)
    for i, (s, a) in enumerate(zip(t["status"], t["answer"])):
        if s == 200:
            probs = json.loads(a)["predictions"][0]["probabilities"]
            out[i] = [probs[c] for c in classes]
    return out


def run(r, tmp: str, proc_start: float) -> None:
    from multimodal_content_moderation_tpu_torch.serving import handler

    cfg, mix, dev = r.config, r.cell.traffic, r.device
    classes = cfg["head"]["class_names"]
    ep = Endpoint(cfg, mix, r.seed, tmp, dev)
    warm = plan(r.seed + 1, float(mix["rate_per_s"]), float(mix["warm_s"]), mix)
    drive(ep.port, warm, mix, tmp)

    p = plan(r.seed, float(mix["rate_per_s"]), r.seconds, mix)
    times: List[float] = []
    predict = handler.predict_fn
    if r.trace:
        def timed(*a, **k):
            t = time.perf_counter()
            with r.spans.span("predict_fn"):
                out = predict(*a, **k)
            times.append(time.perf_counter() - t)
            return out
        handler.predict_fn = timed
    prof = {}

    if r.trace and dev.type == "cuda":
        # the profiler's first start takes seconds and holds the interpreter
        # lock, which would stall the server's threads inside the window
        with trace.profiled(dev, trace.SpanLog()):
            torch.zeros(1, device=dev).add_(1)

    def on_start(t0):
        r.setup_s = t0 - proc_start
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if r.trace and dev.type == "cuda":
            # a slice at the end of the window, from this thread
            slice_s = float(mix["profile_s"])
            time.sleep(max(t0 + r.seconds - slice_s - time.time(), 0.0))
            with trace.profiled(dev, r.spans) as prof_out:
                time.sleep(max(t0 + r.seconds - time.time(), 0.0))
            prof.update(prof_out)

    t = drive(ep.port, p, mix, tmp, on_start)
    handler.predict_fn = predict
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)
    ep.close()
    if prof:
        r.summary = trace.summarize(prof)
    lat = latencies_ms(t, float(mix["grace_s"]))
    r.attempted = len(lat)
    got = probabilities(t, classes)
    r.failed = int(np.isnan(got).any(axis=1).sum())
    r.end_to_end["serve_p95_ms"] = p95(lat)
    sent_late = np.asarray([s - d for s, d in zip(t["sent"], t["due"]) if s is not None])
    r.notes["p50_ms"] = float(np.median(lat))
    # the requests the p95 rests on: those at or above it
    r.notes["p95_tail_requests"] = int(len(lat) - math.ceil(0.95 * len(lat)) + 1)
    r.notes["generator_late_ms_p95"] = float(np.percentile(sent_late, 95) * 1e3) \
        if len(sent_late) else 0.0
    if times:
        r.measured["predict_ms"] = float(np.mean(times) * 1e3)
    del ep
    compare.free_device()

    reference = compare.Reference(cfg, r.seed, assets.encoder_dir(cfg), dev,
                                  weight_dtype=torch.bfloat16
                                  if cfg["recipe"]["eval"]["precision"] == "bf16_fast"
                                  else torch.float32)
    want = 1.0 / (1.0 + np.exp(-reference.logits(p["texts"], p["image_names"])))
    ok = ~np.isnan(got).any(axis=1)
    gap = float(np.abs(got[ok] - want[ok]).max()) if ok.any() else float("inf")
    r.check("max_abs_prob_gap", gap, r.cell.limits["max_abs_prob_gap"])
