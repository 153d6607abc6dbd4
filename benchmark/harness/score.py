"""Offline scoring: a CSV of posts streamed through the fast engine
(``models/fast_infer.evaluate_logits_u8``) with exact text buckets, over the
decode-once pixel cache that a cold pass fills in set-up; the window runs
whole passes until its seconds are up, closed loop.

``score_rows_per_s`` is the rows of the window's passes over the seconds from
its start to the end of its last pass. The traced run profiles one more pass
after those (its slice), then measures the host input alone and the engine
alone over the same batches; ``mfu.score`` counts the model operations of
the untraced passes."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.flops import model as model_flops
from benchmark.harness import assets, compare, env, port, spec, trace, traffic, weights


def _prep(engine, ds, batch, workers, ladder, extra):
    """The host half of ``evaluate_logits_u8`` for one pass: batches from the
    dataset's threads, patch rows, buckets (``extra``: the family's
    ``bucket_extra``), pinned buffers."""
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        bucket_batch_text,
        bucket_for,
    )

    backend = engine.model.backend
    order = np.argsort(ds.attention_mask.sum(axis=1), kind="stable")
    pin = engine.device.type == "cuda"
    for b in ds.batches(batch, pad_to_batch=True, num_workers=workers, indices=order):
        b.pop("_valid")
        b.pop("labels")
        patches = engine.patches_from_hwc(b.pop("pixel_values"))
        w = bucket_for(b["attention_mask"], ladder, extra=extra)
        ids, mask, carry = bucket_batch_text(b["input_ids"], b["attention_mask"], w, backend)
        host = {"input_ids": ids, "attention_mask": mask, "patches_u8": patches,
                "text_present": b["text_present"], "image_present": b["image_present"]}
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        yield host, carry


def run(r, tmp: str, proc_start: float) -> None:
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        FastInferenceEngine,
        bucket_ladder,
        evaluate_logits_u8,
    )

    cfg, mix, dev = r.config, r.cell.traffic, r.device
    recipe = cfg["recipe"]["eval"]
    classes = cfg["head"]["class_names"]
    n, B, workers = int(mix["rows"]), int(mix["batch"]), int(mix["num_workers"])
    buckets = tuple(mix["seq_buckets"])

    enc = assets.encoder_dir(cfg)
    data = traffic.rows(r.seed, n, mix, classes)
    csv_path = traffic.write_csv(os.path.join(tmp, "rows.csv"), data, classes)
    port.build_kernels(["patch_embed_u8", "attention_nhd"], dev)
    wdtype = torch.bfloat16 if recipe["precision"] == "bf16_fast" else torch.float32
    model = port.fusion_model(cfg, weights.draw(cfg, r.seed, dev, wdtype), dev, recipe,
                              train=False)
    engine = FastInferenceEngine(model, cfg["image"]["mean"], cfg["image"]["std"])
    ds = port.dataset(cfg, csv_path, assets.JPEG_DIR, enc, os.path.join(tmp, "pixels"), recipe)
    ladder = bucket_ladder(buckets, cfg["max_text_length"])
    r.notes["bucket_rows"] = traffic.token_hist(ds.attention_mask, ladder)

    def one_pass():
        return evaluate_logits_u8(engine, ds, B, num_workers=workers, seq_buckets=buckets)[0]

    # the cold pass decodes every JPEG into the cache and runs every bucket
    # width the window runs
    one_pass()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    recorder = trace.ShapeRecorder().install() if r.trace and dev.type == "cuda" else None

    r.setup_s = time.time() - proc_start
    outputs, pass_s, host = [], [], []
    t0 = time.perf_counter()
    while True:
        t, h = time.perf_counter(), env.host_sample()
        with r.spans.span("engine"):
            outputs.append(one_pass())
        pass_s.append(time.perf_counter() - t)
        host.append(env.host_delta(h, env.host_sample()))
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    r.notes["pass_s"] = pass_s
    r.notes["host_per_pass"] = host
    r.attempted = n * len(outputs)
    r.end_to_end["score_rows_per_s"] = r.attempted / window_s

    if r.trace and dev.type == "cuda":
        recorder.on = True
        with trace.profiled(dev, r.spans) as p:
            with r.spans.span("engine"):
                outputs.append(one_pass())
        recorder.on = False
        recorder.uninstall()
        r.summary = trace.summarize(p)
        r.shapes = recorder.calls
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)

    if r.trace:
        # the host input alone: one pass of the prep, same workers, no device
        extra = spec.family(cfg).bucket_extra(cfg)
        t = time.perf_counter()
        for _ in _prep(engine, ds, B, workers, ladder, extra):
            pass
        r.measured["host_prep_rows_per_s"] = n / (time.perf_counter() - t)
        # the engine alone over the pass's batches already on the card
        staged = [({k: v.to(dev, non_blocking=True) for k, v in h.items()}, c)
                  for h, c in _prep(engine, ds, B, workers, ladder, extra)]

        def run_staged():
            for h, c in staged:
                engine(h["input_ids"], h["attention_mask"], h["patches_u8"],
                       h["text_present"], h["image_present"], carry_pos=c)

        run_staged()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        run_staged()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        r.measured["engine_rows_per_s"] = len(staged) * B / (time.perf_counter() - t)
        del staged

    del engine, model, ds
    compare.free_device()

    reference = compare.Reference(cfg, r.seed, enc, dev, weight_dtype=wdtype)
    lengths = np.asarray([len(t.split()) for t in data["texts"]])
    rows = compare.sample_rows(r.seed, n, int(mix["compare_rows"]), lengths)
    want = reference.logits([data["texts"][i] for i in rows], [data["images"][i] for i in rows])
    gaps = [float(np.abs(o[rows] - want).max()) for o in outputs]
    r.failed = int(sum(int(not np.isfinite(o).all()) * n for o in outputs))
    r.check("max_abs_logit_gap", max(gaps), r.cell.limits["max_abs_logit_gap"])
    if r.trace:
        tokens = reference.text_tokens(data["texts"])
        per_pass = sum(model_flops.forward(cfg, int(k)) for k in tokens)
        r.measured["model_flops"] = per_pass * (len(outputs) - (1 if r.summary else 0))
        r.measured["model_seconds"] = window_s
