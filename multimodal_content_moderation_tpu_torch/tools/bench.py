"""Headline benchmark of the port: streaming evaluation throughput of the
CLIP ViT-B/32 fusion classifier on one card (the JAX package's
``bench.py``).

    python bench_torch.py [--device cpu] [--tiny] [--seed N]

The counterpart of the reference's published metric
(``test_samples_per_second`` in runs/*/test_metrics.json: 381.5 samples/s
for clip_fusion on its GPU). It runs the fast-eval path
(``models/fast_infer.py``): uint8 patch rows -> the ``patch_embed_u8``
kernel -> bf16 towers with the attention kernels (``attention: pallas``)
-> the fusion head, over 10,080 MMHS150K-shaped samples (77 BPE tokens,
224x224 RGB) in batches of 144.

- ``value``: samples/s over batches staged on the card (4 patch batches in
  turn, distinct token ids for every batch of a pass), the median of 5
  passes with their min and max; each pass is timed on the host clock and
  ends in ``torch.cuda.synchronize()``.
- ``value_bucketed``: the same at the seq-32 text bucket (EOS at 30), exact
  for CLIP (causal tower, first-EOS pooling).
- ``e2e_*``: the full pipeline, the reference's measurement boundary: CSV
  rows -> BPE -> JPEG decode + resize + crop (``native_scaled``: libjpeg,
  or nvJPEG where the machine has no libjpeg) -> u8 wire -> the card,
  through ``data/dataset.CSVDataset`` and ``evaluate_logits_u8``; 3 cold
  passes, then 3 with the decode-once pixel cache filled.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c

BASELINE_SAMPLES_PER_SEC = 381.5  # the reference's clip_fusion test throughput
BASELINE_E2E_SAMPLES_PER_SEC = 400.9  # the reference's, DataLoader included
N_SAMPLES = 10_080  # 70 batches of 144
BATCH = 144
SEQ = 77
BUCKET = 32
EOS_POS = 30
N_STAGED = 4  # distinct staged patch batches rotated through a pass
PASSES = 5
E2E_ROWS = 1536
E2E_PASSES = 3
TINY = {"batch": 4, "n_samples": 8, "passes": 2, "e2e_rows": 8}  # --tiny's counts
FULL = {"batch": BATCH, "n_samples": N_SAMPLES, "passes": PASSES, "e2e_rows": E2E_ROWS}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    return ap.parse_args(argv)


def build_model(tiny: bool, seed: int, device):
    """The fusion classifier over CLIP ViT-B/32 (or the tiny towers), fp32,
    random weights from ``seed``."""
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

    return FusionModel.create("clip", num_labels=len(c.CLASSES), seed=seed, device=device,
                              clip_config=c.encoder_config("clip", tiny))


def make_engine(model, dtype: str = "bfloat16", attention: str = "pallas"):
    """The fast engine over ``model`` with its towers (and, in bf16, its
    weights) in ``dtype`` and the ``attention`` core."""
    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine

    model = model_io.with_performance_options(
        model, compute_dtype=dtype, scores_dtype=dtype, attention_impl=attention)
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    return FastInferenceEngine(model, CLIP_MEAN, CLIP_STD)


def staged_inputs(engine, batch: int, n_ids: int, seed: int, id_base: int = 1000,
                  width: int = SEQ):
    """Host inputs: ``N_STAGED`` batches of u8 patch rows from seeded crops,
    and ``n_ids`` batches of token ids (``make_ids`` of sub-seeds
    ``id_base + k``, cut to ``width`` columns). At seed 0 these are the JAX
    bench's draws."""
    text = engine.model.clip_config.text
    g = np.random.default_rng(seed)
    img = engine.model.image_size
    patches = [engine.patches_from_hwc(c.crops(g, batch, img)) for _ in range(N_STAGED)]
    ids = [np.ascontiguousarray(
        c.make_ids(c.sub_seed(seed, id_base + k), batch, SEQ, text.vocab_size,
                   text.eos_token_id, EOS_POS)[:, :width]) for k in range(n_ids)]
    return ids, patches


def timed_window(engine, batch: int, n_batches: int, passes: int, seed: int,
                 id_base: int, width: int, device):
    """(rates, launches): staged samples/s of ``passes`` passes and the
    kernels' launches over them."""
    ids, patches = staged_inputs(engine, batch, n_batches, seed, id_base, width)
    ids = [torch.from_numpy(x).to(device) for x in ids]
    patches = [torch.from_numpy(p).to(device) for p in patches]
    mask = torch.ones(batch, width, dtype=torch.int32, device=device)
    ones = torch.ones(batch, device=device)

    def run(i):
        return engine(ids[i], mask, patches[i % N_STAGED], ones, ones)

    run(0)
    c.sync(device)
    counts = c.launch_counter()
    rates = c.staged_rates(run, n_batches, batch, passes, device)
    return rates, counts()


def bench_e2e(engine, batch: int, rows: int) -> dict:
    """Full-pipeline samples/s over a CSV of the committed JPEG fixtures."""
    from multimodal_content_moderation_tpu_torch.data import native
    from multimodal_content_moderation_tpu_torch.models.fast_infer import evaluate_logits_u8

    tmp = tempfile.mkdtemp(prefix="bench_e2e_")
    try:
        csv_path = c.write_e2e_csv(tmp, rows)
        n_images = len(c.fixture_jpegs())
        seq = engine.model.clip_config.text.max_positions
        img = engine.model.image_size

        def timed_pass(ds) -> float:
            t0 = time.perf_counter()
            logits, _ = evaluate_logits_u8(engine, ds, batch)  # host arrays: synchronised
            dt = time.perf_counter() - t0
            if logits.shape != (rows, len(c.CLASSES)) or not np.isfinite(logits).all():
                raise RuntimeError(f"e2e logits {logits.shape} are not finite")
            return rows / dt

        # cold passes: CSV read, BPE, decode, resize, crop, u8 wire, the card;
        # the last one fills the decode-once cache for the cached passes
        cold = [timed_pass(c.e2e_dataset(tmp, csv_path, seq, img, cache=False))
                for _ in range(E2E_PASSES - 1)]
        ds = c.e2e_dataset(tmp, csv_path, seq, img, cache=True)
        cold.append(timed_pass(ds))
        warm = [timed_pass(ds) for _ in range(E2E_PASSES)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cold_s, warm_s = c.spread(cold), c.spread(warm)
    decoder = native.jpeg_decoder()
    return {
        "e2e_samples_per_s": cold_s["median"],
        "e2e_samples_per_s_min": cold_s["min"],
        "e2e_samples_per_s_max": cold_s["max"],
        "e2e_cached_samples_per_s": warm_s["median"],
        "e2e_cached_samples_per_s_min": warm_s["min"],
        "e2e_cached_samples_per_s_max": warm_s["max"],
        "e2e_passes_samples_per_s": cold,
        "e2e_cached_passes_samples_per_s": warm,
        "e2e_rows": rows,
        "e2e_host_cpus": c.host_cpus(),
        "e2e_vs_baseline": cold_s["median"] / BASELINE_E2E_SAMPLES_PER_SEC,
        "e2e_images": f"the {n_images} committed JPEG fixtures (testdata/jpeg) in turn, "
                      f"decoded by {decoder}",
        "e2e_note": f"host-side decode on {c.host_cpus()} cores ({decoder}, native_scaled) "
                    f"over the {n_images} JPEG fixtures in turn; the cached passes read the "
                    "decode-once pixel cache",
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "bench")
    card = c.card_line(device)
    n = TINY if args.tiny else FULL
    batch, passes = n["batch"], n["passes"]
    engine = make_engine(build_model(args.tiny, args.seed, device))
    n_batches = -(-n["n_samples"] // batch)

    rates, launches = timed_window(engine, batch, n_batches, passes, args.seed, 1000, SEQ, device)
    s = c.spread(rates)
    result = {
        "metric": "mmhs150k_eval_samples_per_sec_per_chip",
        "value": s["median"],
        "unit": "samples/s",
        "vs_baseline": s["median"] / BASELINE_SAMPLES_PER_SEC,
        "passes_samples_per_s": rates,
        "value_min": s["min"],
        "value_max": s["max"],
        "device": card,
        "launches": launches,
        "launches_window": f"{passes} passes x {n_batches} batches of {batch}, seq {SEQ}",
        "seed": args.seed,
        "batch": batch,
        "n_samples": n_batches * batch,
        "attention": "pallas",
        "tiny": args.tiny,
    }
    rates_b, launches_b = timed_window(engine, batch, n_batches, passes, args.seed, 5000,
                                       BUCKET, device)
    sb = c.spread(rates_b)
    result.update(
        value_bucketed=sb["median"],
        value_bucketed_min=sb["min"],
        value_bucketed_max=sb["max"],
        passes_bucketed_samples_per_s=rates_b,
        launches_bucketed=launches_b,
        bucketed_note="seq-32 text bucket (tweet-length rows), exact for CLIP",
    )
    result.update(bench_e2e(engine, batch, n["e2e_rows"]))
    return c.emit(result)


if __name__ == "__main__":
    main()
