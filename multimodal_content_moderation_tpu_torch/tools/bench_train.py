"""Training-step throughput on one card (the JAX package's
``tools/bench_train.py``).

Measures the full fine-tuning step of the fusion classifier in mixed
precision (fp32 master weights, bf16 towers): forward with the head's
dropout, backward, and the Trainer's two-group AdamW update
(``training/loop.make_train_step``), over batches staged on the card.

``--wire u8`` (default) sends raw uint8 patch rows and embeds them with the
``patch_embed_u8`` kernel and its backward; ``--wire f32`` sends normalised
fp32 pixels through the patch-embedding dense. ``--attention pallas`` runs
the ``attention_nhd`` kernel in the forward and ``attention_nhd_bwd`` in the
backward. ``--decompose`` times forward, forward + backward and the full step
apart with CUDA events. Each pass is timed on the host clock and ends in a
synchronise. Prints one JSON line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c

N_STAGED = 4
PASSES = 3
TINY = {"batch": 4, "steps": 2}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--backend", choices=["clip", "siglip"], default="clip")
    ap.add_argument("--batch", type=int, default=None, help="default 128")
    ap.add_argument("--steps", type=int, default=None, help="micro-steps a pass (default 20)")
    ap.add_argument("--wire", choices=["u8", "f32"], default="u8")
    ap.add_argument("--scores_dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--sweep", type=str, default="",
                    help="comma-separated batch sizes to sweep (e.g. 64,128,192,256)")
    ap.add_argument("--decompose", action="store_true",
                    help="time forward / forward+backward / full step apart (one batch size)")
    ap.add_argument("--accumulator_dtype", choices=["", "bfloat16"], default="",
                    help="bf16 Adam m/v state; '' keeps fp32")
    ap.add_argument("--text_len", type=int, default=0,
                    help="static text width of the batches (0 = 77 or the tower's "
                    "positions); training.text_fit's width, exact for CLIP")
    ap.add_argument("--attention", choices=["xla", "pallas"], default="xla",
                    help="attention core (pallas = attention_nhd forward and "
                    "attention_nhd_bwd backward: training.attention: pallas)")
    args = ap.parse_args(argv)
    for key, value in (TINY if args.tiny else {"batch": 128, "steps": 20}).items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def build(args, device):
    """The fp32 fusion model with bf16 towers and ``args``' attention core
    and score dtype (and, on the u8 wire, the backend's stats folded into
    the embed)."""
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.models.u8wire import default_stats

    cfg = c.encoder_config(args.backend, args.tiny)
    model = FusionModel.create(args.backend, num_labels=len(c.CLASSES), seed=args.seed,
                               device=device, **c.config_kwargs(args.backend, cfg))
    model = model_io.with_performance_options(
        model, compute_dtype="bfloat16", scores_dtype=args.scores_dtype,
        attention_impl=args.attention)
    if args.wire == "u8":
        mean, std = default_stats(args.backend)
        model = model.replace(image_mean=mean, image_std=std)
    return model


def staged_batches(model, args, B: int, device):
    """``N_STAGED`` training batches on the device, each from its own
    sub-seed: ids with EOS at the middle, labels, and u8 patch rows or
    fp32 pixels."""
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8

    cfg = model.encoder_config
    img = model.image_size
    seq = args.text_len or min(cfg.text.max_positions, 77)
    vocab = cfg.text.vocab_size
    eos = getattr(cfg.text, "eos_token_id", vocab - 1)
    out = []
    for i in range(N_STAGED):
        gg = np.random.default_rng(c.sub_seed(args.seed, i))
        ids = gg.integers(1, vocab - 2, size=(B, seq)).astype(np.int32)
        ids[:, seq // 2] = eos
        b = {
            "input_ids": ids,
            "attention_mask": np.ones((B, seq), np.int32),
            "text_present": np.ones((B,), np.float32),
            "image_present": np.ones((B,), np.float32),
            "labels": (gg.random((B, len(c.CLASSES))) < 0.3).astype(np.float32),
        }
        if args.wire == "u8":
            b["patches_u8"] = extract_patches_u8(c.crops(gg, B, img), cfg.vision.patch_size)
        else:
            b["pixel_values"] = gg.normal(size=(B, 3, img, img)).astype(np.float32)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def train_step_of(model, args, device):
    """(step, optimizer): the Trainer's train step over a fresh AdamW."""
    from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

    opt = AdamW(dict(model.named_parameters()), total_steps=1000,
                accumulator_dtype=args.accumulator_dtype or None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return make_train_step(model, opt, generator=gen), opt


def run_once(args, B: int, device) -> dict:
    """Samples/s of ``PASSES`` passes of ``args.steps`` micro-steps at batch
    ``B`` on a fresh model, and the launches over them."""
    model = build(args, device)
    batches = staged_batches(model, args, B, device)
    step, _ = train_step_of(model, args, device)
    step(batches[0])
    c.sync(device)
    counts = c.launch_counter()
    rates = c.staged_rates(lambda k: step(batches[k % N_STAGED]), args.steps, B, PASSES,
                           device)
    return {"rates": rates, "launches": counts()}


def decompose(args, B: int, device) -> dict:
    """Forward (loss, no gradients) / forward + backward / full step, mean
    ms of ``args.steps`` calls each (``mean_ms``: CUDA events on the card)."""
    model = build(args, device)
    batches = staged_batches(model, args, B, device)
    step, opt = train_step_of(model, args, device)

    def fwd(k):
        with torch.no_grad():
            return model(batches[k % N_STAGED])["loss"]

    def fwd_bwd(k):
        for p in opt.params.values():
            p.grad = None
        loss = model(batches[k % N_STAGED])["loss"]
        loss.backward()
        return loss

    fwd_ms = c.mean_ms(fwd, args.steps, device)
    bwd_ms = c.mean_ms(fwd_bwd, args.steps, device)
    full_ms = c.mean_ms(lambda k: step(batches[k % N_STAGED]), args.steps, device)
    return {
        "batch": B,
        "fwd_ms": fwd_ms,
        "fwd_bwd_ms": bwd_ms,
        "full_step_ms": full_ms,
        "bwd_over_fwd": (bwd_ms - fwd_ms) / fwd_ms,
        "optimizer_ms": full_ms - bwd_ms,
        "samples_per_s": B / full_ms * 1e3,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "bench-train")
    common = {"wire": args.wire, "backend": args.backend, "attention": args.attention,
              "scores_dtype": args.scores_dtype,
              "accumulator_dtype": args.accumulator_dtype or "float32",
              "text_len": args.text_len or None, "device": c.card_line(device),
              "seed": args.seed, "tiny": args.tiny}
    if args.decompose:
        counts = c.launch_counter()
        out = decompose(args, args.batch, device)
        return c.emit({"metric": "train_step_decomposition", **out, **common,
                       "launches": counts()})
    sizes = [int(s) for s in args.sweep.split(",") if s] if args.sweep else [args.batch]
    results = []
    for B in sizes:
        r = run_once(args, B, device)
        s = c.spread(r["rates"])
        results.append({"batch": B, "samples_per_s": s["max"], "median_samples_per_s":
                        s["median"], "min_samples_per_s": s["min"],
                        "ms_per_step": B / s["max"] * 1e3,
                        "passes_samples_per_s": r["rates"], "launches": r["launches"]})
    best = max(results, key=lambda r: r["samples_per_s"])
    return c.emit({
        "metric": "train_step_samples_per_sec_per_chip",
        "value": best["samples_per_s"],
        "median": best["median_samples_per_s"],
        "min": best["min_samples_per_s"],
        "passes_samples_per_s": best["passes_samples_per_s"],
        "unit": "samples/s",
        "batch": best["batch"],
        "ms_per_step": best["ms_per_step"],
        "steps": args.steps,
        "sweep": results if len(results) > 1 else None,
        "launches": best["launches"],
        **common,
    })


if __name__ == "__main__":
    main()
