"""Eval-throughput bench for any backend x head combination on one card (the
JAX package's ``tools/bench_eval.py``).

``bench_torch.py`` is the headline bench (CLIP fusion); this tool measures
the other configurations the same way, over batches staged on the card:

    python -m multimodal_content_moderation_tpu_torch.tools.bench_eval --backend siglip --batch 64
    python -m multimodal_content_moderation_tpu_torch.tools.bench_eval --backend clip --head mtl

Reference baselines (runs/*/test_metrics.json, on its GPU): clip_fusion
381.5/s, clip_mtl 390.9/s, siglip_fusion 236.3/s.

``--decompose`` times the towers apart with CUDA events (ms per batch): the
text tower, the vision tower from the u8 patch rows, the whole forward and,
for SigLIP, the MAP head. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c

BASELINES = {
    ("clip", "fusion"): 381.5,
    ("clip", "mtl"): 390.9,
    ("siglip", "fusion"): 236.3,
}
N_STAGED = 4
DECOMPOSE_ITERS = 20
TINY = {"batch": 4, "n_samples": 8, "passes": 2}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--backend", choices=["clip", "siglip", "generic"], default="siglip")
    ap.add_argument("--head", choices=["fusion", "mtl"], default="fusion")
    ap.add_argument("--batch", type=int, default=None, help="default 48")
    ap.add_argument("--n_samples", type=int, default=None, help="default 4800")
    ap.add_argument("--passes", type=int, default=None, help="default 3")
    ap.add_argument("--sweep", type=str, default="",
                    help="comma-separated batch sizes to sweep (e.g. 48,96,144)")
    ap.add_argument("--image_size", type=int, default=0,
                    help="SigLIP's image size (384: google/siglip2-base-patch16-384, whose "
                    "576 patch tokens take flash_attention); 0 keeps the config's")
    ap.add_argument("--vision_attention", choices=["xla", "pallas"], default="xla",
                    help="the vision tower's attention core (pallas = the attention_nhd "
                    "kernel up to 256 positions, flash_attention above)")
    ap.add_argument("--text_attention", choices=["xla", "pallas"], default="xla",
                    help="the text tower's attention core")
    ap.add_argument("--int8_mlp", action="store_true",
                    help="int8 products in the (768, 3072) fc1 layers (ops/quant.py); "
                    "changes the logits")
    ap.add_argument("--decompose", action="store_true",
                    help="time the text tower, the vision tower, the whole forward and "
                    "(SigLIP) the MAP head apart at --batch (ms per batch)")
    ap.add_argument("--bucket", type=int, default=0,
                    help="time the text-bucketed path at this width (tweet-length rows; "
                    "the evaluate CLI's --seq_buckets auto). Exact for CLIP (truncation) "
                    "and SigLIP (bucket-1 real columns + the carry column); refused for "
                    "the generic backend, whose buckets change the logits")
    args = ap.parse_args(argv)
    full = {"batch": 48, "n_samples": 4800, "passes": 3}
    for key, value in (TINY if args.tiny else full).items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def build_engine(args, device, dtype: str = "bfloat16"):
    """The fast engine over a randomly initialised model of ``args``'
    backend and head, towers in ``dtype`` with their attention cores."""
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine
    from multimodal_content_moderation_tpu_torch.models.fusion import config_field
    from multimodal_content_moderation_tpu_torch.models.u8wire import default_stats

    cfg = c.encoder_config(args.backend, args.tiny)
    if args.image_size and args.backend == "siglip":
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, image_size=args.image_size))
    model = model_io.build_model(args.head, args.backend, c.CLASSES, seed=args.seed,
                                 device=device, **c.config_kwargs(args.backend, cfg))
    cfg = model.encoder_config
    perf = {"compute_dtype": dtype, "scores_dtype": dtype}
    cfg = dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, attention_impl=args.text_attention, **perf),
        vision=dataclasses.replace(cfg.vision, attention_impl=args.vision_attention, **perf),
    )
    model = model.replace(**{config_field(model.backend): cfg})
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    if args.int8_mlp:
        from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

        model, n = quantize_fc1_layers(model)
        c.warn("bench-eval", f"int8 fc1 layers: {n}")
    return FastInferenceEngine(model, *default_stats(args.backend))


def text_shape(engine):
    """(seq, vocab, eos) of the engine's text tower: width 77 or its
    positions, whichever is fewer."""
    t = engine.model.encoder_config.text
    return (min(t.max_positions, 77), t.vocab_size,
            getattr(t, "eos_token_id", t.vocab_size - 1))


def run_b(engine, args, B: int, device) -> dict:
    """Staged samples/s at batch ``B`` (distinct ids for every batch of a
    pass, ``N_STAGED`` patch batches in turn) and the launches."""
    from multimodal_content_moderation_tpu_torch.models.fast_infer import buckets_exact

    seq, vocab, eos = text_shape(engine)
    n_batches = -(-args.n_samples // B)
    T = args.bucket if args.bucket and args.bucket < seq else seq
    carry = None
    if T < seq and not buckets_exact(args.backend):
        raise SystemExit(f"bench-eval: --bucket {args.bucket}: the {args.backend} backend's "
                         "text buckets are not exact (its towers pool over every position)")
    if T < seq and args.backend != "clip":
        # SigLIP: T-1 real columns + a PAD carry column at the full width's
        # last position (models/fast_infer.bucket_batch_text)
        carry = seq - 1
    g = np.random.default_rng(args.seed)
    img = engine.model.image_size
    mask_np = np.ones((B, T), np.int32)
    if carry is not None:
        mask_np[:, -1] = 0
    mask = torch.from_numpy(mask_np).to(device)
    ones = torch.ones(B, device=device)
    patches = [torch.from_numpy(engine.patches_from_hwc(c.crops(g, B, img))).to(device)
               for _ in range(N_STAGED)]

    def make_ids(k):
        ids = c.make_ids(c.sub_seed(args.seed, 1000 + k), B, T, vocab, eos, T // 2)
        if carry is not None:
            ids[:, -1] = 0  # PAD in the carry slot
        return torch.from_numpy(ids).to(device)

    ids = [make_ids(k) for k in range(n_batches)]

    def run(i):
        return engine(ids[i], mask, patches[i % N_STAGED], ones, ones, carry_pos=carry)

    run(0)
    c.sync(device)
    counts = c.launch_counter()
    rates = c.staged_rates(run, n_batches, B, args.passes, device)
    return {"rates": rates, "launches": counts(), "n_samples": n_batches * B}


def towers(engine):
    """{part: fn(inputs) -> output} of the engine's model: "text" (ids,
    mask), "vision" (u8 patch rows) and, for SigLIP, "map_head" (the vision
    tower's last hidden states [B, N, D])."""
    from multimodal_content_moderation_tpu_torch.models import clip, generic, siglip
    from multimodal_content_moderation_tpu_torch.models.u8wire import embed_for_model

    model = engine.model
    bp = model.backbone
    cfg = model.encoder_config
    tokens = lambda p: embed_for_model(model, bp, p)  # noqa: E731
    if model.backend == "clip":
        return {
            "text": lambda ids, m: clip.clip_text_features(bp, ids, m, cfg),
            "vision": lambda p: clip.clip_image_features_from_tokens(bp, tokens(p), cfg),
        }
    if model.backend == "generic":
        return {
            "text": lambda ids, m: generic.generic_text_features(bp, ids, m, cfg),
            "vision": lambda p: generic.generic_image_features_from_tokens(bp, tokens(p), cfg),
        }
    return {
        "text": lambda ids, m: siglip.siglip_text_features(bp, ids, m, cfg),
        "vision": lambda p: siglip.siglip_image_features_from_tokens(bp, tokens(p), cfg),
        "map_head": lambda h: siglip._map_head(
            h.to(getattr(torch, cfg.vision.compute_dtype)), bp["vision_model"]["map_head"],
            cfg.vision),
    }


@torch.inference_mode()
def decompose(engine, args, B: int, device) -> dict:
    """Per-part ms per batch at batch ``B`` over ``N_STAGED`` staged inputs
    (``mean_ms``: CUDA events on the card)."""
    seq, vocab, _ = text_shape(engine)
    g = np.random.default_rng(c.sub_seed(args.seed, 7))
    img = engine.model.image_size
    ids = [torch.from_numpy(g.integers(1, vocab - 2, size=(B, seq)).astype(np.int32))
           .to(device) for _ in range(N_STAGED)]
    mask = torch.ones(B, seq, dtype=torch.int32, device=device)
    patches = [torch.from_numpy(engine.patches_from_hwc(c.crops(g, B, img))).to(device)
               for _ in range(N_STAGED)]
    ones = torch.ones(B, device=device)
    parts = towers(engine)
    n = 2 if args.tiny else DECOMPOSE_ITERS
    t_text = c.mean_ms(lambda i: parts["text"](ids[i % N_STAGED], mask), n, device)
    t_vis = c.mean_ms(lambda i: parts["vision"](patches[i % N_STAGED]), n, device)
    t_full = c.mean_ms(lambda i: engine(ids[i % N_STAGED], mask, patches[i % N_STAGED],
                                        ones, ones), n, device)
    out = {
        "batch": B,
        "text_ms_per_batch": t_text,
        "vision_ms_per_batch": t_vis,
        "full_ms_per_batch": t_full,
        "full_samples_per_s": B / t_full * 1e3,
    }
    if "map_head" in parts:
        vc = engine.model.encoder_config.vision
        n_pat = (vc.image_size // vc.patch_size) ** 2
        hid = [torch.from_numpy(g.standard_normal((B, n_pat, vc.hidden_size))
                                .astype(np.float32) / 30).to(device) for _ in range(N_STAGED)]
        out["map_head_ms_per_batch"] = c.mean_ms(
            lambda i: parts["map_head"](hid[i % N_STAGED]), n, device)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "bench-eval")
    card = c.card_line(device)
    engine = build_engine(args, device)
    attention = {"text": args.text_attention, "vision": args.vision_attention}
    common = {"backend": args.backend, "head": args.head, "attention": attention,
              "int8_mlp": args.int8_mlp, "image_size": engine.model.image_size,
              "device": card, "seed": args.seed, "tiny": args.tiny}
    if args.decompose:
        counts = c.launch_counter()
        parts = decompose(engine, args, args.batch, device)
        return c.emit({"decomposition": parts, **common, "launches": counts()})
    sizes = [int(s) for s in args.sweep.split(",") if s] if args.sweep else [args.batch]
    results = []
    for B in sizes:
        r = run_b(engine, args, B, device)
        s = c.spread(r["rates"])
        results.append({"batch": B, "samples_per_s": s["max"], "median_samples_per_s":
                        s["median"], "min_samples_per_s": s["min"],
                        "passes_samples_per_s": r["rates"], "launches": r["launches"],
                        "n_samples": r["n_samples"]})
    top = max(results, key=lambda r: r["samples_per_s"])
    baseline = BASELINES.get((args.backend, args.head))
    return c.emit({
        "metric": f"{args.backend}_{args.head}_eval_samples_per_sec_per_chip",
        "value": top["samples_per_s"],
        "median": top["median_samples_per_s"],
        "min": top["min_samples_per_s"],
        "passes_samples_per_s": top["passes_samples_per_s"],
        "unit": "samples/s",
        "batch": top["batch"],
        "n_samples": top["n_samples"],
        "bucket": args.bucket or None,
        "vs_baseline": top["samples_per_s"] / baseline if baseline else None,
        "sweep": results if len(results) > 1 else None,
        "launches": top["launches"],
        **common,
    })


if __name__ == "__main__":
    main()
