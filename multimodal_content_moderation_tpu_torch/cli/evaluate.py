#!/usr/bin/env python
"""Evaluation CLI (the reference ``scripts/evaluate.py`` surface): loads a
checkpoint and its inference_config.json, streams the test CSV through the
standard engine (``--engine standard``, the default: normalised fp32 pixels
at the full text width, ``training.loop.evaluate_logits_standard``) or the
uint8 fast engine (``--engine fast``: ``evaluate_logits_u8``, with text
buckets) and writes ``eval_results.json`` with the detailed metric schema
(mean-threshold overall metrics + per-class calibrated F1), computed in
numpy. A generic (BERT-family + ViT) checkpoint evaluates at the full text
width on both engines: its tower may mean-pool over the pads, so buckets
would change its logits. The CSV is read without pandas (``data/dataset.read_csv``), the CLIP
tokenizer runs without ``regex``, and ``--image_backend native*`` decodes
JPEGs without PIL, so the CLI runs on a machine that has none of them.

    python -m multimodal_content_moderation_tpu_torch.cli.evaluate \\
        --checkpoint RUN/checkpoint-N --test_csv test.csv --image_root images
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a multi-modal classifier (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--encoder_dir", type=str, default=None)
    parser.add_argument("--test_csv", type=str, required=True)
    parser.add_argument("--image_root", type=str, default="")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument(
        "--precision",
        choices=["fp32", "bf16", "bf16_fast", "int8_mlp"],
        default="fp32",
        help="fp32 = strict parity; bf16 = mixed precision; bf16_fast adds "
        "bf16 attention scores on the 'xla' core; int8_mlp = bf16_fast + int8 "
        "products in the (768, 3072) fc1 layers (ops/quant.py; eval-only)",
    )
    parser.add_argument(
        "--engine",
        choices=["standard", "fast"],
        default="standard",
        help="standard = normalised fp32 pixels through the pixel path at the full "
        "text width; fast = uint8 wire format + the fused patch-embed kernel, with "
        "text buckets",
    )
    parser.add_argument(
        "--attention",
        choices=["xla", "pallas"],
        default="xla",
        help="attention core in both towers: pallas = the hand-written kernels "
        "(attention_nhd over the [B,T,D] layout up to 256 positions, "
        "flash_attention beyond; plain versions on the CPU); xla = plain products",
    )
    parser.add_argument(
        "--seq_buckets",
        type=str,
        default="auto",
        help="length-sorted bucketed evaluation (fast engine): comma-separated "
        "ladder of text widths, e.g. '32,48,64'; exact for CLIP and SigLIP (its "
        "carry column), never used for the generic backend. 'auto' = 32,48,64; "
        "'off' disables",
    )
    parser.add_argument(
        "--image_backend",
        choices=["pil", "native", "native_scaled"],
        default="pil",
        help="JPEG decode path: pil = PIL; native = the C++ library (libjpeg, or nvJPEG "
        "where libjpeg is missing), PIL's resize bit for bit; native_scaled adds "
        "libjpeg's DCT-domain downscale",
    )
    parser.add_argument(
        "--image_cache",
        type=str,
        default=None,
        help="directory of the decode-once pixel cache (data/cache.py): the first run "
        "fills it, later runs over the same rows read it instead of decoding",
    )
    parser.add_argument(
        "--device",
        choices=["cpu", "cuda"],
        default="cuda",
        help="where the model runs; cuda needs a card",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from multimodal_content_moderation_tpu_torch.utils.compile_cache import (
        maybe_enable_from_env,
    )

    maybe_enable_from_env()

    from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        FastInferenceEngine,
        buckets_exact,
        evaluate_logits_u8,
        parse_seq_buckets,
    )
    from multimodal_content_moderation_tpu_torch.training.loop import evaluate_logits_standard
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        binary_f1,
        compute_detailed_metrics,
    )
    from multimodal_content_moderation_tpu_torch.utils.config import save_json

    print(f"Loading model from: {args.checkpoint}")
    model, config = model_io.load_checkpoint(
        args.checkpoint, args.encoder_dir, device=args.device
    )
    if args.precision in ("bf16", "bf16_fast", "int8_mlp"):
        model = model_io.with_performance_options(
            model,
            compute_dtype="bfloat16",
            scores_dtype="bfloat16" if args.precision != "bf16" else None,
        ).to(torch.bfloat16)
    if args.precision == "int8_mlp":
        from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

        model, nq = quantize_fc1_layers(model)
        print(f"int8 MLP: quantized {nq} fc1 layers (opt-in, eval-only)")
    if args.attention != "xla":
        model = model_io.with_performance_options(model, attention_impl=args.attention)
    class_names = config.get("class_names", ["harmful"])
    thresholds = config.get("thresholds", [0.5] * len(class_names))
    print(f"Classes: {class_names}")
    print(f"Thresholds: {thresholds}")

    enc_dir = args.encoder_dir or config.get("encoder_dir") or args.checkpoint
    tokenizer = load_tokenizer(enc_dir)
    (H, W), mean, std = image_stats_from_dir(enc_dir, config.get("backend", "clip"))
    preproc = ImagePreprocessor(
        H, W, mean, std, output="uint8_hwc" if args.engine == "fast" else "float_nchw",
        backend=args.image_backend,
    )
    test_ds = CSVDataset(
        args.test_csv,
        args.image_root,
        tokenizer,
        preproc,
        min(int(config.get("max_text_length", 77)), model.text_max_positions),
        class_names=class_names if len(class_names) > 1 else None,
        cache_dir=args.image_cache,
    )
    print(f"Test samples: {len(test_ds)}")

    explicit = (args.seq_buckets or "off").strip().lower() not in ("auto", "off", "none", "")
    full_width = args.engine != "fast" or not buckets_exact(model.backend)
    if explicit and full_width:
        # an explicit ladder that does nothing would be a trap ("auto", the
        # default, stays quiet), as the JAX CLI says
        why = ("requires --engine fast (standard engine evaluates at full text width)"
               if args.engine != "fast" else
               "the generic backend evaluates at full text width (its tower may "
               "mean-pool over the pads)")
        print(f"WARNING: seq_buckets={args.seq_buckets} ignored: {why}")
    if args.engine == "fast":
        engine = FastInferenceEngine(model, mean, std)
        t0 = time.time()
        logits, labels = evaluate_logits_u8(
            engine, test_ds, args.batch_size,
            seq_buckets=None if full_width else parse_seq_buckets(args.seq_buckets),
        )
    else:
        t0 = time.time()
        logits, labels = evaluate_logits_standard(model, test_ds, args.batch_size)
    dt = time.time() - t0
    if config.get("use_logit_adjustment") and config.get("priors"):
        # post-hoc logit adjustment: subtract log(p / (1 - p)) per class
        p = np.clip(np.asarray(config["priors"], np.float32), 1e-6, 1.0 - 1e-6)
        logits = logits - np.log(p / (1.0 - p))
    probs = 1 / (1 + np.exp(-logits))

    mean_threshold = float(np.mean(thresholds))
    metrics = compute_detailed_metrics(probs, labels, mean_threshold, class_names)
    for i, (name, thresh) in enumerate(zip(class_names, thresholds)):
        bin_pred = (probs[:, i] >= thresh).astype(int)
        metrics["per_class"][name]["f1_calibrated"] = binary_f1(labels[:, i], bin_pred)
        metrics["per_class"][name]["threshold"] = thresh
    metrics["runtime"] = dt
    metrics["samples_per_second"] = len(test_ds) / dt if dt > 0 else 0.0
    metrics["device"] = (
        torch.cuda.get_device_name(model.device) if model.device.type == "cuda" else "cpu"
    )

    print("=" * 60)
    print("EVALUATION RESULTS")
    print("=" * 60)
    print(f"F1 Macro: {metrics['f1_macro']:.4f}")
    print(f"F1 Micro: {metrics['f1_micro']:.4f}")
    print(f"ROC-AUC Macro: {metrics['roc_auc_macro']:.4f}")
    print(f"Throughput: {metrics['samples_per_second']:.1f} samples/s on {metrics['device']}")
    for name, cm in metrics["per_class"].items():
        print(
            f"  {name}: f1={cm['f1']:.4f} cal={cm.get('f1_calibrated', 0):.4f} "
            f"roc={cm['roc_auc']:.4f} support={cm['support']}"
        )

    output_path = args.output or os.path.join(args.checkpoint, "eval_results.json")
    save_json(metrics, output_path)
    print(f"Results saved to: {output_path}")
    return metrics


if __name__ == "__main__":
    main()
