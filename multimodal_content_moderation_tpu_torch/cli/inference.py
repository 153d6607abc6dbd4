#!/usr/bin/env python
"""Inference CLI and the classifier API under the serving stack.

The JAX package's ``cli/inference.py`` surface: one ``--text``/``--image``
prediction, or ``--input_csv`` batch mode that writes the CSV back with
``pred_*``/``prob_*``/``any_harmful`` columns. Every path funnels into one
fixed-shape batched forward (``forward_batch``), with the last partial
batch padded, on the card unless the caller asks for the CPU.

    python -m multimodal_content_moderation_tpu_torch.cli.inference \\
        --checkpoint RUN/checkpoint-N --text "..." --image post.jpg

The CSV is read and written with the standard library (``data/dataset.py``
``read_csv``), so the CLI needs no pandas.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

logger = logging.getLogger("mmcm.inference")


def _prediction(row: np.ndarray, class_names, thresholds) -> Dict[str, Any]:
    predictions = {
        name: {"label": bool(p >= t), "probability": float(p), "threshold": float(t)}
        for name, p, t in zip(class_names, row, thresholds)
    }
    return {
        "predictions": predictions,
        "any_harmful": any(v["label"] for v in predictions.values()),
    }


class MultiModalClassifier:
    """Checkpoint-backed classifier with single and batched prediction.

    ``predict`` returns per-class ``{label, probability, threshold}`` and
    ``any_harmful``. ``precision``: fp32 | bf16 | bf16_fast (bf16 attention
    scores on the "xla" core) | int8_mlp (bf16_fast with int8 products in
    the (768, 3072) fc1 layers, ``ops/quant.py``; ``quantized_layers`` says
    how many); ``engine``: standard (normalised fp32 pixels)
    | fast (the uint8 wire and the fused patch-embed kernel, with text
    buckets, except for the generic backend, whose tower may mean-pool over
    the pads); ``image_backend``: pil | native | native_scaled;
    ``attention``: xla | pallas (the hand-written kernels); ``device``: the
    card ("cuda") unless the caller asks for "cpu"."""

    def __init__(
        self,
        checkpoint_dir: str,
        encoder_dir: Optional[str] = None,
        batch_size: int = 32,
        dtype=None,
        precision: str = "fp32",
        engine: str = "standard",
        image_backend: str = "pil",
        attention: str = "xla",
        seq_buckets: str = "auto",
        device: str = "cuda",
    ):
        import torch

        from multimodal_content_moderation_tpu_torch.models import model_io
        from multimodal_content_moderation_tpu_torch.models.fast_infer import (
            FastInferenceEngine,
            bucket_ladder,
            buckets_exact,
            parse_seq_buckets,
        )

        if precision not in ("fp32", "bf16", "bf16_fast", "int8_mlp"):
            raise ValueError(f"precision {precision!r}: want fp32, bf16, bf16_fast or int8_mlp")
        model, self.config = model_io.load_checkpoint(
            checkpoint_dir, encoder_dir, dtype=dtype, device=device
        )
        if precision != "fp32":
            model = model_io.with_performance_options(
                model,
                compute_dtype="bfloat16",
                scores_dtype="bfloat16" if precision != "bf16" else None,
            ).to(torch.bfloat16)
        self.quantized_layers = 0
        if precision == "int8_mlp":
            # bf16_fast + int8 products in the (768, 3072) fc1 layers, cast
            # first and then quantized, as the JAX classifier does
            from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

            model, self.quantized_layers = quantize_fc1_layers(model)
        if attention != "xla":
            model = model_io.with_performance_options(model, attention_impl=attention)
        self.model = model
        self.device = model.device
        self.attention = attention
        self.class_names: List[str] = self.config.get("class_names", ["harmful"])
        self.thresholds: List[float] = self.config.get(
            "thresholds", [0.5] * len(self.class_names)
        )
        # opt-in post-hoc logit adjustment (ops/losses.logit_adjust)
        self.logit_adjustment = bool(self.config.get("use_logit_adjustment", False))
        self.priors = self.config.get("priors")
        # a reference-written inference_config.json has no max_text_length:
        # clamp to the encoder's context window
        self.max_len = min(
            int(self.config.get("max_text_length", 77)), model.text_max_positions
        )
        self.batch_size = batch_size
        self.backend = self.config.get("backend", "clip")

        enc_dir = encoder_dir or self.config.get("encoder_dir") or checkpoint_dir
        self.tokenizer = load_tokenizer(enc_dir)
        (H, W), mean, std = image_stats_from_dir(enc_dir, self.backend)

        self.engine = None
        if engine == "fast":
            self.preproc = ImagePreprocessor(
                H, W, mean, std, output="uint8_hwc", backend=image_backend
            )
            self.engine = FastInferenceEngine(model, mean, std)
        elif engine == "standard":
            self.preproc = ImagePreprocessor(
                H, W, mean, std, output="float_nchw", backend=image_backend
            )
        else:
            raise ValueError(f"engine {engine!r}: want standard or fast")

        # Text buckets (fast engine): each batch runs at the smallest ladder
        # width covering its longest row, exact for CLIP (causal tower,
        # first-EOS pooling) and SigLIP (the carry column); never for the
        # generic towers, which may mean-pool over the pads (the JAX
        # classifier builds a ladder for them and shifts their logits).
        # Applied inside forward_batch, so predict, predict_batch, the
        # serving handler and the micro-batcher all get it.
        self._bucket_ladder: Optional[List[int]] = None
        buckets = parse_seq_buckets(seq_buckets)
        if buckets is not None:
            if self.engine is None or not buckets_exact(model.backend):
                # 'auto' is the default and silently inapplicable; an explicit
                # ladder deserves a signal
                if (seq_buckets or "").strip().lower() != "auto":
                    logger.warning(
                        "seq_buckets=%s ignored: %s evaluates at full text width",
                        seq_buckets,
                        "the standard engine" if self.engine is None else "the generic backend",
                    )
            else:
                self._bucket_ladder = bucket_ladder(buckets, self.max_len)

    # -- core batched path ----------------------------------------------------

    def make_batch(self, texts, pixels, presences, ids=None, mask=None) -> Dict[str, np.ndarray]:
        """Host arrays of one batch, zero-padded to ``batch_size`` rows."""
        if ids is None:
            ids, mask = self.tokenizer.encode_batch(texts, self.max_len)
        batch = {
            "input_ids": ids,
            "attention_mask": mask,
            "pixel_values": np.stack(pixels),
            "text_present": np.asarray(
                [1.0 if (t or "").strip() else 0.0 for t in texts], np.float32
            ),
            "image_present": np.asarray(presences, np.float32),
        }
        pad = self.batch_size - len(texts)
        if pad > 0:
            batch = {
                k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in batch.items()
            }
        return batch

    def _logits(
        self, texts: List[str], image_paths: List[str], image_root: str = ""
    ) -> np.ndarray:
        import concurrent.futures as cf

        from multimodal_content_moderation_tpu_torch.data.pipeline import bounded_producer

        n = len(texts)
        bs = self.batch_size
        out = np.empty((n, len(self.class_names)), np.float32)

        # Length-sorted visiting order (multi-batch fast-engine jobs): each
        # batch is length-homogeneous, so its bucket is the small one for
        # short rows. Results scatter back to input positions, and every op
        # is row-independent, so this is exact.
        order = np.arange(n)
        ids_all = mask_all = None
        if self._bucket_ladder and n > bs:
            ids_all, mask_all = self.tokenizer.encode_batch(list(texts), self.max_len)
            order = np.argsort(mask_all.sum(axis=1), kind="stable")

        # images decode on a thread pool (GIL-free in the native backends)
        # and whole batches are prepared one ahead on a producer thread, so
        # host preparation overlaps the previous batch's device work
        pool = cf.ThreadPoolExecutor(max_workers=8)

        def build(s: int):
            idx = order[s : s + bs]
            ts = [texts[i] for i in idx]
            results = list(
                pool.map(lambda p: self.preproc.load_relative(p, image_root),
                         [image_paths[i] for i in idx])
            )
            ids = mask = None
            if ids_all is not None:
                ids, mask = ids_all[idx], mask_all[idx]
            batch = self.make_batch(ts, [r[0] for r in results], [r[1] for r in results],
                                ids, mask)
            return idx, len(ts), batch

        q, _END, err, cancel = bounded_producer(
            lambda: (build(s) for s in range(0, n, bs)), size=2
        )
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    break
                idx, valid, batch = item
                out[idx[:valid]] = self.forward_batch(batch, valid)
        finally:
            # the producer may be blocked on the full queue: cancel() unblocks
            # and joins it, so nothing leaks in a long-lived process
            cancel()
            pool.shutdown(wait=False)
        return out

    def forward_batch(self, batch: Dict[str, np.ndarray], valid: int) -> np.ndarray:
        """One fixed-shape batch of host arrays -> logits[:valid] on the host
        (post-hoc logit adjustment applied where the config enables it).
        ``batch['pixel_values']`` is whatever ``self.preproc`` makes: uint8
        HWC crops for the fast engine, normalised fp32 NCHW otherwise. Shared
        by the API and the serving handler."""
        import torch

        if self.engine is not None:
            from multimodal_content_moderation_tpu_torch.models.fast_infer import (
                bucket_batch_text,
                bucket_for,
            )

            patches = self.engine.patches_from_hwc(batch["pixel_values"])
            ids, mask = batch["input_ids"], batch["attention_mask"]
            carry = None
            if self._bucket_ladder:
                b = bucket_for(mask, self._bucket_ladder,
                               extra=0 if self.backend == "clip" else 1)
                ids, mask, carry = bucket_batch_text(ids, mask, b, self.backend)
            logits = self.engine(
                np.ascontiguousarray(ids), np.ascontiguousarray(mask), patches,
                batch["text_present"], batch["image_present"], carry_pos=carry,
            )
        else:
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                   for k, v in batch.items()}
            with torch.inference_mode():
                logits = self.model(dev)["logits"].float()
        logits = logits.cpu().numpy()[:valid]
        if self.logit_adjustment and self.priors:
            from multimodal_content_moderation_tpu_torch.ops.losses import logit_adjust

            logits = logit_adjust(logits, self.priors)
        return logits

    def eval_kernels(self) -> List[str]:
        """The kernels this classifier's forward can launch: ``patch_embed_u8``
        on the fast engine; with ``attention="pallas"``, ``attention_nhd``,
        and ``flash_attention`` where a tower runs past ``MAX_SEQ`` positions
        (a SigLIP vision tower at 384 px; never CLIP at 224)."""
        from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ

        kernels = ["patch_embed_u8"] if self.engine is not None else []
        if self.attention == "pallas":
            vision = self.model.encoder_config.vision
            # CLIP and the ViT prepend a class token; SigLIP does not
            positions = ((vision.image_size // vision.patch_size) ** 2
                         + (self.backend in ("clip", "generic")))
            kernels.append("attention_nhd")
            if max(positions, self.max_len) > MAX_SEQ:
                kernels.append("flash_attention")
        return kernels

    def warmup(self) -> int:
        """Make the first request as fast as the later ones: on the card,
        build the kernels the forward can launch (one nvcc each, started
        together) and initialise the JPEG decoder, then run one dummy batch
        at every text width the request path can take (each bucket rung on
        the fast engine, else the full width). Returns the number of widths
        run."""
        if self.device.type == "cuda" and self.eval_kernels():
            from multimodal_content_moderation_tpu_torch.ops import _build

            _build.build(self.eval_kernels())
        self.preproc.warmup()
        widths = list(self._bucket_ladder) if self._bucket_ladder else [self.max_len]
        # SigLIP rungs reserve one carry column: a row of w-1 real tokens
        # lands exactly on rung w
        extra = 0 if self.backend == "clip" else 1
        zero_pix = self.preproc.zero_output()
        for w in widths:
            mask = np.zeros((self.batch_size, self.max_len), np.int32)
            mask[:, : max(1, min(w, self.max_len) - extra)] = 1
            batch = {
                "input_ids": np.zeros((self.batch_size, self.max_len), np.int32),
                "attention_mask": mask,
                "pixel_values": np.stack([zero_pix] * self.batch_size),
                "text_present": np.ones((self.batch_size,), np.float32),
                "image_present": np.ones((self.batch_size,), np.float32),
            }
            self.forward_batch(batch, 1)
        return len(widths)

    # -- public API -------------------------------------------------------

    def predict(
        self,
        text: Optional[str] = None,
        image_path: Optional[str] = None,
        return_probs: bool = False,
    ) -> Dict[str, Any]:
        logits = self._logits([text or ""], [image_path or ""])[0]
        probs = 1.0 / (1.0 + np.exp(-logits))
        result = _prediction(probs, self.class_names, self.thresholds)
        if return_probs:
            result["probabilities"] = probs.tolist()
        return result

    def predict_batch(
        self,
        texts: List[str],
        image_paths: List[str],
        batch_size: Optional[int] = None,
        image_root: str = "",
    ) -> List[Dict[str, Any]]:
        if batch_size:
            self.batch_size = batch_size
        logits = self._logits(list(texts), list(image_paths), image_root)
        probs = 1.0 / (1.0 + np.exp(-logits))
        return [_prediction(row, self.class_names, self.thresholds) for row in probs]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run inference with a multi-modal classifier (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--encoder_dir", type=str, default=None)
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--input_csv", type=str, default=None)
    parser.add_argument("--output_csv", type=str, default=None)
    parser.add_argument("--image_root", type=str, default="")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument(
        "--precision", choices=["fp32", "bf16", "bf16_fast", "int8_mlp"], default="fp32",
        help="int8_mlp = bf16_fast + int8 products in the (768, 3072) fc1 layers "
        "(ops/quant.py; eval-only)",
    )
    parser.add_argument(
        "--engine", choices=["standard", "fast"], default="standard",
        help="fast = uint8 wire format + the fused patch-embed kernel, with text buckets",
    )
    parser.add_argument(
        "--image_backend", choices=["pil", "native", "native_scaled"], default="pil",
        help="JPEG decode path: pil = PIL; native = the C++ library (libjpeg, or nvJPEG "
        "where libjpeg is missing), PIL's resize bit for bit; native_scaled adds "
        "libjpeg's DCT-domain downscale",
    )
    parser.add_argument(
        "--attention", choices=["xla", "pallas"], default="xla",
        help="attention core: pallas = the hand-written kernels; xla = plain products",
    )
    parser.add_argument(
        "--seq_buckets", type=str, default="auto",
        help="text buckets of the fast engine: 'auto' = 32,48,64; 'off' disables; or a "
        "comma-separated ladder",
    )
    parser.add_argument(
        "--device", choices=["cpu", "cuda"], default="cuda",
        help="where the model runs; cuda needs a card",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from multimodal_content_moderation_tpu_torch.utils.compile_cache import (
        maybe_enable_from_env,
    )

    maybe_enable_from_env()
    print(f"Loading model from: {args.checkpoint}")
    classifier = MultiModalClassifier(
        args.checkpoint, args.encoder_dir, batch_size=args.batch_size,
        precision=args.precision, engine=args.engine,
        image_backend=args.image_backend, attention=args.attention,
        seq_buckets=args.seq_buckets, device=args.device,
    )
    print(f"Classes: {classifier.class_names}")

    if args.input_csv:
        from multimodal_content_moderation_tpu_torch.data.dataset import read_csv

        table = read_csv(args.input_csv)
        results = classifier.predict_batch(
            table.strings("text"), table.strings("image_path"), args.batch_size,
            image_root=args.image_root,
        )
        extra: Dict[str, List[Any]] = {}
        for name in classifier.class_names:
            extra[f"pred_{name}"] = [r["predictions"][name]["label"] for r in results]
            extra[f"prob_{name}"] = [r["predictions"][name]["probability"] for r in results]
        extra["any_harmful"] = [r["any_harmful"] for r in results]
        output_path = args.output_csv or "predictions.csv"
        table.write(output_path, extra)
        print(f"Predictions saved to: {output_path}")
        return results
    if args.text or args.image:
        result = classifier.predict(args.text, args.image, return_probs=True)
        print("=" * 40)
        print("PREDICTION RESULT")
        print("=" * 40)
        for name, pred in result["predictions"].items():
            status = "DETECTED" if pred["label"] else "not detected"
            print(
                f"  {name}: {status} (prob: {pred['probability']:.3f}, "
                f"threshold: {pred['threshold']:.2f})"
            )
        print(f"Any harmful content: {'YES' if result['any_harmful'] else 'NO'}")
        return result
    print("Error: specify --text/--image or --input_csv")
    sys.exit(1)


if __name__ == "__main__":
    main()
