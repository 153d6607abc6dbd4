"""JSON serving handler with the SageMaker-style contract.

The JAX package's ``serving/handler.py`` request path (model_fn -> input_fn
-> predict_fn -> output_fn) and JSONL batch transform, with the same
payload schema:

  request:  {"text": ..., "image": <base64>|"image_base64": ...|"image_url": ...}
            or {"instances": [...]}
  response: {"predictions": [{"class_predictions": {...},
             "probabilities": {...}, "any_harmful": bool}]}

Instances are batched through ``MultiModalClassifier.forward_batch`` on the
card (``device="cuda"``, unless the caller asks for the CPU). An image that
cannot be fetched or decoded degrades to zero pixels with presence 0.
"""

from __future__ import annotations

import base64
import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def model_fn(model_dir: str, encoder_dir: Optional[str] = None, device: str = "cuda"):
    """Load the classifier once at endpoint start, configured from the
    environment (the SageMaker way to configure a container):

    - ``MMHARM_ENGINE``: standard | fast (the uint8 wire + the patch-embed
      kernel);
    - ``MMHARM_PRECISION``: fp32 | bf16 | bf16_fast | int8_mlp (bf16_fast
      with int8 products in the (768, 3072) fc1 layers, ``ops/quant.py``);
    - ``MMHARM_IMAGE_BACKEND``: pil | native | native_scaled;
    - ``MMHARM_ATTENTION``: xla | pallas (the hand-written kernels);
    - ``MMHARM_SEQ_BUCKETS``: the fast engine's text buckets ('auto' =
      32,48,64; 'off');
    - ``MMHARM_COMPILE_CACHE``: where the kernels and the image library are
      built (``utils/compile_cache.py``);
    - ``MMHARM_PREWARM``: 0 skips ``warmup()``, which otherwise builds the
      kernels, initialises the JPEG decoder and runs every text width now,
      so that the first request does not pay for them."""
    from multimodal_content_moderation_tpu_torch.cli.inference import MultiModalClassifier
    from multimodal_content_moderation_tpu_torch.utils.compile_cache import (
        maybe_enable_from_env,
    )

    maybe_enable_from_env()
    classifier = MultiModalClassifier(
        model_dir,
        encoder_dir,
        precision=os.environ.get("MMHARM_PRECISION", "fp32"),
        engine=os.environ.get("MMHARM_ENGINE", "standard"),
        image_backend=os.environ.get("MMHARM_IMAGE_BACKEND", "pil"),
        attention=os.environ.get("MMHARM_ATTENTION", "xla"),
        seq_buckets=os.environ.get("MMHARM_SEQ_BUCKETS", "auto"),
        device=device,
    )
    if os.environ.get("MMHARM_PREWARM", "1") != "0":
        n = classifier.warmup()
        logger.info("model_fn: pre-warmed %d batch shape(s)", n)
    return classifier


def input_fn(request_body: str, content_type: str = "application/json") -> List[Dict]:
    """Parse a JSON request; a single object is wrapped into a list."""
    if content_type != "application/json":
        raise ValueError(f"Unsupported content type: {content_type}")
    data = json.loads(request_body)
    if isinstance(data, dict) and "instances" in data:
        return list(data["instances"])
    if isinstance(data, list):
        return data
    return [data]


def _image_bytes(instance: Dict[str, Any]) -> Optional[bytes]:
    """base64 ``image``/``image_base64`` or ``image_url`` -> the encoded
    bytes; a failure -> None (the image counts as absent). Decoding happens
    in ``ImagePreprocessor.process_bytes``."""
    try:
        b64 = instance.get("image") or instance.get("image_base64")
        if b64:
            return base64.b64decode(b64)
        if instance.get("image_url"):
            import urllib.request

            with urllib.request.urlopen(instance["image_url"], timeout=10) as r:
                return r.read()
    except Exception as e:  # noqa: BLE001 - a bad image degrades, never fails
        logger.warning("image fetch failed: %s", e)
    return None


def predict_fn(
    instances: List[Dict[str, Any]], classifier, device_lock=None
) -> List[Dict[str, Any]]:
    """Batched prediction over parsed instances.

    ``device_lock`` (optional) serialises only ``forward_batch`` (the device
    forward and its copy back to the host): base64 and JPEG decode, tokenize
    and batch assembly run outside it, so a threaded server overlaps one
    request's host work with another's device work."""
    texts: List[str] = []
    pixel_arrays: List[np.ndarray] = []
    presences: List[float] = []
    for inst in instances:
        texts.append(inst.get("text") or "")
        raw = _image_bytes(inst)
        if raw is None:
            pixel_arrays.append(classifier.preproc.zero_output())
            presences.append(0.0)
        else:
            arr, present = classifier.preproc.process_bytes(raw)
            pixel_arrays.append(arr)
            presences.append(present)

    bs = classifier.batch_size
    results = []
    for s in range(0, len(instances), bs):
        ts = texts[s : s + bs]
        batch = classifier.make_batch(ts, pixel_arrays[s : s + bs], presences[s : s + bs])
        if device_lock is not None:
            with device_lock:
                logits = classifier.forward_batch(batch, len(ts))
        else:
            logits = classifier.forward_batch(batch, len(ts))
        probs = 1.0 / (1.0 + np.exp(-logits))
        for row in probs:
            class_predictions = {
                name: bool(p >= t)
                for name, p, t in zip(classifier.class_names, row, classifier.thresholds)
            }
            results.append(
                {
                    "class_predictions": class_predictions,
                    "probabilities": {
                        name: float(p) for name, p in zip(classifier.class_names, row)
                    },
                    "any_harmful": any(class_predictions.values()),
                }
            )
    return results


def output_fn(predictions: List[Dict], accept: str = "application/json") -> str:
    """Serialise the response."""
    if accept != "application/json":
        raise ValueError(f"Unsupported accept type: {accept}")
    return json.dumps({"predictions": predictions})


class BatchTransformHandler:
    """JSONL batch transform: one JSON instance per line; a line that does
    not parse gets ``{"error": ...}``, blank lines are dropped."""

    def __init__(self, classifier):
        self.classifier = classifier

    def process_lines(self, lines: List[str]) -> List[str]:
        parsed: List[Optional[Dict]] = []
        for line in lines:
            line = line.strip()
            if not line:
                parsed.append(None)
                continue
            try:
                parsed.append(json.loads(line))
            except Exception as e:  # noqa: BLE001 - per-line error capture
                parsed.append({"__error__": str(e)})

        ok = [p for p in parsed if p is not None and "__error__" not in p]
        it = iter(predict_fn(ok, self.classifier) if ok else [])
        out = []
        for p in parsed:
            if p is None:
                continue
            if "__error__" in p:
                out.append(json.dumps({"error": p["__error__"]}))
            else:
                out.append(json.dumps(next(it)))
        return out

    def process_file(self, input_path: str, output_path: str) -> None:
        with open(input_path, "r", encoding="utf-8") as f:
            lines = f.readlines()
        results = self.process_lines(lines)
        with open(output_path, "w", encoding="utf-8") as f:
            for r in results:
                f.write(r + "\n")


def _local_test_main(argv=None):
    """Drive the endpoint contract locally, without a server:

    python -m multimodal_content_moderation_tpu_torch.serving.handler \\
        --model-dir DIR [--image post.jpg] [--device cpu]"""
    import argparse

    parser = argparse.ArgumentParser(description="Test the serving handler locally")
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--encoder-dir", default=None)
    parser.add_argument("--text", default="Test content")
    parser.add_argument("--image", default=None)
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = parser.parse_args(argv)

    classifier = model_fn(args.model_dir, args.encoder_dir, device=args.device)
    instance = {"text": args.text}
    if args.image and os.path.exists(args.image):
        with open(args.image, "rb") as f:
            instance["image_base64"] = base64.b64encode(f.read()).decode("utf-8")
    body = json.dumps({"instances": [instance]})
    result = predict_fn(input_fn(body), classifier)
    print(output_fn(result))
    return result


if __name__ == "__main__":
    _local_test_main()
