#!/usr/bin/env python
"""Containerized training entrypoint (SageMaker conventions; the JAX
package's ``serving/entrypoint.py``).

A self-contained variant of the training CLI honouring the ``/opt/ml``
conventions the reference's ``sagemaker/train_sagemaker.py`` implements:
environment data channels (SM_CHANNEL_TRAIN/VALIDATION/TEST/IMAGES/ENCODER,
SM_MODEL_DIR, SM_OUTPUT_DATA_DIR; :85-91), flat dashed hyperparameter flags
(:94-180) and priority-based data-file / image-root discovery (:183-221).
It writes ``resolved_config.yaml`` (equal to ``yaml.safe_dump``'s, written
by ``utils/yaml_text.py``, so no yaml package is needed) and trains it with
the port's train CLI on the card (``--device cuda``, the default) or the
CPU, then writes ``hyperparameters.json`` and ``final_metrics.json``. Two
flags are the port's own: ``--device`` and ``--image-backend`` (the native
JPEG decoder, for a container without PIL).

    SM_CHANNEL_TRAIN=... SM_CHANNEL_VALIDATION=... SM_MODEL_DIR=... \\
        python -m multimodal_content_moderation_tpu_torch.serving.entrypoint \\
        --encoder-assets-dir /path/to/clip-vit-base-patch32 --max-steps 100
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path
from typing import Optional


def find_data_file(channel_dir: str, names=("data.csv", "train.csv", "val.csv", "test.csv")) -> Optional[str]:
    """Priority search for the channel's CSV (reference train_sagemaker.py:
    183-205): exact names first, then any single CSV."""
    if not channel_dir or not os.path.isdir(channel_dir):
        return None
    for name in names:
        p = os.path.join(channel_dir, name)
        if os.path.exists(p):
            return p
    csvs = sorted(glob.glob(os.path.join(channel_dir, "*.csv")))
    return csvs[0] if csvs else None


def find_image_root(*candidate_dirs: str) -> str:
    """Probe for an images/ directory near the data channels
    (reference train_sagemaker.py:208-221)."""
    for d in candidate_dirs:
        if not d:
            continue
        for probe in (os.path.join(d, "images"), d):
            if os.path.isdir(probe) and glob.glob(os.path.join(probe, "*.jpg")) + glob.glob(
                os.path.join(probe, "*.png")
            ):
                return probe
    for d in candidate_dirs:
        if d and os.path.isdir(os.path.join(d, "images")):
            return os.path.join(d, "images")
    return candidate_dirs[0] if candidate_dirs and candidate_dirs[0] else ""


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Containerized training entrypoint (PyTorch/CUDA port)")
    env = os.environ
    # channels (SageMaker conventions)
    p.add_argument("--train-dir", default=env.get("SM_CHANNEL_TRAIN", "/opt/ml/input/data/train"))
    p.add_argument("--validation-dir", default=env.get("SM_CHANNEL_VALIDATION", "/opt/ml/input/data/validation"))
    p.add_argument("--test-dir", default=env.get("SM_CHANNEL_TEST", ""))
    p.add_argument("--images-dir", default=env.get("SM_CHANNEL_IMAGES", ""))
    p.add_argument("--encoder-assets-dir", default=env.get("SM_CHANNEL_ENCODER", ""))
    p.add_argument("--model-dir", default=env.get("SM_MODEL_DIR", "/opt/ml/model"))
    p.add_argument("--output-data-dir", default=env.get("SM_OUTPUT_DATA_DIR", "/opt/ml/output/data"))
    # flat hyperparameters (same names as the reference's flags)
    p.add_argument("--backend", default="clip", choices=["clip", "siglip", "auto"])
    p.add_argument("--head", default="fusion", choices=["fusion", "mtl"])
    p.add_argument("--encoder-name", default="openai/clip-vit-base-patch32")
    p.add_argument("--fusion-dim", type=int, default=512)
    p.add_argument("--max-text-length", type=int, default=77)
    p.add_argument("--class-names", default="racist,sexist,homophobe,religion,otherhate")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=-1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--eval-batch-size", type=int, default=64)
    p.add_argument("--lr-encoder", type=float, default=1e-5)
    p.add_argument("--lr-head", type=float, default=5e-4)
    p.add_argument("--weight-decay", type=float, default=0.02)
    p.add_argument("--warmup-ratio", type=float, default=0.05)
    p.add_argument("--loss-type", default="bce", choices=["bce", "focal", "asl"])
    p.add_argument("--focal-gamma", type=float, default=1.5)
    p.add_argument("--sampler", default="random", choices=["random", "weighted"])
    p.add_argument("--augment", action="store_true")
    p.add_argument("--head-hidden-dim", type=int, default=0)
    p.add_argument("--learnable-task-weights", action="store_true")
    p.add_argument("--early-stopping-patience", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model trains; cuda needs a card")
    p.add_argument("--image-backend", default=None, choices=["pil", "native", "native_scaled"],
                   help="data.image_backend (the JPEG decode path); unset leaves it out "
                   "of the resolved config, so the train CLI's default (pil) holds")
    return p.parse_args(argv)


def train(argv=None) -> dict:
    args = parse_args(argv)
    from multimodal_content_moderation_tpu_torch.cli import train as train_cli
    from multimodal_content_moderation_tpu_torch.utils.config import save_json
    from multimodal_content_moderation_tpu_torch.utils.yaml_text import dumps

    train_csv = find_data_file(args.train_dir, ("data.csv", "train.csv"))
    val_csv = find_data_file(args.validation_dir, ("data.csv", "val.csv", "validation.csv"))
    test_csv = find_data_file(args.test_dir, ("data.csv", "test.csv")) if args.test_dir else None
    if not train_csv or not val_csv:
        raise FileNotFoundError(
            f"train/val CSV not found under {args.train_dir} / {args.validation_dir}"
        )
    image_root = find_image_root(args.images_dir, args.train_dir, args.validation_dir)

    config = {
        "model": {
            "backend": args.backend,
            "head": args.head,
            "encoder_name": args.encoder_name,
            "encoder_dir": args.encoder_assets_dir or None,
            "fusion_dim": args.fusion_dim,
            "max_text_length": args.max_text_length,
            "head_hidden_dim": args.head_hidden_dim,
            "learnable_task_weights": args.learnable_task_weights,
        },
        "data": {
            "train_csv": train_csv,
            "val_csv": val_csv,
            "test_csv": test_csv,
            "image_root": image_root,
            "class_names": [c.strip() for c in args.class_names.split(",") if c.strip()],
        },
        "training": {
            "per_device_train_batch_size": args.batch_size,
            "per_device_eval_batch_size": args.eval_batch_size,
            "num_train_epochs": args.epochs,
            "max_steps": args.max_steps,
            "lr_encoder": args.lr_encoder,
            "lr_head": args.lr_head,
            "weight_decay": args.weight_decay,
            "warmup_ratio": args.warmup_ratio,
            "sampler": args.sampler,
        },
        "loss": {"type": args.loss_type, "focal_gamma": args.focal_gamma},
        "augmentation": {"enabled": args.augment},
        "early_stopping": {"enabled": True, "patience": args.early_stopping_patience},
        "saving": {"output_dir": args.model_dir},
        "seed": args.seed,
    }

    if args.image_backend:
        config["data"]["image_backend"] = args.image_backend

    os.makedirs(args.output_data_dir, exist_ok=True)
    cfg_path = os.path.join(args.output_data_dir, "resolved_config.yaml")
    Path(cfg_path).write_text(dumps(config))

    out = train_cli.main(["--config", cfg_path, "--device", args.device])
    # hyperparameters + metrics copies in the output channel
    save_json(vars(args), os.path.join(args.output_data_dir, "hyperparameters.json"))
    save_json(out["val"], os.path.join(args.output_data_dir, "final_metrics.json"))
    return out


if __name__ == "__main__":
    train()
