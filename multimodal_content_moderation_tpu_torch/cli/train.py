#!/usr/bin/env python
"""Training CLI (the JAX package's ``cli/train.py`` surface, after the
reference ``scripts/train.py``): the same ``--config`` + dotted
``--section.key`` overrides and the same five artifacts (config.json,
val_report.json, test_metrics.json, inference_config.json, label_map.json),
running the port's trainer on one device.

    python -m multimodal_content_moderation_tpu_torch.cli.train \\
        --config config/clip_fusion.yaml \\
        --model.encoder_dir /path/to/local/clip-vit-base-patch32

Ported: the CLIP, SigLIP and generic (a ``VisionTextDualEncoderModel``
encoder dir: BERT, RoBERTa or DistilBERT text + ViT; ``backend: auto``
resolves to it from the dir's ``config.json``) fusion and multi-task models
on either wire (``training.wire: f32``, the shipped default, or ``u8``),
``training.attention: pallas | xla``, ``training.precision: bf16 | fp32``,
``gradient_checkpointing`` (remat in both towers) and ``text_fit`` (CLIP
only: ignored with a warning for the other backends, as in the JAX
package). ``config/clip_fusion.yaml``,
``config/siglip_fusion.yaml`` and ``config/clip_mtl.yaml`` train as shipped
(``model.head: mtl`` scores each epoch with the per-task metrics). The run
directory records ``"format": "torch"`` and loads in the port's evaluate CLI.
The config is read with PyYAML where it is installed and with the port's
own reader where it is not (``utils/config.load_config``);
``logging.report_to: tensorboard`` writes event files under ``logs/`` and
``dump_test_predictions`` writes ``test_predictions.csv``, neither with
a package beyond torch and numpy.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Any, Dict

import numpy as np

logger = logging.getLogger("mmcm.train")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a multi-modal hateful-content classifier (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--config", "-c", type=str, default="config/default.yaml")
    parser.add_argument("--data.train_csv", dest="train_csv", default=None)
    parser.add_argument("--data.val_csv", dest="val_csv", default=None)
    parser.add_argument("--data.test_csv", dest="test_csv", default=None)
    parser.add_argument("--data.image_root", dest="image_root", default=None)
    parser.add_argument(
        "--model.backend", dest="backend", choices=["clip", "siglip", "auto", "generic"],
        default=None,
    )
    parser.add_argument("--model.head", dest="head", choices=["fusion", "mtl"], default=None)
    parser.add_argument("--model.encoder_name", dest="encoder_name", default=None)
    parser.add_argument("--model.encoder_dir", dest="encoder_dir", default=None)
    parser.add_argument("--model.fusion_dim", dest="fusion_dim", type=int, default=None)
    parser.add_argument(
        "--training.num_train_epochs", dest="num_train_epochs", type=int, default=None
    )
    parser.add_argument("--training.max_steps", dest="max_steps", type=int, default=None)
    parser.add_argument(
        "--training.per_device_train_batch_size", dest="batch_size", type=int, default=None
    )
    parser.add_argument("--training.lr_encoder", dest="lr_encoder", type=float, default=None)
    parser.add_argument("--training.lr_head", dest="lr_head", type=float, default=None)
    parser.add_argument(
        "--training.text_fit", dest="text_fit", default=None,
        help="'auto' shrinks the static text width to the data's longest row "
        "(rounded up to a multiple of 8), exact for CLIP; 'off' keeps "
        "model.max_text_length",
    )
    parser.add_argument("--saving.output_dir", dest="output_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    # mesh shape (the JAX CLI's); the port trains on one device
    parser.add_argument("--parallel.data", dest="mesh_data", type=int, default=None)
    parser.add_argument("--parallel.model", dest="mesh_model", type=int, default=None)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the model trains; cuda needs a card",
    )
    return parser.parse_args(argv)


def override_config(config: Dict[str, Any], args) -> Dict[str, Any]:
    overrides = {
        ("data", "train_csv"): args.train_csv,
        ("data", "val_csv"): args.val_csv,
        ("data", "test_csv"): args.test_csv,
        ("data", "image_root"): args.image_root,
        ("model", "backend"): args.backend,
        ("model", "head"): args.head,
        ("model", "encoder_name"): args.encoder_name,
        ("model", "encoder_dir"): args.encoder_dir,
        ("model", "fusion_dim"): args.fusion_dim,
        ("training", "num_train_epochs"): args.num_train_epochs,
        ("training", "max_steps"): args.max_steps,
        ("training", "per_device_train_batch_size"): args.batch_size,
        ("training", "lr_encoder"): args.lr_encoder,
        ("training", "lr_head"): args.lr_head,
        ("training", "text_fit"): args.text_fit,
        ("saving", "output_dir"): args.output_dir,
        ("parallel", "data"): args.mesh_data,
        ("parallel", "model"): args.mesh_model,
    }
    for (section, key), value in overrides.items():
        if value is not None:
            config.setdefault(section, {})[key] = value
    if args.seed is not None:
        config["seed"] = args.seed
    return config


def dump_predictions(path: str, probs: np.ndarray, labels: np.ndarray, class_names) -> None:
    """``test_predictions.csv``: every ``prob_<name>`` column, then every
    ``label_<name>`` column, each value written as pandas writes its
    column's dtype (the JAX CLI's ``DataFrame.to_csv``), with no pandas."""
    from multimodal_content_moderation_tpu_torch.data.dataset import write_records

    names = [f"prob_{n}" for n in class_names] + [f"label_{n}" for n in class_names]
    write_records(path, [dict(zip(names, list(p) + list(y))) for p, y in zip(probs, labels)])


def _refuse_unported(config, model_cfg, data_cfg) -> None:
    par = config.get("parallel", {})
    if (par.get("data") or -1) not in (-1, 1) or (par.get("model") or 1) != 1:
        raise NotImplementedError(
            f"parallel {par} is not ported yet: the port trains on one device "
            "(multi-GPU comes in a later slice)"
        )


def main(argv=None) -> Dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)

    from multimodal_content_moderation_tpu_torch.cli.common import (
        build_preprocessors,
        build_tokenizer,
        resolve_encoder_dir,
    )
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import config_field
    from multimodal_content_moderation_tpu_torch.ops.losses import logit_adjust
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs, Trainer
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        calibrate_thresholds,
        make_compute_metrics_mtl,
        make_compute_metrics_multi,
    )
    from multimodal_content_moderation_tpu_torch.utils.config import (
        ensure_dir,
        load_config,
        save_json,
    )

    config = override_config(load_config(args.config), args)
    model_cfg = dict(config.get("model", {}))
    data_cfg = config.get("data", {})
    train_cfg = config.get("training", {})
    loss_cfg = config.get("loss", {})
    aug_cfg = config.get("augmentation", {})
    eval_cfg = config.get("evaluation", {})
    save_cfg = config.get("saving", {})
    log_cfg = config.get("logging", {})
    early_cfg = config.get("early_stopping", {})
    seed = config.get("seed", 42)

    output_dir = save_cfg.get("output_dir", "runs/experiment")
    ensure_dir(output_dir)
    save_json(config, os.path.join(output_dir, "config.json"))
    logger.info("output dir: %s", output_dir)

    # ---- assets & data -----------------------------------------------------
    enc_dir = resolve_encoder_dir(model_cfg)
    model_cfg["backend"] = model_io.resolve_backend(enc_dir, model_cfg.get("backend", "clip"))
    _refuse_unported(config, model_cfg, data_cfg)
    tokenizer = build_tokenizer(model_cfg)
    wire = train_cfg.get("wire", "f32") or "f32"
    train_pp, eval_pp = build_preprocessors(
        model_cfg, aug_cfg, image_backend=data_cfg.get("image_backend", "pil"), seed=seed,
        output="uint8_hwc" if wire == "u8" else "float_nchw",
    )

    class_names = data_cfg.get("class_names", []) or []
    if isinstance(class_names, str):
        class_names = [c.strip() for c in class_names.split(",") if c.strip()]
    max_len = model_cfg.get("max_text_length", 77)

    def mk_ds(csv, pp, train):
        return CSVDataset(
            csv, data_cfg.get("image_root", ""), tokenizer, pp, max_len,
            class_names=class_names or None, is_train=train,
            # the decode-once pixel cache; CSVDataset skips it for an
            # augmenting preprocessor
            cache_dir=data_cfg.get("image_cache") or None,
        )

    train_ds = mk_ds(data_cfg["train_csv"], train_pp, True)
    val_ds = mk_ds(data_cfg["val_csv"], eval_pp, False)
    test_ds = mk_ds(data_cfg["test_csv"], eval_pp, False) if data_cfg.get("test_csv") else None
    class_names = train_ds.class_names

    # training.text_fit: shrink the static text width to the data's longest
    # row (a multiple of 8). Exact for CLIP: causal text tower + EOS pooling;
    # SigLIP pools the last position, so its pads are not inert
    text_fit = str(train_cfg.get("text_fit", "off") or "off").lower()
    if text_fit in ("auto", "on", "true", "1") and model_cfg["backend"] != "clip":
        logger.warning(
            "training.text_fit ignored: requires the CLIP backend (causal + EOS "
            "pooling); backend=%s pads are not inert", model_cfg["backend"],
        )
    elif text_fit in ("auto", "on", "true", "1"):
        splits = [d for d in (train_ds, val_ds, test_ds) if d is not None]
        longest = max(int(d.attention_mask.sum(axis=1).max(initial=1)) for d in splits)
        fit = min(max_len, max(8, -(-longest // 8) * 8))
        if fit < max_len:
            for d in splits:
                d.truncate_text(fit)
            logger.info("text_fit: static text width %d -> %d (longest row %d)",
                        max_len, fit, longest)
    logger.info("train %d | val %d | test %d", len(train_ds), len(val_ds),
                len(test_ds) if test_ds else 0)

    # ---- model --------------------------------------------------------------
    backend = model_cfg["backend"]
    head = model_cfg.get("head", "fusion")
    enc_config = model_io.load_encoder_config(enc_dir or "", backend)
    tower_overrides = {}
    if train_cfg.get("gradient_checkpointing", False):
        tower_overrides["remat"] = True
    if train_cfg.get("precision", "fp32") in ("bf16", "bfloat16"):
        tower_overrides["compute_dtype"] = "bfloat16"
    if train_cfg.get("attention", "xla") != "xla":
        # pallas = the [B,T,D]-layout attention kernels in both passes
        tower_overrides["attention_impl"] = train_cfg["attention"]
    if tower_overrides:
        enc_config = dataclasses.replace(
            enc_config,
            text=dataclasses.replace(enc_config.text, **tower_overrides),
            vision=dataclasses.replace(enc_config.vision, **tower_overrides),
        )
    model = model_io.build_model(
        head, backend, class_names,
        fusion_dim=model_cfg.get("fusion_dim", 512),
        loss_type=loss_cfg.get("type", "bce"),
        focal_gamma=loss_cfg.get("focal_gamma", 1.5),
        seed=seed, device=args.device,
        head_hidden_dim=model_cfg.get("head_hidden_dim", 0) or 0,
        learnable_task_weights=model_cfg.get("learnable_task_weights", False),
        **{config_field(backend): enc_config},
    )
    if wire == "u8":
        # the normalisation stats live in the model, folded into the patch
        # embed on the device (the f32 wire normalises on the host)
        model = model.replace(
            image_mean=tuple(float(m) for m in train_pp.mean),
            image_std=tuple(float(s) for s in train_pp.std),
        )
    model = model_io.init_from_encoder_dir(model, enc_dir)

    if head == "mtl":
        compute_metrics = make_compute_metrics_mtl(class_names, eval_cfg.get("threshold", 0.5))
    else:
        compute_metrics = make_compute_metrics_multi(
            len(class_names) or 1, eval_cfg.get("threshold", 0.5)
        )
    targs = TrainArgs(
        output_dir=output_dir,
        num_train_epochs=train_cfg.get("num_train_epochs", 8),
        max_steps=train_cfg.get("max_steps", -1) or -1,
        per_device_train_batch_size=train_cfg.get("per_device_train_batch_size", 32),
        per_device_eval_batch_size=train_cfg.get("per_device_eval_batch_size", 64),
        gradient_accumulation_steps=train_cfg.get("gradient_accumulation_steps", 1),
        lr_encoder=train_cfg.get("lr_encoder", 1e-5),
        lr_head=train_cfg.get("lr_head", 5e-4),
        weight_decay=train_cfg.get("weight_decay", 0.02),
        warmup_ratio=train_cfg.get("warmup_ratio", 0.05),
        max_grad_norm=train_cfg.get("max_grad_norm", 1.0),
        lr_scheduler_type=train_cfg.get("lr_scheduler_type", "cosine"),
        sampler=train_cfg.get("sampler", "random"),
        logging_steps=log_cfg.get("logging_steps", 50),
        save_total_limit=save_cfg.get("save_total_limit", 2),
        load_best_model_at_end=save_cfg.get("load_best_model_at_end", True),
        metric_for_best_model=save_cfg.get("metric_for_best_model", "roc_macro"),
        greater_is_better=save_cfg.get("greater_is_better", True),
        early_stopping=early_cfg.get("enabled", True),
        early_stopping_patience=early_cfg.get("patience", 3),
        seed=seed,
        num_workers=train_cfg.get("num_workers", 8),
        freeze_text=model_cfg.get("freeze_text", False),
        freeze_image=model_cfg.get("freeze_image", False),
        report_to=log_cfg.get("report_to", "none") or "none",
        logging_dir=os.path.join(output_dir, "logs"),
        debug_nans=train_cfg.get("debug_nans", False),
        resume_from_checkpoint=train_cfg.get("resume_from_checkpoint", "") or "",
        wire=wire,
        accumulator_dtype=train_cfg.get("accumulator_dtype", "") or "",
    )
    trainer = Trainer(model, targs, train_ds, val_ds, compute_metrics, device=args.device)
    logger.info("starting training (%d total steps)", trainer.total_steps)
    result = trainer.train()

    # ---- final evaluation + artifacts (reference scripts/train.py:329-374) --
    val_results = trainer.evaluate()
    save_json(val_results, os.path.join(output_dir, "val_report.json"))
    logger.info("validation: %s", val_results)
    if test_ds is not None:
        tm = trainer.evaluate(test_ds)
        test_results = {f"test_{k}": v for k, v in tm.items()}
        save_json(test_results, os.path.join(output_dir, "test_metrics.json"))
        logger.info("test: %s", test_results)
        if config.get("dump_test_predictions", False):
            t_logits, t_labels = trainer.predict(test_ds)
            dump_predictions(os.path.join(output_dir, "test_predictions.csv"),
                             1 / (1 + np.exp(-t_logits)), t_labels, class_names)

    logits, labels = trainer.predict(val_ds)
    priors = [float(p) for p in np.asarray(train_ds.labels).mean(axis=0)]
    if loss_cfg.get("use_logit_adjustment", False):
        # calibrate in the adjusted space the serving paths score in
        logits = logit_adjust(logits, priors)
    probs = 1 / (1 + np.exp(-logits))
    cal = eval_cfg.get("calibration", {})
    thresholds = calibrate_thresholds(
        probs, labels,
        t_start=cal.get("grid_start", 0.05),
        t_end=cal.get("grid_end", 0.95),
        steps=cal.get("grid_steps", 19),
    )

    inference_config = {
        "encoder_name": model_cfg.get("encoder_name", ""),
        "encoder_dir": enc_dir,
        "backend": backend,
        "head": head,
        "fusion_dim": model_cfg.get("fusion_dim", 512),
        "max_text_length": max_len,
        "head_hidden_dim": model_cfg.get("head_hidden_dim", 0) or 0,
        "learnable_task_weights": model_cfg.get("learnable_task_weights", False),
        "thresholds": thresholds,
        "class_names": class_names,
        "best_checkpoint_dir": result["best_checkpoint"],
        "use_logit_adjustment": loss_cfg.get("use_logit_adjustment", False),
        "priors": priors,
        "format": "torch",
    }
    save_json(inference_config, os.path.join(output_dir, "inference_config.json"))
    save_json({i: name for i, name in enumerate(class_names)},
              os.path.join(output_dir, "label_map.json"))
    logger.info("training complete; best checkpoint: %s", result["best_checkpoint"])
    logger.info("calibrated thresholds: %s", thresholds)
    return {"result": result, "val": val_results, "thresholds": thresholds}


if __name__ == "__main__":
    main()
