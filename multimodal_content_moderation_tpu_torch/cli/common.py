"""Shared CLI plumbing: encoder-asset resolution, image statistics and
preprocessor setup."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.utils.config import infer_size, load_json


def resolve_encoder_dir(model_cfg: Dict[str, Any]) -> Optional[str]:
    """The local encoder-asset directory: ``encoder_dir`` first, else
    ``encoder_name`` when it is a path."""
    d = model_cfg.get("encoder_dir")
    if d and os.path.isdir(d):
        return d
    name = model_cfg.get("encoder_name", "")
    if name and os.path.isdir(name):
        return name
    return None


def image_stats_from_dir(
    encoder_dir: Optional[str], backend: str
) -> Tuple[Tuple[int, int], tuple, tuple]:
    """((H, W), mean, std) from preprocessor_config.json, with the family's
    defaults (``Backbone.image_stats``)."""
    size = (224, 224)
    mean, std = backbone(backend).image_stats
    if encoder_dir:
        p = os.path.join(encoder_dir, "preprocessor_config.json")
        if os.path.exists(p):
            d = load_json(p)
            size = infer_size(d)
            if "crop_size" in d:
                size = infer_size({"size": d["crop_size"]})
            mean = tuple(d.get("image_mean", mean))
            std = tuple(d.get("image_std", std))
    return size, mean, std


def build_preprocessors(
    model_cfg: Dict[str, Any],
    aug_cfg: Dict[str, Any],
    image_backend: str = "pil",
    seed: int = 0,
    output: str = "uint8_hwc",
) -> Tuple[ImagePreprocessor, ImagePreprocessor]:
    """(train, eval) preprocessors from the config sections, both producing
    ``output``: uint8 HWC crops for the u8 wire (evaluated by the fast
    engine), normalised float32 CHW arrays ("float_nchw") for the f32 wire
    (evaluated by the standard engine); the train one augments when
    ``augmentation.enabled``."""
    enc_dir = resolve_encoder_dir(model_cfg)
    (H, W), mean, std = image_stats_from_dir(enc_dir, model_cfg.get("backend", "clip"))
    train_pp = ImagePreprocessor(
        H, W, mean, std,
        is_train=True,
        augment=aug_cfg.get("enabled", False),
        aug_scale=(aug_cfg.get("aug_scale_min", 0.8), aug_cfg.get("aug_scale_max", 1.0)),
        output=output,
        seed=seed,
        backend=image_backend,
    )
    eval_pp = ImagePreprocessor(H, W, mean, std, output=output, backend=image_backend)
    return train_pp, eval_pp


def build_tokenizer(model_cfg: Dict[str, Any]):
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

    enc_dir = resolve_encoder_dir(model_cfg)
    if enc_dir is None:
        raise FileNotFoundError(
            "No local encoder assets. Set model.encoder_dir (or encoder_name as a "
            "path) to a directory with tokenizer + config files; nothing is downloaded."
        )
    return load_tokenizer(enc_dir)
