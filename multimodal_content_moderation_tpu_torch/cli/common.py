"""Shared CLI plumbing: encoder image statistics."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
from multimodal_content_moderation_tpu_torch.utils.config import infer_size, load_json


def image_stats_from_dir(
    encoder_dir: Optional[str], backend: str
) -> Tuple[Tuple[int, int], tuple, tuple]:
    """((H, W), mean, std) from preprocessor_config.json, with the CLIP
    defaults."""
    if backend != "clip":
        raise NotImplementedError(f"backend {backend!r} is not ported yet")
    size = (224, 224)
    mean, std = CLIP_MEAN, CLIP_STD
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
