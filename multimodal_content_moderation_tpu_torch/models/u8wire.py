"""uint8 wire-format glue: fold the normalisation into the patch embed and
embed the patch rows (``ops/cuda_image.patch_embed_u8``: the kernel on the
card, its plain version on the CPU, through the autograd Function
``patch_embed_u8_train``). The fold runs inside the autograd graph, so
when gradients are recorded they reach the embedding weight and bias
themselves: the u8 wire trains as well as it evaluates."""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimodal_content_moderation_tpu_torch.data.images import (
    CLIP_MEAN,
    CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
)
from multimodal_content_moderation_tpu_torch.ops.cuda_image import (
    fold_norm_into_embed,
    patch_embed_u8_train,
)


def default_stats(backend: str):
    """The backend's normalisation stats: CLIP's, else SigLIP's 0.5 / 0.5."""
    return (CLIP_MEAN, CLIP_STD) if backend == "clip" else (SIGLIP_MEAN, SIGLIP_STD)


class PatchFold(NamedTuple):
    """A folded patch embedding and the ``stamp`` of what it was folded from."""

    w: torch.Tensor
    b: torch.Tensor
    stamp: tuple


def _stamp(model, pe) -> tuple:
    """What a fold depends on: the stats and, for each leaf of the patch
    embedding, its address and version counter (which every in-place write
    bumps; an inference tensor keeps none and gives None)."""
    leaves = (pe[k] for k in ("w", "b") if k in pe)
    return (model.image_mean, model.image_std,
            *(None if t.is_inference() else (t.data_ptr(), t._version) for t in leaves))


def fold_for_model(model, backbone) -> PatchFold:
    """The model's normalisation folded into its patch embedding: fp32
    (w_folded, b_folded) from the stored weight and bias (``fold_norm_into_embed``),
    with the model's stats (model fields, else the backend's defaults;
    "auto", the multi-task SigLIP backbone, and the generic ViT take
    SigLIP's 0.5 / 0.5)."""
    dmean, dstd = default_stats(model.backend)
    vision = model.encoder_config.vision
    pe = backbone["vision_model"]["patch_embedding"]
    wf, bf = fold_norm_into_embed(
        pe["w"].float(),
        pe["b"].float() if "b" in pe else None,
        model.image_mean or dmean,
        model.image_std or dstd,
        vision.patch_size,
        vision.num_channels,
    )
    return PatchFold(wf.contiguous(), bf.contiguous(), _stamp(model, pe))


def embed_for_model(model, backbone, patches_u8: torch.Tensor) -> torch.Tensor:
    """Model-aware u8 embed, for a ``FusionModel`` or a ``MultiTaskModel``:
    [B, N, C*p*p] uint8 patch rows -> embedded tokens [B, N, D] in the
    tower's compute dtype. The fold is the model's ``patch_fold`` where an
    engine stored one (``FastInferenceEngine``) and nothing it was folded
    from has changed since, else ``fold_for_model`` on this call, inside the
    autograd graph (training: the weights change every step)."""
    fold = model.patch_fold
    if fold is None or fold.stamp != _stamp(model, backbone["vision_model"]["patch_embedding"]):
        fold = fold_for_model(model, backbone)
    return patch_embed_u8_train(
        patches_u8, fold.w, fold.b, getattr(torch, model.encoder_config.vision.compute_dtype)
    )
