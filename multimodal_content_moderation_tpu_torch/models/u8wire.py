"""uint8 wire-format glue: fold the normalisation into the patch embed and
embed the patch rows (``ops/cuda_image.patch_embed_u8``: the kernel on the
card, its plain version on the CPU, through the autograd Function
``patch_embed_u8_train``). The fold runs inside the autograd graph, so
when gradients are recorded they reach the embedding weight and bias
themselves: the u8 wire trains as well as it evaluates."""

from __future__ import annotations

from typing import Optional, Sequence

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


def embed_for_model(model, backbone, patches_u8: torch.Tensor) -> torch.Tensor:
    """Model-aware u8 embed, for a ``FusionModel`` or a ``MultiTaskModel``:
    the vision config and normalisation stats (model fields, else the
    backend's defaults; "auto", the multi-task SigLIP backbone, and the
    generic ViT take SigLIP's 0.5 / 0.5)."""
    dmean, dstd = default_stats(model.backend)
    return embed_patches_u8(
        backbone,
        patches_u8,
        model.encoder_config.vision,
        model.image_mean or dmean,
        model.image_std or dstd,
    )


def embed_patches_u8(
    backbone,
    patches_u8: torch.Tensor,
    vision_cfg,
    image_mean: Optional[Sequence[float]],
    image_std: Optional[Sequence[float]],
) -> torch.Tensor:
    """[B, N, C*p*p] uint8 patch rows -> embedded tokens [B, N, D] in the
    tower's compute dtype. The fold runs in fp32 from the stored weight."""
    pe = backbone["vision_model"]["patch_embedding"]
    wf, bf = fold_norm_into_embed(
        pe["w"].float(),
        pe["b"].float() if "b" in pe else None,
        image_mean,
        image_std,
        vision_cfg.patch_size,
        vision_cfg.num_channels,
    )
    return patch_embed_u8_train(
        patches_u8, wf.contiguous(), bf.contiguous(), getattr(torch, vision_cfg.compute_dtype)
    )
