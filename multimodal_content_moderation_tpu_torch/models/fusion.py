"""Gated late-fusion multi-label classifier over the CLIP or SigLIP dual
encoder.

Same math as the JAX package's ``models/fusion.py`` (the reference
``MultiModalFusionClassifier``): L2-normalised encoder features masked by
presence flags, projected, tanh-gated fusion with a sigmoid gate that sees
both projections and the flags, a three-way fallback when a modality is
absent, and ``[fused, t, v, |t-v|, t*v] -> LN -> Linear -> GELU -> Dropout(0.2) ->
Linear``, and the in-model BCE (``pos_weight``) or focal loss when the
batch carries labels. The generic (BERT-family + ViT) backend is not ported
yet.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from multimodal_content_moderation_tpu_torch.models import clip as clip_mod
from multimodal_content_moderation_tpu_torch.models import siglip as siglip_mod
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
from multimodal_content_moderation_tpu_torch.ops.layers import dense, dropout, gelu_exact, layer_norm
from multimodal_content_moderation_tpu_torch.ops.losses import bce_with_logits, focal_with_logits
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(x, dim=-1)``: x / max(||x||, eps), in fp32."""
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(norm, min=eps)).to(x.dtype)


def _head_dense_init(g, d_in, d_out, dtype):
    """torch nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    bound = d_in ** -0.5

    def u(shape):
        return (torch.rand(shape, generator=g, dtype=dtype, device=g.device) * 2 - 1) * bound

    return {"w": u((d_in, d_out)), "b": u((d_out,))}


def fusion_head_init(
    g: torch.Generator, feature_dim: int, num_labels: int, fusion_dim: int = 512,
    dtype=torch.float32,
) -> dict:
    """Fusion-head parameter tree (names mirror the reference modules)."""

    def ln(d):
        return {
            "scale": torch.ones((d,), dtype=dtype, device=g.device),
            "bias": torch.zeros((d,), dtype=dtype, device=g.device),
        }

    return {
        "proj_t": _head_dense_init(g, feature_dim, fusion_dim, dtype),
        "proj_i": _head_dense_init(g, feature_dim, fusion_dim, dtype),
        "g_t": _head_dense_init(g, fusion_dim, fusion_dim, dtype),
        "g_i": _head_dense_init(g, fusion_dim, fusion_dim, dtype),
        "gate": _head_dense_init(g, fusion_dim * 2 + 2, fusion_dim, dtype),
        "ln_fused": ln(fusion_dim),
        "cls_ln": ln(fusion_dim * 5),
        "cls_fc1": _head_dense_init(g, fusion_dim * 5, fusion_dim, dtype),
        "cls_fc2": _head_dense_init(g, fusion_dim, num_labels, dtype),
    }


def fusion_head_apply(
    params, tfeat, vfeat, text_present, image_present,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Fusion head forward: encoder features -> logits. A ``generator``
    turns on the classifier's dropout (training)."""
    tfeat = l2_normalize(tfeat) * text_present[:, None].to(tfeat.dtype)
    vfeat = l2_normalize(vfeat) * image_present[:, None].to(vfeat.dtype)

    tp = dense(tfeat, params["proj_t"])
    vp = dense(vfeat, params["proj_i"])

    zt = torch.tanh(dense(tp, params["g_t"]))
    zi = torch.tanh(dense(vp, params["g_i"]))
    presence = torch.stack([text_present, image_present], dim=1).to(tp.dtype)
    g = torch.sigmoid(dense(torch.cat([tp, vp, presence], dim=1), params["gate"]))

    fused = torch.where(
        (image_present < 0.5)[:, None],
        zt,
        torch.where((text_present < 0.5)[:, None], zi, g * zt + (1.0 - g) * zi),
    )
    fused = layer_norm(fused, params["ln_fused"])

    feat = torch.cat([fused, tp, vp, torch.abs(tp - vp), tp * vp], dim=1)
    y = layer_norm(feat, params["cls_ln"])
    y = gelu_exact(dense(y, params["cls_fc1"]))
    y = dropout(y, 0.2, generator)
    return dense(y, params["cls_fc2"])


def _check_backend(backend: str) -> str:
    backend = backend.lower()
    if backend not in ("clip", "siglip", "auto"):
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (the generic backend comes in a "
            "later slice)"
        )
    return backend


class FusionModel(nn.Module):
    """Backbone + fusion head. ``forward(batch) -> {"logits"}`` (and
    ``"loss"`` when the batch holds ``labels``) where batch holds input_ids,
    attention_mask, the image as patches_u8 ([B, N, C*p*p] uint8, the u8
    wire) or pixel_values (normalised fp32 [B, C, H, W]), text_present and
    image_present (and, for SigLIP, optionally the text ``position_ids`` of
    a bucket's carry column).

    ``backend`` is "clip" or "siglip" ("auto" is SigLIP, as in the JAX
    package, for a checkpoint whose inference config kept it).

    Parameters live in ``backbone`` and ``head`` (``ParamTree``s), so the
    ``state_dict`` keys are the JAX pytree paths
    (``backbone.text_model.layers.0.attn.q.w``)."""

    def __init__(
        self,
        params: Dict,
        backend: str = "clip",
        clip_config: Optional[clip_mod.CLIPConfig] = None,
        num_labels: int = 5,
        fusion_dim: int = 512,
        image_mean: Optional[tuple] = None,
        image_std: Optional[tuple] = None,
        loss_type: str = "bce",
        focal_gamma: float = 1.5,
        siglip_config: Optional[siglip_mod.SigLIPConfig] = None,
    ):
        super().__init__()
        backend = _check_backend(backend)
        self.backend = backend
        self.clip_config = self.siglip_config = None
        if backend == "clip":
            self.clip_config = clip_config or clip_mod.CLIPConfig.base_patch32()
        else:
            self.siglip_config = siglip_config or siglip_mod.SigLIPConfig.base_patch16_224()
        self.num_labels = num_labels
        self.fusion_dim = fusion_dim
        self.image_mean = image_mean
        self.image_std = image_std
        self.loss_type = loss_type  # "bce" | "focal"
        self.focal_gamma = focal_gamma
        self.backbone = ParamTree(params["backbone"])
        self.head = ParamTree(params["head"])

    @staticmethod
    def create(
        backend: str = "clip",
        num_labels: int = 5,
        fusion_dim: int = 512,
        clip_config: Optional[clip_mod.CLIPConfig] = None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
        loss_type: str = "bce",
        focal_gamma: float = 1.5,
        siglip_config: Optional[siglip_mod.SigLIPConfig] = None,
    ) -> "FusionModel":
        """A randomly initialised model on ``device`` (a seeded generator)."""
        backend = _check_backend(backend)
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        if backend == "clip":
            clip_config = clip_config or clip_mod.CLIPConfig.base_patch32()
            backbone = clip_mod.clip_init(g, clip_config, dtype)
            feature_dim = clip_config.projection_dim
        else:
            siglip_config = siglip_config or siglip_mod.SigLIPConfig.base_patch16_224()
            backbone = siglip_mod.siglip_init(g, siglip_config, dtype)
            feature_dim = siglip_config.text.projection_size
        params = {
            "backbone": backbone,
            "head": fusion_head_init(g, feature_dim, num_labels, fusion_dim, dtype),
        }
        return FusionModel(
            params, backend, clip_config, num_labels, fusion_dim,
            loss_type=loss_type, focal_gamma=focal_gamma, siglip_config=siglip_config,
        )

    def replace(self, **fields) -> "FusionModel":
        """A copy with other config fields that shares these parameters."""
        new = copy.copy(self)
        for k, v in fields.items():
            if not hasattr(self, k) or isinstance(getattr(self, k), nn.Module):
                raise ValueError(f"FusionModel has no config field {k!r}")
            object.__setattr__(new, k, v)
        return new

    @property
    def encoder_config(self):
        """The backbone's config: a ``CLIPConfig`` or a ``SigLIPConfig``."""
        return self.clip_config if self.backend == "clip" else self.siglip_config

    @property
    def feature_dim(self) -> int:
        if self.backend == "clip":
            return self.clip_config.projection_dim
        # SigLIP: the text head's projection_size == the vision hidden size
        return self.siglip_config.text.projection_size

    @property
    def image_size(self) -> int:
        return self.encoder_config.vision.image_size

    @property
    def text_max_positions(self) -> int:
        return self.encoder_config.text.max_positions

    @property
    def device(self) -> torch.device:
        return self.head["proj_t"]["w"].device

    def encode(self, batch: Dict[str, torch.Tensor]):
        """(text features, image features): the image from ``patches_u8``
        (the uint8 wire) where the batch carries them, else from
        ``pixel_values`` (normalised fp32 [B, C, H, W], the pixel path)."""
        from multimodal_content_moderation_tpu_torch.models.u8wire import embed_for_model

        bp = self.backbone
        u8 = batch.get("patches_u8")
        if self.backend == "clip":
            t = clip_mod.clip_text_features(
                bp, batch["input_ids"], batch.get("attention_mask"), self.clip_config
            )
            if u8 is not None:
                v = clip_mod.clip_image_features_from_tokens(
                    bp, embed_for_model(self, bp, u8), self.clip_config
                )
            else:
                v = clip_mod.clip_image_features(bp, batch["pixel_values"], self.clip_config)
            return t, v
        t = siglip_mod.siglip_text_features(
            bp, batch["input_ids"], batch.get("attention_mask"), self.siglip_config,
            position_ids=batch.get("position_ids"),
        )
        if u8 is not None:
            v = siglip_mod.siglip_image_features_from_tokens(
                bp, embed_for_model(self, bp, u8), self.siglip_config
            )
        else:
            v = siglip_mod.siglip_image_features(bp, batch["pixel_values"], self.siglip_config)
        return t, v

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        pos_weight: Optional[torch.Tensor] = None,
        alpha_focal: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``generator`` turns on the head's dropout (training); the loss
        is computed when the batch carries ``labels``."""
        tfeat, vfeat = self.encode(batch)
        logits = fusion_head_apply(
            self.head, tfeat, vfeat, batch["text_present"], batch["image_present"], generator
        )
        out = {"logits": logits}
        labels = batch.get("labels")
        if labels is not None:
            if self.loss_type == "focal":
                out["loss"] = focal_with_logits(
                    logits, labels, gamma=self.focal_gamma, alpha=alpha_focal
                )
            else:
                out["loss"] = bce_with_logits(logits, labels, pos_weight=pos_weight)
        return out
