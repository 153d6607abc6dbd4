"""Gated late-fusion multi-label classifier over a dual encoder of any
family of ``models/backbones.py``: CLIP, SigLIP, generic (BERT-family +
ViT) or DeepSeek-V2 (a sparse decoder beside SigLIP's vision tower).

Same math as the JAX package's ``models/fusion.py`` (the reference
``MultiModalFusionClassifier``): L2-normalised encoder features masked by
presence flags, projected, tanh-gated fusion with a sigmoid gate that sees
both projections and the flags, a three-way fallback when a modality is
absent, and ``[fused, t, v, |t-v|, t*v] -> LN -> Linear -> GELU -> Dropout(0.2) ->
Linear``, and the in-model BCE (``pos_weight``) or focal loss when the
batch carries labels. The generic towers train with HF's dropout, drawn
from a generator forked off the head's (``ops.layers.fork_generator``, as
the JAX package splits its key).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
from multimodal_content_moderation_tpu_torch.models.u8wire import image_tokens
from multimodal_content_moderation_tpu_torch.ops.layers import (
    dense,
    dropout,
    fork_generator,
    gelu_exact,
    layer_norm,
)
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


def config_field(backend: str) -> str:
    """The model field that holds a backend's encoder config:
    ``"encoder_config"`` for every backend (another name raises). Kept for
    ``benchmark/harness/port.py``, which splats ``{config_field(backend):
    cfg}`` into the model and its ``_cfg`` form into the loader."""
    backbone(backend)
    return "encoder_config"


def encoder_generator(backend: str, generator: Optional[torch.Generator]):
    """The encoder's dropout generator: forked off the head's where the
    family's towers have dropout (``Backbone.dropout_fork``), else None."""
    if generator is None or not backbone(backend).dropout_fork:
        return None
    return fork_generator(generator)


class DualEncoderModel(nn.Module):
    """What the fusion and the multi-task model share: a backbone whose
    family ``backend`` names (``models/backbones.py``) with its
    ``encoder_config``, a head whose ``proj_t`` holds the device, config
    fields that ``replace`` swaps, and ``encode`` over the ``towers`` the
    head reads."""

    # the u8 wire's folded patch embedding (``models/u8wire.fold_for_model``),
    # stored by a ``FastInferenceEngine`` on its own copy; None: folded on
    # every forward, as training needs
    patch_fold = None

    def replace(self, **fields):
        """A copy with other config fields that shares these parameters."""
        new = copy.copy(self)
        for k, v in fields.items():
            if not hasattr(self, k) or isinstance(getattr(self, k), nn.Module):
                raise ValueError(f"{type(self).__name__} has no config field {k!r}")
            object.__setattr__(new, k, v)
        return new

    @property
    def image_size(self) -> int:
        return self.encoder_config.vision.image_size

    @property
    def text_max_positions(self) -> int:
        return self.encoder_config.text.max_positions

    @property
    def device(self) -> torch.device:
        return self.head["proj_t"]["w"].device

    def encode(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None):
        """(text features, image features) of the head's ``towers``: the
        image from ``patches_u8`` (the uint8 wire) where the batch carries
        them, else from ``pixel_values`` (normalised fp32 [B, C, H, W], the
        pixel path). ``generator`` turns on the generic text tower's dropout.
        The DeepSeek-V2 tower reads the batch's ``text_kept`` (the mask's
        sum, from the host) and fills its ``counters`` dict where it has
        one."""
        towers, bp, cfg = self.towers, self.backbone, self.encoder_config
        t = towers.text(bp, batch, cfg, generator)
        return t, towers.image(bp, image_tokens(self, bp, batch), cfg)


class FusionModel(DualEncoderModel):
    """Backbone + fusion head. ``forward(batch) -> {"logits"}`` (and
    ``"loss"`` when the batch holds ``labels``) where batch holds input_ids,
    attention_mask, the image as patches_u8 ([B, N, C*p*p] uint8, the u8
    wire) or pixel_values (normalised fp32 [B, C, H, W]), text_present and
    image_present (and, for SigLIP, optionally the text ``position_ids`` of
    a bucket's carry column).

    ``backend`` names the family (``models/backbones.py``): "clip", "siglip"
    ("auto" is SigLIP, as in the JAX package, for a checkpoint whose
    inference config kept it), "generic" (a BERT-family text tower and a
    ViT) or "deepseek_v2" (``models/deepseek_v2.py``'s sparse decoder beside
    a SigLIP vision tower; the port's own, no JAX counterpart);
    ``encoder_config`` is its config, the canonical architecture where
    none is given.

    Parameters live in ``backbone`` and ``head`` (``ParamTree``s), so the
    ``state_dict`` keys are the JAX pytree paths
    (``backbone.text_model.layers.0.attn.q.w``)."""

    def __init__(
        self,
        params: Dict,
        backend: str = "clip",
        encoder_config=None,
        num_labels: int = 5,
        fusion_dim: int = 512,
        image_mean: Optional[tuple] = None,
        image_std: Optional[tuple] = None,
        loss_type: str = "bce",
        focal_gamma: float = 1.5,
    ):
        super().__init__()
        family = backbone(backend)
        self.backend = backend.lower()
        self.encoder_config = encoder_config or family.default()
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
        encoder_config=None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
        loss_type: str = "bce",
        focal_gamma: float = 1.5,
    ) -> "FusionModel":
        """A randomly initialised model on ``device`` (a seeded generator)."""
        family = backbone(backend)
        cfg = encoder_config or family.default()
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        params = {"backbone": family.init(g, cfg, dtype)}
        params["head"] = fusion_head_init(g, family.feature_dim(cfg), num_labels, fusion_dim,
                                          dtype)
        return FusionModel(params, backend, cfg, num_labels=num_labels, fusion_dim=fusion_dim,
                           loss_type=loss_type, focal_gamma=focal_gamma)

    @property
    def towers(self):
        return backbone(self.backend)

    @property
    def feature_dim(self) -> int:
        return backbone(self.backend).feature_dim(self.encoder_config)

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        pos_weight: Optional[torch.Tensor] = None,
        alpha_focal: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``generator`` turns on the head's dropout (training), and the
        generic towers' from a generator forked off it; the loss is computed
        when the batch carries ``labels``."""
        tfeat, vfeat = self.encode(batch, encoder_generator(self.backend, generator))
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
