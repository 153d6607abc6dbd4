"""Gated late-fusion multi-label classifier over the CLIP, SigLIP, generic
(BERT-family + ViT) or DeepSeek-V2 (a sparse decoder beside SigLIP's vision
tower) dual encoder.

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

from multimodal_content_moderation_tpu_torch.models import clip as clip_mod
from multimodal_content_moderation_tpu_torch.models import deepseek_v2 as ds_mod
from multimodal_content_moderation_tpu_torch.models import generic as generic_mod
from multimodal_content_moderation_tpu_torch.models import siglip as siglip_mod
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
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


BACKENDS = ("clip", "siglip", "auto", "generic", "deepseek_v2")
# each backend's config field; "siglip" and "auto" share SigLIP's
CONFIG_FIELDS = {"clip": "clip_config", "siglip": "siglip_config", "auto": "siglip_config",
                 "generic": "generic_config", "deepseek_v2": "deepseek_config"}


def _check_backend(backend: str) -> str:
    backend = backend.lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {', '.join(BACKENDS)}")
    return backend


def config_field(backend: str) -> str:
    """The model field that holds a backend's encoder config."""
    return CONFIG_FIELDS[_check_backend(backend)]


def encoder_configs(backend, clip_config=None, siglip_config=None, generic_config=None,
                    deepseek_config=None):
    """The four config fields of a model: the backend's (its canonical
    architecture where none is given), the others None."""
    cfgs = dict.fromkeys(("clip_config", "siglip_config", "generic_config", "deepseek_config"))
    field = config_field(backend)
    given = {"clip_config": clip_config, "siglip_config": siglip_config,
             "generic_config": generic_config, "deepseek_config": deepseek_config}[field]
    canonical = {"clip_config": clip_mod.CLIPConfig.base_patch32,
                 "siglip_config": siglip_mod.SigLIPConfig.base_patch16_224,
                 "generic_config": generic_mod.GenericDualConfig,
                 "deepseek_config": ds_mod.DeepSeekV2Config.lite_siglip2_224}[field]
    cfgs[field] = given or canonical()
    return cfgs


def encoder_generator(backend: str, generator: Optional[torch.Generator]):
    """The encoder's dropout generator: forked off the head's for the
    generic towers (the only ones with dropout), else None."""
    if generator is None or backend != "generic":
        return None
    return fork_generator(generator)


class DualEncoderModel(nn.Module):
    """What the fusion and the multi-task model share: a CLIP, SigLIP or
    generic backbone (``clip_config`` / ``siglip_config`` /
    ``generic_config``), a head whose ``proj_t`` holds the device, and
    config fields that ``replace`` swaps."""

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
    def encoder_config(self):
        """The backbone's config: a ``CLIPConfig``, a ``SigLIPConfig``, a
        ``GenericDualConfig`` or a ``DeepSeekV2Config``."""
        return getattr(self, config_field(self.backend))

    @property
    def image_size(self) -> int:
        return self.encoder_config.vision.image_size

    @property
    def text_max_positions(self) -> int:
        return self.encoder_config.text.max_positions

    @property
    def device(self) -> torch.device:
        return self.head["proj_t"]["w"].device

    def _set_encoder_config(self, backend, clip_config, siglip_config, generic_config,
                            deepseek_config=None):
        self.backend = backend
        for name, cfg in encoder_configs(backend, clip_config, siglip_config,
                                         generic_config, deepseek_config).items():
            setattr(self, name, cfg)


def fusion_feature_dim(backend, clip_config=None, siglip_config=None, generic_config=None,
                       deepseek_config=None):
    """The width of the features the fusion head takes."""
    if backend == "clip":
        return clip_config.projection_dim
    if backend == "deepseek_v2":
        # text_projection's width, which SigLIP's MAP feature has too
        return deepseek_config.projection_dim
    if backend == "generic":
        # the reference's probe: projection_dim, else the text width, else
        # the vision width
        g = generic_config
        return g.projection_dim or g.text.hidden_size or g.vision.hidden_size
    # SigLIP: the text head's projection_size == the vision hidden size
    return siglip_config.text.projection_size


class FusionModel(DualEncoderModel):
    """Backbone + fusion head. ``forward(batch) -> {"logits"}`` (and
    ``"loss"`` when the batch holds ``labels``) where batch holds input_ids,
    attention_mask, the image as patches_u8 ([B, N, C*p*p] uint8, the u8
    wire) or pixel_values (normalised fp32 [B, C, H, W]), text_present and
    image_present (and, for SigLIP, optionally the text ``position_ids`` of
    a bucket's carry column).

    ``backend`` is "clip", "siglip" ("auto" is SigLIP, as in the JAX
    package, for a checkpoint whose inference config kept it), "generic"
    (``generic_config``: a BERT-family text tower and a ViT) or
    "deepseek_v2" (``deepseek_config``: ``models/deepseek_v2.py``'s sparse
    decoder beside a SigLIP vision tower; the port's own, no JAX
    counterpart).

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
        generic_config: Optional[generic_mod.GenericDualConfig] = None,
        deepseek_config: Optional[ds_mod.DeepSeekV2Config] = None,
    ):
        super().__init__()
        self._set_encoder_config(_check_backend(backend), clip_config, siglip_config,
                                 generic_config, deepseek_config)
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
        generic_config: Optional[generic_mod.GenericDualConfig] = None,
        deepseek_config: Optional[ds_mod.DeepSeekV2Config] = None,
    ) -> "FusionModel":
        """A randomly initialised model on ``device`` (a seeded generator)."""
        backend = _check_backend(backend)
        cfgs = encoder_configs(backend, clip_config, siglip_config, generic_config,
                               deepseek_config)
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        if backend == "clip":
            backbone = clip_mod.clip_init(g, cfgs["clip_config"], dtype)
        elif backend == "generic":
            backbone = generic_mod.generic_init(g, cfgs["generic_config"], dtype)
        elif backend == "deepseek_v2":
            backbone = ds_mod.deepseek_v2_init(g, cfgs["deepseek_config"], dtype)
        else:
            backbone = siglip_mod.siglip_init(g, cfgs["siglip_config"], dtype)
        head = fusion_head_init(g, fusion_feature_dim(backend, **cfgs), num_labels, fusion_dim,
                                dtype)
        return FusionModel(
            {"backbone": backbone, "head": head}, backend, num_labels=num_labels,
            fusion_dim=fusion_dim, loss_type=loss_type, focal_gamma=focal_gamma, **cfgs,
        )

    @property
    def feature_dim(self) -> int:
        return fusion_feature_dim(self.backend, self.clip_config, self.siglip_config,
                                  self.generic_config, self.deepseek_config)

    def encode(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None):
        """(text features, image features): the image from ``patches_u8``
        (the uint8 wire) where the batch carries them, else from
        ``pixel_values`` (normalised fp32 [B, C, H, W], the pixel path).
        ``generator`` turns on the generic text tower's dropout. The
        DeepSeek-V2 tower reads the batch's ``text_kept`` (the mask's sum,
        from the host) and fills its ``counters`` dict where it has one."""
        from multimodal_content_moderation_tpu_torch.models.u8wire import embed_for_model

        bp = self.backbone
        u8 = batch.get("patches_u8")
        if self.backend == "deepseek_v2":
            cfg = self.deepseek_config
            t = ds_mod.deepseek_text_features(
                bp, batch["input_ids"], batch.get("attention_mask"), cfg,
                kept=batch.get("text_kept"), counters=batch.get("counters"),
            )
            if u8 is not None:  # SigLIP's vision tower reads cfg.vision alone
                v = siglip_mod.siglip_image_features_from_tokens(
                    bp, embed_for_model(self, bp, u8), cfg
                )
            else:
                v = siglip_mod.siglip_image_features(bp, batch["pixel_values"], cfg)
            return t, v
        if self.backend == "generic":
            cfg = self.generic_config
            t = generic_mod.generic_text_features(
                bp, batch["input_ids"], batch.get("attention_mask"), cfg, generator
            )
            if u8 is not None:
                v = generic_mod.generic_image_features_from_tokens(
                    bp, embed_for_model(self, bp, u8), cfg
                )
            else:
                v = generic_mod.generic_image_features(bp, batch["pixel_values"], cfg)
            return t, v
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
