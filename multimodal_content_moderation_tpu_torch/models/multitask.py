"""Multi-task classifier over a shared dual encoder (the JAX package's
``models/multitask.py``, after the reference ``MultiTaskClassifier``).

Same math: the pooled tower features (not L2-normalised and not masked by
presence, unlike the fusion head) are projected, fused by the tanh gates
and the sigmoid gate that sees both projections and the presence flags,
with the three-way fallback when a modality is absent; a shared
Dropout(0.2) -> Linear -> exact GELU -> Dropout(0.2) trunk; one binary head
per task, a bare Linear or Linear -> GELU -> Dropout(0.1) -> Linear; and
the mean over tasks of each task's BCE with its ``pos_weight``, weighted by
the learned uncertainties ``exp(-s) L + s / 2`` when the head has
``log_vars``.

Backends:
- "clip": bare CLIP towers (no projections, no ``logit_scale``); the text
  feature is the hidden state at the first EOS, the image feature the
  post-LN class token;
- "auto" (and "siglip"): one shared SigLIP backbone; the text feature is the
  last-position pooler through the text head, the image feature the MAP
  head's output;
- "generic": the BERT-family text tower and the ViT, raw (no projections,
  no ``logit_scale``), each pooled by the reference's fallback (its tanh
  pooler, else the plain mean), the text tower with HF's dropout from a
  generator forked off the head's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models import clip as clip_mod
from multimodal_content_moderation_tpu_torch.models import generic as generic_mod
from multimodal_content_moderation_tpu_torch.models import siglip as siglip_mod
from multimodal_content_moderation_tpu_torch.models.fusion import (
    DualEncoderModel,
    _check_backend,
    _head_dense_init,
    encoder_configs,
    encoder_generator,
)
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
from multimodal_content_moderation_tpu_torch.ops.layers import dense, dropout, gelu_exact
from multimodal_content_moderation_tpu_torch.ops.losses import bce_with_logits
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device

# the CLIP and generic entries a multi-task model does not hold: its towers
# are bare
CLIP_TOP_LEVEL = ("text_projection", "visual_projection", "logit_scale")


def mtl_head_init(
    g: torch.Generator,
    text_dim: int,
    image_dim: int,
    num_tasks: int,
    fusion_dim: int = 512,
    head_hidden_dim: int = 0,
    learnable_task_weights: bool = False,
    dtype=torch.float32,
) -> dict:
    """Multi-task head parameter tree (names as in the JAX package)."""
    params = {
        "proj_t": _head_dense_init(g, text_dim, fusion_dim, dtype),
        "proj_i": _head_dense_init(g, image_dim, fusion_dim, dtype),
        "g_t": _head_dense_init(g, fusion_dim, fusion_dim, dtype),
        "g_i": _head_dense_init(g, fusion_dim, fusion_dim, dtype),
        "gate": _head_dense_init(g, fusion_dim * 2 + 2, fusion_dim, dtype),
        "shared_fc": _head_dense_init(g, fusion_dim, fusion_dim, dtype),
    }
    if head_hidden_dim and head_hidden_dim > 0:
        params["heads"] = [
            {
                "fc1": _head_dense_init(g, fusion_dim, head_hidden_dim, dtype),
                "fc2": _head_dense_init(g, head_hidden_dim, 1, dtype),
            }
            for _ in range(num_tasks)
        ]
    else:
        params["heads"] = [
            {"fc": _head_dense_init(g, fusion_dim, 1, dtype)} for _ in range(num_tasks)
        ]
    if learnable_task_weights:
        params["log_vars"] = torch.zeros((num_tasks,), dtype=dtype, device=g.device)
    return params


def mtl_head_apply(
    params,
    tfeat: torch.Tensor,
    vfeat: torch.Tensor,
    text_present: torch.Tensor,
    image_present: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Multi-task head forward -> logits [B, num_tasks]. A ``generator``
    turns on the dropout, drawn in the JAX package's site order: the trunk's
    two, then each hidden task head's in task order."""
    tp = dense(tfeat, params["proj_t"])
    vp = dense(vfeat, params["proj_i"])

    presence = torch.stack([text_present, image_present], dim=1).to(tp.dtype)
    zt = torch.tanh(dense(tp, params["g_t"]))
    zi = torch.tanh(dense(vp, params["g_i"]))
    g = torch.sigmoid(dense(torch.cat([tp, vp, presence], dim=1), params["gate"]))

    fused = torch.where(
        (image_present < 0.5)[:, None],
        zt,
        torch.where((text_present < 0.5)[:, None], zi, g * zt + (1.0 - g) * zi),
    )

    y = dropout(fused, 0.2, generator)
    y = gelu_exact(dense(y, params["shared_fc"]))
    shared = dropout(y, 0.2, generator)

    logits = []
    for head in params["heads"]:
        if "fc" in head:
            logit = dense(shared, head["fc"])
        else:
            h = gelu_exact(dense(shared, head["fc1"]))
            h = dropout(h, 0.1, generator)
            logit = dense(h, head["fc2"])
        logits.append(logit[:, 0])
    return torch.stack(logits, dim=1)


def mtl_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    pos_weight: Optional[torch.Tensor] = None,
    log_vars: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean over tasks of each task's BCE (with that task's ``pos_weight``),
    each ``exp(-s) L + s / 2`` when the head learns ``log_vars`` s."""
    per_task = []
    for j in range(logits.shape[1]):
        pw = None if pos_weight is None else pos_weight[j]
        lj = bce_with_logits(logits[:, j], labels[:, j], pos_weight=pw)
        if log_vars is not None:
            lj = torch.exp(-log_vars[j]) * lj + 0.5 * log_vars[j]
        per_task.append(lj)
    return torch.mean(torch.stack(per_task))


def _mtl_backend(backend: str) -> str:
    """A backend the multi-task head has a backbone for: every fusion
    backend but "deepseek_v2", which this head does not take."""
    backend = _check_backend(backend)
    if backend == "deepseek_v2":
        raise NotImplementedError("the multi-task head has no deepseek_v2 backbone: use the "
                                  "fusion head (head: fusion)")
    return backend


class MultiTaskModel(DualEncoderModel):
    """Backbone + multi-task head, with ``FusionModel``'s surface:
    ``forward(batch) -> {"logits"}`` (and ``"loss"`` when the batch holds
    ``labels``), ``encode``, ``replace``, ``encoder_config``, ``device``.

    Parameters live in ``backbone`` and ``head`` (``ParamTree``s), so the
    ``state_dict`` keys are the JAX pytree paths
    (``head.heads.0.fc1.w``, ``head.log_vars``)."""

    def __init__(
        self,
        params: Dict,
        backend: str = "clip",
        clip_config: Optional[clip_mod.CLIPConfig] = None,
        siglip_config: Optional[siglip_mod.SigLIPConfig] = None,
        num_tasks: int = 5,
        fusion_dim: int = 512,
        head_hidden_dim: int = 0,
        learnable_task_weights: bool = False,
        image_mean: Optional[tuple] = None,
        image_std: Optional[tuple] = None,
        generic_config: Optional[generic_mod.GenericDualConfig] = None,
        deepseek_config=None,
    ):
        super().__init__()
        self._set_encoder_config(_mtl_backend(backend), clip_config, siglip_config,
                                 generic_config, deepseek_config)
        self.num_tasks = num_tasks
        self.fusion_dim = fusion_dim
        self.head_hidden_dim = head_hidden_dim or 0
        self.learnable_task_weights = learnable_task_weights
        self.image_mean = image_mean
        self.image_std = image_std
        self.backbone = ParamTree(params["backbone"])
        self.head = ParamTree(params["head"])

    @staticmethod
    def create(
        backend: str = "clip",
        num_tasks: int = 5,
        fusion_dim: int = 512,
        head_hidden_dim: int = 0,
        learnable_task_weights: bool = False,
        clip_config: Optional[clip_mod.CLIPConfig] = None,
        siglip_config: Optional[siglip_mod.SigLIPConfig] = None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
        generic_config: Optional[generic_mod.GenericDualConfig] = None,
    ) -> "MultiTaskModel":
        """A randomly initialised model on ``device`` (a seeded generator)."""
        backend = _mtl_backend(backend)
        cfgs = encoder_configs(backend, clip_config, siglip_config, generic_config)
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        if backend == "clip":
            cfg = cfgs["clip_config"]
            backbone = clip_mod.clip_init(g, cfg, dtype)
            for name in CLIP_TOP_LEVEL:
                backbone.pop(name, None)
            dims = (cfg.text.hidden_size, cfg.vision.hidden_size)
        elif backend == "generic":
            # the raw towers: no projections, no logit_scale
            cfg = cfgs["generic_config"]
            backbone = generic_mod.generic_init(
                g, dataclasses.replace(cfg, projection_dim=0), dtype)
            dims = (cfg.text.hidden_size, cfg.vision.hidden_size)
        else:
            cfg = cfgs["siglip_config"]
            backbone = siglip_mod.siglip_init(g, cfg, dtype)
            dims = (cfg.text.projection_size, cfg.vision.hidden_size)
        head = mtl_head_init(
            g, *dims, num_tasks, fusion_dim, head_hidden_dim, learnable_task_weights, dtype
        )
        return MultiTaskModel(
            {"backbone": backbone, "head": head}, backend, num_tasks=num_tasks,
            fusion_dim=fusion_dim, head_hidden_dim=head_hidden_dim,
            learnable_task_weights=learnable_task_weights, **cfgs,
        )

    def encode(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None):
        """(text features, image features), pooled from the bare towers: the
        image from ``patches_u8`` (the uint8 wire) where the batch carries
        them, else from ``pixel_values`` (normalised fp32 [B, C, H, W]).
        ``generator`` turns on the generic text tower's dropout."""
        from multimodal_content_moderation_tpu_torch.models.u8wire import embed_for_model

        bp = self.backbone
        u8 = batch.get("patches_u8")
        if self.backend == "generic":
            cfg = self.generic_config
            t = generic_mod.generic_text_pooled(
                bp, batch["input_ids"], batch.get("attention_mask"), cfg.text, generator
            )
            if u8 is not None:
                v = generic_mod.generic_vision_pooled_from_tokens(
                    bp, embed_for_model(self, bp, u8), cfg.vision
                )
            else:
                v = generic_mod.generic_vision_pooled(bp, batch["pixel_values"], cfg.vision)
            return t, v
        if self.backend == "clip":
            cfg = self.clip_config
            t = clip_mod.clip_text_pooled(
                bp, batch["input_ids"], batch.get("attention_mask"), cfg.text
            )
            if u8 is not None:
                v = clip_mod.clip_vision_pooled_from_tokens(
                    bp, embed_for_model(self, bp, u8), cfg.vision
                )
            else:
                v = clip_mod.clip_vision_pooled(bp, batch["pixel_values"], cfg.vision)
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
    ) -> Dict[str, torch.Tensor]:
        """``generator`` turns on the head's dropout (training), and the
        generic text tower's from a generator forked off it; the loss is
        computed when the batch carries ``labels``."""
        tfeat, vfeat = self.encode(batch, encoder_generator(self.backend, generator))
        logits = mtl_head_apply(
            self.head, tfeat, vfeat, batch["text_present"], batch["image_present"], generator
        )
        out = {"logits": logits}
        labels = batch.get("labels")
        if labels is not None:
            log_vars = self.head["log_vars"] if "log_vars" in self.head else None
            out["loss"] = mtl_loss(logits, labels, pos_weight=pos_weight, log_vars=log_vars)
        return out
