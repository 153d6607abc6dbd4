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

Backends (each family's ``Backbone.multitask`` in ``models/backbones.py``):
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
DeepSeek-V2 has no multi-task backbone and is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.backbones import backbone, multitask
from multimodal_content_moderation_tpu_torch.models.fusion import (
    DualEncoderModel,
    _head_dense_init,
    encoder_generator,
)
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
from multimodal_content_moderation_tpu_torch.ops.layers import dense, dropout, gelu_exact
from multimodal_content_moderation_tpu_torch.ops.losses import bce_with_logits
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device


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
        encoder_config=None,
        num_tasks: int = 5,
        fusion_dim: int = 512,
        head_hidden_dim: int = 0,
        learnable_task_weights: bool = False,
        image_mean: Optional[tuple] = None,
        image_std: Optional[tuple] = None,
    ):
        super().__init__()
        multitask(backend)
        self.backend = backend.lower()
        self.encoder_config = encoder_config or backbone(backend).default()
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
        encoder_config=None,
        seed: int = 0,
        device="cuda",
        dtype=torch.float32,
    ) -> "MultiTaskModel":
        """A randomly initialised model on ``device`` (a seeded generator)."""
        towers = multitask(backend)
        cfg = encoder_config or backbone(backend).default()
        g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        params = {"backbone": towers.init(g, cfg, dtype)}
        params["head"] = mtl_head_init(g, *towers.widths(cfg), num_tasks, fusion_dim,
                                       head_hidden_dim, learnable_task_weights, dtype)
        return MultiTaskModel(
            params, backend, cfg, num_tasks=num_tasks, fusion_dim=fusion_dim,
            head_hidden_dim=head_hidden_dim, learnable_task_weights=learnable_task_weights,
        )

    @property
    def towers(self):
        """The bare towers the head pools (``Backbone.multitask``)."""
        return multitask(self.backend)

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
