"""The port's models -> reference-format state dicts (the JAX package's
``models/export.py``; the inverse of ``models/convert.py``).

A model fine-tuned here leaves as a ``model.safetensors`` with the exact key
layout of the PyTorch reference, which the reference, the JAX package and
the port all load:

- fusion: the encoder under ``backbone.*`` in HF names (``CLIPModel``,
  ``SiglipModel`` with the MAP head's ``in_proj`` re-assembled, or
  ``VisionTextDualEncoderModel`` over a BERT, RoBERTa or DistilBERT text
  tower and a ViT) + the ``MultiModalFusionClassifier`` head keys;
- multi-task: CLIP's bare towers under ``tower_txt.text_model.*`` /
  ``tower_img.vision_model.*``, a shared SigLIP or generic backbone under
  ``backbone.*``, + the ``MultiTaskClassifier`` head (``shared_head.1``,
  ``heads.{j}`` or ``heads.{j}.0`` / ``heads.{j}.3``, ``log_vars``).

``logit_scale`` / ``logit_bias`` are shape (1,) for SigLIP (HF
``SiglipModel``'s parameters) and scalars for CLIP and the
``VisionTextDualEncoderModel``.

One departure from the JAX package: the reference's generic multi-task
model holds a whole ``VisionTextDualEncoderModel``, projections and
``logit_scale`` included, while the multi-task forward pools the raw towers
and never reads them. JAX's export drops the three leaves, so the
reference's strict load of its bundle fails. Here a generic multi-task
export also writes ``backbone.text_projection.weight`` and
``backbone.visual_projection.weight`` ([projection_dim, hidden], zeros) and
``backbone.logit_scale`` (the encoder config's ``logit_scale_init_value``,
else HF's 2.6592; ``models/generic.generic_bare_to_torch``): no logit
changes, and the strict load passes.

Each family's module writes its encoder (``Backbone.to_torch`` in
``models/backbones.py``); the heads are written here. Every tensor comes out
as an owned fp32 CPU tensor (the format JAX's export writes), through
``convert.write_safetensors`` without the ``safetensors`` package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.backbones import backbone, multitask
from multimodal_content_moderation_tpu_torch.models.convert import write_safetensors
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel
from multimodal_content_moderation_tpu_torch.models.params import _f32, _linear_out, _ln_out

StateDict = Dict[str, torch.Tensor]


def _fusion_head_out(sd: StateDict, h) -> None:
    for name in ("proj_t", "proj_i", "g_t", "g_i", "gate"):
        _linear_out(sd, name, h[name])
    _ln_out(sd, "ln_fused", h["ln_fused"])
    _ln_out(sd, "cls.0", h["cls_ln"])
    _linear_out(sd, "cls.1", h["cls_fc1"])
    _linear_out(sd, "cls.4", h["cls_fc2"])


def _mtl_head_out(sd: StateDict, h) -> None:
    for name in ("proj_t", "proj_i", "g_t", "g_i", "gate"):
        _linear_out(sd, name, h[name])
    _linear_out(sd, "shared_head.1", h["shared_fc"])
    for j, head in enumerate(h["heads"]):
        if "fc" in head:
            _linear_out(sd, f"heads.{j}", head["fc"])
        else:
            _linear_out(sd, f"heads.{j}.0", head["fc1"])
            _linear_out(sd, f"heads.{j}.3", head["fc2"])
    if "log_vars" in h:
        sd["log_vars"] = _f32(h["log_vars"])


def encoder_state_dict(model) -> StateDict:
    """A model's backbone alone under its Hugging Face encoder's own names
    (``CLIPModel``, ``SiglipModel``, ``VisionTextDualEncoderModel``): the
    ``model.safetensors`` of an encoder directory."""
    return backbone(model.backend).to_torch(model.backbone, model.encoder_config, "")


def fusion_model_to_torch(model) -> StateDict:
    """A ``FusionModel`` -> ``backbone.*`` + the fusion head's keys."""
    sd = backbone(model.backend).to_torch(model.backbone, model.encoder_config, "backbone.")
    _fusion_head_out(sd, model.head)
    return sd


def mtl_model_to_torch(model, encoder_config: Optional[Dict[str, Any]] = None) -> StateDict:
    """A ``MultiTaskModel`` -> the reference multi-task layout (its family's
    ``MultiTask.to_torch``). A generic backbone also gets the three leaves
    the multi-task forward never reads (module docstring), from
    ``encoder_config`` (the encoder's ``config.json``) where given."""
    sd = multitask(model.backend).to_torch(model.backbone, model.encoder_config, encoder_config)
    _mtl_head_out(sd, model.head)
    return sd


def reference_state_dict(model, encoder_config: Optional[Dict[str, Any]] = None) -> StateDict:
    """A fusion or multi-task model -> its reference state dict (fp32 CPU
    tensors). An int8 model (``ops/quant.py``) is eval-only and refused:
    export the model it was quantized from."""
    if any(name.endswith(".w_i8") for name, _ in model.named_parameters()):
        raise ValueError("an int8_mlp model is eval-only: export the model it was "
                         "quantized from")
    if isinstance(model, MultiTaskModel):
        return mtl_model_to_torch(model, encoder_config)
    return fusion_model_to_torch(model)


def export_safetensors(model, path: str,
                       encoder_config: Optional[Dict[str, Any]] = None) -> str:
    """Write a reference-format ``model.safetensors`` of a fusion or
    multi-task model (F32, with the standard library)."""
    return write_safetensors(reference_state_dict(model, encoder_config), path)
