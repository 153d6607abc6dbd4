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
else HF's 2.6592): no logit changes, and the strict load passes.

Every tensor comes out as an owned fp32 CPU tensor (the format JAX's
export writes), through ``convert.write_safetensors`` without the
``safetensors`` package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.convert import write_safetensors
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel

# HF VisionTextDualEncoderConfig's defaults
VTDE_PROJECTION_DIM = 512
VTDE_LOGIT_SCALE = 2.6592

StateDict = Dict[str, torch.Tensor]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32, copy=True).contiguous()


def _linear_out(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _f32(p["w"]).t().contiguous()
    if "b" in p:
        sd[f"{name}.bias"] = _f32(p["b"])


def _ln_out(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _f32(p["scale"])
    sd[f"{name}.bias"] = _f32(p["bias"])


def _conv_out(p, vision_cfg) -> torch.Tensor:
    """A patch-embed dense (C*p*p, D) -> the ``Conv2d.weight`` (D, C, p, p)."""
    v = vision_cfg
    w = _f32(p["w"]).t()
    return w.reshape(v.hidden_size, v.num_channels, v.patch_size, v.patch_size).contiguous()


def _encoder_layers_out(sd: StateDict, prefix: str, layers) -> None:
    """CLIP / SigLIP encoder layers (HF ``CLIPEncoderLayer`` names)."""
    for i, lp in enumerate(layers):
        b = f"{prefix}.layers.{i}"
        _ln_out(sd, f"{b}.layer_norm1", lp["ln1"])
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _linear_out(sd, f"{b}.self_attn.{hf}", lp["attn"][n])
        _ln_out(sd, f"{b}.layer_norm2", lp["ln2"])
        _linear_out(sd, f"{b}.mlp.fc1", lp["fc1"])
        _linear_out(sd, f"{b}.mlp.fc2", lp["fc2"])


def _text_out(sd: StateDict, prefix: str, t, head: bool) -> None:
    """A CLIP (``head`` False) or SigLIP (``head`` True) text tower."""
    sd[f"{prefix}.embeddings.token_embedding.weight"] = _f32(t["token_embedding"])
    sd[f"{prefix}.embeddings.position_embedding.weight"] = _f32(t["position_embedding"])
    _encoder_layers_out(sd, f"{prefix}.encoder", t["layers"])
    _ln_out(sd, f"{prefix}.final_layer_norm", t["final_ln"])
    if head:
        _linear_out(sd, f"{prefix}.head", t["head"])


def _clip_vision_out(sd: StateDict, prefix: str, v, cfg) -> None:
    sd[f"{prefix}.embeddings.class_embedding"] = _f32(v["class_embedding"])
    sd[f"{prefix}.embeddings.patch_embedding.weight"] = _conv_out(v["patch_embedding"], cfg)
    sd[f"{prefix}.embeddings.position_embedding.weight"] = _f32(v["position_embedding"])
    _ln_out(sd, f"{prefix}.pre_layrnorm", v["pre_ln"])
    _encoder_layers_out(sd, f"{prefix}.encoder", v["layers"])
    _ln_out(sd, f"{prefix}.post_layernorm", v["post_ln"])


def _siglip_vision_out(sd: StateDict, prefix: str, v, cfg) -> None:
    """The SigLIP ViT, with the MAP head's q / k / v re-assembled into
    ``nn.MultiheadAttention``'s fused ``in_proj``."""
    sd[f"{prefix}.embeddings.patch_embedding.weight"] = _conv_out(v["patch_embedding"], cfg)
    sd[f"{prefix}.embeddings.patch_embedding.bias"] = _f32(v["patch_embedding"]["b"])
    sd[f"{prefix}.embeddings.position_embedding.weight"] = _f32(v["position_embedding"])
    _encoder_layers_out(sd, f"{prefix}.encoder", v["layers"])
    _ln_out(sd, f"{prefix}.post_layernorm", v["post_ln"])
    m = v["map_head"]
    a = m["attn"]
    sd[f"{prefix}.head.probe"] = _f32(m["probe"])
    sd[f"{prefix}.head.attention.in_proj_weight"] = torch.cat(
        [_f32(a[n]["w"]).t() for n in ("q", "k", "v")]).contiguous()
    sd[f"{prefix}.head.attention.in_proj_bias"] = torch.cat(
        [_f32(a[n]["b"]) for n in ("q", "k", "v")])
    _linear_out(sd, f"{prefix}.head.attention.out_proj", a["o"])
    _ln_out(sd, f"{prefix}.head.layernorm", m["ln"])
    _linear_out(sd, f"{prefix}.head.mlp.fc1", m["fc1"])
    _linear_out(sd, f"{prefix}.head.mlp.fc2", m["fc2"])


def _bert_text_out(sd: StateDict, prefix: str, t, arch: str) -> None:
    """A BERT / RoBERTa (HF ``BertModel`` names) or DistilBERT text tower."""
    p = prefix
    sd[f"{p}.embeddings.word_embeddings.weight"] = _f32(t["word_embeddings"])
    sd[f"{p}.embeddings.position_embeddings.weight"] = _f32(t["position_embeddings"])
    if "token_type_embeddings" in t:
        sd[f"{p}.embeddings.token_type_embeddings.weight"] = _f32(t["token_type_embeddings"])
    _ln_out(sd, f"{p}.embeddings.LayerNorm", t["emb_ln"])
    for i, lp in enumerate(t["layers"]):
        if arch == "distilbert":
            b = f"{p}.transformer.layer.{i}"
            for n, hf in (("q", "q_lin"), ("k", "k_lin"), ("v", "v_lin"), ("o", "out_lin")):
                _linear_out(sd, f"{b}.attention.{hf}", lp["attn"][n])
            _ln_out(sd, f"{b}.sa_layer_norm", lp["ln1"])
            _linear_out(sd, f"{b}.ffn.lin1", lp["fc1"])
            _linear_out(sd, f"{b}.ffn.lin2", lp["fc2"])
            _ln_out(sd, f"{b}.output_layer_norm", lp["ln2"])
        else:
            b = f"{p}.encoder.layer.{i}"
            for n, hf in (("q", "query"), ("k", "key"), ("v", "value")):
                _linear_out(sd, f"{b}.attention.self.{hf}", lp["attn"][n])
            _linear_out(sd, f"{b}.attention.output.dense", lp["attn"]["o"])
            _ln_out(sd, f"{b}.attention.output.LayerNorm", lp["ln1"])
            _linear_out(sd, f"{b}.intermediate.dense", lp["fc1"])
            _linear_out(sd, f"{b}.output.dense", lp["fc2"])
            _ln_out(sd, f"{b}.output.LayerNorm", lp["ln2"])
    if "pooler" in t:
        _linear_out(sd, f"{p}.pooler.dense", t["pooler"])


def _vit_vision_out(sd: StateDict, prefix: str, v, cfg) -> None:
    """The ViT (HF ``ViTModel`` names)."""
    p = prefix
    sd[f"{p}.embeddings.cls_token"] = _f32(v["cls_token"])
    sd[f"{p}.embeddings.position_embeddings"] = _f32(v["position_embeddings"])[None]
    sd[f"{p}.embeddings.patch_embeddings.projection.weight"] = _conv_out(
        v["patch_embedding"], cfg)
    sd[f"{p}.embeddings.patch_embeddings.projection.bias"] = _f32(v["patch_embedding"]["b"])
    for i, lp in enumerate(v["layers"]):
        b = f"{p}.encoder.layer.{i}"
        _ln_out(sd, f"{b}.layernorm_before", lp["ln1"])
        for n, hf in (("q", "query"), ("k", "key"), ("v", "value")):
            _linear_out(sd, f"{b}.attention.attention.{hf}", lp["attn"][n])
        _linear_out(sd, f"{b}.attention.output.dense", lp["attn"]["o"])
        _ln_out(sd, f"{b}.layernorm_after", lp["ln2"])
        _linear_out(sd, f"{b}.intermediate.dense", lp["fc1"])
        _linear_out(sd, f"{b}.output.dense", lp["fc2"])
    _ln_out(sd, f"{p}.layernorm", v["post_ln"])
    if "pooler" in v:
        _linear_out(sd, f"{p}.pooler.dense", v["pooler"])


def _backbone_out(sd: StateDict, model, prefix: str) -> None:
    """The backbone of any backend under ``prefix`` (``backbone.`` for a
    fusion model and a shared multi-task one), with whatever projections
    and logit leaves it holds."""
    bp, cfg = model.backbone, model.encoder_config
    t, v = bp["text_model"], bp["vision_model"]
    if model.backend == "clip":
        _text_out(sd, f"{prefix}text_model", t, head=False)
        _clip_vision_out(sd, f"{prefix}vision_model", v, cfg.vision)
    elif model.backend == "generic":
        _bert_text_out(sd, f"{prefix}text_model", t, cfg.text.arch)
        _vit_vision_out(sd, f"{prefix}vision_model", v, cfg.vision)
    else:
        _text_out(sd, f"{prefix}text_model", t, head=True)
        _siglip_vision_out(sd, f"{prefix}vision_model", v, cfg.vision)
    for name in ("text_projection", "visual_projection"):
        if name in bp:
            sd[f"{prefix}{name}.weight"] = _f32(bp[name]["w"]).t().contiguous()
    for name in ("logit_scale", "logit_bias"):
        if name in bp:
            leaf = _f32(bp[name])
            sd[f"{prefix}{name}"] = leaf if model.backend in ("clip", "generic") else leaf.reshape(1)


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


def fusion_model_to_torch(model) -> StateDict:
    """A ``FusionModel`` -> ``backbone.*`` + the fusion head's keys."""
    sd: StateDict = {}
    _backbone_out(sd, model, "backbone.")
    _fusion_head_out(sd, model.head)
    return sd


def mtl_model_to_torch(model, encoder_config: Optional[Dict[str, Any]] = None) -> StateDict:
    """A ``MultiTaskModel`` -> the reference multi-task layout. A generic
    backbone also gets the three leaves the multi-task forward never reads
    (module docstring): zero projections to ``projection_dim`` and
    ``logit_scale`` from ``encoder_config`` (the encoder's ``config.json``),
    else from the model's config and HF's defaults."""
    sd: StateDict = {}
    if model.backend == "clip":
        cfg = model.clip_config
        _text_out(sd, "tower_txt.text_model", model.backbone["text_model"], head=False)
        _clip_vision_out(sd, "tower_img.vision_model", model.backbone["vision_model"],
                        cfg.vision)
    else:
        _backbone_out(sd, model, "backbone.")
    if model.backend == "generic":
        enc = encoder_config or {}
        cfg = model.generic_config
        dim = enc.get("projection_dim") or cfg.projection_dim or VTDE_PROJECTION_DIM
        for name, width in (("text_projection", cfg.text.hidden_size),
                            ("visual_projection", cfg.vision.hidden_size)):
            sd.setdefault(f"backbone.{name}.weight", torch.zeros(dim, width))
        sd.setdefault("backbone.logit_scale", torch.tensor(
            float(enc.get("logit_scale_init_value", VTDE_LOGIT_SCALE))))
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
