"""The measured program, ``multimodal_content_moderation_tpu_torch``, as the
benchmark drives it: its own loader for the weights, its dataset, engine,
trainer and server. Nothing else in the harness imports the port."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

import torch


def encoder_config(cfg, **tower):
    """The port's encoder config of a configuration file, with ``tower``
    fields (compute dtype, attention core) set in both towers."""
    from multimodal_content_moderation_tpu_torch.models import model_io

    d = {"text_config": cfg["text_config"], "vision_config": cfg["vision_config"]}
    if "projection_dim" in cfg:
        d["projection_dim"] = cfg["projection_dim"]
    make = (model_io.clip_config_from_dict if cfg["family"] == "clip"
            else model_io.siglip_config_from_dict)
    c = make(d)
    if tower:
        c = dataclasses.replace(c, text=dataclasses.replace(c.text, **tower),
                                vision=dataclasses.replace(c.vision, **tower))
    return c


def build_kernels(names: List[str], device) -> None:
    if device.type == "cuda":
        from multimodal_content_moderation_tpu_torch.ops import _build

        _build.build(names)


def fusion_model(cfg, sd: Dict[str, torch.Tensor], device, recipe: Dict, train: bool):
    """The port's ``FusionModel`` from a reference-layout state dict, through
    its loader (``models/convert.fusion_model_from_torch``), with the recipe:
    for scoring ``bf16_fast`` (bf16 weights and compute, bf16 scores) and the
    attention core; for training bf16 compute on fp32 weights, the attention
    core and the u8 wire's normalisation stats in the model."""
    from multimodal_content_moderation_tpu_torch.models import convert, model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel, config_field

    family = cfg["family"]
    tower = {}
    if train and recipe.get("precision") == "bf16":
        tower["compute_dtype"] = "bfloat16"
    if train and recipe.get("attention", "xla") != "xla":
        tower["attention_impl"] = recipe["attention"]
    enc = encoder_config(cfg, **tower)
    field = config_field(family)
    params = convert.fusion_model_from_torch(sd, family, **{field.replace("_config", "_cfg"): enc})
    model = FusionModel(params, family, num_labels=len(cfg["head"]["class_names"]),
                        fusion_dim=cfg["head"]["fusion_dim"], **{field: enc}).to(device)
    if train:
        return model.replace(image_mean=tuple(cfg["image"]["mean"]),
                             image_std=tuple(cfg["image"]["std"]))
    precision = recipe.get("precision", "fp32")
    if precision not in ("fp32", "bf16_fast"):
        raise ValueError(f"scoring precision {precision!r}: want fp32 or bf16_fast")
    if precision == "bf16_fast":
        model = model_io.with_performance_options(
            model, compute_dtype="bfloat16", scores_dtype="bfloat16").to(torch.bfloat16)
    if recipe.get("attention", "xla") != "xla":
        model = model_io.with_performance_options(model, attention_impl=recipe["attention"])
    return model


def dataset(cfg, csv_path: str, image_root: str, enc_dir: str, cache_dir: str, recipe: Dict):
    """A ``CSVDataset`` of uint8 crops (the u8 wire) with the decode-once
    pixel cache under ``cache_dir``."""
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

    size = cfg["vision_config"]["image_size"]
    pre = ImagePreprocessor(size, size, cfg["image"]["mean"], cfg["image"]["std"],
                            output="uint8_hwc", backend=recipe["image_backend"])
    return CSVDataset(csv_path, image_root, load_tokenizer(enc_dir), pre,
                      max_text_length=cfg["max_text_length"],
                      class_names=cfg["head"]["class_names"], cache_dir=cache_dir)


_RULES = [
    (r"\.embeddings\.token_embedding\.weight$", ".token_embedding"),
    (r"\.embeddings\.position_embedding\.weight$", ".position_embedding"),
    (r"\.embeddings\.class_embedding$", ".class_embedding"),
    (r"\.embeddings\.patch_embedding\.weight$", ".patch_embedding.w"),
    (r"\.embeddings\.patch_embedding\.bias$", ".patch_embedding.b"),
    (r"\.encoder\.layers\.(\d+)\.self_attn\.q_proj\.", r".layers.\1.attn.q."),
    (r"\.encoder\.layers\.(\d+)\.self_attn\.k_proj\.", r".layers.\1.attn.k."),
    (r"\.encoder\.layers\.(\d+)\.self_attn\.v_proj\.", r".layers.\1.attn.v."),
    (r"\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.", r".layers.\1.attn.o."),
    (r"\.encoder\.layers\.(\d+)\.layer_norm1\.", r".layers.\1.ln1."),
    (r"\.encoder\.layers\.(\d+)\.layer_norm2\.", r".layers.\1.ln2."),
    (r"\.encoder\.layers\.(\d+)\.mlp\.", r".layers.\1."),
    (r"\.final_layer_norm\.", ".final_ln."),
    (r"\.pre_layrnorm\.", ".pre_ln."),
    (r"\.post_layernorm\.", ".post_ln."),
    (r"vision_model\.head\.probe$", "vision_model.map_head.probe"),
    (r"vision_model\.head\.attention\.out_proj\.", "vision_model.map_head.attn.o."),
    (r"vision_model\.head\.layernorm\.", "vision_model.map_head.ln."),
    (r"vision_model\.head\.mlp\.", "vision_model.map_head."),
    (r"text_model\.head\.", "text_model.head."),
    (r"^cls\.0\.", "cls_ln."),
    (r"^cls\.1\.", "cls_fc1."),
    (r"^cls\.4\.", "cls_fc2."),
]
_NORMS = {"ln1", "ln2", "final_ln", "pre_ln", "post_ln", "ln", "ln_fused", "cls_ln"}


def port_names(hf_name: str) -> List[str]:
    """The port's parameter paths that hold a reference-layout leaf (the
    MAP head's packed q/k/v projection is three of them)."""
    m = re.match(r"(.*vision_model)\.head\.attention\.in_proj_(weight|bias)$", hf_name)
    if m:
        base = m.group(1) + ".map_head.attn"
        leaf = "w" if m.group(2) == "weight" else "b"
        return [f"{base}.{x}.{leaf}" for x in ("q", "k", "v")]
    name = hf_name
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    if not name.startswith("backbone."):
        name = "head." + name
    parts = name.split(".")
    if parts[-1] in ("weight", "bias"):
        owner = parts[-2]
        if owner in _NORMS or owner.startswith("ln"):
            parts[-1] = "scale" if parts[-1] == "weight" else "bias"
        else:
            parts[-1] = "w" if parts[-1] == "weight" else "b"
    return [".".join(parts)]
