"""Model construction + checkpoint resolution (fully offline).

Loads a reference-format run checkpoint (``model.safetensors`` or
``pytorch_model.bin`` with ``backbone.*`` and head keys, plus
``inference_config.json`` in the directory or its parent) into a
``FusionModel`` on the chosen device. Config JSONs are parsed directly. The
framework's own Orbax run directories come with the training slice; the
SigLIP, generic and multi-task models with theirs.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from multimodal_content_moderation_tpu_torch.models import convert
from multimodal_content_moderation_tpu_torch.models.clip import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.utils.config import load_json
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device


def clip_config_from_dict(d: Dict[str, Any]) -> CLIPConfig:
    t = d.get("text_config", {})
    v = d.get("vision_config", {})
    return CLIPConfig(
        text=CLIPTextConfig(
            vocab_size=t.get("vocab_size", 49408),
            hidden_size=t.get("hidden_size", 512),
            num_layers=t.get("num_hidden_layers", 12),
            num_heads=t.get("num_attention_heads", 8),
            intermediate_size=t.get("intermediate_size", 2048),
            max_positions=t.get("max_position_embeddings", 77),
            eos_token_id=t.get("eos_token_id", 49407),
            hidden_act=t.get("hidden_act", "quick_gelu"),
            layer_norm_eps=t.get("layer_norm_eps", 1e-5),
        ),
        vision=CLIPVisionConfig(
            hidden_size=v.get("hidden_size", 768),
            num_layers=v.get("num_hidden_layers", 12),
            num_heads=v.get("num_attention_heads", 12),
            intermediate_size=v.get("intermediate_size", 3072),
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 32),
            num_channels=v.get("num_channels", 3),
            hidden_act=v.get("hidden_act", "quick_gelu"),
            layer_norm_eps=v.get("layer_norm_eps", 1e-5),
        ),
        projection_dim=d.get("projection_dim", 512),
    )


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (a later slice brings it)")


def load_encoder_config(encoder_dir: str, backend: str) -> CLIPConfig:
    """Parse a local HF ``config.json`` into the CLIP config dataclasses."""
    if backend != "clip":
        raise _not_ported(f"backend {backend!r}")
    cfg_path = os.path.join(encoder_dir, "config.json")
    if os.path.exists(cfg_path):
        return clip_config_from_dict(load_json(cfg_path))
    return CLIPConfig.base_patch32()


def _find_state_dict(directory: str) -> Optional[Dict]:
    """Model weights from a directory: safetensors preferred, torch
    ``pytorch_model.bin`` next (scripts/evaluate.py's order)."""
    st = os.path.join(directory, "model.safetensors")
    if os.path.exists(st):
        return convert.load_safetensors(st)
    bins = os.path.join(directory, "pytorch_model.bin")
    if os.path.exists(bins):
        return torch.load(bins, map_location="cpu", weights_only=True)
    return None


def build_model(
    head: str,
    backend: str,
    class_names,
    fusion_dim: int = 512,
    clip_config: Optional[CLIPConfig] = None,
    seed: int = 0,
    device="cuda",
) -> FusionModel:
    """A randomly initialised fusion model (scripts/train.py's contract;
    the loss options come with the training slice)."""
    if head != "fusion":
        raise _not_ported(f"head {head!r}")
    return FusionModel.create(
        backend=backend,
        num_labels=len(class_names),
        fusion_dim=fusion_dim,
        clip_config=clip_config,
        seed=seed,
        device=device,
    )


def with_performance_options(
    model: FusionModel,
    compute_dtype: Optional[str] = None,
    scores_dtype: Optional[str] = None,
    attention_impl: Optional[str] = None,
) -> FusionModel:
    """A copy of the model (sharing its parameters) with the towers'
    performance knobs set: ``compute_dtype="bfloat16"`` = mixed precision,
    ``scores_dtype`` = the "xla" core's score dtype, ``attention_impl``
    "pallas" = the attention_nhd kernel."""
    overrides = {
        k: v
        for k, v in (
            ("compute_dtype", compute_dtype),
            ("scores_dtype", scores_dtype),
            ("attention_impl", attention_impl),
        )
        if v is not None
    }
    if not overrides:
        return model
    cfg = model.clip_config
    new_cfg = dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, **overrides),
        vision=dataclasses.replace(cfg.vision, **overrides),
    )
    return model.replace(clip_config=new_cfg)


def find_inference_config(checkpoint_dir: str) -> Tuple[Dict[str, Any], str]:
    """Locate inference_config.json in {parent, dir} (scripts/evaluate.py's
    search order). Returns (config, path)."""
    p = Path(checkpoint_dir)
    for cand in [p.parent / "inference_config.json", p / "inference_config.json"]:
        if cand.exists():
            return load_json(str(cand)), str(cand)
    raise FileNotFoundError(
        f"Could not find inference_config.json in {checkpoint_dir} or its parent"
    )


def load_checkpoint(
    checkpoint_dir: str,
    encoder_dir: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Tuple[FusionModel, Dict[str, Any]]:
    """Reference-format checkpoint -> (model on ``device``, inference_config).

    ``encoder_dir`` supplies the encoder ``config.json`` when the checkpoint
    does not carry one."""
    dev = resolve_device(device)
    cfg, _ = find_inference_config(checkpoint_dir)
    backend = cfg.get("backend", "clip")
    head = cfg.get("head", "fusion")
    if head != "fusion":
        raise _not_ported(f"head {head!r}")
    if cfg.get("format") == "orbax":
        raise _not_ported("loading an Orbax run directory (the training slice)")
    class_names = cfg.get("class_names", ["harmful"])
    enc_src = encoder_dir or cfg.get("encoder_dir") or checkpoint_dir
    enc_cfg = load_encoder_config(enc_src, backend)

    sd = _find_state_dict(checkpoint_dir)
    if sd is None:
        raise FileNotFoundError(f"No model weights found in {checkpoint_dir}")
    params = convert.fusion_model_from_torch(sd, backend, clip_cfg=enc_cfg)
    if dtype is not None:
        params = convert.to_dtype(params, dtype)
    model = FusionModel(
        params,
        backend,
        enc_cfg,
        num_labels=len(class_names),
        fusion_dim=cfg.get("fusion_dim", 512),
    ).to(dev)
    return model, cfg
