"""Model construction + checkpoint resolution (fully offline).

Resolves two checkpoint layouts into a ``FusionModel`` or a
``MultiTaskModel`` (``"head": "mtl"``) on the chosen device, with
``inference_config.json`` in the directory or its parent:

1. a reference-format run checkpoint (``model.safetensors`` or
   ``pytorch_model.bin`` with ``backbone.*`` and head keys; a multi-task
   CLIP checkpoint keeps its towers under ``tower_txt.*`` / ``tower_img.*``);
2. the port's own run directories (``checkpoint-N/params.pt``, written by
   ``training/checkpoints.py``, with ``"format": "torch"``).

A local HF encoder directory (``config.json`` + weights) seeds the backbone
of a new model (``init_from_encoder_dir``); the head starts from the seeded
random init. Every backbone loads: CLIP, SigLIP (a SigLIP2 checkpoint's
``image_size`` sizes its position table, so SigLIP2-B/16 at 384 px loads as
it is) and the generic ``VisionTextDualEncoderModel`` (a BERT, RoBERTa or
DistilBERT text tower with a ViT; ``backend: auto`` resolves to it from
the encoder's ``config.json``). The JAX package's Orbax run directories
are its own format (``mmharm-export`` converts them). Config JSONs are
parsed directly.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from multimodal_content_moderation_tpu_torch.models import convert
from multimodal_content_moderation_tpu_torch.models.backbones import backbone, multitask

# re-exported: callers read the CLIP and SigLIP ``config.json`` parsers here
from multimodal_content_moderation_tpu_torch.models.clip import clip_config_from_dict  # noqa: F401
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.models.siglip import (  # noqa: F401
    siglip_config_from_dict,
)
from multimodal_content_moderation_tpu_torch.utils.config import load_json
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device


def resolve_backend(encoder_dir: Optional[str], backend: str) -> str:
    """Resolve ``backend: auto`` from the local encoder's ``config.json``
    ``model_type``, as the JAX package does: clip -> clip, siglip-family or
    none -> siglip, deepseek_v2 and kimi_linear -> themselves (the port's
    own), another dual-encoder config (``text_config`` / ``vision_config``,
    e.g. ``vision-text-dual-encoder``) -> generic. Other names come back as they
    are; a name outside ``models/backbones.py``'s table raises."""
    backbone(backend)
    if backend != "auto":
        return backend
    cfg_path = os.path.join(encoder_dir or "", "config.json")
    if os.path.exists(cfg_path):
        d = load_json(cfg_path)
        model_type = d.get("model_type", "")
        if model_type in ("clip", "deepseek_v2", "kimi_linear"):
            return model_type
        if model_type and not model_type.startswith("siglip") and (
            "text_config" in d or "vision_config" in d
        ):
            return "generic"
    return "siglip"


def load_encoder_config(encoder_dir: str, backend: str):
    """Parse a local HF ``config.json`` into the backend's config
    (``Backbone.from_dict``: ``CLIPConfig``, ``SigLIPConfig``,
    ``GenericDualConfig``, ``DeepSeekV2Config`` or ``KimiLinearConfig``), or the backend's
    canonical architecture without one."""
    family = backbone(backend)
    cfg_path = os.path.join(encoder_dir, "config.json")
    return family.from_dict(load_json(cfg_path)) if os.path.exists(cfg_path) else family.default()


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
    loss_type: str = "bce",
    focal_gamma: float = 1.5,
    encoder_config=None,
    seed: int = 0,
    device="cuda",
    head_hidden_dim: int = 0,
    learnable_task_weights: bool = False,
):
    """A randomly initialised fusion or multi-task model (scripts/train.py's
    contract). The multi-task head maps the backend as the JAX package does
    (``MultiTask.backend``): clip -> clip, generic -> generic, siglip / auto
    -> the shared "auto" backbone; it has no deepseek_v2 backbone and
    refuses it."""
    if head == "mtl":
        return MultiTaskModel.create(
            backend=multitask(backend).backend,
            num_tasks=len(class_names),
            fusion_dim=fusion_dim,
            head_hidden_dim=head_hidden_dim or 0,
            learnable_task_weights=learnable_task_weights,
            encoder_config=encoder_config,
            seed=seed,
            device=device,
        )
    if head != "fusion":
        raise ValueError(f"head {head!r}: want 'fusion' or 'mtl'")
    return FusionModel.create(
        backend=backend,
        num_labels=len(class_names),
        fusion_dim=fusion_dim,
        encoder_config=encoder_config,
        seed=seed,
        device=device,
        loss_type=loss_type,
        focal_gamma=focal_gamma,
    )


def init_from_encoder_dir(model, encoder_dir: Optional[str]):
    """Copy the HF encoder weights of ``encoder_dir`` (a local CLIP, SigLIP
    or ``VisionTextDualEncoderModel`` checkpoint directory) into the model's
    backbone, in place; the head keeps its seeded random init. A multi-task
    model's CLIP and generic towers are bare, so it takes no projections or
    ``logit_scale``. Without weights there, the model is returned as it
    is."""
    sd = _find_state_dict(encoder_dir) if encoder_dir else None
    if sd is None:
        return model
    flat = flatten(backbone(model.backend).from_torch(sd, model.encoder_config, ""))
    own = model.backbone.state_dict()
    missing = sorted(set(own) - set(flat))
    if missing:
        raise KeyError(f"{encoder_dir}: no weights for backbone {missing[:3]}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(flat[name].to(t.dtype))
    return model


def with_performance_options(
    model,
    compute_dtype: Optional[str] = None,
    scores_dtype: Optional[str] = None,
    attention_impl: Optional[str] = None,
):
    """A copy of the model (sharing its parameters) with the towers'
    performance knobs set: ``compute_dtype="bfloat16"`` = mixed precision,
    ``scores_dtype`` = the "xla" core's score dtype, ``attention_impl``
    "pallas" = the attention kernels, in both towers."""
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
    cfg = model.encoder_config
    new_cfg = dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, **overrides),
        vision=dataclasses.replace(cfg.vision, **overrides),
    )
    return model.replace(encoder_config=new_cfg)


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
) -> Tuple[Any, Dict[str, Any]]:
    """Checkpoint -> (model on ``device``, inference_config): a
    reference-format checkpoint, or a ``checkpoint-N`` of the port's own run
    directory (``"format": "torch"``) or the run directory itself (its best
    checkpoint, as ``training/checkpoints.run_checkpoint`` finds it: how a
    model package of a run unpacks); a ``FusionModel``, or a
    ``MultiTaskModel`` where the config says ``"head": "mtl"`` (with its
    ``head_hidden_dim`` and ``learnable_task_weights``; a reference-format
    checkpoint's weights show both).

    ``encoder_dir`` supplies the encoder ``config.json`` when the checkpoint
    does not carry one."""
    dev = resolve_device(device)
    cfg, _ = find_inference_config(checkpoint_dir)
    backend = cfg.get("backend", "clip")
    head = cfg.get("head", "fusion")
    if head not in ("fusion", "mtl"):
        raise ValueError(f"{checkpoint_dir}: head {head!r}: want 'fusion' or 'mtl'")
    backbone(backend)
    if cfg.get("format") == "orbax":
        raise NotImplementedError(
            "an Orbax run directory is the JAX package's own format: convert it "
            "with mmharm-export (model.safetensors) to load it here"
        )
    class_names = cfg.get("class_names", ["harmful"])
    enc_src = encoder_dir or cfg.get("encoder_dir") or checkpoint_dir
    enc_cfg = load_encoder_config(enc_src, backend)

    if cfg.get("format") == "torch":
        from multimodal_content_moderation_tpu_torch.training.checkpoints import (
            load_params,
            run_checkpoint,
        )

        checkpoint_dir = run_checkpoint(checkpoint_dir, cfg.get("best_checkpoint_dir"))
        model = build_model(
            head, backend, class_names, cfg.get("fusion_dim", 512), device="cpu",
            head_hidden_dim=cfg.get("head_hidden_dim", 0) or 0,
            learnable_task_weights=bool(cfg.get("learnable_task_weights", False)),
            encoder_config=enc_cfg,
        )
        model.load_state_dict(load_params(checkpoint_dir), strict=True)
        if dtype is not None:
            model = model.to(dtype)
        return model.to(dev), cfg

    sd = _find_state_dict(checkpoint_dir)
    if sd is None:
        raise FileNotFoundError(f"No model weights found in {checkpoint_dir}")
    if head == "mtl":
        mtl_backend = multitask(backend).backend
        params = convert.mtl_model_from_torch(sd, mtl_backend, len(class_names), enc_cfg)
        if dtype is not None:
            params = convert.to_dtype(params, dtype)
        first = params["head"]["heads"][0]
        model = MultiTaskModel(
            params, mtl_backend, enc_cfg, num_tasks=len(class_names),
            fusion_dim=cfg.get("fusion_dim", 512),
            head_hidden_dim=int(first["fc1"]["w"].shape[1]) if "fc1" in first else 0,
            learnable_task_weights="log_vars" in params["head"],
        )
        return model.to(dev), cfg
    params = convert.fusion_model_from_torch(sd, backend, enc_cfg)
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
