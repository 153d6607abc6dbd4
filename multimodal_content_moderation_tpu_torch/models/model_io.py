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
from multimodal_content_moderation_tpu_torch.models.clip import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import DeepSeekV2Config
from multimodal_content_moderation_tpu_torch.models.fusion import BACKENDS, FusionModel, config_field
from multimodal_content_moderation_tpu_torch.models.generic import (
    GenericDualConfig,
    generic_params_from_torch,
)
from multimodal_content_moderation_tpu_torch.models.multitask import (
    CLIP_TOP_LEVEL,
    MultiTaskModel,
)
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.models.siglip import (
    SigLIPConfig,
    SigLIPTextConfig,
    SigLIPVisionConfig,
)
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


def siglip_config_from_dict(d: Dict[str, Any]) -> SigLIPConfig:
    t = d.get("text_config", {})
    v = d.get("vision_config", {})
    return SigLIPConfig(
        text=SigLIPTextConfig(
            vocab_size=t.get("vocab_size", 256000),
            hidden_size=t.get("hidden_size", 768),
            num_layers=t.get("num_hidden_layers", 12),
            num_heads=t.get("num_attention_heads", 12),
            intermediate_size=t.get("intermediate_size", 3072),
            max_positions=t.get("max_position_embeddings", 64),
            projection_size=t.get("projection_size", t.get("hidden_size", 768)),
            hidden_act=t.get("hidden_act", "gelu_pytorch_tanh"),
            layer_norm_eps=t.get("layer_norm_eps", 1e-6),
        ),
        vision=SigLIPVisionConfig(
            hidden_size=v.get("hidden_size", 768),
            num_layers=v.get("num_hidden_layers", 12),
            num_heads=v.get("num_attention_heads", 12),
            intermediate_size=v.get("intermediate_size", 3072),
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            num_channels=v.get("num_channels", 3),
            hidden_act=v.get("hidden_act", "gelu_pytorch_tanh"),
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
        ),
    )


def resolve_backend(encoder_dir: Optional[str], backend: str) -> str:
    """Resolve ``backend: auto`` from the local encoder's ``config.json``
    ``model_type``, as the JAX package does: clip -> clip, siglip-family or
    none -> siglip, deepseek_v2 -> deepseek_v2 (the port's own), another
    dual-encoder config (``text_config`` / ``vision_config``, e.g.
    ``vision-text-dual-encoder``) -> generic. Other names come back as they
    are."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if backend != "auto":
        return backend
    cfg_path = os.path.join(encoder_dir or "", "config.json")
    if os.path.exists(cfg_path):
        d = load_json(cfg_path)
        model_type = d.get("model_type", "")
        if model_type in ("clip", "deepseek_v2"):
            return model_type
        if model_type and not model_type.startswith("siglip") and (
            "text_config" in d or "vision_config" in d
        ):
            return "generic"
    return "siglip"


def load_encoder_config(encoder_dir: str, backend: str):
    """Parse a local HF ``config.json`` into the backend's config
    dataclasses (``CLIPConfig`` for clip, ``GenericDualConfig`` for generic,
    ``DeepSeekV2Config`` for deepseek_v2, ``SigLIPConfig`` for the SigLIP
    family), or the backend's canonical architecture without one."""
    cfg_path = os.path.join(encoder_dir, "config.json")
    d = load_json(cfg_path) if os.path.exists(cfg_path) else None
    if backend == "deepseek_v2":
        return DeepSeekV2Config.lite_siglip2_224() if d is None else DeepSeekV2Config.from_dict(d)
    if backend == "clip":
        return CLIPConfig.base_patch32() if d is None else clip_config_from_dict(d)
    if backend == "generic":
        return GenericDualConfig() if d is None else GenericDualConfig.from_dict(d)
    return SigLIPConfig.base_patch16_224() if d is None else siglip_config_from_dict(d)


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
    clip_config: Optional[CLIPConfig] = None,
    seed: int = 0,
    device="cuda",
    siglip_config: Optional[SigLIPConfig] = None,
    head_hidden_dim: int = 0,
    learnable_task_weights: bool = False,
    generic_config: Optional[GenericDualConfig] = None,
    deepseek_config: Optional[DeepSeekV2Config] = None,
):
    """A randomly initialised fusion or multi-task model (scripts/train.py's
    contract). The multi-task head maps the backend as the JAX package does:
    clip -> clip, generic -> generic, siglip / auto -> the shared "auto"
    backbone; it has no deepseek_v2 backbone and refuses it."""
    if head == "mtl":
        if backend == "deepseek_v2":
            raise NotImplementedError("the multi-task head has no deepseek_v2 backbone: use "
                                      "the fusion head (head: fusion)")
        return MultiTaskModel.create(
            backend=backend if backend in ("clip", "generic") else "auto",
            num_tasks=len(class_names),
            fusion_dim=fusion_dim,
            head_hidden_dim=head_hidden_dim or 0,
            learnable_task_weights=learnable_task_weights,
            clip_config=clip_config,
            siglip_config=siglip_config,
            generic_config=generic_config,
            seed=seed,
            device=device,
        )
    if head != "fusion":
        raise ValueError(f"head {head!r}: want 'fusion' or 'mtl'")
    return FusionModel.create(
        backend=backend,
        num_labels=len(class_names),
        fusion_dim=fusion_dim,
        clip_config=clip_config,
        seed=seed,
        device=device,
        loss_type=loss_type,
        focal_gamma=focal_gamma,
        siglip_config=siglip_config,
        generic_config=generic_config,
        deepseek_config=deepseek_config,
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
    if model.backend == "deepseek_v2":
        from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import (
            deepseek_v2_params_from_torch,
        )

        backbone = deepseek_v2_params_from_torch(sd, model.deepseek_config)
    elif model.backend in ("clip", "generic"):
        backbone = (convert.clip_params_from_torch(sd, model.clip_config)
                    if model.backend == "clip"
                    else generic_params_from_torch(sd, model.generic_config))
        if isinstance(model, MultiTaskModel):
            for name in CLIP_TOP_LEVEL:
                backbone.pop(name, None)
    else:
        backbone = convert.siglip_params_from_torch(sd, model.siglip_config)
    flat = flatten(backbone)
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
    return model.replace(**{config_field(model.backend): new_cfg})


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
    if backend not in BACKENDS:
        raise ValueError(f"{checkpoint_dir}: backend {backend!r}: want one of {BACKENDS}")
    if cfg.get("format") == "orbax":
        raise NotImplementedError(
            "an Orbax run directory is the JAX package's own format: convert it "
            "with mmharm-export (model.safetensors) to load it here"
        )
    class_names = cfg.get("class_names", ["harmful"])
    enc_src = encoder_dir or cfg.get("encoder_dir") or checkpoint_dir
    enc_cfg = load_encoder_config(enc_src, backend)
    cfg_kw = {config_field(backend): enc_cfg}

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
            **cfg_kw,
        )
        model.load_state_dict(load_params(checkpoint_dir), strict=True)
        if dtype is not None:
            model = model.to(dtype)
        return model.to(dev), cfg

    sd = _find_state_dict(checkpoint_dir)
    if sd is None:
        raise FileNotFoundError(f"No model weights found in {checkpoint_dir}")
    conv_kw = {config_field(backend).replace("_config", "_cfg"): enc_cfg}
    if head == "mtl":
        if backend == "deepseek_v2":
            raise NotImplementedError(f"{checkpoint_dir}: the multi-task head has no "
                                      "deepseek_v2 backbone")
        mtl_backend = backend if backend in ("clip", "generic") else "auto"
        params = convert.mtl_model_from_torch(sd, mtl_backend, len(class_names), **conv_kw)
        if dtype is not None:
            params = convert.to_dtype(params, dtype)
        first = params["head"]["heads"][0]
        model = MultiTaskModel(
            params, mtl_backend, num_tasks=len(class_names),
            fusion_dim=cfg.get("fusion_dim", 512),
            head_hidden_dim=int(first["fc1"]["w"].shape[1]) if "fc1" in first else 0,
            learnable_task_weights="log_vars" in params["head"],
            **cfg_kw,
        )
        return model.to(dev), cfg
    params = convert.fusion_model_from_torch(sd, backend, **conv_kw)
    if dtype is not None:
        params = convert.to_dtype(params, dtype)
    model = FusionModel(
        params,
        backend,
        num_labels=len(class_names),
        fusion_dim=cfg.get("fusion_dim", 512),
        **cfg_kw,
    ).to(dev)
    return model, cfg
