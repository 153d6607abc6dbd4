"""CLIP dual encoder (text transformer + ViT trunk) over a parameter tree.

Semantics match HF ``transformers.CLIPModel``, as the JAX package's
``models/clip.py`` does: causal text tower pooled at the first EOS, ViT
with a CLS token, pre-LN and post-LN on the CLS token, and both
projections. The vision trunk starts from embedded patch tokens, which
``models/u8wire.image_tokens`` makes from either wire: uint8 patch rows
embedded on the card, or normalised fp32 NCHW pixels patchified through the
``patch_embedding`` dense. The reference (Hugging Face) layout
is read and written at the end: ``CLIPModel`` names, the bare towers of the
multi-task checkpoint under ``tower_txt.`` / ``tower_img.``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.params import (
    _conv_out,
    _conv_patch_embed,
    _f32,
    _linear,
    _linear_out,
    _ln,
    _ln_out,
    _strip_prefix,
    _t,
    _top_level_out,
)
from multimodal_content_moderation_tpu_torch.ops.cuda_attention import NEG_INF
from multimodal_content_moderation_tpu_torch.ops.layers import (
    dense,
    layer_norm,
    transformer_block,
)
from multimodal_content_moderation_tpu_torch.parallel.collectives import vocab_parallel_lookup


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_positions: int = 77
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    attention_impl: str = "xla"  # "xla" | "pallas" (the attention_nhd kernels)
    scores_dtype: str = "float32"
    remat: bool = False  # recompute each block in the backward pass


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "float32"
    attention_impl: str = "xla"
    scores_dtype: str = "float32"
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTextConfig = CLIPTextConfig()
    vision: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512

    @staticmethod
    def base_patch32() -> "CLIPConfig":
        """openai/clip-vit-base-patch32."""
        return CLIPConfig()


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(g: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=dtype, device=g.device) * std


def _dense_init(g, d_in, d_out, dtype):
    return {
        "w": _normal(g, (d_in, d_out), dtype, d_in ** -0.5),
        "b": torch.zeros((d_out,), dtype=dtype, device=g.device),
    }


def _ln_init(d, dtype, device):
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def _block_init(g, d, d_ff, dtype):
    return {
        "ln1": _ln_init(d, dtype, g.device),
        "attn": {n: _dense_init(g, d, d, dtype) for n in ("q", "k", "v", "o")},
        "ln2": _ln_init(d, dtype, g.device),
        "fc1": _dense_init(g, d, d_ff, dtype),
        "fc2": _dense_init(g, d_ff, d, dtype),
    }


def clip_init(g: torch.Generator, cfg: CLIPConfig, dtype=torch.float32) -> dict:
    """Random-init a full CLIP parameter tree on ``g.device`` (same
    distributions as the JAX package's ``clip_init``, other numbers)."""
    t, v = cfg.text, cfg.vision
    n_patches = (v.image_size // v.patch_size) ** 2
    text = {
        "token_embedding": _normal(g, (t.vocab_size, t.hidden_size), dtype, 0.02),
        "position_embedding": _normal(g, (t.max_positions, t.hidden_size), dtype, 0.01),
        "layers": [
            _block_init(g, t.hidden_size, t.intermediate_size, dtype)
            for _ in range(t.num_layers)
        ],
        "final_ln": _ln_init(t.hidden_size, dtype, g.device),
    }
    vision = {
        "class_embedding": _normal(g, (v.hidden_size,), dtype, 0.02),
        "patch_embedding": {
            "w": _normal(g, (v.num_channels * v.patch_size**2, v.hidden_size), dtype, 0.02)
        },
        "position_embedding": _normal(g, (n_patches + 1, v.hidden_size), dtype, 0.01),
        "pre_ln": _ln_init(v.hidden_size, dtype, g.device),
        "layers": [
            _block_init(g, v.hidden_size, v.intermediate_size, dtype)
            for _ in range(v.num_layers)
        ],
        "post_ln": _ln_init(v.hidden_size, dtype, g.device),
    }
    return {
        "text_model": text,
        "vision_model": vision,
        "logit_scale": torch.tensor(2.6592, dtype=dtype, device=g.device),
        "text_projection": {
            "w": _normal(g, (t.hidden_size, cfg.projection_dim), dtype, t.hidden_size ** -0.5)
        },
        "visual_projection": {
            "w": _normal(g, (v.hidden_size, cfg.projection_dim), dtype, v.hidden_size ** -0.5)
        },
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _text_masks(input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor]):
    """Additive [B, 1, T, T] mask: causal + padding (HF CLIP convention)."""
    T = input_ids.shape[1]
    causal = torch.full((T, T), NEG_INF, dtype=torch.float32, device=input_ids.device).triu(1)
    mask = causal[None, None, :, :]
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float()) * NEG_INF
        mask = mask + pad[:, None, None, :]
    return mask


def clip_text_hidden(
    params, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor], cfg: CLIPTextConfig
) -> torch.Tensor:
    """Final-LN'd hidden states [B, T, D] of the CLIP text tower."""
    p = params["text_model"]
    T = input_ids.shape[1]
    x = vocab_parallel_lookup(p["token_embedding"], input_ids) + p["position_embedding"][:T]
    x = x.to(getattr(torch, cfg.compute_dtype))
    if cfg.attention_impl == "pallas":
        # structured masks: causal and key padding are applied in the kernel
        mask, causal = None, True
        key_mask = (
            None
            if attention_mask is None
            else (1.0 - attention_mask.float()) * NEG_INF
        )
    else:
        mask, causal, key_mask = _text_masks(input_ids, attention_mask), False, None
    for layer in p["layers"]:
        x = transformer_block(
            x, layer, cfg.num_heads, cfg.hidden_act, mask, cfg.layer_norm_eps,
            remat=cfg.remat,
            attention_impl=cfg.attention_impl,
            scores_dtype=cfg.scores_dtype,
            causal=causal,
            key_mask=key_mask,
        )
    return layer_norm(x, p["final_ln"], cfg.layer_norm_eps)


def clip_text_pooled(params, input_ids, attention_mask, cfg: CLIPTextConfig) -> torch.Tensor:
    """Hidden state at the first EOS position (= HF ``pooler_output``)."""
    hidden = clip_text_hidden(params, input_ids, attention_mask, cfg)
    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), eos_pos]


def clip_text_features(params, input_ids, attention_mask, cfg: CLIPConfig) -> torch.Tensor:
    """= HF ``CLIPModel.get_text_features`` (pooled -> text_projection)."""
    pooled = clip_text_pooled(params, input_ids, attention_mask, cfg.text)
    return dense(pooled, params["text_projection"])


def clip_vision_encoder(params, tokens: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """ViT trunk over embedded patch tokens [B, N, D] -> [B, 1+N, D]
    (CLS prepend + pos-embed + pre-LN + blocks)."""
    p = params["vision_model"]
    x = tokens
    B = x.shape[0]
    cls = p["class_embedding"].to(x.dtype)[None, None, :].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + p["position_embedding"].to(x.dtype)[None]
    x = layer_norm(x, p["pre_ln"], cfg.layer_norm_eps)
    for layer in p["layers"]:
        x = transformer_block(
            x, layer, cfg.num_heads, cfg.hidden_act, None, cfg.layer_norm_eps,
            remat=cfg.remat,
            attention_impl=cfg.attention_impl,
            scores_dtype=cfg.scores_dtype,
        )
    return x


def clip_vision_pooled_from_tokens(params, tokens, cfg: CLIPVisionConfig) -> torch.Tensor:
    """Post-LN of the CLS token, from embedded patch tokens."""
    x = clip_vision_encoder(params, tokens, cfg)
    return layer_norm(x[:, 0], params["vision_model"]["post_ln"], cfg.layer_norm_eps)


def clip_image_features_from_tokens(params, tokens, cfg: CLIPConfig) -> torch.Tensor:
    """``get_image_features`` from embedded patch tokens."""
    pooled = clip_vision_pooled_from_tokens(params, tokens, cfg.vision)
    return dense(pooled, params["visual_projection"])


# ---------------------------------------------------------------------------
# Reference layout
# ---------------------------------------------------------------------------


def clip_config_from_dict(d: Dict[str, Any]) -> CLIPConfig:
    """An HF ``config.json`` -> ``CLIPConfig``."""
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


def _encoder_layers(sd: Dict, prefix: str, num_layers: int) -> list:
    """HF ``CLIPEncoderLayer`` names (SigLIP's too) -> the layer trees."""
    layers = []
    for i in range(num_layers):
        b = f"{prefix}.layers.{i}"
        layers.append(
            {
                "ln1": _ln(sd, f"{b}.layer_norm1"),
                "attn": {
                    "q": _linear(sd, f"{b}.self_attn.q_proj"),
                    "k": _linear(sd, f"{b}.self_attn.k_proj"),
                    "v": _linear(sd, f"{b}.self_attn.v_proj"),
                    "o": _linear(sd, f"{b}.self_attn.out_proj"),
                },
                "ln2": _ln(sd, f"{b}.layer_norm2"),
                "fc1": _linear(sd, f"{b}.mlp.fc1"),
                "fc2": _linear(sd, f"{b}.mlp.fc2"),
            }
        )
    return layers


def clip_text_tower_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "text_model.") -> dict:
    t = _strip_prefix(sd, prefix)
    return {
        "token_embedding": _t(t["embeddings.token_embedding.weight"]),
        "position_embedding": _t(t["embeddings.position_embedding.weight"]),
        "layers": _encoder_layers(t, "encoder", cfg.text.num_layers),
        "final_ln": _ln(t, "final_layer_norm"),
    }


def clip_vision_tower_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "vision_model.") -> dict:
    v = _strip_prefix(sd, prefix)
    return {
        "class_embedding": _t(v["embeddings.class_embedding"]),
        "patch_embedding": _conv_patch_embed(v, "embeddings.patch_embedding", bias=False),
        "position_embedding": _t(v["embeddings.position_embedding.weight"]),
        # NB: HF spells it "pre_layrnorm"
        "pre_ln": _ln(v, "pre_layrnorm"),
        "layers": _encoder_layers(v, "encoder", cfg.vision.num_layers),
        "post_ln": _ln(v, "post_layernorm"),
    }


def clip_params_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "") -> dict:
    """Full CLIPModel state dict -> parameter tree (with projections)."""
    s = _strip_prefix(sd, prefix)
    out = {
        "text_model": clip_text_tower_from_torch(s, cfg),
        "vision_model": clip_vision_tower_from_torch(s, cfg),
        "text_projection": _linear(s, "text_projection", bias=False),
        "visual_projection": _linear(s, "visual_projection", bias=False),
    }
    if "logit_scale" in s:
        out["logit_scale"] = _t(s["logit_scale"]).reshape(())
    return out


def clip_towers_from_torch(sd: Dict, cfg: CLIPConfig) -> dict:
    """The multi-task checkpoint's bare towers (``tower_txt.text_model.*``,
    ``tower_img.vision_model.*``) -> the backbone tree."""
    return {
        "text_model": clip_text_tower_from_torch(sd, cfg, prefix="tower_txt.text_model."),
        "vision_model": clip_vision_tower_from_torch(sd, cfg, prefix="tower_img.vision_model."),
    }


def _encoder_layers_out(sd: Dict, prefix: str, layers) -> None:
    """CLIP / SigLIP encoder layers (HF ``CLIPEncoderLayer`` names)."""
    for i, lp in enumerate(layers):
        b = f"{prefix}.layers.{i}"
        _ln_out(sd, f"{b}.layer_norm1", lp["ln1"])
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _linear_out(sd, f"{b}.self_attn.{hf}", lp["attn"][n])
        _ln_out(sd, f"{b}.layer_norm2", lp["ln2"])
        _linear_out(sd, f"{b}.mlp.fc1", lp["fc1"])
        _linear_out(sd, f"{b}.mlp.fc2", lp["fc2"])


def _text_out(sd: Dict, prefix: str, t, head: bool) -> None:
    """A CLIP (``head`` False) or SigLIP (``head`` True) text tower."""
    sd[f"{prefix}.embeddings.token_embedding.weight"] = _f32(t["token_embedding"])
    sd[f"{prefix}.embeddings.position_embedding.weight"] = _f32(t["position_embedding"])
    _encoder_layers_out(sd, f"{prefix}.encoder", t["layers"])
    _ln_out(sd, f"{prefix}.final_layer_norm", t["final_ln"])
    if head:
        _linear_out(sd, f"{prefix}.head", t["head"])


def clip_to_torch(bp, cfg: CLIPConfig, prefix: str = "", text: str = "text_model",
                  vision: str = "vision_model") -> Dict:
    """The inverse of ``clip_params_from_torch``: HF names under ``prefix``,
    fp32 CPU tensors; the towers under ``text`` and ``vision`` (the
    multi-task checkpoint's ``tower_txt.text_model`` and
    ``tower_img.vision_model``)."""
    sd: Dict = {}
    _text_out(sd, f"{prefix}{text}", bp["text_model"], head=False)
    v, p = bp["vision_model"], f"{prefix}{vision}"
    sd[f"{p}.embeddings.class_embedding"] = _f32(v["class_embedding"])
    sd[f"{p}.embeddings.patch_embedding.weight"] = _conv_out(v["patch_embedding"], cfg.vision)
    sd[f"{p}.embeddings.position_embedding.weight"] = _f32(v["position_embedding"])
    _ln_out(sd, f"{p}.pre_layrnorm", v["pre_ln"])
    _encoder_layers_out(sd, f"{p}.encoder", v["layers"])
    _ln_out(sd, f"{p}.post_layernorm", v["post_ln"])
    _top_level_out(sd, bp, prefix, scalar_logits=True)
    return sd
