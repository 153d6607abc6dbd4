"""SigLIP / SigLIP2 (fixed resolution) dual encoder over a parameter tree.

Semantics match HF ``transformers.SiglipModel``, as the JAX package's
``models/siglip.py`` does; the differences from CLIP:

- the vision tower has no class token, and its patch conv has a bias;
- vision pooling is a MAP head (a learned probe attending over the patch
  tokens, through the single-query branch of ``ops.layers.mha``);
- text pooling takes the last position's hidden state, then a linear head;
- the activation is tanh-approximate GELU and LayerNorm's eps is 1e-6;
- text attention is bidirectional with key padding (no causal mask).

The vision trunk starts from embedded patch tokens (``models/u8wire.py``'s
``image_tokens``, from either wire; the ``patch_embedding`` dense has a
bias). The reference (Hugging Face)
layout, ``SiglipModel`` names, is read and written at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.clip import (
    _block_init,
    _dense_init,
    _encoder_layers,
    _encoder_layers_out,
    _ln_init,
    _normal,
    _text_out,
)
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
    ACTIVATIONS,
    dense,
    dense_maybe_int8,
    layer_norm,
    mha,
    transformer_block,
)
from multimodal_content_moderation_tpu_torch.parallel.collectives import vocab_parallel_lookup


@dataclasses.dataclass(frozen=True)
class SigLIPTextConfig:
    vocab_size: int = 256000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 64
    projection_size: int = 768
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    remat: bool = False
    compute_dtype: str = "float32"
    attention_impl: str = "xla"
    scores_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    remat: bool = False
    compute_dtype: str = "float32"
    attention_impl: str = "xla"
    scores_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    text: SigLIPTextConfig = SigLIPTextConfig()
    vision: SigLIPVisionConfig = SigLIPVisionConfig()

    @staticmethod
    def base_patch16_224() -> "SigLIPConfig":
        """google/siglip2-base-patch16-224 (fixed resolution)."""
        return SigLIPConfig()


def siglip_init(g: torch.Generator, cfg: SigLIPConfig, dtype=torch.float32) -> dict:
    """Random-init a full SigLIP parameter tree on ``g.device`` (same
    distributions as the JAX package's ``siglip_init``, other numbers)."""
    t, v = cfg.text, cfg.vision
    text = {
        "token_embedding": _normal(g, (t.vocab_size, t.hidden_size), dtype, 0.02),
        "position_embedding": _normal(g, (t.max_positions, t.hidden_size), dtype, 0.01),
        "layers": [
            _block_init(g, t.hidden_size, t.intermediate_size, dtype)
            for _ in range(t.num_layers)
        ],
        "final_ln": _ln_init(t.hidden_size, dtype, g.device),
        "head": _dense_init(g, t.hidden_size, t.projection_size, dtype),
    }
    return {
        "text_model": text,
        "vision_model": siglip_vision_init(g, v, dtype),
        # kept for checkpoint round trips (the heads do not use them)
        "logit_scale": torch.tensor(1.0, dtype=dtype, device=g.device),
        "logit_bias": torch.tensor(0.0, dtype=dtype, device=g.device),
    }


def siglip_vision_init(g: torch.Generator, v: SigLIPVisionConfig, dtype=torch.float32) -> dict:
    """Random-init the SigLIP vision tower (patch embedding, blocks,
    post-LN, MAP head) on ``g.device``."""
    n_patches = (v.image_size // v.patch_size) ** 2
    d = v.hidden_size
    return {
        "patch_embedding": {
            "w": _normal(g, (v.num_channels * v.patch_size**2, d), dtype, 0.02),
            "b": torch.zeros((d,), dtype=dtype, device=g.device),
        },
        "position_embedding": _normal(g, (n_patches, d), dtype, 0.01),
        "layers": [_block_init(g, d, v.intermediate_size, dtype) for _ in range(v.num_layers)],
        "post_ln": _ln_init(d, dtype, g.device),
        "map_head": {
            "probe": _normal(g, (1, 1, d), dtype, 0.02),
            "attn": {n: _dense_init(g, d, d, dtype) for n in ("q", "k", "v", "o")},
            "ln": _ln_init(d, dtype, g.device),
            "fc1": _dense_init(g, d, v.intermediate_size, dtype),
            "fc2": _dense_init(g, v.intermediate_size, d, dtype),
        },
    }


def siglip_text_features(
    params,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    cfg: SigLIPConfig,
    position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """= HF ``SiglipModel.get_text_features``: last-position pooling + head.

    ``position_ids`` ([T], default ``arange(T)``) serves the exact
    length-bucketed eval: a bucket keeps b-1 real columns plus a carry
    column, a PAD token masked as a key and embedded at the full width's last
    position. Masked keys weigh exactly zero at any width and per-position
    ops do not mix positions, so the carry column's pooled state equals the
    full-width last position's (``models/fast_infer.bucket_batch_text``)."""
    t = cfg.text
    p = params["text_model"]
    T = input_ids.shape[1]
    pos = (
        p["position_embedding"][:T]
        if position_ids is None
        else p["position_embedding"][position_ids.long()]
    )
    x = vocab_parallel_lookup(p["token_embedding"], input_ids) + pos
    x = x.to(getattr(torch, t.compute_dtype))
    mask, key_mask = None, None
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float()) * NEG_INF
        if t.attention_impl == "pallas":
            key_mask = pad  # applied in the kernel, no dense [T, T] tensor
        else:
            mask = pad[:, None, None, :]
    for layer in p["layers"]:
        x = transformer_block(
            x, layer, t.num_heads, t.hidden_act, mask, t.layer_norm_eps,
            remat=t.remat,
            attention_impl=t.attention_impl,
            scores_dtype=t.scores_dtype,
            key_mask=key_mask,
        )
    x = layer_norm(x, p["final_ln"], t.layer_norm_eps)
    return dense(x[:, -1], p["head"])


def _map_head(hidden: torch.Tensor, p, cfg: SigLIPVisionConfig) -> torch.Tensor:
    """Multihead attention pooling: a learned probe attends over the patch
    tokens (= HF ``SiglipMultiheadAttentionPoolingHead``)."""
    B = hidden.shape[0]
    probe = p["probe"].to(hidden.dtype).expand(B, 1, cfg.hidden_size)
    x = mha(probe, hidden, p["attn"], cfg.num_heads)
    y = layer_norm(x, p["ln"], cfg.layer_norm_eps)
    y = ACTIVATIONS[cfg.hidden_act](dense_maybe_int8(y, p["fc1"]))
    return (x + dense(y, p["fc2"]))[:, 0]


def siglip_vision_encoder(params, tokens: torch.Tensor, cfg: SigLIPVisionConfig) -> torch.Tensor:
    """ViT trunk over embedded patch tokens [B, N, D] -> post-LN hidden
    states (position embedding + blocks + post-LN; no class token)."""
    p = params["vision_model"]
    x = tokens + p["position_embedding"].to(tokens.dtype)[None]
    for layer in p["layers"]:
        x = transformer_block(
            x, layer, cfg.num_heads, cfg.hidden_act, None, cfg.layer_norm_eps,
            remat=cfg.remat,
            attention_impl=cfg.attention_impl,
            scores_dtype=cfg.scores_dtype,
        )
    return layer_norm(x, p["post_ln"], cfg.layer_norm_eps)


def siglip_image_features_from_tokens(params, tokens: torch.Tensor, cfg: SigLIPConfig) -> torch.Tensor:
    """``get_image_features`` (MAP-head pooled) from embedded patch tokens."""
    hidden = siglip_vision_encoder(params, tokens, cfg.vision)
    return _map_head(hidden, params["vision_model"]["map_head"], cfg.vision)


# ---------------------------------------------------------------------------
# Reference layout
# ---------------------------------------------------------------------------


def siglip_config_from_dict(d: Dict[str, Any]) -> SigLIPConfig:
    """An HF ``config.json`` -> ``SigLIPConfig`` (a SigLIP2 checkpoint's
    ``image_size`` sizes the position table)."""
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


def siglip_params_from_torch(sd: Dict, cfg: SigLIPConfig, prefix: str = "") -> dict:
    """Full SiglipModel state dict -> parameter tree."""
    s = _strip_prefix(sd, prefix)
    t = _strip_prefix(s, "text_model.")
    out = {
        "text_model": {
            "token_embedding": _t(t["embeddings.token_embedding.weight"]),
            "position_embedding": _t(t["embeddings.position_embedding.weight"]),
            "layers": _encoder_layers(t, "encoder", cfg.text.num_layers),
            "final_ln": _ln(t, "final_layer_norm"),
            "head": _linear(t, "head"),
        },
        "vision_model": siglip_vision_from_torch(s, cfg.vision.num_layers),
    }
    # HF SigLIP stores these as shape-(1,) parameters: scalars here
    for name in ("logit_scale", "logit_bias"):
        if name in s:
            out[name] = _t(s[name]).reshape(())
    return out


def siglip_vision_from_torch(sd: Dict, num_layers: int, prefix: str = "vision_model.") -> dict:
    """A SigLIP vision tower (``SiglipVisionTransformer`` names under
    ``prefix``) -> its parameter tree."""
    v = _strip_prefix(sd, prefix)
    in_w = _t(v["head.attention.in_proj_weight"])  # (3d, d)
    in_b = _t(v["head.attention.in_proj_bias"])  # (3d,)
    d = in_w.shape[1]
    attn = {
        n: {"w": in_w[i * d : (i + 1) * d].t().contiguous(), "b": in_b[i * d : (i + 1) * d].clone()}
        for i, n in enumerate(("q", "k", "v"))
    }
    attn["o"] = _linear(v, "head.attention.out_proj")
    return {
        "patch_embedding": _conv_patch_embed(v, "embeddings.patch_embedding", bias=True),
        "position_embedding": _t(v["embeddings.position_embedding.weight"]),
        "layers": _encoder_layers(v, "encoder", num_layers),
        "post_ln": _ln(v, "post_layernorm"),
        "map_head": {
            "probe": _t(v["head.probe"]),
            "attn": attn,
            "ln": _ln(v, "head.layernorm"),
            "fc1": _linear(v, "head.mlp.fc1"),
            "fc2": _linear(v, "head.mlp.fc2"),
        },
    }


def siglip_vision_to_torch(sd: Dict, prefix: str, v, cfg: SigLIPVisionConfig) -> None:
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


def siglip_to_torch(bp, cfg: SigLIPConfig, prefix: str = "") -> Dict:
    """The inverse of ``siglip_params_from_torch``: HF names under
    ``prefix``, fp32 CPU tensors, ``logit_scale`` / ``logit_bias`` of shape
    (1,)."""
    sd: Dict = {}
    _text_out(sd, f"{prefix}text_model", bp["text_model"], head=True)
    siglip_vision_to_torch(sd, f"{prefix}vision_model", bp["vision_model"], cfg.vision)
    _top_level_out(sd, bp, prefix, scalar_logits=False)
    return sd
