"""SigLIP / SigLIP2 (fixed resolution) dual encoder over a parameter tree.

Semantics match HF ``transformers.SiglipModel``, as the JAX package's
``models/siglip.py`` does; the differences from CLIP:

- the vision tower has no class token, and its patch conv has a bias;
- vision pooling is a MAP head (a learned probe attending over the patch
  tokens, through the single-query branch of ``ops.layers.mha``);
- text pooling takes the last position's hidden state, then a linear head;
- the activation is tanh-approximate GELU and LayerNorm's eps is 1e-6;
- text attention is bidirectional with key padding (no causal mask).

The vision trunk starts from embedded patch tokens: the uint8 wire of
``models/u8wire.py`` embeds them on the card, the pixel path
(``siglip_vision_hidden``) patchifies normalised fp32 NCHW pixels and applies
the ``patch_embedding`` dense with its bias.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from multimodal_content_moderation_tpu_torch.models.clip import (
    _block_init,
    _dense_init,
    _ln_init,
    _normal,
)
from multimodal_content_moderation_tpu_torch.ops.cuda_attention import NEG_INF
from multimodal_content_moderation_tpu_torch.ops.layers import (
    ACTIVATIONS,
    dense,
    dense_maybe_int8,
    layer_norm,
    mha,
    patchify,
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


def siglip_vision_hidden(params, pixel_values: torch.Tensor, cfg: SigLIPVisionConfig) -> torch.Tensor:
    """Post-LN hidden states [B, N, D] of the SigLIP ViT from normalised
    [B, C, H, W] pixels, cast to the compute dtype before the patches."""
    patches = patchify(pixel_values.to(getattr(torch, cfg.compute_dtype)), cfg.patch_size)
    tokens = dense(patches, params["vision_model"]["patch_embedding"])
    return siglip_vision_encoder(params, tokens, cfg)


def siglip_image_features(params, pixel_values: torch.Tensor, cfg: SigLIPConfig) -> torch.Tensor:
    """= HF ``SiglipModel.get_image_features`` (MAP-head pooled)."""
    hidden = siglip_vision_hidden(params, pixel_values, cfg.vision)
    return _map_head(hidden, params["vision_model"]["map_head"], cfg.vision)
