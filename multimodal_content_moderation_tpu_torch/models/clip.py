"""CLIP dual encoder (text transformer + ViT trunk) over a parameter tree.

Semantics match HF ``transformers.CLIPModel``, as the JAX package's
``models/clip.py`` does: causal text tower pooled at the first EOS, ViT
with a CLS token, pre-LN and post-LN on the CLS token, and both
projections. The vision trunk starts from embedded patch tokens: the
uint8 wire path of ``models/u8wire.py`` embeds them on the card, the pixel
path (``clip_vision_hidden``) patchifies normalised fp32 NCHW pixels and
applies the ``patch_embedding`` dense.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from multimodal_content_moderation_tpu_torch.ops.cuda_attention import NEG_INF
from multimodal_content_moderation_tpu_torch.ops.layers import (
    dense,
    layer_norm,
    patchify,
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

    @staticmethod
    def from_hf(cfg) -> "CLIPConfig":
        """Build from a ``transformers.CLIPConfig``."""
        t, v = cfg.text_config, cfg.vision_config
        return CLIPConfig(
            text=CLIPTextConfig(
                vocab_size=t.vocab_size,
                hidden_size=t.hidden_size,
                num_layers=t.num_hidden_layers,
                num_heads=t.num_attention_heads,
                intermediate_size=t.intermediate_size,
                max_positions=t.max_position_embeddings,
                eos_token_id=t.eos_token_id,
                hidden_act=t.hidden_act,
                layer_norm_eps=t.layer_norm_eps,
            ),
            vision=CLIPVisionConfig(
                hidden_size=v.hidden_size,
                num_layers=v.num_hidden_layers,
                num_heads=v.num_attention_heads,
                intermediate_size=v.intermediate_size,
                image_size=v.image_size,
                patch_size=v.patch_size,
                num_channels=v.num_channels,
                hidden_act=v.hidden_act,
                layer_norm_eps=v.layer_norm_eps,
            ),
            projection_dim=cfg.projection_dim,
        )


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


def clip_vision_hidden(params, pixel_values: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """Hidden states [B, 1+N, D] of the ViT (before post-LN) from normalised
    [B, C, H, W] pixels, cast to the compute dtype before the patches."""
    patches = patchify(pixel_values.to(getattr(torch, cfg.compute_dtype)), cfg.patch_size)
    tokens = dense(patches, params["vision_model"]["patch_embedding"])
    return clip_vision_encoder(params, tokens, cfg)


def clip_vision_pooled(params, pixel_values: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """Post-LN of the CLS token (= HF ``CLIPVisionModel.pooler_output``)."""
    x = clip_vision_hidden(params, pixel_values, cfg)
    return layer_norm(x[:, 0], params["vision_model"]["post_ln"], cfg.layer_norm_eps)


def clip_image_features(params, pixel_values: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """= HF ``CLIPModel.get_image_features`` (pooled -> visual_projection)."""
    pooled = clip_vision_pooled(params, pixel_values, cfg.vision)
    return dense(pooled, params["visual_projection"])
