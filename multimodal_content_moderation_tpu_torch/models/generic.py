"""Generic dual encoder over a parameter tree: the reference's ``AutoModel``
path for a ``VisionTextDualEncoderModel`` checkpoint (the JAX package's
``models/generic.py``).

- Text: post-LN BERT-style towers. ``bert``; the RoBERTa family
  (roberta, camembert, xlm-roberta) with HF RoBERTa's pad-aware position
  ids; ``distilbert`` with its own key names, no token-type embeddings and
  no pooler. Word + position (+ token type 0) embeddings -> LN, post-LN
  layers, an optional tanh pooler over the first position.
- Vision: pre-LN ViT towers (``transformer_block``) over embedded patch
  tokens (``models/u8wire.image_tokens``: the patch conv as one GEMM), a
  class token, learned positions, a final LN and an optional tanh pooler. At 224 px in 16-pixel patches the tower runs 197
  positions.

Pooling follows the reference's fallback: the pooler where the tower has
one, else the plain (unmasked) mean over the last hidden state. The
projected features apply the checkpoint's bias-free ``text_projection`` /
``visual_projection`` on the pooled output, as
``VisionTextDualEncoderModel.get_text_features`` does.

Training dropout (HF BERT / DistilBERT default 0.1) runs only when a
generator is passed: after the embedding LN, on the attention probabilities
(which sends the block to the non-kernel core), after the attention output
dense and after the MLP output dense. Under ``remat`` each block's draws
are replayed in the recompute (``ops.layers.checkpoint_replaying``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from multimodal_content_moderation_tpu_torch.models.params import (
    _conv_out,
    _f32,
    _linear,
    _linear_out,
    _ln,
    _ln_out,
    TOP_LEVEL,
    _t,
    _top_level_out,
)
from multimodal_content_moderation_tpu_torch.ops.layers import (
    ACTIVATIONS,
    add_layer_norm,
    checkpoint_replaying,
    dense,
    dense_maybe_int8,
    dropout,
    layer_norm,
    mha,
    transformer_block,
)
from multimodal_content_moderation_tpu_torch.parallel.collectives import vocab_parallel_lookup

# the generic towers' additive key bias for a padded position (JAX's)
NEG_INF = -1e9
# HF VisionTextDualEncoderConfig's defaults
VTDE_PROJECTION_DIM = 512
VTDE_LOGIT_SCALE = 2.6592
ROBERTA_FAMILY = ("roberta", "camembert", "xlm-roberta")


@dataclasses.dataclass(frozen=True)
class GenericTextConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2  # 0: the tower has no token-type embeddings
    pad_token_id: int = 0
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    arch: str = "bert"  # "bert" | "distilbert" (key names, no pooler)
    # "absolute": positions 0..T-1; "roberta": a non-pad token's position is
    # pad_token_id + its 1-based count of non-pad tokens, pads keep pad_token_id
    position_style: str = "absolute"
    pooling: str = "pooler"  # "pooler" | "mean" | "cls"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    compute_dtype: str = "float32"
    scores_dtype: str = "float32"
    attention_impl: str = "xla"
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class GenericVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    pooling: str = "pooler"  # "pooler" | "mean" | "cls"
    compute_dtype: str = "float32"
    scores_dtype: str = "float32"
    attention_impl: str = "xla"
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class GenericDualConfig:
    text: GenericTextConfig = GenericTextConfig()
    vision: GenericVisionConfig = GenericVisionConfig()
    # > 0: bias-free text / visual projections to this width (the
    # checkpoint's projection_dim); 0: the raw pooled towers
    projection_dim: int = 0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GenericDualConfig":
        """An HF ``config.json`` with ``text_config`` / ``vision_config`` of
        the supported tower families (bert, roberta family and distilbert
        text; vit vision)."""
        t = d.get("text_config", {})
        v = d.get("vision_config", {})
        t_type = t.get("model_type", "bert")
        v_type = v.get("model_type", "vit")
        if t_type not in ("bert", "distilbert") + ROBERTA_FAMILY:
            raise ValueError(
                f"generic backend: unsupported text tower model_type {t_type!r} "
                "(supported: bert/roberta/distilbert families; clip/siglip "
                "have dedicated backends)"
            )
        if v_type != "vit":
            raise ValueError(
                f"generic backend: unsupported vision tower model_type {v_type!r} "
                "(supported: vit; clip/siglip have dedicated backends)"
            )
        if (float(v.get("hidden_dropout_prob", 0.0)) > 0.0
                or float(v.get("attention_probs_dropout_prob", 0.0)) > 0.0):
            # the shared pre-LN block has no dropout: a nonzero rate would
            # train another function without a word
            raise ValueError(
                "generic backend: nonzero vision-tower dropout is not "
                "supported (HF ViT defaults are 0.0)"
            )
        if t_type == "distilbert":
            text = GenericTextConfig(
                vocab_size=t.get("vocab_size", 30522),
                hidden_size=t.get("dim", 768),
                num_layers=t.get("n_layers", 6),
                num_heads=t.get("n_heads", 12),
                intermediate_size=t.get("hidden_dim", 3072),
                max_positions=t.get("max_position_embeddings", 512),
                type_vocab_size=0,
                pad_token_id=t.get("pad_token_id", 0),
                hidden_act=t.get("activation", "gelu"),
                layer_norm_eps=1e-12,
                arch="distilbert",
                pooling="mean",
                hidden_dropout_prob=t.get("dropout", 0.1),
                attention_probs_dropout_prob=t.get("attention_dropout", 0.1),
            )
        else:
            roberta = t_type in ROBERTA_FAMILY
            text = GenericTextConfig(
                vocab_size=t.get("vocab_size", 30522),
                hidden_size=t.get("hidden_size", 768),
                num_layers=t.get("num_hidden_layers", 12),
                num_heads=t.get("num_attention_heads", 12),
                intermediate_size=t.get("intermediate_size", 3072),
                max_positions=t.get("max_position_embeddings", 512),
                type_vocab_size=t.get("type_vocab_size", 2),
                pad_token_id=t.get("pad_token_id", 1 if roberta else 0),
                hidden_act=t.get("hidden_act", "gelu"),
                layer_norm_eps=t.get("layer_norm_eps", 1e-12),
                position_style="roberta" if roberta else "absolute",
                hidden_dropout_prob=t.get("hidden_dropout_prob", 0.1),
                attention_probs_dropout_prob=t.get("attention_probs_dropout_prob", 0.1),
            )
        return GenericDualConfig(
            text=text,
            vision=GenericVisionConfig(
                hidden_size=v.get("hidden_size", 768),
                num_layers=v.get("num_hidden_layers", 12),
                num_heads=v.get("num_attention_heads", 12),
                intermediate_size=v.get("intermediate_size", 3072),
                image_size=v.get("image_size", 224),
                patch_size=v.get("patch_size", 16),
                num_channels=v.get("num_channels", 3),
                hidden_act=v.get("hidden_act", "gelu"),
                layer_norm_eps=v.get("layer_norm_eps", 1e-12),
            ),
            projection_dim=d.get("projection_dim", 0) or 0,
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(g, shape, dtype, std):
    return torch.randn(shape, generator=g, dtype=dtype, device=g.device) * std


def _linear_init(g, d_in, d_out, dtype):
    scale = d_in ** -0.5
    w = (torch.rand((d_in, d_out), generator=g, dtype=dtype, device=g.device) * 2 - 1) * scale
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=g.device)}


def _ln_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def _layer_init(g, d, inter, dtype):
    return {
        "ln1": _ln_init(d, dtype, g.device),
        "attn": {n: _linear_init(g, d, d, dtype) for n in ("q", "k", "v", "o")},
        "ln2": _ln_init(d, dtype, g.device),
        "fc1": _linear_init(g, d, inter, dtype),
        "fc2": _linear_init(g, inter, d, dtype),
    }


def generic_init(g: torch.Generator, cfg: GenericDualConfig, dtype=torch.float32) -> dict:
    """Random-init a generic parameter tree on ``g.device`` (the JAX
    package's distributions and tree, other numbers): embeddings N(0, 0.02),
    linears U(+-1/sqrt(in)) with zero bias, the poolers where the config
    pools with them, the projections and ``logit_scale`` where
    ``projection_dim`` > 0."""
    t, v = cfg.text, cfg.vision
    n_patches = (v.image_size // v.patch_size) ** 2
    text_model = {
        "word_embeddings": _normal(g, (t.vocab_size, t.hidden_size), dtype, 0.02),
        "position_embeddings": _normal(g, (t.max_positions, t.hidden_size), dtype, 0.02),
        "emb_ln": _ln_init(t.hidden_size, dtype, g.device),
        "layers": [_layer_init(g, t.hidden_size, t.intermediate_size, dtype)
                   for _ in range(t.num_layers)],
    }
    if t.type_vocab_size:
        text_model["token_type_embeddings"] = _normal(
            g, (t.type_vocab_size, t.hidden_size), dtype, 0.02)
    if t.pooling == "pooler":
        text_model["pooler"] = _linear_init(g, t.hidden_size, t.hidden_size, dtype)
    vision_model = {
        "cls_token": _normal(g, (1, 1, v.hidden_size), dtype, 0.02),
        "position_embeddings": _normal(g, (n_patches + 1, v.hidden_size), dtype, 0.02),
        "patch_embedding": _linear_init(
            g, v.num_channels * v.patch_size * v.patch_size, v.hidden_size, dtype),
        "layers": [_layer_init(g, v.hidden_size, v.intermediate_size, dtype)
                   for _ in range(v.num_layers)],
        "post_ln": _ln_init(v.hidden_size, dtype, g.device),
    }
    if v.pooling == "pooler":
        vision_model["pooler"] = _linear_init(g, v.hidden_size, v.hidden_size, dtype)
    params = {"text_model": text_model, "vision_model": vision_model}
    if cfg.projection_dim:
        params["text_projection"] = {
            "w": _normal(g, (t.hidden_size, cfg.projection_dim), dtype, 0.02)}
        params["visual_projection"] = {
            "w": _normal(g, (v.hidden_size, cfg.projection_dim), dtype, 0.02)}
        # VisionTextDualEncoderModel's logit_scale (init 2.6592): the heads
        # do not use it; kept so checkpoints round-trip
        params["logit_scale"] = torch.tensor(2.6592, dtype=dtype, device=g.device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _postln_block(x, p, cfg: GenericTextConfig, key_mask, generator=None):
    """BERT-style post-LN layer: attention -> + residual -> LN, MLP ->
    + residual -> LN (HF ``BertLayer``). With a ``generator`` the three HF
    dropout sites draw in this order: the attention probabilities, the
    attention output dense, the MLP output dense."""

    def block(x, g):
        attn = mha(
            x, x, p["attn"], cfg.num_heads,
            impl=cfg.attention_impl, scores_dtype=cfg.scores_dtype, key_mask=key_mask,
            probs_dropout=cfg.attention_probs_dropout_prob, generator=g,
        )
        attn = dropout(attn, cfg.hidden_dropout_prob, g)
        x = add_layer_norm(x, attn, p["ln1"], cfg.layer_norm_eps)[1]
        y = ACTIVATIONS[cfg.hidden_act](dense_maybe_int8(x, p["fc1"]))
        y = dropout(dense(y, p["fc2"]), cfg.hidden_dropout_prob, g)
        return add_layer_norm(x, y, p["ln2"], cfg.layer_norm_eps)[1]

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint_replaying(block, x, generator)
    return block(x, generator)


def _pool(hidden: torch.Tensor, p, pooling: str) -> torch.Tensor:
    """The reference's pooling fallback, in fp32: the tanh pooler over the
    first position where the tower has one; else the first position
    ("cls"), or the plain mean over every position, pads included (a config
    that says "pooler" over a tower converted without one falls back to the
    mean, the reference's ``pooler_output is None`` branch)."""
    if pooling == "pooler" and "pooler" in p:
        return torch.tanh(dense(hidden[:, 0], p["pooler"])).float()
    if pooling == "cls":
        return hidden[:, 0].float()
    return hidden.mean(dim=1).float()


def key_mask_from(attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, T] 0/1 attention mask -> additive fp32 key bias (or None)."""
    if attention_mask is None:
        return None
    return (attention_mask.float() - 1.0) * -NEG_INF


def generic_text_hidden(
    params, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor],
    cfg: GenericTextConfig, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """BERT-style tower -> last hidden state [B, T, D]. A ``generator``
    turns on HF's training dropout (the embedding output, then each
    layer's three sites); without one the tower is deterministic."""
    p = params["text_model"]
    ids = input_ids.long()
    T = ids.shape[1]
    if cfg.position_style == "roberta":
        nonpad = (ids != cfg.pad_token_id).long()
        pos = p["position_embeddings"][torch.cumsum(nonpad, dim=1) * nonpad + cfg.pad_token_id]
    else:
        pos = p["position_embeddings"][:T][None]
    x = vocab_parallel_lookup(p["word_embeddings"], ids) + pos
    if "token_type_embeddings" in p:
        x = x + p["token_type_embeddings"][0][None, None]
    x = layer_norm(x.to(getattr(torch, cfg.compute_dtype)), p["emb_ln"], cfg.layer_norm_eps)
    x = dropout(x, cfg.hidden_dropout_prob, generator)
    key_mask = key_mask_from(attention_mask)
    for layer in p["layers"]:
        x = _postln_block(x, layer, cfg, key_mask, generator)
    return x


def generic_text_pooled(params, input_ids, attention_mask, cfg: GenericTextConfig,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    hidden = generic_text_hidden(params, input_ids, attention_mask, cfg, generator)
    return _pool(hidden, params["text_model"], cfg.pooling)


def _with_class_token(params, tokens: torch.Tensor, cfg: GenericVisionConfig):
    """Embedded patch tokens [B, N, D] -> the trunk's input [B, 1+N, D]: the
    class token in front, the learned positions added."""
    p = params["vision_model"]
    cls = p["cls_token"].to(tokens.dtype).expand(tokens.shape[0], 1, cfg.hidden_size)
    return torch.cat([cls, tokens], dim=1) + p["position_embeddings"].to(tokens.dtype)[None]


def generic_vision_hidden_from_tokens(params, x: torch.Tensor,
                                      cfg: GenericVisionConfig) -> torch.Tensor:
    """The trunk's input [B, 1+N, D] -> the final-LN'd hidden states: pre-LN
    blocks, final LN."""
    p = params["vision_model"]
    for layer in p["layers"]:
        x = transformer_block(
            x, layer, cfg.num_heads, cfg.hidden_act, None, cfg.layer_norm_eps,
            remat=cfg.remat, attention_impl=cfg.attention_impl, scores_dtype=cfg.scores_dtype,
        )
    return layer_norm(x, p["post_ln"], cfg.layer_norm_eps)


def generic_vision_pooled_from_tokens(params, tokens, cfg: GenericVisionConfig) -> torch.Tensor:
    """Pooled ViT features from embedded patch tokens [B, N, D]."""
    hidden = generic_vision_hidden_from_tokens(params, _with_class_token(params, tokens, cfg),
                                               cfg)
    return _pool(hidden, params["vision_model"], cfg.pooling)


def _project(pooled: torch.Tensor, proj) -> torch.Tensor:
    return pooled if proj is None else pooled @ proj["w"].to(pooled.dtype)


def generic_text_features(params, input_ids, attention_mask, cfg: GenericDualConfig,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """= ``get_text_features``: the pooled tower, then the checkpoint's
    bias-free text projection where it has one."""
    pooled = generic_text_pooled(params, input_ids, attention_mask, cfg.text, generator)
    return _project(pooled, params["text_projection"] if "text_projection" in params else None)


def generic_image_features_from_tokens(params, tokens, cfg: GenericDualConfig) -> torch.Tensor:
    """= ``get_image_features`` from embedded patch tokens."""
    pooled = generic_vision_pooled_from_tokens(params, tokens, cfg.vision)
    return _project(pooled,
                    params["visual_projection"] if "visual_projection" in params else None)


# ---------------------------------------------------------------------------
# Torch checkpoint conversion (VisionTextDualEncoderModel / bare towers)
# ---------------------------------------------------------------------------


def bert_tower_from_torch(sd, cfg: GenericTextConfig, prefix: str = "text_model.") -> dict:
    """HF ``BertModel`` / ``RobertaModel`` state dict -> the post-LN tower."""
    p = prefix
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        layers.append({
            "attn": {
                "q": _linear(sd, lp + "attention.self.query"),
                "k": _linear(sd, lp + "attention.self.key"),
                "v": _linear(sd, lp + "attention.self.value"),
                "o": _linear(sd, lp + "attention.output.dense"),
            },
            "ln1": _ln(sd, lp + "attention.output.LayerNorm"),
            "fc1": _linear(sd, lp + "intermediate.dense"),
            "fc2": _linear(sd, lp + "output.dense"),
            "ln2": _ln(sd, lp + "output.LayerNorm"),
        })
    out = {
        "word_embeddings": _t(sd[f"{p}embeddings.word_embeddings.weight"]),
        "position_embeddings": _t(sd[f"{p}embeddings.position_embeddings.weight"]),
        "emb_ln": _ln(sd, f"{p}embeddings.LayerNorm"),
        "layers": layers,
    }
    if f"{p}embeddings.token_type_embeddings.weight" in sd:
        out["token_type_embeddings"] = _t(sd[f"{p}embeddings.token_type_embeddings.weight"])
    if f"{p}pooler.dense.weight" in sd:
        out["pooler"] = _linear(sd, f"{p}pooler.dense")
    return out


def distilbert_tower_from_torch(sd, cfg: GenericTextConfig,
                                prefix: str = "text_model.") -> dict:
    """HF ``DistilBertModel`` state dict -> the post-LN tower: BERT's block
    under other names (``transformer.layer.i.{attention.{q,k,v,out}_lin,
    sa_layer_norm, ffn.{lin1,lin2}, output_layer_norm}``), no token-type
    embeddings, no pooler."""
    p = prefix
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}transformer.layer.{i}."
        layers.append({
            "attn": {
                "q": _linear(sd, lp + "attention.q_lin"),
                "k": _linear(sd, lp + "attention.k_lin"),
                "v": _linear(sd, lp + "attention.v_lin"),
                "o": _linear(sd, lp + "attention.out_lin"),
            },
            "ln1": _ln(sd, lp + "sa_layer_norm"),
            "fc1": _linear(sd, lp + "ffn.lin1"),
            "fc2": _linear(sd, lp + "ffn.lin2"),
            "ln2": _ln(sd, lp + "output_layer_norm"),
        })
    return {
        "word_embeddings": _t(sd[f"{p}embeddings.word_embeddings.weight"]),
        "position_embeddings": _t(sd[f"{p}embeddings.position_embeddings.weight"]),
        "emb_ln": _ln(sd, f"{p}embeddings.LayerNorm"),
        "layers": layers,
    }


def vit_tower_from_torch(sd, cfg: GenericVisionConfig, prefix: str = "vision_model.") -> dict:
    """HF ``ViTModel`` state dict -> the pre-LN tower. The patch conv
    ``[D, C, p, p]`` becomes a dense ``[C*p*p, D]`` over ``patchify``'s
    channel-major rows."""
    p = prefix
    w = _t(sd[f"{p}embeddings.patch_embeddings.projection.weight"])
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        layers.append({
            "ln1": _ln(sd, lp + "layernorm_before"),
            "attn": {
                "q": _linear(sd, lp + "attention.attention.query"),
                "k": _linear(sd, lp + "attention.attention.key"),
                "v": _linear(sd, lp + "attention.attention.value"),
                "o": _linear(sd, lp + "attention.output.dense"),
            },
            "ln2": _ln(sd, lp + "layernorm_after"),
            "fc1": _linear(sd, lp + "intermediate.dense"),
            "fc2": _linear(sd, lp + "output.dense"),
        })
    out = {
        "cls_token": _t(sd[f"{p}embeddings.cls_token"]),
        "position_embeddings": _t(sd[f"{p}embeddings.position_embeddings"])[0],
        "patch_embedding": {
            "w": w.reshape(w.shape[0], -1).t().contiguous(),
            "b": _t(sd[f"{p}embeddings.patch_embeddings.projection.bias"]),
        },
        "layers": layers,
        "post_ln": _ln(sd, f"{p}layernorm"),
    }
    if f"{p}pooler.dense.weight" in sd:
        out["pooler"] = _linear(sd, f"{p}pooler.dense")
    return out


def generic_params_from_torch(sd, cfg: GenericDualConfig, prefix: str = "") -> dict:
    """``VisionTextDualEncoderModel`` state dict (or the same names under
    ``prefix``) -> the parameter tree, with the projections and
    ``logit_scale`` where the checkpoint has them."""
    text_fn = distilbert_tower_from_torch if cfg.text.arch == "distilbert" else bert_tower_from_torch
    params = {
        "text_model": text_fn(sd, cfg.text, f"{prefix}text_model."),
        "vision_model": vit_tower_from_torch(sd, cfg.vision, f"{prefix}vision_model."),
    }
    for name in ("text_projection", "visual_projection"):
        if f"{prefix}{name}.weight" in sd:
            params[name] = {"w": _t(sd[f"{prefix}{name}.weight"]).t().contiguous()}
    if f"{prefix}logit_scale" in sd:
        params["logit_scale"] = _t(sd[f"{prefix}logit_scale"]).reshape(())
    return params


def generic_bare_from_torch(sd, cfg: GenericDualConfig) -> dict:
    """The multi-task checkpoint's ``backbone.*`` without its projections
    and ``logit_scale``: the multi-task model pools the raw towers."""
    params = generic_params_from_torch(sd, cfg, prefix="backbone.")
    for name in TOP_LEVEL:
        params.pop(name, None)
    return params


def _bert_text_out(sd, prefix: str, t, arch: str) -> None:
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


def _vit_vision_out(sd, prefix: str, v, cfg: GenericVisionConfig) -> None:
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


def generic_to_torch(bp, cfg: GenericDualConfig, prefix: str = "") -> Dict:
    """The inverse of ``generic_params_from_torch``: HF names under
    ``prefix``, fp32 CPU tensors."""
    sd: Dict = {}
    _bert_text_out(sd, f"{prefix}text_model", bp["text_model"], cfg.text.arch)
    _vit_vision_out(sd, f"{prefix}vision_model", bp["vision_model"], cfg.vision)
    _top_level_out(sd, bp, prefix, scalar_logits=True)
    return sd


def generic_bare_to_torch(bp, cfg: GenericDualConfig, encoder_json=None) -> Dict:
    """A multi-task model's bare towers under ``backbone.``, with the three
    leaves its forward never reads: the reference's generic multi-task
    model holds a whole ``VisionTextDualEncoderModel``, so its strict load
    wants them (the JAX package's export drops them and that load fails).
    Zero projections to ``projection_dim`` and ``logit_scale`` from
    ``encoder_json`` (the encoder's ``config.json``), else from the config
    and HF's defaults: no logit changes."""
    sd = generic_to_torch(bp, cfg, "backbone.")
    enc = encoder_json or {}
    dim = enc.get("projection_dim") or cfg.projection_dim or VTDE_PROJECTION_DIM
    for name, width in (("text_projection", cfg.text.hidden_size),
                        ("visual_projection", cfg.vision.hidden_size)):
        sd.setdefault(f"backbone.{name}.weight", torch.zeros(dim, width))
    sd.setdefault("backbone.logit_scale", torch.tensor(
        float(enc.get("logit_scale_init_value", VTDE_LOGIT_SCALE))))
    return sd
