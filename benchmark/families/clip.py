"""CLIP (``transformers.CLIPModel``) under the fusion head: a causal text
tower pooled at the first EOS, a ViT with a class token pooled there, and
bias-free projections to ``projection_dim``. The harness finds this file by
the configuration's ``family`` (``harness/spec.Family`` lists what it
gives)."""

from __future__ import annotations

import torch

from benchmark.flops.model import tower
from benchmark.harness import port, weights
from benchmark.reference.models import NEG, encoder, linear, ln, patches, quick_gelu


def backbone_spec(cfg) -> weights.Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    s: weights.Spec = []
    tp, vp = "backbone.text_model", "backbone.vision_model"
    s.append((f"{tp}.embeddings.token_embedding.weight", (t["vocab_size"], t["hidden_size"]),
              "normal", 0.02))
    s.append((f"{tp}.embeddings.position_embedding.weight",
              (t["max_position_embeddings"], t["hidden_size"]), "normal", 0.01))
    weights.add_encoder(s, tp, t)
    weights.add_ln(s, f"{tp}.final_layer_norm", t["hidden_size"])
    d, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{vp}.embeddings.class_embedding", (d,), "normal", 0.02))
    s.append((f"{vp}.embeddings.patch_embedding.weight", (d, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{vp}.embeddings.position_embedding.weight", (n + 1, d), "normal", 0.01))
    weights.add_ln(s, f"{vp}.pre_layrnorm", d)
    weights.add_encoder(s, vp, v)
    weights.add_ln(s, f"{vp}.post_layernorm", d)
    weights.add_linear(s, "backbone.text_projection", t["hidden_size"], cfg["projection_dim"],
                       bias=False)
    weights.add_linear(s, "backbone.visual_projection", d, cfg["projection_dim"], bias=False)
    s.append(("backbone.logit_scale", (), "const", 2.6592))
    return s


def feature_dim(cfg) -> int:
    return cfg["projection_dim"]


def features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features of ``transformers.CLIPModel``."""
    t, v = cfg["text_config"], cfg["vision_config"]
    T = ids.shape[1]
    pre = "backbone.text_model"
    x = P[f"{pre}.embeddings.token_embedding.weight"][ids] + \
        P[f"{pre}.embeddings.position_embedding.weight"][:T]
    bias = (1.0 - mask.float()) * NEG
    x = encoder(pr, x, P, f"{pre}.encoder", t["num_hidden_layers"], t["num_attention_heads"],
                quick_gelu, t["layer_norm_eps"], bias, causal=True)
    x = ln(x, P, f"{pre}.final_layer_norm", t["layer_norm_eps"])
    eos = torch.argmax((ids == t["eos_token_id"]).int(), dim=-1)
    tfeat = linear(pr, x[torch.arange(x.shape[0], device=x.device), eos], P,
                   "backbone.text_projection", bias=False)

    pre = "backbone.vision_model"
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=False)
    cls = P[f"{pre}.embeddings.class_embedding"].expand(y.shape[0], 1, -1)
    y = torch.cat([cls, y], dim=1) + P[f"{pre}.embeddings.position_embedding.weight"]
    y = ln(y, P, f"{pre}.pre_layrnorm", v["layer_norm_eps"])
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                quick_gelu, v["layer_norm_eps"])
    y = ln(y[:, 0], P, f"{pre}.post_layernorm", v["layer_norm_eps"])
    vfeat = linear(pr, y, P, "backbone.visual_projection", bias=False)
    return tfeat, vfeat


def vision_tokens(cfg) -> int:
    """The patches and the class token."""
    v = cfg["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def backbone_ops(cfg, text_tokens: int) -> float:
    """The patch embedding, both towers (the text tower causal) and the two
    projections."""
    t, v = cfg["text_config"], cfg["vision_config"]
    d = v["hidden_size"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    ops = 2 * n * v["num_channels"] * v["patch_size"] ** 2 * d
    ops += tower(vision_tokens(cfg), v)
    ops += tower(text_tokens, t, causal=True)
    return ops + 2 * (t["hidden_size"] + d) * cfg["projection_dim"]


def bucket_extra(cfg) -> int:
    """No column: the causal tower pooled at the first EOS never sees the
    columns a bucket drops."""
    return 0


port_names = port.port_names  # the shared encoder's names, nothing of its own
