"""SigLIP and SigLIP2 (``transformers.SiglipModel``) under the fusion head:
a bidirectional text tower pooled at its last position through a dense
head, and a ViT without a class token pooled by its MAP head (a learned
probe attending over the patches, then an MLP). The harness finds this file
by the configuration's ``family`` (``harness/spec.Family`` lists what it
gives)."""

from __future__ import annotations

import re

import torch

from benchmark.flops.model import tower
from benchmark.harness import port, weights
from benchmark.reference.models import NEG, encoder, gelu_tanh, linear, ln, patches


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
    weights.add_linear(s, f"{tp}.head", t["hidden_size"], t["projection_size"])
    d, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{vp}.embeddings.patch_embedding.weight", (d, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{vp}.embeddings.patch_embedding.bias", (d,), "normal", 0.02))
    s.append((f"{vp}.embeddings.position_embedding.weight", (n, d), "normal", 0.01))
    weights.add_encoder(s, vp, v)
    weights.add_ln(s, f"{vp}.post_layernorm", d)
    h = f"{vp}.head"
    s.append((f"{h}.probe", (1, 1, d), "normal", 0.02))
    s.append((f"{h}.attention.in_proj_weight", (3 * d, d), "normal", d ** -0.5))
    s.append((f"{h}.attention.in_proj_bias", (3 * d,), "normal", 0.02))
    weights.add_linear(s, f"{h}.attention.out_proj", d, d)
    weights.add_ln(s, f"{h}.layernorm", d)
    weights.add_linear(s, f"{h}.mlp.fc1", d, v["intermediate_size"])
    weights.add_linear(s, f"{h}.mlp.fc2", v["intermediate_size"], d)
    s.append(("backbone.logit_scale", (1,), "const", 1.0))
    s.append(("backbone.logit_bias", (1,), "const", 0.0))
    return s


def feature_dim(cfg) -> int:
    return cfg["text_config"]["projection_size"]


def features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features of ``transformers.SiglipModel``: the text
    tower's last position through its head; the vision tower's MAP head."""
    t, v = cfg["text_config"], cfg["vision_config"]
    T = ids.shape[1]
    pre = "backbone.text_model"
    x = P[f"{pre}.embeddings.token_embedding.weight"][ids] + \
        P[f"{pre}.embeddings.position_embedding.weight"][:T]
    bias = (1.0 - mask.float()) * NEG
    x = encoder(pr, x, P, f"{pre}.encoder", t["num_hidden_layers"], t["num_attention_heads"],
                gelu_tanh, t["layer_norm_eps"], bias)
    x = ln(x, P, f"{pre}.final_layer_norm", t["layer_norm_eps"])
    tfeat = linear(pr, x[:, -1], P, f"{pre}.head")

    pre = "backbone.vision_model"
    eps = v["layer_norm_eps"]
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=True)
    y = y + P[f"{pre}.embeddings.position_embedding.weight"]
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                gelu_tanh, eps)
    y = ln(y, P, f"{pre}.post_layernorm", eps)
    # the MAP head: nn.MultiheadAttention with a learned probe as the query
    h = f"{pre}.head"
    D = y.shape[-1]
    w_in, b_in = P[f"{h}.attention.in_proj_weight"], P[f"{h}.attention.in_proj_bias"]
    probe = P[f"{h}.probe"].expand(y.shape[0], 1, D)
    heads = v["num_attention_heads"]
    dh = D // heads
    B, N = y.shape[0], y.shape[1]
    q = (pr.mm(probe, w_in[:D].t()) + b_in[:D]).view(B, 1, heads, dh).transpose(1, 2)
    k = (pr.mm(y, w_in[D:2 * D].t()) + b_in[D:2 * D]).view(B, N, heads, dh).transpose(1, 2)
    vv = (pr.mm(y, w_in[2 * D:].t()) + b_in[2 * D:]).view(B, N, heads, dh).transpose(1, 2)
    w = torch.softmax(pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    a = pr.mm(w, vv).transpose(1, 2).reshape(B, 1, D)
    a = linear(pr, a, P, f"{h}.attention.out_proj")
    z = ln(a, P, f"{h}.layernorm", eps)
    z = linear(pr, gelu_tanh(linear(pr, z, P, f"{h}.mlp.fc1")), P, f"{h}.mlp.fc2")
    return tfeat, (a + z)[:, 0]


def vision_tokens(cfg) -> int:
    """The patches; no class token."""
    v = cfg["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2


def backbone_ops(cfg, text_tokens: int) -> float:
    """The patch embedding, both towers, the MAP head (one query over the
    patches, its projections and MLP) and the text head."""
    t, v = cfg["text_config"], cfg["vision_config"]
    d = v["hidden_size"]
    n = vision_tokens(cfg)
    ops = 2 * n * v["num_channels"] * v["patch_size"] ** 2 * d
    ops += tower(n, v)
    ops += tower(text_tokens, t)
    ops += 2 * (d * d + 2 * n * d * d + d * d + 2 * d * v["intermediate_size"])
    ops += 4 * n * d
    return ops + 2 * t["hidden_size"] * t["projection_size"]


def bucket_extra(cfg) -> int:
    """The carry column: the tower pools the last column, which a bucket
    keeps as a pad at the full width's last position."""
    return 1


# the MAP head's names; its packed q/k/v projection is three port leaves
_MAP_RULES = [
    (r"vision_model\.head\.probe$", "vision_model.map_head.probe"),
    (r"vision_model\.head\.attention\.out_proj\.", "vision_model.map_head.attn.o."),
    (r"vision_model\.head\.layernorm\.", "vision_model.map_head.ln."),
    (r"vision_model\.head\.mlp\.", "vision_model.map_head."),
]


def port_names(hf_name: str):
    m = re.match(r"(.*vision_model)\.head\.attention\.in_proj_(weight|bias)$", hf_name)
    if m:
        base = m.group(1) + ".map_head.attn"
        leaf = "w" if m.group(2) == "weight" else "b"
        return [f"{base}.{x}.{leaf}" for x in ("q", "k", "v")]
    return port.port_names(hf_name, _MAP_RULES)
