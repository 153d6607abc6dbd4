"""A third model family for the harness's test of adding one as files
alone: Hugging Face's ``VisionTextDualEncoderModel`` of a post-LN BERT text
tower (word, position and token-type embeddings, a tanh pooler over the
first position) and a ViT (a class token, a tanh pooler over it), each
projected without a bias, which the port runs as its ``generic`` backend.
It gives what a scoring cell needs; a function it lacks fails by name."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.harness import weights
from benchmark.reference.models import NEG, linear, ln, patches

BACKEND = "generic"


def _bert_layer(s, b, d, f):
    for p in ("query", "key", "value"):
        weights.add_linear(s, f"{b}.attention.self.{p}", d, d)
    weights.add_linear(s, f"{b}.attention.output.dense", d, d)
    weights.add_ln(s, f"{b}.attention.output.LayerNorm", d)
    weights.add_linear(s, f"{b}.intermediate.dense", d, f)
    weights.add_linear(s, f"{b}.output.dense", f, d)
    weights.add_ln(s, f"{b}.output.LayerNorm", d)


def _vit_layer(s, b, d, f):
    weights.add_ln(s, f"{b}.layernorm_before", d)
    for p in ("query", "key", "value"):
        weights.add_linear(s, f"{b}.attention.attention.{p}", d, d)
    weights.add_linear(s, f"{b}.attention.output.dense", d, d)
    weights.add_ln(s, f"{b}.layernorm_after", d)
    weights.add_linear(s, f"{b}.intermediate.dense", d, f)
    weights.add_linear(s, f"{b}.output.dense", f, d)


def backbone_spec(cfg) -> weights.Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    s: weights.Spec = []
    e, D = "backbone.text_model.embeddings", t["hidden_size"]
    s.append((f"{e}.word_embeddings.weight", (t["vocab_size"], D), "normal", 0.02))
    s.append((f"{e}.position_embeddings.weight", (t["max_position_embeddings"], D), "normal",
              0.01))
    s.append((f"{e}.token_type_embeddings.weight", (t["type_vocab_size"], D), "normal", 0.02))
    weights.add_ln(s, f"{e}.LayerNorm", D)
    for i in range(t["num_hidden_layers"]):
        _bert_layer(s, f"backbone.text_model.encoder.layer.{i}", D, t["intermediate_size"])
    weights.add_linear(s, "backbone.text_model.pooler.dense", D, D)
    e, d = "backbone.vision_model.embeddings", v["hidden_size"]
    p, c = v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{e}.cls_token", (1, 1, d), "normal", 0.02))
    s.append((f"{e}.position_embeddings", (1, n + 1, d), "normal", 0.01))
    s.append((f"{e}.patch_embeddings.projection.weight", (d, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{e}.patch_embeddings.projection.bias", (d,), "normal", 0.02))
    for i in range(v["num_hidden_layers"]):
        _vit_layer(s, f"backbone.vision_model.encoder.layer.{i}", d, v["intermediate_size"])
    weights.add_ln(s, "backbone.vision_model.layernorm", d)
    weights.add_linear(s, "backbone.vision_model.pooler.dense", d, d)
    weights.add_linear(s, "backbone.text_projection", D, cfg["projection_dim"], bias=False)
    weights.add_linear(s, "backbone.visual_projection", d, cfg["projection_dim"], bias=False)
    s.append(("backbone.logit_scale", (), "const", 2.6592))
    return s


def feature_dim(cfg) -> int:
    return cfg["projection_dim"]


def bucket_extra(cfg) -> int:
    """The port runs this backend at the full text width."""
    return 0


def _attention(pr, x, P, qkv, out, heads, bias=None):
    B, T, D = x.shape
    dh = D // heads
    q, k, v = (linear(pr, x, P, f"{qkv}.{n}").view(B, T, heads, dh).transpose(1, 2)
               for n in ("query", "key", "value"))
    s = pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    if bias is not None:
        s = s + bias[:, None, None, :]
    o = pr.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, T, D)
    return linear(pr, o, P, out)


def _pool(pr, x, P, name):
    """The tanh pooler over the first position."""
    return torch.tanh(linear(pr, x[:, 0], P, name))


def features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features of ``VisionTextDualEncoderModel``:
    ``get_text_features`` and ``get_image_features``."""
    t, v = cfg["text_config"], cfg["vision_config"]
    eps, heads = t["layer_norm_eps"], t["num_attention_heads"]
    e = "backbone.text_model.embeddings"
    x = P[f"{e}.word_embeddings.weight"][ids] + \
        P[f"{e}.position_embeddings.weight"][:ids.shape[1]] + \
        P[f"{e}.token_type_embeddings.weight"][0]
    x = ln(x, P, f"{e}.LayerNorm", eps)
    bias = (1.0 - mask.float()) * NEG
    for i in range(t["num_hidden_layers"]):
        b = f"backbone.text_model.encoder.layer.{i}"
        a = _attention(pr, x, P, f"{b}.attention.self", f"{b}.attention.output.dense", heads,
                       bias)
        x = ln(x + a, P, f"{b}.attention.output.LayerNorm", eps)
        y = linear(pr, F.gelu(linear(pr, x, P, f"{b}.intermediate.dense")), P,
                   f"{b}.output.dense")
        x = ln(x + y, P, f"{b}.output.LayerNorm", eps)
    tfeat = linear(pr, _pool(pr, x, P, "backbone.text_model.pooler.dense"), P,
                   "backbone.text_projection", bias=False)

    eps, heads = v["layer_norm_eps"], v["num_attention_heads"]
    e = "backbone.vision_model.embeddings"
    y = patches(pr, pixels, P, f"{e}.patch_embeddings.projection", v["patch_size"], bias=True)
    cls = P[f"{e}.cls_token"].expand(y.shape[0], 1, -1)
    y = torch.cat([cls, y], dim=1) + P[f"{e}.position_embeddings"]
    for i in range(v["num_hidden_layers"]):
        b = f"backbone.vision_model.encoder.layer.{i}"
        h = ln(y, P, f"{b}.layernorm_before", eps)
        y = y + _attention(pr, h, P, f"{b}.attention.attention", f"{b}.attention.output.dense",
                           heads)
        h = ln(y, P, f"{b}.layernorm_after", eps)
        y = y + linear(pr, F.gelu(linear(pr, h, P, f"{b}.intermediate.dense")), P,
                       f"{b}.output.dense")
    y = ln(y, P, "backbone.vision_model.layernorm", eps)
    vfeat = linear(pr, _pool(pr, y, P, "backbone.vision_model.pooler.dense"), P,
                   "backbone.visual_projection", bias=False)
    return tfeat, vfeat
