"""Random weights of a configuration in the reference (Hugging Face) layout,
drawn on the device from the run's seed: one normal draw for the whole model
in a single call, cut into leaves and scaled in place (dense weights by
1/sqrt(fan in), embeddings by 0.02, LayerNorm scales around 1, biases
small), in the dtype the cell runs them in. The same seed gives the same
weights, so the reference draws them again after the window instead of
keeping a copy beside the program's."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, kind, scale


def _ln(spec, name, d):
    spec += [(f"{name}.weight", (d,), "ones", 0.02), (f"{name}.bias", (d,), "normal", 0.02)]


def _linear(spec, name, d_in, d_out, bias=True):
    spec.append((f"{name}.weight", (d_out, d_in), "normal", d_in ** -0.5))
    if bias:
        spec.append((f"{name}.bias", (d_out,), "normal", 0.02))


def _encoder(spec, prefix, c):
    d, f = c["hidden_size"], c["intermediate_size"]
    for i in range(c["num_hidden_layers"]):
        b = f"{prefix}.encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{b}.self_attn.{p}", d, d)
        _ln(spec, f"{b}.layer_norm1", d)
        _linear(spec, f"{b}.mlp.fc1", d, f)
        _linear(spec, f"{b}.mlp.fc2", f, d)
        _ln(spec, f"{b}.layer_norm2", d)


def clip_spec(cfg) -> Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    s: Spec = []
    tp, vp = "backbone.text_model", "backbone.vision_model"
    s.append((f"{tp}.embeddings.token_embedding.weight", (t["vocab_size"], t["hidden_size"]),
              "normal", 0.02))
    s.append((f"{tp}.embeddings.position_embedding.weight",
              (t["max_position_embeddings"], t["hidden_size"]), "normal", 0.01))
    _encoder(s, tp, t)
    _ln(s, f"{tp}.final_layer_norm", t["hidden_size"])
    d, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{vp}.embeddings.class_embedding", (d,), "normal", 0.02))
    s.append((f"{vp}.embeddings.patch_embedding.weight", (d, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{vp}.embeddings.position_embedding.weight", (n + 1, d), "normal", 0.01))
    _ln(s, f"{vp}.pre_layrnorm", d)
    _encoder(s, vp, v)
    _ln(s, f"{vp}.post_layernorm", d)
    _linear(s, "backbone.text_projection", t["hidden_size"], cfg["projection_dim"], bias=False)
    _linear(s, "backbone.visual_projection", d, cfg["projection_dim"], bias=False)
    s.append(("backbone.logit_scale", (), "const", 2.6592))
    return s


def siglip_spec(cfg) -> Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    s: Spec = []
    tp, vp = "backbone.text_model", "backbone.vision_model"
    s.append((f"{tp}.embeddings.token_embedding.weight", (t["vocab_size"], t["hidden_size"]),
              "normal", 0.02))
    s.append((f"{tp}.embeddings.position_embedding.weight",
              (t["max_position_embeddings"], t["hidden_size"]), "normal", 0.01))
    _encoder(s, tp, t)
    _ln(s, f"{tp}.final_layer_norm", t["hidden_size"])
    _linear(s, f"{tp}.head", t["hidden_size"], t["projection_size"])
    d, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{vp}.embeddings.patch_embedding.weight", (d, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{vp}.embeddings.patch_embedding.bias", (d,), "normal", 0.02))
    s.append((f"{vp}.embeddings.position_embedding.weight", (n, d), "normal", 0.01))
    _encoder(s, vp, v)
    _ln(s, f"{vp}.post_layernorm", d)
    h = f"{vp}.head"
    s.append((f"{h}.probe", (1, 1, d), "normal", 0.02))
    s.append((f"{h}.attention.in_proj_weight", (3 * d, d), "normal", d ** -0.5))
    s.append((f"{h}.attention.in_proj_bias", (3 * d,), "normal", 0.02))
    _linear(s, f"{h}.attention.out_proj", d, d)
    _ln(s, f"{h}.layernorm", d)
    _linear(s, f"{h}.mlp.fc1", d, v["intermediate_size"])
    _linear(s, f"{h}.mlp.fc2", v["intermediate_size"], d)
    s.append(("backbone.logit_scale", (1,), "const", 1.0))
    s.append(("backbone.logit_bias", (1,), "const", 0.0))
    return s


def head_spec(cfg, feature_dim: int) -> Spec:
    f = cfg["head"]["fusion_dim"]
    labels = len(cfg["head"]["class_names"])
    s: Spec = []
    _linear(s, "proj_t", feature_dim, f)
    _linear(s, "proj_i", feature_dim, f)
    _linear(s, "g_t", f, f)
    _linear(s, "g_i", f, f)
    _linear(s, "gate", 2 * f + 2, f)
    _ln(s, "ln_fused", f)
    _ln(s, "cls.0", 5 * f)
    _linear(s, "cls.1", 5 * f, f)
    _linear(s, "cls.4", f, labels)
    return s


def feature_dim(cfg) -> int:
    if cfg["family"] == "clip":
        return cfg["projection_dim"]
    return cfg["text_config"]["projection_size"]


def spec(cfg) -> Spec:
    backbone = {"clip": clip_spec, "siglip": siglip_spec}[cfg["family"]](cfg)
    return backbone + head_spec(cfg, feature_dim(cfg))


def draw(cfg, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the configuration's fusion checkpoint on ``device``
    in ``dtype``, all views of one buffer."""
    leaves = spec(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in leaves]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, k = {}, 0
    with torch.no_grad():
        for (name, shape, kind, scale), n in zip(leaves, sizes):
            t = flat[k:k + n].view(shape)
            k += n
            if kind == "const":
                t.fill_(scale)
            else:
                t.mul_(scale)
                if kind == "ones":
                    t.add_(1.0)
            out[name] = t
        if dtype != torch.float32:
            flat = flat.to(dtype)
            k = 0
            for (name, shape, _, _), n in zip(leaves, sizes):
                out[name] = flat[k:k + n].view(shape)
                k += n
    return out

