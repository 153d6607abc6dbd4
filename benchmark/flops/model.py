"""Model operations of one row through a fusion model, from the published
widths and the row's own text tokens (padding is not counted): 2 per
multiply-add of every matrix product, the attention's scores and mixing
included; elementwise work, norms and softmax are not counted. Training
counts three times the forward (the forward, and the backward's two
products per forward product)."""

from typing import Dict


def _layer(tokens: int, keys: float, d: int, f: int) -> float:
    # q, k, v, o projections + fc1, fc2; scores and mixing over ``keys``
    return 2 * tokens * (4 * d * d + 2 * d * f) + 4 * tokens * keys * d


def tower(tokens: int, c: Dict, causal: bool = False) -> float:
    keys = (tokens + 1) / 2 if causal else tokens
    return c["num_hidden_layers"] * _layer(tokens, keys, c["hidden_size"],
                                           c["intermediate_size"])


def vision_tokens(cfg: Dict) -> int:
    v = cfg["vision_config"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    return n + (1 if cfg["family"] == "clip" else 0)


def forward(cfg: Dict, text_tokens: int) -> float:
    """Operations of one row's forward pass with ``text_tokens`` real text
    tokens."""
    t, v = cfg["text_config"], cfg["vision_config"]
    d = v["hidden_size"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    ops = 2 * n * v["num_channels"] * v["patch_size"] ** 2 * d  # patch embed
    ops += tower(vision_tokens(cfg), v)
    ops += tower(text_tokens, t, causal=cfg["family"] == "clip")
    f = cfg["head"]["fusion_dim"]
    if cfg["family"] == "clip":
        p = cfg["projection_dim"]
        ops += 2 * (t["hidden_size"] + d) * p
        feat = p
    else:
        # the MAP head: one query over the patches, its projections and MLP
        ops += 2 * (d * d + 2 * n * d * d + d * d + 2 * d * v["intermediate_size"])
        ops += 4 * n * d
        ops += 2 * t["hidden_size"] * t["projection_size"]
        feat = t["projection_size"]
    ops += 2 * (2 * feat * f + 2 * f * f + (2 * f + 2) * f + 5 * f * f
                + f * len(cfg["head"]["class_names"]))
    return float(ops)


def training(cfg: Dict, text_tokens: int) -> float:
    return 3.0 * forward(cfg, text_tokens)
