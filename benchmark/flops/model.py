"""Model operations of one row through a fusion model, from the published
widths and the row's own text tokens (padding is not counted): 2 per
multiply-add of every matrix product, the attention's scores and mixing
included; elementwise work, norms and softmax are not counted. The towers
and projections are the configuration's family's (``families/<family>.py``:
``backbone_ops``, built with ``tower`` here; a new family is a new file
there), the fusion head's are counted here. Training counts three times the
forward (the forward, and the backward's two products per forward
product)."""

from typing import Dict

from benchmark.harness import spec


def _layer(tokens: int, keys: float, d: int, f: int) -> float:
    # q, k, v, o projections + fc1, fc2; scores and mixing over ``keys``
    return 2 * tokens * (4 * d * d + 2 * d * f) + 4 * tokens * keys * d


def tower(tokens: int, c: Dict, causal: bool = False) -> float:
    keys = (tokens + 1) / 2 if causal else tokens
    return c["num_hidden_layers"] * _layer(tokens, keys, c["hidden_size"],
                                           c["intermediate_size"])


def head(cfg: Dict, feature_dim: int) -> int:
    """The fusion head: two projections, the tanh branches, the gate, the
    classifier's two layers."""
    f = cfg["head"]["fusion_dim"]
    return 2 * (2 * feature_dim * f + 2 * f * f + (2 * f + 2) * f + 5 * f * f
                + f * len(cfg["head"]["class_names"]))


def forward(cfg: Dict, text_tokens: int) -> float:
    """Operations of one row's forward pass with ``text_tokens`` real text
    tokens."""
    family = spec.family(cfg)
    return float(family.backbone_ops(cfg, text_tokens) + head(cfg, family.feature_dim(cfg)))


def training(cfg: Dict, text_tokens: int) -> float:
    return 3.0 * forward(cfg, text_tokens)
