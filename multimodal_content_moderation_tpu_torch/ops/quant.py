"""The int8 fc1 tier (``--precision int8_mlp``): eval-only int8 weights for
the (768, 3072) MLP input products (the JAX package's ``ops/quant.py``).

Scheme (static weights, dynamic activations, both symmetric):

- weights: per output channel, ``scale_n = max|w[:, n]| / 127`` (at least
  1e-12), ``w_i8 = clip(rint(w / scale), -127, 127)``;
- activations: per row, ``s_r = max|x[r, :]| / 127`` (at least 1e-12),
  quantized the same way;
- the product: int8 x int8 -> int32 (``torch._int_mm``: cuBLASLt's int8
  product on the card), then ``y * (s_x * scale)`` (the outer product of the
  two scale vectors first), then the fp32 bias, then one rounding to the
  activation's dtype. JAX computes this product with ``jnp.dot`` outside
  any Pallas kernel, so it is left to the library here too; the
  quantization and dequantization are plain torch, as JAX leaves them to
  XLA. Every step is in JAX's order and rounds as JAX does
  (``torch.round`` is half to even, like ``rint``), so ``dense_int8`` equals
  JAX's bit for bit.

The card's ``_int_mm`` takes only more than 16 rows: a batch of at most 16
rows is padded with zero rows, which quantize to zeros, and the padding is
dropped after the product. Any other shape the card refuses raises there;
nothing falls back to another function.

``quantize_fc1_layers`` swaps each chosen ``fc1`` leaf ``{"w", "b"}`` of a
model's encoder for ``{"w_i8", "scale", "b"}``; ``ops.layers.dense_maybe_int8``
dispatches on ``"w_i8"``. The Trainer never sees such a model.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
from torch import nn

from multimodal_content_moderation_tpu_torch.models.params import ParamTree

# the fc1 shape the JAX package quantizes by default: the vision towers of
# CLIP ViT-B/32 and SigLIP2-B/16, the ViT-B/16 and the BERT-base family
WINNING_FC1_SHAPE: Tuple[int, int] = (768, 3072)

# the card's _int_mm takes more than this many rows
_MIN_ROWS = 16


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` rounded once, on every device: the card divides by a
    Python number as a product with its rounded reciprocal, which parts
    from the CPU's (and JAX's) quotient in the last bit."""
    return x / torch.full((), 127.0, device=x.device)


def quantize_linear_int8(p) -> dict:
    """``{"w": (K, N) float, "b"?}`` -> ``{"w_i8": int8 (K, N) stored
    column-major, "scale": fp32 (N,), "b"?}`` on the weight's device; ``b``
    is kept as it is. The column-major int8 weight is the layout of
    cuBLASLt's int8 tensor-core product (A row-major, B column-major)."""
    w = p["w"].detach().float()
    scale = torch.clamp_min(_over_127(w.abs().amax(dim=0)), 1e-12)
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8).t().contiguous().t()
    out = {"w_i8": w_i8, "scale": scale}
    if "b" in p and p["b"] is not None:
        out["b"] = p["b"]
    return out


def quantize_rows_int8(x2: torch.Tensor):
    """[M, K] activations -> (int8 [M, K], fp32 row scales [M, 1])."""
    xf = x2.float()
    s_x = torch.clamp_min(_over_127(xf.abs().amax(dim=-1, keepdim=True)), 1e-12)
    return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8), s_x


def dense_int8(x: torch.Tensor, q) -> torch.Tensor:
    """``ops.layers.dense`` with an int8 weight: x [..., K] -> [..., N] in
    x's dtype, the bias added in fp32."""
    lead = x.shape[:-1]
    x_i8, s_x = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
    rows = x_i8.shape[0]
    if rows <= _MIN_ROWS:
        x_i8 = torch.cat([x_i8, x_i8.new_zeros(_MIN_ROWS + 1 - rows, x_i8.shape[1])])
    acc = torch._int_mm(x_i8, q["w_i8"])[:rows]
    y = acc.float() * (s_x * q["scale"].float())
    if "b" in q and q["b"] is not None:
        y = y + q["b"].float()
    return y.to(x.dtype).reshape(*lead, y.shape[-1])


def _quantize_tree(node, shape, count):
    """A nested dict of the tree with the chosen ``fc1`` leaves quantized;
    every other parameter (and the SigLIP ``map_head``, whose fc1 is
    768x3072 too but runs one query row per image) is the source's own
    object, shared, not copied."""
    if isinstance(node, nn.ModuleList):
        return [_quantize_tree(v, shape, count) for v in node]
    if not isinstance(node, ParamTree):
        return node
    out = {}
    for k in node.keys():
        v = node[k]
        if (k == "fc1" and isinstance(v, ParamTree) and "w" in v
                and (shape is None or tuple(v["w"].shape) == tuple(shape))):
            q = quantize_linear_int8(v)
            out[k] = {name: t if isinstance(t, nn.Parameter)
                      else nn.Parameter(t, requires_grad=False) for name, t in q.items()}
            count[0] += 1
        elif k == "map_head":
            out[k] = v
        else:
            out[k] = _quantize_tree(v, shape, count)
    return out


def quantize_fc1_tree(tree, shape: Optional[Tuple[int, int]] = WINNING_FC1_SHAPE):
    """(new ``ParamTree``, n) for a parameter tree (an encoder's): every
    ``fc1`` whose weight is ``shape`` (``None``: every ``fc1``) becomes
    int8, outside the SigLIP ``map_head``. The source tree is untouched."""
    count = [0]
    new = ParamTree(_quantize_tree(tree, shape, count))
    return new, count[0]


def quantize_fc1_layers(model, shape: Optional[Tuple[int, int]] = WINNING_FC1_SHAPE):
    """(new model, n): a copy of a ``FusionModel`` or ``MultiTaskModel``
    whose encoder has its chosen ``fc1`` layers in int8 (``quantize_fc1_tree``);
    the head and every other parameter are the source's own tensors. The
    source model is untouched. The head is never quantized (JAX's walker,
    which takes the whole tree, would reach a hidden task head's fc1 at
    ``shape=None``, which that head's plain dense then cannot read). Cast the model first, then quantize (the JAX
    entry points' order): ``scale`` stays fp32 and ``b`` keeps the cast
    dtype, which a later ``.to(dtype)`` would round."""
    backbone, n = quantize_fc1_tree(model.backbone, shape)
    new = copy.copy(model)
    # the copy's own child table, so that the source keeps its backbone
    new._modules = dict(model._modules)
    new._modules["backbone"] = backbone
    return new, n
