"""Compute primitives shared by the encoders and heads.

Numerics contract, as in the JAX package:

- Linear weights are stored ``(in_features, out_features)``; every dense is
  ``x @ w``.
- Matrix products accumulate in fp32; a dense returns the input's dtype.
- Softmax and LayerNorm statistics are fp32 whatever the compute dtype.

Parameters are passed as mappings (``p["w"]``), which a
``models.params.ParamTree`` is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ, attention_nhd


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: ``x * sigmoid(1.702 * x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu_exact}


def dense(x: torch.Tensor, p) -> torch.Tensor:
    """Affine layer: ``p = {"w": (in, out), "b": (out,)}`` (b optional).

    The weight is cast to the activation dtype; the product accumulates in
    fp32, the bias is added in fp32 and the result has x's dtype."""
    w = p["w"]
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = torch.matmul(x, w)
    if "b" in p and p["b"] is not None:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (biased variance,
    eps inside the sqrt). ``p = {"scale": (d,), "bias": (d,)}``."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps
    )
    return y.to(x.dtype)


def mha(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    p,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    impl: str = "xla",
    scores_dtype: str = "float32",
    causal: bool = False,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention with fp32 softmax.

    ``mask`` is an additive fp32 bias broadcastable to [B, heads, Tq, Tk];
    ``causal`` and ``key_mask`` ([B, Tk] additive fp32) are the structured
    form. ``impl`` selects the core: "xla" (plain products around an fp32
    softmax, scores in ``scores_dtype``) or "pallas" (the ``attention_nhd``
    kernel on the [B, T, D] layout; its plain version on the CPU)."""
    B, Tq, D = x_q.shape
    Tk = x_kv.shape[1]
    h = num_heads
    dh = D // h

    q3 = dense(x_q, p["q"])
    k3 = dense(x_kv, p["k"])
    v3 = dense(x_kv, p["v"])

    if impl == "pallas":
        if mask is not None:
            raise NotImplementedError(
                "attention impl 'pallas' with a dense mask needs the attention_small "
                "kernel, which is not ported yet"
            )
        if max(Tq, Tk) > MAX_SEQ:
            raise NotImplementedError(
                f"attention impl 'pallas' at sequence {max(Tq, Tk)} > {MAX_SEQ} needs "
                "the flash_attention kernel, which is not ported yet"
            )
        out = attention_nhd(q3, k3, v3, h, key_mask, causal)
        return dense(out, p["o"])
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")

    q = q3.reshape(B, Tq, h, dh).transpose(1, 2)
    k = k3.reshape(B, Tk, h, dh).transpose(1, 2)
    v = v3.reshape(B, Tk, h, dh).transpose(1, 2)
    sdt = getattr(torch, scores_dtype)
    scale = torch.tensor(float(dh), device=q.device).sqrt().reciprocal().to(sdt)
    # products in the wider of the two types, scores rounded to scores_dtype
    wide = torch.promote_types(q.dtype, sdt)
    logits = torch.matmul(q.to(wide), k.to(wide).transpose(-1, -2)).to(sdt) * scale
    if mask is not None:
        logits = logits + mask.to(sdt)
    if key_mask is not None:
        logits = logits + key_mask.to(sdt)[:, None, None, :]
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=x_q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    weights = torch.softmax(logits.float(), dim=-1).to(x_q.dtype)
    out = torch.matmul(weights, v)
    out = out.transpose(1, 2).reshape(B, Tq, D)
    return dense(out, p["o"])


def transformer_block(
    x: torch.Tensor,
    p,
    num_heads: int,
    act: str,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    attention_impl: str = "xla",
    scores_dtype: str = "float32",
    causal: bool = False,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pre-LN transformer block (HF CLIPEncoderLayer semantics).
    ``p = {"ln1", "attn", "ln2", "fc1", "fc2"}``."""
    activation = ACTIVATIONS[act]
    y = layer_norm(x, p["ln1"], eps)
    x = x + mha(
        y, y, p["attn"], num_heads, mask,
        impl=attention_impl, scores_dtype=scores_dtype,
        causal=causal, key_mask=key_mask,
    )
    y = layer_norm(x, p["ln2"], eps)
    y = activation(dense(y, p["fc1"]))
    return x + dense(y, p["fc2"])
