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

from torch.utils.checkpoint import checkpoint

from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ, attention_nhd_diff
from multimodal_content_moderation_tpu_torch.ops.cuda_flash import fused_mha


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: ``x * sigmoid(1.702 * x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """SigLIP's tanh-approximate GELU (torch ``gelu_pytorch_tanh``)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


ACTIVATIONS = {
    "quick_gelu": quick_gelu,
    "gelu_pytorch_tanh": gelu_tanh,
    "gelu_tanh": gelu_tanh,
    "gelu": gelu_exact,
}


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w`` of two low-precision CUDA tensors with an fp32 result (one
    cuBLAS call, fp32 accumulation, no rounding of the product). Its
    gradients are low-precision products, as JAX's transpose of
    ``jnp.dot(..., preferred_element_type=float32)`` gives them."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        # g is the fp32 image of a low-precision cotangent: the cast is exact
        g = g.to(x2.dtype)
        return torch.mm(g, w.t()), torch.mm(x2.t(), g)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in fp32 (x [..., in], w [in, out])."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        y = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    # a product of two bf16 numbers is exact in fp32: the same function
    return torch.matmul(x.float(), w.float())


def dense(x: torch.Tensor, p) -> torch.Tensor:
    """Affine layer: ``p = {"w": (in, out), "b": (out,)}`` (b optional).

    The weight is cast to the activation dtype; the product accumulates in
    fp32 and stays fp32, the bias is added in fp32 and the result is rounded
    once to x's dtype (JAX's ``preferred_element_type=float32`` dense)."""
    w = p["w"]
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = _matmul_f32(x, w)
    if "b" in p and p["b"] is not None:
        y = y + p["b"].float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (biased variance,
    eps inside the sqrt). ``p = {"scale": (d,), "bias": (d,)}``."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps
    )
    return y.to(x.dtype)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout from an explicit generator's stream. Identity when
    ``generator is None`` (eval) or ``rate == 0``."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] non-overlapping patches, the
    im2col of a stride == kernel conv, channel-major (C, ph, pw) inside each
    patch: the layout of a converted ``Conv2d.weight.reshape(d, -1)`` and of
    the uint8 wire rows."""
    B, C, H, W = pixel_values.shape
    p = patch_size
    nh, nw = H // p, W // p
    x = pixel_values.reshape(B, C, nh, p, nw, p)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, nh, nw, C, p, p]
    return x.reshape(B, nh * nw, C * p * p)


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
    softmax, scores in ``scores_dtype``) or "pallas" (the kernels, as the
    JAX package dispatches them: ``attention_nhd`` on the [B, T, D] layout
    when there is no dense mask and both lengths are at most 256, else
    ``fused_mha``; their plain versions on the CPU). A single query with no
    mask (the SigLIP MAP head) takes neither: fp32 products over the
    [B, Tk, h, dh] view."""
    B, Tq, D = x_q.shape
    Tk = x_kv.shape[1]
    h = num_heads
    dh = D // h

    q3 = dense(x_q, p["q"])
    k3 = dense(x_kv, p["k"])
    v3 = dense(x_kv, p["v"])

    if Tq == 1 and mask is None and key_mask is None and not causal:
        qh = q3.float().reshape(B, 1, h, dh)
        kh = k3.float().reshape(B, Tk, h, dh)
        logits = (kh * qh).sum(-1) * (1.0 / float(dh) ** 0.5)  # [B, Tk, h]
        w = torch.softmax(logits, dim=1)
        vh = v3.float().reshape(B, Tk, h, dh)
        out = (vh * w[..., None]).sum(1)  # [B, h, dh]
        return dense(out.to(x_q.dtype).reshape(B, 1, D), p["o"])

    if impl == "pallas":
        if mask is None and max(Tq, Tk) <= MAX_SEQ:
            out = attention_nhd_diff(q3, k3, v3, key_mask, h, causal)
        else:
            # [B, T, D] memory seen as [B, h, T, dh]: no copy on the card
            out = fused_mha(
                q3.view(B, Tq, h, dh).transpose(1, 2),
                k3.view(B, Tk, h, dh).transpose(1, 2),
                v3.view(B, Tk, h, dh).transpose(1, 2),
                mask, causal=causal, key_mask=key_mask,
            )
            out = out.transpose(1, 2).reshape(B, Tq, D)
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
    remat: bool = False,
    attention_impl: str = "xla",
    scores_dtype: str = "float32",
    causal: bool = False,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pre-LN transformer block (HF CLIPEncoderLayer semantics).
    ``p = {"ln1", "attn", "ln2", "fc1", "fc2"}``. With ``remat`` the block's
    activations are recomputed in the backward pass
    (``torch.utils.checkpoint``), trading operations for memory."""
    activation = ACTIVATIONS[act]

    def block(x):
        y = layer_norm(x, p["ln1"], eps)
        x = x + mha(
            y, y, p["attn"], num_heads, mask,
            impl=attention_impl, scores_dtype=scores_dtype,
            causal=causal, key_mask=key_mask,
        )
        y = layer_norm(x, p["ln2"], eps)
        y = activation(dense(y, p["fc1"]))
        return x + dense(y, p["fc2"])

    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)
