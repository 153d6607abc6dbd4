"""Compute primitives shared by the encoders and heads.

Numerics contract, as in the JAX package:

- Linear weights are stored ``(in_features, out_features)``; every dense is
  ``x @ w``.
- Matrix products accumulate in fp32; a dense returns the input's dtype.
- Softmax and LayerNorm statistics are fp32 whatever the compute dtype.

Parameters are passed as mappings (``p["w"]``), which a
``models.params.ParamTree`` is.

Inference on the card in bf16 (``fused``: gradients off, no model split,
every leaf already bf16) takes a shorter schedule of the same arithmetic:
a dense is one ``torch.addmm`` (fp32 accumulation, the bias added in fp32
in cuBLASLt's epilogue, one rounding to bf16; partial sums of a split-K
product kept in fp32 for that call alone), and a LayerNorm, with the residual add before it,
is one launch of ``ops/cuda_norm.add_layer_norm``. Everything else (the
CPU, fp32, training, a model split, int8 leaves) keeps the plain code.
``utils/profiling.count`` records which path each dense and LayerNorm took
(``model.dense.fused`` / ``.plain``, ``model.add_ln.fused`` /
``model.layer_norm.plain``).

Tensor parallelism (``parallel/sharding.py``) is read off the parameters:
a weight that carries a ``model_split`` is this rank's shard. A column
shard (q, k, v, fc1) takes its input through ``copy_to_model_parallel``
and gives this rank's columns; a row shard (o, fc2) gives an fp32 partial
product that ``reduce_from_model_parallel`` sums over the model group
before the replicated bias is added once and the sum is rounded once to
the input's dtype, so a bf16 ``dense`` still rounds once. ``mha`` runs the
heads its q shard holds.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from multimodal_content_moderation_tpu_torch.ops import cuda_norm
from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ, attention_nhd_diff
from multimodal_content_moderation_tpu_torch.ops.cuda_flash import fused_mha
from multimodal_content_moderation_tpu_torch.ops.quant import dense_int8
from multimodal_content_moderation_tpu_torch.parallel.collectives import (
    copy_to_model_parallel,
    data_shard,
    reduce_from_model_parallel,
    split_of,
)
from multimodal_content_moderation_tpu_torch.utils.profiling import count


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


def fused(x: torch.Tensor, *leaves: Optional[torch.Tensor]) -> bool:
    """Whether ``x`` with these parameter leaves takes the fused schedule:
    bf16 on the card, gradients off, every leaf bf16 (None is no leaf) and
    none split over a model group."""
    if not (x.is_cuda and x.dtype == torch.bfloat16) or torch.is_grad_enabled():
        return False
    for t in leaves:
        if t is not None and (t.dtype != torch.bfloat16 or split_of(t) is not None):
            return False
    return True


# the setting's getter returns (reduced precision, split-K) or, in older
# PyTorch, the bool alone; the setter takes the same arguments back
_get_bf16_reduction = torch._C._get_cublas_allow_bf16_reduced_precision_reduction
_set_bf16_reduction = torch._C._set_cublas_allow_bf16_reduced_precision_reduction


def _product_fp32_sums(x2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """``b + x2 @ w`` (``x2 @ w`` without b) in one cuBLAS call, its split-K
    partial sums kept in fp32: PyTorch's process-wide
    ``allow_bf16_reduced_precision_reduction`` (on by default) is off for
    this call alone and set back after it, so every other product in the
    process (training's among them) keeps the setting it had."""
    before = _get_bf16_reduction()
    before = before if isinstance(before, tuple) else (before,)
    if before[0]:
        _set_bf16_reduction(False, *before[1:])
    try:
        return torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
    finally:
        if before[0]:
            _set_bf16_reduction(*before)


def dense(x: torch.Tensor, p) -> torch.Tensor:
    """Affine layer: ``p = {"w": (in, out), "b": (out,)}`` (b optional).

    The weight is cast to the activation dtype; the product accumulates in
    fp32 and stays fp32, the bias is added in fp32 and the result is rounded
    once to x's dtype (JAX's ``preferred_element_type=float32`` dense).
    A row shard's fp32 partial products are summed over its model group
    before the bias. On the ``fused`` schedule the same arithmetic is one
    ``addmm`` (``mm`` without a bias) in cuBLAS."""
    w = p["w"]
    b = p["b"] if "b" in p else None
    if fused(x, w, b):
        count("model.dense.fused")
        y = _product_fp32_sums(x.reshape(-1, x.shape[-1]), w, b)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    count("model.dense.plain")
    split = split_of(w)
    if split is not None and split.dim == 1:
        x = copy_to_model_parallel(x, split.group)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = _matmul_f32(x, w)
    if split is not None and split.dim == 0:
        y = reduce_from_model_parallel(y.float(), split.group)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def dense_maybe_int8(x: torch.Tensor, p) -> torch.Tensor:
    """``dense``, or ``ops.quant.dense_int8`` for a leaf that
    ``quantize_fc1_layers`` made int8 (``{"w_i8", "scale", "b"}``)."""
    if "w_i8" in p:
        return dense_int8(x, p)
    return dense(x, p)


def add_layer_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor], p, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): the residual sum s = x + delta in x's dtype (x itself without
    delta) and y = LayerNorm(s) with fp32 statistics (biased variance, eps
    inside the sqrt), rounded once to x's dtype. ``p = {"scale": (d,),
    "bias": (d,)}``. On the ``fused`` schedule, for a width the kernel
    takes (``ops/cuda_norm.takes``), one launch of its kernel; an operand
    whose layout it does not read is copied to a contiguous one first."""
    scale, bias = p["scale"], p["bias"]
    if fused(x, delta, scale, bias) and cuda_norm.takes(x, delta, scale, bias):
        count("model.add_ln.fused")
        return cuda_norm.launch(*(cuda_norm.laid_out(t) for t in (x, delta, scale, bias)), eps)
    count("model.layer_norm.plain")
    return cuda_norm.add_layer_norm_reference(x, delta, scale, bias, eps)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (biased variance,
    eps inside the sqrt). ``p = {"scale": (d,), "bias": (d,)}``."""
    return add_layer_norm(x, None, p, eps)[1]


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
    heads: Optional[tuple] = None,
) -> torch.Tensor:
    """Inverted dropout from an explicit generator's stream. Identity when
    ``generator is None`` (eval) or ``rate == 0``.

    Under a mesh every rank draws the mask of the global batch (this rank's
    rows are one of ``data_shard()``'s slices) and keeps its own rows, and
    of [B, H, ...] attention weights whose heads are split (``heads``:
    ``(first head, all heads)``) its own heads: a step then draws what one
    process draws on the whole batch."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    index, size = data_shard()
    shape = list(x.shape)
    shape[0] *= size
    if heads is not None:
        shape[1] = heads[1]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if size > 1:
        mask = mask.narrow(0, index * x.shape[0], x.shape[0])
    if heads is not None:
        mask = mask.narrow(1, heads[0], x.shape[1])
    return torch.where(mask, x / keep, torch.zeros_like(x))


def fork_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on ``generator``'s device whose seed is a hash of
    that generator's state, which then moves on by one draw: the
    counterpart of JAX's ``random.split``. The parent's later draws do not
    depend on how much the child draws, and nothing waits for the device
    (a CUDA generator's state lives on the host)."""
    state = generator.get_state().numpy().tobytes()
    seed = int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(), "little") >> 1
    child = torch.Generator(device=generator.device).manual_seed(seed)
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    return child


def checkpoint_replaying(fn, x: torch.Tensor, generator: Optional[torch.Generator]):
    """``torch.utils.checkpoint`` of ``fn(x, generator)`` whose recompute
    draws the same dropout masks as the forward did. Checkpoint restores
    only the default RNG states, not an explicit generator, so the
    generator's state is saved here, outside the checkpointed function;
    the forward and the recompute each draw from a copy started at that
    state, and ``generator`` moves on as if ``fn`` had drawn from it."""
    if generator is None:
        return checkpoint(lambda x: fn(x, None), x, use_reentrant=False)
    state = generator.get_state()
    end = []

    def run(x):
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        y = fn(x, g)
        if not end:  # the forward, not the recompute
            end.append(g.get_state())
        return y

    y = checkpoint(run, x, use_reentrant=False)
    generator.set_state(end[0])
    return y


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
    probs_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
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
    [B, Tk, h, dh] view.

    ``probs_dropout`` with a ``generator`` (training) drops attention
    weights after the softmax, before the product with v (HF's
    attention-probability dropout). Active dropout takes the "xla" core
    whatever ``impl`` says, in every branch: the kernels have no dropout."""
    B, Tq, _ = x_q.shape
    Tk = x_kv.shape[1]
    drop = probs_dropout > 0.0 and generator is not None

    q3 = dense(x_q, p["q"])
    k3 = dense(x_kv, p["k"])
    v3 = dense(x_kv, p["v"])
    # this rank's heads: all of them, or a column shard's run of them
    split = split_of(p["q"]["w"])
    h = num_heads if split is None else num_heads // split.size
    heads = None if split is None else (split.index * h, num_heads)
    D = q3.shape[-1]
    dh = D // h

    if Tq == 1 and mask is None and key_mask is None and not causal and not drop:
        qh = q3.float().reshape(B, 1, h, dh)
        kh = k3.float().reshape(B, Tk, h, dh)
        logits = (kh * qh).sum(-1) * (1.0 / float(dh) ** 0.5)  # [B, Tk, h]
        w = torch.softmax(logits, dim=1)
        vh = v3.float().reshape(B, Tk, h, dh)
        out = (vh * w[..., None]).sum(1)  # [B, h, dh]
        return dense(out.to(x_q.dtype).reshape(B, 1, D), p["o"])

    if impl == "pallas" and not drop:
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
    if impl not in ("xla", "pallas"):
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
    if drop:
        weights = dropout(weights, probs_dropout, generator, heads)
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
        a = mha(
            y, y, p["attn"], num_heads, mask,
            impl=attention_impl, scores_dtype=scores_dtype,
            causal=causal, key_mask=key_mask,
        )
        x, y = add_layer_norm(x, a, p["ln2"], eps)
        y = activation(dense_maybe_int8(y, p["fc1"]))
        return x + dense(y, p["fc2"])

    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)
