"""Short-sequence attention over the projections' natural [B, T, D] layout.

``attention_nhd`` reads q/k/v as [B, T, D] (D = heads * dh), splits the
heads inside the kernel (``csrc/attention_nhd.cu``: bf16 on the tensor
cores, fp32 on the SIMT units), applies an additive fp32 key mask and an
in-kernel causal mask, runs an fp32 softmax and writes [B, T, D] back in
q's dtype. ``attention_nhd_bwd`` is its recompute
backward (``csrc/attention_nhd_bwd.cu``, bf16 on the tensor cores, fp32 on
the SIMT units), and ``attention_nhd_diff`` joins
the two into a ``torch.autograd.Function``. For tensors on the CPU each
wrapper runs its plain version (``attention_nhd_reference``,
``attention_nhd_bwd_reference``); for CUDA tensors it launches its kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodal_content_moderation_tpu_torch.ops import _build

NEG_INF = torch.finfo(torch.float32).min  # -3.4028235e38, the JAX package's NEG_INF
MAX_SEQ = 256  # longer sequences are flash_attention's (ops/cuda_flash.py)
MAX_HEAD_DIM = 128


def _masks(Tq: int, S: int, device, key_mask, causal: bool):
    keep = None
    if causal:
        rows = torch.arange(Tq, device=device)[:, None]
        cols = torch.arange(S, device=device)[None, :]
        keep = (cols <= rows)[None]
    km = None if key_mask is None else key_mask.float()[:, None, :]
    return keep, km


def attention_nhd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Plain version of ``attention_nhd``: a per-head fp32 loop."""
    B, Tq, D = q.shape
    S = k.shape[1]
    dh = D // num_heads
    scale = float(dh) ** -0.5
    keep, km = _masks(Tq, S, q.device, key_mask, causal)
    outs = []
    for hi in range(num_heads):
        sl = slice(hi * dh, (hi + 1) * dh)
        qh = q[:, :, sl].float()
        kh = k[:, :, sl].float()
        vh = v[:, :, sl].float()
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale  # [B, Tq, S]
        if km is not None:
            s = s + km
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        outs.append(torch.matmul(p, vh))
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_nhd_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``attention_nhd_bwd``: a per-head fp32 loop that
    follows the JAX package's ``_nhd_bwd_body`` line by line."""
    B, Tq, D = q.shape
    S = k.shape[1]
    dh = D // num_heads
    scale = float(dh) ** -0.5
    keep, km = _masks(Tq, S, q.device, key_mask, causal)
    dqs, dks, dvs = [], [], []
    for hi in range(num_heads):
        sl = slice(hi * dh, (hi + 1) * dh)
        qh, kh, vh, doh = (t[:, :, sl].float() for t in (q, k, v, do))
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale  # [B, Tq, S]
        if km is not None:
            s = s + km
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        # dv = p^T do ; dp = do v^T ; ds = p*(dp - rowsum(dp*p)) ; dz = ds*scale
        dvs.append(torch.matmul(p.transpose(1, 2), doh))
        dp = torch.matmul(doh, vh.transpose(1, 2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dz = ds * scale
        dqs.append(torch.matmul(dz, kh))
        dks.append(torch.matmul(dz.transpose(1, 2), qh))
    return tuple(torch.cat(g, dim=2).to(q.dtype) for g in (dqs, dks, dvs))


def _check(name: str, q, k, v, num_heads: int, key_mask, extra=()) -> None:
    """Raise on what the kernels do not take: shapes, types, devices and
    layouts. ``extra`` holds (name, tensor) pairs shaped like q."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be [B, T, D]")
    B, Tq, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, D) or tuple(v.shape) != (B, S, D):
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if D % num_heads:
        raise ValueError(f"{name}: D={D} not divisible by {num_heads} heads")
    if D // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D // num_heads} > {MAX_HEAD_DIM}")
    if max(Tq, S) > MAX_SEQ:
        raise ValueError(f"{name}: sequence {max(Tq, S)} > {MAX_SEQ}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    tensors = [("q", q), ("k", k), ("v", v), *extra]
    for extra_name, t in extra:
        if tuple(t.shape) != (B, Tq, D):
            raise ValueError(f"{name}: {extra_name} {tuple(t.shape)} does not match q")
    if key_mask is not None:
        if key_mask.dtype != torch.float32 or tuple(key_mask.shape) != (B, S):
            raise ValueError(
                f"{name}: want fp32 key_mask [{B}, {S}], got {key_mask.dtype} "
                f"{tuple(key_mask.shape)}"
            )
        tensors.append(("key_mask", key_mask))
    for tname, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}")
        if tname != "key_mask" and t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")


def _attention_nhd_launch(q, k, v, num_heads, key_mask, causal, tensor_cores: bool):
    """Check the inputs and launch one forward kernel: the tensor-core one
    (bf16 only) or the SIMT one (fp32 or bf16). Returns the output and
    whether a kernel was launched (none is for an empty output)."""
    _check("attention_nhd", q, k, v, num_heads, key_mask)
    B, Tq, D = q.shape
    S = k.shape[1]
    dh = D // num_heads
    out = torch.empty_like(q)
    if B * Tq == 0:
        return out, False
    km = None if key_mask is None else key_mask.data_ptr()
    stream = _build.stream_ptr(q.device)
    if tensor_cores:
        lib = _lib("attention_nhd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p], entry="mma_launch")
        err = lib.attention_nhd_mma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km, out.data_ptr(), B, Tq, S,
            num_heads, dh, int(causal), float(dh) ** -0.5, stream,
        )
    else:
        lib = _lib("attention_nhd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        err = lib.attention_nhd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), km, out.data_ptr(), B, Tq, S,
            num_heads, dh, int(causal), float(dh) ** -0.5, int(q.dtype == torch.bfloat16),
            stream,
        )
    _build.check(lib, "attention_nhd", err)
    return out, True


def attention_nhd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention: q [B, Tq, D], k/v [B, S, D], key_mask [B, S]
    additive fp32 -> [B, Tq, D] in q's dtype.

    On the card: bf16 runs the tensor-core kernel, fp32 the SIMT kernel,
    chosen by dtype before the launch (both counted in
    ``attention_nhd.launches``, the bf16 ones also in
    ``attention_nhd.tensor_core_launches``). On the CPU: the plain version."""
    if q.device.type == "cpu":
        return attention_nhd_reference(q, k, v, num_heads, key_mask, causal)
    tensor_cores = q.dtype == torch.bfloat16
    out, launched = _attention_nhd_launch(q, k, v, num_heads, key_mask, causal, tensor_cores)
    if launched:
        attention_nhd.launches += 1
        attention_nhd.tensor_core_launches += int(tensor_cores)
    return out


attention_nhd.launches = 0
attention_nhd.tensor_core_launches = 0


def attention_nhd_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The SIMT forward kernel for either dtype, on the card only and not
    counted: the earlier bf16 design, kept as a yardstick for the
    tensor-core kernel (``chip_smoke.py`` times the two in one process)."""
    return _attention_nhd_launch(q, k, v, num_heads, key_mask, causal, False)[0]


def _attention_nhd_bwd_launch(q, k, v, do, num_heads, key_mask, causal, tensor_cores: bool):
    """Check the inputs and launch one backward kernel pair: the tensor-core
    one (bf16 only) or the SIMT one (fp32 or bf16). Returns (dq, dk, dv) and
    whether a kernel was launched (none is for an empty shape)."""
    _check("attention_nhd_bwd", q, k, v, num_heads, key_mask, extra=[("do", do)])
    B, Tq, D = q.shape
    S = k.shape[1]
    dh = D // num_heads
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B * Tq * S == 0:
        return (dq.zero_(), dk.zero_(), dv.zero_()), False
    # per-row max, 1/sum and rowsum(dp * p), from the first launch to the second
    stats = torch.empty((B, num_heads, Tq, 3), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr())
    stream = _build.stream_ptr(q.device)
    if tensor_cores:
        lib = _lib("attention_nhd_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p], entry="mma_launch")
        err = lib.attention_nhd_bwd_mma_launch(
            *ptrs, B, Tq, S, num_heads, dh, int(causal), float(dh) ** -0.5, stream)
    else:
        lib = _lib("attention_nhd_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        err = lib.attention_nhd_bwd_launch(
            *ptrs, B, Tq, S, num_heads, dh, int(causal), float(dh) ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, "attention_nhd_bwd", err)
    return (dq, dk, dv), True


def attention_nhd_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``attention_nhd`` from its output cotangent ``do``
    [B, Tq, D] (q's dtype): (dq [B, Tq, D], dk [B, S, D], dv [B, S, D]) in
    q's dtype. The key mask gets no gradient.

    On the card: bf16 runs the tensor-core kernels, fp32 the SIMT kernels,
    chosen by dtype before the launch; each pair of launches counts as one
    call in ``attention_nhd_bwd.launches``, a bf16 one also in
    ``attention_nhd_bwd.tensor_core_launches``. On the CPU: the plain
    version."""
    if q.device.type == "cpu":
        return attention_nhd_bwd_reference(q, k, v, do, num_heads, key_mask, causal)
    tensor_cores = q.dtype == torch.bfloat16
    grads, launched = _attention_nhd_bwd_launch(q, k, v, do, num_heads, key_mask, causal,
                                                tensor_cores)
    if launched:
        attention_nhd_bwd.launches += 1
        attention_nhd_bwd.tensor_core_launches += int(tensor_cores)
    return grads


attention_nhd_bwd.launches = 0
attention_nhd_bwd.tensor_core_launches = 0


def attention_nhd_bwd_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SIMT backward kernels for either dtype, on the card only and not
    counted: the earlier bf16 design, kept as a yardstick for the
    tensor-core kernels (``chip_smoke.py`` times the two in one process)."""
    return _attention_nhd_bwd_launch(q, k, v, do, num_heads, key_mask, causal, False)[0]


class _AttentionNHD(torch.autograd.Function):
    """``attention_nhd`` forward, ``attention_nhd_bwd`` backward (the JAX
    package's custom VJP ``attention_nhd_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, num_heads, causal):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.num_heads, ctx.causal = num_heads, causal
        return attention_nhd(q, k, v, num_heads, key_mask, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = attention_nhd_bwd(
            q, k, v, g.to(q.dtype).contiguous(), ctx.num_heads, key_mask, ctx.causal
        )
        return dq, dk, dv, None, None, None


def attention_nhd_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    num_heads: int,
    causal: bool = False,
) -> torch.Tensor:
    """Differentiable ``attention_nhd``: the forward kernel, and the
    recompute backward kernel for dq/dk/dv (the cotangent is cast to q's
    dtype first, as in JAX). The key mask is not trained."""
    return _AttentionNHD.apply(q, k, v, key_mask, num_heads, causal)


def _lib(name: str, argtypes, entry: str = "launch") -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``<name>_<entry>``'s types set."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_{entry}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib
