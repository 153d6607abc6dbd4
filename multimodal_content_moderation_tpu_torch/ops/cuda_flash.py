"""The attention kernels behind ``fused_mha``, over [B, H, T, dh] views.

``fused_mha`` dispatches by length, as the JAX package's does. Up to
``MAX_SEQ`` (256) positions it folds ``causal`` and ``key_mask`` into one
additive fp32 mask, kept in its broadcast shape, and calls
``attention_small`` (``csrc/attention_small.cu``). Above that it calls
``flash_attention`` (``csrc/flash_attention.cu``), which takes the dense
mask, the key-padding row and the causal flag as separate sources. Both read
any [B, H, T, dh] view whose last axis is contiguous, and the mask with its
broadcast strides, so ``ops.layers.mha`` hands them the projections'
[B, T, D] memory without a transpose or a copy.

For tensors on the CPU each wrapper runs its plain version
(``flash_attention_reference``, ``attention_small_reference``); for CUDA
tensors it launches its kernel or raises. Both kernels are forward only, as
in the JAX package: asking for a gradient through them raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from multimodal_content_moderation_tpu_torch.ops import _build
from multimodal_content_moderation_tpu_torch.ops.cuda_attention import (
    MAX_HEAD_DIM,
    MAX_SEQ,
    NEG_INF,
    _lib,
)


def attention_small_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of ``attention_small``: the JAX ``_small_body`` in fp32
    (q [..., T, dh], k/v [..., S, dh], mask broadcastable to [..., T, S])."""
    scale = float(q.shape[-1]) ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Plain version of ``flash_attention``: one fp32 softmax over all S keys
    with the mask sources added in the kernel's order."""
    T, S = q.shape[2], k.shape[2]
    scale = float(q.shape[-1]) ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale  # [B, H, T, S]
    if mask is not None:
        s = s + mask.float()
    if key_mask is not None:
        s = s + key_mask.float()[:, None, None, :]
    if causal:
        keep = torch.arange(S, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.float()).to(q.dtype)


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward only (the JAX package defines no backward for it): "
            "train with attention 'xla', or at sequences of at most "
            f"{MAX_SEQ} without a dense mask, where the attention_nhd kernels train"
        )


def _check_common(name: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    for tname, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}, q is {q.dtype} "
                             f"on {q.device}")


def _small_launch(q, k, v, mask, tensor_cores: bool):
    """Check the inputs and launch one kernel: the tensor-core one (bf16
    only) or the SIMT one (fp32 or bf16). q [BH, T, dh] with k/v [BH, S, dh]
    (the JAX contract, seen as B = 1) or q [B, H, T, dh] with k/v
    [B, H, S, dh]; the mask broadcastable to q's leading axes + [T, S].
    Returns the output and whether a kernel was launched (none is for an
    empty output)."""
    _check_common("attention_small", q, k, v)
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("attention_small: q, k, v must be [BH, T, dh] or [B, H, T, dh]")
    *lead, T, dh = q.shape
    S = k.shape[-2]
    if tuple(k.shape) != (*lead, S, dh) or tuple(v.shape) != (*lead, S, dh):
        raise ValueError(f"attention_small: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if max(T, S) > MAX_SEQ or S == 0:
        raise ValueError(f"attention_small: sequence {max(T, S)} outside 1..{MAX_SEQ}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"attention_small: {tname}'s last axis is not contiguous")
    m = None
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != q.device:
            raise ValueError(f"attention_small: want an fp32 mask on {q.device}, got "
                             f"{mask.dtype} on {mask.device}")
        m = mask.expand(*lead, T, S)  # a view: broadcast axes get stride 0
    if q.dim() == 3:  # the JAX contract: a contiguous [BH, T, dh] output
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        q, k, v, out = (t.unsqueeze(0) for t in (q, k, v, out))
        m = None if m is None else m.unsqueeze(0)
    else:  # a view of [B, T, H, dh] memory: mha reads it as [B, T, D]
        B, H = lead
        out = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    B, H = q.shape[:2]
    if B * H * T == 0:
        return out.squeeze(0) if len(lead) == 1 else out, False
    strides = (ctypes.c_longlong * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *(m.stride() if m is not None else (0, 0, 0, 0)),
    )
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if m is None else m.data_ptr(),
            out.data_ptr(), B, H, T, S, dh, float(dh) ** -0.5, strides)
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    if tensor_cores:
        lib = _lib("attention_small", head + [ctypes.c_void_p], entry="mma_launch")
        err = lib.attention_small_mma_launch(*args, _build.stream_ptr(q.device))
    else:
        lib = _lib("attention_small", head + [ctypes.c_int, ctypes.c_void_p])
        err = lib.attention_small_launch(*args, int(q.dtype == torch.bfloat16),
                                         _build.stream_ptr(q.device))
    _build.check(lib, "attention_small", err)
    return out.squeeze(0) if len(lead) == 1 else out, True


def attention_small(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Whole-tile attention with every mask folded into one additive fp32
    ``mask``: q [BH, T, dh], k/v [BH, S, dh], mask broadcastable to
    [BH, T, S] (the JAX contract) -> [BH, T, dh]; or q [B, H, T, dh], k/v
    [B, H, S, dh] (any strides with a contiguous last axis), mask
    broadcastable to [B, H, T, S] and read with its broadcast strides (a
    [B, 1, T, S] mask is never expanded) -> [B, H, T, dh] (on the card a view
    of [B, T, H, dh] memory). The output is in q's dtype.

    On the card: bf16 runs the tensor-core kernel, fp32 the SIMT kernel,
    chosen by dtype before the launch (both counted in
    ``attention_small.launches``, the bf16 ones also in
    ``attention_small.tensor_core_launches``). On the CPU: the plain
    version."""
    _forward_only("attention_small", q, k, v)
    if q.device.type == "cpu":
        return attention_small_reference(q, k, v, mask)
    tensor_cores = q.dtype == torch.bfloat16
    out, launched = _small_launch(q, k, v, mask, tensor_cores)
    if launched:
        attention_small.launches += 1
        attention_small.tensor_core_launches += int(tensor_cores)
    return out


attention_small.launches = 0
attention_small.tensor_core_launches = 0


def attention_small_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The SIMT kernel for either dtype, on the card only and not counted:
    the earlier bf16 design, kept as a yardstick for the tensor-core kernel
    (``chip_smoke.py`` times the two in one process)."""
    return _small_launch(q, k, v, mask, False)[0]


def _flash_launch(q, k, v, mask, key_mask, causal, tensor_cores: bool):
    """Check the inputs and launch one kernel: the tensor-core one (bf16
    only) or the SIMT one (fp32 or bf16). Returns the output and whether a
    kernel was launched (none is for an empty output)."""
    _check_common("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, T, dh]")
    B, H, T, dh = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, H, S, dh) or tuple(v.shape) != (B, H, S, dh):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if S == 0:
        raise ValueError("flash_attention: no keys")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {tname}'s last axis is not contiguous")
    m = None
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != q.device:
            raise ValueError(f"flash_attention: want an fp32 mask on {q.device}, got "
                             f"{mask.dtype} on {mask.device}")
        m = mask.expand(B, H, T, S)
    if key_mask is not None:
        if (key_mask.dtype != torch.float32 or tuple(key_mask.shape) != (B, S)
                or key_mask.device != q.device or key_mask.stride(-1) != 1):
            raise ValueError(f"flash_attention: want a contiguous fp32 key_mask [{B}, {S}] on "
                             f"{q.device}, got {key_mask.dtype} {tuple(key_mask.shape)}")
    out = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B * H * T == 0:
        return out, False
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *(m.stride() if m is not None else (0, 0, 0, 0)),
        *((key_mask.stride(0), 0) if key_mask is not None else (0, 0)),
    )
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if m is None else m.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
            B, H, T, S, dh, int(causal), float(dh) ** -0.5, strides)
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    if tensor_cores:
        lib = _lib("flash_attention", head + [ctypes.c_void_p], entry="mma_launch")
        err = lib.flash_attention_mma_launch(*args, _build.stream_ptr(q.device))
    else:
        lib = _lib("flash_attention", head + [ctypes.c_int, ctypes.c_void_p])
        err = lib.flash_attention_launch(*args, int(q.dtype == torch.bfloat16),
                                         _build.stream_ptr(q.device))
    _build.check(lib, "flash_attention", err)
    return out, True


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Blockwise attention: q [B, H, T, dh], k/v [B, H, S, dh] (any strides
    with a contiguous last axis), ``mask`` additive fp32 broadcastable to
    [B, H, T, S], ``key_mask`` [B, S] additive fp32 -> [B, H, T, dh] in q's
    dtype (on the card a view of [B, T, H, dh] memory).

    On the card: bf16 runs the tensor-core kernel, fp32 the SIMT kernel,
    chosen by dtype before the launch (both counted in
    ``flash_attention.launches``, the bf16 ones also in
    ``flash_attention.tensor_core_launches``). On the CPU: the plain
    version."""
    _forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, key_mask, causal)
    tensor_cores = q.dtype == torch.bfloat16
    out, launched = _flash_launch(q, k, v, mask, key_mask, causal, tensor_cores)
    if launched:
        flash_attention.launches += 1
        flash_attention.tensor_core_launches += int(tensor_cores)
    return out


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0


def flash_attention_simt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The SIMT kernel for either dtype, on the card only and not counted:
    the earlier bf16 design, kept as a yardstick for the tensor-core kernel
    (``chip_smoke.py`` times the two in one process)."""
    return _flash_launch(q, k, v, mask, key_mask, causal, False)[0]


def fused_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shape-dispatching attention over q [B, H, T, dh], k/v [B, H, S, dh];
    ``mask`` additive, broadcastable to [B, H, T, S]; ``key_mask`` [B, S]
    additive fp32 -> [B, H, T, dh] in q's dtype. Sequences of at most
    ``MAX_SEQ`` take ``attention_small`` with every mask folded into one
    additive block in its broadcast shape (no [B*H, T, S] tensor and no copy
    of q, k, v); longer ones take ``flash_attention``."""
    B, H, T, dh = q.shape
    S = k.shape[2]
    m = None if mask is None else mask.float()
    if max(T, S) > MAX_SEQ:
        km = None if key_mask is None else key_mask.float().contiguous()
        return flash_attention(q, k, v, m, km, causal)
    if causal or key_mask is not None:
        # the fold keeps the broadcast shape: [B, 1, T, S] for a key row
        base = torch.zeros((1, 1, T, S), dtype=torch.float32, device=q.device) if m is None else m
        if causal:
            keep = torch.arange(S, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
            base = base + torch.where(keep, 0.0, NEG_INF)
        if key_mask is not None:
            base = base + key_mask.float()[:, None, None, :]
        m = base
    return attention_small(q, k, v, m)
