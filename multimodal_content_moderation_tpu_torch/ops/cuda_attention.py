"""Short-sequence attention over the projections' natural [B, T, D] layout.

``attention_nhd`` reads q/k/v as [B, T, D] (D = heads * dh), splits the
heads inside the kernel (``csrc/attention_nhd.cu``), applies an additive
fp32 key mask and an in-kernel causal mask, runs an fp32 softmax and writes
[B, T, D] back in q's dtype. For tensors on the CPU it runs
``attention_nhd_reference``, its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from multimodal_content_moderation_tpu_torch.ops import _build

NEG_INF = torch.finfo(torch.float32).min  # -3.4028235e38, the JAX package's NEG_INF
MAX_SEQ = 256  # longer sequences are flash_attention's, not yet ported
MAX_HEAD_DIM = 128


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
    keep = None
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        keep = (cols <= rows)[None]
    km = None if key_mask is None else key_mask.float()[:, None, :]
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

    On the card: the CUDA kernel (counted in ``attention_nhd.launches``).
    On the CPU: the plain version."""
    if q.device.type == "cpu":
        return attention_nhd_reference(q, k, v, num_heads, key_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_nhd: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention_nhd: q, k, v must be [B, T, D]")
    B, Tq, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, D) or tuple(v.shape) != (B, S, D):
        raise ValueError(
            f"attention_nhd: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if D % num_heads:
        raise ValueError(f"attention_nhd: D={D} not divisible by {num_heads} heads")
    dh = D // num_heads
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention_nhd: head dim {dh} > {MAX_HEAD_DIM}")
    if max(Tq, S) > MAX_SEQ:
        raise ValueError(f"attention_nhd: sequence {max(Tq, S)} > {MAX_SEQ}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_nhd: unsupported dtype {q.dtype}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if key_mask is not None:
        if key_mask.dtype != torch.float32 or tuple(key_mask.shape) != (B, S):
            raise ValueError(
                f"attention_nhd: want fp32 key_mask [{B}, {S}], got {key_mask.dtype} "
                f"{tuple(key_mask.shape)}"
            )
        tensors.append(("key_mask", key_mask))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"attention_nhd: {name} is on {t.device}")
        if name != "key_mask" and t.dtype != q.dtype:
            raise ValueError(f"attention_nhd: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"attention_nhd: {name} is not contiguous")
    out = torch.empty_like(q)
    if B * Tq == 0:
        return out
    lib = _lib()
    err = lib.attention_nhd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(),
        out.data_ptr(), B, Tq, S, num_heads, dh, int(causal),
        float(dh) ** -0.5, int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(lib, "attention_nhd", err)
    attention_nhd.launches += 1
    return out


attention_nhd.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_nhd")
    fn = lib.attention_nhd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p]
        )
    return lib
