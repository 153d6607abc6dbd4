"""Residual add + LayerNorm over bf16 rows in one launch.

    s = x + delta (rounded to bf16), y = layer_norm(s) (fp32 statistics,
    rounded to bf16 once)

``add_layer_norm`` launches ``csrc/add_layer_norm.cu`` for tensors on the
card and runs ``add_layer_norm_reference``, its plain version (the port's
``x + delta`` then ``ops.layers.layer_norm``), for tensors on the CPU.
Without ``delta`` it is a plain LayerNorm. The kernel replaces no TPU
kernel: XLA fuses these ops on the TPU, eager PyTorch spends six launches on
them. ``ops.layers`` sends ``launch`` only a width the kernel ``takes``, each
operand ``laid_out`` for it: the one check on that path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.ops import _build

MAX_D = 3072  # 128 threads x 3 vectors of 8 a row


def add_layer_norm_reference(
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``add_layer_norm``: (s, y) with s = x + delta in x's
    dtype (x itself without delta) and y = LayerNorm(s) taken in fp32 from
    the rounded s (biased variance, eps inside the sqrt), rounded once."""
    s = x if delta is None else x + delta
    y = F.layer_norm(s.float(), (s.shape[-1],), scale.float(), bias.float(), eps)
    return s, y.to(s.dtype)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The row stride (elements) of ``t`` seen as [rows, D]: a contiguous
    tensor, or a 2-D view whose rows are contiguous; None otherwise."""
    if t.dim() == 2 and t.stride(1) == 1:
        return t.stride(0)
    return t.shape[-1] if t.is_contiguous() else None


def fits(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t``'s layout: D a multiple of 8 up to
    ``MAX_D``, rows of a uniform stride that keeps every row on 16 bytes (a
    scale or bias [D]: contiguous, starting on 16 bytes)."""
    D = t.shape[-1]
    stride = _row_stride(t)
    return (0 < D <= MAX_D and D % 8 == 0 and stride is not None and stride % 8 == 0
            and t.data_ptr() % 16 == 0)


def takes(x: torch.Tensor, delta: Optional[torch.Tensor], scale: torch.Tensor,
          bias: torch.Tensor) -> bool:
    """Whether the kernel takes these bf16 operands once each is ``laid_out``:
    D a multiple of 8 up to ``MAX_D``, delta of x's shape, scale and bias
    [D], all on x's card."""
    D, dev = x.shape[-1], x.get_device()
    return (0 < D <= MAX_D and D % 8 == 0 and scale.shape == bias.shape == (D,)
            and scale.get_device() == bias.get_device() == dev
            and (delta is None or (delta.shape == x.shape and delta.get_device() == dev)))


def laid_out(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` itself where the kernel reads its layout (``fits``), else a
    contiguous copy (a fresh allocation starts on 16 bytes)."""
    return t if t is None or fits(t) else t.clone(memory_format=torch.contiguous_format)


def _check(x, delta, scale, bias) -> None:
    """Raise on what the kernel does not take (one expression on the launch
    path; the message is worked out only for a refusal)."""
    bf16 = torch.bfloat16
    if (x.is_cuda and x.dtype is bf16 and scale.dtype is bf16 and bias.dtype is bf16
            and (delta is None or delta.dtype is bf16) and takes(x, delta, scale, bias)
            and fits(x) and fits(scale) and fits(bias) and (delta is None or fits(delta))):
        return
    named = [("x", x), ("delta", delta), ("scale", scale), ("bias", bias)]
    raise ValueError("add_layer_norm: want bf16 on one card, x and delta [..., D] with D a "
                     f"multiple of 8 up to {MAX_D} in 16-byte rows of a uniform stride, "
                     "contiguous scale and bias [D] starting on 16 bytes; got " + ", ".join(
                         f"{n} {t.dtype} {tuple(t.shape)} stride {tuple(t.stride())} on "
                         f"{t.device}" for n, t in named if t is not None))


def _launcher():
    """``add_layer_norm_launch`` of ``csrc/add_layer_norm.cu``, its types set."""
    fn = _build.load("add_layer_norm").add_layer_norm_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def add_layer_norm(
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y) as ``add_layer_norm_reference`` gives them, both [..., D] in
    bf16 (s is x itself without delta).

    On the card: one launch of the kernel (``launch``); it raises on what it
    does not take (bf16 only, ``takes``, ``fits`` for every operand). On the
    CPU: the plain version."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, delta, scale, bias, eps)
    _check(x, delta, scale, bias)
    return launch(x, delta, scale, bias, eps)


def launch(
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``add_layer_norm`` on the card without its check: the caller has
    settled dtype, device, shapes and layout (``ops.layers``: ``fused``,
    ``takes``, ``laid_out``). Counted in ``add_layer_norm.launches``."""
    D = x.shape[-1]
    R = x.numel() // D
    y = x.new_empty(x.shape)
    s = x if delta is None else x.new_empty(x.shape)
    if R == 0:
        return s, y
    err = _launcher()(
        x.data_ptr(), None if delta is None else delta.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), None if delta is None else s.data_ptr(), y.data_ptr(), R, D,
        _row_stride(x), 0 if delta is None else _row_stride(delta), eps,
        _build.stream_ptr(x.device),
    )
    if err:
        _build.check(_build.load("add_layer_norm"), "add_layer_norm", err)
    add_layer_norm.launches += 1
    return s, y


add_layer_norm.launches = 0
