"""Fused image normalise + patch embed on the uint8 wire format.

    u8 [B, N, C*p*p] -> (x/255 - mean)/std -> @ W [C*p*p, D] (+ b)

The normalisation is folded into the GEMM (``fold_norm_into_embed``):
``((x/255 - mean)/std) @ W == x @ (W/(255*std)) - (mean/std) @ W``, so the
kernel is one product over widened uint8 rows plus a bias.

``patch_embed_u8`` launches the CUDA kernel (``csrc/patch_embed_u8.cu``:
a bf16 output on the tensor cores, fp32 on the SIMT units) for tensors on
the card and runs ``patch_embed_reference``, its plain version, for
tensors on the CPU. ``patch_embed_u8_train`` makes it differentiable in the
folded weight and bias.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.ops import _build


def fold_norm_into_embed(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    mean: Sequence[float],
    std: Sequence[float],
    patch_size: int,
    num_channels: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold (x/255 - mean)/std into the patch-embedding GEMM.

    ``w`` is the (C*p*p, D) embedding with channel-major patch ordering.
    Returns fp32 (w_folded, b_folded) such that
    ``u8 @ w_folded + b_folded == normalize(u8) @ w + b``.
    """
    mean = torch.as_tensor(mean, dtype=torch.float32, device=w.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=w.device)
    pp = patch_size * patch_size
    scale = torch.repeat_interleave(1.0 / (255.0 * std), pp)  # [C*p*p]
    shift = torch.repeat_interleave(-mean / std, pp)  # [C*p*p]
    w32 = w.float()
    wf = w32 * scale[:, None]
    bf = shift @ w32
    if b is not None:
        bf = bf + b.float()
    return wf, bf


def extract_patches_plain(images_hwc: np.ndarray, patch_size: int) -> np.ndarray:
    """Plain version of ``extract_patches_u8``: NumPy's strided copy."""
    B, H, W, C = images_hwc.shape
    p = patch_size
    nh, nw = H // p, W // p
    x = images_hwc.reshape(B, nh, p, nw, p, C)
    x = x.transpose(0, 1, 3, 5, 2, 4)  # [B, nh, nw, C, p, p]
    return np.ascontiguousarray(x.reshape(B, nh * nw, C * p * p))


def gather_patches_u8(src: np.ndarray, rows: Optional[np.ndarray], patch_size: int,
                      out: Optional[np.ndarray] = None, threads: int = 8) -> np.ndarray:
    """Host-side: rows ``rows`` of ``src`` ([n, H, W, C] uint8 crops; all of
    them where ``rows`` is None; a row of -1 is a pad of zeros) -> [B, N,
    C*p*p] patch rows in the channel-major order the folded GEMM expects,
    written into ``out`` where given (a pinned buffer's view, say).

    One native call on up to ``threads`` threads, outside the interpreter
    lock (``data/native.gather_patches_u8``), wherever the host library
    loads; else ``extract_patches_plain`` of the gathered rows."""
    from multimodal_content_moderation_tpu_torch.data import native

    n, H, W, C = src.shape
    p = patch_size
    rows = np.arange(n, dtype=np.int64) if rows is None else np.asarray(rows, np.int64)
    if out is None:
        out = np.empty((len(rows), (H // p) * (W // p), C * p * p), np.uint8)
    if native.available():
        return native.gather_patches_u8(np.ascontiguousarray(src), rows, p, out, threads)
    keep = rows >= 0
    out[~keep] = 0
    out[keep] = extract_patches_plain(src[rows[keep]], p)
    return out


def extract_patches_u8(images_hwc: np.ndarray, patch_size: int) -> np.ndarray:
    """Host-side: [B, H, W, C] uint8 -> [B, N, C*p*p] patch rows in the
    channel-major order the folded GEMM expects (``gather_patches_u8`` of
    every row)."""
    return gather_patches_u8(images_hwc, None, patch_size)


def patch_embed_reference(
    patches_u8: torch.Tensor,
    w_folded: torch.Tensor,
    b_folded: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of ``patch_embed_u8``: fp32 product, bias, cast."""
    x = patches_u8.float()
    return (torch.matmul(x, w_folded.float()) + b_folded.float()).to(out_dtype)


def _patch_embed_launch(patches_u8, w_folded, b_folded, out_dtype, tensor_cores: bool):
    """Check the inputs and launch one kernel: the tensor-core one (bf16
    output only) or the SIMT one (fp32 or bf16). Returns the output and
    whether a kernel was launched (none is for an empty output)."""
    if patches_u8.device.type != "cuda":
        raise ValueError(f"patch_embed_u8: unsupported device {patches_u8.device}")
    if patches_u8.dtype != torch.uint8 or patches_u8.dim() != 3:
        raise ValueError(
            f"patch_embed_u8: want uint8 [B, N, K], got {patches_u8.dtype} "
            f"{tuple(patches_u8.shape)}"
        )
    B, N, K = patches_u8.shape
    if w_folded.dtype != torch.float32 or tuple(w_folded.shape[:1]) != (K,) or w_folded.dim() != 2:
        raise ValueError(
            f"patch_embed_u8: want fp32 w_folded [{K}, D], got {w_folded.dtype} "
            f"{tuple(w_folded.shape)}"
        )
    D = w_folded.shape[1]
    if b_folded.dtype != torch.float32 or tuple(b_folded.shape) != (D,):
        raise ValueError(
            f"patch_embed_u8: want fp32 b_folded [{D}], got {b_folded.dtype} "
            f"{tuple(b_folded.shape)}"
        )
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch_embed_u8: unsupported out_dtype {out_dtype}")
    for name, t in (("patches_u8", patches_u8), ("w_folded", w_folded), ("b_folded", b_folded)):
        if t.device != patches_u8.device:
            raise ValueError(f"patch_embed_u8: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"patch_embed_u8: {name} is not contiguous")
    out = torch.empty((B, N, D), dtype=out_dtype, device=patches_u8.device)
    if B * N == 0:
        return out, False
    ptrs = (patches_u8.data_ptr(), w_folded.data_ptr(), b_folded.data_ptr(), out.data_ptr())
    stream = _build.stream_ptr(patches_u8.device)
    if tensor_cores:
        lib = _lib("mma_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        err = lib.patch_embed_u8_mma_launch(*ptrs, B * N, K, D, stream)
    else:
        lib = _lib("launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        err = lib.patch_embed_u8_launch(*ptrs, B * N, K, D, int(out_dtype == torch.bfloat16),
                                        stream)
    _build.check(lib, "patch_embed_u8", err)
    return out, True


def patch_embed_u8(
    patches_u8: torch.Tensor,
    w_folded: torch.Tensor,
    b_folded: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[B, N, K] uint8 patch rows -> [B, N, D] embedded tokens.

    On the card: a bf16 output runs the tensor-core kernel, an fp32 output
    the SIMT kernel, chosen by dtype before the launch (both counted in
    ``patch_embed_u8.launches``, the bf16 ones also in
    ``patch_embed_u8.tensor_core_launches``). On the CPU: the plain version."""
    if patches_u8.device.type == "cpu":
        return patch_embed_reference(patches_u8, w_folded, b_folded, out_dtype)
    tensor_cores = out_dtype == torch.bfloat16
    out, launched = _patch_embed_launch(patches_u8, w_folded, b_folded, out_dtype, tensor_cores)
    if launched:
        patch_embed_u8.launches += 1
        patch_embed_u8.tensor_core_launches += int(tensor_cores)
    return out


patch_embed_u8.launches = 0
patch_embed_u8.tensor_core_launches = 0


def patch_embed_u8_simt(
    patches_u8: torch.Tensor,
    w_folded: torch.Tensor,
    b_folded: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The SIMT kernel for either output dtype, on the card only and not
    counted: the earlier bf16 design, kept as a yardstick for the
    tensor-core kernel (``chip_smoke.py`` times the two in one process)."""
    return _patch_embed_launch(patches_u8, w_folded, b_folded, out_dtype, False)[0]


class _PatchEmbedU8(torch.autograd.Function):
    """``patch_embed_u8`` forward; the backward is the JAX package's
    ``_embed_train_bwd``, plain products outside any kernel:
    dW = x^T g and db = sum(g) in fp32, no gradient for the uint8 rows."""

    @staticmethod
    def forward(ctx, patches_u8, w_folded, b_folded, out_dtype):
        ctx.save_for_backward(patches_u8)
        return patch_embed_u8(patches_u8, w_folded, b_folded, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (patches_u8,) = ctx.saved_tensors
        K = patches_u8.shape[-1]
        x = patches_u8.reshape(-1, K).float()  # widened before any product
        g32 = g.reshape(-1, g.shape[-1]).float()
        return None, x.t() @ g32, g32.sum(dim=0), None


def patch_embed_u8_train(
    patches_u8: torch.Tensor,
    w_folded: torch.Tensor,
    b_folded: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Differentiable ``patch_embed_u8``: gradients reach ``w_folded`` and
    ``b_folded`` (and through the fold, the embedding weight)."""
    return _PatchEmbedU8.apply(patches_u8, w_folded, b_folded, out_dtype)


def _lib(entry: str, argtypes) -> ctypes.CDLL:
    """The library of ``csrc/patch_embed_u8.cu`` with ``patch_embed_u8_<entry>``'s
    types set."""
    lib = _build.load("patch_embed_u8")
    fn = getattr(lib, f"patch_embed_u8_{entry}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib
