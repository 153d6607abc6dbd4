#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, and the five kernels built from ``csrc/`` with nvcc (one
   process per source, started together), with their ``-Xptxas -v`` lines.
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the shapes of the eval, training, SigLIP-384, SigLIP-224 and
   SigLIP-224 training paths and a few edge shapes, each held to a stated
   tolerance, and timed (kernel, plain version, one PyTorch library call as
   a yardstick the port never calls) beside the card's bound for the same
   work. Each time is the device's: 50 calls captured in a CUDA graph and
   timed over one replay with CUDA events (``timed_by`` "graph"), or, for a
   call that cannot be captured, CUDA events around 50 eager calls
   ("events"). The attention kernels' yardstick is
   ``F.scaled_dot_product_attention`` on the same [B, H, T, dh] inputs; the
   backward's is SDPA's backward (forward + backward through autograd, less
   the forward); the embed's an fp32 ``matmul``. Every bf16 call of the
   five kernels runs on the tensor cores; at the paths' shapes (for
   ``attention_small`` at every shape: [B, H, T, dh] views with a broadcast
   [B, 1, T, S] mask, and the contiguous [B*H, T, S] form of the JAX
   contract) the earlier SIMT kernel (still built, for fp32) is timed
   beside it on the same bf16 inputs, in the order SIMT, tensor cores,
   tensor cores, SIMT.
3. The full-width CLIP ViT-B/32 fusion model (random weights from a seed):
   written as a reference-format checkpoint, loaded with ``load_checkpoint``,
   run through ``FastInferenceEngine`` + ``evaluate_logits_u8`` in bf16 with
   the kernels, with text buckets off and on; the launch counters must show
   1 patch_embed_u8 and 24 attention_nhd launches per batch, every one of
   them on the tensor cores (``tensor_core_launches``); fp32 logits on
   the card must match the same model's CPU logits; the checkpoint written
   again as ``model.safetensors`` (a writer in this script) must load
   through ``load_checkpoint`` without the ``safetensors`` package, with
   logits equal to the ``.bin``'s (difference 0.0); ``--engine standard``
   (``evaluate_logits_standard`` over float_nchw pixels made from the same
   uint8 crops with ``normalize_crop``, no PIL) must match the fast engine in
   fp32 (atol 1e-4); ``compute_detailed_metrics`` runs on the card's
   logits; staged-batch samples/s at seq 77 and at the seq-32 bucket.
4. Fine-tuning at full width: ``Trainer`` on the same model (fp32 master
   weights, bf16 towers, the kernels in both passes, u8 wire, batch 32,
   gradient accumulation 2, ``text_fit`` width 48) for a few optimizer
   steps, an eval and a checkpoint, then a resume from ``trainstate-*`` and
   one more optimizer step. The launch counters must show 1
   ``patch_embed_u8``, 24 ``attention_nhd`` and 24 ``attention_nhd_bwd``
   launches per micro-step (eval batches counted apart), all on the tensor
   cores. Leafwise fp32 gradients on the card (kernels, TF32 off) must
   match the CPU's (plain versions) on every leaf; the bf16 ``dense`` and its gradients must
   match autograd of its plain definition within one bf16 rounding at the
   towers' MLP shapes; the loss on a fixed batch must fall over 10
   optimizer steps; then training samples/s, the time of forward, backward
   and optimizer, and a profiler breakdown of one optimizer step.
5. The full-width SigLIP2-B/16 fusion model at 384 px
   (``google/siglip2-base-patch16-384``'s dimensions, random weights from a
   seed): a reference-format checkpoint through ``load_checkpoint`` ->
   ``FastInferenceEngine`` -> ``evaluate_logits_u8`` in bf16 with the
   kernels, B=64, text buckets off and on (the carry column); the counters
   must show 1 ``patch_embed_u8``, 12 ``attention_nhd`` (text, key mask) and
   12 ``flash_attention`` (vision, T=576) launches per batch, all on the
   tensor cores; fp32 logits on the card must match the
   CPU's, bucketed logits the unbucketed ones; staged-batch samples/s and
   a profiler breakdown. Then the shipped SigLIP2-B/16-224
   (``config/siglip_fusion.yaml``: ``google/siglip2-base-patch16-224``'s
   dimensions) through ``load_checkpoint`` -> ``FastInferenceEngine``, B=64,
   text seq 64, 2 staged passes: 1 ``patch_embed_u8`` and 24
   ``attention_nhd`` (vision T=196 and text), all on the tensor cores, and no
   ``flash_attention`` per batch, samples/s and a profiler breakdown. Then
   ``ops.layers.mha(impl="pallas")`` with a dense mask, which must launch
   ``attention_small`` once per call (the bf16 call on the tensor cores),
   against the "xla" core.
6. The shipped fine-tuning configs on the f32 wire through ``Trainer``:
   CLIP as ``config/clip_fusion.yaml`` ships it (attention "xla", bf16,
   B=32 x 2; no kernel runs), with the f32 wire's micro-step loss held
   against the u8 wire's on the same rows and dropout draw; and
   SigLIP2-B/16-224 at ``config/siglip_fusion.yaml`` settings (full width
   and depth, B=24 x 2, text seq 64), once as shipped (attention "xla") and
   once with attention "pallas" (``attention_nhd`` and
   ``attention_nhd_bwd`` at vision T=196 and on the text key mask, counted
   exactly, all on the tensor cores), each with a falling loss on a fixed
   batch and CUDA-event forward / backward / optimizer ms per micro-step;
   then fp32 card-vs-CPU SigLIP gradients on every leaf.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Per-case details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "multimodal_content_moderation_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

BATCH = 144  # bench.py's main-path batch
N_EVAL_BATCHES = 8
TRAIN_BATCH = 32  # config/clip_fusion.yaml: batch 32, gradient accumulation 2
TRAIN_ACCUM = 2
TRAIN_SEQ = 48  # text_fit of the in-memory rows (EOS by position 40)
TIMED_ITERS = 50
SIGLIP_BATCH = 64  # config/default.yaml per_device_eval_batch_size
N_SIGLIP_BATCHES = 4
SIGLIP_T = 576  # (384 / 16)^2 patch tokens, no class token
SIGLIP224_T = 196  # (224 / 16)^2: config/siglip_fusion.yaml's google/siglip2-base-patch16-224
N_SIGLIP224_BATCHES = 8  # staged batches per pass
SIGLIP_TRAIN_BATCH = 24  # config/siglip_fusion.yaml: batch 24, gradient accumulation 2
# the attention shapes of one SigLIP2-B/16-224 training micro-step (both
# passes): B, T, D, heads, causal, key mask, label
SIGLIP224_TRAIN_SPECS = [
    (SIGLIP_TRAIN_BATCH, SIGLIP224_T, 768, 12, False, False, "siglip224 train path: vision tower"),
    (SIGLIP_TRAIN_BATCH, 64, 768, 12, False, True,
     "siglip224 train path: text tower, seq 64, key mask"),
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = TIMED_ITERS):
    """Mean device ms of one call of ``fn``, and how it was read. "graph":
    after 3 warm calls on a side stream, ``iters`` calls are captured in one
    CUDA graph, which is replayed once and then timed with CUDA events
    around one replay: the device's time alone, even for calls shorter than
    the host's launch overhead. "events": where ``fn`` cannot be captured
    (the capture raised), CUDA events around ``iters`` eager calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except Exception:  # noqa: BLE001 - not capturable: timed eagerly below
        graph = None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph is not None:
        graph.replay()
        start.record()
        graph.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "graph" if graph is not None else "events"


def timed(case: dict, key: str, fn, iters: int = TIMED_ITERS) -> float:
    """``case[key]`` = ``time_ms(fn)``; how it was read goes to
    ``case["timed_by"][key]``."""
    case[key], case.setdefault("timed_by", {})[key] = time_ms(fn, iters)
    return case[key]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _paths(label: str, dtype: str):
    """The paths whose unit of work a bf16 case times: "evaluate" (CLIP,
    B=144), "train" (CLIP, B=32), "siglip384" and "siglip224" (SigLIP2-B/16
    at 384 and 224 px, B=64; "siglip text" is the text tower of both),
    "siglip224_train" (SigLIP2-B/16-224 training, B=24), "mha_dense_mask"."""
    if dtype != "bfloat16":
        return []
    return {"main path": ["evaluate"], "train path": ["train"],
            "siglip384 path": ["siglip384"], "siglip224 path": ["siglip224"],
            "siglip text": ["siglip384", "siglip224"],
            "siglip224 train path": ["siglip224_train"],
            "mha dense mask": ["mha_dense_mask"]}.get(label.split(":")[0], [])


def simt_beside(case, new_fn, simt_fn, want, atol, rtol):
    """Times the earlier SIMT kernel beside the tensor-core one on the same
    bf16 inputs, in the order SIMT, new, new, SIMT, and checks the SIMT
    output (one tensor or a tuple of them) against the plain version too.
    Sets ``ms`` to the mean of the two new timings."""
    got = simt_fn()
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    errs = [max_err_within(a, b, atol, rtol) for a, b in pairs]
    err = max(e for e, _ in errs)
    check(all(ok for _, ok in errs), f"SIMT {case['kernel']} {case['case']}: max abs err {err}")
    order = [time_ms(simt_fn), time_ms(new_fn), time_ms(new_fn), time_ms(simt_fn)]
    case.update(ms=(order[1][0] + order[2][0]) / 2, simt_ms=(order[0][0] + order[3][0]) / 2,
                simt_new_new_simt_ms=[t for t, _ in order], simt_max_abs_err=err)
    case["timed_by"].update(ms=_how(order[1][1], order[2][1]),
                            simt_ms=_how(order[0][1], order[3][1]))


def _how(*reads: str) -> str:
    """"graph" where every reading came from a CUDA graph, else "events"."""
    return "graph" if all(r == "graph" for r in reads) else "events"


def _sdpa_mask(torch, keep, causal, T, S):
    """SDPA's boolean attn_mask for a key-keep row [B, S] and/or causal."""
    mask = None if keep is None else keep[:, None, None, :]
    if causal:
        tril = torch.ones(T, S, dtype=torch.bool, device="cuda").tril()
        mask = tril if mask is None else mask & tril
    return mask


def _keep_rows(torch, g, B, S):
    """Right padding of varied lengths; batch row 0 has every key masked."""
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    lengths[0] = 0
    return torch.arange(S, device="cuda")[None, :] < lengths[:, None]


def max_err_within(got, want, atol: float, rtol: float):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(got.isfinite().all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def patch_embed_cases(torch, g):
    from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci

    # fp32: sums of 3072 fp32 products; bf16: one rounding of the output
    tol = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)}
    cases = []
    for R, K, D, label in [
        (BATCH * 49, 3072, 768, "main path: ViT-B/32, B=144"),
        (TRAIN_BATCH * 49, 3072, 768, "train path: ViT-B/32, B=32"),
        (1000, 3072, 768, "ragged rows"),
        (BATCH * 49, 768, 768, "K=768 with a checkpoint bias"),
        (SIGLIP_BATCH * SIGLIP_T, 768, 768, "siglip384 path: SigLIP2-B/16-384 with its bias, B=64"),
        (SIGLIP_BATCH * SIGLIP224_T, 768, 768,
         "siglip224 path: SigLIP2-B/16-224 with its bias, B=64"),
    ]:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            x = torch.randint(0, 256, (1, R, K), generator=g, device="cuda", dtype=torch.uint8)
            w = torch.randn(K, D, generator=g, device="cuda") * 0.02
            b = torch.randn(D, generator=g, device="cuda") * 0.1 if K == 768 else None
            wf, bf = ci.fold_norm_into_embed(w, b, (0.48, 0.46, 0.41), (0.27, 0.26, 0.28),
                                             int((K // 3) ** 0.5))
            wf, bf = wf.contiguous(), bf.contiguous()
            got = ci.patch_embed_u8(x, wf, bf, dt)
            want = ci.patch_embed_reference(x, wf, bf, dt)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            err, ok = max_err_within(got, want, atol, rtol)
            check(ok, f"patch_embed_u8 {label} {dtype}: max abs err {err} beyond "
                      f"atol {atol} + rtol {rtol}")
            nbytes = R * K + K * D * 4 + D * 4 + R * D * dt.itemsize
            # the JAX cost estimate's 2 R K D: at the bf16 tensor-core rate for
            # the bf16 output (the hi/lo split's doubling is the design's own
            # cost), at the fp32 SIMT rate for the fp32 one
            bms, by = bound_ms(nbytes, 2.0 * R * K * D, dtype)
            case = {
                "kernel": "patch_embed_u8", "case": f"{label}: R={R} K={K} D={D}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "paths": _paths(label, dtype), "bound_ms": bms, "bound_by": by,
            }
            timed(case, "ms", lambda: ci.patch_embed_u8(x, wf, bf, dt))
            timed(case, "plain_ms", lambda: ci.patch_embed_reference(x, wf, bf, dt))
            timed(case, "library_ms", lambda: torch.matmul(x.float(), wf))
            if case["paths"]:  # a path's shape: the earlier SIMT kernel beside
                simt_beside(case, lambda: ci.patch_embed_u8(x, wf, bf, dt),
                            lambda: ci.patch_embed_u8_simt(x, wf, bf, dt), want, atol, rtol)
            cases.append(case)
    return cases


def attention_cases(torch, g):
    import torch.nn.functional as F

    from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca

    # fp32: the same fp32 math summed in another order; bf16: one rounding
    # of the output (1 ulp is 2^-7 of |x| at most)
    tol = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2.0**-7)}
    specs = [(BATCH, 50, 768, 12, False, False, "main path: vision tower")]
    specs += [(BATCH, T, 512, 8, True, True, f"main path: text tower, seq {T}")
              for T in (77, 32, 48, 64)]
    specs += [(16, T, 768, 12, False, True, f"key mask, seq {T}") for T in (131, 196, 197)]
    specs += [(TRAIN_BATCH, 50, 768, 12, False, False, "train path: vision tower"),
              (TRAIN_BATCH, TRAIN_SEQ, 512, 8, True, True,
               f"train path: text tower, seq {TRAIN_SEQ}")]
    specs += [(SIGLIP_BATCH, 64, 768, 12, False, True,
               "siglip text: text tower, seq 64, key mask, not causal"),
              (SIGLIP_BATCH, SIGLIP224_T, 768, 12, False, False, "siglip224 path: vision tower")]
    specs += SIGLIP224_TRAIN_SPECS
    # the shapes at which the earlier SIMT kernel is timed beside the new one
    simt_at = {"main path: vision tower", "main path: text tower, seq 77",
               "siglip224 path: vision tower"}
    cases = []
    for B, T, D, h, causal, with_km, label in specs:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(B, T, D, generator=g, device="cuda").to(dt) for _ in range(3))
            km = keep = None
            if with_km:
                keep = _keep_rows(torch, g, B, T)
                km = (1.0 - keep.float()) * ca.NEG_INF
            got = ca.attention_nhd(q, k, v, h, km, causal)
            want = ca.attention_nhd_reference(q, k, v, h, km, causal)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            err, ok = max_err_within(got, want, atol, rtol)
            check(ok, f"attention_nhd {label} {dtype}: max abs err {err} beyond "
                      f"atol {atol} + rtol {rtol}")
            pairs = B * h * (T * (T + 1) // 2 if causal else T * T)
            nbytes = 4 * B * T * D * dt.itemsize + (B * T * 4 if with_km else 0)
            bms, by = bound_ms(nbytes, 4.0 * pairs * (D // h), dtype)
            qh, kh, vh = (t.view(B, T, h, D // h).transpose(1, 2) for t in (q, k, v))
            mask = _sdpa_mask(torch, keep, causal, T, T)
            paths = _paths(label, dtype)
            case = {
                "kernel": "attention_nhd", "case": f"{label}: B={B} T={T} D={D} heads={h}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                # the eval path's unit is the vision tower + the seq-77 text tower
                "paths": [] if ("evaluate" in paths and T not in (50, 77)) else paths,
                "bound_ms": bms, "bound_by": by,
            }
            timed(case, "ms", lambda: ca.attention_nhd(q, k, v, h, km, causal))
            timed(case, "plain_ms", lambda: ca.attention_nhd_reference(q, k, v, h, km, causal))
            timed(case, "library_ms",
                  lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
            if dtype == "bfloat16" and label in simt_at:
                simt_beside(case, lambda: ca.attention_nhd(q, k, v, h, km, causal),
                            lambda: ca.attention_nhd_simt(q, k, v, h, km, causal),
                            want, atol, rtol)
            cases.append(case)
    return cases


def flash_cases(torch, g):
    """``flash_attention`` on [B, T, D] memory viewed as [B, H, T, dh], the
    view ``ops.layers.mha`` passes it."""
    import torch.nn.functional as F

    from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
    from multimodal_content_moderation_tpu_torch.ops import cuda_flash as cf

    # fp32: the same fp32 math, an online softmax against one softmax;
    # bf16: one rounding of the output (1 ulp is 2^-7 of |x| at most)
    tol = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)}
    B = SIGLIP_BATCH
    specs = [  # B, T, S, D, heads, mask kind, causal, label
        (B, SIGLIP_T, SIGLIP_T, 768, 12, None, False, "siglip384 path: vision tower, no mask"),
        (B, SIGLIP_T, SIGLIP_T, 768, 12, "key", False, "key mask, seq 576"),
        (16, 300, 300, 768, 12, "key", True, "causal + key mask, ragged seq 300"),
        (16, 384, 384, 768, 12, "dense", False, "dense mask, seq 384"),
        (B, 128, SIGLIP_T, 768, 12, None, False, "cross attention, Tq 128, S 576"),
    ]
    cases = []
    for B, T, S, D, h, kind, causal, label in specs:
        dh = D // h
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q3 = torch.randn(B, T, D, generator=g, device="cuda").to(dt)
            k3, v3 = (torch.randn(B, S, D, generator=g, device="cuda").to(dt) for _ in range(2))
            q, k, v = (t.view(B, t.shape[1], h, dh).transpose(1, 2) for t in (q3, k3, v3))
            mask = km = keep = None
            extra_bytes = 0
            if kind == "key":
                keep = _keep_rows(torch, g, B, S)
                km = (1.0 - keep.float()) * ca.NEG_INF
                extra_bytes = B * S * 4
            elif kind == "dense":
                drop = torch.rand(B, 1, T, S, generator=g, device="cuda") < 0.2
                drop[..., 0] = False
                mask = torch.where(drop, ca.NEG_INF, 0.0)
                extra_bytes = B * T * S * 4
            got = cf.flash_attention(q, k, v, mask, km, causal)
            want = cf.flash_attention_reference(q, k, v, mask, km, causal)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            err, ok = max_err_within(got, want, atol, rtol)
            check(ok, f"flash_attention {label} {dtype}: max abs err {err} beyond "
                      f"atol {atol} + rtol {rtol}")
            # the pairs this run computes: a causal row t needs keys 0..t
            pairs = sum(min(t + 1, S) for t in range(T)) if causal else T * S
            nbytes = 2 * (B * T * D + B * S * D) * dt.itemsize + extra_bytes
            bms, by = bound_ms(nbytes, 4.0 * B * h * pairs * dh, dtype)
            sdpa_mask = (~drop) if kind == "dense" else _sdpa_mask(torch, keep, causal, T, S)
            case = {
                "kernel": "flash_attention",
                "case": f"{label}: B={B} T={T} S={S} D={D} heads={h}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "paths": _paths(label, dtype), "bound_ms": bms, "bound_by": by,
            }
            timed(case, "ms", lambda: cf.flash_attention(q, k, v, mask, km, causal))
            timed(case, "plain_ms",
                  lambda: cf.flash_attention_reference(q, k, v, mask, km, causal), iters=10)
            timed(case, "library_ms",
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
            if dtype == "bfloat16" and label.startswith("siglip384 path"):
                simt_beside(case, lambda: cf.flash_attention(q, k, v, mask, km, causal),
                            lambda: cf.flash_attention_simt(q, k, v, mask, km, causal),
                            want, atol, rtol)
            cases.append(case)
    return cases


def small_cases(torch, g):
    """``attention_small`` with the mask forms fused_mha gives it (a dense
    mask, none, and causal + key padding folded into one), in the two
    layouts: [B, H, T, dh] views of [B, T, D] memory with the mask read
    broadcast ([B, 1, T, S], the layout ``mha`` passes), and contiguous
    [B*H, T, dh] with a [B*H, T, S] mask (the JAX contract)."""
    import torch.nn.functional as F

    from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
    from multimodal_content_moderation_tpu_torch.ops import cuda_flash as cf

    tol = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)}
    B = SIGLIP_BATCH
    specs = [  # B, H, T, dh, mask kind, layout, label
        (B, 8, 77, 64, "dense", "views", "mha dense mask: CLIP text shape, seq 77"),
        (B, 8, 77, 64, "dense", "contiguous", "contiguous [BH, T, S] dense mask, seq 77"),
        (B, 12, 50, 64, None, "views", "no mask, seq 50"),
        (B, 8, 77, 64, "folded", "views", "folded causal + key mask, seq 77"),
    ]
    cases = []
    for B, H, T, dh, kind, layout, label in specs:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q3, k3, v3 = (torch.randn(B, T, H * dh, generator=g, device="cuda").to(dt)
                          for _ in range(3))
            q, k, v = (t.view(B, T, H, dh).transpose(1, 2) for t in (q3, k3, v3))
            mask = keep4 = None
            if kind is not None:
                keep = _keep_rows(torch, g, B, T)
                # batch row 0 keeps key 0: no row is -inf throughout (that
                # gives NaN, in the kernel as in its plain version)
                keep[0, 0] = True
                if kind == "dense":
                    keep4 = keep[:, None, None, :] & (
                        torch.rand(B, 1, T, T, generator=g, device="cuda") < 0.8)
                    keep4[..., 0] = True
                    mask = torch.where(keep4, 0.0, ca.NEG_INF)
                else:  # fused_mha's fold: zeros + causal + the key row
                    causal = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
                    mask = (torch.zeros(1, 1, T, T, device="cuda")
                            + torch.where(causal, 0.0, ca.NEG_INF)
                            + ((1.0 - keep.float()) * ca.NEG_INF)[:, None, None, :])
                    keep4 = keep[:, None, None, :] & causal
            if layout == "contiguous":
                q, k, v = (t.reshape(B * H, T, dh) for t in (q, k, v))
                if mask is not None:
                    mask = mask.expand(B, H, T, T).reshape(B * H, T, T).contiguous()
            before = (cf.attention_small.launches, cf.attention_small.tensor_core_launches)
            got = cf.attention_small(q, k, v, mask)
            launched = (cf.attention_small.launches - before[0],
                        cf.attention_small.tensor_core_launches - before[1])
            # one launch, on the tensor cores exactly when bf16
            check(launched == (1, int(dtype == "bfloat16")),
                  f"attention_small {label} {dtype}: (launches, tensor-core launches) {launched}")
            want = cf.attention_small_reference(q, k, v, mask)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            err, ok = max_err_within(got, want, atol, rtol)
            check(ok, f"attention_small {label} {dtype}: max abs err {err} beyond "
                      f"atol {atol} + rtol {rtol}")
            # q, k, v and out once each, and the fp32 mask as passed: [B, 1,
            # T, S] read through a head stride of 0 in the views layout,
            # [B*H, T, S] in the contiguous one
            qkvo = 4 * B * H * T * dh * dt.itemsize
            flops = 4.0 * B * H * T * T * dh
            bms, by = bound_ms(qkvo + (4 * mask.numel() if kind else 0), flops, dtype)
            # the JAX cost estimate (pallas_attention.py:95-101) counts an
            # expanded [B*H, T, S] mask whatever the layout
            jax_ms, _ = bound_ms(qkvo + (4 * B * H * T * T if kind else 0), flops, dtype)
            q4, k4, v4 = (t.view(B, H, T, dh) for t in (q, k, v))
            case = {
                "kernel": "attention_small",
                "case": f"{label}: {layout}, BH={B * H} T={T} dh={dh}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "tensor_core": bool(launched[1]),
                "paths": _paths(label, dtype), "bound_ms": bms, "bound_by": by,
                "jax_estimate_ms": jax_ms,
            }
            timed(case, "ms", lambda: cf.attention_small(q, k, v, mask))
            timed(case, "plain_ms", lambda: cf.attention_small_reference(q, k, v, mask))
            timed(case, "library_ms",
                  lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep4))
            if dtype == "bfloat16":  # the earlier SIMT kernel beside, every layout
                simt_beside(case, lambda: cf.attention_small(q, k, v, mask),
                            lambda: cf.attention_small_simt(q, k, v, mask), want, atol, rtol)
            cases.append(case)
    return cases


def attention_bwd_cases(torch, g):
    import torch.nn.functional as F

    from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca

    # fp32: the same fp32 math summed in another order; bf16: one rounding
    # of each gradient (1 ulp is 2^-7 of |x| at most)
    tol = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)}
    specs = [
        (TRAIN_BATCH, 50, 768, 12, False, False, "train path: vision tower"),
        (TRAIN_BATCH, TRAIN_SEQ, 512, 8, True, True, f"train path: text tower, seq {TRAIN_SEQ}"),
        (TRAIN_BATCH, 77, 512, 8, True, True, "text tower, seq 77"),
    ]
    specs += [(16, T, 768, 12, False, True, f"key mask, seq {T}") for T in (131, 196, 197)]
    specs += [(4, 256, 256, 2, True, True, "seq 256, head dim 128")]
    specs += SIGLIP224_TRAIN_SPECS
    cases = []
    for B, T, D, h, causal, with_km, label in specs:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, do = (torch.randn(B, T, D, generator=g, device="cuda").to(dt) for _ in range(4))
            km, keep = None, None
            if with_km:
                # right padding of varied lengths; row 0 has every key masked
                lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
                lengths[0] = 0
                keep = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
                km = (1.0 - keep.float()) * ca.NEG_INF
            got = ca.attention_nhd_bwd(q, k, v, do, h, km, causal)
            want = ca.attention_nhd_bwd_reference(q, k, v, do, h, km, causal)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            errs = [max_err_within(a, b, atol, rtol) for a, b in zip(got, want)]
            err = max(e for e, _ in errs)
            check(all(ok for _, ok in errs),
                  f"attention_nhd_bwd {label} {dtype}: max abs err {err} beyond "
                  f"atol {atol} + rtol {rtol}")
            # the JAX cost estimate (pallas_attention.py:478-482)
            nbytes = (3 * T + 4 * T) * B * D * dt.itemsize + (B * T * 4 if with_km else 0)
            flops = 10.0 * B * h * T * T * (D // h) * (0.5 if causal else 1.0)
            bms, by = bound_ms(nbytes, flops, dtype)
            # yardstick: SDPA's backward (forward + backward, less the forward)
            heads = [t.view(B, T, h, D // h).transpose(1, 2).detach().requires_grad_()
                     for t in (q, k, v)]
            doh = do.view(B, T, h, D // h).transpose(1, 2)
            mask = None
            if with_km:
                mask = keep[:, None, None, :]
                if causal:
                    mask = mask & torch.ones(T, T, dtype=torch.bool, device="cuda").tril()

            def sdpa():
                return F.scaled_dot_product_attention(
                    *heads, attn_mask=mask, is_causal=causal and mask is None)

            case = {
                "kernel": "attention_nhd_bwd", "case": f"{label}: B={B} T={T} D={D} heads={h}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "paths": _paths(label, dtype), "bound_ms": bms, "bound_by": by,
            }
            timed(case, "ms", lambda: ca.attention_nhd_bwd(q, k, v, do, h, km, causal))
            timed(case, "plain_ms",
                  lambda: ca.attention_nhd_bwd_reference(q, k, v, do, h, km, causal), iters=10)
            fwd_ms = timed(case, "library_fwd_ms", lambda: sdpa().detach())
            both_ms = timed(case, "library_fwd_bwd_ms",
                            lambda: torch.autograd.grad(sdpa(), heads, doh))
            case["library_ms"] = max(both_ms - fwd_ms, 0.0)
            case["timed_by"]["library_ms"] = _how(case["timed_by"]["library_fwd_ms"],
                                                  case["timed_by"]["library_fwd_bwd_ms"])
            if case["paths"]:  # a path's shape: the earlier SIMT kernels beside
                simt_beside(case, lambda: ca.attention_nhd_bwd(q, k, v, do, h, km, causal),
                            lambda: ca.attention_nhd_bwd_simt(q, k, v, do, h, km, causal),
                            want, atol, rtol)
            cases.append(case)
    return cases


# ---------------------------------------------------------------------------
# Phase 3: the full-width model
# ---------------------------------------------------------------------------

HF_CLIP_B32 = {  # openai/clip-vit-base-patch32 config.json (the dimensions)
    "model_type": "clip",
    "projection_dim": 512,
    "text_config": {
        "vocab_size": 49408, "hidden_size": 512, "num_hidden_layers": 12,
        "num_attention_heads": 8, "intermediate_size": 2048,
        "max_position_embeddings": 77, "eos_token_id": 49407, "bos_token_id": 49406,
        "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
    },
    "vision_config": {
        "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
        "intermediate_size": 3072, "image_size": 224, "patch_size": 32,
        "num_channels": 3, "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
    },
}
CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]


HF_SIGLIP2_B16_384 = {  # google/siglip2-base-patch16-384 config.json (the dimensions)
    "model_type": "siglip",
    "text_config": {
        "vocab_size": 256000, "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 3072,
        "max_position_embeddings": 64, "projection_size": 768,
        "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6,
    },
    "vision_config": {
        "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
        "intermediate_size": 3072, "image_size": 384, "patch_size": 16,
        "num_channels": 3, "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6,
    },
}


# google/siglip2-base-patch16-224 (config/siglip_fusion.yaml): the same towers
# at 224 px, 196 patches
HF_SIGLIP2_B16_224 = {
    **HF_SIGLIP2_B16_384,
    "vision_config": {**HF_SIGLIP2_B16_384["vision_config"], "image_size": 224},
}


def reference_state_dict(model) -> dict:
    """The port's parameter tree -> reference fusion checkpoint keys
    (``backbone.*`` in the HF CLIPModel or SiglipModel layout + head), the
    layout ``models/convert.py`` reads."""
    import torch

    bb, hd = model.backbone, model.head
    sd = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = p["w"].t()
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]

    def layers(prefix, ls):
        for i, lp in enumerate(ls):
            b = f"{prefix}.encoder.layers.{i}"
            ln(f"{b}.layer_norm1", lp["ln1"])
            for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                lin(f"{b}.self_attn.{hf}", lp["attn"][n])
            ln(f"{b}.layer_norm2", lp["ln2"])
            lin(f"{b}.mlp.fc1", lp["fc1"])
            lin(f"{b}.mlp.fc2", lp["fc2"])

    t, v = bb["text_model"], bb["vision_model"]
    vc = model.encoder_config.vision
    sd["backbone.text_model.embeddings.token_embedding.weight"] = t["token_embedding"]
    sd["backbone.text_model.embeddings.position_embedding.weight"] = t["position_embedding"]
    layers("backbone.text_model", t["layers"])
    ln("backbone.text_model.final_layer_norm", t["final_ln"])
    pe = v["patch_embedding"]
    sd["backbone.vision_model.embeddings.patch_embedding.weight"] = pe["w"].t().reshape(
        vc.hidden_size, vc.num_channels, vc.patch_size, vc.patch_size
    )
    if "b" in pe:
        sd["backbone.vision_model.embeddings.patch_embedding.bias"] = pe["b"]
    sd["backbone.vision_model.embeddings.position_embedding.weight"] = v["position_embedding"]
    layers("backbone.vision_model", v["layers"])
    ln("backbone.vision_model.post_layernorm", v["post_ln"])
    if model.backend == "clip":
        sd["backbone.vision_model.embeddings.class_embedding"] = v["class_embedding"]
        ln("backbone.vision_model.pre_layrnorm", v["pre_ln"])
        lin("backbone.text_projection", bb["text_projection"])
        lin("backbone.visual_projection", bb["visual_projection"])
        sd["backbone.logit_scale"] = bb["logit_scale"]
    else:
        lin("backbone.text_model.head", t["head"])
        mh = v["map_head"]
        sd["backbone.vision_model.head.probe"] = mh["probe"]
        attn = mh["attn"]
        sd["backbone.vision_model.head.attention.in_proj_weight"] = torch.cat(
            [attn[n]["w"].t() for n in ("q", "k", "v")])
        sd["backbone.vision_model.head.attention.in_proj_bias"] = torch.cat(
            [attn[n]["b"] for n in ("q", "k", "v")])
        lin("backbone.vision_model.head.attention.out_proj", attn["o"])
        ln("backbone.vision_model.head.layernorm", mh["ln"])
        lin("backbone.vision_model.head.mlp.fc1", mh["fc1"])
        lin("backbone.vision_model.head.mlp.fc2", mh["fc2"])
        for name in ("logit_scale", "logit_bias"):  # HF keeps shape (1,)
            sd[f"backbone.{name}"] = bb[name].reshape(1)
    for n in ("proj_t", "proj_i", "g_t", "g_i", "gate"):
        lin(n, hd[n])
    ln("ln_fused", hd["ln_fused"])
    ln("cls.0", hd["cls_ln"])
    lin("cls.1", hd["cls_fc1"])
    lin("cls.4", hd["cls_fc2"])
    return {k: x.detach().cpu().contiguous().clone() for k, x in sd.items()}


def save_safetensors(sd: dict, path: str) -> None:
    """{name: tensor} -> a ``model.safetensors`` of fp32 tensors (what the
    JAX package's export writes), with the standard library and numpy: an
    8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and data offsets, padded with spaces to 8 bytes, then the
    raw little-endian data."""
    import numpy as np

    header, blobs, offset = {}, [], 0
    for name in sorted(sd):
        raw = np.ascontiguousarray(sd[name].detach().cpu().float().numpy(), "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(sd[name].shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


class InMemoryDataset:
    """Seeded uint8 crops and token ids with the ``.batches()`` contract of
    ``data.dataset.CSVDataset``. CLIP-style ids (the default): BOS, random
    tokens, EOS at a position between 8 and 40, EOS padding, 224x224 crops.
    SigLIP-style (``siglip=True``): 8 to 60 random tokens then PAD (id 0)
    padding, so the rows fall in the 32, 48 and 64 text buckets, and
    ``image_size`` crops. With ``stats`` (mean, std) the batches carry the
    crops as normalised float32 CHW pixels (a float_nchw preprocessor's
    output, through ``data.images.normalize_crop``), else as the uint8
    crops."""

    def __init__(self, n: int, seed: int, T: int = 77, siglip: bool = False,
                 image_size: int = 224, stats=None):
        import numpy as np

        self.stats = stats
        g = np.random.default_rng(seed)
        self.attention_mask = np.zeros((n, T), np.int32)
        if siglip:
            self.input_ids = np.zeros((n, T), np.int32)
            for i, length in enumerate(g.integers(8, 61, size=n)):
                self.input_ids[i, :length] = g.integers(2, 256000, size=length)
                self.attention_mask[i, :length] = 1
        else:
            self.input_ids = np.full((n, T), 49407, np.int32)
            eos = g.integers(8, 41, size=n)
            for i, e in enumerate(eos):
                self.input_ids[i, 0] = 49406
                self.input_ids[i, 1:e] = g.integers(1, 49406, size=e - 1)
                self.attention_mask[i, : e + 1] = 1
        self.images = g.integers(0, 256, size=(n, image_size, image_size, 3), dtype=np.uint8)
        self.labels = (g.random((n, len(CLASSES))) < 0.3).astype(np.float32)
        self.text_present = np.ones((n,), np.float32)
        self.image_present = np.ones((n,), np.float32)
        self.image_present[::17] = 0.0

    def __len__(self):
        return len(self.input_ids)

    def truncate_text(self, width: int) -> None:
        """``CSVDataset.truncate_text``: drop pad columns past ``width``."""
        check(int(self.attention_mask[:, width:].sum()) == 0, "truncate_text drops real tokens")
        self.input_ids = self.input_ids[:, :width].copy()
        self.attention_mask = self.attention_mask[:, :width].copy()

    def pixels(self, idx):
        """The rows' images as the batches carry them."""
        import numpy as np

        from multimodal_content_moderation_tpu_torch.data.images import normalize_crop

        if self.stats is None:
            return self.images[idx]
        return np.stack([normalize_crop(c, *self.stats) for c in self.images[idx]])

    def batches(self, batch_size, drop_last=False, pad_to_batch=False, num_workers=0,
                indices=None):
        import numpy as np

        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        n = len(order)
        for s in range(0, n - batch_size + 1 if drop_last else n, batch_size):
            idx = order[s : s + batch_size]
            batch = {
                "input_ids": self.input_ids[idx],
                "attention_mask": self.attention_mask[idx],
                "pixel_values": self.pixels(idx),
                "text_present": self.text_present[idx],
                "image_present": self.image_present[idx],
                "labels": self.labels[idx],
            }
            valid = len(idx)
            if pad_to_batch and valid < batch_size:
                batch = {
                    k: np.concatenate([v, np.zeros((batch_size - valid,) + v.shape[1:], v.dtype)])
                    for k, v in batch.items()
                }
            if pad_to_batch:
                batch["_valid"] = np.int32(valid)
            yield batch


def full_model_phase(torch, card: str):
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.training.metrics import compute_detailed_metrics

    report = {}
    ckpt = os.path.join(REPO, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    src = FusionModel.create("clip", num_labels=len(CLASSES), seed=0, device="cuda")
    torch.save(reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(HF_CLIP_B32, f)
    with open(os.path.join(ckpt, "inference_config.json"), "w") as f:
        json.dump({"backend": "clip", "head": "fusion", "fusion_dim": 512,
                   "class_names": CLASSES, "max_text_length": 77}, f)

    t0 = time.perf_counter()
    model, cfg = model_io.load_checkpoint(ckpt, device="cuda")
    report["load_checkpoint_s"] = time.perf_counter() - t0
    src_sd, got_sd = src.state_dict(), model.state_dict()
    check(src_sd.keys() == got_sd.keys(), "load_checkpoint: parameter names differ")
    for name, x in src_sd.items():
        check(torch.equal(x, got_sd[name]), f"load_checkpoint: {name} differs")
    del src, src_sd, got_sd
    n_params = sum(p.numel() for p in model.parameters())
    report["parameters"] = n_params

    data = InMemoryDataset(N_EVAL_BATCHES * BATCH - 5, seed=1)  # a padded last batch

    # fp32 on the card (kernels) against the same checkpoint on the CPU
    # (plain versions) for 8 rows: fp32 throughout with TF32 off (main sets
    # it), so the logits differ only by summation order (atol 2e-3)
    cpu_model, _ = model_io.load_checkpoint(ckpt, device="cpu")
    rows = next(data.batches(8))
    outs = []
    for m in (model, cpu_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), CLIP_MEAN, CLIP_STD
        )
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    report["fp32_card_vs_cpu_max_abs_err"] = err
    check(err <= 2e-3 and bool(outs[0].isfinite().all()),
          f"fp32 logits on the card differ from the CPU's by {err} (atol 2e-3)")
    del cpu_model
    report["safetensors_checkpoint"] = safetensors_checkpoint_check(torch, model, ckpt, rows)
    shutil.rmtree(ckpt, ignore_errors=True)
    report["standard_vs_fast_engine"] = standard_engine_check(torch, model)

    # the main path: bf16 towers with the attention_nhd kernel
    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas"
    ).to(torch.bfloat16)
    engine = fi.FastInferenceEngine(bf16, CLIP_MEAN, CLIP_STD)
    n_batches = -(-len(data) // BATCH)
    runs = {}
    for name, spec in (("seq_buckets_off", "off"), ("seq_buckets_auto", "auto")):
        counts = _reset_counts()
        t0 = time.perf_counter()
        logits, labels = fi.evaluate_logits_u8(
            engine, data, BATCH, num_workers=4, seq_buckets=fi.parse_seq_buckets(spec)
        )
        wall = time.perf_counter() - t0
        launches = counts()
        check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
              f"{name}: launches {launches} for {n_batches} batches (want 1 and 24 per batch)")
        check(logits.shape == (len(data), len(CLASSES)) and np.isfinite(logits).all(),
              f"{name}: logits {logits.shape}, finite={np.isfinite(logits).all()}")
        np.testing.assert_array_equal(labels, data.labels)
        runs[name] = {"logits": logits, "launches": launches, "wall_s": wall}
    err = float(np.abs(runs["seq_buckets_auto"]["logits"] - runs["seq_buckets_off"]["logits"]).max())
    report["buckets_vs_full_max_abs_err"] = err
    check(err <= 3e-2, f"bucketed logits differ from unbucketed by {err} (bf16 atol 3e-2)")
    report["main_path_launches"] = runs["seq_buckets_off"]["launches"]
    report["main_path_batches"] = n_batches
    for name, r in runs.items():
        report[f"evaluate_{name}_samples_per_s_incl_host_prep"] = len(data) / r["wall_s"]
    # the evaluate CLI's report on the card's results: numpy, no sklearn
    probs = 1.0 / (1.0 + np.exp(-runs["seq_buckets_off"]["logits"]))
    detailed = compute_detailed_metrics(probs, data.labels, 0.5, CLASSES)
    check(set(detailed["per_class"]) == set(CLASSES)
          and all(np.isfinite(v) for k, v in detailed.items() if k != "per_class")
          and all(np.isfinite(x) for cm in detailed["per_class"].values() for x in cm.values()),
          f"compute_detailed_metrics on the card's logits: {detailed}")
    report["detailed_metrics"] = {k: v for k, v in detailed.items() if k != "per_class"}

    # staged-batch throughput, as bench.py measures it: inputs already on
    # the card, distinct ids per batch, one synchronise per pass
    g = np.random.default_rng(2)
    vocab = HF_CLIP_B32["text_config"]["vocab_size"]

    def ids_batch(width):
        ids = g.integers(1, vocab - 2, size=(BATCH, 77)).astype(np.int32)
        ids[:, 30] = 49407
        return torch.from_numpy(np.ascontiguousarray(ids[:, :width])).cuda()

    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(BATCH, 224, 224, 3), dtype=np.uint8))).cuda() for _ in range(4)]
    ones = torch.ones(BATCH, device="cuda")
    for width in (77, 32):
        mask = torch.ones(BATCH, width, dtype=torch.int32, device="cuda")
        ids = [ids_batch(width) for _ in range(20)]
        engine(ids_batch(width), mask, patches[0], ones, ones)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i, x in enumerate(ids):
                engine(x, mask, patches[i % 4], ones, ones)
            torch.cuda.synchronize()
            rates.append(len(ids) * BATCH / (time.perf_counter() - t0))
        report[f"staged_samples_per_s_seq{width}"] = {
            "median": sorted(rates)[1], "passes": rates, "card": card,
        }
        report[f"device_time_seq{width}"] = device_time_breakdown(
            torch, lambda: [engine(x, mask, patches[i % 4], ones, ones)
                            for i, x in enumerate(ids[:4])], 4,
        )
    return report


def safetensors_checkpoint_check(torch, model, ckpt, rows):
    """The checkpoint of ``ckpt`` (``pytorch_model.bin``) written again as a
    reference-format ``model.safetensors`` (the JAX package's export format)
    and read by ``load_checkpoint`` on the card with the ``safetensors``
    package hidden from imports, so through the port's own reader
    (``convert.read_safetensors``): the same parameters, and fp32 logits
    equal to the ``.bin`` model's (difference 0.0). Where the package is
    installed, the reader's arrays must also equal its ``load_file``'s."""
    import importlib.util

    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import convert
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io

    st_dir = ckpt + "_safetensors"
    shutil.rmtree(st_dir, ignore_errors=True)
    os.makedirs(st_dir)
    sd = torch.load(os.path.join(ckpt, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    st_file = os.path.join(st_dir, "model.safetensors")
    t0 = time.perf_counter()
    save_safetensors(sd, st_file)
    write_s = time.perf_counter() - t0
    del sd
    for name in ("config.json", "inference_config.json"):
        shutil.copy(os.path.join(ckpt, name), st_dir)
    installed = importlib.util.find_spec("safetensors") is not None
    if installed:
        from safetensors.numpy import load_file

        want, got = load_file(st_file), convert.read_safetensors(st_file)
        check(want.keys() == got.keys()
              and all(want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
                      for k in want),
              "read_safetensors differs from safetensors.numpy.load_file")
        del want, got
    # None in sys.modules makes an import raise ImportError: load_safetensors
    # then takes the port's reader, as on a machine without the package
    names = ("safetensors", "safetensors.numpy")
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(dict.fromkeys(names))
    try:
        t0 = time.perf_counter()
        st_model, _ = model_io.load_checkpoint(st_dir, device="cuda")
        load_s = time.perf_counter() - t0
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
    shutil.rmtree(st_dir, ignore_errors=True)
    want_sd = model.state_dict()
    for name, x in st_model.state_dict().items():
        check(torch.equal(x, want_sd[name]), f"model.safetensors: {name} differs from the .bin's")
    outs = []
    for m in (model, st_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), CLIP_MEAN, CLIP_STD)
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]))
    diff = float((outs[0] - outs[1]).abs().max())
    check(diff == 0.0, f"model.safetensors logits differ from the .bin's by {diff}")
    return {"safetensors_package_installed": installed,
            "reader_equals_package": installed or "not checked (no package)",
            "loaded_with_package_hidden": True,
            "write_s": write_s, "load_checkpoint_s": load_s, "logits_max_abs_diff": diff}


def standard_engine_check(torch, model):
    """``--engine standard`` against ``--engine fast`` on the card, fp32 with
    the kernels (TF32 off), 2 batches of 64 rows: ``evaluate_logits_standard`` over
    float_nchw pixels built from the crops with ``normalize_crop`` (no PIL)
    against ``evaluate_logits_u8`` over the same uint8 crops, buckets off.
    atol 1e-4: the u8 wire folds the normalisation into the embed weight,
    the standard engine normalises then embeds, so the two round apart."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.loop import evaluate_logits_standard

    fp32 = model_io.with_performance_options(model, attention_impl="pallas")
    n = 2 * 64 - 3  # a padded last batch
    u8_data = InMemoryDataset(n, seed=12)
    float_data = InMemoryDataset(n, seed=12, stats=(CLIP_MEAN, CLIP_STD))
    fast, labels = fi.evaluate_logits_u8(fi.FastInferenceEngine(fp32, CLIP_MEAN, CLIP_STD),
                                         u8_data, 64, num_workers=2)
    counts = _reset_counts()
    standard, labels_std = evaluate_logits_standard(fp32, float_data, 64, num_workers=2)
    launches = counts()
    check(launches == _counts(False, attention_nhd=24 * 2),
          f"standard engine launches {launches}: want 24 attention_nhd a batch, no embed kernel")
    np.testing.assert_array_equal(labels, labels_std)
    err = float(np.abs(standard - fast).max())
    check(standard.shape == (n, len(CLASSES)) and np.isfinite(standard).all() and err <= 1e-4,
          f"standard engine logits {standard.shape} differ from the fast engine's by {err} "
          "(fp32 atol 1e-4)")
    return {"rows": n, "max_abs_err": err, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 4: fine-tuning at full width
# ---------------------------------------------------------------------------

N_TRAIN_ROWS = 16 * TRAIN_BATCH  # 16 micro-steps (8 optimizer steps) an epoch
N_VAL_ROWS = 2 * 64 - 7  # two eval batches, the last one padded


def _wrappers():
    from multimodal_content_moderation_tpu_torch.ops.cuda_attention import (
        attention_nhd, attention_nhd_bwd)
    from multimodal_content_moderation_tpu_torch.ops.cuda_flash import (
        attention_small, flash_attention)
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import patch_embed_u8

    return {"patch_embed_u8": patch_embed_u8, "attention_nhd": attention_nhd,
            "attention_nhd_bwd": attention_nhd_bwd, "flash_attention": flash_attention,
            "attention_small": attention_small}


# kernels with a tensor_core_launches count: every bf16 launch goes there
TENSOR_CORE = ["patch_embed_u8", "attention_nhd", "attention_nhd_bwd", "flash_attention",
               "attention_small"]


def _reset_counts():
    """Set every kernel's launch count (and tensor-core launch count) to 0;
    returns a reader of the counts."""
    wrappers = _wrappers()
    for name, fn in wrappers.items():
        fn.launches = 0
        if name in TENSOR_CORE:
            fn.tensor_core_launches = 0

    def read():
        counts = {name: fn.launches for name, fn in wrappers.items()}
        counts.update({f"{name}_tensor_core": wrappers[name].tensor_core_launches
                       for name in TENSOR_CORE})
        return counts

    return read


def _counts(tensor_cores: bool = True, **nonzero):
    """The expected counts: the given kernels, every other kernel 0; the
    tensor-core counts equal to the launches (a bf16 run) or 0 (fp32)."""
    counts = {name: nonzero.get(name, 0) for name in KERNELS}
    counts.update({f"{name}_tensor_core": counts[name] if tensor_cores else 0
                   for name in TENSOR_CORE})
    return counts


def _device_batch(torch, data, idx, patch_size=None):
    """Rows ``idx`` of ``data`` on the card: the image as uint8 patch rows
    with a ``patch_size`` (the u8 wire), else as ``data.pixels`` (the f32
    wire for a dataset with stats)."""
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8

    image = ({"patches_u8": extract_patches_u8(data.images[idx], patch_size)}
             if patch_size is not None else {"pixel_values": data.pixels(idx)})
    host = {
        "input_ids": data.input_ids[idx], "attention_mask": data.attention_mask[idx],
        "text_present": data.text_present[idx], "image_present": data.image_present[idx],
        "labels": data.labels[idx], **image,
    }
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def leafwise_grad_check(card, cpu):
    """Fp32 gradients on the card against the CPU's, leaf by leaf, from
    ``_leaf_grads``: |card - cpu| <= 1e-3 * max|cpu leaf| + 1e-6 * max|cpu,
    all leaves|: fp32 sums over 12 layers in another order. The floor is
    for leaves whose exact gradient is 0 (the attention key bias: softmax
    does not see a shift shared by every key), where both devices hold
    rounding noise. A leaf that is zero on the card and not on the CPU
    fails; the losses agree within 1e-4."""
    (loss_card, g_card), (loss_cpu, g_cpu) = card, cpu
    check(abs(loss_card - loss_cpu) <= 1e-4, f"fp32 loss card {loss_card} vs cpu {loss_cpu}")
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values() if g is not None)
    ratios = []
    for name, want_g in g_cpu.items():
        got_g = g_card[name]
        if want_g is None:
            check(got_g is None, f"{name}: a gradient on the card, none on the CPU")
            continue
        check(got_g is not None, f"{name}: no gradient on the card")
        scale = float(want_g.abs().max())
        err = float((got_g - want_g).abs().max())
        check(not (scale > floor and float(got_g.abs().max()) == 0),
              f"{name}: gradient zero on the card, {scale} on the CPU")
        tol = 1e-3 * scale + floor
        check(err <= tol, f"{name}: card vs cpu gradient err {err} (leaf max {scale}, tol {tol})")
        ratios.append((err / tol, name, err, scale))
    ratios.sort(reverse=True)
    return {
        "leaves": len(ratios), "floor": floor, "loss_card": loss_card, "loss_cpu": loss_cpu,
        "worst_err_over_tol": [{"leaf": n, "err": e, "leaf_max": sc, "err_over_tol": r}
                               for r, n, e, sc in ratios[:4]],
    }


def fixed_batch_loss_falls(torch, model, batch, lr_encoder, lr_head, steps: int = 10):
    """The loss on one fixed batch before and after ``steps`` optimizer
    steps (dropout on, a seeded generator); fails unless it fell."""
    from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

    opt = AdamW(dict(model.named_parameters()), lr_encoder=lr_encoder, lr_head=lr_head,
                total_steps=steps, warmup_ratio=0.0, schedule="constant")
    step = make_train_step(model, opt, generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        before = float(model(batch)["loss"])
    for _ in range(steps):
        step(batch)
    with torch.no_grad():
        after = float(model(batch)["loss"])
    check(after < before, f"loss on a fixed batch did not fall: {before} -> {after}")
    return {"before": before, f"after_{steps}_steps": after}


def staged_training(torch, model, staged, card, accum, batch_size):
    """Training samples/s over staged batches (3 passes of 8 micro-steps),
    the CUDA-event time of the forward, backward and optimizer per
    micro-step, and a profiler breakdown of one optimizer step."""
    from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = AdamW(dict(model.named_parameters()), total_steps=100, accumulation_steps=accum)
    step = make_train_step(model, opt, generator=gen)
    for b in staged:
        step(b)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(8):
            step(staged[i % len(staged)])
        torch.cuda.synchronize()
        rates.append(8 * batch_size / (time.perf_counter() - t0))
    return {
        "staged_train_samples_per_s": {"median": sorted(rates)[1], "passes": rates, "card": card},
        "train_step_parts_ms": step_parts_ms(torch, model, opt, gen, staged),
        "device_time_train": device_time_breakdown(
            torch, lambda: [step(staged[i]) for i in range(accum)], 1),
    }


def _leaf_grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = model(batch)["loss"]
    loss.backward()
    return float(loss.detach()), {
        n: (p.grad.detach().float().cpu() if p.grad is not None else None)
        for n, p in model.named_parameters()
    }


def dense_bf16_grad_check(torch):
    """``layers.dense`` in bf16 on the card (the fp32-output cuBLAS product
    and its backward, which every bf16 dense of the training path takes)
    against autograd of its plain definition, ``(x @ bf16(w) + b)`` in fp32
    rounded once to bf16, with a random cotangent, at the towers' MLP shapes
    of a training micro-step. Both sides round each gradient once from an
    fp32 sum: within 1 bf16 ulp (rtol 2^-7) + atol 1e-3 for the order of
    the sums."""
    from multimodal_content_moderation_tpu_torch.ops.layers import dense

    g = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for label, rows, d_in, d_out in (("vision fc1", TRAIN_BATCH * 50, 768, 3072),
                                     ("vision fc2", TRAIN_BATCH * 50, 3072, 768),
                                     ("text fc1", TRAIN_BATCH * TRAIN_SEQ, 512, 2048)):
        x = torch.randn(rows, d_in, generator=g, device="cuda").bfloat16()
        w = torch.randn(d_in, d_out, generator=g, device="cuda") * d_in ** -0.5
        b = torch.randn(d_out, generator=g, device="cuda") * 0.1
        gy = torch.randn(rows, d_out, generator=g, device="cuda").bfloat16()
        grads = []
        for fn in (lambda x_, w_, b_: dense(x_, {"w": w_, "b": b_}),
                   lambda x_, w_, b_: (x_.float() @ w_.bfloat16().float() + b_).bfloat16()):
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            y = fn(*leaves)
            check(y.dtype == torch.bfloat16, f"dense {label}: output dtype {y.dtype}")
            grads.append((y.detach(),) + torch.autograd.grad(y, leaves, gy))
        case = {"case": f"{label}: x [{rows}, {d_in}] bf16, w [{d_in}, {d_out}] fp32"}
        for part, got, want in zip(("y", "dx", "dw", "db"), *grads):
            check(got.dtype == want.dtype, f"dense {label} {part}: dtype {got.dtype} vs {want.dtype}")
            err, ok = max_err_within(got, want, 1e-3, 2.0**-7)
            check(ok, f"dense {label} {part}: err {err} beyond 1 bf16 ulp + 1e-3")
            case[f"{part}_max_abs_err"] = err
        out.append(case)
    return out


def train_phase(torch, card: str):
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.training import checkpoints as ckpt_lib
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs, Trainer
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_multi)

    report = {}
    out_dir = os.path.join(REPO, "build", "chip_smoke_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    train_ds = InMemoryDataset(N_TRAIN_ROWS, seed=3)
    val_ds = InMemoryDataset(N_VAL_ROWS, seed=4)
    # training.text_fit: the longest row rounded up to a multiple of 8
    longest = max(int(d.attention_mask.sum(axis=1).max()) for d in (train_ds, val_ds))
    fit = min(77, max(8, -(-longest // 8) * 8))
    check(fit == TRAIN_SEQ, f"text_fit gave width {fit}, want {TRAIN_SEQ}")
    for d in (train_ds, val_ds):
        d.truncate_text(fit)

    def new_model(seed=0, device="cuda", **perf):
        m = FusionModel.create("clip", num_labels=len(CLASSES), seed=seed, device=device)
        m = model_io.with_performance_options(m, **perf)
        return m.replace(image_mean=CLIP_MEAN, image_std=CLIP_STD)

    bf16_pallas = dict(compute_dtype="bfloat16", attention_impl="pallas")
    args = TrainArgs(
        output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=TRAIN_BATCH,
        per_device_eval_batch_size=64, gradient_accumulation_steps=TRAIN_ACCUM,
        logging_steps=4, save_total_limit=2, early_stopping=False, wire="u8",
        num_workers=4, seed=0,
    )
    metrics = make_compute_metrics_multi(len(CLASSES))
    n_micro = N_TRAIN_ROWS // TRAIN_BATCH
    eval_batches = -(-N_VAL_ROWS // 64)

    # the main path: Trainer.train for one epoch (an eval, a checkpoint and a
    # train state at its end), counted from 0
    trainer = Trainer(new_model(**bf16_pallas), args, train_ds, val_ds, metrics, device="cuda")
    counts = _reset_counts()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    report["train_wall_s"] = time.perf_counter() - t0
    launches = counts()
    want = _counts(patch_embed_u8=n_micro + eval_batches,
                   attention_nhd=24 * (n_micro + eval_batches),
                   attention_nhd_bwd=24 * n_micro)
    check(launches == want, f"training launches {launches}, want {want} for {n_micro} "
                            f"micro-steps + {eval_batches} eval batches")
    check(result["global_step"] == n_micro and trainer.optimizer.count == n_micro // TRAIN_ACCUM,
          f"global_step {result['global_step']}, optimizer steps {trainer.optimizer.count}")
    hist = result["history"][0]
    check(np.isfinite(hist["loss"]) and np.isfinite(hist["train_loss"]),
          f"non-finite eval/train loss {hist}")
    report["main_path_launches"] = launches
    report["main_path_micro_steps"] = n_micro
    report["main_path_eval_batches"] = eval_batches
    report["history"] = result["history"]
    report["trainer_samples_per_s"] = {"value": result["train_samples_per_second"], "card": card}
    saved = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    ckpt = result["best_checkpoint"]
    check(ckpt is not None and os.path.exists(os.path.join(ckpt, ckpt_lib.PARAMS_FILE)),
          f"no checkpoint written ({ckpt})")
    del trainer

    # resume from trainstate-* and one more optimizer step
    resumed = Trainer(
        new_model(seed=1, **bf16_pallas),
        TrainArgs(**{**args.__dict__, "num_train_epochs": 2, "max_steps": n_micro + TRAIN_ACCUM,
                     "resume_from_checkpoint": "auto"}),
        train_ds, val_ds, metrics, device="cuda",
    )
    check((resumed.start_epoch, resumed._start_step, resumed.optimizer.count)
          == (1, n_micro, n_micro // TRAIN_ACCUM),
          f"resume read epoch {resumed.start_epoch}, step {resumed._start_step}, "
          f"optimizer count {resumed.optimizer.count}")
    for k, v in resumed.model.state_dict().items():
        check(torch.equal(v.cpu(), saved[k]), f"resume: {k} differs from the saved state")
    r2 = resumed.train()
    check(r2["global_step"] == n_micro + TRAIN_ACCUM
          and resumed.optimizer.count == n_micro // TRAIN_ACCUM + 1,
          f"after resume: global_step {r2['global_step']}, optimizer {resumed.optimizer.count}")
    report["resume"] = {"from": os.path.basename(ckpt_lib.latest_train_state(out_dir)),
                        "global_step": r2["global_step"], "eval_loss": r2["history"][0]["loss"]}
    del resumed

    # gradients: fp32 on the card (kernels, TF32 off) against the CPU (plain
    # versions), from the same checkpoint, 4 rows
    rows = np.arange(4)
    grads = {}
    for device in ("cuda", "cpu"):
        m = new_model(device=device, attention_impl="pallas")
        ckpt_lib.restore_checkpoint(ckpt, m)
        batch = _device_batch(torch, train_ds, rows, 32)
        if device == "cpu":
            batch = {k: v.cpu() for k, v in batch.items()}
        counts = _reset_counts()
        grads[device] = _leaf_grads(m, batch)
        if device == "cuda":
            check(counts() == _counts(False, patch_embed_u8=1, attention_nhd=24,
                                      attention_nhd_bwd=24),
                  f"gradient check launches {counts()}")
        del m
    report["grad_check"] = leafwise_grad_check(grads["cuda"], grads["cpu"])
    del grads
    # the check above runs fp32, which bypasses the bf16 dense's backward
    report["dense_bf16_grad_check"] = dense_bf16_grad_check(torch)

    # learning: the loss on one fixed batch falls over 10 optimizer steps
    model = new_model(seed=2, **bf16_pallas)
    report["fixed_batch_loss"] = fixed_batch_loss_falls(
        torch, model, _device_batch(torch, train_ds, np.arange(TRAIN_BATCH), 32), 1e-5, 5e-4)

    # throughput on staged batches, and the time of each part of a step
    staged = [_device_batch(torch, train_ds, np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH), 32)
              for i in range(4)]
    report.update(staged_training(torch, model, staged, card, TRAIN_ACCUM, TRAIN_BATCH))
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(out_dir, ignore_errors=True)
    return report


def step_parts_ms(torch, model, opt, gen, staged, n: int = 8):
    """Mean device ms of the forward, the backward and the optimizer over
    ``n`` micro-steps (CUDA events between the parts)."""
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for i in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in opt.params.values():
            p.grad = None
        ev[0].record()
        loss = model(staged[i % len(staged)], generator=gen)["loss"]
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for j, k in enumerate(parts):
            parts[k] += ev[j].elapsed_time(ev[j + 1]) / n
    parts["optimizer_note"] = "mean over micro-steps; the update itself runs on every 2nd"
    return parts


def trainer_run(torch, model, args, train_ds, val_ds, want_fn, label):
    """``Trainer.train`` for one epoch on the card, counted from 0: the
    launches must equal ``want_fn(micro_steps, eval_batches)``; returns the
    report and the trainer."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.training.loop import Trainer
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_multi)

    trainer = Trainer(model, args, train_ds, val_ds, make_compute_metrics_multi(len(CLASSES)),
                      device="cuda")
    n_micro = len(train_ds) // args.per_device_train_batch_size
    eval_batches = -(-len(val_ds) // args.per_device_eval_batch_size)
    counts = _reset_counts()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = want_fn(n_micro, eval_batches)
    check(launches == want, f"{label}: launches {launches}, want {want} for {n_micro} "
                            f"micro-steps + {eval_batches} eval batches")
    accum = args.gradient_accumulation_steps
    check(result["global_step"] == n_micro and trainer.optimizer.count == n_micro // accum,
          f"{label}: global_step {result['global_step']}, optimizer {trainer.optimizer.count}")
    hist = result["history"][0]
    check(np.isfinite(hist["loss"]) and np.isfinite(hist["train_loss"]),
          f"{label}: non-finite eval/train loss {hist}")
    return {"main_path_launches": launches, "micro_steps": n_micro, "eval_batches": eval_batches,
            "optimizer_steps": trainer.optimizer.count, "history": result["history"],
            "train_wall_s": wall,
            "trainer_samples_per_s": result["train_samples_per_second"]}, trainer


def clip_f32_train_phase(torch, card: str):
    """CLIP ViT-B/32 fine-tuning as ``config/clip_fusion.yaml`` ships it:
    the f32 wire (normalised pixels through the pixel path), the "xla"
    attention core, bf16 towers on fp32 master weights, B=32 x 2, text_fit
    width 48, 4 optimizer steps and a standard-engine eval through
    ``Trainer.train`` (no kernel runs: the launch counts stay 0); the loss
    on a fixed batch falls; one micro-step's loss on the f32 wire against
    the u8 wire's on the same rows and dropout draw (fp32 atol 1e-4: the
    two wires round the embed apart; bf16 atol 2e-2: the f32 wire rounds
    the pixels and the embed weight to bf16, the u8 wire neither); staged
    samples/s, CUDA-event step parts and a profiler breakdown."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs

    out_dir = os.path.join(REPO, "build", "chip_smoke_clip_f32")
    shutil.rmtree(out_dir, ignore_errors=True)
    stats = (CLIP_MEAN, CLIP_STD)
    train_ds = InMemoryDataset(8 * TRAIN_BATCH, seed=3, stats=stats)
    val_ds = InMemoryDataset(64 - 7, seed=4, stats=stats)
    for d in (train_ds, val_ds):
        d.truncate_text(TRAIN_SEQ)

    def new_model(seed=0, **perf):
        m = FusionModel.create("clip", num_labels=len(CLASSES), seed=seed, device="cuda")
        return model_io.with_performance_options(m, **perf)

    args = TrainArgs(
        output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=TRAIN_BATCH,
        per_device_eval_batch_size=64, gradient_accumulation_steps=TRAIN_ACCUM,
        logging_steps=4, save_total_limit=1, early_stopping=False, wire="f32",
        num_workers=4, seed=0,
    )
    report, trainer = trainer_run(torch, new_model(compute_dtype="bfloat16"), args, train_ds,
                                  val_ds, lambda micro, evals: _counts(), "clip f32 training")
    del trainer
    shutil.rmtree(out_dir, ignore_errors=True)

    # the f32 wire against the u8 wire: the same rows and dropout draw
    idx = np.arange(TRAIN_BATCH)
    f32_batch = _device_batch(torch, train_ds, idx)
    u8_batch = {**{k: v for k, v in f32_batch.items() if k != "pixel_values"},
                "patches_u8": torch.from_numpy(extract_patches_u8(train_ds.images[idx], 32)).cuda()}
    wires = {}
    for dtype, atol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        m = new_model(seed=1, compute_dtype=dtype).replace(image_mean=CLIP_MEAN,
                                                           image_std=CLIP_STD)
        losses = []
        for batch in (f32_batch, u8_batch):
            with torch.no_grad():
                gen = torch.Generator(device="cuda").manual_seed(5)
                losses.append(float(m(batch, generator=gen)["loss"]))
        err = abs(losses[0] - losses[1])
        check(err <= atol, f"{dtype} micro-step loss: f32 wire {losses[0]}, u8 wire "
                           f"{losses[1]} (atol {atol})")
        wires[dtype] = {"f32_wire": losses[0], "u8_wire": losses[1], "abs_diff": err,
                        "atol": atol}
        del m
    report["f32_vs_u8_wire_loss"] = wires

    model = new_model(seed=2, compute_dtype="bfloat16")
    report["fixed_batch_loss"] = fixed_batch_loss_falls(torch, model, f32_batch, 1e-5, 5e-4)
    staged = [_device_batch(torch, train_ds, np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
              for i in range(4)]
    report.update(staged_training(torch, model, staged, card, TRAIN_ACCUM, TRAIN_BATCH))
    return report


def siglip224_train_phase(torch, card: str):
    """SigLIP2-B/16-224 fine-tuning at ``config/siglip_fusion.yaml``
    settings, full width and depth, random weights from a seed: the f32
    wire, bf16 towers on fp32 master weights, B=24 x 2, text seq 64 (SigLIP
    ignores text_fit), 4 optimizer steps and a standard-engine eval through
    ``Trainer.train``, once as shipped (attention "xla": no kernel runs) and
    once with attention "pallas" (``attention_nhd`` and
    ``attention_nhd_bwd`` on the vision tower at T=196 without a mask and on
    the text tower with its key mask: 24 of each per micro-step, 24
    forward launches per eval batch, every one on the tensor cores). For
    each: the loss on a fixed batch falls, staged samples/s, CUDA-event
    forward / backward / optimizer ms per micro-step and a profiler
    breakdown. Then fp32 gradients with the kernels on the card against the
    CPU's plain versions on every leaf, 2 rows."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs

    cfg = model_io.siglip_config_from_dict(HF_SIGLIP2_B16_224)
    stats = (SIGLIP_MEAN, SIGLIP_STD)
    B = SIGLIP_TRAIN_BATCH
    train_ds = InMemoryDataset(8 * B, seed=10, T=64, siglip=True, stats=stats)
    val_ds = InMemoryDataset(64 - 7, seed=11, T=64, siglip=True, stats=stats)

    def new_model(seed=0, device="cuda", **perf):
        m = FusionModel.create("siglip", num_labels=len(CLASSES), siglip_config=cfg, seed=seed,
                               device=device)
        return model_io.with_performance_options(m, **perf)

    report = {}
    for impl in ("xla", "pallas"):
        out_dir = os.path.join(REPO, "build", f"chip_smoke_siglip224_{impl}")
        shutil.rmtree(out_dir, ignore_errors=True)
        args = TrainArgs(
            output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=B,
            per_device_eval_batch_size=64, gradient_accumulation_steps=2, lr_encoder=5e-6,
            lr_head=3e-4, logging_steps=4, save_total_limit=1, early_stopping=False,
            wire="f32", num_workers=4, seed=0,
        )
        if impl == "xla":
            def want(micro, evals):
                return _counts()
        else:
            def want(micro, evals):
                return _counts(attention_nhd=24 * (micro + evals), attention_nhd_bwd=24 * micro)
        run, trainer = trainer_run(
            torch, new_model(compute_dtype="bfloat16", attention_impl=impl), args, train_ds,
            val_ds, want, f"siglip224 {impl} training")
        del trainer
        shutil.rmtree(out_dir, ignore_errors=True)
        model = new_model(seed=2, compute_dtype="bfloat16", attention_impl=impl)
        run["fixed_batch_loss"] = fixed_batch_loss_falls(
            torch, model, _device_batch(torch, train_ds, np.arange(B)), 5e-6, 3e-4)
        staged = [_device_batch(torch, train_ds, np.arange(i * B, (i + 1) * B)) for i in range(4)]
        run.update(staged_training(torch, model, staged, card, 2, B))
        del model, staged
        report[impl] = run

    # gradients: fp32 on the card (kernels, TF32 off) against the CPU (plain
    # versions), 2 rows; the weights drawn once, on the CPU (a generator on
    # the card draws other numbers from the same seed), and copied over
    grads = {}
    for device in ("cuda", "cpu"):
        m = new_model(seed=3, device="cpu", attention_impl="pallas").to(device)
        batch = _device_batch(torch, train_ds, np.arange(2))
        if device == "cpu":
            batch = {k: v.cpu() for k, v in batch.items()}
        counts = _reset_counts()
        grads[device] = _leaf_grads(m, batch)
        if device == "cuda":
            check(counts() == _counts(False, attention_nhd=24, attention_nhd_bwd=24),
                  f"siglip224 gradient check launches {counts()}")
        del m
    report["grad_check"] = leafwise_grad_check(grads["cuda"], grads["cpu"])
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return report


# ---------------------------------------------------------------------------
# Phase 5: SigLIP2-B/16 at 384 px, and attention_small through mha
# ---------------------------------------------------------------------------


def siglip_phase(torch, card: str):
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

    report = {}
    ckpt = os.path.join(REPO, "build", "chip_smoke_siglip")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    cfg = model_io.siglip_config_from_dict(HF_SIGLIP2_B16_384)
    src = FusionModel.create("siglip", num_labels=len(CLASSES), siglip_config=cfg, seed=0,
                             device="cuda")
    torch.save(reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(HF_SIGLIP2_B16_384, f)
    with open(os.path.join(ckpt, "inference_config.json"), "w") as f:
        json.dump({"backend": "siglip", "head": "fusion", "fusion_dim": 512,
                   "class_names": CLASSES, "max_text_length": 64}, f)

    t0 = time.perf_counter()
    model, _ = model_io.load_checkpoint(ckpt, device="cuda")
    report["load_checkpoint_s"] = time.perf_counter() - t0
    check(model.backend == "siglip" and model.image_size == 384
          and model.text_max_positions == 64, "load_checkpoint: not the SigLIP-384 config")
    src_sd, got_sd = src.state_dict(), model.state_dict()
    check(src_sd.keys() == got_sd.keys(), "load_checkpoint: parameter names differ")
    for name, x in src_sd.items():
        check(torch.equal(x, got_sd[name]), f"load_checkpoint: {name} differs")
    del src, src_sd, got_sd
    report["parameters"] = sum(p.numel() for p in model.parameters())

    data = InMemoryDataset(N_SIGLIP_BATCHES * SIGLIP_BATCH - 5, seed=5, T=64, siglip=True,
                           image_size=384)  # a padded last batch

    # fp32 on the card (kernels, TF32 off) against the same checkpoint on
    # the CPU (plain versions), 4 rows: the logits differ by summation order
    # only (atol 2e-3)
    cpu_model, _ = model_io.load_checkpoint(ckpt, device="cpu")
    rows = next(data.batches(4))
    outs = []
    for m in (model, cpu_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), SIGLIP_MEAN, SIGLIP_STD
        )
        counts = _reset_counts()
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]).cpu())
        if m is model:
            check(counts() == _counts(False, patch_embed_u8=1, attention_nhd=12,
                                      flash_attention=12),
                  f"fp32 card launches {counts()}")
    err = float((outs[0] - outs[1]).abs().max())
    report["fp32_card_vs_cpu_max_abs_err"] = err
    check(err <= 2e-3 and bool(outs[0].isfinite().all()),
          f"fp32 logits on the card differ from the CPU's by {err} (atol 2e-3)")
    del cpu_model
    shutil.rmtree(ckpt, ignore_errors=True)

    # the path: bf16 towers with the kernels, text buckets off and on
    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas"
    ).to(torch.bfloat16)
    del model
    engine = fi.FastInferenceEngine(bf16, SIGLIP_MEAN, SIGLIP_STD)
    n_batches = -(-len(data) // SIGLIP_BATCH)
    runs = {}
    for name, spec in (("seq_buckets_off", "off"), ("seq_buckets_auto", "auto")):
        counts = _reset_counts()
        t0 = time.perf_counter()
        logits, labels = fi.evaluate_logits_u8(
            engine, data, SIGLIP_BATCH, num_workers=4, seq_buckets=fi.parse_seq_buckets(spec)
        )
        wall = time.perf_counter() - t0
        launches = counts()
        want = _counts(patch_embed_u8=n_batches, attention_nhd=12 * n_batches,
                       flash_attention=12 * n_batches)
        check(launches == want, f"siglip {name}: launches {launches}, want {want}")
        check(logits.shape == (len(data), len(CLASSES)) and np.isfinite(logits).all(),
              f"siglip {name}: logits {logits.shape}, finite={np.isfinite(logits).all()}")
        np.testing.assert_array_equal(labels, data.labels)
        runs[name] = {"logits": logits, "launches": launches, "wall_s": wall}
    # the widths the auto ladder gave each batch (rows sorted by length)
    ladder = fi.bucket_ladder(fi.parse_seq_buckets("auto"), 64)
    order = np.argsort(data.attention_mask.sum(axis=1), kind="stable")
    report["bucket_widths"] = [
        fi.bucket_for(data.attention_mask[order[i : i + SIGLIP_BATCH]], ladder, extra=1)
        for i in range(0, len(data), SIGLIP_BATCH)
    ]
    err = float(np.abs(runs["seq_buckets_auto"]["logits"] - runs["seq_buckets_off"]["logits"]).max())
    report["buckets_vs_full_max_abs_err"] = err
    # bf16 towers: another text width changes the GEMM shapes and so the
    # bf16 roundings; the carry column itself is exact (the CPU tests)
    check(err <= 3e-2, f"siglip bucketed logits differ from unbucketed by {err} (bf16 atol 3e-2)")
    report["main_path_launches"] = runs["seq_buckets_off"]["launches"]
    report["main_path_batches"] = n_batches
    for name, r in runs.items():
        report[f"evaluate_{name}_samples_per_s_incl_host_prep"] = len(data) / r["wall_s"]

    # staged batches: inputs already on the card, one synchronise per pass
    g = np.random.default_rng(6)
    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(SIGLIP_BATCH, 384, 384, 3), dtype=np.uint8))).cuda()
        for _ in range(2)]
    ones = torch.ones(SIGLIP_BATCH, device="cuda")
    for width, carry in ((64, None), (32, 63)):
        ids = [torch.from_numpy(g.integers(2, 256000, size=(SIGLIP_BATCH, width)).astype(np.int32)
                                ).cuda() for _ in range(8)]
        mask = torch.ones(SIGLIP_BATCH, width, dtype=torch.int32, device="cuda")
        if carry is not None:
            mask[:, -1] = 0
        engine(ids[0], mask, patches[0], ones, ones, carry_pos=carry)
        torch.cuda.synchronize()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i, x in enumerate(ids):
                engine(x, mask, patches[i % 2], ones, ones, carry_pos=carry)
            torch.cuda.synchronize()
            rates.append(len(ids) * SIGLIP_BATCH / (time.perf_counter() - t0))
        report[f"staged_samples_per_s_seq{width}"] = {
            "median": sorted(rates)[1], "passes": rates, "card": card,
        }
        report[f"device_time_seq{width}"] = device_time_breakdown(
            torch, lambda: [engine(x, mask, patches[i % 2], ones, ones, carry_pos=carry)
                            for i, x in enumerate(ids[:2])], 2,
        )
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return report


def siglip224_phase(torch, card: str):
    """The shipped SigLIP2-B/16-224 (``config/siglip_fusion.yaml``) through
    ``load_checkpoint`` -> ``FastInferenceEngine`` in bf16, B=64, text seq
    64: both towers on ``attention_nhd`` (vision T=196, no flash). First
    its fp32 logits on the card are held against the CPU's."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

    report = {}
    ckpt = os.path.join(REPO, "build", "chip_smoke_siglip224")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    cfg = model_io.siglip_config_from_dict(HF_SIGLIP2_B16_224)
    src = FusionModel.create("siglip", num_labels=len(CLASSES), siglip_config=cfg, seed=0,
                             device="cuda")
    torch.save(reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
    del src
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(HF_SIGLIP2_B16_224, f)
    with open(os.path.join(ckpt, "inference_config.json"), "w") as f:
        json.dump({"backend": "siglip", "head": "fusion", "fusion_dim": 512,
                   "class_names": CLASSES, "max_text_length": 64}, f)
    model, _ = model_io.load_checkpoint(ckpt, device="cuda")
    check(model.backend == "siglip" and model.image_size == 224
          and model.text_max_positions == 64, "load_checkpoint: not the SigLIP-224 config")

    # fp32 on the card (kernels, TF32 off) against the same checkpoint on
    # the CPU (plain versions), 4 rows, as at 384 px (atol 2e-3)
    cpu_model, _ = model_io.load_checkpoint(ckpt, device="cpu")
    shutil.rmtree(ckpt, ignore_errors=True)
    rows = next(InMemoryDataset(4, seed=9, T=64, siglip=True, image_size=224).batches(4))
    outs = []
    for m in (model, cpu_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), SIGLIP_MEAN, SIGLIP_STD
        )
        counts = _reset_counts()
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]).cpu())
        if m is model:
            check(counts() == _counts(False, patch_embed_u8=1, attention_nhd=24),
                  f"siglip224 fp32 card launches {counts()}")
    err = float((outs[0] - outs[1]).abs().max())
    report["fp32_card_vs_cpu_max_abs_err"] = err
    check(err <= 2e-3 and bool(outs[0].isfinite().all()),
          f"siglip224 fp32 logits on the card differ from the CPU's by {err} (atol 2e-3)")
    del cpu_model

    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas"
    ).to(torch.bfloat16)
    del model
    engine = fi.FastInferenceEngine(bf16, SIGLIP_MEAN, SIGLIP_STD)

    g = np.random.default_rng(8)
    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(SIGLIP_BATCH, 224, 224, 3), dtype=np.uint8))).cuda()
        for _ in range(2)]
    ids = [torch.from_numpy(g.integers(2, 256000, size=(SIGLIP_BATCH, 64)).astype(np.int32)
                            ).cuda() for _ in range(N_SIGLIP224_BATCHES)]
    mask = torch.ones(SIGLIP_BATCH, 64, dtype=torch.int32, device="cuda")
    ones = torch.ones(SIGLIP_BATCH, device="cuda")
    logits = engine(ids[0], mask, patches[0], ones, ones)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (SIGLIP_BATCH, len(CLASSES))
          and bool(logits.float().isfinite().all()),
          f"siglip224 logits {tuple(logits.shape)}, finite={bool(logits.float().isfinite().all())}")
    # the path: 2 staged passes, counted from 0
    counts = _reset_counts()
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        for i, x in enumerate(ids):
            engine(x, mask, patches[i % 2], ones, ones)
        torch.cuda.synchronize()
        rates.append(len(ids) * SIGLIP_BATCH / (time.perf_counter() - t0))
    launches = counts()
    n_batches = 2 * len(ids)
    want = _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches)
    check(launches == want, f"siglip224: launches {launches}, want {want}")
    report["main_path_launches"] = launches
    report["main_path_batches"] = n_batches
    report["staged_samples_per_s_seq64"] = {"mean_of_2": sum(rates) / 2, "passes": rates,
                                            "card": card}
    report["device_time_seq64"] = device_time_breakdown(
        torch, lambda: [engine(x, mask, patches[i % 2], ones, ones)
                        for i, x in enumerate(ids[:2])], 2,
    )
    return report


def mha_dense_mask_phase(torch):
    """``ops.layers.mha(impl="pallas")`` with a dense mask (CLIP's causal +
    padding mask, as its "xla" text path builds it) at the CLIP text shape:
    the route to ``attention_small``, once per call, against the "xla"
    core. fp32 (TF32 off): atol 1e-4, the same math in another order; bf16:
    two bf16 ulps (rtol 2^-6) + atol 1e-2, as the "xla" core rounds the
    softmax weights to bf16 before the product with v and the kernel does
    not, and both round the output projection once."""
    from multimodal_content_moderation_tpu_torch.models.clip import _text_masks
    from multimodal_content_moderation_tpu_torch.ops import layers

    g = torch.Generator(device="cuda").manual_seed(7)
    B, T, D, h = SIGLIP_BATCH, 77, 512, 8
    p = {n: {"w": torch.randn(D, D, generator=g, device="cuda") * D ** -0.5,
             "b": torch.randn(D, generator=g, device="cuda") * 0.1} for n in "qkvo"}
    x = torch.randn(B, T, D, generator=g, device="cuda")
    lengths = torch.randint(2, T + 1, (B,), generator=g, device="cuda")
    attention_mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).int()
    mask = _text_masks(attention_mask, attention_mask)  # [B, 1, T, T] fp32
    report = {"case": f"x [{B}, {T}, {D}], {h} heads, dense causal + padding mask"}
    counts = _reset_counts()
    for dtype, atol, rtol in (("float32", 1e-4, 0.0), ("bfloat16", 1e-2, 2.0**-6)):
        dt = getattr(torch, dtype)
        pd = {n: {k: t.to(dt) for k, t in d.items()} for n, d in p.items()}
        got = layers.mha(x.to(dt), x.to(dt), pd, h, mask, impl="pallas")
        want = layers.mha(x.to(dt), x.to(dt), pd, h, mask, impl="xla")
        err, ok = max_err_within(got, want, atol, rtol)
        check(ok, f"mha pallas with a dense mask {dtype}: err {err} vs the xla core "
                  f"(atol {atol} + rtol {rtol})")
        report[f"{dtype}_max_abs_err_vs_xla"] = err
    report["launches"] = counts()
    # one launch a call; the bf16 one on the tensor cores
    want = {**_counts(attention_small=2), "attention_small_tensor_core": 1}
    check(report["launches"] == want,
          f"mha with a dense mask launches {report['launches']}, want 1 attention_small a call")
    return report


# device-kernel name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = [
    ("attention_nhd_bwd", ("attention_nhd_bwd",)),
    ("attention_nhd", ("attention_nhd",)),
    ("flash_attention", ("flash_attention",)),
    ("attention_small", ("attention_small",)),
    ("patch_embed_u8", ("patch_embed_u8",)),
    ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "cublas")),
    ("layer_norm", ("layer_norm",)),
    ("dtype casts and copies", ("copy",)),
    ("other elementwise", ("elementwise", "reduce", "index", "cat")),
]


def device_time_breakdown(torch, run, n_batches: int):
    """Device time per batch by kernel (torch.profiler over ``run``), the
    share of the wall time the device was busy, and the top kernels. Says
    "not measured" where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms == 0:
        return "not measured (the profiler reported no device time)"
    rows.sort(key=lambda r: -r[1])
    groups = {}
    for name, ms, _ in rows:
        low = name.lower()
        group = next(
            (g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other"
        )
        groups[group] = groups.get(group, 0.0) + ms / n_batches
    return {
        "wall_ms_per_batch": wall_ms / n_batches,
        "device_busy_ms_per_batch": busy_ms / n_batches,
        "device_busy_share_of_wall": busy_ms / wall_ms,
        "groups_ms_per_batch": groups,
        "top_kernels_ms_per_batch": [
            [name[:90], ms / n_batches, count // n_batches] for name, ms, count in rows[:12]
        ],
    }


KERNELS = ["patch_embed_u8", "attention_nhd", "attention_nhd_bwd", "flash_attention",
           "attention_small"]
REPLACES = {
    "patch_embed_u8": "multimodal_content_moderation_tpu/ops/pallas_image.py:93",
    "attention_nhd": "multimodal_content_moderation_tpu/ops/pallas_attention.py:318",
    "attention_nhd_bwd": "multimodal_content_moderation_tpu/ops/pallas_attention.py:468",
    "flash_attention": "multimodal_content_moderation_tpu/ops/pallas_attention.py:663",
    "attention_small": "multimodal_content_moderation_tpu/ops/pallas_attention.py:90",
}
# each path's unit of work, and each kernel's launches in one unit
UNITS = {
    "siglip384": "one SigLIP2-B/16-384 eval batch, bf16, B=64",
    "siglip224": "one SigLIP2-B/16-224 eval batch, bf16, B=64, text seq 64",
    "evaluate": "one CLIP ViT-B/32 eval batch, bf16, B=144",
    "train": "one CLIP ViT-B/32 training micro-step, bf16, B=32",
    "siglip224_train": "one SigLIP2-B/16-224 training micro-step, bf16, B=24, text seq 64",
    "mha_dense_mask": "one mha(impl='pallas') call with a dense mask, bf16",
}
# the shared headers each kernel's source includes
HEADERS = {
    "patch_embed_u8": ["mma_common.cuh"],
    "attention_nhd": ["attention_mma.cuh", "mma_common.cuh"],
    "attention_nhd_bwd": ["attention_mma.cuh", "mma_common.cuh"],
    "flash_attention": ["attention_mma.cuh", "mma_common.cuh"],
    "attention_small": ["attention_mma.cuh", "mma_common.cuh"],
}
PER_UNIT = {
    "siglip384": {"patch_embed_u8": 1, "attention_nhd": 12, "flash_attention": 12},
    "siglip224": {"patch_embed_u8": 1, "attention_nhd": 24},
    "evaluate": {"patch_embed_u8": 1, "attention_nhd": 24},
    "train": {"patch_embed_u8": 1, "attention_nhd": 24, "attention_nhd_bwd": 24},
    "siglip224_train": {"attention_nhd": 24, "attention_nhd_bwd": 24},
    "mha_dense_mask": {"attention_small": 1},
}
WORK = {
    "siglip384": {
        "patch_embed_u8": "[36864, 768] x [768, 768] + bias",
        "attention_nhd": "12 text [64,64,768]/12 heads, key mask",
        "flash_attention": "12 vision [64,576,768]/12 heads, no mask",
    },
    "siglip224": {
        "patch_embed_u8": "[12544, 768] x [768, 768] + bias",
        "attention_nhd": "12 vision [64,196,768]/12 heads + 12 text [64,64,768]/12 heads, "
                         "key mask",
    },
    "evaluate": {
        "patch_embed_u8": "[7056, 3072] x [3072, 768]",
        "attention_nhd": "12 vision [144,50,768]/12 heads + 12 text [144,77,512]/8 heads",
    },
    "train": {
        "patch_embed_u8": "[1568, 3072] x [3072, 768]",
        "attention_nhd": "12 vision [32,50,768]/12 heads + 12 text [32,48,512]/8 heads",
        "attention_nhd_bwd": "12 vision [32,50,768]/12 heads + 12 text [32,48,512]/8 heads",
    },
    "siglip224_train": {
        "attention_nhd": "12 vision [24,196,768]/12 heads + 12 text [24,64,768]/12 heads, "
                         "key mask",
        "attention_nhd_bwd": "12 vision [24,196,768]/12 heads + 12 text [24,64,768]/12 heads, "
                             "key mask",
    },
    "mha_dense_mask": {"attention_small": "[64, 8, 77, 64] views of [64, 77, 512] + a dense "
                                          "[64, 1, 77, 77] fp32 mask read broadcast"},
}
# the path whose numbers head each kernel's entry, fixed so that entries
# compare from one run to the next; other_paths carries the rest
PRIMARY = {"patch_embed_u8": "siglip384", "attention_nhd": "siglip384",
           "flash_attention": "siglip384", "attention_nhd_bwd": "train",
           "attention_small": "mha_dense_mask"}


def _per_unit(name, cases, path):
    """Sums over the launches of one unit of a path's work, from the bf16
    cases timed at that path's shapes."""
    main = [c for c in cases if c["kernel"] == name and path in c["paths"]]
    if not main:
        return None
    each = PER_UNIT[path][name] // len(main)
    keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
    if all("simt_ms" in c for c in main):  # the earlier SIMT kernel, timed beside
        keys.append("simt_ms")
    out = {k: each * sum(c[k] for c in main) for k in keys}
    out["bound_by"] = max(main, key=lambda c: c["bound_ms"])["bound_by"]
    out["timed_by"] = {k: _how(*(c["timed_by"][k] for c in main))
                       for k in keys if k != "bound_ms"}
    out["work"] = f"{UNITS[path]}: {WORK[path][name]}"
    return out


def kernel_entry(name, cases, launches_by_path):
    """One kernel of the ``{"kernels": ...}`` line: the numbers of its
    primary path's unit of work with that path's launches, and every other
    path's numbers and launches beside them."""
    primary = PRIMARY[name]
    main = _per_unit(name, cases, primary)
    return {
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/{name}.cu",
        "headers": [f"{PKG}/csrc/{h}" for h in HEADERS[name]],
        "replaces": REPLACES[name],
        "launches": launches_by_path[primary][name],
        "tensor_core_launches": launches_by_path[primary].get(f"{name}_tensor_core"),
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == name),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "simt_ms": main.get("simt_ms"),
        "timed_by": main["timed_by"],
        "work": main["work"],
        "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()},
        "other_paths": {path: _per_unit(name, cases, path) for path in PER_UNIT
                        if path != primary and name in PER_UNIT[path]},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG, "csrc")):
        print(f"chip_smoke: {PKG}/ is missing beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from multimodal_content_moderation_tpu_torch.ops import _build

    # fp32 products stay fp32 (no TF32) wherever a comparison is made
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device and build
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in _build.ptxas_reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = (patch_embed_cases(torch, g) + attention_cases(torch, g) + flash_cases(torch, g)
             + small_cases(torch, g) + attention_bwd_cases(torch, g))
    for c in cases:
        print(
            f"{c['kernel']:17s} {c['dtype']:8s} {c['case']:60s} err {c['max_abs_err']:.3g} "
            f"(atol {c['atol']:g} rtol {c['rtol']:.3g}) kernel {c['ms']:.4f} ms "
            f"plain {c['plain_ms']:.4f} ms library {c['library_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
            + (f" JAX estimate {c['jax_estimate_ms']:.4f} ms" if "jax_estimate_ms" in c else "")
            + (f" SIMT {c['simt_ms']:.4f} ms (SIMT new new SIMT "
               f"{', '.join(f'{t:.4f}' for t in c['simt_new_new_simt_ms'])})"
               if "simt_ms" in c else "")
            + "".join(f" [{k} by events]" for k, how in c["timed_by"].items() if how != "graph")
        )
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # phase 3: the CLIP eval path through the entry points
    t0 = time.perf_counter()
    report = full_model_phase(torch, card)
    for k, v in report.items():
        print(f"model {k}: {v}")
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # phase 4: the training path through the entry points
    t0 = time.perf_counter()
    train = train_phase(torch, card)
    for k, v in train.items():
        print(f"train {k}: {v}")
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # phase 5: the SigLIP-384 and SigLIP-224 eval paths, and attention_small
    # through mha
    t0 = time.perf_counter()
    siglip = siglip_phase(torch, card)
    for k, v in siglip.items():
        print(f"siglip {k}: {v}")
    siglip224 = siglip224_phase(torch, card)
    for k, v in siglip224.items():
        print(f"siglip224 {k}: {v}")
    mha = mha_dense_mask_phase(torch)
    print(f"mha dense mask: {mha}")
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # phase 6: the shipped fine-tuning configs on the f32 wire
    t0 = time.perf_counter()
    clip_f32 = clip_f32_train_phase(torch, card)
    for k, v in clip_f32.items():
        print(f"clip f32 train {k}: {v}")
    siglip_train = siglip224_train_phase(torch, card)
    for k, v in siglip_train.items():
        print(f"siglip224 train {k}: {v}")
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    launches_by_path = {"siglip384": siglip["main_path_launches"],
                        "siglip224": siglip224["main_path_launches"],
                        "evaluate": report["main_path_launches"],
                        "train": train["main_path_launches"],
                        "siglip224_train": siglip_train["pallas"]["main_path_launches"],
                        "mha_dense_mask": mha["launches"]}
    kernels = [kernel_entry(name, cases, launches_by_path) for name in KERNELS]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "cases": cases, "model": report, "train": train, "siglip": siglip,
                   "siglip224": siglip224, "mha_dense_mask": mha, "clip_f32_train": clip_f32,
                   "siglip224_train": siglip_train, "kernels": kernels},
                  f, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
