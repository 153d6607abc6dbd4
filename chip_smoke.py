#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, and the five kernels built from ``csrc/`` with nvcc (one
   process per source, started together), with their ``-Xptxas -v`` lines.
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the shapes of the eval, training, SigLIP-384, SigLIP-224,
   SigLIP-224 training and generic (ViT-B/16 at T=197, BERT's non-causal
   key-masked text at seq 77 with a one-token and a [CLS] [SEP] row) paths
   and a few edge shapes, each held to a stated
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
   written as a reference-format checkpoint (``models/export.py``, as every
   reference checkpoint of this script), loaded with ``load_checkpoint``,
   run through ``FastInferenceEngine`` + ``evaluate_logits_u8`` in bf16 with
   the kernels, with text buckets off and on; the launch counters must show
   1 patch_embed_u8 and 24 attention_nhd launches per batch, every one of
   them on the tensor cores (``tensor_core_launches``); fp32 logits on
   the card must match the same model's CPU logits; the checkpoint written
   again as ``model.safetensors`` (``convert.write_safetensors``) must load
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
7. The moderation endpoint at full CLIP ViT-B/32 width, from JPEG bytes and
   real text, with PIL, pandas, ``regex``, yaml and JAX hidden from imports
   for the whole run: the native JPEG decoder (libjpeg, or nvJPEG where the
   machine has no libjpeg; named in the output) on every committed fixture
   against its committed PIL crop, and its decode rate at 224 and 384 px;
   the bf16 classifier's answers on the fixtures from their PIL crops and
   from the native decode, side by side; a
   reference-format checkpoint with a synthetic 49,408-entry CLIP BPE
   vocabulary; a cold start of ``python -m ...serving.server`` in a fresh
   process and build directory (seconds to /ping 200); ``cli/evaluate.main``
   (fast engine, native_scaled, the kernels, bf16, buckets, a pixel cache)
   twice over a CSV of tweet-length rows with NA strings and missing images,
   the second run decoding nothing; ``serving.server.serve`` in a thread
   (``SERVE_ENV``): /ping, 404, 400, single and batch requests, fp32 card
   probabilities against ``MultiModalClassifier(device="cpu")`` (atol 1e-4),
   bf16 ``forward_batch`` logits against fp32 (3e-2), buckets against none
   (fp32, 1e-5), 4 concurrent clients each getting its own rows with
   micro-batching off and on, then requests/s and p50 / p99 latency over
   ``LOAD_WINDOW_S`` of load at 1, 4 and 16 clients, off and on, with 1
   ``patch_embed_u8`` and 24 ``attention_nhd`` launches per served batch,
   all on the tensor cores.
8. The multi-task head (``config/clip_mtl.yaml``: 5 tasks, fusion 512,
   hidden task heads of 256, learned task weights) on CLIP ViT-B/32's bare
   towers, random weights from a seed: ``Trainer.train`` at B=32 x 2 as
   shipped (f32 wire, attention "xla": no kernel runs) and on the u8 wire
   with attention "pallas" (1 ``patch_embed_u8``, 24 ``attention_nhd`` and
   24 ``attention_nhd_bwd`` per micro-step, all on the tensor cores), each
   with a falling loss on a fixed batch, ``head.log_vars`` moving, staged
   samples/s and CUDA-event step parts; fp32 card-vs-CPU gradients on
   every leaf; a reference-format multi-task checkpoint (``tower_txt.`` /
   ``tower_img.`` + the ``MultiTaskClassifier`` head) through
   ``load_checkpoint`` -> ``FastInferenceEngine`` -> ``evaluate_logits_u8``
   (fp32 card vs CPU, fp32 buckets vs none within 1e-5, bf16 B=144 with 1 +
   24 launches per batch, staged samples/s at seq 77 and 32);
   SigLIP2-B/16-224 with the shared "auto" backbone (B=64, seq 64, 1 + 24
   launches per batch, no ``flash_attention``); and the endpoint's
   ``model_fn`` -> ``predict_fn`` on that checkpoint (answers keyed by the
   task names, fp32 card vs ``MultiModalClassifier(device="cpu")`` within
   1e-4).
9. The generic dual encoder (``VisionTextDualEncoderModel`` over ViT-B/16
   at 224 px and BERT-base, projection 512, random weights from a seed): a
   reference-format checkpoint (``backbone.`` + the VTDE names + the fusion
   head, ``model.safetensors``) and an encoder dir whose BERT
   ``tokenizer.json`` over a synthetic 30,522-entry vocabulary must load in
   the port's ``JSONTokenizer``; eval through ``load_checkpoint`` ->
   ``FastInferenceEngine`` -> ``evaluate_logits_u8`` (fp32 card vs CPU
   within 1e-5; bf16, B=64, width 77, ``seq_buckets`` "auto", which the
   generic backend runs at full width: 1 ``patch_embed_u8`` and 24
   ``attention_nhd`` per batch on the tensor cores, every batch at width
   77; staged samples/s) and one ``--engine standard`` batch; training as
   ``config/default.yaml`` gives it (B=32 x 2, bf16) through ``Trainer`` on
   the f32 wire ("xla") and the u8 wire ("pallas": 1 / 12 / 12 launches a
   micro-step, the text tower's dropout on the non-kernel core), a falling
   loss on a fixed batch, staged samples/s, step parts, fp32 card-vs-CPU
   gradients on every leaf; RoBERTa-base and DistilBERT-base towers (fp32
   card vs CPU, 1 + 24 and 1 + 18 launches); the multi-task head on the
   generic backbone (2 u8 micro-steps, one eval batch); the endpoint over
   HTTP (fp32 card vs the CPU classifier within 1e-5, no bucket ladder) and
   the evaluate CLI over a CSV.
10. The int8 fc1 tier (``--precision int8_mlp``: bf16_fast with int8
   products in the (768, 3072) fc1 layers, ``ops/quant.py``) and the
   export. (a) ``dense_int8`` at [7200, 768] x [768, 3072] and at 1, 16 and
   17 rows: the card's output equal to the CPU's bit for bit, the
   ``_int_mm`` accumulator equal to the fp32 product of the same int8
   values; ``dense_int8``, ``_int_mm`` alone (with the column-major int8
   weight, and row-major beside it) and the bf16 ``dense`` timed beside
   their bounds. (b) CLIP ViT-B/32 fusion from an exported
   checkpoint: 12 quantized layers, fp32 int8 card vs CPU, int8_mlp vs
   bf16_fast, B=144 with 1 + 24 launches a batch and buckets equal to
   none, staged samples/s of both tiers in turn. (c) SigLIP2-B/16-224 and
   ViT-B/16 + BERT-base at int8_mlp, B=64: 24 quantized layers each, the
   MAP head untouched. (d) The evaluate CLI over phase 7's CSV and
   ``model_fn`` at int8_mlp. (e) ``cli/export.py`` on the run directories
   that phases 6, 8 and 9 trained: each bundle's keys are its layout's, and
   it reloads to the run's parameters and fp32 logits bit for bit.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Per-case details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import shutil
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
GENERIC_BATCH = 64  # config/default.yaml per_device_eval_batch_size
GENERIC_T = 197  # ViT-B/16 at 224 px: 196 patches + the class token
GENERIC_TEXT_T = 77  # config/default.yaml max_text_length (text_fit is CLIP's)
GENERIC_NEG_INF = -1e9  # the generic towers' key bias (models/generic.py)
GENERIC_SPECS = [
    (GENERIC_BATCH, GENERIC_T, 768, 12, False, False,
     "generic eval path: vision tower, ViT-B/16, T=197"),
    (GENERIC_BATCH, GENERIC_TEXT_T, 768, 12, False, True,
     "generic eval path: text tower, seq 77, key mask, not causal"),
    (TRAIN_BATCH, GENERIC_T, 768, 12, False, False,
     "generic train path: vision tower, ViT-B/16, T=197"),
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
    "siglip224_train" (SigLIP2-B/16-224 training, B=24), "mha_dense_mask",
    "generic_eval" and "generic_train" (ViT-B/16 + BERT-base, B=64 / 32)."""
    if dtype != "bfloat16":
        return []
    return {"main path": ["evaluate"], "train path": ["train"],
            "siglip384 path": ["siglip384"], "siglip224 path": ["siglip224"],
            "siglip text": ["siglip384", "siglip224"],
            "siglip224 train path": ["siglip224_train"],
            "mha dense mask": ["mha_dense_mask"],
            "generic eval path": ["generic_eval"],
            "generic train path": ["generic_train"]}.get(label.split(":")[0], [])


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


def _keep_rows(torch, g, B, S, first=(0,)):
    """Right padding of varied lengths (1 to S); the first rows take the
    lengths ``first``: by default row 0 has every key masked."""
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    lengths[: len(first)] = torch.tensor(first, device="cuda")
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
        (GENERIC_BATCH * (GENERIC_T - 1), 768, 768,
         "generic eval path: ViT-B/16 with its bias, B=64"),
        (TRAIN_BATCH * (GENERIC_T - 1), 768, 768, "generic train path: ViT-B/16, B=32"),
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
    # the serving path's B=32 batches at the text widths it launches besides
    # the train path's 48 (its vision tower is the train path's shape)
    specs += [(SERVE_BATCH, T, 512, 8, True, True, f"serving path: text tower, seq {T}")
              for T in (32, 64, 77)]
    specs += [(SIGLIP_BATCH, 64, 768, 12, False, True,
               "siglip text: text tower, seq 64, key mask, not causal"),
              (SIGLIP_BATCH, SIGLIP224_T, 768, 12, False, False, "siglip224 path: vision tower")]
    specs += SIGLIP224_TRAIN_SPECS
    specs += GENERIC_SPECS
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
                # the generic text tower: a one-token row, a [CLS] [SEP] row,
                # a full row; its key bias is -1e9 (models/generic.py)
                generic = label.startswith("generic")
                keep = _keep_rows(torch, g, B, T, (1, 2, T) if generic else (0,))
                km = (1.0 - keep.float()) * (GENERIC_NEG_INF if generic else ca.NEG_INF)
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
    # the generic training micro-step: only the vision tower takes the
    # kernels (the text tower's dropout takes the non-kernel core)
    specs += [spec for spec in GENERIC_SPECS if spec[-1].startswith("generic train")]
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


class InMemoryDataset:
    """Seeded uint8 crops and token ids with the ``.batches()`` contract of
    ``data.dataset.CSVDataset``. CLIP-style ids (the default): BOS, random
    tokens, EOS at a position between 8 and 40, EOS padding, 224x224 crops.
    SigLIP-style (``siglip=True``): 8 to 60 random tokens then PAD (id 0)
    padding, so the rows fall in the 32, 48 and 64 text buckets, and
    ``image_size`` crops. BERT-style (``bert=True``): [CLS], word pieces,
    [SEP] (8 to 60 in all), [PAD] padding. With ``stats`` (mean, std) the batches carry the
    crops as normalised float32 CHW pixels (a float_nchw preprocessor's
    output, through ``data.images.normalize_crop``), else as the uint8
    crops."""

    def __init__(self, n: int, seed: int, T: int = 77, siglip: bool = False,
                 image_size: int = 224, stats=None, bert: bool = False):
        import numpy as np

        self.stats = stats
        g = np.random.default_rng(seed)
        self.attention_mask = np.zeros((n, T), np.int32)
        if bert:  # [CLS] 6 to 58 word pieces [SEP], then [PAD] (id 0)
            self.input_ids = np.zeros((n, T), np.int32)
            for i, length in enumerate(g.integers(8, 61, size=n)):
                self.input_ids[i, :length] = g.integers(1000, 30522, size=length)
                self.input_ids[i, 0], self.input_ids[i, length - 1] = 101, 102
                self.attention_mask[i, :length] = 1
        elif siglip:
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


def staged_eval_rates(torch, engine, ids, patches, mask, passes: int = 3):
    """Samples/s of the engine over batches already on the card (distinct
    ids per batch, one synchronise per pass): the median and every pass."""
    B = ids[0].shape[0]
    ones = torch.ones(B, device="cuda")
    engine(ids[0], mask, patches[0], ones, ones)
    torch.cuda.synchronize()
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for i, x in enumerate(ids):
            engine(x, mask, patches[i % len(patches)], ones, ones)
        torch.cuda.synchronize()
        rates.append(len(ids) * B / (time.perf_counter() - t0))
    return {"median": sorted(rates)[len(rates) // 2], "passes": rates}


def full_model_phase(torch, card: str):
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import export
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.training.metrics import compute_detailed_metrics

    report = {}
    ckpt = os.path.join(REPO, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    os.makedirs(ckpt)
    src = FusionModel.create("clip", num_labels=len(CLASSES), seed=0, device="cuda")
    torch.save(export.reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
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
        report[f"staged_samples_per_s_seq{width}"] = {
            **staged_eval_rates(torch, engine, ids, patches, mask), "card": card}
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
    convert.write_safetensors(sd, st_file)
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


def staged_training(torch, model, staged, card, accum, batch_size, profile: bool = True):
    """Training samples/s over staged batches (3 passes of 8 micro-steps),
    the CUDA-event time of the forward, backward and optimizer per
    micro-step, and (``profile``) a profiler breakdown of one optimizer
    step."""
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
    out = {
        "staged_train_samples_per_s": {"median": sorted(rates)[1], "passes": rates, "card": card},
        "train_step_parts_ms": step_parts_ms(torch, model, opt, gen, staged),
    }
    if profile:
        out["device_time_train"] = device_time_breakdown(
            torch, lambda: [step(staged[i]) for i in range(accum)], 1)
    return out


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


def trainer_run(torch, model, args, train_ds, val_ds, want_fn, label, metrics=None):
    """``Trainer.train`` for one epoch on the card, counted from 0: the
    launches must equal ``want_fn(micro_steps, eval_batches)``; returns the
    report and the trainer. ``metrics``: the fusion metrics by default."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.training.loop import Trainer
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_multi)

    trainer = Trainer(model, args, train_ds, val_ds,
                      metrics or make_compute_metrics_multi(len(CLASSES)), device="cuda")
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


# the port run directories that phases 6, 8 and 9 train and phase 10 (e) exports
EXPORT_ROOT = os.path.join(REPO, "build", "chip_smoke_export")


def keep_run(out_dir: str, name: str, hf_cfg: dict, **inference):
    """Move a ``Trainer`` run's newest ``checkpoint-N`` to
    ``EXPORT_ROOT/name/`` as the port's run directory (``"format":
    "torch"``, the encoder's ``config.json`` in the checkpoint), for phase
    10 (e), and remove the rest of ``out_dir``."""
    from multimodal_content_moderation_tpu_torch.training.checkpoints import list_checkpoints

    ckpts = list_checkpoints(out_dir)
    check(bool(ckpts), f"{name}: the Trainer wrote no checkpoint under {out_dir}")
    run = os.path.join(EXPORT_ROOT, name)
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)
    ckpt = shutil.move(ckpts[-1], os.path.join(run, os.path.basename(ckpts[-1])))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    with open(os.path.join(run, "inference_config.json"), "w") as f:
        json.dump({"fusion_dim": 512, "class_names": CLASSES, "max_text_length": 77,
                   "format": "torch", **inference}, f)
    shutil.rmtree(out_dir, ignore_errors=True)


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
    keep_run(out_dir, "clip_fusion", HF_CLIP_B32, backend="clip", head="fusion")

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
    from multimodal_content_moderation_tpu_torch.models import export
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
    torch.save(export.reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
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
    from multimodal_content_moderation_tpu_torch.models import export
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
    torch.save(export.reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
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


# ---------------------------------------------------------------------------
# Phase 7: the moderation endpoint and the evaluate CLI, from CSV rows and
# JPEG bytes
# ---------------------------------------------------------------------------

SERVE_BATCH = 32  # MultiModalClassifier's batch (the JAX endpoint's too)
N_CSV_ROWS = 9 * SERVE_BATCH - 7  # nine batches, the last one padded
# the endpoint as phase 7 serves it (serving/handler.model_fn's knobs)
SERVE_ENV = {"MMHARM_ENGINE": "fast", "MMHARM_ATTENTION": "pallas",
             "MMHARM_PRECISION": "bf16", "MMHARM_IMAGE_BACKEND": "native_scaled",
             "MMHARM_SEQ_BUCKETS": "auto", "MMHARM_PREWARM": "1"}
MICROBATCH_MS = "4"  # the JAX MicroBatcher's default window
# what the card's path runs without: hidden from imports for the whole run
HIDDEN_MODULES = ["jax", "jaxlib", "multimodal_content_moderation_tpu", "PIL", "pandas",
                  "regex", "yaml"]
WORDS = ("the a you they this that is are was not just so really why how all people "
         "women men immigrants refugees neighbours go back home hate love stupid "
         "disgusting trash never always ever lol wtf smh rt #news #politics #tbt "
         "@user @friend 🙂 😂 🔥 ... !!! ?? don't they're it's I'll").split()
NA_TEXTS = ["", "NA", "null", "None", "nan", "N/A", "   "]
LOAD_CLIENTS = (1, 4, 16)
LOAD_WINDOW_S = 12.0  # each level: clients post back to back for this long


def tweet(g) -> str:
    """A tweet-length text (3 to 40 words, at most 280 characters)."""
    words = [WORDS[int(i)] for i in g.integers(0, len(WORDS), size=int(g.integers(3, 41)))]
    if g.random() < 0.3:
        words[0] = words[0].upper()
    return " ".join(words)[:280]


def write_serving_checkpoint(torch, root: str, hf_cfg: dict, device: str,
                             head: str = "fusion") -> str:
    """A reference-format CLIP checkpoint (random weights from a seed) with a
    synthetic 49,408-entry CLIP BPE vocabulary, so that real text is
    tokenized by the port's own BPE: the fusion head, or with ``head="mtl"``
    the multi-task head at ``config/clip_mtl.yaml``'s settings."""
    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import export
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.testdata import write_clip_bpe

    ckpt = os.path.join(root, "checkpoint")
    os.makedirs(ckpt)
    mtl = MTL_HEAD if head == "mtl" else {}
    src = model_io.build_model(head, "clip", CLASSES, seed=3, device=device,
                               clip_config=model_io.clip_config_from_dict(hf_cfg), **mtl)
    torch.save(export.reference_state_dict(src), os.path.join(ckpt, "pytorch_model.bin"))
    del src
    size = hf_cfg["vision_config"]["image_size"]
    files = {
        "config.json": hf_cfg,
        "inference_config.json": {
            "backend": "clip", "head": head, "fusion_dim": 512, "class_names": CLASSES,
            "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5], "max_text_length": 77, **mtl},
        "preprocessor_config.json": {
            "size": {"shortest_edge": size}, "crop_size": {"height": size, "width": size},
            "image_mean": list(CLIP_MEAN), "image_std": list(CLIP_STD)},
    }
    for name, obj in files.items():
        with open(os.path.join(ckpt, name), "w") as f:
            json.dump(obj, f)
    vocab = write_clip_bpe(ckpt, hf_cfg["text_config"]["vocab_size"], seed=0)
    check(vocab["<|startoftext|>"] == hf_cfg["text_config"]["bos_token_id"]
          and vocab["<|endoftext|>"] == hf_cfg["text_config"]["eos_token_id"],
          "synthetic vocabulary: BOS/EOS ids differ from the config's")
    return ckpt


def decode_checks():
    """Every committed JPEG fixture through the native decoder at 224 and
    384 px against its committed PIL crop: libjpeg unscaled must be
    bit-identical, and scaled within the JAX package's scaled-path tolerance
    (tests/test_native_ops.py: mean absolute difference < 2.0 levels).
    nvJPEG has no scaled decode; its planes are upsampled and converted as
    libjpeg does, so only its IDCT's rounding is left: mean < 0.5 and at
    most 8 levels on any sample (measured on an H100: 0.13 and 3). The
    corrupt fixture must not decode (and must not raise: a raise is a fault
    of the decoder, not of the bytes)."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data import native
    from multimodal_content_moderation_tpu_torch.testdata import (
        CROP_SIZES, jpeg_fixtures, pil_crops)

    decoder = native.jpeg_decoder()
    check(decoder in ("libjpeg", "nvjpeg"), f"no JPEG decoder in the native library "
                                            f"(build attempts: {native.build_log})")
    report = {"decoder": decoder, "build_attempts": list(native.build_log), "cases": []}
    for name, path in jpeg_fixtures().items():
        data = path.read_bytes()
        crops = pil_crops(name)
        for size in CROP_SIZES:
            for scaled in (False, True) if decoder == "libjpeg" else (False,):
                got = native.decode_jpeg_resize_crop(data, size, scaled=scaled)
                label = f"{name} {size}px {'scaled' if scaled else 'full'}"
                if crops is None:
                    check(got is None, f"decode {label}: a corrupt file decoded")
                    continue
                check(got is not None, f"decode {label}: failed")
                diff = np.abs(got.astype(np.int32) - crops[size].astype(np.int32))
                case = {"case": label, "mean_abs_diff": float(diff.mean()),
                        "max_abs_diff": int(diff.max())}
                if decoder == "libjpeg" and not scaled:
                    check(case["max_abs_diff"] == 0, f"decode {label}: {case} (want exact)")
                elif decoder == "nvjpeg":
                    check(case["mean_abs_diff"] < 0.5 and case["max_abs_diff"] <= 8,
                          f"decode {label}: {case} (want mean < 0.5, max <= 8)")
                else:
                    check(case["mean_abs_diff"] < 2.0, f"decode {label}: {case} (want < 2.0)")
                report["cases"].append(case)
    report["max_mean_abs_diff"] = max(c["mean_abs_diff"] for c in report["cases"])
    report["max_abs_diff"] = max(c["max_abs_diff"] for c in report["cases"])
    return report


def decode_rates(card: str):
    """Decoded 224 and 384 px crops per second through the native library
    with 1 and 8 threads, over the committed fixtures (sources 97x203 to
    456x610 px). libjpeg runs on the host's cores; nvJPEG is hybrid: entropy
    decode, upsampling, colour conversion and resize on the host's cores,
    the IDCT on the card."""
    import concurrent.futures as cf

    from multimodal_content_moderation_tpu_torch.data import native
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures, pil_crops

    blobs = [p.read_bytes() for n, p in jpeg_fixtures().items() if pil_crops(n) is not None]
    decoder = native.jpeg_decoder()
    out = {"card": card, "cpu_cores": os.cpu_count(), "decoder": decoder,
           "where": "host cores" if decoder == "libjpeg" else "host cores + card (IDCT)"}
    for size in (224, 384):
        for threads in (1, 8):
            work = blobs * (40 if threads == 1 else 160)
            with cf.ThreadPoolExecutor(threads) as pool:
                list(pool.map(lambda b: native.decode_jpeg_resize_crop(b, size, True),
                              blobs * threads))  # warm every thread's decoder state
                t0 = time.perf_counter()
                list(pool.map(lambda b: native.decode_jpeg_resize_crop(b, size, True), work))
                dt = time.perf_counter() - t0
            out[f"{size}px_{threads}_threads_images_per_s"] = len(work) / dt
    return out


def write_csv(root: str, g) -> str:
    """``N_CSV_ROWS`` rows of tweet-length texts (with NA strings and empty
    texts), JPEG paths into ``root/images`` (some missing, some empty, one
    corrupt) and multi-label ``labels``."""
    import csv

    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

    images = os.path.join(root, "images")
    os.makedirs(images)
    names = []
    for name, path in jpeg_fixtures().items():
        shutil.copy(path, os.path.join(images, path.name))
        names.append(path.name)
    path = os.path.join(root, "test.csv")
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["text", "image_path", "labels"])
        for i in range(N_CSV_ROWS):
            text = NA_TEXTS[i // 11 % len(NA_TEXTS)] if i % 11 == 5 else tweet(g)
            image = ("" if i % 13 == 4 else f"missing_{i}.jpg" if i % 13 == 9
                     else names[i % len(names)])
            labels = ",".join(c for c in CLASSES if g.random() < 0.25)
            w.writerow([text, image, labels])
    return path


def csv_evaluate_checks(ckpt: str, root: str, g, device: str):
    """``cli/evaluate.main`` as a user runs it on the card, twice over one
    CSV with one pixel cache: both runs write ``eval_results.json`` with the
    same metrics; the first decodes every row whose JPEG exists, the second
    decodes nothing (every row is a cache hit); each launches 1
    ``patch_embed_u8`` and 24 ``attention_nhd`` per batch, on the tensor
    cores."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.cli import evaluate
    from multimodal_content_moderation_tpu_torch.data import native

    csv_path = write_csv(root, g)
    n_batches = -(-N_CSV_ROWS // SERVE_BATCH)
    decodes = []  # one entry per call (list.append is atomic across threads)
    real_decode = native.decode_jpeg_resize_crop

    def counted(*a, **k):
        decodes.append(1)
        return real_decode(*a, **k)

    native.decode_jpeg_resize_crop = counted
    runs = []
    try:
        for run in (1, 2):
            out = os.path.join(root, f"eval_results_{run}.json")
            decodes.clear()
            counts = _reset_counts()
            t0 = time.perf_counter()
            metrics = evaluate.main([
                "--checkpoint", ckpt, "--test_csv", csv_path, "--image_root",
                os.path.join(root, "images"), "--batch_size", str(SERVE_BATCH),
                "--engine", "fast", "--image_backend", "native_scaled", "--attention", "pallas",
                "--precision", "bf16", "--seq_buckets", "auto",
                "--image_cache", os.path.join(root, "pixel_cache"), "--device", device,
                "--output", out])
            wall = time.perf_counter() - t0
            launches = counts()
            check(os.path.exists(out), f"evaluate run {run}: {out} was not written")
            with open(out) as f:
                saved = json.load(f)
            check(np.isfinite(saved["f1_macro"]) and np.isfinite(saved["roc_auc_macro"]),
                  f"evaluate run {run}: metrics {saved}")
            check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
                  f"evaluate run {run}: launches {launches} for {n_batches} batches")
            runs.append({"wall_s": wall, "decodes": len(decodes), "launches": launches,
                         "f1_macro": saved["f1_macro"], "roc_auc_macro": saved["roc_auc_macro"],
                         "samples_per_second": saved["samples_per_second"]})
    finally:
        native.decode_jpeg_resize_crop = real_decode
    present = sum(1 for line in open(csv_path, encoding="utf-8").read().splitlines()[1:]
                  if ".jpg" in line and "missing_" not in line)
    check(runs[0]["decodes"] == present,
          f"evaluate run 1 decoded {runs[0]['decodes']} JPEGs, the CSV names {present}")
    check(runs[1]["decodes"] == 0,
          f"evaluate run 2 decoded {runs[1]['decodes']} JPEGs: want every row from the cache")
    check(abs(runs[0]["f1_macro"] - runs[1]["f1_macro"]) <= 1e-6
          and abs(runs[0]["roc_auc_macro"] - runs[1]["roc_auc_macro"]) <= 1e-6,
          f"evaluate runs differ: {runs}")
    return {"rows": N_CSV_ROWS, "batches": n_batches, "runs": runs}


def _post(url: str, body: bytes, timeout: float = 120):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get_status(url: str, timeout: float = 10) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _probs(preds) -> "list":
    return [[p["probabilities"][c] for c in CLASSES] for p in preds]


def _max_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def load_test(url: str, clients: int, bodies, window_s: float = LOAD_WINDOW_S):
    """``clients`` threads post requests back to back, each starting new
    ones until ``window_s`` has passed since the level began: requests/s is
    every request over the wall time to the last answer, and p50 / p99 are
    over every request's latency (host clock around each HTTP call)."""
    import threading

    import numpy as np

    lat, errors = [], []
    lock = threading.Lock()
    deadline = time.perf_counter() + window_s

    def worker(c):
        i = 0
        while time.perf_counter() < deadline:
            body = bodies[(c * 7 + i) % len(bodies)]
            i += 1
            t0 = time.perf_counter()
            try:
                status, _ = _post(url, body)
            except OSError as e:  # a refused or reset connection fails the check below
                status = repr(e)
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                if status != 200:
                    errors.append(status)

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"load test with {clients} clients: statuses {errors}")
    ms = np.asarray(lat) * 1e3
    return {"clients": clients, "requests": len(lat), "wall_s": wall,
            "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def served_logits(h, classifier, insts):
    """The logits ``forward_batch`` returns while ``predict_fn`` answers
    ``insts``, in request order."""
    import numpy as np

    got = []
    real = classifier.forward_batch

    def recording(batch, valid):
        out = real(batch, valid)
        got.append(out)
        return out

    classifier.forward_batch = recording
    try:
        h.predict_fn(insts, classifier)
    finally:
        del classifier.forward_batch
    return np.concatenate(got)


def decoder_effect(classifier):
    """The classifier on every decodable fixture (each with a tweet), once
    from its committed PIL crop (the reference's pipeline) and once from the
    native decode of its bytes (the card's): how far the card's JPEG
    decoder moves the served answers."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures, pil_crops

    names = [n for n in jpeg_fixtures() if pil_crops(n) is not None]
    g = np.random.default_rng(12)
    texts = [tweet(g) for _ in names]
    size = classifier.preproc.H
    crops = {"pil": [pil_crops(n)[size] for n in names],
             "native": [classifier.preproc.process_bytes(jpeg_fixtures()[n].read_bytes())[0]
                        for n in names]}
    logits = {k: classifier.forward_batch(
        classifier.make_batch(texts, px, [1.0] * len(names)), len(names))
        for k, px in crops.items()}
    probs = {k: 1.0 / (1.0 + np.exp(-v)) for k, v in logits.items()}
    pixels = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
                 for a, b in zip(crops["pil"], crops["native"]))
    return {"fixtures": len(names), "crop_px": size, "max_abs_pixel_diff": pixels,
            "max_abs_logit_diff": _max_diff(logits["pil"], logits["native"]),
            "max_abs_prob_diff": _max_diff(probs["pil"], probs["native"])}


def routing_check(url: str, cases):
    """4 clients post their own requests at once; each must get exactly its
    own rows: within 1e-4 of the same request's sequential answer (fp32;
    batch composition only changes summation order), and closer to it than
    to any other request's answer, which differ by more than 1e-3."""
    import threading

    bodies = [json.dumps({"instances": insts}).encode() for insts in cases]
    sequential = [_probs(_post(url, b)[1]["predictions"]) for b in bodies]
    for i in range(len(cases)):
        for j in range(i + 1, len(cases)):
            check(_max_diff(sequential[i], sequential[j]) > 1e-3,
                  f"routing check has no power: requests {i} and {j} answer alike")
    results = [None] * len(cases)

    def worker(k):
        status, out = _post(url, bodies[k])
        results[k] = _probs(out["predictions"]) if status == 200 else status

    worst = 0.0
    for _ in range(3):
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for k, got in enumerate(results):
            check(isinstance(got, list) and len(got) == len(cases[k]),
                  f"concurrent request {k}: {got if not isinstance(got, list) else len(got)}")
            own = _max_diff(got, sequential[k])
            other = min(_max_diff(got, s) for j, s in enumerate(sequential)
                        if j != k and len(s) == len(got)) if len(cases) > 1 else 1.0
            check(own <= 1e-4 and own < other,
                  f"concurrent request {k}: {own} from its own answer, {other} from another's")
            worst = max(worst, own)
    return worst


def cold_start(ckpt: str, root: str, device: str):
    """``python -m ...serving.server`` in a fresh process with a fresh
    build directory (``MMHARM_COMPILE_CACHE``) and the packages the card
    lacks hidden: seconds from the start of the process to /ping 200, which
    the server answers only after the model is loaded, the kernels and the
    image library are built and every text width has run; then one request.
    The process is stopped before this returns."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cache = os.path.join(root, "cold_build")
    code = (f"import sys; sys.modules.update(dict.fromkeys({HIDDEN_MODULES!r})); "
            f"sys.path.insert(0, {REPO!r}); "
            f"from {PKG}.serving.server import main; "
            f"main(['--model-dir', {ckpt!r}, '--port', '{port}', '--host', '127.0.0.1', "
            f"'--device', {device!r}])")
    env = {**os.environ, **SERVE_ENV, "MMHARM_COMPILE_CACHE": cache}
    log = open(os.path.join(root, "cold_server.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=root)
    url = f"http://127.0.0.1:{port}"
    try:
        ping_s = None
        while time.perf_counter() - t0 < 600 and proc.poll() is None:
            try:
                if _get_status(f"{url}/ping", timeout=2) == 200:
                    ping_s = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.2)
        check(ping_s is not None, f"cold server: no /ping 200 (exit {proc.poll()}; "
                                  f"log {os.path.join(root, 'cold_server.log')})")
        body = json.dumps({"text": "first request"}).encode()
        t1 = time.perf_counter()
        status, out = _post(f"{url}/invocations", body)
        first_ms = (time.perf_counter() - t1) * 1e3
        check(status == 200 and len(out["predictions"]) == 1, f"cold server: {status} {out}")
        built = sorted(os.path.relpath(os.path.join(d, f), cache)
                       for d, _, fs in os.walk(cache) for f in fs if f.endswith(".so"))
        check(len(built) == 3 and any(b.startswith("native/") for b in built)
              and not any("flash_attention" in b for b in built),
              f"cold server built {built}: want patch_embed_u8, attention_nhd and the image "
              "library (CLIP never launches flash_attention)")
        return {"seconds_to_ping_200": ping_s, "first_request_ms": first_ms, "built": built}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def serving_phase(torch, card: str, hf_cfg: dict = HF_CLIP_B32, device: str = "cuda"):
    """The moderation endpoint at full CLIP ViT-B/32 width, from JPEG bytes
    and real text: decode checks and rates, a cold start, the evaluate CLI
    over a CSV with a pixel cache, and ``serving.server.serve`` with the
    knobs of ``SERVE_ENV`` (fp32 endpoint against the CPU classifier, bf16
    against fp32, buckets against none, concurrent routing with and without
    micro-batching, 400 / 404, load at 1, 4 and 16 clients, and the kernel
    launches of the served batches)."""
    import base64
    import threading

    import numpy as np

    from multimodal_content_moderation_tpu_torch.cli.inference import MultiModalClassifier
    from multimodal_content_moderation_tpu_torch.serving import handler as h
    from multimodal_content_moderation_tpu_torch.serving import server as srv
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

    report = {"card": card}
    root = os.path.join(REPO, "build", "chip_smoke_serving")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    g = np.random.default_rng(11)
    t0 = time.perf_counter()
    report["decode"] = decode_checks()
    print(f"serving: JPEG decoder {report['decode']['decoder']}, worst fixture mean |diff| "
          f"{report['decode']['max_mean_abs_diff']:.4f}, max |diff| "
          f"{report['decode']['max_abs_diff']} (vs the committed PIL crops)")
    report["decode_rates"] = decode_rates(card)
    ckpt = write_serving_checkpoint(torch, root, hf_cfg, device)
    report["setup_s"] = time.perf_counter() - t0
    report["cold_start"] = cold_start(ckpt, root, device)
    report["csv_evaluate"] = csv_evaluate_checks(ckpt, root, g, device)

    # the requests: tweet-length texts, JPEG bytes (base64), some without an
    # image, one corrupt, one under the "image_base64" key
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = []
    for i in range(48):
        inst = {"text": tweet(g) if i % 9 != 4 else NA_TEXTS[i % len(NA_TEXTS)]}
        if i % 6 != 5:
            inst["image_base64" if i % 10 == 3 else "image"] = blobs[i % len(blobs)]
        insts.append(inst)

    saved_env = {k: os.environ.get(k) for k in [*SERVE_ENV, "MMHARM_MICROBATCH_MS"]}
    os.environ.update(SERVE_ENV)
    os.environ.pop("MMHARM_MICROBATCH_MS", None)
    server = None
    try:
        counts = _reset_counts()
        t0 = time.perf_counter()
        server = srv.serve(ckpt, port=0, host="127.0.0.1", device=device)
        report["serve_s_warm_builds"] = time.perf_counter() - t0
        bf16 = server.state.classifier
        widths = len(bf16._bucket_ladder)
        check(counts() == _counts(patch_embed_u8=widths, attention_nhd=24 * widths),
              f"serve(): prewarm launches {counts()} for {widths} text widths")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        check(_get_status(f"{url}/ping") == 200, "/ping is not 200 after serve()")
        check(_get_status(f"{url}/nope") == 404, "an unknown route is not 404")
        status, out = _post(f"{url}/invocations", b"{not json")
        check(status == 400, f"a bad body got {status}, want 400")
        status, out = _post(f"{url}/invocations", json.dumps(insts[0]).encode())
        check(status == 200 and len(out["predictions"]) == 1
              and set(out["predictions"][0]) == {"class_predictions", "probabilities",
                                                 "any_harmful"},
              f"single request: {status} {out}")
        body = json.dumps({"instances": insts[:40]}).encode()
        status, out = _post(f"{url}/invocations", body)
        check(status == 200 and len(out["predictions"]) == 40, f"batch request: {status}")
        bf16_probs = _probs(out["predictions"])
        check(np.isfinite(bf16_probs).all(), "bf16 endpoint: non-finite probabilities")
        report["decoder_vs_pil_bf16"] = decoder_effect(bf16)
        check(np.isfinite(report["decoder_vs_pil_bf16"]["max_abs_prob_diff"]),
              f"decoder vs PIL crops: {report['decoder_vs_pil_bf16']}")

        # fp32 on the card against the CPU classifier, both with buckets,
        # then without; bf16 against fp32
        os.environ["MMHARM_PRECISION"] = "fp32"
        fp32 = h.model_fn(ckpt, device=device)
        server.state.classifier = fp32
        status, out = _post(f"{url}/invocations", body)
        check(status == 200, f"fp32 endpoint: {status}")
        fp32_probs = _probs(out["predictions"])
        cpu = MultiModalClassifier(ckpt, batch_size=8, engine="fast", attention="pallas",
                                   image_backend="native_scaled", device="cpu")
        cpu_probs = _probs(h.predict_fn(insts[:40], cpu))
        del cpu
        report["fp32_card_vs_cpu_max_abs_err"] = _max_diff(fp32_probs, cpu_probs)
        check(report["fp32_card_vs_cpu_max_abs_err"] <= 1e-4,
              f"fp32 endpoint vs the CPU classifier: {report['fp32_card_vs_cpu_max_abs_err']}")
        report["bf16_vs_fp32_probs_max_abs_err"] = _max_diff(bf16_probs, fp32_probs)
        # phase 3's bf16 tolerance, on the logits forward_batch serves
        report["bf16_vs_fp32_logits_max_abs_err"] = _max_diff(
            served_logits(h, bf16, insts[:40]), served_logits(h, fp32, insts[:40]))
        check(report["bf16_vs_fp32_logits_max_abs_err"] <= 3e-2,
              f"bf16 endpoint logits vs fp32: {report['bf16_vs_fp32_logits_max_abs_err']} "
              "(atol 3e-2)")
        os.environ["MMHARM_SEQ_BUCKETS"] = "off"
        fp32_off = h.model_fn(ckpt, device=device)
        check(fp32_off._bucket_ladder is None, "MMHARM_SEQ_BUCKETS=off left a ladder")
        off_probs = _probs(h.predict_fn(insts[:40], fp32_off))
        del fp32_off
        report["fp32_buckets_vs_none_max_abs_err"] = _max_diff(fp32_probs, off_probs)
        check(report["fp32_buckets_vs_none_max_abs_err"] <= 1e-5,
              f"bucketed vs unbucketed: {report['fp32_buckets_vs_none_max_abs_err']}")
        os.environ["MMHARM_SEQ_BUCKETS"] = SERVE_ENV["MMHARM_SEQ_BUCKETS"]

        # routing: 4 concurrent clients, fp32, micro-batching off then on
        cases = [insts[3 * k : 3 * k + 3] for k in range(4)]
        report["routing_max_abs_err"] = {}
        for label, window in (("microbatch_off", None), ("microbatch_on", MICROBATCH_MS)):
            if window:
                os.environ["MMHARM_MICROBATCH_MS"] = window
            else:
                os.environ.pop("MMHARM_MICROBATCH_MS", None)
            srv.configure(server.state)
            report["routing_max_abs_err"][label] = routing_check(f"{url}/invocations", cases)
        server.state.classifier = bf16
        del fp32

        # load: single-instance requests (text + JPEG) against the bf16
        # endpoint for LOAD_WINDOW_S at each of 1, 4 and 16 clients; every
        # served batch counted
        served = []  # host ms of each served forward_batch (to the logits on the host)
        real_forward = bf16.forward_batch

        def counted_forward(batch, valid):
            t = time.perf_counter()
            out = real_forward(batch, valid)
            served.append((time.perf_counter() - t) * 1e3)
            return out

        bf16.forward_batch = counted_forward
        bodies = [json.dumps(inst).encode() for inst in insts]
        counts = _reset_counts()
        report["load"] = {}
        for label, window in (("microbatch_off", None), ("microbatch_on", MICROBATCH_MS)):
            if window:
                os.environ["MMHARM_MICROBATCH_MS"] = window
            else:
                os.environ.pop("MMHARM_MICROBATCH_MS", None)
            srv.configure(server.state)
            report["load"][label] = [load_test(f"{url}/invocations", c, bodies)
                                     for c in LOAD_CLIENTS]
        launches = counts()
        report["served_batches"] = len(served)
        report["forward_batch_ms_median"] = float(np.median(served))
        report["launches"] = launches
        check(launches == _counts(patch_embed_u8=len(served), attention_nhd=24 * len(served)),
              f"serving: launches {launches} for {len(served)} served batches (want 1 and 24 "
              "per batch, all on the tensor cores)")
        bf16.forward_batch = real_forward
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for label, levels in report["load"].items():
        for r in levels:
            print(f"serving {label}: {r['clients']:2d} clients {r['requests']:4d} requests "
                  f"in {r['wall_s']:.1f} s "
                  f"{r['requests_per_s']:.1f} req/s p50 {r['p50_ms']:.1f} ms "
                  f"p99 {r['p99_ms']:.1f} ms ({card})")
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in HIDDEN_MODULES)
    check(not loaded, f"modules the card's path must not import were imported: {loaded}")
    # the checkpoint and the CSV stay for phase 10 (d), which removes them
    return report


# ---------------------------------------------------------------------------
# Phase 8: the multi-task head (config/clip_mtl.yaml) on the card
# ---------------------------------------------------------------------------

MTL_HEAD = {"fusion_dim": 512, "head_hidden_dim": 256, "learnable_task_weights": True}
MTL_MICRO_STEPS = 4  # 2 optimizer steps of B=32 x 2 in each Trainer run


def mtl_train_phase(torch, card: str):
    """CLIP ViT-B/32 multi-task fine-tuning at ``config/clip_mtl.yaml``'s
    settings (5 tasks, fusion 512, hidden task heads of 256, learned task
    weights, B=32 x 2, lr 1e-5 / 5e-4, bf16 towers on fp32 master weights,
    text_fit width 48) through ``Trainer.train``, twice: as shipped (the f32
    wire, attention "xla": no kernel runs) and on the u8 wire with attention
    "pallas" (1 ``patch_embed_u8``, 24 ``attention_nhd`` and 24
    ``attention_nhd_bwd`` per micro-step, 1 + 24 forward launches per eval
    batch, all on the tensor cores). For each: the loss on a fixed batch
    falls over 10 optimizer steps and ``head.log_vars`` moves; staged
    samples/s (median and range of 3 passes) and CUDA-event forward /
    backward / optimizer ms per micro-step. Then fp32 gradients on the card
    (u8 wire, the kernels) against the CPU's on every leaf, 4 rows."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_mtl)

    stats = (CLIP_MEAN, CLIP_STD)

    def new_model(seed=0, device="cuda", **perf):
        m = model_io.build_model("mtl", "clip", CLASSES, seed=seed, device=device,
                                 clip_config=model_io.clip_config_from_dict(HF_CLIP_B32),
                                 **MTL_HEAD)
        return model_io.with_performance_options(m, **perf).replace(
            image_mean=CLIP_MEAN, image_std=CLIP_STD)

    report = {}
    for wire, impl in (("f32", "xla"), ("u8", "pallas")):
        out_dir = os.path.join(REPO, "build", f"chip_smoke_mtl_{wire}")
        shutil.rmtree(out_dir, ignore_errors=True)
        train_ds = InMemoryDataset(MTL_MICRO_STEPS * TRAIN_BATCH, seed=20,
                                   stats=stats if wire == "f32" else None)
        val_ds = InMemoryDataset(64 - 7, seed=21, stats=stats if wire == "f32" else None)
        for d in (train_ds, val_ds):
            d.truncate_text(TRAIN_SEQ)
        args = TrainArgs(
            output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=TRAIN_BATCH,
            per_device_eval_batch_size=64, gradient_accumulation_steps=TRAIN_ACCUM,
            lr_encoder=1e-5, lr_head=5e-4, logging_steps=2, save_total_limit=1,
            early_stopping=False, metric_for_best_model="roc_macro", wire=wire,
            num_workers=4, seed=0,
        )
        if wire == "f32":
            def want(micro, evals):
                return _counts()
        else:
            def want(micro, evals):
                return _counts(patch_embed_u8=micro + evals, attention_nhd=24 * (micro + evals),
                               attention_nhd_bwd=24 * micro)
        run, trainer = trainer_run(
            torch, new_model(compute_dtype="bfloat16", attention_impl=impl), args, train_ds,
            val_ds, want, f"mtl {wire} training", make_compute_metrics_mtl(CLASSES))
        check(all(f"roc_{c}" in run["history"][0] for c in CLASSES),
              f"mtl {wire}: per-task metrics missing from {run['history'][0]}")
        del trainer
        if wire == "u8":
            keep_run(out_dir, "clip_mtl", HF_CLIP_B32, backend="clip", head="mtl", **MTL_HEAD)
        shutil.rmtree(out_dir, ignore_errors=True)

        model = new_model(seed=2, compute_dtype="bfloat16", attention_impl=impl)
        patch = 32 if wire == "u8" else None
        idx = np.arange(TRAIN_BATCH)
        before = model.head["log_vars"].detach().clone()
        run["fixed_batch_loss"] = fixed_batch_loss_falls(
            torch, model, _device_batch(torch, train_ds, idx, patch), 1e-5, 5e-4)
        after = model.head["log_vars"].detach()
        check(bool((after - before).abs().min() > 0),
              f"mtl {wire}: head.log_vars did not move: {before.tolist()} -> {after.tolist()}")
        run["log_vars_after_10_steps"] = after.tolist()
        staged = [_device_batch(torch, train_ds, np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH),
                                patch) for i in range(MTL_MICRO_STEPS)]
        run.update(staged_training(torch, model, staged, card, TRAIN_ACCUM, TRAIN_BATCH,
                                   profile=False))
        del model, staged
        report[wire] = run

    # gradients: fp32 on the card (kernels, TF32 off) against the CPU (plain
    # versions), 4 rows; the weights drawn once, on the CPU, and copied over
    rows = InMemoryDataset(4, seed=25)
    rows.truncate_text(TRAIN_SEQ)
    grads = {}
    for device in ("cuda", "cpu"):
        m = new_model(seed=3, device="cpu", attention_impl="pallas")
        with torch.no_grad():  # task weights off zero, so their gradients are not all alike
            m.head["log_vars"].copy_(torch.linspace(-0.5, 0.5, len(CLASSES)))
        m = m.to(device)
        batch = _device_batch(torch, rows, np.arange(4), 32)
        if device == "cpu":
            batch = {k: v.cpu() for k, v in batch.items()}
        counts = _reset_counts()
        grads[device] = _leaf_grads(m, batch)
        if device == "cuda":
            check(counts() == _counts(False, patch_embed_u8=1, attention_nhd=24,
                                      attention_nhd_bwd=24),
                  f"mtl gradient check launches {counts()}")
        del m
    check({"head.log_vars", f"head.heads.{len(CLASSES) - 1}.fc2.w"} <= set(grads["cpu"][1]),
          "mtl gradient check: the task heads' leaves are missing")
    report["grad_check"] = leafwise_grad_check(grads["cuda"], grads["cpu"])
    report["main_path_launches"] = report["u8"]["main_path_launches"]
    return report


def mtl_eval_phase(torch, card: str, root: str):
    """(b) A reference-format CLIP ViT-B/32 multi-task checkpoint
    (``tower_txt.``/``tower_img.`` + the ``MultiTaskClassifier`` head, from
    ``models/export.py``) through ``load_checkpoint`` ->
    ``FastInferenceEngine`` -> ``evaluate_logits_u8``: fp32 card against
    CPU logits (8 rows, atol 2e-3), fp32 buckets against none (atol 1e-5),
    and in bf16 with the kernels 1 ``patch_embed_u8`` and 24
    ``attention_nhd`` per batch at B=144, all on the tensor cores, then
    staged samples/s at seq 77 and the seq-32 bucket. (c) SigLIP2-B/16-224
    with the shared "auto" backbone and the same head, B=64, text seq 64: 1
    + 24 launches per batch and no ``flash_attention``, staged samples/s.
    Returns the report and (b)'s checkpoint, which phase 8 (d) serves."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import (
        CLIP_MEAN, CLIP_STD, SIGLIP_MEAN, SIGLIP_STD)
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel

    report = {"card": card}
    ckpt = write_serving_checkpoint(torch, root, HF_CLIP_B32, "cuda", head="mtl")
    model, cfg = model_io.load_checkpoint(ckpt, device="cuda")
    check(isinstance(model, MultiTaskModel) and model.backend == "clip"
          and model.head_hidden_dim == MTL_HEAD["head_hidden_dim"] and model.learnable_task_weights
          and "text_projection" not in model.backbone,
          "load_checkpoint: not the multi-task CLIP model of the checkpoint")
    cpu_model, _ = model_io.load_checkpoint(ckpt, device="cpu")
    data = InMemoryDataset(2 * BATCH - 5, seed=22)  # a padded last batch
    rows = next(data.batches(8))
    outs = []
    for m in (model, cpu_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), CLIP_MEAN, CLIP_STD)
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]).cpu())
    del cpu_model
    err = float((outs[0] - outs[1]).abs().max())
    report["fp32_card_vs_cpu_max_abs_err"] = err
    check(err <= 2e-3 and bool(outs[0].isfinite().all()),
          f"mtl fp32 logits on the card differ from the CPU's by {err} (atol 2e-3)")

    fp32 = fi.FastInferenceEngine(model_io.with_performance_options(model, attention_impl="pallas"),
                                  CLIP_MEAN, CLIP_STD)
    full, _ = fi.evaluate_logits_u8(fp32, data, BATCH, num_workers=4)
    cut, _ = fi.evaluate_logits_u8(fp32, data, BATCH, num_workers=4,
                                   seq_buckets=fi.parse_seq_buckets("auto"))
    err = float(np.abs(cut - full).max())
    report["fp32_buckets_vs_full_max_abs_err"] = err
    check(err <= 1e-5, f"mtl fp32 bucketed logits differ from unbucketed by {err} (atol 1e-5)")

    # the main path: bf16 towers with the kernels, counted from 0
    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas").to(torch.bfloat16)
    del model, fp32
    engine = fi.FastInferenceEngine(bf16, CLIP_MEAN, CLIP_STD)
    n_batches = -(-len(data) // BATCH)
    counts = _reset_counts()
    logits, labels = fi.evaluate_logits_u8(engine, data, BATCH, num_workers=4,
                                           seq_buckets=fi.parse_seq_buckets("auto"))
    launches = counts()
    check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
          f"mtl evaluate: launches {launches} for {n_batches} batches (want 1 and 24 per batch)")
    check(logits.shape == (len(data), len(CLASSES)) and np.isfinite(logits).all()
          and float(np.abs(logits - full).max()) <= 3e-2,
          f"mtl bf16 logits: shape {logits.shape}, max |bf16 - fp32| "
          f"{float(np.abs(logits - full).max())} (atol 3e-2)")
    np.testing.assert_array_equal(labels, data.labels)
    report["main_path_launches"] = launches
    report["main_path_batches"] = n_batches
    g = np.random.default_rng(23)
    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(BATCH, 224, 224, 3), dtype=np.uint8))).cuda() for _ in range(2)]
    for width in (77, 32):
        ids = []
        for _ in range(10):
            x = g.integers(1, 49405, size=(BATCH, width)).astype(np.int32)
            x[:, width - 2] = 49407
            ids.append(torch.from_numpy(x).cuda())
        mask = torch.ones(BATCH, width, dtype=torch.int32, device="cuda")
        report[f"staged_samples_per_s_seq{width}"] = {
            **staged_eval_rates(torch, engine, ids, patches, mask), "card": card}
    del bf16, engine

    # (c) SigLIP2-B/16-224, the shared "auto" backbone
    cfg224 = model_io.siglip_config_from_dict(HF_SIGLIP2_B16_224)
    auto = model_io.build_model("mtl", "siglip", CLASSES, siglip_config=cfg224, seed=4,
                                device="cuda", **MTL_HEAD)
    check(auto.backend == "auto", f"build_model mtl siglip gave backend {auto.backend}")
    auto = model_io.with_performance_options(
        auto, compute_dtype="bfloat16", attention_impl="pallas").to(torch.bfloat16)
    engine = fi.FastInferenceEngine(auto, SIGLIP_MEAN, SIGLIP_STD)
    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(SIGLIP_BATCH, 224, 224, 3), dtype=np.uint8))).cuda()
        for _ in range(2)]
    ids = [torch.from_numpy(g.integers(2, 256000, size=(SIGLIP_BATCH, 64)).astype(np.int32)
                            ).cuda() for _ in range(N_SIGLIP224_BATCHES)]
    mask = torch.ones(SIGLIP_BATCH, 64, dtype=torch.int32, device="cuda")
    ones = torch.ones(SIGLIP_BATCH, device="cuda")
    out = engine(ids[0], mask, patches[0], ones, ones)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (SIGLIP_BATCH, len(CLASSES)) and bool(out.isfinite().all()),
          f"mtl siglip224 logits {tuple(out.shape)}, finite={bool(out.isfinite().all())}")
    counts = _reset_counts()
    rates = staged_eval_rates(torch, engine, ids, patches, mask)
    launches = counts()
    n = 3 * len(ids) + 1  # the passes and their warm-up call
    check(launches == _counts(patch_embed_u8=n, attention_nhd=24 * n),
          f"mtl siglip224: launches {launches} for {n} batches (want 1 and 24 per batch, "
          "no flash_attention)")
    report["siglip224_auto"] = {"launches": launches, "batches": n,
                                "staged_samples_per_s_seq64": {**rates, "card": card}}
    del auto, engine
    return report, ckpt


def mtl_serving_phase(torch, card: str, ckpt: str):
    """(d) The endpoint on phase 8 (b)'s multi-task checkpoint: ``model_fn``
    (fp32, the fast engine, the kernels, the native decoder, buckets) ->
    ``predict_fn`` for one request and for a batch of text + fixture JPEG
    requests; every answer is keyed by the task names, and the card's
    probabilities are within 1e-4 of ``MultiModalClassifier(device="cpu")``."""
    import base64

    import numpy as np

    from multimodal_content_moderation_tpu_torch.cli.inference import MultiModalClassifier
    from multimodal_content_moderation_tpu_torch.serving import handler as h
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

    g = np.random.default_rng(24)
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = [{"text": tweet(g), **({"image": blobs[i % len(blobs)]} if i % 5 != 4 else {})}
             for i in range(12)]
    env = {**SERVE_ENV, "MMHARM_PRECISION": "fp32"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        counts = _reset_counts()
        classifier = h.model_fn(ckpt, device="cuda")
        one = h.predict_fn(insts[:1], classifier)
        batch = h.predict_fn(insts, classifier)
        launches = counts()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(classifier.class_names == CLASSES and len(one) == 1 and len(batch) == len(insts),
          f"mtl endpoint: {len(one)} and {len(batch)} answers, classes {classifier.class_names}")
    for p in one + batch:
        check(set(p["probabilities"]) == set(CLASSES) == set(p["class_predictions"]),
              f"mtl endpoint: an answer is not keyed by the task names: {p}")
    cpu = MultiModalClassifier(ckpt, batch_size=8, engine="fast", attention="pallas",
                               image_backend="native_scaled", device="cpu")
    cpu_probs = _probs(h.predict_fn(insts, cpu))
    del cpu
    err = _max_diff(_probs(batch), cpu_probs)
    check(err <= 1e-4, f"mtl endpoint: fp32 card vs the CPU classifier {err} (atol 1e-4)")
    check(_max_diff(_probs(one), cpu_probs[:1]) <= 1e-4, "mtl endpoint: the single request")
    widths = len(classifier._bucket_ladder)
    served = 1 + -(-len(insts) // classifier.batch_size)
    check(launches == _counts(False, patch_embed_u8=widths + served,
                              attention_nhd=24 * (widths + served)),
          f"mtl endpoint: launches {launches} for {widths} warm-up widths + {served} batches")
    return {"card": card, "requests": len(insts), "fp32_card_vs_cpu_max_abs_err": err,
            "launches": launches, "prewarm_widths": widths, "served_batches": served,
            "example": batch[0]}


def mtl_phase(torch, card: str):
    """Phase 8: the multi-task head on the card (training, eval, serving)."""
    root = os.path.join(REPO, "build", "chip_smoke_mtl")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = {}
    t0 = time.perf_counter()
    report["train"] = mtl_train_phase(torch, card)
    report["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["evaluate"], ckpt = mtl_eval_phase(torch, card, root)
    report["evaluate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["serving"] = mtl_serving_phase(torch, card, ckpt)
    report["serving_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# Phase 9: the generic dual encoder (ViT-B/16 + BERT-base) on the card
# ---------------------------------------------------------------------------

# VisionTextDualEncoderModel over google/vit-base-patch16-224-in21k and
# bert-base-uncased (their config.json dimensions), projection_dim 512
HF_VTDE_B16 = {
    "model_type": "vision-text-dual-encoder", "projection_dim": 512,
    "logit_scale_init_value": 2.6592,
    "text_config": {
        "model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
        "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
        "max_position_embeddings": 512, "type_vocab_size": 2, "pad_token_id": 0,
        "hidden_act": "gelu", "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.1,
        "attention_probs_dropout_prob": 0.1,
    },
    "vision_config": {
        "model_type": "vit", "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 3072, "image_size": 224,
        "patch_size": 16, "num_channels": 3, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    },
}
# roberta-base and distilbert-base-uncased (their config.json dimensions)
ROBERTA_BASE = {
    "model_type": "roberta", "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "max_position_embeddings": 514,
    "type_vocab_size": 1, "pad_token_id": 1, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
}
DISTILBERT_BASE = {
    "model_type": "distilbert", "vocab_size": 30522, "dim": 768, "n_layers": 6, "n_heads": 12,
    "hidden_dim": 3072, "max_position_embeddings": 512, "pad_token_id": 0,
    "activation": "gelu", "dropout": 0.1, "attention_dropout": 0.1,
}
GENERIC_MICRO_STEPS = 4  # 2 optimizer steps of B=32 x 2 in each Trainer run


def write_generic_dirs(torch, root: str):
    """(encoder dir, checkpoint dir) of the full-width generic model: the
    encoder dir holds the ``vision-text-dual-encoder`` ``config.json``,
    ``preprocessor_config.json`` (224 px, 0.5 / 0.5) and a BERT WordPiece
    ``tokenizer.json`` over a synthetic 30,522-entry vocabulary; the
    checkpoint dir a reference-format fusion checkpoint (random weights
    from a seed, written as ``model.safetensors`` by ``models/export.py``)
    and its ``inference_config.json``. Returns the source model too."""
    from multimodal_content_moderation_tpu_torch.models import export
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.models.generic import GenericDualConfig
    from multimodal_content_moderation_tpu_torch.testdata import write_bert_wordpiece

    enc, ckpt = os.path.join(root, "encoder"), os.path.join(root, "checkpoint")
    os.makedirs(ckpt)
    write_bert_wordpiece(enc, HF_VTDE_B16["text_config"]["vocab_size"], seed=0,
                         words=[w for w in (w.strip("#@.!?") for w in WORDS) if w])
    files = {
        os.path.join(enc, "config.json"): HF_VTDE_B16,
        os.path.join(enc, "preprocessor_config.json"): {
            "size": 224, "image_mean": [0.5] * 3, "image_std": [0.5] * 3},
        os.path.join(ckpt, "inference_config.json"): {
            "backend": "generic", "head": "fusion", "fusion_dim": 512, "class_names": CLASSES,
            "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5], "max_text_length": GENERIC_TEXT_T,
            "encoder_dir": enc},
    }
    for path, obj in files.items():
        with open(path, "w") as f:
            json.dump(obj, f)
    src = FusionModel.create("generic", num_labels=len(CLASSES), seed=0, device="cuda",
                             generic_config=GenericDualConfig.from_dict(HF_VTDE_B16))
    export.export_safetensors(src, os.path.join(ckpt, "model.safetensors"))
    return enc, ckpt, src


def _full_width_spy(engine):
    """Record the text width of every batch ``engine`` moves to the card."""
    widths = []
    real = engine.to_device

    def to_device(x):
        t = real(x)
        if t.dim() == 2 and not t.is_floating_point():
            widths.append(int(t.shape[1]))
        return t

    engine.to_device = to_device
    return widths


def generic_eval_phase(torch, card: str, enc: str, ckpt: str, src):
    """(b) The reference-format checkpoint through ``load_checkpoint`` ->
    ``FastInferenceEngine`` -> ``evaluate_logits_u8``: fp32 card against CPU
    logits (8 rows, atol 1e-5); in bf16 with the kernels (B=64, width 77,
    seq_buckets "auto", which the generic backend runs at full width) 1
    ``patch_embed_u8`` and 24 ``attention_nhd`` per batch on the tensor
    cores, no ``flash_attention``, every batch at width 77, within 3e-2 of
    fp32; staged samples/s; then one batch through ``--engine standard``
    (the f32 wire) against the fast engine (fp32, atol 1e-4)."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
    from multimodal_content_moderation_tpu_torch.data.tokenizer_json import JSONTokenizer
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.loop import evaluate_logits_standard

    report = {"card": card}
    tok = load_tokenizer(enc)
    check(isinstance(tok, JSONTokenizer),
          f"the BERT tokenizer.json loaded as {type(tok).__name__}, not the port's JSONTokenizer")
    ids, mask = tok.encode_batch(["Hate speech, online!", ""], GENERIC_TEXT_T)
    check(ids[0, 0] == 101 and ids[1, :2].tolist() == [101, 102] and mask[1].sum() == 2,
          f"BERT tokenizer: {ids[:, :8].tolist()}")
    report["tokenizer"] = type(tok).__name__
    t0 = time.perf_counter()
    model, cfg = model_io.load_checkpoint(ckpt, device="cuda")
    report["load_checkpoint_s"] = time.perf_counter() - t0
    src_sd, got_sd = src.state_dict(), model.state_dict()
    check(src_sd.keys() == got_sd.keys() and model.backend == "generic",
          "load_checkpoint: not the generic model of the checkpoint")
    for name, x in src_sd.items():
        check(torch.equal(x, got_sd[name]), f"load_checkpoint: {name} differs")
    report["parameters"] = sum(p.numel() for p in model.parameters())

    data = InMemoryDataset(3 * GENERIC_BATCH - 5, seed=30, bert=True)  # a padded last batch
    cpu_model, _ = model_io.load_checkpoint(ckpt, device="cpu")
    rows = next(data.batches(8))
    outs = []
    for m in (model, cpu_model):
        eng = fi.FastInferenceEngine(
            model_io.with_performance_options(m, attention_impl="pallas"), SIGLIP_MEAN,
            SIGLIP_STD)
        outs.append(eng(rows["input_ids"], rows["attention_mask"],
                        eng.patches_from_hwc(rows["pixel_values"]),
                        rows["text_present"], rows["image_present"]).cpu())
    del cpu_model
    err = float((outs[0] - outs[1]).abs().max())
    report["fp32_card_vs_cpu_max_abs_err"] = err
    check(err <= 1e-5 and bool(outs[0].isfinite().all()),
          f"generic fp32 logits on the card differ from the CPU's by {err} (atol 1e-5)")

    fp32 = model_io.with_performance_options(model, attention_impl="pallas")
    fp32_engine = fi.FastInferenceEngine(fp32, SIGLIP_MEAN, SIGLIP_STD)
    full, _ = fi.evaluate_logits_u8(fp32_engine, data, GENERIC_BATCH, num_workers=4)
    # --engine standard: normalised fp32 pixels of the same crops, one batch
    fast, _ = fi.evaluate_logits_u8(fp32_engine, InMemoryDataset(GENERIC_BATCH, seed=39,
                                                                 bert=True), GENERIC_BATCH)
    one = InMemoryDataset(GENERIC_BATCH, seed=39, bert=True, stats=(SIGLIP_MEAN, SIGLIP_STD))
    counts = _reset_counts()
    standard, _ = evaluate_logits_standard(fp32, one, GENERIC_BATCH, num_workers=2)
    launches = counts()
    check(launches == _counts(False, attention_nhd=24),
          f"generic standard engine launches {launches}: want 24 attention_nhd, no embed")
    err = float(np.abs(standard - fast).max())
    report["standard_vs_fast_engine_max_abs_err"] = err
    check(err <= 1e-4, f"generic --engine standard vs fast: {err} (fp32 atol 1e-4)")

    # the main path: bf16 towers with the kernels, counted from 0
    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas").to(torch.bfloat16)
    del model, fp32
    engine = fi.FastInferenceEngine(bf16, SIGLIP_MEAN, SIGLIP_STD)
    widths = _full_width_spy(engine)
    n_batches = -(-len(data) // GENERIC_BATCH)
    counts = _reset_counts()
    t0 = time.perf_counter()
    logits, labels = fi.evaluate_logits_u8(engine, data, GENERIC_BATCH, num_workers=4,
                                           seq_buckets=fi.parse_seq_buckets("auto"))
    wall = time.perf_counter() - t0
    launches = counts()
    check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
          f"generic evaluate: launches {launches} for {n_batches} batches (want 1 and 24 per "
          "batch on the tensor cores, no flash_attention)")
    # each batch moves its ids and its mask
    check(len(widths) == 2 * n_batches and set(widths) == {GENERIC_TEXT_T},
          f"generic evaluate with seq_buckets auto ran text widths {widths}, want 77 only")
    err = float(np.abs(logits - full).max())
    check(logits.shape == (len(data), len(CLASSES)) and np.isfinite(logits).all()
          and err <= 3e-2, f"generic bf16 logits: shape {logits.shape}, max |bf16 - fp32| "
                           f"{err} (atol 3e-2)")
    np.testing.assert_array_equal(labels, data.labels)
    report["bf16_vs_fp32_max_abs_err"] = err
    report["main_path_launches"] = launches
    report["main_path_batches"] = n_batches
    report["evaluate_samples_per_s_incl_host_prep"] = len(data) / wall
    g = np.random.default_rng(31)
    patches = [torch.from_numpy(engine.patches_from_hwc(
        g.integers(0, 256, size=(GENERIC_BATCH, 224, 224, 3), dtype=np.uint8))).cuda()
        for _ in range(2)]
    ids = []
    for _ in range(8):
        x = g.integers(1000, 30522, size=(GENERIC_BATCH, GENERIC_TEXT_T)).astype(np.int32)
        x[:, 0], x[:, -1] = 101, 102
        ids.append(torch.from_numpy(x).cuda())
    mask = torch.ones(GENERIC_BATCH, GENERIC_TEXT_T, dtype=torch.int32, device="cuda")
    report["staged_samples_per_s_seq77"] = {
        **staged_eval_rates(torch, engine, ids, patches, mask), "card": card}
    del bf16, engine
    return report


def _generic_model(torch, head="fusion", seed=0, device="cuda", text=None, **perf):
    """The full-width generic model (``HF_VTDE_B16``, or another
    ``text_config``) from a seed, the knobs ``perf`` in both towers."""
    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.generic import GenericDualConfig

    cfg = GenericDualConfig.from_dict({**HF_VTDE_B16, **({"text_config": text} if text else {})})
    m = model_io.build_model(head, "generic", CLASSES, seed=seed, device=device,
                             generic_config=cfg, **(MTL_HEAD if head == "mtl" else {}))
    return model_io.with_performance_options(m, **perf).replace(
        image_mean=SIGLIP_MEAN, image_std=SIGLIP_STD)


def generic_train_phase(torch, card: str):
    """(c) Fine-tuning as ``config/default.yaml`` gives it with ``backend:
    generic`` (B=32 x 2, bf16 towers on fp32 master weights, lr 1e-5 /
    5e-4, text width 77: ``text_fit`` is CLIP's) through ``Trainer.train``,
    on the f32 wire with attention "xla" (no kernel) and on the u8 wire with
    attention "pallas": per micro-step 1 ``patch_embed_u8``, 12
    ``attention_nhd`` and 12 ``attention_nhd_bwd`` (the vision tower; the
    text tower trains with HF's dropout 0.1 on the non-kernel core), 1 + 24
    per eval batch, all on the tensor cores. Each: a falling loss on a fixed
    batch, staged samples/s, CUDA-event step parts. Then fp32 gradients on
    the card (u8 wire, the kernels, the dropout rates 0) against the CPU's
    on every leaf, 4 rows."""
    import dataclasses

    import numpy as np

    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs

    report = {}
    for wire, impl in (("f32", "xla"), ("u8", "pallas")):
        out_dir = os.path.join(REPO, "build", f"chip_smoke_generic_{wire}")
        shutil.rmtree(out_dir, ignore_errors=True)
        stats = ((0.5,) * 3, (0.5,) * 3) if wire == "f32" else None
        train_ds = InMemoryDataset(GENERIC_MICRO_STEPS * TRAIN_BATCH, seed=32, bert=True,
                                   stats=stats)
        val_ds = InMemoryDataset(64 - 7, seed=33, bert=True, stats=stats)
        args = TrainArgs(
            output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=TRAIN_BATCH,
            per_device_eval_batch_size=64, gradient_accumulation_steps=TRAIN_ACCUM,
            lr_encoder=1e-5, lr_head=5e-4, logging_steps=2, save_total_limit=1,
            early_stopping=False, wire=wire, num_workers=4, seed=0,
        )
        if wire == "f32":
            def want(micro, evals):
                return _counts()
        else:
            def want(micro, evals):
                return _counts(patch_embed_u8=micro + evals,
                               attention_nhd=12 * micro + 24 * evals,
                               attention_nhd_bwd=12 * micro)
        run, trainer = trainer_run(
            torch, _generic_model(torch, compute_dtype="bfloat16", attention_impl=impl), args,
            train_ds, val_ds, want, f"generic {wire} training")
        del trainer
        shutil.rmtree(out_dir, ignore_errors=True)
        model = _generic_model(torch, seed=2, compute_dtype="bfloat16", attention_impl=impl)
        patch = 16 if wire == "u8" else None
        run["fixed_batch_loss"] = fixed_batch_loss_falls(
            torch, model, _device_batch(torch, train_ds, np.arange(TRAIN_BATCH), patch),
            1e-5, 5e-4)
        staged = [_device_batch(torch, train_ds, np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH),
                                patch) for i in range(GENERIC_MICRO_STEPS)]
        run.update(staged_training(torch, model, staged, card, TRAIN_ACCUM, TRAIN_BATCH,
                                   profile=False))
        del model, staged
        report[wire] = run

    rows = InMemoryDataset(4, seed=34, bert=True)
    grads = {}
    for device in ("cuda", "cpu"):
        m = _generic_model(torch, seed=3, device="cpu", attention_impl="pallas")
        t = m.generic_config.text
        m = m.replace(generic_config=dataclasses.replace(m.generic_config, text=dataclasses.replace(
            t, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))).to(device)
        batch = _device_batch(torch, rows, np.arange(4), 16)
        if device == "cpu":
            batch = {k: v.cpu() for k, v in batch.items()}
        counts = _reset_counts()
        grads[device] = _leaf_grads(m, batch)
        if device == "cuda":
            check(counts() == _counts(False, patch_embed_u8=1, attention_nhd=24,
                                      attention_nhd_bwd=24),
                  f"generic gradient check launches {counts()}")
        del m
    report["grad_check"] = leafwise_grad_check(grads["cuda"], grads["cpu"])
    report["main_path_launches"] = report["u8"]["main_path_launches"]
    return report


def generic_towers_phase(torch, card: str):
    """(d) RoBERTa-base and DistilBERT-base text towers (with the ViT-B/16):
    one fp32 eval batch of 8 rows each through ``FastInferenceEngine`` with
    the kernels, card against CPU logits (atol 1e-5), with their launches:
    1 + 24 (RoBERTa: 12 text layers) and 1 + 18 (DistilBERT: 6)."""
    import copy

    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi

    report = {}
    g = np.random.default_rng(35)
    for name, text, (cls, sep, pad) in (("roberta_base", ROBERTA_BASE, (0, 2, 1)),
                                         ("distilbert_base", DISTILBERT_BASE, (101, 102, 0))):
        cpu = _generic_model(torch, seed=4, device="cpu", text=text, attention_impl="pallas")
        card_model = copy.deepcopy(cpu).to("cuda")
        ids = np.full((8, GENERIC_TEXT_T), pad, np.int32)
        mask = np.zeros((8, GENERIC_TEXT_T), np.int32)
        for i, n in enumerate([1, 2, GENERIC_TEXT_T, 9, 20, 33, 50, 64]):
            ids[i, :n] = g.integers(1000, text["vocab_size"], size=n)
            ids[i, 0], ids[i, n - 1] = cls, (sep if n > 1 else cls)
            mask[i, :n] = 1
        crops = g.integers(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
        ones = np.ones(8, np.float32)
        outs = []
        for m in (card_model, cpu):
            eng = fi.FastInferenceEngine(m, SIGLIP_MEAN, SIGLIP_STD)
            counts = _reset_counts()
            outs.append(eng(ids, mask, eng.patches_from_hwc(crops), ones, ones).cpu())
            if m is card_model:
                launches = counts()
        layers = text.get("num_hidden_layers", text.get("n_layers"))
        check(launches == _counts(False, patch_embed_u8=1, attention_nhd=12 + layers),
              f"{name}: launches {launches}, want 1 + {12 + layers}")
        err = float((outs[0] - outs[1]).abs().max())
        check(err <= 1e-5 and bool(outs[0].isfinite().all()),
              f"{name}: fp32 logits on the card differ from the CPU's by {err} (atol 1e-5)")
        report[name] = {"fp32_card_vs_cpu_max_abs_err": err, "launches": launches,
                        "text_layers": layers}
        del cpu, card_model
    return report


def generic_mtl_phase(torch, card: str):
    """(e) The multi-task head (``clip_mtl.yaml``'s: fusion 512, hidden task
    heads of 256, learned task weights) on the generic backbone's raw
    towers: ``Trainer.train`` for 2 u8 micro-steps (B=32 x 2, bf16, the
    kernels) and one eval batch: 1 / 12 / 12 launches per micro-step and 1 +
    24 per eval batch, on the tensor cores."""
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs
    from multimodal_content_moderation_tpu_torch.training.metrics import make_compute_metrics_mtl

    out_dir = os.path.join(REPO, "build", "chip_smoke_generic_mtl")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = TrainArgs(
        output_dir=out_dir, num_train_epochs=1, per_device_train_batch_size=TRAIN_BATCH,
        per_device_eval_batch_size=64, gradient_accumulation_steps=TRAIN_ACCUM,
        lr_encoder=1e-5, lr_head=5e-4, logging_steps=1, save_total_limit=1,
        early_stopping=False, wire="u8", num_workers=4, seed=0,
    )
    model = _generic_model(torch, head="mtl", compute_dtype="bfloat16", attention_impl="pallas")
    check(model.backend == "generic" and "text_projection" not in model.backbone
          and model.head["proj_t"]["w"].shape[0] == 768,
          "the multi-task generic model does not pool the raw towers")

    def want(micro, evals):
        return _counts(patch_embed_u8=micro + evals, attention_nhd=12 * micro + 24 * evals,
                       attention_nhd_bwd=12 * micro)

    run, trainer = trainer_run(
        torch, model, args, InMemoryDataset(2 * TRAIN_BATCH, seed=36, bert=True),
        InMemoryDataset(64 - 7, seed=37, bert=True), want, "generic mtl training",
        make_compute_metrics_mtl(CLASSES))
    check(all(f"roc_{c}" in run["history"][0] for c in CLASSES),
          f"generic mtl: per-task metrics missing from {run['history'][0]}")
    del trainer
    keep_run(out_dir, "generic_mtl", HF_VTDE_B16, backend="generic", head="mtl", **MTL_HEAD)
    return run


def generic_serving_phase(torch, card: str, ckpt: str, root: str):
    """(f) The endpoint and the evaluate CLI on the generic checkpoint:
    ``serving.server.serve`` (fp32, the fast engine, the kernels, the native
    decoder, ``MMHARM_SEQ_BUCKETS=auto``, which the generic backend serves
    at full width) answers a single and a batch request (text + fixture
    JPEG) over HTTP; its probabilities are within 1e-5 of
    ``MultiModalClassifier(device="cpu")``'s, and each served batch makes 1
    + 24 launches. Then ``cli/evaluate.main`` (bf16, the fast engine, the
    kernels, ``--seq_buckets auto``) over a generated CSV: 1 + 24 launches
    per batch on the tensor cores."""
    import base64
    import threading

    import numpy as np

    from multimodal_content_moderation_tpu_torch.cli import evaluate
    from multimodal_content_moderation_tpu_torch.cli.inference import MultiModalClassifier
    from multimodal_content_moderation_tpu_torch.serving import handler as h
    from multimodal_content_moderation_tpu_torch.serving import server as srv
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

    g = np.random.default_rng(38)
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = [{"text": tweet(g), **({"image": blobs[i % len(blobs)]} if i % 5 != 4 else {})}
             for i in range(12)]
    report = {"card": card}
    env = {**SERVE_ENV, "MMHARM_PRECISION": "fp32"}
    saved_env = {k: os.environ.get(k) for k in [*env, "MMHARM_MICROBATCH_MS"]}
    os.environ.update(env)
    os.environ.pop("MMHARM_MICROBATCH_MS", None)
    server = None
    try:
        counts = _reset_counts()
        server = srv.serve(ckpt, port=0, host="127.0.0.1", device="cuda")
        classifier = server.state.classifier
        check(classifier._bucket_ladder is None,
              "the generic endpoint built a bucket ladder (its tower may mean-pool the pads)")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        check(_get_status(f"{url}/ping") == 200, "/ping is not 200 after serve()")
        status, one = _post(f"{url}/invocations", json.dumps(insts[0]).encode())
        check(status == 200 and len(one["predictions"]) == 1, f"single request: {status}")
        status, out = _post(f"{url}/invocations", json.dumps({"instances": insts}).encode())
        check(status == 200 and len(out["predictions"]) == len(insts),
              f"batch request: {status}")
        launches = counts()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    served = 1 + 1 + -(-len(insts) // classifier.batch_size)  # the warm-up, then the requests
    check(launches == _counts(False, patch_embed_u8=served, attention_nhd=24 * served),
          f"generic endpoint: launches {launches} for {served} batches (warm-up included)")
    cpu = MultiModalClassifier(ckpt, batch_size=8, engine="fast", attention="pallas",
                               image_backend="native_scaled", device="cpu")
    cpu_probs = _probs(h.predict_fn(insts, cpu))
    del cpu
    err = _max_diff(_probs(out["predictions"]), cpu_probs)
    check(err <= 1e-5 and _max_diff(_probs(one["predictions"]), cpu_probs[:1]) <= 1e-5,
          f"generic endpoint: fp32 card vs the CPU classifier {err} (atol 1e-5)")
    report.update(requests=len(insts), fp32_card_vs_cpu_max_abs_err=err, launches=launches,
                  served_batches=served, example=out["predictions"][0])

    csv_path = write_csv(root, g)
    n_batches = -(-N_CSV_ROWS // SERVE_BATCH)
    counts = _reset_counts()
    t0 = time.perf_counter()
    metrics = evaluate.main([
        "--checkpoint", ckpt, "--test_csv", csv_path, "--image_root",
        os.path.join(root, "images"), "--batch_size", str(SERVE_BATCH), "--engine", "fast",
        "--image_backend", "native_scaled", "--attention", "pallas", "--precision", "bf16",
        "--seq_buckets", "auto", "--device", "cuda",
        "--output", os.path.join(root, "eval_results.json")])
    wall = time.perf_counter() - t0
    launches = counts()
    check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
          f"generic evaluate CLI: launches {launches} for {n_batches} batches")
    check(np.isfinite(metrics["f1_macro"]) and np.isfinite(metrics["roc_auc_macro"]),
          f"generic evaluate CLI: metrics {metrics}")
    report["evaluate_cli"] = {"rows": N_CSV_ROWS, "batches": n_batches, "wall_s": wall,
                              "launches": launches, "f1_macro": metrics["f1_macro"],
                              "samples_per_second": metrics["samples_per_second"]}
    return report


def generic_phase(torch, card: str):
    """Phase 9: the generic dual encoder on the card (checkpoint, eval,
    training, the other text towers, the multi-task head, the endpoint and
    the evaluate CLI)."""
    root = os.path.join(REPO, "build", "chip_smoke_generic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = {}
    t0 = time.perf_counter()
    enc, ckpt, src = write_generic_dirs(torch, root)
    report["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["eval"] = generic_eval_phase(torch, card, enc, ckpt, src)
    report["eval_s"] = time.perf_counter() - t0
    del src
    for key, run in (("train", generic_train_phase), ("towers", generic_towers_phase),
                     ("mtl", generic_mtl_phase)):
        t0 = time.perf_counter()
        report[key] = run(torch, card)
        report[f"{key}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["serving"] = generic_serving_phase(torch, card, ckpt, root)
    report["serving_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# Phase 10: the int8 fc1 tier (--precision int8_mlp) and the export
# ---------------------------------------------------------------------------

# one CLIP ViT-B/32 eval batch's vision fc1: B=144 x T=50 rows, [768, 3072]
INT8_M, INT8_K, INT8_N = BATCH * 50, 768, 3072
PEAK_INT8_OPS = 1979e12  # H100 SXM int8 dense, NVIDIA data sheet
N_INT8_BATCHES = 4
INT8_ROOT = os.path.join(REPO, "build", "chip_smoke_int8")
# the leaves a generic multi-task export adds to JAX's (models/export.py)
FAULT3 = {"backbone.text_projection.weight", "backbone.visual_projection.weight",
          "backbone.logit_scale"}


def int8_product_checks(torch, card: str):
    """(a) ``ops.quant.dense_int8`` on the card at [7200, 768] x [768, 3072]
    (a CLIP eval batch's vision fc1) and at 1, 16 and 17 rows (the card's
    ``_int_mm`` takes more than 16; fewer are padded with zero rows), bf16
    inputs: the weight's int8 values and scales equal the CPU's; the
    ``_int_mm`` accumulator equals the fp32 product of the same int8 values
    (exact: 768 x 127^2 < 2^24, TF32 off); the output equals the CPU's bit
    for bit. Timed from CUDA graphs: ``dense_int8`` whole, ``_int_mm``
    alone (and with the weight stored row-major, the layout
    ``quantize_linear_int8`` does not use) and the bf16 ``dense`` of the
    same shape, each beside its bound
    (bytes over 3.35 TB/s, operations over 1,979 int8 TOPS or 989 bf16
    TFLOPS, the larger)."""
    from multimodal_content_moderation_tpu_torch.ops import layers
    from multimodal_content_moderation_tpu_torch.ops.quant import (
        dense_int8, quantize_linear_int8, quantize_rows_int8)

    M, K, N = INT8_M, INT8_K, INT8_N
    g = torch.Generator().manual_seed(10)
    w = (torch.randn(K, N, generator=g) * 0.02).bfloat16()
    b = (torch.randn(N, generator=g) * 0.01).bfloat16()
    x_cpu = torch.randn(M, K, generator=g).bfloat16()
    q_cpu = quantize_linear_int8({"w": w, "b": b})
    q = quantize_linear_int8({"w": w.cuda(), "b": b.cuda()})
    check(torch.equal(q["w_i8"].cpu(), q_cpu["w_i8"]) and torch.equal(q["scale"].cpu(),
                                                                      q_cpu["scale"]),
          "quantize_linear_int8 on the card differs from the CPU's")
    x = x_cpu.cuda()
    report = {"card": card, "shape": [M, K, N], "rows_equal_cpu_bitwise": {}}
    for rows in (M, 1, 16, 17):
        got = dense_int8(x[:rows], q)
        same = torch.equal(got.cpu(), dense_int8(x_cpu[:rows], q_cpu))
        check(same and got.dtype == torch.bfloat16,
              f"dense_int8 at {rows} rows: the card's output differs from the CPU's")
        report["rows_equal_cpu_bitwise"][rows] = same
    x_i8, _ = quantize_rows_int8(x)
    acc = torch._int_mm(x_i8, q["w_i8"])
    exact = torch.equal(acc.float(), x_i8.float() @ q["w_i8"].float())
    check(exact, "_int_mm differs from the fp32 product of the same int8 values")
    report["int_mm_equals_fp32_product"] = exact
    wb = {"w": w.cuda(), "b": b.cuda()}
    w_rows = q["w_i8"].contiguous()
    check(torch.equal(torch._int_mm(x_i8, w_rows), acc),
          "_int_mm with a row-major weight differs from the column-major one")
    ops = 2.0 * M * K * N
    work = {
        # name: (call, bytes moved, peak rate of its operations)
        "dense_int8": (lambda: dense_int8(x, q),
                       M * K * 2 + K * N + N * 4 + N * 2 + M * N * 2, PEAK_INT8_OPS),
        "int_mm": (lambda: torch._int_mm(x_i8, q["w_i8"]), M * K + K * N + M * N * 4,
                   PEAK_INT8_OPS),
        # the same product with the weight stored row-major (the layout
        # quantize_linear_int8 does not use)
        "int_mm_row_major_w": (lambda: torch._int_mm(x_i8, w_rows), M * K + K * N + M * N * 4,
                               PEAK_INT8_OPS),
        "bf16_dense": (lambda: layers.dense(x, wb), M * K * 2 + K * N * 2 + N * 2 + M * N * 2,
                       PEAK_FLOPS["bfloat16"]),
    }
    for name, (fn, nbytes, peak) in work.items():
        case = {"bytes": nbytes, "operations": ops}
        timed(case, "ms", fn)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        case.update(bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        report[name] = case
        print(f"int8 product {name:18s} [{M}, {K}] x [{K}, {N}]: {case['ms']:.4f} ms, bound "
              f"{case['bound_ms']:.4f} ms ({case['bound_by']}) ({card})")
    return report


def _logits8(torch, model, mean, std, rows):
    """fp32 logits of ``rows`` through a ``FastInferenceEngine`` of
    ``model``, on the host."""
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi

    eng = fi.FastInferenceEngine(model, mean, std)
    return eng(rows["input_ids"], rows["attention_mask"],
               eng.patches_from_hwc(rows["pixel_values"]),
               rows["text_present"], rows["image_present"]).cpu()


def alternating_rates(torch, engines: dict, ids, patches, mask, passes: int = 3):
    """``staged_eval_rates`` of several engines, one pass of each in turn,
    ``passes`` times: {name: {"median", "passes"}}."""
    runs = {name: [] for name in engines}
    for _ in range(passes):
        for name, engine in engines.items():
            runs[name] += staged_eval_rates(torch, engine, ids, patches, mask, passes=1)["passes"]
    return {name: {"median": sorted(r)[len(r) // 2], "passes": r} for name, r in runs.items()}


def clip_int8_phase(torch, card: str):
    """(b) CLIP ViT-B/32 fusion at full width from an exported reference
    checkpoint (``models/export.py``) through ``load_checkpoint`` ->
    ``quantize_fc1_layers`` -> ``FastInferenceEngine``: 12 quantized fc1
    layers (the vision tower's; the 512x2048 text ones stay); fp32 with
    int8 fc1 on the card against the CPU (8 rows, within the CPU's own
    int8-vs-fp32 difference); int8_mlp against bf16_fast on the same 8 rows within the
    CPU's own difference + 3e-2 (phase 3's bf16 bound between two runs);
    ``evaluate_logits_u8`` at int8_mlp, B=144, buckets off and on: 1
    ``patch_embed_u8`` and 24 ``attention_nhd`` per batch on the tensor
    cores, bucketed logits equal to unbucketed (the activation scales are
    per row); staged samples/s of int8_mlp and bf16_fast in turn at seq 77
    and 32 (median and range of 3 passes each) and a profiler breakdown of
    each at seq 77."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models import export
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

    report = {"card": card}
    shutil.rmtree(INT8_ROOT, ignore_errors=True)
    os.makedirs(INT8_ROOT)
    src = FusionModel.create("clip", num_labels=len(CLASSES), seed=4, device="cuda")
    export.export_safetensors(src, os.path.join(INT8_ROOT, "model.safetensors"))
    del src
    for name, obj in (("config.json", HF_CLIP_B32),
                      ("inference_config.json", {"backend": "clip", "head": "fusion",
                                                 "fusion_dim": 512, "class_names": CLASSES})):
        with open(os.path.join(INT8_ROOT, name), "w") as f:
            json.dump(obj, f)
    model, _ = model_io.load_checkpoint(INT8_ROOT, device="cuda")
    cpu_model, _ = model_io.load_checkpoint(INT8_ROOT, device="cpu")
    shutil.rmtree(INT8_ROOT, ignore_errors=True)
    rows = next(InMemoryDataset(8, seed=40).batches(8))
    stats = (CLIP_MEAN, CLIP_STD)

    def tiers(m):
        """(fp32, fp32 int8, bf16_fast, int8_mlp) logits of the 8 rows; casts m."""
        m32 = model_io.with_performance_options(m, attention_impl="pallas")
        q32, n32 = quantize_fc1_layers(m32)
        out = [_logits8(torch, m32, *stats, rows), _logits8(torch, q32, *stats, rows)]
        bf16 = model_io.with_performance_options(
            m, compute_dtype="bfloat16", scores_dtype="bfloat16", attention_impl="pallas",
        ).to(torch.bfloat16)
        q, n = quantize_fc1_layers(bf16)
        check(n32 == n == 12, f"CLIP ViT-B/32: quantized {n32} / {n} fc1 layers, want 12")
        return out + [_logits8(torch, bf16, *stats, rows), _logits8(torch, q, *stats, rows)], \
            bf16, q, n

    card_out, bf16, q, n = tiers(model)
    cpu_out, *_ = tiers(cpu_model)
    del cpu_model
    # fp32: the int8 products are exact, but the card's and the CPU's fp32
    # activations round apart in the last bit, so an element may land one
    # int8 step away; quantizing moves every element by up to half a step,
    # so the quantization's own effect on the CPU bounds the difference
    err = float((card_out[1] - cpu_out[1]).abs().max())
    d_q = float((cpu_out[1] - cpu_out[0]).abs().max())
    check(err <= d_q and bool(card_out[1].isfinite().all()),
          f"fp32 int8 logits on the card differ from the CPU's by {err} (bound: int8 vs "
          f"fp32 on the CPU, {d_q})")
    d_cpu = float((cpu_out[3] - cpu_out[2]).abs().max())
    d_card = float((card_out[3] - card_out[2]).abs().max())
    check(d_card <= d_cpu + 3e-2, f"int8_mlp vs bf16_fast on the card {d_card}, on the CPU "
                                  f"{d_cpu} (bound: the CPU's + 3e-2)")
    report.update(quantized_layers=n, fp32_int8_card_vs_cpu_max_abs_err=err,
                  fp32_int8_vs_fp32_cpu_max_abs_err=d_q,
                  fp32_card_vs_cpu_max_abs_err=float((card_out[0] - cpu_out[0]).abs().max()),
                  int8_vs_bf16_fast_8_rows={"card": d_card, "cpu": d_cpu})

    data = InMemoryDataset(N_INT8_BATCHES * BATCH - 5, seed=41)
    engines = {"int8_mlp": fi.FastInferenceEngine(q, *stats),
               "bf16_fast": fi.FastInferenceEngine(bf16, *stats)}
    runs = {}
    for name, engine, spec in (("int8_buckets_off", engines["int8_mlp"], "off"),
                               ("int8_buckets_auto", engines["int8_mlp"], "auto"),
                               ("bf16_fast_buckets_off", engines["bf16_fast"], "off")):
        counts = _reset_counts()
        logits, labels = fi.evaluate_logits_u8(engine, data, BATCH, num_workers=4,
                                               seq_buckets=fi.parse_seq_buckets(spec))
        launches = counts()
        check(launches == _counts(patch_embed_u8=N_INT8_BATCHES,
                                  attention_nhd=24 * N_INT8_BATCHES),
              f"{name}: launches {launches} for {N_INT8_BATCHES} batches (want 1 and 24 a "
              "batch, on the tensor cores)")
        check(logits.shape == (len(data), len(CLASSES)) and np.isfinite(logits).all(),
              f"{name}: logits {logits.shape}")
        np.testing.assert_array_equal(labels, data.labels)
        runs[name] = {"logits": logits, "launches": launches}
    bucket_err = float(np.abs(runs["int8_buckets_auto"]["logits"]
                              - runs["int8_buckets_off"]["logits"]).max())
    check(bucket_err == 0.0, f"int8 bucketed logits differ from unbucketed by {bucket_err}")
    report.update(
        buckets_vs_full_max_abs_err=bucket_err, batches=N_INT8_BATCHES,
        main_path_launches=runs["int8_buckets_off"]["launches"],
        int8_vs_bf16_fast_max_abs_err=float(np.abs(
            runs["int8_buckets_off"]["logits"] - runs["bf16_fast_buckets_off"]["logits"]).max()))

    g = np.random.default_rng(42)
    vocab = HF_CLIP_B32["text_config"]["vocab_size"]
    patches = [torch.from_numpy(engines["int8_mlp"].patches_from_hwc(
        g.integers(0, 256, size=(BATCH, 224, 224, 3), dtype=np.uint8))).cuda() for _ in range(4)]
    ones = torch.ones(BATCH, device="cuda")
    for width in (77, 32):
        mask = torch.ones(BATCH, width, dtype=torch.int32, device="cuda")
        ids = []
        for _ in range(20):
            x = g.integers(1, vocab - 2, size=(BATCH, 77)).astype(np.int32)
            x[:, 30] = 49407
            ids.append(torch.from_numpy(np.ascontiguousarray(x[:, :width])).cuda())
        report[f"staged_samples_per_s_seq{width}"] = {
            **alternating_rates(torch, engines, ids, patches, mask), "card": card}
        if width == 77:
            for name, engine in engines.items():
                report[f"device_time_seq77_{name}"] = device_time_breakdown(
                    torch, lambda: [engine(x, mask, patches[i % 4], ones, ones)
                                    for i, x in enumerate(ids[:4])], 4)
    return report


def other_int8_phase(torch, card: str):
    """(c) SigLIP2-B/16-224 and ViT-B/16 + BERT-base fusion at int8_mlp,
    B=64, 2 batches each (text seq 64 / 77): 24 quantized fc1 layers each,
    SigLIP's MAP head the source's own module and still float; 1
    ``patch_embed_u8`` and 24 ``attention_nhd`` per batch on the tensor
    cores; the largest logit difference from bf16_fast recorded."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
    from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

    report = {"card": card}
    B = SIGLIP_BATCH
    fast = dict(compute_dtype="bfloat16", scores_dtype="bfloat16", attention_impl="pallas")
    for name in ("siglip224", "generic"):
        if name == "siglip224":
            src = FusionModel.create(
                "siglip", num_labels=len(CLASSES), seed=5, device="cuda",
                siglip_config=model_io.siglip_config_from_dict(HF_SIGLIP2_B16_224))
            data = InMemoryDataset(2 * B, seed=43, T=64, siglip=True)
        else:
            src = _generic_model(torch, seed=5)
            data = InMemoryDataset(2 * B, seed=44, T=GENERIC_TEXT_T, bert=True)
        bf16 = model_io.with_performance_options(src, **fast).to(torch.bfloat16)
        q, n = quantize_fc1_layers(bf16)
        check(n == 24, f"{name}: quantized {n} fc1 layers, want 24")
        if name == "siglip224":
            head = q.backbone["vision_model"]["map_head"]
            check(head is bf16.backbone["vision_model"]["map_head"] and "w" in head["fc1"],
                  "siglip224: the MAP head was quantized")
        batches = []
        for i in range(2):
            idx = np.arange(i * B, (i + 1) * B)
            batches.append((data.input_ids[idx], data.attention_mask[idx],
                            extract_patches_u8(data.images[idx], 16), data.text_present[idx],
                            data.image_present[idx]))
        outs = {}
        for tier, m in (("int8_mlp", q), ("bf16_fast", bf16)):
            engine = fi.FastInferenceEngine(m, SIGLIP_MEAN, SIGLIP_STD)
            counts = _reset_counts()
            outs[tier] = torch.cat([engine(*args) for args in batches])
            if tier == "int8_mlp":
                launches = counts()
        check(launches == _counts(patch_embed_u8=2, attention_nhd=48),
              f"{name}: int8 launches {launches} for 2 batches (want 1 and 24 a batch)")
        check(bool(outs["int8_mlp"].isfinite().all()), f"{name}: non-finite int8 logits")
        report[name] = {"quantized_layers": n, "launches": launches,
                        "int8_vs_bf16_fast_max_abs_err": float(
                            (outs["int8_mlp"] - outs["bf16_fast"]).abs().max())}
        del src, bf16, q
    return report


def entry_points_int8_phase(torch, card: str):
    """(d) The entry points at int8_mlp on phase 7's full-width CLIP
    checkpoint and 281-row CSV: ``cli/evaluate.main`` (``--precision
    int8_mlp --engine fast``, the kernels, native_scaled, buckets, the
    pixel cache) says it quantized 12 fc1 layers and launches 1
    ``patch_embed_u8`` and 24 ``attention_nhd`` per batch; ``model_fn``
    with ``MMHARM_PRECISION=int8_mlp`` (pre-warmed) answers 40 requests in
    2 batches with the same launches, and its probabilities are held
    beside a bf16_fast endpoint's (the largest difference recorded).
    Removes phase 7's directory."""
    import base64
    import contextlib
    import io

    import numpy as np

    from multimodal_content_moderation_tpu_torch.cli import evaluate
    from multimodal_content_moderation_tpu_torch.serving import handler as h
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

    root = os.path.join(REPO, "build", "chip_smoke_serving")
    ckpt, csv_path = os.path.join(root, "checkpoint"), os.path.join(root, "test.csv")
    check(os.path.exists(csv_path), f"phase 7 left no CSV at {csv_path}")
    report = {"card": card}
    n_batches = -(-N_CSV_ROWS // SERVE_BATCH)
    out = io.StringIO()
    counts = _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        metrics = evaluate.main([
            "--checkpoint", ckpt, "--test_csv", csv_path, "--image_root",
            os.path.join(root, "images"), "--batch_size", str(SERVE_BATCH), "--engine", "fast",
            "--image_backend", "native_scaled", "--attention", "pallas", "--precision",
            "int8_mlp", "--seq_buckets", "auto", "--image_cache",
            os.path.join(root, "pixel_cache"), "--device", "cuda",
            "--output", os.path.join(root, "int8.json")])
    wall = time.perf_counter() - t0
    launches = counts()
    check("int8 MLP: quantized 12 fc1 layers" in out.getvalue(),
          f"evaluate at int8_mlp did not quantize 12 layers: {out.getvalue()[-500:]}")
    check(launches == _counts(patch_embed_u8=n_batches, attention_nhd=24 * n_batches),
          f"evaluate at int8_mlp: launches {launches} for {n_batches} batches")
    check(np.isfinite(metrics["f1_macro"]) and np.isfinite(metrics["roc_auc_macro"]),
          f"evaluate at int8_mlp: metrics {metrics}")
    report["evaluate"] = {"rows": N_CSV_ROWS, "batches": n_batches, "launches": launches,
                          "wall_s": wall, "f1_macro": metrics["f1_macro"],
                          "roc_auc_macro": metrics["roc_auc_macro"],
                          "samples_per_second": metrics["samples_per_second"]}

    g = np.random.default_rng(12)
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = [{"text": tweet(g), **({"image": blobs[i % len(blobs)]} if i % 6 != 5 else {})}
             for i in range(40)]
    env = dict(SERVE_ENV)
    saved = {k: os.environ.get(k) for k in env}
    probs = {}
    try:
        for tier in ("int8_mlp", "bf16_fast"):
            os.environ.update(env, MMHARM_PRECISION=tier)
            clf = h.model_fn(ckpt, device="cuda")
            counts = _reset_counts()
            preds = h.predict_fn(insts, clf)
            if tier == "int8_mlp":
                launches = counts()
                check(clf.quantized_layers == 12,
                      f"model_fn at int8_mlp quantized {clf.quantized_layers} layers")
                check(launches == _counts(patch_embed_u8=2, attention_nhd=48),
                      f"model_fn at int8_mlp: launches {launches} for 40 requests")
            check(len(preds) == 40 and all(set(p) == {"class_predictions", "probabilities",
                                                      "any_harmful"} for p in preds),
                  f"model_fn at {tier}: answers {preds[:1]}")
            probs[tier] = _probs(preds)
            del clf
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(np.isfinite(probs["int8_mlp"]).all(), "model_fn at int8_mlp: non-finite answers")
    report["model_fn"] = {"requests": 40, "launches": launches,
                          "int8_vs_bf16_fast_max_abs_prob_diff": _max_diff(
                              probs["int8_mlp"], probs["bf16_fast"])}
    shutil.rmtree(root, ignore_errors=True)
    return report


def _safetensors_names(path: str) -> set:
    """The tensor names in a .safetensors file's header."""
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return set(json.loads(f.read(n))) - {"__metadata__"}


# each kept run's layout: the key prefixes its bundle holds
EXPORT_LAYOUTS = {
    "clip_fusion": ("backbone.text_model.", "backbone.vision_model.", "backbone.logit_scale",
                    "backbone.text_projection.", "backbone.visual_projection.", "proj_t.",
                    "proj_i.", "g_t.", "g_i.", "gate.", "ln_fused.", "cls."),
    "clip_mtl": ("tower_txt.text_model.", "tower_img.vision_model.", "proj_t.", "proj_i.",
                 "g_t.", "g_i.", "gate.", "shared_head.", "heads.", "log_vars"),
    "generic_mtl": ("backbone.text_model.", "backbone.vision_model.", "proj_t.", "proj_i.",
                    "g_t.", "g_i.", "gate.", "shared_head.", "heads.", "log_vars", *FAULT3),
}


def export_phase(torch, card: str):
    """(e) ``cli/export.py`` on the card on the port run directories that
    phase 6 (CLIP fusion), phase 8 (CLIP multi-task, u8 wire) and phase 9
    (generic multi-task) trained: each bundle's keys are its layout's (the
    generic multi-task one with the three leaves JAX's export drops), its
    parameters through ``load_checkpoint`` equal the run checkpoint's, and
    its fp32 logits (the kernels, 8 rows) equal the run checkpoint's bit for
    bit."""
    from multimodal_content_moderation_tpu_torch.cli import export as export_cli
    from multimodal_content_moderation_tpu_torch.data.images import (
        CLIP_MEAN, CLIP_STD, SIGLIP_MEAN, SIGLIP_STD)
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.checkpoints import list_checkpoints

    report = {"card": card}
    counts = _reset_counts()
    for name, prefixes in EXPORT_LAYOUTS.items():
        run = os.path.join(EXPORT_ROOT, name)
        (ckpt,) = list_checkpoints(run)
        out = run + "_exported"
        t0 = time.perf_counter()
        path = export_cli.main(["--checkpoint", ckpt, "--output_dir", out, "--device", "cuda"])
        export_s = time.perf_counter() - t0
        bundle = os.path.dirname(path)
        names = _safetensors_names(path)
        stray = sorted(k for k in names if not k.startswith(prefixes))
        check(not stray, f"{name}: keys outside the layout: {stray[:5]}")
        lacking = [p for p in prefixes if not any(k.startswith(p) for k in names)]
        check(not lacking, f"{name}: the bundle has no key under {lacking}")
        with open(os.path.join(out, "inference_config.json")) as f:
            cfg = json.load(f)
        check("format" not in cfg and cfg["best_checkpoint_dir"] == bundle,
              f"{name}: exported inference_config {cfg}")
        generic = name.startswith("generic")
        rows = next(InMemoryDataset(8, seed=45, bert=generic).batches(8))
        stats = (SIGLIP_MEAN, SIGLIP_STD) if generic else (CLIP_MEAN, CLIP_STD)
        logits, sds = [], []
        for d in (ckpt, bundle):
            m, _ = model_io.load_checkpoint(d, device="cuda")
            sds.append(m.state_dict())
            logits.append(_logits8(torch, model_io.with_performance_options(
                m, attention_impl="pallas"), *stats, rows))
        check(sds[0].keys() == sds[1].keys()
              and all(torch.equal(v, sds[1][k]) for k, v in sds[0].items()),
              f"{name}: the bundle's parameters differ from the run checkpoint's")
        diff = float((logits[0] - logits[1]).abs().max())
        check(diff == 0.0 and bool(logits[0].isfinite().all()),
              f"{name}: the bundle's fp32 logits differ from the run checkpoint's by {diff}")
        report[name] = {"keys": len(names), "export_s": export_s,
                        "bytes": os.path.getsize(path), "logits_max_abs_diff": diff}
        del sds, logits
    launches = counts()
    check(launches == _counts(False, patch_embed_u8=6, attention_nhd=6 * 24),
          f"export round trips: launches {launches} (want 1 + 24 per fp32 batch, 6 batches)")
    report["launches"] = launches
    shutil.rmtree(EXPORT_ROOT, ignore_errors=True)
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
    "generic_eval": "one ViT-B/16 + BERT-base eval batch, bf16, B=64, text seq 77",
    "generic_train": "one ViT-B/16 + BERT-base training micro-step, bf16, B=32, u8 wire (the "
                     "text tower's dropout keeps it on the non-kernel core)",
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
    "generic_eval": {"patch_embed_u8": 1, "attention_nhd": 24},
    "generic_train": {"patch_embed_u8": 1, "attention_nhd": 12, "attention_nhd_bwd": 12},
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
    "generic_eval": {
        "patch_embed_u8": "[12544, 768] x [768, 768] + bias",
        "attention_nhd": "12 vision [64,197,768]/12 heads + 12 text [64,77,768]/12 heads, "
                         "key mask, not causal",
    },
    "generic_train": {
        "patch_embed_u8": "[6272, 768] x [768, 768] + bias",
        "attention_nhd": "12 vision [32,197,768]/12 heads",
        "attention_nhd_bwd": "12 vision [32,197,768]/12 heads",
    },
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
    # None in sys.modules makes an import raise ImportError: nothing the card
    # machine may lack is used on the way
    import importlib.util

    installed = [m for m in HIDDEN_MODULES  # the JAX package is in every checkout
                 if m != "multimodal_content_moderation_tpu" and importlib.util.find_spec(m)]
    print(f"installed here, hidden from imports for this run: {installed}")
    sys.modules.update(dict.fromkeys(HIDDEN_MODULES))
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
    results = {}
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
    results["cases"] = cases
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # phases 3-10: the paths through the entry points; each prints its report
    paths = [
        (3, "model", lambda: full_model_phase(torch, card)),  # the CLIP eval path
        (4, "train", lambda: train_phase(torch, card)),  # the training path
        (5, "siglip", lambda: siglip_phase(torch, card)),  # SigLIP-384 eval
        (5, "siglip224", lambda: siglip224_phase(torch, card)),  # SigLIP-224 eval
        (5, "mha_dense_mask", lambda: mha_dense_mask_phase(torch)),  # attention_small
        (6, "clip_f32_train", lambda: clip_f32_train_phase(torch, card)),
        (6, "siglip224_train", lambda: siglip224_train_phase(torch, card)),
        (7, "serving", lambda: serving_phase(torch, card)),  # the moderation endpoint
        (8, "mtl", lambda: mtl_phase(torch, card)),  # the multi-task head
        (9, "generic", lambda: generic_phase(torch, card)),  # ViT-B/16 + BERT-base
        (10, "int8_product", lambda: int8_product_checks(torch, card)),  # dense_int8
        (10, "int8_eval", lambda: clip_int8_phase(torch, card)),  # CLIP at int8_mlp
        (10, "int8_other", lambda: other_int8_phase(torch, card)),  # SigLIP-224, generic
        (10, "int8_entry_points", lambda: entry_points_int8_phase(torch, card)),
        (10, "export", lambda: export_phase(torch, card)),  # trained runs -> reference
    ]
    for phase in sorted({p for p, *_ in paths}):
        t0 = time.perf_counter()
        for _, key, run in (p for p in paths if p[0] == phase):
            results[key] = run()
            for k, v in results[key].items():
                print(f"{key} {k}: {v}")
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    cases, report, train = results["cases"], results["model"], results["train"]
    siglip, siglip224, mha = results["siglip"], results["siglip224"], results["mha_dense_mask"]
    clip_f32, siglip_train = results["clip_f32_train"], results["siglip224_train"]
    serving, mtl, generic = results["serving"], results["mtl"], results["generic"]
    int8 = {k: results[k] for k in ("int8_product", "int8_eval", "int8_other",
                                    "int8_entry_points")}
    launches_by_path = {"siglip384": siglip["main_path_launches"],
                        "siglip224": siglip224["main_path_launches"],
                        "evaluate": report["main_path_launches"],
                        "train": train["main_path_launches"],
                        "siglip224_train": siglip_train["pallas"]["main_path_launches"],
                        "mha_dense_mask": mha["launches"],
                        "serving": serving["launches"],
                        "mtl_train": mtl["train"]["main_path_launches"],
                        "mtl_evaluate": mtl["evaluate"]["main_path_launches"],
                        "generic_eval": generic["eval"]["main_path_launches"],
                        "generic_train": generic["train"]["main_path_launches"],
                        "int8_eval": int8["int8_eval"]["main_path_launches"],
                        "export": results["export"]["launches"]}
    kernels = [kernel_entry(name, cases, launches_by_path) for name in KERNELS]
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "cases": cases, "model": report, "train": train, "siglip": siglip,
                   "siglip224": siglip224, "mha_dense_mask": mha, "clip_f32_train": clip_f32,
                   "siglip224_train": siglip_train, "serving": serving, "mtl": mtl,
                   "generic": generic, **int8, "export": results["export"],
                   "kernels": kernels},
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
