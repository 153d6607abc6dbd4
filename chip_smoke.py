#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, and the three kernels built from ``csrc/`` with nvcc (one
   process per source, started together), with their ``-Xptxas -v`` lines.
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the shapes of the eval and training paths and a few edge
   shapes, each held to a stated tolerance, and timed with CUDA events
   (kernel, plain version, one PyTorch library call as a yardstick the port
   never calls) beside the card's bound for the same work. The attention
   backward's yardstick is the backward of
   ``F.scaled_dot_product_attention`` (forward + backward through autograd,
   less the forward).
3. The full-width CLIP ViT-B/32 fusion model (random weights from a seed):
   written as a reference-format checkpoint, loaded with ``load_checkpoint``,
   run through ``FastInferenceEngine`` + ``evaluate_logits_u8`` in bf16 with
   the kernels, with text buckets off and on; the launch counters must show
   1 patch_embed_u8 and 24 attention_nhd launches per batch; fp32 logits on
   the card must match the same model's CPU logits; staged-batch samples/s
   at seq 77 and at the seq-32 bucket.
4. Fine-tuning at full width: ``Trainer`` on the same model (fp32 master
   weights, bf16 towers, the kernels in both passes, u8 wire, batch 32,
   gradient accumulation 2, ``text_fit`` width 48) for a few optimizer
   steps, an eval and a checkpoint, then a resume from ``trainstate-*`` and
   one more optimizer step. The launch counters must show 1
   ``patch_embed_u8``, 24 ``attention_nhd`` and 24 ``attention_nhd_bwd``
   launches per micro-step (eval batches counted apart). Leafwise fp32
   gradients on the card (kernels, TF32 off) must match the CPU's (plain
   versions) on every leaf; the bf16 ``dense`` and its gradients must
   match autograd of its plain definition within one bf16 rounding at the
   towers' MLP shapes; the loss on a fixed batch must fall over 10
   optimizer steps; then training samples/s, the time of forward, backward
   and optimizer, and a profiler breakdown of one optimizer step.

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


def time_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean device time of ``fn`` over ``iters`` warm launches (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _path(label: str, dtype: str):
    """Which main path a bf16 case times: "eval" (B=144), "train" (B=32)."""
    if dtype != "bfloat16":
        return None
    return {"main path": "eval", "train path": "train"}.get(label.split(":")[0])


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
            bms, by = bound_ms(nbytes, 2.0 * R * K * D, "float32")
            cases.append({
                "kernel": "patch_embed_u8", "case": f"{label}: R={R} K={K} D={D}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "path": _path(label, dtype),
                "ms": time_ms(lambda: ci.patch_embed_u8(x, wf, bf, dt)),
                "plain_ms": time_ms(lambda: ci.patch_embed_reference(x, wf, bf, dt)),
                "library_ms": time_ms(lambda: torch.matmul(x.float(), wf)),
                "bound_ms": bms, "bound_by": by,
            })
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
    cases = []
    for B, T, D, h, causal, with_km, label in specs:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(B, T, D, generator=g, device="cuda").to(dt) for _ in range(3))
            km = None
            if with_km:
                # right padding of varied lengths; row 0 has every key masked
                lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
                lengths[0] = 0
                keep = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
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
            mask = None
            if with_km:
                mask = keep[:, None, None, :]
                if causal:
                    mask = mask & torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
            cases.append({
                "kernel": "attention_nhd", "case": f"{label}: B={B} T={T} D={D} heads={h}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                # the eval path's unit is the vision tower + the seq-77 text tower
                "path": None if (_path(label, dtype) == "eval" and T not in (50, 77))
                else _path(label, dtype),
                "ms": time_ms(lambda: ca.attention_nhd(q, k, v, h, km, causal)),
                "plain_ms": time_ms(lambda: ca.attention_nhd_reference(q, k, v, h, km, causal)),
                "library_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None
                    )
                ),
                "bound_ms": bms, "bound_by": by,
            })
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

            fwd_ms = time_ms(lambda: sdpa().detach())
            fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), heads, doh))
            cases.append({
                "kernel": "attention_nhd_bwd", "case": f"{label}: B={B} T={T} D={D} heads={h}",
                "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol,
                "path": _path(label, dtype),
                "ms": time_ms(lambda: ca.attention_nhd_bwd(q, k, v, do, h, km, causal)),
                "plain_ms": time_ms(
                    lambda: ca.attention_nhd_bwd_reference(q, k, v, do, h, km, causal), iters=10),
                "library_ms": max(fwd_bwd_ms - fwd_ms, 0.0),
                "bound_ms": bms, "bound_by": by,
            })
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


def reference_state_dict(model) -> dict:
    """The port's parameter tree -> reference fusion checkpoint keys
    (``backbone.*`` + head), the layout ``models/convert.py`` reads."""
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
    sd["backbone.text_model.embeddings.token_embedding.weight"] = t["token_embedding"]
    sd["backbone.text_model.embeddings.position_embedding.weight"] = t["position_embedding"]
    layers("backbone.text_model", t["layers"])
    ln("backbone.text_model.final_layer_norm", t["final_ln"])
    vc = model.clip_config.vision
    sd["backbone.vision_model.embeddings.class_embedding"] = v["class_embedding"]
    sd["backbone.vision_model.embeddings.patch_embedding.weight"] = (
        v["patch_embedding"]["w"].t().reshape(
            vc.hidden_size, vc.num_channels, vc.patch_size, vc.patch_size
        )
    )
    sd["backbone.vision_model.embeddings.position_embedding.weight"] = v["position_embedding"]
    ln("backbone.vision_model.pre_layrnorm", v["pre_ln"])
    layers("backbone.vision_model", v["layers"])
    ln("backbone.vision_model.post_layernorm", v["post_ln"])
    lin("backbone.text_projection", bb["text_projection"])
    lin("backbone.visual_projection", bb["visual_projection"])
    sd["backbone.logit_scale"] = bb["logit_scale"]
    for n in ("proj_t", "proj_i", "g_t", "g_i", "gate"):
        lin(n, hd[n])
    ln("ln_fused", hd["ln_fused"])
    ln("cls.0", hd["cls_ln"])
    lin("cls.1", hd["cls_fc1"])
    lin("cls.4", hd["cls_fc2"])
    return {k: x.detach().cpu().contiguous().clone() for k, x in sd.items()}


class InMemoryDataset:
    """Seeded uint8 224x224 crops and CLIP-style token ids (BOS, random
    tokens, EOS at a position between 8 and 40, EOS padding), with the
    ``.batches()`` contract of ``data.dataset.CSVDataset``."""

    def __init__(self, n: int, seed: int, T: int = 77):
        import numpy as np

        g = np.random.default_rng(seed)
        self.input_ids = np.full((n, T), 49407, np.int32)
        self.attention_mask = np.zeros((n, T), np.int32)
        eos = g.integers(8, 41, size=n)
        for i, e in enumerate(eos):
            self.input_ids[i, 0] = 49406
            self.input_ids[i, 1:e] = g.integers(1, 49406, size=e - 1)
            self.attention_mask[i, : e + 1] = 1
        self.images = g.integers(0, 256, size=(n, 224, 224, 3), dtype=np.uint8)
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
                "pixel_values": self.images[idx],
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
    from multimodal_content_moderation_tpu_torch.ops.cuda_attention import attention_nhd
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import patch_embed_u8

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
    shutil.rmtree(ckpt, ignore_errors=True)

    # the main path: bf16 towers with the attention_nhd kernel
    bf16 = model_io.with_performance_options(
        model, compute_dtype="bfloat16", attention_impl="pallas"
    ).to(torch.bfloat16)
    engine = fi.FastInferenceEngine(bf16, CLIP_MEAN, CLIP_STD)
    n_batches = -(-len(data) // BATCH)
    runs = {}
    for name, spec in (("seq_buckets_off", "off"), ("seq_buckets_auto", "auto")):
        patch_embed_u8.launches = 0
        attention_nhd.launches = 0
        t0 = time.perf_counter()
        logits, labels = fi.evaluate_logits_u8(
            engine, data, BATCH, num_workers=4, seq_buckets=fi.parse_seq_buckets(spec)
        )
        wall = time.perf_counter() - t0
        launches = {"patch_embed_u8": patch_embed_u8.launches,
                    "attention_nhd": attention_nhd.launches}
        check(launches == {"patch_embed_u8": n_batches, "attention_nhd": 24 * n_batches},
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


# ---------------------------------------------------------------------------
# Phase 4: fine-tuning at full width
# ---------------------------------------------------------------------------

N_TRAIN_ROWS = 16 * TRAIN_BATCH  # 16 micro-steps (8 optimizer steps) an epoch
N_VAL_ROWS = 2 * 64 - 7  # two eval batches, the last one padded


def _reset_counts():
    from multimodal_content_moderation_tpu_torch.ops.cuda_attention import (
        attention_nhd, attention_nhd_bwd)
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import patch_embed_u8

    for fn in (patch_embed_u8, attention_nhd, attention_nhd_bwd):
        fn.launches = 0
    return lambda: {"patch_embed_u8": patch_embed_u8.launches,
                    "attention_nhd": attention_nhd.launches,
                    "attention_nhd_bwd": attention_nhd_bwd.launches}


def _device_batch(torch, data, idx, patch_size):
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8

    return {
        "input_ids": torch.from_numpy(data.input_ids[idx]).cuda(),
        "attention_mask": torch.from_numpy(data.attention_mask[idx]).cuda(),
        "patches_u8": torch.from_numpy(extract_patches_u8(data.images[idx], patch_size)).cuda(),
        "text_present": torch.from_numpy(data.text_present[idx]).cuda(),
        "image_present": torch.from_numpy(data.image_present[idx]).cuda(),
        "labels": torch.from_numpy(data.labels[idx]).cuda(),
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
    from multimodal_content_moderation_tpu_torch.training.loop import (
        TrainArgs, Trainer, make_train_step)
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_multi)
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

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
    want = {"patch_embed_u8": n_micro + eval_batches,
            "attention_nhd": 24 * (n_micro + eval_batches),
            "attention_nhd_bwd": 24 * n_micro}
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
            check(counts() == {"patch_embed_u8": 1, "attention_nhd": 24, "attention_nhd_bwd": 24},
                  f"gradient check launches {counts()}")
        del m
    (loss_card, g_card), (loss_cpu, g_cpu) = grads["cuda"], grads["cpu"]
    check(abs(loss_card - loss_cpu) <= 1e-4, f"fp32 loss card {loss_card} vs cpu {loss_cpu}")
    # per leaf: |card - cpu| <= 1e-3 * max|cpu leaf| + 1e-6 * max|cpu, all
    # leaves|: fp32 sums over 12 layers in another order. The floor is for
    # leaves whose exact gradient is 0 (the attention key bias: softmax does
    # not see a shift shared by every key), where both devices hold rounding
    # noise. A leaf that is zero on the card and not on the CPU fails.
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
    report["grad_check"] = {
        "leaves": len(ratios), "floor": floor, "loss_card": loss_card, "loss_cpu": loss_cpu,
        "worst_err_over_tol": [{"leaf": n, "err": e, "leaf_max": sc, "err_over_tol": r}
                               for r, n, e, sc in ratios[:4]],
    }
    del grads, g_card, g_cpu
    # the check above runs fp32, which bypasses the bf16 dense's backward
    report["dense_bf16_grad_check"] = dense_bf16_grad_check(torch)

    # learning: the loss on one fixed batch falls over 10 optimizer steps
    model = new_model(seed=2, **bf16_pallas)
    batch = _device_batch(torch, train_ds, np.arange(TRAIN_BATCH), 32)
    opt = AdamW(dict(model.named_parameters()), lr_encoder=1e-5, lr_head=5e-4,
                total_steps=10, warmup_ratio=0.0, schedule="constant")
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_train_step(model, opt, generator=gen)
    with torch.no_grad():
        before = float(model(batch)["loss"])
    for _ in range(10):
        step(batch)
    with torch.no_grad():
        after = float(model(batch)["loss"])
    check(after < before, f"loss on a fixed batch did not fall: {before} -> {after}")
    report["fixed_batch_loss"] = {"before": before, "after_10_steps": after}

    # throughput on staged batches, and the time of each part of a step
    opt = AdamW(dict(model.named_parameters()), total_steps=100,
                accumulation_steps=TRAIN_ACCUM)
    step = make_train_step(model, opt, generator=gen)
    staged = [_device_batch(torch, train_ds, np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH), 32)
              for i in range(4)]
    for b in staged:
        step(b)
    torch.cuda.synchronize()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(8):
            step(staged[i % 4])
        torch.cuda.synchronize()
        rates.append(8 * TRAIN_BATCH / (time.perf_counter() - t0))
    report["staged_train_samples_per_s"] = {"median": sorted(rates)[1], "passes": rates,
                                           "card": card}
    report["train_step_parts_ms"] = step_parts_ms(torch, model, opt, gen, staged)
    report["device_time_train"] = device_time_breakdown(
        torch, lambda: [step(staged[i]) for i in range(TRAIN_ACCUM)], 1)
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


# device-kernel name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = [
    ("attention_nhd_bwd", ("attention_nhd_bwd",)),
    ("attention_nhd", ("attention_nhd",)),
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


KERNELS = ["patch_embed_u8", "attention_nhd", "attention_nhd_bwd"]
REPLACES = {
    "patch_embed_u8": "multimodal_content_moderation_tpu/ops/pallas_image.py:93",
    "attention_nhd": "multimodal_content_moderation_tpu/ops/pallas_attention.py:318",
    "attention_nhd_bwd": "multimodal_content_moderation_tpu/ops/pallas_attention.py:468",
}
# launches of each kernel in one unit of a path's work (a training
# micro-step; an eval batch)
PER_UNIT = {"patch_embed_u8": 1, "attention_nhd": 24, "attention_nhd_bwd": 24}
WORK = {
    "train": {
        "patch_embed_u8": "[1568, 3072] x [3072, 768]",
        "attention_nhd": "12 vision [32,50,768]/12 heads + 12 text [32,48,512]/8 heads",
        "attention_nhd_bwd": "12 vision [32,50,768]/12 heads + 12 text [32,48,512]/8 heads",
    },
    "eval": {
        "patch_embed_u8": "[7056, 3072] x [3072, 768]",
        "attention_nhd": "12 vision [144,50,768]/12 heads + 12 text [144,77,512]/8 heads",
    },
}


def _per_unit(name, cases, path):
    """Sums over the launches of one unit of a path's work, from the bf16
    cases timed at that path's shapes."""
    main = [c for c in cases if c["kernel"] == name and c["path"] == path]
    if not main:
        return None
    each = PER_UNIT[name] // len(main)
    out = {k: each * sum(c[k] for c in main) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = max(main, key=lambda c: c["bound_ms"])["bound_by"]
    out["work"] = WORK[path][name]
    return out


def unported_bounds():
    """The card's bound for the two TPU kernels not yet ported, at a stated
    representative shape (bf16): ``flash_attention`` from its work (q, k, v
    read and o written once; 4 T S dh operations per head, there is no cost
    estimate in its ``pallas_call``) and ``attention_small`` from its cost
    estimate (pallas_attention.py:95-101)."""
    out = {}
    bh, t, dh = 32 * 12, 512, 64  # a BERT-base text tower at seq 512, key padding
    ms, by = bound_ms(4 * bh * t * dh * 2 + bh * t * 4, 4.0 * bh * t * t * dh, "bfloat16")
    out["flash_attention"] = {"shape": f"[{bh}, {t}, {dh}] bf16 + key mask [{bh}, {t}]",
                              "bound_ms": ms, "bound_by": by}
    bh, t = BATCH * 8, 77  # the CLIP text tower of an eval batch with a dense mask
    ms, by = bound_ms(bh * t * dh * 3 * 2 + bh * t * t * 4, 4.0 * bh * t * t * dh, "bfloat16")
    out["attention_small"] = {"shape": f"[{bh}, {t}, {dh}] bf16 + dense mask [{bh}, {t}, {t}]",
                              "bound_ms": ms, "bound_by": by}
    return out


def kernel_entry(name, cases, train_launches, eval_launches):
    """One kernel of the ``{"kernels": ...}`` line: the training path
    (this slice's main path, per micro-step) with its launches, and the
    eval path's numbers beside it."""
    train = _per_unit(name, cases, "train")
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"{PKG}/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": train_launches[name],
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == name),
        "ms": train["ms"],
        "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"],
        "library_ms": train["library_ms"],
        "work": "one training micro-step, bf16, B=32: " + train["work"],
        "launches_by_path": {"train": train_launches[name],
                             "evaluate": eval_launches.get(name, 0)},
    }
    ev = _per_unit(name, cases, "eval")
    if ev is not None:
        entry["eval_batch"] = dict(ev, work="one eval batch, bf16, B=144: " + ev["work"])
    return entry


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
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = patch_embed_cases(torch, g) + attention_cases(torch, g) + attention_bwd_cases(torch, g)
    for c in cases:
        print(
            f"{c['kernel']:17s} {c['dtype']:8s} {c['case']:60s} err {c['max_abs_err']:.3g} "
            f"(atol {c['atol']:g} rtol {c['rtol']:.3g}) kernel {c['ms']:.4f} ms "
            f"plain {c['plain_ms']:.4f} ms library {c['library_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
        )

    # phase 3: the eval path through the entry points
    report = full_model_phase(torch, card)
    for k, v in report.items():
        print(f"model {k}: {v}")

    # phase 4: the training path through the entry points
    train = train_phase(torch, card)
    for k, v in train.items():
        print(f"train {k}: {v}")

    kernels = [
        kernel_entry(name, cases, train["main_path_launches"], report["main_path_launches"])
        for name in KERNELS
    ]
    unported = unported_bounds()
    for name, b in unported.items():
        print(f"not ported yet: {name} at {b['shape']}: bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "cases": cases, "model": report, "train": train, "kernels": kernels,
                   "unported_bounds": unported},
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
