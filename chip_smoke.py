#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, and both kernels built from ``csrc/`` with nvcc (one process
   per source, started together), with their ``-Xptxas -v`` lines.
2. Each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at the main path's shapes and a few edge shapes, each held to a
   stated tolerance, and timed with CUDA events (kernel, plain version, one
   PyTorch library call as a yardstick the port never calls) beside the
   card's bound for the same work.
3. The full-width CLIP ViT-B/32 fusion model (random weights from a seed):
   written as a reference-format checkpoint, loaded with ``load_checkpoint``,
   run through ``FastInferenceEngine`` + ``evaluate_logits_u8`` in bf16 with
   the kernels, with text buckets off and on; the launch counters must show
   1 patch_embed_u8 and 24 attention_nhd launches per batch; fp32 logits on
   the card must match the same model's CPU logits; staged-batch samples/s
   at seq 77 and at the seq-32 bucket.

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
                "main_path": label.startswith("main path") and dtype == "bfloat16",
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
                "main_path": label.startswith("main path") and dtype == "bfloat16"
                and T in (50, 77),
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

    def batches(self, batch_size, pad_to_batch=False, num_workers=0, indices=None):
        import numpy as np

        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        for s in range(0, len(order), batch_size):
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


# device-kernel name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = [
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
    _build.build(["patch_embed_u8", "attention_nhd"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in _build.ptxas_reports.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = patch_embed_cases(torch, g) + attention_cases(torch, g)
    for c in cases:
        print(
            f"{c['kernel']:15s} {c['dtype']:8s} {c['case']:60s} err {c['max_abs_err']:.3g} "
            f"(atol {c['atol']:g} rtol {c['rtol']:.3g}) kernel {c['ms']:.4f} ms "
            f"plain {c['plain_ms']:.4f} ms library {c['library_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
        )

    # phase 3: the full-width model through the entry points
    report = full_model_phase(torch, card)
    for k, v in report.items():
        print(f"model {k}: {v}")

    launches = report["main_path_launches"]
    per_launch = {"patch_embed_u8": 1, "attention_nhd": 24}
    replaces = {
        "patch_embed_u8": "multimodal_content_moderation_tpu/ops/pallas_image.py:93",
        "attention_nhd": "multimodal_content_moderation_tpu/ops/pallas_attention.py:318",
    }
    kernels = []
    for name in ("patch_embed_u8", "attention_nhd"):
        mine = [c for c in cases if c["kernel"] == name]
        # the work of one main-path batch (bf16, B=144): 1 patch embed, or
        # 12 vision + 12 seq-77 text attention launches
        main = [c for c in mine if c["main_path"]]
        each = per_launch[name] // len(main)
        sums = {k: each * sum(c[k] for c in main) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sums["ms"],
            "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"],
            "bound_by": max(main, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": sums["library_ms"],
            "work": "one main-path batch, bf16, B=144"
            + (": 12 vision [144,50,768]/12 heads + 12 text [144,77,512]/8 heads"
               if name == "attention_nhd" else ": [7056, 3072] x [3072, 768]"),
        })

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "cases": cases, "model": report, "kernels": kernels}, f, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
