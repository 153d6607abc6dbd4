"""The port's measuring tools (``multimodal_content_moderation_tpu_torch/tools``)
at ``--device cpu --tiny``: each prints one JSON line with its JAX
counterpart's keys (listed here from the JAX tools' source) plus ``device``,
``launches`` and ``seed``, in its default mode and in the others
(``bench_serving --coldstart`` and ``--mixed --bypass_sweep``, the
``--decompose`` of ``bench_eval`` and ``bench_train``, ``--int8_mlp``,
``--sweep``, ``profile_eval --seq 32``); ``bench_eval --decompose``'s
towers equal the JAX package's tower functions at tiny widths (fp32, atol
1e-4); the generic backend's text bucket is refused; and without a card
every tool exits non-zero before it prints anything."""

import dataclasses
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.data import images as jimages
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import clip as jclip
from multimodal_content_moderation_tpu.models import generic as jgeneric
from multimodal_content_moderation_tpu.models import siglip as jsiglip
from multimodal_content_moderation_tpu.models.fast_infer import FastInferenceEngine as JEngine
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.tools import _common, bench_eval

PKG = "multimodal_content_moderation_tpu_torch.tools"
TOOLS = ["bench", "bench_eval", "bench_train", "bench_serving", "bench_input", "profile_eval",
         "profile_e2e", "bench_attention", "bench_transfer"]
# each tool's extra flags for the CPU case, and the keys of its JAX
# counterpart's line (bench.py; tools/<tool>.py)
CASES = {
    "bench": ([], ["metric", "value", "unit", "vs_baseline", "passes_samples_per_s",
                   "value_min", "value_max", "value_bucketed", "e2e_samples_per_s",
                   "e2e_cached_samples_per_s", "e2e_note"]),
    "bench_eval": (["--backend", "siglip"],
                   ["metric", "value", "median", "unit", "batch", "bucket", "vs_baseline",
                    "attention", "sweep"]),
    "bench_train": ([], ["metric", "value", "unit", "batch", "ms_per_step", "wire",
                         "scores_dtype", "attention", "accumulator_dtype", "backend", "sweep"]),
    "bench_serving": (["--port", "0", "--clients", "1", "--latency_requests", "2",
                       "--batch_requests", "2", "--batch_size", "2"],
                      ["metric", "value", "unit", "latency_p50_ms", "latency_p95_ms",
                       "latency_p99_ms", "latency_requests", "throughput_samples", "clients",
                       "request_batch", "engine", "precision", "attention", "microbatch_ms",
                       "vs_reference_offline_381.5"]),
    "bench_input": ([], ["metric", "native_jpeg_w1", "native_scaled_w1"]),
    "profile_eval": (["--out", "{tmp}"], ["trace_dir", "trace_files", "largest_file"]),
    "profile_e2e": ([], ["batch", "rows", "cold", "warm_best", "warm_all_rows_per_s"]),
    "bench_attention": ([], ["metric", "value", "unit"]),
    "bench_transfer": ([], ["batch", "per_batch_mb", "single_put",
                            "sequential_4x_per_batch_mb_per_s",
                            "sequential_samples_per_s_equiv"]),
}
NO_LAUNCHES = {**{k: 0 for k in _common.KERNELS},
               **{f"{k}_tensor_core": 0 for k in _common.KERNELS}}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_cpu_tiny_line(tool, tmp_path, capsys):
    extra, jax_keys = CASES[tool]
    argv = ["--device", "cpu", "--tiny"] + [a.format(tmp=tmp_path) for a in extra]
    result = importlib.import_module(f"{PKG}.{tool}").main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(jax_keys) <= set(line), sorted(set(jax_keys) - set(line))
    assert line["device"] == "cpu" and line["seed"] == 0 and line["tiny"] is True
    assert line["launches"] == NO_LAUNCHES  # the CPU runs the plain versions
    if tool == "bench_attention":
        assert {"seq", "xla_us", "pallas_us", "pallas_speedup"} <= set(line["rows"][0])
        assert "nhd_us" in line["rows"][0] and "nhd_us" not in line["rows"][-1]
    if tool == "bench_transfer":
        assert {"mult", "mb", "mb_per_s", "mb_per_s_min", "mb_per_s_max",
                "samples_per_s_equiv"} <= set(line["single_put"][0])
    if tool == "profile_e2e":
        assert {"producer_batch_assembly_s", "producer_patch_extract_s",
                "producer_qput_wait_s", "consumer_qget_wait_s", "consumer_dispatch_s",
                "consumer_fetch_s", "rows_per_s"} <= set(line["cold"])
        for stats in (line["cold"], line["warm_best"]):
            for thread in ("producer_", "consumer_"):
                stages = [v for k, v in stats.items() if k.startswith(thread)]
                assert len(stages) == (5 if thread == "producer_" else 3)
                assert 0 < sum(stages) <= stats["total_s"], (thread, stats)
    if tool == "profile_eval":
        assert line["trace_files"] == 1 and line["device_time"] == _common.NOT_MEASURED


# the modes beyond each tool's default: (tool, flags, the keys of the JAX
# tool's line in that mode)
MODES = {
    "bench_serving coldstart": (
        "bench_serving", ["--coldstart", "--batch_size", "2"],
        ["metric", "value", "unit", "model_load_s", "first_small_request_s",
         "first_batch_request_s", "compile_cache", "seq_buckets", "engine"]),
    "bench_serving mixed bypass_sweep": (
        "bench_serving", ["--mixed", "--microbatch_ms", "4", "--bypass_sweep", "off,16",
                          "--mixed_seconds", "0.5", "--small_clients", "2", "--clients", "1",
                          "--batch_size", "2"],
        ["metric", "value", "sweep", "unit", "small_clients", "batch_clients",
         "request_batch", "microbatch_ms", "engine"]),
    "bench_eval decompose": (
        "bench_eval", ["--backend", "siglip", "--decompose"],
        ["decomposition", "backend", "attention"]),
    "bench_eval int8_mlp": (
        "bench_eval", ["--backend", "clip", "--int8_mlp"],
        ["metric", "value", "median", "unit", "batch", "vs_baseline", "sweep"]),
    "bench_eval sweep": (
        "bench_eval", ["--backend", "clip", "--sweep", "2,4", "--bucket", "16"],
        ["metric", "value", "median", "unit", "batch", "bucket", "vs_baseline", "sweep"]),
    "bench_train decompose": (
        "bench_train", ["--decompose", "--wire", "f32"],
        ["metric", "batch", "fwd_ms", "fwd_bwd_ms", "full_step_ms", "bwd_over_fwd",
         "optimizer_ms", "samples_per_s", "wire", "backend", "attention", "scores_dtype"]),
    "profile_eval seq32": (
        "profile_eval", ["--seq", "32", "--out", "{tmp}"],
        ["trace_dir", "trace_files", "largest_file"]),
    "bench_train sweep": (
        "bench_train", ["--sweep", "2,4", "--backend", "siglip", "--accumulator_dtype",
                        "bfloat16", "--text_len", "16"],
        ["metric", "value", "unit", "batch", "ms_per_step", "sweep", "accumulator_dtype"]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tool_mode_cpu_tiny_line(mode, tmp_path, capsys):
    tool, extra, jax_keys = MODES[mode]
    argv = ["--device", "cpu", "--tiny"] + [a.format(tmp=tmp_path) for a in extra]
    result = importlib.import_module(f"{PKG}.{tool}").main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(jax_keys) <= set(line), sorted(set(jax_keys) - set(line))
    assert line["device"] == "cpu" and line["seed"] == 0 and line["tiny"] is True
    assert line["launches"] == NO_LAUNCHES
    if "sweep" in mode:
        sweep = line["sweep"]
        assert [w.get("bypass", w.get("batch")) for w in sweep] in (["off", "16"], [2, 4])
        assert line["value"] == max(w.get("value", w.get("samples_per_s")) for w in sweep)
    if mode == "bench_eval decompose":
        assert {"batch", "text_ms_per_batch", "vision_ms_per_batch", "full_ms_per_batch",
                "full_samples_per_s", "map_head_ms_per_batch"} <= set(line["decomposition"])
    if mode == "bench_serving coldstart":
        assert line["value"] >= line["model_load_s"] > 0
    if mode == "profile_eval seq32":
        assert line["seq"] == 32 and line["trace_files"] == 1


def _jax_config(backend, cfg):
    """The JAX package's encoder config of the port's (the same fields)."""
    mod, names = {
        "clip": (jclip, ("CLIPConfig", "CLIPTextConfig", "CLIPVisionConfig")),
        "siglip": (jsiglip, ("SigLIPConfig", "SigLIPTextConfig", "SigLIPVisionConfig")),
        "generic": (jgeneric, ("GenericDualConfig", "GenericTextConfig",
                               "GenericVisionConfig")),
    }[backend]
    top, text, vision = (getattr(mod, n) for n in names)
    d = dataclasses.asdict(cfg)
    return top(text=text(**d.pop("text")), vision=vision(**d.pop("vision")), **d)


@pytest.mark.parametrize("backend", ["clip", "siglip", "generic"])
def test_decompose_towers_match_jax(backend):
    args = bench_eval.parse_args(["--device", "cpu", "--tiny", "--backend", backend])
    engine = bench_eval.build_engine(args, torch.device("cpu"), dtype="float32")
    jcfg = _jax_config(backend, _common.encoder_config(backend, tiny=True))
    field = f"{backend}_config"
    jmodel = JFusion.create(backend, num_labels=5, **{field: jcfg})
    jparams = jmodel.init(jax.random.key(1))
    load_jax_params(engine.model, jax.tree_util.tree_map(np.asarray, jparams))
    mean, std = ((jimages.CLIP_MEAN, jimages.CLIP_STD) if backend == "clip"
                 else (jimages.SIGLIP_MEAN, jimages.SIGLIP_STD))
    jmdl = JEngine(jmodel, jparams, mean, std, use_pallas=False).model
    b = jparams["backbone"]

    g = np.random.default_rng(3)
    seq, vocab, _ = bench_eval.text_shape(engine)
    ids = g.integers(1, vocab - 2, size=(3, seq)).astype(np.int32)
    mask = np.ones((3, seq), np.int32)
    mask[1, seq // 2:] = 0
    patches = engine.patches_from_hwc(_common.crops(g, 3, engine.model.image_size))
    jmod = {"clip": jclip, "siglip": jsiglip, "generic": jgeneric}[backend]
    want = {
        "text": getattr(jmod, f"{backend}_text_features")(b, ids, mask, jcfg),
        "vision": getattr(jmod, f"{backend}_image_features_from_tokens")(
            b, jmdl._embed_u8(b, patches), jcfg),
    }
    parts = bench_eval.towers(engine)
    with torch.inference_mode():
        got = {"text": parts["text"](torch.from_numpy(ids), torch.from_numpy(mask)),
               "vision": parts["vision"](torch.from_numpy(patches))}
        if backend == "siglip":
            vc = jcfg.vision
            hid = (g.standard_normal((3, (vc.image_size // vc.patch_size) ** 2,
                                      vc.hidden_size)) / 30).astype(np.float32)
            want["map_head"] = jsiglip._map_head(hid, b["vision_model"]["map_head"], vc)
            got["map_head"] = parts["map_head"](torch.from_numpy(hid))
    assert set(got) == set(parts)
    for name, x in got.items():
        np.testing.assert_allclose(x.numpy(), np.asarray(want[name]), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_generic_bucket_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        bench_eval.main(["--device", "cpu", "--tiny", "--backend", "generic", "--bucket", "32"])
    assert "not exact" in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_a_card_prints_no_line(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        importlib.import_module(f"{PKG}.{tool}").main(["--tiny"])
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""
