"""The port's headline bench (``bench_torch.py``, ``tools/bench.py``) against
the JAX package's ``bench.py``: the staged inputs bit for bit, the first
staged batch's fp32 logits at ``--tiny`` widths with one set of weights
(``models/bridge``), the JSON line's keys, and no line without a card.

Tolerance: fp32 atol 1e-4 on the logits (two frameworks, the same
arithmetic in another order)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.data.images import CLIP_MEAN, CLIP_STD
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import clip as jclip
from multimodal_content_moderation_tpu.models.fast_infer import FastInferenceEngine as JEngine
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.tools import _common, bench

REPO = Path(__file__).resolve().parent.parent

# the keys of the JAX bench's line (bench.py:267-312 and bench_e2e)
JAX_BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "passes_samples_per_s", "value_min",
    "value_max", "value_bucketed", "value_bucketed_min", "value_bucketed_max",
    "bucketed_note", "e2e_samples_per_s", "e2e_samples_per_s_min", "e2e_samples_per_s_max",
    "e2e_cached_samples_per_s", "e2e_cached_samples_per_s_min",
    "e2e_cached_samples_per_s_max", "e2e_rows", "e2e_host_cpus", "e2e_vs_baseline",
    "e2e_note",
]


def jax_make_ids(seed, BATCH, SEQ, vocab, eos):
    """``make_ids`` as bench.py:223-227 writes it."""
    gg = np.random.default_rng(seed)
    ids = gg.integers(1, vocab - 2, size=(BATCH, SEQ)).astype(np.int32)
    ids[:, 30] = eos
    return ids


def jax_clip_config(cfg):
    """The JAX package's ``CLIPConfig`` of the port's (the same fields)."""
    d = dataclasses.asdict(cfg)
    return jclip.CLIPConfig(text=jclip.CLIPTextConfig(**d.pop("text")),
                            vision=jclip.CLIPVisionConfig(**d.pop("vision")), **d)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX model, JAX params, the port's fp32 model with those weights)."""
    cfg = _common.encoder_config("clip", tiny=True)
    jmodel = JFusion.create("clip", num_labels=5, clip_config=jax_clip_config(cfg))
    jparams = jmodel.init(jax.random.key(0))
    tmodel = bench.build_model(tiny=True, seed=0, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("seed", [999, 1000, 5069])
def test_make_ids_matches_jax_bench(seed):
    np.testing.assert_array_equal(
        _common.make_ids(seed, 144, 77, 49408, 49407),
        jax_make_ids(seed, 144, 77, 49408, 49407),
    )


def test_staged_inputs_match_jax_bench(tiny_pair):
    """bench.py's draws at seed 0: 4 patch batches from ``default_rng(0)``
    through JAX's ``patches_from_hwc``, ids from seeds 1000 + k."""
    jmodel, jparams, tmodel = tiny_pair
    B = bench.TINY["batch"]
    jeng = JEngine(jmodel, jparams, CLIP_MEAN, CLIP_STD, use_pallas=False)
    g = np.random.default_rng(0)
    want_patches = [jeng.patches_from_hwc(g.integers(0, 256, size=(B, 224, 224, 3),
                                                     dtype=np.uint8)) for _ in range(4)]
    ids, patches = bench.staged_inputs(bench.make_engine(tmodel, "float32"), B, 3, seed=0)
    for got, want in zip(patches, want_patches):
        np.testing.assert_array_equal(got, np.asarray(want))
    for k, got in enumerate(ids):
        np.testing.assert_array_equal(got, jax_make_ids(1000 + k, B, 77, 49408, 49407))
    assert len(patches) == bench.N_STAGED


@pytest.mark.parametrize("attention", ["xla", "pallas"])
def test_first_staged_batch_logits_match_jax(tiny_pair, attention):
    jmodel, jparams, tmodel = tiny_pair
    B = bench.TINY["batch"]
    engine = bench.make_engine(tmodel, "float32", attention)
    ids, patches = bench.staged_inputs(engine, B, 1, seed=0)
    mask = np.ones((B, bench.SEQ), np.int32)
    ones = np.ones((B,), np.float32)
    got = engine(ids[0], mask, patches[0], ones, ones).numpy()
    jeng = JEngine(jmodel, jparams, CLIP_MEAN, CLIP_STD, use_pallas=False)
    want = np.asarray(jeng(ids[0], mask, patches[0], ones, ones))
    assert got.shape == (B, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_bench_torch_cpu_tiny_prints_the_jax_keys():
    out = subprocess.run(
        [sys.executable, str(REPO / "bench_torch.py"), "--device", "cpu", "--tiny"],
        capture_output=True, text=True, cwd=str(REPO), env=_env(), timeout=240,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(JAX_BENCH_KEYS) <= set(line)
    assert line["device"] == "cpu" and line["seed"] == 0
    assert set(line["launches"]) == {*_common.KERNELS,
                                     *(f"{k}_tensor_core" for k in _common.KERNELS)}
    assert not any(line["launches"].values())  # no kernel runs on the CPU
    assert len(line["passes_samples_per_s"]) == bench.TINY["passes"]
    assert line["e2e_rows"] == bench.TINY["e2e_rows"]


def test_bench_torch_without_a_card_prints_no_line(monkeypatch, capsys):
    card = torch.cuda.is_available()  # decided here, not at collection
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py"), "--tiny"],
                         capture_output=True, text=True, cwd=str(REPO), env=_env(),
                         timeout=120)
    if not card:
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA device" in out.stderr
