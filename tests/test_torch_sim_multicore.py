"""The port's multi-producer simulation
(``multimodal_content_moderation_tpu_torch/tools/sim_multicore_e2e.py``) on the CPU
at ``--tiny``: its staged batches are JAX's ``host_batch`` draws (re-derived
here with numpy) cut by JAX's ``extract_patches_u8``; every run hands back
the engine's own logits for every staged batch, in order; the producer
sleeps ``B / rate / cores`` a batch, and not at all without a decode limit;
the JSON line carries JAX's keys plus ``device``, ``launches`` and
``seed``, with a measured decode rate."""

import json

import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.tools import _common
from multimodal_content_moderation_tpu_torch.tools import sim_multicore_e2e as sim
from multimodal_content_moderation_tpu_torch.tools.bench import build_model, make_engine

B = 4


@pytest.fixture(scope="module")
def engine():
    return make_engine(build_model(tiny=True, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def staged(engine):
    return [sim.host_batch(engine, i, B) for i in range(3)]


def test_staged_batches_are_jax_host_batch(engine, staged):
    text = engine.model.clip_config.text
    img, patch = engine.model.image_size, engine.model.clip_config.vision.patch_size
    for seed, b in enumerate(staged):
        g = np.random.default_rng(seed)  # JAX's host_batch(seed)
        ids = g.integers(1, text.vocab_size - 2, size=(B, 77)).astype(np.int32)
        ids[:, 30] = text.eos_token_id
        crops = g.integers(0, 256, size=(B, img, img, 3), dtype=np.uint8)
        np.testing.assert_array_equal(b["input_ids"], ids)
        np.testing.assert_array_equal(b["attention_mask"], np.ones((B, 77), np.int32))
        np.testing.assert_array_equal(b["patches"], np.asarray(extract_patches_u8(crops, patch)))
        assert b["text_present"].tolist() == b["image_present"].tolist() == [1.0] * B


@pytest.mark.parametrize("n_cores", [1, 0])
def test_runs_return_the_engines_logits(engine, staged, n_cores):
    want = [sim.call(engine, b).numpy() for b in staged]
    rate, outs = sim.simulate(engine, staged, n_cores, batch_decode_s=1e-3)
    assert rate > 0 and len(outs) == len(want)
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(got, w)


def test_producer_sleeps_per_batch(engine, staged, monkeypatch):
    slept = []
    monkeypatch.setattr(sim.time, "sleep", slept.append)
    rate = 300.0
    sim.simulate(engine, staged, 4, batch_decode_s=B / rate)
    assert slept == pytest.approx([B / rate / 4] * len(staged))
    slept.clear()
    sim.simulate(engine, staged, 0, batch_decode_s=B / rate)
    assert slept == []


def test_json_line(capsys):
    line = sim.main(["--device", "cpu", "--tiny", "--cores", "2,0"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(line))
    assert {"batch", "per_core_decode_rate_img_s", "curve"} <= set(line)  # JAX's keys
    assert line["device"] == "cpu" and line["seed"] == 0 and line["tiny"] is True
    assert all(v == 0 for v in line["launches"].values())
    assert line["decode_rate_measured"] is True and line["per_core_decode_rate_img_s"] > 0
    assert [p["cores"] for p in line["curve"]] == [2, "inf"]
    for p in line["curve"]:
        assert set(p) == {"cores", "rows_per_s", "min", "max"}
        assert 0 < p["min"] <= p["rows_per_s"] <= p["max"]
    assert line["outputs_max_abs_diff_vs_engine"] == 0.0
    # a given rate is used as it is
    line = sim.main(["--device", "cpu", "--tiny", "--cores", "0", "--decode_rate", "567"])
    assert line["per_core_decode_rate_img_s"] == 567.0 and not line["decode_rate_measured"]


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        sim.main(["--tiny"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_decode_rate_is_measured_on_the_fixtures():
    assert sim.measure_decode_rate(6, 224) > 0
    assert len(_common.fixture_jpegs()) == 6
