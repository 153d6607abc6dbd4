"""The port's evaluate CLI against the JAX package's on one reference-format
checkpoint: a tiny JAX fusion model on the ``encoder_dir`` config, exported
with ``export_safetensors`` beside an ``inference_config.json``, through
both engines (``--engine standard``, the default of both CLIs, and
``fast``); and the two engines of the port against each other.

Tolerances as in tests/test_cli.py: f1 within 1e-6, ROC-AUC within 1e-4;
the two engines' logits within fp32 atol 1e-5 (the u8 wire folds the
normalisation into the embed weight, the standard engine normalises then
embeds: the same fp32 math rounded in another order)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.cli import evaluate as j_eval
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.export import export_safetensors
from multimodal_content_moderation_tpu.models.model_io import load_encoder_config
from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(encoder_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_ckpt")
    model = JFusion.create(
        "clip", num_labels=5, fusion_dim=16, clip_config=load_encoder_config(encoder_dir, "clip")
    )
    export_safetensors(model.init(jax.random.key(7)), model, str(d / "model.safetensors"))
    with open(d / "inference_config.json", "w") as f:
        json.dump(
            {
                "backend": "clip", "head": "fusion", "fusion_dim": 16,
                "class_names": CLASSES, "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5],
                "max_text_length": 16, "encoder_dir": encoder_dir,
            },
            f,
        )
    return str(d)


@pytest.mark.parametrize("engine", ["fast", "standard"])
@pytest.mark.parametrize("attention", ["xla", "pallas"])
def test_evaluate_cli_matches_jax(checkpoint, data_dir, tmp_path, attention, engine):
    common = [
        "--checkpoint", checkpoint,
        "--test_csv", f"{data_dir}/test.csv",
        "--image_root", f"{data_dir}/images",
        "--batch_size", "8",
    ] + (["--engine", "fast"] if engine == "fast" else [])
    want = j_eval.main(common + ["--device", "cpu", "--output", str(tmp_path / "jax.json")])
    out = str(tmp_path / "torch.json")
    got = t_eval.main(
        common + ["--device", "cpu", "--attention", attention, "--output", out]
    )
    assert os.path.exists(out)
    with open(out) as f:
        assert json.load(f)["f1_macro"] == got["f1_macro"]
    assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-6)
    assert got["f1_micro"] == pytest.approx(want["f1_micro"], abs=1e-6)
    assert got["roc_auc_macro"] == pytest.approx(want["roc_auc_macro"], abs=1e-4)
    for name in CLASSES:
        g, w = got["per_class"][name], want["per_class"][name]
        assert g["support"] == w["support"]
        assert g["f1_calibrated"] == pytest.approx(w["f1_calibrated"], abs=1e-6)
        assert g["roc_auc"] == pytest.approx(w["roc_auc"], abs=1e-4)


@pytest.mark.parametrize("backend", ["native", "native_scaled"])
def test_evaluate_cli_takes_the_native_backends(backend, tmp_path):
    """The native JPEG backends and the pixel cache are ported: the CLI
    takes them (the run itself: tests/test_torch_no_pil.py)."""
    args = t_eval.parse_args(["--checkpoint", "c", "--test_csv", "t.csv", "--image_backend",
                              backend, "--image_cache", str(tmp_path)])
    assert args.image_backend == backend and args.image_cache == str(tmp_path)


def test_standard_engine_matches_the_fast_engine(checkpoint, data_dir, capsys):
    """The port's two engines on the same checkpoint and CSV: the standard
    engine (fp32 pixels, full text width) against the fast engine (u8 wire,
    the seq-8 bucket rung): logits within fp32 atol 1e-5. An explicit
    ``--seq_buckets`` ladder with the standard engine is named as ignored."""
    from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
    from multimodal_content_moderation_tpu_torch.models import fast_infer as fi
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.loop import evaluate_logits_standard

    model, cfg = model_io.load_checkpoint(checkpoint, device="cpu")
    enc = cfg["encoder_dir"]
    (H, W), mean, std = image_stats_from_dir(enc, "clip")
    logits = {}
    for output in ("uint8_hwc", "float_nchw"):
        ds = CSVDataset(f"{data_dir}/test.csv", f"{data_dir}/images", load_tokenizer(enc),
                        ImagePreprocessor(H, W, mean, std, output=output), 16,
                        class_names=CLASSES)
        if output == "uint8_hwc":
            logits[output], labels = fi.evaluate_logits_u8(
                fi.FastInferenceEngine(model, mean, std), ds, 8, seq_buckets=(8,))
        else:
            logits[output], labels_std = evaluate_logits_standard(model, ds, 8)
    np.testing.assert_array_equal(labels, labels_std)
    np.testing.assert_allclose(logits["float_nchw"], logits["uint8_hwc"], atol=1e-5, rtol=0)
    t_eval.main(["--checkpoint", checkpoint, "--test_csv", f"{data_dir}/test.csv",
                 "--image_root", f"{data_dir}/images", "--batch_size", "8", "--device", "cpu",
                 "--seq_buckets", "8,16", "--output", os.devnull])
    assert "seq_buckets=8,16 ignored" in capsys.readouterr().out
