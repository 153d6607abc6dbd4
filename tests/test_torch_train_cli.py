"""The port's train CLI end to end on the tiny CSV + PNG fixture
(tests/conftest.py: a complete local CLIP encoder directory, 32/16/16 rows)
with ``training: {wire: u8, attention: pallas}`` in its YAML (the kernels'
plain versions on the CPU) and ``--device cpu``.

It writes the JAX CLI's five artifacts with the JAX CLI's keys (as
tests/test_cli.py checks them), ``"format": "torch"`` in
inference_config.json, and the run directory then loads in the port's
evaluate CLI."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval
from multimodal_content_moderation_tpu_torch.cli import train as t_train

INFERENCE_KEYS = {
    "encoder_name", "encoder_dir", "backend", "head", "fusion_dim", "max_text_length",
    "head_hidden_dim", "learnable_task_weights", "thresholds", "class_names",
    "best_checkpoint_dir", "use_logit_adjustment", "priors", "format",
}
METRIC_KEYS = {"f1_macro", "f1_micro", "roc_macro", "loss", "runtime", "samples_per_second"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(config_file, directory, **training):
    """The shared fixture's YAML with ``training`` keys set."""
    with open(config_file) as f:
        cfg = yaml.safe_load(f)
    cfg["training"].update(training)
    path = directory / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def torch_run(config_file, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_run")
    cfg = _config(config_file, d, wire="u8", attention="pallas")
    out = str(d / "exp")
    result = t_train.main([
        "--config", cfg, "--saving.output_dir", out, "--training.text_fit", "auto",
        "--device", "cpu",
    ])
    return out, result


def test_artifacts_and_keys(torch_run):
    out, result = torch_run
    for name in ["config.json", "val_report.json", "test_metrics.json",
                 "inference_config.json", "label_map.json"]:
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "inference_config.json")) as f:
        cfg = json.load(f)
    assert set(cfg) == INFERENCE_KEYS
    assert cfg["format"] == "torch" and cfg["backend"] == "clip"
    assert len(cfg["thresholds"]) == 5 and cfg["class_names"][0] == "racist"
    assert os.path.isdir(cfg["best_checkpoint_dir"])
    with open(os.path.join(out, "test_metrics.json")) as f:
        assert set(json.load(f)) == {f"test_{k}" for k in METRIC_KEYS}
    with open(os.path.join(out, "val_report.json")) as f:
        assert set(json.load(f)) == METRIC_KEYS
    with open(os.path.join(out, "label_map.json")) as f:
        lm = json.load(f)
    assert lm["0"] == "racist" and lm["4"] == "otherhate"
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["training"]["wire"] == "u8"
    hist = result["result"]["history"]
    assert len(hist) == 2 and result["result"]["global_step"] == 8
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["train_loss"]) for h in hist)


def test_run_directory_loads_in_the_evaluate_cli(torch_run, data_dir, tmp_path):
    out, result = torch_run
    metrics = t_eval.main([
        "--checkpoint", result["result"]["best_checkpoint"],
        "--test_csv", f"{data_dir}/test.csv", "--image_root", f"{data_dir}/images",
        "--batch_size", "8", "--device", "cpu", "--attention", "pallas",
        "--output", str(tmp_path / "eval.json"),
    ])
    assert "f1_macro" in metrics and "f1_calibrated" in metrics["per_class"]["racist"]
    # the same trained model scored by the CLI and by the trainer's test pass
    with open(os.path.join(out, "test_metrics.json")) as f:
        test = json.load(f)
    assert metrics["roc_auc_macro"] == pytest.approx(test["test_roc_macro"], abs=1e-4)


@pytest.mark.parametrize(
    "wire,flags,match",
    [
        ("f32", [], "patchify"),
        ("u8", ["--model.head", "mtl"], "mtl"),
        ("u8", ["--parallel.model", "2"], "one device"),
    ],
)
def test_train_cli_names_what_is_not_ported(config_file, tmp_path, wire, flags, match):
    cfg = _config(config_file, tmp_path, wire=wire)
    with pytest.raises(NotImplementedError, match=match):
        t_train.main(["--config", cfg, "--saving.output_dir", str(tmp_path / "x"),
                      "--device", "cpu"] + flags)
