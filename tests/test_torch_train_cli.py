"""The port's train CLI end to end on the tiny CSV + PNG fixture
(tests/conftest.py: a complete local CLIP encoder directory, 32/16/16 rows)
with ``training: {wire: u8, attention: pallas}`` in its YAML (the kernels'
plain versions on the CPU) and ``--device cpu``.

It writes the JAX CLI's five artifacts with the JAX CLI's keys (as
tests/test_cli.py checks them), ``"format": "torch"`` in
inference_config.json, and the run directory then loads in the port's
evaluate CLI. The shipped ``config/clip_fusion.yaml``,
``config/siglip_fusion.yaml`` and ``config/clip_mtl.yaml`` train as they are
(the f32 wire, bf16, the "xla" attention core), with only the encoder, the
data and the epochs set on the command line; ``clip_mtl.yaml`` also on the
u8 wire with the kernels, and its run directory scores in the evaluate
CLI as in the trainer's test pass."""

import json
import os
from pathlib import Path

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
        ("u8", ["--parallel.model", "2"], "one device"),
    ],
)
def test_train_cli_names_what_is_not_ported(config_file, tmp_path, wire, flags, match):
    # a mesh of two ranks in a world of one process: the CLI names what the
    # section needs (a process, and a device, per rank) instead of carrying on
    cfg = _config(config_file, tmp_path, wire=wire)
    with pytest.raises(ValueError, match=match):
        t_train.main(["--config", cfg, "--saving.output_dir", str(tmp_path / "x"),
                      "--device", "cpu"] + flags)


REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def siglip_encoder_dir(tmp_path_factory):
    """A tiny SigLIP encoder directory without weights (the model starts from
    its seeded init): config.json with a 64-position text tower, as the
    shipped config's ``max_text_length``, a WordLevel tokenizer.json and a
    32-pixel preprocessor_config.json."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("siglip_train_enc")
    words = ["<pad>", "<unk>", "hate", "love"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<pad>"}))
    (d / "config.json").write_text(json.dumps({
        "model_type": "siglip",
        "text_config": {"vocab_size": len(words), "hidden_size": 32, "num_hidden_layers": 1,
                        "num_attention_heads": 2, "intermediate_size": 64,
                        "max_position_embeddings": 64},
        "vision_config": {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
                          "intermediate_size": 64, "image_size": 32, "patch_size": 16},
    }))
    (d / "preprocessor_config.json").write_text(json.dumps(
        {"size": {"height": 32, "width": 32}, "image_mean": [0.5] * 3, "image_std": [0.5] * 3}))
    return str(d)


@pytest.mark.parametrize("name", ["clip_fusion.yaml", "siglip_fusion.yaml"])
def test_shipped_configs_train(name, encoder_dir, siglip_encoder_dir, data_dir, tmp_path,
                               caplog):
    """The shipped YAML with no wire override: the f32 wire (float_nchw
    pixels through the pixel path), evaluated by the standard engine; the
    five artifacts are written. SigLIP ignores ``text_fit`` with a warning
    and trains at the full 64-position text width."""
    enc = encoder_dir if name.startswith("clip") else siglip_encoder_dir
    out = str(tmp_path / "run")
    result = t_train.main([
        "--config", str(REPO / "config" / name), "--model.encoder_dir", enc,
        "--data.train_csv", f"{data_dir}/train.csv", "--data.val_csv", f"{data_dir}/val.csv",
        "--data.test_csv", f"{data_dir}/test.csv", "--data.image_root", f"{data_dir}/images",
        "--training.num_train_epochs", "2", "--saving.output_dir", out, "--device", "cpu",
    ])
    for artifact in ["config.json", "val_report.json", "test_metrics.json",
                     "inference_config.json", "label_map.json"]:
        assert os.path.exists(os.path.join(out, artifact)), artifact
    with open(os.path.join(out, "config.json")) as f:
        training = json.load(f)["training"]
    assert training["wire"] == "f32" and training["precision"] == "bf16"
    assert training["attention"] == "xla"
    with open(os.path.join(out, "inference_config.json")) as f:
        cfg = json.load(f)
    assert set(cfg) == INFERENCE_KEYS and cfg["backend"] == name.split("_")[0]
    assert os.path.isdir(cfg["best_checkpoint_dir"])
    with open(os.path.join(out, "test_metrics.json")) as f:
        assert set(json.load(f)) == {f"test_{k}" for k in METRIC_KEYS}
    hist = result["result"]["history"]
    assert len(hist) == 2 and result["result"]["global_step"] == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["train_loss"]) for h in hist)
    assert ("text_fit ignored" in caplog.text) == name.startswith("siglip")


MTL_METRIC_KEYS = METRIC_KEYS | {
    f"{m}_{c}" for m in ("f1", "roc")
    for c in ("racist", "sexist", "homophobe", "religion", "otherhate")
}


def _mtl_config(directory, **training):
    """The shipped ``config/clip_mtl.yaml`` as the base of a YAML that sets
    ``training`` keys (the CLI has no flag for the wire)."""
    path = directory / "mtl.yaml"
    path.write_text(yaml.safe_dump({"_base_": str(REPO / "config" / "clip_mtl.yaml"),
                                    "training": training}))
    return str(path)


@pytest.fixture(scope="module", params=["f32", "u8"])
def mtl_run(request, encoder_dir, data_dir, tmp_path_factory):
    """``config/clip_mtl.yaml`` as shipped (f32), and on the u8 wire with
    ``attention: pallas``: 2 epochs of 32 rows at batch 32 x 2 accumulation."""
    d = tmp_path_factory.mktemp(f"mtl_{request.param}")
    cfg = (str(REPO / "config" / "clip_mtl.yaml") if request.param == "f32"
           else _mtl_config(d, wire="u8", attention="pallas"))
    out = str(d / "run")
    result = t_train.main([
        "--config", cfg, "--model.encoder_dir", encoder_dir,
        "--data.train_csv", f"{data_dir}/train.csv", "--data.val_csv", f"{data_dir}/val.csv",
        "--data.test_csv", f"{data_dir}/test.csv", "--data.image_root", f"{data_dir}/images",
        "--training.num_train_epochs", "2", "--saving.output_dir", out, "--device", "cpu",
    ])
    return request.param, out, result


def test_shipped_clip_mtl_trains(mtl_run):
    wire, out, result = mtl_run
    for artifact in ["config.json", "val_report.json", "test_metrics.json",
                     "inference_config.json", "label_map.json"]:
        assert os.path.exists(os.path.join(out, artifact)), artifact
    with open(os.path.join(out, "config.json")) as f:
        training = json.load(f)["training"]
    assert training["wire"] == wire and training["gradient_accumulation_steps"] == 2
    assert training["attention"] == ("xla" if wire == "f32" else "pallas")
    with open(os.path.join(out, "inference_config.json")) as f:
        cfg = json.load(f)
    assert set(cfg) == INFERENCE_KEYS and cfg["head"] == "mtl" and cfg["backend"] == "clip"
    assert cfg["head_hidden_dim"] == 256 and cfg["learnable_task_weights"] is True
    assert os.path.isdir(cfg["best_checkpoint_dir"])
    with open(os.path.join(out, "test_metrics.json")) as f:
        assert set(json.load(f)) == {f"test_{k}" for k in MTL_METRIC_KEYS}
    with open(os.path.join(out, "val_report.json")) as f:
        assert set(json.load(f)) == MTL_METRIC_KEYS
    hist = result["result"]["history"]
    assert len(hist) == 2 and result["result"]["global_step"] == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["train_loss"]) for h in hist)


def test_mtl_run_directory_scores_in_the_evaluate_cli(mtl_run, data_dir, tmp_path):
    wire, out, result = mtl_run
    metrics = t_eval.main([
        "--checkpoint", result["result"]["best_checkpoint"],
        "--test_csv", f"{data_dir}/test.csv", "--image_root", f"{data_dir}/images",
        "--batch_size", "8", "--device", "cpu", "--output", str(tmp_path / "eval.json"),
        "--engine", "standard" if wire == "f32" else "fast",
    ])
    assert set(metrics["per_class"]) == {"racist", "sexist", "homophobe", "religion",
                                         "otherhate"}
    with open(os.path.join(out, "test_metrics.json")) as f:
        test = json.load(f)
    assert metrics["roc_auc_macro"] == pytest.approx(test["test_roc_macro"], abs=1e-4)


def test_mtl_run_directory_serves(mtl_run, monkeypatch):
    """``model_fn`` loads the run's best checkpoint (the port's own format)
    and ``predict_fn`` answers with the task names, on the run's wire."""
    from multimodal_content_moderation_tpu_torch.serving import handler

    wire, _, result = mtl_run
    monkeypatch.setenv("MMHARM_ENGINE", "standard" if wire == "f32" else "fast")
    classifier = handler.model_fn(result["result"]["best_checkpoint"], device="cpu")
    out = handler.predict_fn([{"text": "hate hate hate"}, {"text": ""}], classifier)
    tasks = {"racist", "sexist", "homophobe", "religion", "otherhate"}
    assert len(out) == 2 and all(set(r["probabilities"]) == tasks for r in out)
    assert all(0.0 < p < 1.0 for r in out for p in r["probabilities"].values())


def test_mtl_on_the_generic_backend_names_the_generic_slice(config_file, tmp_path):
    """The generic slice is ported (tests/test_torch_generic.py trains it on
    a VisionTextDualEncoderModel directory); ``backend: generic`` over this
    fixture's CLIP directory is refused, naming the tower it cannot read."""
    with open(config_file) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(head="mtl", backend="generic")
    path = tmp_path / "generic.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="generic backend: unsupported text tower"):
        t_train.main(["--config", str(path), "--saving.output_dir", str(tmp_path / "x"),
                      "--device", "cpu"])
