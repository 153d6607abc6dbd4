"""The port's containerized training entrypoint (``serving/entrypoint.py``)
against the JAX package's.

- ``find_data_file`` and ``find_image_root`` as tests/test_serving.py:278-291
  holds JAX's, each answer equal to JAX's.
- The same ``SM_*`` channels and flat flags give a ``resolved_config.yaml``
  equal byte for byte to JAX's (``yaml.safe_dump``), with both packages'
  train CLI ``main`` replaced by a stub so that JAX trains nothing, and the
  same ``final_metrics.json``; the port's ``hyperparameters.json`` is JAX's
  plus its own two flags, ``--device`` and ``--image-backend``.
- The port's entrypoint trains for real on the CPU from ``SM_CHANNEL_*``
  (channels made by ``deploy.prepare_training_data`` from the tiny CSV +
  PNG fixture, the tiny CLIP encoder dir of tests/conftest.py) with yaml
  hidden, and writes the three artifacts and the run directory.
"""

import json
import os
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

from multimodal_content_moderation_tpu.serving import entrypoint as je
from multimodal_content_moderation_tpu_torch.serving import entrypoint as te
from multimodal_content_moderation_tpu_torch.serving.deploy import prepare_training_data


def test_find_data_file_priority(tmp_path):
    (tmp_path / "other.csv").write_text("text\n")
    (tmp_path / "data.csv").write_text("text\n")
    for m in (je, te):
        assert m.find_data_file(str(tmp_path)).endswith("data.csv")
    os.remove(tmp_path / "data.csv")
    (tmp_path / "b.csv").write_text("text\n")
    assert te.find_data_file(str(tmp_path)) == je.find_data_file(str(tmp_path))
    assert te.find_data_file(str(tmp_path)).endswith("b.csv")
    (tmp_path / "val.csv").write_text("text\n")
    names = ("data.csv", "val.csv", "validation.csv")
    assert te.find_data_file(str(tmp_path), names).endswith("val.csv")
    for d in (str(tmp_path / "missing"), "", None):
        assert te.find_data_file(d) is None and je.find_data_file(d) is None


def test_find_image_root(tmp_path):
    imgs = tmp_path / "images"
    imgs.mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(imgs / "a.jpg")
    assert te.find_image_root(str(tmp_path)) == je.find_image_root(str(tmp_path)) == str(imgs)
    flat = tmp_path / "flat"
    flat.mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(flat / "b.png")
    empty = tmp_path / "empty"
    (empty / "images").mkdir(parents=True)
    for args in [(str(flat),), ("", str(empty), str(flat)), (str(empty),),
                 (str(tmp_path / "nothing"),), ("",), ()]:
        assert te.find_image_root(*args) == je.find_image_root(*args), args


def _channels(root, data_dir):
    ch = prepare_training_data(f"{data_dir}/train.csv", f"{data_dir}/val.csv",
                               str(root / "channels"), test_csv=f"{data_dir}/test.csv",
                               image_dir=f"{data_dir}/images")
    return ch


def _sm_env(monkeypatch, ch, root, encoder_dir):
    env = {"SM_CHANNEL_TRAIN": ch["train"], "SM_CHANNEL_VALIDATION": ch["validation"],
           "SM_CHANNEL_TEST": ch["test"], "SM_CHANNEL_IMAGES": ch["images"],
           "SM_CHANNEL_ENCODER": encoder_dir, "SM_MODEL_DIR": str(root / "model"),
           "SM_OUTPUT_DATA_DIR": str(root / "output")}
    for k, v in env.items():
        monkeypatch.setenv(k, v)


FLAGS = [
    [],
    ["--backend", "auto", "--lr-encoder", "2e-5", "--lr-head", "0.001", "--max-steps", "3",
     "--class-names", "racist, sexist,,otherhate", "--loss-type", "focal", "--augment",
     "--head", "mtl", "--head-hidden-dim", "256", "--learnable-task-weights",
     "--sampler", "weighted", "--warmup-ratio", "0", "--seed", "7"],
    ["--backend", "siglip", "--encoder-name", "google/siglip2-base-patch16-224",
     "--max-text-length", "64", "--batch-size", "24", "--weight-decay", "1e-2",
     "--early-stopping-patience", "0"],
]


@pytest.mark.parametrize("flags", FLAGS, ids=["defaults", "mtl-auto", "siglip"])
def test_resolved_config_equals_jax(flags, tmp_path, data_dir, encoder_dir, monkeypatch):
    from multimodal_content_moderation_tpu.cli import train as j_train_cli
    from multimodal_content_moderation_tpu_torch.cli import train as t_train_cli

    ch = _channels(tmp_path, data_dir)
    _sm_env(monkeypatch, ch, tmp_path, encoder_dir)
    seen = []

    def stub(argv):
        seen.append(argv)
        return {"val": {"roc_macro": 0.75, "loss": 0.5}}

    monkeypatch.setattr(j_train_cli, "main", stub)
    monkeypatch.setattr(t_train_cli, "main", stub)
    out = tmp_path / "output"
    je.train(flags)
    want = {n: (out / n).read_text() for n in
            ("resolved_config.yaml", "hyperparameters.json", "final_metrics.json")}
    te.train(flags + ["--device", "cpu"])
    got = {n: (out / n).read_text() for n in want}
    assert got["resolved_config.yaml"] == want["resolved_config.yaml"]
    assert got["final_metrics.json"] == want["final_metrics.json"]
    assert json.loads(got["hyperparameters.json"]) == {
        **json.loads(want["hyperparameters.json"]), "device": "cpu", "image_backend": None}
    cfg_path = str(out / "resolved_config.yaml")
    assert seen == [["--config", cfg_path], ["--config", cfg_path, "--device", "cpu"]]
    cfg = yaml.safe_load(want["resolved_config.yaml"])
    assert cfg["data"]["train_csv"] == os.path.join(ch["train"], "data.csv")
    assert cfg["data"]["image_root"] == ch["images"]
    assert isinstance(cfg["training"]["lr_encoder"], float)


def test_entrypoint_needs_train_and_val_csvs(tmp_path):
    with pytest.raises(FileNotFoundError, match="train/val CSV"):
        te.train(["--train-dir", str(tmp_path / "none"), "--validation-dir", str(tmp_path),
                  "--output-data-dir", str(tmp_path / "o"), "--device", "cpu"])


def test_entrypoint_trains_without_yaml(tmp_path, data_dir, encoder_dir, monkeypatch):
    ch = _channels(tmp_path, data_dir)
    _sm_env(monkeypatch, ch, tmp_path, encoder_dir)
    monkeypatch.setitem(sys.modules, "yaml", None)
    out = te.train(["--max-steps", "2", "--batch-size", "8", "--eval-batch-size", "8",
                    "--max-text-length", "16", "--fusion-dim", "16", "--epochs", "1",
                    "--image-backend", "native", "--device", "cpu"])
    outdir, model = tmp_path / "output", tmp_path / "model"
    for name in ("resolved_config.yaml", "hyperparameters.json", "final_metrics.json"):
        assert (outdir / name).exists(), name
    assert json.loads((outdir / "final_metrics.json").read_text()) == out["val"]
    assert np.isfinite(out["val"]["loss"]) and out["result"]["global_step"] == 2
    hp = json.loads((outdir / "hyperparameters.json").read_text())
    assert hp["max_steps"] == 2 and hp["device"] == "cpu"
    resolved = (outdir / "resolved_config.yaml").read_text()
    assert "  image_backend: native\n" in resolved and "  lr_encoder: 1.0e-05\n" in resolved
    cfg = json.loads((model / "inference_config.json").read_text())
    assert cfg["format"] == "torch" and cfg["encoder_dir"] == encoder_dir
    assert os.path.isdir(cfg["best_checkpoint_dir"])
    assert (model / "test_metrics.json").exists()
