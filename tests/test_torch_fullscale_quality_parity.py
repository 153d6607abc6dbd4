"""The port's full-scale quality-parity runner
(``multimodal_content_moderation_tpu_torch/tools/run_fullscale_quality_parity.py``)
on the CPU at ``--tiny``: its encoder directories (written without
``transformers`` or ``safetensors``) load strictly into
``transformers.CLIPModel`` / ``SiglipModel`` with the same features as the
port's model and parse back to the same config; its synthetic MMHS CSVs
hold the text and label columns JAX's ``build_synthetic_mmhs`` draws; and
a tiny run goes end to end with the report's ``scale`` and
``wallclock_s``."""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import run_fullscale_quality_parity as jax_fs  # noqa: E402  (the JAX package's tool)

from multimodal_content_moderation_tpu_torch.models import clip, model_io, siglip  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.convert import read_safetensors  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.tools import _common  # noqa: E402
from multimodal_content_moderation_tpu_torch.tools import (  # noqa: E402
    run_fullscale_quality_parity as fs,
)


@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_encoder_dir_loads_strictly_into_hf(tmp_path, backend):
    d = str(tmp_path / "enc")
    cfg = fs.build_encoder(d, backend, tiny=True)
    assert model_io.load_encoder_config(d, backend) == cfg
    sd = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
          for k, v in read_safetensors(os.path.join(d, "model.safetensors")).items()}
    if backend == "clip":
        hf = transformers.CLIPModel(transformers.CLIPConfig.from_pretrained(d))
    else:
        hf = transformers.SiglipModel(transformers.SiglipConfig.from_pretrained(d))
    hf.load_state_dict(sd, strict=True)
    hf.eval()
    # the same seeded weights the tool drew, through both stacks
    model = FusionModel.create(backend, seed=0, device="cpu",
                               **_common.config_kwargs(backend, cfg))
    g = np.random.default_rng(0)
    T = 16
    ids = g.integers(1, cfg.text.vocab_size - 2, size=(2, T)).astype(np.int64)
    ids[:, T // 2] = getattr(cfg.text, "eos_token_id", 1)
    mask = np.ones((2, T), np.int64)
    px = g.normal(size=(2, 3, 224, 224)).astype(np.float32)
    t_ids, t_mask, t_px = (torch.from_numpy(x) for x in (ids, mask, px))
    with torch.no_grad():
        if backend == "clip":
            want_t = hf.get_text_features(input_ids=t_ids, attention_mask=t_mask)
            want_v = hf.get_image_features(pixel_values=t_px)
            got_t = clip.clip_text_features(model.backbone, t_ids, t_mask, cfg)
            got_v = clip.clip_image_features(model.backbone, t_px, cfg)
        else:
            want_t = hf.text_model(input_ids=t_ids).pooler_output
            want_v = hf.vision_model(pixel_values=t_px).pooler_output
            got_t = siglip.siglip_text_features(model.backbone, t_ids, None, cfg)
            got_v = siglip.siglip_image_features(model.backbone, t_px, cfg)
    torch.testing.assert_close(got_t, want_t, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_v, want_v, atol=1e-4, rtol=1e-4)


def _columns(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: [r[k] for r in rows] for k in rows[0]}


def test_synthetic_mmhs_columns_equal_jax(tmp_path):
    pytest.importorskip("pandas")
    pytest.importorskip("PIL")
    jax_fs.build_synthetic_mmhs(str(tmp_path / "jax"), 9, 4)
    fs.build_synthetic_mmhs(str(tmp_path / "port"), 9, 4)
    fixtures = list(_common.fixture_jpegs().values())
    for split in ("train", "val"):
        want = _columns(tmp_path / "jax" / f"{split}.csv")
        got = _columns(tmp_path / "port" / f"{split}.csv")
        assert got == want  # text, image_path and labels
        for img, labels in zip(got["image_path"], got["labels"]):
            n = len([x for x in labels.split(",") if x])
            assert (tmp_path / "port" / "images" / img).read_bytes() == fixtures[n]


@pytest.mark.parametrize("flags", [
    ["--backend", "clip", "--fast", "--oracle", "fp32"],
    ["--backend", "siglip", "--head", "mtl", "--fast", "--oracle", "fp32", "--int8_eval"],
    ["--backend", "clip", "--head", "mtl", "--fast", "--oracle", "reference",
     "--reference_bf16"],
], ids=["clip-fusion", "siglip-mtl-int8", "clip-mtl-witness"])
def test_tiny_run_end_to_end(tmp_path, capsys, flags):
    out = tmp_path / "report.json"
    rc = fs.main(["--tiny", "--device", "cpu", "--output", str(out), *flags])
    assert rc == 0
    report = json.loads(out.read_text())
    assert capsys.readouterr().out.rstrip().endswith("band check (+-0.005): PASS")
    assert report["steps"] == 2 * (16 // 8) and report["mode"] == "locked_fast"
    assert report["oracle_kind"] == flags[flags.index("--oracle") + 1]
    assert report["device"] == "cpu"
    assert report["scale"]["n_train"] == 16 and report["scale"]["tiny"] is True
    assert report["scale"]["vocab"] == (49408 if "clip" in flags else 1000)
    assert report["wallclock_s"] > 0
    assert ("int8_mlp" in report) == ("--int8_eval" in flags)
    assert ("reference_bf16" in report) == ("--reference_bf16" in flags)
    assert all(np.isfinite(report["losses"][side]).all() for side in ("oracle", "port"))


def test_output_defaults_under_build(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x"])
    args = fs.parse_args(["--backend", "siglip", "--fast", "--int8_eval"])
    assert args.output == os.path.join("build", "quality_parity",
                                       "quality_parity_fullscale_siglip_fast_int8.json")
    assert (args.n_train, args.n_val, args.epochs, args.batch_size) == (400, 96, 2, 8)
    assert args.device == "cuda" and args.oracle == "reference"
    assert not args.reference_bf16
    with pytest.raises(SystemExit) as e:
        fs.parse_args(["--oracle", "fp32", "--reference_bf16"])
    assert e.value.code == 2


def test_no_card_no_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as e:
        fs.main(["--tiny", "--oracle", "fp32", "--output", str(out)])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == "" and not out.exists()
