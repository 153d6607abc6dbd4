"""The port's feature-parity checker
(``multimodal_content_moderation_tpu_torch/tools/parity_check.py``) on the CPU, on a
tiny reference-format CLIP checkpoint and its encoder directory: ``PARITY OK``
and exit 0, with the port's features within 1e-5 of the JAX package's
``clip_text_features`` / ``clip_image_features`` on the tool's inputs; one
perturbed weight gives ``PARITY FAILED`` and exit 1; SigLIP and the
multi-task head are refused as JAX's tool refuses them; and without
``transformers`` the tool exits non-zero naming it."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_check as jax_pc  # noqa: E402  (the JAX package's tool)

from multimodal_content_moderation_tpu.models import model_io as jax_model_io  # noqa: E402
from multimodal_content_moderation_tpu.models.clip import (  # noqa: E402
    clip_image_features,
    clip_text_features,
)
from multimodal_content_moderation_tpu_torch.models import convert, export, model_io  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.tools import _common  # noqa: E402
from multimodal_content_moderation_tpu_torch.tools import parity_check as pc  # noqa: E402


def _clip_model(seed=0):
    return FusionModel.create("clip", seed=seed, device="cpu",
                              encoder_config=_common.encoder_config("clip", tiny=True))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(checkpoint dir, encoder dir) of one tiny CLIP fusion model."""
    root = tmp_path_factory.mktemp("parity_check")
    model = _clip_model()
    ckpt = _common.write_reference_checkpoint(model, str(root / "ckpt"), {})
    enc = _common.write_clip_encoder_dir(str(root / "enc"),
                                         _common.hf_clip_config(model.encoder_config))
    _common.write_encoder_weights(model, enc)
    return ckpt, enc


def test_parity_ok_and_features_equal_jax(assets, capsys):
    ckpt, enc = assets
    rc = pc.main(["--checkpoint", ckpt, "--encoder_dir", enc, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and out.rstrip().endswith("PARITY OK")
    model, _ = model_io.load_checkpoint(ckpt, enc, device="cpu")
    ids, mask, px = pc.inputs(model, 8)
    got_t, got_v = pc.port_features(model, ids, mask, px)
    jmodel, jparams, _ = jax_model_io.load_checkpoint(ckpt, enc)
    want_t = np.asarray(clip_text_features(jparams["backbone"], ids, mask, jmodel.clip_config))
    want_v = np.asarray(clip_image_features(jparams["backbone"], px, jmodel.clip_config))
    np.testing.assert_allclose(got_t, want_t, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=0)


def test_parity_ok_with_transformers_5_outputs(assets, monkeypatch, capsys):
    """transformers 5's ``get_*_features`` return a ``BaseModelOutputWithPooling``
    whose ``pooler_output`` holds the features; the check reads them there."""
    import transformers
    from transformers.modeling_outputs import BaseModelOutputWithPooling

    for name in ("get_text_features", "get_image_features"):
        fn = getattr(transformers.CLIPModel, name)
        monkeypatch.setattr(
            transformers.CLIPModel, name,
            lambda self, *a, _fn=fn, **k: BaseModelOutputWithPooling(
                pooler_output=_fn(self, *a, **k)))
    ckpt, enc = assets
    rc = pc.main(["--checkpoint", ckpt, "--encoder_dir", enc, "--device", "cpu"])
    assert rc == 0 and capsys.readouterr().out.rstrip().endswith("PARITY OK")


def test_perturbed_weight_fails(assets, tmp_path, capsys):
    ckpt, enc = assets
    bad = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, bad)
    path = os.path.join(bad, "model.safetensors")
    sd = convert.read_safetensors(path)
    name = "backbone.text_model.final_layer_norm.weight"
    sd[name] = np.asarray(sd[name]) + 0.5
    convert.write_safetensors(sd, path)
    rc = pc.main(["--checkpoint", bad, "--encoder_dir", enc, "--device", "cpu"])
    assert rc == 1 and capsys.readouterr().out.rstrip().endswith("PARITY FAILED")


def _refused_checkpoint(root, kind):
    """A tiny reference-format checkpoint that parity_check refuses: a SigLIP
    fusion model or a CLIP multi-task model."""
    if kind == "siglip":
        cfg = _common.encoder_config("siglip", tiny=True)
        model = FusionModel.create("siglip", seed=0, device="cpu", encoder_config=cfg)
        _common.write_siglip_encoder_dir(root, cfg)
        inference = {"backend": "siglip", "head": "fusion"}
    else:
        cfg = _common.encoder_config("clip", tiny=True)
        model = MultiTaskModel.create("clip", seed=0, device="cpu", encoder_config=cfg)
        _common.write_clip_encoder_dir(root, _common.hf_clip_config(cfg))
        inference = {"backend": "clip", "head": "mtl"}
    export.export_safetensors(model, os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "inference_config.json"), "w") as f:
        json.dump({**inference, "fusion_dim": 512, "class_names": _common.CLASSES}, f)
    return root


@pytest.mark.parametrize("kind", ["siglip", "mtl"])
def test_refuses_what_jax_refuses(tmp_path, monkeypatch, kind):
    ckpt = _refused_checkpoint(str(tmp_path / kind), kind)
    with pytest.raises(SystemExit) as port:
        pc.main(["--checkpoint", ckpt, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["parity_check.py", "--checkpoint", ckpt])
    with pytest.raises(SystemExit) as jax:
        jax_pc.main()
    assert port.value.code == jax.value.code
    assert "clip+fusion" in str(port.value.code)


def test_needs_transformers(assets, monkeypatch, capsys):
    ckpt, enc = assets
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit) as e:
        pc.main(["--checkpoint", ckpt, "--encoder_dir", enc, "--device", "cpu"])
    assert "transformers" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_no_card_exits(assets, monkeypatch, capsys):
    ckpt, enc = assets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        pc.main(["--checkpoint", ckpt, "--encoder_dir", enc])
    assert e.value.code not in (0, None)
    assert "PARITY" not in capsys.readouterr().out
