"""The port's stdlib reader of the safetensors format
(``models/convert.read_safetensors``), which ``load_safetensors`` falls
back to where the ``safetensors`` package is missing (the card machine).

- every dtype against ``safetensors.numpy.load_file`` (F32, F16, I64, I32,
  U8, BOOL, an empty tensor and a scalar): the same dtype, shape and values,
  exactly; BF16, which numpy lacks, against ``safetensors.torch.load_file``;
- a file whose offsets do not fit its shapes raises;
- a reference-format ``model.safetensors`` written by the JAX package's
  ``export_safetensors`` loads through ``load_checkpoint`` with
  ``safetensors`` hidden from ``sys.modules``: the same parameters and
  logits (difference 0.0) as with the package, and JAX's logits within
  fp32 atol 1e-5."""

import dataclasses
import json
import struct
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file as np_save
from safetensors.torch import load_file as torch_load
from safetensors.torch import save_file as torch_save

from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.export import export_safetensors
from multimodal_content_moderation_tpu.models.model_io import load_encoder_config
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.models import convert, model_io

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
ARRAYS = {
    "F32": np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32),
    "F16": np.random.default_rng(1).normal(size=(5,)).astype(np.float16),
    "I64": np.arange(-3, 9, dtype=np.int64).reshape(2, 2, 3),
    "I32": np.arange(7, dtype=np.int32) * -5,
    "U8": np.arange(250, 256, dtype=np.uint8).reshape(3, 2),
    "BOOL": np.array([[True, False], [False, True]]),
    "empty": np.zeros((0, 3), np.float32),
    "scalar": np.array(2.5, np.float32),
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_reader_matches_safetensors_numpy(name, tmp_path):
    path = str(tmp_path / "x.safetensors")
    # the tensor beside others, so that its data starts past offset 0
    np_save({"a_first": np.ones(3, np.int8), name: ARRAYS[name], "z_last": np.ones(2)}, path,
            metadata={"format": "np"})
    got, want = convert.read_safetensors(path), np_load(path)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w)


def test_reader_reads_bf16_as_torch(tmp_path):
    path = str(tmp_path / "x.safetensors")
    want = {"w": torch.randn(3, 5).bfloat16(), "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
            "f": torch.arange(4.0)}
    torch_save(want, path)
    got = convert.read_safetensors(path)
    for k, w in torch_load(path).items():
        if w.dtype == torch.bfloat16:
            assert isinstance(got[k], torch.Tensor), k
        t = torch.as_tensor(got[k])
        assert t.dtype == w.dtype and t.shape == w.shape, k
        assert torch.equal(t, w), k


def test_reader_refuses_offsets_that_do_not_fit(tmp_path):
    header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(12))
    with pytest.raises(ValueError, match="data_offsets"):
        convert.read_safetensors(str(path))


@pytest.fixture(scope="module")
def jax_checkpoint(encoder_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_export")
    model = JFusion.create(
        "clip", num_labels=5, fusion_dim=16, clip_config=load_encoder_config(encoder_dir, "clip"))
    params = model.init(jax.random.key(3))
    export_safetensors(params, model, str(d / "model.safetensors"))
    (d / "inference_config.json").write_text(json.dumps({
        "backend": "clip", "head": "fusion", "fusion_dim": 16, "class_names": CLASSES,
        "max_text_length": 16, "encoder_dir": encoder_dir}))
    return str(d), model, params


def test_jax_export_loads_without_the_safetensors_package(jax_checkpoint, monkeypatch):
    ckpt, jmodel, jparams = jax_checkpoint
    g = np.random.default_rng(0)
    B, T = 3, 16
    ids = g.integers(1, 60, size=(B, T)).astype(np.int32)
    ids[:, 9] = jmodel.clip_config.text.eos_token_id
    mask = (np.arange(T)[None, :] <= 9).astype(np.int32).repeat(B, 0)
    crops = g.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    batch = {"input_ids": ids, "attention_mask": mask, "text_present": np.ones(B, np.float32),
             "image_present": np.ones(B, np.float32),
             "patches_u8": extract_patches_u8(crops, 16)}
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)

    def logits(model):
        with torch.inference_mode():
            m = model.replace(image_mean=mean, image_std=std)
            return m({k: torch.from_numpy(v) for k, v in batch.items()})["logits"].numpy()

    with_pkg, _ = model_io.load_checkpoint(ckpt, device="cpu")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError):
        import safetensors.numpy  # noqa: F401
    without, _ = model_io.load_checkpoint(ckpt, device="cpu")
    for (name, a), b in zip(with_pkg.state_dict().items(), without.state_dict().values()):
        assert torch.equal(a, b), name
    got = logits(without)
    np.testing.assert_array_equal(got, logits(with_pkg))
    jm = dataclasses.replace(jmodel, image_mean=mean, image_std=std)
    np.testing.assert_allclose(got, np.asarray(jm.apply(jparams, batch)["logits"]), atol=1e-5,
                               rtol=0)
