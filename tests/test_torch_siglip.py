"""A tiny SigLIP fusion model in the port against the JAX package: two-layer
towers of width 32 with 2 heads, a 16-position text tower, and a 68-pixel
image cut in 4-pixel patches, so the vision tower runs T = 289 tokens and
its ``"pallas"`` attention takes ``flash_attention`` (the plain version here,
interpret mode in JAX), the text tower ``attention_nhd`` bidirectional with
a key mask, and the MAP head the single-query branch of ``mha``.

- text features, image features and fusion logits, for both attention
  cores: fp32 atol 1e-4 (24 layers' worth of the same fp32 math in another
  order), bf16 atol 3e-2 (bf16 rounding between ops);
- the bucket carry column: bucketed equals unbucketed within 8 ulp of the
  feature's largest magnitude (``assert_within_ulps``), and
  ``evaluate_logits_u8`` with buckets off and on equals JAX's (fp32 atol
  1e-4);
- ``siglip_params_from_torch`` on an HF ``SiglipModel`` built from a config
  gives the JAX converter's tree leaf for leaf, and features equal to the HF
  model's own pooled outputs (fp32 atol 1e-4);
- the evaluate CLI on a reference-format SigLIP checkpoint writes the JAX
  CLI's metrics (f1 within 1e-6, ROC-AUC within 1e-4), buckets off and on."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import fast_infer as jfi
from multimodal_content_moderation_tpu.models import siglip as jsig
from multimodal_content_moderation_tpu.models.convert import (
    siglip_params_from_torch as j_convert,
)
from multimodal_content_moderation_tpu.models.convert import to_dtype as j_to_dtype
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models import siglip as tsig
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.convert import siglip_params_from_torch
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.models.u8wire import embed_for_model

MEAN = STD = (0.5, 0.5, 0.5)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_positions=16, projection_size=32)
VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
              image_size=68, patch_size=4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs():
    jcfg = jsig.SigLIPConfig(text=jsig.SigLIPTextConfig(**TEXT),
                             vision=jsig.SigLIPVisionConfig(**VISION))
    tcfg = tsig.SigLIPConfig(text=tsig.SigLIPTextConfig(**TEXT),
                             vision=tsig.SigLIPVisionConfig(**VISION))
    return jcfg, tcfg


def _pair(seed=0, num_labels=3):
    """The same tiny model in both packages (JAX init, bridged weights)."""
    jcfg, tcfg = _configs()
    jmodel = JFusion.create("siglip", num_labels=num_labels, fusion_dim=16, siglip_config=jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = FusionModel.create("siglip", num_labels=num_labels, fusion_dim=16,
                                siglip_config=tcfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _text(g, B, T, lengths):
    """Right-padded ids (PAD id 0 past each row) and masks."""
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = g.integers(1, 63, size=n)
        mask[i, :n] = 1
    return ids, mask


def _batch(B=4, seed=0):
    g = np.random.default_rng(seed)
    ids, mask = _text(g, B, 16, [3, 9, 16, 6][:B])
    imgs = g.integers(0, 256, size=(B, 68, 68, 3), dtype=np.uint8)
    tp = np.ones((B,), np.float32)
    ip = np.ones((B,), np.float32)
    tp[1] = 0.0  # text absent
    ip[2] = 0.0  # image absent
    return {"input_ids": ids, "attention_mask": mask, "patches_u8": extract_patches_u8(imgs, 4),
            "text_present": tp, "image_present": ip}


def _with(jmodel, **kw):
    c = jmodel.siglip_config
    return dataclasses.replace(
        jmodel, image_mean=MEAN, image_std=STD,
        siglip_config=dataclasses.replace(
            c, text=dataclasses.replace(c.text, **kw), vision=dataclasses.replace(c.vision, **kw)
        ),
    )


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_siglip_fusion_logits_match_jax(impl, dtype):
    jmodel, jparams, tmodel = _pair()
    batch = _batch()
    jm = _with(jmodel, compute_dtype=dtype, attention_impl=impl)
    jp = jparams if dtype == "float32" else j_to_dtype(jparams, jnp.bfloat16)
    want = np.asarray(jm.apply(jp, batch)["logits"]).astype(np.float32)

    tm = model_io.with_performance_options(
        tmodel, compute_dtype=dtype, attention_impl=impl
    ).replace(image_mean=MEAN, image_std=STD).to(getattr(torch, dtype))
    with torch.inference_mode():
        got = tm(_torch_batch(batch))["logits"]
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_siglip_features_match_jax(impl):
    jmodel, jparams, tmodel = _pair(seed=1)
    batch = _batch(seed=1)
    jm = _with(jmodel, attention_impl=impl)
    tm = model_io.with_performance_options(tmodel, attention_impl=impl).replace(
        image_mean=MEAN, image_std=STD)
    jb = jparams["backbone"]
    want_t = np.asarray(jsig.siglip_text_features(
        jb, batch["input_ids"], batch["attention_mask"], jm.siglip_config))
    want_v = np.asarray(jsig.siglip_image_features_from_tokens(
        jb, jm._embed_u8(jb, jnp.asarray(batch["patches_u8"])), jm.siglip_config))
    tb = _torch_batch(batch)
    with torch.inference_mode():
        got_t = tsig.siglip_text_features(tm.backbone, tb["input_ids"], tb["attention_mask"],
                                          tm.siglip_config).numpy()
        tokens = embed_for_model(tm, tm.backbone, tb["patches_u8"])
        assert tokens.shape == (4, 289, 32)
        got_v = tsig.siglip_image_features_from_tokens(tm.backbone, tokens,
                                                       tm.siglip_config).numpy()
    np.testing.assert_allclose(got_t, want_t, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_v, want_v, atol=1e-4, rtol=0)


def test_siglip_weights_bridge():
    """JAX params as numpy -> the port: the same paths, leaf for leaf."""
    _, jparams, tmodel = _pair(seed=2)
    flat = flatten(jax.tree_util.tree_map(np.asarray, jparams))
    sd = tmodel.state_dict()
    assert set(sd) == set(flat)
    for name, want in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
    assert sd["backbone.vision_model.map_head.probe"].shape == (1, 1, 32)
    assert sd["backbone.logit_bias"].shape == ()


def assert_within_ulps(cut, full, ulps=8):
    """A bucketed feature against its full-width one: every element within
    ``ulps`` units in the last place of ``max|full|``, rtol 0. The ops are
    the same, but the CPU GEMM blocks a product by its width: ``q k^T`` over
    the same q and k rows, at 8 keys and at 12, differs by 9.5e-7 on the
    rows both share (the reduction length, the head width, is the same).
    The carry column inherits that: about 4.5 ulp of a feature whose
    largest element is 2.29. An elementwise rtol would ask a small element
    for a precision that the vector's large terms set."""
    bound = ulps * float(np.spacing(np.float32(np.abs(full).max())))
    np.testing.assert_allclose(cut, full, atol=bound, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_siglip_text_carry_column_exact(impl):
    """b-1 real columns plus a PAD carry column at the full width's last
    position (mask 0) give the full-width pooled text feature, in the port as
    in the JAX package (tests/test_fast_infer.py)."""
    jmodel, jparams, tmodel = _pair(seed=8)
    g = np.random.default_rng(8)
    B, T = 4, 12  # T < max_positions: the carry must use position T-1
    ids, mask = _text(g, B, T, [3, 5, 6, 7])
    cfg = model_io.with_performance_options(tmodel, attention_impl=impl).siglip_config
    with torch.inference_mode():
        full = tsig.siglip_text_features(tmodel.backbone, torch.from_numpy(ids),
                                         torch.from_numpy(mask), cfg).numpy()
        b = 8  # covers the longest row (7) plus the carry column
        ids_b, mask_b, carry_pos = tfi.bucket_batch_text(ids, mask, b, "siglip")
        assert carry_pos == T - 1 and ids_b.shape == (B, b) and mask_b[:, -1].sum() == 0
        pos = torch.cat([torch.arange(b - 1), torch.tensor([carry_pos])])
        cut = tsig.siglip_text_features(tmodel.backbone, torch.from_numpy(ids_b),
                                        torch.from_numpy(mask_b), cfg, position_ids=pos).numpy()
    assert_within_ulps(cut, full)
    want = np.asarray(jsig.siglip_text_features(jparams["backbone"], ids, mask,
                                                _with(jmodel, attention_impl=impl).siglip_config))
    np.testing.assert_allclose(full, want, atol=1e-4, rtol=0)
    for x, y in zip(tfi.bucket_batch_text(ids, mask, b, "siglip"),
                    jfi.bucket_batch_text(ids, mask, b, "siglip")):
        np.testing.assert_array_equal(x, y)
    assert tfi.bucket_for(mask, [8, 12], extra=1) == jfi.bucket_for(mask, [8, 12], extra=1) == 8


class _Rows:
    """Seeded uint8 68x68 crops and right-padded ids with the ``.batches()``
    contract of ``data.dataset.CSVDataset`` (what both packages'
    ``evaluate_logits_u8`` read)."""

    def __init__(self, n, seed):
        g = np.random.default_rng(seed)
        self.input_ids, self.attention_mask = _text(g, n, 16, g.integers(1, 16, size=n))
        self.images = g.integers(0, 256, size=(n, 68, 68, 3), dtype=np.uint8)
        self.labels = (g.random((n, 3)) < 0.4).astype(np.float32)
        self.present = np.ones((n,), np.float32)

    def __len__(self):
        return len(self.input_ids)

    def batches(self, batch_size, pad_to_batch=False, num_workers=0, indices=None, **_):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            batch = {"input_ids": self.input_ids[idx], "attention_mask": self.attention_mask[idx],
                     "pixel_values": self.images[idx], "text_present": self.present[idx],
                     "image_present": self.present[idx], "labels": self.labels[idx]}
            valid = len(idx)
            if pad_to_batch:
                batch = {k: np.concatenate([v, np.zeros((batch_size - valid,) + v.shape[1:],
                                                        v.dtype)]) for k, v in batch.items()}
                batch["_valid"] = np.int32(valid)
            yield batch


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_siglip_evaluate_logits_u8_buckets_match_jax(impl):
    jmodel, jparams, tmodel = _pair(seed=3)
    rows = _Rows(13, seed=3)  # a padded last batch of 5
    jeng = jfi.FastInferenceEngine(_with(jmodel, attention_impl=impl), jparams, MEAN, STD,
                                   use_pallas=False)
    teng = tfi.FastInferenceEngine(model_io.with_performance_options(tmodel, attention_impl=impl),
                                   MEAN, STD)
    got = {}
    for buckets in (None, (6, 8)):
        want, want_labels = jfi.evaluate_logits_u8(jeng, rows, 8, num_workers=0,
                                                   seq_buckets=buckets)
        got[buckets], labels = tfi.evaluate_logits_u8(teng, rows, 8, num_workers=0,
                                                      seq_buckets=buckets)
        assert got[buckets].shape == (13, 3)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_allclose(got[buckets], want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[(6, 8)], got[None], atol=1e-5, rtol=1e-5)


def _hf_siglip(transformers, **text_kw):
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=16, vocab_size=64,
                         **text_kw),
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=64, image_size=68, patch_size=4),
    )
    torch.manual_seed(0)
    return hf_cfg, transformers.SiglipModel(hf_cfg).eval()


def test_siglip_params_from_torch_matches_jax_and_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg, hf = _hf_siglip(transformers)
    sd = hf.state_dict()
    tcfg = model_io.siglip_config_from_dict(hf_cfg.to_dict())
    assert tcfg.vision.image_size == 68 and tcfg.text.hidden_act == "gelu_pytorch_tanh"
    got = flatten(siglip_params_from_torch(sd, tcfg))
    jtree = j_convert({k: v.numpy() for k, v in sd.items()}, jsig.SigLIPConfig.from_hf(hf_cfg))
    want = flatten(jtree)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), err_msg=name)

    # the converted backbone in a fusion model: logits equal to JAX's on
    # JAX's convert of the same state dict, features equal to HF's pooling
    jmodel, jparams, tmodel = _pair(seed=4)
    tmodel.load_state_dict({**tmodel.state_dict(), **{f"backbone.{k}": v for k, v in got.items()}})
    tmodel = tmodel.replace(image_mean=MEAN, image_std=STD)
    jparams = {**jparams, "backbone": jax.tree_util.tree_map(jnp.asarray, jtree)}
    batch = _batch(seed=4)
    want_logits = np.asarray(_with(jmodel).apply(jparams, batch)["logits"])
    tb = _torch_batch(batch)
    with torch.inference_mode():
        np.testing.assert_allclose(tmodel(tb)["logits"].numpy(), want_logits, atol=1e-4, rtol=0)
        t, v = tmodel.encode(tb)
        hf_t = hf.text_model(input_ids=tb["input_ids"].long(),
                             attention_mask=tb["attention_mask"]).pooler_output
        pixels = torch.from_numpy(np.ascontiguousarray(
            _batch(seed=4)["patches_u8"].reshape(4, 17, 17, 3, 4, 4)
            .transpose(0, 3, 1, 4, 2, 5).reshape(4, 3, 68, 68))).float() / 255.0
        hf_v = hf.vision_model(pixel_values=(pixels - 0.5) / 0.5).pooler_output
    np.testing.assert_allclose(t.numpy(), hf_t.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), hf_v.numpy(), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def siglip_checkpoint(tmp_path_factory):
    """A tiny but complete SigLIP encoder directory (config.json, a
    WordLevel tokenizer.json, preprocessor_config.json) and a
    reference-format fusion checkpoint of a JAX model on it."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    from multimodal_content_moderation_tpu.models.export import export_safetensors
    from multimodal_content_moderation_tpu.models.model_io import load_encoder_config

    enc = tmp_path_factory.mktemp("siglip_enc")
    words = ["<pad>", "<unk>", "hate", "love", "the", "a", "thing"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(enc / "tokenizer.json"))
    (enc / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<pad>"}))
    hf_cfg, _ = _hf_siglip(transformers)
    hf_cfg.text_config.vocab_size = len(words)
    (enc / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    (enc / "preprocessor_config.json").write_text(json.dumps(
        {"size": {"height": 68, "width": 68}, "image_mean": list(MEAN), "image_std": list(STD)}))

    ckpt = tmp_path_factory.mktemp("siglip_ckpt")
    model = JFusion.create("siglip", num_labels=5, fusion_dim=16,
                           siglip_config=load_encoder_config(str(enc), "siglip"))
    export_safetensors(model.init(jax.random.key(9)), model, str(ckpt / "model.safetensors"))
    (ckpt / "inference_config.json").write_text(json.dumps({
        "backend": "siglip", "head": "fusion", "fusion_dim": 16, "class_names": CLASSES,
        "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5], "max_text_length": 16,
        "encoder_dir": str(enc),
    }))
    return str(ckpt)


@pytest.mark.parametrize("buckets", ["off", "6,8"])
def test_siglip_evaluate_cli_matches_jax(siglip_checkpoint, data_dir, tmp_path, buckets):
    from multimodal_content_moderation_tpu.cli import evaluate as j_eval
    from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

    common = ["--checkpoint", siglip_checkpoint, "--test_csv", f"{data_dir}/test.csv",
              "--image_root", f"{data_dir}/images", "--batch_size", "8", "--engine", "fast",
              "--seq_buckets", buckets, "--attention", "pallas", "--device", "cpu"]
    want = j_eval.main(common + ["--output", str(tmp_path / "jax.json")])
    got = t_eval.main(common + ["--output", str(tmp_path / "torch.json")])
    with open(tmp_path / "torch.json") as f:
        assert json.load(f)["f1_macro"] == got["f1_macro"]
    assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-6)
    assert got["f1_micro"] == pytest.approx(want["f1_micro"], abs=1e-6)
    assert got["roc_auc_macro"] == pytest.approx(want["roc_auc_macro"], abs=1e-4)
    for name in CLASSES:
        g, w = got["per_class"][name], want["per_class"][name]
        assert g["support"] == w["support"]
        assert g["f1_calibrated"] == pytest.approx(w["f1_calibrated"], abs=1e-6)
        assert g["roc_auc"] == pytest.approx(w["roc_auc"], abs=1e-4)
