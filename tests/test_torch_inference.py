"""The port's ``MultiModalClassifier`` and inference CLI
(``cli/inference.py``) against the JAX package's, on tiny reference-format
checkpoints that a JAX model exported: CLIP (the ``encoder_dir`` fixture's
towers) and SigLIP (a 68-pixel image in 4-pixel patches, so its vision
tower takes ``flash_attention``'s plain version).

The same rows (tweet-like texts with empty and NA ones, the committed JPEG
fixtures, a missing file) go through both packages on the CPU in fp32:
probabilities within atol 1e-5 (the same fp32 math in another order) and
the same labels, for both engines, both attention cores, buckets on and
off, ``predict``, ``predict_batch``, the CSV mode of ``main`` and the
post-hoc logit adjustment.
"""

import json
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_content_moderation_tpu.cli import inference as j_inf
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.export import export_safetensors
from multimodal_content_moderation_tpu.models.model_io import load_encoder_config
from multimodal_content_moderation_tpu_torch.cli import inference as t_inf
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
THRESHOLDS = [0.5, 0.45, 0.5, 0.55, 0.5]
TEXTS = ["hate hate hate", "", "love love love the thing", "hate " * 12, "null", "a", "   ",
         "love", "the hate", "thing thing"]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def export_checkpoint(d, backend, enc_dir, seed=7, **extra):
    """A JAX fusion model on ``enc_dir``'s towers, exported in the reference
    format beside its inference_config.json."""
    kw = {f"{backend}_config": load_encoder_config(enc_dir, backend)}
    model = JFusion.create(backend, num_labels=5, fusion_dim=16, **kw)
    export_safetensors(model.init(jax.random.key(seed)), model, str(d / "model.safetensors"))
    cfg = {"backend": backend, "head": "fusion", "fusion_dim": 16, "class_names": CLASSES,
           "thresholds": THRESHOLDS, "max_text_length": 16, "encoder_dir": enc_dir, **extra}
    (d / "inference_config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.fixture(scope="module")
def clip_checkpoint(encoder_dir, tmp_path_factory):
    return export_checkpoint(tmp_path_factory.mktemp("inf_clip"), "clip", encoder_dir)


@pytest.fixture(scope="module")
def siglip_checkpoint(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    enc = tmp_path_factory.mktemp("inf_siglip_enc")
    words = ["<pad>", "<unk>", "hate", "love", "the", "a", "thing"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(enc / "tokenizer.json"))
    (enc / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<pad>"}))
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=16,
                         vocab_size=len(words)),
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=64, image_size=68, patch_size=4),
    )
    (enc / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    (enc / "preprocessor_config.json").write_text(json.dumps(
        {"size": {"height": 68, "width": 68}, "image_mean": [0.5] * 3, "image_std": [0.5] * 3}))
    return export_checkpoint(tmp_path_factory.mktemp("inf_siglip"), "siglip", str(enc), seed=9)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """The JPEG fixtures in one directory, and one path per row of TEXTS
    (relative names, one missing, one empty)."""
    d = tmp_path_factory.mktemp("inf_images")
    names = []
    for p in jpeg_fixtures().values():
        shutil.copy(p, d / p.name)
        names.append(p.name)
    rows = [names[i % len(names)] for i in range(len(TEXTS))]
    rows[3], rows[6] = "missing.jpg", ""
    return str(d), rows


def _probs(results):
    return np.asarray([[r["predictions"][c]["probability"] for c in CLASSES] for r in results])


def _labels(results):
    return [[r["predictions"][c]["label"] for c in CLASSES] + [r["any_harmful"]]
            for r in results]


def _compare(got, want):
    np.testing.assert_allclose(_probs(got), _probs(want), atol=ATOL, rtol=0)
    near = np.abs(_probs(want) - np.asarray(THRESHOLDS)).min() < ATOL
    if not near:
        assert _labels(got) == _labels(want)
    for g, w in zip(got, want):
        assert [p["threshold"] for p in g["predictions"].values()] == THRESHOLDS
        assert set(g) == set(w)


def _pair(ckpt, **kw):
    return (t_inf.MultiModalClassifier(ckpt, device="cpu", **kw),
            j_inf.MultiModalClassifier(ckpt, **kw))


@pytest.mark.parametrize("buckets", ["off", "6,8"])
@pytest.mark.parametrize("attention", ["xla", "pallas"])
@pytest.mark.parametrize("engine", ["standard", "fast"])
def test_clip_predict_batch_matches_jax(clip_checkpoint, images, engine, attention, buckets):
    root, paths = images
    tc, jc = _pair(clip_checkpoint, batch_size=3, engine=engine, attention=attention,
                   seq_buckets=buckets)
    assert (tc._bucket_ladder is None) == (jc._bucket_ladder is None)
    _compare(tc.predict_batch(TEXTS, paths, image_root=root),
             jc.predict_batch(TEXTS, paths, image_root=root))


@pytest.mark.parametrize("engine,buckets", [("standard", "off"), ("fast", "off"),
                                            ("fast", "6,8")])
def test_siglip_predict_batch_matches_jax(siglip_checkpoint, images, engine, buckets):
    root, paths = images
    tc, jc = _pair(siglip_checkpoint, batch_size=4, engine=engine, attention="pallas",
                   seq_buckets=buckets)
    _compare(tc.predict_batch(TEXTS, paths, image_root=root),
             jc.predict_batch(TEXTS, paths, image_root=root))


@pytest.mark.parametrize("backend", ["native", "native_scaled"])
def test_native_image_backends_match_jax(clip_checkpoint, images, backend):
    """Against JAX's pil backend: native decodes like PIL bit for bit
    (atol 1e-5); native_scaled decodes at a DCT scale (its crops within 2
    levels of PIL's on average, the JAX package's scaled-path tolerance),
    which moves these probabilities by under 1e-2."""
    root, paths = images
    tc = t_inf.MultiModalClassifier(clip_checkpoint, batch_size=4, engine="fast",
                                    image_backend=backend, device="cpu")
    jc = j_inf.MultiModalClassifier(clip_checkpoint, batch_size=4, engine="fast")
    got = tc.predict_batch(TEXTS, paths, image_root=root)
    want = jc.predict_batch(TEXTS, paths, image_root=root)
    if backend == "native":
        _compare(got, want)
    else:
        np.testing.assert_allclose(_probs(got), _probs(want), atol=1e-2, rtol=0)


def test_predict_single(clip_checkpoint, images):
    root, paths = images
    tc, jc = _pair(clip_checkpoint, engine="fast", attention="pallas")
    img = f"{root}/{paths[0]}"
    for text, image in (("hate hate hate", img), ("love", None), (None, img), (None, None)):
        got = tc.predict(text, image, return_probs=True)
        want = jc.predict(text, image, return_probs=True)
        _compare([got], [want])
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=ATOL)


def test_logit_adjustment_matches_jax(encoder_dir, images, tmp_path):
    ckpt = export_checkpoint(tmp_path, "clip", encoder_dir, use_logit_adjustment=True,
                             priors=[0.1, 0.3, 0.05, 0.2, 0.5])
    root, paths = images
    tc, jc = _pair(ckpt, batch_size=4, engine="fast")
    assert tc.logit_adjustment and tc.priors
    _compare(tc.predict_batch(TEXTS, paths, image_root=root),
             jc.predict_batch(TEXTS, paths, image_root=root))


def test_csv_mode_writes_the_jax_columns(clip_checkpoint, images, tmp_path):
    root, paths = images
    csv = tmp_path / "in.csv"
    pd.DataFrame({"id": range(len(TEXTS)), "text": TEXTS, "image_path": paths}).to_csv(
        csv, index=False)
    common = ["--checkpoint", clip_checkpoint, "--input_csv", str(csv), "--image_root", root,
              "--batch_size", "4", "--engine", "fast", "--seq_buckets", "6,8"]
    j_inf.main(common + ["--output_csv", str(tmp_path / "jax.csv")])
    t_inf.main(common + ["--output_csv", str(tmp_path / "torch.csv"), "--device", "cpu"])
    got, want = pd.read_csv(tmp_path / "torch.csv"), pd.read_csv(tmp_path / "jax.csv")
    assert list(got.columns) == list(want.columns)
    probs = [c for c in want.columns if c.startswith("prob_")]
    pd.testing.assert_frame_equal(got.drop(columns=probs), want.drop(columns=probs))
    np.testing.assert_allclose(got[probs].to_numpy(), want[probs].to_numpy(), atol=ATOL)


def test_warmup_runs_every_text_width(clip_checkpoint):
    tc, jc = _pair(clip_checkpoint, engine="fast", seq_buckets="6,8")
    assert tc._bucket_ladder == jc._bucket_ladder == [6, 8, 16]
    assert tc.warmup() == jc.warmup() == 3
    tc, jc = _pair(clip_checkpoint, engine="standard")
    assert tc.warmup() == jc.warmup() == 1


@pytest.mark.parametrize("engine,attention,want", [
    ("fast", "pallas", ["patch_embed_u8", "attention_nhd"]),
    ("fast", "xla", ["patch_embed_u8"]),
    ("standard", "pallas", ["attention_nhd"]),
    ("standard", "xla", []),
])
def test_warmup_builds_only_the_kernels_the_forward_launches(clip_checkpoint, siglip_checkpoint,
                                                             engine, attention, want):
    """CLIP's towers stay within 256 positions, so no flash_attention; the
    tiny SigLIP's vision tower runs 289 and needs it."""
    tc = t_inf.MultiModalClassifier(clip_checkpoint, device="cpu", engine=engine,
                                    attention=attention)
    assert tc.eval_kernels() == want
    sc = t_inf.MultiModalClassifier(siglip_checkpoint, device="cpu", engine=engine,
                                    attention=attention)
    assert sc.eval_kernels() == want + ["flash_attention"] * (attention == "pallas")


def test_int8_mlp_and_the_default_device(clip_checkpoint):
    """int8_mlp loads as bf16_fast with the (768, 3072) fc1 layers in int8:
    this checkpoint's towers are 32 wide, so none is quantized (the tier
    against JAX's: tests/test_torch_quant.py)."""
    tc = t_inf.MultiModalClassifier(clip_checkpoint, precision="int8_mlp", device="cpu")
    assert tc.quantized_layers == 0
    assert tc.model.encoder_config.vision.compute_dtype == "bfloat16"
    assert tc.model.encoder_config.vision.scores_dtype == "bfloat16"
    with pytest.raises(ValueError, match="precision"):
        t_inf.MultiModalClassifier(clip_checkpoint, precision="int4", device="cpu")
    if not torch.cuda.is_available():
        # the entry point runs on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_inf.MultiModalClassifier(clip_checkpoint)
