"""The port's ``evaluate_logits_u8`` against the JAX package's on the
shared ``encoder_dir`` / ``data_dir`` fixtures (same weights through the
bridge, each package's own tokenizer, images and dataset), with text
buckets off and on, rows in natural order.

Tolerance: fp32 atol 1e-4 on the logits.

Recorded (``utils/profiling.recording``), on tiny CLIP and SigLIP models,
buckets off and on: the logits equal the unrecorded ones bit for bit; each
batch gets one span of each pipeline stage, the launching thread one more
queue wait for the end, every span descends from ``score.evaluate``; the
counters hold the rows, the pads and each bucket width's batches."""

import collections

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_content_moderation_tpu.data.dataset import CSVDataset as JDataset
from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu.data.tokenizer import load_tokenizer as j_tok
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import fast_infer as jfi
from multimodal_content_moderation_tpu.models.model_io import load_encoder_config as j_enc
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models import siglip as tsig
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.utils import profiling

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("buckets", [None, (6, 8)])
def test_evaluate_logits_u8_matches_jax(encoder_dir, data_dir, buckets, impl):
    jcfg = j_enc(encoder_dir, "clip")
    jmodel = JFusion.create("clip", num_labels=5, fusion_dim=16, clip_config=jcfg)
    jparams = jmodel.init(jax.random.key(3))
    jds = JDataset(
        f"{data_dir}/test.csv", f"{data_dir}/images", j_tok(encoder_dir),
        JPre(32, 32, MEAN, STD, output="uint8_hwc"), 16, class_names=CLASSES,
    )
    jeng = jfi.FastInferenceEngine(jmodel, jparams, MEAN, STD, use_pallas=False)
    want, want_labels = jfi.evaluate_logits_u8(
        jeng, jds, batch_size=6, num_workers=2, seq_buckets=buckets
    )

    tcfg = model_io.load_encoder_config(encoder_dir, "clip")
    tmodel = model_io.build_model("fusion", "clip", CLASSES, fusion_dim=16,
                                  clip_config=tcfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    tmodel = model_io.with_performance_options(tmodel, attention_impl=impl)
    tds = CSVDataset(
        f"{data_dir}/test.csv", f"{data_dir}/images", load_tokenizer(encoder_dir),
        ImagePreprocessor(32, 32, MEAN, STD, output="uint8_hwc"), 16, class_names=CLASSES,
    )
    np.testing.assert_array_equal(tds.input_ids, jds.input_ids)
    teng = tfi.FastInferenceEngine(tmodel, MEAN, STD)
    got, labels = tfi.evaluate_logits_u8(
        teng, tds, batch_size=6, num_workers=2, seq_buckets=buckets
    )
    assert got.shape == (16, 5)  # 16 rows: a padded last batch of 4
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bucket_helpers_match_jax():
    g = np.random.default_rng(0)
    mask = np.zeros((5, 20), np.int32)
    for i, n in enumerate([3, 9, 17, 4, 12]):
        mask[i, :n] = 1
    ids = g.integers(0, 50, size=(5, 20)).astype(np.int32)
    for spec in ["auto", "off", "", "6,12, 4"]:
        assert tfi.parse_seq_buckets(spec) == jfi.parse_seq_buckets(spec)
    for buckets in [(6, 12), (32,), (4, 12, 12, 30)]:
        ladder = tfi.bucket_ladder(buckets, 20)
        assert ladder == jfi.bucket_ladder(buckets, 20)
        if ladder is None:
            continue
        for rows in [slice(0, 1), slice(0, 2), slice(None)]:
            b = tfi.bucket_for(mask[rows], ladder)
            assert b == jfi.bucket_for(mask[rows], ladder)
            for x, y in zip(tfi.bucket_batch_text(ids[rows], mask[rows], b, "clip"),
                            jfi.bucket_batch_text(ids[rows], mask[rows], b, "clip")):
                np.testing.assert_array_equal(x, y)


def _tiny_engine(backend, encoder_dir):
    if backend == "clip":
        model = model_io.build_model("fusion", "clip", CLASSES, fusion_dim=16, device="cpu",
                                     clip_config=model_io.load_encoder_config(encoder_dir, "clip"))
    else:
        tower = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
        cfg = tsig.SigLIPConfig(
            text=tsig.SigLIPTextConfig(vocab_size=600, max_positions=16, projection_size=32,
                                       **tower),
            vision=tsig.SigLIPVisionConfig(image_size=32, patch_size=8, **tower))
        model = model_io.build_model("fusion", "siglip", CLASSES, fusion_dim=16, device="cpu",
                                     siglip_config=cfg)
    return tfi.FastInferenceEngine(model, MEAN, STD)


PER_BATCH = ["prep.load", "prep.patches", "prep.bucket", "prep.pin", "pipeline.put_wait",
             "engine.call", "score.readback"]


@pytest.mark.parametrize("buckets", [None, (10, 14)])
@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_evaluate_logits_u8_recorded(encoder_dir, data_dir, tmp_path, backend, buckets):
    engine = _tiny_engine(backend, encoder_dir)
    # 1 to 16 words a row, so that the batches fall in several buckets
    rows = pd.read_csv(f"{data_dir}/test.csv")
    rows["text"] = [" ".join(["hate", "love"][i % 2] for _ in range(i + 1))
                    for i in range(len(rows))]
    rows.to_csv(tmp_path / "test.csv", index=False)
    ds = CSVDataset(
        str(tmp_path / "test.csv"), f"{data_dir}/images", load_tokenizer(encoder_dir),
        ImagePreprocessor(32, 32, MEAN, STD, output="uint8_hwc"), 16, class_names=CLASSES,
    )
    B, n = 6, len(ds)
    off, off_labels = tfi.evaluate_logits_u8(engine, ds, B, num_workers=2, seq_buckets=buckets)
    with profiling.recording() as rec:
        on, on_labels = tfi.evaluate_logits_u8(engine, ds, B, num_workers=2,
                                               seq_buckets=buckets)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on_labels, off_labels)

    batches = -(-n // B)
    names = collections.Counter(s.name for s in rec.spans)
    assert names == {"score.evaluate": 1, "score.wait_batch": batches + 1,
                     **{k: batches for k in PER_BATCH}}
    (root,) = rec.named("score.evaluate")
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert top is root, s
        launching = not s.name.startswith(("prep.", "pipeline."))
        assert (s.thread == root.thread) == launching, s

    if buckets:
        ladder = tfi.bucket_ladder(buckets, 16)
        order = np.argsort(ds.attention_mask.sum(axis=1), kind="stable")
        widths = [tfi.bucket_for(ds.attention_mask[order[i:i + B]], ladder,
                                 extra=0 if backend == "clip" else 1) for i in range(0, n, B)]
    else:
        widths = [16] * batches
    for name in PER_BATCH[:4] + PER_BATCH[5:] + ["score.wait_batch"]:
        got = sorted((s.attrs["batch"], s.attrs.get("width")) for s in rec.named(name))
        assert got[:batches] == list(enumerate(widths)), name
    assert sorted(s.attrs["batch"] for s in rec.named("pipeline.put_wait")) == list(range(batches))

    c = rec.counters
    buckets_seen = {k: v for k, v in c.items() if k.startswith("score.bucket.")}
    assert buckets_seen == {f"score.bucket.{w}": k for w, k in collections.Counter(widths).items()}
    assert sum(buckets_seen.values()) == c["score.batches"] == batches
    assert c["score.rows"] == n and c["score.pad_rows"] == batches * B - n
    assert c["score.text_tokens"] == int(ds.attention_mask.sum())
    assert c["score.text_slots"] == B * sum(widths)
    assert c["score.h2d_bytes"] > 0


@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_engine_folds_the_patch_embedding_once(encoder_dir, monkeypatch, backend):
    """The engine folds the normalisation into the patch embedding when it is
    made, not on each call; a write into that weight afterwards (a loaded
    checkpoint, say) makes the next call fold again, so its logits equal a
    new engine's."""
    from multimodal_content_moderation_tpu_torch.models import u8wire

    folds = []
    real = u8wire.fold_norm_into_embed
    monkeypatch.setattr(u8wire, "fold_norm_into_embed",
                        lambda *a, **k: folds.append(1) or real(*a, **k))
    engine = _tiny_engine(backend, encoder_dir)
    vision = engine.model.encoder_config.vision
    g = np.random.default_rng(4)
    ids = g.integers(2, 500, size=(3, 8)).astype(np.int64)
    mask = np.ones((3, 8), np.int64)
    patches = engine.patches_from_hwc(
        g.integers(0, 256, size=(3, vision.image_size, vision.image_size, 3), dtype=np.uint8))
    flags = np.ones(3, np.float32)
    run = lambda e: e(ids, mask, patches, flags, flags)  # noqa: E731
    first = run(engine)
    assert torch.equal(run(engine), first) and len(folds) == 1
    w = engine.model.backbone["vision_model"]["patch_embedding"]["w"]
    with torch.no_grad():
        w.mul_(1.5)
    moved = run(engine)
    assert len(folds) == 2 and not torch.equal(moved, first)
    assert torch.equal(moved, run(tfi.FastInferenceEngine(engine.model, MEAN, STD)))
