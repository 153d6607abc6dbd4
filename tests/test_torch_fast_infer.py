"""The port's ``evaluate_logits_u8`` against the JAX package's on the
shared ``encoder_dir`` / ``data_dir`` fixtures (same weights through the
bridge, each package's own tokenizer, images and dataset), with text
buckets off and on, rows in natural order.

Tolerance: fp32 atol 1e-4 on the logits."""

import jax
import numpy as np
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
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params

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
