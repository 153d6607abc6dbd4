"""The port's host-side training data and encoder loading against the JAX
package's, on the shared CSV + PNG fixtures (tests/conftest.py):

- train-time augmentation (RandomResizedCrop, flip, ColorJitter) gives the
  same uint8 crops for one seed (exact: the same numpy draws and PIL ops);
- ``CSVDataset.batches(drop_last=..., indices=...)`` and ``truncate_text``
  give the same arrays (exact);
- ``init_from_encoder_dir`` fills the backbone with the encoder directory's
  weights exactly as the JAX package converts them, and ``resolve_backend``
  reads ``auto`` from its config.json."""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from multimodal_content_moderation_tpu.data.dataset import CSVDataset as JDataset
from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu.data.tokenizer import load_tokenizer as j_tokenizer
from multimodal_content_moderation_tpu.models import model_io as j_io
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.params import flatten

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]


@pytest.mark.parametrize("seed", [0, 3])
def test_augmented_crops_match_jax(seed):
    g = np.random.default_rng(seed)
    images = [Image.fromarray(g.integers(0, 256, size=(40 + 9 * i, 52 - 5 * i, 3), dtype=np.uint8))
              for i in range(4)]
    kw = dict(is_train=True, augment=True, seed=seed)
    mine = ImagePreprocessor(32, 32, **kw)
    theirs = JPre(32, 32, output="uint8_hwc", **kw)
    for im in images:
        np.testing.assert_array_equal(mine.process_pil(im), theirs.process_pil(im))
    # without augment (or outside training) the eval transform runs
    plain = ImagePreprocessor(32, 32, augment=True)
    np.testing.assert_array_equal(plain.process_pil(images[0]),
                                  JPre(32, 32, output="uint8_hwc").process_pil(images[0]))


def test_dataset_batches_and_truncate_text_match_jax(encoder_dir, data_dir):
    csv, root = os.path.join(data_dir, "train.csv"), os.path.join(data_dir, "images")
    mine = CSVDataset(csv, root, load_tokenizer(encoder_dir), ImagePreprocessor(32, 32), 16,
                      class_names=CLASSES, is_train=True)
    theirs = JDataset(csv, root, j_tokenizer(encoder_dir), JPre(32, 32, output="uint8_hwc"), 16,
                      class_names=CLASSES, is_train=True)
    longest = int(mine.attention_mask.sum(axis=1).max())
    with pytest.raises(ValueError, match="real tokens"):
        mine.truncate_text(longest - 1)
    mine.truncate_text(8)
    theirs.truncate_text(8)
    assert mine.max_len == 8
    order = np.random.default_rng(1).permutation(len(mine))
    got = list(mine.batches(6, drop_last=True, indices=order, num_workers=2))
    want = list(theirs.batches(6, drop_last=True, indices=order, num_workers=2))
    assert len(got) == len(want) == len(mine) // 6
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_init_from_encoder_dir_matches_jax(encoder_dir):
    assert model_io.resolve_backend(encoder_dir, "auto") == "clip"
    cfg = model_io.load_encoder_config(encoder_dir, "clip")
    model = model_io.build_model("fusion", "clip", CLASSES, fusion_dim=16, clip_config=cfg,
                                 device="cpu")
    before = {k: v.clone() for k, v in model.head.state_dict().items()}
    model_io.init_from_encoder_dir(model, encoder_dir)
    jmodel = j_io.build_model("fusion", "clip", CLASSES, fusion_dim=16,
                              clip_config=j_io.load_encoder_config(encoder_dir, "clip"))
    jparams = j_io.init_from_encoder_dir(jmodel, encoder_dir, jax.random.key(0))
    want = flatten(jax.tree_util.tree_map(np.asarray, jparams["backbone"]))
    got = model.backbone.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for k, v in model.head.state_dict().items():  # the head keeps its init
        np.testing.assert_array_equal(v.numpy(), before[k].numpy())
    # no weights in the directory: the model is left as it is
    assert model_io.init_from_encoder_dir(model, None) is model
