"""Full-width CLIP ViT-B/32 fusion logits on the uint8 wire: the port's
plain path (CPU, fp32, both attention cores) against JAX
``FusionModel.apply`` on the same weights (JAX init, bridged).

Tolerance: fp32 atol 1e-4 on the logits (24 layers of the same fp32 math
in another summation order)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


@pytest.mark.slow
def test_fullsize_vitb32_fusion_logits_match_jax():
    jmodel = JFusion.create("clip", num_labels=5)
    jmodel = dataclasses.replace(jmodel, image_mean=MEAN, image_std=STD)
    jparams = jmodel.init(jax.random.key(0))

    g = np.random.default_rng(0)
    B, T = 2, 77
    ids = np.full((B, T), 49407, np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, eos in enumerate([12, 40]):
        ids[i, 0] = 49406
        ids[i, 1:eos] = g.integers(1, 49406, size=eos - 1)
        mask[i, : eos + 1] = 1
    batch = {
        "input_ids": ids, "attention_mask": mask,
        "patches_u8": extract_patches_u8(
            g.integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8), 32
        ),
        "text_present": np.ones((B,), np.float32),
        "image_present": np.ones((B,), np.float32),
    }
    want = np.asarray(jmodel.apply(jparams, batch)["logits"])

    tmodel = FusionModel.create("clip", num_labels=5, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for impl in ("xla", "pallas"):
        m = model_io.with_performance_options(tmodel, attention_impl=impl).replace(
            image_mean=MEAN, image_std=STD
        )
        with torch.inference_mode():
            got = m(tbatch)["logits"].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
