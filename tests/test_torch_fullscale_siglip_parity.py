"""Full-width SigLIP2-B/16 fusion logits at 384 px on the uint8 wire: the
port's plain path (CPU, fp32, both attention cores: "pallas" runs the
vision tower's T = 576 through ``flash_attention``'s plain version) against
JAX ``FusionModel.apply`` (its "xla" core) on the same weights (JAX init,
bridged), following tests/test_fullscale_siglip_parity.py.

Tolerance: fp32 atol 1e-4 on the logits (24 layers of the same fp32 math in
another summation order)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.model_io import (
    siglip_config_from_dict as j_config_from_dict,
)
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

MEAN = STD = (0.5, 0.5, 0.5)
# google/siglip2-base-patch16-384's config.json (the dimensions)
SIGLIP2_B16_384 = {
    "model_type": "siglip",
    "text_config": {"vocab_size": 256000, "hidden_size": 768, "num_hidden_layers": 12,
                    "num_attention_heads": 12, "intermediate_size": 3072,
                    "max_position_embeddings": 64, "hidden_act": "gelu_pytorch_tanh",
                    "layer_norm_eps": 1e-6},
    "vision_config": {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
                      "intermediate_size": 3072, "image_size": 384, "patch_size": 16,
                      "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6},
}


def siglip_logits_match_jax(config: dict, B: int = 2, atol: float = 1e-4) -> None:
    """The check itself, for any SigLIP ``config.json`` dict."""
    jcfg = j_config_from_dict(config)
    jmodel = dataclasses.replace(
        JFusion.create("siglip", num_labels=5, siglip_config=jcfg), image_mean=MEAN, image_std=STD
    )
    jparams = jmodel.init(jax.random.key(0))
    v, t = jcfg.vision, jcfg.text
    g = np.random.default_rng(0)
    ids = np.zeros((B, t.max_positions), np.int32)
    mask = np.zeros((B, t.max_positions), np.int32)
    for i, n in enumerate(np.linspace(8, t.max_positions, B).astype(int)):
        ids[i, :n] = g.integers(2, t.vocab_size, size=n)
        mask[i, :n] = 1
    imgs = g.integers(0, 256, size=(B, v.image_size, v.image_size, 3), dtype=np.uint8)
    batch = {"input_ids": ids, "attention_mask": mask,
             "patches_u8": extract_patches_u8(imgs, v.patch_size),
             "text_present": np.ones((B,), np.float32), "image_present": np.ones((B,), np.float32)}
    want = np.asarray(jmodel.apply(jparams, batch)["logits"])

    tmodel = FusionModel.create("siglip", num_labels=5, device="cpu",
                                encoder_config=model_io.siglip_config_from_dict(config))
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    for impl in ("xla", "pallas"):
        m = model_io.with_performance_options(tmodel, attention_impl=impl).replace(
            image_mean=MEAN, image_std=STD
        )
        with torch.inference_mode():
            got = m(tbatch)["logits"].numpy()
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.slow
def test_fullsize_siglip2_b16_384_fusion_logits_match_jax():
    siglip_logits_match_jax(SIGLIP2_B16_384)
