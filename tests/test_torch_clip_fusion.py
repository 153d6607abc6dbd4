"""Tiny CLIP fusion logits on the uint8 wire: the port (weights carried
across by the bridge) against JAX ``FusionModel.apply``.

Tolerances: fp32 atol 1e-4 (two-layer towers and the head, same math in
another summation order); bf16 atol 3e-2 (bf16 rounding between ops)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.models import CLIPConfig as JCLIPConfig
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig as JText
from multimodal_content_moderation_tpu.models.clip import CLIPVisionConfig as JVision
from multimodal_content_moderation_tpu.models.clip import clip_text_features as j_text_features
from multimodal_content_moderation_tpu.models.convert import to_dtype as j_to_dtype
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.models import clip as tclip
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from test_torch_siglip import assert_within_ulps

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_positions=12, eos_token_id=63)
VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
              image_size=32, patch_size=16)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seed=0):
    """The same tiny model in both packages (JAX init, bridged weights)."""
    jcfg = JCLIPConfig(text=JText(**TEXT), vision=JVision(**VISION), projection_dim=32)
    jmodel = JFusion.create("clip", num_labels=3, fusion_dim=16, clip_config=jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tcfg = tclip.CLIPConfig(
        text=tclip.CLIPTextConfig(**TEXT), vision=tclip.CLIPVisionConfig(**VISION),
        projection_dim=32,
    )
    tmodel = FusionModel.create("clip", num_labels=3, fusion_dim=16, clip_config=tcfg,
                                device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _batch(B=4, T=12, seed=0):
    g = np.random.default_rng(seed)
    ids = np.full((B, T), 63, np.int32)
    mask = np.zeros((B, T), np.int32)
    for i in range(B):
        n = 3 + (5 * i) % (T - 3)  # EOS at n-1
        ids[i, : n - 1] = g.integers(1, 62, size=n - 1)
        mask[i, :n] = 1
    imgs = g.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    tp = np.ones((B,), np.float32)
    ip = np.ones((B,), np.float32)
    tp[1] = 0.0  # text absent
    ip[2] = 0.0  # image absent
    return {
        "input_ids": ids, "attention_mask": mask,
        "patches_u8": extract_patches_u8(imgs, 16), "text_present": tp, "image_present": ip,
    }


def _with(jmodel, **kw):
    c = jmodel.clip_config
    return dataclasses.replace(
        jmodel,
        image_mean=MEAN, image_std=STD,
        clip_config=dataclasses.replace(
            c, text=dataclasses.replace(c.text, **kw), vision=dataclasses.replace(c.vision, **kw)
        ),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fusion_logits_match_jax(impl, dtype):
    jmodel, jparams, tmodel = _pair()
    batch = _batch()
    jm = _with(jmodel, compute_dtype=dtype, attention_impl=impl)
    jp = jparams if dtype == "float32" else j_to_dtype(jparams, jnp.bfloat16)
    want = np.asarray(jm.apply(jp, batch)["logits"]).astype(np.float32)

    tm = model_io.with_performance_options(
        tmodel, compute_dtype=dtype, attention_impl=impl
    ).replace(image_mean=MEAN, image_std=STD).to(getattr(torch, dtype))
    with torch.inference_mode():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})["logits"]
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


def test_clip_text_truncation_exact():
    """Slicing padded ids to any length >= the EOS position leaves the
    pooled text feature unchanged (causal mask + EOS pooling), in the port
    as in the JAX package."""
    jmodel, jparams, tmodel = _pair(seed=5)
    g = np.random.default_rng(5)
    B, T = 4, 12
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate([3, 5, 7, 8]):  # EOS at n-1, all < bucket 8
        ids[i, : n - 1] = g.integers(1, 62, size=n - 1)
        ids[i, n - 1] = 63
        mask[i, :n] = 1
    cfg = tmodel.clip_config
    with torch.inference_mode():
        full = tclip.clip_text_features(
            tmodel.backbone, torch.from_numpy(ids), torch.from_numpy(mask), cfg
        ).numpy()
        cut = tclip.clip_text_features(
            tmodel.backbone, torch.from_numpy(ids[:, :8]), torch.from_numpy(mask[:, :8]), cfg
        ).numpy()
    assert_within_ulps(cut, full)
    want = np.asarray(j_text_features(jparams["backbone"], ids, mask, jmodel.clip_config))
    np.testing.assert_allclose(full, want, atol=1e-5, rtol=0)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusionModel.create("clip", clip_config=tclip.CLIPConfig(
            text=tclip.CLIPTextConfig(**TEXT), vision=tclip.CLIPVisionConfig(**VISION),
        ))
