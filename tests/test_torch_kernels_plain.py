"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode), on the same seeded numpy inputs.

Tolerances: fp32 atol 1e-5 (the same fp32 math, summed in another order);
bf16 atol 2e-2 (inputs and outputs rounded to bf16, 1 ulp at |x| < 4 is
2^-6 = 1.6e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import pallas_attention as jattn
from multimodal_content_moderation_tpu.ops import pallas_image as jimg
from multimodal_content_moderation_tpu_torch.ops import cuda_attention as tattn
from multimodal_content_moderation_tpu_torch.ops import cuda_image as timg

NEG_INF = -3.4028235e38
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tt(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,p,D,bias", [(2, 4, 4, 32, True), (3, 7, 6, 40, False)])
def test_patch_embed_reference_matches_jax(B, N, p, D, bias, dtype):
    K = 3 * p * p
    g = np.random.default_rng(7)
    patches = g.integers(0, 256, size=(B, N, K), dtype=np.uint8)
    w = (g.normal(size=(K, D)) * 0.05).astype(np.float32)
    b = g.normal(size=(D,)).astype(np.float32) if bias else None
    mean, std = (0.48, 0.46, 0.41), (0.27, 0.26, 0.28)
    wf, bf = jimg.fold_norm_into_embed(jnp.asarray(w), None if b is None else jnp.asarray(b),
                                       mean, std, p, 3)
    want = np.asarray(
        jimg.patch_embed_u8(patches, wf, bf, out_dtype=jnp.dtype(dtype), interpret=True)
    ).astype(np.float32)

    twf, tbf = timg.fold_norm_into_embed(
        torch.from_numpy(w), None if b is None else torch.from_numpy(b), mean, std, p, 3
    )
    np.testing.assert_allclose(twf.numpy(), np.asarray(wf), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbf.numpy(), np.asarray(bf), rtol=1e-5, atol=1e-5)
    got = timg.patch_embed_u8(torch.from_numpy(patches), twf, tbf, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, D)
    # bf16 outputs reach |x| ~ 10 here: 1 ulp there is 2^-4
    tol = TOL[dtype] if dtype == "float32" else 6.25e-2
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=1e-5 if dtype == "float32" else 8e-3)


def test_extract_patches_matches_jax():
    g = np.random.default_rng(1)
    imgs = g.integers(0, 256, size=(2, 32, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        timg.extract_patches_u8(imgs, 16), jimg.extract_patches_u8(imgs, 16)
    )


def _attention_inputs(B, T, D, mask_kind, seed=11, all_masked_row=True):
    g = np.random.default_rng(seed)
    q, k, v = (g.normal(size=(B, T, D)).astype(np.float32) for _ in range(3))
    km = None
    if mask_kind != "none":
        keep = (g.random((B, T)) < 0.8).astype(np.float32)
        keep[:, 0] = 1.0
        if all_masked_row:  # every key masked: a uniform average, not NaN
            keep[-1] = 0.0
        km = ((1.0 - keep) * NEG_INF).astype(np.float32)
    return q, k, v, km


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", ["none", "key", "causal_key"])
@pytest.mark.parametrize("T", [5, 32, 50, 131, 197])
def test_attention_nhd_reference_matches_jax(T, mask_kind, dtype):
    B, h, D = 2, 2, 16
    # The JAX kernel pads T=131 and T=197 (a Mosaic compile workaround) with
    # keys masked by -1e9, which outweigh keys masked by NEG_INF: a row with
    # every real key masked then averages the zero pads there. The port
    # computes the unpadded function, so that row is held only where JAX
    # does not pad.
    q, k, v, km = _attention_inputs(
        B, T, D, mask_kind, all_masked_row=jattn._padded_seq_len(T) == T
    )
    causal = mask_kind == "causal_key"
    jd = jnp.dtype(dtype)
    want = np.asarray(
        jattn.attention_nhd(
            jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), h,
            key_mask=None if km is None else jnp.asarray(km),
            causal=causal, interpret=True,
        )
    ).astype(np.float32)
    got = tattn.attention_nhd(
        _tt(q, dtype), _tt(k, dtype), _tt(v, dtype), h,
        None if km is None else torch.from_numpy(km), causal,
    )
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, D)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype], rtol=0)


def test_fully_masked_row_is_uniform_average():
    B, T, h, D = 1, 6, 2, 8
    q, k, v, _ = _attention_inputs(B, T, D, "none", seed=3)
    km = np.full((B, T), NEG_INF, np.float32)
    got = tattn.attention_nhd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
        torch.from_numpy(km), causal=True,
    ).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape),
                               atol=1e-6)
