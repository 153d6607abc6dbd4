"""The arithmetic of the bf16 tensor-core patch embed
(``csrc/patch_embed_u8.cu``, ``patch_embed_u8_mma_kernel``) as a plain torch
model on the CPU, against the JAX package's Pallas kernel in interpret mode,
its plain reference and the port's plain version, on seeded numpy inputs.

The model rounds where the kernel rounds: every uint8 value is exact in
bf16; the fp32 weight is split into hi = bf16(w) and lo = bf16(w - hi); the
products x hi and x lo are exact in fp32 and summed in fp32; the fp32 bias
is added and the sum rounded once to bf16. Tolerance: the kernel's bf16
tolerance on the card, atol 1e-3 + rtol 2^-7 (one rounding of the output:
the model and the reference differ by the residual below lo, ~2^-17 of w,
and the order of the sums, so at most one bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import pallas_image as jimg
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci

TOL = dict(atol=1e-3, rtol=2.0**-7)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def split_hi_lo(w):
    """fp32 w -> (hi, lo) bf16 with hi + lo ~ w to 2^-17 relative."""
    hi = w.bfloat16()
    lo = (w - hi.float()).bfloat16()
    return hi, lo


def mma_model(x_u8, w, b, round_output=True):
    """x_u8 [R, K] uint8, w [K, D] and b [D] fp32 -> [R, D] bf16 (fp32 with
    ``round_output=False``), with the tensor-core kernel's roundings."""
    x = x_u8.to(torch.bfloat16).float()  # exact: 0..255 has 8 significant bits
    hi, lo = split_hi_lo(w)
    acc = torch.matmul(x, hi.float()) + torch.matmul(x, lo.float())
    out = acc + b
    return out.bfloat16() if round_output else out


def _inputs(R, K, D, seed, bias=True):
    g = np.random.default_rng(seed)
    x = g.integers(0, 256, size=(1, R, K), dtype=np.uint8)
    w = (g.normal(size=(K, D)) * 0.02).astype(np.float32)
    b = (g.normal(size=(D,)) * 0.1).astype(np.float32) if bias else None
    wf, bf = jimg.fold_norm_into_embed(
        jnp.asarray(w), None if b is None else jnp.asarray(b),
        (0.48, 0.46, 0.41), (0.27, 0.26, 0.28), int(round((K // 3) ** 0.5)))
    return x, np.array(wf), np.array(bf)


def _close(got, want):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **TOL)


def test_every_u8_value_is_exact_in_bf16():
    v = torch.arange(256, dtype=torch.float32)
    assert torch.equal(v.bfloat16().float(), v)


def test_split_keeps_the_weight():
    """hi + lo is within 2^-16 of w, relative, across magnitudes (the folded
    weight carries 1 / (255 std) ~ 1.5e-2)."""
    g = np.random.default_rng(0)
    w = torch.from_numpy((g.normal(size=4096) * 10.0 ** g.uniform(-6, 1, size=4096))
                         .astype(np.float32))
    hi, lo = split_hi_lo(w)
    err = (hi.float() + lo.float() - w).abs()
    assert bool((err <= 2.0**-16 * w.abs()).all())


# R, K, D, bias: K = 3 * 4 * 4 (48) and 3 * 14 * 14 (588, not a multiple of
# 16); ragged D; R around the JAX kernel's 256-row blocks
CASES = [(37, 48, 70, True), (300, 48, 33, False), (1, 588, 72, True), (130, 588, 72, False),
         (257, 588, 24, True)]


@pytest.mark.parametrize("R,K,D,bias", CASES)
def test_model_matches_jax_patch_embed(R, K, D, bias):
    """bf16 output: JAX's kernel (interpret mode) and its plain reference,
    the port's plain version, and the model of the tensor-core kernel."""
    x, wf, bf = _inputs(R, K, D, seed=R + K + D, bias=bias)
    got = mma_model(torch.from_numpy(x[0]), torch.from_numpy(wf), torch.from_numpy(bf))
    want = jimg.patch_embed_u8(jnp.asarray(x), jnp.asarray(wf), jnp.asarray(bf),
                               out_dtype=jnp.bfloat16, interpret=True)
    _close(got, np.asarray(want, np.float32)[0])
    ref = jimg.patch_embed_reference(jnp.asarray(x), jnp.asarray(wf), jnp.asarray(bf),
                                     out_dtype=jnp.bfloat16)
    _close(got, np.asarray(ref, np.float32)[0])
    plain = ci.patch_embed_u8(torch.from_numpy(x), torch.from_numpy(wf), torch.from_numpy(bf),
                              torch.bfloat16)
    _close(got, plain[0])


@pytest.mark.parametrize("K", [588, 3072])
def test_model_keeps_the_fp32_product(K):
    """Before the output's rounding the model is within 2^-14 of the fp32
    product's scale (the split's residual summed over K terms), far below
    one bf16 ulp (2^-8 of the value)."""
    x, wf, bf = _inputs(64, K, 96, seed=K)
    xt, wt, bt = torch.from_numpy(x[0]), torch.from_numpy(wf), torch.from_numpy(bf)
    got = mma_model(xt, wt, bt, round_output=False)
    want = torch.matmul(xt.double(), wt.double()) + bt.double()
    err = float((got.double() - want).abs().max())
    assert err <= 2.0**-14 * float(want.abs().max())
