"""The port's losses (``ops/losses.py``) against the JAX package's, on the same
seeded logits and targets, in each reduction. Tolerance: fp32 atol 1e-6 +
rtol 1e-6 (the same fp32 formulas; log-sigmoid and pow summed in another
order). The gradient of the in-model losses is checked in
tests/test_torch_training.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import losses as jl
from multimodal_content_moderation_tpu_torch.ops import losses as tl


def _data(seed, dtype="float32"):
    g = np.random.default_rng(seed)
    logits = (g.normal(size=(16, 5)) * 4).astype(np.float32)
    logits[0, 0], logits[1, 1] = 40.0, -40.0  # saturated sigmoid
    targets = (g.random((16, 5)) < 0.3).astype(np.float32)
    pw = (0.5 + g.random(5) * 3).astype(np.float32)
    alpha = g.random(5).astype(np.float32)
    return logits, targets, pw, alpha


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("with_pw", [False, True])
def test_bce_with_logits(reduction, with_pw):
    x, y, pw, _ = _data(0)
    got = tl.bce_with_logits(
        torch.from_numpy(x), torch.from_numpy(y),
        pos_weight=torch.from_numpy(pw) if with_pw else None, reduction=reduction,
    )
    want = jl.bce_with_logits(
        jnp.asarray(x), jnp.asarray(y), pos_weight=jnp.asarray(pw) if with_pw else None,
        reduction=reduction,
    )
    _close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_focal_with_logits(reduction, with_alpha):
    x, y, _, alpha = _data(1)
    got = tl.focal_with_logits(
        torch.from_numpy(x), torch.from_numpy(y), gamma=1.5,
        alpha=torch.from_numpy(alpha) if with_alpha else None, reduction=reduction,
    )
    want = jl.focal_with_logits(
        jnp.asarray(x), jnp.asarray(y), gamma=1.5,
        alpha=jnp.asarray(alpha) if with_alpha else None, reduction=reduction,
    )
    _close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_asymmetric_loss(reduction):
    x, y, _, _ = _data(2)
    got = tl.asymmetric_loss(torch.from_numpy(x), torch.from_numpy(y), reduction=reduction)
    want = jl.asymmetric_loss(jnp.asarray(x), jnp.asarray(y), reduction=reduction)
    _close(got, want)


def test_bf16_logits_are_lifted_to_fp32():
    x, y, pw, _ = _data(3)
    xb = torch.from_numpy(x).bfloat16()
    got = tl.bce_with_logits(xb, torch.from_numpy(y), pos_weight=torch.from_numpy(pw))
    assert got.dtype == torch.float32
    want = jl.bce_with_logits(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(y), pos_weight=jnp.asarray(pw))
    _close(got, want)


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_logit_adjust(tau):
    x, y, _, _ = _data(4)
    priors = list(y.mean(axis=0))
    priors[0] = 0.0  # clipped to 1e-6
    np.testing.assert_allclose(
        tl.logit_adjust(x, priors, tau), np.asarray(jl.logit_adjust(x, priors, tau)),
        atol=1e-5, rtol=1e-6,
    )
