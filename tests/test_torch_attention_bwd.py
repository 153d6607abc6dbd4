"""The backward of the port's attention (``ops/cuda_attention``) against the
JAX package's recompute backward kernel, run in interpret mode.

- ``attention_nhd_bwd_reference`` (the plain version of the CUDA kernel)
  against ``_attention_nhd_bwd_call(..., interpret=True)``: fp32 atol 5e-5
  (the same fp32 math summed in another order); bf16 inputs and outputs
  atol 2e-3 + rtol 2^-7 (both compute in fp32 and round once, so they differ
  by at most one bf16 ulp).
- ``attention_nhd_diff`` gradients against ``jax.grad`` of the JAX
  ``attention_nhd_diff`` and against torch autograd of
  ``attention_nhd_reference``, fp32 atol 5e-5 (the JAX package's own
  tolerance for its VJP test).

A fully masked row (every key masked) is held at lengths the JAX wrapper
does not pad (its pad shim changes that row's answer at T=131/197). Against
autograd of the plain forward it is left out under a causal mask: there the
recompute formula (JAX's and the kernel's) sends gradient through the
causal positions of a uniform row, where autograd of ``torch.where`` does
not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import pallas_attention as jpa
from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca

NEG_INF = -3.4028235e38
B, D, H = 3, 64, 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, kind, seed, fully_masked_row=True):
    g = np.random.default_rng(seed)
    q, k, v, do = (g.normal(size=(B, T, D)).astype(np.float32) for _ in range(4))
    km = None
    if kind != "none":
        keep = (g.random((B, T)) < 0.7).astype(np.float32)
        keep[:, 0] = 1.0
        if fully_masked_row:
            keep[0] = 0.0
        km = ((1.0 - keep) * NEG_INF).astype(np.float32)
    return q, k, v, do, km, kind == "causal_key"


def _torch(x, dtype):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return None if x is None else jnp.asarray(x, jnp.dtype(dtype))


CASES = [(T, kind) for T in (5, 32, 50, 77) for kind in ("none", "key", "causal_key")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,kind", CASES)
def test_bwd_reference_matches_jax_kernel(T, kind, dtype):
    q, k, v, do, km, causal = _inputs(T, kind, seed=T)
    got = ca.attention_nhd_bwd_reference(
        *(_torch(x, dtype) for x in (q, k, v, do)), H,
        None if km is None else torch.from_numpy(km), causal,
    )
    want = jpa._attention_nhd_bwd_call(
        *(_jax(x, dtype) for x in (q, k, v, do)),
        None if km is None else jnp.asarray(km), H, causal=causal, interpret=True,
    )
    atol, rtol = (5e-5, 0.0) if dtype == "float32" else (2e-3, 2.0**-7)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b).astype(np.float32), atol=atol, rtol=rtol,
            err_msg=name,
        )


def _port_grads(fn, q, k, v, w):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fn(*leaves) * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("T,kind", [(5, "key"), (50, "none"), (77, "causal_key"), (32, "key")])
def test_attention_nhd_diff_grads_match_jax_and_autograd(T, kind):
    q, k, v, w, km, causal = _inputs(T, kind, seed=100 + T)
    tkm = None if km is None else torch.from_numpy(km)
    got = _port_grads(lambda a, b, c: ca.attention_nhd_diff(a, b, c, tkm, H, causal), q, k, v, w)

    jkm = None if km is None else jnp.asarray(km)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jpa.attention_nhd_diff(a, b, c, jkm, H, causal, 0, True) * w),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, err_msg=name)

    if causal:  # no uniform row under the causal mask (see the module note)
        q, k, v, w, km, causal = _inputs(T, kind, seed=100 + T, fully_masked_row=False)
        tkm = torch.from_numpy(km)
        got = _port_grads(
            lambda a, b, c: ca.attention_nhd_diff(a, b, c, tkm, H, causal), q, k, v, w
        )
    plain = _port_grads(
        lambda a, b, c: ca.attention_nhd_reference(a, b, c, H, tkm, causal), q, k, v, w
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, plain):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)


def test_key_mask_gets_no_gradient_and_bf16_cotangent_is_cast():
    q, k, v, w, km, causal = _inputs(32, "causal_key", seed=7)
    qt, kt, vt = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    kmt = torch.from_numpy(km).requires_grad_()
    out = ca.attention_nhd_diff(qt, kt, vt, kmt, H, causal)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert kmt.grad is None
    want = ca.attention_nhd_bwd_reference(
        qt.detach(), kt.detach(), vt.detach(), torch.from_numpy(w).bfloat16(), H, kmt.detach(),
        causal,
    )
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ca.attention_nhd_bwd(q, q, q, q, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ca.attention_nhd_diff(q, q, q, None, 2)
