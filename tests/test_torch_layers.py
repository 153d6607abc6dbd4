"""The port's ops/layers against the JAX package's, on the same seeded
numpy weights and inputs.

Tolerances: fp32 atol 1e-5 (same math, other summation order); bf16 atol
3e-2 plus rtol 1/64, two bf16 ulps (activations are rounded to bf16 between
ops, at |x| of a few units)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import layers as jl
from multimodal_content_moderation_tpu_torch.models.params import map_leaves
from multimodal_content_moderation_tpu_torch.ops import layers as tl

NEG_INF = -3.4028235e38
TOL = {"float32": (1e-5, 0), "bfloat16": (3e-2, 1 / 64)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense_p(g, d_in, d_out):
    return {
        "w": (g.normal(size=(d_in, d_out)) * d_in ** -0.5).astype(np.float32),
        "b": (g.normal(size=(d_out,)) * 0.1).astype(np.float32),
    }


def _block_p(g, d, d_ff):
    ln = lambda: {  # noqa: E731
        "scale": (1 + 0.1 * g.normal(size=(d,))).astype(np.float32),
        "bias": (0.1 * g.normal(size=(d,))).astype(np.float32),
    }
    return {
        "ln1": ln(),
        "attn": {n: _dense_p(g, d, d) for n in "qkvo"},
        "ln2": ln(),
        "fc1": _dense_p(g, d, d_ff),
        "fc2": _dense_p(g, d_ff, d),
    }


def _both(p, dtype):
    jp = map_leaves(lambda a: jnp.asarray(a, jnp.dtype(dtype)), p)
    tp = map_leaves(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), p)
    return jp, tp


def _x(g, shape, dtype):
    x = g.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want).astype(np.float32),
        atol=TOL[dtype][0], rtol=TOL[dtype][1],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_layer_norm(dtype):
    g = np.random.default_rng(0)
    jp, tp = _both({"d": _dense_p(g, 24, 16), "ln": _block_p(g, 16, 8)["ln1"]}, dtype)
    jx, tx = _x(g, (3, 5, 24), dtype)
    y = tl.dense(tx, tp["d"])
    assert y.dtype == tx.dtype
    _close(y, jl.dense(jx, jp["d"]), dtype)
    jy = jl.dense(jx, jp["d"])
    _close(tl.layer_norm(y, tp["ln"]), jl.layer_norm(jy, jp["ln"]), dtype)
    _close(tl.quick_gelu(y), jl.quick_gelu(jy), dtype)
    _close(tl.gelu_exact(y), jl.gelu_exact(jy), dtype)


def _masks(g, B, T, kind):
    """(dense mask, causal, key_mask) as numpy, for one mask form."""
    keep = (g.random((B, T)) < 0.75).astype(np.float32)
    keep[:, 0] = 1.0
    km = ((1.0 - keep) * NEG_INF).astype(np.float32)
    if kind == "dense":
        causal = np.triu(np.full((T, T), NEG_INF, np.float32), k=1)
        with np.errstate(over="ignore"):  # NEG_INF + NEG_INF -> -inf, as in JAX
            return (causal[None, None] + km[:, None, None, :]).astype(np.float32), False, None
    if kind == "causal_key":
        return None, True, km
    if kind == "key":
        return None, False, km
    return None, False, None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "impl,kind,scores",
    [
        ("xla", "none", "float32"),
        ("xla", "dense", "float32"),
        ("xla", "causal_key", "float32"),
        ("xla", "key", "bfloat16"),
        ("pallas", "none", "float32"),
        ("pallas", "causal_key", "float32"),
    ],
)
def test_mha(impl, kind, scores, dtype):
    g = np.random.default_rng(1)
    B, T, D, h = 2, 9, 32, 4
    jp, tp = _both(_block_p(g, D, 2 * D)["attn"], dtype)
    jx, tx = _x(g, (B, T, D), dtype)
    mask, causal, km = _masks(g, B, T, kind)
    want = jl.mha(
        jx, jx, jp, h, None if mask is None else jnp.asarray(mask), impl=impl,
        scores_dtype=scores, causal=causal, key_mask=None if km is None else jnp.asarray(km),
    )
    got = tl.mha(
        tx, tx, tp, h, None if mask is None else torch.from_numpy(mask), impl=impl,
        scores_dtype=scores, causal=causal, key_mask=None if km is None else torch.from_numpy(km),
    )
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


def test_mha_pallas_refuses_what_is_not_ported():
    g = np.random.default_rng(2)
    _, tp = _both(_block_p(g, 16, 32)["attn"], "float32")
    with pytest.raises(NotImplementedError, match="flash_attention"):
        tl.mha(torch.zeros(1, 257, 16), torch.zeros(1, 257, 16), tp, 2, impl="pallas")
    with pytest.raises(NotImplementedError, match="attention_small"):
        tl.mha(torch.zeros(1, 4, 16), torch.zeros(1, 4, 16), tp, 2,
               torch.zeros(1, 1, 4, 4), impl="pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,kind", [("xla", "dense"), ("pallas", "causal_key"), ("pallas", "none")])
def test_transformer_block(impl, kind, dtype):
    g = np.random.default_rng(3)
    B, T, D, h = 2, 7, 32, 2
    jp, tp = _both(_block_p(g, D, 64), dtype)
    jx, tx = _x(g, (B, T, D), dtype)
    mask, causal, km = _masks(g, B, T, kind)
    kw = dict(attention_impl=impl, causal=causal)
    want = jl.transformer_block(
        jx, jp, h, "quick_gelu", None if mask is None else jnp.asarray(mask),
        key_mask=None if km is None else jnp.asarray(km), **kw,
    )
    got = tl.transformer_block(
        tx, tp, h, "quick_gelu", None if mask is None else torch.from_numpy(mask),
        key_mask=None if km is None else torch.from_numpy(km), **kw,
    )
    _close(got, want, dtype)
