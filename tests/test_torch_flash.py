"""The port's ``fused_mha``, ``flash_attention`` and ``attention_small`` (their
plain versions, on the CPU) against the JAX package's Pallas kernels in
interpret mode, mirroring tests/test_pallas_kernels.py; ``mha`` with
``impl="pallas"`` on both dispatch paths; and the single-query (``Tq == 1``)
branch of ``mha``.

Tolerances: fp32 atol 2e-5, rtol 1e-4 (the JAX tests' own: the same fp32
math in another order, an online softmax on the JAX side); bf16 outputs
within one bf16 rounding (rtol 2^-7) + atol 1e-3; ``mha`` as
tests/test_torch_layers.py holds it (fp32 1e-5, bf16 2e-2 after the bf16
projections).

A row whose keys are all masked is compared with JAX only where JAX pads
nothing: the JAX wrapper pads S to a multiple of 128 with zero keys that
such a row averages too, while the port computes the unpadded function (a
mean over the S real keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import layers as jl
from multimodal_content_moderation_tpu.ops.pallas_attention import NEG_INF
from multimodal_content_moderation_tpu.ops.pallas_attention import (
    attention_small as j_small,
)
from multimodal_content_moderation_tpu.ops.pallas_attention import (
    flash_attention as j_flash,
)
from multimodal_content_moderation_tpu.ops.pallas_attention import fused_mha as j_fused
from multimodal_content_moderation_tpu_torch.ops import cuda_flash as cf
from multimodal_content_moderation_tpu_torch.ops import layers as tl

TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=2.0**-7)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, shape, s_len=None, dtype="float32"):
    g = np.random.default_rng(seed)
    kshape = shape[:-2] + (s_len or shape[-2], shape[-1])
    arrs = [g.normal(size=s).astype(np.float32) for s in (shape, kshape, kshape)]
    if dtype == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    return arrs


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want).astype(np.float32), **TOL[dtype]
    )


def _key_mask(valid, S):
    return np.where(np.arange(S)[None, :] < np.asarray(valid)[:, None], 0.0, NEG_INF).astype(
        np.float32
    )


def _causal(T, S=None):
    S = S or T
    return np.where(np.arange(T)[:, None] >= np.arange(S)[None, :], 0.0, NEG_INF).astype(
        np.float32
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "kind",
    ["none_ragged", "key_mask", "causal", "causal_key_ragged", "dense", "dense_key_causal"],
)
def test_fused_mha_long_path_matches_jax(kind, dtype):
    """T > 256: the port's flash_attention against JAX's (padded to a
    multiple of 128 on the JAX side)."""
    B, H, dh = 2, 2, 32
    T = {"none_ragged": 300, "causal_key_ragged": 300, "dense_key_causal": 300}.get(kind, 384)
    q, k, v = _qkv(20, (B, H, T, dh), dtype=dtype)
    km = dense = None
    causal = "causal" in kind
    if "key" in kind:
        km = _key_mask([T, T - 51], T)  # every row keeps key 0
    if "dense" in kind:
        g = np.random.default_rng(21)
        dense = np.where(g.random((B, 1, T, T)) < 0.2, NEG_INF, 0.0).astype(np.float32)
        dense[..., 0] = 0.0  # every row keeps key 0
    want = j_fused(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), None if dense is None else jnp.asarray(dense),
        interpret=True, causal=causal, key_mask=None if km is None else jnp.asarray(km),
    )
    got = cf.fused_mha(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if dense is None else torch.from_numpy(dense),
        causal=causal, key_mask=None if km is None else torch.from_numpy(km),
    )
    assert got.shape == (B, H, T, dh) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize(
    "kind,T,dh",
    [("none", 256, 64), ("key_mask", 256, 32), ("causal", 256, 32), ("causal_key", 256, 32),
     ("dense", 256, 32)],
)
def test_flash_attention_matches_jax(kind, T, dh):
    """JAX's flash_attention on [BH, T, dh] (block multiples, so nothing is
    padded) against the port's on the [BH, 1, T, dh] view."""
    BH = 4
    q, k, v = _qkv(22, (BH, T, dh))
    km = mask = None
    if "key" in kind:
        km = _key_mask([256, 200, 129, 77], T)
    if kind == "dense":
        mask = np.zeros((BH, T, T), np.float32)
        mask[:, :, 200:] = NEG_INF
    causal = "causal" in kind
    want = j_flash(
        q, k, v, None if mask is None else jnp.asarray(mask),
        key_mask=None if km is None else jnp.asarray(km), causal=causal,
        block_q=128, block_k=128, interpret=True,
    )
    got = cf.flash_attention(
        *(torch.from_numpy(a)[:, None] for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask)[:, None],
        None if km is None else torch.from_numpy(km), causal,
    )
    _close(got[:, 0], want, "float32")


def test_flash_attention_cross_attention_and_broadcast_mask():
    """T != S, and a dense [T, S] mask broadcast over batch and heads, against
    the plain fp32 softmax."""
    B, H, T, S, dh = 2, 3, 40, 300, 16
    q, k, v = _qkv(23, (B, H, T, dh), s_len=S)
    g = np.random.default_rng(24)
    mask = np.where(g.random((T, S)) < 0.3, NEG_INF, 0.0).astype(np.float32)
    got = cf.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    s = np.einsum("bhtd,bhsd->bhts", q, k) / np.sqrt(dh) + mask
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), np.einsum("bhts,bhsd->bhtd", p, v), **TOL["float32"])


def test_flash_fully_masked_row_is_the_unpadded_mean():
    """A row with every key masked: the port averages its S real keys; the
    JAX wrapper, padding S=300 to 384, averages 84 zero keys too
    (ROADMAP queue 3, fault 8). Every other row agrees with JAX."""
    B, H, T, dh = 2, 2, 300, 16
    q, k, v = _qkv(25, (B, H, T, dh))
    km = _key_mask([0, 300], T)  # batch row 0: every key masked
    got = cf.fused_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                       key_mask=torch.from_numpy(km)).numpy()
    want = np.asarray(j_fused(q, k, v, None, interpret=True, key_mask=jnp.asarray(km)))
    np.testing.assert_allclose(got[1], want[1], **TOL["float32"])
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(want[0], np.broadcast_to(v[0].sum(1, keepdims=True) / 384,
                                                        want[0].shape), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,T,dh", [("pad", 64, 32), ("causal", 16, 8), ("none", 50, 64)])
def test_attention_small_matches_jax(kind, T, dh, dtype):
    BH = 4
    q, k, v = _qkv(26, (BH, T, dh), dtype=dtype)
    mask = None
    if kind == "pad":
        mask = np.zeros((BH, T, T), np.float32)
        mask[:, :, 50:] = NEG_INF
    elif kind == "causal":
        mask = np.broadcast_to(_causal(T), (BH, T, T)).copy()
    want = j_small(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                   None if mask is None else jnp.asarray(mask), interpret=True)
    got = cf.attention_small(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", ["none", "causal_key", "dense_key", "key_only"])
def test_fused_mha_short_path_matches_jax(flags, dtype):
    """max(T, S) <= 256: flags folded into one dense block, attention_small."""
    B, H, T, dh = 2, 2, 64, 16
    q, k, v = _qkv(27, (B, H, T, dh), dtype=dtype)
    km = _key_mask([50, 64], T) if "key" in flags else None
    dense = _causal(T)[None, None] * 0.5 if "dense" in flags else None  # still -inf-free
    causal = "causal" in flags
    want = j_fused(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), None if dense is None else jnp.asarray(dense),
        interpret=True, causal=causal, key_mask=None if km is None else jnp.asarray(km),
    )
    got = cf.fused_mha(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if dense is None else torch.from_numpy(dense),
        causal=causal, key_mask=None if km is None else torch.from_numpy(km),
    )
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", ["dense_b1", "dense_shared", "causal_key", "dense_b1_key"])
def test_fused_mha_broadcast_mask_and_strided_views_match_jax(flags, dtype):
    """The short path as ``mha`` reaches it: q, k, v as [B, H, T, dh] views of
    [B, T, D] memory (no copy) and the mask in its broadcast shape ([B, 1, T,
    S] or [T, S], folded with a causal flag or a key row into [B, 1, T, S]),
    against JAX ``fused_mha`` on contiguous heads and the expanded mask."""
    B, H, T, dh = 3, 4, 77, 16
    g = np.random.default_rng(28)
    q3, k3, v3 = (g.normal(size=(B, T, H * dh)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":
        q3, k3, v3 = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                      for a in (q3, k3, v3))
    heads = [a.reshape(B, T, H, dh).transpose(0, 2, 1, 3) for a in (q3, k3, v3)]
    dense = None
    if flags.startswith("dense"):
        shape = (B, 1, T, T) if "b1" in flags else (T, T)
        dense = np.where(g.random(shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
        dense[..., 0] = 0.0
    km = _key_mask([77, 40, 5], T) if "key" in flags else None
    causal = "causal" in flags
    want = j_fused(
        *(_j(np.ascontiguousarray(a), dtype) for a in heads),
        None if dense is None else jnp.asarray(dense), interpret=True, causal=causal,
        key_mask=None if km is None else jnp.asarray(km),
    )
    views = [_t(a, dtype).view(B, T, H, dh).transpose(1, 2) for a in (q3, k3, v3)]
    assert not views[0].is_contiguous()
    got = cf.fused_mha(*views, None if dense is None else torch.from_numpy(dense),
                       causal=causal, key_mask=None if km is None else torch.from_numpy(km))
    assert got.shape == (B, H, T, dh)
    _close(got, want, dtype)


def _attn_params(g, D):
    p = {n: {"w": (g.normal(size=(D, D)) * D**-0.5).astype(np.float32),
             "b": (g.normal(size=(D,)) * 0.1).astype(np.float32)} for n in ("q", "k", "v", "o")}
    jp = {n: {k: jnp.asarray(a) for k, a in d.items()} for n, d in p.items()}
    tp = {n: {k: torch.from_numpy(a) for k, a in d.items()} for n, d in p.items()}
    return jp, tp


MHA_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "T,kind",
    [(289, "none"), (289, "key"), (289, "dense"), (20, "dense"), (20, "dense_causal_key")],
)
def test_mha_pallas_matches_jax(T, kind, dtype):
    """``mha(impl="pallas")`` on the fused_mha routes (T=289: flash; a dense
    mask at T=20: attention_small) against JAX's ``mha(impl="pallas")``."""
    g = np.random.default_rng(28)
    B, D, h = 2, 32, 2
    jp, tp = _attn_params(g, D)
    x = g.normal(size=(B, T, D)).astype(np.float32)
    km = _key_mask([T, T - 7], T) if "key" in kind else None
    dense = None
    if "dense" in kind:
        dense = np.where(g.random((B, 1, T, T)) < 0.2, NEG_INF, 0.0).astype(np.float32)
        dense[..., 0] = 0.0
    causal = "causal" in kind
    jx = jnp.asarray(x, getattr(jnp, dtype))
    if dtype == "bfloat16":
        jp = {n: {k: a.astype(jnp.bfloat16) for k, a in d.items()} for n, d in jp.items()}
        tp = {n: {k: a.bfloat16() for k, a in d.items()} for n, d in tp.items()}
    want = jl.mha(jx, jx, jp, h, None if dense is None else jnp.asarray(dense), impl="pallas",
                  causal=causal, key_mask=None if km is None else jnp.asarray(km))
    tx = _t(np.asarray(jx.astype(jnp.float32)), dtype)
    got = tl.mha(tx, tx, tp, h, None if dense is None else torch.from_numpy(dense),
                 impl="pallas", causal=causal,
                 key_mask=None if km is None else torch.from_numpy(km))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               **MHA_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mha_single_query_branch_matches_jax(impl, dtype):
    """Tq == 1 with no mask (the SigLIP MAP head): fp32 products over the
    [B, Tk, h, dh] view on both sides, whatever the impl."""
    g = np.random.default_rng(29)
    B, Tk, D, h = 3, 289, 32, 4
    jp, tp = _attn_params(g, D)
    xq = g.normal(size=(B, 1, D)).astype(np.float32)
    xkv = g.normal(size=(B, Tk, D)).astype(np.float32)
    jq, jkv = jnp.asarray(xq, getattr(jnp, dtype)), jnp.asarray(xkv, getattr(jnp, dtype))
    if dtype == "bfloat16":
        jp = {n: {k: a.astype(jnp.bfloat16) for k, a in d.items()} for n, d in jp.items()}
        tp = {n: {k: a.bfloat16() for k, a in d.items()} for n, d in tp.items()}
    want = np.asarray(jl.mha(jq, jkv, jp, h, impl=impl)).astype(np.float32)
    got = tl.mha(_t(np.asarray(jq.astype(jnp.float32)), dtype),
                 _t(np.asarray(jkv.astype(jnp.float32)), dtype), tp, h, impl=impl)
    assert got.shape == (B, 1, D)
    # bf16: both sides round the same fp32 sums once to bf16 before the out
    # projection, so they agree to a rounding or two after it
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_kernels_are_forward_only():
    q = torch.zeros(1, 1, 300, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flash_attention is forward only"):
        cf.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="attention_small is forward only"):
        cf.attention_small(q[0], q[0], q[0])
    with torch.no_grad():
        assert cf.flash_attention(q, q, q).shape == (1, 1, 300, 8)
