"""The arithmetic of the bf16 tensor-core attention kernels
(``csrc/attention_mma.cuh``, behind ``attention_nhd`` and ``flash_attention``)
as a plain torch model on the CPU, against the JAX package's Pallas kernels
in interpret mode and the port's plain versions, on seeded numpy inputs.

The model rounds where the kernels round: bf16 inputs; fp32 scores (a
product of two bf16 values is exact in fp32), scaled after the dot, then the
dense mask, the key row and the causal mask in the reference's order; the
keys in steps of 64 with an online softmax (running max from -FLT_MAX,
rescale by exp(m_old - m_new)); P split into bf16 hi = bf16(p) and lo =
bf16(p - hi), each multiplied with V in fp32; the sum l of fp32 p; one bf16
rounding of o / l. (The kernels take exp as the SFU's 2^(x log2 e), within
~2^-22 of ``torch.exp``.) Tolerance: the kernels' bf16 tolerance on the
card, atol 1e-3 + rtol 2^-7 (one rounding of the output).

A row whose keys are all masked is held against the port's plain version
only: JAX pads such rows' keys (ROADMAP queue 3, faults 6 and 8).

``attention_small`` (``csrc/attention_small.cu``,
``attention_small_mma_launch``) runs the same routine over its slice's keys,
staged whole (one key tile of up to four 64-key chunks), with the one
folded additive mask added after the scale: the same model with ``dense``,
held against JAX's ``attention_small`` in interpret mode.

The backward (``csrc/attention_nhd_bwd.cu``, ``attention_nhd_bwd_mma_launch``)
is modelled in its two launches:

- A (query rows): fp32 scores as above; over 64-key chunks an online row max
  m, sum l of exp(s - m) and sum a of dp exp(s - m), rescaled by
  exp(m_old - m_new), so rowsum(dp * p) = a / l; then p = exp(s - m) / l,
  dz = p (dp - rowsum) scale, and dq = dz k with dz split into bf16 hi + lo.
- B (keys): s^T = k q^T recomputed, p^T and dz^T rebuilt from A's per-row
  statistics (m, 1/l, rowsum), and dv = p^T dO, dk = dz^T q with p and dz
  split hi + lo.

One bf16 rounding of each gradient, held against JAX's
``_attention_nhd_bwd_call`` in interpret mode at lengths it does not pad
(not 131 or 197), so a fully masked row compares with JAX too; same
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.ops import pallas_attention as jattn
from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
from multimodal_content_moderation_tpu_torch.ops import cuda_flash as cf

NEG_INF = torch.finfo(torch.float32).min  # -FLT_MAX, the masked score
CHUNK = 64
TOL = dict(atol=1e-3, rtol=2.0**-7)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mma_model(q, k, v, dense=None, key=None, causal=False, round_output=True):
    """q [N, T, dh], k/v [N, S, dh] bf16; dense [N, T, S] and key [N, S]
    additive fp32 -> [N, T, dh] bf16 (fp32 with ``round_output=False``),
    with the kernels' roundings."""
    N, T, dh = q.shape
    S = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (float(dh) ** -0.5)
    if dense is not None:
        s = s + dense
    if key is not None:
        s = s + key[:, None, :]
    if causal:
        keep = torch.arange(S)[None, :] <= torch.arange(T)[:, None]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = torch.full((N, T), NEG_INF)
    l = torch.zeros(N, T)
    o = torch.zeros(N, T, dh)
    for c0 in range(0, S, CHUNK):
        sc = s[:, :, c0 : c0 + CHUNK]
        mn = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - mn)
        p = torch.exp(sc - mn[..., None])
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vc = v[:, c0 : c0 + CHUNK].float()
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(hi, vc) + torch.matmul(lo, vc)
        m = mn
    out = o / l[..., None]
    return out.bfloat16() if round_output else out


def _bf16(g, shape):
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).bfloat16()


def _j(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close(got, want):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), **TOL)


def _key_row(g, B, S, fully_masked_row):
    lengths = g.integers(1, S + 1, size=B)
    lengths[0] = S  # one row keeps every key
    if fully_masked_row:
        lengths[-1] = 0
    keep = np.arange(S)[None, :] < lengths[:, None]
    return np.where(keep, 0.0, NEG_INF).astype(np.float32)


def _heads(t, h):
    """[B, T, D] -> [B*h, T, dh]"""
    B, T, D = t.shape
    return t.view(B, T, h, D // h).permute(0, 2, 1, 3).reshape(B * h, T, D // h)


def _unheads(t, B, h):
    """[B*h, T, dh] -> [B, T, D]"""
    N, T, dh = t.shape
    return t.view(B, h, T, dh).permute(0, 2, 1, 3).reshape(B, T, h * dh)


NHD_CASES = [  # T, heads, dh, mask kind
    (50, 2, 64, "none"),
    (50, 2, 64, "key"),
    (77, 2, 64, "causal_key"),
    (32, 3, 8, "none"),
    (32, 3, 8, "causal"),
    (136, 2, 8, "key"),  # three 64-key steps, the last one of 8 keys
]


@pytest.mark.parametrize("T,h,dh,kind", NHD_CASES)
def test_model_matches_jax_attention_nhd(T, h, dh, kind):
    """``attention_nhd`` in bf16: JAX's kernel (interpret mode), the port's
    plain version and the model of the tensor-core kernel agree."""
    g = np.random.default_rng(T + dh)
    B, D = 2, h * dh
    q, k, v = (_bf16(g, (B, T, D)) for _ in range(3))
    km = _key_row(g, B, T, False) if "key" in kind else None
    causal = "causal" in kind
    assert jattn._padded_seq_len(T) == T  # JAX pads nothing here
    want = jattn.attention_nhd(_j(q), _j(k), _j(v), h,
                               key_mask=None if km is None else jnp.asarray(km),
                               causal=causal, interpret=True)
    key = None if km is None else torch.from_numpy(km).repeat_interleave(h, dim=0)
    got = _unheads(mma_model(_heads(q, h), _heads(k, h), _heads(v, h), key=key, causal=causal),
                   B, h)
    _close(got, want)
    plain = ca.attention_nhd(q, k, v, h, None if km is None else torch.from_numpy(km), causal)
    _close(got, plain)


@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_model_fully_masked_row_is_the_plain_average(dh, causal):
    """A batch row whose keys are all masked at -FLT_MAX: the running max
    stays -FLT_MAX, every key weighs 1, and the row is the plain version's
    average (not NaN), in the model as in ``attention_nhd_reference``."""
    g = np.random.default_rng(dh)
    B, T, h = 3, 70, 2
    q, k, v = (_bf16(g, (B, T, h * dh)) for _ in range(3))
    km = _key_row(g, B, T, True)
    key = torch.from_numpy(km).repeat_interleave(h, dim=0)
    got = _unheads(mma_model(_heads(q, h), _heads(k, h), _heads(v, h), key=key, causal=causal),
                   B, h)
    assert torch.isfinite(got.float()).all()
    _close(got, ca.attention_nhd_reference(q, k, v, h, torch.from_numpy(km), causal))


FLASH_CASES = [  # T, S, dh, mask kind, causal
    (256, 256, 64, "none", False),
    (256, 256, 64, "key", False),
    (256, 256, 8, "dense", False),
    (256, 256, 64, "dense_key", True),
]


@pytest.mark.parametrize("T,S,dh,kind,causal", FLASH_CASES)
def test_model_matches_jax_flash_attention(T, S, dh, kind, causal):
    """JAX's ``flash_attention`` (interpret mode, block multiples, so
    nothing is padded) in bf16, the port's plain version and the model."""
    g = np.random.default_rng(T + dh + int(causal))
    N = 4
    q, k, v = _bf16(g, (N, T, dh)), _bf16(g, (N, S, dh)), _bf16(g, (N, S, dh))
    km = _key_row(g, N, S, False) if "key" in kind else None
    dense = None
    if "dense" in kind:
        dense = np.where(g.random((N, T, S)) < 0.2, NEG_INF, 0.0).astype(np.float32)
        dense[..., 0] = 0.0  # every row keeps key 0
    want = jattn.flash_attention(
        _j(q), _j(k), _j(v), None if dense is None else jnp.asarray(dense),
        key_mask=None if km is None else jnp.asarray(km), causal=causal,
        block_q=128, block_k=128, interpret=True,
    )
    tdense = None if dense is None else torch.from_numpy(dense)
    tkm = None if km is None else torch.from_numpy(km)
    got = mma_model(q, k, v, dense=tdense, key=tkm, causal=causal)
    _close(got, want)
    plain = cf.flash_attention(q[:, None], k[:, None], v[:, None],
                               None if tdense is None else tdense[:, None], tkm, causal)
    _close(got, plain[:, 0])


@pytest.mark.parametrize("T,S,dh,kind,causal", [(300, 300, 64, "key", True),
                                                (300, 300, 8, "dense", False)])
def test_model_matches_jax_fused_mha_ragged(T, S, dh, kind, causal):
    """Ragged T and S (not multiples of 64 or 128): JAX's ``fused_mha``
    pads them, the kernels mask them; every row keeps a real key."""
    g = np.random.default_rng(T + dh)
    B, H = 2, 2
    q, k, v = _bf16(g, (B, H, T, dh)), _bf16(g, (B, H, S, dh)), _bf16(g, (B, H, S, dh))
    km = _key_row(g, B, S, False) if kind == "key" else None
    dense = None
    if kind == "dense":
        dense = np.where(g.random((B, 1, T, S)) < 0.2, NEG_INF, 0.0).astype(np.float32)
        dense[..., 0] = 0.0
    want = jattn.fused_mha(
        _j(q), _j(k), _j(v), None if dense is None else jnp.asarray(dense), interpret=True,
        causal=causal, key_mask=None if km is None else jnp.asarray(km),
    )
    flat = lambda t: t.reshape(B * H, t.shape[2], dh)  # noqa: E731
    tdense = None
    if dense is not None:
        tdense = torch.from_numpy(dense).expand(B, H, T, S).reshape(B * H, T, S)
    tkm = None if km is None else torch.from_numpy(km).repeat_interleave(H, dim=0)
    got = mma_model(flat(q), flat(k), flat(v), dense=tdense, key=tkm, causal=causal)
    _close(got.view(B, H, T, dh), want)


@pytest.mark.parametrize("T,S,dh", [(100, 333, 64), (70, 130, 8)])
def test_model_cross_attention_matches_plain(T, S, dh):
    """T != S with a key row, including a fully masked row: the model and
    the port's ``flash_attention_reference``."""
    g = np.random.default_rng(S)
    B = 3
    q, k, v = _bf16(g, (B, 1, T, dh)), _bf16(g, (B, 1, S, dh)), _bf16(g, (B, 1, S, dh))
    km = torch.from_numpy(_key_row(g, B, S, True))
    got = mma_model(q[:, 0], k[:, 0], v[:, 0], key=km)
    _close(got, cf.flash_attention_reference(q, k, v, None, km)[:, 0])


SMALL_CASES = [  # BH, T, dh, mask kind
    (4, 77, 64, "dense"),  # the mha dense-mask shape: two 64-key chunks
    (3, 200, 16, "dense"),  # four chunks, the last one of 8 keys
    (2, 50, 64, "none"),  # one ragged chunk, no mask
    (4, 77, 64, "folded"),  # causal + a key row folded, as fused_mha gives it
]


@pytest.mark.parametrize("BH,T,dh,kind", SMALL_CASES)
def test_model_matches_jax_attention_small(BH, T, dh, kind):
    """``attention_small`` in bf16: JAX's kernel (interpret mode), the
    port's plain version and the model of the tensor-core kernel agree."""
    g = np.random.default_rng(BH * T + dh)
    q, k, v = (_bf16(g, (BH, T, dh)) for _ in range(3))
    mask = None
    if kind == "dense":
        mask = np.where(g.random((BH, T, T)) < 0.3, NEG_INF, 0.0).astype(np.float32)
        mask[..., 0] = 0.0
    elif kind == "folded":
        causal = np.where(np.arange(T)[None, :] <= np.arange(T)[:, None], 0.0, NEG_INF)
        key = _key_row(g, BH, T, False)
        mask = (np.zeros((BH, T, T), np.float32) + causal.astype(np.float32)) + key[:, None, :]
    tm = None if mask is None else torch.from_numpy(mask)
    model = mma_model(q, k, v, dense=tm)
    want = jattn.attention_small(_j(q), _j(k), _j(v), None if mask is None else jnp.asarray(mask),
                                 interpret=True)
    _close(model, want)
    _close(model, cf.attention_small_reference(q, k, v, tm))


def test_split_p_keeps_the_fp32_product():
    """Before the output's rounding, the hi/lo split of P leaves the model
    within 2e-5 of the plain fp32 function (P kept to ~2^-17)."""
    g = np.random.default_rng(0)
    N, T, dh = 4, 200, 64
    q, k, v = (_bf16(g, (N, T, dh)) for _ in range(3))
    got = mma_model(q, k, v, round_output=False)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (float(dh) ** -0.5)
    want = torch.matmul(torch.softmax(s, dim=-1), v.float())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def _hi_lo_matmul(a, b):
    """a @ b with a (fp32) split into bf16 hi + lo, b bf16-exact."""
    hi = a.bfloat16().float()
    lo = (a - hi).bfloat16().float()
    return torch.matmul(hi, b) + torch.matmul(lo, b)


def _scores(a, b, scale, key, causal, transpose=False):
    """Masked fp32 scores [N, Tq, S] of rows a against rows b (or their
    transpose [N, S, Tq], formed as b a^T, as launch B forms them)."""
    s = torch.matmul(b, a.transpose(1, 2)).transpose(1, 2) if transpose else \
        torch.matmul(a, b.transpose(1, 2))
    s = s * scale
    if key is not None:
        s = s + key[:, None, :]
    if causal:
        Tq, S = s.shape[1:]
        keep = torch.arange(S)[None, :] <= torch.arange(Tq)[:, None]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def bwd_model(q, k, v, do, key=None, causal=False, round_output=True):
    """q, do [N, Tq, dh], k, v [N, S, dh] bf16; key [N, S] additive fp32 ->
    (dq, dk, dv) in bf16 (fp32 with ``round_output=False``), with the
    tensor-core kernels' roundings."""
    dh = q.shape[2]
    S = k.shape[1]
    scale = float(dh) ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))

    # launch A
    s = _scores(qf, kf, scale, key, causal)
    dp = torch.matmul(gf, vf.transpose(1, 2))
    m = torch.full(s.shape[:2], NEG_INF)
    l = torch.zeros(s.shape[:2])
    a = torch.zeros(s.shape[:2])
    for c0 in range(0, S, CHUNK):
        sc, dpc = s[..., c0 : c0 + CHUNK], dp[..., c0 : c0 + CHUNK]
        mn = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - mn)
        e = torch.exp(sc - mn[..., None])
        l = l * corr + e.sum(dim=-1)
        a = a * corr + (dpc * e).sum(dim=-1)
        m = mn
    inv = 1.0 / l
    rs = a * inv
    p = torch.exp(s - m[..., None]) * inv[..., None]
    dq = _hi_lo_matmul((p * (dp - rs[..., None])) * scale, kf)

    # launch B: the same products transposed, p and dz from A's statistics
    st = _scores(qf, kf, scale, key, causal, transpose=True)
    dpt = torch.matmul(vf, gf.transpose(1, 2)).transpose(1, 2)
    pt = torch.exp(st - m[..., None]) * inv[..., None]
    zt = (pt * (dpt - rs[..., None])) * scale
    dv = _hi_lo_matmul(pt.transpose(1, 2), gf)
    dk = _hi_lo_matmul(zt.transpose(1, 2), qf)
    out = (dq, dk, dv)
    return tuple(t.bfloat16() for t in out) if round_output else out


BWD_CASES = [  # Tq, S, heads, dh, mask kind
    (50, 50, 2, 64, "none"),  # the vision tower's length
    (48, 48, 2, 64, "causal_key_fully_masked"),  # the text tower's, one row with no key
    (40, 70, 2, 64, "key"),  # Tq < S, two 64-key chunks
    (70, 40, 3, 8, "causal_key"),  # Tq > S
    (136, 136, 2, 16, "key"),  # three 64-key chunks, the last one of 8 keys
    (32, 32, 3, 8, "causal"),
]


@pytest.mark.parametrize("Tq,S,h,dh,kind", BWD_CASES)
def test_bwd_model_matches_jax_attention_nhd_bwd(Tq, S, h, dh, kind):
    """``_attention_nhd_bwd_call`` in bf16: JAX's kernel (interpret mode),
    the port's plain version and the model of the tensor-core kernels agree
    on dq, dk and dv."""
    g = np.random.default_rng(Tq + S + dh)
    B, D = 3, h * dh
    q, do = _bf16(g, (B, Tq, D)), _bf16(g, (B, Tq, D))
    k, v = _bf16(g, (B, S, D)), _bf16(g, (B, S, D))
    km = _key_row(g, B, S, "fully_masked" in kind) if "key" in kind else None
    causal = "causal" in kind
    assert jattn._padded_seq_len(Tq) == Tq and jattn._padded_seq_len(S) == S  # JAX pads nothing
    want = jattn._attention_nhd_bwd_call(
        _j(q), _j(k), _j(v), _j(do), None if km is None else jnp.asarray(km), h,
        causal=causal, interpret=True,
    )
    key = None if km is None else torch.from_numpy(km).repeat_interleave(h, dim=0)
    got = [_unheads(t, B, h) for t in bwd_model(_heads(q, h), _heads(k, h), _heads(v, h),
                                                _heads(do, h), key=key, causal=causal)]
    plain = ca.attention_nhd_bwd(q, k, v, do, h, None if km is None else torch.from_numpy(km),
                                 causal)
    for name, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert torch.isfinite(a.float()).all(), name
        _close(a, w)
        _close(a, p)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_model_fully_masked_row_is_uniform(causal):
    """A batch row whose keys are all masked at -FLT_MAX: the running max
    stays -FLT_MAX, every key weighs 1 / S, and the model's gradients are the
    plain version's (finite), with and without the causal mask."""
    g = np.random.default_rng(int(causal))
    B, T, h, dh = 2, 70, 2, 8
    q, k, v, do = (_bf16(g, (B, T, h * dh)) for _ in range(4))
    km = _key_row(g, B, T, True)
    key = torch.from_numpy(km).repeat_interleave(h, dim=0)
    got = [_unheads(t, B, h) for t in bwd_model(_heads(q, h), _heads(k, h), _heads(v, h),
                                                _heads(do, h), key=key, causal=causal)]
    plain = ca.attention_nhd_bwd_reference(q, k, v, do, h, torch.from_numpy(km), causal)
    for name, a, p in zip(("dq", "dk", "dv"), got, plain):
        assert torch.isfinite(a.float()).all(), name
        _close(a, p)


def test_bwd_split_keeps_the_fp32_gradients():
    """Before the outputs' rounding, the hi/lo split of p and dz and the
    statistics round trip leave the model within 3e-5 of the plain fp32
    backward on the same bf16 inputs (p and dz kept to ~2^-17; the rest is
    fp32 sums of dp ~ 10 in another order), a hundredth of a bf16 ulp of
    gradients of ~1-4."""
    g = np.random.default_rng(0)
    B, T, h, dh = 2, 100, 2, 64
    q, k, v, do = (_bf16(g, (B, T, h * dh)) for _ in range(4))
    got = bwd_model(_heads(q, h), _heads(k, h), _heads(v, h), _heads(do, h), causal=True,
                    round_output=False)
    want = ca.attention_nhd_bwd_reference(q.float(), k.float(), v.float(), do.float(), h,
                                          None, True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(_unheads(a, B, h), w, atol=3e-5, rtol=0, msg=name)
