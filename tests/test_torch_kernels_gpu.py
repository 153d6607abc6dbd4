"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no card is present (decided inside each
test, so every pytest-xdist worker collects the same tests). On the card
machine, which has neither JAX nor PIL for ``tests/conftest.py``:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.

Tolerances: fp32 atol 1e-4 (+ rtol 1e-5 for the K=3072 products); bf16
rtol 2^-7 (one rounding of the output, 1 ulp) + atol 1e-3. Gradients
through the autograd Functions against torch autograd of the plain
versions in fp32 (TF32 off): atol 1e-4, rtol 1e-4 (sums over up to 3,072
products in another order). The bf16 ``dense`` and its gradients against
autograd of its plain definition: rtol 2^-7 + atol 1e-3 (one rounding of
each side from an fp32 sum)."""

import pytest
import torch

from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci
from multimodal_content_moderation_tpu_torch.ops import layers

TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2.0**-7)}

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _assert_close(got, want):
    atol, rtol = TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,D", [(144 * 49, 3072, 768), (1000, 3072, 768), (37, 768, 72)])
def test_patch_embed_u8_kernel(R, K, D, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(R)
    x = torch.randint(0, 256, (1, R, K), generator=g, device="cuda", dtype=torch.uint8)
    w = torch.randn(K, D, generator=g, device="cuda") * 3e-4
    b = torch.randn(D, generator=g, device="cuda")
    before = ci.patch_embed_u8.launches
    got = ci.patch_embed_u8(x, w, b, dtype)
    assert ci.patch_embed_u8.launches == before + 1
    _assert_close(got, ci.patch_embed_reference(x, w, b, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,T,D,h,causal,with_km",
    [
        (8, 50, 768, 12, False, False),
        (8, 77, 512, 8, True, True),
        (4, 32, 512, 8, True, True),
        (3, 131, 256, 4, True, True),
        (2, 197, 768, 12, False, True),
        (2, 5, 16, 2, False, True),
    ],
)
def test_attention_nhd_kernel(B, T, D, h, causal, with_km, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T)
    q, k, v = (torch.randn(B, T, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    km = None
    if with_km:
        lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
        lengths[0] = 0  # every key masked: a uniform average
        km = (1.0 - (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()) * ca.NEG_INF
    got = ca.attention_nhd(q, k, v, h, km, causal)
    assert torch.isfinite(got.float()).all()
    _assert_close(got, ca.attention_nhd_reference(q, k, v, h, km, causal))


def _key_mask(g, B, T, fully_masked_row=True):
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    if fully_masked_row:
        lengths[0] = 0  # every key masked: a uniform average
    return (1.0 - (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()) * ca.NEG_INF


BWD_SHAPES = [
    (8, 50, 768, 12, False, False),
    (8, 48, 512, 8, True, True),
    (4, 77, 512, 8, True, True),
    (3, 131, 256, 4, True, True),
    (2, 197, 768, 12, False, True),
    (2, 256, 256, 2, True, True),
    (2, 5, 16, 2, False, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,h,causal,with_km", BWD_SHAPES)
def test_attention_nhd_bwd_kernel(B, T, D, h, causal, with_km, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + 1)
    q, k, v, do = (torch.randn(B, T, D, generator=g, device="cuda").to(dtype) for _ in range(4))
    km = _key_mask(g, B, T) if with_km else None
    before = ca.attention_nhd_bwd.launches
    got = ca.attention_nhd_bwd(q, k, v, do, h, km, causal)
    assert ca.attention_nhd_bwd.launches == before + 1
    want = ca.attention_nhd_bwd_reference(q, k, v, do, h, km, causal)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        _assert_close(a, b)


@pytest.mark.parametrize("B,T,D,h,causal,with_km", BWD_SHAPES[:3])
def test_attention_nhd_diff_matches_autograd_of_plain(B, T, D, h, causal, with_km):
    """Every row keeps a key: in a row whose keys are all masked, the
    recompute formula (JAX's, which the kernel follows) sends gradient
    through the causal positions, where autograd of torch.where sends none."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + 2)
    q, k, v, do = (torch.randn(B, T, D, generator=g, device="cuda") for _ in range(4))
    km = _key_mask(g, B, T, fully_masked_row=False) if with_km else None
    grads = []
    for fn in (
        lambda a, b, c: ca.attention_nhd_diff(a, b, c, km, h, causal),
        lambda a, b, c: ca.attention_nhd_reference(a, b, c, h, km, causal),
    ):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_patch_embed_u8_train_grads():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (4, 49, 3072), generator=g, device="cuda", dtype=torch.uint8)
    w = (torch.randn(3072, 768, generator=g, device="cuda") * 3e-4).requires_grad_()
    b = torch.randn(768, generator=g, device="cuda").requires_grad_()
    gy = torch.randn(4, 49, 768, generator=g, device="cuda")
    before = ci.patch_embed_u8.launches
    got = torch.autograd.grad(ci.patch_embed_u8_train(x, w, b, torch.float32), (w, b), gy)
    assert ci.patch_embed_u8.launches == before + 1
    want = torch.autograd.grad(ci.patch_embed_reference(x, w, b, torch.float32), (w, b), gy)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("B,T,d_in,d_out", [(3, 5, 64, 32), (32, 50, 768, 3072), (32, 48, 2048, 512)])
def test_dense_bf16_rounds_once_and_differentiates(B, T, d_in, d_out):
    """The bf16 dense and its backward (the fp32-output product's) against
    autograd of ``(x @ bf16(w) + b)`` in fp32 rounded once to bf16, with a
    random cotangent: each side rounds once from an fp32 sum (1 ulp)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(B, T, d_in, generator=g, device="cuda").bfloat16()
    w = torch.randn(d_in, d_out, generator=g, device="cuda") * d_in ** -0.5
    b = torch.randn(d_out, generator=g, device="cuda")
    gy = torch.randn(B, T, d_out, generator=g, device="cuda").bfloat16()
    results = []
    for fn in (lambda x_, w_, b_: layers.dense(x_, {"w": w_, "b": b_}),
               lambda x_, w_, b_: (x_.float() @ w_.bfloat16().float() + b_).bfloat16()):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*leaves)
        results.append((y.detach(),) + torch.autograd.grad(y, leaves, gy))
    got, want = results
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]
    for a, c in zip(got, want):
        assert a.dtype == c.dtype
        torch.testing.assert_close(a.float(), c.float(), atol=1e-3, rtol=2.0**-7)


def test_wrappers_refuse_bad_inputs():
    _need_card()
    x = torch.zeros(1, 4, 48, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        ci.patch_embed_u8(x, torch.zeros(48, 8, device="cuda", dtype=torch.bfloat16),
                          torch.zeros(8, device="cuda"))
    q = torch.zeros(2, 300, 64, device="cuda")
    with pytest.raises(ValueError):
        ca.attention_nhd(q, q, q, 1)
    with pytest.raises(ValueError):
        ca.attention_nhd_bwd(q, q, q, q, 1)
    q = torch.zeros(2, 8, 64, device="cuda")
    with pytest.raises(ValueError):
        ca.attention_nhd_bwd(q, q, q, q.bfloat16(), 1)
