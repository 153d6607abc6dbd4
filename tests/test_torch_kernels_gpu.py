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
each side from an fp32 sum). ``flash_attention`` and ``attention_small``
against their plain versions: fp32 atol 1e-4, bf16 rtol 2^-7 + atol 1e-3
(an online softmax on the card, one softmax in the plain version).

bf16 ``patch_embed_u8``, ``attention_nhd``, ``attention_nhd_bwd``,
``flash_attention`` and ``attention_small`` calls run the tensor-core kernels (``csrc/mma_common.cuh``,
``csrc/attention_mma.cuh``) and fp32 calls the SIMT ones: every call adds
one to the wrapper's ``launches``, and a bf16 call one to its
``tensor_core_launches`` too.

``add_layer_norm`` against its plain version: the rounded sum bit for bit,
the normalised rows bf16 rtol 2^-7 + atol 1e-3 (fp32 statistics summed in
another order can flip one rounding). The fused bf16 forward of a
full-width SigLIP2-B/16-224, CLIP ViT-B/32 and ViT-B/16 + BERT-base engine
against the plain schedule of the same engine: logits atol 0.03 (the GEMMs' sums in another order, rounded to bf16
at every layer over 12 blocks)."""

import pytest
import torch

from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
from multimodal_content_moderation_tpu_torch.ops import cuda_flash as cf
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci
from multimodal_content_moderation_tpu_torch.ops import cuda_norm as cn
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


def _launch_counted(kernel, dtype, call):
    """``call()`` through ``kernel``'s wrapper: one launch, on the tensor
    cores exactly when the inputs are bf16."""
    before = kernel.launches, kernel.tensor_core_launches
    out = call()
    assert kernel.launches == before[0] + 1
    assert kernel.tensor_core_launches == before[1] + int(dtype == torch.bfloat16)
    return out


EMBED_SHAPES = [
    # R, K, D, x's storage offset (bytes)
    (144 * 49, 3072, 768, 0),
    (1000, 3072, 768, 0),
    (37, 768, 72, 0),
    (1, 588, 72, 0),  # K = 3 * 14 * 14: not a multiple of 16, element staging, a k tail
    (1000, 588, 72, 0),
    (1568, 3072, 768, 0),  # 128-row tiles would leave SMs idle: 64-row tiles
    (300, 48, 70, 0),  # D not a multiple of 4: element weight staging
    (129, 768, 33, 0),  # odd D: element stores
    (64, 768, 128, 1),  # rows 1 byte off 16-byte alignment
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,D,offset", EMBED_SHAPES)
def test_patch_embed_u8_kernel(R, K, D, offset, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(R + K + D)
    x = torch.randint(0, 256, (R * K + offset,), generator=g, device="cuda",
                      dtype=torch.uint8)[offset:].view(1, R, K)
    w = torch.randn(K, D, generator=g, device="cuda") * 3e-4
    b = torch.randn(D, generator=g, device="cuda")
    got = _launch_counted(ci.patch_embed_u8, dtype, lambda: ci.patch_embed_u8(x, w, b, dtype))
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
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
    got = _launch_counted(ca.attention_nhd, dtype, lambda: ca.attention_nhd(q, k, v, h, km, causal))
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
    got = _launch_counted(ca.attention_nhd_bwd, dtype,
                          lambda: ca.attention_nhd_bwd(q, k, v, do, h, km, causal))
    want = ca.attention_nhd_bwd_reference(q, k, v, do, h, km, causal)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        _assert_close(a, b)


BWD_TC_SHAPES = [
    # B, Tq, S, D, heads, causal, key mask, storage offset (elements)
    (3, 1, 1, 64, 1, False, True, 0),  # S = 1; batch row 0 fully masked
    (2, 5, 5, 32, 2, True, True, 0),  # dh = 16
    (2, 50, 50, 768, 12, False, False, 1),  # 2 bytes off 16-byte alignment: element staging
    (2, 77, 77, 512, 8, True, True, 0),
    (2, 131, 131, 256, 2, True, True, 0),  # dh = 128, three 64-row chunks
    (2, 256, 256, 256, 2, True, True, 0),  # dh = 128 at the largest S
    (2, 40, 133, 128, 2, False, True, 0),  # Tq < S, ragged
    (2, 100, 30, 256, 4, True, True, 0),  # Tq > S, causal
    (2, 33, 33, 36, 3, True, True, 0),  # dh = 12: zero columns, paired stores
    (2, 17, 17, 15, 3, False, True, 0),  # dh = 5 (odd): element stores
]


@pytest.mark.parametrize("B,Tq,S,D,h,causal,with_km,offset", BWD_TC_SHAPES)
def test_attention_nhd_bwd_tensor_core_edge_shapes(B, Tq, S, D, h, causal, with_km, offset):
    """bf16 through the tensor-core kernels at head widths 16-128 and off the
    MMA widths, S from 1 to 256, Tq != S, a fully masked row and rows off
    16-byte alignment; the same inputs in fp32 through the SIMT kernels."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(Tq + S + D)
    for dtype in (torch.bfloat16, torch.float32):
        q, do = (_offset_randn(g, (B, Tq, D), offset, dtype) for _ in range(2))
        k, v = (_offset_randn(g, (B, S, D), offset, dtype) for _ in range(2))
        km = _key_mask(g, B, S) if with_km else None
        got = _launch_counted(ca.attention_nhd_bwd, dtype,
                              lambda: ca.attention_nhd_bwd(q, k, v, do, h, km, causal))
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
    got = _launch_counted(ci.patch_embed_u8, torch.float32, lambda: torch.autograd.grad(
        ci.patch_embed_u8_train(x, w, b, torch.float32), (w, b), gy))
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


FLASH_SHAPES = [
    # B, H, T, S, dh, mask kind, causal
    (2, 12, 576, 576, 64, None, False),  # SigLIP2-B/16-384 vision, no mask
    (2, 4, 300, 300, 64, "key", True),  # ragged, causal + key mask
    (2, 2, 384, 384, 32, "dense", False),
    (2, 2, 128, 576, 64, "key", False),  # cross attention, T != S
    (1, 2, 257, 257, 128, "dense_key", True),
    (3, 1, 70, 70, 8, "key", False),
]


def _flash_inputs(B, H, T, S, dh, kind, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, T, dh, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, H, S, dh, generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = km = None
    if kind in ("key", "dense_key"):
        km = _key_mask(g, B, S)  # batch row 0: every key masked
    if kind in ("dense", "dense_key"):
        mask = torch.where(torch.rand(B, 1, T, S, generator=g, device="cuda") < 0.2,
                           ca.NEG_INF, 0.0)
        mask[..., 0] = 0.0
    return q, k, v, mask, km


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,S,dh,kind,causal", FLASH_SHAPES)
def test_flash_attention_kernel(B, H, T, S, dh, kind, causal, dtype):
    _need_card()
    q, k, v, mask, km = _flash_inputs(B, H, T, S, dh, kind, dtype, T + dh)
    got = _launch_counted(cf.flash_attention, dtype,
                          lambda: cf.flash_attention(q, k, v, mask, km, causal))
    assert torch.isfinite(got.float()).all()
    _assert_close(got, cf.flash_attention_reference(q, k, v, mask, km, causal))


NHD_TC_SHAPES = [
    # B, Tq, S, D, heads, causal, key mask, storage offset (elements)
    (3, 77, 77, 32, 2, True, True, 0),  # dh = 16
    (2, 256, 256, 256, 2, True, True, 0),  # dh = 128: 8 warps of two row groups
    (2, 200, 200, 256, 2, False, True, 0),  # dh = 128, ragged against 64 keys
    (3, 40, 133, 128, 2, False, True, 0),  # ragged S != Tq
    (2, 50, 50, 768, 12, False, False, 1),  # 2 bytes off 16-byte alignment: element loads
    (2, 33, 33, 36, 3, True, True, 0),  # dh = 12: element K/V rows, paired q and out
    (2, 17, 17, 15, 3, False, True, 0),  # dh = 5 (odd): element loads and stores
]


def _simt_fits(S, dh):
    """The fp32 SIMT kernel keeps a head's K and V as fp32 in shared memory:
    at S = 256, dh = 128 that is 264 KB, past the card's 227 KB (it raises)."""
    return 4 * (S * (2 * dh + 1) + 5 * S + 4 * dh) <= 232448


def _offset_randn(g, shape, offset, dtype):
    """A contiguous tensor whose storage starts ``offset`` elements in."""
    n = 1
    for d in shape:
        n *= d
    return torch.randn(n + offset, generator=g, device="cuda").to(dtype)[offset:].view(shape)


@pytest.mark.parametrize("B,Tq,S,D,h,causal,with_km,offset", NHD_TC_SHAPES)
def test_attention_nhd_tensor_core_edge_shapes(B, Tq, S, D, h, causal, with_km, offset):
    """bf16 through the tensor-core kernel at head widths 16, 128 and off
    the MMA widths, ragged S, and rows off 16-byte alignment; the same
    inputs in fp32 through the SIMT kernel."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(Tq + S + D)
    dtypes = (torch.bfloat16, torch.float32) if _simt_fits(S, D // h) else (torch.bfloat16,)
    for dtype in dtypes:
        q = _offset_randn(g, (B, Tq, D), offset, dtype)
        k, v = (_offset_randn(g, (B, S, D), offset, dtype) for _ in range(2))
        km = _key_mask(g, B, S) if with_km else None
        got = _launch_counted(ca.attention_nhd, dtype,
                              lambda: ca.attention_nhd(q, k, v, h, km, causal))
        assert torch.isfinite(got.float()).all()
        _assert_close(got, ca.attention_nhd_reference(q, k, v, h, km, causal))


FLASH_TC_SHAPES = [
    # B, H, T, S, dh, mask kind, causal
    (2, 3, 300, 300, 16, "key", True),  # dh = 16
    (1, 2, 300, 700, 128, "dense_key", False),  # dh = 128, S != T
    (2, 2, 100, 333, 64, "key", False),  # ragged S, one query tile
    (2, 2, 290, 290, 40, None, True),  # dh = 40: zero columns up to 64
]


@pytest.mark.parametrize("B,H,T,S,dh,kind,causal", FLASH_TC_SHAPES)
def test_flash_attention_tensor_core_edge_shapes(B, H, T, S, dh, kind, causal):
    _need_card()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, mask, km = _flash_inputs(B, H, T, S, dh, kind, dtype, T + S + dh)
        got = _launch_counted(cf.flash_attention, dtype,
                              lambda: cf.flash_attention(q, k, v, mask, km, causal))
        assert torch.isfinite(got.float()).all()
        _assert_close(got, cf.flash_attention_reference(q, k, v, mask, km, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_strided_unaligned_view(dtype):
    """q, k, v as views that start 2 bytes into rows of an odd stride: no
    16-byte copies and no paired loads, the element path of both kernels."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, T, dh = 2, 3, 280, 64
    base = [torch.randn(B, H, T, dh + 3, generator=g, device="cuda").to(dtype) for _ in range(3)]
    q, k, v = (t[..., 1:dh + 1] for t in base)
    assert q.stride(2) % 2 == 1 and q.data_ptr() % 16 != 0
    km = _key_mask(g, B, T)
    got = _launch_counted(cf.flash_attention, dtype,
                          lambda: cf.flash_attention(q, k, v, None, km, True))
    _assert_close(got, cf.flash_attention_reference(q, k, v, None, km, True))


@pytest.mark.parametrize(
    "kernel",
    ["attention_nhd", "flash_attention", "patch_embed_u8", "attention_nhd_bwd", "attention_small"])
def test_simt_kernel_stays_the_earlier_bf16_design(kernel):
    """The uncounted SIMT entry (the yardstick chip_smoke.py times) agrees
    with the plain version on the same bf16 inputs, and neither count
    moves."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    if kernel == "attention_nhd":
        q, k, v = (torch.randn(4, 77, 512, generator=g, device="cuda").bfloat16() for _ in range(3))
        km = _key_mask(g, 4, 77)
        wrapper = ca.attention_nhd
        before = wrapper.launches, wrapper.tensor_core_launches
        got = [ca.attention_nhd_simt(q, k, v, 8, km, True)]
        want = [ca.attention_nhd_reference(q, k, v, 8, km, True)]
    elif kernel == "flash_attention":
        q, k, v, mask, km = _flash_inputs(2, 4, 300, 300, 64, "key", torch.bfloat16, 3)
        wrapper = cf.flash_attention
        before = wrapper.launches, wrapper.tensor_core_launches
        got = [cf.flash_attention_simt(q, k, v, mask, km, True)]
        want = [cf.flash_attention_reference(q, k, v, mask, km, True)]
    elif kernel == "patch_embed_u8":
        x = torch.randint(0, 256, (2, 49, 3072), generator=g, device="cuda", dtype=torch.uint8)
        w = torch.randn(3072, 768, generator=g, device="cuda") * 3e-4
        b = torch.randn(768, generator=g, device="cuda")
        wrapper = ci.patch_embed_u8
        before = wrapper.launches, wrapper.tensor_core_launches
        got = [ci.patch_embed_u8_simt(x, w, b, torch.bfloat16)]
        want = [ci.patch_embed_reference(x, w, b, torch.bfloat16)]
    elif kernel == "attention_small":
        q, k, v = (torch.randn(4, 8, 77, 64, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        mask = torch.where(torch.rand(4, 1, 77, 77, generator=g, device="cuda") < 0.3,
                           ca.NEG_INF, 0.0)
        wrapper = cf.attention_small
        before = wrapper.launches, wrapper.tensor_core_launches
        got = [cf.attention_small_simt(q, k, v, mask)]
        want = [cf.attention_small_reference(q, k, v, mask)]
    else:
        q, k, v, do = (torch.randn(4, 48, 512, generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        km = _key_mask(g, 4, 48)
        wrapper = ca.attention_nhd_bwd
        before = wrapper.launches, wrapper.tensor_core_launches
        got = ca.attention_nhd_bwd_simt(q, k, v, do, 8, km, True)
        want = ca.attention_nhd_bwd_reference(q, k, v, do, 8, km, True)
    assert (wrapper.launches, wrapper.tensor_core_launches) == before
    for a, c in zip(got, want):
        _assert_close(a, c)


def test_flash_attention_reads_the_projection_layout():
    """[B, T, D] memory viewed as [B, H, T, dh] (the view mha passes): the
    same result as contiguous inputs, and an output whose [B, T, D] view is
    free."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, dh = 3, 300, 12, 64
    q3, k3, v3 = (torch.randn(B, T, H * dh, generator=g, device="cuda") for _ in range(3))
    views = [t.view(B, T, H, dh).transpose(1, 2) for t in (q3, k3, v3)]
    got = cf.flash_attention(*views)
    _assert_close(got, cf.flash_attention(*(t.contiguous() for t in views)))
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "BH,T,S,dh,with_mask", [(64, 77, 77, 64, True), (32, 50, 50, 64, False),
                            (8, 256, 256, 128, True), (6, 20, 130, 16, True), (4, 5, 5, 8, False)]
)
def test_attention_small_kernel(BH, T, S, dh, with_mask, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + S)
    q = torch.randn(BH, T, dh, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(BH, S, dh, generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(BH, T, S, generator=g, device="cuda") < 0.3, ca.NEG_INF, 0.0)
        mask[0] = ca.NEG_INF  # slice 0: every key masked, a uniform average
    got = _launch_counted(cf.attention_small, dtype, lambda: cf.attention_small(q, k, v, mask))
    assert got.shape == q.shape and got.is_contiguous()
    assert torch.isfinite(got.float()).all()
    _assert_close(got, cf.attention_small_reference(q, k, v, mask))


SMALL_VIEW_SHAPES = [
    # B, H, T, S, dh, mask kind ("key": [B, 1, T, S]; "dense": [B, H, T, S];
    # "shared": [T, S]), q's storage offset (elements)
    (64, 8, 77, 77, 64, "key", 0),  # the mha dense-mask path's shape
    (3, 4, 200, 256, 128, "dense", 0),  # dh = 128, four key chunks, S != T
    (2, 3, 1, 130, 16, "shared", 0),  # one query row, ragged S
    (2, 2, 70, 70, 40, "key", 0),  # dh = 40: zero columns up to 64
    (2, 2, 33, 33, 5, "dense", 1),  # dh = 5 (odd), unaligned rows: element loads
]


@pytest.mark.parametrize("B,H,T,S,dh,kind,offset", SMALL_VIEW_SHAPES)
def test_attention_small_reads_views_and_broadcast_masks(B, H, T, S, dh, kind, offset):
    """[B, T, D] memory viewed as [B, H, T, dh] (the view mha passes) and a
    mask read with its broadcast strides: the same result as the plain
    version, an output whose [B, T, D] view is free, and the contiguous
    [B*H, T, dh] form of the JAX contract gives the same numbers."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + S + dh)
    shape = {"key": (B, 1, T, S), "dense": (B, H, T, S), "shared": (T, S)}[kind]
    mask = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.3, ca.NEG_INF, 0.0)
    mask[..., 0] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q3 = _offset_randn(g, (B, T, H * dh), offset, dtype)
        k3, v3 = (_offset_randn(g, (B, S, H * dh), offset, dtype) for _ in range(2))
        q, k, v = (t.view(B, t.shape[1], H, dh).transpose(1, 2) for t in (q3, k3, v3))
        got = _launch_counted(cf.attention_small, dtype,
                              lambda: cf.attention_small(q, k, v, mask))
        assert got.shape == (B, H, T, dh) and got.transpose(1, 2).is_contiguous()
        assert torch.isfinite(got.float()).all()
        _assert_close(got, cf.attention_small_reference(q, k, v, mask))
        flat = [t.reshape(B * H, t.shape[2], dh) for t in (q, k, v)]
        m3 = mask.expand(B, H, T, S).reshape(B * H, T, S)
        torch.testing.assert_close(cf.attention_small(*flat, m3).view(B, H, T, dh), got,
                                   atol=0, rtol=0)


def test_attention_small_fully_masked_rows():
    """A row whose keys are all at -FLT_MAX averages them; a row of -inf
    entries (a causal and a key mask of -FLT_MAX added) is NaN, as in the
    plain version, in both kernels."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    BH, T, dh = 4, 77, 64
    mask = torch.zeros(BH, T, T, device="cuda")
    mask[1] = ca.NEG_INF
    mask[2, 5] = float("-inf")
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(BH, T, dh, generator=g, device="cuda").to(dtype) for _ in range(3))
        got = cf.attention_small(q, k, v, mask).float()
        want = cf.attention_small_reference(q, k, v, mask).float()
        assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[2, 5]).all()
        keep = ~torch.isnan(want)
        _assert_close(got[keep].to(dtype), want[keep].to(dtype))
        _assert_close(got[1].to(dtype), v[1].float().mean(0).expand(T, dh).to(dtype))


@pytest.mark.parametrize("T,dense", [(289, False), (289, True), (77, True)])
def test_mha_pallas_kernels_match_xla_core(T, dense):
    """``mha(impl="pallas")`` through fused_mha on the card (flash_attention
    at T=289, attention_small for a dense mask at T=77) against the "xla"
    core, in fp32."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T)
    B, D, h = 4, 256, 4
    p = {n: {"w": torch.randn(D, D, generator=g, device="cuda") * D ** -0.5,
             "b": torch.randn(D, generator=g, device="cuda") * 0.1} for n in "qkvo"}
    x = torch.randn(B, T, D, generator=g, device="cuda")
    mask = None
    if dense:
        mask = torch.where(torch.rand(B, 1, T, T, generator=g, device="cuda") < 0.2, ca.NEG_INF, 0.0)
        mask[..., 0] = 0.0
    kernel = cf.attention_small if dense and T <= 256 else cf.flash_attention
    before = kernel.launches
    got = layers.mha(x, x, p, h, mask, impl="pallas")
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, layers.mha(x, x, p, h, mask, impl="xla"), atol=1e-4, rtol=1e-4)


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
    with pytest.raises(ValueError):  # attention_small is for T <= 256
        cf.attention_small(torch.zeros(2, 300, 64, device="cuda"),
                           torch.zeros(2, 300, 64, device="cuda"),
                           torch.zeros(2, 300, 64, device="cuda"))
    q4 = torch.zeros(1, 2, 300, 64, device="cuda")
    with pytest.raises(ValueError):  # the key row is fp32
        cf.flash_attention(q4, q4, q4, key_mask=torch.zeros(1, 300, device="cuda").bfloat16())
    with pytest.raises(ValueError):  # the last axis is contiguous
        cf.flash_attention(q4.transpose(2, 3), q4.transpose(2, 3), q4.transpose(2, 3))


NORM_SHAPES = [
    # R, D: the SigLIP2-B/16-224 vision tower (B=64 x 196), its text tower at
    # the bucket widths 32 / 48 / 64, the fusion head's 512 and 5 x 512; 2,048,
    # the warp-per-row width the RMSNorm instantiation brought
    (64 * 196, 768), (64 * 32, 768), (64 * 48, 768), (64 * 64, 768),
    (64, 512), (64, 2560), (77, 1024), (3, 24), (1, 3072), (4170, 2048),
]


@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("R,D", NORM_SHAPES)
def test_add_layer_norm_kernel(R, D, with_delta):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(R + D)
    x = (torch.randn(R, D, generator=g, device="cuda") * 3 + 1).bfloat16()
    d = torch.randn(R, D, generator=g, device="cuda").bfloat16() if with_delta else None
    scale = (1 + 0.2 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    bias = (0.2 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    before = cn.add_layer_norm.launches
    s, y = cn.add_layer_norm(x, d, scale, bias, 1e-6)
    assert cn.add_layer_norm.launches == before + 1
    want_s, want_y = cn.add_layer_norm_reference(x, d, scale, bias, 1e-6)
    assert torch.equal(s, want_s)
    _assert_close(y, want_y)


def test_add_layer_norm_reads_row_strided_views():
    """A [B, D] view of every row's first token (CLIP's post-LN input) and
    a delta of the same layout; a layout it does not take raises, a scale
    or bias off 16 bytes among them (the kernel reads them 16 bytes at a
    time)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    full = torch.randn(8, 50, 768, generator=g, device="cuda").bfloat16()
    scale = torch.randn(768, generator=g, device="cuda").bfloat16()
    bias = torch.randn(768, generator=g, device="cuda").bfloat16()
    x, d = full[:, 0], full[:, 1]
    assert cn.fits(x) and not x.is_contiguous()
    for got, want in zip(cn.add_layer_norm(x, d, scale, bias, 1e-5),
                         cn.add_layer_norm_reference(x, d, scale, bias, 1e-5)):
        _assert_close(got, want)
    odd = torch.zeros(4, 100, device="cuda").bfloat16()
    for bad in (full.transpose(0, 1), odd, full.float()):
        with pytest.raises(ValueError):
            cn.add_layer_norm(bad, None, scale[:bad.shape[-1]], bias[:bad.shape[-1]], 1e-5)
    off = torch.randn(769, generator=g, device="cuda").bfloat16()[1:]  # 2 bytes past 16
    assert off.is_contiguous() and not cn.fits(off)
    for sc, bi in ((off, bias), (scale, off)):
        with pytest.raises(ValueError):
            cn.add_layer_norm(x, d, sc, bi, 1e-5)
    torch.cuda.synchronize()  # the refusals launched nothing that faults


def test_dispatch_lays_out_what_the_kernel_cannot_read():
    """``layers.add_layer_norm`` on the fused schedule launches the kernel
    for operands it cannot read as they lie (rows and a scale 2 bytes off
    16, a transposed delta), copied to contiguous ones, and gives the plain
    version's result; the plain code runs only for a width it does not
    take."""
    from multimodal_content_moderation_tpu_torch.utils import profiling

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    R, D = 300, 768
    x = torch.randn(R * D + 1, generator=g, device="cuda").bfloat16()[1:].view(R, D)
    d = torch.randn(D, R, generator=g, device="cuda").bfloat16().t()
    scale = (1 + 0.2 * torch.randn(D + 1, generator=g, device="cuda")).bfloat16()[1:]
    bias = (0.2 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    assert not (cn.fits(x) or cn.fits(d) or cn.fits(scale))
    before = cn.add_layer_norm.launches
    with torch.no_grad(), profiling.recording() as rec:
        s, y = layers.add_layer_norm(x, d, {"scale": scale, "bias": bias}, 1e-5)
    assert cn.add_layer_norm.launches == before + 1
    assert rec.counters == {"model.add_ln.fused": 1}
    want_s, want_y = cn.add_layer_norm_reference(x, d, scale, bias, 1e-5)
    assert torch.equal(s, want_s)
    _assert_close(y, want_y)
    narrow = torch.randn(R, 100, generator=g, device="cuda").bfloat16()
    p100 = {"scale": scale[:100], "bias": bias[:100]}
    with torch.no_grad(), profiling.recording() as rec:
        got = layers.layer_norm(narrow, p100, 1e-5)
    assert rec.counters == {"model.layer_norm.plain": 1}
    assert cn.add_layer_norm.launches == before + 1
    assert torch.equal(got, cn.add_layer_norm_reference(narrow, None, *p100.values(), 1e-5)[1])


def test_training_products_ignore_an_earlier_eval():
    """A fused dense turns cuBLAS's bf16 reduced-precision reductions off
    for its own product alone: a bf16 training step's gradients are the
    same bit for bit before and after an evaluation under ``no_grad``,
    and the process-wide setting is as it was."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    # a long reduction over few outputs, where cuBLAS splits K
    x = torch.randn(32, 49, 8192, generator=g, device="cuda").bfloat16()
    p = {"w": (torch.randn(8192, 64, generator=g, device="cuda") * 0.01).bfloat16(),
         "b": torch.randn(64, generator=g, device="cuda").bfloat16()}
    gy = torch.randn(32, 49, 64, generator=g, device="cuda").bfloat16()

    def step():
        leaves = [x.clone().requires_grad_(), p["w"].clone().requires_grad_()]
        y = layers.dense(leaves[0], {"w": leaves[1], "b": p["b"]})
        return (y.detach(),) + torch.autograd.grad(y, leaves, gy)

    setting = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    first = step()
    with torch.no_grad():
        layers.dense(x, p)  # the fused schedule
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == setting
    for a, b in zip(first, step()):
        assert torch.equal(a, b)


def _engine(backend="siglip", seed=0):
    """A full-width fusion engine at ``bf16_fast`` with the attention kernels
    (random bf16 weights from ``seed``): SigLIP2-B/16-224, CLIP ViT-B/32, or
    ViT-B/16 + BERT-base ("generic")."""
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.backbones import backbone
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine
    from multimodal_content_moderation_tpu_torch.tools import _common

    model = model_io.build_model(
        "fusion", backend, _common.CLASSES, seed=seed, device="cuda",
        encoder_config=_common.encoder_config(backend))
    model = model_io.with_performance_options(
        model, compute_dtype="bfloat16", scores_dtype="bfloat16", attention_impl="pallas",
    ).to(torch.bfloat16)
    return FastInferenceEngine(model, *backbone(backend).image_stats)


# text widths a backend's batches run at: SigLIP's buckets (the carry column
# below 64), CLIP's bucket 32 and full 77, the generic towers' full width
WIDTHS = {"siglip": (64, (32, 48, 64)), "clip": (77, (32, 77)), "generic": (64, (64,))}


def _bucket_batches(engine, B=64, seed=0):
    """Pinned host batches at the backend's text widths (``WIDTHS``), ids and
    lengths drawn from ``seed``."""
    import numpy as np

    from multimodal_content_moderation_tpu_torch.models.fast_infer import bucket_batch_text

    backend = engine.model.backend
    T, widths = WIDTHS[backend]
    vocab = engine.model.encoder_config.text.vocab_size
    size = engine.model.image_size
    g = np.random.default_rng(seed)
    out = []
    for width in widths:
        top = width - 1 if backend == "siglip" and width < T else width
        lengths = g.integers(3, top + 1, size=B)
        ids = g.integers(2, vocab - 2, size=(B, T)).astype(np.int64)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int64)
        ids = ids * mask + (1 - mask)  # PAD id 1 past each row
        if backend == "clip":  # EOS, where CLIP pools, ends each row
            ids[np.arange(B), lengths - 1] = vocab - 1
        ids_b, mask_b, carry = bucket_batch_text(ids, mask, width, backend)
        patches = engine.patches_from_hwc(
            g.integers(0, 256, size=(B, size, size, 3), dtype=np.uint8))
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in
                (ids_b, mask_b, patches, np.ones(B, np.float32),
                 (g.random(B) < 0.9).astype(np.float32))]
        out.append((width, host, carry))
    return out


# the schedule counters of one forward. CLIP ViT-B/32: 12 + 12 blocks x 6
# dense, two projections, the fusion head's 7; 2 LayerNorms a block, the
# final, pre and post ones, the head's 2. SigLIP2-B/16-224: the text head and
# the MAP head's 6 in place of the projections; its final, post and MAP
# LayerNorms. ViT-B/16 + BERT-base: two poolers, the embedding and post
# LayerNorms; its towers pool in fp32 (the reference's pooling), so its
# fusion head runs in fp32, on the plain code.
COUNTS = {
    "clip": {"model.dense.fused": 24 * 6 + 2 + 7, "model.add_ln.fused": 24 * 2 + 3 + 2},
    "siglip": {"model.dense.fused": 24 * 6 + 6 + 1 + 7, "model.add_ln.fused": 24 * 2 + 3 + 2},
    "generic": {"model.dense.fused": 24 * 6 + 2, "model.add_ln.fused": 24 * 2 + 2,
                "model.dense.plain": 7, "model.layer_norm.plain": 2},
}


@pytest.mark.parametrize("backend", ["siglip", "clip", "generic"])
def test_fused_forward_matches_the_plain_schedule(backend):
    """Every dense and LayerNorm of the engine's bf16 forward takes the fused
    schedule (the counters; the generic head's fp32 ones the plain code),
    and its logits stay within 0.03 of the plain schedule's (the same
    engine's model called with gradients on) at each text width."""
    from multimodal_content_moderation_tpu_torch.utils import profiling

    _need_card()
    engine = _engine(backend)
    for width, host, carry in _bucket_batches(engine):
        with profiling.recording() as rec:
            got = engine(*host, carry_pos=carry)
        assert rec.counters == COUNTS[backend]
        batch = {k: t.to("cuda") for k, t in zip(
            ("input_ids", "attention_mask", "patches_u8", "text_present", "image_present"),
            host)}
        if carry is not None:
            pos = torch.arange(width, device="cuda")
            pos[-1] = carry
            batch["position_ids"] = pos
        with torch.enable_grad():
            want = engine.model(batch)["logits"].float()
        gap = float((got - want.detach()).abs().max())
        print(f"{backend} fused vs plain schedule, width {width}: max |logit gap| {gap:.5f}")
        assert gap <= 0.03


def test_engine_call_does_not_synchronise():
    """One engine call on pinned host inputs enqueues its copies and its
    forward without a synchronising operation (the fold is the engine's)."""
    _need_card()
    engine = _engine(seed=1)
    width, host, carry = _bucket_batches(engine, seed=1)[0]
    engine(*host, carry_pos=carry)  # loads the kernels, warms cuBLAS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = engine(*host, carry_pos=carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(logits.isfinite().all())
