"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no card is present (decided inside each
test, so every pytest-xdist worker collects the same tests). On the card
machine, which has neither JAX nor PIL for ``tests/conftest.py``:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.

Tolerances: fp32 atol 1e-4 (+ rtol 1e-5 for the K=3072 products); bf16
rtol 2^-7 (one rounding of the output, 1 ulp) + atol 1e-3."""

import pytest
import torch

from multimodal_content_moderation_tpu_torch.ops import cuda_attention as ca
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci

TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2.0**-7)}

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card machine)")


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


def test_wrappers_refuse_bad_inputs():
    _need_card()
    x = torch.zeros(1, 4, 48, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        ci.patch_embed_u8(x, torch.zeros(48, 8, device="cuda", dtype=torch.bfloat16),
                          torch.zeros(8, device="cuda"))
    q = torch.zeros(2, 300, 64, device="cuda")
    with pytest.raises(ValueError):
        ca.attention_nhd(q, q, q, 1)
