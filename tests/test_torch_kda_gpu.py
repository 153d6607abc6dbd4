"""The KDA core's kernels (``csrc/kda.cu`` behind ``ops/kda.py``) and the
sigmoid router over a held share (``csrc/moe.cu`` behind ``ops/moe.py``)
against their plain versions on the card, at Kimi-Linear-48B-A3B's
published widths (32 heads of 128, hidden 2,304, a router of 256 experts at
top-8 of which 64 are held, experts of 1,024) and the benchmark cell's
batch (56 rows of 48-480 tokens, about 13,000 kept).

Marked ``gpu``: they skip where no card is present (decided inside each
test). On the card machine: ``python -m pytest --noconftest -m gpu
tests/test_torch_kda_gpu.py``.

Tolerances. The convolution and the output norm: bf16 rtol 2^-7 + atol 1e-3
(fp32 inside both, one rounding each: at most one ulp apart). The chunked
core, whose products take bf16 operands on the tensor cores (the state, the
inverse and the decays in fp32) where the plain form is fp32 throughout: an
absolute error under 2% of the largest output (about 3 bf16 ulps of it,
over sums of 64-128 products each rounded to 2^-9 relative), which a lost
chunk, a wrong decay or a dropped state would exceed by an order of
magnitude. Routing from the same fp32 logits: the top-k equal and the
weights to 1e-6 (one renormalisation in another summation order); the held
layer: bf16 rtol 2^-7 + atol 8e-3 (the 8 weighted rows, of magnitude up to
about 1 at a scaling of 2.446, each one bf16 ulp, 2^-8 of it, apart before
the fp32 sum; 1 of 30 M outputs read 3.9e-3 at 13,000 tokens)."""

import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu_torch.ops import kda, moe
from multimodal_content_moderation_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

H, HD = 32, 128
C = H * HD
D, F, WIDTH, HELD, K = 2304, 1024, 256, 64, 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rows(B=56, lo=48, hi=480, seed=0):
    """A [B, T] right-padded mask of row lengths in [lo, hi] and its packing
    on the card."""
    from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import pack

    g = np.random.default_rng(seed)
    lengths = g.integers(lo, hi + 1, size=B)
    T = int(lengths.max())
    mask = torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(np.int64)).cuda()
    kept = int(lengths.sum())
    pk = pack(mask, kept)
    return mask, pk, kda.rows(mask, pk.src, kept), T


def _inputs(N, seed=0, strong=False, cell=False):
    """Bf16 q~|k~|v~, the decay's and the gate's pre-activations, beta's
    logits (a [N, 32] column view of a wider tensor, as the model reads
    them) and the layer's parameters: A_log as the published init draws it
    (log U(1, 16)) and dt_bias N(0, 0.25), a decay of -1 to -11 a token, or
    (``cell``) as the Kimi-Linear cell draws them (A_log 1 + 0.7 N(0, 1),
    dt_bias -4), about -0.1 a token, so that the state carried from earlier
    chunks is most of each output."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    qkv = randn(N, 3 * C).bfloat16()
    f = randn(N, C).bfloat16()
    small = randn(N, 288).bfloat16()
    gate = randn(N, C).bfloat16()
    a_log = torch.log(torch.rand(H, generator=g, device="cuda") * 15 + 1)
    if strong:
        a_log[:4] = np.log(16.0)  # with f + dt_bias near 6: a decay of about -100 a token
        f[:, : 4 * HD] = 6.0
    p = {"conv": randn(3 * C, kda.TAPS, scale=0.5).bfloat16(), "A_log": a_log.bfloat16(),
         "dt_bias": randn(C, scale=0.5).bfloat16(),
         "o_norm": {"scale": (1 + 0.2 * randn(HD)).bfloat16()}}
    if cell:
        p["A_log"] = (1 + 0.7 * randn(H)).bfloat16()
        p["dt_bias"] = torch.full((C,), -4.0, device="cuda").bfloat16()
    return qkv, f, small[:, 256:], gate, p


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("lo,hi", [(48, 480), (1, 5)])
def test_conv_kernel(lo, hi):
    _need_card()
    mask, pk, r, T = _rows(lo=lo, hi=hi)
    qkv, _, _, _, p = _inputs(pk.src.shape[0])
    before = kda.conv.launches
    got = kda.conv(qkv, p["conv"], r, H)
    assert kda.conv.launches == before + 1
    want = kda.conv_reference(qkv, p["conv"], r.row, H, HD)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2.0 ** -7)


def _plain_core(qkv, f, b, p, r, src, T):
    """The plain chunked form of the convolved q, k, v (the kernel's own conv
    output, so that only the chunk launches differ)."""
    x = kda.conv(qkv, p["conv"], r, H)
    return x, kda.delta_rule_reference(x, f, b, p, r, src, T, H, HD)


@pytest.mark.parametrize("case", ["cell", "strong_decay", "short_rows", "long_memory"])
def test_chunk_and_state_kernels(case):
    _need_card()
    lo, hi = (1, 70) if case == "short_rows" else (48, 480)
    mask, pk, r, T = _rows(lo=lo, hi=hi, seed=1)
    qkv, f, b, _, p = _inputs(pk.src.shape[0], seed=1, strong=case == "strong_decay",
                              cell=case == "long_memory")
    x, want = _plain_core(qkv, f, b, p, r, pk.src, T)
    before = kda.chunk.launches, kda.state.launches
    got = kda.state(kda.chunk(x, f, b, p["A_log"], p["dt_bias"], r, H), r, H)
    assert (kda.chunk.launches, kda.state.launches) == (before[0] + 1, before[1] + 1)
    assert bool(got.isfinite().all())
    scale = float(want.abs().max())
    err = _err(got, want)
    print(f"kda chunk+state {case}: max abs err {err:.3e}, largest output {scale:.3e}")
    assert err <= 0.02 * scale, (err, scale)
    again = kda.state(kda.chunk(x, f, b, p["A_log"], p["dt_bias"], r, H), r, H)
    assert torch.equal(got, again)  # no atomics: the same bits every run


def test_out_kernel():
    _need_card()
    N = 13000
    g = torch.Generator(device="cuda").manual_seed(2)
    o = torch.randn(N, C, generator=g, device="cuda").bfloat16()
    gate = torch.randn(N, C, generator=g, device="cuda").bfloat16()
    w = (1 + 0.2 * torch.randn(HD, generator=g, device="cuda")).bfloat16()
    got = kda.out_norm(o, gate, w, 1e-5)
    want = kda.out_reference(o, gate, w, 1e-5, HD)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2.0 ** -7)


def test_core_runs_the_kernels_alone(monkeypatch):
    """On the fused schedule the core is the four ``kda_`` launches: the
    plain steps never run, ``kda.plain`` is not counted, and the output
    matches the plain core."""
    _need_card()
    mask, pk, r, T = _rows(seed=3)
    qkv, f, b, gate, p = _inputs(pk.src.shape[0], seed=3)
    with torch.inference_mode():
        want = kda.kda_core(qkv.float(), f.float(), b.float(), gate.float(),
                            {"conv": p["conv"].float(), "A_log": p["A_log"].float(),
                             "dt_bias": p["dt_bias"].float(),
                             "o_norm": {"scale": p["o_norm"]["scale"].float()}},
                            r, pk.src, T, H, HD, 1e-5)
        got = kda.kda_core(qkv, f, b, gate, p, r, pk.src, T, H, HD, 1e-5)
    for name in ("conv_reference", "chunk_reference", "out_reference"):
        monkeypatch.setattr(kda, name, lambda *a, **k: (_ for _ in ()).throw(AssertionError))
    before = [fn.launches for fn in (kda.conv, kda.chunk, kda.state, kda.out_norm)]
    with torch.inference_mode(), profiling.recording() as rec:
        again = kda.kda_core(qkv, f, b, gate, p, r, pk.src, T, H, HD, 1e-5)
    assert [fn.launches for fn in (kda.conv, kda.chunk, kda.state, kda.out_norm)] == \
        [n + 1 for n in before]
    assert rec.counters["kda.layers"] == 1 and "kda.plain" not in rec.counters
    assert torch.equal(got, again)
    # the gated norm divides outputs of order 0.1 by their RMS: the chunked
    # core's bf16 operands (0.5% of the largest output, measured) and the
    # convolution's rounding reach its outputs of order one at a few percent
    err = _err(got, want)
    print(f"kda core: max abs err {err:.3e} against the fp32 plain core")
    assert err <= 0.05 * float(want.abs().max())


_NAMES = """
import json, sys
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
import test_torch_kda_gpu as t
mask, pk, r, T = t._rows(seed=4)
qkv, f, b, gate, p = t._inputs(pk.src.shape[0], seed=4)
with torch.inference_mode():
    t.kda.kda_core(qkv, f, b, gate, p, r, pk.src, T, t.H, t.HD, 1e-5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t.kda.kda_core(qkv, f, b, gate, p, r, pk.src, T, t.H, t.HD, 1e-5)
        torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_core_kernels_are_named_kda():
    """Every device kernel of the core is named ``kda_`` (what
    ``kda_roofline.score`` and ``kda_device_share.score`` read), four a
    layer. Profiled in a child process: a second profiler session in one
    process can record no device events, which would blind the next test
    that profiles."""
    import json
    import os
    import subprocess
    import sys

    _need_card()
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _NAMES], capture_output=True, text=True,
                         cwd=here, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(here)))
    assert out.returncode == 0, out.stderr[-2000:]
    kernels = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(kernels) == 4 and all("kda_" in n for n in kernels), kernels


def test_core_raises_on_a_head_the_kernels_do_not_take():
    _need_card()
    mask, pk, r, T = _rows(B=4, lo=3, hi=9)
    N = pk.src.shape[0]
    qkv = torch.randn(N, 3 * 2 * 64, device="cuda").bfloat16()
    p = {"conv": torch.randn(3 * 128, 4, device="cuda").bfloat16(),
         "A_log": torch.zeros(2, device="cuda").bfloat16(),
         "dt_bias": torch.zeros(128, device="cuda").bfloat16(),
         "o_norm": {"scale": torch.ones(64, device="cuda").bfloat16()}}
    f = torch.randn(N, 128, device="cuda").bfloat16()
    with torch.inference_mode(), pytest.raises(ValueError, match="kda_core"):
        kda.kda_core(qkv, f, f[:, :2], f, p, r, pk.src, T, 2, 64, 1e-5)


# ---------------------------------------------------------------------------
# the sigmoid router and the held share
# ---------------------------------------------------------------------------


def _held_layer(N, first, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = randn(N, D).bfloat16()
    p = {"gate": {"w": randn(D, WIDTH, scale=D ** -0.5).bfloat16(),
                  "bias": randn(WIDTH, scale=0.02).bfloat16()},
         "experts": {"gate_up": randn(HELD, 2 * F, D, scale=D ** -0.5).bfloat16(),
                     "down": randn(HELD, D, F, scale=F ** -0.5).bfloat16()},
         "shared": {"gate_up": {"w": randn(D, 2 * F, scale=D ** -0.5).bfloat16()},
                    "down": {"w": randn(F, D, scale=F ** -0.5).bfloat16()}}}
    return x, p, moe.Router(sigmoid=True, first=first)


@pytest.mark.parametrize("N", [1, 333, 13000])
@pytest.mark.parametrize("first", [0, 64, 192])
def test_sigmoid_route_over_a_held_share(N, first):
    _need_card()
    x, p, router = _held_layer(N, first)
    logits = torch.mm(x, p["gate"]["w"], out_dtype=torch.float32)
    bias = p["gate"]["bias"].float()
    counts = torch.zeros(HELD, dtype=torch.int32, device="cuda")
    remote = torch.zeros((), dtype=torch.int32, device="cuda")
    r = moe.route(logits, K, 2.446, counts, router, bias, remote)
    idx, weight = moe.route_reference(logits, K, 2.446, router, bias)
    local, dropped = moe.held_slots(idx, first, HELD)
    assert torch.equal(r.idx.long(), local)
    torch.testing.assert_close(r.weight, weight, atol=1e-6, rtol=1e-6)
    assert torch.equal(counts.long(), moe._bincount_held(local, HELD))
    assert int(remote) == int(dropped) and int(remote) + int(counts.sum()) == N * K
    assert bool((r.slot_pos.reshape(-1)[local.reshape(-1) < 0] == -1).all())
    assert int(r.offsets[-1]) == int(counts.sum())


@pytest.mark.parametrize("N", [7, 13000])
def test_held_layer_matches_plain(N):
    _need_card()
    x, p, router = _held_layer(N, 64, seed=1)
    remote = torch.zeros((), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        got = moe.moe_layer(x, p, K, 2.446, None, router, remote)
        again = moe.moe_layer(x, p, K, 2.446, None, router)
        want = moe.moe_reference(x, p, K, 2.446, None, router)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=8e-3, rtol=2.0 ** -7)
    assert 0 < int(remote) < N * K


def _kimi_engine(layers=4):
    """An engine of the kimi_linear backend at the published widths (one
    period: three KDA layers and the MLA layer; the dense layer and three
    expert layers, 64 held of 256) and a batch of 16 rows on pinned host
    buffers."""
    import dataclasses

    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine
    from multimodal_content_moderation_tpu_torch.models.kimi_linear import KimiLinearConfig

    cfg = KimiLinearConfig.published_siglip2_224()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_layers=layers, n_held=HELD, kda_layers=(0, 1, 2)))
    model = model_io.build_model("fusion", "kimi_linear", ["a", "b", "c", "d", "e"],
                                 device="cuda", encoder_config=cfg)
    model = model_io.with_performance_options(
        model, compute_dtype="bfloat16", scores_dtype="bfloat16", attention_impl="pallas",
    ).to(torch.bfloat16)
    engine = FastInferenceEngine(model, (0.5,) * 3, (0.5,) * 3)
    B, T = 16, 300
    g = np.random.default_rng(0)
    lengths = g.integers(40, T + 1, size=B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int64)
    ids = g.integers(2, 1000, size=(B, T)) * mask + (1 - mask)
    patches = engine.patches_from_hwc(g.integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8))
    host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            for a in (ids, mask, patches, np.ones(B, np.float32), np.ones(B, np.float32))]
    return engine, host, int(lengths.sum()), lengths


def test_kimi_engine_call_does_not_synchronise_and_counts():
    """An engine call of the kimi_linear backend at the published widths on
    pinned host inputs enqueues the packing, the KDA core, the routing and
    the forward without a synchronising operation; a recorded call counts
    the KDA layers and chunks, no plain core, and the remote slots."""
    _need_card()
    engine, host, kept, lengths = _kimi_engine()
    engine(*host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = engine(*host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(logits.isfinite().all())
    with profiling.recording() as rec:
        engine(*host)
    c = rec.counters
    assert c["kda.layers"] == 3 and "kda.plain" not in c and "moe.plain" not in c
    counters = engine.last_counters
    remote = int(counters["moe.remote_slots"])
    assert 0 < remote < kept * K * 3
