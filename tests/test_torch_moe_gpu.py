"""The expert layer's kernels (``csrc/moe.cu`` behind ``ops/moe.py``) and the
add + RMSNorm instantiation of ``csrc/add_layer_norm.cu`` (behind
``ops/cuda_norm.py``) against their plain versions on the card, at
DeepSeek-V2-Lite's published widths (d 2,048, experts of 1,408, 64 experts,
top-6), and ``moe_grouped`` at Kimi-Linear's (d 2,304, experts of 1,024).

Marked ``gpu``: they skip where no card is present (decided inside each
test). On the card machine: ``python -m pytest --noconftest -m gpu
tests/test_torch_moe_gpu.py``.

Tolerances. Routing from the same fp32 logits: the top-k indices equal and
the weights to 1e-6 (one softmax in another summation order). A grouped
product: bf16 rtol 2^-7 + atol 1e-3 (fp32 sums in another order, then one
rounding each side: at most one ulp apart). The whole layer: bf16 rtol 2^-7
+ atol 3e-3 (each of the k weighted rows may sit one ulp apart before the
fp32 sum that is rounded once). add + RMSNorm: the rounded sum bit for bit,
the normalised rows bf16 rtol 2^-7 + atol 1e-3."""

import pytest
import torch

from multimodal_content_moderation_tpu_torch.ops import cuda_norm as cn
from multimodal_content_moderation_tpu_torch.ops import moe
from multimodal_content_moderation_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

D, F, E, K = 2048, 1408, 64, 6


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _layer(N, load, seed=0, k=K):
    """Tokens and an expert layer (bf16, on the card) whose gate routes
    ``load``: "uniform" (random gate), "zipf" (expert e's logits raised by
    -1.2 log(e + 1): a few experts take most slots), "empty" (16 experts
    never chosen), "one" (expert 7 first for every token)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = randn(N, D)
    gate = randn(D, E, scale=D ** -0.5)
    if load in ("zipf", "empty", "one"):
        x[:, 0] = 4.0
        gate[0] = 0.0
    if load == "zipf":
        gate[0] = -1.2 * torch.log(torch.arange(1, E + 1, device="cuda", dtype=torch.float32)) / 4
    elif load == "empty":
        gate[0, 48:] = -5.0
    elif load == "one":
        gate[0, 7] = 5.0
    p = {"gate": {"w": gate.bfloat16()},
         "experts": {"gate_up": randn(E, 2 * F, D, scale=D ** -0.5).bfloat16(),
                     "down": randn(E, D, F, scale=F ** -0.5).bfloat16()},
         "shared": {"gate_up": {"w": randn(D, 4 * F, scale=D ** -0.5).bfloat16()},
                    "down": {"w": randn(2 * F, D, scale=(2 * F) ** -0.5).bfloat16()}}}
    return x.bfloat16(), p


LOADS = [(1, "uniform"), (7, "uniform"), (100, "zipf"), (333, "empty"), (1000, "one"),
         (4170, "uniform"), (4170, "zipf"), (8192, "uniform"), (16384, "uniform")]


@pytest.mark.parametrize("N,load", LOADS)
def test_route_and_grouped_products(N, load):
    _need_card()
    x, p = _layer(N, load)
    w_gu, w_down = p["experts"]["gate_up"], p["experts"]["down"]
    logits = torch.mm(x, p["gate"]["w"], out_dtype=torch.float32)
    counts = torch.zeros(E, dtype=torch.int32, device="cuda")
    r = moe.route(logits, K, 1.0, counts)
    idx, weight = moe.route_reference(logits, K, 1.0)
    assert torch.equal(r.idx.long(), idx)
    torch.testing.assert_close(r.weight, weight, atol=1e-6, rtol=1e-6)
    assert torch.equal(counts.long(), torch.bincount(idx.reshape(-1), minlength=E))
    off = r.offsets.long()
    assert off[0] == 0 and torch.equal(off[1:] - off[:-1], counts.long())
    # each expert's sorted slots are its slots in slot order
    flat = idx.reshape(-1)
    for e in (0, 7, 31, 63):
        slots = (flat == e).nonzero()[:, 0]
        assert torch.equal(r.rows[off[e]:off[e + 1]].long(), slots // K)
        assert torch.equal(r.slot_pos.reshape(-1)[slots].long(),
                           torch.arange(int(off[e]), int(off[e + 1]), device="cuda"))
    if load == "empty":
        assert int(counts[48:].sum()) == 0
    if load == "one":
        assert int(counts[7]) == N

    _check_products(x, r, idx, weight, w_gu, w_down)


def _check_products(x, r, idx, weight, w_gu, w_down):
    """The two ``moe_grouped`` launches against the plain path: h an expert
    at a time in expert order, y in slot order against
    ``experts_reference``."""
    off = r.offsets.long()
    before = moe.grouped.launches
    h = moe.grouped(True, x, r, w_gu)
    y = moe.grouped(False, h, r, w_down)
    assert moe.grouped.launches == before + 2
    want = moe.experts_reference(x, idx, weight, w_gu, w_down)  # [N, k, D], slot order
    gate, up = moe.split_gate_up(w_gu)
    for e in range(w_gu.shape[0]):  # h in expert order, an expert at a time
        tok = r.rows[off[e]:off[e + 1]].long()
        if tok.numel():
            xe = x[tok]
            want_h = (torch.nn.functional.silu(torch.mm(xe, gate[e].t(), out_dtype=torch.float32))
                      * torch.mm(xe, up[e].t(), out_dtype=torch.float32)).bfloat16()
            torch.testing.assert_close(h[off[e]:off[e + 1]].float(), want_h.float(), atol=1e-3,
                                       rtol=2.0 ** -7)
    held = r.slot_pos >= 0  # every slot, but where the layer holds a share of the experts
    got_y = y[r.slot_pos.clamp(min=0).long()]  # back in slot order
    torch.testing.assert_close(got_y[held].float(), want[held].float(), atol=1e-3,
                               rtol=2.0 ** -7)
    return h, y


@pytest.mark.parametrize("N", [333, 13000])
def test_grouped_products_at_kimi_linear_widths(N):
    """``moe_grouped`` at Kimi-Linear's expert widths (d 2,304, F 1,024) over
    the 64 experts a card holds of a 256-wide sigmoid router at top-8 (about
    a quarter of the slots held): every held row against the plain path."""
    _need_card()
    Dk, Fk, Ek, width, k = 2304, 1024, 64, 256, 8
    g = torch.Generator(device="cuda").manual_seed(N)
    x = torch.randn(N, Dk, generator=g, device="cuda").bfloat16()
    gate = (torch.randn(Dk, width, generator=g, device="cuda") * Dk ** -0.5).bfloat16()
    w_gu = (torch.randn(Ek, 2 * Fk, Dk, generator=g, device="cuda") * Dk ** -0.5).bfloat16()
    w_down = (torch.randn(Ek, Dk, Fk, generator=g, device="cuda") * Fk ** -0.5).bfloat16()
    assert moe.takes(x, w_gu, w_down, k, width, 0)
    logits = torch.mm(x, gate, out_dtype=torch.float32)
    router = moe.Router(sigmoid=True, first=0)
    counts = torch.zeros(Ek, dtype=torch.int32, device="cuda")
    r = moe.route(logits, k, 2.446, counts, router)
    idx, weight = moe.route_reference(logits, k, 2.446, router)
    local = moe.held_slots(idx, 0, Ek)[0]
    assert torch.equal(r.idx.long(), local)
    _check_products(x, r, local, weight, w_gu, w_down)


# slots an expert around the products' row granularity (64-row halves of a
# 128-row m-tile) and one expert of 2.59 times the cell's mean of 390
RAGGED = [1, 63, 64, 65, 127, 128, 129, 1010]


@pytest.mark.parametrize("first", [0, E - len(RAGGED)])
def test_grouped_products_ragged_counts(first):
    """Top-1 routing that gives experts ``first`` .. ``first`` + 7 exactly
    ``RAGGED`` slots (the others none; at the last experts the weight tiles
    end at the tensor's end): every row against the plain path."""
    _need_card()
    x, p = _layer(sum(RAGGED), "uniform", seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    counts = torch.tensor(RAGGED, device="cuda")
    assign = torch.repeat_interleave(torch.arange(first, first + len(RAGGED), device="cuda"), counts)
    assign = assign[torch.randperm(assign.numel(), generator=g, device="cuda")]
    logits = torch.zeros(assign.numel(), E, device="cuda")
    logits[torch.arange(assign.numel(), device="cuda"), assign] = 8.0
    got = torch.zeros(E, dtype=torch.int32, device="cuda")
    r = moe.route(logits, 1, 1.0, got)
    idx, weight = moe.route_reference(logits, 1, 1.0)
    want = torch.zeros(E, dtype=torch.int32, device="cuda")
    want[first:first + len(RAGGED)] = counts.int()
    assert torch.equal(got, want)
    _check_products(x, r, idx, weight, p["experts"]["gate_up"], p["experts"]["down"])


def test_grouped_products_repeat_and_are_named():
    """Two launches of each product give the same bits (no split-K, no
    atomics), and every device kernel a product launches is named
    ``moe_grouped`` (what ``moe_grouped_roofline.score`` reads)."""
    _need_card()
    x, p = _layer(4170, "zipf", seed=9)
    w_gu, w_down = p["experts"]["gate_up"], p["experts"]["down"]
    logits = torch.mm(x, p["gate"]["w"], out_dtype=torch.float32)
    r = moe.route(logits, K, 1.0, torch.zeros(E, dtype=torch.int32, device="cuda"))
    h = moe.grouped(True, x, r, w_gu)
    y = moe.grouped(False, h, r, w_down)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h2 = moe.grouped(True, x, r, w_gu)
        y2 = moe.grouped(False, h2, r, w_down)
        torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(y, y2)
    kernels = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and all("moe_grouped" in name for name in kernels), kernels


@pytest.mark.parametrize("N,load", [(1, "uniform"), (4170, "uniform"), (4170, "one"),
                                    (8192, "zipf")])
def test_layer_matches_plain_and_repeats(N, load):
    _need_card()
    x, p = _layer(N, load, seed=1)
    with torch.inference_mode():
        before = moe.route.launches, moe.combine.launches
        got = moe.moe_layer(x, p, K, 1.0)
        assert (moe.route.launches, moe.combine.launches) == (before[0] + 1, before[1] + 1)
        again = moe.moe_layer(x, p, K, 1.0)
        want = moe.moe_reference(x, p, K, 1.0)
    assert torch.equal(got, again)  # no atomics on the output: the same bits every run
    torch.testing.assert_close(got.float(), want.float(), atol=3e-3, rtol=2.0 ** -7)


def test_one_expert_holds_every_slot():
    """Top-1 with every token on one expert: that expert's m-tiles cover all
    the rows, the other 63 have none."""
    _need_card()
    x, p = _layer(1000, "one", seed=2)
    with torch.inference_mode():
        got = moe.moe_layer(x, p, 1, 1.0)
        want = moe.moe_reference(x, p, 1, 1.0)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-3, rtol=2.0 ** -7)


def test_fused_layer_never_runs_the_plain_path(monkeypatch):
    """On the fused schedule the layer is the kernels alone, for a strided
    view of the tokens too (laid out contiguous first): the plain routing
    and experts are never called and ``moe.plain`` is not counted."""
    _need_card()
    x, p = _layer(4170, "zipf", seed=4)
    with torch.inference_mode():
        want = moe.moe_layer(x, p, K, 1.0)

    def refuse(*a, **k):
        raise AssertionError("the plain expert path ran on the fused schedule")

    monkeypatch.setattr(moe, "experts_reference", refuse)
    monkeypatch.setattr(moe, "route_reference", refuse)
    strided = torch.cat([x, x], dim=1)[:, D:]
    assert not strided.is_contiguous()
    with torch.inference_mode(), profiling.recording() as rec:
        got = moe.moe_layer(strided, p, K, 1.0)
    assert rec.counters["moe.layers"] == 1 and "moe.plain" not in rec.counters
    assert torch.equal(got, want)


def test_fused_layer_raises_on_a_shape_the_kernels_do_not_take():
    """An expert width that is not a whole number of k steps (F % 64 != 0)
    is refused on the fused schedule, not run on the plain path."""
    _need_card()
    Dn, Fn, En = 256, 100, 8
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(32, Dn, generator=g, device="cuda").bfloat16()
    p = {"gate": {"w": torch.randn(Dn, En, generator=g, device="cuda").bfloat16()},
         "experts": {"gate_up": torch.randn(En, 2 * Fn, Dn, generator=g, device="cuda").bfloat16(),
                     "down": torch.randn(En, Dn, Fn, generator=g, device="cuda").bfloat16()}}
    with torch.inference_mode(), pytest.raises(ValueError, match="moe_layer"):
        moe.moe_layer(x, p, 2, 1.0)


def test_layer_does_not_synchronise():
    """The layer, routing included, enqueues without a synchronising
    operation."""
    _need_card()
    x, p = _layer(4170, "uniform", seed=3)
    hist = torch.zeros(E, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        moe.moe_layer(x, p, K, 1.0, hist)  # loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = moe.moe_layer(x, p, K, 1.0, hist)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert bool(out.isfinite().all()) and int(hist.sum()) == 2 * 4170 * K


def _engine_and_batch():
    """An engine of the deepseek_v2 backend at the published widths (3
    layers: the dense one and two expert layers) and a batch of 64 rows on
    pinned host buffers."""
    import dataclasses

    import numpy as np

    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import DeepSeekV2Config
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine

    cfg = DeepSeekV2Config.lite_siglip2_224()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=3))
    model = model_io.build_model("fusion", "deepseek_v2", ["a", "b", "c", "d", "e"],
                                 device="cuda", encoder_config=cfg)
    model = model_io.with_performance_options(
        model, compute_dtype="bfloat16", scores_dtype="bfloat16", attention_impl="pallas",
    ).to(torch.bfloat16)
    engine = FastInferenceEngine(model, (0.5,) * 3, (0.5,) * 3)
    B, T = 64, 48
    g = np.random.default_rng(0)
    lengths = g.integers(3, T + 1, size=B)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int64)
    ids = g.integers(2, 1000, size=(B, T)) * mask + (1 - mask)
    patches = engine.patches_from_hwc(g.integers(0, 256, size=(B, 224, 224, 3), dtype=np.uint8))
    host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            for a in (ids, mask, patches, np.ones(B, np.float32), np.ones(B, np.float32))]
    return engine, host


def test_engine_call_does_not_synchronise():
    """An engine call of the deepseek_v2 backend at the published widths on
    pinned host inputs enqueues its copies, the packing, the routing and the
    forward without a synchronising operation."""
    _need_card()
    engine, host = _engine_and_batch()
    engine(*host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = engine(*host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(logits.isfinite().all())


def test_engine_counts_grouped_pad_rows(monkeypatch):
    """A recorded engine call leaves ``moe.grouped_pad_rows``: each expert
    layer's per-expert slots up to whole 64-row halves, as the host counts
    them from the layers' counts."""
    from multimodal_content_moderation_tpu_torch.models import deepseek_v2 as ds

    _need_card()
    engine, host = _engine_and_batch()
    layer_counts = []
    real_layer = ds.moe_layer

    def counting_layer(x, p, k, scaling, hist=None, *rest):
        out = real_layer(x, p, k, scaling, hist, *rest)
        layer_counts.append(hist.tolist())
        return out

    monkeypatch.setattr(ds, "moe_layer", counting_layer)
    with profiling.recording():
        engine(*host)
    counters = engine.last_counters
    assert len(layer_counts) == 2
    want = sum(-(-n // moe.HALF) * moe.HALF - n for row in layer_counts for n in row)
    assert int(counters["moe.grouped_pad_rows"]) == want
    assert int(counters["moe.max_expert_slots"]) == sum(max(row) for row in layer_counts)


@pytest.mark.parametrize("R,Dn,add", [(4170, 2048, True), (4170, 2048, False), (4170, 512, False),
                                      (256, 2048, True), (7, 1536, True), (33, 3072, False)])
def test_add_rms_norm_kernel(R, Dn, add):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(R + Dn)
    x = (torch.randn(R, Dn, generator=g, device="cuda") * 3 + 1).bfloat16()
    d = torch.randn(R, Dn, generator=g, device="cuda").bfloat16() if add else None
    w = (1 + 0.2 * torch.randn(Dn, generator=g, device="cuda")).bfloat16()
    before = cn.add_rms_norm.launches
    s, y = cn.add_rms_norm(x, d, w, 1e-6)
    assert cn.add_rms_norm.launches == before + 1
    want_s, want_y = cn.add_rms_norm_reference(x, d, w, 1e-6)
    assert torch.equal(s, want_s)
    torch.testing.assert_close(y.float(), want_y.float(), atol=1e-3, rtol=2.0 ** -7)


def test_add_rms_norm_reads_the_latent_view():
    """The MLA latent: a [N, 512] column slice of the [N, 3,648] projection,
    read in place (a row stride of 3,648, 16-byte aligned)."""
    from multimodal_content_moderation_tpu_torch.ops import layers

    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    qa = torch.randn(4170, 3648, generator=g, device="cuda").bfloat16()
    lat = qa[:, 3072:3584]
    w = (1 + 0.2 * torch.randn(512, generator=g, device="cuda")).bfloat16()
    before = cn.add_rms_norm.launches
    with torch.inference_mode():
        y = layers.rms_norm(lat, {"scale": w}, 1e-6)
    assert cn.add_rms_norm.launches == before + 1
    torch.testing.assert_close(y.float(), cn.add_rms_norm_reference(lat, None, w, 1e-6)[1].float(),
                               atol=1e-3, rtol=2.0 ** -7)
    with pytest.raises(ValueError, match="add_rms_norm"):
        cn.add_rms_norm(lat.float(), None, w, 1e-6)

