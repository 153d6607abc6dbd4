"""The ``kimi_linear`` backend on the CPU: Kimi-Linear's text tower
(``models/kimi_linear.py``), its KDA core (``ops/kda.py``) and its sigmoid
router over a held share of the experts (``ops/moe.py``) at a tiny size
with the published structure (hidden 64; one whole period of three KDA
layers of 2 heads of 16 and one NoPE MLA layer of 4 heads of 16 + 8 for q
and k and 16 for v, a latent of 32; a dense first layer, then a router over
16 experts, top-4, of which this card holds 4, and 1 shared expert), held
to the plain fp32 reference ``tests/plain_kimi_linear.py`` (HF names, HF's
equations, KDA token by token).

Tolerance against the reference: 1e-4 absolute and relative where both
sides are fp32 on the CPU: they differ in the order of their sums (the port
packs the kept tokens, runs KDA in chunks of 64 with a triangular solve,
fuses projections side by side and sums the experts in top-k order), a few
fp32 ulps at features of order 1. The chunked KDA core against the
recurrence alone: 2e-5 on outputs of order 0.1-1 over up to 200 tokens."""

import dataclasses
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

import plain_kimi_linear as plain
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.models import convert, deepseek_v2 as ds
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models import fusion, model_io
from multimodal_content_moderation_tpu_torch.models import kimi_linear as kl
from multimodal_content_moderation_tpu_torch.models import siglip as siglip_mod
from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.models.export import fusion_model_to_torch
from multimodal_content_moderation_tpu_torch.models.u8wire import embed_pixels
from multimodal_content_moderation_tpu_torch.ops import kda, moe
from multimodal_content_moderation_tpu_torch.utils import profiling

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
MEAN = STD = (0.5, 0.5, 0.5)
TEXT = {
    "vocab_size": 600, "hidden_size": 64, "num_hidden_layers": 5, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_experts": 4, "num_experts_published": 16, "first_held_expert": 4,
    "num_shared_experts": 1, "num_experts_per_token": 4, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "routed_scaling_factor": 2.446, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_expert_group": 1, "topk_group": 1,
    "use_grouped_topk": True, "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-5, "rope_theta": 10000,
    "rope_scaling": None, "mla_use_nope": True, "hidden_act": "silu",
    "model_type": "kimi_linear",
    "linear_attn_config": {"kda_layers": [1, 2, 3, 5], "full_attn_layers": [4], "num_heads": 2,
                           "head_dim": 16, "short_conv_kernel_size": 4},
}
VISION = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
          "intermediate_size": 64, "image_size": 32, "patch_size": 8, "num_channels": 3,
          "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6}
ENCODER = {"model_type": "kimi_linear", "text_config": TEXT, "vision_config": VISION,
           "projection_dim": 32}
TOL = dict(atol=1e-4, rtol=1e-4)


def _hf_state_dict(seed=0, text=TEXT):
    """(config, HF-named fp32 state dict) of a tiny random fusion model, its
    norm weights drawn around 1."""
    cfg = kl.KimiLinearConfig.from_dict(dict(ENCODER, text_config=text))
    model = fusion.FusionModel.create("kimi_linear", num_labels=5, fusion_dim=16,
                                      encoder_config=cfg, seed=seed, device="cpu")
    sd = fusion_model_to_torch(model)
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if "text_model" in k and k.endswith("norm.weight"):
            sd[k] = 1 + 0.2 * torch.randn(sd[k].shape, generator=g)
    return cfg, sd


def _model(seed=0, text=TEXT):
    cfg, sd = _hf_state_dict(seed, text)
    params = convert.fusion_model_from_torch(sd, "kimi_linear", encoder_cfg=cfg)
    return fusion.FusionModel(params, "kimi_linear", num_labels=5, fusion_dim=16,
                              encoder_config=cfg), sd


def _rows(seed, B=5, T=80, lo=1):
    g = np.random.default_rng(seed)
    lengths = g.integers(lo, T + 1, size=B)
    lengths[0] = T  # one row with no padding, past a chunk
    ids = g.integers(2, TEXT["vocab_size"], size=(B, T))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int64)
    ids = ids * mask + (1 - mask)  # pad id 1 past each row
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tower_matches_the_plain_reference(seed):
    model, sd = _model(seed)
    ids, mask = _rows(seed)
    with torch.no_grad():
        got = kl.kimi_text_features(model.backbone, ids, mask, model.encoder_config)
        want = plain.text_features(sd, TEXT, ids, mask)
    torch.testing.assert_close(got, want, **TOL)


def test_fusion_logits_use_the_kimi_text_feature():
    """The whole model's logits: the fusion head over the tower's feature
    (against the reference's) and SigLIP's vision feature."""
    model, sd = _model(3)
    ids, mask = _rows(3, T=24)
    pix = torch.randn(ids.shape[0], 3, 32, 32, generator=torch.Generator().manual_seed(3))
    batch = {"input_ids": ids, "attention_mask": mask, "pixel_values": pix,
             "text_present": torch.ones(ids.shape[0]), "image_present": torch.ones(ids.shape[0])}
    with torch.no_grad():
        got = model(batch)["logits"]
        tfeat = plain.text_features(sd, TEXT, ids, mask)
        cfg = model.encoder_config
        vfeat = siglip_mod.siglip_image_features_from_tokens(
            model.backbone, embed_pixels(model.backbone, pix, cfg.vision), cfg)
        want = fusion.fusion_head_apply(model.head, tfeat, vfeat, batch["text_present"],
                                        batch["image_present"])
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the KDA core
# ---------------------------------------------------------------------------


def _kda_inputs(L, H=2, d=16, seed=0, strong=False):
    g = torch.Generator().manual_seed(seed)
    q = plain.l2norm(torch.randn(L, H, d, generator=g)) * d ** -0.5
    k = plain.l2norm(torch.randn(L, H, d, generator=g))
    v = torch.randn(L, H, d, generator=g)
    gate = -torch.rand(L, H, d, generator=g) * 0.5
    if strong:
        # a decay of -40 a token on some channels from token 10 on: the
        # cumulative decay inside the first chunk falls below -100 by token 13
        gate[10:, :, : d // 2] = -40.0
    beta = torch.sigmoid(torch.randn(L, H, generator=g))
    return q, k, v, gate, beta


def _chunked(q, k, v, gate, beta):
    L = q.shape[0]
    Tp = -(-L // kda.CHUNK) * kda.CHUNK

    def pad(t):
        return F.pad(t, (0, 0) * (t.dim() - 1) + (0, Tp - L))[None]

    return kda.chunk_reference(pad(q), pad(k), pad(v), pad(gate), pad(beta))[0, :L]


@pytest.mark.parametrize("L", [1, 63, 64, 65, 200])
def test_chunked_kda_matches_the_recurrence(L):
    inputs = _kda_inputs(L, seed=L)
    want = plain.kda_recurrence(*inputs)
    torch.testing.assert_close(_chunked(*inputs), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("L", [64, 150])
def test_chunked_kda_stays_exact_under_a_strong_decay(L):
    """A cumulative decay below -100 inside a chunk (exp(100) overflows no
    fp32 factor here: every exponent is a later minus an earlier
    cumulative decay) gives the recurrence's outputs, all finite."""
    inputs = _kda_inputs(L, seed=7, strong=True)
    cum = inputs[3][:, 0, 0].cumsum(0)
    assert float(cum[: kda.CHUNK].min()) < -100
    got = _chunked(*inputs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain.kda_recurrence(*inputs), atol=2e-5, rtol=2e-5)


def test_conv_taps_never_cross_rows():
    """The packed convolution of two rows equals each row's alone: the taps
    before a row's first kept token are zero."""
    g = torch.Generator().manual_seed(4)
    H, d = 2, 16
    C = H * d
    x = torch.randn(9, 3 * C, generator=g)
    w = torch.randn(3 * C, kda.TAPS, generator=g)
    row = torch.tensor([0, 0, 0, 0, 0, 1, 1, 2, 2])
    both = kda.conv_reference(x, w, row, H, d)
    for r in range(3):
        sel = row == r
        alone = kda.conv_reference(x[sel], w, torch.zeros(int(sel.sum()), dtype=torch.long),
                                   H, d)
        torch.testing.assert_close(both[sel], alone, atol=1e-6, rtol=1e-6)
    # against the reference's nn.Conv1d on row 0's first third (q)
    want = plain.short_conv(x[:5, :C], w[:C, None])
    qn = plain.l2norm(want.view(5, H, d)) * d ** -0.5
    torch.testing.assert_close(both[:5, :C], qn.reshape(5, C), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("width", [80, 160])
def test_packing_changes_nothing(width):
    """Each row's feature is the one it has alone: padding, other rows and
    the width of the batch leave it as it is."""
    model, _ = _model(5)
    ids, mask = _rows(5, T=80)
    ids_w = torch.ones(ids.shape[0], width, dtype=ids.dtype)
    mask_w = torch.zeros_like(ids_w)
    ids_w[:, :80], mask_w[:, :80] = ids, mask
    with torch.no_grad():
        got = kl.kimi_text_features(model.backbone, ids_w, mask_w, model.encoder_config)
        for r in range(ids.shape[0]):
            n = int(mask[r].sum())
            alone = kl.kimi_text_features(model.backbone, ids[r:r + 1, :n], mask[r:r + 1, :n],
                                          model.encoder_config)
            torch.testing.assert_close(got[r:r + 1], alone, atol=1e-5, rtol=1e-5)


def test_nope_mla_matches_the_reference():
    """``deepseek_v2.mla`` with no tables: the "rotary" columns as they are,
    scale q_head_dim^-0.5."""
    model, sd = _model(6)
    c = model.encoder_config.text
    layer = 3  # the MLA layer (full_attn_layers [4], 1-indexed)
    assert not c.is_kda(layer) and c.softmax_scale == 24 ** -0.5
    g = torch.Generator().manual_seed(6)
    ids, mask = _rows(6, T=20)
    h = torch.randn(ids.shape[0], 20, 64, generator=g)
    kept = int(mask.sum())
    pk = ds.pack(mask, kept)
    with torch.no_grad():
        got = ds.mla(h.reshape(-1, 64)[pk.src], model.backbone["text_model"]["layers"][layer]
                     ["attn"], c, pk, mask, None, None)
        want = plain.mla_nope(h, sd, f"backbone.text_model.layers.{layer}.self_attn", TEXT, mask)
    torch.testing.assert_close(got, want.reshape(-1, 64)[pk.src], **TOL)


# ---------------------------------------------------------------------------
# the router and the held share
# ---------------------------------------------------------------------------


def _brute_force_route(logits, bias, k, scaling):
    """Every expert's choice score compared with every other's: the k
    largest, ties to the lower index; weights renormalised over the k."""
    s = torch.sigmoid(logits)
    choice = s + bias
    N, E = s.shape
    idx = torch.empty(N, k, dtype=torch.long)
    for n in range(N):
        order = sorted(range(E), key=lambda e: (-float(choice[n, e]), e))
        idx[n] = torch.tensor(order[:k])
    w = s.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * scaling


@pytest.mark.parametrize("case", ["random", "ties", "bias_decides"])
def test_sigmoid_router_matches_a_brute_force_top_k(case):
    g = torch.Generator().manual_seed(8)
    logits = torch.randn(30, 16, generator=g)
    bias = torch.randn(16, generator=g) * 0.02
    if case == "ties":
        logits[:, 8:] = logits[:, :8]
        bias = torch.zeros(16)
    elif case == "bias_decides":
        bias[3] = 5.0  # expert 3 is chosen by every token, weighted by its own score
    got = moe.route_reference(logits, 4, 2.446, moe.Router(sigmoid=True),
                              bias)
    want = _brute_force_route(logits, bias, 4, 2.446)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=1e-6)
    if case == "bias_decides":
        assert (got[0] == 3).any(1).all()


def _share(p, first, E, shared):
    out = {"gate": p["gate"], "experts": {n: p["experts"][n][first:first + E].clone()
                                          for n in ("gate_up", "down")}}
    if shared:
        out["shared"] = p["shared"]
    return out


@pytest.mark.parametrize("shares", [2, 4])
def test_the_shares_add_up_to_the_uncut_layer(shares):
    """Expert parallelism's shares of one expert layer: each routes over
    all 16 experts and computes its own; their outputs, with the shared
    expert counted once, add up to the reference's whole layer, and each
    counts as remote the slots the others hold."""
    text = dict(TEXT, num_experts=16, first_held_expert=0)
    model, sd = _model(9, text)
    p = model.backbone["text_model"]["layers"][1]["mlp"]
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(9))
    E = 16 // shares
    total = torch.zeros(40, 64)
    remote = torch.zeros((), dtype=torch.int32)
    with torch.no_grad():
        for s in range(shares):
            router = moe.Router(sigmoid=True, first=s * E)
            total += moe.moe_layer(x, _share(p, s * E, E, shared=s == 0), 4, 2.446,
                                   router=router, remote=remote)
        want = plain.moe(x, sd, "backbone.text_model.layers.1.block_sparse_moe", text)
    torch.testing.assert_close(total, want, **TOL)
    assert int(remote) == 40 * 4 * (shares - 1)


def test_held_share_counts_remote_slots_and_drops_them():
    """A share holding no routed slot's expert returns the shared expert
    alone and counts every slot as remote."""
    model, sd = _model(10)
    p = model.backbone["text_model"]["layers"][1]["mlp"]
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(10))
    bias = torch.zeros(16)
    bias[:4] = 10.0  # every token chooses experts 0-3; this card holds 4-7
    p = dict(p, gate=dict(p["gate"], bias=bias))
    remote = torch.zeros((), dtype=torch.int32)
    hist = torch.zeros(4, dtype=torch.int32)
    router = moe.Router(sigmoid=True, first=4)
    with torch.no_grad():
        got = moe.moe_layer(x, p, 4, 2.446, hist, router, remote)
    assert int(remote) == 12 * 4 and int(hist.sum()) == 0
    torch.testing.assert_close(got, moe.swiglu(x, p["shared"]), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# loader, engine, config
# ---------------------------------------------------------------------------


def test_hf_loader_round_trips():
    """HF names -> the port's tree -> HF names gives the state dict back,
    the held experts under their own indices."""
    cfg, sd = _hf_state_dict(11)
    params = convert.fusion_model_from_torch(sd, "kimi_linear", encoder_cfg=cfg)
    back = kl.kimi_linear_to_torch(params["backbone"], cfg, "backbone.")
    ours = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    assert set(back) == set(ours)
    for k in ours:
        torch.testing.assert_close(back[k], ours[k], atol=0, rtol=0)
    assert "backbone.text_model.layers.1.block_sparse_moe.experts.4.w1.weight" in back
    assert "backbone.text_model.layers.1.block_sparse_moe.experts.3.w1.weight" not in back
    assert back["backbone.text_model.layers.0.self_attn.q_conv1d.weight"].shape == (32, 1, 4)
    assert back["backbone.text_model.layers.0.self_attn.A_log"].shape == (1, 1, 2, 1)


def _engine(model):
    return tfi.FastInferenceEngine(model, MEAN, STD)


def _u8_batch(seed, B, T):
    ids, mask = _rows(seed, B=B, T=T)
    g = np.random.default_rng(seed)
    patches = torch.from_numpy(g.integers(0, 256, size=(B, 16, 192), dtype=np.uint8))
    return ids, mask, patches, torch.ones(B), torch.ones(B)


@pytest.mark.parametrize("width", [8, 12])
def test_bucketed_logits_equal_full_width(width):
    """A bucket truncates the trailing pads (no carry column) and leaves the
    logits as the full width gives them."""
    model, _ = _model(12)
    engine = _engine(model)
    ids, mask, patches, tp, ip = _u8_batch(12, 6, 16)
    mask[:, width:] = 0
    ids[:, width:] = 1
    full = engine(ids, mask, patches, tp, ip)
    assert tfi.bucket_for(mask.numpy(), [8, 12, 16],
                          extra=backbone("kimi_linear").bucket_extra) == width
    ids_b, mask_b, carry = tfi.bucket_batch_text(ids.numpy(), mask.numpy(), width,
                                                 "kimi_linear")
    assert carry is None and ids_b.shape == (6, width)
    got = engine(torch.from_numpy(ids_b), torch.from_numpy(mask_b), patches, tp, ip)
    torch.testing.assert_close(got, full, atol=1e-5, rtol=1e-5)


def _dataset(tmp_path, data_dir, encoder_dir):
    rows = pd.read_csv(f"{data_dir}/test.csv")
    rows["text"] = [" ".join(["hate", "love"][i % 2] for _ in range(3 * i + 1))
                    for i in range(len(rows))]
    rows.to_csv(tmp_path / "test.csv", index=False)
    return CSVDataset(str(tmp_path / "test.csv"), f"{data_dir}/images",
                      load_tokenizer(encoder_dir),
                      ImagePreprocessor(32, 32, MEAN, STD, output="uint8_hwc"), 16,
                      class_names=CLASSES)


def test_evaluate_counts_the_kda_core_and_the_share(tmp_path, data_dir, encoder_dir):
    """A recorded ``evaluate_logits_u8`` pass counts the packing, the KDA
    layers and chunks (each row's ceil(kept / 64) in each KDA layer), the
    plain core on the CPU, the routed and the remote slots, and holds the
    tower's spans."""
    model, _ = _model(13)
    engine = _engine(model)
    ds_ = _dataset(tmp_path, data_dir, encoder_dir)
    B = 6
    off, _ = tfi.evaluate_logits_u8(engine, ds_, B, num_workers=2)
    with profiling.recording() as rec:
        on, _ = tfi.evaluate_logits_u8(engine, ds_, B, num_workers=2, seq_buckets=(8, 12))
    np.testing.assert_allclose(on, off, atol=1e-5, rtol=1e-5)
    c = rec.counters
    batches = -(-len(ds_) // B)
    kept = int(ds_.attention_mask.sum())
    assert c["text.kept_tokens"] == c["score.text_tokens"] == kept
    assert c["moe.routed_slots"] == kept * 4 * 4
    assert c["moe.layers"] == c["moe.plain"] == 4 * batches
    assert c["kda.layers"] == c["kda.plain"] == 4 * batches
    assert c["model.attention.plain"] == batches
    # every row is one chunk (under 64 tokens); the last batch's pad rows,
    # with no kept token, none
    assert c["kda.chunks"] == 4 * len(ds_)
    # about three quarters of the slots route to the 12 experts held elsewhere
    assert 0 < c["moe.remote_slots"] < c["moe.routed_slots"]
    names = {s.name for s in rec.spans}
    assert {"text.pack", "kda.conv", "kda.chunk", "kda.out", "mla.attention", "moe.route",
            "moe.experts", "moe.combine"} <= names


def test_backend_resolves_and_keeps_its_own_branches(tmp_path):
    model, _ = _model(14)
    assert isinstance(model.encoder_config, kl.KimiLinearConfig)
    assert model.feature_dim == 32
    (tmp_path / "config.json").write_text(json.dumps(ENCODER))
    assert model_io.resolve_backend(str(tmp_path), "auto") == "kimi_linear"
    assert model_io.load_encoder_config(str(tmp_path), "kimi_linear") == model.encoder_config
    perf = model_io.with_performance_options(model, compute_dtype="bfloat16",
                                             attention_impl="pallas")
    assert perf.encoder_config.text.compute_dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match="kimi_linear"):
        model_io.build_model("mtl", "kimi_linear", CLASSES, device="cpu")


def test_trainer_refuses_the_backend():
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs, Trainer

    model, _ = _model(15)
    with pytest.raises(NotImplementedError, match="kimi_linear"):
        Trainer(model, TrainArgs(), None, None, None, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 64), ("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
    ("num_expert_group", 4), ("rope_scaling", {"type": "yarn", "factor": 4}),
    ("mla_use_output_gate", True), ("moe_renormalize", False)])
def test_config_refuses_what_the_tower_does_not_compute(key, value):
    bad = dict(ENCODER, text_config=dict(TEXT, **{key: value}))
    with pytest.raises(NotImplementedError, match=key):
        kl.KimiLinearConfig.from_dict(bad)


def test_config_refuses_a_layer_list_that_misses_a_layer_and_a_share_outside_the_router():
    lin = dict(TEXT["linear_attn_config"], kda_layers=[1, 2, 3])
    with pytest.raises(NotImplementedError, match="cover the layers"):
        kl.KimiLinearConfig.from_dict(dict(ENCODER, text_config=dict(
            TEXT, linear_attn_config=lin)))
    with pytest.raises(ValueError, match="inside the router"):
        kl.KimiLinearConfig.from_dict(dict(ENCODER, text_config=dict(
            TEXT, first_held_expert=14)))


# the benchmark configuration's own keys; the rest of its top level is the
# published config.json with the card's share
HARNESS_KEYS = {"name", "source", "family", "reduced", "assumed", "text_config", "vision_config",
                "projection_dim", "max_text_length", "tokenizer", "image", "head", "recipe",
                "deployment"}


def _published():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "configs", "kimi-linear-48b-a3b-ep4-siglip2-224-fusion.json")
    with open(path) as f:
        return json.load(f)


def test_published_keys_and_text_config_are_one_copy():
    """The configuration's top level and ``text_config`` hold exactly the
    same keys and values; the held experts are the one key reduced."""
    published = _published()
    top = {k: v for k, v in published.items() if k not in HARNESS_KEYS}
    assert top == published["text_config"]
    assert [k for k in published["reduced"]] == ["num_experts"]
    assert published["num_experts"] == 64 and published["num_experts_published"] == 256


def test_published_config_parses_to_the_defaults_with_the_share():
    """Kimi-Linear-48B-A3B's published text config (the benchmark's) parses
    to the defaults but for the share: 27 layers, 20 KDA and 7 MLA, 26
    expert layers, a router of 256 at top-8 with 64 held from expert 0, q/k
    heads of 192 at scale 192^-0.5."""
    cfg = kl.KimiLinearConfig.from_dict(_published())
    default = kl.KimiLinearConfig.published_siglip2_224()
    assert cfg == dataclasses.replace(default, vision=cfg.vision,
                                      text=dataclasses.replace(default.text, n_held=64))
    t = cfg.text
    assert len(t.kda_layers) == 20 and t.moe_layers == 26 and t.n_router == 256
    assert [i for i in range(27) if not t.is_kda(i)] == [3, 7, 11, 15, 19, 23, 26]
    assert t.router == moe.Router(sigmoid=True, first=0)
    assert abs(t.softmax_scale - 192 ** -0.5) < 1e-12
