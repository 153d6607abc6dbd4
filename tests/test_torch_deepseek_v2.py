"""The ``deepseek_v2`` backend on the CPU: DeepSeek-V2's text tower
(``models/deepseek_v2.py``) and its expert layer (``ops/moe.py``) at a tiny
size with DeepSeek-V2-Lite's structure (hidden 64, 4 heads of 16 + 8 rotary
for q and k and 16 for v, a latent of 32, a dense first layer, then 8
routed experts, top-2, and 1 shared; 3 layers; YaRN factor 40), held to the
plain fp32 reference ``tests/plain_deepseek_v2.py`` (HF names, HF's
equations).

Tolerance against the reference: 1e-4 absolute and relative. Both sides
are fp32 on the CPU; they differ in the order of their sums (the port packs
the kept tokens, fuses q_proj with kv_a_proj_with_mqa into one product and
sums the experts in top-k order), a few fp32 ulps at features of order 1.
Where both sides are the port at two shapes (padding, buckets) the
features agree to 1e-5: the same arithmetic over more masked positions."""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

import plain_deepseek_v2 as plain
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.models import convert, deepseek_v2 as ds
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models import fusion, model_io
from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.models import siglip as siglip_mod
from multimodal_content_moderation_tpu_torch.models.export import fusion_model_to_torch
from multimodal_content_moderation_tpu_torch.models.u8wire import embed_pixels
from multimodal_content_moderation_tpu_torch.ops import moe
from multimodal_content_moderation_tpu_torch.utils import profiling

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
MEAN = STD = (0.5, 0.5, 0.5)
TEXT = {
    "vocab_size": 600, "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 96, "moe_intermediate_size": 32,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "topk_method": "greedy", "norm_topk_prob": False,
    "n_group": 1, "topk_group": 1, "kv_lora_rank": 32, "q_lora_rank": None,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "max_position_embeddings": 163840, "hidden_act": "silu",
    "attention_bias": False, "model_type": "deepseek_v2",
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
}
VISION = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
          "intermediate_size": 64, "image_size": 32, "patch_size": 8, "num_channels": 3,
          "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6}
ENCODER = {"model_type": "deepseek_v2", "text_config": TEXT, "vision_config": VISION,
           "projection_dim": 32}
TOL = dict(atol=1e-4, rtol=1e-4)


def _hf_state_dict(seed=0):
    """(config, HF-named fp32 state dict) of a tiny random fusion model, its
    norm weights drawn around 1."""
    cfg = ds.DeepSeekV2Config.from_dict(ENCODER)
    model = fusion.FusionModel.create("deepseek_v2", num_labels=5, fusion_dim=16,
                                      encoder_config=cfg, seed=seed, device="cpu")
    sd = fusion_model_to_torch(model)
    g = torch.Generator().manual_seed(seed + 1)
    for k in sd:
        if "text_model" in k and k.endswith("norm.weight"):
            sd[k] = 1 + 0.2 * torch.randn(sd[k].shape, generator=g)
    return cfg, sd


def _model(seed=0):
    cfg, sd = _hf_state_dict(seed)
    params = convert.fusion_model_from_torch(sd, "deepseek_v2", encoder_cfg=cfg)
    return fusion.FusionModel(params, "deepseek_v2", num_labels=5, fusion_dim=16,
                              encoder_config=cfg), sd


def _rows(seed, B=5, T=16, lo=1):
    g = np.random.default_rng(seed)
    lengths = g.integers(lo, T + 1, size=B)
    lengths[0] = T  # one row with no padding
    ids = g.integers(2, TEXT["vocab_size"], size=(B, T))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int64)
    ids = ids * mask + (1 - mask)  # pad id 1 past each row
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tower_matches_the_plain_reference(seed):
    model, sd = _model(seed)
    ids, mask = _rows(seed)
    with torch.no_grad():
        got = ds.deepseek_text_features(model.backbone, ids, mask, model.encoder_config)
        want = plain.text_features(sd, TEXT, ids, mask)
    torch.testing.assert_close(got, want, **TOL)


def test_fusion_logits_use_the_deepseek_text_feature():
    """The whole model's logits: the fusion head over the tower's feature
    (against the reference's) and SigLIP's vision feature."""
    model, sd = _model(3)
    ids, mask = _rows(3)
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


def _layer(seed, E=8, d=64, f=32, k=2, case="random"):
    """A random expert layer and tokens; ``case`` sets the gate so that one
    expert holds a slot of every token, some experts hold none, or pairs of
    experts tie."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(40, d, generator=g)
    gate = torch.randn(d, E, generator=g) * d ** -0.5
    if case == "one_expert_everywhere":
        x[:, 0] = 10.0
        gate[0] = 0.0
        gate[0, 3] = 10.0
    elif case == "empty_experts":
        x[:, 0] = 10.0
        gate[0, 6:] = -10.0
    elif case == "ties":
        gate[:, 2] = gate[:, 1]
        gate[:, 5] = gate[:, 4]
    p = {"gate": {"w": gate},
         "experts": {"gate_up": torch.randn(E, 2 * f, d, generator=g) * d ** -0.5,
                     "down": torch.randn(E, d, f, generator=g) * f ** -0.5},
         "shared": {"gate_up": {"w": torch.randn(d, 2 * f, generator=g) * d ** -0.5},
                    "down": {"w": torch.randn(f, d, generator=g) * f ** -0.5}}}
    return x, p


def _brute_force(x, p, k, scaling):
    """Every expert on every token, each weighted by its routing weight
    where it is among the token's top k and by 0 elsewhere, summed, plus the
    shared experts."""
    probs = torch.softmax(x @ p["gate"]["w"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    weight = torch.zeros_like(probs).scatter(1, top, probs.gather(1, top) * scaling)
    gate, up = moe.split_gate_up(p["experts"]["gate_up"])
    out = torch.zeros_like(x)
    for e in range(gate.shape[0]):
        h = torch.nn.functional.silu(x @ gate[e].t()) * (x @ up[e].t())
        out += weight[:, e, None] * (h @ p["experts"]["down"][e].t())
    s = p["shared"]
    fs = s["gate_up"]["w"].shape[1] // 2
    gu = x @ s["gate_up"]["w"]
    return out + (torch.nn.functional.silu(gu[:, :fs]) * gu[:, fs:]) @ s["down"]["w"]


@pytest.mark.parametrize("k", [1, 2, 6])
@pytest.mark.parametrize("case", ["random", "one_expert_everywhere", "empty_experts", "ties"])
def test_expert_layer_matches_a_brute_force_sum(case, k):
    x, p = _layer(7, case=case)
    hist = torch.zeros(8, dtype=torch.int32)
    got = moe.moe_layer(x, p, k, 1.0, hist)
    torch.testing.assert_close(got, _brute_force(x, p, k, 1.0), atol=1e-5, rtol=1e-5)
    assert int(hist.sum()) == k * x.shape[0]
    idx, _ = moe.route_reference(x @ p["gate"]["w"], k, 1.0)
    if case == "one_expert_everywhere":
        assert bool((idx == 3).any(1).all()) and int(hist[3]) == x.shape[0]
    if case == "empty_experts":
        assert hist[6:].tolist() == [0, 0]
    if case == "ties":  # the lower of two equal experts comes first
        for lo, hi in ((1, 2), (4, 5)):
            both = (idx == lo).any(1) & (idx == hi).any(1)
            pos = lambda e: (idx == e).int().argmax(1)  # noqa: E731
            assert bool((pos(lo)[both] < pos(hi)[both]).all())
            assert not bool(((idx == hi).any(1) & ~(idx == lo).any(1)).any())


def test_expert_layer_gradients_flow_in_fp32():
    """The plain path with gradients on (the CPU's) differentiates through
    the experts, the router's weights and the shared experts."""
    x, p = _layer(8)
    leaves = [p["gate"]["w"], p["experts"]["gate_up"], p["experts"]["down"]]
    for t in leaves:
        t.requires_grad_(True)
    moe.moe_layer(x, p, 2, 1.0).square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in leaves)


@pytest.mark.parametrize("width", [16, 64])
def test_packing_changes_nothing(width):
    """The same rows padded to 16 or to ``width`` columns give the same
    features: only the kept tokens are computed."""
    model, _ = _model(4)
    ids, mask = _rows(4, T=16)
    wide_ids = torch.ones(ids.shape[0], width, dtype=ids.dtype)
    wide_mask = torch.zeros_like(wide_ids)
    wide_ids[:, :16], wide_mask[:, :16] = ids, mask
    cfg = model.encoder_config
    with torch.no_grad():
        a = ds.deepseek_text_features(model.backbone, ids, mask, cfg)
        b = ds.deepseek_text_features(model.backbone, wide_ids, wide_mask, cfg,
                                      kept=int(mask.sum()))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_pack_indices():
    mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0], [1, 0, 0, 0]])
    pk = ds.pack(mask, int(mask.sum()))
    assert pk.src.tolist() == [0, 1, 4, 5, 6, 7, 12]
    assert pk.pos.tolist() == [0, 1, 0, 1, 2, 3, 0]
    assert pk.last.tolist() == [1, 5, 5, 6]


def test_pool_is_the_last_kept_token():
    """Under right padding the feature is the last kept token's: a pad's id
    changes nothing, the last kept token's changes it, and a row alone at
    its own length gives the same feature."""
    model, _ = _model(5)
    cfg = model.encoder_config
    ids, mask = _rows(5, B=4, T=12, lo=3)
    n = mask.sum(1)
    with torch.no_grad():
        base = ds.deepseek_text_features(model.backbone, ids, mask, cfg)
        pads = ids.clone()
        pads[mask == 0] = 77
        torch.testing.assert_close(
            ds.deepseek_text_features(model.backbone, pads, mask, cfg), base, atol=0, rtol=0)
        last = ids.clone()
        last[torch.arange(4), n - 1] = (last[torch.arange(4), n - 1] + 1) % TEXT["vocab_size"]
        moved = ds.deepseek_text_features(model.backbone, last, mask, cfg)
        assert bool(((moved - base).abs().amax(1) > 1e-3).all())
        for b in range(4):
            alone = ds.deepseek_text_features(model.backbone, ids[b:b + 1, :n[b]],
                                              mask[b:b + 1, :n[b]], cfg)
            torch.testing.assert_close(alone[0], base[b], atol=1e-5, rtol=1e-5)


def test_hf_loader_round_trips():
    """HF names -> the port's tree -> HF names gives every leaf back, and
    the stacked experts hold each expert's HF weights."""
    model, sd = _model(6)
    back = fusion_model_to_torch(model)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k].float()), k
    gu = model.backbone["text_model"]["layers"][1]["mlp"]["experts"]["gate_up"]
    gate, up = moe.split_gate_up(gu)
    pre = "backbone.text_model.layers.1.mlp.experts.5"
    assert torch.equal(gate[5], sd[f"{pre}.gate_proj.weight"])
    assert torch.equal(up[5], sd[f"{pre}.up_proj.weight"])
    # the layout the grouped kernel reads: 8 gate rows, then the same 8 up rows
    assert torch.equal(gu[5, 16:24], sd[f"{pre}.gate_proj.weight"][8:16])
    assert torch.equal(gu[5, 24:32], sd[f"{pre}.up_proj.weight"][8:16])
    assert not any("lm_head" in k for k in sd)


def test_loader_keeps_the_state_dict_device_and_dtype():
    """The text tower is converted where its leaves lie, in their dtype, and
    owns its memory (no view of the state dict)."""
    cfg, sd = _hf_state_dict(7)
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tree = ds.deepseek_v2_params_from_torch(sd, cfg, prefix="backbone.")
    experts = tree["text_model"]["layers"][2]["mlp"]["experts"]["down"]
    assert experts.dtype == torch.bfloat16 and experts.shape == (8, 64, 32)
    emb = tree["text_model"]["embed_tokens"]
    assert emb.data_ptr() != sd["backbone.text_model.embed_tokens.weight"].data_ptr()


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
    model, _ = _model(8)
    engine = _engine(model)
    ids, mask, patches, tp, ip = _u8_batch(8, 6, 16)
    mask[:, width:] = 0
    ids[:, width:] = 1
    full = engine(ids, mask, patches, tp, ip)
    assert tfi.bucket_for(mask.numpy(), [8, 12, 16],
                          extra=backbone("deepseek_v2").bucket_extra) == width
    ids_b, mask_b, carry = tfi.bucket_batch_text(ids.numpy(), mask.numpy(), width,
                                                 "deepseek_v2")
    assert carry is None and ids_b.shape == (6, width)
    got = engine(torch.from_numpy(ids_b), torch.from_numpy(mask_b), patches, tp, ip)
    torch.testing.assert_close(got, full, atol=1e-5, rtol=1e-5)


def _dataset(tmp_path, data_dir, encoder_dir):
    rows = pd.read_csv(f"{data_dir}/test.csv")
    rows["text"] = [" ".join(["hate", "love"][i % 2] for _ in range(i + 1))
                    for i in range(len(rows))]
    rows.to_csv(tmp_path / "test.csv", index=False)
    return CSVDataset(str(tmp_path / "test.csv"), f"{data_dir}/images",
                      load_tokenizer(encoder_dir),
                      ImagePreprocessor(32, 32, MEAN, STD, output="uint8_hwc"), 16,
                      class_names=CLASSES)


def test_evaluate_buckets_exactly_and_counts(tmp_path, data_dir, encoder_dir, monkeypatch):
    """``evaluate_logits_u8`` with buckets gives the logits without them; a
    recorded pass counts the packing (kept tokens, positions, routed slots),
    the expert layers, the plain attention core, the largest expert's slots
    and the grouped products' pad rows (each expert's slots up to a whole
    number of 64-row halves, from every layer's counts read here), and holds
    the spans of the tower."""
    model, _ = _model(9)
    engine = _engine(model)
    ds_ = _dataset(tmp_path, data_dir, encoder_dir)
    B = 6
    off, _ = tfi.evaluate_logits_u8(engine, ds_, B, num_workers=2)
    layer_counts = []
    real_layer = ds.moe_layer

    def counting_layer(x, p, k, scaling, hist=None, *rest):
        out = real_layer(x, p, k, scaling, hist, *rest)
        if hist is not None:
            layer_counts.append(hist.tolist())
        return out

    monkeypatch.setattr(ds, "moe_layer", counting_layer)
    with profiling.recording() as rec:
        on, _ = tfi.evaluate_logits_u8(engine, ds_, B, num_workers=2, seq_buckets=(8, 12))
    np.testing.assert_allclose(on, off, atol=1e-5, rtol=1e-5)
    c = rec.counters
    batches = -(-len(ds_) // B)
    kept = int(ds_.attention_mask.sum())
    assert c["text.kept_tokens"] == c["score.text_tokens"] == kept
    assert c["text.positions"] == c["score.text_slots"] < batches * B * 16
    assert c["moe.routed_slots"] == kept * 2 * 2
    assert c["moe.layers"] == c["moe.plain"] == 2 * batches  # the CPU: the plain layer
    assert c["model.attention.plain"] == 3 * batches
    # padded rows of the last batch are kept tokens of their own
    assert kept * 2 // 8 <= c["moe.max_expert_slots"] / 2 <= c["moe.routed_slots"] / 2
    assert len(layer_counts) == c["moe.layers"]
    assert c["moe.grouped_pad_rows"] == sum(-(-n // 64) * 64 - n for row in layer_counts
                                            for n in row)
    assert 0 < c["moe.grouped_pad_rows"] < 64 * len(layer_counts) * len(layer_counts[0])
    names = {s.name for s in rec.spans}
    assert {"text.pack", "mla.attention", "moe.route", "moe.experts", "moe.combine"} <= names


def test_backend_never_reaches_siglip_text_path(monkeypatch, tmp_path):
    """Scoring, the encoder config, the buckets and ``auto`` all take the
    backend's own branches: SigLIP's text tower is never called."""

    def refuse(*a, **k):
        raise AssertionError("SigLIP's text tower was called")

    monkeypatch.setattr(siglip_mod, "siglip_text_features", refuse)
    model, _ = _model(10)
    engine = _engine(model)
    engine(*_u8_batch(10, 3, 8))
    assert fusion.config_field("deepseek_v2") == "encoder_config"
    assert isinstance(model.encoder_config, ds.DeepSeekV2Config)
    assert not hasattr(model, "siglip_config")
    assert model.feature_dim == 32
    assert backbone("deepseek_v2").bucket_extra == 0 and backbone("deepseek_v2").exact_buckets
    (tmp_path / "config.json").write_text(json.dumps(ENCODER))
    assert model_io.resolve_backend(str(tmp_path), "auto") == "deepseek_v2"
    enc = model_io.load_encoder_config(str(tmp_path), "deepseek_v2")
    assert enc == model.encoder_config
    perf = model_io.with_performance_options(model, compute_dtype="bfloat16",
                                             attention_impl="pallas")
    assert perf.encoder_config.text.compute_dtype == "bfloat16"
    assert perf.encoder_config.vision.attention_impl == "pallas"
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        model_io.build_model("mtl", "deepseek_v2", CLASSES, device="cpu")
    with pytest.raises(ValueError, match="deepseek_v3"):
        fusion.config_field("deepseek_v3")


def test_trainer_refuses_the_backend():
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs, Trainer

    model, _ = _model(11)
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        Trainer(model, TrainArgs(), None, None, None, device="cpu")


def test_config_refuses_what_the_tower_does_not_compute():
    for key, value in (("q_lora_rank", 64), ("topk_method", "group_limited_greedy"),
                       ("norm_topk_prob", True), ("scoring_func", "sigmoid")):
        bad = dict(ENCODER, text_config=dict(TEXT, **{key: value}))
        with pytest.raises(NotImplementedError, match=key):
            ds.DeepSeekV2Config.from_dict(bad)


# the benchmark configuration's own keys; the rest of its top level is the
# published config.json
HARNESS_KEYS = {"name", "source", "family", "reduced", "assumed", "text_config", "vision_config",
                "projection_dim", "max_text_length", "tokenizer", "image", "head", "recipe"}


def _published():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "configs", "deepseek-v2-lite-siglip2-224-fusion.json")
    with open(path) as f:
        return json.load(f)


def test_published_keys_and_text_config_are_one_copy():
    """The configuration's top level holds the published config.json as it
    is, and ``text_config`` (what the encoder directory is written from)
    holds exactly the same keys and values: the two copies cannot drift."""
    published = _published()
    top = {k: v for k, v in published.items() if k not in HARNESS_KEYS}
    assert top == published["text_config"]
    assert published["reduced"] == []


def test_published_config_parses_to_the_lite_defaults():
    """DeepSeek-V2-Lite's published text config (the benchmark's) parses to
    the dataclass defaults: 27 layers, 26 of them expert layers, 64 + 2
    experts of 1,408, top-6, q/k heads of 192, the YaRN scale."""
    published = _published()
    cfg = ds.DeepSeekV2Config.from_dict(published)
    default = ds.DeepSeekV2Config.lite_siglip2_224()
    assert cfg == dataclasses.replace(default, vision=cfg.vision)
    assert cfg.text.moe_layers == 26 and cfg.text.q_head_dim == 192
    assert abs(cfg.text.softmax_scale - 192 ** -0.5 * (0.1 * 0.707 * np.log(40) + 1) ** 2) < 1e-9
