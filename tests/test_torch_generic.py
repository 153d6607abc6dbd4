"""The port's generic dual encoder (``models/generic.py``: BERT, RoBERTa and
DistilBERT text towers, a ViT) against the JAX package's, and against
``transformers``' own ``VisionTextDualEncoderModel``, on tiny towers: two
layers, 2 heads, width 32 (text MLP 64, vision MLP 48), 32-pixel images in
16-pixel patches, except where a test says otherwise. Both packages get
the same weights (``bridge.load_jax_params``) and the same inputs, made
from a seed with numpy.

- the towers' pooled features, every tower family, both attention cores
  (the kernels' plain versions here, interpret mode in JAX): fp32 atol 1e-5;
  a ViT at 224 px in 16-pixel patches (T = 197, which JAX pads to 200);
- the converters against ``transformers``' ``get_text_features`` /
  ``get_image_features`` and pooler outputs: atol 2e-5, as the JAX
  package's own test;
- the fusion and multi-task models, logits and loss (atol 1e-5 / 1e-6) and
  gradients on every leaf (atol 2e-5 + rtol 1e-4) on both wires, one AdamW
  step against optax;
- the ``mha`` dispatch: active dropout takes the non-kernel core, past 256
  positions the kernel path is ``fused_mha``;
- dropout: its rate, the fork of the encoder's generator, and remat that
  replays the masks (gradients equal to the un-rematted ones, exactly);
- buckets off for the generic backend in the engine, the evaluate CLI, the
  classifier and the handler, each against JAX's buckets-off logits, and
  the JAX classifier's bucket shift (a fault of the JAX package) shown;
- ``load_checkpoint`` on reference-format fusion and multi-task
  checkpoints and on the port's own run directory; the train CLI with
  ``backend: auto`` on a ``VisionTextDualEncoderModel`` directory."""

import base64
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

transformers = pytest.importorskip("transformers")

from multimodal_content_moderation_tpu.models import FusionModel as JFusion  # noqa: E402
from multimodal_content_moderation_tpu.models import MultiTaskModel as JMTL  # noqa: E402
from multimodal_content_moderation_tpu.models import fast_infer as jfi  # noqa: E402
from multimodal_content_moderation_tpu.models import generic as jgen  # noqa: E402
from multimodal_content_moderation_tpu.models.convert import (  # noqa: E402
    fusion_model_from_torch as j_fusion_from_torch,
)
from multimodal_content_moderation_tpu.models.convert import (  # noqa: E402
    mtl_model_from_torch as j_mtl_from_torch,
)
from multimodal_content_moderation_tpu.models.export import (  # noqa: E402
    export_safetensors,
    fusion_model_to_torch,
    mtl_model_to_torch,
)
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8  # noqa: E402
from multimodal_content_moderation_tpu.training.optim import build_optimizer  # noqa: E402
from multimodal_content_moderation_tpu_torch.data.images import normalize_crop  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import generic as tgen  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import model_io  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.convert import (  # noqa: E402
    fusion_model_from_torch,
    mtl_model_from_torch,
)
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.params import flatten, map_leaves  # noqa: E402
from multimodal_content_moderation_tpu_torch.ops import layers  # noqa: E402
from multimodal_content_moderation_tpu_torch.training.loop import make_train_step  # noqa: E402
from multimodal_content_moderation_tpu_torch.training.optim import AdamW  # noqa: E402
from test_torch_inference import TEXTS, images  # noqa: E402, F401  (fixture)
from test_torch_pixel_path import assert_adam_step_matches  # noqa: E402

TASKS = ["racist", "sexist", "homophobe", "religion", "otherhate"]
N = len(TASKS)
T_TEXT = 12
V = 64  # the tiny text towers' vocabulary
HALF = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))  # the generic backend's default stats
PW = np.array([1.0, 2.5, 0.5, 1.5, 3.0], np.float32)

VIT = dict(model_type="vit", hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=48, image_size=32, patch_size=16, num_channels=3,
           hidden_act="gelu", layer_norm_eps=1e-12)
TEXT = {
    "bert": dict(model_type="bert", vocab_size=V, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64, max_position_embeddings=32,
                 type_vocab_size=2, pad_token_id=0, hidden_act="gelu", layer_norm_eps=1e-12),
    "roberta": dict(model_type="roberta", vocab_size=V, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=64, max_position_embeddings=34,
                    type_vocab_size=1, pad_token_id=1, hidden_act="gelu",
                    layer_norm_eps=1e-5),
    "distilbert": dict(model_type="distilbert", vocab_size=V, dim=32, n_layers=2, n_heads=2,
                       hidden_dim=64, max_position_embeddings=32, pad_token_id=0,
                       activation="gelu"),
}
PAD = {"bert": 0, "roberta": 1, "distilbert": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf(arch="bert", projection_dim=24, vision=None):
    return {"model_type": "vision-text-dual-encoder", "projection_dim": projection_dim,
            "text_config": TEXT[arch], "vision_config": vision or VIT}


def _configs(arch="bert", projection_dim=24, vision=None, **tower):
    """(JAX config, port config) of the same ``config.json``, with ``tower``
    knobs in both towers."""
    d = _hf(arch, projection_dim, vision)
    out = []
    for mod in (jgen, tgen):
        c = mod.GenericDualConfig.from_dict(d)
        out.append(dataclasses.replace(c, text=dataclasses.replace(c.text, **tower),
                                       vision=dataclasses.replace(c.vision, **tower)))
    return tuple(out)


def _torch_tree(jparams):
    return map_leaves(lambda x: torch.from_numpy(np.array(x)), jparams)


def _text(arch, B=4, seed=0, T=T_TEXT):
    """Right-padded ids: [CLS]-like 2, tokens, [SEP]-like 3, then the
    tower's pad id; row 0 one real token, row 1 full."""
    g = np.random.default_rng(seed)
    ids = np.full((B, T), PAD[arch], np.int32)
    mask = np.zeros((B, T), np.int32)
    for i in range(B):
        n = 1 if i == 0 else T if i == 1 else int(g.integers(2, T))
        ids[i, :n] = g.integers(4, V, size=n)
        ids[i, 0] = 2
        if n > 1:
            ids[i, n - 1] = 3
        mask[i, :n] = 1
    return ids, mask


def _batch(wire, B=4, seed=0, arch="bert", labels=True):
    ids, mask = _text(arch, B, seed)
    g = np.random.default_rng(seed + 50)
    crops = g.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    tp = np.ones((B,), np.float32)
    ip = np.ones((B,), np.float32)
    tp[2 % B] = 0.0
    ip[1 % B] = 0.0
    batch = {"input_ids": ids, "attention_mask": mask, "text_present": tp,
             "image_present": ip}
    if labels:
        batch["labels"] = (g.random((B, N)) < 0.4).astype(np.float32)
    if wire == "u8":
        batch["patches_u8"] = extract_patches_u8(crops, 16)
    else:
        batch["pixel_values"] = np.stack([normalize_crop(c, *HALF) for c in crops])
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", sorted(TEXT))
def test_from_dict_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.text.arch == ("distilbert" if arch == "distilbert" else "bert")
    assert tcfg.text.position_style == ("roberta" if arch == "roberta" else "absolute")
    assert tcfg.text.pooling == ("mean" if arch == "distilbert" else "pooler")
    # the canonical config without a config.json: ViT-B/16 + BERT-base
    assert dataclasses.asdict(tgen.GenericDualConfig()) == dataclasses.asdict(
        jgen.GenericDualConfig())


@pytest.mark.parametrize("bad,match", [
    ({"text_config": {"model_type": "gpt2"}, "vision_config": VIT}, "unsupported text tower"),
    ({"text_config": TEXT["bert"], "vision_config": {"model_type": "swin"}},
     "unsupported vision tower"),
    ({"text_config": TEXT["bert"], "vision_config": dict(VIT, hidden_dropout_prob=0.1)},
     "vision-tower dropout"),
])
def test_from_dict_refuses_what_jax_refuses(bad, match):
    for mod in (jgen, tgen):
        with pytest.raises(ValueError, match=match):
            mod.GenericDualConfig.from_dict(bad)


def test_init_tree_matches_jax():
    for arch in sorted(TEXT):
        for proj in (0, 24):
            jcfg, tcfg = _configs(arch, proj)
            want = flatten(jax.tree_util.tree_map(
                np.asarray, jgen.generic_init(jax.random.key(0), jcfg)))
            got = flatten(tgen.generic_init(torch.Generator().manual_seed(0), tcfg))
            assert set(got) == set(want), (arch, proj)
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape, k


# ---------------------------------------------------------------- towers


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", sorted(TEXT))
def test_text_tower_matches_jax(arch, impl):
    jcfg, tcfg = _configs(arch, attention_impl=impl)
    jp = jgen.generic_init(jax.random.key(1), jcfg)
    tp = _torch_tree(jp)
    ids, mask = _text(arch, B=5, seed=1)
    want_h = np.asarray(jgen.generic_text_hidden(jp, jnp.asarray(ids), jnp.asarray(mask),
                                                 jcfg.text))
    want = np.asarray(jgen.generic_text_pooled(jp, jnp.asarray(ids), jnp.asarray(mask),
                                               jcfg.text))
    with torch.inference_mode():
        got_h = tgen.generic_text_hidden(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                         tcfg.text)
        got = tgen.generic_text_pooled(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                       tcfg.text)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert got.dtype == torch.float32 and got.shape == (5, 32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vit_tower_matches_jax(impl):
    jcfg, tcfg = _configs(attention_impl=impl)
    jp = jgen.generic_init(jax.random.key(2), jcfg)
    tp = _torch_tree(jp)
    px = _batch("f32", B=3, seed=2)["pixel_values"]
    want = np.asarray(jgen.generic_image_features(jp, jnp.asarray(px), jcfg))
    with torch.inference_mode():
        got = tgen.generic_image_features(tp, torch.from_numpy(px), tcfg)
    assert got.shape == (3, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_vit_at_197_positions_matches_jax_interpret_mode():
    """ViT at 224 px in 16-pixel patches: 196 patches + the class token,
    T = 197, through the "pallas" core. JAX's ``attention_nhd`` pads 197 to
    200 for Mosaic with masked keys (interpret mode here); the port runs
    the unpadded function (the kernel's plain version here). Width 32."""
    vision = dict(VIT, image_size=224)
    jcfg, tcfg = _configs(vision=vision, attention_impl="pallas")
    jp = jgen.generic_init(jax.random.key(3), jcfg)
    tp = _torch_tree(jp)
    g = np.random.default_rng(3)
    crops = g.integers(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    px = np.stack([normalize_crop(c, *HALF) for c in crops])
    tokens = jgen.generic_vision_tokens(jp, jnp.asarray(px), jcfg.vision)
    assert tokens.shape == (2, 197, 32)
    want = np.asarray(jgen.generic_vision_hidden_from_tokens(jp, tokens, jcfg.vision))
    with torch.inference_mode():
        got = tgen.generic_vision_hidden_from_tokens(
            tp, tgen.generic_vision_tokens(tp, torch.from_numpy(px), tcfg.vision), tcfg.vision)
    assert got.shape == (2, 197, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- converters


@pytest.fixture(scope="module")
def vtde(tmp_path_factory):
    """A tiny ``VisionTextDualEncoderModel`` (ViT + BERT, projection 24)
    saved as an encoder directory with its BERT WordPiece tokenizer.json and
    a 32-pixel, 0.5 / 0.5 preprocessor config."""
    d = tmp_path_factory.mktemp("vtde")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hate", "love", "the", "thing",
             "a", "null", "speech", "online", "world", "hello"]
    words += [f"w{i}" for i in range(V - len(words))]
    (d / "vocab.txt").write_text("\n".join(words))
    transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(str(d))
    torch.manual_seed(0)
    cfg = transformers.VisionTextDualEncoderConfig.from_vision_text_configs(
        transformers.ViTConfig(**{k: v for k, v in VIT.items() if k != "model_type"}),
        transformers.BertConfig(**{k: v for k, v in TEXT["bert"].items()
                                   if k != "model_type"}),
        projection_dim=24,
    )
    model = transformers.VisionTextDualEncoderModel(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=True)
    (d / "preprocessor_config.json").write_text(json.dumps(
        {"size": 32, "image_mean": [0.5] * 3, "image_std": [0.5] * 3}))
    return model, str(d)


def test_converters_match_transformers(vtde):
    model, d = vtde
    assert model_io.resolve_backend(d, "auto") == "generic"
    cfg = model_io.load_encoder_config(d, "generic")
    assert isinstance(cfg, tgen.GenericDualConfig) and cfg.projection_dim == 24
    sd = model.state_dict()
    params = tgen.generic_params_from_torch(sd, cfg)
    want = flatten(jax.tree_util.tree_map(
        np.asarray, jgen.generic_params_from_torch(sd, j_configs_from(d))))
    got = flatten(params)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    ids, mask = _text("bert", B=3, seed=4)
    px = _batch("f32", B=3, seed=4)["pixel_values"]
    ti, tm, tpx = (torch.from_numpy(a) for a in (ids.astype(np.int64), mask, px))
    with torch.inference_mode():
        t_ref = model.get_text_features(input_ids=ti, attention_mask=tm)
        v_ref = model.get_image_features(pixel_values=tpx)
        tp_ref = model.text_model(input_ids=ti, attention_mask=tm).pooler_output
        vp_ref = model.vision_model(pixel_values=tpx).pooler_output
        t = tgen.generic_text_features(params, ti, tm, cfg)
        v = tgen.generic_image_features(params, tpx, cfg)
        tp = tgen.generic_text_pooled(params, ti, tm, cfg.text)
        vp = tgen.generic_vision_pooled(params, tpx, cfg.vision)
    for a, b in ((t, t_ref), (v, v_ref), (tp, tp_ref), (vp, vp_ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5)


def j_configs_from(d):
    from multimodal_content_moderation_tpu.models.model_io import load_encoder_config

    return load_encoder_config(d, "generic")


@pytest.mark.parametrize("arch", ["roberta", "distilbert"])
def test_text_converters_match_transformers(arch):
    """RoBERTa's pad-aware position ids and DistilBERT's names and plain
    mean, on padded rows, against the HF modules."""
    torch.manual_seed(5)
    hf_kw = {k: v for k, v in TEXT[arch].items() if k != "model_type"}
    if arch == "roberta":
        hf = transformers.RobertaModel(transformers.RobertaConfig(**hf_kw)).eval()
        fn = tgen.bert_tower_from_torch
    else:
        hf = transformers.DistilBertModel(transformers.DistilBertConfig(**hf_kw)).eval()
        fn = tgen.distilbert_tower_from_torch
    _, cfg = _configs(arch)
    params = {"text_model": fn(hf.state_dict(), cfg.text, prefix="")}
    ids, mask = _text(arch, B=4, seed=6)
    ti, tm = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)
    with torch.inference_mode():
        out = hf(input_ids=ti, attention_mask=tm)
        want = out.pooler_output if arch == "roberta" else out.last_hidden_state.mean(dim=1)
        got = tgen.generic_text_pooled(params, ti, tm, cfg.text)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------- whole model


def _pair(head, seed=0, arch="bert", **tower):
    """The same tiny generic model in both packages: JAX's init bridged into
    the port, the u8 wire's stats set in both."""
    jcfg, tcfg = _configs(arch, **tower)
    if head == "fusion":
        jmodel = JFusion.create("generic", num_labels=N, fusion_dim=16, generic_config=jcfg)
        tmodel = FusionModel.create("generic", num_labels=N, fusion_dim=16,
                                    generic_config=tcfg, device="cpu")
    else:
        jmodel = JMTL.create("generic", num_tasks=N, fusion_dim=16, head_hidden_dim=8,
                             learnable_task_weights=True, generic_config=jcfg)
        tmodel = MultiTaskModel.create("generic", num_tasks=N, fusion_dim=16,
                                       head_hidden_dim=8, learnable_task_weights=True,
                                       generic_config=tcfg, device="cpu")
    jmodel = dataclasses.replace(jmodel, image_mean=HALF[0], image_std=HALF[1],
                                 embed_impl="reference")
    jparams = jmodel.init(jax.random.key(seed))
    if head == "mtl":
        g = np.random.default_rng(100 + seed)
        jparams["head"]["log_vars"] = jnp.asarray(g.normal(size=N).astype(np.float32) * 0.5)
    tmodel = tmodel.replace(image_mean=HALF[0], image_std=HALF[1])
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


IMPL = {"f32": "xla", "u8": "pallas"}


@pytest.mark.parametrize("wire", ["f32", "u8"])
@pytest.mark.parametrize("head", ["fusion", "mtl"])
def test_logits_and_grads_match_jax(head, wire):
    jmodel, jparams, tmodel = _pair(head, seed=1, attention_impl=IMPL[wire])
    if head == "mtl":
        assert not any(k in tmodel.backbone for k in ("text_projection", "logit_scale"))
    else:
        assert "logit_scale" in tmodel.backbone and tmodel.feature_dim == 24
    batch = _batch(wire, seed=1)
    if wire == "u8":  # no stats on the model: the generic ViT takes 0.5 / 0.5
        with torch.inference_mode():
            torch.testing.assert_close(
                tmodel.replace(image_mean=None, image_std=None)(_tb(batch))["logits"],
                tmodel(_tb(batch))["logits"], atol=0, rtol=0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, batch, pos_weight=jnp.asarray(PW))["loss"])(jparams)
    jlogits = np.asarray(jmodel.apply(jparams, batch)["logits"])
    out = tmodel(_tb(batch), pos_weight=torch.from_numpy(PW))
    np.testing.assert_allclose(out["logits"].detach().numpy(), jlogits, atol=1e-5, rtol=0)
    assert float(out["loss"].detach()) == pytest.approx(float(jloss), abs=1e-6)
    out["loss"].backward()
    want = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name]
        if g is None:  # logit_scale: the loss does not reach it
            assert not np.any(w), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4, err_msg=name)


# elements of test_adamw_step_matches_jax held to the looser bound of
# assert_adam_step_matches (0 < |clipped JAX gradient| < 100 eps), of the
# tiny fusion model's 67,286: the towers' small gradients (none of them is
# past atol 5e-5 here either)
ILL_CONDITIONED = 738


def test_adamw_step_matches_jax():
    jmodel, jparams, tmodel = _pair("fusion", seed=3)
    batch = _batch("f32", seed=3)
    kw = dict(lr_encoder=1e-3, lr_head=1e-2, weight_decay=0.02, max_grad_norm=1.0,
              total_steps=3, warmup_ratio=0.0, schedule="cosine")
    tx = build_optimizer(jparams, **kw)
    jloss, g = jax.value_and_grad(lambda q: jmodel.apply(q, batch)["loss"])(jparams)
    upd, _ = tx.update(g, tx.init(jparams), jparams)
    want = flatten(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, upd)))
    step = make_train_step(tmodel, AdamW(dict(tmodel.named_parameters()), **kw))
    assert float(step(_tb(batch))) == pytest.approx(float(jloss), abs=1e-6)
    assert assert_adam_step_matches(tmodel, want, g, kw) == ILL_CONDITIONED


# ---------------------------------------------------------------- mha and dropout


def test_mha_dispatch_with_dropout_and_past_256(monkeypatch):
    """Active dropout takes the non-kernel core in every branch (the single
    query, ``attention_nhd``, ``fused_mha``); past 256 positions the kernel
    path is ``fused_mha``."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "attention_nhd_diff",
                        spy("attention_nhd", layers.attention_nhd_diff))
    monkeypatch.setattr(layers, "fused_mha", spy("fused_mha", layers.fused_mha))
    g = np.random.default_rng(7)
    p = {n: {"w": torch.from_numpy(g.normal(size=(32, 32)).astype(np.float32) * 0.2),
             "b": torch.zeros(32)} for n in "qkvo"}
    for T, want in ((12, "attention_nhd"), (300, "fused_mha")):
        x = torch.from_numpy(g.normal(size=(2, T, 32)).astype(np.float32))
        km = torch.zeros(2, T)
        calls.clear()
        eval_out = layers.mha(x, x, p, 2, impl="pallas", key_mask=km, probs_dropout=0.1)
        assert calls == [want]  # no generator: no dropout, the kernel path
        calls.clear()
        gen = torch.Generator().manual_seed(0)
        train = layers.mha(x, x, p, 2, impl="pallas", key_mask=km, probs_dropout=0.1,
                           generator=gen)
        assert calls == [] and not torch.allclose(train, eval_out)
        # the same draw through the "xla" core: the same function
        xla = layers.mha(x, x, p, 2, impl="xla", key_mask=km, probs_dropout=0.1,
                         generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(train, xla, atol=0, rtol=0)
    q = torch.from_numpy(g.normal(size=(2, 1, 32)).astype(np.float32))
    kv = torch.from_numpy(g.normal(size=(2, 9, 32)).astype(np.float32))
    single = layers.mha(q, kv, p, 2, impl="pallas")
    dropped = layers.mha(q, kv, p, 2, impl="pallas", probs_dropout=0.5,
                         generator=torch.Generator().manual_seed(1))
    assert calls == [] and not torch.allclose(single, dropped)


def test_dropout_rate_and_fork():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    for rate in (0.1, 0.5):
        y = layers.dropout(x, rate, gen)
        assert abs(float((y == 0).float().mean()) - rate) < 0.005
        kept = y[y != 0]
        torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - rate)))
    # a fork leaves the parent one draw further on whatever the child draws
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    ca, cb = layers.fork_generator(a), layers.fork_generator(b)
    torch.testing.assert_close(torch.rand(4, generator=ca), torch.rand(4, generator=cb))
    torch.rand(1000, generator=ca)
    torch.testing.assert_close(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert not torch.equal(torch.rand(8, generator=layers.fork_generator(a)),
                           torch.rand(8, generator=a))


def test_training_dropout_only_with_a_generator_and_head_stream_independent(monkeypatch):
    """The text tower drops only under a generator, and the encoder's draws
    do not move the head's: the forward's head dropout is the same whether
    the text tower's rates are 0.1 or 0 (the fork, as JAX's key split)."""
    _, _, tmodel = _pair("fusion", seed=4)
    batch = _tb(_batch("f32", seed=4))
    with torch.no_grad():
        ev1, ev2 = tmodel(batch)["logits"], tmodel(batch)["logits"]
        torch.testing.assert_close(ev1, ev2, atol=0, rtol=0)
        tr = tmodel(batch, generator=torch.Generator().manual_seed(0))["logits"]
        assert not torch.allclose(tr, ev1)
    zero = tmodel.replace(generic_config=dataclasses.replace(
        tmodel.generic_config, text=dataclasses.replace(
            tmodel.generic_config.text, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)))
    from multimodal_content_moderation_tpu_torch.models import fusion as fusion_mod

    real = fusion_mod.dropout
    states = []

    def spy(x, rate, g):  # the head's one dropout site: the generator's state there
        states.append(g.get_state().clone())
        return real(x, rate, g)

    for m in (tmodel, zero):
        monkeypatch.setattr(fusion_mod, "dropout", spy)
        with torch.no_grad():
            m(batch, generator=torch.Generator().manual_seed(9))
        monkeypatch.setattr(fusion_mod, "dropout", real)
    assert len(states) == 2 and torch.equal(states[0], states[1])


def test_remat_replays_dropout_masks_exactly():
    """Gradients with remat equal those without, exactly, in fp32, under
    the same generator seed (``checkpoint_replaying``); a plain
    ``torch.utils.checkpoint`` redraws the masks in the recompute and
    differs."""
    def grads(remat, monkeypatch_plain=False):
        _, _, m = _pair("fusion", seed=5, remat=remat)
        if monkeypatch_plain:
            from multimodal_content_moderation_tpu_torch.models import generic as gmod

            saved = gmod.checkpoint_replaying
            gmod.checkpoint_replaying = lambda fn, x, g: torch.utils.checkpoint.checkpoint(
                fn, x, g, use_reentrant=False)
        try:
            loss = m(_tb(_batch("f32", seed=5)),
                     generator=torch.Generator().manual_seed(0))["loss"]
            loss.backward()
        finally:
            if monkeypatch_plain:
                gmod.checkpoint_replaying = saved
        return float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()
                             if p.grad is not None}

    loss0, g0 = grads(False)
    loss1, g1 = grads(True)
    assert loss0 == loss1 and set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    _, g2 = grads(True, monkeypatch_plain=True)
    assert any(not torch.equal(g0[n], g2[n]) for n in g0 if "text_model.layers" in n)


def test_trainer_counts_the_class_token_against_the_kernels_limit(tmp_path):
    """The ViT's class token counts: 256 patches + 1 is past the 256
    positions ``attention_nhd`` takes, so training it with the kernels
    would need ``flash_attention``'s missing backward and is refused; at
    240 px (225 + 1) the Trainer takes it."""
    from multimodal_content_moderation_tpu_torch.training.loop import TrainArgs, Trainer

    for size, refused in ((256, True), (240, False)):
        _, tcfg = _configs(vision=dict(VIT, image_size=size), attention_impl="pallas")
        model = FusionModel.create("generic", num_labels=N, fusion_dim=16,
                                   generic_config=tcfg, device="cpu")
        args = TrainArgs(output_dir=str(tmp_path / str(size)), wire="u8", num_workers=0)
        rows = _Rows(4, seed=8)
        if refused:
            with pytest.raises(NotImplementedError, match="257 positions"):
                Trainer(model, args, rows, rows, lambda x: {}, device="cpu")
        else:
            assert Trainer(model, args, rows, rows, lambda x: {}, device="cpu").patch_size == 16


# ---------------------------------------------------------------- engine + checkpoints


class _Rows:
    """Seeded uint8 32x32 crops and right-padded BERT-style ids with the
    ``CSVDataset.batches`` contract that both packages' engines read."""

    def __init__(self, n, seed):
        g = np.random.default_rng(seed)
        self.input_ids, self.attention_mask = _text("bert", n, seed)
        self.images = g.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        self.labels = (g.random((n, N)) < 0.4).astype(np.float32)
        self.present = np.ones((n,), np.float32)

    def __len__(self):
        return len(self.input_ids)

    def batches(self, batch_size, pad_to_batch=False, num_workers=0, indices=None, **_):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        for s in range(0, len(order), batch_size):
            idx = order[s : s + batch_size]
            batch = {"input_ids": self.input_ids[idx],
                     "attention_mask": self.attention_mask[idx],
                     "pixel_values": self.images[idx], "text_present": self.present[idx],
                     "image_present": self.present[idx], "labels": self.labels[idx]}
            valid = len(idx)
            if pad_to_batch:
                batch = {k: np.concatenate([v, np.zeros((batch_size - valid,) + v.shape[1:],
                                                        v.dtype)]) for k, v in batch.items()}
                batch["_valid"] = np.int32(valid)
            yield batch


@pytest.mark.parametrize("head", ["fusion", "mtl"])
def test_engine_ignores_buckets_and_matches_jax(head):
    """The mean over the pads (the DistilBERT-style pooling, set in both
    towers) would move under a narrower batch: the engine runs the full width
    whatever ``seq_buckets`` says, as JAX's does."""
    jmodel, jparams, tmodel = _pair(head, seed=6, attention_impl="pallas", pooling="mean")
    rows = _Rows(13, seed=6)  # a padded last batch of 5
    jeng = jfi.FastInferenceEngine(jmodel, jparams, *HALF, use_pallas=False)
    want, wlabels = jfi.evaluate_logits_u8(jeng, rows, 8, num_workers=0)
    teng = tfi.FastInferenceEngine(tmodel, *HALF)
    assert teng.patch_size == 16
    got = {b: tfi.evaluate_logits_u8(teng, rows, 8, num_workers=0, seq_buckets=b)
           for b in (None, (6, 8))}
    np.testing.assert_allclose(got[None][0], want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[None][1], wlabels)
    np.testing.assert_array_equal(got[(6, 8)][0], got[None][0])
    # what a bucket of 8 would have given: another mean
    rows.input_ids, rows.attention_mask = rows.input_ids[:, :8], rows.attention_mask[:, :8]
    cut, _ = tfi.evaluate_logits_u8(teng, rows, 8, num_workers=0)
    assert np.abs(cut - got[None][0]).max() > 1e-3


def _write_reference_checkpoint(directory, jmodel, jparams, head, encoder_dir, max_len=16):
    sd = (fusion_model_to_torch if head == "fusion" else mtl_model_to_torch)(jparams, jmodel)
    export_safetensors(jparams, jmodel, str(directory / "model.safetensors"))
    cfg = {"backend": "generic", "head": head, "fusion_dim": 16, "class_names": TASKS,
           "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5], "max_text_length": max_len,
           "encoder_dir": encoder_dir}
    if head == "mtl":
        cfg.update(head_hidden_dim=8, learnable_task_weights=True)
    (directory / "inference_config.json").write_text(json.dumps(cfg))
    return sd


@pytest.fixture(scope="module")
def distil_dir(vtde, tmp_path_factory):
    """An encoder directory of a DistilBERT + ViT dual encoder (mean-pooled
    text): the ``vtde`` fixture's tokenizer and preprocessor files with a
    DistilBERT ``text_config``."""
    import shutil

    _, src = vtde
    d = tmp_path_factory.mktemp("distil")
    for name in os.listdir(src):
        if name.startswith(("tokenizer", "vocab", "special", "preprocessor")):
            shutil.copy(os.path.join(src, name), d / name)
    (d / "config.json").write_text(json.dumps(_hf("distilbert")))
    return str(d)


@pytest.fixture(scope="module", params=["fusion", "mtl"])
def generic_checkpoint(request, distil_dir, tmp_path_factory):
    """A JAX generic model (DistilBERT + ViT, random weights), exported in
    the reference format (``backbone.`` + the VTDE names + the head) beside
    its inference_config.json."""
    enc = distil_dir
    head = request.param
    d = tmp_path_factory.mktemp(f"generic_{head}")
    jcfg = j_configs_from(enc)
    if head == "fusion":
        jmodel = JFusion.create("generic", num_labels=N, fusion_dim=16, generic_config=jcfg)
    else:
        jmodel = JMTL.create("generic", num_tasks=N, fusion_dim=16, head_hidden_dim=8,
                             learnable_task_weights=True, generic_config=jcfg)
    jparams = jmodel.init(jax.random.key(21))
    sd = _write_reference_checkpoint(d, jmodel, jparams, head, enc)
    return head, str(d), sd, enc


def test_reference_checkpoint_converts_and_loads_as_jax(generic_checkpoint):
    head, ckpt, sd, enc = generic_checkpoint
    assert all(k.startswith("backbone.") for k in sd if "text_model" in k or "vision_model" in k)
    jcfg, tcfg = j_configs_from(enc), model_io.load_encoder_config(enc, "generic")
    if head == "fusion":
        want = j_fusion_from_torch(sd, "generic", generic_cfg=jcfg)
        got = fusion_model_from_torch(sd, "generic", generic_cfg=tcfg)
    else:
        want = j_mtl_from_torch(sd, "generic", N, generic_cfg=jcfg)
        got = mtl_model_from_torch(sd, "generic", N, generic_cfg=tcfg)
    want, got = flatten(jax.tree_util.tree_map(np.asarray, want)), flatten(got)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    model, cfg = model_io.load_checkpoint(ckpt, device="cpu")
    assert model.backend == "generic" and isinstance(
        model, FusionModel if head == "fusion" else MultiTaskModel)
    assert set(model.state_dict()) == {f"{k}" for k in got}


@pytest.mark.parametrize("engine", ["standard", "fast"])
def test_evaluate_cli_matches_jax_with_buckets_off(generic_checkpoint, data_dir, tmp_path,
                                                   engine, capsys):
    from multimodal_content_moderation_tpu.cli import evaluate as j_eval
    from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

    head, ckpt, _, _ = generic_checkpoint
    common = ["--checkpoint", ckpt, "--test_csv", f"{data_dir}/test.csv",
              "--image_root", f"{data_dir}/images", "--batch_size", "8", "--engine", engine]
    want = j_eval.main(common + ["--device", "cpu", "--seq_buckets", "off",
                                 "--output", str(tmp_path / "jax.json")])
    for buckets in ("auto", "6,8"):
        capsys.readouterr()
        got = t_eval.main(common + ["--device", "cpu", "--attention", "pallas",
                                    "--seq_buckets", buckets,
                                    "--output", str(tmp_path / "torch.json")])
        said = capsys.readouterr().out
        assert ("seq_buckets=6,8 ignored" in said) == (buckets == "6,8")
        assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-6)
        assert got["roc_auc_macro"] == pytest.approx(want["roc_auc_macro"], abs=1e-4)
        for name in TASKS:
            assert got["per_class"][name]["roc_auc"] == pytest.approx(
                want["per_class"][name]["roc_auc"], abs=1e-4)


def _probs(results, key="predictions"):
    return np.asarray([[r[key][t] if key == "probabilities" else r[key][t]["probability"]
                        for t in TASKS] for r in results])


def test_classifier_and_handler_match_jax_with_buckets_off(generic_checkpoint, images,
                                                           monkeypatch):
    """The port's classifier and handler never bucket a generic model; the
    JAX classifier does (its default "auto" ladder) and shifts the logits:
    the port is held to JAX's buckets-off answers."""
    from multimodal_content_moderation_tpu.cli import inference as j_inf
    from multimodal_content_moderation_tpu.serving import handler as j_handler
    from multimodal_content_moderation_tpu_torch.cli import inference as t_inf
    from multimodal_content_moderation_tpu_torch.serving import handler as t_handler

    head, ckpt, _, _ = generic_checkpoint
    root, paths = images
    kw = dict(batch_size=4, engine="fast", attention="pallas")
    want = _probs(j_inf.MultiModalClassifier(ckpt, seq_buckets="off", **kw).predict_batch(
        TEXTS, paths, image_root=root))
    for buckets in ("auto", "6,8"):
        clf = t_inf.MultiModalClassifier(ckpt, device="cpu", seq_buckets=buckets, **kw)
        assert clf._bucket_ladder is None
        got = _probs(clf.predict_batch(TEXTS, paths, image_root=root))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # JAX's own ladder for the generic backend (the fault the port avoids)
    jax_auto = _probs(j_inf.MultiModalClassifier(ckpt, seq_buckets="6,8", **kw).predict_batch(
        TEXTS, paths, image_root=root))
    assert np.abs(jax_auto - want).max() > 1e-4

    with open(os.path.join(root, paths[0]), "rb") as f:
        image = base64.b64encode(f.read()).decode()
    insts = [{"text": "hate hate hate", "image": image}, {"text": "love"}, {"image": image}]
    monkeypatch.setenv("MMHARM_ENGINE", "fast")
    monkeypatch.setenv("MMHARM_ATTENTION", "pallas")
    monkeypatch.setenv("MMHARM_PREWARM", "0")
    t_out = t_handler.predict_fn(insts, t_handler.model_fn(ckpt, device="cpu"))
    monkeypatch.setenv("MMHARM_SEQ_BUCKETS", "off")
    j_out = j_handler.predict_fn(insts, j_handler.model_fn(ckpt))
    assert all(set(r["probabilities"]) == set(TASKS) for r in t_out)
    np.testing.assert_allclose(_probs(t_out, "probabilities"), _probs(j_out, "probabilities"),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------- train CLI


@pytest.mark.parametrize("head,wire", [("fusion", "u8"), ("mtl", "f32")])
def test_train_cli_auto_on_a_vtde_dir(vtde, data_dir, tmp_path, head, wire, caplog):
    """``backend: auto`` on a ``VisionTextDualEncoderModel`` directory trains
    the generic model (its towers from the directory's weights, the u8 wire
    with the kernels as an override), ignores ``text_fit`` with a warning,
    and its run directory loads through ``load_checkpoint`` and scores in
    ``MultiModalClassifier``."""
    import yaml

    from multimodal_content_moderation_tpu_torch.cli import inference as t_inf
    from multimodal_content_moderation_tpu_torch.cli import train as t_train

    model, enc = vtde
    cfg = {
        "model": {"backend": "auto", "head": head, "encoder_dir": enc, "fusion_dim": 16,
                  "max_text_length": 12, "head_hidden_dim": 8 if head == "mtl" else 0},
        "data": {"train_csv": f"{data_dir}/train.csv", "val_csv": f"{data_dir}/val.csv",
                 "image_root": f"{data_dir}/images",
                 "class_names": TASKS},
        "training": {"per_device_train_batch_size": 8, "per_device_eval_batch_size": 8,
                     "num_train_epochs": 1, "max_steps": 2, "num_workers": 2, "wire": wire,
                     "attention": "pallas" if wire == "u8" else "xla", "text_fit": "auto",
                     "gradient_checkpointing": True},
        "early_stopping": {"enabled": False},
        "seed": 0,
    }
    path = tmp_path / "generic.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = str(tmp_path / "run")
    with caplog.at_level("WARNING"):
        result = t_train.main(["--config", str(path), "--saving.output_dir", out,
                               "--device", "cpu"])
    assert "text_fit ignored" in caplog.text
    with open(os.path.join(out, "inference_config.json")) as f:
        icfg = json.load(f)
    assert icfg["backend"] == "generic" and icfg["head"] == head
    assert result["result"]["global_step"] == 2
    loaded, _ = model_io.load_checkpoint(result["result"]["best_checkpoint"], device="cpu")
    assert loaded.backend == "generic" and loaded.generic_config.projection_dim == 24
    assert isinstance(loaded, FusionModel if head == "fusion" else MultiTaskModel)
    clf = t_inf.MultiModalClassifier(result["result"]["best_checkpoint"], batch_size=4,
                                     device="cpu")
    r = clf.predict("hate hate hate", None)
    assert set(r["predictions"]) == set(TASKS)
