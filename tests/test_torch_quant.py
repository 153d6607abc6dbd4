"""The port's int8 fc1 tier (``ops/quant.py``, ``--precision int8_mlp``)
against the JAX package's, on the CPU.

- ``quantize_linear_int8`` and ``dense_int8`` at [300, 768] x [768, 3072]:
  bit for bit, fp32 and bf16, with and without a bias; the route that pads
  at most 16 rows (the card's ``_int_mm`` takes more) bit for bit too.
- The layer selection on skeleton trees of the published widths (CLIP
  ViT-B/32: 12, SigLIP2-B/16: 24 with the MAP head skipped, ViT-B/16 +
  BERT-base: 24, + DistilBERT-base: 18, ``shape=None``: every fc1): the
  same count and the same int8 leaves as JAX's ``quantize_fc1_layers``.
- A quantized model keeps ``scale`` in fp32 and ``b`` in the cast dtype,
  takes no gradient in its int8 leaves, and leaves its source model as it
  was.
- Logits of tiny CLIP, SigLIP and generic (BERT + ViT) fusion and
  multi-task models with every encoder fc1 quantized (``shape=None``),
  weights carried across by the bridge, against JAX's on the same inputs:
  fp32 atol 1e-4, the fp32 bound of the fusion parity tests, which allows
  a rounding flip (the fp32 towers round apart in the last bit, so an
  activation may land on the other side of a step of the int8 grid; one
  step moves an fc1 output by s_x * scale, about 1e-5 here), and
  ``int8_mlp`` in bf16 atol 3e-2, the bf16 bound of
  the fusion parity tests (``tests/test_torch_clip_fusion.py``).
- The entry points at ``int8_mlp`` (the evaluate CLI, the classifier, the
  handler) against the JAX package's, on a reference-format CLIP
  checkpoint whose one vision layer is 768 wide with a 3072 MLP, so that
  the default selection quantizes it: the same count of quantized layers;
  the evaluate CLI's metrics within the bounds of
  ``tests/test_torch_cli.py``; the classifier's and the handler's
  probabilities within 1e-2 (the bf16 logits bound, 3e-2, times the
  sigmoid's slope of at most 1/4) and the same labels wherever a
  probability is clear of its threshold by more than that.
"""

import base64
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.cli import evaluate as j_eval
from multimodal_content_moderation_tpu.cli import inference as j_inf
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import MultiTaskModel as JMTL
from multimodal_content_moderation_tpu.models import model_io as j_model_io
from multimodal_content_moderation_tpu.models.convert import to_dtype as j_to_dtype
from multimodal_content_moderation_tpu.ops import quant as jq
from multimodal_content_moderation_tpu.serving import handler as jh
from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval
from multimodal_content_moderation_tpu_torch.cli import inference as t_inf
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel
from multimodal_content_moderation_tpu_torch.models.params import ParamTree
from multimodal_content_moderation_tpu_torch.ops import layers as tl
from multimodal_content_moderation_tpu_torch.ops import quant as tq
from multimodal_content_moderation_tpu_torch.serving import handler as th
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures
from test_torch_generic import _configs as generic_configs
from test_torch_inference import CLASSES, TEXTS, export_checkpoint, images  # noqa: F401
from test_torch_multitask import _configs as tower_configs

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PROB_TOL = 1e-2
N = len(CLASSES)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_torch(a) -> torch.Tensor:
    """A JAX array -> the same values as a torch tensor of its dtype."""
    dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)


def _linear(seed, K=768, N_out=3072, bias=True):
    g = np.random.default_rng(seed)
    p = {"w": (g.normal(size=(K, N_out)) * 0.02).astype(np.float32)}
    if bias:
        p["b"] = (g.normal(size=N_out) * 0.01).astype(np.float32)
    return p


# -- the product --------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_linear_int8_matches_jax_bitwise(dtype):
    jdt, _ = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jdt) for k, v in _linear(0).items()}
    want = jq.quantize_linear_int8(jp)
    got = tq.quantize_linear_int8({k: _to_torch(v) for k, v in jp.items()})
    assert got["w_i8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_i8"].numpy(), np.asarray(want["w_i8"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["b"].dtype == DTYPES[dtype][1]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_int8_matches_jax_bitwise(dtype, bias):
    jdt, tdt = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jdt) for k, v in _linear(1, bias=bias).items()}
    x = jnp.asarray(np.random.default_rng(2).normal(size=(300, 768)).astype(np.float32), jdt)
    want = np.asarray(jq.dense_int8(x, jq.quantize_linear_int8(jp)).astype(jnp.float32))
    q = tq.quantize_linear_int8({k: _to_torch(v) for k, v in jp.items()})
    got = tq.dense_int8(_to_torch(x), q)
    assert got.dtype == tdt and got.shape == (300, 3072)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the [B, T, K] form of the towers: the same rows
    got3 = tq.dense_int8(_to_torch(x).reshape(3, 100, 768), q)
    np.testing.assert_array_equal(got3.reshape(300, 3072).float().numpy(), want)


@pytest.mark.parametrize("rows", [1, 5, 16, 17])
def test_dense_int8_pads_few_rows(rows):
    """At most 16 rows go through ``_int_mm`` padded with zero rows: the
    same function, bit for bit against JAX and against the same rows inside
    a larger batch (the activation scales are per row)."""
    jp = {k: jnp.asarray(v) for k, v in _linear(3).items()}
    x = np.random.default_rng(4).normal(size=(40, 768)).astype(np.float32)
    want = np.asarray(jq.dense_int8(jnp.asarray(x[:rows]), jq.quantize_linear_int8(jp)))
    q = tq.quantize_linear_int8({k: _to_torch(v) for k, v in jp.items()})
    got = tq.dense_int8(torch.from_numpy(x[:rows]), q).numpy()
    np.testing.assert_array_equal(got, want)
    whole = tq.dense_int8(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(got, whole[:rows])


def test_dense_maybe_int8_dispatch():
    p = {k: torch.from_numpy(v) for k, v in _linear(5, K=32, N_out=48).items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 32)).astype(np.float32))
    assert torch.equal(tl.dense_maybe_int8(x, p), tl.dense(x, p))
    q = tq.quantize_linear_int8(p)
    assert torch.equal(tl.dense_maybe_int8(x, q), tq.dense_int8(x, q))


# -- the layer selection ------------------------------------------------------


def _skeleton(text_layers, text_fc1, vision_layers, map_head=False):
    """A backbone tree with the published widths' fc1 shapes (one draw per
    shape, shared by the layers) and a small fc2 stand-in."""
    g = np.random.default_rng(7)
    fc1 = {}

    def layer(shape):
        if shape not in fc1:
            fc1[shape] = {"w": (g.normal(size=shape) * 0.02).astype(np.float32),
                          "b": np.zeros(shape[1], np.float32)}
        return {"fc1": dict(fc1[shape]), "fc2": {"w": np.zeros((8, 8), np.float32)}}

    vision = {"layers": [layer((768, 3072)) for _ in range(vision_layers)]}
    if map_head:
        vision["map_head"] = layer((768, 3072))
    return {"text_model": {"layers": [layer(text_fc1) for _ in range(text_layers)]},
            "vision_model": vision}


SKELETONS = {
    # name: (text layers, text fc1, vision layers, MAP head, shape, want)
    "clip_vit_b32": (12, (512, 2048), 12, False, tq.WINNING_FC1_SHAPE, 12),
    "siglip2_b16": (12, (768, 3072), 12, True, tq.WINNING_FC1_SHAPE, 24),
    "vit_b16_bert_base": (12, (768, 3072), 12, False, tq.WINNING_FC1_SHAPE, 24),
    "vit_b16_distilbert_base": (6, (768, 3072), 12, False, tq.WINNING_FC1_SHAPE, 18),
    "clip_vit_b32_every_fc1": (12, (512, 2048), 12, False, None, 24),
}


@pytest.mark.parametrize("name", sorted(SKELETONS))
def test_fc1_selection_matches_jax(name):
    t_layers, t_fc1, v_layers, map_head, shape, want_n = SKELETONS[name]
    tree = _skeleton(t_layers, t_fc1, v_layers, map_head)
    jtree, jn = jq.quantize_fc1_layers(jax.tree_util.tree_map(jnp.asarray, tree), shape=shape)
    src = ParamTree(jax.tree_util.tree_map(torch.from_numpy, tree))
    ttree, tn = tq.quantize_fc1_tree(src, shape)
    assert tn == jn == want_n
    for tower in ("text_model", "vision_model"):
        for i, jl in enumerate(jtree[tower]["layers"]):
            tl_fc1 = ttree[tower]["layers"][i]["fc1"]
            assert ("w_i8" in tl_fc1) == ("w_i8" in jl["fc1"])
            if "w_i8" in jl["fc1"]:
                np.testing.assert_array_equal(tl_fc1["w_i8"].numpy(), np.asarray(jl["fc1"]["w_i8"]))
                np.testing.assert_array_equal(tl_fc1["scale"].numpy(), np.asarray(jl["fc1"]["scale"]))
            # the source tree keeps its float weight
            assert "w" in src[tower]["layers"][i]["fc1"]
    if map_head:
        assert "w" in ttree["vision_model"]["map_head"]["fc1"]
        assert "w" in jtree["vision_model"]["map_head"]["fc1"]


# -- quantized models ---------------------------------------------------------


def _pair(backend, head, seed=0):
    """The same tiny model in both packages (JAX's init, bridged): CLIP and
    SigLIP towers of ``tests/test_torch_multitask.py``, BERT + ViT towers of
    ``tests/test_torch_generic.py``."""
    if backend == "generic":
        jcfg, tcfg = generic_configs("bert")
    else:
        jcfg, tcfg = tower_configs("clip" if backend == "clip" else "auto")
    if backend == "siglip" and head == "fusion":
        # the fusion head takes both features at the text projection's width
        jcfg, tcfg = (dataclasses.replace(c, text=dataclasses.replace(c.text, projection_size=32))
                      for c in (jcfg, tcfg))
    field = {"clip": "clip_config", "siglip": "siglip_config",
             "generic": "generic_config"}[backend]
    if head == "fusion":
        jmodel = JFusion.create(backend, num_labels=N, fusion_dim=16, **{field: jcfg})
        tmodel = FusionModel.create(backend, num_labels=N, fusion_dim=16, device="cpu",
                                    **{field: tcfg})
    else:
        mb = "auto" if backend == "siglip" else backend
        kw = dict(num_tasks=N, fusion_dim=16, head_hidden_dim=8, learnable_task_weights=True)
        jmodel = JMTL.create(mb, **kw, **{field: jcfg})
        tmodel = MultiTaskModel.create(mb, device="cpu", **kw, **{field: tcfg})
    jparams = jmodel.init(jax.random.key(seed))
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _batch(backend, B=4, T=12, seed=0):
    """Right-padded ids (an EOS, 63, at each row's end for CLIP's pooling),
    normalised pixels, one row without text and one without an image."""
    g = np.random.default_rng(seed)
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate([1, T, 5, 9][:B]):
        ids[i, :n] = g.integers(4, 60, size=n)
        if backend == "clip":
            ids[i, n - 1] = 63
        mask[i, :n] = 1
    tp, ip = np.ones(B, np.float32), np.ones(B, np.float32)
    tp[2], ip[3] = 0.0, 0.0
    return {"input_ids": ids, "attention_mask": mask,
            "pixel_values": g.normal(size=(B, 3, 32, 32)).astype(np.float32),
            "text_present": tp, "image_present": ip}


def test_quantized_model_keeps_its_types_and_its_source():
    _, _, tmodel = _pair("siglip", "fusion")
    bf16 = model_io.with_performance_options(
        tmodel, compute_dtype="bfloat16", scores_dtype="bfloat16").to(torch.bfloat16)
    before = {k: v.clone() for k, v in bf16.state_dict().items()}
    q, n = tq.quantize_fc1_layers(bf16, shape=None)
    assert n == 4  # 2 text + 2 vision layers; never the MAP head
    fc1 = q.backbone["vision_model"]["layers"][0]["fc1"]
    assert fc1["w_i8"].dtype == torch.int8 and fc1["scale"].dtype == torch.float32
    assert fc1["b"].dtype == torch.bfloat16
    assert not fc1["w_i8"].requires_grad and not fc1["scale"].requires_grad
    assert "w" in q.backbone["vision_model"]["map_head"]["fc1"]
    # the source keeps its float fc1 and every value; the copy shares the rest
    assert "w" in bf16.backbone["vision_model"]["layers"][0]["fc1"]
    assert q.backbone["vision_model"]["layers"][0]["ln1"]["scale"] is \
        bf16.backbone["vision_model"]["layers"][0]["ln1"]["scale"]
    assert q.head is bf16.head
    assert bf16.state_dict().keys() == before.keys()
    for k, v in bf16.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a cast after the quantization would round the scales: the tier casts first
    assert q.to(torch.bfloat16).backbone["vision_model"]["layers"][0]["fc1"]["scale"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("head", ["fusion", "mtl"])
@pytest.mark.parametrize("backend", ["clip", "siglip", "generic"])
def test_int8_logits_match_jax(backend, head, dtype):
    """Every encoder fc1 in int8 (``shape=None``); in bf16 this is
    ``int8_mlp`` (bf16_fast + int8). JAX's walker takes the whole tree, and
    would reach a hidden task head's fc1, so it is given the backbone, as
    the port quantizes it."""
    jmodel, jparams, tmodel = _pair(backend, head)
    batch = _batch(backend)
    jdt, tdt = DTYPES[dtype]
    perf = ({} if dtype == "float32"
            else dict(compute_dtype="bfloat16", scores_dtype="bfloat16"))
    jm = j_model_io.with_performance_options(jmodel, **perf)
    jp = jparams if dtype == "float32" else j_to_dtype(jparams, jdt)
    jbb, jn = jq.quantize_fc1_layers(jp["backbone"], shape=None)
    want = np.asarray(jm.apply({**jp, "backbone": jbb}, batch)["logits"]).astype(np.float32)

    tm = model_io.with_performance_options(tmodel, **perf).to(tdt)
    qm, tn = tq.quantize_fc1_layers(tm, shape=None)
    assert tn == jn == 4
    with torch.inference_mode():
        got = qm({k: torch.from_numpy(v) for k, v in batch.items()})["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=LOGITS_TOL[dtype], rtol=0)


# -- the entry points ---------------------------------------------------------


@pytest.fixture(scope="module")
def wide_checkpoint(encoder_dir, tmp_path_factory):
    """A reference-format CLIP checkpoint that a JAX model exported: the
    ``encoder_dir`` fixture's text tower and tokenizer, and one vision
    layer 768 wide with a 3072 MLP (12 heads, 32-pixel images in 16-pixel
    patches), the shape the default selection quantizes."""
    enc = tmp_path_factory.mktemp("int8_enc")
    for name in ("vocab.json", "merges.txt", "preprocessor_config.json"):
        shutil.copy(f"{encoder_dir}/{name}", enc / name)
    with open(f"{encoder_dir}/config.json") as f:
        cfg = json.load(f)
    cfg["vision_config"].update(hidden_size=768, intermediate_size=3072, num_attention_heads=12)
    (enc / "config.json").write_text(json.dumps(cfg))
    return export_checkpoint(tmp_path_factory.mktemp("int8_ckpt"), "clip", str(enc))


def _assert_probs_agree(got, want, thresholds):
    """Probabilities within ``PROB_TOL``; the same label wherever the
    probability is clear of the threshold by more than that."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    clear = np.abs(want - np.asarray(thresholds)) > PROB_TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal((got >= thresholds)[clear], (want >= thresholds)[clear])


def test_evaluate_cli_at_int8_mlp_matches_jax(wide_checkpoint, data_dir, tmp_path, capsys):
    common = ["--checkpoint", wide_checkpoint, "--test_csv", f"{data_dir}/test.csv",
              "--image_root", f"{data_dir}/images", "--batch_size", "8",
              "--precision", "int8_mlp", "--engine", "fast", "--device", "cpu"]
    want = j_eval.main(common + ["--output", str(tmp_path / "jax.json")])
    jout = capsys.readouterr().out
    got = t_eval.main(common + ["--attention", "pallas", "--output", str(tmp_path / "t.json")])
    tout = capsys.readouterr().out
    line = "int8 MLP: quantized 1 fc1 layers (opt-in, eval-only)"
    assert line in jout and line in tout
    # the CSV's rows fall in two groups (the "hate" and the "love" texts)
    # whose scores lie far apart, so the bf16 rounding (about 1e-3 in a
    # probability) moves no metric: the bounds of tests/test_torch_cli.py
    assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-6)
    assert got["f1_micro"] == pytest.approx(want["f1_micro"], abs=1e-6)
    assert got["roc_auc_macro"] == pytest.approx(want["roc_auc_macro"], abs=1e-4)
    for name in CLASSES:
        g, w = got["per_class"][name], want["per_class"][name]
        assert g["support"] == w["support"]
        assert g["f1_calibrated"] == pytest.approx(w["f1_calibrated"], abs=1e-6)


def test_classifier_at_int8_mlp_matches_jax(wide_checkpoint, images):  # noqa: F811
    root, rows = images
    kw = dict(precision="int8_mlp", engine="fast", batch_size=4)
    jc = j_inf.MultiModalClassifier(wide_checkpoint, **kw)
    tc = t_inf.MultiModalClassifier(wide_checkpoint, device="cpu", attention="pallas", **kw)
    assert tc.quantized_layers == 1
    assert tc.warmup() >= 1
    want = jc.predict_batch(TEXTS, rows, image_root=root)
    got = tc.predict_batch(TEXTS, rows, image_root=root)

    def probs(results):
        return [[r["predictions"][c]["probability"] for c in CLASSES] for r in results]

    _assert_probs_agree(probs(got), probs(want), tc.thresholds)


def test_handler_at_int8_mlp_matches_jax(wide_checkpoint, monkeypatch):
    for k, v in {"MMHARM_PRECISION": "int8_mlp", "MMHARM_ENGINE": "fast",
                 "MMHARM_ATTENTION": "pallas"}.items():
        monkeypatch.setenv(k, v)
    tc = th.model_fn(wide_checkpoint, device="cpu")
    jc = jh.model_fn(wide_checkpoint)
    assert tc.quantized_layers == 1
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = [{"text": TEXTS[i % len(TEXTS)], "image": blobs[i % len(blobs)]} for i in range(9)]
    insts[4].pop("image")
    got = th.predict_fn(insts, tc)
    want = jh.predict_fn(insts, jc)
    assert [set(g) for g in got] == [set(w) for w in want]

    def probs(preds):
        return [[p["probabilities"][c] for c in CLASSES] for p in preds]

    _assert_probs_agree(probs(got), probs(want), tc.thresholds)
