"""The port's multi-task model (``models/multitask.py``) against the JAX
package's, on tiny towers: CLIP with a 32-wide text tower and a 64-wide
vision tower (32-pixel images in 16-pixel patches), SigLIP ("auto", the
shared backbone) with a 32-wide text tower projected to 48 and a 32-wide
vision tower (32-pixel images in 8-pixel patches); two layers, 2 heads,
5 tasks, ``fusion_dim`` 16. Both packages get the same weights
(``bridge.load_jax_params``) and the same inputs, made from a seed with
numpy. The towers' widths differ, so a swapped projection cannot pass.

- ``mtl_head_apply``, bare and hidden task heads, every presence
  combination: fp32 atol 1e-5; the dropout sites in JAX's order;
- ``mtl_loss`` with and without ``log_vars`` and ``pos_weight``: atol 1e-6;
- whole-model fp32 logits, both backends, on the pixel path ("xla") and on
  the u8 wire ("pallas": the kernels' plain versions here, interpret mode
  in JAX): atol 1e-5;
- gradients on every leaf, ``head.log_vars`` and every ``heads.{j}``
  included: atol 2e-5 + rtol 1e-4; one AdamW step against optax under the
  conditioning rule of ``test_torch_pixel_path.assert_adam_step_matches``;
- ``evaluate_logits_u8``: buckets on equal buckets off (atol 1e-6) and
  JAX's engine (atol 1e-5);
- ``mtl_model_from_torch`` against JAX's on the same reference state dict
  (``tower_txt.``/``tower_img.`` for CLIP, ``backbone.`` for SigLIP), and
  ``load_checkpoint`` on it and on the port's own run directory;
- ``make_compute_metrics_mtl`` against JAX's (sklearn): atol 1e-12;
- the Trainer on both wires with accumulation, resume and load-best;
- the entry points on a reference-format multi-task checkpoint that a JAX
  model exported on the ``encoder_dir`` fixture's towers: the evaluate CLI
  (f1 within 1e-6, ROC-AUC within 1e-4), ``MultiModalClassifier`` and the
  serving handler (probabilities within 1e-5, keyed by the task names)
  against the JAX package's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_content_moderation_tpu.models import CLIPConfig as JCLIPConfig
from multimodal_content_moderation_tpu.models import MultiTaskModel as JMTL
from multimodal_content_moderation_tpu.models import fast_infer as jfi
from multimodal_content_moderation_tpu.models import multitask as jmt
from multimodal_content_moderation_tpu.models import siglip as jsig
from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig as JText
from multimodal_content_moderation_tpu.models.clip import CLIPVisionConfig as JVision
from multimodal_content_moderation_tpu.models.convert import (
    mtl_model_from_torch as j_mtl_from_torch,
)
from multimodal_content_moderation_tpu.models.export import export_safetensors, mtl_model_to_torch
from multimodal_content_moderation_tpu.models.model_io import (
    load_encoder_config as j_load_encoder_config,
)
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu.training.metrics import (
    make_compute_metrics_mtl as j_metrics_mtl,
)
from multimodal_content_moderation_tpu.training.optim import build_optimizer
from multimodal_content_moderation_tpu_torch.data.images import normalize_crop
from multimodal_content_moderation_tpu_torch.models import clip as tclip
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models import multitask as tmt
from multimodal_content_moderation_tpu_torch.models import siglip as tsig
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.convert import mtl_model_from_torch
from multimodal_content_moderation_tpu_torch.models.params import (
    TOP_LEVEL,
    ParamTree,
    flatten,
    map_leaves,
)
from multimodal_content_moderation_tpu_torch.training import checkpoints as ckpt_lib
from multimodal_content_moderation_tpu_torch.training.loop import (
    TrainArgs,
    Trainer,
    make_train_step,
)
from multimodal_content_moderation_tpu_torch.training.metrics import make_compute_metrics_mtl
from multimodal_content_moderation_tpu_torch.training.optim import AdamW
from test_torch_inference import TEXTS, images  # noqa: F401  (fixture)
from test_torch_pixel_path import assert_adam_step_matches, assert_ill_conditioned_count

TASKS = ["racist", "sexist", "homophobe", "religion", "otherhate"]
N = len(TASKS)
T_TEXT = 12
STATS = {"clip": ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
         "auto": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))}
PATCH = {"clip": 16, "auto": 8}
PW = np.array([1.0, 2.5, 0.5, 1.5, 3.0], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(backend, **tower):
    """(JAX config, port config) of the tiny towers."""
    if backend == "clip":
        text = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, max_positions=T_TEXT, eos_token_id=63, **tower)
        vision = dict(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=64,
                      image_size=32, patch_size=16, **tower)
        return (JCLIPConfig(text=JText(**text), vision=JVision(**vision), projection_dim=32),
                tclip.CLIPConfig(text=tclip.CLIPTextConfig(**text),
                                 vision=tclip.CLIPVisionConfig(**vision), projection_dim=32))
    text = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                max_positions=T_TEXT, projection_size=48, **tower)
    vision = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                  image_size=32, patch_size=8, **tower)
    return (jsig.SigLIPConfig(text=jsig.SigLIPTextConfig(**text),
                              vision=jsig.SigLIPVisionConfig(**vision)),
            tsig.SigLIPConfig(text=tsig.SigLIPTextConfig(**text),
                              vision=tsig.SigLIPVisionConfig(**vision)))


def _kw(backend, cfg):
    return {"clip_config" if backend == "clip" else "siglip_config": cfg}


def _pair(backend, seed=0, hidden=8, task_weights=True, wire="f32", **tower):
    """The same tiny multi-task model in both packages: JAX's init (with
    ``log_vars`` moved off zero) bridged into the port."""
    jcfg, tcfg = _configs(backend, **tower)
    mean, std = STATS[backend]
    jmodel = JMTL.create(backend, num_tasks=N, fusion_dim=16, head_hidden_dim=hidden,
                         learnable_task_weights=task_weights, **_kw(backend, jcfg))
    jmodel = dataclasses.replace(jmodel, image_mean=mean, image_std=std, embed_impl="reference")
    jparams = jmodel.init(jax.random.key(seed))
    if task_weights:
        g = np.random.default_rng(100 + seed)
        jparams["head"]["log_vars"] = jnp.asarray(g.normal(size=N).astype(np.float32) * 0.5)
    tmodel = tmt.MultiTaskModel.create(
        backend, num_tasks=N, fusion_dim=16, head_hidden_dim=hidden,
        learnable_task_weights=task_weights, device="cpu", encoder_config=tcfg,
    ).replace(image_mean=mean, image_std=std)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _batch(backend, wire, B=4, seed=0):
    """Right-padded ids (CLIP: EOS 63 at the row's end and as padding;
    SigLIP: PAD 0), crops on the wire (uint8 patch rows, or normalised fp32
    pixels), presence both / text only / image only / both, labels."""
    g = np.random.default_rng(seed)
    ids = np.full((B, T_TEXT), 63 if backend == "clip" else 0, np.int32)
    mask = np.zeros((B, T_TEXT), np.int32)
    for i in range(B):
        n = 3 + (5 * i + seed) % (T_TEXT - 3)
        ids[i, : n - 1] = g.integers(1, 62, size=n - 1)
        if backend != "clip":
            ids[i, n - 1] = g.integers(1, 62)
        mask[i, :n] = 1
    crops = g.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    tp = np.ones((B,), np.float32)
    ip = np.ones((B,), np.float32)
    tp[2 % B] = 0.0
    ip[1 % B] = 0.0
    batch = {"input_ids": ids, "attention_mask": mask, "text_present": tp, "image_present": ip,
             "labels": (g.random((B, N)) < 0.4).astype(np.float32)}
    if wire == "u8":
        batch["patches_u8"] = extract_patches_u8(crops, PATCH[backend])
    else:
        mean, std = STATS[backend]
        batch["pixel_values"] = np.stack([normalize_crop(c, mean, std) for c in crops])
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with_impl(jmodel, tmodel, impl):
    """Both models with the attention core ``impl`` in both towers."""
    field = "clip_config" if jmodel.backend == "clip" else "siglip_config"
    c = getattr(jmodel, field)
    jm = dataclasses.replace(jmodel, **{field: dataclasses.replace(
        c, text=dataclasses.replace(c.text, attention_impl=impl),
        vision=dataclasses.replace(c.vision, attention_impl=impl))})
    return jm, model_io.with_performance_options(tmodel, attention_impl=impl)


IMPL = {"f32": "xla", "u8": "pallas"}  # as the config ships it; the kernels' override


# ---------------------------------------------------------------- head + loss


def _head_pair(hidden, seed):
    jp = jmt.mtl_head_init(jax.random.key(seed), 32, 48, N, 16, hidden, True)
    return jp, ParamTree(map_leaves(lambda x: torch.from_numpy(np.array(x)), jp))


@pytest.mark.parametrize("hidden", [0, 8])
def test_mtl_head_matches_jax(hidden):
    jp, tp_ = _head_pair(hidden, seed=hidden)
    g = np.random.default_rng(hidden)
    B = 6
    t = g.normal(size=(B, 32)).astype(np.float32) * 3
    v = g.normal(size=(B, 48)).astype(np.float32) * 3
    # both, text only, image only, neither, both, both
    tpres = np.array([1, 1, 0, 0, 1, 1], np.float32)
    ipres = np.array([1, 0, 1, 0, 1, 1], np.float32)
    want = np.asarray(jmt.mtl_head_apply(jp, t, v, tpres, ipres))
    with torch.inference_mode():
        got = tmt.mtl_head_apply(tp_, *(torch.from_numpy(a) for a in (t, v, tpres, ipres)))
    assert got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # no L2 normalisation: scaling the features changes the logits
    with torch.inference_mode():
        scaled = tmt.mtl_head_apply(
            tp_, *(torch.from_numpy(a) for a in (2 * t, 2 * v, tpres, ipres)))
    assert not np.allclose(scaled.numpy(), got.numpy(), atol=1e-3)


def test_mtl_head_dropout_sites_in_jax_order(monkeypatch):
    """Trunk, trunk, then each hidden task head, in task order (JAX
    ``mtl_head_apply``'s ``rngs[0]``, ``rngs[1]``, ``rngs[2 + j]``), all from
    the one generator."""
    _, tp_ = _head_pair(8, seed=3)
    calls = []
    real = tmt.dropout

    def spy(x, rate, generator):
        calls.append((rate, tuple(x.shape), generator))
        return real(x, rate, generator)

    monkeypatch.setattr(tmt, "dropout", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(2, 32), torch.ones(2, 48), torch.ones(2), torch.ones(2)
    a = tmt.mtl_head_apply(tp_, *x, generator=gen)
    assert [(r, s) for r, s, _ in calls] == [(0.2, (2, 16))] * 2 + [(0.1, (2, 8))] * N
    assert all(c[2] is gen for c in calls)
    b = tmt.mtl_head_apply(tp_, *x, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, tmt.mtl_head_apply(tp_, *x))  # dropout was active


@pytest.mark.parametrize("task_weights", [False, True])
@pytest.mark.parametrize("pos_weight", [False, True])
def test_mtl_loss_matches_jax(pos_weight, task_weights):
    g = np.random.default_rng(7)
    logits = (g.normal(size=(8, N)) * 2).astype(np.float32)
    labels = (g.random((8, N)) < 0.4).astype(np.float32)
    lv = (g.normal(size=N) * 0.7).astype(np.float32) if task_weights else None
    pw = PW if pos_weight else None
    want = float(jmt.mtl_loss(jnp.asarray(logits), jnp.asarray(labels),
                              pos_weight=None if pw is None else jnp.asarray(pw),
                              log_vars=None if lv is None else jnp.asarray(lv)))
    got = float(tmt.mtl_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             pos_weight=None if pw is None else torch.from_numpy(pw),
                             log_vars=None if lv is None else torch.from_numpy(lv)))
    assert got == pytest.approx(want, abs=1e-6)


# ---------------------------------------------------------------- whole model


@pytest.mark.parametrize("wire", ["f32", "u8"])
@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_mtl_logits_match_jax(backend, wire):
    jmodel, jparams, tmodel = _pair(backend, seed=1)
    jm, tm = _with_impl(jmodel, tmodel, IMPL[wire])
    batch = _batch(backend, wire, seed=1)
    jout = jm.apply(jparams, batch, pos_weight=jnp.asarray(PW))
    with torch.inference_mode():
        out = tm(_tb(batch), pos_weight=torch.from_numpy(PW))
    assert out["logits"].shape == (4, N)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=1e-5, rtol=0)
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), abs=1e-6)


def test_clip_towers_are_bare_and_auto_shares_one_backbone():
    _, _, clip = _pair("clip")
    assert not any(k in clip.backbone for k in TOP_LEVEL)
    assert set(clip.backbone.state_dict()) == set(
        flatten(jax.tree_util.tree_map(np.asarray, JMTL.create(
            "clip", num_tasks=N, fusion_dim=16, clip_config=_configs("clip")[0],
        ).init(jax.random.key(0))["backbone"])))
    _, _, auto = _pair("auto")
    # the head projects each tower's own width: (text, image) = CLIP (32, 64), SigLIP (48, 32)
    assert clip.head["proj_t"]["w"].shape[0] == 32 and clip.head["proj_i"]["w"].shape[0] == 64
    assert auto.head["proj_t"]["w"].shape[0] == 48 and auto.head["proj_i"]["w"].shape[0] == 32
    assert "map_head" in auto.backbone["vision_model"] and "head" in auto.backbone["text_model"]
    assert "log_vars" in auto.head and len(auto.head["heads"]) == N


@pytest.mark.parametrize("wire", ["f32", "u8"])
@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_mtl_grads_match_jax(backend, wire):
    jmodel, jparams, tmodel = _pair(backend, seed=2)
    jm, tm = _with_impl(jmodel, tmodel, IMPL[wire])
    batch = _batch(backend, wire, seed=2)
    for p in tm.parameters():
        p.grad = None
    loss = tm(_tb(batch), pos_weight=torch.from_numpy(PW))["loss"]
    loss.backward()
    loss = float(loss.detach())
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, batch, pos_weight=jnp.asarray(PW))["loss"])(jparams)
    assert loss == pytest.approx(float(jloss), abs=1e-6)
    want = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(want) == set(grads)
    assert {"head.log_vars", f"head.heads.{N - 1}.fc2.w"} <= set(grads)
    for name, w in want.items():
        g = grads[name]
        if g is None:  # SigLIP's logit_scale / logit_bias: the loss does not reach them
            assert not np.any(w), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4, err_msg=name)
    assert float(grads["head.log_vars"].abs().min()) > 0


# elements of test_mtl_train_step_matches_jax held to the looser bound of
# assert_adam_step_matches (0 < |clipped JAX gradient| < 100 eps), of
# 123,482 (CLIP) and 56,940 (SigLIP), as one x86 CPU counted them: the
# towers' small gradients and the MAP head's q and k weights; none of them
# is past atol 5e-5 today. Another CPU read 2047 and 2485: a ceiling
# (assert_ill_conditioned_count), not a pin
ILL_CONDITIONED = {"clip": 2044, "auto": 2482}


@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_mtl_train_step_matches_jax(backend):
    jmodel, jparams, tmodel = _pair(backend, seed=3)
    batch = _batch(backend, "f32", seed=3)
    kw = dict(lr_encoder=1e-3, lr_head=1e-2, weight_decay=0.02, max_grad_norm=1.0,
              total_steps=3, warmup_ratio=0.0, schedule="cosine")
    tx = build_optimizer(jparams, **kw)
    jloss, g = jax.value_and_grad(
        lambda q: jmodel.apply(q, batch, pos_weight=jnp.asarray(PW))["loss"])(jparams)
    upd, _ = tx.update(g, tx.init(jparams), jparams)
    want = flatten(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, upd)))
    opt = AdamW(dict(tmodel.named_parameters()), **kw)
    assert opt.labels["head.log_vars"] == "head"  # lr_head, with weight decay
    step = make_train_step(tmodel, opt, pos_weight=PW)
    assert float(step(_tb(batch))) == pytest.approx(float(jloss), abs=1e-6)
    n_loose = assert_adam_step_matches(tmodel, want, g, kw)
    assert_ill_conditioned_count(n_loose, ILL_CONDITIONED[backend], tmodel)


# ---------------------------------------------------------------- engine


class _Rows:
    """Seeded uint8 32x32 crops and right-padded ids with the
    ``CSVDataset.batches`` contract that both packages' engines read."""

    def __init__(self, backend, n, seed):
        g = np.random.default_rng(seed)
        self.input_ids = np.full((n, T_TEXT), 63 if backend == "clip" else 0, np.int32)
        self.attention_mask = np.zeros((n, T_TEXT), np.int32)
        for i, k in enumerate(g.integers(2, T_TEXT + 1, size=n)):
            self.input_ids[i, :k] = g.integers(1, 62, size=k)
            if backend == "clip":
                self.input_ids[i, k - 1] = 63
            self.attention_mask[i, :k] = 1
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


@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_mtl_evaluate_logits_u8_buckets_match_jax(backend):
    jmodel, jparams, tmodel = _pair(backend, seed=4)
    jm, tm = _with_impl(jmodel, tmodel, "pallas")
    rows = _Rows(backend, 13, seed=4)  # a padded last batch of 5
    mean, std = STATS[backend]
    jeng = jfi.FastInferenceEngine(jm, jparams, mean, std, use_pallas=False)
    want, wlabels = jfi.evaluate_logits_u8(jeng, rows, 8, num_workers=0)
    teng = tfi.FastInferenceEngine(tm, mean, std)
    got = {b: tfi.evaluate_logits_u8(teng, rows, 8, num_workers=0, seq_buckets=b)
           for b in (None, (6, 8))}
    np.testing.assert_allclose(got[None][0], want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[None][1], wlabels)
    np.testing.assert_allclose(got[(6, 8)][0], got[None][0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[(6, 8)][1], got[None][1])


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("hidden,task_weights", [(0, False), (8, True)])
@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_mtl_model_from_torch_matches_jax(backend, hidden, task_weights):
    jmodel, jparams, _ = _pair(backend, seed=5, hidden=hidden, task_weights=task_weights)
    sd = mtl_model_to_torch(jparams, jmodel)
    towers = ("tower_txt.", "tower_img.") if backend == "clip" else ("backbone.",)
    assert all(k.startswith(towers) or not k.startswith(("backbone.", "tower_")) for k in sd)
    assert any(k.startswith(towers[-1]) for k in sd)
    assert ("heads.0.weight" in sd) == (hidden == 0) and ("log_vars" in sd) == task_weights
    _, tcfg = _configs(backend)
    jcfg, _ = _configs(backend)
    cfg_kw = "clip_cfg" if backend == "clip" else "siglip_cfg"
    want = flatten(jax.tree_util.tree_map(
        np.asarray, j_mtl_from_torch(sd, backend, N, **{cfg_kw: jcfg})))
    got = flatten(mtl_model_from_torch(sd, backend, N, encoder_cfg=tcfg))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def _write_reference_checkpoint(directory, jmodel, jparams, backend, hidden, task_weights):
    """A reference-format multi-task run: model.safetensors in the reference
    ``MultiTaskClassifier`` layout and its inference_config.json."""
    from safetensors.numpy import save_file

    os.makedirs(directory, exist_ok=True)
    sd = {k: np.ascontiguousarray(v) for k, v in mtl_model_to_torch(jparams, jmodel).items()}
    save_file(sd, os.path.join(directory, "model.safetensors"))
    with open(os.path.join(directory, "inference_config.json"), "w") as f:
        json.dump({"backend": "clip" if backend == "clip" else "siglip", "head": "mtl",
                   "fusion_dim": 16, "class_names": TASKS, "head_hidden_dim": hidden,
                   "learnable_task_weights": task_weights, "max_text_length": T_TEXT}, f)


def _write_encoder_config(directory, backend):
    """config.json of the tiny towers, as the checkpoint's encoder config."""
    if backend == "clip":
        cfg = {"model_type": "clip", "projection_dim": 32,
               "text_config": {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
                               "num_attention_heads": 2, "intermediate_size": 64,
                               "max_position_embeddings": T_TEXT, "eos_token_id": 63},
               "vision_config": {"hidden_size": 64, "num_hidden_layers": 2,
                                 "num_attention_heads": 2, "intermediate_size": 64,
                                 "image_size": 32, "patch_size": 16}}
    else:
        cfg = {"model_type": "siglip",
               "text_config": {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
                               "num_attention_heads": 2, "intermediate_size": 64,
                               "max_position_embeddings": T_TEXT, "projection_size": 48},
               "vision_config": {"hidden_size": 32, "num_hidden_layers": 2,
                                 "num_attention_heads": 2, "intermediate_size": 64,
                                 "image_size": 32, "patch_size": 8}}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.mark.parametrize("backend", ["clip", "auto"])
def test_load_checkpoint_reference_and_torch_formats(backend, tmp_path):
    jmodel, jparams, tmodel = _pair(backend, seed=6)
    ref = str(tmp_path / "ref")
    _write_reference_checkpoint(ref, jmodel, jparams, backend, 8, True)
    _write_encoder_config(ref, backend)
    model, cfg = model_io.load_checkpoint(ref, device="cpu")
    assert isinstance(model, tmt.MultiTaskModel) and cfg["head"] == "mtl"
    assert model.backend == ("clip" if backend == "clip" else "auto")
    assert model.head_hidden_dim == 8 and model.learnable_task_weights
    batch = _batch(backend, "f32", seed=6)
    want = np.asarray(jmodel.apply(jparams, batch)["logits"])
    with torch.inference_mode():
        got = model(_tb(batch))["logits"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    # the port's own run directory ("format": "torch")
    run = tmp_path / "run"
    ckpt = ckpt_lib.save_checkpoint(str(run), tmodel, 1)
    with open(run / "inference_config.json", "w") as f:
        json.dump({"backend": "clip" if backend == "clip" else "siglip", "head": "mtl",
                   "fusion_dim": 16, "class_names": TASKS, "head_hidden_dim": 8,
                   "learnable_task_weights": True, "format": "torch",
                   "encoder_dir": ref}, f)
    own, _ = model_io.load_checkpoint(ckpt, device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(own(_tb(batch))["logits"].numpy(),
                                      tmodel(_tb(batch))["logits"].numpy())


def test_build_model_maps_backends_and_refuses_generic():
    _, tcfg = _configs("auto")
    for backend in ("siglip", "auto"):
        m = model_io.build_model("mtl", backend, TASKS, 16, encoder_config=tcfg, device="cpu",
                                 head_hidden_dim=8, learnable_task_weights=True)
        assert isinstance(m, tmt.MultiTaskModel) and m.backend == "auto"
        assert m.head["heads"][0]["fc1"]["w"].shape == (16, 8) and "log_vars" in m.head
    _, ccfg = _configs("clip")
    m = model_io.build_model("mtl", "clip", TASKS[:3], 16, encoder_config=ccfg, device="cpu")
    assert m.backend == "clip" and "fc" in m.head["heads"][2] and "log_vars" not in m.head
    # the generic backend keeps its name and pools its raw towers; a name
    # that is no backend is refused
    from multimodal_content_moderation_tpu_torch.models.generic import GenericDualConfig

    small = GenericDualConfig.from_dict({
        "text_config": {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 1,
                        "num_attention_heads": 2, "intermediate_size": 64,
                        "max_position_embeddings": 16},
        "vision_config": {"hidden_size": 48, "num_hidden_layers": 1,
                          "num_attention_heads": 2, "intermediate_size": 64,
                          "image_size": 32, "patch_size": 16},
        "projection_dim": 24})
    m = model_io.build_model("mtl", "generic", TASKS, 16, encoder_config=small, device="cpu")
    assert m.backend == "generic" and "text_projection" not in m.backbone
    assert m.head["proj_t"]["w"].shape[0] == 32 and m.head["proj_i"]["w"].shape[0] == 48
    with pytest.raises(ValueError, match="backend"):
        model_io.build_model("fusion", "bogus", TASKS, device="cpu")


def test_init_from_encoder_dir_drops_clip_projections(encoder_dir):
    cfg = model_io.load_encoder_config(encoder_dir, "clip")
    m = model_io.build_model("mtl", "clip", TASKS, 16, encoder_config=cfg, device="cpu")
    m = model_io.init_from_encoder_dir(m, encoder_dir)
    from multimodal_content_moderation_tpu_torch.models import clip, convert

    hf = clip.clip_params_from_torch(
        convert.load_safetensors(os.path.join(encoder_dir, "model.safetensors")), cfg)
    assert "text_projection" in hf and "text_projection" not in m.backbone
    torch.testing.assert_close(m.backbone["text_model"]["token_embedding"],
                               hf["text_model"]["token_embedding"], atol=0, rtol=0)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("degenerate", [False, True])
def test_compute_metrics_mtl_matches_jax(degenerate):
    g = np.random.default_rng(9)
    logits = g.normal(size=(40, N)).astype(np.float32)
    labels = (g.random((40, N)) < 0.3).astype(np.float32)
    if degenerate:
        labels[:, 3] = 0.0  # one class in a column: its ROC-AUC and the macro are 0
    want = j_metrics_mtl(TASKS, 0.4)((logits, labels))
    got = make_compute_metrics_mtl(TASKS, 0.4)((logits, labels))
    assert set(got) == set(want) and {f"roc_{t}" for t in TASKS} <= set(got)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-12), k
    assert (got["roc_religion"] == 0.0) == degenerate


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_trainer_mtl_accumulates_resumes_and_loads_best(wire, tmp_path):
    _, _, tmodel = _pair("clip", seed=7)
    tm = model_io.with_performance_options(tmodel, attention_impl=IMPL[wire])
    rows = _Rows("clip", 16, seed=7)
    if wire == "f32":
        mean, std = STATS["clip"]
        rows.images = np.stack([normalize_crop(c, mean, std) for c in rows.images])
    args = TrainArgs(output_dir=str(tmp_path / "run"), num_train_epochs=3,
                     per_device_train_batch_size=4, per_device_eval_batch_size=8,
                     gradient_accumulation_steps=2, lr_encoder=1e-4, lr_head=1e-2,
                     warmup_ratio=0.0, logging_steps=1, save_total_limit=2,
                     metric_for_best_model="roc_macro", early_stopping=False, seed=0,
                     num_workers=0, wire=wire)
    lv0 = tm.head["log_vars"].detach().clone()
    trainer = Trainer(tm, args, rows, rows, make_compute_metrics_mtl(TASKS), device="cpu")
    result = trainer.train()
    assert result["global_step"] == 12 and trainer.optimizer.count == 6
    hist = result["history"]
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(f"roc_{task}" in h and f"f1_{task}" in h for h in hist for task in TASKS)
    assert not torch.equal(tm.head["log_vars"].detach(), lv0)
    best = max(range(3), key=lambda i: hist[i]["roc_macro"])  # the first of equals
    assert result["best_checkpoint"].endswith(f"checkpoint-{4 * (best + 1)}")
    # load-best-at-end: the model holds the best checkpoint's weights
    saved = ckpt_lib.load_params(result["best_checkpoint"])
    torch.testing.assert_close(tm.head["log_vars"].detach(), saved["head.log_vars"],
                               atol=0, rtol=0)

    # resume from the last train state: the optimizer state and the step count
    _, _, fresh = _pair("clip", seed=8)
    fresh = model_io.with_performance_options(fresh, attention_impl=IMPL[wire])
    resumed = Trainer(fresh, dataclasses.replace(args, resume_from_checkpoint="auto",
                                                 num_train_epochs=4),
                      rows, rows, make_compute_metrics_mtl(TASKS), device="cpu")
    assert resumed.start_epoch == 3 and resumed._start_step == 12
    assert resumed.optimizer.count == 6
    out = resumed.train()
    assert out["global_step"] == 16 and len(out["history"]) == 1


# ---------------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def mtl_checkpoint(encoder_dir, tmp_path_factory):
    """A JAX multi-task model on the ``encoder_dir`` fixture's CLIP towers
    (hidden task heads, learned task weights), exported in the reference
    format beside its inference_config.json."""
    d = tmp_path_factory.mktemp("mtl_ckpt")
    model = JMTL.create("clip", num_tasks=N, fusion_dim=16, head_hidden_dim=8,
                        learnable_task_weights=True,
                        clip_config=j_load_encoder_config(encoder_dir, "clip"))
    export_safetensors(model.init(jax.random.key(11)), model, str(d / "model.safetensors"))
    (d / "inference_config.json").write_text(json.dumps({
        "backend": "clip", "head": "mtl", "fusion_dim": 16, "head_hidden_dim": 8,
        "learnable_task_weights": True, "class_names": TASKS,
        "thresholds": [0.5, 0.45, 0.5, 0.55, 0.5], "max_text_length": 16,
        "encoder_dir": encoder_dir}))
    return str(d)


@pytest.mark.parametrize("engine", ["standard", "fast"])
def test_evaluate_cli_on_a_reference_mtl_checkpoint_matches_jax(mtl_checkpoint, data_dir,
                                                                tmp_path, engine):
    from multimodal_content_moderation_tpu.cli import evaluate as j_eval
    from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

    common = ["--checkpoint", mtl_checkpoint, "--test_csv", f"{data_dir}/test.csv",
              "--image_root", f"{data_dir}/images", "--batch_size", "8", "--engine", engine]
    want = j_eval.main(common + ["--device", "cpu", "--output", str(tmp_path / "jax.json")])
    got = t_eval.main(common + ["--device", "cpu", "--attention", "pallas",
                                "--output", str(tmp_path / "torch.json")])
    assert set(got["per_class"]) == set(TASKS)
    assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-6)
    assert got["roc_auc_macro"] == pytest.approx(want["roc_auc_macro"], abs=1e-4)
    for name in TASKS:
        assert got["per_class"][name]["roc_auc"] == pytest.approx(
            want["per_class"][name]["roc_auc"], abs=1e-4)


def test_mtl_classifier_and_endpoint_match_jax(mtl_checkpoint, images, monkeypatch):
    from multimodal_content_moderation_tpu.cli import inference as j_inf
    from multimodal_content_moderation_tpu.serving import handler as j_handler
    from multimodal_content_moderation_tpu_torch.cli import inference as t_inf
    from multimodal_content_moderation_tpu_torch.serving import handler as t_handler

    root, paths = images
    kw = dict(batch_size=4, engine="fast", attention="pallas", seq_buckets="6,8")
    got = t_inf.MultiModalClassifier(mtl_checkpoint, device="cpu", **kw).predict_batch(
        TEXTS, paths, image_root=root)
    want = j_inf.MultiModalClassifier(mtl_checkpoint, **kw).predict_batch(
        TEXTS, paths, image_root=root)

    def probs(results, key):
        return np.asarray([[r[key][t] if key == "probabilities" else
                            r[key][t]["probability"] for t in TASKS] for r in results])

    np.testing.assert_allclose(probs(got, "predictions"), probs(want, "predictions"),
                               atol=1e-5, rtol=0)

    import base64

    with open(os.path.join(root, paths[0]), "rb") as f:
        image = base64.b64encode(f.read()).decode()
    insts = [{"text": "hate hate hate", "image": image}, {"text": "love"}, {"image": image}]
    monkeypatch.setenv("MMHARM_ENGINE", "fast")
    monkeypatch.setenv("MMHARM_PREWARM", "0")
    t_out = t_handler.predict_fn(insts, t_handler.model_fn(mtl_checkpoint, device="cpu"))
    j_out = j_handler.predict_fn(insts, j_handler.model_fn(mtl_checkpoint))
    assert all(set(r["probabilities"]) == set(TASKS) for r in t_out)
    np.testing.assert_allclose(probs(t_out, "probabilities"), probs(j_out, "probabilities"),
                               atol=1e-5, rtol=0)
