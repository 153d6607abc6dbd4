"""The pixel path and the f32 training wire of the port against the JAX
package, on tiny CLIP and SigLIP fusion models (two-layer towers of width
32; CLIP 32-pixel images in 16-pixel patches, SigLIP 32-pixel images in
8-pixel patches) fed the same normalised fp32 NCHW pixels, made from seeded
numpy uint8 crops with ``normalize_crop``.

- ``patchify``: exact (a reshape and a transpose);
- fusion logits on ``pixel_values``, both attention cores: fp32 atol 1e-5
  (two layers of the same fp32 math in another summation order), bf16 atol
  3e-2 (bf16 rounding between ops);
- leafwise gradients of the loss (fp32, dropout off): atol 2e-5 + rtol
  1e-4, as on the u8 wire (``tests/test_torch_training.py``);
- one train step (``make_train_step``, the Trainer's step, dropout off)
  against JAX's ``value_and_grad`` + ``build_optimizer`` update: the loss
  atol 1e-6, every parameter after the step atol 5e-5 where Adam's first
  step is well conditioned, else within ``lr`` (``assert_adam_step_matches``,
  which counts those elements);
- ``Trainer`` on the f32 wire end to end: its standard-engine eval logits
  equal JAX ``FusionModel.apply`` on the trained parameters (fp32 atol
  1e-5);
- the f32 and u8 wires on the same crops and the same dropout draw: the
  losses agree (fp32 atol 1e-5: the u8 wire folds the normalisation into
  the embed weight, the f32 wire normalises then embeds);
- ``attention: pallas`` past 256 positions refuses to train, naming
  ``flash_attention``; JAX fails there too (its ``pallas_call`` JVP rule
  raises before any gradient is computed)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models import clip as jclip
from multimodal_content_moderation_tpu.models import siglip as jsig
from multimodal_content_moderation_tpu.models.convert import to_dtype as j_to_dtype
from multimodal_content_moderation_tpu.ops import layers as jl
from multimodal_content_moderation_tpu.ops.pallas_image import extract_patches_u8
from multimodal_content_moderation_tpu.training.optim import build_optimizer
from multimodal_content_moderation_tpu_torch.data.images import normalize_crop
from multimodal_content_moderation_tpu_torch.models import clip as tclip
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models import siglip as tsig
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.ops import layers as tl
from multimodal_content_moderation_tpu_torch.training.loop import (
    TrainArgs,
    Trainer,
    evaluate_logits_standard,
    make_train_step,
)
from multimodal_content_moderation_tpu_torch.training.metrics import make_compute_metrics_multi
from multimodal_content_moderation_tpu_torch.training.optim import AdamW

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STATS = {"clip": ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
         "siglip": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))}
PATCH = {"clip": 16, "siglip": 8}
T_TEXT = 12
PW = np.array([1.0, 2.5, 0.5], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(backend, **tower):
    if backend == "clip":
        text = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, max_positions=T_TEXT, eos_token_id=63, **tower)
        vision = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                      image_size=32, patch_size=16, **tower)
        return (jclip.CLIPConfig(text=jclip.CLIPTextConfig(**text),
                                 vision=jclip.CLIPVisionConfig(**vision), projection_dim=32),
                tclip.CLIPConfig(text=tclip.CLIPTextConfig(**text),
                                 vision=tclip.CLIPVisionConfig(**vision), projection_dim=32))
    text = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                max_positions=T_TEXT, projection_size=32, **tower)
    vision = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                  image_size=32, patch_size=8, **tower)
    return (jsig.SigLIPConfig(text=jsig.SigLIPTextConfig(**text),
                              vision=jsig.SigLIPVisionConfig(**vision)),
            tsig.SigLIPConfig(text=tsig.SigLIPTextConfig(**text),
                              vision=tsig.SigLIPVisionConfig(**vision)))


def _kw(backend, cfg):
    return {"clip_config" if backend == "clip" else "siglip_config": cfg}


def _pair(backend, seed=0, **tower):
    """The same tiny model in both packages (JAX init, bridged weights)."""
    jcfg, tcfg = _configs(backend, **tower)
    jmodel = JFusion.create(backend, num_labels=3, fusion_dim=16, **_kw(backend, jcfg))
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = FusionModel.create(backend, num_labels=3, fusion_dim=16, device="cpu",
                                **_kw(backend, tcfg))
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _crops_and_text(backend, B, seed):
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
    tp[1 % B] = 0.0
    ip[2 % B] = 0.0
    labels = (g.random((B, 3)) < 0.4).astype(np.float32)
    return crops, {"input_ids": ids, "attention_mask": mask, "text_present": tp,
                   "image_present": ip, "labels": labels}


def _pixels(backend, crops):
    mean, std = STATS[backend]
    return np.stack([normalize_crop(c, mean, std) for c in crops])


def _batch(backend, B=4, seed=0):
    crops, b = _crops_and_text(backend, B, seed)
    return {**b, "pixel_values": _pixels(backend, crops)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jwith(jmodel, backend, **kw):
    field = "clip_config" if backend == "clip" else "siglip_config"
    c = getattr(jmodel, field)
    return dataclasses.replace(jmodel, **{field: dataclasses.replace(
        c, text=dataclasses.replace(c.text, **kw), vision=dataclasses.replace(c.vision, **kw))})


@pytest.mark.parametrize("shape,p", [((2, 3, 32, 32), 16), ((1, 3, 24, 40), 8), ((2, 1, 6, 6), 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patchify_matches_jax(shape, p, dtype):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jl.patchify(jnp.asarray(x, dtype), p)).astype(np.float32)
    got = tl.patchify(torch.from_numpy(x).to(getattr(torch, dtype)), p)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_pixel_path_logits_match_jax(backend, impl, dtype):
    jmodel, jparams, tmodel = _pair(backend)
    batch = _batch(backend)
    jm = _jwith(jmodel, backend, compute_dtype=dtype, attention_impl=impl)
    jp = jparams if dtype == "float32" else j_to_dtype(jparams, jnp.bfloat16)
    want = np.asarray(jm.apply(jp, batch)["logits"]).astype(np.float32)
    tm = model_io.with_performance_options(
        tmodel, compute_dtype=dtype, attention_impl=impl).to(getattr(torch, dtype))
    with torch.inference_mode():
        got = tm(_tb(batch))["logits"]
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


def _port_grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = model(_tb(batch), pos_weight=torch.from_numpy(PW))["loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_pixel_path_grads_match_jax(backend, impl):
    jmodel, jparams, tmodel = _pair(backend, seed=1, attention_impl=impl)
    batch = _batch(backend, seed=1)
    loss, grads = _port_grads(tmodel, batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, batch, pos_weight=jnp.asarray(PW))["loss"])(jparams)
    assert loss == pytest.approx(float(jloss), abs=1e-6)
    want = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name]
        if g is None:  # logit_scale / logit_bias: the loss does not reach them
            assert not np.any(w), name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4, err_msg=name)
    assert float(grads["backbone.vision_model.patch_embedding.w"].abs().max()) > 0


@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_f32_wire_train_step_matches_jax(backend):
    jmodel, jparams, tmodel = _pair(backend, seed=2)
    batch = _batch(backend, seed=2)
    kw = dict(lr_encoder=1e-3, lr_head=1e-2, weight_decay=0.02, max_grad_norm=1.0,
              total_steps=3, warmup_ratio=0.0, schedule="cosine")
    tx = build_optimizer(jparams, **kw)
    jloss, g = jax.value_and_grad(
        lambda q: jmodel.apply(q, batch, pos_weight=jnp.asarray(PW))["loss"])(jparams)
    upd, _ = tx.update(g, tx.init(jparams), jparams)
    want = flatten(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, upd)))
    step = make_train_step(tmodel, AdamW(dict(tmodel.named_parameters()), **kw), pos_weight=PW)
    assert float(step(_tb(batch))) == pytest.approx(float(jloss), abs=1e-6)
    n_loose = assert_adam_step_matches(tmodel, want, g, kw)
    assert n_loose == ILL_CONDITIONED[backend]


# elements whose first Adam step is ill-conditioned (0 < |clipped JAX
# gradient| < 100 eps) in test_f32_wire_train_step_matches_jax, of 67,316
# (CLIP) and 56,693 (SigLIP): mostly the attention key biases, whose exact
# gradient is 0 (softmax ignores a shift along the keys) and whose computed
# one is rounding noise, and the SigLIP MAP head's q and k weights. Only one
# of them is past atol 5e-5: head.cls_fc1.w[39, 14] for SigLIP (1 of that
# leaf's 1280), gradient 3.5e-8, off by 8.8e-5
ILL_CONDITIONED = {"clip": 318, "siglip": 1286}


def assert_adam_step_matches(tmodel, want, jgrads, kw, eps=1e-8):
    """Every parameter after one AdamW step against optax's (``want``, flat):
    atol 5e-5 where the JAX gradient after global-norm clipping is 0 or at
    least 100 eps. Between those, the first step ``lr m/(sqrt(v) + eps)`` is
    ill-conditioned: a gradient of 3.5e-8 that differs by 1.5e-9 between the
    packages moves the weight by 8.8e-5. There the difference is bounded by
    ``lr``, the largest step Adam's direction can take. Returns the number of
    elements held to that looser bound."""
    flat = {k: np.asarray(v, np.float64) for k, v in flatten(jgrads).items()}
    norm = np.sqrt(sum(float(np.sum(v * v)) for v in flat.values()))
    clip = min(1.0, kw["max_grad_norm"] / norm) if kw.get("max_grad_norm") else 1.0
    n_loose = 0
    for name, t in tmodel.named_parameters():
        got, w = t.detach().float().numpy(), want[name]
        ag = np.abs(flat[name]) * clip
        tight = (ag == 0) | (ag >= 100 * eps)
        np.testing.assert_allclose(got[tight], w[tight], atol=5e-5, err_msg=name)
        lr = kw["lr_encoder"] if name.startswith("backbone.") else kw["lr_head"]
        assert np.all(np.abs(got[~tight] - w[~tight]) <= lr), name
        n_loose += int(np.sum(~tight))
    return n_loose


class PixelDataset:
    """In-memory rows with the ``CSVDataset.batches`` contract, as uint8 HWC
    crops (the u8 wire) or normalised float32 CHW pixels (the f32 wire)."""

    def __init__(self, backend, n, seed, output="float_nchw"):
        self.crops, b = _crops_and_text(backend, n, seed)
        self.pixels = _pixels(backend, self.crops) if output == "float_nchw" else self.crops
        self.input_ids, self.attention_mask = b["input_ids"], b["attention_mask"]
        self.text_present, self.image_present = b["text_present"], b["image_present"]
        self.labels = b["labels"]

    def __len__(self):
        return len(self.labels)

    def batches(self, batch_size, drop_last=False, pad_to_batch=False, num_workers=0,
                indices=None):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        n = len(order)
        for s in range(0, n - batch_size + 1 if drop_last else n, batch_size):
            idx = order[s : s + batch_size]
            out = {"input_ids": self.input_ids[idx], "attention_mask": self.attention_mask[idx],
                   "pixel_values": self.pixels[idx], "text_present": self.text_present[idx],
                   "image_present": self.image_present[idx], "labels": self.labels[idx]}
            if pad_to_batch:
                pad = batch_size - len(idx)
                out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                       for k, v in out.items()}
                out["_valid"] = np.int32(len(idx))
            yield out


def _unflatten_like(flat, template):
    """{dotted path: tensor} -> the JAX tree ``template``'s structure."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in leaves]
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[n].detach().float().numpy()) for n in names])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_trainer_on_the_f32_wire(backend, impl, tmp_path):
    """One epoch of the Trainer on float pixels (the patch size is never
    asked for), evaluated by the standard engine: its logits are JAX's
    ``apply`` on the trained parameters."""
    jmodel, jparams, tmodel = _pair(backend, seed=3, attention_impl=impl)
    train, val = PixelDataset(backend, 8, 4), PixelDataset(backend, 7, 5)
    args = TrainArgs(output_dir=str(tmp_path), num_train_epochs=1,
                     per_device_train_batch_size=4, per_device_eval_batch_size=3,
                     gradient_accumulation_steps=2, lr_encoder=1e-3, lr_head=1e-2,
                     logging_steps=1, early_stopping=False, wire="f32", num_workers=1, seed=3)
    trainer = Trainer(tmodel, args, train, val, make_compute_metrics_multi(3), device="cpu")
    assert trainer.patch_size is None and trainer.eval_logits is evaluate_logits_standard
    result = trainer.train()
    assert result["global_step"] == 2 and trainer.optimizer.count == 1
    assert np.isfinite(result["history"][0]["loss"])
    logits, labels = trainer.predict(val)
    np.testing.assert_array_equal(labels, val.labels)
    trained = _unflatten_like(dict(trainer.model.named_parameters()), jparams)
    batch = {k: v for k, v in next(val.batches(7)).items() if k != "labels"}
    want = np.asarray(_jwith(jmodel, backend, attention_impl=impl).apply(trained, batch)["logits"])
    np.testing.assert_allclose(logits, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["clip", "siglip"])
def test_f32_and_u8_wires_agree_on_one_draw(backend):
    """The same crops as normalised pixels and as uint8 patch rows, the same
    dropout draw (one seeded generator each): the training losses agree."""
    _, _, tmodel = _pair(backend, seed=6)
    mean, std = STATS[backend]
    tmodel = tmodel.replace(image_mean=mean, image_std=std)
    crops, b = _crops_and_text(backend, 4, 6)
    losses = []
    for wire in ("f32", "u8"):
        image = ({"pixel_values": _pixels(backend, crops)} if wire == "f32"
                 else {"patches_u8": extract_patches_u8(crops, PATCH[backend])})
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            losses.append(float(tmodel(_tb({**b, **image}), generator=gen)["loss"]))
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)


def test_trainer_refuses_to_train_through_flash_attention(tmp_path):
    """SigLIP at 17 x 17 patches (T = 289) with attention 'pallas' would
    differentiate flash_attention, which has no backward: the Trainer
    refuses before it starts, naming the kernel and the way out; the 'xla'
    core trains the same model."""
    _, tcfg = _configs("siglip", attention_impl="pallas")
    tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, image_size=68,
                                                                patch_size=4))
    model = FusionModel.create("siglip", num_labels=3, fusion_dim=16, device="cpu",
                               siglip_config=tcfg)
    ds = PixelDataset("siglip", 4, 0)
    args = TrainArgs(output_dir=str(tmp_path), wire="f32", num_workers=1)
    with pytest.raises(NotImplementedError, match=r"vision tower at 289 positions through "
                                                  r"flash_attention.*attention 'xla'"):
        Trainer(model, args, ds, ds, make_compute_metrics_multi(3), device="cpu")
    Trainer(model_io.with_performance_options(model, attention_impl="xla"), args, ds, ds,
            make_compute_metrics_multi(3), device="cpu")


def test_jax_fails_to_differentiate_flash_attention():
    """The JAX side of the refusal above: the same model with attention
    'pallas' takes flash_attention past 256 positions, and jax.grad through
    it fails in pallas_call's JVP rule, before any gradient exists."""
    jcfg, _ = _configs("siglip", attention_impl="pallas")
    jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, image_size=68,
                                                                patch_size=4))
    jmodel = JFusion.create("siglip", num_labels=3, fusion_dim=16, siglip_config=jcfg)
    jparams = jmodel.init(jax.random.key(0))
    _, b = _crops_and_text("siglip", 2, 0)
    batch = {**b, "pixel_values": np.zeros((2, 3, 68, 68), np.float32)}
    with pytest.raises(AssertionError) as info:
        jax.grad(lambda p: jmodel.apply(p, batch)["loss"])(jparams)
    assert any(f.name == "_pallas_call_jvp_rule" for f in info.traceback)
