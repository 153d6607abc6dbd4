"""The port's training path against the JAX package's, on a tiny CLIP fusion
model on the uint8 wire (two-layer towers, widths 32, the "pallas"
attention core: the kernels' plain versions here, interpret mode in JAX).

- leafwise gradients of the loss against ``jax.value_and_grad`` of the JAX
  ``FusionModel.apply`` (fp32, dropout off, ``patch_embedding`` included):
  atol 2e-5 + rtol 1e-4, the same fp32 math summed in another order;
- a 5-step loss trajectory, each package with its own optimizer: atol 1e-5
  on the losses, 5e-5 on the final parameters;
- ``patch_embed_u8_train``'s backward against the JAX custom VJP (fp32,
  atol 1e-3 on dW: sums of 96 products of integers up to 255, rtol 1e-5);
- ``remat`` gives the same loss and gradients (atol 1e-6);
- ``Trainer`` end to end: checkpoint pruning, resume from ``trainstate-*``,
  early stopping, ``load_best_model_at_end``, the weighted sampler and
  ``debug_nans``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_content_moderation_tpu.models import CLIPConfig as JCLIPConfig
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig as JText
from multimodal_content_moderation_tpu.models.clip import CLIPVisionConfig as JVision
from multimodal_content_moderation_tpu.ops import pallas_image as jpi
from multimodal_content_moderation_tpu.training.optim import build_optimizer
from multimodal_content_moderation_tpu_torch.models import clip as tclip
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.models.siglip import (
    SigLIPConfig,
    SigLIPTextConfig,
    SigLIPVisionConfig,
)
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci
from multimodal_content_moderation_tpu_torch.ops.layers import dropout
from multimodal_content_moderation_tpu_torch.training import checkpoints as ckpt_lib
from multimodal_content_moderation_tpu_torch.training.loop import (
    TrainArgs,
    Trainer,
    evaluate_logits,
    make_train_step,
)
from multimodal_content_moderation_tpu_torch.training.metrics import make_compute_metrics_multi
from multimodal_content_moderation_tpu_torch.training.optim import AdamW
from multimodal_content_moderation_tpu_torch.utils.profiling import assert_finite

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_positions=12, eos_token_id=63, attention_impl="pallas")
VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
              image_size=32, patch_size=16, attention_impl="pallas")
PW = np.array([1.0, 2.5, 0.5], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_model(seed=0, **tower):
    cfg = tclip.CLIPConfig(
        text=tclip.CLIPTextConfig(**{**TEXT, **tower}),
        vision=tclip.CLIPVisionConfig(**{**VISION, **tower}), projection_dim=32,
    )
    m = FusionModel.create("clip", num_labels=3, fusion_dim=16, encoder_config=cfg,
                           seed=seed, device="cpu")
    return m.replace(image_mean=MEAN, image_std=STD)


def _pair(seed=0):
    jcfg = JCLIPConfig(text=JText(**TEXT), vision=JVision(**VISION), projection_dim=32)
    jmodel = dataclasses.replace(
        JFusion.create("clip", num_labels=3, fusion_dim=16, clip_config=jcfg),
        image_mean=MEAN, image_std=STD, embed_impl="reference",
    )
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = load_jax_params(_port_model(), jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _batch(B=4, T=12, seed=0):
    g = np.random.default_rng(seed)
    ids = np.full((B, T), 63, np.int32)
    mask = np.zeros((B, T), np.int32)
    for i in range(B):
        n = 3 + (5 * i + seed) % (T - 3)  # EOS at n-1
        ids[i, : n - 1] = g.integers(1, 62, size=n - 1)
        mask[i, :n] = 1
    imgs = g.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    tp = np.ones((B,), np.float32)
    ip = np.ones((B,), np.float32)
    tp[1] = 0.0
    ip[2] = 0.0
    return {
        "input_ids": ids, "attention_mask": mask,
        "patches_u8": jpi.extract_patches_u8(imgs, 16), "text_present": tp,
        "image_present": ip, "labels": (g.random((B, 3)) < 0.4).astype(np.float32),
    }


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model, batch, pos_weight=None):
    for p in model.parameters():
        p.grad = None
    loss = model(_tb(batch), pos_weight=pos_weight)["loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def test_leafwise_grads_match_jax():
    jmodel, jparams, tmodel = _pair()
    batch = _batch()
    loss, grads = _port_grads(tmodel, batch, torch.from_numpy(PW))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, batch, pos_weight=jnp.asarray(PW))["loss"]
    )(jparams)
    assert loss == pytest.approx(float(jloss), abs=1e-6)
    want = flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name]
        if name == "backbone.logit_scale":
            assert g is None and not np.any(w)  # the loss does not reach it
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4, err_msg=name)
    pe = grads["backbone.vision_model.patch_embedding.w"]
    assert float(pe.abs().max()) > 0


def test_five_step_loss_trajectory_matches_jax():
    jmodel, jparams, tmodel = _pair(seed=1)
    batches = [_batch(seed=s) for s in range(5)]
    kw = dict(lr_encoder=1e-3, lr_head=1e-2, weight_decay=0.02, max_grad_norm=1.0,
              total_steps=5, warmup_ratio=0.2, schedule="cosine")
    tx = build_optimizer(jparams, **kw)
    state = tx.init(jparams)
    p = jparams
    want = []
    for b in batches:
        loss, g = jax.value_and_grad(
            lambda q: jmodel.apply(q, b, pos_weight=jnp.asarray(PW))["loss"]
        )(p)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        want.append(float(loss))

    opt = AdamW(dict(tmodel.named_parameters()), **kw)
    step = make_train_step(tmodel, opt, pos_weight=PW)
    got = [float(step(_tb(b))) for b in batches]
    np.testing.assert_allclose(got, want, atol=1e-5)
    final = flatten(jax.tree_util.tree_map(np.asarray, p))
    for name, t in tmodel.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), final[name], atol=5e-5, err_msg=name)


def test_patch_embed_u8_train_grads_match_jax():
    g = np.random.default_rng(3)
    x = g.integers(0, 256, size=(2, 4, 96), dtype=np.uint8)
    w = (g.normal(size=(96, 8)) * 1e-3).astype(np.float32)
    b = g.normal(size=(8,)).astype(np.float32)
    gy = g.normal(size=(2, 4, 8)).astype(np.float32)
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    out = ci.patch_embed_u8_train(torch.from_numpy(x), wt, bt, torch.float32)
    dw, db = torch.autograd.grad(out, (wt, bt), torch.from_numpy(gy))
    _, vjp = jax.vjp(
        lambda w_, b_: jpi.patch_embed_u8_train(jnp.asarray(x), w_, b_, jnp.float32, False),
        jnp.asarray(w), jnp.asarray(b),
    )
    jdw, jdb = vjp(jnp.asarray(gy))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-5)


def test_remat_gives_the_same_loss_and_grads():
    batch = _batch(seed=2)
    base = _port_model(seed=4)
    loss, grads = _port_grads(base, batch)
    remat = _port_model(seed=4, remat=True)
    loss_r, grads_r = _port_grads(remat, batch)
    assert loss_r == pytest.approx(loss, abs=1e-6)
    for name, g in grads.items():
        if g is not None:
            torch.testing.assert_close(grads_r[name], g, atol=1e-6, rtol=0)


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(4000)
    assert dropout(x, 0.2, None) is x and dropout(x, 0.0, torch.Generator()) is x
    a = dropout(x, 0.2, torch.Generator().manual_seed(0))
    b = dropout(x, 0.2, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1.25))
    assert 0.75 < float(kept.float().mean()) < 0.85


# ---------------------------------------------------------------------------
# Trainer end to end
# ---------------------------------------------------------------------------


class TinyDataset:
    """In-memory rows with the ``CSVDataset.batches`` contract."""

    def __init__(self, n, seed):
        g = np.random.default_rng(seed)
        b = _batch(B=n, seed=seed)
        self.input_ids, self.attention_mask = b["input_ids"], b["attention_mask"]
        self.images = g.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
        self.labels = b["labels"]
        self.text_present, self.image_present = b["text_present"], b["image_present"]

    def __len__(self):
        return len(self.labels)

    def batches(self, batch_size, drop_last=False, pad_to_batch=False, num_workers=0,
                indices=None):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        n = len(order)
        for s in range(0, n - batch_size + 1 if drop_last else n, batch_size):
            idx = order[s : s + batch_size]
            out = {"input_ids": self.input_ids[idx], "attention_mask": self.attention_mask[idx],
                   "pixel_values": self.images[idx], "text_present": self.text_present[idx],
                   "image_present": self.image_present[idx], "labels": self.labels[idx]}
            if pad_to_batch:
                pad = batch_size - len(idx)
                out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                       for k, v in out.items()}
                out["_valid"] = np.int32(len(idx))
            yield out


def _args(out, **kw):
    base = dict(output_dir=str(out), num_train_epochs=3, per_device_train_batch_size=4,
                per_device_eval_batch_size=5, gradient_accumulation_steps=2, lr_encoder=1e-3,
                lr_head=1e-2, logging_steps=1, save_total_limit=1, early_stopping=False,
                wire="u8", num_workers=1, seed=3)
    base.update(kw)
    return TrainArgs(**base)


def test_trainer_checkpoints_resume_and_best_at_end(tmp_path):
    train, val = TinyDataset(16, 0), TinyDataset(7, 1)
    metrics = make_compute_metrics_multi(3)
    args = _args(tmp_path / "run", save_total_limit=2)
    trainer = Trainer(_port_model(seed=5), args, train, val, metrics, device="cpu")
    result = trainer.train()
    assert result["global_step"] == 12 and len(result["history"]) == 3
    assert trainer.optimizer.count == 6
    names = sorted(os.listdir(args.output_dir))
    # save_total_limit 2 prunes the oldest, never the best so far
    ckpts = [n for n in names if n.startswith("checkpoint-")]
    assert "checkpoint-12" in ckpts and len(ckpts) == 2
    assert os.path.basename(result["best_checkpoint"]) in ckpts
    assert [n for n in names if n.startswith("trainstate-")] == ["trainstate-12"]
    for k in ("f1_macro", "f1_micro", "roc_macro", "loss", "runtime", "samples_per_second",
              "epoch", "train_loss"):
        assert k in result["history"][0]
    assert set(result) == {"history", "best_metric", "best_checkpoint", "train_runtime",
                           "train_samples_per_second", "global_step"}
    # load-best-at-end: the live parameters are the best checkpoint's
    best = ckpt_lib.load_params(result["best_checkpoint"])
    for name, t in trainer.model.state_dict().items():
        torch.testing.assert_close(t, best[name], atol=0, rtol=0)

    # resume: a fresh trainer picks up epoch 3 / step 12 and the optimizer state
    resumed = Trainer(
        _port_model(seed=99),
        dataclasses.replace(args, num_train_epochs=4, resume_from_checkpoint="auto"),
        train, val, metrics, device="cpu",
    )
    assert (resumed.start_epoch, resumed._start_step, resumed.optimizer.count) == (3, 12, 6)
    r2 = resumed.train()
    assert r2["global_step"] == 16 and len(r2["history"]) == 1


def test_resume_continues_the_same_trajectory(tmp_path):
    """Two epochs straight equal one epoch, a resume, and one more epoch."""
    train, val = TinyDataset(8, 2), TinyDataset(4, 3)
    metrics = make_compute_metrics_multi(3)
    kw = dict(num_train_epochs=2, load_best_model_at_end=False, save_total_limit=0)
    straight = Trainer(_port_model(seed=6), _args(tmp_path / "a", **kw), train, val, metrics,
                       device="cpu")
    straight.train()
    first = Trainer(_port_model(seed=6), _args(tmp_path / "b", **{**kw, "num_train_epochs": 1}),
                    train, val, metrics, device="cpu")
    first.train()
    second = Trainer(_port_model(seed=7),
                     _args(tmp_path / "b", **kw, resume_from_checkpoint="auto"),
                     train, val, metrics, device="cpu")
    second.train()
    for (name, a), b in zip(straight.model.state_dict().items(), second.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


def test_trainer_early_stopping_and_weighted_sampler(tmp_path):
    train, val = TinyDataset(12, 4), TinyDataset(4, 5)
    # a metric that never improves after the first epoch stops training
    # once `patience` epochs have passed without improvement
    args = _args(tmp_path / "run", num_train_epochs=6, early_stopping=True,
                 early_stopping_patience=2, sampler="weighted",
                 metric_for_best_model="flat")
    trainer = Trainer(_port_model(seed=8), args, train, val, lambda ev: {"flat": 0.5},
                      device="cpu")
    idx = trainer._epoch_indices(0)
    assert len(idx) == 12 and idx.min() >= 0 and idx.max() < 12
    np.testing.assert_array_equal(idx, trainer._epoch_indices(0))
    assert not np.array_equal(idx, trainer._epoch_indices(1))
    result = trainer.train()
    assert len(result["history"]) == 3
    assert result["best_checkpoint"].endswith("checkpoint-3")


def test_assert_finite_names_the_bad_tensors():
    assert_finite({"a": torch.ones(3), "ids": torch.arange(3), "b": torch.zeros(2)})
    with pytest.raises(FloatingPointError, match=r"in t: \['bad'\]"):
        assert_finite({"ok": torch.ones(2), "bad": torch.tensor([1.0, float("inf")])}, name="t")


def test_debug_nans_stops_the_step_before_the_update(tmp_path):
    """``debug_nans`` checks the loss and gradients of every step: a NaN in a
    head weight raises before the optimizer touches any parameter."""
    train, val = TinyDataset(8, 6), TinyDataset(4, 7)
    args = _args(tmp_path / "run", debug_nans=True, gradient_accumulation_steps=1)
    trainer = Trainer(_port_model(seed=9), args, train, val, make_compute_metrics_multi(3),
                      device="cpu")
    head = next(p for n, p in trainer.model.named_parameters() if not n.startswith("backbone."))
    with torch.no_grad():
        head.view(-1)[0] = float("nan")
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    with pytest.raises(FloatingPointError, match="train step"):
        trainer.train()
    assert trainer.optimizer.count == 0
    for name, p in trainer.model.named_parameters():
        torch.testing.assert_close(p.detach(), before[name], atol=0, rtol=0, equal_nan=True,
                                   msg=name)


def _tiny_siglip():
    return SigLIPConfig(
        text=SigLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                              intermediate_size=64, max_positions=12, projection_size=32),
        vision=SigLIPVisionConfig(hidden_size=32, num_layers=1, num_heads=2,
                                  intermediate_size=64, image_size=32, patch_size=16),
    )


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """Both wires and both backends train (tests/test_torch_pixel_path.py);
    a wire that does not exist is refused. ``report_to: tensorboard`` is
    ported: the Trainer opens its event file under ``logging_dir`` (its
    tags: tests/test_torch_events.py). The generic backend is ported; a
    name that is no backend is refused."""
    tb = Trainer(_port_model(), _args(tmp_path, report_to="tensorboard",
                                      logging_dir=str(tmp_path / "tb")),
                 TinyDataset(4, 0), TinyDataset(4, 0), make_compute_metrics_multi(3),
                 device="cpu")
    assert tb.writer is not None and os.path.dirname(tb.writer.path) == str(tmp_path / "tb")
    tb.writer.close()
    with pytest.raises(ValueError, match="wire"):
        Trainer(_port_model(), _args(tmp_path, wire="u16"), TinyDataset(4, 0),
                TinyDataset(4, 0), make_compute_metrics_multi(3), device="cpu")
    siglip = FusionModel.create("siglip", num_labels=3, fusion_dim=16, device="cpu",
                                encoder_config=_tiny_siglip())
    trainer = Trainer(siglip, _args(tmp_path), TinyDataset(4, 0), TinyDataset(4, 0),
                      make_compute_metrics_multi(3), device="cpu")
    assert trainer.patch_size == 16 and trainer.eval_logits is evaluate_logits
    assert model_io.resolve_backend(None, "generic") == "generic"
    with pytest.raises(ValueError, match="backend"):
        model_io.resolve_backend(None, "bert")
