"""The port's TensorBoard event writer (``utils/events.py``) and the
Trainer's ``report_to: tensorboard`` against the JAX package's.

- CRC32C on the canonical Castagnoli vectors (as tests/test_events_writer.py)
  and the TFRecord mask, equal to JAX's on the same bytes.
- With ``time.time`` and ``socket.gethostname`` pinned, the port's event
  file has JAX's name and JAX's bytes for the same scalars (multi-byte step
  varints, negative and float32-rounded values, non-ASCII tags).
- The port's Trainer (tiny CLIP fusion on the u8 wire) writes the tags the
  JAX Trainer (the same settings on its f32 wire) writes at the same steps: ``train/loss`` and
  ``train/samples_per_second`` every logging step, ``eval/<metric>`` after
  each epoch's eval; every record's CRCs hold.
"""

import dataclasses
import glob
import os
import socket
import time

import jax
import numpy as np
import pytest

from multimodal_content_moderation_tpu.models import CLIPConfig as JCLIPConfig
from multimodal_content_moderation_tpu.models import FusionModel as JFusion
from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig as JText
from multimodal_content_moderation_tpu.models.clip import CLIPVisionConfig as JVision
from multimodal_content_moderation_tpu.parallel.mesh import build_mesh
from multimodal_content_moderation_tpu.training import loop as jloop
from multimodal_content_moderation_tpu.training.metrics import (
    make_compute_metrics_multi as j_metrics,
)
from multimodal_content_moderation_tpu.utils import events as jev
from multimodal_content_moderation_tpu_torch.training.loop import Trainer
from multimodal_content_moderation_tpu_torch.training.metrics import make_compute_metrics_multi
from multimodal_content_moderation_tpu_torch.utils import events as tev
from test_torch_training import MEAN, STD, TEXT, VISION, TinyDataset, _args, _port_model


@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283), (b"", 0x0), (b"\x00" * 32, 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_vectors(data, want):
    assert tev._crc32c(data) == want == jev._crc32c(data)
    assert tev._masked_crc(data) == jev._masked_crc(data)


@pytest.fixture
def pinned(monkeypatch):
    """One wall time and one host name for both writers."""
    monkeypatch.setattr(time, "time", lambda: 1760000000.125)
    monkeypatch.setattr(socket, "gethostname", lambda: "card-host")


def _write(module, log_dir, suffix=None):
    with module.EventWriter(str(log_dir), suffix=suffix) as w:
        w.scalar("train/loss", 0.693147, 1)
        w.scalar("train/samples_per_second", 1234.5678, 300)
        w.scalar("eval/roc_macro", np.float64(0.8125), 2**40 + 3)
        w.scalar("eval/neg", -3.0e-7, 0)
        w.scalar("eval/ünïcode", 1e30, 127)
        w.scalar("eval/int", 7, 128)
        w.flush()
        return w.path


@pytest.mark.parametrize("suffix", [None, "v2"])
def test_event_file_equals_jax_byte_for_byte(tmp_path, pinned, suffix):
    got = _write(tev, tmp_path / "torch", suffix)
    want = _write(jev, tmp_path / "jax", suffix)
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.basename(got).startswith("events.out.tfevents.1760000000.card-host")
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    scalars = tev.read_scalars(got)
    assert [(t, s) for t, s, _ in scalars] == [
        ("train/loss", 1), ("train/samples_per_second", 300), ("eval/roc_macro", 2**40 + 3),
        ("eval/neg", 0), ("eval/ünïcode", 127), ("eval/int", 128)]
    assert scalars[0][2] == np.float32(0.693147)


def test_a_damaged_record_is_refused(tmp_path):
    path = _write(tev, tmp_path)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tev.read_records(path)


class _NormalisedNCHW:
    """A ``TinyDataset`` whose images go as normalised float NCHW pixels
    (the JAX trainer's f32 wire, and its eval step's input)."""

    def __init__(self, ds):
        self.ds, self.labels = ds, ds.labels

    def __len__(self):
        return len(self.ds)

    def batches(self, *args, **kw):
        for b in self.ds.batches(*args, **kw):
            x = (b["pixel_values"] / 255.0 - np.asarray(MEAN)) / np.asarray(STD)
            yield {**b, "pixel_values": x.transpose(0, 3, 1, 2).astype(np.float32)}


def _jax_trainer(out):
    text = {k: v for k, v in TEXT.items() if k != "attention_impl"}
    vision = {k: v for k, v in VISION.items() if k != "attention_impl"}
    jcfg = JCLIPConfig(text=JText(**text), vision=JVision(**vision), projection_dim=32)
    jmodel = dataclasses.replace(
        JFusion.create("clip", num_labels=3, fusion_dim=16, clip_config=jcfg),
        image_mean=MEAN, image_std=STD, embed_impl="reference",
    )
    fields = {f.name for f in dataclasses.fields(jloop.TrainArgs)} - {"wire"}
    args = jloop.TrainArgs(**{k: v for k, v in dataclasses.asdict(_tb_args(out)).items()
                              if k in fields}, wire="f32")
    return jloop.Trainer(jmodel, jmodel.init(jax.random.key(0)), args,
                         _NormalisedNCHW(TinyDataset(16, 0)), _NormalisedNCHW(TinyDataset(7, 1)),
                         j_metrics(3), mesh=build_mesh(1, 1))


def _tb_args(out):
    return _args(out, num_train_epochs=2, report_to="tensorboard", logging_steps=2,
                 save_total_limit=1)


def _tags(out):
    (path,) = glob.glob(os.path.join(out, "logs", "events.out.tfevents.*"))
    return [(tag, step) for tag, step, _ in tev.read_scalars(path)]


def test_trainer_writes_the_jax_trainers_tags(tmp_path):
    port_out, jax_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    trainer = Trainer(_port_model(seed=5), _tb_args(port_out), TinyDataset(16, 0),
                      TinyDataset(7, 1), make_compute_metrics_multi(3), device="cpu")
    trainer.train()
    trainer.writer.close()
    jt = _jax_trainer(jax_out)
    jt.train()
    jt.writer.close()
    got, want = _tags(port_out), _tags(jax_out)
    assert got == want
    # 4 micro-steps an epoch, logged every 2nd; eval after each epoch
    assert [s for t, s in got if t == "train/loss"] == [2, 4, 6, 8]
    assert ("eval/roc_macro", 4) in got and ("eval/train_loss", 8) in got
