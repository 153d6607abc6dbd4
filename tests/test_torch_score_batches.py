"""The host input of offline scoring: ``ops/cuda_image.gather_patches_u8``
(the native routine of ``csrc/image_ops.cpp``) and
``models/fast_infer.score_batches``.

- The native routine writes the bytes of ``extract_patches_plain`` (NumPy's
  strided copy) at p 16 and 32, 224 and 384 px, with repeated rows, one
  row and the -1 rows of a padded last batch; on one thread and on several;
  the general path (another patch size or channel count) and the plain
  fallback where the library does not load do too.
- ``score_batches`` gives the host batches of the closure it replaced
  (``_parent_batches`` below, kept as the reference): ids, mask, patch
  rows, flags, carry, width, valid rows and labels, bit for bit, over a
  warm cache, a cache with cold rows and a dataset without one; SigLIP's
  carry column, CLIP's and DeepSeek-V2's truncation, and each rank of a
  two-rank mesh.
- Recorded, ``prep.gathered_rows`` + ``prep.decoded_rows`` equal the rows
  scored, and the logits do not depend on where the crops came from."""

import types

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_content_moderation_tpu_torch.data import native
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.models import fast_infer as tfi
from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.models import model_io
from multimodal_content_moderation_tpu_torch.ops import cuda_image as ci
from multimodal_content_moderation_tpu_torch.utils import profiling

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]

ROWS = {
    "repeated": [3, 0, 3, 5, 5, 1],
    "one": [4],
    "padded": [2, 5, 0, -1, -1],
}


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("p,size", [(16, 224), (32, 224), (16, 384), (32, 384)])
def test_gather_patches_matches_plain(p, size, rows, threads):
    assert native.available(), native.build_log
    src = np.random.default_rng(size + p).integers(0, 256, size=(6, size, size, 3), dtype=np.uint8)
    idx = np.asarray(ROWS[rows])
    want = ci.extract_patches_plain(src[np.maximum(idx, 0)], p)
    want[idx < 0] = 0
    out = np.full(want.shape, 7, np.uint8)  # every byte written, pads included
    got = ci.gather_patches_u8(src, idx, p, out=out, threads=threads)
    assert got is out
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ci.extract_patches_u8(src, p), ci.extract_patches_plain(src, p))


@pytest.mark.parametrize("shape,p",
                         [((3, 24, 40, 3), 8), ((2, 32, 48, 1), 16), ((2, 64, 32, 4), 32)])
@pytest.mark.parametrize("library", [True, False])
def test_gather_patches_general_shapes(monkeypatch, shape, p, library):
    """Shapes off the specialised paths, and the plain fallback where the
    library does not load: the same bytes."""
    if not library:
        monkeypatch.setattr(native, "available", lambda: False)
    src = np.random.default_rng(p).integers(0, 256, size=shape, dtype=np.uint8)
    idx = np.asarray([1, 0, 1, -1])
    want = ci.extract_patches_plain(src[np.maximum(idx, 0)], p)
    want[3] = 0
    np.testing.assert_array_equal(ci.gather_patches_u8(src, idx, p), want)
    np.testing.assert_array_equal(ci.extract_patches_u8(src, p), ci.extract_patches_plain(src, p))


@pytest.mark.parametrize("bad", ["row past the end", "row below -1", "patch size", "dtype"])
def test_gather_patches_refuses(bad):
    src = np.zeros((4, 32, 32, 3), np.uint8)
    rows, p = np.asarray([0, 1]), 16
    if bad == "row past the end":
        rows = np.asarray([0, 4])
    elif bad == "row below -1":
        rows = np.asarray([-2, 1])
    elif bad == "patch size":
        p = 12
    else:
        src = src.astype(np.float32)
    with pytest.raises(ValueError):
        native.gather_patches_u8(src, rows, p, np.empty((2, 4, 768), np.uint8), 1)


def _parent_batches(engine, dataset, batch_size, rows, ladder, num_workers=2):
    """The scoring prep as it was: ``dataset.batches``, NumPy's patch rows,
    the buckets, ``from_numpy`` (no pinning on the CPU)."""
    backend = engine.model.backend
    n = len(dataset) if rows is None else len(rows)
    batches = dataset.batches(batch_size, pad_to_batch=True, num_workers=num_workers,
                              indices=rows)
    for _ in range(-(-n // batch_size)):
        batch = next(batches)
        valid = int(batch.pop("_valid"))
        labels = batch.pop("labels")[:valid]
        patches = ci.extract_patches_plain(batch.pop("pixel_values"), engine.patch_size)
        carry, width = None, batch["input_ids"].shape[1]
        if ladder is not None:
            width = tfi.bucket_for(batch["attention_mask"], ladder,
                                   extra=backbone(backend).bucket_extra)
            batch["input_ids"], batch["attention_mask"], carry = tfi.bucket_batch_text(
                batch["input_ids"], batch["attention_mask"], width, backend)
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        host["patches_u8"] = torch.from_numpy(patches)
        yield valid, labels, host, carry, width
    batches.close()


@pytest.fixture
def rows_csv(data_dir, tmp_path):
    """``data_dir``'s test rows with 1 to 16 words, so that the batches fall
    in several buckets."""
    rows = pd.read_csv(f"{data_dir}/test.csv")
    rows["text"] = [" ".join(["hate", "love"][i % 2] for _ in range(i + 1))
                    for i in range(len(rows))]
    rows.to_csv(tmp_path / "test.csv", index=False)
    return str(tmp_path / "test.csv")


def _dataset(rows_csv, data_dir, encoder_dir, cache_dir=None):
    return CSVDataset(
        rows_csv, f"{data_dir}/images", load_tokenizer(encoder_dir),
        ImagePreprocessor(32, 32, MEAN, STD, output="uint8_hwc"), 16, class_names=CLASSES,
        cache_dir=cache_dir,
    )


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gv, gl, gh, gc, gw), (wv, wl, wh, wc, ww) in zip(got, want):
        assert (gv, gc, gw) == (wv, wc, ww)
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)
        assert list(gh) == list(wh)
        for k in wh:
            assert gh[k].dtype == wh[k].dtype and gh[k].shape == wh[k].shape, k
            assert torch.equal(gh[k], wh[k]), k


CASES = {  # backend, buckets, cache ("warm", "cold" rows 0, 5, 9-11, or none), data rank of 2
    "siglip-carry": ("siglip", (10, 14), "warm", None),
    "clip-truncate": ("clip", (10, 14), "warm", None),
    "deepseek_v2": ("deepseek_v2", (6, 12), "warm", None),
    "clip-natural": ("clip", None, "warm", None),
    "mesh-rank0": ("siglip", (10, 14), "warm", 0),
    "mesh-rank1": ("clip", None, "warm", 1),
    "no-cache": ("siglip", (10, 14), None, None),
    "cold-rows": ("siglip", (10, 14), "cold", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_score_batches_match_parent(rows_csv, data_dir, encoder_dir, tmp_path, case):
    backend, buckets, cache, rank = CASES[case]
    engine = types.SimpleNamespace(model=types.SimpleNamespace(backend=backend),
                                   device=torch.device("cpu"), patch_size=8)
    ds = _dataset(rows_csv, data_dir, encoder_dir,
                  str(tmp_path / "cache") if cache else None)
    n, B = len(ds), 6
    if cache == "warm":
        for i in range(n):
            ds.load_image(i)
    elif cache == "cold":  # a few rows cached, the rest decoded in the pass
        for i in (0, 5, 9, 10, 11):
            ds.load_image(i)
    ladder = tfi.bucket_ladder(buckets, 16) if buckets else None
    order = np.argsort(ds.attention_mask.sum(axis=1), kind="stable") if ladder else np.arange(n)
    rows = None if ladder is None and rank is None else order
    if rank is not None:  # this rank's half of every global batch of B rows
        B //= 2
        pos = np.arange(-(-n // 6) * 6).reshape(-1, 6)[:, rank * B:(rank + 1) * B].reshape(-1)
        rows = order[pos[pos < n]]
    reference = _dataset(rows_csv, data_dir, encoder_dir)  # no cache: every crop decoded
    want = list(_parent_batches(engine, reference, B, rows, ladder))
    got = list(tfi.score_batches(engine, ds, B, rows=rows, ladder=ladder, num_workers=2))
    _assert_same_batches(got, want)
    if cache:
        assert ds.cache.hit_count == n


@pytest.mark.parametrize("cache", ["cold", "partial", "warm", "none"])
def test_score_counters_add_up(rows_csv, data_dir, encoder_dir, tmp_path, cache):
    model = model_io.build_model(
        "fusion", "clip", CLASSES, fusion_dim=16, device="cpu",
        encoder_config=model_io.load_encoder_config(encoder_dir, "clip"))
    engine = tfi.FastInferenceEngine(model, MEAN, STD)
    ds = _dataset(rows_csv, data_dir, encoder_dir,
                  None if cache == "none" else str(tmp_path / "cache"))
    n, B = len(ds), 6
    warm = {"cold": 0, "partial": 7, "warm": n, "none": 0}[cache]
    for i in range(warm):
        ds.load_image(i)
    with profiling.recording() as rec:
        logits, labels = tfi.evaluate_logits_u8(engine, ds, B, num_workers=2, seq_buckets=(10, 14))
    c = rec.counters
    assert c["score.rows"] == n
    assert c.get("prep.gathered_rows", 0) + c.get("prep.decoded_rows", 0) == n
    assert c.get("prep.gathered_rows", 0) == warm
    # the crops' source does not show in the logits
    plain = _dataset(rows_csv, data_dir, encoder_dir)
    want, want_labels = tfi.evaluate_logits_u8(engine, plain, B, num_workers=2,
                                               seq_buckets=(10, 14))
    np.testing.assert_array_equal(logits, want)
    np.testing.assert_array_equal(labels, want_labels)
