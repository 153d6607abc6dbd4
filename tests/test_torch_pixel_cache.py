"""The port's ``PixelCache`` (``data/cache.py``) against the JAX package's:
the same cache directory signature for the same rows and preprocessor, a
second pass that decodes nothing, and a cache either package filled read
by the other, with the same arrays (exact)."""

import shutil

import numpy as np
import pytest

from multimodal_content_moderation_tpu.data import cache as jcache
from multimodal_content_moderation_tpu.data.dataset import CSVDataset as JDataset
from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu.data.tokenizer import load_tokenizer as j_load
from multimodal_content_moderation_tpu_torch.data import cache as tcache
from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """A CSV over the JPEG fixtures (one missing file, one empty path)."""
    d = tmp_path_factory.mktemp("cache_rows")
    images = d / "images"
    images.mkdir()
    names = []
    for p in jpeg_fixtures().values():
        shutil.copy(p, images / p.name)
        names.append(p.name)
    names += ["missing.jpg", ""]
    lines = ["text,image_path,label"] + [f"row {i},{n},{i % 2}" for i, n in enumerate(names)]
    (d / "t.csv").write_text("\n".join(lines) + "\n")
    return str(d / "t.csv"), str(images), names


@pytest.mark.parametrize("output", ["uint8_hwc", "float_nchw"])
def test_signature_equals_the_jax_one(rows, output):
    _, images, names = rows
    t = tcache._dataset_signature(names, images, ImagePreprocessor(32, 32, output=output))
    j = jcache._dataset_signature(names, images, JPre(32, 32, output=output))
    assert t == j
    other = tcache._dataset_signature(
        names, images, ImagePreprocessor(32, 32, output=output, backend="native"))
    assert other != t  # the backend is part of the key


def _count_decodes(monkeypatch, pre):
    calls = []
    real = pre.load_relative

    def counted(rel, root):
        calls.append(rel)
        return real(rel, root)

    monkeypatch.setattr(pre, "load_relative", counted)
    return calls


def _pixels(ds):
    out = [ds.load_image(i) for i in range(len(ds))]
    return np.stack([a for a, _ in out]), np.asarray([p for _, p in out])


def test_second_pass_reads_the_cache(rows, tmp_path, encoder_dir, monkeypatch):
    csv, images, names = rows
    tok = load_tokenizer(encoder_dir)
    pre = ImagePreprocessor(32, 32, backend="native")
    calls = _count_decodes(monkeypatch, pre)
    first = CSVDataset(csv, images, tok, pre, 16, cache_dir=str(tmp_path))
    px1, pr1 = _pixels(first)
    assert len(calls) == len(names) and first.cache.hit_count == len(names)
    calls.clear()
    second = CSVDataset(csv, images, tok, pre, 16, cache_dir=str(tmp_path))
    px2, pr2 = _pixels(second)
    assert calls == []
    np.testing.assert_array_equal(px1, px2)
    np.testing.assert_array_equal(pr1, pr2)
    # the corrupt JPEG, the missing file and the empty path are absent images
    assert pr1.tolist() == [0.0 if n in ("corrupt.jpg", "missing.jpg", "") else 1.0
                            for n in names]


@pytest.mark.parametrize("output", ["uint8_hwc", "float_nchw"])
@pytest.mark.parametrize("filler", ["jax", "torch"])
def test_either_package_reads_the_others_cache(rows, tmp_path, encoder_dir, monkeypatch,
                                               filler, output):
    csv, images, _ = rows
    tpre, jpre = ImagePreprocessor(32, 32, output=output), JPre(32, 32, output=output)
    tds = lambda: CSVDataset(csv, images, load_tokenizer(encoder_dir), tpre, 16,  # noqa: E731
                             cache_dir=str(tmp_path))
    jds = lambda: JDataset(csv, images, j_load(encoder_dir), jpre, 16,  # noqa: E731
                           cache_dir=str(tmp_path))
    fill, read, read_pre = (jds, tds, tpre) if filler == "jax" else (tds, jds, jpre)
    want = _pixels(fill())
    calls = _count_decodes(monkeypatch, read_pre)
    got = _pixels(read())
    assert calls == []
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
