"""The port's native image library (``csrc/image_ops.cpp`` through
``data/native.py``) and the ``native*`` backends of its preprocessor,
against PIL and the JAX package's ``pil`` backend (the JAX package's own
``data.native`` is not called here: it would start a second, concurrent
build into ``native/``).

- The resize is PIL's ``Image.BILINEAR`` bit for bit (exact), at the JAX
  test's shapes and at seeded random ones.
- The libjpeg decode of every committed fixture equals its committed PIL
  crop exactly; the scaled decode is within the JAX package's scaled-path
  tolerance (tests/test_native_ops.py: mean absolute difference < 2.0).
- ``ImagePreprocessor(backend="native*")`` gives the JAX ``pil`` backend's
  arrays (uint8 and normalised fp32, exact); a corrupt JPEG degrades to
  zeros with presence 0; a PNG goes to PIL; a fault of the decoder itself
  raises.
- The host half of the nvJPEG decode (4:2:0 upsampling, YCbCr -> RGB) is
  libjpeg's arithmetic exactly, on libjpeg's own coded planes.
- The build: into ``build/native/`` (or under ``MMHARM_COMPILE_CACHE``),
  under a name keyed by the source; concurrent processes load one library
  built once, through a temporary file and ``os.replace`` under a lock; a
  build that cannot succeed raises.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu_torch.data import native
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.testdata import (
    CROP_SIZES,
    jpeg_fixtures,
    pil_crops,
)
from multimodal_content_moderation_tpu_torch.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted(jpeg_fixtures())
DECODABLE = [n for n in FIXTURES if pil_crops(n) is not None]


@pytest.mark.parametrize(
    "in_shape,out_shape",
    [((300, 470), (224, 351)), ((100, 80), (224, 179)), ((224, 224), (112, 112)),
     ((37, 53), (64, 96)), ((1, 300), (5, 7)), ((640, 480), (640, 224))],
)
def test_resize_is_pil_bilinear_exactly(in_shape, out_shape):
    src = np.random.default_rng(0).integers(0, 256, size=(*in_shape, 3), dtype=np.uint8)
    oh, ow = out_shape
    want = np.asarray(Image.fromarray(src).resize((ow, oh), Image.BILINEAR), np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(src, oh, ow), want)


def test_resize_random_shapes_are_pil_exactly():
    g = np.random.default_rng(1)
    for _ in range(60):
        h, w, oh, ow = (int(v) for v in g.integers(1, 300, size=4))
        src = g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(src).resize((ow, oh), Image.BILINEAR), np.uint8)
        np.testing.assert_array_equal(native.resize_bilinear(src, oh, ow), want)


@pytest.mark.parametrize("name", DECODABLE)
def test_fixture_decode_equals_the_pil_crop(name):
    if native.jpeg_decoder() != "libjpeg":
        pytest.fail(f"this machine's native library decodes with {native.jpeg_decoder()}")
    data = jpeg_fixtures()[name].read_bytes()
    for size in CROP_SIZES:
        want = pil_crops(name)[size]
        np.testing.assert_array_equal(native.decode_jpeg_resize_crop(data, size, False), want)
        scaled = native.decode_jpeg_resize_crop(data, size, True)
        assert np.abs(scaled.astype(int) - want.astype(int)).mean() < 2.0


def _ycc_planes(data: bytes):
    """libjpeg's Y plane and its Cb, Cr planes as coded, through PIL: the
    full-size YCbCr decode gives Y; a 1/2-scale decode of a 4:2:0 image
    runs the chroma IDCT at full 8x8 size, so its Cb and Cr are the coded
    planes, not upsampled."""
    with Image.open(io.BytesIO(data)) as im:
        w, h = im.size
        sub = im.layer[0][1] == 2
        im.draft("YCbCr", (w, h))
        y = np.asarray(im)[..., 0]
        c = np.asarray(im)
    if sub:
        with Image.open(io.BytesIO(data)) as im:
            im.draft("YCbCr", (w // 2, h // 2))
            c = np.asarray(im)
        assert c.shape[:2] == (-(-h // 2), -(-w // 2))
    return y, c[..., 1], c[..., 2]


def _seeded_jpegs():
    g = np.random.default_rng(5)
    out = {}
    for h, w, sub in [(37, 53, 2), (5, 3, 2), (3, 4, 2), (2, 2, 2), (64, 31, 2), (9, 7, 0)]:
        buf = io.BytesIO()
        Image.fromarray(g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(
            buf, "JPEG", subsampling=sub, quality=90)
        out[f"seeded_{h}x{w}_{'420' if sub else '444'}"] = buf.getvalue()
    return out


@pytest.mark.parametrize("name", [n for n in DECODABLE if not n.startswith("grey")]
                         + sorted(_seeded_jpegs()))
def test_ycc_to_rgb_is_libjpeg_exactly(name):
    """The host half of the nvJPEG decode (4:2:0 fancy upsampling and the
    YCbCr -> RGB tables) turns libjpeg's coded planes into PIL's RGB pixels
    exactly, odd sizes and 2-sample-wide chroma planes included."""
    data = _seeded_jpegs().get(name) or jpeg_fixtures()[name].read_bytes()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(native.ycc_to_rgb(*_ycc_planes(data)), want)


class _FaultyLib:
    """The library with a decode that returns ``rc``."""

    def __init__(self, rc):
        self.rc = rc

    def decode_jpeg_resize_crop_u8(self, *args):
        return self.rc


@pytest.mark.parametrize("rc", [4, 5, 6, 7, 106])
def test_decoder_fault_raises(monkeypatch, rc):
    """A decode that fails for the machine's sake (memory, a copy, nvJPEG's
    set up, an nvJPEG device status) raises, in the native call and through
    the preprocessor: the request fails instead of losing its image."""
    pre = ImagePreprocessor(224, 224, backend="native_scaled")
    data = jpeg_fixtures()["rgb420_240x320"].read_bytes()
    monkeypatch.setattr(native, "load", lambda: _FaultyLib(rc))
    with pytest.raises(RuntimeError, match=f"code {rc}"):
        native.decode_jpeg_resize_crop(data, 224)
    with pytest.raises(RuntimeError, match=f"code {rc}"):
        pre.process_bytes(data)


@pytest.mark.parametrize("rc", [1, 2, 3])
def test_undecodable_bytes_degrade(monkeypatch, rc):
    pre = ImagePreprocessor(224, 224, backend="native_scaled")
    monkeypatch.setattr(native, "load", lambda: _FaultyLib(rc))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert native.decode_jpeg_resize_crop(b"\xff\xd8", 224) is None
    arr, present = pre.process_bytes(b"\xff\xd8")
    assert present == 0.0 and not arr.any()


def test_corrupt_fixture_does_not_decode():
    data = jpeg_fixtures()["corrupt"].read_bytes()
    assert pil_crops("corrupt") is None
    for scaled in (False, True):
        assert native.decode_jpeg_resize_crop(data, 224, scaled) is None
    assert native.decode_jpeg_resize_crop(b"notajpeg", 224) is None
    arr, present = ImagePreprocessor(224, 224, backend="native").process_bytes(data)
    assert present == 0.0 and arr.shape == (224, 224, 3) and not arr.any()


@pytest.mark.parametrize("output", ["uint8_hwc", "float_nchw"])
@pytest.mark.parametrize("backend", ["native", "native_scaled"])
def test_preprocessor_matches_the_jax_pil_backend(output, backend):
    """native: exact; native_scaled: exact where libjpeg does not scale (a
    short edge under 2 x 7/8 of the crop), else within the scaled tolerance."""
    tp = ImagePreprocessor(224, 224, output=output, backend=backend)
    jp = JPre(224, 224, output=output, backend="pil")
    for name in FIXTURES:
        data = jpeg_fixtures()[name].read_bytes()
        got, got_p = tp.process_bytes(data)
        want, want_p = jp.process_bytes(data)
        assert got_p == want_p and got.shape == want.shape and got.dtype == want.dtype
        if backend == "native":
            np.testing.assert_array_equal(got, want)
        elif output == "uint8_hwc":
            assert np.abs(got.astype(int) - want.astype(int)).mean() < 2.0


def test_non_jpeg_goes_to_pil():
    g = np.random.default_rng(2)
    buf = io.BytesIO()
    Image.fromarray(g.integers(0, 256, size=(50, 70, 3), dtype=np.uint8)).save(buf, "PNG")
    got = ImagePreprocessor(32, 32, backend="native").process_bytes(buf.getvalue())
    want = JPre(32, 32, output="uint8_hwc").process_bytes(buf.getvalue())
    assert got[1] == want[1] == 1.0
    np.testing.assert_array_equal(got[0], want[0])


def test_library_is_built_under_build_native():
    path = native.lib_path()
    assert native.available() and path.exists()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libmmcm_image_ops-") and path.suffix == ".so"
    assert not list(path.parent.glob("*.tmp"))
    assert (path.parent / "lock").exists()


LOADER = """
import sys
sys.path.insert(0, {repo!r})
from multimodal_content_moderation_tpu_torch.utils import compile_cache
from multimodal_content_moderation_tpu_torch.data import native
compile_cache.maybe_enable_from_env()
print(native.lib_path(), native.jpeg_decoder(), native.build_log)
"""


def test_concurrent_processes_build_once(tmp_path):
    """Four processes load the library from one empty build directory at
    once: each gets it, one of them built it, and no temporary file is left."""
    env = {**os.environ, "MMHARM_COMPILE_CACHE": str(tmp_path)}
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", LOADER.format(repo=str(REPO))], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = [o.strip() for o, _ in outs]
    built = [ln for ln in lines if "'libjpeg: ok'" in ln]
    assert len(built) == 1, lines
    libs = list((tmp_path / "native").glob("*.so"))
    assert len(libs) == 1 and all(ln.startswith(str(libs[0])) for ln in lines)
    assert not list((tmp_path / "native").glob("*.tmp"))


def test_failed_build_raises(tmp_path):
    code = LOADER.format(repo=str(REPO)) + """
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
for attempt in range(2):
    try:
        native.load()
    except RuntimeError as e:
        print("raised", "build failed" in str(e))
try:
    ImagePreprocessor(backend="native")
except RuntimeError:
    print("preprocessor raised")
"""
    env = {**os.environ, "MMHARM_COMPILE_CACHE": str(tmp_path), "CXX": "/bin/false"}
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.replace(
        "print(native.lib_path(), native.jpeg_decoder(), native.build_log)", "")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == ["raised True", "raised True", "preprocessor raised"]
    assert not list((tmp_path / "native").glob("*.so"))


@pytest.mark.parametrize(
    "value,want",
    [("", None), ("0", None), ("no", None), ("1", "default"), ("TRUE", "default"),
     ("DIR", "dir")],
)
def test_compile_cache_from_env(monkeypatch, tmp_path, value, want):
    from multimodal_content_moderation_tpu_torch.ops import _build

    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(compile_cache, "_DEFAULT_DIR", str(tmp_path / "default"))
    monkeypatch.setenv("MMHARM_COMPILE_CACHE", value.replace("DIR", str(tmp_path / "dir")))
    got = compile_cache.maybe_enable_from_env()
    if want is None:
        assert got is None and compile_cache.cache_dir() is None
        assert _build.build_dir() == _build.BUILD_DIR
        assert native.build_dir() == REPO / "build" / "native"
    else:
        assert got == str(tmp_path / want) == compile_cache.cache_dir()
        assert _build.build_dir() == tmp_path / want / "torch_kernels"
        assert native.build_dir() == tmp_path / want / "native"
