"""ctypes bindings of the port's host image library (``csrc/image_ops.cpp``).

The library is built with ``g++`` at first use into ``build/native/`` (or
``native/`` under an enabled ``MMHARM_COMPILE_CACHE``), under a name keyed
by a hash of the source. The build writes a temporary file of its own and
``os.replace``s it onto that name while it holds an ``fcntl`` lock on
``lock`` in the same directory, so that concurrent processes (test workers,
a server's threads) never load a half-written library. The JAX package's
``native/`` directory is never written.

The JPEG decoder is chosen when the library is built, in this order:
libjpeg (``jpeglib.h`` found; the decoder PIL wraps, bit-identical to it),
else the CUDA toolkit's nvJPEG (``nvjpeg.h`` found; the IDCT runs on the
card, the rest on the host), else none. ``jpeg_decoder()`` names it.

Unlike the JAX package's loader, a failed build raises (``load``): a caller
that asks for a ``native*`` backend gets the library or an error, never a
silent fallback. So does a decode that fails for a reason other than its
bytes (``decode_jpeg_resize_crop``): a device or memory fault is an error,
not an image that is absent. Every entry point is a plain C call, so ctypes releases the
GIL and a thread pool decodes in parallel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from multimodal_content_moderation_tpu_torch.utils import compile_cache

SRC = Path(__file__).resolve().parent.parent / "csrc" / "image_ops.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
build_log: List[str] = []  # each build attempt of this process and its outcome


def build_dir() -> Path:
    root = compile_cache.cache_dir()
    return Path(root) / "native" if root else compile_cache.REPO_BUILD / "native"


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libmmcm_image_ops-{digest}.so"


def _cuda_home() -> Optional[Path]:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "include" / "nvjpeg.h").exists():
            return Path(cand)
    return None


def _variants():
    """(name, extra g++ arguments) in the order they are tried."""
    yield "libjpeg", ["-DMMCM_HAVE_JPEG", "-ljpeg"]
    cuda = _cuda_home()
    if cuda is not None:
        lib = cuda / "lib64"
        yield "nvjpeg", ["-DMMCM_HAVE_NVJPEG", f"-I{cuda / 'include'}", f"-L{lib}",
                         f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"]
    yield "none", []


def _build(out: Path) -> None:
    """Compile ``SRC`` onto ``out`` (under the directory's lock)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native image library is built at first use")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    errors = []
    try:
        for name, extra in _variants():
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), *extra]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                build_log.append(f"{name}: ok")
                os.replace(tmp, out)
                return
            build_log.append(f"{name}: failed: {proc.stderr.strip()[-1500:]}")
            errors.append(f"[{name}] {proc.stderr.strip()[-2000:]}")
    finally:
        if tmp.exists():
            tmp.unlink()
    raise RuntimeError("native image library build failed:\n" + "\n".join(errors))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
    ]
    lib.resize_bilinear_u8.restype = None
    lib.resize_shortest_edge_center_crop_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.resize_shortest_edge_center_crop_u8.restype = None
    lib.decode_jpeg_resize_crop_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
    ]
    lib.decode_jpeg_resize_crop_u8.restype = ctypes.c_int
    lib.ycc_to_rgb_u8.argtypes = [u8p, u8p, u8p, *[ctypes.c_int] * 4, u8p]
    lib.ycc_to_rgb_u8.restype = None
    lib.has_jpeg.argtypes = []
    lib.has_jpeg.restype = ctypes.c_int
    lib.jpeg_decoder.argtypes = []
    lib.jpeg_decoder.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first where needed. Raises if it cannot
    be built or loaded (and again on every later call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            out = lib_path()
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out.parent / "lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not out.exists():
                        _build(out)
                    try:
                        lib = ctypes.CDLL(str(out))
                    except OSError:
                        # built on another machine (a shared or copied build
                        # directory) against libraries this one lacks
                        _build(out)
                        lib = ctypes.CDLL(str(out))
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
            _lib = _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"native image library unavailable: {e}"
            raise RuntimeError(_error) from e
        return _lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def jpeg_available() -> bool:
    return available() and bool(load().has_jpeg())


def jpeg_decoder() -> Optional[str]:
    """"libjpeg", "nvjpeg", or None where the library has no decoder or
    cannot be built."""
    if not available():
        return None
    name = load().jpeg_decoder().decode()
    return None if name == "none" else name


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# decode_jpeg_resize_crop_u8's codes past those of bytes that do not decode (1-3)
_FAULTS = {
    4: "out of device or pinned host memory",
    5: "the copy from the card or its stream sync failed",
    6: "nvJPEG could not be set up (library handle, decoder state or stream)",
    7: "the library has no JPEG decoder compiled in",
}


def decode_jpeg_resize_crop(data: bytes, out: int, scaled: bool = True) -> Optional[np.ndarray]:
    """JPEG bytes -> (out, out, 3) uint8 RGB crop in one native call, or
    None where the bytes do not decode (corrupt, truncated, not a JPEG the
    decoder takes). A fault of the machine (memory, the card, nvJPEG's set
    up) raises ``RuntimeError``. ``scaled`` lets libjpeg decode at the
    smallest M/8 scale that still covers ``out`` (near-exact; nvJPEG always
    decodes at full size); unscaled, the libjpeg crop is bit-identical to
    the PIL path's."""
    lib = load()
    dst = np.empty((out, out, 3), np.uint8)
    rc = lib.decode_jpeg_resize_crop_u8(data, len(data), _u8(dst), out, 1 if scaled else 0)
    if rc == 0:
        return dst
    if rc in (1, 2, 3):
        return None
    why = _FAULTS.get(rc, f"nvJPEG status {rc - 100}" if rc >= 100 else "unknown code")
    raise RuntimeError(f"JPEG decoder fault (code {rc}): {why}")


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Coded YCbCr planes (Y [h, w]; Cb and Cr [h, w] for 4:4:4 or
    [ceil(h / 2), ceil(w / 2)] for 4:2:0) -> [h, w, 3] RGB, upsampled and
    converted with libjpeg's arithmetic: the host half of the nvJPEG decode."""
    lib = load()
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))
    (h, w), (ch, cw) = y.shape, cb.shape
    if cr.shape != cb.shape or (ch, cw) not in ((h, w), (-(-h // 2), -(-w // 2))):
        raise ValueError(f"planes {y.shape}, {cb.shape}, {cr.shape}: want 4:4:4 or 4:2:0")
    dst = np.empty((h, w, 3), np.uint8)
    lib.ycc_to_rgb_u8(_u8(y), _u8(cb), _u8(cr), w, h, cw, ch, _u8(dst))
    return dst


def resize_bilinear(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8 resize, PIL's ``Image.BILINEAR`` bit for bit."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w, c = src.shape
    dst = np.empty((out_h, out_w, c), np.uint8)
    lib.resize_bilinear_u8(_u8(src), h, w, c, _u8(dst), out_h, out_w)
    return dst


def resize_center_crop(src: np.ndarray, out: int) -> np.ndarray:
    """Shortest-edge resize + centre crop to (out, out) in one native call."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w, c = src.shape
    dst = np.empty((out, out, c), np.uint8)
    lib.resize_shortest_edge_center_crop_u8(_u8(src), h, w, c, _u8(dst), out)
    return dst
