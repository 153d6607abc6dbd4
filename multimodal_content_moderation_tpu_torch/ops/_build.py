"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library's file name carries a hash of its source and of
every shared header (``csrc/*.cuh``), so an edited kernel or header is
rebuilt and a stale library is never loaded. Builds go to
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), or under ``MMHARM_COMPILE_CACHE`` where an entry point
enabled it (``utils/compile_cache.py``). A failed build raises; nothing
falls back.

Every C entry point takes raw device pointers, ints and the current CUDA
stream, launches, and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from multimodal_content_moderation_tpu_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = compile_cache.REPO_BUILD / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) of each build
ptxas_reports: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "csrc/ at first use"
    )


def build_dir() -> Path:
    """``BUILD_DIR``, or ``torch_kernels/`` under an enabled
    ``MMHARM_COMPILE_CACHE``."""
    root = compile_cache.cache_dir()
    return Path(root) / "torch_kernels" if root else BUILD_DIR


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc; returns (process, temporary output, final path)."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: Iterable[str]) -> None:
    """Build the named kernels that are not built yet, one nvcc per source,
    all started together. Raises on the first failure."""
    with _lock:
        todo = [n for n in names if n not in _libs and not _lib_path(n).exists()]
        if not todo:
            return
        build_dir().mkdir(parents=True, exist_ok=True)
        started = [(n, *_start(n)) for n in todo]
        failures = []
        for name, proc, tmp, out in started:
            log, _ = proc.communicate()
            ptxas_reports[name] = log
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
                getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
                getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, read through PyTorch's raw
    accessor (a ``torch.cuda.Stream`` object costs microseconds a launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
