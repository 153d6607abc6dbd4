"""Where the port's native builds go: the nvcc kernel libraries
(``ops/_build.py``) and the host image library (``data/native.py``).

Both are built at first use and keyed by a hash of their sources, so a
directory can be shared by every process of one machine. By default they go
to ``build/`` at the root of the checkout. An installed package cannot write
there, so, as in the JAX package (``utils/compile_cache.py``), the entry
points honour ``MMHARM_COMPILE_CACHE``:

- a directory: the builds go under it (``torch_kernels/``, ``native/``);
- ``1``/``true``/``yes``: ``~/.cache/mmharm/torch``;
- ``0``/``false``/``no`` or unset: ``build/`` of the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

_ENV = "MMHARM_COMPILE_CACHE"
_DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache", "mmharm", "torch")
REPO_BUILD = Path(__file__).resolve().parents[2] / "build"
_enabled_dir: Optional[str] = None


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Send later builds to ``cache_dir`` (default ``~/.cache/mmharm/torch``);
    returns the directory. Libraries already loaded stay loaded."""
    global _enabled_dir
    path = os.path.abspath(cache_dir or _DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    _enabled_dir = path
    return path


def maybe_enable_from_env() -> Optional[str]:
    """Honour ``MMHARM_COMPILE_CACHE`` (the CLI and serving hook)."""
    raw = os.environ.get(_ENV, "").strip()
    if not raw or raw.lower() in ("0", "false", "no"):
        return None
    if raw.lower() in ("1", "true", "yes"):
        return enable_compilation_cache()
    return enable_compilation_cache(raw)


def cache_dir() -> Optional[str]:
    """The directory enabled in this process, or None."""
    return _enabled_dir
