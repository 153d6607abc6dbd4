"""The run's process: where its caches live, which modules it may never
load, when it started, and the card it measures."""

from __future__ import annotations

import os
import sys
import time
from typing import List

# top-level module names the benchmark's process may never hold: JAX and the
# JAX package, whose name the measured port's name begins with, so names are
# compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_content_moderation_tpu")


def hide_forbidden() -> None:
    """Make every import of a forbidden module fail in this process."""
    for name in FORBIDDEN:
        if sys.modules.get(name) is None:
            sys.modules[name] = None


def forbidden_loaded() -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds. The port's nvcc and image
    libraries already go to ``build/`` of the checkout."""
    base = os.path.join(root, "build", "benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.pop("MMHARM_COMPILE_CACHE", None)
    # libraries that load JAX or Flax by themselves when present
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The process's start on the ``time.time()`` clock, from
    ``/proc/self/stat``; now, where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, field 22
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def card(chips: int):
    """(device, the card's name) of a card that can run the cell; exits
    non-zero with no result where there is none or too few."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0), torch.cuda.get_device_name(0)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or ''."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


def host_sample():
    """This process's CPU seconds and major page faults so far, to read
    with ``host_delta``: a pass whose CPU seconds grow with its wall time
    ran slower on the host, and major faults mean the pixel cache was read
    from the disk again."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_majflt


def host_delta(a, b):
    """This process's CPU seconds and major page faults between two
    ``host_sample``s."""
    return {"proc_cpu_s": b[0] - a[0], "majflt": b[1] - a[1]}
