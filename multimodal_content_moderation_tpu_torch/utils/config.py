"""Small IO utilities: label-list parsing, image-size inference and JSON
artifacts (the reference's src/utils/helpers.py surface)."""

from __future__ import annotations

import ast
import json
import os
from typing import Any, List, Tuple


def ensure_dir(p: str) -> None:
    """Create directory ``p`` (and parents) if missing."""
    os.makedirs(p, exist_ok=True)


def parse_label_list(v: Any) -> List[str]:
    """Parse a label field into a list of label strings.

    Accepts: None, a list, a Python-literal string ("['a','b']"), or a
    comma-separated string (reference src/utils/helpers.py:23-57).
    """
    if v is None:
        return []
    if isinstance(v, list):
        return [str(x).strip() for x in v if str(x).strip()]

    s = str(v).strip()
    if not s:
        return []

    try:
        maybe = ast.literal_eval(s)
        if isinstance(maybe, (list, tuple)):
            return [str(x).strip() for x in maybe if str(x).strip()]
    except Exception:
        pass

    return [t.strip() for t in s.split(",") if t.strip()]


def infer_size(proc: Any) -> Tuple[int, int]:
    """Infer (H, W) from an image-processor-like object or a plain dict.

    Mirrors the probing order of the reference (src/utils/helpers.py:60-84):
    ``size`` may be a dict with height/width/shortest_edge, an int, or a
    2-tuple. Defaults to 224x224.
    """
    H = W = 224
    sz = proc.get("size") if isinstance(proc, dict) else getattr(proc, "size", None)
    if sz is not None:
        if isinstance(sz, dict):
            H = int(sz.get("height", sz.get("shortest_edge", H)))
            W = int(sz.get("width", sz.get("shortest_edge", W)))
        elif isinstance(sz, (int, float)):
            H = W = int(sz)
        elif isinstance(sz, (tuple, list)) and len(sz) == 2:
            H, W = int(sz[0]), int(sz[1])
    return H, W


def save_json(data: Any, path: str, indent: int = 2) -> None:
    ensure_dir(os.path.dirname(path) or ".")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=indent, ensure_ascii=False)


def load_json(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
