"""Decode-once pixel cache: a disk memmap of preprocessed images.

``PixelCache`` stores each image's preprocessor output (a uint8 HWC crop or
a normalised float32 CHW array) in a memmap that is filled lazily on the
first decode; a later pass over the same rows (another epoch, another
evaluation) reads it back instead of decoding the JPEG again.

The cache directory is keyed by the same signature as the JAX package's
``data/cache.py`` (the image paths, root and each file's mtime and size; the
preprocessor's geometry, normalisation, output layout and decode backend),
and holds the same files, so either package reads a cache the other filled.

- An augmenting preprocessor is never cached (its outputs are random).
- An entry's ``filled`` flag is written after its pixels and presence flag,
  so a process that dies mid-fill loses the entry, never corrupts it.
- Concurrent fillers write identical bytes; the last writer wins.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor


def _dataset_signature(
    paths: List[str], image_root: str, preproc: ImagePreprocessor
) -> str:
    """Stable hash of everything that determines the cached bytes."""
    files = []
    for rel in paths:
        if not rel:
            files.append((rel, 0, 0))
            continue
        p = rel if os.path.isabs(rel) or not image_root else os.path.join(image_root, rel)
        try:
            st = os.stat(p)
            files.append((rel, int(st.st_mtime_ns), st.st_size))
        except OSError:
            files.append((rel, -1, -1))
    key = {
        "files": files,
        "image_root": os.path.abspath(image_root) if image_root else "",
        "H": preproc.H,
        "W": preproc.W,
        "output": preproc.output,
        # native_scaled is near-exact (not bit-exact) against pil/native, so
        # the backend is part of the key
        "backend": preproc.backend,
        "mean": preproc.mean.tolist(),
        "std": preproc.std.tolist(),
        "version": 1,
    }
    return hashlib.sha1(
        json.dumps(key, sort_keys=True).encode("utf-8")
    ).hexdigest()[:16]


class PixelCache:
    """Lazily-filled memmap cache of per-image preprocessor outputs.

    ``get(i)`` returns ``(array, present)`` or ``None`` on a cold entry;
    ``put(i, array, present)`` fills it. Arrays returned by ``get`` are
    copies (safe to mutate / ship to device)."""

    def __init__(
        self,
        cache_dir: str,
        paths: List[str],
        image_root: str,
        preproc: ImagePreprocessor,
    ):
        if preproc.augment:
            raise ValueError(
                "PixelCache cannot cache an augmenting preprocessor "
                "(outputs are random); construct the dataset without a cache."
            )
        n = len(paths)
        if preproc.output == "uint8_hwc":
            shape, dtype = (n, preproc.H, preproc.W, 3), np.uint8
        else:
            shape, dtype = (n, 3, preproc.H, preproc.W), np.float32
        sig = _dataset_signature(paths, image_root, preproc)
        self.dir = os.path.join(cache_dir, sig)
        os.makedirs(self.dir, exist_ok=True)
        meta_path = os.path.join(self.dir, "meta.json")
        meta = {"n": n, "shape": list(shape), "dtype": np.dtype(dtype).name}
        if not os.path.exists(meta_path):
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        self.pixels = np.lib.format.open_memmap(
            os.path.join(self.dir, "pixels.npy"),
            mode="r+" if os.path.exists(os.path.join(self.dir, "pixels.npy")) else "w+",
            dtype=dtype,
            shape=shape,
        )
        self.present = np.lib.format.open_memmap(
            os.path.join(self.dir, "present.npy"),
            mode="r+" if os.path.exists(os.path.join(self.dir, "present.npy")) else "w+",
            dtype=np.float32,
            shape=(n,),
        )
        self.filled = np.lib.format.open_memmap(
            os.path.join(self.dir, "filled.npy"),
            mode="r+" if os.path.exists(os.path.join(self.dir, "filled.npy")) else "w+",
            dtype=np.uint8,
            shape=(n,),
        )

    def get(self, i: int) -> Optional[Tuple[np.ndarray, float]]:
        if not self.filled[i]:
            return None
        return np.array(self.pixels[i]), float(self.present[i])

    def put(self, i: int, arr: np.ndarray, present: float) -> None:
        self.pixels[i] = arr
        self.present[i] = present
        # The flag is written last, so a process that dies mid-fill loses the
        # entry. Power loss is not covered: memmap writeback order is
        # unspecified, so a torn entry costs one stale crop, and deleting the
        # cache directory rebuilds it.
        self.filled[i] = 1

    @property
    def hit_count(self) -> int:
        return int(np.count_nonzero(self.filled))
