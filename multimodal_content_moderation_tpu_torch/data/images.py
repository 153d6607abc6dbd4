"""Host-side image decode + geometric preprocessing (eval path).

Reproduces the reference's torchvision eval pipeline on PIL inputs exactly:

    Resize(shortest_edge=H, bilinear antialias) -> CenterCrop(H, W)
    -> ToTensor -> Normalize(mean, std)

The host produces raw uint8 HWC crops; on the uint8 wire the normalisation
is folded into the patch embed on the card (``models/u8wire.py``). Missing
or corrupt images degrade to zeros with presence flag 0.0.

Not ported yet: the normalised float32 NCHW output (the pixel path), the
native libjpeg backend and the training augmentations.

PIL is imported where an image is decoded, so this module (and the stats
below) import on a machine without it.
"""

from __future__ import annotations

import io
import os
from typing import Sequence, Tuple

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shortest_edge(im, size: int):
    """PIL bilinear resize with the shortest edge scaled to ``size``
    (= torchvision ``Resize(size, antialias=True)`` on PIL input)."""
    from PIL import Image

    w, h = im.size
    if (w <= h and w == size) or (h <= w and h == size):
        return im
    # NB: torchvision/HF truncate (int(), not round()) the long edge.
    if w < h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return im.resize((new_w, new_h), Image.BILINEAR)


def center_crop(arr: np.ndarray, H: int, W: int) -> np.ndarray:
    """Center crop HWC array to (H, W), zero-padding if smaller
    (= torchvision ``CenterCrop``)."""
    h, w = arr.shape[:2]
    if h < H or w < W:
        padded = np.zeros((max(h, H), max(w, W), arr.shape[2]), arr.dtype)
        top, left = (max(h, H) - h) // 2, (max(w, W) - w) // 2
        padded[top : top + h, left : left + w] = arr
        arr, h, w = padded, max(h, H), max(w, W)
    top = (h - H) // 2
    left = (w - W) // 2
    return arr[top : top + H, left : left + W]


class ImagePreprocessor:
    """Decode + resize + crop one image to a fixed-shape uint8 HWC crop.
    ``mean``/``std`` (the encoder's stats) are applied on the card, folded
    into the patch embed; they are accepted here for the JAX signature."""

    def __init__(
        self,
        height: int = 224,
        width: int = 224,
        mean: Sequence[float] = CLIP_MEAN,
        std: Sequence[float] = CLIP_STD,
        output: str = "uint8_hwc",
        backend: str = "pil",
    ):
        if output != "uint8_hwc":
            raise NotImplementedError(
                f"image output {output!r} is not ported yet (the pixel path comes "
                "in a later slice); use 'uint8_hwc'"
            )
        if backend != "pil":
            raise NotImplementedError(
                f"image backend {backend!r} is not ported yet (the native libjpeg "
                "backend comes in a later slice); use 'pil'"
            )
        self.H, self.W = height, width

    def zero_output(self) -> np.ndarray:
        return np.zeros((self.H, self.W, 3), np.uint8)

    def process_pil(self, im) -> np.ndarray:
        im = resize_shortest_edge(im.convert("RGB"), self.H)
        return center_crop(np.asarray(im, np.uint8), self.H, self.W)

    def process_bytes(self, data: bytes) -> Tuple[np.ndarray, float]:
        """Encoded image bytes -> (array, present_flag); any failure
        degrades to zeros."""
        from PIL import Image

        try:
            with Image.open(io.BytesIO(data)) as im:
                return self.process_pil(im), 1.0
        except Exception:
            return self.zero_output(), 0.0

    def load(self, path: str) -> Tuple[np.ndarray, float]:
        """Decode ``path`` -> (array, present_flag). Degrades to zeros on any
        failure."""
        if not path:
            return self.zero_output(), 0.0
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return self.zero_output(), 0.0
        return self.process_bytes(data)

    def load_relative(self, rel: str, image_root: str) -> Tuple[np.ndarray, float]:
        if not rel:
            return self.zero_output(), 0.0
        path = rel if os.path.isabs(rel) or not image_root else os.path.join(image_root, rel)
        return self.load(path)
