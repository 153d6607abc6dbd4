"""Host-side image decode + geometric preprocessing.

The eval path reproduces the reference's torchvision pipeline on PIL inputs
exactly:

    Resize(shortest_edge=H, bilinear antialias) -> CenterCrop(H, W)
    -> ToTensor -> Normalize(mean, std)

The train path (``augment``) is torchvision's RandomResizedCrop, horizontal
flip and ColorJitter, drawn from a numpy ``Generator`` in the same order as
the JAX package's ``data/images.py``, so one seed gives the same crops.

The host produces raw uint8 HWC crops; on the uint8 wire the normalisation
is folded into the patch embed on the card (``models/u8wire.py``). Missing
or corrupt images degrade to zeros with presence flag 0.0.

Not ported yet: the normalised float32 NCHW output (the pixel path) and the
native libjpeg backend.

PIL is imported where an image is decoded, so this module (and the stats
below) import on a machine without it.
"""

from __future__ import annotations

import io
import math
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


def _sample_rrc_box(
    rng: np.random.Generator,
    h: int,
    w: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: (top, left, ch, cw)."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop at the closest valid aspect ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _adjust_hue(im, factor: float):
    """Shift hue by ``factor`` in [-0.5, 0.5] via an HSV roll (torchvision's
    algorithm)."""
    from PIL import Image

    if abs(factor) < 1e-8:
        return im
    hsv = np.array(im.convert("HSV"), dtype=np.uint8)
    shift = np.uint8(int(factor * 255)) if factor >= 0 else np.uint8(256 + int(factor * 255))
    hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraparound == hue circle
    return Image.fromarray(hsv, "HSV").convert("RGB")


class ImagePreprocessor:
    """Decode + resize + crop (+ augment) one image to a fixed-shape uint8
    HWC crop. ``mean``/``std`` (the encoder's stats) are applied on the
    card, folded into the patch embed; they are kept for the model."""

    def __init__(
        self,
        height: int = 224,
        width: int = 224,
        mean: Sequence[float] = CLIP_MEAN,
        std: Sequence[float] = CLIP_STD,
        is_train: bool = False,
        augment: bool = False,
        aug_scale: Tuple[float, float] = (0.8, 1.0),
        color_jitter: Tuple[float, float, float, float] = (0.1, 0.1, 0.1, 0.05),
        output: str = "uint8_hwc",
        seed: int = 0,
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
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.is_train = is_train
        self.augment = augment and is_train
        self.aug_scale = aug_scale
        self.jitter = color_jitter
        self.rng = np.random.default_rng(seed)

    def _train_transform(self, im) -> np.ndarray:
        from PIL import Image, ImageEnhance

        w, h = im.size
        top, left, ch, cw = _sample_rrc_box(self.rng, h, w, self.aug_scale)
        im = im.crop((left, top, left + cw, top + ch))
        im = im.resize((self.W, self.H), Image.BILINEAR)
        if self.rng.random() < 0.5:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        b, c, s, hue = self.jitter
        for op in self.rng.permutation(4):
            if op == 0 and b > 0:
                im = ImageEnhance.Brightness(im).enhance(self.rng.uniform(1 - b, 1 + b))
            elif op == 1 and c > 0:
                im = ImageEnhance.Contrast(im).enhance(self.rng.uniform(1 - c, 1 + c))
            elif op == 2 and s > 0:
                im = ImageEnhance.Color(im).enhance(self.rng.uniform(1 - s, 1 + s))
            elif op == 3 and hue > 0:
                im = _adjust_hue(im, self.rng.uniform(-hue, hue))
        return np.asarray(im, np.uint8)

    def zero_output(self) -> np.ndarray:
        return np.zeros((self.H, self.W, 3), np.uint8)

    def process_pil(self, im) -> np.ndarray:
        im = im.convert("RGB")
        if self.augment:
            return self._train_transform(im)
        im = resize_shortest_edge(im, self.H)
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
