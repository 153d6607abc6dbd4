"""Host-side image decode + geometric preprocessing.

The eval path reproduces the reference's torchvision pipeline on PIL inputs
exactly:

    Resize(shortest_edge=H, bilinear antialias) -> CenterCrop(H, W)
    -> ToTensor -> Normalize(mean, std)

The train path (``augment``) is torchvision's RandomResizedCrop, horizontal
flip and ColorJitter, drawn from a numpy ``Generator`` in the same order as
the JAX package's ``data/images.py``, so one seed gives the same crops.

The host produces either raw uint8 HWC crops (``output="uint8_hwc"``, the
uint8 wire: the normalisation is folded into the patch embed on the card,
``models/u8wire.py``) or normalised float32 CHW arrays (``"float_nchw"``, the
pixel path: ``normalize_crop``, which needs no PIL). Missing or corrupt
images degrade to zeros with presence flag 0.0.

Decode backends:
- ``pil``: PIL decode and resize (the reference).
- ``native``: one call into the port's C++ library (``data/native.py``):
  JPEG decode, shortest-edge resize with PIL's own arithmetic, centre crop,
  without the GIL. With libjpeg the crop is bit-identical to ``pil``'s; on a
  machine without libjpeg the decoder is nvJPEG.
- ``native_scaled``: ``native`` with libjpeg's DCT-domain M/8 downscale
  (near-exact, cheaper on large images).
A ``native*`` backend needs no PIL for JPEGs: other formats go to PIL where
it is installed, and degrade to zeros where it is not, as an undecodable
image does. A ``native*`` backend whose library cannot be built, or has no
JPEG decoder, raises when the preprocessor is made.

PIL is imported where an image is decoded, so this module (and the stats
and ``normalize_crop`` below) import on a machine without it.
"""

from __future__ import annotations

import base64
import io
import math
import os
from typing import Sequence, Tuple

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

# a 16x16 JPEG (PIL, quality 50): warmup() decodes it to initialise the
# native decoder before the first request
_WARM_JPEG = base64.b64decode(
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDABALDA4MChAODQ4SERATGCgaGBYWGDEjJR0oOjM9PDkz"
    "ODdASFxOQERXRTc4UG1RV19iZ2hnPk1xeXBkeFxlZ2P/2wBDARESEhgVGC8aGi9jQjhCY2NjY2Nj"
    "Y2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2NjY2P/wAARCAAQABADASIA"
    "AhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQA"
    "AAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3"
    "ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWm"
    "p6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEA"
    "AwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSEx"
    "BhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElK"
    "U1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3"
    "uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwAlllYs"
    "rbQoTfKhRgMEehORgAc9QPyqON8KZ8kmQF9qoNx5OTg9ccAkevoBTmR5r1goQB18xiEIAB4JBHXP"
    "Yc8le+aYd7XZBwwCNgqQWxnAYkcZ4znI+72xy5L3lrr+v9X/AAHZ25Vu/wCv6/E//9k="
)


def normalize_crop(crop_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC crop -> normalised float32 CHW: ``(crop / 255 - mean) /
    std`` in fp32, in that order (the JAX package's ``normalize``, bit for
    bit), then transposed."""
    x = crop_u8.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


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
    """Decode + resize + crop (+ augment) one image to a fixed-shape array:
    a uint8 HWC crop (``output="uint8_hwc"``; ``mean``/``std``, the
    encoder's stats, are then applied on the card, folded into the patch
    embed) or a normalised float32 CHW array (``"float_nchw"``)."""

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
        if output not in ("uint8_hwc", "float_nchw"):
            raise ValueError(f"image output {output!r}: want 'uint8_hwc' or 'float_nchw'")
        if backend not in ("pil", "native", "native_scaled"):
            raise ValueError(f"image backend {backend!r}: want pil, native or native_scaled")
        if backend != "pil":
            from multimodal_content_moderation_tpu_torch.data import native

            native.load()  # raises where the library cannot be built
            if not native.jpeg_available():
                raise RuntimeError(
                    f"image backend {backend!r}: the native library was built without a "
                    "JPEG decoder (neither jpeglib.h nor the CUDA toolkit's nvjpeg.h "
                    "was found); use 'pil'"
                )
        self.backend = backend
        self.H, self.W = height, width
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.is_train = is_train
        self.augment = augment and is_train
        self.aug_scale = aug_scale
        self.jitter = color_jitter
        self.output = output
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

    def warmup(self) -> None:
        """Initialise the native JPEG decoder (nvJPEG creates its handle and
        a decoder state on its first call); nothing for ``pil``."""
        if self.backend != "pil":
            self.process_bytes(_WARM_JPEG)

    def zero_output(self) -> np.ndarray:
        if self.output == "uint8_hwc":
            return np.zeros((self.H, self.W, 3), np.uint8)
        return np.zeros((3, self.H, self.W), np.float32)

    def _finish(self, crop: np.ndarray) -> np.ndarray:
        return crop if self.output == "uint8_hwc" else normalize_crop(crop, self.mean, self.std)

    def process_pil(self, im) -> np.ndarray:
        im = im.convert("RGB")
        if self.augment:
            crop = self._train_transform(im)
        elif self.backend != "pil" and self.H == self.W:
            from multimodal_content_moderation_tpu_torch.data import native

            crop = native.resize_center_crop(np.asarray(im, np.uint8), self.H)
        else:
            im = resize_shortest_edge(im, self.H)
            crop = center_crop(np.asarray(im, np.uint8), self.H, self.W)
        return self._finish(crop)

    def process_bytes(self, data: bytes) -> Tuple[np.ndarray, float]:
        """Encoded image bytes -> (array, present_flag). With a ``native*``
        backend a JPEG takes one native call (decode, resize, crop); other
        bytes go to PIL, or, where PIL is not installed, degrade to zeros,
        as bytes that do not decode do. A fault of the native decoder
        itself (memory, the card) raises."""
        if self.backend != "pil" and not self.augment and self.H == self.W:
            from multimodal_content_moderation_tpu_torch.data import native

            crop = native.decode_jpeg_resize_crop(
                data, self.H, scaled=self.backend == "native_scaled"
            )
            if crop is not None:
                return self._finish(crop), 1.0
            try:
                from PIL import Image
            except ImportError:
                return self.zero_output(), 0.0
        else:
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
