"""Make the committed JPEG fixtures of ``testdata/jpeg/`` with PIL, from a
seed, and the PIL pipeline's centre crops of each at 224 and 384 px:

    python -m multimodal_content_moderation_tpu_torch.testdata.make_jpegs

The images are smooth colour fields with a few shapes and mild noise, like
photographs; ``tests/test_torch_jpeg_fixtures.py`` checks that the
committed crops still equal PIL's decode of the committed files.
"""

from __future__ import annotations

import io

import numpy as np

from multimodal_content_moderation_tpu_torch.testdata import CROP_SIZES, JPEG_DIR

# name: (height, width, grey, subsampling (0 = 4:4:4, 2 = 4:2:0), quality,
# progressive)
FIXTURES = {
    "rgb420_240x320": (240, 320, False, 2, 85, False),
    "rgb444_517x301": (517, 301, False, 0, 70, False),
    "grey_193x257": (193, 257, True, 2, 85, False),
    "rgb420_small_97x203": (97, 203, False, 2, 90, False),
    "rgb420_456x610": (456, 610, False, 2, 60, False),
    "progressive_300x400": (300, 400, False, 2, 75, True),
}
CORRUPT = "corrupt"


def _image(g: np.random.Generator, h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        a, b, p = g.uniform(-1, 1, 3)
        img[..., c] = 128 + 90 * np.sin(a * x / w * 3 + b * y / h * 3 + p * 3)
    for _ in range(4):  # a few discs of flat colour
        cy, cx, r = g.uniform(0, h), g.uniform(0, w), g.uniform(0.05, 0.3) * min(h, w)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = g.uniform(0, 255, 3)
    img += g.normal(0, 1.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_crop(data: bytes, size: int) -> np.ndarray:
    """The ``pil`` backend's eval crop: decode, RGB, shortest-edge bilinear
    resize, centre crop."""
    from PIL import Image

    from multimodal_content_moderation_tpu_torch.data.images import (
        center_crop,
        resize_shortest_edge,
    )

    with Image.open(io.BytesIO(data)) as im:
        im = resize_shortest_edge(im.convert("RGB"), size)
        return center_crop(np.asarray(im, np.uint8), size, size)


def main() -> None:
    from PIL import Image

    g = np.random.default_rng(0)
    JPEG_DIR.mkdir(parents=True, exist_ok=True)
    for name, (h, w, grey, sub, q, prog) in FIXTURES.items():
        im = Image.fromarray(_image(g, h, w))
        if grey:
            im = im.convert("L")
        buf = io.BytesIO()
        kw = {} if grey else {"subsampling": sub}
        im.save(buf, "JPEG", quality=q, progressive=prog, **kw)
        data = buf.getvalue()
        (JPEG_DIR / f"{name}.jpg").write_bytes(data)
        np.savez_compressed(JPEG_DIR / f"{name}.npz",
                            **{f"crop{s}": pil_crop(data, s) for s in CROP_SIZES})
    # SOI, then bytes that are no JPEG segment: every decoder refuses it
    bad = b"\xff\xd8" + g.integers(0, 256, 510, dtype=np.uint8).tobytes()
    (JPEG_DIR / f"{CORRUPT}.jpg").write_bytes(bad)
    empty = np.zeros((0, 0, 3), np.uint8)
    np.savez_compressed(JPEG_DIR / f"{CORRUPT}.npz", **{f"crop{s}": empty for s in CROP_SIZES})


if __name__ == "__main__":
    main()
