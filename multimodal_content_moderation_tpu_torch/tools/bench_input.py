"""Host input-pipeline benchmark: JPEG decode + resize + crop in images/s
over a thread pool (the JAX package's ``tools/bench_input.py``).

For each image backend this machine has: ``native_jpeg`` (the native
library's fused decode at full size + resize + crop) and ``native_scaled``
(the decode scaled down by M/8 first), on libjpeg or, where the machine has
no libjpeg, nvJPEG on the card; ``native`` (PIL decode + the native resize)
and ``pil`` only where PIL imports. The input is the committed JPEG fixtures
in turn. Prints one JSON line; ``decoder`` names what decoded.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import io
import time

import numpy as np

from multimodal_content_moderation_tpu_torch.tools import _common as c


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--n", type=int, default=None, help="images a timed run (default 512)")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--workers", type=int, default=None, help="threads (default 16)")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = 12 if args.tiny else 512
    if args.workers is None:
        args.workers = 2 if args.tiny else 16
    return args


def backends(size: int):
    """[(name, fn(jpeg bytes) -> uint8 crop)] of the backends found here."""
    from multimodal_content_moderation_tpu_torch.data import native

    out = []
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        from multimodal_content_moderation_tpu_torch.data.images import (
            center_crop,
            resize_shortest_edge,
        )

        def work_pil(blob):
            im = Image.open(io.BytesIO(blob)).convert("RGB")
            return center_crop(np.asarray(resize_shortest_edge(im, size), np.uint8), size, size)

        out.append(("pil", work_pil))
        if native.available():
            out.append(("native", lambda blob: native.resize_center_crop(
                np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"), np.uint8), size)))
    if native.jpeg_available():
        out.append(("native_jpeg",
                    lambda blob: native.decode_jpeg_resize_crop(blob, size, scaled=False)))
        out.append(("native_scaled",
                    lambda blob: native.decode_jpeg_resize_crop(blob, size, scaled=True)))
    return out


def main(argv=None) -> dict:
    from multimodal_content_moderation_tpu_torch.data import native

    args = parse_args(argv)
    device = c.open_device(args.device, "bench-input")
    fixtures = list(c.fixture_jpegs().values())
    blobs = [fixtures[i % len(fixtures)] for i in range(args.n)]
    counts = c.launch_counter()
    results = {}
    found = backends(args.size)
    for name, fn in found:
        for w in sorted({1, args.workers}):
            with cf.ThreadPoolExecutor(max_workers=w) as pool:
                warm = list(pool.map(fn, blobs[:32]))
                if any(x is None or x.shape != (args.size, args.size, 3) for x in warm):
                    raise RuntimeError(f"{name}: a fixture did not decode")
                t0 = time.perf_counter()
                list(pool.map(fn, blobs))
                dt = time.perf_counter() - t0
            results[f"{name}_w{w}"] = args.n / dt
    return c.emit({
        "metric": "host_decode_resize_images_per_sec", **results,
        "decoder": native.jpeg_decoder(), "backends": [name for name, _ in found],
        "images": f"the {len(fixtures)} committed JPEG fixtures (testdata/jpeg) in turn",
        "n": args.n, "size": args.size, "host_cpus": c.host_cpus(),
        "device": c.card_line(device), "launches": counts(), "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
