"""Host-to-card transfer bandwidth for the u8 wire (the JAX package's
``tools/bench_transfer.py``): MB/s of one copy of 1, 2, 4 and 8
batch-equivalents of B=144 uint8 patch rows (``49 * 3072`` bytes a sample,
CLIP ViT-B/32), from pinned memory (what ``training/loop.prefetch_to_device``
and ``evaluate_logits_u8`` copy from) and from pageable memory, and the
pattern of the eval loop: 4 copies of one batch each, back to back. After
every copy a reduction on the card reads every byte, and the time ends in a
synchronise (host clock). Fresh contents for every repetition. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--batch", type=int, default=None, help="default 144")
    ap.add_argument("--sample_bytes", type=int, default=49 * 3072,
                    help="u8 wire bytes a sample (CLIP patch32: 49 rows x 3072)")
    ap.add_argument("--multiples", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 2 if args.tiny else 144
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "bench-transfer")
    pinned_ok = device.type == "cuda"
    per_batch = args.batch * args.sample_bytes
    g = np.random.default_rng(args.seed)

    def host(nbytes: int, pinned: bool) -> torch.Tensor:
        t = torch.from_numpy(g.integers(0, 256, size=(nbytes,), dtype=np.uint8))
        return t.pin_memory() if pinned else t

    def copy_and_touch(h: torch.Tensor):
        return h.to(device, non_blocking=True).sum(dtype=torch.int64)

    def rate(hosts) -> float:
        """MB/s of copying ``hosts`` one after another, each touched."""
        c.sync(device)
        t0 = time.perf_counter()
        out = [copy_and_touch(h) for h in hosts]
        c.sync(device)
        dt = time.perf_counter() - t0
        del out
        return sum(h.numel() for h in hosts) / dt / 1e6

    copy_and_touch(host(1024, pinned_ok))  # warm: the first launch, the pinned pool
    counts = c.launch_counter()
    rows = []
    for mult in [int(m) for m in args.multiples.split(",")]:
        nbytes = per_batch * mult
        row = {"mult": mult, "mb": nbytes / 1e6}
        for kind, pinned in (("", pinned_ok), ("pageable_", False)):
            rates = [rate([host(nbytes, pinned)]) for _ in range(args.reps)]
            s = c.spread(rates)
            row.update({f"{kind}mb_per_s": s["median"], f"{kind}mb_per_s_min": s["min"],
                        f"{kind}mb_per_s_max": s["max"],
                        f"{kind}samples_per_s_equiv": s["median"] * 1e6 / args.sample_bytes})
        rows.append(row)
    seq = {}
    for kind, pinned in (("", pinned_ok), ("pageable_", False)):
        med = float(np.median([rate([host(per_batch, pinned) for _ in range(4)])
                               for _ in range(args.reps)]))
        seq[f"sequential_4x_per_batch_{kind}mb_per_s"] = med
        seq[f"sequential_{kind}samples_per_s_equiv"] = med * 1e6 / args.sample_bytes
    return c.emit({
        "batch": args.batch,
        "per_batch_mb": per_batch / 1e6,
        "single_put": rows,
        **seq,
        "pinned": pinned_ok,
        "note": "keys without 'pageable' copy from pinned memory" if pinned_ok else
                "no card: both copies are from pageable memory and move nothing",
        "device": c.card_line(device), "launches": counts(), "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
