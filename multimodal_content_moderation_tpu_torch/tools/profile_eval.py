"""Profile of the fast-eval path: the staged CLIP ViT-B/32 engine loop that
``bench_torch.py`` times, inside ``utils/profiling.trace`` (torch.profiler,
host and CUDA activity), which writes a Chrome trace (Perfetto and
``chrome://tracing`` read it) into ``--out`` (the JAX package's
``tools/profile_eval.py``).

    python -m multimodal_content_moderation_tpu_torch.tools.profile_eval --batches 8

The JSON line carries the trace files and the device time per batch summed
by kernel group (the five hand kernels, cuBLAS GEMMs, dtype casts and
copies, LayerNorm, other elementwise), with the device's busy time against
the wall time; "not measured" where the profiler reports no device time.
"""

from __future__ import annotations

import argparse
import os

import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c
from multimodal_content_moderation_tpu_torch.tools import bench
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate


def parse_args(argv=None) -> argparse.Namespace:
    from multimodal_content_moderation_tpu_torch.utils.compile_cache import REPO_BUILD

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--out", default=str(REPO_BUILD / "profile_eval"),
                    help="trace directory (default build/profile_eval in the checkout)")
    ap.add_argument("--batch", type=int, default=None, help="default 144")
    ap.add_argument("--batches", type=int, default=None, help="batches traced (default 8)")
    ap.add_argument("--seq", type=int, default=bench.SEQ,
                    help=f"text width: {bench.SEQ}, or {bench.BUCKET} for the seq-32 bucket "
                    "that bench_torch.py's value_bucketed times")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 4 if args.tiny else bench.BATCH
    if args.batches is None:
        args.batches = 2 if args.tiny else 8
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "profile-eval")
    engine = bench.make_engine(bench.build_model(args.tiny, args.seed, device))
    with annotate("stage_inputs"):
        ids, patches = bench.staged_inputs(engine, args.batch, args.batches, args.seed,
                                           width=args.seq)
        ids = [torch.from_numpy(x).to(device) for x in ids]
        patches = [torch.from_numpy(p).to(device) for p in patches]
        mask = torch.ones(args.batch, args.seq, dtype=torch.int32, device=device)
        ones = torch.ones(args.batch, device=device)

    def loop():
        with annotate("eval_loop"):
            for i, x in enumerate(ids):
                engine(x, mask, patches[i % bench.N_STAGED], ones, ones)

    loop()  # warm outside the trace, so that it shows the steady state
    c.sync(device)
    counts = c.launch_counter()
    before = set(os.listdir(args.out)) if os.path.isdir(args.out) else set()
    breakdown = c.device_time_breakdown(loop, args.batches, trace_dir=args.out)
    files = [os.path.join(args.out, n) for n in sorted(set(os.listdir(args.out)) - before)]
    return c.emit({
        "metric": "eval_device_time_by_kernel_group",
        "trace_dir": args.out,
        "trace_files": len(files),
        "trace_paths": files,
        "largest_file": max((os.path.getsize(f) for f in files), default=0),
        "device_time": breakdown,
        "batch": args.batch, "batches": args.batches, "seq": args.seq,
        "attention": "pallas",
        "device": c.card_line(device), "launches": counts(), "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
