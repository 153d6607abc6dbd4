"""Wall-clock attribution of the end-to-end evaluation loop (the JAX
package's ``tools/profile_e2e.py``): ``models/fast_infer.evaluate_logits_u8``
itself over the CSV of ``bench_torch.py``'s end-to-end slice (the committed
JPEG fixtures in turn), each pass inside ``utils/profiling.recording()``,
its stages the sums of the pipeline's own spans:

  producer thread: cache read or batch assembly (``prep.load``) | patch
                   extraction (``prep.patches``) | buckets (``prep.bucket``)
                   | host tensors and pinning (``prep.pin``) | the
                   queue-put wait (``pipeline.put_wait``)
  consumer thread: the engine call (``engine.call``: the host-to-card copy
                   of the batch and the forward's launches) | the logits
                   fetch two batches behind (``score.readback``) | the
                   queue-get wait (``score.wait_batch``)

The first pass decodes and fills the pixel cache; the warm passes read it.
Prints one JSON line with each stage's seconds and the rows/s.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from multimodal_content_moderation_tpu_torch.models.fast_infer import evaluate_logits_u8
from multimodal_content_moderation_tpu_torch.tools import _common as c
from multimodal_content_moderation_tpu_torch.tools import bench
from multimodal_content_moderation_tpu_torch.utils.profiling import recording

DECODE_WORKERS = 8  # evaluate_logits_u8's default
# each stage's key and the span it sums
STAGES = {
    "producer_batch_assembly_s": "prep.load",
    "producer_patch_extract_s": "prep.patches",
    "producer_bucket_s": "prep.bucket",
    "producer_pin_s": "prep.pin",
    "producer_qput_wait_s": "pipeline.put_wait",
    "consumer_qget_wait_s": "score.wait_batch",
    "consumer_dispatch_s": "engine.call",
    "consumer_fetch_s": "score.readback",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--batch", type=int, default=None, help="default 144")
    ap.add_argument("--rows", type=int, default=None, help="CSV rows (default 1536)")
    ap.add_argument("--passes", type=int, default=3, help="warm passes")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 4 if args.tiny else bench.BATCH
    if args.rows is None:
        args.rows = 8 if args.tiny else bench.E2E_ROWS
    return args


def recorded_pass(engine, ds, batch: int, rows: int) -> dict:
    with recording() as rec:
        evaluate_logits_u8(engine, ds, batch, num_workers=DECODE_WORKERS)
    stats = {key: rec.seconds(span) for key, span in STAGES.items()}
    stats["total_s"] = rec.seconds("score.evaluate")
    stats["rows_per_s"] = rows / stats["total_s"]
    stats["n_fetches"] = len(rec.named("score.readback"))
    return stats


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "profile-e2e")
    engine = bench.make_engine(bench.build_model(args.tiny, args.seed, device))
    seq = engine.model.clip_config.text.max_positions
    tmp = tempfile.mkdtemp(prefix="profile_e2e_")
    try:
        csv_path = c.write_e2e_csv(tmp, args.rows)
        ds = c.e2e_dataset(tmp, csv_path, seq, engine.model.image_size, cache=True)
        counts = c.launch_counter()
        cold = recorded_pass(engine, ds, args.batch, args.rows)
        warm = [recorded_pass(engine, ds, args.batch, args.rows) for _ in range(args.passes)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return c.emit({
        "batch": args.batch,
        "rows": args.rows,
        "cold": cold,
        "warm_best": min(warm, key=lambda s: s["total_s"]),
        "warm_all_rows_per_s": [s["rows_per_s"] for s in warm],
        "host_cpus": c.host_cpus(),
        "device": c.card_line(device), "launches": counts(), "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
