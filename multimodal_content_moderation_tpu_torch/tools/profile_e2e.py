"""Wall-clock attribution of the end-to-end evaluation loop (the JAX
package's ``tools/profile_e2e.py``): the pipeline of
``models/fast_infer.evaluate_logits_u8`` over the CSV of ``bench_torch.py``'s
end-to-end slice (the committed JPEG fixtures in turn), with its stages
timed on the host clock:

  producer thread: cache read or batch assembly | patch extraction |
                   the queue-put wait
  consumer thread: the engine call (the host-to-card copy of the batch
                   included) | the logits fetch (two batches behind, as
                   evaluate_logits_u8 reads them) | the queue-get wait

The first pass decodes and fills the pixel cache; the warm passes read it.
Prints one JSON line with each stage's seconds and the rows/s.
"""

from __future__ import annotations

import argparse
import queue
import shutil
import tempfile
import threading
import time

from multimodal_content_moderation_tpu_torch.tools import _common as c
from multimodal_content_moderation_tpu_torch.tools import bench

DECODE_WORKERS = 8  # evaluate_logits_u8's default


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


def instrumented_pass(engine, ds, batch: int, rows: int) -> dict:
    stats = {
        "producer_batch_assembly_s": 0.0,
        "producer_patch_extract_s": 0.0,
        "producer_qput_wait_s": 0.0,
        "consumer_qget_wait_s": 0.0,
        "consumer_dispatch_s": 0.0,
        "consumer_fetch_s": 0.0,
    }
    q: queue.Queue = queue.Queue(maxsize=2)
    end = object()

    def producer():
        it = ds.batches(batch, pad_to_batch=True, num_workers=DECODE_WORKERS)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            stats["producer_batch_assembly_s"] += t1 - t0
            b.pop("_valid")
            b.pop("labels")
            patches = engine.patches_from_hwc(b.pop("pixel_values"))
            t2 = time.perf_counter()
            stats["producer_patch_extract_s"] += t2 - t1
            q.put((b, patches))
            stats["producer_qput_wait_s"] += time.perf_counter() - t2
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    outs = []
    n_fetch = 0
    t_pass = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        item = q.get()
        t1 = time.perf_counter()
        stats["consumer_qget_wait_s"] += t1 - t0
        if item is end:
            break
        b, patches = item
        outs.append(engine(b["input_ids"], b["attention_mask"], patches, b["text_present"],
                           b["image_present"]))
        t2 = time.perf_counter()
        stats["consumer_dispatch_s"] += t2 - t1
        if len(outs) > 2:
            outs.pop(0).cpu().numpy()
            n_fetch += 1
            stats["consumer_fetch_s"] += time.perf_counter() - t2
    t0 = time.perf_counter()
    for o in outs:
        o.cpu().numpy()
        n_fetch += 1
    stats["consumer_fetch_s"] += time.perf_counter() - t0
    stats["total_s"] = time.perf_counter() - t_pass
    stats["rows_per_s"] = rows / stats["total_s"]
    stats["n_fetches"] = n_fetch
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
        cold = instrumented_pass(engine, ds, args.batch, args.rows)
        warm = [instrumented_pass(engine, ds, args.batch, args.rows) for _ in range(args.passes)]
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
