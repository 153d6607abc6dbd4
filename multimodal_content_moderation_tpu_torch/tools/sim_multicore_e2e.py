"""Multi-producer end-to-end scaling simulation (the JAX package's
``tools/sim_multicore_e2e.py``).

The claim "~N decode cores saturate the card" is arithmetic until it is
measured. This measures the delivered-throughput curve: all host batches
are pre-staged in RAM (token ids with EOS at 30, uint8 crops cut into
wire-format patch rows), and a producer thread delivers each batch into a
``Queue(maxsize=2)`` after sleeping ``B / rate / cores``, where ``rate`` is
one core's JPEG decode rate: a rate model of an N-core decode farm feeding
the dispatch loop of ``models/fast_infer.evaluate_logits_u8`` (a bounded
queue, two batches in flight, then a fetch).

The model is the CLIP ViT-B/32 fusion classifier in bf16 with the
``patch_embed_u8`` and ``attention_nhd`` kernels, through
``FastInferenceEngine`` (random weights from ``--seed``). ``--decode_rate
0`` (the default) measures the single-thread ``native_scaled`` decode rate
on the committed JPEG fixtures in this process, with ``bench_input``'s
decode function (libjpeg, or nvJPEG where the machine has no libjpeg).

Output: rows/s for each ``--cores`` count (median, min and max of three
runs); ``0`` is no decode limit, the dispatch ceiling measured. The knee of
the curve is where decode stops being the bottleneck. Prints one JSON line.

    python -m multimodal_content_moderation_tpu_torch.tools.sim_multicore_e2e
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np

from multimodal_content_moderation_tpu_torch.tools import _common as c
from multimodal_content_moderation_tpu_torch.tools import bench, bench_input

SEQ = 77
EOS_POS = 30
RUNS = 3  # runs per core count
TINY = {"batch": 4, "n_batches": 3}
DECODE_IMAGES = {"full": 256, "tiny": 12}  # images decoded to measure the rate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--batch", type=int, default=None, help="default 144")
    ap.add_argument("--n_batches", type=int, default=None, help="default 12")
    ap.add_argument("--cores", default="1,2,4,8,16,0",
                    help="0 = no decode limit (the dispatch ceiling)")
    ap.add_argument("--decode_rate", type=float, default=0.0,
                    help="one core's decode rate in images/s (0 = measure it here)")
    args = ap.parse_args(argv)
    full = {"batch": bench.BATCH, "n_batches": 12}
    for key, value in (TINY if args.tiny else full).items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def host_batch(engine, seed: int, batch: int) -> dict:
    """One staged host batch (JAX's ``host_batch``): ids from
    ``default_rng(seed)`` in [1, vocab - 2) with EOS at 30, then uint8
    crops from the same generator, cut into patch rows."""
    text = engine.model.clip_config.text
    g = np.random.default_rng(seed)
    ids = g.integers(1, text.vocab_size - 2, size=(batch, SEQ)).astype(np.int32)
    ids[:, EOS_POS] = text.eos_token_id
    return {
        "input_ids": ids,
        "attention_mask": np.ones((batch, SEQ), np.int32),
        "patches": engine.patches_from_hwc(c.crops(g, batch, engine.model.image_size)),
        "text_present": np.ones((batch,), np.float32),
        "image_present": np.ones((batch,), np.float32),
    }


def measure_decode_rate(n: int, size: int) -> float:
    """Images/s of one thread decoding, resizing and cropping the committed
    JPEG fixtures in turn (``native_scaled``), after a warm pass."""
    fn = dict(bench_input.backends(size)).get("native_scaled")
    if fn is None:
        raise RuntimeError("sim: the native JPEG decoder is not available here; pass "
                           "--decode_rate")
    fixtures = list(c.fixture_jpegs().values())
    blobs = [fixtures[i % len(fixtures)] for i in range(n)]
    for blob in blobs[:len(fixtures)]:
        if fn(blob) is None:
            raise RuntimeError("sim: a fixture did not decode")
    t0 = time.perf_counter()
    for blob in blobs:
        fn(blob)
    return n / (time.perf_counter() - t0)


def call(engine, b):
    return engine(b["input_ids"], b["attention_mask"], b["patches"], b["text_present"],
                  b["image_present"])


def simulate(engine, staged, n_cores: int, batch_decode_s: float):
    """(rows/s, outputs): the staged batches through the engine behind a
    producer limited to ``n_cores``' decode rate (0: no limit), two batches
    in flight; ``outputs`` are the fetched logits in batch order."""
    q: queue.Queue = queue.Queue(maxsize=2)
    end = object()

    def producer():
        for b in staged:
            if n_cores:
                time.sleep(batch_decode_s / n_cores)
            q.put(b)
        q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    pending, outs = [], []
    t0 = time.perf_counter()
    while True:
        item = q.get()
        if item is end:
            break
        pending.append(call(engine, item))
        if len(pending) > 2:
            outs.append(pending.pop(0).cpu().numpy())
    outs.extend(p.cpu().numpy() for p in pending)
    rate = len(staged) * len(staged[0]["input_ids"]) / (time.perf_counter() - t0)
    thread.join()
    return rate, outs


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = c.open_device(args.device, "sim-multicore")
    engine = bench.make_engine(bench.build_model(args.tiny, args.seed, device))
    B = args.batch
    staged = [host_batch(engine, c.sub_seed(args.seed, i), B) for i in range(args.n_batches)]
    measured = not args.decode_rate
    per_core_rate = args.decode_rate or measure_decode_rate(
        DECODE_IMAGES["tiny" if args.tiny else "full"], engine.model.image_size)
    batch_decode_s = B / per_core_rate
    # the engine's own logits for the staged batches (the first call builds
    # the kernels), which every run's outputs must equal
    want = [call(engine, b).cpu().numpy() for b in staged]
    counts = c.launch_counter()
    curve, diff = [], 0.0
    for n_cores in [int(x) for x in args.cores.split(",")]:
        rates = []
        for _ in range(RUNS):
            rate, outs = simulate(engine, staged, n_cores, batch_decode_s)
            if len(outs) != len(want):
                raise RuntimeError(f"sim: {len(outs)} outputs for {len(want)} batches")
            diff = max([diff] + [float(np.abs(o - w).max()) for o, w in zip(outs, want)])
            rates.append(rate)
        s = c.spread(rates)
        curve.append({"cores": n_cores or "inf", "rows_per_s": s["median"], "min": s["min"],
                      "max": s["max"]})
        c.warn("sim", f"cores={n_cores or 'inf'}: {s['median']:.1f} rows/s")
    return c.emit({
        "batch": B,
        "per_core_decode_rate_img_s": per_core_rate,
        "decode_rate_measured": measured,
        "curve": curve,
        "n_batches": args.n_batches,
        "runs_per_core_count": RUNS,
        "outputs_max_abs_diff_vs_engine": diff,
        "device": c.card_line(device),
        "launches": counts(),
        "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
