"""The scoring pipeline's own spans and counters (``utils/profiling`` in the
port) beside a profiled pass, at a scoring cell's own size, in one process:

    python benchmark/tools/span_split.py --workload <score cell> --seed <n> \\
        [--seconds 51] [--out <file>]

- set-up as the cell's runs: weights and rows drawn from the seed, a cold
  pass that fills the pixel cache;
- a window of ``--seconds`` of whole passes, by turns with recording off and
  on: the rows a second of each (what recording costs), whether the logits
  of the two kinds are equal bit for bit, and the span metrics of the
  recorded passes (``harness/program_spans.window_split``);
- one more pass, recorded and profiled as a traced run's slice is
  (``trace.profiled``): the device's idle gaps labelled by what the
  launching thread was doing (``program_spans.slice_split``), the idle share
  as ``readers.idle_share`` reads it, the pass's counters, each span's mean
  in the window and in the slice, and how far each span's start, put on the
  trace's clock by the ``bench-clock`` mark, lies from its own
  ``record_function`` range.

Prints one JSON line and writes it to ``--out``. Without a card
(``--device cpu``) the slice is left out."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import env, spec  # noqa: E402


def scoring_pass(cell, seed: int, device, tmp: str):
    """The cell's set-up as ``harness/score.run`` makes it; returns a
    function that runs one whole pass and returns its logits."""
    import torch

    from benchmark.harness import assets, port, traffic, weights
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        FastInferenceEngine,
        evaluate_logits_u8,
    )

    cfg, mix = cell.config, cell.traffic
    recipe = cfg["recipe"]["eval"]
    classes = cfg["head"]["class_names"]
    n, B, workers = int(mix["rows"]), int(mix["batch"]), int(mix["num_workers"])
    enc = assets.encoder_dir(cfg)
    data = traffic.rows(seed, n, mix, classes)
    csv_path = traffic.write_csv(os.path.join(tmp, "rows.csv"), data, classes)
    port.build_kernels(["patch_embed_u8", "attention_nhd"], device)
    wdtype = torch.bfloat16 if recipe["precision"] == "bf16_fast" else torch.float32
    model = port.fusion_model(cfg, weights.draw(cfg, seed, device, wdtype), device, recipe,
                              train=False)
    engine = FastInferenceEngine(model, cfg["image"]["mean"], cfg["image"]["std"])
    ds = port.dataset(cfg, csv_path, assets.JPEG_DIR, enc, os.path.join(tmp, "pixels"), recipe)

    def one_pass():
        return evaluate_logits_u8(engine, ds, B, num_workers=workers,
                                  seq_buckets=tuple(mix["seq_buckets"]))[0]

    return one_pass


def _mean_ms(spans):
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    return {k: statistics.fmean(v) for k, v in by.items()}


def _clock_summary(errors, counts):
    """The spans' clock errors: how many were matched, the median and
    largest error by size, the median signed error, its drift (us a second
    after the mark, least squares) and the matched counts by name."""
    import numpy as np

    out = {"n": len(errors), "by_name": counts}
    if errors:
        e = np.asarray(errors)
        out.update(median=float(np.median(np.abs(e[:, 0]))), max=float(np.abs(e[:, 0]).max()),
                   signed_median=float(np.median(e[:, 0])),
                   drift_us_per_s=float(np.polyfit(e[:, 1], e[:, 0], 1)[0]) if len(e) > 1
                   else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--benchmark-json", default=None)
    args = ap.parse_args(argv)
    env.set_cache_dirs(spec.ROOT)
    env.hide_forbidden()
    cell = spec.load_cell(args.workload, args.benchmark_json)
    if cell.mode != "score":
        raise SystemExit(f"{args.workload}: a {cell.mode} cell; this tool reads scoring")

    import numpy as np
    import torch

    from benchmark.harness import program_spans, readers, trace
    from multimodal_content_moderation_tpu_torch.utils.profiling import recording

    if args.device == "cuda":
        device, card = env.card(cell.chips)
    else:
        device, card = torch.device("cpu"), "cpu"
    line = {"workload": args.workload, "seed": args.seed, "device": card,
            "card": env.power_limit() if device.type == "cuda" else "cpu"}
    with tempfile.TemporaryDirectory(prefix="span-split-") as tmp:
        one_pass = scoring_pass(cell, args.seed, device, tmp)
        one_pass()  # the cold pass
        rows = int(cell.traffic["rows"])
        pass_s = {"off": [], "on": []}
        first, window, counters = {}, [], {}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds or len(pass_s["on"]) < 1:
            kind = "on" if len(pass_s["off"]) > len(pass_s["on"]) else "off"
            t = time.perf_counter()
            if kind == "on":
                with recording() as rec:
                    out = one_pass()
                window += rec.spans
                for k, v in rec.counters.items():
                    counters[k] = counters.get(k, 0) + v
            else:
                out = one_pass()
            pass_s[kind].append(time.perf_counter() - t)
            first.setdefault(kind, out)
        line["pass_s"] = pass_s
        line["rows_per_s"] = {k: rows * len(v) / sum(v) for k, v in pass_s.items()}
        line["recording_cost"] = 1 - line["rows_per_s"]["on"] / line["rows_per_s"]["off"]
        line["logits_equal"] = bool(np.array_equal(first["off"], first["on"]))
        line["window"] = program_spans.window_split(window, counters)

        if device.type == "cuda":
            log = trace.SpanLog()
            with recording() as rec:
                with trace.profiled(device, log) as p:
                    with log.span("engine"):
                        one_pass()
            run = argparse.Namespace(summary=trace.summarize(p))
            line["device_idle_share"] = readers.idle_share(run)
            line["slice"] = program_spans.slice_split(p, rec.spans)
            line["program_counters"] = rec.counters
            line["profiler_launch_inflation"] = program_spans.launch_inflation(window, rec.spans)
            win, sl = _mean_ms(window), _mean_ms(rec.spans)
            line["span_mean_ms"] = {k: [win[k], sl.get(k)] for k in sorted(win)}
            errors, counts = program_spans.clock_errors(p, rec.spans)
            line["clock_error_us"] = _clock_summary(errors, counts)
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
