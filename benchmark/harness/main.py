"""One run of one cell:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (assets, weights, the program, warm-up) counts in ``setup_s``; the
window runs the cell's traffic for ``--seconds``; then the program's state
is freed and its answers are compared with the plain reference. The result
is the last line of standard output; each compared number and its limit are
the last lines of standard error. No card, or a forbidden module loaded:
a non-zero exit and no result."""

from __future__ import annotations

import argparse
import sys
import tempfile

from benchmark.harness import env, spec


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    # the CPU and another BENCHMARK.json are for the harness's own tests
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help=argparse.SUPPRESS)
    ap.add_argument("--benchmark-json", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    proc_start = env.process_start()
    args = parse(argv)
    env.set_cache_dirs(spec.ROOT)
    env.hide_forbidden()
    cell = spec.load_cell(args.workload, args.benchmark_json)

    import torch

    from benchmark.harness import record, score, serve, train

    if args.device == "cuda":
        device, card = env.card(cell.chips)
    else:
        device, card = torch.device("cpu"), "cpu"
    r = record.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=device, card=card)
    if device.type == "cuda":
        r.notes["card"] = env.power_limit()
    mode = {"score": score.run, "train": train.run, "serve": serve.run}[cell.mode]
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        mode(r, tmp, proc_start)
    r.end_to_end["setup_s"] = r.setup_s
    loaded = env.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    record.emit(r)
    return 0
