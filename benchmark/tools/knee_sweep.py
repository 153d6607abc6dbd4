"""The endpoint's knee: open-loop Poisson load at a list of rates, one
window each, against one server (the cell's configuration and recipe), in
one process:

    python benchmark/tools/knee_sweep.py --workload clip-b32.serve-single \\
        --rates 8,16,24,30 --seconds 51 [--out knee.json]

For each rate: the p50 / p95 / p99 from due time, how late the generator
sent, and the backlog: the requests in flight when the last one was due,
and the median latency of the window's last fifth over its first fifth. The
knee is the highest rate whose backlog does not grow."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import env, spec  # noqa: E402


def backlog(t):
    import numpy as np

    due = np.asarray(t["due"], float)
    done = np.asarray([d if d is not None else np.inf for d in t["done"]], float)
    last = due[-1]
    in_flight = int(((due <= last) & (done > last)).sum())
    lat = done - due
    k = max(len(lat) // 5, 1)
    growth = float(np.median(lat[-k:]) / max(np.median(lat[:k]), 1e-9))
    return in_flight, growth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--benchmark-json", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    env.set_cache_dirs(spec.ROOT)
    env.hide_forbidden()
    cell = spec.load_cell(args.workload, args.benchmark_json)

    import numpy as np
    import torch

    from benchmark.harness import serve

    device = env.card(1)[0] if args.device == "cuda" else torch.device("cpu")
    rows = []
    with tempfile.TemporaryDirectory(prefix="knee-") as tmp:
        ep = serve.Endpoint(cell.config, cell.traffic, args.seed, tmp, device)
        try:
            serve.drive(ep.port, serve.plan(args.seed, 50.0, 2.0, cell.traffic), cell.traffic,
                        tmp)
            for i, rate in enumerate(float(x) for x in args.rates.split(",")):
                p = serve.plan(args.seed + 1 + i, rate, args.seconds, cell.traffic)
                t = serve.drive(ep.port, p, cell.traffic, tmp)
                lat = serve.latencies_ms(t, float(cell.traffic["grace_s"]))
                sent = np.asarray([s - d for s, d in zip(t["sent"], t["due"]) if s is not None])
                flight, growth = backlog(t)
                row = {"rate_per_s": rate, "requests": len(lat),
                       "failed": int(sum(s != 200 for s in t["status"])),
                       "p50_ms": float(np.median(lat)), "p95_ms": serve.p95(lat),
                       "p99_ms": float(np.percentile(lat, 99)),
                       "generator_late_ms_p95": float(np.percentile(sent, 95) * 1e3),
                       "in_flight_at_last_due": flight, "late_over_early_median": growth}
                rows.append(row)
                print(json.dumps(row), flush=True)
        finally:
            ep.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": env.power_limit(), "rates": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
