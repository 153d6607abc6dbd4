"""Readings that set a cell's correctness limits, on the card at the cell's
own size, in one process:

    python benchmark/tools/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault half_batch --fault-seeds 4,5,6] [--seconds 5]

- the program's numbers: a short run of the cell (its set-up, a window of
  ``--seconds`` at the cell's own load, the comparison) for each seed;
- the control's: the plain reference computed with every matrix product in
  float8 e4m3 (the precision below the configurations' bf16), put in the
  program's place and compared with the fp32 reference the same way;
- a fault planted in the program (``tools/faults.py``), for each fault seed.

Prints one JSON line per reading and writes them all to ``--out``."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import env, spec  # noqa: E402


def control(cell, seed: int, device, seconds: float):
    """The control's numbers for ``seed``."""
    import numpy as np
    import torch

    from benchmark.harness import assets, compare, serve, traffic, train

    cfg, mix = cell.config, cell.traffic
    enc = assets.encoder_dir(cfg)
    classes = cfg["head"]["class_names"]
    if cell.mode == "train":
        recipe = cfg["recipe"]["train"]
        n = int(mix["rows"])
        B, accum = int(recipe["per_device_train_batch_size"]), int(
            recipe["gradient_accumulation_steps"])
        data = traffic.rows(seed, n, mix, classes)
        g = np.random.default_rng([seed, 6])
        order = np.concatenate([g.permutation(n) for _ in range(int(mix["epochs_laid"]))])
        tseed = int(seed) % (1 << 62)
        out = {}
        for lowp in (None, "fp8"):
            ref = compare.Reference(cfg, seed, enc, device)
            out[lowp] = train.follow(cfg, recipe, ref, data, order, B, accum,
                                     int(mix["checked_updates"]), tseed, n, device, lowp)
            del ref
            compare.free_device()
        a, b = out["fp8"], out[None]
        names = list(b["first_grad"])
        used = [k for k in names if b["first_grad"][k] >= 1e-3 * np.median(
            list(b["first_grad"].values()))]
        return {"loss_gap": max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                "first_grad_gap": train.worst_gap(a["first_grad"], b["first_grad"], names),
                "update_gap": train.worst_gap(a["change"], b["change"], used)}
    wdtype = torch.bfloat16 if cfg["recipe"]["eval"]["precision"] == "bf16_fast" \
        else torch.float32
    if cell.mode == "score":
        n = int(mix["rows"])
        data = traffic.rows(seed, n, mix, classes)
        lengths = np.asarray([len(t.split()) for t in data["texts"]])
        rows = compare.sample_rows(seed, n, int(mix["compare_rows"]), lengths)
        texts, images = [data["texts"][i] for i in rows], [data["images"][i] for i in rows]
    else:
        p = serve.plan(seed, float(mix["rate_per_s"]), seconds, mix)
        texts, images = p["texts"], p["image_names"]
    got = {}
    for lowp in (None, "fp8"):
        ref = compare.Reference(cfg, seed, enc, device, lowp=lowp, weight_dtype=wdtype)
        got[lowp] = ref.logits(texts, images)
        del ref
        compare.free_device()
    if cell.mode == "score":
        return {"max_abs_logit_gap": float(np.abs(got["fp8"] - got[None]).max())}
    sig = {k: 1.0 / (1.0 + np.exp(-v)) for k, v in got.items()}
    return {"max_abs_prob_gap": float(np.abs(sig["fp8"] - sig[None]).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--benchmark-json", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    env.set_cache_dirs(spec.ROOT)
    env.hide_forbidden()
    cell = spec.load_cell(args.workload, args.benchmark_json)

    import torch

    from benchmark.harness import record, score, serve, train
    from benchmark.tools import faults

    device = env.card(1)[0] if args.device == "cuda" else torch.device("cpu")
    card = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    mode = {"score": score.run, "train": train.run, "serve": serve.run}[cell.mode]
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = []

    def program(seed, fault=""):
        r = record.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=device,
                       card=card)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="readings-") as tmp:
            if fault:
                with faults.planted(fault):
                    mode(r, tmp, time.time())
            else:
                mode(r, tmp, time.time())
        return {"kind": f"fault:{fault}" if fault else "program", "seed": seed,
                "numbers": {k: c["value"] for k, c in r.checks.items()},
                "end_to_end": r.end_to_end, "failed": r.failed,
                "seconds": time.perf_counter() - t, "notes": r.notes}

    jobs = [("program", s) for s in seeds(args.seeds)]
    jobs += [("control", s) for s in seeds(args.control_seeds)]
    jobs += [("fault", s) for s in seeds(args.fault_seeds)]
    for kind, s in jobs:
        if kind == "control":
            t = time.perf_counter()
            rec = {"kind": "control:fp8", "seed": s,
                   "numbers": control(cell, s, device, args.seconds),
                   "seconds": time.perf_counter() - t}
        else:
            rec = program(s, args.fault if kind == "fault" else "")
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": env.power_limit(), "readings": out}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
