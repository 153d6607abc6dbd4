"""How often the program's router picks another top-k set than the plain
fp32 reference's, at a scoring cell's own size, in one process:

    python benchmark/tools/routing_flips.py --workload <cell> --seed <n> \\
        [--rows 512] [--out <file>]

The cell's weights and rows from the seed; the first ``--rows`` rows of the
traffic (batches of the cell's size at the full text width, PIL's crops)
run through the program's engine, recording each expert layer's top-k
of every kept token (``ops/moe.route``); the program's state is freed; the
family's plain reference runs the same rows in fp32, recording its own
router's top-k (``families/<family>.py``'s ``_route``). Prints one JSON
line: the share of (token, expert layer) pairs whose top-k sets differ, by
layer and in all, and the same for the float8 control. A later layer's
router sees the activations that earlier flips have already moved, so the
share grows with depth. Without a card (``--device cpu``) the program runs
its plain router (``route_reference``)."""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import env, spec  # noqa: E402


def _sets(idx):
    import numpy as np

    return np.sort(idx.astype(np.int64), axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--benchmark-json", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    env.set_cache_dirs(spec.ROOT)
    env.hide_forbidden()
    cell = spec.load_cell(args.workload, args.benchmark_json)

    import numpy as np
    import torch

    from benchmark.harness import assets, compare, port, traffic, weights
    from benchmark.reference import models as ref
    from multimodal_content_moderation_tpu_torch.models.fast_infer import FastInferenceEngine
    from multimodal_content_moderation_tpu_torch.ops import moe

    device = env.card(1)[0] if args.device == "cuda" else torch.device("cpu")
    cfg, mix = cell.config, cell.traffic
    recipe = cfg["recipe"]["eval"]
    B = int(mix["batch"])
    enc = assets.encoder_dir(cfg)
    data = traffic.rows(args.seed, int(mix["rows"]), mix, cfg["head"]["class_names"])
    texts, images = data["texts"][:args.rows], data["images"][:args.rows]
    wdtype = torch.bfloat16 if recipe["precision"] == "bf16_fast" else torch.float32

    # the reference's batch of the rows, shared by both sides
    reference = compare.Reference(cfg, args.seed, enc, device, weight_dtype=wdtype)
    batches = [reference.batch(texts[s:s + B], images[s:s + B]) for s in range(0, len(texts), B)]
    del reference
    compare.free_device()

    got = []  # the program's top-k of each expert layer, batch by batch
    model = port.fusion_model(cfg, weights.draw(cfg, args.seed, device, wdtype), device, recipe,
                              train=False)
    engine = FastInferenceEngine(model, cfg["image"]["mean"], cfg["image"]["std"])
    kernel_route, plain_route = moe.route, moe.route_reference

    def on_card(logits, k, scaling, counts):
        r = kernel_route(logits, k, scaling, counts)
        got[-1].append(r.idx.cpu().numpy())
        return r

    def plain(logits, k, scaling):
        idx, w = plain_route(logits, k, scaling)
        got[-1].append(idx.cpu().numpy())
        return idx, w

    on_card.launches = kernel_route.launches  # the wrapper counts through its module name
    moe.route, moe.route_reference = on_card, plain
    try:
        crops = np.stack(_crops(images))
        for i, b in enumerate(batches):
            got.append([])
            n = b["ids"].shape[0]
            patches = engine.patches_from_hwc(crops[i * B:i * B + n])
            engine(b["ids"].cpu(), b["mask"].cpu(), patches, b["text_present"].cpu(),
                   b["image_present"].cpu())
    finally:
        moe.route, moe.route_reference = kernel_route, plain_route
    del engine, model
    compare.free_device()

    family = spec.family(cfg).module
    out = {"workload": args.workload, "seed": args.seed, "rows": len(texts),
           "device": str(device)}
    for lowp in (None, "fp8"):
        want = []
        ref_route = family._route

        def recording(pr, x, P, name, t):
            idx, w = ref_route(pr, x, P, name, t)
            want[-1].append(idx.cpu().numpy())
            return idx, w

        reference = compare.Reference(cfg, args.seed, enc, device, lowp=lowp,
                                      weight_dtype=wdtype)
        family._route = recording
        try:
            with torch.no_grad():
                for b in batches:
                    want.append([])
                    ref.logits(reference.features, cfg, reference.P, b, lowp)
        finally:
            family._route = ref_route
        del reference
        compare.free_device()
        per_layer = None
        for b, gb, wb in zip(batches, got, want):
            keep = b["mask"].cpu().numpy().reshape(-1) != 0
            flips = [np.any(_sets(g) != _sets(w[keep]), axis=1) for g, w in zip(gb, wb)]
            per_layer = flips if per_layer is None else [
                np.concatenate([a, f]) for a, f in zip(per_layer, flips)]
        name = "program" if lowp is None else "control_fp8"
        out[name] = {"flip_share": float(np.mean(np.concatenate(per_layer))),
                     "by_layer": [float(f.mean()) for f in per_layer],
                     "pairs": int(sum(len(f) for f in per_layer))}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _crops(images):
    """The uint8 crops the program reads for the rows' images: PIL's, as the
    reference reads them (the engine takes HWC uint8)."""
    from benchmark.reference import pixels

    crops = pixels.pil_crops()
    return [crops[name] for name in images]


if __name__ == "__main__":
    sys.exit(main())
