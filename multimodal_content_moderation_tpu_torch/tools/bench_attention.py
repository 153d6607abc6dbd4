"""Attention crossover across sequence lengths (the JAX package's
``tools/bench_attention.py``): one multi-head attention layer (the q/k/v/o
projections and the core) at B=8, 12 heads of 64, bf16, with three cores:

- ``xla``: the port's plain core (``ops.layers.mha(impl="xla")``: products
  around an fp32 softmax);
- ``pallas``: the ``flash_attention`` kernel (``ops/cuda_flash.py``, the
  JAX tool's Pallas core) on the projections' [B, h, T, dh] views;
- ``nhd`` (T <= 256 only): the ``attention_nhd`` kernel
  (``mha(impl="pallas")``).

Each time is the mean of ``--iters`` calls over 4 staged inputs, by CUDA
events. Prints a JSON line per length and one result line last:
``attention_crossover_seq``, the shortest length at which ``pallas`` beats
``xla``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    c.add_common_args(ap)
    ap.add_argument("--batch", type=int, default=None, help="default 8")
    ap.add_argument("--dim", type=int, default=None, help="default 768")
    ap.add_argument("--heads", type=int, default=None, help="default 12")
    ap.add_argument("--seqs", default=None, help="default 128,256,512,1024,2048,4096")
    ap.add_argument("--iters", type=int, default=None, help="default 20")
    args = ap.parse_args(argv)
    full = {"batch": 8, "dim": 768, "heads": 12, "seqs": "128,256,512,1024,2048,4096",
            "iters": 20}
    tiny = {"batch": 2, "dim": 64, "heads": 4, "seqs": "32,300", "iters": 2}
    for key, value in (tiny if args.tiny else full).items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def flash_mha(x, p, num_heads: int):
    """The layer with ``flash_attention`` as its core."""
    from multimodal_content_moderation_tpu_torch.ops.cuda_flash import flash_attention
    from multimodal_content_moderation_tpu_torch.ops.layers import dense

    B, T, D = x.shape
    dh = D // num_heads
    q, k, v = (dense(x, p[n]).view(B, T, num_heads, dh).transpose(1, 2) for n in "qkv")
    out = flash_attention(q, k, v)
    return dense(out.transpose(1, 2).reshape(B, T, D), p["o"])


@torch.inference_mode()
def main(argv=None) -> dict:
    from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ
    from multimodal_content_moderation_tpu_torch.ops.layers import mha

    args = parse_args(argv)
    device = c.open_device(args.device, "bench-attention")
    B, D, H = args.batch, args.dim, args.heads
    g = np.random.default_rng(args.seed)

    def param(shape, scale):
        return torch.from_numpy((g.normal(size=shape) * scale).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    p = {k: {"w": param((D, D), D ** -0.5), "b": torch.zeros(D, device=device,
                                                            dtype=torch.bfloat16)}
         for k in ("q", "k", "v", "o")}
    cores = {
        "xla": lambda x: mha(x, x, p, H, impl="xla"),
        "pallas": lambda x: flash_mha(x, p, H),
        "nhd": lambda x: mha(x, x, p, H, impl="pallas"),
    }
    counts = c.launch_counter()
    results = []
    for T in [int(s) for s in args.seqs.split(",") if s]:
        xs = [param((B, T, D), 1.0) for _ in range(4)]
        row = {"seq": T}
        for name, fn in cores.items():
            if name == "nhd" and T > MAX_SEQ:
                continue
            row[f"{name}_us"] = c.mean_ms(lambda i: fn(xs[i % 4]), args.iters, device) * 1e3
        row["pallas_speedup"] = row["xla_us"] / row["pallas_us"]
        if "nhd_us" in row:
            row["nhd_speedup"] = row["xla_us"] / row["nhd_us"]
        results.append(row)
        print(json.dumps(row), flush=True)
    winners = [r["seq"] for r in results if r["pallas_speedup"] > 1.0]
    return c.emit({
        "metric": "attention_crossover_seq",
        "value": min(winners) if winners else None,
        "unit": "tokens",
        "rows": results,
        "batch": B, "dim": D, "heads": H, "iters": args.iters,
        "timed_by": "CUDA events" if device.type == "cuda" else "host clock",
        "device": c.card_line(device), "launches": counts(), "seed": args.seed,
        "tiny": args.tiny,
    })


if __name__ == "__main__":
    main()
