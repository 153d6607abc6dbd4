"""A dry run of the multi-process paths on the CPU (the JAX package's
``__graft_entry__.dryrun_multichip``): ``n`` gloo processes run one sharded
train step of a small CLIP fusion model on an ``(n/2) x 2`` mesh
(tensor-parallel over the model axis; ``n x 1`` for an odd ``n``), then the
fast engine over ``n`` data ranks, and print one line.

    python -m multimodal_content_moderation_tpu_torch.parallel.dryrun --n 4

Each process runs one thread; the group gives up after ``--timeout``
seconds, and a process that fails ends the run non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

D, HEADS, T, VOCAB, IMAGE = 64, 4, 16, 512, 32


def _batch(rows: int, seed: int):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 1, size=(rows, T)).astype(np.int32)
    ids[:, -1] = VOCAB - 1
    return {
        "input_ids": ids,
        "attention_mask": np.ones((rows, T), np.int32),
        "pixel_values": g.integers(0, 256, size=(rows, IMAGE, IMAGE, 3), dtype=np.uint8),
        "text_present": np.ones((rows,), np.float32),
        "image_present": np.ones((rows,), np.float32),
        "labels": (g.random((rows, 5)) < 0.3).astype(np.float32),
    }


class _Rows:
    """In-memory rows with the ``CSVDataset.batches`` contract (uint8 HWC)."""

    def __init__(self, rows: int, seed: int):
        self.data = _batch(rows, seed)
        self.input_ids, self.attention_mask = self.data["input_ids"], self.data["attention_mask"]
        self.labels = self.data["labels"]

    def __len__(self):
        return len(self.labels)

    def batches(self, batch_size, drop_last=False, pad_to_batch=False, num_workers=0,
                indices=None):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        for s in range(0, len(order), batch_size):
            idx = order[s: s + batch_size]
            out = {k: v[idx] for k, v in self.data.items()}
            if pad_to_batch:
                pad = batch_size - len(idx)
                out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                       for k, v in out.items()}
                out["_valid"] = np.int32(len(idx))
            yield out


def worker(n: int, rank: int, port: int, timeout_s: float) -> dict:
    import torch

    from multimodal_content_moderation_tpu_torch.models import clip as tclip
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        FastInferenceEngine,
        evaluate_logits_u8,
    )
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
    from multimodal_content_moderation_tpu_torch.parallel.collectives import split_of
    from multimodal_content_moderation_tpu_torch.parallel.mesh import (
        build_mesh,
        init_distributed,
    )
    from multimodal_content_moderation_tpu_torch.parallel.sharding import shard_params
    from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", n, rank, device="cpu", timeout_s=timeout_s)
    num_model = 2 if n % 2 == 0 else 1
    mesh = build_mesh(n // num_model, num_model).activate()
    tower = dict(hidden_size=D, num_layers=2, num_heads=HEADS, intermediate_size=2 * D)
    cfg = tclip.CLIPConfig(
        text=tclip.CLIPTextConfig(vocab_size=VOCAB, max_positions=T, eos_token_id=VOCAB - 1,
                                  **tower),
        vision=tclip.CLIPVisionConfig(image_size=IMAGE, patch_size=16, **tower),
        projection_dim=D,
    )
    model = FusionModel.create("clip", num_labels=5, fusion_dim=32, encoder_config=cfg,
                               device="cpu").replace(image_mean=(0.5,) * 3, image_std=(0.5,) * 3)
    mesh.replicate(model)
    shard_params(model, mesh)
    fc1 = model.backbone["text_model"]["layers"][0]["fc1"]["w"]
    if num_model > 1 and (split_of(fc1) is None or split_of(fc1).dim != 1):
        raise AssertionError("the tensor-parallel rules did not split fc1 by column")
    opt = AdamW(dict(model.named_parameters()), total_steps=10, schedule="constant", mesh=mesh)
    step = make_train_step(model, opt, generator=torch.Generator().manual_seed(0))
    rows = 2 * mesh.num_data
    host = _batch(rows, 0)
    host["patches_u8"] = extract_patches_u8(host.pop("pixel_values"), 16)
    batch = mesh.shard_batch({k: torch.from_numpy(v) for k, v in host.items()})
    loss = float(mesh.mean(step(batch)))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    eval_mesh = build_mesh(n, 1)
    plain = FusionModel.create("clip", num_labels=5, fusion_dim=32, encoder_config=cfg,
                               device="cpu")
    engine = FastInferenceEngine(plain, (0.5,) * 3, (0.5,) * 3, mesh=eval_mesh)
    logits, _ = evaluate_logits_u8(engine, _Rows(4 * n + 1, 1), batch_size=2 * n,
                                   num_workers=1)
    if logits.shape != (4 * n + 1, 5) or not np.isfinite(logits).all():
        raise AssertionError(f"fast engine logits {logits.shape}")
    return {"dryrun": "ok", "processes": n, "mesh": [mesh.num_data, mesh.num_model],
            "batch": rows, "loss": loss, "fast_engine_mesh": [eval_mesh.num_data, 1],
            "logits": list(logits.shape)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=4, help="processes")
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        line = worker(args.n, args.rank, args.port, args.timeout)
        if args.rank == 0:
            print(json.dumps(line), flush=True)
        return 0

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "multimodal_content_moderation_tpu_torch.parallel.dryrun",
             "--n", str(args.n), "--timeout", str(args.timeout), "--rank", str(r),
             "--port", str(port)],
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL, env=env, text=True,
        )
        for r in range(args.n)
    ]
    try:
        out = procs[0].communicate(timeout=args.timeout)[0]
        codes = [p.wait(timeout=max(args.timeout - (time.perf_counter() - t0), 1))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"dryrun failed: exit codes {codes}", file=sys.stderr)
        return 1
    line = json.loads(out.strip().splitlines()[-1])
    line["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
