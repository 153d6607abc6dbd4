"""Fine-tuning: the Trainer's step loop as ``Trainer.train`` runs an epoch,
``host_batches`` -> ``prefetch_to_device`` -> ``Trainer.train_step``, over a
cached ``CSVDataset``, with seeded permutations of the rows laid end to end so
that no epoch end (evaluation, checkpoint) falls inside the window.

Set-up builds the one trainer, fills the pixel cache and drives the trainer
through its first ``checked_updates`` optimizer updates on the window's own
feed (rows that all differ); the reference follows those steps, and the same
trainer and feed go on into the window. ``train_samples_per_s`` is the
samples of the window's micro-steps over its seconds, to a synchronise."""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from benchmark.flops import model as model_flops
from benchmark.harness import assets, compare, port, spec, trace, traffic, weights
from benchmark.reference import models as ref
from benchmark.reference import optim as ref_optim


def _timed_optimizer(opt, spans):
    """Wrap ``opt.step`` with CUDA events and a span; returns the list of
    event pairs."""
    pairs = []
    step = opt.step

    def timed():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with spans.span("optimizer"):
            out = step()
        b.record()
        pairs.append((a, b))
        return out

    opt.step = timed
    return pairs


def _record_lr(opt):
    """Wrap each group's schedule of the port's optimizer so that every
    update it applies records (group, update count, learning rate); returns
    the record."""
    seen = []
    for group, sched in list(opt.lr.items()):
        def recorded(count, _sched=sched, _group=group):
            lr = _sched(count)
            seen.append((_group, int(count), float(lr)))
            return lr
        opt.lr[group] = recorded
    return seen


def lr_gap(seen, recipe, first: int, updates: int, total: int) -> float:
    """The largest gap, as a share of the group's peak, between the learning
    rate that each of the updates ``first .. first + updates - 1`` applied
    and the reference's schedule at that update; an update that applied
    none reads as a rate of 0, and one applied more than once reads 1."""
    gap = 0.0
    for group in ("encoder", "head"):
        peak = float(recipe[f"lr_{group}"])
        want = ref_optim.schedule(peak, total, float(recipe["warmup_ratio"]))
        got = [(c, lr) for g, c, lr in seen if g == group]
        if len(got) > updates:
            return 1.0
        for i in range(updates):
            c, lr = got[i] if i < len(got) else (first + i, 0.0)
            if c != first + i:
                return 1.0
            gap = max(gap, abs(lr - want(first + i)) / peak)
    return gap


def _port_leaf_norms(named: Dict[str, torch.Tensor], hf_names, port_names) -> Dict[str, float]:
    """Norms of reference-layout leaves from the port's leaves
    (``port_names``: the family's map from one to the other)."""
    out = {}
    for n in hf_names:
        sq = sum(float(named[p].double().pow(2).sum()) for p in port_names(n))
        out[n] = math.sqrt(sq)
    return out


def worst_gap(port_norms: Dict[str, float], ref_norms: Dict[str, float], leaves) -> float:
    """The largest |port norm - reference norm| of a leaf, against the
    reference's norm of that leaf or of the median leaf, the larger."""
    med = float(np.median([ref_norms[n] for n in leaves]))
    return max(abs(port_norms[n] - ref_norms[n]) / max(ref_norms[n], med) for n in leaves)


def run(r, tmp: str, proc_start: float) -> None:
    from multimodal_content_moderation_tpu_torch.training.loop import (
        Trainer,
        TrainArgs,
        host_batches,
        prefetch_to_device,
    )

    cfg, mix, dev = r.config, r.cell.traffic, r.device
    recipe = cfg["recipe"]["train"]
    classes = cfg["head"]["class_names"]
    n, workers = int(mix["rows"]), int(mix["num_workers"])
    B = int(recipe["per_device_train_batch_size"])
    accum = int(recipe["gradient_accumulation_steps"])
    checked = int(mix["checked_updates"])
    trainer_seed = int(r.seed) % (1 << 62)

    enc = assets.encoder_dir(cfg)
    data = traffic.rows(r.seed, n, mix, classes)
    csv_path = traffic.write_csv(os.path.join(tmp, "rows.csv"), data, classes)
    port.build_kernels(["patch_embed_u8", "attention_nhd", "attention_nhd_bwd"], dev)
    model = port.fusion_model(cfg, weights.draw(cfg, r.seed, dev), dev, recipe, train=True)
    ds = port.dataset(cfg, csv_path, assets.JPEG_DIR, enc, os.path.join(tmp, "pixels"), recipe)
    with cf.ThreadPoolExecutor(workers) as pool:  # the first epoch's decode, into the cache
        list(pool.map(ds.load_image, range(n)))
    args = TrainArgs(
        output_dir=os.path.join(tmp, "run"), per_device_train_batch_size=B,
        gradient_accumulation_steps=accum, num_train_epochs=int(recipe["num_train_epochs"]),
        lr_encoder=float(recipe["lr_encoder"]), lr_head=float(recipe["lr_head"]),
        weight_decay=float(recipe["weight_decay"]), warmup_ratio=float(recipe["warmup_ratio"]),
        max_grad_norm=float(recipe["max_grad_norm"]),
        lr_scheduler_type=recipe["lr_scheduler_type"], seed=trainer_seed,
        num_workers=workers, wire=recipe["wire"], prefetch=int(mix["prefetch"]),
        accumulator_dtype=recipe.get("accumulator_dtype", ""),
    )
    trainer = Trainer(model, args, ds, None, compute_metrics=None, device=dev)
    opt = trainer.optimizer
    g = np.random.default_rng([r.seed, 6])
    order = np.concatenate([g.permutation(n) for _ in range(int(mix["epochs_laid"]))])
    feed = prefetch_to_device(
        host_batches(ds, B, trainer.patch_size, order, workers), trainer.device, args.prefetch)

    # the checked updates, on the window's own trainer and feed
    p0 = {k: p.detach().clone() for k, p in opt.params.items()}
    hf_names = [name for name, _, _, _ in weights.spec(cfg)]
    port_names = spec.family(cfg).port_names
    losses, first_grad = [], None
    for i in range(checked * accum):
        losses.append(float(trainer.train_step(next(feed))))
        if i == accum - 1:
            first_grad = _port_leaf_norms({k: m / (1 - opt.b1) for k, m in opt.mu.items()},
                                          hf_names, port_names)
    change = _port_leaf_norms({k: p.detach() - p0[k] for k, p in opt.params.items()}, hf_names,
                              port_names)
    del p0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    events = _timed_optimizer(opt, r.spans) if r.trace and dev.type == "cuda" else None
    applied = _record_lr(opt)

    r.setup_s = time.time() - proc_start
    steps, step_losses = 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        with r.spans.span("host_prep"):
            batch = next(feed)
        with r.spans.span("train_step"):
            step_losses.append(trainer.train_step(batch))
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    r.attempted = steps * B
    r.end_to_end["train_samples_per_s"] = steps * B / window_s

    if r.trace and dev.type == "cuda":
        recorder = trace.ShapeRecorder().install()
        recorder.on = True
        with trace.profiled(dev, r.spans) as p:
            for _ in range(int(mix["profile_micro_steps"])):
                with r.spans.span("host_prep"):
                    batch = next(feed)
                with r.spans.span("train_step"):
                    step_losses.append(trainer.train_step(batch))
        recorder.uninstall()
        r.summary = trace.summarize(p)
        r.shapes = recorder.calls
        ms = [a.elapsed_time(b) for a, b in events]
        r.measured["optimizer_ms"] = float(np.mean(ms))
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)
    window_losses = torch.stack(step_losses).float().cpu().numpy()
    r.failed = int((~np.isfinite(window_losses)).sum())
    feed.close()

    if r.trace:
        t = time.perf_counter()
        for _ in host_batches(ds, B, trainer.patch_size, order[:n], workers):
            pass
        r.measured["host_prep_rows_per_s"] = (n // B) * B / (time.perf_counter() - t)
    del trainer, model, opt, ds
    compare.free_device()

    reference = compare.Reference(cfg, r.seed, enc, dev, grad=True)
    want = follow(cfg, recipe, reference, data, order, B, accum, checked, trainer_seed, n, dev)
    used = [k for k in hf_names if want["first_grad"][k] >= 1e-3 * np.median(
        list(want["first_grad"].values()))]
    r.notes["leaves_compared"] = len(used)
    r.notes["losses"] = losses
    r.check("loss_gap", max(abs(a - b) for a, b in zip(losses, want["losses"])),
            r.cell.limits["loss_gap"])
    r.check("first_grad_gap", worst_gap(first_grad, want["first_grad"], hf_names),
            r.cell.limits["first_grad_gap"])
    r.check("update_gap", worst_gap(change, want["change"], used), r.cell.limits["update_gap"])
    # every update of the window, past the warmup into the decay, at the
    # reference's learning rate
    updates = (checked * accum + len(step_losses)) // accum - checked
    r.notes["window_updates"] = updates
    r.check("lr_gap", lr_gap(applied, recipe, checked, updates, want["total"]),
            r.cell.limits["lr_gap"])
    if r.trace:
        tokens = reference.text_tokens([data["texts"][i] for i in order[:steps * B]])
        r.measured["model_flops"] = float(sum(model_flops.training(cfg, int(k)) for k in tokens))
        r.measured["model_seconds"] = window_s


def follow(cfg, recipe, reference, data, order, B, accum, updates, trainer_seed, n, dev,
           lowp=None):
    """The reference's first ``updates`` optimizer updates on the rows
    ``order`` feeds first, with the dropout masks the trainer's seed draws:
    each micro-step's loss, the first update's per-leaf gradient norms and
    each leaf's change after the last update. ``reference`` holds its
    weights to train (``grad``)."""
    P = reference.P
    p0 = {k: t.detach().clone() for k, t in P.items()}
    total = -(-(n // B) * int(recipe["num_train_epochs"]) // accum)
    opt = ref_optim.AdamW(P, float(recipe["lr_encoder"]), float(recipe["lr_head"]),
                          float(recipe["weight_decay"]), float(recipe["max_grad_norm"]), total,
                          float(recipe["warmup_ratio"]), accum)
    gen = torch.Generator(device=dev).manual_seed(trainer_seed)
    fusion = cfg["head"]["fusion_dim"]
    losses, first = [], None
    for i in range(updates * accum):
        rows = order[i * B:(i + 1) * B]
        batch = reference.batch([data["texts"][j] for j in rows], [data["images"][j] for j in rows])
        keep = torch.rand([B, fusion], generator=gen, device=dev) < 0.8
        y = torch.as_tensor(data["labels"][rows], device=dev)
        out = ref.logits(reference.features, cfg, P, batch, lowp, drop_mask=keep)
        loss = ref.bce(out, y)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
        for t in P.values():
            t.grad = None
        if i == accum - 1:
            first = ref_optim.leaf_norms(opt.first_moment_grads())
    change = ref_optim.leaf_norms({k: P[k].detach() - p0[k] for k in P})
    return {"losses": losses, "first_grad": first, "change": change, "total": total}
