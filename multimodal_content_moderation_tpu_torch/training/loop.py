"""Fine-tuning loop and streaming evaluation (the JAX package's
``training/loop.py``), on one device or over a mesh of processes.

- ``make_train_step``: forward (dropout from the trainer's generator), loss,
  backward, then the optimizer (``training/optim.AdamW``: global-norm clip,
  two-group AdamW, accumulation). The loss comes back as a device tensor;
  nothing in a step waits for the device.
- ``evaluate_logits``: the fast engine on uint8 crops (``models/fast_infer``);
  ``evaluate_logits_standard``: the standard engine on normalised fp32 pixels
  (the model's ``forward`` on ``pixel_values``, the JAX package's
  ``make_eval_step``). Both pad the last batch to the batch size, trim the
  pads on the host and keep two batches in flight.
- ``Trainer``: per-epoch order from ``np.random.default_rng(seed + epoch)``
  or the weighted sampler, the CLIP, SigLIP or generic fusion or multi-task
  model (the generic text tower with HF's dropout, drawn from a generator
  the model forks off the trainer's)
  (``models/multitask.py``, its loss weighted by the learned ``log_vars``
  where the head has them) on either wire
  (``wire: f32``, the shipped default: normalised pixels through the pixel
  path; ``wire: u8``: uint8 patch rows built on the host), per-epoch eval,
  checkpoints with ``save_total_limit``, best-metric tracking, early
  stopping, resume from ``trainstate-*`` and load-best-at-end, with the JAX
  trainer's result dict; with ``report_to: tensorboard`` the JAX trainer's
  scalars (``train/loss`` and ``train/samples_per_second`` every logging
  step, ``eval/<metric>`` after each eval) in an event file under
  ``logging_dir`` (``utils/events.py``).

Host batches are prepared on a background thread and copied from pinned
memory without blocking. On the card the model's kernels run in both
passes (``patch_embed_u8`` on the u8 wire; ``attention_nhd`` and
``attention_nhd_bwd`` with ``attention_impl="pallas"``).

Under a mesh (``Trainer(..., mesh=)``, ``parallel/mesh.py``) the parameters
are broadcast from the first rank and split over the model axis by the
Megatron rules (``parallel/sharding.py``); ``per_device_train_batch_size``
stays the global batch, as on a JAX single-process mesh, and each data rank
prepares, copies and runs only its rows of it; dropout draws the global
batch's masks; the optimizer averages the gradients over the data axis once
per update; the logged loss is the data axis's mean; eval gathers the
logits, so every rank computes the same metrics; only the main rank writes
checkpoints, train states and events. Every rank runs the hand kernels on
its local tensors (the JAX package's ``enforce_gspmd_safe_kernels`` swaps
them out under GSPMD; nothing here needs that).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.data.pipeline import bounded_producer
from multimodal_content_moderation_tpu_torch.models.backbones import backbone
from multimodal_content_moderation_tpu_torch.models.fast_infer import (
    FastInferenceEngine,
    evaluate_logits_u8,
    gather_rank_rows,
    rank_positions,
)
from multimodal_content_moderation_tpu_torch.ops.cuda_attention import MAX_SEQ
from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.ops.losses import bce_with_logits
from multimodal_content_moderation_tpu_torch.parallel.mesh import local_device
from multimodal_content_moderation_tpu_torch.parallel.sharding import shard_params
from multimodal_content_moderation_tpu_torch.training import checkpoints as ckpt_lib
from multimodal_content_moderation_tpu_torch.training.optim import AdamW
from multimodal_content_moderation_tpu_torch.training.sampling import (
    build_multilabel_sample_weights,
    weighted_sample_indices,
)
from multimodal_content_moderation_tpu_torch.utils.device import resolve_device
from multimodal_content_moderation_tpu_torch.utils.events import EventWriter
from multimodal_content_moderation_tpu_torch.utils.profiling import StepTimer, assert_finite

logger = logging.getLogger(__name__)

BATCH_KEYS = (
    "input_ids",
    "attention_mask",
    "pixel_values",
    "text_present",
    "image_present",
    "labels",
)


@dataclasses.dataclass
class TrainArgs:
    """Training-loop hyperparameters (the JAX package's fields and
    defaults, after the reference TrainingArguments)."""

    output_dir: str = "runs/experiment"
    num_train_epochs: int = 8
    max_steps: int = -1
    per_device_train_batch_size: int = 32
    per_device_eval_batch_size: int = 64
    gradient_accumulation_steps: int = 1
    lr_encoder: float = 1e-5
    lr_head: float = 5e-4
    weight_decay: float = 0.02
    warmup_ratio: float = 0.05
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "cosine"
    sampler: str = "random"  # "random" | "weighted"
    logging_steps: int = 50
    save_total_limit: int = 2
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "roc_macro"
    greater_is_better: bool = True
    early_stopping: bool = True
    early_stopping_patience: int = 3
    seed: int = 42
    num_workers: int = 8
    freeze_text: bool = False
    freeze_image: bool = False
    report_to: str = "none"  # "none" | "tensorboard" (utils/events.EventWriter)
    logging_dir: str = ""
    debug_nans: bool = False
    resume_from_checkpoint: str = ""  # "" | "auto" | explicit trainstate dir
    prefetch: int = 2
    # "f32": normalised fp32 NCHW pixels through the pixel path (patchify +
    # the patch_embedding dense), evaluated by the standard engine. "u8": raw
    # uint8 patch rows on the wire, the normalisation folded into the patch
    # embed on the device (models/u8wire.py), evaluated by the fast engine.
    wire: str = "f32"
    # "" keeps fp32 Adam m/v; "bfloat16" stores them in bf16 (optim.AdamW)
    accumulator_dtype: str = ""


def host_batches(
    dataset, batch_size: int, patch_size: Optional[int], indices, num_workers: int = 8,
    mesh=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Full training batches in ``indices`` order as {name: CPU tensor}. With
    a ``patch_size`` (the u8 wire) the uint8 HWC crops are cut into
    wire-format patch rows; without one (the f32 wire) the normalised
    ``pixel_values`` go as they are. Under a ``mesh`` only this data rank's
    rows of each global batch of ``batch_size`` are read."""
    indices = np.asarray(indices)
    if mesh is not None and mesh.num_data > 1:
        n_batches = len(indices) // batch_size
        sl = mesh.rows(batch_size)
        indices = indices[: n_batches * batch_size].reshape(n_batches, batch_size)[:, sl]
        indices, batch_size = indices.reshape(-1), sl.stop - sl.start
    for batch in dataset.batches(
        batch_size, drop_last=True, indices=indices, num_workers=num_workers
    ):
        b = {k: batch[k] for k in BATCH_KEYS if k in batch}
        if patch_size is not None:
            b["patches_u8"] = extract_patches_u8(b.pop("pixel_values"), patch_size)
        yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def prefetch_to_device(
    items: Iterator[Dict[str, torch.Tensor]], device: torch.device, size: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Run an iterator of {name: CPU tensor} on a background thread (pinning
    the tensors for a card) and yield {name: device tensor}, copied without
    blocking."""
    pin = device.type == "cuda"

    def produce():
        for host in items:
            yield {k: v.pin_memory() for k, v in host.items()} if pin else host

    q, end, err, cancel = bounded_producer(produce, size=max(size, 1))
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield {k: v.to(device, non_blocking=True) for k, v in item.items()}
    finally:
        cancel()


def make_train_step(
    model,
    optimizer: AdamW,
    pos_weight=None,
    generator: Optional[torch.Generator] = None,
    debug_nans: bool = False,
) -> Callable:
    """``train_step(batch) -> loss`` (a device tensor): forward with dropout
    from ``generator``, backward, then ``optimizer.step()``. With
    ``debug_nans`` the loss and every gradient are checked before the update
    (``assert_finite``, a host sync per step): a NaN or an Inf raises
    ``FloatingPointError`` and never reaches the weights."""
    pw = (
        None if pos_weight is None
        else torch.as_tensor(np.asarray(pos_weight), dtype=torch.float32, device=model.device)
    )
    named = optimizer.params

    def train_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        for p in named.values():
            p.grad = None
        loss = model(batch, generator=generator, pos_weight=pw)["loss"]
        loss.backward()
        if debug_nans:
            grads = {f"{n}.grad": p.grad for n, p in named.items() if p.grad is not None}
            assert_finite({"loss": loss.detach(), **grads}, name="train step")
        optimizer.step()
        return loss.detach()

    return train_step


def evaluate_logits_standard(model, dataset, batch_size: int, num_workers: int = 8,
                             mesh=None):
    """(logits, labels) host arrays of the dataset in its row order through
    ``model.forward`` on normalised fp32 ``pixel_values`` at the full text
    width (the JAX package's standard engine): the last batch padded to
    ``batch_size`` and the pads trimmed on the host, two batches in flight.
    Under a ``mesh`` each data rank runs its slice of every batch and every
    rank returns all the rows."""
    valids, labels = [], []
    n = len(dataset)
    positions, rank_batch = rank_positions(mesh, n, batch_size)
    split = rank_batch != batch_size  # several data ranks share the rows
    rows = positions if split else None

    def host():
        for batch in dataset.batches(rank_batch, pad_to_batch=True, num_workers=num_workers,
                                     indices=rows):
            if batch["pixel_values"].dtype != np.float32:
                raise ValueError(
                    "the standard engine takes normalised float32 NCHW pixel_values (a "
                    f"float_nchw preprocessor), got {batch['pixel_values'].dtype}"
                )
            valids.append(int(batch.pop("_valid")))
            labels.append(batch.pop("labels")[: valids[-1]])
            yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}

    logits, outs = [], []
    with torch.inference_mode():
        for dev in prefetch_to_device(host(), model.device, size=2):
            outs.append(model(dev)["logits"].float())
            if len(outs) > 2:
                logits.append(outs.pop(0).cpu().numpy())
        logits.extend(o.cpu().numpy() for o in outs)
    logits = [lg[:v] for lg, v in zip(logits, valids)]
    if split:
        return gather_rank_rows(mesh, logits, labels or [np.asarray(dataset.labels)[:0]],
                                positions, n, model.device)
    return np.concatenate(logits), np.concatenate(labels)


def evaluate_logits(model, dataset, batch_size: int, num_workers: int = 8, mesh=None):
    """(logits, labels) host arrays of the dataset in its row order, through
    the u8-wire eval engine (``models/fast_infer``, a dataset of uint8 HWC
    crops): the last batch padded to ``batch_size`` and the pads trimmed on
    the host, two batches in flight; over the ``mesh``'s data axis."""
    mean, std = backbone(model.backend).image_stats
    engine = FastInferenceEngine(model, model.image_mean or mean, model.image_std or std,
                                 mesh=mesh)
    return evaluate_logits_u8(engine, dataset, batch_size, num_workers=num_workers)


class Trainer:
    """Epoch-driven fine-tuning with eval, checkpoint and early-stop
    plumbing, on one device (``device``, the card by default) or, with a
    ``mesh``, as one rank of it (a bare ``"cuda"`` is then the card
    ``LOCAL_RANK`` names, one card per process under ``torchrun``)."""

    def __init__(
        self,
        model,
        args: TrainArgs,
        train_dataset,
        eval_dataset,
        compute_metrics: Callable,
        pos_weight: Optional[np.ndarray] = None,
        device="cuda",
        mesh=None,
    ):
        family = backbone(model.backend)
        if family.training_refused:
            raise NotImplementedError(f"training the {model.backend} backend is not "
                                      f"supported: {family.training_refused}")
        if args.wire not in ("u8", "f32"):
            raise ValueError(f"wire {args.wire!r}: want 'f32' or 'u8'")
        vision = model.encoder_config.vision
        n_vision = family.vision_positions(model.encoder_config)
        if vision.attention_impl == "pallas" and n_vision > MAX_SEQ:
            # the text towers stop at 77 (CLIP) and 64 (SigLIP) positions;
            # a generic one runs at the data's width
            raise NotImplementedError(
                f"attention 'pallas' would train the vision tower at {n_vision} positions "
                "through flash_attention, which is forward only (the JAX package cannot "
                "differentiate it either: its pallas_call JVP rule fails): train with "
                f"attention 'xla', or at sequences of at most {MAX_SEQ}"
            )
        self.args = args
        self.train_ds = train_dataset
        self.eval_ds = eval_dataset
        self.compute_metrics = compute_metrics
        self.device = resolve_device(device if mesh is None else local_device(device))
        self.model = model.to(self.device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        if mesh is not None:
            mesh.activate()
            mesh.replicate(self.model)
            shard_params(self.model, mesh)
        # the u8 wire cuts patch rows of the backend's own patch size
        self.patch_size = model.encoder_config.vision.patch_size if args.wire == "u8" else None
        self.eval_logits = evaluate_logits if args.wire == "u8" else evaluate_logits_standard

        n_batches = max(len(train_dataset) // args.per_device_train_batch_size, 1)
        self.steps_per_epoch = n_batches
        total = args.max_steps if args.max_steps > 0 else n_batches * args.num_train_epochs
        self.total_steps = total
        accum = max(args.gradient_accumulation_steps, 1)
        self.optimizer = AdamW(
            dict(self.model.named_parameters()),
            lr_encoder=args.lr_encoder,
            lr_head=args.lr_head,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            total_steps=-(-total // accum),  # optimizer steps after accumulation
            warmup_ratio=args.warmup_ratio,
            schedule=args.lr_scheduler_type,
            freeze_text=args.freeze_text,
            freeze_image=args.freeze_image,
            accumulator_dtype=args.accumulator_dtype or None,
            accumulation_steps=accum,
            mesh=mesh,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)
        self.train_step = make_train_step(
            self.model, self.optimizer, pos_weight, self.generator, debug_nans=args.debug_nans
        )

        self.best_metric: Optional[float] = None
        self.best_checkpoint: Optional[str] = None
        self.start_epoch = 0
        self._start_step = 0
        self.writer = None
        if args.report_to == "tensorboard" and self.is_main:
            self.writer = EventWriter(args.logging_dir or f"{args.output_dir}/logs")
        elif args.report_to not in ("", "none"):
            logger.warning("report_to %r: only 'tensorboard' writes anything (as in the "
                           "JAX trainer)", args.report_to)
        if args.resume_from_checkpoint:
            self._maybe_resume(args.resume_from_checkpoint)

    def _maybe_resume(self, spec: str) -> None:
        path = ckpt_lib.latest_train_state(self.args.output_dir) if spec == "auto" else spec
        if not path:
            return
        meta = ckpt_lib.restore_train_state(path, self.model, self.optimizer, self.generator)
        self.start_epoch = int(meta.get("epoch", 0))
        self._start_step = int(meta.get("step", 0))
        self.best_metric = meta.get("best_metric")
        self.best_checkpoint = meta.get("best_checkpoint")
        logger.info("resumed from %s (epoch %d, step %d)", path, self.start_epoch, self._start_step)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.train_ds)
        if self.args.sampler == "weighted":
            w = build_multilabel_sample_weights(self.train_ds.labels)
            return weighted_sample_indices(w, n, seed=self.args.seed + epoch)
        order = np.arange(n)
        np.random.default_rng(self.args.seed + epoch).shuffle(order)
        return order

    def predict(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        return self.eval_logits(
            self.model, dataset, self.args.per_device_eval_batch_size, self.args.num_workers,
            mesh=self.mesh,
        )

    def evaluate(self, dataset=None) -> Dict[str, float]:
        dataset = dataset if dataset is not None else self.eval_ds
        t0 = time.time()
        logits, labels = self.predict(dataset)
        metrics = self.compute_metrics((logits, labels))
        dt = time.time() - t0
        # the reference trainer.evaluate schema (test_loss, test_runtime, ...)
        metrics["loss"] = float(bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)))
        metrics["runtime"] = dt
        metrics["samples_per_second"] = len(dataset) / dt if dt > 0 else 0.0
        return metrics

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's loss over the whole global batch: the data axis's mean
        of the ranks' losses (each over its equal share of the rows)."""
        return loss if self.mesh is None else self.mesh.mean(loss)

    def _is_better(self, value: float) -> bool:
        if self.best_metric is None:
            return True
        if self.args.greater_is_better:
            return value > self.best_metric
        return value < self.best_metric

    def train(self) -> Dict[str, Any]:
        args = self.args
        step = self._start_step
        epochs_without_improvement = 0
        history = []
        t_start = time.time()
        timer = StepTimer(warmup=1)

        for epoch in range(self.start_epoch, args.num_train_epochs):
            # the eval/checkpoint pause between epochs is not a train step
            timer.reset_clock()
            items = host_batches(
                self.train_ds, args.per_device_train_batch_size, self.patch_size,
                self._epoch_indices(epoch), args.num_workers, self.mesh,
            )
            losses = []
            for batch in prefetch_to_device(items, self.device, size=args.prefetch):
                loss = self.train_step(batch)
                step += 1
                timer.tick()
                if step % args.logging_steps == 0:
                    loss_val = float(self._mean_loss(loss))
                    losses.append(loss_val)
                    sps = timer.samples_per_second(args.per_device_train_batch_size)
                    logger.info(
                        "step %d/%d loss %.4f (%.1f samples/s, %.0f ms/step)",
                        step, self.total_steps, loss_val, sps, timer.mean_step_seconds * 1000,
                    )
                    if self.writer:
                        self.writer.scalar("train/loss", loss_val, step)
                        self.writer.scalar("train/samples_per_second", sps, step)
                if 0 < args.max_steps <= step:
                    break

            metrics = self.evaluate()
            metrics["epoch"] = epoch + 1
            metrics["train_loss"] = (float(np.mean(losses)) if losses
                                     else float(self._mean_loss(loss)))
            history.append(metrics)
            logger.info("epoch %d eval: %s", epoch + 1, metrics)
            if self.writer:
                for k, v in metrics.items():
                    if isinstance(v, (int, float)):
                        self.writer.scalar(f"eval/{k}", v, step)
                self.writer.flush()

            ckpt_path = ckpt_lib.save_checkpoint(
                args.output_dir, self.model, step,
                save_total_limit=args.save_total_limit, keep=self.best_checkpoint,
                mesh=self.mesh,
            )
            value = metrics.get(args.metric_for_best_model)
            if value is not None and self._is_better(value):
                self.best_metric = value
                self.best_checkpoint = ckpt_path
                epochs_without_improvement = 0
            else:
                epochs_without_improvement += 1

            ckpt_lib.save_train_state(
                args.output_dir, step, self.model, self.optimizer, self.generator,
                meta={
                    "epoch": epoch + 1,
                    "step": step,
                    "best_metric": self.best_metric,
                    "best_checkpoint": self.best_checkpoint,
                },
                mesh=self.mesh,
            )
            if args.early_stopping and epochs_without_improvement >= args.early_stopping_patience:
                logger.info("early stopping at epoch %d", epoch + 1)
                break
            if 0 < args.max_steps <= step:
                break

        if args.load_best_model_at_end and self.best_checkpoint:
            ckpt_lib.restore_checkpoint(self.best_checkpoint, self.model)

        return {
            "history": history,
            "best_metric": self.best_metric,
            "best_checkpoint": self.best_checkpoint,
            "train_runtime": time.time() - t_start,
            # rolling throughput (steady state, warm-up skipped)
            "train_samples_per_second": timer.samples_per_second(
                args.per_device_train_batch_size
            ),
            "global_step": step,
        }
