"""uint8 wire-format inference engine (the fast evaluation path).

Raw uint8 patch rows cross to the device (4x fewer bytes than fp32
pixels); the fused normalise + patch-embed kernel embeds them and the rest
of the towers run as usual. ``evaluate_logits_u8`` streams a dataset
through the engine with host preparation on a background thread, pinned
host buffers, non-blocking copies and at most two batches in flight, with
optional exact text-length buckets (with the SigLIP carry column).

Under a mesh (``parallel/mesh.py``) the rows are split over the data axis
as the JAX engine's ``shard_map`` splits them: each data rank reads,
prepares and runs its slice of every global batch, and the logits are
gathered back in the dataset's row order on every rank (one ``all_reduce``
of a zero-filled buffer). The ranks of one model group run the same rows
through a model split over them. The rows a rank runs follow its data
index on the grid, never its rank number or its device.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models.u8wire import fold_for_model
from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count, is_recording


class FastInferenceEngine:
    """u8-wire forward of a ``FusionModel`` or a ``MultiTaskModel`` on the
    model's device.

    On the card the patch embed is the ``patch_embed_u8`` kernel, with the
    normalisation folded into its weight once, here; the attention core
    follows the model's ``attention_impl``. A call runs the
    rows it is given; with a ``mesh``, ``evaluate_logits_u8`` gives each
    data rank its rows and gathers the logits."""

    def __init__(self, model, mean: Sequence[float], std: Sequence[float], mesh=None):
        self.mesh = mesh
        model = model.replace(
            image_mean=tuple(float(m) for m in mean),
            image_std=tuple(float(s) for s in std),
        )
        # the weights are fixed for the engine's life: fold once, not on
        # every call (the fold's stats cross to the card synchronously)
        with torch.no_grad():
            self.model = model.replace(patch_fold=fold_for_model(model, model.backbone))
        self.device = model.device
        self.patch_size = self.model.encoder_config.vision.patch_size

    def patches_from_hwc(self, images_hwc: np.ndarray) -> np.ndarray:
        """[B, H, W, C] uint8 crops -> wire-format patch rows."""
        return extract_patches_u8(images_hwc, self.patch_size)

    def to_device(self, x) -> torch.Tensor:
        """Host array or tensor -> tensor on the engine's device (a
        non-blocking copy from pinned memory)."""
        t = torch.as_tensor(x)
        return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(
        self, ids, mask, patches_u8, text_present, image_present,
        carry_pos: Optional[int] = None,
    ) -> torch.Tensor:
        """Logits [B, C] in fp32, on the engine's device.

        ``carry_pos`` (an int) marks the last ids/mask column as the SigLIP
        bucket carry slot: a PAD token embedded at position ``carry_pos``,
        the position the unbucketed run pools (the full text width - 1).
        ``bucket_batch_text`` returns it."""
        batch = {
            "input_ids": self.to_device(ids),
            "attention_mask": self.to_device(mask),
            "patches_u8": self.to_device(patches_u8),
            "text_present": self.to_device(text_present),
            "image_present": self.to_device(image_present),
        }
        if carry_pos is not None:
            T = batch["input_ids"].shape[1]
            pos = torch.arange(T, device=self.device)
            pos[-1:].fill_(carry_pos)  # an assignment would copy the int over, synchronously
            batch["position_ids"] = pos
        return self.model(batch)["logits"].float()


def parse_seq_buckets(spec: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Parse a ``--seq_buckets`` value: ``auto`` -> the (32, 48, 64) ladder,
    ``off``/``none``/empty -> None, otherwise a comma-separated list."""
    sb = (spec or "off").strip().lower()
    if sb == "auto":
        return (32, 48, 64)
    if sb in ("off", "none", ""):
        return None
    try:
        return tuple(int(b) for b in sb.split(","))
    except ValueError:
        raise ValueError(
            f"invalid seq-buckets spec {spec!r}: expected 'auto', 'off', or a "
            "comma-separated list of token widths (e.g. '32,48,64')"
        ) from None


def buckets_exact(backend: str) -> bool:
    """Whether text buckets leave a backend's logits as they are: CLIP and
    SigLIP, not the generic towers (a mean over every position, pads
    included)."""
    return backend != "generic"


def bucket_ladder(buckets: Sequence[int], full_T: int) -> Optional[List[int]]:
    """Sorted, deduplicated widths below ``full_T`` with ``full_T`` as the
    terminal rung, or None when no bucket is below ``full_T``."""
    ladder = sorted({int(b) for b in buckets if 0 < int(b) < full_T})
    return ladder + [full_T] if ladder else None


def bucket_for(mask, ladder: Sequence[int], extra: int = 0) -> int:
    """Smallest ladder width covering the batch's longest row plus ``extra``
    reserved columns (SigLIP passes 1 for its carry column); the terminal
    rung is the full width."""
    L = int(np.asarray(mask).sum(axis=1).max(initial=1)) + extra
    for b in ladder:
        if b >= L:
            return b
    return ladder[-1]


def bucket_batch_text(
    ids: np.ndarray, mask: np.ndarray, b: int, backend: str
) -> Tuple[np.ndarray, np.ndarray, Optional[int]]:
    """Shrink a right-padded [B, T] ids/mask pair to bucket width ``b``:
    (ids_b, mask_b, carry_pos).

    CLIP: plain truncation (the causal tower pooled at the first EOS never
    sees the dropped columns), carry_pos None. SigLIP: b-1 real columns plus
    a carry column, the row's last column (a PAD, since ``bucket_for(...,
    extra=1)`` fits every row in b-1) with mask 0, embedded at position T-1
    (carry_pos): the tower pools the last column and masked keys are inert
    at any width, so this is exact."""
    if b >= ids.shape[1]:
        return ids, mask, None
    if backend == "clip":
        return np.ascontiguousarray(ids[:, :b]), np.ascontiguousarray(mask[:, :b]), None
    ids_b = np.concatenate([ids[:, : b - 1], ids[:, -1:]], axis=1)
    mask_b = np.concatenate([mask[:, : b - 1], np.zeros((mask.shape[0], 1), mask.dtype)], axis=1)
    return ids_b, mask_b, ids.shape[1] - 1


def rank_positions(mesh, n: int, batch_size: int):
    """(positions, batch size): the positions of an order of ``n`` rows that
    this data rank runs, in batches of its share of ``batch_size``; every
    position in batches of ``batch_size`` without a mesh of several data
    ranks. A ``batch_size`` that does not divide by the data axis raises."""
    if mesh is None or mesh.num_data == 1:
        return np.arange(n), batch_size
    return mesh.positions(n, batch_size), batch_size // mesh.num_data


def gather_rank_rows(mesh, logits: List[np.ndarray], labels: List[np.ndarray],
                     positions: np.ndarray, n: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """Every data rank's (logits, labels) at their ``positions`` of an order
    of ``n`` rows, on every rank, as host arrays (one ``all_reduce``). The
    logits are as wide as the labels (the loss compares them element for
    element), so a rank whose slices were all pads still knows the width."""
    width = int(np.asarray(labels[0]).shape[1])
    local = np.zeros((len(positions), 2 * width), np.float32)
    if len(positions):
        local[:, :width] = np.concatenate(logits)
        local[:, width:] = np.concatenate(labels)
    full = mesh.gather_rows(torch.from_numpy(local).to(device), positions, n).cpu().numpy()
    return full[:, :width], full[:, width:]


def _count_batch(host, valid: int, width: int) -> None:
    """A recorded batch's counters (``utils/profiling.count``)."""
    mask = host["attention_mask"]
    count("score.batches")
    count("score.rows", valid)
    count("score.pad_rows", mask.shape[0] - valid)
    count(f"score.bucket.{width}")
    count("score.text_tokens", int(mask.sum()))
    count("score.text_slots", mask.numel())
    count("score.h2d_bytes", sum(v.numel() * v.element_size() for v in host.values()))


def _readback(logits, host, batch: int, width: int) -> np.ndarray:
    with annotate("score.readback", batch=batch, width=width):
        return logits.cpu().numpy()


def evaluate_logits_u8(
    engine: FastInferenceEngine,
    dataset,
    batch_size: int,
    num_workers: int = 8,
    seq_buckets: Optional[Sequence[int]] = None,
):
    """Stream a CSVDataset (built with a uint8_hwc preprocessor) through the
    fast engine; returns (logits, labels) host arrays in the dataset's
    natural row order. The last batch is padded to ``batch_size``.

    ``seq_buckets`` enables length-sorted bucketed evaluation: rows are
    visited in token-length order and each batch's ids/mask shrink to the
    smallest bucket covering its longest row. Exact for CLIP (causal text
    tower, first-EOS pooling) and SigLIP (masked keys, the carry column).
    The generic backend runs at the full width whatever ``seq_buckets``
    says, as in the JAX engine: its tower may mean-pool over every
    position, pads included, so a narrower batch changes its features.

    Under the engine's mesh each data rank runs its slice of every global
    batch of ``batch_size`` rows (of the length-sorted order with buckets)
    and every rank returns all the rows."""
    with annotate("score.evaluate", rows=len(dataset), batch_size=batch_size) as root:
        return _evaluate(engine, dataset, batch_size, num_workers, seq_buckets, root.id)


def _evaluate(engine, dataset, batch_size, num_workers, seq_buckets, root):
    """``evaluate_logits_u8`` inside its ``score.evaluate`` span (``root``,
    the parent of the prep thread's spans)."""
    from multimodal_content_moderation_tpu_torch.data.pipeline import bounded_producer

    indices = None
    backend = engine.model.backend
    full_T = dataset.input_ids.shape[1]
    if seq_buckets and buckets_exact(backend):
        ladder = bucket_ladder(seq_buckets, full_T)
        if ladder is not None:
            lengths = dataset.attention_mask.sum(axis=1)
            indices = np.argsort(lengths, kind="stable")
    n = len(dataset)
    positions, rank_batch = rank_positions(engine.mesh, n, batch_size)
    split = rank_batch != batch_size  # several data ranks share the rows
    order = np.arange(n) if indices is None else indices
    rows = order[positions] if split or indices is not None else None
    pin = engine.device.type == "cuda"

    # Host preparation (decode, patch extraction, pinning) runs two batches
    # ahead on a background thread, overlapping the device work.
    n_batches = -(-(n if rows is None else len(rows)) // rank_batch)

    def prep():
        batches = dataset.batches(
            rank_batch, pad_to_batch=True, num_workers=num_workers, indices=rows,
        )
        for i in range(n_batches):
            with annotate("prep.load", parent=root, batch=i) as load:
                batch = next(batches)
            valid = int(batch.pop("_valid"))
            labels = batch.pop("labels")[:valid]
            with annotate("prep.patches", parent=root, batch=i) as patch:
                patches = engine.patches_from_hwc(batch.pop("pixel_values"))
            carry, width = None, batch["input_ids"].shape[1]
            with annotate("prep.bucket", parent=root, batch=i) as bucket:
                if indices is not None:
                    width = bucket_for(batch["attention_mask"], ladder,
                                       extra=0 if backend == "clip" else 1)
                    batch["input_ids"], batch["attention_mask"], carry = bucket_batch_text(
                        batch["input_ids"], batch["attention_mask"], width, backend
                    )
            with annotate("prep.pin", parent=root, batch=i, width=width):
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                host["patches_u8"] = torch.from_numpy(patches)
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
            if is_recording():
                for span in (load, patch, bucket):
                    span.set(width=width)
                _count_batch(host, valid, width)
            yield valid, labels, host, carry, width
        batches.close()  # the dataset's pool, as its end would

    q, _END, err, cancel = bounded_producer(prep, size=2)

    all_logits, all_labels, valids, outs = [], [], [], []
    try:
        for i in itertools.count():
            with annotate("score.wait_batch", batch=i) as wait:
                item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                break
            valid, labels, host, carry, width = item
            wait.set(width=width)
            valids.append(valid)
            all_labels.append(labels)
            with annotate("engine.call", batch=i, width=width):
                logits = engine(
                    host["input_ids"], host["attention_mask"], host["patches_u8"],
                    host["text_present"], host["image_present"], carry_pos=carry,
                )
            # the pinned host buffers stay referenced until their batch is read
            outs.append((logits, host, i, width))
            if len(outs) > 2:
                all_logits.append(_readback(*outs.pop(0)))
    finally:
        cancel()
    all_logits.extend(_readback(*o) for o in outs)
    all_logits = [lg[:v] for lg, v in zip(all_logits, valids)]
    if split:
        logits, labels = gather_rank_rows(
            engine.mesh, all_logits, all_labels or [np.asarray(dataset.labels)[:0]],
            positions, n, engine.device,
        )
    else:
        logits, labels = np.concatenate(all_logits), np.concatenate(all_labels)
    if indices is not None:  # restore the dataset's natural row order
        inv = np.empty_like(indices)
        inv[indices] = np.arange(len(indices))
        logits, labels = logits[inv], labels[inv]
    return logits, labels
