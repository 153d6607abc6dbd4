"""uint8 wire-format inference engine (the fast evaluation path).

Raw uint8 patch rows cross to the device (4x fewer bytes than fp32
pixels); the fused normalise + patch-embed kernel embeds them and the rest
of the towers run as usual. ``evaluate_logits_u8`` streams a dataset
through the engine with host preparation (``score_batches``) on a
background thread, pinned host buffers, non-blocking copies and at most two
batches in flight, with optional exact text-length buckets (with the SigLIP
carry column; CLIP's and DeepSeek-V2's causal towers truncate). Over a
dataset's pixel cache a batch's patch rows are gathered from the cache
straight into pinned memory by one native call outside the interpreter
lock.

Under a mesh (``parallel/mesh.py``) the rows are split over the data axis
as the JAX engine's ``shard_map`` splits them: each data rank reads,
prepares and runs its slice of every global batch, and the logits are
gathered back in the dataset's row order on every rank (one ``all_reduce``
of a zero-filled buffer). The ranks of one model group run the same rows
through a model split over them. The rows a rank runs follow its data
index on the grid, never its rank number or its device.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models.u8wire import fold_for_model
from multimodal_content_moderation_tpu_torch.ops.cuda_image import (
    extract_patches_u8,
    gather_patches_u8,
)
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count, is_recording


class FastInferenceEngine:
    """u8-wire forward of a ``FusionModel`` or a ``MultiTaskModel`` on the
    model's device.

    On the card the patch embed is the ``patch_embed_u8`` kernel, with the
    normalisation folded into its weight once, here; the attention core
    follows the model's ``attention_impl``. A call runs the
    rows it is given; with a ``mesh``, ``evaluate_logits_u8`` gives each
    data rank its rows and gathers the logits."""

    # the device scalars the last call's forward left for an open recording
    # (a packing tower's ``moe.max_expert_slots``), read with its logits
    last_counters = None

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
        if packs_text(self.model.backend):
            # the packed tower's token count, from the host's mask where it
            # is on the host (a read of the card's copy would wait for it)
            if not (isinstance(mask, torch.Tensor) and mask.device.type != "cpu"):
                batch["text_kept"] = int(np.asarray(mask).sum())
            if is_recording():
                batch["counters"] = {}
        logits = self.model(batch)["logits"].float()
        self.last_counters = batch.get("counters")
        return logits


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
    """Whether text buckets leave a backend's logits as they are: CLIP,
    SigLIP and DeepSeek-V2, not the generic towers (a mean over every
    position, pads included)."""
    return backend != "generic"


def truncates(backend: str) -> bool:
    """Whether a backend's bucket is a plain truncation (a causal tower
    pooled at a real token never sees the dropped trailing pads: CLIP,
    DeepSeek-V2) rather than SigLIP's carry column."""
    return backend in ("clip", "deepseek_v2")


def bucket_extra(backend: str) -> int:
    """The columns a bucket reserves beside the longest row: SigLIP's carry
    column, none where the bucket truncates."""
    return 0 if truncates(backend) else 1


def packs_text(backend: str) -> bool:
    """Whether the text tower packs the kept tokens (DeepSeek-V2), so the
    engine hands it the mask's sum from the host."""
    return backend == "deepseek_v2"


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

    CLIP and DeepSeek-V2 (``truncates``): plain truncation (a causal tower
    pooled at the first EOS or the last kept token never sees the dropped
    columns), carry_pos None. SigLIP: b-1 real columns plus
    a carry column, the row's last column (a PAD, since ``bucket_for(...,
    extra=1)`` fits every row in b-1) with mask 0, embedded at position T-1
    (carry_pos): the tower pools the last column and masked keys are inert
    at any width, so this is exact."""
    if b >= ids.shape[1]:
        return ids, mask, None
    if truncates(backend):
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


def _count_batch(model, host, valid: int, width: int) -> None:
    """A recorded batch's counters (``utils/profiling.count``); a packing
    tower's from the host's mask too (``deepseek_v2.count_packing``)."""
    mask = host["attention_mask"]
    if packs_text(model.backend):
        from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import count_packing

        count_packing(model.encoder_config, mask)
    count("score.batches")
    count("score.rows", valid)
    count("score.pad_rows", mask.shape[0] - valid)
    count(f"score.bucket.{width}")
    count("score.text_tokens", int(mask.sum()))
    count("score.text_slots", mask.numel())
    count("score.h2d_bytes", sum(v.numel() * v.element_size() for v in host.values()))


def _readback(logits, batch: int, width: int, counters=None) -> np.ndarray:
    """The batch's logits on the host, and the device counters its forward
    left (``FastInferenceEngine.last_counters``), read once the logits are."""
    with annotate("score.readback", batch=batch, width=width):
        out = logits.cpu().numpy()
        for name, value in (counters or {}).items():
            count(name, int(value))
        return out


def _padded(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``n`` rows."""
    if len(a) == n:
        return a
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def _load_cached(dataset, idx: np.ndarray, batch_size: int, pool):
    """``prep.load`` over a dataset's pixel cache: the rows the cache lacks
    decoded (and cached) through ``pool`` first, then every row's flags in
    one read. Returns (the batch's text, flags and labels as
    ``CSVDataset.batches`` pads them, the cache's pixel array, the rows to
    gather from it with -1 for each pad, the rows decoded)."""
    cache = dataset.cache
    src, filled, present = cache.lookup(idx)
    cold = idx[~filled]
    if len(cold):
        list(pool.map(dataset.load_image, cold))
        src, filled, present = cache.lookup(idx)
    batch = {
        "input_ids": _padded(dataset.input_ids[idx], batch_size),
        "attention_mask": _padded(dataset.attention_mask[idx], batch_size),
        "text_present": _padded(dataset.text_present[idx], batch_size),
        "image_present": _padded(present, batch_size),
        "labels": dataset.labels[idx],
    }
    rows = np.full(batch_size, -1, np.int64)
    rows[: len(idx)] = idx
    return batch, src, rows, len(cold)


def score_batches(engine: FastInferenceEngine, dataset, batch_size: int,
                  rows: Optional[np.ndarray] = None, ladder: Optional[Sequence[int]] = None,
                  num_workers: int = 8, parent: Optional[int] = None):
    """The host half of ``evaluate_logits_u8``: for each batch of
    ``batch_size`` rows of ``dataset`` in the order ``rows`` (every row in
    order where None; the last batch padded), ``(valid, labels, host, carry,
    width)``. ``host`` holds the engine's inputs as tensors, pinned where the
    engine is on the card; with a ``ladder`` the text shrinks to the batch's
    bucket (``bucket_for``, ``bucket_batch_text``: ``carry`` and ``width``).

    Over a pixel cache (a ``CSVDataset`` with ``cache_dir``) the rows the
    cache lacks are decoded first on ``num_workers`` threads; then one
    native call (``gather_patches_u8``, on up to ``num_workers`` threads,
    outside the interpreter lock) writes every row's patch rows from the
    cache into the pinned buffer. Any other dataset's ``batches`` stack its
    crops, and the same call lays them out.

    Spans (children of ``parent``): ``prep.load`` (the cache's flags and
    any decode; the dataset's batch), ``prep.patches`` (the gather),
    ``prep.bucket``, ``prep.pin`` (the small arrays into pinned memory).
    Counters: ``prep.gathered_rows`` (rows taken from the cache without a
    decode) and ``prep.decoded_rows`` (the others); they add up to the rows
    scored. The pinned buffers come from PyTorch's caching host allocator,
    which holds a freed buffer back until the copies recorded on it are
    done, so nothing here keeps them alive."""
    backend = engine.model.backend
    pin = engine.device.type == "cuda"
    order = np.arange(len(dataset)) if rows is None else np.asarray(rows)
    cached = getattr(dataset, "cache", None) is not None
    workers = max(int(num_workers), 1)
    batches = None if cached else dataset.batches(
        batch_size, pad_to_batch=True, num_workers=num_workers, indices=order)
    pool = cf.ThreadPoolExecutor(max_workers=workers) if cached else None
    try:
        for i, start in enumerate(range(0, len(order), batch_size)):
            idx = order[start: start + batch_size]
            valid = len(idx)
            with annotate("prep.load", parent=parent, batch=i) as load:
                if cached:
                    batch, src, pixel_rows, decoded = _load_cached(dataset, idx, batch_size, pool)
                else:
                    batch = next(batches)
                    src, pixel_rows, decoded = batch.pop("pixel_values"), None, valid
                    batch.pop("_valid")
            labels = batch.pop("labels")[:valid]
            with annotate("prep.patches", parent=parent, batch=i) as patch:
                _, H, W, C = src.shape
                p = engine.patch_size
                patches = torch.empty((batch_size, (H // p) * (W // p), C * p * p),
                                      dtype=torch.uint8, pin_memory=pin)
                gather_patches_u8(src, pixel_rows, p, out=patches.numpy(), threads=workers)
            carry, width = None, batch["input_ids"].shape[1]
            with annotate("prep.bucket", parent=parent, batch=i) as bucket:
                if ladder is not None:
                    width = bucket_for(batch["attention_mask"], ladder,
                                       extra=bucket_extra(backend))
                    batch["input_ids"], batch["attention_mask"], carry = bucket_batch_text(
                        batch["input_ids"], batch["attention_mask"], width, backend
                    )
            with annotate("prep.pin", parent=parent, batch=i, width=width):
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                host["patches_u8"] = patches
            if is_recording():
                for span in (load, patch, bucket):
                    span.set(width=width)
                count("prep.gathered_rows", valid - decoded)
                count("prep.decoded_rows", decoded)
                _count_batch(engine.model, host, valid, width)
            yield valid, labels, host, carry, width
    finally:
        if batches is not None:
            batches.close()  # the dataset's pool, as its end would
        if pool is not None:
            pool.shutdown(wait=False)


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

    indices = ladder = None
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

    # the host input runs two batches ahead on a background thread,
    # overlapping the device work
    q, _END, err, cancel = bounded_producer(
        lambda: score_batches(engine, dataset, rank_batch, rows=rows, ladder=ladder,
                              num_workers=num_workers, parent=root),
        size=2,
    )

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
            outs.append((logits, i, width, engine.last_counters))
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
