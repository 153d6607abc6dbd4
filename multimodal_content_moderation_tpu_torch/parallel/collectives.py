"""The collectives of tensor parallelism (Megatron-LM's), and the split
record that a sharded parameter carries.

Only ``all_reduce`` and ``broadcast`` touch device tensors anywhere in the
port: they are the two collectives that every backend takes on a CUDA
tensor (NCCL, and gloo as well), so the same code runs on several cards
over NCCL and on one card shared by two gloo processes.

- ``ModelSplit``: which dimension of a parameter is split over the model
  axis, the group that holds the other shards, this rank's shard index and
  the group's size. ``parallel.sharding.shard_params`` sets it as the
  parameter's ``model_split`` attribute; the layers read it there.
- ``copy_to_model_parallel``: identity forward, ``all_reduce`` of the
  input's gradient backward (the input of a column-parallel dense).
- ``reduce_from_model_parallel``: ``all_reduce`` forward, identity backward
  (the partial sums of a row-parallel dense).
- ``vocab_parallel_lookup``: the rows of a table split over the vocabulary.
- ``set_data_shard`` / ``data_shard``: this process's rows of the global
  batch, which dropout reads to draw the global batch's mask and keep its
  own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """``dim`` of a parameter is split into ``size`` equal shards over
    ``group``; this rank holds shard ``index``."""

    dim: int
    group: Any
    index: int
    size: int


def split_of(t) -> Optional[ModelSplit]:
    """The ``ModelSplit`` a parameter carries, or None (replicated)."""
    return getattr(t, "model_split", None)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in place on a contiguous copy."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the input's gradient over ``group``
    (each rank's column shard contributes part of it)."""
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward passes the gradient
    through (every rank needs all of it)."""
    return _ReduceFromModelParallel.apply(x, group)


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table whose rows (the vocabulary) may be split
    over the model axis: each rank looks up the ids in its range, zeros the
    rest and the rows are summed over the group. A sum of one row and zeros
    is exact, so the result equals the unsplit lookup bit for bit."""
    split = split_of(table)
    ids = ids.long()
    if split is None:
        return table[ids]
    rows = table.shape[0]
    local = ids - split.index * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return reduce_from_model_parallel(out, split.group)


# this process's rows of every global batch: (data index, data size)
_DATA_SHARD: Tuple[int, int] = (0, 1)


def set_data_shard(index: int, size: int) -> None:
    """Record that this process holds rows ``[index*b, (index+1)*b)`` of
    every global batch of ``size*b`` rows (``parallel.mesh.Mesh.activate``)."""
    global _DATA_SHARD
    _DATA_SHARD = (int(index), int(size))


def data_shard() -> Tuple[int, int]:
    return _DATA_SHARD
