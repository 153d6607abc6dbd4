"""The ("data", "model") mesh over the ranks of a ``torch.distributed``
world (the JAX package's ``parallel/mesh.py``).

- ``init_distributed``: ``init_process_group`` from its arguments or from
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, as
  ``torchrun`` sets them; NCCL on the card, gloo on the CPU. It does nothing
  for one process, and raises (never carries on alone) when a group of
  several cannot form within its timeout.
- ``build_mesh``: rank ``ranks[k]`` sits at ``(k // num_model, k %
  num_model)``, the layout of JAX's ``devices.reshape(num_data,
  num_model)``. A ``Mesh`` holds the process group of its data axis (the
  ranks with its model index) and of its model axis (the ranks with its
  data index). A world of one process is a mesh of one, with no group.
- ``Mesh.shard_batch``: the rank's rows of a global batch (every rank of a
  model group keeps the same rows); ``Mesh.replicate``: a broadcast of the
  parameters from the mesh's first rank; ``Mesh.gather_rows``: the rows of
  every data rank in data-index order; ``Mesh.mean``: a scalar's mean over
  the data axis; ``Mesh.barrier``.

Gathers are ``all_reduce`` sums of zero-filled buffers in which each rank
fills its own rows: exact (a value plus zeros), and one of the two
collectives that gloo takes on a CUDA tensor, so two processes can share
one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodal_content_moderation_tpu_torch.parallel.collectives import set_data_shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
# how long a collective waits for a rank that has stopped before it raises
TIMEOUT_S = 120


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group; returns whether the process is in one.

    ``coordinator_address`` is ``host:port`` (else ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (else
    ``WORLD_SIZE``), ``process_id`` the rank (else ``RANK``). The backend is
    NCCL for ``device="cuda"`` and gloo for the CPU unless ``backend`` names
    one; a named backend forms a group even for one process (a one-rank
    NCCL group runs its collectives for real). With NCCL the process takes
    the card ``LOCAL_RANK`` (default 0)."""
    if dist.is_initialized():
        return True
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None or (world <= 1 and backend is None):
        return False
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError(f"a world of {world} processes needs a rank (RANK)")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError(f"a world of {world} processes needs MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def local_device(device: str = "cuda") -> str:
    """``cuda:<LOCAL_RANK>`` for a bare ``"cuda"`` in a process that
    ``torchrun`` started (one card per process), else ``device``."""
    local = _env_int("LOCAL_RANK")
    if device == "cuda" and local is not None:
        return f"cuda:{local}"
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """This process's place on a ``num_data x num_model`` grid of ranks."""

    def __init__(self, grid: np.ndarray):
        self.grid = np.asarray(grid)
        self.num_data, self.num_model = (int(n) for n in self.grid.shape)
        self.ranks = [int(r) for r in self.grid.reshape(-1)]
        self.rank = rank()
        where = np.argwhere(self.grid == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not on the mesh {self.grid.tolist()}")
        self.data_index, self.model_index = (int(i) for i in where[0])
        self.data_group = self.model_group = None
        if dist.is_initialized():
            # every rank creates every group, in the same order
            for j in range(self.num_model):
                g = dist.new_group(self.grid[:, j].tolist())
                if j == self.model_index:
                    self.data_group = g
            for i in range(self.num_data):
                g = dist.new_group(self.grid[i, :].tolist())
                if i == self.data_index:
                    self.model_group = g

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.num_data, MODEL_AXIS: self.num_model}

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def is_main(self) -> bool:
        """The process that writes files: the world's rank 0."""
        return self.rank == 0

    def activate(self) -> "Mesh":
        """Make dropout draw the global batch's mask and keep this rank's
        rows (``collectives.set_data_shard``)."""
        set_data_shard(self.data_index, self.num_data)
        return self

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size`` rows."""
        if batch_size % self.num_data:
            raise ValueError(
                f"batch size {batch_size} not divisible by the data axis "
                f"({self.num_data}); pick batch_size as a multiple (the "
                "eval loop pads the last batch, so any full batch works)"
            )
        b = batch_size // self.num_data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's rows of every batched entry; scalars stay whole."""
        sizes = {v.shape[0] for v in batch.values() if v.ndim >= 1}
        if not sizes:
            return dict(batch)
        sl = self.rows(max(sizes))
        return {k: v[sl] if v.ndim >= 1 else v for k, v in batch.items()}

    def positions(self, n: int, batch_size: int) -> np.ndarray:
        """The rank's positions in an order of ``n`` rows read in global
        batches of ``batch_size`` (the last one padded): its slice of every
        batch, pads dropped."""
        sl = self.rows(batch_size)
        padded = -(-n // batch_size) * batch_size
        pos = np.arange(padded).reshape(-1, batch_size)[:, sl].reshape(-1)
        return pos[pos < n]

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Every parameter and buffer broadcast from the mesh's first rank,
        so that every rank starts from the same weights."""
        if dist.is_initialized() and self.size > 1:
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=self.ranks[0])
        return module

    def gather_rows(self, local: torch.Tensor, positions: np.ndarray, n: int) -> torch.Tensor:
        """[n, ...] from every data rank's rows: ``local[i]`` is row
        ``positions[i]``. An ``all_reduce`` of a zero-filled buffer over the
        data group, so every rank returns all ``n`` rows."""
        out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
        if len(positions):
            out[torch.as_tensor(positions, device=local.device)] = local
        if self.data_group is not None:
            dist.all_reduce(out, group=self.data_group)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar over the data axis (an all_reduce
        whenever the process is in a group, even a group of one)."""
        if self.data_group is None:
            return x
        x = x.detach().float().clone()
        dist.all_reduce(x, group=self.data_group)
        return x / self.num_data

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh(data={self.num_data}, model={self.num_model}, rank={self.rank} at "
                f"({self.data_index}, {self.model_index}))")


def layout(world: int, num_data: int = -1, num_model: int = 1,
           ranks: Optional[List[int]] = None) -> np.ndarray:
    """The [num_data, num_model] grid of ranks: ``ranks`` (the world's order
    by default) row by row. ``num_data=-1`` means every rank divided by
    ``num_model``. The grid must take every rank: a process left off it
    would wait at the first collective."""
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    num_model = int(num_model or 1)
    if num_data in (None, -1, 0):
        num_data = max(len(ranks) // num_model, 1)
    if num_data * num_model != world or sorted(ranks) != list(range(world)):
        raise ValueError(
            f"parallel {{data: {num_data}, model: {num_model}}} needs "
            f"{num_data * num_model} processes; this world has {world}, one device "
            "per process (launch with torchrun --nproc_per_node "
            f"{num_data * num_model}, or set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)"
        )
    return np.asarray(ranks).reshape(num_data, num_model)


def build_mesh(num_data: int = -1, num_model: int = 1,
               ranks: Optional[List[int]] = None) -> Mesh:
    """A ("data", "model") mesh over the world's ranks (``ranks``: their
    order on the grid), laid out by ``layout``."""
    return Mesh(layout(world_size(), num_data, num_model, ranks))
