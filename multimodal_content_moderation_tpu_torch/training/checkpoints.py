"""Checkpoints of the port's own format (``torch.save``), with the JAX
package's layout and retention (``training/checkpoints.py``):

- ``checkpoint-<step>/params.pt``: the model's ``state_dict`` (keys are the
  parameter-tree paths). Pruned to ``save_total_limit``, oldest first,
  never pruning ``keep`` (the best checkpoint).
- ``trainstate-<step>/state.pt`` + ``meta.json``: parameters, optimizer
  state and the dropout generator's state, for resuming; only the newest
  ``keep_last`` are kept.

One departure: the checkpoint just written is never pruned. The JAX
package's pruning can delete it at ``save_total_limit`` 1 and then name it
the best, so that load-best-at-end finds no files.

Tensors are saved from the CPU and restored onto the model's device.

Under a mesh (``mesh=``) every rank calls these functions: a model split
over the model axis is gathered whole first (``parallel/sharding.py``), so
a tensor-parallel run writes the same files as a one-device run; only the
mesh's main rank writes, and every rank waits at a barrier until the files
are there. A restore reads the full tensors on every rank, and each keeps
its shards.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from multimodal_content_moderation_tpu_torch.parallel.sharding import (
    gather_named,
    gather_params,
    load_full_state,
    shard_like,
)

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    return obj


def _numbered(output_dir: str, prefix: str) -> List[str]:
    if not os.path.isdir(output_dir):
        return []
    names = [n for n in os.listdir(output_dir) if re.fullmatch(rf"{prefix}-\d+", n)]
    names.sort(key=lambda n: int(n.rsplit("-", 1)[1]))
    return [os.path.join(output_dir, n) for n in names]


def list_checkpoints(output_dir: str) -> List[str]:
    return _numbered(output_dir, "checkpoint")


def save_checkpoint(
    output_dir: str,
    model: torch.nn.Module,
    step: int,
    save_total_limit: Optional[int] = None,
    keep: Optional[str] = None,
    mesh=None,
) -> str:
    """Save the model's parameters at ``checkpoint-<step>``; prune the oldest
    beyond the limit, never pruning ``keep`` or the new checkpoint."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    state = gather_params(model)  # every rank takes part in the gather
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return path
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_cpu(state), os.path.join(path, PARAMS_FILE))
    if save_total_limit and save_total_limit > 0:
        existing = list_checkpoints(output_dir)
        # never the best so far, nor the one just written: it may become the
        # best a moment later (the JAX package prunes it at limit 1)
        spared = {path, os.path.abspath(keep) if keep else None}
        prunable = [p for p in existing if os.path.abspath(p) not in spared]
        while len(existing) > save_total_limit and prunable:
            victim = prunable.pop(0)
            existing.remove(victim)
            shutil.rmtree(victim, ignore_errors=True)
    if mesh is not None:
        mesh.barrier()
    return path


def run_checkpoint(path: str, best_checkpoint_dir: Optional[str] = None) -> str:
    """The ``checkpoint-<step>`` directory to load for ``path``: ``path``
    itself where it holds parameters; for a run directory (as a model
    package unpacks it), the checkpoint named like ``best_checkpoint_dir``
    under it (the recorded path is the training machine's), else its newest
    ``checkpoint-<step>``."""
    if os.path.exists(os.path.join(path, PARAMS_FILE)):
        return path
    if best_checkpoint_dir:
        best = os.path.join(path, os.path.basename(os.path.normpath(best_checkpoint_dir)))
        if os.path.exists(os.path.join(best, PARAMS_FILE)):
            return best
    found = list_checkpoints(path)
    if not found:
        raise FileNotFoundError(f"{path}: no {PARAMS_FILE} and no checkpoint-<step> under it")
    return found[-1]


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The parameter ``state_dict`` saved by ``save_checkpoint`` (on the CPU)."""
    return torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``checkpoint-<step>`` into ``model`` (strict, in place; a model
    split over the model axis keeps its shards)."""
    load_full_state(model, load_params(path))
    return model


def save_train_state(
    output_dir: str,
    step: int,
    model: torch.nn.Module,
    optimizer,
    generator: torch.Generator,
    meta: dict,
    keep_last: int = 1,
    mesh=None,
) -> str:
    path = os.path.join(os.path.abspath(output_dir), f"trainstate-{step}")
    opt = dict(optimizer.state_dict())
    for key in ("mu", "nu", "acc"):
        if opt.get(key) is not None:
            opt[key] = gather_named(opt[key], model)
    params = gather_params(model)
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return path
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"params": _cpu(params), "optimizer": _cpu(opt),
                "generator": generator.get_state()}, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    for victim in _numbered(output_dir, "trainstate")[:-keep_last]:
        shutil.rmtree(victim, ignore_errors=True)
    if mesh is not None:
        mesh.barrier()
    return path


def latest_train_state(output_dir: str) -> Optional[str]:
    states = _numbered(output_dir, "trainstate")
    return states[-1] if states else None


def restore_train_state(
    path: str, model: torch.nn.Module, optimizer, generator: torch.Generator
) -> Dict[str, Any]:
    """Load a ``trainstate-<step>`` into the live objects (in place);
    returns its meta."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    load_full_state(model, state["params"])
    opt = dict(state["optimizer"])
    for key in ("mu", "nu", "acc"):
        if opt.get(key) is not None:
            opt[key] = shard_like(opt[key], model)
    optimizer.load_state_dict(opt)
    generator.set_state(state["generator"])
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
