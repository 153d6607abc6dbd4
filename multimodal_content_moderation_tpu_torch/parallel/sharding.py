"""Megatron tensor-parallel rules for the model axis (the JAX package's
``parallel/sharding.py``), on the port's dotted parameter names
(``backbone.text_model.layers.0.attn.q.w``).

Rules, keyed on the name, never on the shape:

- attention ``q/k/v``: column-parallel, the weight [D, D] split on its
  output (head) axis and the bias with it; each rank owns a contiguous run
  of heads;
- attention ``o``: row-parallel, the weight split on its input axis, the
  bias replicated (added once, after the partial sums are summed);
- MLP ``fc1``: column-parallel (weight on F, bias on F); ``fc2``:
  row-parallel (weight on F, bias replicated);
- ``token_embedding`` [V, D]: split over the vocabulary;
- everything else (LayerNorms, position and class embeddings, the patch
  embedding, projections, SigLIP's MAP head, every head parameter):
  replicated. The rules apply only inside a tower's ``layers.<i>.``.

A split whose axis does not divide by the model size falls back to
replication, as in JAX. The port adds one fallback: an attention block
whose head count does not divide by the model size stays replicated. JAX
can split columns across a head boundary because GSPMD repartitions the
product; the port's kernels take whole heads. The function is the same
either way.

``shard_params`` keeps the rank's shard of every split parameter and
records the split on it (``collectives.ModelSplit`` as
``param.model_split``); ``gather_params`` and ``gather_named`` build the
full tensors back (``all_reduce`` of zero-filled buffers over the model
group) for checkpoints and the export; ``load_full_state`` loads a full
state dict into a sharded model.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from multimodal_content_moderation_tpu_torch.parallel.collectives import ModelSplit, split_of
from multimodal_content_moderation_tpu_torch.parallel.mesh import MODEL_AXIS

COLUMN = ("attn.q", "attn.k", "attn.v", ".fc1")
ROW = ("attn.o", ".fc2")


def _spec_for(path: str, ndim: int) -> Optional[tuple]:
    """The partition spec of a parameter under the rules (a tuple of
    ``"model"`` / None of length ``ndim``), or None for replication."""
    if "layers." not in path:
        if path.endswith("token_embedding") and ndim == 2:
            return (MODEL_AXIS, None)  # vocabulary-axis split
        return None
    if path.endswith(".w"):
        stem = path[: -len(".w")]
        if stem.endswith(COLUMN) and ndim == 2:
            return (None, MODEL_AXIS)
        if stem.endswith(ROW) and ndim == 2:
            return (MODEL_AXIS, None)
    elif path.endswith(".b"):
        stem = path[: -len(".b")]
        if stem.endswith(COLUMN) and ndim == 1:
            return (MODEL_AXIS,)
    return None


def tower_heads(model) -> Dict[str, int]:
    """{tower prefix: its attention head count} of a fusion or multi-task
    model's backbone."""
    cfg = model.encoder_config
    return {"backbone.text_model.": cfg.text.num_heads,
            "backbone.vision_model.": cfg.vision.num_heads}


def param_shardings(shapes: Mapping[str, tuple], model_size: int,
                    heads: Optional[Mapping[str, int]] = None) -> Dict[str, Optional[int]]:
    """{name: the dimension split over the model axis, or None} for every
    parameter of ``shapes`` ({name: shape}). With ``model_size`` 1 nothing
    is split. ``heads`` ({name prefix: head count}) keeps an attention block
    whole where its heads do not divide by the model size."""
    out: Dict[str, Optional[int]] = {}
    for name, shape in shapes.items():
        out[name] = None
        if model_size <= 1:
            continue
        spec = _spec_for(name, len(shape))
        if spec is None:
            continue
        dim = spec.index(MODEL_AXIS)
        if shape[dim] % model_size or shape[dim] < model_size:
            continue
        if ".attn." in name and heads:
            n_heads = next((h for p, h in heads.items() if name.startswith(p)), None)
            if n_heads is not None and n_heads % model_size:
                continue
        out[name] = dim
    return out


def shard_params(model: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """Keep this rank's shard of every parameter the rules split (in place,
    before an optimizer is built over them) and record the split on it.
    Returns {name: split dimension or None}."""
    params = dict(model.named_parameters())
    splits = param_shardings({n: tuple(p.shape) for n, p in params.items()},
                             mesh.num_model, tower_heads(model))
    for name, dim in splits.items():
        if dim is None:
            continue
        p = params[name]
        size = p.shape[dim] // mesh.num_model
        with torch.no_grad():
            p.data = p.data.narrow(dim, mesh.model_index * size, size).contiguous()
        p.model_split = ModelSplit(dim, mesh.model_group, mesh.model_index, mesh.num_model)
    return splits


def gather_full(t: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's shard (``t`` itself
    where ``split`` is None)."""
    if split is None:
        return t
    shape = list(t.shape)
    shape[split.dim] *= split.size
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(split.dim, split.index * t.shape[split.dim], t.shape[split.dim]).copy_(t)
    dist.all_reduce(full, group=split.group)
    return full


def gather_named(tensors: Mapping[str, torch.Tensor], model: torch.nn.Module) -> Dict:
    """{name: full tensor} for tensors shaped like ``model``'s parameters of
    the same name (the parameters, the optimizer's moments)."""
    params = dict(model.named_parameters())
    return {n: gather_full(t.detach(), split_of(params.get(n))) for n, t in tensors.items()}


@torch.no_grad()
def gather_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full ``state_dict`` on every rank of its model groups;
    the ``state_dict`` itself where nothing is split."""
    return gather_named(model.state_dict(), model)


def shard_like(full: Mapping[str, torch.Tensor], model: torch.nn.Module) -> Dict:
    """This rank's shards of full tensors named like ``model``'s parameters."""
    params = dict(model.named_parameters())
    out = {}
    for n, t in full.items():
        split = split_of(params.get(n))
        if split is not None:
            size = t.shape[split.dim] // split.size
            t = t.narrow(split.dim, split.index * size, size)
        out[n] = t
    return out


@torch.no_grad()
def load_full_state(model: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state, strict=True)`` for a full state dict,
    each rank keeping its shards."""
    model.load_state_dict(shard_like(state, model), strict=True)
