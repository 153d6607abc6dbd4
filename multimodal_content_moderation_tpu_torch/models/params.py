"""Parameter trees as ``nn.Module``s that keep the JAX pytree's layout.

A ``ParamTree`` is built from a nested dict of tensors (lists become
``nn.ModuleList``). Its ``state_dict`` keys are the pytree paths, e.g.
``text_model.layers.0.attn.q.w``, and it reads like the dict it was built
from (``p["w"]``, ``"b" in p``), so the functional layers of ``ops.layers``
take it as their ``p`` and carrying JAX weights across is a leafwise copy.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = list(tree)
        for name, value in tree.items():
            setattr(self, name, _wrap(value))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self):
        return list(self._keys)


def _wrap(value):
    if isinstance(value, (nn.Module, nn.Parameter)):  # shared with another tree
        return value
    if isinstance(value, dict):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_wrap(v) for v in value])
    t = torch.as_tensor(value)
    return nn.Parameter(t, requires_grad=t.is_floating_point())


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list -> {dotted path: leaf}."""
    out: Dict[str, Any] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def map_leaves(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)
