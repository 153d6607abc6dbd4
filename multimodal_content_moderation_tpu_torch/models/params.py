"""Parameter trees as ``nn.Module``s that keep the JAX pytree's layout.

A ``ParamTree`` is built from a nested dict of tensors (lists become
``nn.ModuleList``). Its ``state_dict`` keys are the pytree paths, e.g.
``text_model.layers.0.attn.q.w``, and it reads like the dict it was built
from (``p["w"]``, ``"b" in p``), so the functional layers of ``ops.layers``
take it as their ``p`` and carrying JAX weights across is a leafwise copy.

Below them, the leaf readers and writers of the reference (Hugging Face)
layout that every family's converter shares: torch ``nn.Linear.weight`` is
(out, in) and a dense here (in, out); a patch ``Conv2d.weight``
(d, C, p, p) is a dense (C*p*p, d) over the channel-major patch rows.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

# the leaves of a whole dual encoder beside its towers, which a multi-task
# model's bare CLIP and generic towers do not hold
TOP_LEVEL = ("text_projection", "visual_projection", "logit_scale")


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


def _t(x) -> torch.Tensor:
    """torch tensor or ndarray -> an owned CPU tensor (a copy, so a later
    in-place update of the source cannot reach the converted tree)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def _linear(sd: Dict, name: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{name}.weight"]).t().contiguous()}
    if bias:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _ln(sd: Dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _conv_patch_embed(sd: Dict, name: str, bias: bool) -> dict:
    w = _t(sd[f"{name}.weight"])  # (d, C, p, p)
    p = {"w": w.reshape(w.shape[0], -1).t().contiguous()}
    if bias:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _strip_prefix(sd: Dict, prefix: str) -> Dict:
    if not prefix:
        return dict(sd)
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32, copy=True).contiguous()


def _linear_out(sd: Dict, name: str, p) -> None:
    sd[f"{name}.weight"] = _f32(p["w"]).t().contiguous()
    if "b" in p:
        sd[f"{name}.bias"] = _f32(p["b"])


def _ln_out(sd: Dict, name: str, p) -> None:
    sd[f"{name}.weight"] = _f32(p["scale"])
    sd[f"{name}.bias"] = _f32(p["bias"])


def _conv_out(p, vision_cfg) -> torch.Tensor:
    """A patch-embed dense (C*p*p, D) -> the ``Conv2d.weight`` (D, C, p, p)."""
    v = vision_cfg
    w = _f32(p["w"]).t()
    return w.reshape(v.hidden_size, v.num_channels, v.patch_size, v.patch_size).contiguous()


def _top_level_out(sd: Dict, bp, prefix: str, scalar_logits: bool) -> None:
    """A backbone's bias-free projections and its ``logit_scale`` /
    ``logit_bias``, where it holds them, under ``prefix``: the logit leaves
    as the scalars they are (CLIP, ``VisionTextDualEncoderModel``) or of
    shape (1,) (HF ``SiglipModel``'s parameters)."""
    for name in ("text_projection", "visual_projection"):
        if name in bp:
            sd[f"{prefix}{name}.weight"] = _f32(bp[name]["w"]).t().contiguous()
    for name in ("logit_scale", "logit_bias"):
        if name in bp:
            leaf = _f32(bp[name])
            sd[f"{prefix}{name}"] = leaf if scalar_logits else leaf.reshape(1)
