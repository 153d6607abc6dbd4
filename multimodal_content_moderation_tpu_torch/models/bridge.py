"""JAX parameter pytrees (handed over as numpy arrays) -> the port's
parameters. The layouts are the same, so this is a leafwise copy; the
tests use it to feed one set of weights to both packages."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from multimodal_content_moderation_tpu_torch.models.params import flatten


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """Nested dict/list of arrays -> {pytree path: CPU tensor}. bf16 leaves
    (ml_dtypes arrays) become torch bf16."""
    out = {}
    for path, leaf in flatten(tree).items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            out[path] = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[path] = torch.from_numpy(np.array(arr))
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX params tree into ``module`` (keys must match exactly;
    values are cast to each parameter's dtype and device)."""
    module.load_state_dict(params_from_numpy(tree), strict=True)
    return module
