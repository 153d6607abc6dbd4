"""JAX parameter pytrees (handed over as numpy arrays) and optax optimizer
states -> the port's parameters and ``training.optim.AdamW`` state. The
layouts are the same, so this is a leafwise copy; the tests use it to feed
one set of weights, or one mid-run training state, to both packages."""

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


def optimizer_state_from_optax(opt_state) -> dict:
    """An optax state of the JAX package's ``build_optimizer`` (optionally
    wrapped in ``optax.MultiSteps``) -> ``training.optim.AdamW.state_dict()``
    form: each group's ``ScaleByAdamState`` mu/nu (keyed by parameter path),
    the shared update count, and the accumulation state. The state is walked
    by its fields (mu/nu/count, inner_state(s), acc_grads), so this module
    needs neither JAX nor optax."""
    adam = []

    def visit(node):
        if all(hasattr(node, f) for f in ("mu", "nu", "count")):
            adam.append(node)
        elif hasattr(node, "inner_states"):
            for v in node.inner_states.values():
                visit(v)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)
        elif hasattr(node, "inner_opt_state"):
            visit(node.inner_opt_state)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v)

    visit(opt_state)
    counts = {int(np.asarray(a.count)) for a in adam}
    if len(counts) != 1:
        raise ValueError(f"expected one Adam update count across the groups, got {counts}")
    mu, nu = {}, {}
    for a in adam:
        mu.update(params_from_numpy(a.mu))
        nu.update(params_from_numpy(a.nu))
    state = {"count": counts.pop(), "mini_step": 0, "mu": mu, "nu": nu, "acc": None}
    if hasattr(opt_state, "acc_grads"):
        state["mini_step"] = int(np.asarray(opt_state.mini_step))
        state["acc"] = params_from_numpy(opt_state.acc_grads)
    return state
