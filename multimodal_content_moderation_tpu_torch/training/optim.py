"""Two-group AdamW with global-norm clipping, warmup + decay schedules and
gradient accumulation, step for step as the JAX package's
``build_optimizer`` composes it from optax:

    MultiSteps(k)(chain(clip_by_global_norm(max_norm),
                        multi_transform({"encoder": adamw(lr_encoder),
                                         "head": adamw(lr_head),
                                         "frozen": set_to_zero()})))

It is written over the model's named parameters, not as ``torch.optim.AdamW``
+ ``clip_grad_norm_``, because those differ from optax where it matters:

- the global norm runs over every gradient, a frozen tower's included, and
  scales by ``max_norm / norm`` only when the norm is not below it (no 1e-6);
- a frozen tower gets a zero update and no weight decay;
- eps is added outside the square root; weight decay is added to the Adam
  direction of every leaf before the learning rate scales it;
- the schedule's first value is ``schedule(0)`` (0 under warmup);
- ``accumulator_dtype="bfloat16"`` keeps m and v in bf16 with fp32
  arithmetic (``scale_by_adam_compact``);
- accumulation keeps the running mean of k micro-step gradients and applies
  it on every k-th call.

Parameters under ``backbone.`` take ``lr_encoder``; the rest take ``lr_head``.
Updates are applied in place (``torch.no_grad``); nothing here synchronises
with the device.

Under a mesh (``parallel/mesh.py``) the gradients are averaged over the
data axis once per optimizer update, after the accumulated micro-steps, in
flat fp32 buckets (``all_reduce`` of a few large buffers, not one call per
leaf). The global norm counts each leaf once: the squares of the leaves
split over the model axis (``parallel/sharding.py``) are summed over the
model group, the replicated leaves' (the same on every rank of the group)
are added once. The moments are shaped like this rank's shards.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from multimodal_content_moderation_tpu_torch.parallel.collectives import split_of

ENCODER, HEAD, FROZEN = "encoder", "head", "frozen"
# elements at which a flat gradient bucket summed over the data axis closes (64 MiB of fp32)
BUCKET_ELEMENTS = 1 << 24


def label_for(name: str, freeze_text: bool = False, freeze_image: bool = False) -> str:
    """'encoder' | 'head' | 'frozen' for a parameter path: only the text and
    vision towers freeze; projections and the head always train."""
    if name.startswith("backbone."):
        tower = name.split(".")[1]
        if (freeze_text and tower == "text_model") or (freeze_image and tower == "vision_model"):
            return FROZEN
        return ENCODER
    return HEAD


def make_schedule(
    peak: float, total_steps: int, warmup_ratio: float, schedule: str = "cosine"
) -> Callable[[int], float]:
    """Learning rate at optimizer step ``count`` (0-based): linear warmup
    from 0, then cosine or linear decay to 0, or constant."""
    if schedule == "constant":
        return lambda count: peak
    warmup = max(int(total_steps * warmup_ratio), 0)
    decay_steps = max(total_steps - warmup, 1)

    def down(count: int) -> float:
        c = min(max(count, 0), decay_steps)
        if schedule == "linear":
            return peak * (1.0 - c / decay_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    if warmup == 0:
        return down

    def sched(count: int) -> float:
        if count < warmup:
            return peak * (min(max(count, 0), warmup) / warmup)
        return down(count - warmup)

    return sched


class AdamW:
    """The optimizer over ``named_params`` ({path: tensor}, updated in place).

    ``step()`` reads each parameter's ``.grad`` (None reads as zeros; the
    gradients are clipped in place) and returns True on the micro-steps that
    applied an update."""

    def __init__(
        self,
        named_params: Dict[str, torch.Tensor],
        lr_encoder: float = 1e-5,
        lr_head: float = 5e-4,
        weight_decay: float = 0.02,
        max_grad_norm: float = 1.0,
        total_steps: int = 1000,
        warmup_ratio: float = 0.05,
        schedule: str = "cosine",
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        freeze_text: bool = False,
        freeze_image: bool = False,
        accumulator_dtype: Optional[str] = None,
        accumulation_steps: int = 1,
        mesh=None,
    ):
        self.params = dict(named_params)
        self.mesh = mesh
        self.labels = {n: label_for(n, freeze_text, freeze_image) for n in self.params}
        self.lr = {
            ENCODER: make_schedule(lr_encoder, total_steps, warmup_ratio, schedule),
            HEAD: make_schedule(lr_head, total_steps, warmup_ratio, schedule),
        }
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.compact = accumulator_dtype is not None
        self.state_dtype = getattr(torch, accumulator_dtype) if self.compact else None
        self.k = max(int(accumulation_steps), 1)
        self.count = 0  # optimizer updates applied
        self.mini_step = 0  # micro-steps accumulated toward the next update
        trained = [n for n in self.params if self.labels[n] != FROZEN]
        zeros = lambda n: torch.zeros_like(  # noqa: E731
            self.params[n], dtype=self.state_dtype or self.params[n].dtype
        )
        self.mu = {n: zeros(n) for n in trained}
        self.nu = {n: zeros(n) for n in trained}
        self.acc = (
            {n: torch.zeros_like(p) for n, p in self.params.items()} if self.k > 1 else None
        )

    @torch.no_grad()
    def step(self) -> bool:
        # a leaf the loss does not reach (logit_scale) has a zero gradient,
        # as jax.grad gives it: Adam moves it by weight decay alone
        grads = [
            torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
            for p in self.params.values()
        ]
        if self.acc is not None:
            # optax.MultiSteps: running mean acc + (g - acc) / (n + 1)
            acc = list(self.acc.values())
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(acc, delta)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return False
            grads = acc
        self._average_over_data(grads)
        self._update(dict(zip(self.params, grads)))
        if self.acc is not None:
            self.mini_step = 0
            torch._foreach_zero_(list(self.acc.values()))
        return True

    def _average_over_data(self, grads) -> None:
        """The mean of every gradient over the data axis, in place: flat
        fp32 buckets (each closes at the leaf that takes it to
        ``BUCKET_ELEMENTS``), one ``all_reduce`` each, whenever the process
        is in a group (a group of one sums nothing, but its collective
        runs)."""
        mesh = self.mesh
        if mesh is None or mesh.data_group is None:
            return
        bucket, n = [], 0
        for i, g in enumerate(grads):
            bucket.append(g)
            n += g.numel()
            if n >= BUCKET_ELEMENTS or i == len(grads) - 1:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                dist.all_reduce(flat, group=mesh.data_group)
                flat.div_(mesh.num_data)
                for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                    t.copy_(piece.view_as(t))
                bucket, n = [], 0

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole model's gradient, each leaf counted once:
        the split leaves' squares summed over their model group."""
        splits = {n: split_of(self.params[n]) for n in grads}

        def squares(gs):
            return torch.stack(torch._foreach_norm(gs)).square().sum()

        sq_split = squares([g for n, g in grads.items() if splits[n] is not None])
        group = next(s.group for s in splits.values() if s is not None)
        dist.all_reduce(sq_split, group=group)
        return (squares([g for n, g in grads.items() if splits[n] is None]) + sq_split).sqrt()

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer update from the (mean) gradients, which are clipped
        in place. Multi-tensor (``torch._foreach_*``) ops: a few launches per
        group, not a few per parameter."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            # clip_by_global_norm over every leaf, frozen towers included:
            # g if norm < max_norm, else g * (max_norm / norm)
            g_all = list(grads.values())
            if any(split_of(p) is not None for p in self.params.values()):
                norm = self._global_norm(grads)
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g_all)))
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                self.max_grad_norm / norm)
            torch._foreach_mul_(g_all, scale)
        count = self.count + 1
        b1, b2 = self.b1, self.b2
        # fp32 scalars, as optax forms them (1 - decay**count in fp32)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        for label, sched in self.lr.items():
            names = [n for n in self.params if self.labels[n] == label]
            if not names:
                continue  # frozen leaves (optax.set_to_zero): no update, no decay
            ps = [self.params[n] for n in names]
            gs = [grads[n] for n in names]
            mu = [self.mu[n] for n in names]
            nu = [self.nu[n] for n in names]
            if self.compact:
                # fp32 arithmetic, the stored moments rounded to the state dtype
                m = torch._foreach_mul([t.float() for t in mu], b1)
                torch._foreach_add_(m, gs, alpha=1 - b1)
                v = torch._foreach_mul([t.float() for t in nu], b2)
                torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
                torch._foreach_copy_(mu, m)
                torch._foreach_copy_(nu, v)
            else:
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gs, alpha=1 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
                m, v = mu, nu
            # Adam direction m_hat / (sqrt(v_hat) + eps), eps outside the root
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(m, bc1)
            torch._foreach_div_(u, denom)
            if self.weight_decay:
                torch._foreach_add_(u, [p.float() for p in ps], alpha=self.weight_decay)
            if any(p.dtype != torch.float32 for p in ps):
                u = [t.to(p.dtype) for t, p in zip(u, ps)]
            torch._foreach_add_(ps, u, alpha=float(np.float32(-sched(self.count))))
        self.count = count

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "mini_step": self.mini_step,
            "mu": self.mu,
            "nu": self.nu,
            "acc": self.acc,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        for key in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            mine, theirs = getattr(self, key), state.get(key) or {}
            missing = set(mine) - set(theirs)
            if missing:
                raise KeyError(f"optimizer state {key!r} lacks {sorted(missing)[:3]}")
            for n, t in mine.items():
                t.copy_(theirs[n])
