"""The fine-tuning step of the shipped recipe, in plain fp32 PyTorch, as the
reference composes it from optax:

    MultiSteps(k)(chain(clip_by_global_norm(max_norm),
                        multi_transform({"encoder": adamw(lr_encoder),
                                         "head": adamw(lr_head)})))

with each group's learning rate on a linear warmup (from 0) and a cosine
decay to 0. Leaves named ``backbone.*`` take ``lr_encoder``, the rest
``lr_head``. A leaf the loss does not reach has a zero gradient and moves by
weight decay alone.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def schedule(peak: float, total: int, warmup_ratio: float):
    warmup = max(int(total * warmup_ratio), 0)
    decay = max(total - warmup, 1)

    def lr(count: int) -> float:
        if warmup and count < warmup:
            return peak * count / warmup
        c = min(max(count - warmup, 0), decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr_encoder: float, lr_head: float,
                 weight_decay: float, max_grad_norm: float, total_updates: int,
                 warmup_ratio: float, accumulation: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr = {"encoder": schedule(lr_encoder, total_updates, warmup_ratio),
                   "head": schedule(lr_head, total_updates, warmup_ratio)}
        self.wd, self.max_norm, self.k = weight_decay, max_grad_norm, accumulation
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.micro = 0
        self.count = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Accumulate this micro-step's gradients (a running mean); apply an
        update on every k-th call. Returns whether it updated."""
        self.micro += 1
        for n, p in self.params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            self.acc[n] += (g - self.acc[n]) / self.micro
        if self.micro < self.k:
            return False
        grads = self.acc
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        scale = 1.0 if norm < self.max_norm else self.max_norm / norm
        c = self.count + 1
        bc1, bc2 = 1 - self.b1 ** c, 1 - self.b2 ** c
        for n, p in self.params.items():
            g = grads[n] * scale
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + self.eps) + self.wd * p
            group = "encoder" if n.startswith("backbone.") else "head"
            p.add_(u, alpha=-self.lr[group](self.count))
        self.count = c
        self.micro = 0
        for a in self.acc.values():
            a.zero_()
        return True

    def first_moment_grads(self) -> Dict[str, torch.Tensor]:
        """The clipped mean gradient of the first update, read back from the
        first moment after it (m = (1 - b1) g)."""
        return {n: m / (1 - self.b1) for n, m in self.m.items()}


def leaf_norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in ts.items()}

