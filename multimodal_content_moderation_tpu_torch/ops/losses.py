"""Multi-label losses, as the JAX package's ``ops/losses.py`` computes them:

- ``bce_with_logits``: sigmoid BCE with an optional per-class ``pos_weight``
  (torch ``F.binary_cross_entropy_with_logits`` semantics);
- ``focal_with_logits``: sigmoid focal loss with an optional per-class alpha;
- ``asymmetric_loss``: the asymmetric multi-label loss (Ridnik et al. 2021);
- ``logit_adjust``: post-hoc logit adjustment on host arrays.

All in fp32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_weight: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """``-[pw*y*log(sigmoid(x)) + (1-y)*log(sigmoid(-x))]``."""
    logits = logits.float()
    targets = targets.float()
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = (
        torch.ones_like(targets)
        if pos_weight is None
        else torch.as_tensor(pos_weight, dtype=torch.float32, device=logits.device).expand_as(
            targets
        )
    )
    loss = -(pw * targets * log_p + (1.0 - targets) * log_not_p)
    return _reduce(loss, reduction)


def focal_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 1.5,
    alpha: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Sigmoid focal loss (Lin et al. 2017), optional per-class alpha."""
    logits = logits.float()
    targets = targets.float()
    prob = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets, reduction="none")
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
        loss = loss * (a * targets + (1.0 - a) * (1.0 - targets))
    return _reduce(loss, reduction)


def asymmetric_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma_neg: float = 4.0,
    gamma_pos: float = 1.0,
    clip: float = 0.05,
    reduction: str = "mean",
) -> torch.Tensor:
    """Asymmetric multi-label loss (Ridnik et al. 2021)."""
    logits = logits.float()
    targets = targets.float()
    prob = torch.sigmoid(logits)
    prob_neg = torch.clamp(prob + clip, max=1.0)

    loss_pos = targets * torch.log(torch.clamp(prob, min=1e-8))
    loss_neg = (1.0 - targets) * torch.log(torch.clamp(1.0 - prob_neg, min=1e-8))

    pt_pos = prob * targets + (1.0 - prob) * (1.0 - targets)
    pt_neg = prob_neg * targets + (1.0 - prob_neg) * (1.0 - targets)
    focal_pos = torch.pow(1.0 - pt_pos, gamma_pos)
    focal_neg = torch.pow(1.0 - pt_neg, gamma_neg)

    loss = -(focal_pos * loss_pos + focal_neg * loss_neg)
    return _reduce(loss, reduction)


def logit_adjust(logits, priors, tau: float = 1.0):
    """Post-hoc logit adjustment for class imbalance (Menon et al. 2021,
    multi-label sigmoid form): subtract ``tau * log(p/(1-p))`` per class."""
    p = np.clip(np.asarray(priors, np.float32), 1e-6, 1.0 - 1e-6)
    return logits - tau * np.log(p / (1.0 - p))
