"""Class-balanced weighted sampling (pure numpy; the JAX package's
``training/sampling.py``).

Effective-number class weights (Cui et al. 2019), per-example weight = sum
of positive-class weights, all-negative rows get 0.1x the minimum positive
weight. Sampling is a numpy categorical draw with replacement (torch
``WeightedRandomSampler(replacement=True)`` semantics) over index arrays.
"""

from __future__ import annotations

import numpy as np


def build_multilabel_sample_weights(labels: np.ndarray, beta: float = 0.999) -> np.ndarray:
    """[N, C] 0/1 labels -> [N] float64 sampling weights."""
    labels = np.asarray(labels, np.float32)
    pos_counts = np.clip(labels.sum(axis=0), 1.0, None)
    # fp32 intermediate math, as the reference computes it
    eff_num = np.float32(1.0) - np.power(np.float32(beta), pos_counts, dtype=np.float32)
    cls_w = np.float32(1.0 - beta) / eff_num
    w = (labels * cls_w[None, :]).sum(axis=1, dtype=np.float32)
    positive = w > 0
    min_pos = np.float32(w[positive].min()) if positive.any() else np.float32(1.0)
    return np.where(positive, w, min_pos * np.float32(0.1)).astype(np.float64)


def weighted_sample_indices(weights: np.ndarray, num_samples: int, seed: int = 0) -> np.ndarray:
    """Draw ``num_samples`` indices with replacement, p proportional to
    ``weights``."""
    weights = np.asarray(weights, np.float64)
    p = weights / weights.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(len(weights), size=num_samples, replace=True, p=p)
