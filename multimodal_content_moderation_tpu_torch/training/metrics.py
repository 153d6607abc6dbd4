"""Evaluation metrics on host numpy (the reference's
src/training/metrics.py report: same names, same sklearn scorers).
sklearn is imported where a report is computed."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _f(value) -> float:
    """float() with NaN -> 0.0: newer sklearn returns NaN (instead of
    raising) for degenerate classes; the reference's except-path yields 0.0,
    so NaN is normalized to keep the artifact contract identical."""
    v = float(value)
    return 0.0 if np.isnan(v) else v


def compute_detailed_metrics(
    probs: np.ndarray,
    y_true: np.ndarray,
    threshold: float = 0.5,
    class_names: Optional[List[str]] = None,
) -> dict:
    """Full report incl. precision/recall/support and per-class ROC
    (reference metrics.py:164-215)."""
    from sklearn.metrics import f1_score, precision_score, recall_score, roc_auc_score

    bin_preds = (probs >= threshold).astype(int)
    n_classes = probs.shape[1]
    if class_names is None:
        class_names = [f"class_{i}" for i in range(n_classes)]

    metrics = {
        "f1_macro": float(f1_score(y_true, bin_preds, average="macro", zero_division=0)),
        "f1_micro": float(f1_score(y_true, bin_preds, average="micro", zero_division=0)),
        "precision_macro": float(
            precision_score(y_true, bin_preds, average="macro", zero_division=0)
        ),
        "recall_macro": float(
            recall_score(y_true, bin_preds, average="macro", zero_division=0)
        ),
    }
    try:
        metrics["roc_auc_macro"] = _f(roc_auc_score(y_true, probs, average="macro"))
    except ValueError:
        metrics["roc_auc_macro"] = 0.0

    metrics["per_class"] = {}
    for j, name in enumerate(class_names):
        cm = {
            "f1": float(f1_score(y_true[:, j], bin_preds[:, j], zero_division=0)),
            "precision": float(
                precision_score(y_true[:, j], bin_preds[:, j], zero_division=0)
            ),
            "recall": float(recall_score(y_true[:, j], bin_preds[:, j], zero_division=0)),
            "support": int(y_true[:, j].sum()),
        }
        try:
            cm["roc_auc"] = _f(roc_auc_score(y_true[:, j], probs[:, j]))
        except ValueError:
            cm["roc_auc"] = 0.0
        metrics["per_class"][name] = cm
    return metrics
