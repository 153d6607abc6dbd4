"""Evaluation metrics on host numpy (the reference's
src/training/metrics.py report: same names, same numbers).

Every metric is computed in numpy alone, because the card's machine has
no sklearn: precision, recall and F1 with sklearn's ``zero_division=0`` and
averaging rules, and ROC-AUC by midranks (the Mann-Whitney statistic, ties
counted one half), which is the area sklearn's trapezoids give.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _f(value) -> float:
    """float() with NaN -> 0.0: newer sklearn returns NaN (instead of
    raising) for degenerate classes; the reference's except-path yields 0.0,
    so NaN is normalized to keep the artifact contract identical."""
    v = float(value)
    return 0.0 if np.isnan(v) else v


def _ratio(num, den) -> np.ndarray:
    """num / den, 0 where the denominator is 0 (sklearn's zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def _f1(tp, fp, fn) -> np.ndarray:
    """2tp / (2tp + fp + fn), 0 where the denominator is 0."""
    tp = np.asarray(tp, np.float64)
    return _ratio(2 * tp, 2 * tp + np.asarray(fp) + np.asarray(fn))


def _counts(y_true: np.ndarray, y_pred: np.ndarray):
    """Per-class (tp, fp, fn) as sklearn's ``average="macro"`` sees them: per
    label column of a multi-label [N, C>1] indicator; for one column, per
    class 0 and 1 that occurs in either array (sklearn reads a 0/1 column as
    a binary target)."""
    t = np.asarray(y_true).reshape(len(y_true), -1) == 1
    p = np.asarray(y_pred).reshape(len(y_pred), -1) == 1
    if t.shape[1] > 1:
        return tuple(np.sum(a, axis=0) for a in (t & p, ~t & p, t & ~p))
    t, p = t[:, 0], p[:, 0]
    classes = [c for c in (False, True) if np.any(t == c) or np.any(p == c)]
    return tuple(np.array([np.sum(a(c)) for c in classes]) for a in (
        lambda c: (t == c) & (p == c), lambda c: (t != c) & (p == c), lambda c: (t == c) & (p != c)))


def _binary_counts(y_true: np.ndarray, y_pred: np.ndarray):
    t = np.asarray(y_true).ravel() == 1
    p = np.asarray(y_pred).ravel() == 1
    return np.sum(t & p), np.sum(~t & p), np.sum(t & ~p)


def binary_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn ``f1_score(y_true, y_pred, zero_division=0)`` for 0/1 vectors."""
    return float(_f1(*_binary_counts(y_true, y_pred)))


def binary_precision_recall(y_true: np.ndarray, y_pred: np.ndarray):
    """sklearn ``precision_score`` and ``recall_score`` (``zero_division=0``)
    for 0/1 vectors."""
    tp, fp, fn = _binary_counts(y_true, y_pred)
    return float(_ratio(tp, tp + fp)), float(_ratio(tp, tp + fn))


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray):
    """(macro, micro) F1 as sklearn ``f1_score(average=..., zero_division=0)``
    computes them: per label column for a multi-label [N, C>1] indicator; for
    one column, over the classes 0 and 1 that occur in either array (sklearn
    reads a 0/1 column as a binary target, so its "macro" averages the F1 of
    both classes and its "micro" is the accuracy)."""
    tp, fp, fn = _counts(y_true, y_pred)
    macro = float(np.mean(_f1(tp, fp, fn)))
    if np.asarray(y_true).reshape(len(y_true), -1).shape[1] > 1:
        return macro, float(_f1(tp.sum(), fp.sum(), fn.sum()))
    t = np.asarray(y_true).ravel() == 1
    return macro, float(np.mean(t == (np.asarray(y_pred).ravel() == 1)))


def precision_recall_macro(y_true: np.ndarray, y_pred: np.ndarray):
    """(macro precision, macro recall) as sklearn ``precision_score`` and
    ``recall_score`` (``average="macro"``, ``zero_division=0``) compute them,
    with ``f1_scores``'s reading of the columns."""
    tp, fp, fn = _counts(y_true, y_pred)
    return float(np.mean(_ratio(tp, tp + fp))), float(np.mean(_ratio(tp, tp + fn)))


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve of one binary column by midranks; raises
    ValueError when only one class is present (as sklearn does)."""
    y = np.asarray(y_true).ravel() == 1
    s = np.asarray(scores).ravel()
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined.")
    # 1-based ranks, averaged over runs of equal scores
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    ranks = ((ends - counts + 1 + ends) / 2.0)[inv.ravel()]
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_macro(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Mean of the per-column areas; raises ValueError if any column has a
    single class."""
    t = np.asarray(y_true).reshape(len(y_true), -1)
    s = np.asarray(scores).reshape(len(scores), -1)
    return float(np.mean([roc_auc(t[:, j], s[:, j]) for j in range(t.shape[1])]))


def make_compute_metrics_multi(num_labels: int, threshold: float = 0.5) -> Callable:
    """Multi-label: f1_macro/f1_micro at ``threshold`` + roc_macro
    (reference metrics.py:10-55); a degenerate class gives roc_macro 0.0."""

    def compute_metrics(eval_pred):
        logits, labels = eval_pred
        probs = sigmoid(np.asarray(logits))
        labels = np.asarray(labels)
        f1_macro, f1_micro = f1_scores(labels, (probs >= threshold).astype(int))
        try:
            roc_macro = _f(roc_auc_macro(labels, probs))
        except ValueError:
            roc_macro = 0.0
        return {"f1_macro": f1_macro, "f1_micro": f1_micro, "roc_macro": roc_macro}

    return compute_metrics


def make_compute_metrics_mtl(task_names: List[str], threshold: float = 0.5) -> Callable:
    """Multi-task: the aggregate f1_macro/f1_micro/roc_macro plus
    ``f1_<task>`` and ``roc_<task>`` per task (reference metrics.py:58-113);
    a degenerate column gives its ROC-AUC, and the macro one, 0.0."""

    def compute_metrics(eval_pred):
        logits, labels = eval_pred
        probs = sigmoid(np.asarray(logits))
        labels = np.asarray(labels)
        bin_preds = (probs >= threshold).astype(int)
        f1_macro, f1_micro = f1_scores(labels, bin_preds)
        try:
            roc_macro = _f(roc_auc_macro(labels, probs))
        except ValueError:
            roc_macro = 0.0
        out = {"f1_macro": f1_macro, "f1_micro": f1_micro, "roc_macro": roc_macro}
        for j, name in enumerate(task_names):
            out[f"f1_{name}"] = binary_f1(labels[:, j], bin_preds[:, j])
            try:
                out[f"roc_{name}"] = _f(roc_auc(labels[:, j], probs[:, j]))
            except ValueError:
                out[f"roc_{name}"] = 0.0
        return out

    return compute_metrics


def calibrate_thresholds(
    probs: np.ndarray,
    y_true: np.ndarray,
    t_start: float = 0.05,
    t_end: float = 0.95,
    steps: int = 19,
) -> List[float]:
    """Per-class F1-maximizing threshold grid search (reference
    metrics.py:116-161; classes without positives get 0.5)."""
    grid = np.linspace(t_start, t_end, steps)
    best_thresholds: List[float] = []
    for j in range(probs.shape[1]):
        yj = y_true[:, j]
        if yj.sum() == 0:
            best_thresholds.append(0.5)
            continue
        pj = probs[:, j]
        best_t, best_f1 = 0.5, -1.0
        for t in grid:
            f1 = binary_f1(yj, (pj >= t).astype(int))
            if f1 > best_f1:
                best_f1, best_t = f1, t
        best_thresholds.append(float(best_t))
    return best_thresholds


def compute_detailed_metrics(
    probs: np.ndarray,
    y_true: np.ndarray,
    threshold: float = 0.5,
    class_names: Optional[List[str]] = None,
) -> dict:
    """Full report incl. precision/recall/support and per-class ROC
    (reference metrics.py:164-215), with the numbers sklearn gives: macro
    and micro F1, macro precision and recall, macro ROC-AUC (0.0 when a
    column holds one class), and per class F1, precision, recall, support
    and ROC-AUC (0.0 for a column with one class)."""
    bin_preds = (probs >= threshold).astype(int)
    n_classes = probs.shape[1]
    if class_names is None:
        class_names = [f"class_{i}" for i in range(n_classes)]

    f1_macro, f1_micro = f1_scores(y_true, bin_preds)
    precision_macro, recall_macro = precision_recall_macro(y_true, bin_preds)
    metrics = {
        "f1_macro": f1_macro,
        "f1_micro": f1_micro,
        "precision_macro": precision_macro,
        "recall_macro": recall_macro,
    }
    try:
        metrics["roc_auc_macro"] = _f(roc_auc_macro(y_true, probs))
    except ValueError:
        metrics["roc_auc_macro"] = 0.0

    metrics["per_class"] = {}
    for j, name in enumerate(class_names):
        precision, recall = binary_precision_recall(y_true[:, j], bin_preds[:, j])
        cm = {
            "f1": binary_f1(y_true[:, j], bin_preds[:, j]),
            "precision": precision,
            "recall": recall,
            "support": int(y_true[:, j].sum()),
        }
        try:
            cm["roc_auc"] = _f(roc_auc(y_true[:, j], probs[:, j]))
        except ValueError:
            cm["roc_auc"] = 0.0
        metrics["per_class"][name] = cm
    return metrics
