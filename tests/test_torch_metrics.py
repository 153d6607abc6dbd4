"""The port's numpy metrics (``training/metrics.py``) against sklearn, which
the JAX package's metrics call, and against the JAX package's own
``make_compute_metrics_multi`` / ``calibrate_thresholds``.

Random and tied scores (rounded to 1-2 decimals), one label column and
five, degenerate columns included. Tolerance: F1 exact up to float
rounding (1e-12); ROC-AUC 1e-12 (midranks and sklearn's trapezoids give the
same area); thresholds equal."""

import warnings

import numpy as np
import pytest
from sklearn.metrics import f1_score, roc_auc_score

from multimodal_content_moderation_tpu.training import metrics as jm
from multimodal_content_moderation_tpu_torch.training import metrics as tm


def _case(seed):
    g = np.random.default_rng(seed)
    n = int(g.integers(2, 60))
    c = int(g.choice([1, 5]))
    y = (g.random((n, c)) < g.random()).astype(np.float32)
    decimals = int(g.integers(1, 3))
    probs = np.round(g.random((n, c)), decimals).astype(np.float32)
    return y, probs


@pytest.mark.parametrize("seed", range(12))
def test_f1_and_roc_auc_match_sklearn(seed):
    y, probs = _case(seed)
    pred = (probs >= 0.5).astype(int)
    macro, micro = tm.f1_scores(y, pred)
    assert macro == pytest.approx(f1_score(y, pred, average="macro", zero_division=0), abs=1e-12)
    assert micro == pytest.approx(f1_score(y, pred, average="micro", zero_division=0), abs=1e-12)
    for j in range(y.shape[1]):
        assert tm.binary_f1(y[:, j], pred[:, j]) == pytest.approx(
            f1_score(y[:, j], pred[:, j], zero_division=0), abs=1e-12
        )
        if 0 < y[:, j].sum() < len(y):
            assert tm.roc_auc(y[:, j], probs[:, j]) == pytest.approx(
                roc_auc_score(y[:, j], probs[:, j]), abs=1e-12
            )
        else:
            with pytest.raises(ValueError):
                tm.roc_auc(y[:, j], probs[:, j])


@pytest.mark.parametrize("seed", range(12, 20))
def test_compute_metrics_and_thresholds_match_jax(seed):
    y, probs = _case(seed)
    logits = np.log(np.clip(probs, 1e-4, 1 - 1e-4) / (1 - np.clip(probs, 1e-4, 1 - 1e-4)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's degenerate-class warning
        want = jm.make_compute_metrics_multi(y.shape[1])((logits, y))
    got = tm.make_compute_metrics_multi(y.shape[1])((logits, y))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert tm.calibrate_thresholds(probs, y) == jm.calibrate_thresholds(probs, y)


def _nested_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _nested_close(got[k], want[k], f"{path}.{k}")
    else:
        assert type(got) is type(want), path
        assert got == pytest.approx(want, abs=1e-12), path


@pytest.mark.parametrize("seed", range(20, 30))
def test_compute_detailed_metrics_matches_the_jax_report(seed):
    """The numpy report against the JAX package's (sklearn's
    ``f1_score``, ``precision_score``, ``recall_score`` and ``roc_auc_score``):
    every key and number, degenerate columns included; and a column that
    holds one class gets a per-class ROC-AUC of 0.0 and a macro ROC-AUC of
    0.0 (tolerance 1e-12)."""
    y, probs = _case(seed)
    if seed == 20:  # five columns, the second of them all 0
        y = (np.random.default_rng(0).random((30, 5)) < 0.4).astype(np.float32)
        probs = np.round(np.random.default_rng(1).random((30, 5)), 2).astype(np.float32)
        y[:, 1] = 0.0
    names = [f"c{i}" for i in range(y.shape[1])]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's degenerate-class warnings
        want = jm.compute_detailed_metrics(probs, y, 0.45, names)
    got = tm.compute_detailed_metrics(probs, y, 0.45, names)
    _nested_close(got, want)
    if seed == 20:
        assert got["per_class"]["c1"]["roc_auc"] == 0.0 and got["roc_auc_macro"] == 0.0
