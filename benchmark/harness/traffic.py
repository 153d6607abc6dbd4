"""The one generator of every traffic mix: rows of (text, image, labels) and,
for an endpoint, arrival times, all from ``--seed`` and the mix's
parameters.

Every seed gets the same work in another order: the multiset of text lengths
(in words) and of images is drawn from a fixed seed, and the run's seed
permutes it and draws the words and the labels. An endpoint's arrival times
are one fixed Poisson schedule for every seed: a queue's tail depends on the
order of the gaps as much as on the system, so the seed changes what the
requests say, not when they come."""

from __future__ import annotations

import csv
from typing import Dict, List, Sequence

import numpy as np

from benchmark.harness.assets import fixtures, lexicon

FIXED = 7_340_033  # the seed of the multisets every run shares
PUNCT = ["!", "?", "!!", "#", "@"]


def _word_counts(n: int, words: Dict) -> np.ndarray:
    """``n`` text lengths in words between ``min`` and ``max``, skewed short
    (``u ** skew`` of a uniform u), from the fixed seed."""
    g = np.random.default_rng(FIXED)
    lo, hi, skew = int(words["min"]), int(words["max"]), float(words["skew"])
    return lo + np.floor((hi - lo + 1) * g.random(n) ** skew).astype(np.int64)


def texts(seed: int, n: int, words: Dict) -> List[str]:
    """``n`` tweet-like texts: Zipf-distributed words of the lexicon, now and
    then a punctuation token."""
    lex = lexicon()
    g = np.random.default_rng([seed, 1])
    counts = g.permutation(_word_counts(n, words))
    ranks = np.arange(1, len(lex) + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    total = int(counts.sum())
    picks = g.choice(len(lex), size=total, p=p)
    punct = g.random(total) < float(words.get("punct", 0.05))
    pmark = g.integers(0, len(PUNCT), size=total)
    out, k = [], 0
    for c in counts:
        toks = []
        for j in range(k, k + c):
            toks.append(lex[picks[j]])
            if punct[j]:
                toks.append(PUNCT[pmark[j]])
        k += c
        out.append(" ".join(toks))
    return out


def images(seed: int, n: int) -> List[str]:
    """The fixture name of each of ``n`` rows: every fixture equally often
    (row i -> fixture i mod count), in the seed's order."""
    names = fixtures()
    g = np.random.default_rng([seed, 2])
    return [names[i] for i in g.permutation(np.arange(n) % len(names))]


def labels(seed: int, n: int, classes: Sequence[str], rate: float) -> np.ndarray:
    """[n, classes] 0/1 labels, each present with probability ``rate``."""
    g = np.random.default_rng([seed, 3])
    return (g.random((n, len(classes))) < rate).astype(np.float32)


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Poisson arrival offsets (s) over ``seconds`` at ``rate`` a second,
    from the fixed seed."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(FIXED).exponential(1.0 / rate, size=n)
    gaps *= seconds / gaps.sum()  # exactly ``seconds`` of arrivals
    return np.cumsum(gaps) - gaps[0]


def rows(seed: int, n: int, mix: Dict, classes: Sequence[str]) -> Dict:
    """The rows of a mix: {"texts", "images" (fixture names), "labels"}."""
    return {"texts": texts(seed, n, mix["words"]), "images": images(seed, n),
            "labels": labels(seed, n, classes, float(mix.get("label_rate", 0.2)))}


def write_csv(path: str, data: Dict, classes: Sequence[str]) -> str:
    """The rows as the CLIs' CSV: ``text,image_path,labels``."""
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["text", "image_path", "labels"])
        for t, img, y in zip(data["texts"], data["images"], data["labels"]):
            w.writerow([t, f"{img}.jpg", ",".join(c for c, v in zip(classes, y) if v)])
    return path


def token_hist(mask: np.ndarray, ladder: Sequence[int]) -> Dict[str, int]:
    """Rows per bucket rung (the smallest rung covering a row's tokens)."""
    lengths = mask.sum(axis=1)
    out = {}
    for L in lengths:
        rung = next((b for b in ladder if b >= L), ladder[-1])
        out[str(rung)] = out.get(str(rung), 0) + 1
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))

