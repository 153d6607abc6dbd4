"""The learning rate that each update of a training window applied, held
against the reference's schedule: a sound record reads 0 or rounding, and a
missing, repeated or decayless update reads far above the limit."""

import pytest

from harness_util import ROOT  # noqa: F401  (the repository's root on sys.path)
from benchmark.harness import train
from benchmark.reference import optim as ref_optim

RECIPE = {"lr_encoder": 5e-6, "lr_head": 3e-4, "warmup_ratio": 0.05}
TOTAL, FIRST, UPDATES = 768, 3, 280


def record(counts, held=False):
    out = []
    for c in counts:
        for group in ("encoder", "head"):
            peak = RECIPE[f"lr_{group}"]
            lr = ref_optim.schedule(peak, TOTAL, RECIPE["warmup_ratio"])(c)
            out.append((group, c, peak if held and c >= 38 else lr))
    return out


@pytest.mark.parametrize("case,low", [
    ("sound", True), ("missing", False), ("repeated", False), ("extra", False),
    ("held", False)])
def test_lr_gap(case, low):
    counts = list(range(FIRST, FIRST + UPDATES))
    seen = {"sound": record(counts), "missing": record(counts[:-1]),
            "repeated": record(counts[:10] + counts[9:-1]),
            "extra": record(counts + [FIRST + UPDATES]),
            "held": record(counts, held=True)}[case]
    gap = train.lr_gap(seen, RECIPE, FIRST, UPDATES, TOTAL)
    assert (gap < 1e-12) if low else (gap > 1e-3), gap
