"""On the card: a short run of each cell at its own size reads correct.
Skips without a card."""

import json
import os

import pytest

from harness_util import ROOT, run_harness

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_card(card, cell):
    rc, line, err = run_harness("--workload", cell, "--seed", "2718281828", "--seconds", "5",
                                "--trace", "0", timeout=900)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
