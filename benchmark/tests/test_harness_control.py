"""The control: the plain reference put in the program's place with every
matrix product in float8 e4m3, one precision below the bf16 the
configurations state, reads above the limits on each tiny cell (the
harness's limits at the published widths were set from the same readings on
the card, ``tools/readings.py``)."""

import pytest
import torch

from harness_util import TINY
from benchmark.harness import spec
from benchmark.tools import readings


@pytest.mark.parametrize("cell", ["tiny-clip.score", "tiny-siglip.score", "tiny-siglip.train",
                                  "tiny-clip.serve"])
def test_control_fails(cell):
    c = spec.load_cell(cell, TINY)
    numbers = readings.control(c, 3_000_000_047, torch.device("cpu"), seconds=1.0)
    assert any(numbers[k] > c.limits[k] for k in c.limits), (numbers, c.limits)
