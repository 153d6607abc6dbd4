"""The card fixture of the harness's tests."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import harness_util  # noqa: E402,F401  (puts the repository's root on sys.path)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
