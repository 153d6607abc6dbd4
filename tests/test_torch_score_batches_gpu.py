"""The host input of offline scoring on the card (``chip_smoke.score_prep_check``):
three passes of ``evaluate_logits_u8`` over a pixel cache with a delay kernel
before every host-to-card copy, so that pinned buffers are freed and taken
again while copies from them are still queued. The logits equal the earlier
prep's (the dataset's ``batches``, NumPy's patch rows, ``pin_memory``) bit
for bit, and the counters say the first pass decoded every row and the
others gathered every row from the cache.

Marked ``gpu``: it skips where no card is present. On the card machine:
``python -m pytest --noconftest -m gpu tests/test_torch_score_batches_gpu.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


def test_score_prep_recycles_pinned_buffers_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card machine)")
    import chip_smoke

    report = chip_smoke.score_prep_check(torch)  # raises where a check fails
    assert report["max_abs_diff"] == [0.0, 0.0, 0.0]
    assert report["copies_queued_behind_work"] > 0
