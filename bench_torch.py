#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: staged CLIP ViT-B/32 fusion
eval throughput on one card, with its bucketed and end-to-end slices (the
JAX package's ``bench.py``). Prints one JSON line.

    python bench_torch.py                # on the card
    python bench_torch.py --device cpu --tiny   # a smoke run on the CPU

The flags are those of ``multimodal_content_moderation_tpu_torch/tools/bench.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multimodal_content_moderation_tpu_torch.tools.bench import main  # noqa: E402

if __name__ == "__main__":
    main()
