#!/usr/bin/env python
"""Dataset-preparation CLI (the JAX package's ``cli/prepare_data.py``, the
reference scripts/prepare_data.py's dispatch). It runs on the host only and
needs no pandas.

    python -m multimodal_content_moderation_tpu_torch.cli.prepare_data \\
        --dataset mmhs150k --raw_dir /path/to/raw --out_dir data/mmhs150k
    python -m multimodal_content_moderation_tpu_torch.cli.prepare_data \\
        --dataset hateful_memes --out_dir data --local_dir /path/to/snapshot
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_content_moderation_tpu_torch.data.preprocessing import (
    download_and_prepare_hateful_memes,
    prepare_mmhs150k_from_raw,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Prepare training datasets")
    parser.add_argument("--dataset", choices=["hateful_memes", "mmhs150k"], required=True)
    parser.add_argument("--out_dir", type=str, default="data")
    parser.add_argument("--raw_dir", type=str, default=None, help="Raw MMHS150K directory")
    parser.add_argument(
        "--local_dir", type=str, default=None,
        help="Existing Hateful Memes snapshot (img/ + *.jsonl): convert "
        "offline instead of downloading",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dataset == "hateful_memes":
        download_and_prepare_hateful_memes(
            Path(args.out_dir), local_repo=Path(args.local_dir) if args.local_dir else None
        )
    else:
        if not args.raw_dir:
            raise SystemExit("--raw_dir is required for mmhs150k")
        prepare_mmhs150k_from_raw(Path(args.raw_dir), Path(args.out_dir))


if __name__ == "__main__":
    main()
