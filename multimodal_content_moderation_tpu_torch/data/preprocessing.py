"""Dataset preparation: Hateful Memes and MMHS150K (the JAX package's
``data/preprocessing.py``, with the standard library's ``csv`` in place of
pandas).

The CSVs are byte for byte the JAX package's (``pd.DataFrame(records)
.to_csv(index=False)``: QUOTE_MINIMAL, ``\\n`` line ends, a missing text as
an empty field, a lone ``\\n`` for a split with no rows), which are the
reference prep step's (src/data/preprocessing.py:16-167). The MMHS150K
label-index quirk is part of that contract: raw MMHS150K annotates
0=NotHate..5=OtherHate, but the reference maps index 0 -> "racist" and drops
index 5 (``0 <= idx < len(class_names)`` with 5 names,
preprocessing.py:150-153). The published CSVs were made by that mapping,
so it is kept.

The Hateful Memes download needs the HF hub (network); offline hosts pass
an existing snapshot directory instead (``--local_dir`` on the
prepare-data CLI).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional

from multimodal_content_moderation_tpu_torch.data.dataset import write_records

logger = logging.getLogger(__name__)

MMHS_CLASS_NAMES = ["racist", "sexist", "homophobe", "religion", "otherhate"]

# raw-split file stem -> output CSV, shared by both datasets' split loops
SPLIT_CSVS = {"train": "train.csv", "val": "val.csv", "test": "test.csv"}


def ensure_dir(p: Path) -> None:
    p.mkdir(parents=True, exist_ok=True)


def write_class_names(out_dir: Path, class_names: List[str]) -> None:
    with open(out_dir / "class_names.txt", "w", encoding="utf-8") as f:
        for c in class_names:
            f.write(c + "\n")


def _read_jsonl(path: Path) -> List[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _emit_split_csv(records: List[Dict], path: Path) -> None:
    write_records(str(path), records)
    logger.info("wrote %s (%d rows)", path, len(records))
    print(f"[prepare] {path.name}: {len(records)} rows")


def download_and_prepare_hateful_memes(
    out_root: Path, local_repo: Optional[Path] = None
) -> None:
    """Emit Hateful Memes binary-label CSVs (train/val/test with columns
    text,image_path,label). Downloads the HF mirror unless ``local_repo``
    points at an existing snapshot (img/ + *.jsonl), the offline path."""
    if local_repo is None:  # pragma: no cover - needs network
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise RuntimeError(
                "huggingface_hub is required for hateful_memes download; "
                "or pass a local snapshot dir (--local_dir)"
            ) from e

        print("[prepare] fetching hateful_memes snapshot from the HF hub")
        local_repo = Path(
            snapshot_download(repo_id="neuralcatcher/hateful_memes", repo_type="dataset")
        )
    local_repo = Path(local_repo)

    out_dir = Path(out_root) / "hateful_memes"
    images_out = out_dir / "images"
    ensure_dir(images_out)

    src_img_dir = local_repo / "img"
    if not src_img_dir.exists():
        raise FileNotFoundError(f"Expected 'img' folder inside {local_repo}")
    if not any(images_out.iterdir()):
        shutil.copytree(src_img_dir, images_out, dirs_exist_ok=True)

    # snapshot jsonl name -> our split CSV (dev_seen/test_seen are the
    # publicly-labeled splits)
    jsonl_for_split = {"train": "train.jsonl", "val": "dev_seen.jsonl", "test": "test_seen.jsonl"}
    for split, csv_name in SPLIT_CSVS.items():
        jsonl_path = local_repo / jsonl_for_split[split]
        if not jsonl_path.exists():
            print(f"[prepare] no {jsonl_path.name} in snapshot; {split} skipped")
            continue
        records = [
            {
                "text": row.get("text", ""),
                "image_path": os.path.basename(row.get("img", "")),
                "label": int(row.get("label", 0)),
            }
            for row in _read_jsonl(jsonl_path)
        ]
        _emit_split_csv(records, out_dir / csv_name)

    write_class_names(out_dir, ["hateful"])
    print(f"[prepare] hateful_memes ready under {out_dir}")


def _mmhs_active_labels(entry: Dict, class_names: List[str]) -> List[str]:
    """Annotation indices -> class names, keeping the reference's mapping
    quirk: index 0 lands on "racist" and index 5 falls outside the 5-name
    range and is dropped (module docstring)."""
    return [class_names[idx] for idx in entry.get("labels", []) if 0 <= idx < len(class_names)]


def prepare_mmhs150k_from_raw(raw_dir: Path, out_dir: Path) -> None:
    """Convert raw MMHS150K (MMHS150K_GT.json + splits/*.txt) into
    multi-label CSVs, keeping the reference's label-index mapping."""
    raw_dir, out_dir = Path(raw_dir), Path(out_dir)
    gt_path = raw_dir / "MMHS150K_GT.json"
    if not gt_path.exists():
        raise FileNotFoundError(f"Ground truth file not found: {gt_path}")

    with open(gt_path, "r", encoding="utf-8") as f:
        gt = json.load(f)

    class_names = list(MMHS_CLASS_NAMES)
    ensure_dir(out_dir)
    ensure_dir(out_dir / "images")

    splits_dir = raw_dir / "splits"
    for split, csv_name in SPLIT_CSVS.items():
        split_file = splits_dir / f"{split}_ids.txt"
        if not split_file.exists():
            print(f"[prepare] no {split_file.name}; {split} skipped")
            continue
        with open(split_file, "r") as f:
            ids = [line.strip() for line in f if line.strip()]

        records = [
            {
                "text": gt[img_id].get("tweet_text", ""),
                "image_path": f"{img_id}.jpg",
                "labels": ",".join(_mmhs_active_labels(gt[img_id], class_names)),
            }
            for img_id in ids
            if img_id in gt
        ]
        _emit_split_csv(records, out_dir / csv_name)

    write_class_names(out_dir, class_names)
    print(f"[prepare] mmhs150k ready under {out_dir}")
