"""CSV-driven multimodal dataset with fixed-shape batch production.

Schema (reference src/data/dataset.py):
- binary:      columns [text, image_path, label]  (0/1)
- multi-label: columns [text, image_path, labels] (comma-separated subset of
  ``class_names``)

Texts are tokenized once up front into dense [N, T] int32 arrays; batches
are dicts of numpy arrays with a thread pool decoding images, and the last
batch can be zero-padded to the batch size (``_valid`` carries the true
count). Missing images degrade to zeros + ``image_present=0`` and empty
text to ``text_present=0``. pandas is imported where the CSV is read.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.utils.config import parse_label_list


class CSVDataset:
    def __init__(
        self,
        csv_path: str,
        image_root: str,
        tokenizer,
        preprocessor: ImagePreprocessor,
        max_text_length: int = 77,
        class_names: Optional[List[str]] = None,
    ):
        import pandas as pd

        self.df = pd.read_csv(csv_path)
        self.image_root = image_root
        self.preproc = preprocessor

        has_binary = "label" in self.df.columns
        has_multilabel = "labels" in self.df.columns
        if not has_binary and not has_multilabel:
            raise ValueError(
                "CSV must have column 'label' (0/1) or 'labels' (comma-separated)."
            )

        if has_multilabel:
            if not class_names:
                raise ValueError("Provide class_names for multi-label classification.")
            self.class_names = [c.strip() for c in class_names]
            class2id = {c: i for i, c in enumerate(self.class_names)}
            Y = np.zeros((len(self.df), len(self.class_names)), np.float32)
            for r, v in enumerate(self.df["labels"].fillna("")):
                for name in parse_label_list(v):
                    j = class2id.get(name)
                    if j is not None:
                        Y[r, j] = 1.0
            self.labels = Y
        else:
            self.class_names = ["harmful"]
            self.labels = (
                self.df["label"].astype(int).to_numpy().reshape(-1, 1).astype(np.float32)
            )

        self.texts: List[str] = self.df["text"].fillna("").astype(str).tolist()
        self.paths: List[str] = self.df["image_path"].fillna("").astype(str).tolist()
        self.text_present = np.asarray(
            [1.0 if t.strip() else 0.0 for t in self.texts], np.float32
        )
        self.input_ids, self.attention_mask = tokenizer.encode_batch(
            self.texts, max_text_length
        )

    def __len__(self) -> int:
        return len(self.texts)

    def load_image(self, i: int):
        return self.preproc.load_relative(self.paths[i], self.image_root)

    def batches(
        self,
        batch_size: int,
        pad_to_batch: bool = False,
        num_workers: int = 8,
        indices: Optional[Sequence[int]] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape dict-of-numpy batches with threaded image decode.

        ``indices`` overrides the natural order. With ``pad_to_batch`` the
        last batch is zero-padded to ``batch_size`` and carries ``_valid``.
        """
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        try:
            for s in range(0, len(order), batch_size):
                idx = order[s : s + batch_size]
                valid = len(idx)
                results = list(pool.map(self.load_image, idx))
                pixels = np.stack([r[0] for r in results])
                present = np.asarray([r[1] for r in results], np.float32)
                batch = {
                    "input_ids": self.input_ids[idx],
                    "attention_mask": self.attention_mask[idx],
                    "pixel_values": pixels,
                    "text_present": self.text_present[idx],
                    "image_present": present,
                    "labels": self.labels[idx],
                }
                if pad_to_batch and valid < batch_size:
                    pad = batch_size - valid
                    batch = {
                        k: np.concatenate(
                            [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0
                        )
                        for k, v in batch.items()
                    }
                if pad_to_batch:
                    batch["_valid"] = np.int32(valid)
                yield batch
        finally:
            pool.shutdown(wait=False)
