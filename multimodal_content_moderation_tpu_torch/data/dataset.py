"""CSV-driven multimodal dataset with fixed-shape batch production.

Schema (reference src/data/dataset.py):
- binary:      columns [text, image_path, label]  (0/1)
- multi-label: columns [text, image_path, labels] (comma-separated subset of
  ``class_names``)

Texts are tokenized once up front into dense [N, T] int32 arrays; batches
are dicts of numpy arrays with a thread pool decoding images, and the last
batch can be zero-padded to the batch size (``_valid`` carries the true
count). Missing images degrade to zeros + ``image_present=0`` and empty
text to ``text_present=0``.

The CSV is read with the standard library's ``csv`` (``read_csv``), to the
rows the JAX package's ``pd.read_csv`` gives: blank and whitespace-only
lines skipped, pandas' default NA strings read as missing, and each column's
values typed as pandas infers them (int, float, bool or str), so that
``strings`` equals ``fillna("").astype(str)``: a text column of ``5`` and an
empty row gives ``"5.0"``.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.utils.config import parse_label_list


# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_INT = re.compile(r"[ \t]*[+-]?[0-9]+[ \t]*\Z")
_FLOAT = re.compile(
    r"[ \t]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|inf|infinity)[ \t]*\Z",
    re.IGNORECASE,
)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_INT64 = (-(1 << 63), (1 << 63) - 1)


def _typed_column(raw: List[Optional[str]]) -> List[Any]:
    """One column's fields (None where missing) as pandas types them: all
    ints -> int (float where a value is missing, unless an int leaves
    int64), all ints or floats -> float, all bools -> bool, else str."""
    present = [v for v in raw if v is not None]
    if not present:
        return list(raw)
    if all(_INT.match(v) for v in present):
        ints = [None if v is None else int(v) for v in raw]
        if len(present) == len(raw):
            return ints
        if all(_INT64[0] <= i <= _INT64[1] for i in ints if i is not None):
            return [None if i is None else float(i) for i in ints]
        if all(0 <= i < (1 << 64) for i in ints if i is not None):
            return list(raw)  # uint64 with a missing value stays text
        return ints
    if all(_INT.match(v) or _FLOAT.match(v) for v in present):
        return [None if v is None else float(v) for v in raw]
    if all(v in _BOOLS for v in present):
        return [None if v is None else _BOOLS[v] for v in raw]
    return list(raw)


def _as_str(v: Any) -> str:
    """``fillna("").astype(str)`` of one value."""
    return "" if v is None else str(v)


class CSVTable:
    """The rows of a CSV file as the JAX package's ``pd.read_csv`` reads
    them: ``columns`` in file order, ``values(name)`` typed (None where
    missing), ``strings(name)`` as ``fillna("").astype(str)``."""

    def __init__(self, columns: List[str], rows: List[List[Optional[str]]]):
        self.columns = columns
        self._typed = {
            name: _typed_column([r[j] for r in rows]) for j, name in enumerate(columns)
        }
        self.n = len(rows)

    def __len__(self) -> int:
        return self.n

    def __contains__(self, name: str) -> bool:
        return name in self._typed

    def values(self, name: str) -> List[Any]:
        return self._typed[name]

    def strings(self, name: str) -> List[str]:
        return [_as_str(v) for v in self._typed[name]]

    def ints(self, name: str) -> List[int]:
        """``astype(int)``: refuses a missing or non-numeric value."""
        out = []
        for v in self._typed[name]:
            if v is None or isinstance(v, str) or (isinstance(v, float) and not math.isfinite(v)):
                raise ValueError(f"column {name!r}: cannot convert {v!r} to int")
            out.append(int(v))
        return out

    def write(self, path: str, extra: Dict[str, List[Any]]) -> None:
        """``df.to_csv(path, index=False)`` of the table plus ``extra``
        columns (bools and floats, as the CSV mode of inference adds)."""
        cols = [self._typed[n] for n in self.columns] + list(extra.values())
        _write_csv(path, self.columns + list(extra), zip(*cols))


def read_csv(path: str) -> CSVTable:
    """A CSV file -> ``CSVTable``, with pandas' reading conventions: the
    first row names the columns, blank and whitespace-only lines are
    skipped, a short row is padded with missing values, the default NA
    strings (quoted or not) are missing values."""
    with open(path, encoding="utf-8", newline="") as f:
        records = [r for r in csv.reader(f) if r and not (len(r) == 1 and not r[0].strip())]
    if not records:
        raise ValueError(f"{path}: no columns to parse")
    columns, body = records[0], records[1:]
    rows = []
    for k, r in enumerate(body):
        if len(r) > len(columns):
            raise ValueError(
                f"{path}: row {k + 1} has {len(r)} fields, the header {len(columns)}"
            )
        r = r + [""] * (len(columns) - len(r))
        rows.append([None if v in NA_STRINGS else v for v in r])
    return CSVTable(columns, rows)


def _csv_field(v: Any) -> str:
    """pandas' ``to_csv`` text of one value: None and NaN empty, anything
    else its ``str`` (a numpy scalar's own: a float32 column writes
    ``0.12345679``, not the float64 ``0.12345679104328156``)."""
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return ""
    return str(v)


def _write_csv(path: str, columns: List[str], rows) -> None:
    """pandas' ``to_csv(index=False)`` layout: QUOTE_MINIMAL, ``\\n`` line
    ends, each value as ``_csv_field`` writes it."""
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([_csv_field(v) for v in r] for r in rows)


def write_records(path: str, records: Sequence[Dict[str, Any]]) -> None:
    """``pd.DataFrame(records).to_csv(path, index=False)`` for records that
    all have the same keys (the columns, in the first record's order) and
    values of one type a column (a lone ``\\n`` for no records)."""
    columns = list(records[0]) if records else []
    for k, r in enumerate(records):
        if list(r) != columns:
            raise ValueError(f"record {k} has keys {list(r)}, the first {columns}")
    _write_csv(path, columns, (r.values() for r in records))


class CSVDataset:
    def __init__(
        self,
        csv_path: str,
        image_root: str,
        tokenizer,
        preprocessor: ImagePreprocessor,
        max_text_length: int = 77,
        class_names: Optional[List[str]] = None,
        is_train: bool = False,
        cache_dir: Optional[str] = None,
    ):
        self.table = read_csv(csv_path)
        self.image_root = image_root
        self.preproc = preprocessor
        self.max_len = max_text_length
        self.is_train = is_train

        has_binary = "label" in self.table
        has_multilabel = "labels" in self.table
        if not has_binary and not has_multilabel:
            raise ValueError(
                "CSV must have column 'label' (0/1) or 'labels' (comma-separated)."
            )

        if has_multilabel:
            if not class_names:
                raise ValueError("Provide class_names for multi-label classification.")
            self.class_names = [c.strip() for c in class_names]
            class2id = {c: i for i, c in enumerate(self.class_names)}
            Y = np.zeros((len(self.table), len(self.class_names)), np.float32)
            for r, v in enumerate(self.table.values("labels")):
                for name in parse_label_list("" if v is None else v):
                    j = class2id.get(name)
                    if j is not None:
                        Y[r, j] = 1.0
            self.labels = Y
        else:
            self.class_names = ["harmful"]
            self.labels = np.asarray(self.table.ints("label"), np.float32).reshape(-1, 1)

        self.texts: List[str] = self.table.strings("text")
        self.paths: List[str] = self.table.strings("image_path")
        self.text_present = np.asarray(
            [1.0 if t.strip() else 0.0 for t in self.texts], np.float32
        )
        self.input_ids, self.attention_mask = tokenizer.encode_batch(
            self.texts, max_text_length
        )

        # the decode-once pixel cache (data/cache.py), filled on the first
        # pass; an augmenting preprocessor is never cached
        self.cache = None
        if cache_dir and not preprocessor.augment:
            from multimodal_content_moderation_tpu_torch.data.cache import PixelCache

            self.cache = PixelCache(cache_dir, self.paths, image_root, preprocessor)

    def truncate_text(self, width: int) -> None:
        """Shrink the static text width to ``width`` tokens (in place), for
        ``training.text_fit``: with a causal text tower pooled at the first
        EOS (CLIP), features and gradients are the same at the smaller width
        when every row's EOS sits before it. Refuses to drop real tokens."""
        if width >= self.input_ids.shape[1]:
            return
        if int(self.attention_mask[:, width:].sum()) != 0:
            raise ValueError(
                f"truncate_text({width}) would drop real tokens (longest row "
                f"is {int(self.attention_mask.sum(axis=1).max())} tokens)"
            )
        self.input_ids = np.ascontiguousarray(self.input_ids[:, :width])
        self.attention_mask = np.ascontiguousarray(self.attention_mask[:, :width])
        self.max_len = width

    def __len__(self) -> int:
        return len(self.texts)

    def load_image(self, i: int):
        if self.cache is not None:
            hit = self.cache.get(i)
            if hit is not None:
                return hit
        arr, present = self.preproc.load_relative(self.paths[i], self.image_root)
        if self.cache is not None:
            self.cache.put(i, arr, present)
        return arr, present

    def batches(
        self,
        batch_size: int,
        drop_last: bool = False,
        pad_to_batch: bool = False,
        num_workers: int = 8,
        indices: Optional[Sequence[int]] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape dict-of-numpy batches with threaded image decode.

        ``indices`` overrides the natural order (the weighted sampler's
        draw). ``drop_last`` drops a short last batch (training); with
        ``pad_to_batch`` the last batch is zero-padded to ``batch_size`` and
        carries ``_valid`` (evaluation).
        """
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        n = len(order)
        starts = range(0, n - batch_size + 1, batch_size) if drop_last else range(0, n, batch_size)
        pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        try:
            for s in starts:
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
