"""Committed fixtures for the tests and ``chip_smoke.py``, and a writer of
a synthetic CLIP BPE vocabulary.

``jpeg/`` holds a few small JPEGs made from a seed with PIL
(``make_jpegs.py``): 4:2:0 and 4:4:4, grey, odd and small sizes, a
progressive one and a corrupt one, each beside ``<name>.npz``, the PIL
pipeline's centre crops of it at 224 and 384 px (``crop224``, ``crop384``;
empty for the corrupt file). They let a machine without PIL (the card's)
check its JPEG decoder against PIL's output.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

JPEG_DIR = Path(__file__).resolve().parent / "jpeg"
CROP_SIZES = (224, 384)


def jpeg_fixtures() -> Dict[str, Path]:
    """{name: path} of the committed JPEGs, in name order."""
    return {p.stem: p for p in sorted(JPEG_DIR.glob("*.jpg"))}


def pil_crops(name: str) -> Optional[Dict[int, np.ndarray]]:
    """{size: uint8 [size, size, 3]} PIL crops of fixture ``name``, or None
    for the fixture PIL cannot decode."""
    with np.load(JPEG_DIR / f"{name}.npz") as z:
        crops = {s: z[f"crop{s}"] for s in CROP_SIZES}
    return None if any(c.size == 0 for c in crops.values()) else crops


def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP byte <-> unicode table (``data/tokenizer.py``)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def write_clip_bpe(directory: str, vocab_size: int = 49408, seed: int = 0) -> Dict[str, int]:
    """Write ``vocab.json`` + ``merges.txt`` of ``vocab_size`` entries into
    ``directory``: the 256 byte symbols, their ``</w>`` forms, merges drawn
    from a seed, and ``<|startoftext|>`` / ``<|endoftext|>`` as the last two
    ids (49406 / 49407 at CLIP's size). Merges favour the lowercase letters
    and the tokens made early, so that real text takes multi-symbol tokens.
    Returns the vocabulary."""
    g = np.random.default_rng(seed)
    symbols = list(_bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for s in symbols + [s + "</w>" for s in symbols]:
        vocab[s] = len(vocab)
    letters = [s for s in symbols if s.isalpha() and s.isascii() and s.islower()]
    heads, tails = list(letters), list(letters) + [s + "</w>" for s in letters]
    merges = []
    n_merges = vocab_size - 2 - len(vocab)
    while len(merges) < n_merges:
        a = heads[int(len(heads) * g.random() ** 2)]
        b = tails[int(len(tails) * g.random() ** 2)]
        tok = a + b
        if tok in vocab:
            continue
        vocab[tok] = len(vocab)
        merges.append(f"{a} {b}")
        tails.append(tok)
        if not tok.endswith("</w>"):
            heads.append(tok)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return vocab
