"""Committed fixtures for the tests and ``chip_smoke.py``, and writers of
synthetic CLIP BPE and BERT WordPiece vocabularies.

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


# BERT-base-uncased's special tokens and their ids
BERT_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}


def write_bert_wordpiece(directory: str, vocab_size: int = 30522, seed: int = 0,
                         words=()) -> Dict[str, int]:
    """Write a BERT ``tokenizer.json`` (BertNormalizer, lowercasing;
    BertPreTokenizer; WordPiece; the ``[CLS] $A [SEP]`` template) and
    ``tokenizer_config.json`` of ``vocab_size`` entries into ``directory``,
    as ``transformers``' ``BertTokenizerFast`` saves them. The special
    tokens take BERT-base-uncased's ids, the other low ids ``[unusedN]``;
    then ``words`` (lowercased), the printable ASCII characters and their
    ``##`` forms, and pieces drawn from a seed (short lowercase strings,
    half of them ``##`` continuations) up to ``vocab_size``. Returns the
    vocabulary."""
    g = np.random.default_rng(seed)
    vocab: Dict[str, int] = {}
    for i in range(BERT_SPECIALS["[MASK]"] + 1):
        vocab[next((t for t, j in BERT_SPECIALS.items() if j == i), f"[unused{i}]")] = i
    chars = [chr(c) for c in range(33, 127)]
    for w in [w.lower() for w in words if w] + [c.lower() for c in chars] + [
            "##" + c for c in chars]:
        vocab.setdefault(w, len(vocab))
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < vocab_size:
        n = int(g.integers(2, 8))
        piece = "".join(letters[int(i)] for i in g.integers(0, 26, size=n))
        vocab.setdefault(("##" if g.random() < 0.5 else "") + piece, len(vocab))
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for t, i in BERT_SPECIALS.items()]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [BERT_SPECIALS[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")},
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"do_lower_case": True, "pad_token": "[PAD]", "unk_token": "[UNK]",
                   "cls_token": "[CLS]", "sep_token": "[SEP]", "mask_token": "[MASK]",
                   "tokenizer_class": "BertTokenizer", "model_max_length": 512}, f)
    return vocab
