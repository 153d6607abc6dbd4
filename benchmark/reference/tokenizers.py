"""Plain tokenizers for the benchmark's texts, read from the same asset files
the measured program reads: CLIP's byte-level BPE (``vocab.json`` +
``merges.txt``) and a WordLevel ``tokenizer.json`` (lowercase, split on
words and punctuation). They cover the alphabet the benchmark's generator
writes (lowercase ASCII letters, digits, spaces, punctuation without
apostrophes) and refuse any other character.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

_ALPHABET = re.compile(r"[a-z0-9 .,!?#@]*\Z")
_CLIP_PIECES = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")
_WORDS = re.compile(r"\w+|[^\w\s]+")


def _bytes_to_unicode() -> Dict[int, str]:
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


def _check(text: str) -> str:
    text = " ".join(text.split()).lower()
    if not _ALPHABET.match(text):
        raise ValueError(f"text outside the benchmark's alphabet: {text[:40]!r}")
    return text


class ClipBPE:
    """``<|startoftext|>`` + BPE pieces + ``<|endoftext|>``, truncated to
    ``max_length - 2`` pieces and padded with ``<|endoftext|>``."""

    def __init__(self, directory: str):
        with open(os.path.join(directory, "vocab.json"), encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
            merges = [tuple(l.split()) for l in f.read().split("\n")
                      if l and not l.startswith("#")]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte = _bytes_to_unicode()
        self.bos = self.vocab["<|startoftext|>"]
        self.eos = self.vocab["<|endoftext|>"]

    def _bpe(self, token: str) -> List[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            best = min(zip(word, word[1:]), key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        body = []
        for piece in _CLIP_PIECES.findall(_check(text)):
            mapped = "".join(self.byte[b] for b in piece.encode("utf-8"))
            body += [self.vocab[p] for p in self._bpe(mapped)]
        ids = [self.bos] + body[: max_length - 2] + [self.eos]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        return ids + [self.eos] * (max_length - len(ids)), mask


class WordLevel:
    """One id a word (``<unk>`` for the rest), no special tokens, padded
    with the tokenizer config's pad token."""

    def __init__(self, directory: str):
        with open(os.path.join(directory, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        with open(os.path.join(directory, "tokenizer_config.json"), encoding="utf-8") as f:
            pad = json.load(f)["pad_token"]
        self.vocab: Dict[str, int] = spec["model"]["vocab"]
        self.unk = self.vocab[spec["model"]["unk_token"]]
        self.pad = self.vocab[pad]

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        ids = [self.vocab.get(w, self.unk) for w in _WORDS.findall(_check(text))][:max_length]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        return ids + [self.pad] * (max_length - len(ids)), mask


def load(kind: str, directory: str):
    return {"clip_bpe": ClipBPE, "wordlevel": WordLevel}[kind](directory)


def encode_batch(tok, texts, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    pairs = [tok.encode(t, max_length) for t in texts]
    return (np.asarray([p[0] for p in pairs], np.int64),
            np.asarray([p[1] for p in pairs], np.int64))
