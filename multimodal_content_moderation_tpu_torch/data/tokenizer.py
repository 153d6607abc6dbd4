"""Host-side tokenization.

``ClipBPETokenizer`` is a self-contained byte-level BPE tokenizer matching
the HF *fast* CLIP tokenizer pipeline (the reference always loads tokenizers
with ``use_fast=True``, scripts/train.py:129): NFC normalize -> collapse
whitespace -> lowercase -> CLIP regex pre-tokenization -> byte-to-unicode
mapping -> BPE with ``</w>`` end-of-word marker -> bos/eos + eos-padding.
It loads the standard ``vocab.json`` + ``merges.txt`` files shipped with
every CLIP checkpoint — no network, no torch, no Rust required.

``load_tokenizer`` resolves a local checkpoint/encoder directory to the best
available backend:
1. ``vocab.json`` + ``merges.txt``  -> native ClipBPETokenizer
2. ``tokenizer.json``               -> the pure-Python ``JSONTokenizer``
   (``data/tokenizer_json.py``), else the Rust ``tokenizers`` wheel
   (``RustTokenizer``, imported only then) for components outside its subset

It exposes ``encode_batch(texts, max_length) -> (ids, mask)`` producing the
fixed-shape int32 arrays the batch pipeline uses.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # `regex` supports \p{L}/\p{N}; stdlib `re` does not.
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

_CLIP_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte<->unicode mapping (published spec)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipBPETokenizer:
    """CLIP byte-level BPE tokenizer (pure Python, file-driven)."""

    def __init__(self, vocab_file: str, merges_file: str):
        if _re is None:
            raise ImportError("ClipBPETokenizer requires the `regex` package")
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip the "#version" header and trailing blanks
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.pat = _re.compile(_CLIP_PATTERN, _re.IGNORECASE)
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id  # CLIP pads with <|endoftext|>
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        """Apply BPE merges to one pre-token (with </w> on the last symbol)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        if len(self._cache) < 65536:
            self._cache[token] = word
        return word

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFC", text)
        text = _re.sub(r"\s+", " ", text)
        return text.strip().lower()

    def tokenize_ids(self, text: str) -> List[int]:
        """Text -> BPE token ids (no special tokens)."""
        text = self._normalize(text)
        ids: List[int] = []
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def encode(self, text: str, max_length: int = 77) -> Tuple[List[int], List[int]]:
        """Text -> (ids, attention_mask), bos/eos added, eos-padded.

        Matches HF fast-tokenizer semantics with ``padding="max_length",
        truncation=True`` (body truncated to max_length-2 so EOS is always
        present — required by the EOS-position pooling in models/clip.py).
        """
        body = self.tokenize_ids(text)[: max_length - 2]
        ids = [self.bos_token_id] + body + [self.eos_token_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids += [self.pad_token_id] * pad
        mask += [0] * pad
        return ids, mask

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 77
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.empty((len(texts), max_length), np.int32)
        mask = np.empty((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t or "", max_length)
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text (special tokens dropped); for debugging."""
        text = "".join(
            self.decoder[i]
            for i in ids
            if i in self.decoder and i not in (self.bos_token_id, self.eos_token_id)
        )
        words = [
            bytearray(self.byte_decoder[c] for c in w).decode("utf-8", errors="replace")
            for w in text.split("</w>")
        ]
        return " ".join(words).strip()


class RustTokenizer:
    """An HF ``tokenizers`` (Rust) tokenizer.json, for components outside
    ``JSONTokenizer``'s subset. The wheel is imported here, not at module
    import: the card machine does not have it."""

    def __init__(self, tokenizer_json: str, pad_token_id: Optional[int] = None):
        from tokenizers import Tokenizer

        self.tk = Tokenizer.from_file(tokenizer_json)
        cfg_path = os.path.join(os.path.dirname(tokenizer_json), "tokenizer_config.json")
        pad = pad_token_id
        if pad is None and os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            pad_tok = cfg.get("pad_token")
            if isinstance(pad_tok, dict):
                pad_tok = pad_tok.get("content")
            if pad_tok is not None:
                pad = self.tk.token_to_id(pad_tok)
        self.pad_token_id = pad if pad is not None else 0

    @property
    def vocab_size(self) -> int:
        return self.tk.get_vocab_size()

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        self.tk.enable_truncation(max_length)
        self.tk.enable_padding(length=max_length, pad_id=self.pad_token_id)
        encs = self.tk.encode_batch([t or "" for t in texts])
        ids = np.asarray([e.ids for e in encs], np.int32)
        mask = np.asarray([e.attention_mask for e in encs], np.int32)
        return ids, mask


def load_tokenizer(path: str, pad_token_id: Optional[int] = None):
    """Resolve a local checkpoint / encoder-asset directory to a tokenizer.

    Native CLIP BPE (vocab.json+merges.txt) first, then a tokenizer.json
    through ``JSONTokenizer``, or ``RustTokenizer`` for components outside
    its subset. Raises with a clear message if neither is present (no
    network access is ever attempted).
    """
    vocab = os.path.join(path, "vocab.json")
    merges = os.path.join(path, "merges.txt")
    tok_json = os.path.join(path, "tokenizer.json")
    if os.path.exists(vocab) and os.path.exists(merges):
        return ClipBPETokenizer(vocab, merges)
    if os.path.exists(tok_json):
        from multimodal_content_moderation_tpu_torch.data.tokenizer_json import (
            JSONTokenizer,
            UnsupportedTokenizerJSON,
        )

        try:
            return JSONTokenizer(tok_json, pad_token_id)
        except UnsupportedTokenizerJSON:
            return RustTokenizer(tok_json, pad_token_id)
    raise FileNotFoundError(
        f"No tokenizer assets found in {path!r}: expected vocab.json+merges.txt "
        "(CLIP) or tokenizer.json (SigLIP/other). This framework runs fully "
        "offline — place the checkpoint's tokenizer files locally."
    )
