"""A pure-Python engine for HF ``tokenizer.json`` files (no Rust wheel).

SigLIP (Gemma-style) and other non-CLIP checkpoints ship a ``tokenizer.json``.
This module implements the subset of its pipeline those checkpoints use:

  added-token splitting -> normalizers -> pre-tokenizers -> model
  -> truncation (template-aware) -> TemplateProcessing -> padding

Models: Unigram (SentencePiece Viterbi, the SigLIP/T5 family), BPE with
optional byte fallback (the Gemma/SigLIP2 family), WordLevel, WordPiece.
Normalizers: Sequence/Replace/Prepend/Lowercase/NFx/Strip. Pre-tokenizers:
Metaspace/Whitespace/WhitespaceSplit/Split/Sequence.

Anything outside the subset raises ``UnsupportedTokenizerJSON``, and
``data.tokenizer.load_tokenizer`` then uses the Rust ``tokenizers`` wheel
where it is installed: the same output, never a silently different one.
Only the standard library and numpy are needed, so the engine runs where the
wheel is missing.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class UnsupportedTokenizerJSON(Exception):
    """A tokenizer.json component outside the implemented subset."""


# ---------------------------------------------------------------------------
# normalizers


def _build_normalizer(spec):
    if spec is None:
        return lambda s: s
    t = spec.get("type")
    if t == "Sequence":
        fns = [_build_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for f in fns:
                s = f(s)
            return s

        return seq
    if t == "Replace":
        pat = spec["pattern"]
        content = spec["content"]
        if "String" in pat:
            lit = pat["String"]
            return lambda s: s.replace(lit, content)
        if "Regex" in pat:
            rx = re.compile(pat["Regex"])
            return lambda s: rx.sub(content, s)
        raise UnsupportedTokenizerJSON(f"Replace pattern {pat}")
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: (pre + s) if s else s
    if t == "Lowercase":
        return lambda s: s.lower()
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, _f=t: unicodedata.normalize(_f, s)
    if t == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            if left:
                s = s.lstrip()
            if right:
                s = s.rstrip()
            return s

        return strip
    raise UnsupportedTokenizerJSON(f"normalizer {t}")


# ---------------------------------------------------------------------------
# pre-tokenizers (str -> list of pieces)

_WHITESPACE_RX = re.compile(r"\w+|[^\w\s]+")


def _build_pre_tokenizer(spec):
    if spec is None:
        return lambda s: [s] if s else []
    t = spec.get("type")
    if t == "Sequence":
        fns = [_build_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(s):
            pieces = [s]
            for f in fns:
                pieces = [q for p in pieces for q in f(p)]
            return pieces

        return seq
    if t == "Whitespace":
        return lambda s: _WHITESPACE_RX.findall(s)
    if t == "WhitespaceSplit":
        return lambda s: s.split()
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # legacy serialization
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = spec.get("split", True)

        def metaspace(s):
            s = s.replace(" ", rep)
            if scheme in ("always", "first") and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s] if s else []
            # split keeping the replacement attached to what follows it
            out, cur = [], ""
            for ch in s:
                if ch == rep:
                    if cur:
                        out.append(cur)
                    cur = ch
                else:
                    cur += ch
            if cur:
                out.append(cur)
            return out

        return metaspace
    if t == "Split":
        pat = spec.get("pattern", {})
        behavior = spec.get("behavior", "Removed")
        invert = spec.get("invert", False)
        if "String" in pat:
            rx = re.compile(re.escape(pat["String"]))
        elif "Regex" in pat:
            rx = re.compile(pat["Regex"])
        else:
            raise UnsupportedTokenizerJSON(f"Split pattern {pat}")
        if invert:
            return lambda s: rx.findall(s)
        if behavior == "Removed":
            return lambda s: [p for p in rx.split(s) if p]
        if behavior == "Isolated":

            def isolated(s):
                out, last = [], 0
                for m in rx.finditer(s):
                    if m.start() > last:
                        out.append(s[last : m.start()])
                    out.append(m.group())
                    last = m.end()
                if last < len(s):
                    out.append(s[last:])
                return out

            return isolated
        raise UnsupportedTokenizerJSON(f"Split behavior {behavior}")
    raise UnsupportedTokenizerJSON(f"pre_tokenizer {t}")


# ---------------------------------------------------------------------------
# models (piece -> list of ids)


class _WordLevel:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_id = self.vocab.get(spec.get("unk_token", ""))

    def encode(self, piece: str) -> List[int]:
        i = self.vocab.get(piece, self.unk_id)
        return [] if i is None else [i]


class _WordPiece:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_id = self.vocab.get(spec.get("unk_token", "[UNK]"))
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def encode(self, piece: str) -> List[int]:
        if len(piece) > self.max_chars:
            return [self.unk_id] if self.unk_id is not None else []
        ids, start = [], 0
        while start < len(piece):
            end, cur = len(piece), None
            while start < end:
                sub = piece[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id] if self.unk_id is not None else []
            ids.append(cur)
            start = end
        return ids


class _BPE:
    """Classic rank-ordered BPE over unicode chars, with optional
    SentencePiece-style byte fallback for out-of-vocab characters."""

    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_id = (
            self.vocab.get(spec["unk_token"])
            if spec.get("unk_token") is not None
            else None
        )
        merges = spec.get("merges", [])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            pair = tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
            self.ranks[pair] = r
        self.byte_fallback = spec.get("byte_fallback", False)
        self.fuse_unk = spec.get("fuse_unk", False)
        self.cont_prefix = spec.get("continuing_subword_prefix") or ""
        self.eow_suffix = spec.get("end_of_word_suffix") or ""
        if spec.get("dropout"):
            raise UnsupportedTokenizerJSON("BPE dropout")
        self._cache: Dict[str, List[str]] = {}

    def _merge(self, piece: str) -> List[str]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        word = [
            (self.cont_prefix + ch if i else ch)
            + (self.eow_suffix if i == len(piece) - 1 else "")
            for i, ch in enumerate(piece)
        ]
        while len(word) > 1:
            best, best_i = None, -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]
        if len(self._cache) < 65536:
            self._cache[piece] = word
        return word

    def encode(self, piece: str) -> List[int]:
        ids: List[int] = []
        prev_unk = False
        for tok in self._merge(piece):
            i = self.vocab.get(tok)
            if i is not None:
                ids.append(i)
                prev_unk = False
                continue
            if self.byte_fallback:
                bt = [self.vocab.get(f"<0x{b:02X}>") for b in tok.encode("utf-8")]
                if all(b is not None for b in bt):
                    ids.extend(bt)
                    prev_unk = False
                    continue
            if self.unk_id is not None and not (self.fuse_unk and prev_unk):
                ids.append(self.unk_id)
            prev_unk = True
        return ids


class _Unigram:
    """SentencePiece unigram LM: Viterbi segmentation maximizing the sum of
    per-token log-probs (the scores shipped in tokenizer.json)."""

    _UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty, applied per unk char

    def __init__(self, spec):
        vocab = spec["vocab"]  # [[token, score], ...]
        self.ids: Dict[str, int] = {}
        self.scores: List[float] = []
        self.pieces: List[str] = []
        for tok, score in vocab:
            self.ids[tok] = len(self.pieces)
            self.pieces.append(tok)
            self.scores.append(float(score))
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = spec.get("byte_fallback", False)
        self.min_score = min(self.scores) if self.scores else 0.0
        self.max_len = max((len(p) for p in self.pieces), default=1)
        # bucket pieces by first char to bound the inner loop
        self._by_first: Dict[str, List[str]] = {}
        for p in self.pieces:
            if p:
                self._by_first.setdefault(p[0], []).append(p)

    def encode(self, piece: str) -> List[int]:
        n = len(piece)
        if n == 0:
            return []
        unk_score = self.min_score - self._UNK_PENALTY
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # single-char unk transition (merged later, sentencepiece-style)
            sc = best[i] + unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, None)
            for cand in self._by_first.get(piece[i], ()):
                j = i + len(cand)
                if j > n or piece[i:j] != cand:
                    continue
                tid = self.ids[cand]
                sc = best[i] + self.scores[tid]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, tid)
        # walk back
        toks: List[Tuple[int, int, Optional[int]]] = []  # (start, end, id)
        j = n
        while j > 0:
            i, tid = back[j]
            toks.append((i, j, tid))
            j = i
        toks.reverse()
        ids: List[int] = []
        k = 0
        while k < len(toks):
            start, end, tid = toks[k]
            if tid is not None:
                ids.append(tid)
                k += 1
                continue
            # merge consecutive unk spans into one surface, then fall back
            while k + 1 < len(toks) and toks[k + 1][2] is None:
                k += 1
                end = toks[k][1]
            surface = piece[start:end]
            if self.byte_fallback:
                bt = [
                    self.ids.get(f"<0x{b:02X}>")
                    for b in surface.encode("utf-8")
                ]
                if all(b is not None for b in bt):
                    ids.extend(bt)  # type: ignore[arg-type]
                    k += 1
                    continue
            if self.unk_id is not None:
                ids.append(self.unk_id)
            k += 1
        return ids


def _build_model(spec):
    t = spec.get("type")
    if t == "WordLevel":
        return _WordLevel(spec)
    if t == "WordPiece":
        return _WordPiece(spec)
    if t == "BPE":
        return _BPE(spec)
    if t == "Unigram":
        return _Unigram(spec)
    raise UnsupportedTokenizerJSON(f"model {t}")


# ---------------------------------------------------------------------------
# post-processor (TemplateProcessing, single-sequence template only)


class _Template:
    def __init__(self, spec):
        self.prefix: List[int] = []
        self.suffix: List[int] = []
        if spec is None:
            return
        t = spec.get("type")
        if t != "TemplateProcessing":
            raise UnsupportedTokenizerJSON(f"post_processor {t}")
        specials = {
            name: st["ids"] for name, st in spec.get("special_tokens", {}).items()
        }
        target = self.prefix
        for item in spec.get("single", []):
            if "Sequence" in item:
                if item["Sequence"].get("id") != "A":
                    raise UnsupportedTokenizerJSON("pair template in single")
                target = self.suffix
            elif "SpecialToken" in item:
                target.extend(specials[item["SpecialToken"]["id"]])
            else:
                raise UnsupportedTokenizerJSON(f"template item {item}")

    @property
    def n_added(self) -> int:
        return len(self.prefix) + len(self.suffix)

    def apply(self, ids: List[int]) -> List[int]:
        return self.prefix + ids + self.suffix


# ---------------------------------------------------------------------------
# the tokenizer


class JSONTokenizer:
    """Pure-Python engine for an HF ``tokenizer.json`` (drop-in for the
    ``RustTokenizer`` wrapper: same ``encode_batch``/``vocab_size``/
    ``pad_token_id`` surface, token-for-token the wheel's output on the
    supported subset)."""

    def __init__(self, tokenizer_json: str, pad_token_id: Optional[int] = None):
        with open(tokenizer_json, encoding="utf-8") as f:
            spec = json.load(f)
        if spec.get("truncation") or spec.get("padding"):
            # we manage both in encode_batch (as the wrapper always did)
            pass
        self.normalize = _build_normalizer(spec.get("normalizer"))
        self.pre_tokenize = _build_pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _build_model(spec["model"])
        self.template = _Template(spec.get("post_processor"))

        self._vocab: Dict[str, int] = dict(getattr(self.model, "vocab", {}) or {})
        if not self._vocab and hasattr(self.model, "ids"):
            self._vocab = dict(self.model.ids)
        self.added: Dict[str, dict] = {}
        for at in spec.get("added_tokens", []):
            self.added[at["content"]] = at
            self._vocab.setdefault(at["content"], at["id"])
        self._added_ids = {at["content"]: at["id"] for at in self.added.values()}
        # longest-first alternation so overlapping specials match greedily
        if self.added:
            alts = sorted(self.added, key=len, reverse=True)
            self._added_rx = re.compile(
                "|".join(re.escape(a) for a in alts)
            )
        else:
            self._added_rx = None

        self.pad_token_id = pad_token_id
        if self.pad_token_id is None:
            cfg_path = os.path.join(
                os.path.dirname(tokenizer_json), "tokenizer_config.json"
            )
            if os.path.exists(cfg_path):
                with open(cfg_path, encoding="utf-8") as f:
                    cfg = json.load(f)
                pad_tok = cfg.get("pad_token")
                if isinstance(pad_tok, dict):
                    pad_tok = pad_tok.get("content")
                if pad_tok is not None:
                    self.pad_token_id = self._vocab.get(pad_tok)
        if self.pad_token_id is None:
            self.pad_token_id = 0

    @property
    def vocab_size(self) -> int:
        return max(
            len(getattr(self.model, "vocab", {}) or getattr(self.model, "pieces", [])),
            max(self._added_ids.values(), default=-1) + 1,
        )

    def token_to_id(self, token: str) -> Optional[int]:
        return self._vocab.get(token)

    # -- encoding -----------------------------------------------------------

    def _encode_raw(self, text: str) -> List[int]:
        """Text -> model ids (no template/truncation/padding)."""
        if not text:
            return []
        segments: List[Tuple[str, bool]] = []  # (text, is_added_token)
        if self._added_rx is None:
            segments.append((text, False))
        else:
            last = 0
            for m in self._added_rx.finditer(text):
                at = self.added[m.group()]
                start, end = m.start(), m.end()
                if at.get("single_word"):
                    before = text[start - 1] if start else " "
                    after = text[end] if end < len(text) else " "
                    if before.isalnum() or after.isalnum():
                        continue  # not a standalone word; treat as plain text
                if start > last:
                    segments.append((text[last:start], False))
                seg = m.group()
                # lstrip/rstrip eat adjacent whitespace into the added token
                if at.get("lstrip") and segments and not segments[-1][1]:
                    stripped = segments[-1][0].rstrip()
                    if stripped:
                        segments[-1] = (stripped, False)
                    else:
                        segments.pop()
                segments.append((seg, True))
                last = end
                if at.get("rstrip"):
                    while last < len(text) and text[last].isspace():
                        last += 1
            if last < len(text):
                segments.append((text[last:], False))
        ids: List[int] = []
        for seg, is_added in segments:
            if is_added:
                ids.append(self._added_ids[seg])
                continue
            norm = self.normalize(seg)
            for piece in self.pre_tokenize(norm):
                ids.extend(self.model.encode(piece))
        return ids

    def encode(self, text: str) -> List[int]:
        """Full single-text encode (template applied, no trunc/pad)."""
        return self.template.apply(self._encode_raw(text))

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Match RustTokenizer.encode_batch: truncate (reserving room for
        the template's special tokens), apply template, pad to max_length."""
        room = max(0, max_length - self.template.n_added)
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for r, t in enumerate(texts):
            seq = self.template.apply(self._encode_raw(t or "")[:room])
            seq = seq[:max_length]
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        """Debugging aid (surface-form join; Metaspace-aware)."""
        inv = {v: k for k, v in self._vocab.items()}
        if hasattr(self.model, "pieces"):
            for i, p in enumerate(self.model.pieces):
                inv.setdefault(i, p)
        toks = [inv.get(int(i), "") for i in ids]
        toks = [t for t in toks if t not in self.added]
        return "".join(toks).replace("▁", " ").strip()
