"""The port's CLIP pre-tokenizer without ``regex`` (``data/tokenizer.py``:
``collapse_whitespace`` and ``_clip_findall`` on ``unicodedata``) against
``regex`` itself and against the JAX package's ``ClipBPETokenizer``.

- Every code point assigned in ``unicodedata.unidata_version``, one at a
  time: the same pieces as ``regex.findall(_CLIP_PATTERN, IGNORECASE)`` and
  the same whitespace collapse as ``regex.sub(r"\\s+", " ")`` (exact).
- U+001C-U+001F, which ``str.isspace`` counts as white space and ``regex``'s
  ``\\s`` (the White_Space property) does not, inside and at both ends of a
  string; and seeded random strings over a mixed alphabet: token ids equal
  to the JAX tokenizer's (exact), with the port's ``regex`` hidden.
- The Unicode-version gap: every code point where ``regex``'s newer tables
  call a character a letter or a number and Python's database does not is
  unassigned (Cn) in Python's database.
"""

import sys
import unicodedata

import numpy as np
import pytest
import regex

from multimodal_content_moderation_tpu.data.tokenizer import ClipBPETokenizer as JTok
from multimodal_content_moderation_tpu_torch.data import tokenizer as ttok
from multimodal_content_moderation_tpu_torch.testdata import write_clip_bpe

PATTERN = regex.compile(ttok._CLIP_PATTERN, regex.IGNORECASE)
N_CHUNKS = 8
CHUNK = (sys.maxunicode + 1) // N_CHUNKS


def _assigned(lo, hi):
    return [chr(c) for c in range(lo, hi) if unicodedata.category(chr(c)) != "Cn"]


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_every_assigned_code_point_matches_regex(chunk):
    bad = []
    for ch in _assigned(chunk * CHUNK, (chunk + 1) * CHUNK):
        for s in (ch, "a" + ch + "1", "'" + ch):
            if ttok._clip_findall(s) != PATTERN.findall(s):
                bad.append((hex(ord(ch)), s))
            if ttok.collapse_whitespace(s) != regex.sub(r"\s+", " ", s):
                bad.append(("ws", hex(ord(ch))))
    assert not bad, bad[:10]


def test_unicode_version_gap_is_unassigned_code_points_only():
    """regex carries a newer Unicode database than unicodedata: the code
    points where \\p{L} / \\p{N} disagree with the categories are all Cn
    here (a version difference, not a difference of the scanners)."""
    gap = [
        c for c in range(sys.maxunicode + 1)
        if not 0xD800 <= c <= 0xDFFF
        and (bool(regex.fullmatch(r"\p{L}", chr(c)))
             != unicodedata.category(chr(c)).startswith("L")
             or bool(regex.fullmatch(r"\p{N}", chr(c)))
             != unicodedata.category(chr(c)).startswith("N"))
    ]
    assert {unicodedata.category(chr(c)) for c in gap} <= {"Cn"}


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_bpe")
    write_clip_bpe(str(d), vocab_size=49408, seed=0)
    return str(d)


@pytest.fixture
def no_regex(monkeypatch):
    monkeypatch.setattr(ttok, "_re", None)


def _pair(vocab_dir):
    files = (f"{vocab_dir}/vocab.json", f"{vocab_dir}/merges.txt")
    return JTok(*files), ttok.ClipBPETokenizer(*files)


def test_tokenizer_builds_without_regex(vocab_dir, no_regex):
    _, tok = _pair(vocab_dir)
    assert tok.pat is None
    assert tok.bos_token_id == 49406 and tok.eos_token_id == 49407


@pytest.mark.parametrize("sep", ["\x1c", "\x1d", "\x1e", "\x1f"])
def test_information_separators_inside_and_at_the_ends(vocab_dir, no_regex, sep):
    """U+001C-U+001F are not \\s to regex: kept inside a string (a piece of
    their own), stripped at the ends by the trailing ``.strip()``."""
    jtok, tok = _pair(vocab_dir)
    for text in (f"a{sep}b", f"{sep}hello{sep}", f"x {sep} y", f"{sep}{sep}", f"it's{sep}s"):
        assert tok.tokenize_ids(text) == jtok.tokenize_ids(text), repr(text)
        ids_t, mask_t = tok.encode_batch([text], 16)
        ids_j, mask_j = jtok.encode_batch([text], 16)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)


ALPHABET = (
    [chr(c) for c in range(0x20, 0x250)]
    + list("\t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0     　")
    + list("ͅſKİ١½一あ가אا")
    + ["\U0001f600", "\U0001f525", "‍", "️", "́"]
    + ["<|startoftext|>", "<|endoftext|>", "<|STARTOFTEXT|>", "'s", "'S", "'ſ", "'re",
       "'ll", "'ve", "'m", "'d", "'t", " "]
)


@pytest.mark.parametrize("seed", range(4))
def test_random_strings_give_the_jax_token_ids(vocab_dir, no_regex, seed):
    jtok, tok = _pair(vocab_dir)
    g = np.random.default_rng(seed)
    texts = ["".join(ALPHABET[i] for i in g.integers(0, len(ALPHABET), size=int(n)))
             for n in g.integers(0, 60, size=300)]
    for text in texts:
        assert ttok._clip_findall(text) == PATTERN.findall(text), repr(text)
        assert tok.tokenize_ids(text) == jtok.tokenize_ids(text), repr(text)
    ids_t, mask_t = tok.encode_batch(texts, 77)
    ids_j, mask_j = jtok.encode_batch(texts, 77)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)


def test_regex_and_fallback_tokenizers_agree(vocab_dir, monkeypatch):
    """The port with ``regex`` (the default where it is installed) and
    without it give the same ids on tweet-like text."""
    files = (f"{vocab_dir}/vocab.json", f"{vocab_dir}/merges.txt")
    with_regex = ttok.ClipBPETokenizer(*files)
    monkeypatch.setattr(ttok, "_re", None)
    without = ttok.ClipBPETokenizer(*files)
    assert with_regex.pat is not None and without.pat is None
    texts = ["RT @user: they're NOT welcome here!!! #news 🔥🔥", "  lol what  ",
             "I'll go back home… it's 3:15am", "Ünïcödé ſtraße İstanbul ½ ٣"]
    for text in texts:
        assert without.tokenize_ids(text) == with_regex.tokenize_ids(text), repr(text)
