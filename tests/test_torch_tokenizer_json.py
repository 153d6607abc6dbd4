"""The port's tokenizer.json engine against the JAX package's, token for
token, on the fixture vocabularies of tests/test_tokenizer_json.py (each
built with the Rust ``tokenizers`` library, the format's reference), and
``load_tokenizer``'s resolution: CLIP BPE files, a tokenizer.json in the
supported subset, the Rust wheel for one outside it, nothing at all.

A BERT ``tokenizer.json`` (``BertNormalizer``, ``BertPreTokenizer``,
WordPiece, the ``[CLS] $A [SEP]`` template), which the JAX package reads
only through the wheel, loads in the port's engine with the wheel hidden
and gives the wheel's ids token for token; its two components equal the
wheel's on every code point of the scripts and symbol blocks a post
carries (the wheel's older Unicode tables part from Python's only on code
points later versions assigned or recategorised)."""

import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")

from multimodal_content_moderation_tpu.data.tokenizer_json import JSONTokenizer as JJSON
from multimodal_content_moderation_tpu.data.tokenizer_json import (
    UnsupportedTokenizerJSON as JUnsupported,
)
from multimodal_content_moderation_tpu_torch.data import tokenizer as ttok
from multimodal_content_moderation_tpu_torch.data.tokenizer_json import (
    JSONTokenizer,
    UnsupportedTokenizerJSON,
)

import test_tokenizer_json as fixtures  # the JAX package's fixture vocabularies


def _wordlevel():
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "<unk>", "hate", "speech", "the", "a", "thing", ",", "!", "?", "online",
             "works", "right"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    return tk


def _lowercase():
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    tk = Tokenizer(models.WordLevel({"<unk>": 0, "the": 1, "thing": 2, "hate": 3},
                                    unk_token="<unk>"))
    tk.normalizer = normalizers.Lowercase()
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tk


def _template():
    from tokenizers import AddedToken, processors

    tk = fixtures.TestUnigram()._unigram()
    tk.add_special_tokens([AddedToken("<bos>", special=True), AddedToken("<eos>", special=True)])
    bos, eos = tk.token_to_id("<bos>"), tk.token_to_id("<eos>")
    tk.post_processor = processors.TemplateProcessing(
        single="<bos> $A <eos>", special_tokens=[("<bos>", bos), ("<eos>", eos)]
    )
    return tk


def _special():
    from tokenizers import AddedToken

    tk = fixtures.TestUnigram()._unigram()
    tk.add_special_tokens([AddedToken("<image>", special=True)])
    return tk


def _plain_bpe():
    from tokenizers import Tokenizer, models, pre_tokenizers

    toks = ["<unk>", "h", "a", "t", "e", "ha", "hat", "hate", "he", "the", "i", "n", "g", "in",
            "ing", "th", "thing", "s"]
    merges = [("h", "a"), ("ha", "t"), ("hat", "e"), ("t", "h"), ("i", "n"), ("in", "g"),
              ("th", "ing")]
    tk = Tokenizer(models.BPE(vocab={t: i for i, t in enumerate(toks)}, merges=merges,
                              unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tk


def _wordpiece():
    from tokenizers import Tokenizer, models, pre_tokenizers

    toks = ["[PAD]", "[UNK]", "hate", "speech", "th", "##ing", "##e", "the", "a", "on", "##line"]
    tk = Tokenizer(models.WordPiece({t: i for i, t in enumerate(toks)}, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tk


BUILDERS = {
    "wordlevel_whitespace": _wordlevel,
    "wordlevel_lowercase": _lowercase,
    "unigram_metaspace": lambda: fixtures.TestUnigram()._unigram(),
    "unigram_byte_fallback": lambda: fixtures.TestUnigram()._unigram(byte_fallback=True),
    "unigram_template": _template,
    "unigram_special_tokens": _special,
    "bpe_gemma_style": lambda: fixtures.TestBPE()._gemma_style(),
    "bpe_plain": _plain_bpe,
    "wordpiece": _wordpiece,
}
EXTRA = ["<image> hate speech", "hate <image> speech", "<image>", "hate speech " * 20]


@pytest.mark.parametrize("max_length", [16, 8])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_json_tokenizer_matches_jax(tmp_path, name, max_length):
    path = str(tmp_path / "tokenizer.json")
    BUILDERS[name]().save(path)
    mine, theirs = JSONTokenizer(path), JJSON(path)
    assert mine.pad_token_id == theirs.pad_token_id
    assert mine.vocab_size == theirs.vocab_size
    for text in fixtures.CORPUS + EXTRA:
        assert mine.encode(text) == theirs.encode(text), text
    ids, mask = mine.encode_batch(fixtures.CORPUS + EXTRA, max_length=max_length)
    want_ids, want_mask = theirs.encode_batch(fixtures.CORPUS + EXTRA, max_length=max_length)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


def test_load_tokenizer_resolution(tmp_path, encoder_dir):
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    assert isinstance(ttok.load_tokenizer(encoder_dir), ttok.ClipBPETokenizer)

    native = tmp_path / "native"
    native.mkdir()
    tk = Tokenizer(models.WordLevel({"<pad>": 0, "<unk>": 1, "hate": 2, "speech": 3},
                                    unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(native / "tokenizer.json"))
    (native / "tokenizer_config.json").write_text(json.dumps({"pad_token": "<pad>"}))
    loaded = ttok.load_tokenizer(str(native))
    assert isinstance(loaded, JSONTokenizer) and loaded.pad_token_id == 0
    assert loaded.encode_batch(["hate speech"], max_length=4)[0][0].tolist() == [2, 3, 0, 0]

    rust = tmp_path / "rust"
    rust.mkdir()
    tk = Tokenizer(models.WordLevel({"<unk>": 0, "hate": 1}, unk_token="<unk>"))
    tk.normalizer = normalizers.Lowercase()
    # RoBERTa's byte-level pre-tokenizer: outside the engine's subset
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.save(str(rust / "tokenizer.json"))
    with pytest.raises(UnsupportedTokenizerJSON):
        JSONTokenizer(str(rust / "tokenizer.json"))
    loaded = ttok.load_tokenizer(str(rust))
    assert isinstance(loaded, ttok.RustTokenizer)
    assert loaded.encode_batch(["hate"], max_length=4)[0][0, 0] == 1

    with pytest.raises(FileNotFoundError, match="No tokenizer assets"):
        ttok.load_tokenizer(str(tmp_path))


# ---------------------------------------------------------------- BERT


BERT_TEXTS = [
    "Hello, World! This is a TEST.",
    "Héllo wörld — naïve café; ÀÉÎÕÜ ç",
    "don't stop-believing... (really?) [yes] {no} <maybe> a+b=c $5 10.5% #tag @user",
    "中文字符测试 and 日本語テキスト mixed with 한국어",
    "ΟΔΟΣ Σίσυφος and Ελλάδα; Привет, МИР!",
    "tabs\tand\nnewlines\r\nand\x0bvertical\x0cfeed \u00a0nbsp \u3000ideographic",
    "zero\u200bwidth\u200djoiner\ufeffbom\x00null\ufffdreplacement\x7fdel",
    "emoji 😀🔥 #hashtag ¿qué? «quoted» ‘curly’ “double” …",
    "supercalifragilisticexpialidocious" * 5,
    "İstanbul ß ﬁ ǅ Ǆ",
    "",
    "   ",
    "unknownwordzzz qqq",
]


def _bert_tokenizer_json(directory, lowercase=True):
    """A BERT WordPiece tokenizer.json written by ``transformers``'
    ``BertTokenizerFast`` (the files of a BERT checkpoint)."""
    transformers = pytest.importorskip("transformers")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += sorted({w for t in BERT_TEXTS for w in t.lower().split()} | set(
        "abcdefghijklmnopqrstuvwxyz0123456789.,!?;:'\"()[]{}<>+=$%#@-—…«»¿‘’“”"))
    words += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"] + ["hel", "##lo", "wor", "##ld",
                                                               "中", "文", "##s", "##ing"]
    vocab = directory / "vocab.txt"
    vocab.write_text("\n".join(dict.fromkeys(words)), encoding="utf-8")
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab), do_lower_case=lowercase)
    tok.save_pretrained(str(directory))
    return str(directory / "tokenizer.json")


@pytest.mark.parametrize("lowercase", [True, False])
def test_bert_tokenizer_json_matches_the_wheel_with_the_wheel_hidden(tmp_path, monkeypatch,
                                                                      lowercase):
    import sys

    path = _bert_tokenizer_json(tmp_path, lowercase)
    spec = json.loads(open(path, encoding="utf-8").read())
    assert spec["normalizer"]["type"] == "BertNormalizer"
    assert spec["pre_tokenizer"]["type"] == "BertPreTokenizer"
    assert spec["model"]["type"] == "WordPiece"
    wheel = ttok.RustTokenizer(path)
    with pytest.raises(JUnsupported):  # the JAX engine needs the wheel
        JJSON(path)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    mine = ttok.load_tokenizer(str(tmp_path))
    assert isinstance(mine, JSONTokenizer)
    assert mine.pad_token_id == wheel.pad_token_id == 0
    for max_length in (77, 12):
        ids, mask = mine.encode_batch(BERT_TEXTS, max_length=max_length)
        want_ids, want_mask = wheel.encode_batch(BERT_TEXTS, max_length=max_length)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
    assert ids[-3, :2].tolist() == [2, 3]  # the empty text: [CLS] [SEP]


# the blocks a post's text is drawn from: Latin, Greek, Cyrillic, Armenian,
# Hebrew, Arabic, Devanagari, Thai, Hangul Jamo, general punctuation,
# currency, letterlike symbols, arrows, math operators, CJK symbols, kana,
# CJK ideographs, Hangul, the compatibility and half/full-width forms, emoji
POST_BLOCKS = [(0x0000, 0x05FF), (0x0600, 0x06FF), (0x0900, 0x097F), (0x0E00, 0x0E7F),
               (0x1100, 0x11FF), (0x2000, 0x22FF), (0x3000, 0x30FF), (0x3400, 0x4DBF),
               (0x4E00, 0x9FFF), (0xAC00, 0xD7A3), (0xF900, 0xFAFF), (0xFE30, 0xFFEF),
               (0x1F300, 0x1F64F)]


def test_bert_normalizer_and_pre_tokenizer_match_the_wheel_per_code_point():
    from tokenizers import normalizers, pre_tokenizers

    from multimodal_content_moderation_tpu_torch.data import tokenizer_json as tj

    spec = {"clean_text": True, "handle_chinese_chars": True, "strip_accents": None,
            "lowercase": True}
    wheel_n = normalizers.BertNormalizer(**spec)
    wheel_p = pre_tokenizers.BertPreTokenizer()
    mine_n = tj._bert_normalizer(spec)
    n = 0
    for lo, hi in POST_BLOCKS:
        for cp in range(lo, hi + 1):
            text = f"ab{chr(cp)}cd"
            assert mine_n(text) == wheel_n.normalize_str(text), hex(cp)
            wheel_pieces = [p for p, _ in wheel_p.pre_tokenize_str(text)]
            if cp in VERSION_GAP:  # unassigned in the wheel: a letter-like piece
                assert wheel_pieces == [text] and tj._bert_pre_tokenize(text) == [
                    "ab", chr(cp), "cd"], hex(cp)
                continue
            assert tj._bert_pre_tokenize(text) == wheel_pieces, hex(cp)
            n += 1
    assert n == 43891  # every code point of the blocks but the gap


# assigned after the wheel's Unicode tables: U+061D ARABIC END OF TEXT MARK
# (Unicode 14.0, category Po in Python's 15.0 database)
VERSION_GAP = {0x061D}


def test_synthetic_bert_vocabulary_matches_the_wheel(tmp_path, monkeypatch):
    """``testdata.write_bert_wordpiece`` (the 30,522-entry vocabulary the
    card's smoke run tokenizes with) loads in the wheel and in the port's
    engine, with the wheel hidden, and both give the same ids."""
    import sys

    from multimodal_content_moderation_tpu_torch.testdata import write_bert_wordpiece

    vocab = write_bert_wordpiece(str(tmp_path), 30522, seed=0, words=["hate", "love"])
    assert len(vocab) == 30522 and vocab["[CLS]"] == 101 and vocab["[SEP]"] == 102
    wheel = ttok.RustTokenizer(str(tmp_path / "tokenizer.json"))
    assert wheel.vocab_size == 30522
    want = wheel.encode_batch(BERT_TEXTS, max_length=77)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    mine = ttok.load_tokenizer(str(tmp_path))
    assert isinstance(mine, JSONTokenizer) and mine.pad_token_id == 0
    got = mine.encode_batch(BERT_TEXTS, max_length=77)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] > 103).sum() > 3 * len(BERT_TEXTS)  # real pieces, not [UNK] only
