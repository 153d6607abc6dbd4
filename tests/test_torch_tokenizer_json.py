"""The port's tokenizer.json engine against the JAX package's, token for
token, on the fixture vocabularies of tests/test_tokenizer_json.py (each
built with the Rust ``tokenizers`` library, the format's reference), and
``load_tokenizer``'s resolution: CLIP BPE files, a tokenizer.json in the
supported subset, the Rust wheel for one outside it, nothing at all."""

import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")

from multimodal_content_moderation_tpu.data.tokenizer_json import JSONTokenizer as JJSON
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
    tk.normalizer = normalizers.BertNormalizer()  # outside the engine's subset
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.save(str(rust / "tokenizer.json"))
    with pytest.raises(UnsupportedTokenizerJSON):
        JSONTokenizer(str(rust / "tokenizer.json"))
    loaded = ttok.load_tokenizer(str(rust))
    assert isinstance(loaded, ttok.RustTokenizer)
    assert loaded.encode_batch(["hate"], max_length=4)[0][0, 0] == 1

    with pytest.raises(FileNotFoundError, match="No tokenizer assets"):
        ttok.load_tokenizer(str(tmp_path))
