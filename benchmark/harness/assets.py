"""Files a user of the endpoint or the CLIs has beside a checkpoint, made by
the benchmark: the tokenizer assets of each configuration (a synthetic
vocabulary of the published size), the encoder's ``config.json`` and
``preprocessor_config.json``, and the committed JPEG fixtures. The
vocabularies do not depend on the run's seed, so they are written once into
a fixed directory of the checkout and read by every later run."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np

from benchmark.harness.spec import BENCH_DIR, ROOT

JPEG_DIR = os.path.join(BENCH_DIR, "assets", "jpeg")
ASSET_CACHE = os.path.join(ROOT, "build", "benchmark_cache", "assets")


def fixtures() -> List[str]:
    """The JPEG fixtures' names, in name order."""
    return sorted(f[:-4] for f in os.listdir(JPEG_DIR) if f.endswith(".jpg"))


def fixture_bytes() -> Dict[str, bytes]:
    out = {}
    for name in fixtures():
        with open(os.path.join(JPEG_DIR, f"{name}.jpg"), "rb") as f:
            out[name] = f.read()
    return out


def lexicon(n: int = 8192) -> List[str]:
    """The words texts are made of: ``n`` distinct lowercase pseudo-words of
    2 to 9 letters, the same for every run."""
    g = np.random.default_rng(20240917)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    # English-like letter frequencies, so that BPE merges find common pairs
    freq = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.2, 0.8, 4.0, 2.4, 6.7,
                     7.5, 1.9, 0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.2, 2.0, 0.1])
    freq /= freq.sum()
    words, seen = [], set()
    while len(words) < n:
        k = int(g.integers(2, 10))
        w = "".join(g.choice(letters, size=k, p=freq))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


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


def write_clip_bpe(directory: str, vocab_size: int) -> None:
    """``vocab.json`` + ``merges.txt`` of ``vocab_size`` entries: the 256
    byte symbols and their ``</w>`` forms, merges drawn from a fixed seed
    that favour lowercase letters and the tokens made early, and
    ``<|startoftext|>`` / ``<|endoftext|>`` as the last two ids."""
    g = np.random.default_rng(0)
    symbols = list(_bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for s in symbols + [s + "</w>" for s in symbols]:
        vocab[s] = len(vocab)
    letters = [s for s in symbols if s.isalpha() and s.isascii() and s.islower()]
    heads, tails = list(letters), list(letters) + [s + "</w>" for s in letters]
    merges = []
    while len(merges) < vocab_size - 2 - 2 * len(symbols):
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
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def write_wordlevel(directory: str, vocab_size: int) -> None:
    """A WordLevel ``tokenizer.json`` (lowercase, words and punctuation):
    ``<unk>``, ``<pad>``, the lexicon, then ``fill<i>`` entries up to
    ``vocab_size``."""
    vocab = {"<unk>": 0, "<pad>": 1}
    for w in lexicon():
        vocab.setdefault(w, len(vocab))
    i = 0
    while len(vocab) < vocab_size:
        vocab.setdefault(f"fill{i}", len(vocab))
        i += 1
    spec = {"version": "1.0", "normalizer": {"type": "Lowercase"},
            "pre_tokenizer": {"type": "Whitespace"},
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
            "added_tokens": [], "post_processor": None, "decoder": None}
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f)
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"pad_token": "<pad>"}, f)


def encoder_files(config: Dict) -> Dict[str, Dict]:
    """The encoder's ``config.json`` and ``preprocessor_config.json``."""
    size = config["vision_config"]["image_size"]
    img = config["image"]
    pre = {"size": {"shortest_edge": size}, "crop_size": {"height": size, "width": size},
           "image_mean": img["mean"], "image_std": img["std"]}
    enc = {"model_type": config["family"], "text_config": config["text_config"],
           "vision_config": config["vision_config"]}
    if "projection_dim" in config:
        enc["projection_dim"] = config["projection_dim"]
    return {"config.json": enc, "preprocessor_config.json": pre}


def encoder_dir(config: Dict, root: str = ASSET_CACHE) -> str:
    """A directory with the configuration's tokenizer and encoder files,
    written once under ``root`` (atomically: a finished directory is
    renamed into place)."""
    text = config["text_config"]
    key = f"{config['tokenizer']}-{text['vocab_size']}-{config['name']}"
    path = os.path.join(root, key)
    if os.path.isdir(path):
        return path
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp-")
    try:
        if config["tokenizer"] == "clip_bpe":
            write_clip_bpe(tmp, text["vocab_size"])
        elif config["tokenizer"] == "wordlevel":
            write_wordlevel(tmp, text["vocab_size"])
        else:
            raise ValueError(f"tokenizer {config['tokenizer']!r}: want clip_bpe or wordlevel")
        for name, obj in encoder_files(config).items():
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f)
        try:
            os.rename(tmp, path)
        except OSError:  # another process finished first
            if not os.path.isdir(path):
                raise
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    return path
