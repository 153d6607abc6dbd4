"""The port's stdlib CSV reader (``data/dataset.read_csv``) against
``pandas.read_csv``, which the JAX package's ``CSVDataset`` and inference
CLI use: every column as ``fillna("").astype(str)``, ``label`` as
``astype(int)``, and the JAX ``CSVDataset``'s rows (texts, paths, labels,
text presence, token ids), all exact. The cases are pandas' conventions
that the reference inherits: blank and whitespace-only lines skipped, the
default NA strings read as missing (so a tweet that reads ``null`` has no
text), numeric columns typed (``5`` above an empty row reads ``"5.0"``),
quotes and embedded newlines; and a CSV written back as ``to_csv`` does."""

import csv
import io

import numpy as np
import pandas as pd
import pytest

from multimodal_content_moderation_tpu.data.dataset import CSVDataset as JDataset
from multimodal_content_moderation_tpu.data.images import ImagePreprocessor as JPre
from multimodal_content_moderation_tpu.data.tokenizer import load_tokenizer as j_load
from multimodal_content_moderation_tpu_torch.data.dataset import NA_STRINGS, CSVDataset, read_csv
from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
FIELDS = [
    "hello world", "she said \"no\", then left", "line one\nline two", "  padded  ",
    "tab\there", "5", "-3", "007", "+5", "1.5", "1e5", ".5", "inf", "-Infinity", "true",
    "FALSE", "é 🙂 ſ", "#tag, @user", "a,b,c", "'quoted'", " 5 ", "1_000", "0x10", "nan1",
    "", "NA", "null", "None", "nan", "N/A", "#N/A", "<NA>", "NULL",
]


def _write(path, header, rows, blank_every=0):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i, r in enumerate(rows):
            w.writerow(r)
            if blank_every and i % blank_every == 0:
                f.write("\n" if i % 2 else "   \n")


def _assert_same_as_pandas(path):
    df = pd.read_csv(path)
    got = read_csv(str(path))
    assert got.columns == list(df.columns)
    assert len(got) == len(df)
    for name in df.columns:
        assert got.strings(name) == df[name].fillna("").astype(str).tolist(), name


@pytest.mark.parametrize("seed", range(6))
def test_seeded_csvs_read_as_pandas_reads_them(tmp_path, seed):
    g = np.random.default_rng(seed)
    n = int(g.integers(1, 40))
    pools = [FIELDS, FIELDS[5:16] + ["", "NA"], ["1", "0", "1", "0", ""], FIELDS[:5]]
    cols = [pools[int(g.integers(0, len(pools)))] for _ in range(4)]
    rows = [[c[int(g.integers(0, len(c)))] for c in cols] for _ in range(n)]
    path = tmp_path / "t.csv"
    _write(path, ["text", "image_path", "num", "other"], rows, blank_every=int(g.integers(0, 4)))
    _assert_same_as_pandas(path)


@pytest.mark.parametrize("na", sorted(NA_STRINGS))
def test_na_strings_are_no_text(tmp_path, na, encoder_dir):
    """Each default NA string (quoted or not) is a missing text: "" and
    text_present 0, in the port's CSVDataset as in the JAX one."""
    path = tmp_path / "t.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        f.write("text,image_path,label\n")
        f.write(f"{na},a.jpg,1\n")
        f.write(f"\"{na}\",,0\n")
        f.write("real text,b.jpg,1\n")
    _assert_same_as_pandas(path)
    ds = CSVDataset(str(path), "", load_tokenizer(encoder_dir), ImagePreprocessor(32, 32), 16)
    jds = JDataset(str(path), "", j_load(encoder_dir), JPre(32, 32), 16)
    assert ds.texts == jds.texts and ds.texts[:2] == ["", ""]
    np.testing.assert_array_equal(ds.text_present, jds.text_present)


@pytest.mark.parametrize(
    "body,want",
    [
        ("5,a,1\n,b,0\n", ["5.0", ""]),  # numeric with a missing value: float
        ("5,a,1\n6,b,0\n", ["5", "6"]),
        ("true,a,1\nFALSE,b,0\n", ["True", "False"]),
        ("1.5,a,1\n2,b,0\n", ["1.5", "2.0"]),
        (" 5 ,a,1\n", ["5"]),
        ("1e20,a,1\n", ["1e+20"]),
        ("True,a,1\n2,b,0\n", ["True", "2"]),
        ("9223372036854775808,a,1\n,b,0\n", ["9223372036854775808", ""]),
    ],
)
def test_typed_text_columns(tmp_path, body, want):
    path = tmp_path / "t.csv"
    path.write_text("text,image_path,label\n" + body)
    _assert_same_as_pandas(path)
    assert read_csv(str(path)).strings("text") == want


def test_blank_lines_quotes_and_short_rows(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text('text,image_path,label\n\n   \n"multi\nline, ""q""",a,1\nx,,0\n\ny\n')
    _assert_same_as_pandas(path)
    t = read_csv(str(path))
    assert t.strings("text") == ['multi\nline, "q"', "x", "y"]
    with pytest.raises(ValueError):
        t.ints("label")  # the short row's label is missing, as astype(int) refuses


def test_dataset_rows_equal_the_jax_dataset(tmp_path, encoder_dir):
    g = np.random.default_rng(3)
    rows = [[FIELDS[int(g.integers(0, len(FIELDS)))], f"im{i}.jpg" if i % 3 else "",
             ",".join(c for c in CLASSES if g.random() < 0.3)] for i in range(40)]
    path = tmp_path / "t.csv"
    _write(path, ["text", "image_path", "labels"], rows, blank_every=3)
    tok, jtok = load_tokenizer(encoder_dir), j_load(encoder_dir)
    ds = CSVDataset(str(path), "", tok, ImagePreprocessor(32, 32), 16, class_names=CLASSES)
    jds = JDataset(str(path), "", jtok, JPre(32, 32), 16, class_names=CLASSES)
    assert ds.texts == jds.texts and ds.paths == jds.paths
    for a, b in ((ds.labels, jds.labels), (ds.text_present, jds.text_present),
                 (ds.input_ids, jds.input_ids), (ds.attention_mask, jds.attention_mask)):
        np.testing.assert_array_equal(a, b)


def test_binary_labels_as_astype_int(tmp_path, encoder_dir):
    path = tmp_path / "t.csv"
    path.write_text("text,image_path,label\na,,1.0\nb,,0\nc,,1\n")
    ds = CSVDataset(str(path), "", load_tokenizer(encoder_dir), ImagePreprocessor(32, 32), 16)
    jds = JDataset(str(path), "", j_load(encoder_dir), JPre(32, 32), 16)
    np.testing.assert_array_equal(ds.labels, jds.labels)


def test_write_equals_pandas_to_csv(tmp_path):
    """``CSVTable.write`` with bool and float columns added, as the CSV mode
    of inference writes them, gives the bytes of ``df.to_csv``."""
    src = tmp_path / "in.csv"
    src.write_text('text,image_path,n\n"a, b",x.jpg,5\nNA,,\n"q""uote\nnl",y.jpg,7\n')
    df = pd.read_csv(src)
    extra = {"pred_racist": [True, False, True], "prob_racist": [0.25, 1e-7, 0.3333333333333333],
             "any_harmful": [True, False, False]}
    for k, v in extra.items():
        df[k] = v
    want = tmp_path / "pandas.csv"
    df.to_csv(want, index=False)
    got = tmp_path / "port.csv"
    read_csv(str(src)).write(str(got), extra)
    assert got.read_bytes() == want.read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(io.StringIO(got.read_text())), pd.read_csv(want))
