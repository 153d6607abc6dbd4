"""The port's data preparation (``data/preprocessing.py``,
``cli/prepare_data.py``) and ``test_predictions.csv`` against the JAX
package's pandas writers, byte for byte.

- Raw MMHS150K (``MMHS150K_GT.json`` + ``splits/*_ids.txt``) and Hateful
  Memes ``--local_dir`` snapshots built under ``tmp_path``, with the cases
  of tests/test_cli.py:255 and :456 (the label-index quirk: index 0 ->
  racist, index 5 dropped) and texts that are None, hold a quote, a comma,
  a newline or a carriage return, an empty split (a lone ``\\n``), a
  missing split file and an id absent from the ground truth: every CSV,
  ``class_names.txt`` and the printed lines equal JAX's.
- ``dump_predictions`` equals the JAX train CLI's ``DataFrame.to_csv`` on
  float32 probabilities (``0.5``, ``1.0000017e-08``, ``1.0``, NaN as an
  empty field: each the float32's own ``str``) and float32 labels;
  ``write_records`` equals ``pd.DataFrame(records).to_csv(index=False)``.
- The train CLI with ``dump_test_predictions: true`` and yaml and pandas
  hidden writes a ``test_predictions.csv`` that parses, with the
  ``prob_<name>`` columns first and the ``label_<name>`` columns after.
"""

import json
import sys

import numpy as np
import pandas as pd
import pytest
import yaml
from PIL import Image

from multimodal_content_moderation_tpu.cli import prepare_data as j_prep
from multimodal_content_moderation_tpu_torch.cli import prepare_data as t_prep
from multimodal_content_moderation_tpu_torch.cli import train as t_train
from multimodal_content_moderation_tpu_torch.data.dataset import read_csv, write_records

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
ODD_TEXTS = [None, 'a"b,\nc', "racist,sexist", "carriage\rreturn", " lead and trail ",
             "ünïcödé 🙂", "", "NA", "5"]


def _mmhs_raw(root):
    raw = root / "raw"
    (raw / "splits").mkdir(parents=True)
    gt = {
        "111": {"tweet_text": "t1", "labels": [0, 2], "labels_str": []},
        "222": {"tweet_text": "t2", "labels": [5], "labels_str": []},
        "333": {"tweet_text": "t3", "labels": [1, 4, 5], "labels_str": []},
        "444": {"labels": [3]},
    }
    for i, text in enumerate(ODD_TEXTS):
        gt[str(500 + i)] = {"tweet_text": text, "labels": [i % 6, (i + 2) % 6]}
    (raw / "MMHS150K_GT.json").write_text(json.dumps(gt))
    (raw / "splits" / "train_ids.txt").write_text(
        "111\n222\n333\n\n999\n" + "".join(f"{500 + i}\n" for i in range(len(ODD_TEXTS))))
    (raw / "splits" / "val_ids.txt").write_text("\n\n")  # no rows
    (raw / "splits" / "test_ids.txt").write_text("444\n111\n")
    return raw


def _read_all(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


def test_mmhs150k_csvs_equal_jax(tmp_path, capsys):
    raw = _mmhs_raw(tmp_path)
    j_prep.main(["--dataset", "mmhs150k", "--raw_dir", str(raw), "--out_dir",
                 str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    t_prep.main(["--dataset", "mmhs150k", "--raw_dir", str(raw), "--out_dir",
                 str(tmp_path / "torch")])
    tout = capsys.readouterr().out
    got, want = _read_all(tmp_path / "torch"), _read_all(tmp_path / "jax")
    assert set(got) == {"train.csv", "val.csv", "test.csv", "class_names.txt"}
    assert got == want
    assert tout == jout.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert got["val.csv"] == b"\n"
    assert (tmp_path / "torch" / "images").is_dir()
    # the reference's label-index quirk (tests/test_cli.py:255)
    df = pd.read_csv(tmp_path / "torch" / "train.csv")
    assert df.iloc[0]["labels"] == "racist,homophobe"
    assert pd.isna(df.iloc[1]["labels"])
    assert df.iloc[2]["labels"] == "sexist,otherhate"
    assert read_csv(str(tmp_path / "torch" / "train.csv")).strings("image_path")[0] == "111.jpg"


def test_mmhs150k_missing_split_file_is_skipped(tmp_path, capsys):
    raw = _mmhs_raw(tmp_path)
    (raw / "splits" / "test_ids.txt").unlink()
    for pkg, name in ((j_prep, "jax"), (t_prep, "torch")):
        pkg.main(["--dataset", "mmhs150k", "--raw_dir", str(raw), "--out_dir",
                  str(tmp_path / name)])
    assert "no test_ids.txt; test skipped" in capsys.readouterr().out
    assert _read_all(tmp_path / "torch") == _read_all(tmp_path / "jax")
    assert not (tmp_path / "torch" / "test.csv").exists()


def _memes_snapshot(root, dev_rows=True):
    snap = root / "snapshot"
    (snap / "img").mkdir(parents=True)
    for name in ("a.png", "b.png"):
        Image.fromarray(np.full((4, 4, 3), 7, np.uint8)).save(snap / "img" / name)
    rows = {
        "train.jsonl": [
            {"id": 1, "img": "img/a.png", "label": 1, "text": "bad meme"},
            {"id": 2, "img": "img/b.png", "label": 0, "text": "fine meme"},
            {"id": 3, "img": "img/a.png", "text": None},
            {"id": 4, "img": "b.png", "label": 1},
        ] + [{"id": 10 + i, "img": "img/a.png", "label": i % 2, "text": t}
             for i, t in enumerate(ODD_TEXTS) if t is not None],
        "dev_seen.jsonl": [{"id": 5, "img": "img/a.png", "label": 1, "text": "x"}]
        if dev_rows else [],
    }
    for name, recs in rows.items():
        with open(snap / name, "w") as f:
            f.write("\n")
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return snap  # no test_seen.jsonl: that split is skipped


@pytest.mark.parametrize("dev_rows", [True, False])
def test_hateful_memes_local_dir_equals_jax(tmp_path, capsys, dev_rows):
    snap = _memes_snapshot(tmp_path, dev_rows)
    printed = []
    for pkg, name in ((j_prep, "jax"), (t_prep, "torch")):
        pkg.main(["--dataset", "hateful_memes", "--out_dir", str(tmp_path / name),
                  "--local_dir", str(snap)])
        printed.append(capsys.readouterr().out.replace(str(tmp_path / name), "OUT"))
    assert printed[0] == printed[1]
    got = _read_all(tmp_path / "torch" / "hateful_memes")
    want = _read_all(tmp_path / "jax" / "hateful_memes")
    assert set(got) == {"train.csv", "val.csv", "class_names.txt"}
    assert got == want
    assert got["class_names.txt"] == b"hateful\n"
    assert (got["val.csv"] == b"\n") is not dev_rows
    assert sorted(p.name for p in (tmp_path / "torch" / "hateful_memes" / "images").iterdir()) \
        == ["a.png", "b.png"]
    train = pd.read_csv(tmp_path / "torch" / "hateful_memes" / "train.csv")
    assert list(train.columns) == ["text", "image_path", "label"]
    assert train["label"].tolist()[:4] == [1, 0, 0, 1]


def test_hateful_memes_needs_an_img_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="img"):
        t_prep.main(["--dataset", "hateful_memes", "--out_dir", str(tmp_path / "o"),
                     "--local_dir", str(tmp_path / "empty")])
    with pytest.raises(SystemExit):
        t_prep.main(["--dataset", "mmhs150k", "--out_dir", str(tmp_path / "o")])


@pytest.mark.parametrize("records", [
    [],
    [{"text": None, "image_path": "a.jpg", "labels": "racist,sexist"},
     {"text": 'a"b,\nc', "image_path": "x", "labels": ""}],
    [{"text": "x", "image_path": "a.png", "label": 1},
     {"text": "tab\there", "image_path": "r\rx", "label": 0}],
    [{"p": np.float32(0.123456789), "q": np.float64(0.1), "n": np.float32("nan"), "b": True}],
])
def test_write_records_equals_pandas(tmp_path, records):
    write_records(str(tmp_path / "t.csv"), records)
    pd.DataFrame(records).to_csv(tmp_path / "p.csv", index=False)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()


def _jax_dump(path, t_probs, t_labels, class_names):
    """The JAX train CLI's writer (multimodal_content_moderation_tpu/cli/
    train.py, dump_test_predictions)."""
    pred_df = pd.DataFrame({f"prob_{n}": t_probs[:, j] for j, n in enumerate(class_names)})
    for j, n in enumerate(class_names):
        pred_df[f"label_{n}"] = t_labels[:, j]
    pred_df.to_csv(path, index=False)


def test_dump_predictions_equals_pandas(tmp_path):
    g = np.random.default_rng(0)
    logits = (g.normal(size=(40, 5)) * 6).astype(np.float32)
    logits[0] = [0.0, 30.0, -18.42068, 2.1972246, np.nan]
    probs = 1 / (1 + np.exp(-logits))
    assert probs.dtype == np.float32
    labels = (g.random((40, 5)) < 0.3).astype(np.float32)
    t_train.dump_predictions(str(tmp_path / "t.csv"), probs, labels, CLASSES)
    _jax_dump(tmp_path / "j.csv", probs, labels, CLASSES)
    got = (tmp_path / "t.csv").read_text()
    assert got == (tmp_path / "j.csv").read_text()
    assert got.splitlines()[1].split(",")[:5] == ["0.5", "1.0", "1.0000017e-08", "0.9", ""]
    assert "0.12345679104328156" not in got


def test_train_cli_dumps_predictions_without_yaml_or_pandas(config_file, tmp_path,
                                                           monkeypatch):
    with open(config_file) as f:
        cfg = yaml.safe_load(f)
    cfg["training"].update(wire="u8", attention="pallas", num_train_epochs=1)
    cfg["dump_test_predictions"] = True
    path = tmp_path / "predict.yaml"
    path.write_text(yaml.safe_dump(cfg))
    for name in ("yaml", "pandas"):
        monkeypatch.setitem(sys.modules, name, None)
    out = tmp_path / "run"
    t_train.main(["--config", str(path), "--saving.output_dir", str(out), "--device", "cpu"])
    table = read_csv(str(out / "test_predictions.csv"))
    assert table.columns == [f"prob_{c}" for c in CLASSES] + [f"label_{c}" for c in CLASSES]
    assert len(table) == 16
    probs = np.array([table.values(f"prob_{c}") for c in CLASSES])
    assert np.all((probs > 0) & (probs < 1))
    assert {v for c in CLASSES for v in table.values(f"label_{c}")} <= {0.0, 1.0}
