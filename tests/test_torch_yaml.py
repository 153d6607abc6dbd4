"""The port's YAML text without the ``yaml`` package (``utils/yaml_text.py``
and ``utils/config.load_config``) against PyYAML.

- Every ``config/*.yaml`` through the stdlib reader equals ``yaml.safe_load``,
  and ``load_config`` with yaml hidden (in this process and in a fresh one
  with ``sys.modules["yaml"] = None``) equals ``load_config`` with it,
  ``_base_`` resolved.
- PyYAML's YAML 1.1 scalar rules, case by case (``1.0e-5`` a float,
  ``1e-5`` a string, ``no`` False, ``017`` 15, ...).
- The emitter equals ``yaml.safe_dump`` byte for byte on the entrypoint's
  config dict, on the strings PyYAML quotes and leaves plain, on long
  strings it folds, and on trees drawn by hypothesis; the reader reads
  every such output back to ``yaml.safe_load``'s value.
- What the reader does not take raises with the file and line.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodal_content_moderation_tpu_torch.utils import config as tconfig
from multimodal_content_moderation_tpu_torch.utils import yaml_text

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "config").glob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types (True is not 1, 1.0 is not 1), NaN equal
    to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_shipped_config_reads_as_pyyaml(path, monkeypatch):
    text = path.read_text()
    assert _same(yaml_text.loads(text, str(path)), yaml.safe_load(text))
    want = tconfig.load_config(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    got = tconfig.load_config(str(path))
    assert _same(got, want)
    assert "_base_" not in got


def test_load_config_in_a_process_without_yaml():
    code = (
        "import json, sys\n"
        "sys.modules['yaml'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from multimodal_content_moderation_tpu_torch.utils.config import load_config\n"
        f"print(json.dumps({{p: load_config(p) for p in {[str(p) for p in CONFIGS]!r}}}))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    for p in CONFIGS:
        assert got[str(p)] == json.loads(json.dumps(tconfig.load_config(str(p))))
    assert got[str(REPO / "config/clip_fusion.yaml")]["training"]["lr_encoder"] == 1e-5


# PyYAML's YAML 1.1 resolution of plain scalars
SCALARS = [
    ("1.0e-5", 1e-5), ("1e-5", "1e-5"), ("1.0e5", "1.0e5"), ("1.0e+5", 1.0e5),
    ("5.0e-4", 5e-4), ("no", False), ("off", False), ("on", True), ("yes", True),
    ("True", True), ("FALSE", False), ("tRue", "tRue"), ("y", "y"), ("~", None),
    ("null", None), ("Null", None), ("017", 15), ("08", "08"), ("1_000", 1000),
    (".5", 0.5), ("-.5", "-.5"), ("1.", 1.0), ("+1", 1), ("-0", 0), ("0x1F", 31),
    ("0b101", 5), ("0o17", "0o17"), ("1:20", 80), ("1:20.5", 80.5), (".inf", math.inf),
    ("-.inf", -math.inf), ("42", 42), ("-7", -7), ("0.02", 0.02), ("a b", "a b"),
    ("-x", "-x"), ("a:b", "a:b"), ("x#", "x#"), ("x,", "x,"), ("..", ".."),
    ("openai/clip-vit-base-patch32", "openai/clip-vit-base-patch32"),
]


@pytest.mark.parametrize("text,want", SCALARS, ids=[t for t, _ in SCALARS])
def test_scalar_resolution_matches_pyyaml(text, want):
    doc = f"k: {text}\n"
    got = yaml_text.loads(doc)["k"]
    assert _same(got, yaml.safe_load(doc)["k"])
    assert _same(got, want)


def test_nan_resolves_as_pyyaml():
    assert math.isnan(yaml_text.loads("k: .NaN\n")["k"])


HAND_WRITTEN = [
    "a: 1\nb:\n  c: x  # trailing\n  d: ''\n  e: \"\"\n# full line\nf: ~\n",
    "names:\n- a\n- b\nnext: 2\n",
    "names:\n    - a\n    - 'b c'\n    - \"d\\te\"\n",
    "flow: [racist, sexist, 'a, b', \"x\"]\nempty: []\nnone: {}\n",
    "training: {wire: u8, attention: pallas, lr: 1.0e-5, on: yes}\nmix: [a:b, 'c, d', ~, 1_0]\n",
    "m: { a: 1 , 'b c': \"d\", e: }  # comment\nk: [ x , y ]\n",
    "'quoted key': 1\n\"dq\": 2\nk: 'it''s'\n",
    "outer:\n  inner:\n    deep: 1.0e-5\n  back: yes\ntop: no\n",
    "seq:\n- a: 1\n  b: 2\n- - x\n  - y\n-\n- z\n",
    "k: a long plain value\n  continued on a line\nj: 'single\n  folded'\n",
    "",
    "# only a comment\n",
]


@pytest.mark.parametrize("text", HAND_WRITTEN)
def test_hand_written_yaml_reads_as_pyyaml(text):
    assert _same(yaml_text.loads(text), yaml.safe_load(text))


REFUSED = [
    ("a: &anchor 1\n", 1), ("a: *alias\n", 1), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1),
    ("a: >\n  x\n", 1), ("a: {b: {c: 1}}\n", 1), ("a: {b}\n", 1), ("a:\n\tb: 1\n", 2), ("a: 2001-01-01\n", 1),
    ("---\na: 1\n", 1), ("a: 1\n  b: 2\n", 2), ("a: [1, [2]]\n", 1), ("a: 'open\n", 1),
    ("just a scalar\n", 1), ("a: x: y\n", 1), ("a: [1,\n  2]\n", 1), ("a: <<\n", 1),
]


@pytest.mark.parametrize("text,line", REFUSED)
def test_outside_the_subset_raises_with_file_and_line(text, line):
    with pytest.raises(yaml_text.YAMLSubsetError, match=rf"^cfg\.yaml:{line}: "):
        yaml_text.loads(text, "cfg.yaml")


def entrypoint_config(root="/opt/ml"):
    """The dict ``serving/entrypoint.train`` builds, at its defaults."""
    return {
        "model": {"backend": "clip", "head": "fusion",
                  "encoder_name": "openai/clip-vit-base-patch32", "encoder_dir": None,
                  "fusion_dim": 512, "max_text_length": 77, "head_hidden_dim": 0,
                  "learnable_task_weights": False},
        "data": {"train_csv": f"{root}/input/data/train/data.csv",
                 "val_csv": f"{root}/input/data/validation/data.csv", "test_csv": None,
                 "image_root": f"{root}/input/data/train",
                 "class_names": ["racist", "sexist", "homophobe", "religion", "otherhate"]},
        "training": {"per_device_train_batch_size": 32, "per_device_eval_batch_size": 64,
                     "num_train_epochs": 8, "max_steps": -1, "lr_encoder": 1e-5,
                     "lr_head": 5e-4, "weight_decay": 0.02, "warmup_ratio": 0.05,
                     "sampler": "random"},
        "loss": {"type": "bce", "focal_gamma": 1.5},
        "augmentation": {"enabled": False},
        "early_stopping": {"enabled": True, "patience": 3},
        "saving": {"output_dir": f"{root}/model"},
        "seed": 42,
    }


QUOTING = ["no", "on", "17", "null", "~", "1.0e-5", "", "a: b", "a #b", "[x", "*x", "&x",
           "1e-5", "-x", "a b", "- x", "? x", ":x", "x:", "a:b", "#x", "x#", "0x1F", ".5",
           "+1", "Yes", "1_000", "%x", "@x", "`x", "!x", "|x", ">x", "'x", '"x', ",x", "x,",
           "{x", " x", "x ", "---x", "...", "it's", "2001-01-01", "=", "<<", "08", "1e5"]


@pytest.mark.parametrize("value", QUOTING)
def test_emitter_quotes_as_pyyaml(value):
    d = {"k": value, "l": [value], value or "e": 1}
    text = yaml_text.dumps(d)
    assert text == yaml.safe_dump(d)
    assert _same(yaml_text.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("value", [
    "word " * 20 + "x", "it's " * 25 + "z", "  two  spaces  " + "x " * 40,
    "/very/long/path/" * 8, "a" * 90 + " b",
])
def test_emitter_folds_as_pyyaml(value):
    d = {"a": {"b": value, "c": [value]}, "d": [value, {"e": value}]}
    text = yaml_text.dumps(d)
    assert text == yaml.safe_dump(d)
    assert _same(yaml_text.loads(text), yaml.safe_load(text))


def test_emitter_on_the_entrypoint_config():
    for root in ("/opt/ml", "/tmp/pytest-of-user/pytest-3/test_entrypoint0/a b"):
        d = entrypoint_config(root)
        text = yaml_text.dumps(d)
        assert text == yaml.safe_dump(d)
        assert "lr_encoder: 1.0e-05\n" in text
        assert _same(yaml_text.loads(text), yaml.safe_load(text))
        assert yaml_text.loads(text) == d


def test_emitter_refuses_what_pyyaml_writes_otherwise():
    for bad in ({"k": "é"}, {"k": "a\nb"}, {"k": "a\tb"}, {"": 1}, {"k": (1, 2)}, {"k": b"x"}):
        with pytest.raises(yaml_text.YAMLSubsetError):
            yaml_text.dumps(bad)


_WORDS = st.text(alphabet=st.sampled_from(list("ab x:#-'\"[]{},&*!|>%@`?~.019eE+_")),
                 max_size=12)
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-10**6, 10**6), st.floats(width=64), _WORDS,
    st.lists(st.sampled_from(["word", "it's", "a", "bb", "  ", "x:", "#"]), max_size=40)
    .map(" ".join),
    st.sampled_from(QUOTING),
)
_KEYS = st.text(alphabet=st.sampled_from(list("abc_xyz19 -:.")), min_size=1, max_size=8)
_TREES = st.recursive(
    _SCALARS, lambda ch: st.one_of(st.lists(ch, max_size=4), st.dictionaries(_KEYS, ch, max_size=4)),
    max_leaves=20,
)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.one_of(st.dictionaries(_KEYS, _TREES, max_size=5), st.lists(_TREES, max_size=4)))
def test_emitter_and_reader_match_pyyaml_on_drawn_trees(tree):
    text = yaml.safe_dump(tree)
    assert yaml_text.dumps(tree) == text
    assert _same(yaml_text.loads(text), yaml.safe_load(text))
