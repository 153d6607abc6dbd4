"""The card's situation on the CPU: a fresh process with PIL, pandas,
``regex`` and yaml hidden (``sys.modules[name] = None``, so importing them
raises) runs the endpoint (``model_fn`` -> ``input_fn`` -> ``predict_fn``
-> ``output_fn``, ``MMHARM_IMAGE_BACKEND=native``) and ``evaluate.main``
(``--image_backend native --engine fast``) on the committed JPEG fixtures
and a CSV with NA texts. Its answers equal the JAX package's (PIL decode,
``regex`` tokenizer, pandas CSV) on the same checkpoint: probabilities
within fp32 atol 1e-5, metrics as tests/test_torch_cli.py holds them."""

import base64
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multimodal_content_moderation_tpu.cli import evaluate as j_eval
from multimodal_content_moderation_tpu.serving import handler as jh
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

from test_torch_inference import CLASSES, clip_checkpoint  # noqa: F401  (fixture)
from test_torch_serving import instances

REPO = Path(__file__).resolve().parent.parent


def _image(inst) -> bytes:
    b64 = inst.get("image") or inst.get("image_base64") or ""
    try:
        return base64.b64decode(b64)
    except ValueError:
        return b""

HIDDEN = ["PIL", "pandas", "regex", "yaml"]

SCRIPT = """
import json, os, sys
sys.modules.update(dict.fromkeys({hidden!r}))
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from multimodal_content_moderation_tpu_torch.cli import evaluate
from multimodal_content_moderation_tpu_torch.data import tokenizer
from multimodal_content_moderation_tpu_torch.serving import handler as h
assert tokenizer._re is None
os.environ.update(MMHARM_IMAGE_BACKEND="native", MMHARM_ENGINE="fast", MMHARM_SEQ_BUCKETS="6,8")
clf = h.model_fn({ckpt!r}, device="cpu")
body = open({body!r}).read()
preds = json.loads(h.output_fn(h.predict_fn(h.input_fn(body), clf)))["predictions"]
metrics = evaluate.main(["--checkpoint", {ckpt!r}, "--test_csv", {csv!r}, "--image_root",
                         {images!r}, "--batch_size", "8", "--engine", "fast",
                         "--image_backend", "native", "--seq_buckets", "6,8",
                         "--image_cache", {cache!r}, "--device", "cpu",
                         "--output", {out!r}])
loaded = sorted(m for m in {hidden!r} if sys.modules.get(m) is not None)
print("RESULT " + json.dumps({{"preds": preds, "f1_macro": metrics["f1_macro"],
                              "loaded": loaded}}))
"""


def test_endpoint_and_evaluate_without_pil_pandas_regex_yaml(clip_checkpoint, tmp_path):  # noqa: F811
    images = tmp_path / "images"
    images.mkdir()
    names = []
    for p in jpeg_fixtures().values():
        shutil.copy(p, images / p.name)
        names.append(p.name)
    texts = ["hate hate hate", "NA", "love the thing", "", "null", "a thing", "hate love",
             "the", "love love", "thing"]
    lines = ["text,image_path,labels"] + [
        f"{t},{names[i % len(names)] if i != 5 else 'missing.jpg'},"
        f"\"{CLASSES[i % 5]},{CLASSES[(i + 2) % 5]}\"" for i, t in enumerate(texts)]
    csv = tmp_path / "test.csv"
    csv.write_text("\n".join(lines) + "\n")
    # the PNG of ``instances`` needs PIL (without it, it is an absent image)
    insts = [i for i in instances(20)
             if not _image(i).startswith(b"\x89PNG")]
    body = tmp_path / "body.json"
    body.write_text(json.dumps({"instances": insts}))
    out = tmp_path / "torch_eval.json"
    code = SCRIPT.format(hidden=HIDDEN, repo=str(REPO), ckpt=clip_checkpoint, body=str(body),
                         csv=str(csv), images=str(images), cache=str(tmp_path / "cache"),
                         out=str(out))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.split("RESULT ", 1)[1])
    assert result["loaded"] == []

    mp = pytest.MonkeyPatch()
    mp.setenv("MMHARM_ENGINE", "fast")
    mp.setenv("MMHARM_SEQ_BUCKETS", "6,8")
    try:
        want = jh.predict_fn(insts, jh.model_fn(clip_checkpoint))
    finally:
        mp.undo()
    got = result["preds"]
    assert len(got) == len(want) == len(insts)
    np.testing.assert_allclose(
        [[p["probabilities"][c] for c in CLASSES] for p in got],
        [[p["probabilities"][c] for c in CLASSES] for p in want], atol=1e-5, rtol=0)
    assert [p["any_harmful"] for p in got] == [p["any_harmful"] for p in want]

    jm = j_eval.main(["--checkpoint", clip_checkpoint, "--test_csv", str(csv), "--image_root",
                      str(images), "--batch_size", "8", "--engine", "fast", "--seq_buckets",
                      "6,8", "--output", str(tmp_path / "jax_eval.json")])
    with open(out) as f:
        tm = json.load(f)
    assert tm["f1_macro"] == result["f1_macro"]
    assert tm["f1_macro"] == pytest.approx(jm["f1_macro"], abs=1e-6)
    assert tm["roc_auc_macro"] == pytest.approx(jm["roc_auc_macro"], abs=1e-4)
    for name in CLASSES:
        assert tm["per_class"][name]["support"] == jm["per_class"][name]["support"]
