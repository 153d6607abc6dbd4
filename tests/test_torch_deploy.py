"""The port's deployment utilities (``serving/deploy.py``) against the JAX
package's, with injected fake boto3 clients (the cases of
tests/test_deploy.py), and a packaged run directory served by the port's
handler.

- The three request-spec builders give JAX's dicts and refuse what JAX
  refuses; ``SageMakerEndpoint`` and ``SageMakerBatchTransform`` make JAX's
  client calls with JAX's arguments; ``upload_data_to_s3`` uploads JAX's
  keys; the CLI's ``package`` and ``prepare-data`` write the same channel
  files and archive members (each once: JAX's archive holds every file
  below the top level twice) and print the same lines.
- A run directory of the port's train CLI, packaged with ``deploy package``
  and unpacked with ``extract_model_package``, serves through
  ``handler.model_fn(device="cpu")`` with logits equal bit for bit to
  those of the unpacked run directory itself.
"""

import base64
import io
import json
import os
import tarfile

import numpy as np
import pytest

from multimodal_content_moderation_tpu.serving import deploy as jd
from multimodal_content_moderation_tpu_torch.serving import deploy as td
from multimodal_content_moderation_tpu_torch.serving import handler as th
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

MODULES = [pytest.param(jd, id="jax"), pytest.param(td, id="torch")]


class FakeSMClient:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def record(**kwargs):
            self.calls.append((name, kwargs))
            return {}

        return record


class FakeRuntime:
    def __init__(self, response):
        self.response = response
        self.calls = []

    def invoke_endpoint(self, **kwargs):
        self.calls.append(kwargs)
        return {"Body": io.BytesIO(json.dumps(self.response).encode())}


SPEC_CASES = [
    ("build_model_spec", ("m", "img:latest", "s3://b/model.tar.gz", "arn:role"),
     {"env": {"A": "1"}}),
    ("build_model_spec", ("m", "img", "s3://b/m.tar.gz", "arn:role"), {}),
    ("build_endpoint_config_spec", ("cfg", "m", "ml.g4dn.xlarge", 2), {}),
    ("build_endpoint_config_spec", ("cfg", "m"), {}),
    ("build_transform_job_spec", ("job", "m", "s3://b/in", "s3://b/out"), {"instance_count": 3}),
    ("build_transform_job_spec", ("job", "m", "s3://b/in", "s3://b/out"),
     {"split_type": "None", "content_type": "application/json"}),
]


@pytest.mark.parametrize("name,args,kw", SPEC_CASES)
def test_spec_builders_equal_jax(name, args, kw):
    assert getattr(td, name)(*args, **kw) == getattr(jd, name)(*args, **kw)


@pytest.mark.parametrize("name,args,kw", [
    ("build_model_spec", ("m", "img", "/local/path", "arn:role"), {}),
    ("build_endpoint_config_spec", ("cfg", "m"), {"instance_count": 0}),
    ("build_transform_job_spec", ("job", "m", "not-s3", "s3://b/out"), {}),
    ("build_transform_job_spec", ("job", "m", "s3://b/in", "/out"), {}),
])
def test_spec_builders_refuse_as_jax(name, args, kw):
    for module in (jd, td):
        with pytest.raises(ValueError):
            getattr(module, name)(*args, **kw)


def _endpoint_calls(module):
    client = FakeSMClient()
    runtime = FakeRuntime({"predictions": {"racist": {"label": False}}})
    ep = module.SageMakerEndpoint("ep", client=client, runtime=runtime)
    ep.deploy("s3://b/model.tar.gz", "arn:role", "img:latest", env={"MMHARM_ENGINE": "fast"},
              wait=False)
    out = ep.predict({"text": "hi"})
    ep.delete()
    return client.calls, runtime.calls, out


def test_endpoint_deploy_predict_delete_equals_jax():
    got, want = _endpoint_calls(td), _endpoint_calls(jd)
    assert got == want
    calls, runtime_calls, out = got
    assert [c[0] for c in calls] == ["create_model", "create_endpoint_config", "create_endpoint",
                                     "delete_endpoint", "delete_endpoint_config", "delete_model"]
    assert calls[0][1]["ModelName"] == "ep-model"
    assert json.loads(runtime_calls[0]["Body"]) == {"text": "hi"}
    assert out["predictions"]["racist"]["label"] is False


def _transform_calls(module, **kw):
    client = FakeSMClient()
    bt = module.SageMakerBatchTransform("s3://b/model.tar.gz", "arn:role", image_uri="img",
                                        instance_count=2, client=client)
    out = bt.run("s3://b/in.jsonl", "s3://b/out/", wait=False, **kw)
    return client.calls, out


def test_batch_transform_run_equals_jax():
    got, want = _transform_calls(td, job_name="j1"), _transform_calls(jd, job_name="j1")
    assert got == want
    calls, out = got
    assert out == "s3://b/out/"
    assert [c[0] for c in calls] == ["create_model", "create_transform_job"]
    assert calls[1][1]["TransformJobName"] == "j1"
    # the default job name is drawn: the same form in both packages
    (calls, _), (jcalls, _) = _transform_calls(td), _transform_calls(jd)
    name, jname = calls[1][1]["TransformJobName"], jcalls[1][1]["TransformJobName"]
    assert name.startswith("mmharm-batch-transform-") and len(name) == len(jname)


class FakeS3:
    def __init__(self):
        self.uploads = []

    def upload_file(self, local, bucket, key):
        self.uploads.append((local, bucket, key))


@pytest.mark.parametrize("patterns", [["*.csv"], None, ["*.txt", "b.*"]])
def test_upload_data_to_s3_equals_jax(tmp_path, patterns):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.csv").write_text("x")
    (tmp_path / "sub" / "b.csv").write_text("y")
    (tmp_path / "skip.txt").write_text("z")
    results = []
    for module in (jd, td):
        s3 = FakeS3()
        uri = module.upload_data_to_s3(str(tmp_path), "bkt", "pre/fix/",
                                       include_patterns=patterns, s3_client=s3)
        results.append((uri, sorted(s3.uploads)))
    assert results[0] == results[1]
    assert results[1][0] == "s3://bkt/pre/fix"


def _members(path):
    with tarfile.open(path, "r:gz") as tar:
        return sorted((m.name, m.isdir(), tar.extractfile(m).read() if m.isfile() else None)
                      for m in tar.getmembers())


@pytest.mark.parametrize("module", MODULES)
def test_cli_package_and_prepare_data_equal_jax(module, tmp_path, capsys):
    model_dir = tmp_path / "run"
    (model_dir / "checkpoint-4").mkdir(parents=True)
    (model_dir / "inference_config.json").write_text("{}")
    (model_dir / "checkpoint-4" / "params.pt").write_bytes(b"\0\1")
    out = {}
    for m, name in ((jd, "jax"), (td, "torch")):
        tar = tmp_path / f"{name}.tar.gz"
        m.main(["package", "--model-dir", str(model_dir), "--output", str(tar)])
        out[name] = capsys.readouterr().out.replace(str(tar), "TAR")
        assert out[name] == "Created model package: TAR\n"
    got, want = _members(tmp_path / "torch.tar.gz"), _members(tmp_path / "jax.tar.gz")
    # the same members, each once: JAX's tar.add recurses into each directory
    # and rglob then adds its files again (a reference fault)
    assert sorted(set(want)) == got
    assert want.count(("checkpoint-4/params.pt", False, b"\0\1")) == 2

    train, val = tmp_path / "train.csv", tmp_path / "val.csv"
    train.write_text("text,image_path,labels\nhi,,racist\n")
    val.write_text("text,image_path,labels\nho,,sexist\n")
    (tmp_path / "imgs").mkdir()
    (tmp_path / "imgs" / "a.jpg").write_bytes(b"jpeg")
    for m, name in ((jd, "jax"), (td, "torch")):
        m.main(["prepare-data", "--train-csv", str(train), "--val-csv", str(val),
                "--test-csv", str(val), "--image-root", str(tmp_path / "imgs"),
                "--output-dir", str(tmp_path / f"ch_{name}")])
        out[name] = capsys.readouterr().out.replace(str(tmp_path / f"ch_{name}"), "CH")
    assert out["torch"] == out["jax"]
    for ch in ("train", "validation", "test"):
        assert (tmp_path / "ch_torch" / ch / "data.csv").read_bytes() == \
            (tmp_path / "ch_jax" / ch / "data.csv").read_bytes()
    assert (tmp_path / "ch_torch" / "images" / "a.jpg").read_bytes() == b"jpeg"
    module.main([])
    assert "Deployment utilities" in capsys.readouterr().out


def test_extract_refuses_a_path_outside_the_target(tmp_path):
    evil = tmp_path / "evil.tar.gz"
    with tarfile.open(evil, "w:gz") as tar:
        data = b"x"
        info = tarfile.TarInfo("../escape.txt")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    with pytest.raises(tarfile.OutsideDestinationError):
        td.extract_model_package(str(evil), str(tmp_path / "target"))
    assert not (tmp_path / "escape.txt").exists()


@pytest.fixture(scope="module")
def port_run(config_file, tmp_path_factory):
    """A run directory of the port's train CLI (tiny CLIP, u8 wire, the
    kernels' plain versions)."""
    import yaml

    from multimodal_content_moderation_tpu_torch.cli import train as t_train

    d = tmp_path_factory.mktemp("deploy_run")
    with open(config_file) as f:
        cfg = yaml.safe_load(f)
    cfg["training"].update(wire="u8", attention="pallas", num_train_epochs=1)
    (d / "train.yaml").write_text(yaml.safe_dump(cfg))
    out = d / "run"
    t_train.main(["--config", str(d / "train.yaml"), "--saving.output_dir", str(out),
                  "--device", "cpu"])
    return out


def _served_logits(classifier, insts):
    got = []
    real = classifier.forward_batch

    def recording(batch, valid):
        out = real(batch, valid)
        got.append(out)
        return out

    classifier.forward_batch = recording
    preds = th.predict_fn(insts, classifier)
    return np.concatenate(got), preds


def test_packaged_run_serves_bit_equal(port_run, tmp_path, monkeypatch, capsys):
    for k, v in {"MMHARM_ENGINE": "fast", "MMHARM_ATTENTION": "pallas",
                 "MMHARM_PRECISION": "fp32"}.items():
        monkeypatch.setenv(k, v)
    tar = tmp_path / "model.tar.gz"
    td.main(["package", "--model-dir", str(port_run), "--output", str(tar)])
    target = td.extract_model_package(str(tar), str(tmp_path / "extracted"))
    members = [m[0] for m in _members(tar)]
    assert len(members) == len(set(members))
    assert "inference_config.json" in members and any(n.startswith("checkpoint-") for n in members)
    blobs = [base64.b64encode(p.read_bytes()).decode() for p in jpeg_fixtures().values()]
    insts = [{"text": ["hate hate hate", "love love love", ""][i % 3],
              "image": blobs[i % len(blobs)]} for i in range(7)]
    insts[3].pop("image")
    served = th.model_fn(target, device="cpu")
    unpacked = th.model_fn(str(port_run), device="cpu")
    got, got_preds = _served_logits(served, insts)
    want, want_preds = _served_logits(unpacked, insts)
    assert got.shape == (7, 5) and np.isfinite(got).all()
    assert np.array_equal(got, want)
    assert got_preds == want_preds
    assert os.path.isdir(os.path.join(target, os.path.basename(
        json.loads((port_run / "inference_config.json").read_text())["best_checkpoint_dir"])))
