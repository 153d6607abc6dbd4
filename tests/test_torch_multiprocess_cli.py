"""The port's CLIs over a mesh of gloo processes on the CPU, the dry run,
and reference fault 13 in the JAX package's own Trainer (the spawning
harness and the tiny models are ``tests/test_torch_multiprocess.py``'s).

- The train CLI under two processes: ``--parallel.data 2`` writes its
  artifacts once and its checkpoint follows one process's under the Adam
  rule; ``--parallel.model 2`` writes a full checkpoint that loads in one
  process and gives that run's logits; a resume of the TP run takes the
  same next step as an unbroken run; the evaluate CLI over two processes
  (both engines, 16 rows at batch 6: a padded last batch) scores as one.
- ``parallel/dryrun.py`` prints its line.
- Two processes of the JAX Trainer on one 8-device mesh feed every row
  twice and cannot evaluate (reference fault 13), which the port avoids.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_multiprocess import REPO, TIMEOUT, _ok, _spawn


# ---------------------------------------------------------------- the train CLI


def _cli_yaml(directory, **extra):
    """``config/clip_fusion.yaml`` as shipped (bf16 towers, the f32 wire,
    accumulation 2) with a constant learning rate (a resume then continues
    the schedule of an unbroken run), event files, test predictions and no
    augmentation: its random crops come from one stream per process drawn
    in load order, which no split of the rows can reproduce."""
    import yaml

    cfg = {"_base_": str(REPO / "config" / "clip_fusion.yaml"),
           "augmentation": {"enabled": False},
           "training": {"lr_scheduler_type": "constant", **extra},
           "logging": {"report_to": "tensorboard"}, "dump_test_predictions": True}
    path = directory / f"train_{len(list(directory.glob('train_*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cli_argv(cfg, encoder_dir, data_dir, out, epochs, *flags):
    return ["--config", cfg, "--model.encoder_dir", encoder_dir,
            "--data.train_csv", f"{data_dir}/train.csv", "--data.val_csv", f"{data_dir}/val.csv",
            "--data.test_csv", f"{data_dir}/test.csv", "--data.image_root", f"{data_dir}/images",
            "--training.num_train_epochs", str(epochs), "--saving.output_dir", str(out),
            "--device", "cpu", *flags]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, encoder_dir, data_dir):
    """Two processes run the train CLI four times: ``--parallel.data 2`` (2
    epochs), ``--parallel.model 2`` (2 epochs, then resumed to 3) and the
    unbroken 3-epoch TP run (fp32 towers); then the evaluate CLI on that
    run with both engines, its rows split over the two."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _cli_yaml(tmp)
    # the TP runs in fp32: their logits are held to one process at 1e-6
    tp = _cli_yaml(tmp, precision="fp32")
    resume = _cli_yaml(tmp, precision="fp32", resume_from_checkpoint="auto")
    runs = [
        {"what": "cli", "env": {}, "argv": _cli_argv(cfg, encoder_dir, data_dir, tmp / "dp", 2,
                                                     "--parallel.data", "2")},
        {"what": "cli", "env": {}, "argv": _cli_argv(tp, encoder_dir, data_dir, tmp / "tp", 2,
                                                     "--parallel.model", "2")},
        {"what": "cli", "env": {}, "argv": _cli_argv(resume, encoder_dir, data_dir, tmp / "tp",
                                                     3, "--parallel.model", "2")},
        {"what": "cli", "env": {}, "argv": _cli_argv(tp, encoder_dir, data_dir,
                                                     tmp / "tp_full", 3, "--parallel.model", "2")},
    ]
    for engine in ("fast", "standard"):
        runs.append({"what": "eval_cli", "argv": _eval_argv(tmp / "tp_full", data_dir, engine,
                                                            tmp / f"eval_{engine}.json")})
    results, _ = _spawn(tmp, runs, name="cli")
    _ok(results)
    return tmp, cfg


def _eval_argv(run, data_dir, engine, output):
    return ["--checkpoint", str(run), "--test_csv", f"{data_dir}/test.csv",
            "--image_root", f"{data_dir}/images", "--batch_size", "6", "--engine", engine,
            "--seq_buckets", "auto", "--attention", "pallas", "--device", "cpu",
            "--output", str(output)]


def _params(run_dir, step):
    return torch.load(os.path.join(run_dir, f"checkpoint-{step}", "params.pt"),
                      map_location="cpu", weights_only=True)


def test_train_cli_data_parallel_writes_once_and_matches_one_process(
        cli_runs, encoder_dir, data_dir):
    from multimodal_content_moderation_tpu_torch.cli import train as t_train

    tmp, cfg = cli_runs
    dp = tmp / "dp"
    for artifact in ["config.json", "val_report.json", "test_metrics.json",
                     "inference_config.json", "label_map.json", "test_predictions.csv"]:
        assert (dp / artifact).exists(), artifact
    assert len(list((dp / "logs").iterdir())) == 1  # one event file: rank 0's
    torch.set_num_threads(1)
    t_train.main(_cli_argv(cfg, encoder_dir, data_dir, tmp / "one", 2))
    got, want = _params(dp, 2), _params(tmp / "one", 2)
    assert set(got) == set(want)
    # one optimizer update (two micro-steps of the whole 32-row set): Adam's
    # first step moves each element by at most lr (1 + weight decay), and is
    # ill-conditioned where the gradient is rounding noise (of the bf16
    # towers here): there the two runs may step in opposite directions
    n_loose = 0
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w.numpy())
        lr = 1e-5 if name.startswith("backbone.") else 5e-4
        assert np.all(diff <= 2.1 * lr), name
        n_loose += int(np.sum(diff > 5e-5))
    assert n_loose <= 1e-3 * sum(w.numel() for w in want.values())
    with open(dp / "val_report.json") as f, open(tmp / "one" / "val_report.json") as g:
        a, b = json.load(f), json.load(g)
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-3)


def test_train_cli_tensor_parallel_checkpoint_loads_in_one_process(cli_runs, encoder_dir):
    import csv

    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
    from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.loop import evaluate_logits_standard

    tmp, _ = cli_runs
    run = tmp / "tp_full"
    params = _params(run, 3)
    assert tuple(params["backbone.text_model.layers.0.attn.q.w"].shape) == (32, 32)  # whole
    model, config = model_io.load_checkpoint(str(run), device="cpu")
    (H, W), mean, std = image_stats_from_dir(encoder_dir, "clip")
    with open(run / "config.json") as f:
        data = json.load(f)["data"]
    ds = CSVDataset(data["test_csv"], data["image_root"], load_tokenizer(encoder_dir),
                    ImagePreprocessor(H, W, mean, std, output="float_nchw"),
                    min(config["max_text_length"], model.text_max_positions),
                    class_names=config["class_names"])
    logits, _ = evaluate_logits_standard(model, ds, 8, num_workers=1)
    with open(run / "test_predictions.csv") as f:
        rows = list(csv.DictReader(f))
    probs = np.asarray([[float(r[f"prob_{c}"]) for c in config["class_names"]] for r in rows])
    np.testing.assert_allclose(1 / (1 + np.exp(-logits)), probs, atol=1e-6)


def test_train_cli_tensor_parallel_resume_takes_the_unbroken_step(cli_runs):
    tmp, _ = cli_runs
    got, want = _params(tmp / "tp", 3), _params(tmp / "tp_full", 3)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("engine", ["fast", "standard"])
def test_evaluate_cli_over_two_processes_matches_one(cli_runs, data_dir, engine):
    from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

    tmp, _ = cli_runs
    torch.set_num_threads(1)
    one = t_eval.main(_eval_argv(tmp / "tp_full", data_dir, engine, tmp / f"one_{engine}.json"))
    with open(tmp / f"eval_{engine}.json") as f:
        two = json.load(f)  # rank 0's; rank 1 wrote nothing over it
    for key in ("f1_macro", "f1_micro", "roc_auc_macro"):
        assert two[key] == pytest.approx(one[key], abs=1e-6), key
    for name, row in one["per_class"].items():
        assert two["per_class"][name]["support"] == row["support"]
        assert two["per_class"][name]["roc_auc"] == pytest.approx(row["roc_auc"], abs=1e-6)


def test_dryrun_prints_its_line():
    out = subprocess.run(
        [sys.executable, "-m", "multimodal_content_moderation_tpu_torch.parallel.dryrun",
         "--n", "4", "--timeout", "100"],
        capture_output=True, text=True, cwd=str(REPO), timeout=TIMEOUT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["dryrun"] == "ok" and line["mesh"] == [2, 2] and line["logits"] == [17, 5]


# ---------------------------------------------------------------- reference fault 13

JAX_TRAINER = r'''
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from multimodal_content_moderation_tpu.models import CLIPConfig, FusionModel
from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig, CLIPVisionConfig
from multimodal_content_moderation_tpu.parallel.mesh import build_mesh, init_distributed
from multimodal_content_moderation_tpu.training import loop

init_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
tower = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
cfg = CLIPConfig(text=CLIPTextConfig(vocab_size=64, max_positions=12, eos_token_id=63, **tower),
                 vision=CLIPVisionConfig(image_size=32, patch_size=16, **tower),
                 projection_dim=32)
model = FusionModel.create("clip", num_labels=3, fusion_dim=16, clip_config=cfg)


class Rows:
    def __init__(self, n, seed):
        g = np.random.default_rng(seed)
        ids = g.integers(1, 62, (n, 12)).astype(np.int32)
        ids[:, 7] = 63
        self.d = {"input_ids": ids, "attention_mask": np.ones((n, 12), np.int32),
                  "pixel_values": g.normal(size=(n, 3, 32, 32)).astype(np.float32),
                  "text_present": np.ones(n, np.float32), "image_present": np.ones(n, np.float32),
                  "labels": (g.random((n, 3)) < .5).astype(np.float32)}
        self.labels = self.d["labels"]

    def __len__(self):
        return len(self.labels)

    def batches(self, B, drop_last=False, pad_to_batch=False, num_workers=0, indices=None):
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        for s in range(0, len(order) - (B - 1 if drop_last else 0), B):
            idx = order[s:s + B]
            out = {k: v[idx] for k, v in self.d.items()}
            if pad_to_batch:
                out = {k: np.concatenate([v, np.zeros((B - len(idx),) + v.shape[1:], v.dtype)])
                       for k, v in out.items()}
                out["_valid"] = np.int32(len(idx))
            yield out


rows = []
make = loop.make_train_step


def spy(model, tx, pos_weight=None):
    step = make(model, tx, pos_weight)

    def run(p, o, r, batch):
        rows.append(batch["input_ids"].shape[0])
        return step(p, o, r, batch)
    return run


loop.make_train_step = spy
args = loop.TrainArgs(output_dir=sys.argv[3] + f"/run{pid}", num_train_epochs=1, max_steps=1,
                      per_device_train_batch_size=8, per_device_eval_batch_size=8,
                      save_total_limit=1, early_stopping=False, num_workers=1,
                      load_best_model_at_end=False)
trainer = loop.Trainer(model, model.init(jax.random.key(0)), args, Rows(16, 0), Rows(8, 1),
                       lambda p: {"roc_macro": 0.0}, mesh=build_mesh())
try:
    trainer.train()
    print("TRAINED", flush=True)
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).split(".")[0], flush=True)
print("GLOBAL_ROWS", rows, flush=True)
'''


def test_jax_multihost_trainer_duplicates_rows_and_cannot_evaluate(tmp_path):
    """Reference fault 13, as the JAX package stands: two processes of its
    Trainer on one 8-device mesh. Each passes its whole host batch (the same
    rows: same seed, same order) as its local slice, so a global batch of
    16 rows holds the 8 rows of ``per_device_train_batch_size`` twice; then
    the epoch's eval fetches a global array no process holds and raises.
    The port slices the rows by data rank (``test_dp_2x1_matches_one_process``,
    the train CLI under ``--parallel.data 2``) and gathers the eval logits."""
    script = tmp_path / "jax_trainer.py"
    script.write_text(JAX_TRAINER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        assert "GLOBAL_ROWS [16]" in out, out[-3000:]
        assert "RAISED RuntimeError Fetching value for `jax" in out, out[-3000:]
