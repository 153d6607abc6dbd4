"""The port's multi-process paths on the CPU: gloo process groups of two and
four ranks against one process of the port and against the JAX package's
mesh runs (its 8 virtual CPU devices, from ``tests/conftest.py``).

Tiny models (two-layer towers of width 32 with 2 heads, as in
``tests/test_multiprocess_distributed.py``) and seeded numpy batches; every
spawned group has a free port, one thread per rank and a ``communicate``
timeout of at most 120 s, and one group runs several checks.

- DP 2x1, TP 1x2 and TP 2x2 (CLIP fusion; TP 1x2 also the generic BERT +
  ViT model, whose dropout reaches the attention weights of the split
  heads, and CLIP with ``attention: pallas``, the kernels' dispatch at one
  head a rank): 3 optimizer steps with accumulation 2 on the same global
  batches, dropout on. The losses equal one process to rtol 1e-6; the
  gradients the optimizer averages equal one process leafwise to atol 1e-6,
  rtol 1e-5; the parameters after the steps follow the first-step Adam rule
  of ``test_torch_pixel_path.assert_adam_step_matches`` (atol 5e-5 where
  well conditioned, ``lr`` per step elsewhere). Each TP rank's q.w is
  [32, 16].
- Against JAX (dropout off: the two packages draw other masks): DP 2x1 of
  the port equals the JAX package's 8x1 mesh on the same weights and
  batches, losses atol 1e-6, rtol 1e-5.
- The bf16 row-parallel dense rounds once: the fp32 partial products are
  summed over the model group and the bias added before the one rounding,
  bit for bit.
- Clipping under TP: the global norm at a norm above ``max_grad_norm``
  equals one process's to rtol 1e-6.
- Fast eval over 2 data ranks (buckets (6, 8), 20 rows at batch 8, a padded
  last batch, a missing image): both ranks' logits equal one process to
  atol 1e-5, and again with the ranks placed on the grid in the other order
  (the rows follow the data index, never the rank).
- A rank that raises ends the other one non-zero within the group's
  timeout; a group that cannot form raises.
The train and evaluate CLIs under two processes, the dry run and reference
fault 13 are in ``tests/test_torch_multiprocess_cli.py``.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120

COMMON = r'''
import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models import clip as tclip
from multimodal_content_moderation_tpu_torch.models import generic as tgen
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
from multimodal_content_moderation_tpu_torch.parallel.sharding import (
    gather_named,
    gather_params,
    shard_params,
)
from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
from multimodal_content_moderation_tpu_torch.training.optim import AdamW

B, T = 8, 12
KW = dict(lr_encoder=1e-3, lr_head=1e-2, weight_decay=0.02, max_grad_norm=1.0,
          total_steps=3, warmup_ratio=0.0, schedule="cosine")


def tiny_model(kind="clip", seed=0):
    if kind == "generic":
        cfg = tgen.GenericDualConfig(
            text=tgen.GenericTextConfig(vocab_size=64, hidden_size=32, num_layers=2,
                                        num_heads=2, intermediate_size=64, max_positions=32),
            vision=tgen.GenericVisionConfig(hidden_size=32, num_layers=2, num_heads=2,
                                            intermediate_size=64, image_size=32,
                                            patch_size=16),
            projection_dim=24)
        return FusionModel.create("generic", num_labels=3, fusion_dim=16, encoder_config=cfg,
                                  seed=seed, device="cpu")
    # "clip_pallas": the kernels' dispatch (their plain versions on the CPU)
    core = {"attention_impl": "pallas"} if kind == "clip_pallas" else {}
    cfg = tclip.CLIPConfig(
        text=tclip.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                                  intermediate_size=64, max_positions=T, eos_token_id=63,
                                  **core),
        vision=tclip.CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=2,
                                      intermediate_size=64, image_size=32, patch_size=16,
                                      **core),
        projection_dim=32)
    return FusionModel.create("clip", num_labels=3, fusion_dim=16, encoder_config=cfg,
                              seed=seed, device="cpu")


def global_batch(step):
    g = np.random.default_rng(1000 + step)
    ids = g.integers(1, 62, size=(B, T)).astype(np.int32)
    ids[:, 7] = 63
    b = {
        "input_ids": ids,
        "attention_mask": np.ones((B, T), np.int32),
        "pixel_values": g.normal(size=(B, 3, 32, 32)).astype(np.float32),
        "text_present": np.ones((B,), np.float32),
        "image_present": np.ones((B,), np.float32),
        "labels": (g.random((B, 3)) < 0.5).astype(np.float32),
    }
    return {k: torch.from_numpy(v) for k, v in b.items()}


def run_steps(kind, mesh=None, steps=3, accum=2, dropout=True, weights=None, **kw):
    """(losses, the averaged gradients of each update, the parameters after
    the last one, this rank's q.w shape): ``steps`` optimizer updates of
    ``accum`` micro-steps each, on this rank's rows of the global batches."""
    model = tiny_model(kind)
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    if mesh is not None:
        mesh.activate()
        mesh.replicate(model)
        shard_params(model, mesh)
    opt = AdamW(dict(model.named_parameters()), accumulation_steps=accum, mesh=mesh,
                **{**KW, **kw})
    grads, norms = [], []
    update = opt._update

    def record(g):
        grads.append({n: t.clone() for n, t in gather_named(g, model).items()})
        norms.append(opt._global_norm(g) if mesh is not None and mesh.num_model > 1
                     else torch.linalg.vector_norm(
                         torch.stack(torch._foreach_norm(list(g.values())))))
        update(g)

    opt._update = record
    gen = torch.Generator().manual_seed(7) if dropout else None
    step = make_train_step(model, opt, generator=gen)
    losses = []
    for s in range(steps * accum):
        batch = global_batch(s)
        if mesh is not None:
            batch = mesh.shard_batch(batch)
        loss = step(batch)
        losses.append(float(loss if mesh is None else mesh.mean(loss)))
    q = model.backbone["text_model"]["layers"][0]["attn"]["q"]["w"]
    return losses, grads, norms, gather_params(model), tuple(q.shape)
'''

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, port, job_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from multimodal_content_moderation_tpu_torch.parallel.mesh import build_mesh, init_distributed

with open(job_path) as f:
    job = json.load(f)
init_distributed(f"localhost:{port}", world, rank, device="cpu", timeout_s=job["timeout_s"])
exec(compile(job["common"], "common", "exec"))
out = job["out"]


def save(name, **arrays):
    np.savez(os.path.join(out, f"{name}_{rank}.npz"), **arrays)


for run in job["runs"]:
    what = run["what"]
    if what == "train":
        mesh = build_mesh(*run["mesh"])
        weights = None
        if run.get("weights"):
            weights = dict(np.load(run["weights"]))
        losses, grads, norms, params, qshape = run_steps(
            run["kind"], mesh, dropout=run["dropout"], weights=weights, **run.get("kw", {}))
        flat = {f"grad{i}/{k}": v.numpy() for i, g in enumerate(grads) for k, v in g.items()}
        save(run["name"], losses=np.asarray(losses), norms=np.asarray([float(n) for n in norms]),
             qshape=np.asarray(qshape), **flat,
             **{f"param/{k}": v.numpy() for k, v in params.items()})
    elif what == "eval":
        sys.path.insert(0, job["tests"])
        from test_torch_multiprocess import eval_logits

        mesh = build_mesh(len(run["ranks"]), 1, ranks=run["ranks"])
        logits, labels = eval_logits(run["data"], mesh)
        save(run["name"], logits=logits, labels=labels)
    elif what == "dense_bf16":
        from multimodal_content_moderation_tpu_torch.ops.layers import dense
        from multimodal_content_moderation_tpu_torch.parallel.collectives import ModelSplit

        mesh = build_mesh(1, 2)
        g = torch.Generator().manual_seed(0)
        x = torch.randn(64, 32, generator=g).bfloat16()
        w, b = torch.randn(32, 48, generator=g), torch.randn(48, generator=g)
        i = mesh.model_index  # this rank's 16 input features: a row shard of w
        shard = w[16 * i: 16 * (i + 1)].clone()
        shard.model_split = ModelSplit(0, mesh.model_group, i, 2)
        y = dense(x[:, 16 * i: 16 * (i + 1)], {"w": shard, "b": b})
        assert y.dtype == torch.bfloat16
        save(run["name"], y=y.float().numpy(), x=x.float().numpy(), w=w.numpy(), b=b.numpy())
    elif what == "cli":
        from multimodal_content_moderation_tpu_torch.cli import train as t_train

        for k, v in run["env"].items():
            os.environ[k] = v
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                          MASTER_PORT=port)
        t_train.main(run["argv"])
    elif what == "eval_cli":
        from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval

        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                          MASTER_PORT=port)
        t_eval.main(run["argv"])
    elif what == "raise":
        mesh = build_mesh()
        if rank == run["rank"]:
            raise RuntimeError("rank fails on purpose")
        t0 = __import__("time").time()
        try:
            mesh.mean(torch.ones(()))
        finally:
            print(f"WAITED {__import__('time').time() - t0:.1f}", flush=True)
print("DONE", flush=True)
'''


def _spawn(tmp_path, runs, n=2, timeout=TIMEOUT, name="job", group_timeout_s=60):
    """Run the worker in ``n`` gloo processes over the ``runs``; returns
    ([(returncode, output)] by rank, the directory of their results). A
    process still running at ``timeout`` is killed."""
    out = tmp_path / f"{name}_out"
    out.mkdir(exist_ok=True)
    job = tmp_path / f"{name}.json"
    job.write_text(json.dumps({"common": COMMON, "out": str(out), "runs": runs,
                               "tests": str(REPO / "tests"), "timeout_s": group_timeout_s}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    logs = [tmp_path / f"{name}_{r}.log" for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(n), str(port), str(job)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(tmp_path),
            ))
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log.read_text()) for p, log in zip(procs, logs)], out


def _ok(results):
    for rc, text in results:
        assert rc == 0, text[-4000:]


def _load(out, name, rank=0):
    with np.load(out / f"{name}_{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def _one_process(kind, dropout=True, weights=None, **kw):
    ns = {}
    exec(compile(COMMON, "common", "exec"), ns)
    return ns["run_steps"](kind, None, dropout=dropout, weights=weights, **kw)


def _assert_adam_rule(got, want, grads, lr_encoder=1e-3, lr_head=1e-2, steps=3):
    """Parameters after ``steps`` updates: atol 5e-5 where every update's
    gradient is 0 or at least 100 eps, else within ``lr`` a step (the first
    Adam step's ill-conditioning of ``assert_adam_step_matches``)."""
    for name, w in want.items():
        w = w.numpy()
        ag = [np.abs(g[name].numpy()) for g in grads]
        tight = np.all([(a == 0) | (a >= 1e-6) for a in ag], axis=0)
        np.testing.assert_allclose(got[name][tight], w[tight], atol=5e-5, err_msg=name)
        lr = lr_encoder if name.startswith("backbone.") else lr_head
        assert np.all(np.abs(got[name][~tight] - w[~tight]) <= steps * lr), name


def _assert_matches_one_process(res, ref):
    losses, grads, _, params, _ = ref
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
    for i, g in enumerate(grads):
        for k, v in g.items():
            np.testing.assert_allclose(res[f"grad{i}/{k}"], v.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"update {i}: {k}")
    _assert_adam_rule({k[len("param/"):]: v for k, v in res.items() if k.startswith("param/")},
                      params, grads)


# ---------------------------------------------------------------- data for eval


def build_eval_data(root):
    """20 rows (20 % 8 != 0: a padded last batch), one missing image, texts
    of 1 to 9 words, PNG crops."""
    from PIL import Image

    root = Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(7)
    lines = ["text,image_path,labels"]
    for i in range(20):
        name = "missing.png" if i == 4 else f"im{i}.png"
        if i != 4:
            Image.fromarray(g.integers(0, 256, size=(36, 40, 3), dtype=np.uint8)).save(
                root / "imgs" / name)
        lines.append(f"{' '.join(['w'] * (1 + (7 * i) % 9))},{name},"
                     f"{'racist' if i % 2 else 'sexist'}")
    (root / "test.csv").write_text("\n".join(lines) + "\n")
    return str(root)


class VarLenTok:
    def encode_batch(self, texts, max_length):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros_like(ids)
        for r, t in enumerate(texts):
            n = min(len(t.split()) + 2, max_length)
            ids[r, : n - 1] = 1 + (np.arange(n - 1) % 60)
            ids[r, n - 1] = 63
            mask[r, :n] = 1
        return ids, mask

    def __call__(self, texts, max_length):
        return self.encode_batch(texts, max_length)


def eval_logits(data_dir, mesh=None):
    """The tiny CLIP model through the fast engine and ``evaluate_logits_u8``
    (buckets (6, 8), batch 8), over the ``mesh``'s data axis."""
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.models.fast_infer import (
        FastInferenceEngine,
        evaluate_logits_u8,
    )

    ns = {}
    exec(compile(COMMON, "common", "exec"), ns)
    model = ns["tiny_model"]("clip")
    mean = std = (0.5, 0.5, 0.5)
    pre = ImagePreprocessor(32, 32, mean, std, output="uint8_hwc", backend="pil")
    ds = CSVDataset(f"{data_dir}/test.csv", f"{data_dir}/imgs", VarLenTok(), pre, 12,
                    class_names=["racist", "sexist", "other"])
    engine = FastInferenceEngine(model, mean, std, mesh=mesh)
    return evaluate_logits_u8(engine, ds, batch_size=8, num_workers=1, seq_buckets=(6, 8))


# ---------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_weights):
    """One group of two gloo processes: DP 2x1 and TP 1x2 training (CLIP,
    dropout on; the generic model under TP; CLIP DP on the JAX weights with
    dropout off; TP clipping at a norm far above its limit) and the fast
    eval with the ranks in both orders."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    data = build_eval_data(tmp / "data")
    runs = [
        {"what": "train", "name": "dp", "mesh": [2, 1], "kind": "clip", "dropout": True},
        {"what": "train", "name": "tp", "mesh": [1, 2], "kind": "clip", "dropout": True},
        {"what": "train", "name": "tp_generic", "mesh": [1, 2], "kind": "generic",
         "dropout": True},
        {"what": "train", "name": "tp_pallas", "mesh": [1, 2], "kind": "clip_pallas",
         "dropout": True},
        {"what": "train", "name": "dp_jax", "mesh": [2, 1], "kind": "clip", "dropout": False,
         "weights": jax_weights["path"], "kw": JAX_ADAMW},
        {"what": "train", "name": "tp_clip", "mesh": [1, 2], "kind": "clip", "dropout": False,
         "kw": {"max_grad_norm": 1e-3}},
        {"what": "dense_bf16", "name": "dense_bf16"},
        {"what": "eval", "name": "eval", "ranks": [0, 1], "data": data},
        {"what": "eval", "name": "eval_permuted", "ranks": [1, 0], "data": data},
    ]
    t0 = time.time()
    results, out = _spawn(tmp, runs)
    _ok(results)
    return out, data, time.time() - t0


# the JAX test's optimizer, optax.adamw(1e-3): one learning rate, weight
# decay 1e-4, no clipping, a constant schedule
JAX_ADAMW = dict(lr_encoder=1e-3, lr_head=1e-3, weight_decay=1e-4, max_grad_norm=0.0,
                 schedule="constant")


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """The tiny CLIP model's JAX init, flattened to the port's names, and the
    losses of the JAX package's 8x1 mesh (8 virtual devices) over the same
    global batches with dropout off."""
    import jax
    import optax

    from multimodal_content_moderation_tpu.models import CLIPConfig, FusionModel as JFusion
    from multimodal_content_moderation_tpu.models.clip import CLIPTextConfig, CLIPVisionConfig
    from multimodal_content_moderation_tpu.parallel.mesh import (
        build_mesh,
        replicate,
        shard_batch,
    )
    from multimodal_content_moderation_tpu_torch.models.params import flatten

    cfg = CLIPConfig(
        text=CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, max_positions=12, eos_token_id=63),
        vision=CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=2,
                                intermediate_size=64, image_size=32, patch_size=16),
        projection_dim=32)
    model = JFusion.create("clip", num_labels=3, fusion_dim=16, clip_config=cfg)
    params = model.init(jax.random.key(0))
    ns = {}
    exec(compile(COMMON, "common", "exec"), ns)
    mesh = build_mesh()
    assert mesh.devices.shape == (8, 1)
    tx = optax.adamw(1e-3)
    p = replicate(params, mesh)
    state = replicate(tx.init(p), mesh)
    grad = jax.jit(jax.value_and_grad(lambda q, batch: model.apply(q, batch)["loss"]))

    @jax.jit
    def update(p, state, g0, g1):  # optax.MultiSteps(2): the mean of 2 gradients
        upd, state = tx.update(jax.tree_util.tree_map(lambda a, b: (a + b) / 2, g0, g1),
                               state, p)
        return optax.apply_updates(p, upd), state

    losses = []
    for s in range(0, 6, 2):  # 3 updates of 2 micro-steps
        out = [grad(p, shard_batch({k: v.numpy() for k, v in ns["global_batch"](s + i).items()},
                                   mesh)) for i in (0, 1)]
        losses += [float(loss) for loss, _ in out]
        p, state = update(p, state, out[0][1], out[1][1])
    path = tmp_path_factory.mktemp("jax") / "weights.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in
                      flatten(jax.tree_util.tree_map(np.asarray, params)).items()})
    return {"path": str(path), "losses": losses}


def test_dp_2x1_matches_one_process(two_ranks):
    out, _, _ = two_ranks
    ref = _one_process("clip")
    for rank in (0, 1):
        _assert_matches_one_process(_load(out, "dp", rank), ref)


def test_tp_1x2_matches_one_process(two_ranks):
    out, _, _ = two_ranks
    for kind, name in (("clip", "tp"), ("generic", "tp_generic"), ("clip_pallas", "tp_pallas")):
        ref = _one_process(kind)
        for rank in (0, 1):
            res = _load(out, name, rank)
            assert tuple(res["qshape"]) == (32, 16)
            _assert_matches_one_process(res, ref)


def test_dp_2x1_matches_the_jax_mesh(two_ranks, jax_weights):
    out, _, _ = two_ranks
    res = _load(out, "dp_jax")
    np.testing.assert_allclose(res["losses"], jax_weights["losses"], atol=1e-6, rtol=1e-5)
    ref = _one_process("clip", dropout=False, weights=dict(np.load(jax_weights["path"])),
                       **JAX_ADAMW)
    np.testing.assert_allclose(res["losses"], ref[0], rtol=1e-6)


def test_tp_global_norm_when_clipping(two_ranks):
    out, _, _ = two_ranks
    ref = _one_process("clip", dropout=False, max_grad_norm=1e-3)
    for rank in (0, 1):
        res = _load(out, "tp_clip", rank)
        norms = np.asarray([float(n) for n in ref[2]])
        assert np.all(norms > 1e-3)  # every update clips
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-6)
        _assert_matches_one_process(res, ref)


def test_row_parallel_bf16_dense_rounds_once(two_ranks):
    """A row shard's partial products stay fp32 through the sum over the
    model group and the bias; the result is rounded to bf16 once: bit for
    bit the rounding of the fp32 sum, which rounding each partial first is
    not."""
    out, _, _ = two_ranks
    res = _load(out, "dense_bf16")
    x, w, b = (torch.from_numpy(res[k]) for k in ("x", "w", "b"))
    wb = w.bfloat16().float()
    parts = [x[:, :16] @ wb[:16], x[:, 16:] @ wb[16:]]
    once = (parts[0] + parts[1] + b).bfloat16().float()
    np.testing.assert_array_equal(res["y"], once.numpy())
    for rank in (0, 1):
        np.testing.assert_array_equal(_load(out, "dense_bf16", rank)["y"], once.numpy())
    twice = (parts[0].bfloat16().float() + parts[1].bfloat16().float() + b).bfloat16().float()
    assert not torch.equal(twice, once)


@pytest.mark.parametrize("name", ["eval", "eval_permuted"])
def test_fast_eval_over_two_ranks_matches_one_process(two_ranks, name):
    out, data, _ = two_ranks
    want, labels = eval_logits(data)
    assert want.shape == (20, 3)
    for rank in (0, 1):
        got = _load(out, name, rank)
        np.testing.assert_allclose(got["logits"], want, atol=1e-5)
        np.testing.assert_array_equal(got["labels"], labels)


def test_two_rank_group_stays_inside_its_budget(two_ranks):
    assert two_ranks[2] < TIMEOUT


# ---------------------------------------------------------------- four ranks


def test_tp_2x2_matches_one_process(tmp_path):
    results, out = _spawn(tmp_path, [
        {"what": "train", "name": "tp22", "mesh": [2, 2], "kind": "clip", "dropout": True},
    ], n=4)
    _ok(results)
    ref = _one_process("clip")
    for rank in range(4):
        res = _load(out, "tp22", rank)
        assert tuple(res["qshape"]) == (32, 16)
        _assert_matches_one_process(res, ref)


# ---------------------------------------------------------------- failure


def test_a_failing_rank_ends_the_other_within_the_timeout(tmp_path):
    t0 = time.time()
    results, _ = _spawn(tmp_path, [{"what": "raise", "rank": 1}], group_timeout_s=20)
    assert time.time() - t0 < TIMEOUT
    assert results[1][0] != 0 and "rank fails on purpose" in results[1][1]
    assert results[0][0] != 0, results[0][1][-2000:]


def test_a_group_that_cannot_form_raises(monkeypatch):
    from multimodal_content_moderation_tpu_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    with pytest.raises(Exception):  # no rank 0 ever listens: the store times out
        init_distributed(device="cpu", timeout_s=2)
    assert not torch.distributed.is_initialized()
