"""The port's export to the reference format (``models/export.py``,
``convert.write_safetensors``, ``cli/export.py``) against the JAX
package's, on the CPU, on tiny towers whose ``config.json`` both packages
read: CLIP (the ``encoder_dir`` fixture), SigLIP (32 wide, 2 layers) and
the generic ``VisionTextDualEncoderModel`` over a ViT with a BERT, RoBERTa
or DistilBERT text tower (``tests/test_torch_generic.py``'s).

- Key for key and bit for bit: the port's state dict of a model bridged
  from a JAX init equals JAX's ``fusion_model_to_torch`` /
  ``mtl_model_to_torch`` of those weights (values, shapes, the shape (1,)
  of SigLIP's ``logit_scale`` / ``logit_bias``), for every backend and both
  heads (hidden task heads with ``log_vars``, and bare ones without). The
  one difference: a generic multi-task state dict also holds the three
  leaves JAX's drops, so that the reference's strict load passes.
- The generic multi-task bundle loads into the reference layout
  (``VisionTextDualEncoderModel`` + ``MultiTaskClassifier``, built with
  ``transformers``) with no unexpected key and no missing one but a
  ``position_ids`` buffer; JAX's misses the three leaves.
- The writer: its file reads back through ``safetensors.numpy.load_file``
  and through ``read_safetensors`` with the package hidden.
- Round trips: export -> the port's ``load_checkpoint``: fp32 logits equal
  bit for bit; export -> the JAX package's ``load_checkpoint``: fp32
  logits within atol 1e-5 (the fp32 parity bound of the port's tests).
- The CLI: ``cli/export.py --device cpu`` on the run directory of a
  2-step train-CLI run; the evaluate CLI scores the bundle with the same
  metrics as the run directory.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from multimodal_content_moderation_tpu.models import FusionModel as JFusion  # noqa: E402
from multimodal_content_moderation_tpu.models import MultiTaskModel as JMTL  # noqa: E402
from multimodal_content_moderation_tpu.models import export as j_export  # noqa: E402
from multimodal_content_moderation_tpu.models import model_io as j_model_io  # noqa: E402
from multimodal_content_moderation_tpu_torch.cli import evaluate as t_eval  # noqa: E402
from multimodal_content_moderation_tpu_torch.cli import export as t_export_cli  # noqa: E402
from multimodal_content_moderation_tpu_torch.cli import train as t_train  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import convert  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import export as t_export  # noqa: E402
from multimodal_content_moderation_tpu_torch.models import model_io  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.bridge import load_jax_params  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel  # noqa: E402
from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel  # noqa: E402
from test_head_parity import TorchFusionHead, TorchMTLHead  # noqa: E402
from test_torch_generic import TEXT, VIT, _hf  # noqa: E402
from test_torch_quant import _batch  # noqa: E402

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
N = len(CLASSES)
SIGLIP = {
    "model_type": "siglip",
    "text_config": dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=12, projection_size=32),
    "vision_config": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=64, image_size=32, patch_size=16),
}
# name: (backend, the generic text tower)
BACKENDS = {"clip": ("clip", None), "siglip": ("siglip", None), "bert": ("generic", "bert"),
            "roberta": ("generic", "roberta"), "distilbert": ("generic", "distilbert")}
# head: (head, hidden task-head width, learned task weights)
HEADS = {"fusion": ("fusion", 0, False), "mtl": ("mtl", 8, True),
         "mtl_bare": ("mtl", 0, False)}
FAULT3 = {"backbone.text_projection.weight", "backbone.visual_projection.weight",
          "backbone.logit_scale"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def encoders(encoder_dir, tmp_path_factory):
    """{name: encoder directory with its config.json}: the ``encoder_dir``
    fixture for CLIP, a written one for the others."""
    out = {"clip": encoder_dir}
    for name, (backend, arch) in BACKENDS.items():
        if backend == "clip":
            continue
        d = tmp_path_factory.mktemp(f"export_enc_{name}")
        (d / "config.json").write_text(json.dumps(SIGLIP if arch is None else _hf(arch)))
        out[name] = str(d)
    return out


def _pair(name, head, enc, seed=0):
    """(JAX model, its params, the port's model with those weights) on
    ``enc``'s config.json."""
    backend, _ = BACKENDS[name]
    kind, hidden, task_weights = HEADS[head]
    jcfg = j_model_io.load_encoder_config(enc, backend)
    tcfg = model_io.load_encoder_config(enc, backend)
    field = {"clip": "clip_config", "siglip": "siglip_config",
             "generic": "generic_config"}[backend]
    if kind == "fusion":
        jmodel = JFusion.create(backend, num_labels=N, fusion_dim=16, **{field: jcfg})
        tmodel = FusionModel.create(backend, num_labels=N, fusion_dim=16, device="cpu",
                                    **{field: tcfg})
    else:
        mb = "auto" if backend == "siglip" else backend
        kw = dict(num_tasks=N, fusion_dim=16, head_hidden_dim=hidden,
                  learnable_task_weights=task_weights)
        jmodel = JMTL.create(mb, **kw, **{field: jcfg})
        tmodel = MultiTaskModel.create(mb, device="cpu", **kw, **{field: tcfg})
    jparams = jmodel.init(jax.random.key(seed))
    if task_weights:  # off zero, so that a lost log_vars shows
        jparams["head"]["log_vars"] = jax.numpy.asarray(
            np.random.default_rng(seed).normal(size=N).astype(np.float32))
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _jax_state_dict(jmodel, jparams):
    if isinstance(jmodel, JMTL):
        return j_export.mtl_model_to_torch(jparams, jmodel)
    return j_export.fusion_model_to_torch(jparams, jmodel)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_export_matches_jax_key_for_key(name, head, encoders):
    jmodel, jparams, tmodel = _pair(name, head, encoders[name])
    want = _jax_state_dict(jmodel, jparams)
    got = t_export.reference_state_dict(tmodel)
    extra = FAULT3 if BACKENDS[name][0] == "generic" and head != "fusion" else set()
    assert set(got) == set(want) | extra and not extra & set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.is_contiguous(), k
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    if name == "siglip":
        assert got["backbone.logit_scale"].shape == got["backbone.logit_bias"].shape == (1,)
    if name == "clip" and head == "fusion":
        assert got["backbone.logit_scale"].shape == ()
    if extra:
        dim = tmodel.generic_config.projection_dim
        assert got["backbone.text_projection.weight"].shape == (dim, 32)
        assert not got["backbone.visual_projection.weight"].any()
        assert float(got["backbone.logit_scale"]) == pytest.approx(2.6592)
        # the encoder config's logit_scale_init_value where it has one
        sd = t_export.reference_state_dict(tmodel, {"logit_scale_init_value": 1.5})
        assert float(sd["backbone.logit_scale"]) == 1.5


def test_export_refuses_an_int8_model(encoders):
    from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

    _, _, tmodel = _pair("clip", "fusion", encoders["clip"])
    q, n = quantize_fc1_layers(tmodel, shape=None)
    assert n == 2
    with pytest.raises(ValueError, match="eval-only"):
        t_export.reference_state_dict(q)


class _ReferenceAuto(torch.nn.Module):
    """The reference's ``backend: auto`` models over a
    ``VisionTextDualEncoderModel``: ``backbone.*`` + the head's top-level
    modules (``MultiModalFusionClassifier`` / ``MultiTaskClassifier``)."""

    def __init__(self, hf_cfg, head, num_labels=N, fusion_dim=16):
        super().__init__()
        self.backbone = transformers.VisionTextDualEncoderModel(hf_cfg)
        kind, hidden, _ = HEADS[head]
        if kind == "fusion":
            h = TorchFusionHead(hf_cfg.projection_dim, fusion_dim, num_labels)
            names = ("proj_t", "proj_i", "g_t", "g_i", "gate", "cls", "ln_fused")
        else:
            h = TorchMTLHead(hf_cfg.text_config.hidden_size, hf_cfg.vision_config.hidden_size,
                             fusion_dim, num_labels, hidden)
            names = ("proj_t", "proj_i", "g_t", "g_i", "gate", "shared_head", "heads")
        for n in names:
            setattr(self, n, getattr(h, n))
        if HEADS[head][2]:
            self.log_vars = torch.nn.Parameter(torch.zeros(num_labels))


def _vtde_config(arch):
    text_cls = {"bert": transformers.BertConfig, "roberta": transformers.RobertaConfig,
                "distilbert": transformers.DistilBertConfig}[arch]
    strip = lambda d: {k: v for k, v in d.items() if k != "model_type"}  # noqa: E731
    return transformers.VisionTextDualEncoderConfig.from_vision_text_configs(
        transformers.ViTConfig(**strip(VIT)), text_cls(**strip(TEXT[arch])), projection_dim=24)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("arch", ["bert", "roberta", "distilbert"])
def test_generic_bundle_loads_strictly_in_the_reference_layout(arch, head, encoders):
    jmodel, jparams, tmodel = _pair(arch, head, encoders[arch])
    oracle = _ReferenceAuto(_vtde_config(arch), head)
    sd = {k: v.clone() for k, v in t_export.reference_state_dict(tmodel).items()}
    missing, unexpected = oracle.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all("position_ids" in m for m in missing), missing
    if head != "fusion":
        # the JAX package's bundle lacks the three leaves (its fault)
        want = _jax_state_dict(jmodel, jparams)
        missing, _ = oracle.load_state_dict({k: torch.from_numpy(v) for k, v in want.items()},
                                            strict=False)
        assert FAULT3 <= set(missing)


def test_write_safetensors_reads_back(tmp_path):
    from safetensors.numpy import load_file

    g = np.random.default_rng(0)
    sd = {"b.weight": torch.from_numpy(g.normal(size=(3, 5)).astype(np.float32)),
          "a.bias": g.normal(size=7).astype(np.float32),
          "scalar": torch.tensor(2.5),
          "half": torch.from_numpy(g.normal(size=(2, 2)).astype(np.float32)).bfloat16(),
          "empty": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "model.safetensors")
    assert convert.write_safetensors(sd, path) == path
    want = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()}
    for reader in (load_file, convert.read_safetensors):
        got = reader(path)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w)
    # with the package hidden, load_safetensors takes the port's reader
    saved = {n: sys.modules.get(n) for n in ("safetensors", "safetensors.numpy")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        got = convert.load_safetensors(path)
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
    np.testing.assert_array_equal(got["b.weight"], want["b.weight"])


def _bundle(d, name, head, enc, tmodel):
    """``tmodel`` exported with its inference_config.json into ``d``."""
    kind, hidden, task_weights = HEADS[head]
    t_export.export_safetensors(tmodel, str(d / "model.safetensors"))
    cfg = {"backend": BACKENDS[name][0], "head": kind, "fusion_dim": 16,
           "class_names": CLASSES, "encoder_dir": enc, "head_hidden_dim": hidden,
           "learnable_task_weights": task_weights}
    (d / "inference_config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("name", ["clip", "siglip", "bert"])
def test_export_round_trips(name, head, encoders, tmp_path):
    _, _, tmodel = _pair(name, head, encoders[name], seed=3)
    ckpt = _bundle(tmp_path, name, head, encoders[name], tmodel)
    batch = _batch(BACKENDS[name][0])
    with torch.inference_mode():
        want = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})["logits"].numpy()
        back, _ = model_io.load_checkpoint(ckpt, device="cpu")
        got = back({k: torch.from_numpy(v) for k, v in batch.items()})["logits"].numpy()
    np.testing.assert_array_equal(got, want)
    jmodel, jparams, _ = j_model_io.load_checkpoint(ckpt)
    jgot = np.asarray(jmodel.apply(jparams, batch)["logits"])
    np.testing.assert_allclose(jgot, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def two_step_run(config_file, tmp_path_factory):
    """The train CLI on the shared fixture: 32 rows at batch 16, one epoch
    (2 optimizer steps)."""
    out = str(tmp_path_factory.mktemp("export_run") / "exp")
    result = t_train.main([
        "--config", config_file, "--saving.output_dir", out,
        "--training.per_device_train_batch_size", "16", "--training.num_train_epochs", "1",
        "--device", "cpu",
    ])
    assert result["result"]["global_step"] == 2
    return out, result["result"]["best_checkpoint"]


def test_export_cli_end_to_end(two_step_run, encoder_dir, data_dir, tmp_path):
    run, ckpt = two_step_run
    out = str(tmp_path / "exported")
    path = t_export_cli.main(["--checkpoint", ckpt, "--output_dir", out, "--device", "cpu"])
    bundle = os.path.join(out, "checkpoint-exported")
    assert path == os.path.join(bundle, "model.safetensors")
    for name in ("vocab.json", "merges.txt", "config.json", "preprocessor_config.json"):
        assert os.path.exists(os.path.join(bundle, name)), name
    with open(os.path.join(run, "inference_config.json")) as f:
        run_cfg = json.load(f)
    with open(os.path.join(out, "inference_config.json")) as f:
        cfg = json.load(f)
    assert "format" not in cfg and cfg["best_checkpoint_dir"] == bundle
    assert {k: v for k, v in cfg.items() if k != "best_checkpoint_dir"} == {
        k: v for k, v in run_cfg.items() if k not in ("format", "best_checkpoint_dir")}
    # the bundle is the reference layout: no torch run format inside
    assert not os.path.exists(os.path.join(bundle, "params.pt"))
    common = ["--test_csv", f"{data_dir}/test.csv", "--image_root", f"{data_dir}/images",
              "--batch_size", "8", "--device", "cpu"]
    want = t_eval.main(["--checkpoint", ckpt, "--output", str(tmp_path / "run.json")] + common)
    got = t_eval.main(["--checkpoint", bundle, "--output", str(tmp_path / "bundle.json")]
                      + common)
    timing = ("runtime", "samples_per_second", "device")
    assert {k: v for k, v in got.items() if k not in timing} == {
        k: v for k, v in want.items() if k not in timing}


def test_export_cli_keeps_refusing_orbax(tmp_path):
    d = tmp_path / "orbax"
    d.mkdir()
    (d / "inference_config.json").write_text(json.dumps({"format": "orbax", "backend": "clip"}))
    with pytest.raises(NotImplementedError, match="Orbax"):
        t_export_cli.main(["--checkpoint", str(d), "--output_dir", str(tmp_path / "o"),
                           "--device", "cpu"])
    assert not (tmp_path / "o").exists()


def test_export_cli_defaults_to_the_card(two_step_run, tmp_path):
    assert t_export_cli.parse_args(["--checkpoint", "c", "--output_dir", "o"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_export_cli.main(["--checkpoint", two_step_run[1], "--output_dir",
                               str(tmp_path / "o")])
