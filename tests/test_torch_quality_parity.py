"""The port's quality-parity tool (``multimodal_content_moderation_tpu_torch/tools/
quality_parity.py``) against the JAX package's ``tools/quality_parity.py`` on
the synthetic fixture of ``tests/conftest.py``, on the CPU.

In locked mode (identical init, identical data, dropout off) both tools
train the same HF reference oracle, and their second sides (the port's model
and the JAX model) start from its converted weights: the port's per-step
losses equal JAX's within 1e-4, its val logits within 1e-3, and F1 / ROC
agree within the +-0.005 band. The fast recipe (``--fast``, the port's u8
wire + bf16 + bf16 Adam moments + ``text_fit``) tracks JAX's ``jax_fast``
within 0.05 a step at the same ``text_fit`` width. The ``fp32`` oracle, the
port's own model at the parity configuration, follows the HF oracle's
trajectory within 1e-4 a step from the same weights. And the tool refuses
what it cannot do: ``--oracle reference`` without ``transformers``, the card
without one."""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import quality_parity as jax_qp  # noqa: E402  (the JAX package's tool)

from multimodal_content_moderation_tpu_torch.tools import quality_parity as port_qp  # noqa: E402

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
BAND = 0.005
KW = dict(class_names=CLASSES, mode="locked", epochs=1, batch_size=8, fusion_dim=16,
          max_text_length=16, lr=1e-3)


@pytest.fixture(scope="module")
def siglip_encoder_dir(tmp_path_factory):
    """Tiny SigLIP checkpoint dir (config + safetensors + tokenizer.json),
    the recipe of tests/test_quality_parity.py."""
    import transformers
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("siglip_qp_enc_torch")
    words = ["<unk>", "<pad>", "hate", "love", "people", "you", "stop", "go", "bad", "good"]
    vocab = {w: i for i, w in enumerate(words)}
    with open(d / "tokenizer.json", "w") as f:
        json.dump({
            "version": "1.0", "normalizer": {"type": "Lowercase"},
            "pre_tokenizer": {"type": "Whitespace"},
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
            "added_tokens": [], "post_processor": None, "decoder": None,
        }, f)
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"pad_token": "<pad>"}, f)
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=16,
                         vocab_size=len(vocab)),
        vision_config=dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=64, image_size=32, patch_size=16),
    )
    torch.manual_seed(0)
    model = transformers.SiglipModel(hf_cfg).eval()
    save_file(model.state_dict(), str(d / "model.safetensors"))
    with open(d / "config.json", "w") as f:
        json.dump(hf_cfg.to_dict(), f)
    with open(d / "preprocessor_config.json", "w") as f:
        json.dump({"size": {"height": 32, "width": 32}, "image_mean": [0.5, 0.5, 0.5],
                   "image_std": [0.5, 0.5, 0.5]}, f)
    return str(d)


def _paths(data_dir):
    return dict(train_csv=f"{data_dir}/train.csv", val_csv=f"{data_dir}/val.csv",
                image_root=f"{data_dir}/images")


def _capture(monkeypatch, module, name, store):
    """Record what ``module.name`` returns."""
    fn = getattr(module, name)

    def spy(*a, **k):
        out = fn(*a, **k)
        store.append(out)
        return out

    monkeypatch.setattr(module, name, spy)


def _both(monkeypatch, enc, data_dir, jax_kw=None, port_kw=None, **kw):
    """(JAX report, port report, the JAX side's (losses, val logits), the
    port side's) of one configuration."""
    got = {"jax": [], "port": []}
    _capture(monkeypatch, jax_qp, "train_jax", got["jax"])
    _capture(monkeypatch, port_qp, "train_port", got["port"])
    kw = {**KW, **kw}
    j = jax_qp.run(encoder_dir=enc, **_paths(data_dir), **kw, **(jax_kw or {}))
    p = port_qp.run(encoder_dir=enc, **_paths(data_dir), **kw, **(port_kw or {}),
                    device="cpu")
    return j, p, got["jax"][-1][:2], got["port"][-1][:2]


CONFIGS = {
    "clip-fusion": dict(head="fusion", backend="clip", int8_eval=True),
    "clip-mtl": dict(head="mtl", head_hidden_dim=8, backend="clip"),
    "siglip-fusion": dict(head="fusion", backend="siglip"),
}


@pytest.fixture(scope="module")
def locked_pairs(encoder_dir, siglip_encoder_dir, data_dir):
    mp = pytest.MonkeyPatch()
    try:
        return {name: _both(mp, siglip_encoder_dir if cfg["backend"] == "siglip"
                            else encoder_dir, data_dir, **cfg)
                for name, cfg in CONFIGS.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_locked_port_matches_jax(locked_pairs, config):
    j, p, (j_losses, j_logits), (p_losses, p_logits) = locked_pairs[config]
    assert p["steps"] == j["steps"] == 4  # 32 rows / 8 a batch, one epoch
    assert p["head"] == j["head"] and p["mode"] == j["mode"] == "locked"
    assert p["oracle_kind"] == "reference" and p["port_config"] == j["jax_config"]
    # the same HF oracle on the same batches
    assert abs(p["final_loss_oracle"] - j["final_loss_torch"]) < 1e-5
    # the port's side against the JAX side, step for step
    np.testing.assert_allclose(p_losses, j_losses, atol=1e-4, rtol=0)
    assert p["losses"]["port"] == p_losses
    assert p["max_step_loss_delta"] < 1e-4 and j["max_step_loss_delta"] < 1e-4
    np.testing.assert_allclose(p_logits, j_logits, atol=1e-3, rtol=0)
    for key in ("f1_macro", "roc_macro"):
        assert abs(p["port"][key] - j["jax"][key]) <= BAND
        assert p["delta"][key] <= BAND
    assert set(p) >= {"oracle", "port", "delta", "final_loss_oracle", "final_loss_port",
                      "max_step_loss_delta", "max_val_logit_delta", "device", "launches",
                      "wall_s", "trained_samples_per_s"}
    assert p["device"] == "cpu"
    assert all(v == 0 for side in p["launches"].values() for v in side.values())


def test_int8_block_matches_jax(locked_pairs):
    j, p, _, _ = locked_pairs["clip-fusion"]
    ji, pi = j["int8_mlp"], p["int8_mlp"]
    renamed = {k.replace("torch", "oracle").replace("jax", "port") for k in ji}
    assert renamed <= set(pi)
    assert pi["quantized_fc1_layers"] == ji["quantized_fc1_layers"]
    for key in ("f1_macro", "roc_macro"):
        assert abs(pi["delta_vs_oracle"][key] - ji["delta_vs_torch"][key]) <= BAND
        assert abs(pi["delta_vs_port"][key] - ji["delta_vs_jax"][key]) <= BAND
    assert abs(pi["max_val_logit_delta_vs_port"] - ji["max_val_logit_delta_vs_jax"]) < 1e-3


@pytest.mark.parametrize("head", ["fusion", "mtl"])
def test_fast_recipe_matches_jax_fast(monkeypatch, encoder_dir, data_dir, head):
    j, p, (j_losses, j_logits), (p_losses, p_logits) = _both(
        monkeypatch, encoder_dir, data_dir, jax_kw={"jax_fast": True},
        port_kw={"fast": True}, epochs=2, head=head, head_hidden_dim=8 if head == "mtl" else 0)
    assert p["mode"] == j["mode"] == "locked_fast"
    width = lambda cfg: int(cfg.rsplit("text_fit", 1)[1])  # noqa: E731
    assert width(p["port_config"]) == width(j["jax_config"])
    for r in (j, p):
        assert r["delta"]["f1_macro"] <= BAND and r["delta"]["roc_macro"] <= BAND
        assert r["max_step_loss_delta"] < 0.05
    np.testing.assert_allclose(p_losses, j_losses, atol=0.05, rtol=0)
    assert np.max(np.abs(p_logits - j_logits)) < 0.05


@pytest.mark.parametrize("head", ["fusion", "mtl"])
def test_fp32_oracle_follows_the_reference_oracle(encoder_dir, data_dir, head):
    kw = dict(head=head, head_hidden_dim=8 if head == "mtl" else 0)
    build = (port_qp.build_torch_mtl(encoder_dir, 5, 16, 8, 0) if head == "mtl"
             else port_qp.build_torch_fusion(encoder_dir, 5, 16, 0))
    init = {k: v.detach().clone() for k, v in build.state_dict().items()}
    ref = port_qp.run(encoder_dir, **_paths(data_dir), **KW, **kw, oracle="reference",
                      device="cpu", init_state=init)
    f32 = port_qp.run(encoder_dir, **_paths(data_dir), **KW, **kw, oracle="fp32",
                      device="cpu", init_state=init)
    assert f32["oracle_kind"] == "fp32"
    np.testing.assert_allclose(f32["losses"]["oracle"], ref["losses"]["oracle"], atol=1e-4,
                               rtol=0)
    # with the fp32 oracle the port's fp32 side is the same computation
    assert f32["max_step_loss_delta"] == 0.0 and f32["max_val_logit_delta"] == 0.0


def test_fp32_oracle_default_init(encoder_dir, data_dir):
    """Without ``init_state`` the fp32 oracle starts from the encoder dir's
    weights and a reference-layout head drawn after ``manual_seed``; the
    independent mode gives the port's side its own head and dropout."""
    locked = port_qp.run(encoder_dir, **_paths(data_dir), **KW, oracle="fp32", device="cpu")
    indep = port_qp.run(encoder_dir, **_paths(data_dir), **{**KW, "mode": "independent"},
                        oracle="fp32", device="cpu")
    assert locked["losses"]["oracle"] == locked["losses"]["port"]
    assert indep["mode"] == "independent" and indep["max_val_logit_delta"] is None
    # dropout on both sides, and the port's side has its own head
    assert indep["losses"]["oracle"] != locked["losses"]["oracle"]
    assert indep["losses"]["port"] != indep["losses"]["oracle"]
    assert np.isfinite(indep["losses"]["port"]).all()


@pytest.mark.parametrize("head", ["fusion", "mtl"])
def test_reference_bf16_witness(encoder_dir, data_dir, head):
    """``reference_bf16`` trains the HF reference model itself in bf16 from
    the oracle's start and data order, beside an unchanged oracle and port
    side: its block holds its metrics and its deltas against both sides."""
    kw = dict(KW, head=head, head_hidden_dim=8 if head == "mtl" else 0, fast=True,
              oracle="reference", device="cpu")
    plain = port_qp.run(encoder_dir, **_paths(data_dir), **kw)
    r = port_qp.run(encoder_dir, **_paths(data_dir), **kw, reference_bf16=True)
    assert r["losses"] == plain["losses"] and r["oracle"] == plain["oracle"]
    w = r["reference_bf16"]
    assert len(w["losses"]) == r["steps"] and set(w["metrics"]) == set(r["oracle"])
    for side in ("oracle", "port"):
        losses = np.asarray(r["losses"][side])
        assert w[f"max_step_loss_delta_vs_{side}"] == np.max(np.abs(w["losses"] - losses))
        assert set(w[f"delta_vs_{side}"]) == set(r["delta"])
    # bf16, so not the oracle's trajectory, yet close to it at this width
    assert 0 < w["max_step_loss_delta_vs_oracle"] < 0.05
    assert 0 < w["max_val_logit_delta_vs_oracle"] < 0.05
    assert all(v == 0 for v in w["launches"].values())


def test_train_reference_bf16_steps_fp32_weights(encoder_dir, data_dir):
    """In bf16 the reference's weights stay fp32 and take every step; the
    first step's loss is the fp32 model's within bf16's rounding."""
    model = port_qp.build_torch_mtl(encoder_dir, 5, 16, 8, 0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    train, val = _datasets(encoder_dir, data_dir)
    orders = port_qp.epoch_orders(len(train), 1, 0)
    f32 = port_qp.build_torch_mtl(encoder_dir, 5, 16, 8, 0)
    f32_losses, _, _ = port_qp.train_reference(f32, train, val, orders, 8, 1e-3, 0.01, True,
                                               torch.device("cpu"))
    losses, logits, labels = port_qp.train_reference(
        model, train, val, orders, 8, 1e-3, 0.01, True, torch.device("cpu"),
        compute_dtype="bfloat16")
    assert logits.dtype == np.float32 and logits.shape == labels.shape == (len(val), 5)
    assert np.isfinite(losses).all() and np.isfinite(logits).all()
    assert abs(losses[0] - f32_losses[0]) < 0.01 and losses[0] != f32_losses[0]
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype, k
    moved = [k for k, v in model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert "proj_t.weight" in moved and any(k.startswith("tower_img.") for k in moved)


def test_fusion_oracle_reads_transformers_5_outputs(encoder_dir, monkeypatch):
    """transformers 5's ``get_*_features`` return a ``BaseModelOutputWithPooling``
    holding the features in ``pooler_output``: the fusion oracle's logits
    are the same as from transformers 4's tensors."""
    import transformers
    from transformers.modeling_outputs import BaseModelOutputWithPooling

    model = port_qp.build_torch_fusion(encoder_dir, 5, 16, 0).eval()
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 90, (2, 16), generator=g)
    ids[:, 7] = model.backbone.config.text_config.eos_token_id
    args = (ids, torch.ones_like(ids), torch.randn(2, 3, 32, 32, generator=g),
            torch.ones(2), torch.tensor([1.0, 0.0]))
    with torch.no_grad():
        want = model(*args)
        for name in ("get_text_features", "get_image_features"):
            fn = getattr(transformers.CLIPModel, name)
            monkeypatch.setattr(
                transformers.CLIPModel, name,
                lambda self, *a, _fn=fn, **k: BaseModelOutputWithPooling(
                    pooler_output=_fn(self, *a, **k)))
        got = model(*args)
    assert torch.equal(got, want)


def test_reference_bf16_needs_the_reference_oracle(encoder_dir, data_dir, capsys):
    with pytest.raises(ValueError, match="reference_bf16"):
        port_qp.run(encoder_dir, **_paths(data_dir), **KW, oracle="fp32", device="cpu",
                    reference_bf16=True)
    with pytest.raises(SystemExit) as e:
        port_qp.main(_argv(encoder_dir, data_dir, "--device", "cpu", "--oracle", "fp32",
                           "--reference_bf16"))
    assert e.value.code == 2 and "--oracle reference" in capsys.readouterr().err


def _datasets(encoder_dir, data_dir):
    """The tool's f32-wire train and val datasets of the fixture."""
    from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

    (h, w), mean, std = image_stats_from_dir(encoder_dir, "clip")
    pp = ImagePreprocessor(h, w, mean, std, output="float_nchw",
                           backend=port_qp.image_backend())
    tok = load_tokenizer(encoder_dir)
    return [CSVDataset(f"{data_dir}/{split}.csv", f"{data_dir}/images", tok, pp, 16,
                       class_names=CLASSES) for split in ("train", "val")]


def _argv(encoder_dir, data_dir, *extra):
    return ["--encoder_dir", encoder_dir, "--train_csv", f"{data_dir}/train.csv",
            "--val_csv", f"{data_dir}/val.csv", "--image_root", f"{data_dir}/images",
            "--class_names", ",".join(CLASSES), "--epochs", "1", "--batch_size", "8",
            "--fusion_dim", "16", "--max_text_length", "16", *extra]


def test_cli_exit_code(encoder_dir, data_dir, tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = port_qp.main(_argv(encoder_dir, data_dir, "--device", "cpu", "--output", str(out)))
    assert rc == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    # a band no run can meet gives exit code 1, the report still written
    rc = port_qp.main(_argv(encoder_dir, data_dir, "--device", "cpu", "--oracle", "fp32",
                            "--tolerance", "-1", "--output", str(out)))
    assert rc == 1 and out.exists()


def test_reference_oracle_needs_transformers(encoder_dir, data_dir, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit) as e:
        port_qp.main(_argv(encoder_dir, data_dir, "--device", "cpu"))
    assert "transformers" in str(e.value.code) and "--oracle fp32" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_no_card_no_report(encoder_dir, data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as e:
        port_qp.main(_argv(encoder_dir, data_dir, "--oracle", "fp32", "--output", str(out)))
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == "" and not out.exists()
