"""The plain reference against the port at the tiny width on the CPU: the
same token ids from the same asset files, and, with the port in fp32 on
PIL-exact decode, the same logits and the same first training steps within
fp32 rounding. The benchmark's runs hold the port's bf16 recipe to the same
reference within the cells' limits."""

import copy
import tempfile
import time

import numpy as np
import pytest
import torch

from harness_util import TINY
from benchmark.harness import assets, record, score, spec, traffic, train
from benchmark.reference import tokenizers


@pytest.mark.parametrize("cell", ["tiny-clip.score", "tiny-siglip.score"])
def test_tokenizers_match_the_port(cell):
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

    cfg = spec.load_cell(cell, TINY).config
    enc = assets.encoder_dir(cfg)
    texts = traffic.texts(11, 200, {"min": 1, "max": 60, "skew": 1.0, "punct": 0.2}) + ["", " "]
    want = load_tokenizer(enc).encode_batch(texts, cfg["max_text_length"])
    got = tokenizers.encode_batch(tokenizers.load(cfg["tokenizer"], enc), texts,
                                  cfg["max_text_length"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _fp32_run(cell, mode, seconds=0.5):
    c = spec.load_cell(cell, TINY)
    c = copy.deepcopy(c)
    for r in c.config["recipe"].values():
        r.update(precision="fp32", attention="xla", image_backend="native")
    c.limits = {k: 1.0 for k in c.limits}
    r = record.Run(cell=c, seed=424242, seconds=seconds, trace=False,
                   device=torch.device("cpu"), card="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        mode(r, tmp, time.time())
    return r


@pytest.mark.parametrize("cell", ["tiny-clip.score", "tiny-siglip.score"])
def test_fp32_logits_match(cell):
    r = _fp32_run(cell, score.run)
    assert r.checks["max_abs_logit_gap"]["value"] < 2e-4


@pytest.mark.parametrize("cell", ["tiny-clip.train", "tiny-siglip.train"])
def test_fp32_training_steps_match(cell):
    r = _fp32_run(cell, train.run)
    assert r.checks["loss_gap"]["value"] < 1e-5
    assert r.checks["first_grad_gap"]["value"] < 1e-4
    assert r.checks["update_gap"]["value"] < 1e-3


def test_every_leaf_maps_to_the_port():
    from multimodal_content_moderation_tpu_torch.models import convert
    from multimodal_content_moderation_tpu_torch.models.fusion import config_field
    from multimodal_content_moderation_tpu_torch.models.params import flatten

    from benchmark.harness import port, weights

    for cell in ("tiny-clip.score", "tiny-siglip.score"):
        cfg = spec.load_cell(cell, TINY).config
        family = spec.family(cfg)
        sd = weights.draw(cfg, 1, torch.device("cpu"))
        enc = port.encoder_config(cfg)
        kw = {config_field(family.backend).replace("_config", "_cfg"): enc}
        tree = flatten(convert.fusion_model_from_torch(sd, family.backend, **kw))
        mapped = [p for n in sd for p in family.port_names(n)]
        assert sorted(mapped) == sorted(tree)
        for n, t in sd.items():
            assert sum(tree[p].numel() for p in family.port_names(n)) == t.numel()


@pytest.mark.parametrize("file", ["tests/tiny/configs/tiny-clip.json",
                                  "tests/tiny/configs/tiny-siglip.json",
                                  "configs/clip-vit-b32-fusion.json",
                                  "configs/siglip2-b16-224-fusion.json"])
def test_encoder_config_is_the_ports_parse(file):
    # the port's parse of the encoder directory equals the config the
    # harness built from the configuration file by its family's name
    import dataclasses
    import json
    import os

    from multimodal_content_moderation_tpu_torch.models import model_io

    from benchmark.harness import port
    from harness_util import ROOT

    cfg = json.load(open(os.path.join(ROOT, "benchmark", file)))
    d = {"text_config": cfg["text_config"], "vision_config": cfg["vision_config"]}
    if "projection_dim" in cfg:
        d["projection_dim"] = cfg["projection_dim"]
    make = {"clip": model_io.clip_config_from_dict,
            "siglip": model_io.siglip_config_from_dict}[cfg["family"]]
    want = make(d)
    assert port.encoder_config(cfg) == want
    tower = {"compute_dtype": "bfloat16", "attention_impl": "pallas"}
    assert port.encoder_config(cfg, **tower) == dataclasses.replace(
        want, text=dataclasses.replace(want.text, **tower),
        vision=dataclasses.replace(want.vision, **tower))
