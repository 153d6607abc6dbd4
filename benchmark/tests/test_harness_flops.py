"""The operation and byte counts against hand counts at the shapes of the
port's kernel table (a CLIP ViT-B/32 eval batch, B=144; a SigLIP-224
micro-step, B=24), and the model counts against the widths."""

import json
import os

import pytest

from harness_util import ROOT
from benchmark.flops import attention_nhd, attention_nhd_bwd, model, peaks


def test_attention_nhd_clip_batch_bound():
    # 12 vision launches (T=50, 12 heads x 64) + 12 causal text launches
    # (T=77, 8 x 64, key mask), bf16
    vf, vb = attention_nhd.count(144, 50, 50, 12, 64, False, False, 2)
    tf, tb = attention_nhd.count(144, 77, 77, 8, 64, True, True, 2)
    assert vf == 4 * 144 * 12 * 64 * 50 * 50
    assert vb == 2 * 144 * 768 * 4 * 50
    assert tf == 4 * 144 * 8 * 64 * (77 * 78 // 2)
    assert tb == 2 * 144 * 512 * 4 * 77 + 4 * 144 * 77
    nbytes = 12 * (vb + tb)
    bound_ms = 1e3 * max(12 * (vf + tf) / peaks.peak("bf16_flops"),
                         nbytes / peaks.peak("hbm_bytes_per_s"))
    assert bound_ms == pytest.approx(0.321, abs=0.0005)  # the kernel table's bound (bytes)


def test_attention_nhd_bwd_siglip_step():
    f, b = attention_nhd_bwd.count(24, 196, 196, 12, 64, False, False, 2)
    assert f == 10 * 24 * 12 * 64 * 196 * 196
    # q, k, v, dO read; dq, dk, dv written
    assert b == 2 * 24 * 768 * 196 * 7


def test_model_forward_hand_count():
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/clip-vit-b32-fusion.json")))
    d, f = 768, 3072
    vision = 12 * (2 * 50 * (4 * d * d + 2 * d * f) + 4 * 50 * 50 * d)
    embed = 2 * 49 * 3072 * d
    dt, ft = 512, 2048
    text = 12 * (2 * 20 * (4 * dt * dt + 2 * dt * ft) + 4 * 20 * 10.5 * dt)
    head = 2 * (dt + d) * 512 + 2 * (2 * 512 * 512 + 2 * 512 * 512 + 1026 * 512
                                      + 5 * 512 * 512 + 512 * 5)
    assert model.forward(cfg, 20) == pytest.approx(vision + embed + text + head)
    assert model.training(cfg, 20) == pytest.approx(3 * model.forward(cfg, 20))
    assert 10e9 < model.forward(cfg, 77) < 16e9


def test_siglip_counts_the_map_head():
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/siglip2-b16-224-fusion.json")))
    assert model.vision_tokens(cfg) == 196
    assert 35e9 < model.forward(cfg, 20) < 45e9
