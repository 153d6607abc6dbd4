"""On the card: a short run of each cell at its own size reads correct, and
the weights of a 15.59 B-element model are drawn, and read by the
reference, within one card. Skips without a card."""

import json
import os

import pytest

from harness_util import ROOT, run_harness

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_card(card, cell):
    rc, line, err = run_harness("--workload", cell, "--seed", "2718281828", "--seconds", "5",
                                "--trace", "0", timeout=900)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]


def room_leaves():
    """The leaves of a fusion model whose text tower is DeepSeek-V2-Lite at
    its published widths (huggingface.co/deepseek-ai/DeepSeek-V2-Lite,
    config.json: 27 layers, hidden 2,048, vocabulary 102,400, the first
    layer dense at 10,944, then 64 routed experts of 1,408 and 2 shared;
    MLA with 16 heads, kv_lora_rank 512, no q_lora, qk 128 + 64, v 128;
    RMSNorm; no lm_head), SigLIP2-B/16-224's vision tower and MAP head, a
    text projection to 768 and the fusion head."""
    from benchmark.harness import spec, weights

    L, D, V, H, kv, nope, rope, vd = 27, 2048, 102400, 16, 512, 128, 64, 128
    dense, ew, experts, shared = 10944, 1408, 64, 2
    s = [("backbone.text_model.embed_tokens.weight", (V, D), "normal", 0.02)]

    def norm(name, d):
        s.append((f"{name}.weight", (d,), "ones", 0.02))

    def mlp(name, f):
        for p in ("gate_proj", "up_proj"):
            weights.add_linear(s, f"{name}.{p}", D, f, bias=False)
        weights.add_linear(s, f"{name}.down_proj", f, D, bias=False)

    for i in range(L):
        b = f"backbone.text_model.layers.{i}"
        norm(f"{b}.input_layernorm", D)
        weights.add_linear(s, f"{b}.self_attn.q_proj", D, H * (nope + rope), bias=False)
        weights.add_linear(s, f"{b}.self_attn.kv_a_proj_with_mqa", D, kv + rope, bias=False)
        norm(f"{b}.self_attn.kv_a_layernorm", kv)
        weights.add_linear(s, f"{b}.self_attn.kv_b_proj", kv, H * (nope + vd), bias=False)
        weights.add_linear(s, f"{b}.self_attn.o_proj", H * vd, D, bias=False)
        norm(f"{b}.post_attention_layernorm", D)
        if i == 0:
            mlp(f"{b}.mlp", dense)
            continue
        weights.add_linear(s, f"{b}.mlp.gate", D, experts, bias=False)
        for j in range(experts):
            mlp(f"{b}.mlp.experts.{j}", ew)
        mlp(f"{b}.mlp.shared_experts", shared * ew)
    norm("backbone.text_model.norm", D)
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "siglip2-b16-224-fusion.json")))
    s += [x for x in spec.family(cfg).backbone_spec(cfg) if ".vision_model." in x[0]]
    weights.add_linear(s, "backbone.text_projection", D, 768, bias=False)
    return s + weights.head_spec(cfg, 768)


@pytest.mark.gpu
def test_room_draw_fits(card):
    # 15.59 B elements in bf16 (29.0 GiB): the draw holds them and one group
    # in fp32 (2 GiB); the reference reads them in their dtype, one leaf
    # in fp32 at a time (the largest, the embedding, 0.78 GiB)
    import time

    import torch

    from benchmark.harness import weights
    from benchmark.reference import models as ref

    leaves = room_leaves()
    n = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in leaves)
    assert 15.55e9 < n < 15.65e9, n
    gib = 2 ** 30
    torch.zeros(1, device=card)  # the context, before the allocator's statistics
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    t = time.perf_counter()
    sd = weights.draw_leaves(leaves, 2718281830, card, torch.bfloat16)
    torch.cuda.synchronize(card)
    seconds = time.perf_counter() - t
    drawn = torch.cuda.max_memory_allocated(card) - base
    held = torch.cuda.memory_allocated(card) - base
    torch.cuda.reset_peak_memory_stats(card)
    P = ref.Fp32(sd)
    largest = max(P[k].numel() for k in P)  # every leaf read in fp32, one at a time
    read = torch.cuda.max_memory_allocated(card) - base - held
    print(json.dumps({"elements": n, "draw_s": seconds, "draw_peak_gib": drawn / gib,
                      "held_gib": held / gib, "reference_adds_gib": read / gib,
                      "largest_leaf": largest}))
    assert 2 * n <= held < 2 * n + 2 ** 20  # one bf16 buffer
    assert drawn <= (29.0 + 2 + 1) * gib
    assert read < gib
