"""``moe_grouped`` (csrc/moe.cu): the routed experts' two grouped products of
a DeepSeek-V2 expert layer, gate+up with the SiLU product, then down with
the routing weight, over every slot a batch routes.

Operations: 2 per multiply-add of the three expert matrices (d x F each) for
each routed slot: 6 d F a slot, k slots a kept token, in every expert
layer. Bytes: each expert layer of each batch reads its E experts' weights
once (3 d F bf16 each; an expert the router leaves empty would read none,
which at about 390 slots an expert does not happen), and each slot's
activations are read and written once: its token's row in (d), h out and in
(F each), y out (d), bf16. The work is the configuration's and the
traffic's, whatever kernel computes it: the kept tokens are counted from
the traffic's own texts by the reference tokenizer."""

from __future__ import annotations

import math
from typing import Dict, Tuple


def expert_layers(t: Dict) -> int:
    n = t.get("n_routed_experts") or 0
    return sum(1 for i in range(t["num_hidden_layers"])
               if n > 0 and i >= t["first_k_dense_replace"] and i % t["moe_layer_freq"] == 0)


def count(cfg: Dict, kept_tokens: int, batches: int) -> Tuple[float, float]:
    """(operations, bytes) of the routed experts over ``kept_tokens`` tokens
    in ``batches`` batches."""
    t = cfg["text_config"]
    d, f = t["hidden_size"], t["moe_intermediate_size"]
    layers = expert_layers(t)
    slots = t["num_experts_per_tok"] * kept_tokens
    ops = 6.0 * d * f * slots * layers
    weight_bytes = 2.0 * layers * batches * t["n_routed_experts"] * 3 * d * f
    act_bytes = 2.0 * layers * slots * (2 * d + 2 * f)
    return ops, weight_bytes + act_bytes


def pass_tokens(run) -> Tuple[int, int]:
    """(kept tokens, batches) of one pass of a scoring cell's traffic at the
    run's seed: its texts tokenised by the reference tokenizer from the
    configuration's asset files."""
    from benchmark.harness import assets, traffic
    from benchmark.reference import tokenizers

    cfg, mix = run.config, run.cell.traffic
    n = int(mix["rows"])
    texts = traffic.rows(run.seed, n, mix, cfg["head"]["class_names"])["texts"]
    tok = tokenizers.load(cfg["tokenizer"], assets.encoder_dir(cfg))
    mask = tokenizers.encode_batch(tok, texts, cfg["max_text_length"])[1]
    return int(mask.sum()), math.ceil(n / int(mix["batch"]))
