"""The KDA core (csrc/kda.cu: kda_conv, kda_chunk, kda_state, kda_out) of a
Kimi-Linear text tower: every KDA layer's work between its input
projections and ``o_proj`` over the kept tokens of a pass.

Operations: the recurrent form's, whatever form computes it: 2 per
multiply-add of the three dk x dv products a token and head (the state's
decayed read S^T k, its rank-one update, the output S^T q), and of the
short convolution's taps over the three projections (q~, k~, v~).
Bytes: the core's bf16 inputs read once (q~, k~, v~, the decay's and the
output gate's pre-activations, beta's logits) and its output written once.
The work is the configuration's and the traffic's: the kept tokens are
counted from the traffic's own texts by the reference tokenizer
(``flops/moe_grouped.pass_tokens``)."""

from __future__ import annotations

from typing import Dict, Tuple


def kda_layers(t: Dict) -> int:
    return len(t["linear_attn_config"]["kda_layers"])


def count(cfg: Dict, kept_tokens: int) -> Tuple[float, float]:
    """(operations, bytes) of the KDA core over ``kept_tokens`` tokens."""
    t = cfg["text_config"]
    lin = t["linear_attn_config"]
    H, hd, taps = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    C = H * hd
    layers = kda_layers(t)
    ops = 2.0 * kept_tokens * layers * (3 * H * hd * hd + taps * 3 * C)
    nbytes = 2.0 * kept_tokens * layers * (3 * C + C + C + H + C)
    return ops, nbytes
