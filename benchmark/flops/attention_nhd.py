"""``attention_nhd`` forward: softmax(q k^T / sqrt(dh) + key mask) v over
[B, T, D] q, k, v (D = heads * dh).

Operations: the two products, 2 * B * heads * dh * (score pairs) each, where
the score pairs are Tq * S, or Tq * (Tq + 1) / 2 under the causal mask.
Bytes: q, k, v and the fp32 key mask read once, the output written once."""


def pairs(Tq: int, S: int, causal: bool) -> int:
    return Tq * (Tq + 1) // 2 if causal else Tq * S


def count(B: int, Tq: int, S: int, heads: int, dh: int, causal: bool, key_mask: bool,
          itemsize: int):
    """(operations, bytes) of one launch."""
    flops = 4 * B * heads * dh * pairs(Tq, S, causal)
    D = heads * dh
    nbytes = itemsize * B * D * (2 * Tq + 2 * S) + (4 * B * S if key_mask else 0)
    return flops, nbytes
