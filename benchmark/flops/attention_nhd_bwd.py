"""``attention_nhd`` backward (recompute): from q, k, v and the output's
cotangent dO, the gradients dq, dk, dv.

Operations: five products over the score pairs, 2 * B * heads * dh * pairs
each: the recomputed scores q k^T, dV = P^T dO, dP = dO v^T, dq = dS k and
dk = dS^T q. Bytes: q, k, v, dO and the fp32 key mask read once, dq, dk, dv
written once."""

from benchmark.flops.attention_nhd import pairs


def count(B: int, Tq: int, S: int, heads: int, dh: int, causal: bool, key_mask: bool,
          itemsize: int):
    """(operations, bytes) of one backward call (its two launches)."""
    flops = 10 * B * heads * dh * pairs(Tq, S, causal)
    D = heads * dh
    nbytes = itemsize * B * D * (2 * Tq + 2 * S) + itemsize * B * D * (Tq + 2 * S) \
        + (4 * B * S if key_mask else 0)
    return flops, nbytes
