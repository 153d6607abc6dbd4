"""Kimi Delta Attention (KDA), the linear attention of Kimi-Linear
(``models/kimi_linear.py``): a gated delta rule with a decay per key
channel, over the packed kept tokens of a batch.

Per token, H heads of dk = dv = 128 (the core between the input
projections and ``o_proj``):

    q, k, v = SiLU(causal depthwise conv4(q~, k~, v~))   taps within a row
    q, k = q / |q|, k / |k| per head (eps 1e-6 under the root); q *= dk^-0.5
    g = -exp(A_log[h]) * softplus(f + dt_bias)           log-decay [H, dk]
    beta = sigmoid(b)                                    [H]
    S_t = Diag(exp(g_t)) S_{t-1};  S_t += beta_t k_t (v_t - S_t^T k_t)^T
    o_t = S_t^T q_t                                      S_0 = 0 a row
    y = RMSNorm_dv(o) * w * sigmoid(gate)                rounded once

Chunked form (``CHUNK`` = 64 tokens, Gamma the cumulative log-decay inside
a chunk from its start): A_kk[i, j] = sum_c k_i k_j exp(Gamma_i - Gamma_j)
for j < i, A_qk the same with q_i for j <= i; M = I + Diag(beta) A_kk;
w = M^-1 Diag(beta) (K e^Gamma), u = M^-1 Diag(beta) V; per chunk in turn
v_new = u - w S, o = (Q e^Gamma) S + A_qk v_new, S <- Diag(e^Gamma_last) S
+ (K e^(Gamma_last - Gamma))^T v_new. Every exponent is a difference of
later minus earlier cumulative decays, so at most 0: the decay may fall
below -100 inside a chunk and nothing overflows (the factorisation k
e^Gamma_i . k e^-Gamma_j would).

On the card in bf16 with gradients off (``ops/layers.fused``) the core is
the four launches of ``csrc/kda.cu``: ``kda_conv`` (the convolution, SiLU,
the norms and the scale), ``kda_chunk`` (the gate and beta, the
intra-chunk products, the inverse, w and u; a block a chunk and head),
``kda_state`` (the chunks of a row in turn: the state, the output; a block
a row, head and half of dv) and ``kda_out`` (the gated output norm). A
shape they do not take raises. Elsewhere (the CPU, fp32, gradients) the
same steps run in plain PyTorch (counted in ``kda.plain``), the chunked
form with exact pairwise exponents, in fp32, the outputs rounded where the
kernels round theirs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.ops import _build
from multimodal_content_moderation_tpu_torch.ops.layers import fused
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count

CHUNK = 64  # tokens a chunk
HEAD = 128  # dk = dv the kernels take
TAPS = 4  # the short convolution's width
L2_EPS = 1e-6


class Rows(NamedTuple):
    """The packed rows of a batch, built on the card from its mask: each
    row's first token (``starts``, int32 [B + 1]) and first chunk
    (``chunks``, int32 [B + 1], a row ceil(kept / ``CHUNK``) chunks), each
    token's row (``row``, int64 [N]) and a bound on the chunks from the
    host's kept count (``bound`` = kept // CHUNK + B)."""

    starts: torch.Tensor
    chunks: torch.Tensor
    row: torch.Tensor
    bound: int


def rows(mask: torch.Tensor, src: torch.Tensor, kept: int) -> Rows:
    """``Rows`` of ``mask`` [B, T] whose kept tokens ``src`` (flat positions,
    ``deepseek_v2.pack``'s) number ``kept``: no read back of the card."""
    B, T = mask.shape
    lengths = (mask != 0).sum(1, dtype=torch.int32)
    zero = lengths.new_zeros(1)
    starts = torch.cat([zero, torch.cumsum(lengths, 0, dtype=torch.int32)])
    per_row = torch.div(lengths + (CHUNK - 1), CHUNK, rounding_mode="floor")
    chunks = torch.cat([zero, torch.cumsum(per_row, 0, dtype=torch.int32)])
    return Rows(starts, chunks, torch.div(src, T, rounding_mode="floor"), kept // CHUNK + B)


# ---------------------------------------------------------------------------
# the plain steps (fp32 inside, outputs rounded to the activations' dtype)
# ---------------------------------------------------------------------------


def conv_reference(qkv: torch.Tensor, w: torch.Tensor, row: torch.Tensor, heads: int,
                   head_dim: int) -> torch.Tensor:
    """[N, 3 C] q~ | k~ | v~ -> q | k | v: the causal depthwise convolution
    (``w`` [3 C, TAPS], tap TAPS - 1 on the token itself) over the tokens of
    the same row, SiLU, then q and k normalised per head and q scaled by
    head_dim^-0.5."""
    N, C3 = qkv.shape
    x = qkv.float()
    wf = w.float()
    acc = x * wf[:, TAPS - 1]
    for j in range(1, TAPS):
        prev = torch.zeros_like(x)
        same = row[j:] == row[:-j]
        prev[j:] = torch.where(same[:, None], x[:-j], prev[j:])
        acc = acc + prev * wf[:, TAPS - 1 - j]
    y = F.silu(acc)
    C = C3 // 3
    qk = y[:, :2 * C].view(N, 2, heads, head_dim)
    qk = qk * torch.rsqrt(qk.pow(2).sum(-1, keepdim=True) + L2_EPS)
    qk[:, 0] *= head_dim ** -0.5
    return torch.cat([qk.reshape(N, 2 * C), y[:, 2 * C:]], 1).to(qkv.dtype)


def gate_reference(f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """fp32 [N, H, dk] log-decays -exp(A_log[h]) softplus(f + dt_bias)."""
    N = f.shape[0]
    z = F.softplus(f.float() + dt_bias.float()).view(N, heads, -1)
    return -torch.exp(a_log.float().view(1, heads, 1)) * z


def chunk_reference(q, k, v, g, beta, head_group: int = 8) -> torch.Tensor:
    """The chunked gated delta rule in fp32 on [B, T, H, d] q, k, v, g and
    [B, T, H] beta (T a multiple of ``CHUNK``; a position with g = 0 and
    beta = 0 leaves the state as it is, so pads are steps that change
    nothing): o [B, T, H, dv]. Exact pairwise exponents inside each chunk,
    masked before the exp; heads in groups of ``head_group`` to bound the
    [., C, C, dk] temporaries."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    n = T // CHUNK
    out = torch.empty(B, T, H, dv, dtype=torch.float32, device=q.device)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=q.device).tril()
    strict = lower.clone().fill_diagonal_(False)
    eye = torch.eye(CHUNK, device=q.device)
    for h0 in range(0, H, head_group):
        hs = slice(h0, min(H, h0 + head_group))

        def split(t):
            # [B, T, h, ...] -> [B, h, n, C, ...]
            t = t[:, :, hs].float()
            return t.reshape(B, n, CHUNK, t.shape[2], *t.shape[3:]).transpose(1, 3) \
                .transpose(2, 3)

        qc, kc, vc, gc, bc = split(q), split(k), split(v), split(g), split(beta)
        G = gc.cumsum(-2)
        S = torch.zeros(B, qc.shape[1], dk, dv, device=q.device)
        for c in range(n):
            Gi = G[:, :, c]  # [B, h, C, dk]
            diff = Gi[:, :, :, None] - Gi[:, :, None]  # [B, h, C(i), C(j), dk]
            decay = torch.exp(diff.masked_fill(~lower[:, :, None], float("-inf")))
            kk = torch.einsum("bhic,bhjc,bhijc->bhij", kc[:, :, c], kc[:, :, c], decay)
            qk = torch.einsum("bhic,bhjc,bhijc->bhij", qc[:, :, c], kc[:, :, c], decay)
            del diff, decay
            kk = kk.masked_fill(~strict, 0.0)
            b = bc[:, :, c]  # [B, h, C]
            M = eye + b[..., None] * kk
            rhs = torch.cat([b[..., None] * kc[:, :, c] * torch.exp(Gi),
                             b[..., None] * vc[:, :, c]], -1)
            wu = torch.linalg.solve_triangular(M, rhs, upper=False, unitriangular=True)
            w, u = wu[..., :dk], wu[..., dk:]
            v_new = u - w @ S
            o = (qc[:, :, c] * torch.exp(Gi)) @ S + qk.masked_fill(~lower, 0.0) @ v_new
            last = Gi[:, :, -1:]  # [B, h, 1, dk]
            S = torch.exp(last).transpose(-1, -2) * S \
                + (kc[:, :, c] * torch.exp(last - Gi)).transpose(-1, -2) @ v_new
            out[:, c * CHUNK:(c + 1) * CHUNK, hs] = o.transpose(1, 2)
    return out


def delta_rule_reference(x: torch.Tensor, f: torch.Tensor, b: torch.Tensor, p, r: Rows,
                         src: torch.Tensor, T: int, heads: int, head_dim: int) -> torch.Tensor:
    """What ``kda_chunk`` + ``kda_state`` compute, in fp32: the decay and
    beta from ``f`` and ``b``, then ``chunk_reference`` on the convolved
    ``x`` (q | k | v [N, 3 C]) laid out by row, each row padded to whole
    chunks; o [N, C] fp32 in the packed order."""
    N = x.shape[0]
    C = heads * head_dim
    B = r.starts.shape[0] - 1
    Tp = -(-T // CHUNK) * CHUNK
    dest = r.row * Tp + src % T  # a token's place in its row padded to Tp

    def padded(t):
        z = t.new_zeros((B * Tp,) + t.shape[1:])
        return z.index_copy_(0, dest, t).view(B, Tp, *t.shape[1:])

    g = gate_reference(f, p["A_log"], p["dt_bias"], heads)
    beta = torch.sigmoid(b[:, :heads].float())
    q, k, v = (padded(x[:, i * C:(i + 1) * C].float().view(N, heads, head_dim))
               for i in range(3))
    o = chunk_reference(q, k, v, padded(g), padded(beta))
    return o.reshape(B * Tp, C).index_select(0, dest)


def out_reference(o: torch.Tensor, gate: torch.Tensor, w: torch.Tensor, eps: float,
                  head_dim: int) -> torch.Tensor:
    """[N, H dv] RMSNorm of each head's o (fp32 mean of squares) times the
    weight and sigmoid(gate), rounded once."""
    N = o.shape[0]
    of = o.float().view(N, -1, head_dim)
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps) * w.float()
    y = y * torch.sigmoid(gate.float().view(N, -1, head_dim))
    return y.reshape(N, -1).to(o.dtype)


# ---------------------------------------------------------------------------
# the kernels (csrc/kda.cu)
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("kda")
    if lib.kda_conv_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn, args in ((lib.kda_conv_launch, [p, p, p, p, i, i, f, p]),
                         (lib.kda_chunk_launch, [p, p, p, i, p, p, p, p, i, i, i]
                          + [p] * 6 + [p]),
                         (lib.kda_state_launch, [p] * 6 + [p, p, i, i, p, p]),
                         (lib.kda_out_launch, [p, p, p, p, i, i, f, p])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _check(err: int) -> None:
    if err:
        _build.check(_build.load("kda"), "kda", err)


def takes(qkv: torch.Tensor, heads: int, head_dim: int) -> bool:
    """Whether the kernels take the layer: contiguous bf16 [N, 3 H 128]
    q~ | k~ | v~ on 16 bytes, N > 0."""
    return (qkv.dim() == 2 and qkv.is_contiguous() and head_dim == HEAD and qkv.shape[0] > 0
            and qkv.shape[1] == 3 * heads * HEAD and qkv.data_ptr() % 16 == 0)


def conv(qkv: torch.Tensor, w: torch.Tensor, r: Rows, heads: int) -> torch.Tensor:
    """``kda_conv``: q | k | v [N, 3 C] bf16. Counted in ``conv.launches``."""
    N, C3 = qkv.shape
    out = torch.empty_like(qkv)
    _check(_lib().kda_conv_launch(qkv.data_ptr(), w.data_ptr(), r.row.data_ptr(),
                                  out.data_ptr(), N, heads, HEAD ** -0.5,
                                  _build.stream_ptr(qkv.device)))
    conv.launches += 1
    return out


conv.launches = 0


class Chunked(NamedTuple):
    """What ``kda_chunk`` leaves for ``kda_state``: w, u, Q e^Gamma and K
    e^(Gamma_last - Gamma) [N, C] bf16, A_qk [bound, H, 64, 64] bf16 and
    e^Gamma_last [bound, H, dk] fp32."""

    w: torch.Tensor
    u: torch.Tensor
    qg: torch.Tensor
    kg: torch.Tensor
    aqk: torch.Tensor
    glast: torch.Tensor


def chunk(qkv: torch.Tensor, f: torch.Tensor, b: torch.Tensor, a_log: torch.Tensor,
          dt_bias: torch.Tensor, r: Rows, heads: int) -> Chunked:
    """``kda_chunk`` over every chunk and head: f [N, C] the decay's
    pre-activation, b a [N, >= H] view (row stride free) of beta's logits.
    Counted in ``chunk.launches``."""
    N = qkv.shape[0]
    C = heads * HEAD
    dev = qkv.device
    bf = torch.bfloat16
    w, u, qg, kg = (torch.empty(N, C, dtype=bf, device=dev) for _ in range(4))
    aqk = torch.empty(r.bound, heads, CHUNK, CHUNK, dtype=bf, device=dev)
    glast = torch.empty(r.bound, heads, HEAD, dtype=torch.float32, device=dev)
    B = r.starts.shape[0] - 1
    _check(_lib().kda_chunk_launch(
        qkv.data_ptr(), f.data_ptr(), b.data_ptr(), b.stride(0), a_log.data_ptr(),
        dt_bias.data_ptr(), r.starts.data_ptr(), r.chunks.data_ptr(), B, r.bound, heads,
        w.data_ptr(), u.data_ptr(), qg.data_ptr(), kg.data_ptr(), aqk.data_ptr(),
        glast.data_ptr(), _build.stream_ptr(dev)))
    chunk.launches += 1
    return Chunked(w, u, qg, kg, aqk, glast)


chunk.launches = 0


def state(c: Chunked, r: Rows, heads: int) -> torch.Tensor:
    """``kda_state``: o [N, C] bf16, the chunks of each row in turn.
    Counted in ``state.launches``."""
    o = torch.empty_like(c.w)
    B = r.starts.shape[0] - 1
    _check(_lib().kda_state_launch(
        c.w.data_ptr(), c.u.data_ptr(), c.qg.data_ptr(), c.kg.data_ptr(), c.aqk.data_ptr(),
        c.glast.data_ptr(), r.starts.data_ptr(), r.chunks.data_ptr(), B, heads, o.data_ptr(),
        _build.stream_ptr(o.device)))
    state.launches += 1
    return o


state.launches = 0


def out_norm(o: torch.Tensor, gate: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``kda_out``: the gated RMSNorm of each head, [N, C] bf16. Counted in
    ``out_norm.launches``."""
    N, C = o.shape
    y = torch.empty_like(o)
    _check(_lib().kda_out_launch(o.data_ptr(), gate.data_ptr(), w.data_ptr(), y.data_ptr(), N,
                                 C // HEAD, eps, _build.stream_ptr(o.device)))
    out_norm.launches += 1
    return y


out_norm.launches = 0


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------


def kda_core(qkv: torch.Tensor, f: torch.Tensor, b: torch.Tensor, gate: torch.Tensor, p,
             r: Rows, src: torch.Tensor, T: int, heads: int, head_dim: int,
             eps: float) -> torch.Tensor:
    """The KDA core (module docstring) on packed tokens: ``qkv`` [N, 3 C] the
    three projections, ``f`` [N, C] the decay's pre-activation (f_b's
    output), ``b`` [N, H] beta's logits (a view), ``gate`` [N, C] the output
    gate's pre-activation (g_b's output); ``p`` holds ``conv`` [3 C, 4],
    ``A_log`` [H], ``dt_bias`` [C], ``o_norm`` {``scale`` [dv]}. ``src``
    and ``T``: the packed tokens' flat positions in the [B, T] mask. Spans
    ``kda.conv``, ``kda.chunk`` and ``kda.out``; counted in ``kda.layers``
    (and ``kda.plain`` off the kernels)."""
    count("kda.layers")
    leaves = [p["conv"], p["A_log"], p["dt_bias"], p["o_norm"]["scale"], f, b, gate]
    on_card = fused(qkv, *leaves)
    if on_card and not takes(qkv, heads, head_dim):
        raise ValueError(f"kda_core: the kernels take contiguous bf16 q~|k~|v~ [N, 3 H "
                         f"{HEAD}] on 16 bytes; got {tuple(qkv.shape)} with {heads} heads of "
                         f"{head_dim}")
    if on_card:
        with annotate("kda.conv"):
            x = conv(qkv, p["conv"], r, heads)
        with annotate("kda.chunk"):
            o = state(chunk(x, f, b, p["A_log"], p["dt_bias"], r, heads), r, heads)
        with annotate("kda.out"):
            return out_norm(o, gate, p["o_norm"]["scale"], eps)
    count("kda.plain")
    with annotate("kda.conv"):
        x = conv_reference(qkv, p["conv"], r.row, heads, head_dim)
    with annotate("kda.chunk"):
        o = delta_rule_reference(x, f, b, p, r, src, T, heads, head_dim).to(qkv.dtype)
    with annotate("kda.out"):
        return out_reference(o, gate, p["o_norm"]["scale"], eps, head_dim)
