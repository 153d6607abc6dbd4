"""A plain fp32 PyTorch reference of the Kimi-Linear text tower under the
fusion classifier, read from Hugging Face ``KimiLinearModel`` state-dict
names (``modeling_kimi.py``'s equations), for the CPU tests.

No kernel of the port and no JAX: plain ``torch`` operations in fp32 (TF32
off for products on a card), one row at a time where HF batches, the KDA
recurrence token by token where HF runs a chunked kernel, a loop over the
experts where HF gathers them, and each token over its own top-k.

Departures from HF, each one of the classifier's, of the card's share or
of a tie, and not of the decoder's:

- no ``lm_head``: the feature is the final RMSNorm's output at each row's
  last kept token (HF ``*ForSequenceClassification``'s pooling under right
  padding), projected by a bias-free ``text_projection``;
- the expert layer may hold a share of the router's experts (``held``,
  expert parallelism's part of one card): the router scores all of them,
  the share computes the slots of its own and the shared expert, and what
  the other shares would add is left out;
- top-k ties go to the lower expert index (a stable sort; ``torch.topk``
  leaves the order of equal values unspecified);
- KDA runs over each row's kept tokens from a zero state: a row's
  convolution sees no token before its first.

``cfg`` is the ``text_config`` of an HF ``KimiLinearConfig`` (a dict).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min


def fp32_only() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def linear(x, P, name):
    return x @ P[f"{name}.weight"].t()


def kda_layers(cfg: Dict):
    """0-indexed KDA layers of ``linear_attn_config`` (1-indexed)."""
    return {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}


def l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def short_conv(x, w):
    """Causal depthwise ``nn.Conv1d`` (weight [C, 1, K], no bias) over one
    row's tokens [L, C], zeros before the first, then SiLU."""
    K = w.shape[-1]
    xp = F.pad(x.t()[None], (K - 1, 0))
    return F.silu(F.conv1d(xp, w, groups=x.shape[1])[0].t())


def kda_recurrence(q, k, v, g, beta):
    """The gated delta rule token by token over one row: q, k [L, H, dk],
    v [L, H, dv], g [L, H, dk] log-decays, beta [L, H]; S_0 = 0."""
    L, H, dk = q.shape
    S = torch.zeros(H, dk, v.shape[-1], dtype=q.dtype, device=q.device)
    out = []
    for t in range(L):
        S = torch.exp(g[t])[..., None] * S
        kv = torch.einsum("hk,hkv->hv", k[t], S)
        S = S + beta[t][:, None, None] * k[t][..., None] * (v[t] - kv)[:, None, :]
        out.append(torch.einsum("hk,hkv->hv", q[t], S))
    return torch.stack(out)


def kda(x, P, pre, cfg):
    """``KimiDeltaAttention`` over one row's kept tokens [L, d]."""
    lin = cfg["linear_attn_config"]
    H, hd = lin["num_heads"], lin["head_dim"]
    L = x.shape[0]
    q = short_conv(linear(x, P, f"{pre}.q_proj"), P[f"{pre}.q_conv1d.weight"])
    k = short_conv(linear(x, P, f"{pre}.k_proj"), P[f"{pre}.k_conv1d.weight"])
    v = short_conv(linear(x, P, f"{pre}.v_proj"), P[f"{pre}.v_conv1d.weight"])
    q = l2norm(q.view(L, H, hd)) * hd ** -0.5
    k = l2norm(k.view(L, H, hd))
    v = v.view(L, H, hd)
    f = linear(linear(x, P, f"{pre}.f_a_proj"), P, f"{pre}.f_b_proj")
    g = -torch.exp(P[f"{pre}.A_log"].reshape(1, H, 1)) \
        * F.softplus((f + P[f"{pre}.dt_bias"]).view(L, H, hd))
    beta = torch.sigmoid(linear(x, P, f"{pre}.b_proj"))
    o = kda_recurrence(q, k, v, g, beta)
    gate = linear(linear(x, P, f"{pre}.g_a_proj"), P, f"{pre}.g_b_proj").view(L, H, hd)
    o = rms_norm(o, P[f"{pre}.o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(gate)
    return linear(o.reshape(L, H * hd), P, f"{pre}.o_proj")


def mla_nope(x, P, pre, cfg, mask):
    """``KimiMLAAttention`` with ``mla_use_nope`` (no rotation, scale
    q_head_dim^-0.5) over [B, T, d], causal, with the key mask."""
    B, T, _ = x.shape
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = linear(x, P, f"{pre}.q_proj").view(B, T, H, dn + dr).transpose(1, 2)
    ckv = linear(x, P, f"{pre}.kv_a_proj_with_mqa")
    ckv, k_pe = ckv[..., :r], ckv[..., r:].view(B, T, 1, dr).transpose(1, 2)
    kv = linear(rms_norm(ckv, P[f"{pre}.kv_a_layernorm.weight"], cfg["rms_norm_eps"]), P,
                f"{pre}.kv_b_proj").view(B, T, H, dn + dv).transpose(1, 2)
    ks = torch.cat([kv[..., :dn], k_pe.expand(B, H, T, dr)], dim=-1)
    s = (q @ ks.transpose(2, 3)) * (dn + dr) ** -0.5
    allowed = torch.ones(T, T, dtype=torch.bool).tril()[None, None] & mask.bool()[:, None, None]
    o = torch.softmax(s.masked_fill(~allowed, NEG), dim=-1) @ kv[..., dn:]
    return linear(o.transpose(1, 2).reshape(B, T, H * dv), P, f"{pre}.o_proj")


def swiglu(x, P, pre, gate="gate_proj", up="up_proj", down="down_proj"):
    return linear(F.silu(linear(x, P, f"{pre}.{gate}")) * linear(x, P, f"{pre}.{up}"),
                  P, f"{pre}.{down}")


def route(x, P, pre, cfg):
    """(idx, weight) [N, k] of ``KimiMoEGate``: sigmoid scores of the fp32
    gate logits, the top-k of the scores plus the correction bias (ties to
    the lower expert), weighted by the scores renormalised over the k,
    times the scaling factor."""
    s = torch.sigmoid(linear(x, P, f"{pre}.gate"))
    choice = s + P[f"{pre}.gate.e_score_correction_bias"]
    idx = torch.sort(choice, dim=-1, descending=True, stable=True).indices
    idx = idx[:, : cfg["num_experts_per_token"]]
    w = s.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]


def moe(x, P, pre, cfg, held: Optional[Tuple[int, int]] = None, shared: bool = True):
    """``KimiSparseMoeBlock`` over [..., d]: every token through its own
    top-k experts among ``held`` = (first, count) (every routed expert
    where None), weighted and summed, plus the shared expert (``shared``)."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = route(x, P, pre, cfg)
    first, count = held or (0, cfg.get("num_experts_published", cfg["num_experts"]))
    y = torch.zeros_like(x)
    for e in range(first, first + count):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y[tok] += swiglu(x[tok], P, f"{pre}.experts.{e}", "w1", "w3", "w2") \
                * w[tok, slot, None]
    if shared and cfg.get("num_shared_experts"):
        y = y + swiglu(x, P, f"{pre}.shared_experts")
    return y.view(shape)


def text_features(P, cfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
                  prefix: str = "backbone.") -> torch.Tensor:
    """The projected text feature [B, projection] of right-padded rows; the
    expert layers hold the share ``cfg`` names (``first_held_expert``,
    ``num_experts`` of ``num_experts_published``)."""
    t = f"{prefix}text_model"
    held = (cfg.get("first_held_expert", 0), cfg["num_experts"])
    linear_layers = kda_layers(cfg)
    x = P[f"{t}.embed_tokens.weight"][ids]
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        b = f"{t}.layers.{i}"
        h = rms_norm(x, P[f"{b}.input_layernorm.weight"], eps)
        if i in linear_layers:
            a = torch.zeros_like(h)
            for row in range(h.shape[0]):
                keep = mask[row].bool()
                a[row, keep] = kda(h[row, keep], P, f"{b}.self_attn", cfg)
        else:
            a = mla_nope(h, P, f"{b}.self_attn", cfg, mask)
        x = x + a
        h = rms_norm(x, P[f"{b}.post_attention_layernorm.weight"], eps)
        dense = i < cfg["first_k_dense_replace"]
        x = x + (swiglu(h, P, f"{b}.mlp") if dense
                 else moe(h, P, f"{b}.block_sparse_moe", cfg, held))
    x = rms_norm(x, P[f"{t}.norm.weight"], eps)
    last = (mask.sum(1) - 1).clamp(min=0)
    pooled = x[torch.arange(x.shape[0]), last]
    return linear(pooled, P, f"{prefix}text_projection")
