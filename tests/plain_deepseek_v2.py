"""A plain fp32 PyTorch reference of the DeepSeek-V2 text tower under the
fusion classifier, read from Hugging Face ``DeepseekV2Model`` state-dict
names (``modeling_deepseek.py``'s equations), for the CPU tests.

No kernel of the port and no JAX: plain ``torch`` operations in fp32 (TF32
off for products on a card), one row at a time where HF batches, a loop
over the experts where HF gathers them, and each token over its own top-k.

Departures from HF, each one of the classifier's and not of the decoder's:

- no ``lm_head``: the feature is the final RMSNorm's output at each row's
  last kept token (HF ``*ForSequenceClassification``'s pooling under right
  padding), projected by a bias-free ``text_projection``
  (``VisionTextDualEncoderModel``'s);
- top-k ties go to the lower expert index (a stable sort; ``torch.topk``
  leaves the order of equal values unspecified);
- the RMSNorm rounds once, after the weight (HF rounds the normalised row
  to the input dtype, then multiplies: in fp32 both are the same).

``cfg`` is the ``text_config`` of an HF ``DeepseekV2Config`` (a dict).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min


def rms_norm(x, w, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def _yarn_mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_cos_sin(cfg: Dict, T: int):
    """HF ``DeepseekV2YarnRotaryEmbedding``'s cos and sin caches [T, dim]."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(torch.arange(T, dtype=torch.float32), inv_freq)
    m = _yarn_mscale(factor, rs["mscale"]) / _yarn_mscale(factor, rs["mscale_all_dim"])
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """HF's: the interleaved pairs laid out as halves, then the rotation."""
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs.get("mscale_all_dim"):
        m = _yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def linear(x, P, name):
    return x @ P[f"{name}.weight"].t()


def attention(x, P, pre, cfg, mask):
    """``DeepseekV2Attention`` (no q LoRA) over [B, T, d] with a causal mask
    and the key mask."""
    B, T, _ = x.shape
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = linear(x, P, f"{pre}.q_proj").view(B, T, H, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = linear(x, P, f"{pre}.kv_a_proj_with_mqa")
    ckv, k_pe = ckv[..., :r], ckv[..., r:]
    k_pe = k_pe.view(B, T, 1, dr).transpose(1, 2)
    kv = linear(rms_norm(ckv, P[f"{pre}.kv_a_layernorm.weight"], cfg["rms_norm_eps"]), P,
                f"{pre}.kv_b_proj").view(B, T, H, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = yarn_cos_sin(cfg, T)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(B, H, T, dr)], dim=-1)
    s = (qs @ ks.transpose(2, 3)) * softmax_scale(cfg)
    allowed = torch.ones(T, T, dtype=torch.bool).tril()[None, None] & mask.bool()[:, None, None]
    s = s.masked_fill(~allowed, NEG)
    o = torch.softmax(s, dim=-1) @ v
    return linear(o.transpose(1, 2).reshape(B, T, H * dv), P, f"{pre}.o_proj")


def swiglu(x, P, pre):
    return linear(F.silu(linear(x, P, f"{pre}.gate_proj")) * linear(x, P, f"{pre}.up_proj"),
                  P, f"{pre}.down_proj")


def route(x, P, pre, cfg):
    """(idx, weight) [N, k] of ``MoEGate``: softmax of the fp32 gate logits,
    greedy top-k (ties to the lower expert), not renormalised, times the
    scaling factor."""
    scores = torch.softmax(linear(x, P, f"{pre}.gate"), dim=-1)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = idx[:, : cfg["num_experts_per_tok"]]
    return idx, scores.gather(1, idx) * cfg.get("routed_scaling_factor", 1.0)


def moe(x, P, pre, cfg):
    """``DeepseekV2MoE``: each token through its own top-k experts (a loop
    over the experts), weighted and summed, plus the shared experts."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = route(x, P, pre, cfg)
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y[tok] += swiglu(x[tok], P, f"{pre}.experts.{e}") * w[tok, slot, None]
    if cfg.get("n_shared_experts"):
        y = y + swiglu(x, P, f"{pre}.shared_experts")
    return y.view(shape)


def text_features(P, cfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
                  prefix: str = "backbone.") -> torch.Tensor:
    """The projected text feature [B, projection] of right-padded rows."""
    t = f"{prefix}text_model"
    x = P[f"{t}.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        b = f"{t}.layers.{i}"
        h = rms_norm(x, P[f"{b}.input_layernorm.weight"], cfg["rms_norm_eps"])
        x = x + attention(h, P, f"{b}.self_attn", cfg, mask)
        h = rms_norm(x, P[f"{b}.post_attention_layernorm.weight"], cfg["rms_norm_eps"])
        dense = cfg.get("n_routed_experts") is None or i < cfg["first_k_dense_replace"]
        x = x + (swiglu(h, P, f"{b}.mlp") if dense else moe(h, P, f"{b}.mlp", cfg))
    x = rms_norm(x, P[f"{t}.norm.weight"], cfg["rms_norm_eps"])
    last = (mask.sum(1) - 1).clamp(min=0)
    pooled = x[torch.arange(x.shape[0]), last]
    return linear(pooled, P, f"{prefix}text_projection")
