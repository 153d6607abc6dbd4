"""DeepSeek-V2 (HF ``DeepseekV2Model``, ``modeling_deepseek.py``) as the text
tower of the fusion classifier, beside SigLIP's vision tower: a decoder of
latent attention (MLA) and sparse expert layers pooled at each row's last
kept token through a bias-free ``text_projection``
(``VisionTextDualEncoderModel``'s), and SigLIP's ViT pooled by its MAP head.
The harness finds this file by the configuration's ``family``
(``harness/spec.Family`` lists what it gives).

The plain fp32 reference (``features``) follows HF's equations with every
matrix product through ``pr.mm`` (the float8 control rounds them all, the
router's too): RMSNorm (fp32 mean of squares, eps ``rms_norm_eps``); MLA
without q LoRA (q heads of nope + rope, the latent and one shared rotary
key, the latent's RMSNorm, k_nope and v from ``kv_b_proj``, YaRN RoPE after
HF's de-interleave of the pairs, causal attention with the key mask, scale
q_head_dim^-0.5 times mscale(factor, mscale_all_dim)^2); a SwiGLU first
layer; then the router (softmax of the gate logits, greedy top-k, the
probabilities not renormalised, times ``routed_scaling_factor``), each
token through its own top-k experts (a loop over the experts) and the
shared experts. Departures, the classifier's and not the decoder's: no
``lm_head``; the pooling above; top-k ties to the lower expert (a stable
sort; ``torch.topk`` leaves their order unspecified)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.flops.model import tower
from benchmark.harness import weights
from benchmark.reference.models import NEG, encoder, gelu_tanh, linear, ln, patches

BACKEND = "deepseek_v2"


def _moe_layer(t, i: int) -> bool:
    n = t.get("n_routed_experts") or 0
    return n > 0 and i >= t["first_k_dense_replace"] and i % t["moe_layer_freq"] == 0


def _rms(s, name, d):
    s.append((f"{name}.weight", (d,), "ones", 0.02))


def _swiglu_spec(s, name, d, f):
    for p in ("gate_proj", "up_proj"):
        weights.add_linear(s, f"{name}.{p}", d, f, bias=False)
    weights.add_linear(s, f"{name}.down_proj", f, d, bias=False)


def backbone_spec(cfg) -> weights.Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    d, H = t["hidden_size"], t["num_attention_heads"]
    dn, dr, dv, r = (t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"],
                     t["kv_lora_rank"])
    s: weights.Spec = []
    tp, vp = "backbone.text_model", "backbone.vision_model"
    s.append((f"{tp}.embed_tokens.weight", (t["vocab_size"], d), "normal", 0.02))
    for i in range(t["num_hidden_layers"]):
        b = f"{tp}.layers.{i}"
        a = f"{b}.self_attn"
        weights.add_linear(s, f"{a}.q_proj", d, H * (dn + dr), bias=False)
        weights.add_linear(s, f"{a}.kv_a_proj_with_mqa", d, r + dr, bias=False)
        _rms(s, f"{a}.kv_a_layernorm", r)
        weights.add_linear(s, f"{a}.kv_b_proj", r, H * (dn + dv), bias=False)
        weights.add_linear(s, f"{a}.o_proj", H * dv, d, bias=False)
        _rms(s, f"{b}.input_layernorm", d)
        _rms(s, f"{b}.post_attention_layernorm", d)
        if _moe_layer(t, i):
            f = t["moe_intermediate_size"]
            weights.add_linear(s, f"{b}.mlp.gate", d, t["n_routed_experts"], bias=False)
            for j in range(t["n_routed_experts"]):
                _swiglu_spec(s, f"{b}.mlp.experts.{j}", d, f)
            if t.get("n_shared_experts"):
                _swiglu_spec(s, f"{b}.mlp.shared_experts", d, f * t["n_shared_experts"])
        else:
            _swiglu_spec(s, f"{b}.mlp", d, t["intermediate_size"])
    _rms(s, f"{tp}.norm", d)
    weights.add_linear(s, "backbone.text_projection", d, cfg["projection_dim"], bias=False)
    # SigLIP's vision tower and MAP head, as families/siglip.py draws them
    dv_, p, c = v["hidden_size"], v["patch_size"], v["num_channels"]
    n = (v["image_size"] // p) ** 2
    s.append((f"{vp}.embeddings.patch_embedding.weight", (dv_, c, p, p), "normal",
              (c * p * p) ** -0.5))
    s.append((f"{vp}.embeddings.patch_embedding.bias", (dv_,), "normal", 0.02))
    s.append((f"{vp}.embeddings.position_embedding.weight", (n, dv_), "normal", 0.01))
    weights.add_encoder(s, vp, v)
    weights.add_ln(s, f"{vp}.post_layernorm", dv_)
    h = f"{vp}.head"
    s.append((f"{h}.probe", (1, 1, dv_), "normal", 0.02))
    s.append((f"{h}.attention.in_proj_weight", (3 * dv_, dv_), "normal", dv_ ** -0.5))
    s.append((f"{h}.attention.in_proj_bias", (3 * dv_,), "normal", 0.02))
    weights.add_linear(s, f"{h}.attention.out_proj", dv_, dv_)
    weights.add_ln(s, f"{h}.layernorm", dv_)
    weights.add_linear(s, f"{h}.mlp.fc1", dv_, v["intermediate_size"])
    weights.add_linear(s, f"{h}.mlp.fc2", v["intermediate_size"], dv_)
    return s


def feature_dim(cfg) -> int:
    return cfg["projection_dim"]


def bucket_extra(cfg) -> int:
    """No carry column: the causal tower pooled at the last kept token never
    sees the trailing pads a bucket drops."""
    return 0


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _yarn_mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _yarn(t, T, device):
    """HF ``DeepseekV2YarnRotaryEmbedding``'s (cos, sin) [T, rope dim]."""
    dim, base = t["qk_rope_head_dim"], float(t["rope_theta"])
    rs = t["rope_scaling"]
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low, high = max(math.floor(corr(rs["beta_fast"])), 0), min(math.ceil(corr(rs["beta_slow"])),
                                                               dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra, inter = 1.0 / base ** exps, 1.0 / (factor * base ** exps)
    keep = 1.0 - torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                             / (high - low), 0, 1)
    inv = inter * (1 - keep) + extra * keep
    freqs = torch.outer(torch.arange(T, dtype=torch.float32, device=device), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = _yarn_mscale(factor, rs["mscale"]) / _yarn_mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _rope(x, cos, sin):
    """HF's ``apply_rotary_pos_emb`` on one of q, k [B, h, T, dim]."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    rot = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos + rot * sin


def _softmax_scale(t):
    scale = (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]) ** -0.5
    rs = t["rope_scaling"]
    if rs.get("mscale_all_dim"):
        scale *= _yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _attention(pr, x, P, a, t, mask, cos, sin):
    B, T, _ = x.shape
    H, dn, dr, dv, r = (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                        t["v_head_dim"], t["kv_lora_rank"])
    q = linear(pr, x, P, f"{a}.q_proj", bias=False).view(B, T, H, dn + dr).transpose(1, 2)
    ckv = linear(pr, x, P, f"{a}.kv_a_proj_with_mqa", bias=False)
    lat, k_pe = ckv[..., :r], ckv[..., r:].view(B, T, 1, dr).transpose(1, 2)
    kv = linear(pr, _rms_norm(lat, P[f"{a}.kv_a_layernorm.weight"], t["rms_norm_eps"]), P,
                f"{a}.kv_b_proj", bias=False).view(B, T, H, dn + dv).transpose(1, 2)
    qs = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    ks = torch.cat([kv[..., :dn], _rope(k_pe, cos, sin).expand(B, H, T, dr)], dim=-1)
    s = pr.mm(qs, ks.transpose(2, 3)) * _softmax_scale(t)
    allowed = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None, None] \
        & (mask != 0)[:, None, None]
    w = torch.softmax(s.masked_fill(~allowed, NEG), dim=-1)
    o = pr.mm(w, kv[..., dn:]).transpose(1, 2).reshape(B, T, H * dv)
    return linear(pr, o, P, f"{a}.o_proj", bias=False)


def _swiglu(pr, x, P, name):
    g = linear(pr, x, P, f"{name}.gate_proj", bias=False)
    u = linear(pr, x, P, f"{name}.up_proj", bias=False)
    return linear(pr, F.silu(g) * u, P, f"{name}.down_proj", bias=False)


def _route(pr, x, P, name, t):
    """(idx, weight) [N, k] of HF's ``MoEGate``: the softmax of the gate
    logits, greedy top-k (ties to the lower expert), not renormalised, times
    the scaling factor."""
    probs = torch.softmax(linear(pr, x, P, f"{name}.gate", bias=False), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[:, : t["num_experts_per_tok"]]
    return idx, probs.gather(1, idx) * float(t.get("routed_scaling_factor", 1.0))


def _moe(pr, x, P, name, t):
    """The router and each token through its own top-k experts (a loop over
    the experts), weighted, summed, plus the shared experts."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = _route(pr, x, P, name, t)
    y = torch.zeros_like(x)
    for e in range(t["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, _swiglu(pr, x[tok], P, f"{name}.experts.{e}") * w[tok, slot, None])
    if t.get("n_shared_experts"):
        y = y + _swiglu(pr, x, P, f"{name}.shared_experts")
    return y.view(shape)


def features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features: the decoder's final RMSNorm at each row's last
    kept token through ``text_projection``; SigLIP's MAP-head feature."""
    t, v = cfg["text_config"], cfg["vision_config"]
    pre = "backbone.text_model"
    B, T = ids.shape
    x = P[f"{pre}.embed_tokens.weight"][ids]
    cos, sin = _yarn(t, T, ids.device)
    eps = t["rms_norm_eps"]
    for i in range(t["num_hidden_layers"]):
        b = f"{pre}.layers.{i}"
        h = _rms_norm(x, P[f"{b}.input_layernorm.weight"], eps)
        x = x + _attention(pr, h, P, f"{b}.self_attn", t, mask, cos, sin)
        h = _rms_norm(x, P[f"{b}.post_attention_layernorm.weight"], eps)
        x = x + (_moe(pr, h, P, f"{b}.mlp", t) if _moe_layer(t, i)
                 else _swiglu(pr, h, P, f"{b}.mlp"))
    last = (mask.sum(1) - 1).clamp(min=0)
    pooled = _rms_norm(x[torch.arange(B, device=x.device), last], P[f"{pre}.norm.weight"], eps)
    tfeat = linear(pr, pooled, P, "backbone.text_projection", bias=False)

    pre = "backbone.vision_model"
    veps = v["layer_norm_eps"]
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=True)
    y = y + P[f"{pre}.embeddings.position_embedding.weight"]
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                gelu_tanh, veps)
    y = ln(y, P, f"{pre}.post_layernorm", veps)
    # the MAP head: nn.MultiheadAttention with a learned probe as the query
    h = f"{pre}.head"
    D = y.shape[-1]
    w_in, b_in = P[f"{h}.attention.in_proj_weight"], P[f"{h}.attention.in_proj_bias"]
    probe = P[f"{h}.probe"].expand(y.shape[0], 1, D)
    heads = v["num_attention_heads"]
    dh = D // heads
    N = y.shape[1]
    q = (pr.mm(probe, w_in[:D].t()) + b_in[:D]).view(B, 1, heads, dh).transpose(1, 2)
    k = (pr.mm(y, w_in[D:2 * D].t()) + b_in[D:2 * D]).view(B, N, heads, dh).transpose(1, 2)
    vv = (pr.mm(y, w_in[2 * D:].t()) + b_in[2 * D:]).view(B, N, heads, dh).transpose(1, 2)
    w = torch.softmax(pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    a = pr.mm(w, vv).transpose(1, 2).reshape(B, 1, D)
    a = linear(pr, a, P, f"{h}.attention.out_proj")
    z = ln(a, P, f"{h}.layernorm", veps)
    z = linear(pr, gelu_tanh(linear(pr, z, P, f"{h}.mlp.fc1")), P, f"{h}.mlp.fc2")
    return tfeat, (a + z)[:, 0]


def text_ops(t, n: int) -> float:
    """Operations of the decoder over one row's ``n`` kept tokens: every
    projection, the scores and the mixing over the causal triangle, layer 0's
    SwiGLU, and in each expert layer the router, the k routed experts and
    the shared experts each token runs."""
    d, H = t["hidden_size"], t["num_attention_heads"]
    dn, dr, dv, r = (t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"],
                     t["kv_lora_rank"])
    pairs = n * (n + 1) / 2
    attn = 2 * n * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d) \
        + 2 * H * pairs * (dn + dr + dv)
    ops = 0.0
    for i in range(t["num_hidden_layers"]):
        ops += attn
        if _moe_layer(t, i):
            f = t["moe_intermediate_size"]
            ops += 2 * n * d * t["n_routed_experts"]
            ops += 6 * n * d * f * (t["num_experts_per_tok"] + (t.get("n_shared_experts") or 0))
        else:
            ops += 6 * n * d * t["intermediate_size"]
    return ops


def backbone_ops(cfg, text_tokens: int) -> float:
    """The decoder over the row's kept tokens (``text_ops``), the
    projection of the pooled token, and SigLIP's vision side: the patch
    embedding, the tower, the MAP head."""
    t, v = cfg["text_config"], cfg["vision_config"]
    d = v["hidden_size"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    ops = text_ops(t, text_tokens) + 2 * t["hidden_size"] * cfg["projection_dim"]
    ops += 2 * n * v["num_channels"] * v["patch_size"] ** 2 * d
    ops += tower(n, v)
    ops += 2 * (d * d + 2 * n * d * d + d * d + 2 * d * v["intermediate_size"])
    return ops + 4 * n * d
