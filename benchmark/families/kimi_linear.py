"""Kimi-Linear (HF ``KimiLinearModel``, ``modeling_kimi.py``) as the text
tower of the fusion classifier, beside SigLIP's vision tower: a decoder of
Kimi Delta Attention (a gated delta rule with a decay per key channel) and
NoPE latent attention (MLA) layers, a dense first layer and then sparse
expert layers under a sigmoid router, pooled at each row's last kept token
through a bias-free ``text_projection``; SigLIP's ViT pooled by its MAP
head. The harness finds this file by the configuration's ``family``
(``harness/spec.Family`` lists what it gives).

The configuration holds one card's share of each expert layer (expert
parallelism): ``num_experts`` experts from ``first_held_expert`` (0) of the
router's ``num_experts_published``. The router scores all of them; the
share computes its own experts' slots and the shared expert, and what the
other cards' experts would add is left out, here as in the program.

The plain fp32 reference (``features``) follows HF's equations with every
matrix product through ``pr`` (the float8 control rounds them all, the
router's, the convolutions' and the recurrence's too): RMSNorm (fp32 mean
of squares, eps ``rms_norm_eps``); KDA token by token (q, k, v projected,
each through its causal depthwise convolution of 4 taps and SiLU, q and k
L2-normalised per head with eps 1e-6 and q scaled by head_dim^-0.5; the
log-decay -exp(A_log) softplus(f_b(f_a(x)) + dt_bias); beta = sigmoid(x
W_b); S = Diag(exp(g)) S, S += beta k (v - S^T k)^T, o = S^T q from S = 0;
the output's RMSNorm per head times the weight and sigmoid(g_b(g_a(x))),
``o_proj``); MLA without rotation (the 64 "rotary" columns of q and of the
shared key as they are, scale q_head_dim^-0.5, causal with the key mask); a
SwiGLU first layer; then the router (sigmoid scores of the gate logits, the
top-k of the scores plus the score-correction bias, the scores renormalised
over the k, times ``routed_scaling_factor``), each token through its own
held experts (a loop over the experts) and the shared expert. Departures,
the classifier's, the share's and a tie's, not the decoder's: no
``lm_head``; the pooling above; the held share; top-k ties to the lower
expert (a stable sort). A pad after a row's last kept token is a step of
the recurrence that changes nothing (beta and the decay 0 there), so the
rows run at the batch's width; the token-wise layers run on the kept
tokens."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.flops.model import tower
from benchmark.harness import weights
from benchmark.reference.models import NEG, encoder, gelu_tanh, linear, ln, patches

BACKEND = "kimi_linear"
HEAD_GROUP = 8  # attention heads a block of MLA's fp32 scores
ROUTED_DOWN = 0.25  # the routed experts' w2, in units of 1/sqrt(F)


def _kda_layers(t):
    return {i - 1 for i in t["linear_attn_config"]["kda_layers"]}


def _held(t):
    return t.get("first_held_expert", 0), t["num_experts"]


def _rms(s, name, d):
    s.append((f"{name}.weight", (d,), "ones", 0.02))


def _swiglu_spec(s, name, d, f, names=("gate_proj", "up_proj", "down_proj")):
    for p in names[:2]:
        weights.add_linear(s, f"{name}.{p}", d, f, bias=False)
    weights.add_linear(s, f"{name}.{names[2]}", f, d, bias=False)


def backbone_spec(cfg) -> weights.Spec:
    t, v = cfg["text_config"], cfg["vision_config"]
    d, H = t["hidden_size"], t["num_attention_heads"]
    dn, dr, dv, r = (t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"],
                     t["kv_lora_rank"])
    lin = t["linear_attn_config"]
    kh, hd = lin["num_heads"], lin["head_dim"]
    C, taps = kh * hd, lin["short_conv_kernel_size"]
    first, held = _held(t)
    width = t.get("num_experts_published", held)
    s: weights.Spec = []
    tp, vp = "backbone.text_model", "backbone.vision_model"
    s.append((f"{tp}.embed_tokens.weight", (t["vocab_size"], d), "normal", 0.02))
    linear_layers = _kda_layers(t)
    for i in range(t["num_hidden_layers"]):
        b = f"{tp}.layers.{i}"
        a = f"{b}.self_attn"
        if i in linear_layers:
            for p in ("q_proj", "k_proj", "v_proj"):
                weights.add_linear(s, f"{a}.{p}", d, C, bias=False)
            for p in ("q_conv1d", "k_conv1d", "v_conv1d"):
                s.append((f"{a}.{p}.weight", (C, 1, taps), "normal", taps ** -0.5))
            # log-decay rates around e^1 a token (the harness draws normals)
            s.append((f"{a}.A_log", (1, 1, kh, 1), "ones", 0.7))
            weights.add_linear(s, f"{a}.f_a_proj", d, hd, bias=False)
            weights.add_linear(s, f"{a}.f_b_proj", hd, C, bias=False)
            # softplus(-4 + f) of about 0.02 a token: a memory of tens of tokens
            s.append((f"{a}.dt_bias", (C,), "const", -4.0))
            weights.add_linear(s, f"{a}.b_proj", d, kh, bias=False)
            weights.add_linear(s, f"{a}.g_a_proj", d, hd, bias=False)
            weights.add_linear(s, f"{a}.g_b_proj", hd, C, bias=False)
            _rms(s, f"{a}.o_norm", hd)
            weights.add_linear(s, f"{a}.o_proj", C, d, bias=False)
        else:
            weights.add_linear(s, f"{a}.q_proj", d, H * (dn + dr), bias=False)
            weights.add_linear(s, f"{a}.kv_a_proj_with_mqa", d, r + dr, bias=False)
            _rms(s, f"{a}.kv_a_layernorm", r)
            weights.add_linear(s, f"{a}.kv_b_proj", r, H * (dn + dv), bias=False)
            weights.add_linear(s, f"{a}.o_proj", H * dv, d, bias=False)
        _rms(s, f"{b}.input_layernorm", d)
        _rms(s, f"{b}.post_attention_layernorm", d)
        if i >= t["first_k_dense_replace"]:
            m, f = f"{b}.block_sparse_moe", t["moe_intermediate_size"]
            weights.add_linear(s, f"{m}.gate", d, width, bias=False)
            s.append((f"{m}.gate.e_score_correction_bias", (width,), "normal", 0.02))
            for j in range(first, first + held):
                e = f"{m}.experts.{j}"
                for p in ("w1", "w3"):
                    weights.add_linear(s, f"{e}.{p}", d, f, bias=False)
                # a quarter of 1/sqrt(F): a top-8 set that rounding changes at
                # its 8th place moves a token by a quarter of an expert, and
                # the changes do not cascade through the 26 expert layers
                s.append((f"{e}.w2.weight", (d, f), "normal", ROUTED_DOWN * f ** -0.5))
            if t.get("num_shared_experts"):
                _swiglu_spec(s, f"{m}.shared_experts", d, f * t["num_shared_experts"])
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


def _l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def _conv(pr, y, w):
    """HF's ``ShortConvolution``: a causal depthwise ``nn.Conv1d`` of [B, T,
    C] (zeros before a row's first token), then SiLU."""
    yp = F.pad(y.transpose(1, 2), (w.shape[-1] - 1, 0))
    return F.silu(F.conv1d(pr.q(yp), pr.q(w), groups=y.shape[-1]).transpose(1, 2))


def _kda(pr, x, P, a, t, keep):
    """``KimiDeltaAttention`` over [B, T, d], the recurrence token by token
    on the batch's rows at once (beta and the decay 0 at the pads)."""
    lin = t["linear_attn_config"]
    H, hd = lin["num_heads"], lin["head_dim"]
    B, T, _ = x.shape
    q = _conv(pr, linear(pr, x, P, f"{a}.q_proj", bias=False), P[f"{a}.q_conv1d.weight"])
    k = _conv(pr, linear(pr, x, P, f"{a}.k_proj", bias=False), P[f"{a}.k_conv1d.weight"])
    v = _conv(pr, linear(pr, x, P, f"{a}.v_proj", bias=False), P[f"{a}.v_conv1d.weight"])
    q = _l2norm(q.view(B, T, H, hd)) * hd ** -0.5
    k = _l2norm(k.view(B, T, H, hd))
    v = v.view(B, T, H, hd)
    f = linear(pr, linear(pr, x, P, f"{a}.f_a_proj", bias=False), P, f"{a}.f_b_proj",
               bias=False)
    g = -torch.exp(P[f"{a}.A_log"].reshape(1, 1, H, 1)) \
        * F.softplus((f + P[f"{a}.dt_bias"]).view(B, T, H, hd))
    g = g * keep[:, :, None, None]
    beta = torch.sigmoid(linear(pr, x, P, f"{a}.b_proj", bias=False)) * keep[:, :, None]
    S = x.new_zeros(B, H, hd, hd)
    out = []
    for i in range(T):
        S = torch.exp(g[:, i])[..., None] * S
        kv = pr.mm(k[:, i, :, None, :], S)[:, :, 0]  # S^T k
        S = S + pr.mm((beta[:, i, :, None] * k[:, i])[..., None], (v[:, i] - kv)[:, :, None])
        out.append(pr.mm(q[:, i, :, None, :], S)[:, :, 0])
    o = torch.stack(out, 1)  # [B, T, H, dv]
    gate = linear(pr, linear(pr, x, P, f"{a}.g_a_proj", bias=False), P, f"{a}.g_b_proj",
                  bias=False).view(B, T, H, hd)
    o = _rms_norm(o, P[f"{a}.o_norm.weight"], t["rms_norm_eps"]) * torch.sigmoid(gate)
    return linear(pr, o.reshape(B, T, H * hd), P, f"{a}.o_proj", bias=False)


def _mla(pr, x, P, a, t, mask):
    """``KimiMLAAttention`` with ``mla_use_nope``: no rotation, scale
    q_head_dim^-0.5, causal with the key mask; fp32 scores in blocks of
    ``HEAD_GROUP`` heads."""
    B, T, _ = x.shape
    H, dn, dr, dv, r = (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                        t["v_head_dim"], t["kv_lora_rank"])
    q = linear(pr, x, P, f"{a}.q_proj", bias=False).view(B, T, H, dn + dr).transpose(1, 2)
    ckv = linear(pr, x, P, f"{a}.kv_a_proj_with_mqa", bias=False)
    lat, k_pe = ckv[..., :r], ckv[..., r:].view(B, T, 1, dr).transpose(1, 2)
    kv = linear(pr, _rms_norm(lat, P[f"{a}.kv_a_layernorm.weight"], t["rms_norm_eps"]), P,
                f"{a}.kv_b_proj", bias=False).view(B, T, H, dn + dv).transpose(1, 2)
    ks = torch.cat([kv[..., :dn], k_pe.expand(B, H, T, dr)], dim=-1)
    allowed = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None, None] \
        & (mask != 0)[:, None, None]
    out = []
    for h0 in range(0, H, HEAD_GROUP):
        hs = slice(h0, h0 + HEAD_GROUP)
        s = pr.mm(q[:, hs], ks[:, hs].transpose(2, 3)) * (dn + dr) ** -0.5
        w = torch.softmax(s.masked_fill(~allowed, NEG), dim=-1)
        del s
        out.append(pr.mm(w, kv[:, hs, :, dn:]))
    o = torch.cat(out, 1).transpose(1, 2).reshape(B, T, H * dv)
    return linear(pr, o, P, f"{a}.o_proj", bias=False)


def _swiglu(pr, x, P, name, names=("gate_proj", "up_proj", "down_proj")):
    g = linear(pr, x, P, f"{name}.{names[0]}", bias=False)
    u = linear(pr, x, P, f"{name}.{names[1]}", bias=False)
    return linear(pr, F.silu(g) * u, P, f"{name}.{names[2]}", bias=False)


def _route(pr, x, P, name, t):
    """(idx, weight) [N, k] of ``KimiMoEGate``: sigmoid scores, the top-k of
    the scores plus the correction bias (ties to the lower expert), the
    scores renormalised over the k, times the scaling factor."""
    s = torch.sigmoid(linear(pr, x, P, f"{name}.gate", bias=False))
    choice = s + P[f"{name}.gate.e_score_correction_bias"]
    idx = torch.sort(choice, dim=-1, descending=True, stable=True).indices
    idx = idx[:, : t["num_experts_per_token"]]
    w = s.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * float(t["routed_scaling_factor"])


def _moe(pr, x, P, name, t):
    """The router over every expert and each token through its own held
    experts (a loop over them), weighted, summed, plus the shared expert."""
    idx, w = _route(pr, x, P, name, t)
    y = torch.zeros_like(x)
    first, held = _held(t)
    for e in range(first, first + held):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, _swiglu(pr, x[tok], P, f"{name}.experts.{e}", ("w1", "w3", "w2"))
                         * w[tok, slot, None])
    if t.get("num_shared_experts"):
        y = y + _swiglu(pr, x, P, f"{name}.shared_experts")
    return y


def _vision(pr, cfg, P, pixels):
    """SigLIP's MAP-head feature, as families/deepseek_v2.py computes it."""
    v = cfg["vision_config"]
    pre = "backbone.vision_model"
    veps = v["layer_norm_eps"]
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=True)
    y = y + P[f"{pre}.embeddings.position_embedding.weight"]
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                gelu_tanh, veps)
    y = ln(y, P, f"{pre}.post_layernorm", veps)
    h = f"{pre}.head"
    B, N, D = y.shape
    w_in, b_in = P[f"{h}.attention.in_proj_weight"], P[f"{h}.attention.in_proj_bias"]
    probe = P[f"{h}.probe"].expand(B, 1, D)
    heads = v["num_attention_heads"]
    dh = D // heads
    q = (pr.mm(probe, w_in[:D].t()) + b_in[:D]).view(B, 1, heads, dh).transpose(1, 2)
    k = (pr.mm(y, w_in[D:2 * D].t()) + b_in[D:2 * D]).view(B, N, heads, dh).transpose(1, 2)
    vv = (pr.mm(y, w_in[2 * D:].t()) + b_in[2 * D:]).view(B, N, heads, dh).transpose(1, 2)
    w = torch.softmax(pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    a = pr.mm(w, vv).transpose(1, 2).reshape(B, 1, D)
    a = linear(pr, a, P, f"{h}.attention.out_proj")
    z = ln(a, P, f"{h}.layernorm", veps)
    z = linear(pr, gelu_tanh(linear(pr, z, P, f"{h}.mlp.fc1")), P, f"{h}.mlp.fc2")
    return (a + z)[:, 0]


def features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features: the decoder's final RMSNorm at each row's last
    kept token through ``text_projection``; SigLIP's MAP-head feature."""
    t = cfg["text_config"]
    pre = "backbone.text_model"
    B, T = ids.shape
    T = max(int((mask != 0).sum(1).max()), 1)  # the steps past every row's end change nothing
    ids, mask = ids[:, :T], mask[:, :T]
    keep = (mask != 0).to(torch.float32)
    kept = (mask.reshape(-1) != 0).nonzero()[:, 0]
    x = P[f"{pre}.embed_tokens.weight"][ids]
    d = x.shape[-1]
    eps = t["rms_norm_eps"]
    linear_layers = _kda_layers(t)
    for i in range(t["num_hidden_layers"]):
        b = f"{pre}.layers.{i}"
        h = _rms_norm(x, P[f"{b}.input_layernorm.weight"], eps)
        x = x + (_kda(pr, h, P, f"{b}.self_attn", t, keep) if i in linear_layers
                 else _mla(pr, h, P, f"{b}.self_attn", t, mask))
        h = _rms_norm(x, P[f"{b}.post_attention_layernorm.weight"], eps).reshape(B * T, d)[kept]
        m = (_moe(pr, h, P, f"{b}.block_sparse_moe", t) if i >= t["first_k_dense_replace"]
             else _swiglu(pr, h, P, f"{b}.mlp"))
        x = x.reshape(B * T, d).index_add(0, kept, m).view(B, T, d)
    last = (mask.sum(1) - 1).clamp(min=0)
    pooled = _rms_norm(x[torch.arange(B, device=x.device), last], P[f"{pre}.norm.weight"], eps)
    return linear(pr, pooled, P, "backbone.text_projection", bias=False), _vision(pr, cfg, P,
                                                                                   pixels)


def text_ops(t, n: int) -> float:
    """Operations of the decoder over one row's ``n`` kept tokens: every
    projection; in a KDA layer the recurrence's three dk x dv products a
    token and head; in an MLA layer the scores and the mixing over the
    causal triangle; layer 0's SwiGLU; in each expert layer the router over
    every expert, the routed slots this card's share holds (k held / routed
    a token, the router's spread taken as even) and the shared expert."""
    d, H = t["hidden_size"], t["num_attention_heads"]
    dn, dr, dv, r = (t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"],
                     t["kv_lora_rank"])
    lin = t["linear_attn_config"]
    kh, hd = lin["num_heads"], lin["head_dim"]
    C = kh * hd
    first, held = _held(t)
    width = t.get("num_experts_published", held)
    pairs = n * (n + 1) / 2
    mla = 2 * n * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d) \
        + 2 * H * pairs * (dn + dr + dv)
    kda = 2 * n * (3 * d * C + d * (2 * hd + kh) + 2 * hd * C + C * d) + 2 * n * 3 * kh * hd * hd
    linear_layers = _kda_layers(t)
    ops = 0.0
    for i in range(t["num_hidden_layers"]):
        ops += kda if i in linear_layers else mla
        if i >= t["first_k_dense_replace"]:
            f = t["moe_intermediate_size"]
            ops += 2 * n * d * width
            slots = t["num_experts_per_token"] * held / width + (t.get("num_shared_experts") or 0)
            ops += 6 * n * d * f * slots
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
