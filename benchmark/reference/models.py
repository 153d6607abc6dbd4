"""Plain fp32 PyTorch of the benchmark's models, read from Hugging Face
state-dict names: CLIP ViT-B/32 and SigLIP2-B/16 dual encoders (as
``transformers.CLIPModel`` and ``SiglipModel`` compute them) under
``backbone.``, and the gated fusion head of the reference
``MultiModalFusionClassifier`` at the top level, with its BCE loss.

Nothing here imports the measured program. ``P`` is a dict of fp32 tensors
keyed by the state-dict names; the forward is functional, so the same code
trains (leaves with ``requires_grad``) and scores. ``lowp="fp8"`` rounds both
operands of every matrix product, and the gradient flowing back into them,
to float8 e4m3 with a per-tensor scale: the correctness control, one
precision below the bf16 that the configurations state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

NEG = torch.finfo(torch.float32).min
FP8_MAX = 448.0


def fp32_only() -> None:
    """Matrix products in true fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class Precision:
    """Where each matrix product's operands are rounded: nowhere (fp32) or
    to float8 e4m3 (the control)."""

    def __init__(self, lowp: Optional[str] = None):
        if lowp not in (None, "fp8"):
            raise ValueError(f"lowp {lowp!r}: want None or 'fp8'")
        self.lowp = lowp

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.lowp is None else _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


def linear(pr: Precision, x, P, name, bias=True):
    y = pr.mm(x, P[f"{name}.weight"].t())
    return y + P[f"{name}.bias"] if bias else y


def ln(x, P, name, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def attention(pr: Precision, xq, xkv, P, name, heads, bias=None, causal=False):
    """Multi-head attention with the ``{q,k,v,out}_proj`` names; ``bias`` an
    additive [B, Tk] key mask."""
    B, Tq, D = xq.shape
    Tk = xkv.shape[1]
    dh = D // heads
    q = linear(pr, xq, P, f"{name}.q_proj").view(B, Tq, heads, dh).transpose(1, 2)
    k = linear(pr, xkv, P, f"{name}.k_proj").view(B, Tk, heads, dh).transpose(1, 2)
    v = linear(pr, xkv, P, f"{name}.v_proj").view(B, Tk, heads, dh).transpose(1, 2)
    s = pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).triu(1), NEG)
    w = torch.softmax(s, dim=-1)
    o = pr.mm(w, v).transpose(1, 2).reshape(B, Tq, D)
    return linear(pr, o, P, f"{name}.out_proj")


def encoder(pr, x, P, prefix, layers, heads, act, eps, bias=None, causal=False):
    for i in range(layers):
        b = f"{prefix}.layers.{i}"
        y = ln(x, P, f"{b}.layer_norm1", eps)
        x = x + attention(pr, y, y, P, f"{b}.self_attn", heads, bias, causal)
        y = ln(x, P, f"{b}.layer_norm2", eps)
        x = x + linear(pr, act(linear(pr, y, P, f"{b}.mlp.fc1")), P, f"{b}.mlp.fc2")
    return x


def patches(pr, pixels, P, name, patch, bias):
    """Conv2d with stride = kernel = ``patch`` as a matrix product:
    [B, 3, H, W] -> [B, N, D] in row-major patch order."""
    B, C, H, W = pixels.shape
    x = pixels.unfold(2, patch, patch).unfold(3, patch, patch)  # B C h w p p
    x = x.permute(0, 2, 3, 1, 4, 5).reshape(B, (H // patch) * (W // patch), C * patch * patch)
    w = P[f"{name}.weight"].reshape(P[f"{name}.weight"].shape[0], -1)
    y = pr.mm(x, w.t())
    return y + P[f"{name}.bias"] if bias else y


def clip_features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features of ``transformers.CLIPModel``."""
    t, v = cfg["text_config"], cfg["vision_config"]
    T = ids.shape[1]
    pre = "backbone.text_model"
    x = P[f"{pre}.embeddings.token_embedding.weight"][ids] + \
        P[f"{pre}.embeddings.position_embedding.weight"][:T]
    bias = (1.0 - mask.float()) * NEG
    x = encoder(pr, x, P, f"{pre}.encoder", t["num_hidden_layers"], t["num_attention_heads"],
                quick_gelu, t["layer_norm_eps"], bias, causal=True)
    x = ln(x, P, f"{pre}.final_layer_norm", t["layer_norm_eps"])
    eos = torch.argmax((ids == t["eos_token_id"]).int(), dim=-1)
    tfeat = linear(pr, x[torch.arange(x.shape[0], device=x.device), eos], P,
                   "backbone.text_projection", bias=False)

    pre = "backbone.vision_model"
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=False)
    cls = P[f"{pre}.embeddings.class_embedding"].expand(y.shape[0], 1, -1)
    y = torch.cat([cls, y], dim=1) + P[f"{pre}.embeddings.position_embedding.weight"]
    y = ln(y, P, f"{pre}.pre_layrnorm", v["layer_norm_eps"])
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                quick_gelu, v["layer_norm_eps"])
    y = ln(y[:, 0], P, f"{pre}.post_layernorm", v["layer_norm_eps"])
    vfeat = linear(pr, y, P, "backbone.visual_projection", bias=False)
    return tfeat, vfeat


def siglip_features(pr, cfg, P, ids, mask, pixels):
    """(text, image) features of ``transformers.SiglipModel``: the text
    tower's last position through its head; the vision tower's MAP head."""
    t, v = cfg["text_config"], cfg["vision_config"]
    T = ids.shape[1]
    pre = "backbone.text_model"
    x = P[f"{pre}.embeddings.token_embedding.weight"][ids] + \
        P[f"{pre}.embeddings.position_embedding.weight"][:T]
    bias = (1.0 - mask.float()) * NEG
    x = encoder(pr, x, P, f"{pre}.encoder", t["num_hidden_layers"], t["num_attention_heads"],
                gelu_tanh, t["layer_norm_eps"], bias)
    x = ln(x, P, f"{pre}.final_layer_norm", t["layer_norm_eps"])
    tfeat = linear(pr, x[:, -1], P, f"{pre}.head")

    pre = "backbone.vision_model"
    eps = v["layer_norm_eps"]
    y = patches(pr, pixels, P, f"{pre}.embeddings.patch_embedding", v["patch_size"], bias=True)
    y = y + P[f"{pre}.embeddings.position_embedding.weight"]
    y = encoder(pr, y, P, f"{pre}.encoder", v["num_hidden_layers"], v["num_attention_heads"],
                gelu_tanh, eps)
    y = ln(y, P, f"{pre}.post_layernorm", eps)
    # the MAP head: nn.MultiheadAttention with a learned probe as the query
    h = f"{pre}.head"
    D = y.shape[-1]
    w_in, b_in = P[f"{h}.attention.in_proj_weight"], P[f"{h}.attention.in_proj_bias"]
    probe = P[f"{h}.probe"].expand(y.shape[0], 1, D)
    heads = v["num_attention_heads"]
    dh = D // heads
    B, N = y.shape[0], y.shape[1]
    q = (pr.mm(probe, w_in[:D].t()) + b_in[:D]).view(B, 1, heads, dh).transpose(1, 2)
    k = (pr.mm(y, w_in[D:2 * D].t()) + b_in[D:2 * D]).view(B, N, heads, dh).transpose(1, 2)
    vv = (pr.mm(y, w_in[2 * D:].t()) + b_in[2 * D:]).view(B, N, heads, dh).transpose(1, 2)
    w = torch.softmax(pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    a = pr.mm(w, vv).transpose(1, 2).reshape(B, 1, D)
    a = linear(pr, a, P, f"{h}.attention.out_proj")
    z = ln(a, P, f"{h}.layernorm", eps)
    z = linear(pr, gelu_tanh(linear(pr, z, P, f"{h}.mlp.fc1")), P, f"{h}.mlp.fc2")
    return tfeat, (a + z)[:, 0]


FEATURES = {"clip": clip_features, "siglip": siglip_features}


def fusion_head(pr, P, tfeat, vfeat, text_present, image_present, drop_mask=None):
    """The gated fusion head: L2-normalised features masked by presence,
    projections, tanh branches, a sigmoid gate that sees both projections and
    the flags, a fallback where a modality is absent, then
    LayerNorm -> Linear -> GELU -> Dropout(0.2) -> Linear (``cls.0/1/4``).
    ``drop_mask`` is the boolean keep mask of the dropout (training)."""
    tfeat = F.normalize(tfeat, dim=-1) * text_present[:, None]
    vfeat = F.normalize(vfeat, dim=-1) * image_present[:, None]
    tp = linear(pr, tfeat, P, "proj_t")
    vp = linear(pr, vfeat, P, "proj_i")
    zt = torch.tanh(linear(pr, tp, P, "g_t"))
    zi = torch.tanh(linear(pr, vp, P, "g_i"))
    presence = torch.stack([text_present, image_present], dim=1)
    g = torch.sigmoid(linear(pr, torch.cat([tp, vp, presence], dim=1), P, "gate"))
    fused = torch.where((image_present < 0.5)[:, None], zt,
                        torch.where((text_present < 0.5)[:, None], zi, g * zt + (1 - g) * zi))
    fused = ln(fused, P, "ln_fused", 1e-5)
    feat = torch.cat([fused, tp, vp, (tp - vp).abs(), tp * vp], dim=1)
    y = F.gelu(linear(pr, ln(feat, P, "cls.0", 1e-5), P, "cls.1"))
    if drop_mask is not None:
        y = torch.where(drop_mask, y / 0.8, torch.zeros_like(y))
    return linear(pr, y, P, "cls.4")


def logits(cfg, P, batch, lowp: Optional[str] = None, drop_mask=None) -> torch.Tensor:
    """Logits [B, labels] of a batch {ids, mask, pixels (normalised fp32
    NCHW), text_present, image_present}."""
    pr = Precision(lowp)
    tfeat, vfeat = FEATURES[cfg["family"]](pr, cfg, P, batch["ids"], batch["mask"],
                                           batch["pixels"])
    return fusion_head(pr, P, tfeat, vfeat, batch["text_present"], batch["image_present"],
                       drop_mask)


def bce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy over every element."""
    return -(y * F.logsigmoid(x) + (1 - y) * F.logsigmoid(-x)).mean()


def as_fp32(sd: Dict[str, torch.Tensor], requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """A float32 copy of a state dict (the reference's own weights)."""
    out = {}
    for k, t in sd.items():
        c = t.detach().to(torch.float32, copy=True)
        out[k] = c.requires_grad_(requires_grad)
    return out

