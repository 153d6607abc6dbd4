"""DeepSeek-V2 (``deepseek-ai/DeepSeek-V2-Lite``) as the text tower of the
fusion classifier, beside a SigLIP vision tower (``models/siglip.py``).

The text tower is HF ``DeepseekV2Model`` (``modeling_deepseek.py``) without
q LoRA, pooled as HF's ``*ForSequenceClassification`` pools a decoder, at
the last kept token, then projected by a bias-free ``text_projection`` as
``VisionTextDualEncoderModel`` projects a tower; a classifier has no
``lm_head``. Per decoder layer:

    h = RMSNorm(x); x = x + MLA(h); h = RMSNorm(x); x = x + MLP(h)

- MLA: ``q_proj`` -> H heads of 192 (128 "nope" + 64 rotary);
  ``kv_a_proj_with_mqa`` -> a 512-wide latent and one 64-wide rotary key
  shared by the heads; RMSNorm of the latent, ``kv_b_proj`` -> each head's
  128-wide k_nope and v; YaRN RoPE on q's and k's rotary parts after HF's
  de-interleave of the pairs; causal attention with the key mask, softmax in
  fp32, scale 192^-0.5 * mscale^2; ``o_proj`` over H * 128.
- MLP: a SwiGLU of width ``intermediate_size`` in the first
  ``first_k_dense_replace`` layers, after them the expert layer
  (``ops/moe.py``: the router, the routed experts, the shared experts).
- RMSNorm: an fp32 mean of squares, times the weight, rounded once
  (``ops/layers.add_rms_norm``; eps ``rms_norm_eps``).

Every token-wise step runs on the kept tokens alone, packed into one [N, d]
tensor (``pack``: indices built on the card from the mask, the count N from
the host's mask, so nothing waits for the card); only the attention
products see the [B, T] layout.

Parameters (``DeepSeekV2Config``'s tree): ``text_model`` {``embed_tokens``
[V, d], ``layers`` [{``input_ln``, ``attn`` {``qkv_a`` (q_proj and
kv_a_proj_with_mqa side by side), ``kv_a_ln``, ``kv_b``, ``o``},
``post_ln``, ``mlp``}], ``norm``}, ``text_projection``, ``vision_model``
(SigLIP's). Dense weights are stored (in, out) as everywhere in the port;
the experts keep HF's (out, in), stacked (``ops/moe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.models.clip import _normal
from multimodal_content_moderation_tpu_torch.models.siglip import (
    SigLIPVisionConfig,
    siglip_vision_from_torch,
    siglip_vision_init,
    siglip_vision_to_torch,
)
from multimodal_content_moderation_tpu_torch.ops.layers import (
    add_rms_norm,
    apply_rope_interleaved,
    dense,
    rms_norm,
    swiglu,
    yarn_rope_tables,
    yarn_softmax_scale,
)
from multimodal_content_moderation_tpu_torch.ops.moe import (
    HALF,
    SOFTMAX,
    Router,
    moe_layer,
    split_gate_up,
)
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count


@dataclasses.dataclass(frozen=True)
class DeepSeekV2TextConfig:
    """The text tower's shape (HF ``DeepseekV2Config`` names, shortened as
    the port's other configs; DeepSeek-V2-Lite's values by default)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_positions: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_positions: int = 163840
    compute_dtype: str = "float32"
    attention_impl: str = "xla"
    scores_dtype: str = "float32"

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        """HF's rule: an expert layer from ``first_k_dense_replace`` on, every
        ``moe_layer_freq``-th."""
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> int:
        return sum(self.is_moe(i) for i in range(self.num_layers))

    @property
    def softmax_scale(self) -> float:
        return yarn_softmax_scale(self.q_head_dim, self.rope_factor, self.rope_mscale_all_dim)


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config:
    """The DeepSeek-V2 text tower beside a SigLIP vision tower; both towers'
    features are ``projection_dim`` wide (the text through
    ``text_projection``, the vision tower's MAP feature as it is)."""

    text: DeepSeekV2TextConfig = DeepSeekV2TextConfig()
    vision: SigLIPVisionConfig = SigLIPVisionConfig()
    projection_dim: int = 768

    @staticmethod
    def lite_siglip2_224() -> "DeepSeekV2Config":
        """deepseek-ai/DeepSeek-V2-Lite beside google/siglip2-base-patch16-224's
        vision tower."""
        return DeepSeekV2Config()

    @staticmethod
    def from_dict(d: Dict) -> "DeepSeekV2Config":
        """An encoder ``config.json``: HF ``DeepseekV2Config`` keys under
        ``text_config``, SigLIP's under ``vision_config``, ``projection_dim``.
        Raises on a variant the tower does not compute (q LoRA, another
        scoring, top-k method or rope scaling, renormalised top-k)."""
        t, v = d.get("text_config", {}), d.get("vision_config", {})
        if t.get("q_lora_rank") is not None:
            raise NotImplementedError("deepseek_v2: q_lora_rank is not supported (V2-Lite has none)")
        for key, want in (("scoring_func", "softmax"), ("topk_method", "greedy"),
                          ("norm_topk_prob", False), ("hidden_act", "silu")):
            if t.get(key, want) != want:
                raise NotImplementedError(f"deepseek_v2: {key} {t[key]!r} is not supported "
                                          f"(want {want!r})")
        rope = t.get("rope_scaling") or {}
        if rope.get("type", "yarn") != "yarn":
            raise NotImplementedError(f"deepseek_v2: rope_scaling {rope!r}: want yarn")
        base = DeepSeekV2TextConfig()
        text = DeepSeekV2TextConfig(
            vocab_size=t.get("vocab_size", base.vocab_size),
            hidden_size=t.get("hidden_size", base.hidden_size),
            num_layers=t.get("num_hidden_layers", base.num_layers),
            num_heads=t.get("num_attention_heads", base.num_heads),
            intermediate_size=t.get("intermediate_size", base.intermediate_size),
            moe_intermediate_size=t.get("moe_intermediate_size", base.moe_intermediate_size),
            n_routed_experts=t.get("n_routed_experts") or 0,
            n_shared_experts=t.get("n_shared_experts") or 0,
            num_experts_per_tok=t.get("num_experts_per_tok", base.num_experts_per_tok),
            first_k_dense_replace=t.get("first_k_dense_replace", base.first_k_dense_replace),
            moe_layer_freq=t.get("moe_layer_freq", base.moe_layer_freq),
            routed_scaling_factor=float(t.get("routed_scaling_factor", 1.0)),
            kv_lora_rank=t.get("kv_lora_rank", base.kv_lora_rank),
            qk_nope_head_dim=t.get("qk_nope_head_dim", base.qk_nope_head_dim),
            qk_rope_head_dim=t.get("qk_rope_head_dim", base.qk_rope_head_dim),
            v_head_dim=t.get("v_head_dim", base.v_head_dim),
            rms_norm_eps=float(t.get("rms_norm_eps", base.rms_norm_eps)),
            rope_theta=float(t.get("rope_theta", base.rope_theta)),
            rope_factor=float(rope.get("factor", 1.0)),
            rope_original_max_positions=int(rope.get(
                "original_max_position_embeddings", base.rope_original_max_positions)),
            rope_beta_fast=float(rope.get("beta_fast", base.rope_beta_fast)),
            rope_beta_slow=float(rope.get("beta_slow", base.rope_beta_slow)),
            rope_mscale=float(rope.get("mscale", 1.0)),
            rope_mscale_all_dim=float(rope.get("mscale_all_dim", 0.0)),
            max_positions=t.get("max_position_embeddings", base.max_positions),
        )
        vb = SigLIPVisionConfig()
        vision = SigLIPVisionConfig(
            hidden_size=v.get("hidden_size", vb.hidden_size),
            num_layers=v.get("num_hidden_layers", vb.num_layers),
            num_heads=v.get("num_attention_heads", vb.num_heads),
            intermediate_size=v.get("intermediate_size", vb.intermediate_size),
            image_size=v.get("image_size", vb.image_size),
            patch_size=v.get("patch_size", vb.patch_size),
            num_channels=v.get("num_channels", vb.num_channels),
            hidden_act=v.get("hidden_act", vb.hidden_act),
            layer_norm_eps=v.get("layer_norm_eps", vb.layer_norm_eps),
        )
        return DeepSeekV2Config(text, vision, d.get("projection_dim", 768))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _ones(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def _w(g, d_in, d_out, dtype):
    return {"w": _normal(g, (d_in, d_out), dtype, d_in ** -0.5)}


def _swiglu_init(g, d, f, dtype):
    return {"gate_up": _w(g, d, 2 * f, dtype), "down": _w(g, f, d, dtype)}


def _mla_init(g, t, dtype) -> dict:
    d, H, r = t.hidden_size, t.num_heads, t.kv_lora_rank
    return {
        "qkv_a": _w(g, d, H * t.q_head_dim + r + t.qk_rope_head_dim, dtype),
        "kv_a_ln": _ones(r, dtype, g.device),
        "kv_b": _w(g, r, H * (t.qk_nope_head_dim + t.v_head_dim), dtype),
        "o": _w(g, H * t.v_head_dim, d, dtype),
    }


def deepseek_v2_init(g: torch.Generator, cfg: DeepSeekV2Config, dtype=torch.float32) -> dict:
    """Random-init the backbone tree on ``g.device`` (dense weights with
    std 1/sqrt(fan in), the embedding 0.02, norms 1)."""
    t = cfg.text
    d = t.hidden_size
    dev = g.device
    layers = []
    for i in range(t.num_layers):
        attn = _mla_init(g, t, dtype)
        if t.is_moe(i):
            E, f = t.n_routed_experts, t.moe_intermediate_size
            mlp = {
                "gate": _w(g, d, E, dtype),
                "experts": {"gate_up": _normal(g, (E, 2 * f, d), dtype, d ** -0.5),
                            "down": _normal(g, (E, d, f), dtype, f ** -0.5)},
            }
            if t.n_shared_experts:
                mlp["shared"] = _swiglu_init(g, d, f * t.n_shared_experts, dtype)
        else:
            mlp = _swiglu_init(g, d, t.intermediate_size, dtype)
        layers.append({"input_ln": _ones(d, dtype, dev), "attn": attn,
                       "post_ln": _ones(d, dtype, dev), "mlp": mlp})
    return {
        "text_model": {"embed_tokens": _normal(g, (t.vocab_size, d), dtype, 0.02),
                       "layers": layers, "norm": _ones(d, dtype, dev)},
        "text_projection": _w(g, d, cfg.projection_dim, dtype),
        "vision_model": siglip_vision_init(g, cfg.vision, dtype),
    }


def _leaf(x) -> torch.Tensor:
    """A state-dict leaf as a tensor where it lies (an array: a CPU tensor)."""
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _linear_in_out(*weights) -> torch.Tensor:
    """HF (out, in) weights side by side as one (in, sum of outs) tensor, on
    their device: one new tensor, no intermediate."""
    ws = [_leaf(w) for w in weights]
    out = torch.empty(ws[0].shape[1], sum(w.shape[0] for w in ws), dtype=ws[0].dtype,
                      device=ws[0].device)
    c = 0
    for w in ws:
        out[:, c:c + w.shape[0]].copy_(w.t())
        c += w.shape[0]
    return out


EXPERT_NAMES = ("gate_proj", "up_proj", "down_proj")  # an HF expert's (gate, up, down)


def _experts(t: Dict, b: str, E: int, first: int = 0, names=EXPERT_NAMES) -> dict:
    """A layer's E experts from ``first`` stacked in place: gate+up [E, 2F,
    d] interleaved by 8 rows, down [E, d, F], copied expert by expert into
    the new tensors."""
    gn, un, dn = names
    g0 = _leaf(t[f"{b}.experts.{first}.{gn}.weight"])
    f, d = g0.shape
    gate_up = torch.empty(E, 2 * f, d, dtype=g0.dtype, device=g0.device)
    down = torch.empty(E, d, f, dtype=g0.dtype, device=g0.device)
    view = gate_up.view(E, f // 8, 2, 8, d)
    for j in range(E):
        e = f"{b}.experts.{first + j}"
        view[j, :, 0].copy_(_leaf(t[f"{e}.{gn}.weight"]).view(f // 8, 8, d))
        view[j, :, 1].copy_(_leaf(t[f"{e}.{un}.weight"]).view(f // 8, 8, d))
        down[j].copy_(_leaf(t[f"{e}.{dn}.weight"]))
    return {"gate_up": gate_up, "down": down}


def _swiglu_from_torch(t: Dict, b: str) -> dict:
    return {"gate_up": {"w": _linear_in_out(t[f"{b}.gate_proj.weight"], t[f"{b}.up_proj.weight"])},
            "down": {"w": _linear_in_out(t[f"{b}.down_proj.weight"])}}


def _mla_from_torch(t: Dict, a: str) -> dict:
    return {
        "qkv_a": {"w": _linear_in_out(t[f"{a}.q_proj.weight"],
                                      t[f"{a}.kv_a_proj_with_mqa.weight"])},
        "kv_a_ln": {"scale": _leaf(t[f"{a}.kv_a_layernorm.weight"]).clone()},
        "kv_b": {"w": _linear_in_out(t[f"{a}.kv_b_proj.weight"])},
        "o": {"w": _linear_in_out(t[f"{a}.o_proj.weight"])},
    }


def deepseek_v2_params_from_torch(sd: Dict, cfg: DeepSeekV2Config, prefix: str = "") -> dict:
    """A state dict in HF names under ``prefix`` (``text_model.`` a
    ``DeepseekV2Model``, ``text_projection``, ``vision_model.`` a SigLIP
    vision tower) -> the backbone tree. The text tower is converted where its
    leaves lie (on the card for a drawn checkpoint), one layer at a time, each
    leaf copied once into its new layout: loading holds the state dict, the
    tree built so far and no more."""
    n = len(prefix)
    s = {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}
    tp = "text_model."
    t = {k[len(tp):]: v for k, v in s.items() if k.startswith(tp)}
    c = cfg.text
    layers = []
    with torch.no_grad():
        for i in range(c.num_layers):
            b = f"layers.{i}"
            attn = _mla_from_torch(t, f"{b}.self_attn")
            if c.is_moe(i):
                mlp = {"gate": {"w": _linear_in_out(t[f"{b}.mlp.gate.weight"])},
                       "experts": _experts(t, f"{b}.mlp", c.n_routed_experts)}
                if c.n_shared_experts:
                    mlp["shared"] = _swiglu_from_torch(t, f"{b}.mlp.shared_experts")
            else:
                mlp = _swiglu_from_torch(t, f"{b}.mlp")
            layers.append({
                "input_ln": {"scale": _leaf(t[f"{b}.input_layernorm.weight"]).clone()},
                "attn": attn,
                "post_ln": {"scale": _leaf(t[f"{b}.post_attention_layernorm.weight"]).clone()},
                "mlp": mlp,
            })
        text = {"embed_tokens": _leaf(t["embed_tokens.weight"]).clone(), "layers": layers,
                "norm": {"scale": _leaf(t["norm.weight"]).clone()}}
        projection = {"w": _linear_in_out(s["text_projection.weight"])}
    return {"text_model": text, "text_projection": projection,
            "vision_model": siglip_vision_from_torch(s, cfg.vision.num_layers)}


def _split_out(w: torch.Tensor, *widths):
    """(in, out) -> HF (out, in) pieces of the given output widths."""
    out, c = [], 0
    for n in widths:
        out.append(w[:, c:c + n].t().contiguous())
        c += n
    return out


def _swiglu_to_torch(out: Dict, name: str, sw, f32) -> None:
    gu = f32(sw["gate_up"]["w"])
    gate, up = _split_out(gu, gu.shape[1] // 2, gu.shape[1] // 2)
    out[f"{name}.gate_proj.weight"] = gate
    out[f"{name}.up_proj.weight"] = up
    out[f"{name}.down_proj.weight"] = f32(sw["down"]["w"]).t().contiguous()


def _mla_to_torch(out: Dict, a: str, at, c, f32) -> None:
    q, kv_a = _split_out(f32(at["qkv_a"]["w"]), c.num_heads * c.q_head_dim,
                         c.kv_lora_rank + c.qk_rope_head_dim)
    out[f"{a}.q_proj.weight"] = q
    out[f"{a}.kv_a_proj_with_mqa.weight"] = kv_a
    out[f"{a}.kv_a_layernorm.weight"] = f32(at["kv_a_ln"]["scale"])
    out[f"{a}.kv_b_proj.weight"] = f32(at["kv_b"]["w"]).t().contiguous()
    out[f"{a}.o_proj.weight"] = f32(at["o"]["w"]).t().contiguous()


def _experts_to_torch(out: Dict, b: str, experts, f32, first: int = 0,
                      names=EXPERT_NAMES) -> None:
    gate, up = split_gate_up(f32(experts["gate_up"]))
    down = f32(experts["down"])
    for j in range(gate.shape[0]):
        e = f"{b}.experts.{first + j}"
        for name, w in zip(names, (gate[j], up[j], down[j])):
            out[f"{e}.{name}.weight"] = w.contiguous()


def deepseek_v2_to_torch(bp, cfg: DeepSeekV2Config, prefix: str = "") -> Dict:
    """The inverse of ``deepseek_v2_params_from_torch``: the text tower,
    ``text_projection`` and SigLIP's vision tower in HF names under
    ``prefix``, fp32 CPU tensors."""
    c = cfg.text
    f32 = lambda x: x.detach().to("cpu", torch.float32)  # noqa: E731
    p = bp["text_model"]
    out = {f"{prefix}text_model.embed_tokens.weight": f32(p["embed_tokens"]),
           f"{prefix}text_model.norm.weight": f32(p["norm"]["scale"])}
    for i, layer in enumerate(p["layers"]):
        b = f"{prefix}text_model.layers.{i}"
        _mla_to_torch(out, f"{b}.self_attn", layer["attn"], c, f32)
        out[f"{b}.input_layernorm.weight"] = f32(layer["input_ln"]["scale"])
        out[f"{b}.post_attention_layernorm.weight"] = f32(layer["post_ln"]["scale"])
        mlp = layer["mlp"]
        swiglus = [(f"{b}.mlp", mlp)] if not c.is_moe(i) else (
            [(f"{b}.mlp.shared_experts", mlp["shared"])] if "shared" in mlp else [])
        for name, sw in swiglus:
            _swiglu_to_torch(out, name, sw, f32)
        if c.is_moe(i):
            out[f"{b}.mlp.gate.weight"] = f32(mlp["gate"]["w"]).t().contiguous()
            _experts_to_torch(out, f"{b}.mlp", mlp["experts"], f32)
    out[f"{prefix}text_projection.weight"] = f32(bp["text_projection"]["w"]).t().contiguous()
    siglip_vision_to_torch(out, f"{prefix}vision_model", bp["vision_model"], cfg.vision)
    return out


# ---------------------------------------------------------------------------
# the text tower
# ---------------------------------------------------------------------------


class Packing(NamedTuple):
    """The kept tokens of a [B, T] mask packed in row order: each one's flat
    position in [B * T] (``src``) and position in its row (``pos``), and
    each row's last kept token in the packed order (``last``; row 0's first
    for a row with none)."""

    src: torch.Tensor
    pos: torch.Tensor
    last: torch.Tensor


def pack(mask: torch.Tensor, kept: int) -> Packing:
    """``Packing`` of ``mask`` [B, T] with ``kept`` nonzero entries, built on
    the mask's device with no read back of it (``kept`` comes from the
    caller: the host's copy of the mask)."""
    B, T = mask.shape
    keep = mask.reshape(-1) != 0
    flat = torch.arange(B * T, device=mask.device)
    # a kept entry's place in the packed order; a pad's a slot of its own past
    # the kept ones, so the scatter has no repeated index
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, kept + flat)
    src = torch.empty(kept + B * T, dtype=torch.long, device=mask.device)
    src = src.scatter_(0, dest, flat)[:kept]
    last = (torch.cumsum(keep.view(B, T).sum(1), 0) - 1).clamp_(min=0)
    return Packing(src, src % T, last)


_ROPE: Dict = {}


def _rope_rows(c: DeepSeekV2TextConfig, pos: torch.Tensor, T: int):
    """YaRN (cos, sin) fp32 [N, rope dim] at the packed tokens' positions;
    the tables are computed once a device and length."""
    key = (str(pos.device), T, c.qk_rope_head_dim, c.rope_theta, c.rope_factor,
           c.rope_original_max_positions, c.rope_beta_fast, c.rope_beta_slow, c.rope_mscale,
           c.rope_mscale_all_dim)
    if key not in _ROPE:
        _ROPE[key] = yarn_rope_tables(c.qk_rope_head_dim, T, c.rope_theta, c.rope_factor,
                                      c.rope_original_max_positions, c.rope_beta_fast,
                                      c.rope_beta_slow, c.rope_mscale, c.rope_mscale_all_dim,
                                      device=pos.device)
    cos, sin = _ROPE[key]
    return cos.index_select(0, pos), sin.index_select(0, pos)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T in fp32 ([B, H, T, d] each): on the card in bf16 one batched
    cuBLAS product with an fp32 result; elsewhere fp32 products of the same
    values."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        B, H, T, d = q.shape
        s = torch.bmm(q.reshape(B * H, T, d), k.reshape(B * H, T, d).transpose(1, 2),
                      out_dtype=torch.float32)
        return s.view(B, H, T, T)
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def attention_packed(q, k, v, pk: Packing, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention with the key mask over packed q, k [N, H, dq] and v
    [N, H, dv]: scattered into [B, H, T, .], scores in fp32 (``_scores``),
    masked, softmax in fp32, the weights rounded to v's dtype, then gathered
    back to [N, H * dv]. The port's plain attention core (counted in
    ``model.attention.plain``)."""
    count("model.attention.plain")
    B, T = mask.shape
    N, H = q.shape[:2]

    def padded(t):
        z = t.new_zeros((B * T,) + t.shape[1:])
        return z.index_copy_(0, pk.src, t).view(B, T, H, -1).transpose(1, 2).contiguous()

    qp, kp, vp = padded(q), padded(k), padded(v)
    s = _scores(qp, kp) * scale
    allowed = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    allowed = allowed[None, None] & (mask != 0)[:, None, None, :]
    s = s.masked_fill(~allowed, torch.finfo(torch.float32).min)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(w, vp)  # [B, H, T, dv]
    return o.transpose(1, 2).reshape(B * T, -1).index_select(0, pk.src)


def mla(h: torch.Tensor, p, c: DeepSeekV2TextConfig, pk: Packing, mask: torch.Tensor,
        cos: Optional[torch.Tensor], sin: Optional[torch.Tensor]) -> torch.Tensor:
    """HF ``DeepseekV2Attention`` without q LoRA on packed tokens [N, d];
    with ``cos`` None the NoPE variant (Kimi-Linear's ``mla_use_nope``): the
    "rotary" columns of q and of the shared key are used as they are. The
    scale is ``c.softmax_scale``."""
    N = h.shape[0]
    H, dn, dr, dv, r = (c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                        c.kv_lora_rank)
    nq = H * (dn + dr)
    with annotate("mla.attention"):
        qa = dense(h, p["qkv_a"])  # q | latent | shared rotary key
        q = qa[:, :nq].view(N, H, dn + dr)
        latent = rms_norm(qa[:, nq:nq + r], p["kv_a_ln"], c.rms_norm_eps)
        if cos is None:
            k_pe, q_pe = qa[:, nq + r:], q[..., dn:]
        else:
            k_pe = apply_rope_interleaved(qa[:, nq + r:], cos, sin)
            q_pe = apply_rope_interleaved(q[..., dn:], cos[:, None], sin[:, None])
        kv = dense(latent, p["kv_b"]).view(N, H, dn + dv)
        qf = torch.cat([q[..., :dn], q_pe], dim=-1)
        kf = torch.cat([kv[..., :dn], k_pe[:, None].expand(N, H, dr)], dim=-1)
        o = attention_packed(qf, kf, kv[..., dn:], pk, mask, c.softmax_scale)
        return dense(o, p["o"])


def count_packing(cfg: DeepSeekV2Config, mask) -> None:
    """A batch's packing counters from the host's mask (``utils/profiling``):
    ``text.kept_tokens``, ``text.positions`` and ``moe.routed_slots``."""
    kept = int(np.asarray(mask).sum())
    count("text.kept_tokens", kept)
    count("text.positions", int(np.asarray(mask).size))
    t = cfg.text
    count("moe.routed_slots", kept * t.num_experts_per_tok * t.moe_layers)


def decoder_features(
    params,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    c,
    projection_dim: int,
    attention: Callable,
    held: int,
    kept: Optional[int] = None,
    counters: Optional[Dict] = None,
    router: Router = SOFTMAX,
    remote: bool = False,
) -> torch.Tensor:
    """The text feature [B, projection_dim] of a sparse pre-norm decoder
    (DeepSeek-V2's, Kimi-Linear's): the layers over the kept tokens, the
    final RMSNorm at each row's last kept token, ``text_projection``.

    ``c`` is the text config (``rms_norm_eps``, ``compute_dtype``,
    ``is_moe``, ``moe_layers``, ``num_experts_per_tok``,
    ``routed_scaling_factor``); ``attention(pk, mask, T)``, called once
    under ``text.pack``, gives the layers' attention ``attend(i, h,
    p_attn)`` on the packed tokens; an expert layer holds ``held`` experts
    and routes with ``router``.

    ``kept`` is the mask's sum where the caller has it on the host (the
    engine); without it it is read from the mask, which waits for the card.
    ``counters`` (a dict) receives, as device scalars summed over the
    expert layers, ``moe.max_expert_slots`` (the largest held expert's
    slots in each layer), ``moe.grouped_pad_rows`` (the rows the grouped
    products compute beyond each expert's slots, at their row granularity
    ``ops/moe.HALF``) and, with ``remote``, ``moe.remote_slots`` (the slots
    routed to experts held elsewhere)."""
    p = params["text_model"]
    B, T = input_ids.shape
    mask = torch.ones_like(input_ids) if attention_mask is None else attention_mask
    dtype = getattr(torch, c.compute_dtype)
    if kept is None:
        kept = int(mask.sum())
    if kept == 0:
        return torch.zeros(B, projection_dim, dtype=dtype, device=input_ids.device)
    with annotate("text.pack"):
        pk = pack(mask, kept)
        x = F.embedding(input_ids.reshape(-1).index_select(0, pk.src),
                        p["embed_tokens"]).to(dtype)
        attend = attention(pk, mask, T)
    hist = slots = None
    if counters is not None and c.moe_layers:
        hist = torch.zeros(c.moe_layers, held, dtype=torch.int32, device=x.device)
        if remote:
            slots = torch.zeros((), dtype=torch.int32, device=x.device)
    delta, m = None, 0
    for i, layer in enumerate(p["layers"]):
        x, h = add_rms_norm(x, delta, layer["input_ln"], c.rms_norm_eps)
        a = attend(i, h, layer["attn"])
        x, h = add_rms_norm(x, a, layer["post_ln"], c.rms_norm_eps)
        if c.is_moe(i):
            delta = moe_layer(h, layer["mlp"], c.num_experts_per_tok, c.routed_scaling_factor,
                              None if hist is None else hist[m], router, slots)
            m += 1
        else:
            delta = swiglu(h, layer["mlp"])
    # the final RMSNorm is token-wise: only the pooled tokens need it
    last_x, last_d = x.index_select(0, pk.last), delta.index_select(0, pk.last)
    y = add_rms_norm(last_x, last_d, p["norm"], c.rms_norm_eps)[1]
    if hist is not None:
        counters["moe.max_expert_slots"] = hist.amax(1).sum()
        counters["moe.grouped_pad_rows"] = (-hist % HALF).sum()
        if slots is not None:
            counters["moe.remote_slots"] = slots
    return dense(y, params["text_projection"])


def deepseek_text_features(
    params,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    cfg: DeepSeekV2Config,
    kept: Optional[int] = None,
    counters: Optional[Dict] = None,
) -> torch.Tensor:
    """DeepSeek-V2's text feature (``decoder_features``): MLA with YaRN
    rotation in every layer, every routed expert held."""
    c = cfg.text

    def attention(pk, mask, T):
        cos, sin = _rope_rows(c, pk.pos, T)
        return lambda i, h, p: mla(h, p, c, pk, mask, cos, sin)

    return decoder_features(params, input_ids, attention_mask, c, cfg.projection_dim,
                            attention, c.n_routed_experts, kept, counters)

