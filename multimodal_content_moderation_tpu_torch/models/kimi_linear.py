"""Kimi-Linear (``moonshotai/Kimi-Linear-48B-A3B-Instruct``) as the text
tower of the fusion classifier, beside a SigLIP vision tower
(``models/siglip.py``).

The text tower is HF ``KimiLinearModel`` (``modeling_kimi.py``), pooled as
DeepSeek-V2's is (``models/deepseek_v2.py``): the final RMSNorm at each
row's last kept token, a bias-free ``text_projection``, no ``lm_head``. Per
decoder layer:

    h = RMSNorm(x); x = x + Attn(h); h = RMSNorm(x); x = x + MLP(h)

- Attn: Kimi Delta Attention (``ops/kda.py``) in the layers the config's
  ``linear_attn_config.kda_layers`` lists (1-indexed), MLA with NoPE
  (``deepseek_v2.mla`` without the rotation, scale q_head_dim^-0.5) in its
  ``full_attn_layers``. A KDA layer: q~, k~, v~ = x W_q, x W_k, x W_v; the
  decay's pre-activation f_b(f_a(x)), beta's logits x W_b, the output
  gate's g_b(g_a(x)); the core; ``o_proj``.
- MLP: a SwiGLU of ``intermediate_size`` in the first
  ``first_k_dense_replace`` layers, then the expert layer
  (``ops/moe.py``, the sigmoid ``Router``): the router over all
  ``n_router`` experts, the ``n_held`` from ``first_expert`` that this card
  holds (expert parallelism's share; the whole layer where they are all
  held), and the shared expert.
- RMSNorm: an fp32 mean of squares, times the weight, rounded once (eps
  ``rms_norm_eps``).

Every token-wise step runs on the kept tokens alone, packed as DeepSeek-V2's
are (``deepseek_v2.pack``); the KDA core's rows are built on the card from
the mask (``ops/kda.rows``).

Parameters: ``text_model`` {``embed_tokens``, ``layers`` [{``input_ln``,
``attn``, ``post_ln``, ``mlp``}], ``norm``}, ``text_projection``,
``vision_model`` (SigLIP's). A KDA layer's ``attn``: ``qkv`` (q_proj,
k_proj, v_proj side by side), ``small`` (f_a_proj, g_a_proj, b_proj side by
side), ``f_b``, ``g_b``, ``conv`` [3 C, 4] (the three convolutions),
``A_log`` [H], ``dt_bias`` [C], ``o_norm``, ``o``; an MLA layer's as
DeepSeek-V2's. An expert layer's ``gate`` holds ``w`` (d, n_router) and
``bias`` (the score-correction bias), ``experts`` the held experts stacked
as ``ops/moe.py`` lays them out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models.clip import _normal
from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import (
    _experts,
    _experts_to_torch,
    _leaf,
    _linear_in_out,
    _mla_from_torch,
    _mla_init,
    _mla_to_torch,
    _ones,
    _split_out,
    _swiglu_from_torch,
    _swiglu_init,
    _swiglu_to_torch,
    _w,
    decoder_features,
    mla,
)
from multimodal_content_moderation_tpu_torch.models.siglip import (
    SigLIPVisionConfig,
    siglip_vision_from_torch,
    siglip_vision_init,
    siglip_vision_to_torch,
)
from multimodal_content_moderation_tpu_torch.ops import kda
from multimodal_content_moderation_tpu_torch.ops.layers import dense
from multimodal_content_moderation_tpu_torch.ops.moe import Router
from multimodal_content_moderation_tpu_torch.utils.profiling import count

# the published linear_attn_config's layer lists, 1-indexed
_FULL = (4, 8, 12, 16, 20, 24, 27)


@dataclasses.dataclass(frozen=True)
class KimiLinearTextConfig:
    """The text tower's shape (HF ``KimiLinearConfig`` names, shortened as
    the port's other configs; Kimi-Linear-48B-A3B's values by default, every
    expert held). ``kda_layers`` is 0-indexed."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    num_layers: int = 27
    num_heads: int = 32  # MLA's
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    n_router: int = 256  # the router's outputs: the published expert count
    n_held: int = 256  # the experts this card holds, from first_expert
    first_expert: int = 0
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kda_layers: Tuple[int, ...] = tuple(i for i in range(27) if i + 1 not in _FULL)
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4
    rms_norm_eps: float = 1e-5
    compute_dtype: str = "float32"
    attention_impl: str = "xla"
    scores_dtype: str = "float32"

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """NoPE MLA: q_head_dim^-0.5, no YaRN mscale."""
        return self.q_head_dim ** -0.5

    def is_kda(self, layer: int) -> bool:
        return layer in self.kda_layers

    def is_moe(self, layer: int) -> bool:
        return (self.n_router > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> int:
        return sum(self.is_moe(i) for i in range(self.num_layers))

    @property
    def router(self) -> Router:
        return Router(sigmoid=True, first=self.first_expert)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    """The Kimi-Linear text tower beside a SigLIP vision tower; both towers'
    features are ``projection_dim`` wide."""

    text: KimiLinearTextConfig = KimiLinearTextConfig()
    vision: SigLIPVisionConfig = SigLIPVisionConfig()
    projection_dim: int = 768

    @staticmethod
    def published_siglip2_224() -> "KimiLinearConfig":
        """moonshotai/Kimi-Linear-48B-A3B-Instruct whole beside
        google/siglip2-base-patch16-224's vision tower."""
        return KimiLinearConfig()

    @staticmethod
    def from_dict(d: Dict) -> "KimiLinearConfig":
        """An encoder ``config.json``: HF ``KimiLinearConfig`` keys under
        ``text_config`` (``num_experts`` the experts held, from
        ``first_held_expert``, of ``num_experts_published``, the router's
        width, where those are given), SigLIP's under ``vision_config``,
        ``projection_dim``. Raises on a variant the tower does not compute
        (q LoRA, rotary MLA, another router or unrenormalised weights,
        expert groups, a layer that is neither KDA nor full attention)."""
        t, v = d.get("text_config", {}), d.get("vision_config", {})
        refused = ((t.get("q_lora_rank") is not None, "q_lora_rank", "None"),
                   (t.get("mla_use_nope", True) is not True, "mla_use_nope", "True"),
                   (t.get("moe_router_activation_func", "sigmoid") != "sigmoid",
                    "moe_router_activation_func", "'sigmoid'"),
                   (t.get("moe_renormalize", True) is not True, "moe_renormalize", "True"),
                   ((t.get("num_expert_group") or 1) != 1 or (t.get("topk_group") or 1) != 1,
                    "num_expert_group", "1 (one group)"),
                   (t.get("hidden_act", "silu") != "silu", "hidden_act", "'silu'"),
                   (t.get("rope_scaling") is not None, "rope_scaling", "None (NoPE)"),
                   (bool(t.get("mla_use_output_gate")), "mla_use_output_gate", "False"))
        for bad, key, want in refused:
            if bad:
                raise NotImplementedError(f"kimi_linear: {key} {t.get(key)!r} is not supported "
                                          f"(want {want})")
        base = KimiLinearTextConfig()
        layers = t.get("num_hidden_layers", base.num_layers)
        lin = t.get("linear_attn_config") or {}
        kda_1 = lin.get("kda_layers", [i + 1 for i in base.kda_layers])
        full_1 = lin.get("full_attn_layers", list(_FULL))
        if sorted(list(kda_1) + list(full_1)) != list(range(1, layers + 1)):
            raise NotImplementedError("kimi_linear: linear_attn_config's kda_layers and "
                                      "full_attn_layers must cover the layers once each")
        held = t.get("num_experts", base.n_held) or 0
        text = KimiLinearTextConfig(
            vocab_size=t.get("vocab_size", base.vocab_size),
            hidden_size=t.get("hidden_size", base.hidden_size),
            num_layers=layers,
            num_heads=t.get("num_attention_heads", base.num_heads),
            intermediate_size=t.get("intermediate_size", base.intermediate_size),
            moe_intermediate_size=t.get("moe_intermediate_size", base.moe_intermediate_size),
            n_router=t.get("num_experts_published", held),
            n_held=held,
            first_expert=t.get("first_held_expert", 0),
            num_experts_per_tok=t.get("num_experts_per_token", base.num_experts_per_tok),
            n_shared_experts=t.get("num_shared_experts") or 0,
            first_k_dense_replace=t.get("first_k_dense_replace", base.first_k_dense_replace),
            moe_layer_freq=t.get("moe_layer_freq", base.moe_layer_freq),
            routed_scaling_factor=float(t.get("routed_scaling_factor", 1.0)),
            kv_lora_rank=t.get("kv_lora_rank", base.kv_lora_rank),
            qk_nope_head_dim=t.get("qk_nope_head_dim", base.qk_nope_head_dim),
            qk_rope_head_dim=t.get("qk_rope_head_dim", base.qk_rope_head_dim),
            v_head_dim=t.get("v_head_dim", base.v_head_dim),
            kda_layers=tuple(sorted(i - 1 for i in kda_1)),
            kda_heads=lin.get("num_heads", base.kda_heads),
            kda_head_dim=lin.get("head_dim", base.kda_head_dim),
            conv_size=lin.get("short_conv_kernel_size", base.conv_size),
            rms_norm_eps=float(t.get("rms_norm_eps", base.rms_norm_eps)),
        )
        if text.conv_size != kda.TAPS:
            raise NotImplementedError(f"kimi_linear: short_conv_kernel_size {text.conv_size} "
                                      f"is not supported (want {kda.TAPS})")
        if not 0 <= text.first_expert <= text.first_expert + text.n_held <= text.n_router:
            raise ValueError(f"kimi_linear: experts [{text.first_expert}, "
                             f"{text.first_expert + text.n_held}) are not inside the router's "
                             f"{text.n_router}")
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
        return KimiLinearConfig(text, vision, d.get("projection_dim", 768))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _kda_init(g, t: KimiLinearTextConfig, dtype) -> dict:
    d, H, hd = t.hidden_size, t.kda_heads, t.kda_head_dim
    C = H * hd
    dev = g.device
    a_log = torch.log(torch.rand(H, generator=g, device=dev) * 15 + 1).to(dtype)
    return {
        "qkv": _w(g, d, 3 * C, dtype),
        "small": _w(g, d, 2 * hd + H, dtype),
        "f_b": _w(g, hd, C, dtype),
        "g_b": _w(g, hd, C, dtype),
        "conv": _normal(g, (3 * C, kda.TAPS), dtype, 0.5),
        "A_log": a_log,
        "dt_bias": _normal(g, (C,), dtype, 0.5),
        "o_norm": _ones(hd, dtype, dev),
        "o": _w(g, C, d, dtype),
    }


def kimi_linear_init(g: torch.Generator, cfg: KimiLinearConfig, dtype=torch.float32) -> dict:
    """Random-init the backbone tree on ``g.device`` (dense weights with
    std 1/sqrt(fan in), the embedding 0.02, norms 1, A_log as log U(1, 16))."""
    t = cfg.text
    d = t.hidden_size
    dev = g.device
    layers = []
    for i in range(t.num_layers):
        attn = _kda_init(g, t, dtype) if t.is_kda(i) else _mla_init(g, t, dtype)
        if t.is_moe(i):
            E, f = t.n_held, t.moe_intermediate_size
            mlp = {
                "gate": {"w": _normal(g, (d, t.n_router), dtype, d ** -0.5),
                         "bias": _normal(g, (t.n_router,), dtype, 0.02)},
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


EXPERT_NAMES = ("w1", "w3", "w2")  # HF KimiMLP's (gate, up, down)


def _kda_from_torch(t: Dict, a: str, H: int) -> dict:
    conv = torch.cat([_leaf(t[f"{a}.{n}_conv1d.weight"]).reshape(-1, kda.TAPS)
                      for n in "qkv"])
    return {
        "qkv": {"w": _linear_in_out(t[f"{a}.q_proj.weight"], t[f"{a}.k_proj.weight"],
                                    t[f"{a}.v_proj.weight"])},
        "small": {"w": _linear_in_out(t[f"{a}.f_a_proj.weight"], t[f"{a}.g_a_proj.weight"],
                                      t[f"{a}.b_proj.weight"])},
        "f_b": {"w": _linear_in_out(t[f"{a}.f_b_proj.weight"])},
        "g_b": {"w": _linear_in_out(t[f"{a}.g_b_proj.weight"])},
        "conv": conv,
        "A_log": _leaf(t[f"{a}.A_log"]).reshape(H).clone(),
        "dt_bias": _leaf(t[f"{a}.dt_bias"]).clone(),
        "o_norm": {"scale": _leaf(t[f"{a}.o_norm.weight"]).clone()},
        "o": {"w": _linear_in_out(t[f"{a}.o_proj.weight"])},
    }


def kimi_linear_params_from_torch(sd: Dict, cfg: KimiLinearConfig, prefix: str = "") -> dict:
    """A state dict in HF names under ``prefix`` (``text_model.`` a
    ``KimiLinearModel`` holding the experts it names, ``text_projection``,
    ``vision_model.`` a SigLIP vision tower) -> the backbone tree, converted
    where its leaves lie, one layer at a time."""
    n = len(prefix)
    s = {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}
    tp = "text_model."
    t = {k[len(tp):]: v for k, v in s.items() if k.startswith(tp)}
    c = cfg.text
    layers = []
    with torch.no_grad():
        for i in range(c.num_layers):
            b = f"layers.{i}"
            a = f"{b}.self_attn"
            attn = _kda_from_torch(t, a, c.kda_heads) if c.is_kda(i) else _mla_from_torch(t, a)
            if c.is_moe(i):
                m = f"{b}.block_sparse_moe"
                mlp = {"gate": {"w": _linear_in_out(t[f"{m}.gate.weight"]),
                                "bias": _leaf(t[f"{m}.gate.e_score_correction_bias"]).clone()},
                       "experts": _experts(t, m, c.n_held, c.first_expert, EXPERT_NAMES)}
                if c.n_shared_experts:
                    mlp["shared"] = _swiglu_from_torch(t, f"{m}.shared_experts")
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


def kimi_linear_to_torch(bp, cfg: KimiLinearConfig, prefix: str = "") -> Dict:
    """The inverse of ``kimi_linear_params_from_torch``: HF names under
    ``prefix``, fp32 CPU tensors (the held experts under their own
    indices)."""
    c = cfg.text
    f32 = lambda x: x.detach().to("cpu", torch.float32)  # noqa: E731
    p = bp["text_model"]
    out = {f"{prefix}text_model.embed_tokens.weight": f32(p["embed_tokens"]),
           f"{prefix}text_model.norm.weight": f32(p["norm"]["scale"])}
    H, hd = c.kda_heads, c.kda_head_dim
    C = H * hd
    for i, layer in enumerate(p["layers"]):
        b = f"{prefix}text_model.layers.{i}"
        a, at = f"{b}.self_attn", layer["attn"]
        if c.is_kda(i):
            for name, w in zip(("q_proj", "k_proj", "v_proj"),
                               _split_out(f32(at["qkv"]["w"]), C, C, C)):
                out[f"{a}.{name}.weight"] = w
            for name, w in zip(("f_a_proj", "g_a_proj", "b_proj"),
                               _split_out(f32(at["small"]["w"]), hd, hd, H)):
                out[f"{a}.{name}.weight"] = w
            out[f"{a}.f_b_proj.weight"] = f32(at["f_b"]["w"]).t().contiguous()
            out[f"{a}.g_b_proj.weight"] = f32(at["g_b"]["w"]).t().contiguous()
            for j, name in enumerate("qkv"):
                out[f"{a}.{name}_conv1d.weight"] = \
                    f32(at["conv"][j * C:(j + 1) * C]).reshape(C, 1, kda.TAPS).contiguous()
            out[f"{a}.A_log"] = f32(at["A_log"]).reshape(1, 1, H, 1).contiguous()
            out[f"{a}.dt_bias"] = f32(at["dt_bias"])
            out[f"{a}.o_norm.weight"] = f32(at["o_norm"]["scale"])
            out[f"{a}.o_proj.weight"] = f32(at["o"]["w"]).t().contiguous()
        else:
            _mla_to_torch(out, a, at, c, f32)
        out[f"{b}.input_layernorm.weight"] = f32(layer["input_ln"]["scale"])
        out[f"{b}.post_attention_layernorm.weight"] = f32(layer["post_ln"]["scale"])
        mlp = layer["mlp"]
        if not c.is_moe(i):
            _swiglu_to_torch(out, f"{b}.mlp", mlp, f32)
            continue
        m = f"{b}.block_sparse_moe"
        out[f"{m}.gate.weight"] = f32(mlp["gate"]["w"]).t().contiguous()
        out[f"{m}.gate.e_score_correction_bias"] = f32(mlp["gate"]["bias"])
        if "shared" in mlp:
            _swiglu_to_torch(out, f"{m}.shared_experts", mlp["shared"], f32)
        _experts_to_torch(out, m, mlp["experts"], f32, c.first_expert, EXPERT_NAMES)
    out[f"{prefix}text_projection.weight"] = f32(bp["text_projection"]["w"]).t().contiguous()
    siglip_vision_to_torch(out, f"{prefix}vision_model", bp["vision_model"], cfg.vision)
    return out


# ---------------------------------------------------------------------------
# the text tower
# ---------------------------------------------------------------------------


def kda_attention(h: torch.Tensor, p, c: KimiLinearTextConfig, src: torch.Tensor,
                  rows: kda.Rows, T: int) -> torch.Tensor:
    """HF ``KimiDeltaAttention`` on packed tokens [N, d]: the projections,
    the core (``ops/kda.kda_core``), ``o_proj``."""
    hd, H = c.kda_head_dim, c.kda_heads
    qkv = dense(h, p["qkv"])
    small = dense(h, p["small"])  # f_a | g_a | beta's logits
    f = dense(small[:, :hd], p["f_b"])
    gate = dense(small[:, hd:2 * hd], p["g_b"])
    o = kda.kda_core(qkv, f, small[:, 2 * hd:], gate, p, rows, src, T, H, hd, c.rms_norm_eps)
    return dense(o, p["o"])


def count_packing(cfg: KimiLinearConfig, mask) -> None:
    """A batch's packing counters from the host's mask (``utils/profiling``):
    ``text.kept_tokens``, ``text.positions``, ``moe.routed_slots`` (every
    slot the router routes, held here or not) and ``kda.chunks`` (each
    row's ceil(kept / 64) chunks in every KDA layer)."""
    m = np.asarray(mask)
    lengths = (m != 0).sum(axis=1)
    kept = int(lengths.sum())
    t = cfg.text
    count("text.kept_tokens", kept)
    count("text.positions", int(m.size))
    count("moe.routed_slots", kept * t.num_experts_per_tok * t.moe_layers)
    count("kda.chunks", int(-(-lengths // kda.CHUNK).sum()) * len(t.kda_layers))


def kimi_text_features(
    params,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    cfg: KimiLinearConfig,
    kept: Optional[int] = None,
    counters: Optional[Dict] = None,
) -> torch.Tensor:
    """Kimi-Linear's text feature (``deepseek_v2.decoder_features``): KDA or
    NoPE MLA a layer, the sigmoid router over the held share;
    ``counters`` also receives ``moe.remote_slots``."""
    c = cfg.text

    def attention(pk, mask, T):
        rows = kda.rows(mask, pk.src, pk.src.shape[0]) if c.kda_layers else None

        def attend(i, h, p):
            if c.is_kda(i):
                return kda_attention(h, p, c, pk.src, rows, T)
            return mla(h, p, c, pk, mask, None, None)

        return attend

    return decoder_features(params, input_ids, attention_mask, c, cfg.projection_dim,
                            attention, c.n_held, kept, counters, c.router, remote=True)
