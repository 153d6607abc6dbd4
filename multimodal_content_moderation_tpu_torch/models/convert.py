"""Reference / HF torch state dict -> the port's parameter trees.

Layout conventions handled here, once, at load time:
- torch ``nn.Linear.weight`` is (out, in) -> transposed to (in, out)
- the patch-embedding ``Conv2d.weight`` (d, C, p, p) -> (C*p*p, d), the
  channel-major patch ordering of the uint8 wire rows
- the SigLIP MAP head's ``nn.MultiheadAttention.in_proj_weight`` (3d, d)
  -> q/k/v dense params

Prefixes: the reference fusion checkpoint keeps the encoder under
``backbone.*`` and the head modules at the top level; the multi-task one
keeps CLIP's bare towers under ``tower_txt.*`` / ``tower_img.*`` and a
shared SigLIP or generic backbone under ``backbone.*`` (a generic backbone
in ``VisionTextDualEncoderModel`` names, read by
``models/generic.generic_params_from_torch``).

``model.safetensors`` is read with the ``safetensors`` package where it is
installed, else with ``read_safetensors``, a reader of the format built from
the standard library, so a checkpoint loads on a machine without the package;
``write_safetensors`` writes one (``models/export.py``) without it.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Union

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models.clip import CLIPConfig
from multimodal_content_moderation_tpu_torch.models.siglip import SigLIPConfig
from multimodal_content_moderation_tpu_torch.models.params import map_leaves


def _t(x) -> torch.Tensor:
    """torch tensor or ndarray -> an owned CPU tensor (a copy, so a later
    in-place update of the source cannot reach the converted tree)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def _linear(sd: Dict, name: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{name}.weight"]).t().contiguous()}
    if bias:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _ln(sd: Dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _encoder_layers(sd: Dict, prefix: str, num_layers: int) -> list:
    layers = []
    for i in range(num_layers):
        b = f"{prefix}.layers.{i}"
        layers.append(
            {
                "ln1": _ln(sd, f"{b}.layer_norm1"),
                "attn": {
                    "q": _linear(sd, f"{b}.self_attn.q_proj"),
                    "k": _linear(sd, f"{b}.self_attn.k_proj"),
                    "v": _linear(sd, f"{b}.self_attn.v_proj"),
                    "o": _linear(sd, f"{b}.self_attn.out_proj"),
                },
                "ln2": _ln(sd, f"{b}.layer_norm2"),
                "fc1": _linear(sd, f"{b}.mlp.fc1"),
                "fc2": _linear(sd, f"{b}.mlp.fc2"),
            }
        )
    return layers


def _conv_patch_embed(sd: Dict, name: str, bias: bool) -> dict:
    w = _t(sd[f"{name}.weight"])  # (d, C, p, p)
    p = {"w": w.reshape(w.shape[0], -1).t().contiguous()}
    if bias:
        p["b"] = _t(sd[f"{name}.bias"])
    return p


def _strip_prefix(sd: Dict, prefix: str) -> Dict:
    if not prefix:
        return dict(sd)
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def clip_text_tower_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "text_model.") -> dict:
    t = _strip_prefix(sd, prefix)
    return {
        "token_embedding": _t(t["embeddings.token_embedding.weight"]),
        "position_embedding": _t(t["embeddings.position_embedding.weight"]),
        "layers": _encoder_layers(t, "encoder", cfg.text.num_layers),
        "final_ln": _ln(t, "final_layer_norm"),
    }


def clip_vision_tower_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "vision_model.") -> dict:
    v = _strip_prefix(sd, prefix)
    return {
        "class_embedding": _t(v["embeddings.class_embedding"]),
        "patch_embedding": _conv_patch_embed(v, "embeddings.patch_embedding", bias=False),
        "position_embedding": _t(v["embeddings.position_embedding.weight"]),
        # NB: HF spells it "pre_layrnorm"
        "pre_ln": _ln(v, "pre_layrnorm"),
        "layers": _encoder_layers(v, "encoder", cfg.vision.num_layers),
        "post_ln": _ln(v, "post_layernorm"),
    }


def clip_params_from_torch(sd: Dict, cfg: CLIPConfig, prefix: str = "") -> dict:
    """Full CLIPModel state dict -> parameter tree (with projections)."""
    s = _strip_prefix(sd, prefix)
    out = {
        "text_model": clip_text_tower_from_torch(s, cfg),
        "vision_model": clip_vision_tower_from_torch(s, cfg),
        "text_projection": _linear(s, "text_projection", bias=False),
        "visual_projection": _linear(s, "visual_projection", bias=False),
    }
    if "logit_scale" in s:
        out["logit_scale"] = _t(s["logit_scale"]).reshape(())
    return out


def siglip_params_from_torch(sd: Dict, cfg: SigLIPConfig, prefix: str = "") -> dict:
    """Full SiglipModel state dict -> parameter tree."""
    s = _strip_prefix(sd, prefix)
    t = _strip_prefix(s, "text_model.")
    out = {
        "text_model": {
            "token_embedding": _t(t["embeddings.token_embedding.weight"]),
            "position_embedding": _t(t["embeddings.position_embedding.weight"]),
            "layers": _encoder_layers(t, "encoder", cfg.text.num_layers),
            "final_ln": _ln(t, "final_layer_norm"),
            "head": _linear(t, "head"),
        },
        "vision_model": siglip_vision_from_torch(s, cfg.vision.num_layers),
    }
    # HF SigLIP stores these as shape-(1,) parameters: scalars here
    for name in ("logit_scale", "logit_bias"):
        if name in s:
            out[name] = _t(s[name]).reshape(())
    return out


def siglip_vision_from_torch(sd: Dict, num_layers: int, prefix: str = "vision_model.") -> dict:
    """A SigLIP vision tower (``SiglipVisionTransformer`` names under
    ``prefix``) -> its parameter tree."""
    v = _strip_prefix(sd, prefix)
    in_w = _t(v["head.attention.in_proj_weight"])  # (3d, d)
    in_b = _t(v["head.attention.in_proj_bias"])  # (3d,)
    d = in_w.shape[1]
    attn = {
        n: {"w": in_w[i * d : (i + 1) * d].t().contiguous(), "b": in_b[i * d : (i + 1) * d].clone()}
        for i, n in enumerate(("q", "k", "v"))
    }
    attn["o"] = _linear(v, "head.attention.out_proj")
    return {
        "patch_embedding": _conv_patch_embed(v, "embeddings.patch_embedding", bias=True),
        "position_embedding": _t(v["embeddings.position_embedding.weight"]),
        "layers": _encoder_layers(v, "encoder", num_layers),
        "post_ln": _ln(v, "post_layernorm"),
        "map_head": {
            "probe": _t(v["head.probe"]),
            "attn": attn,
            "ln": _ln(v, "head.layernorm"),
            "fc1": _linear(v, "head.mlp.fc1"),
            "fc2": _linear(v, "head.mlp.fc2"),
        },
    }


def fusion_head_from_torch(sd: Dict) -> dict:
    """Reference MultiModalFusionClassifier head; ``cls`` Sequential indices:
    0=LayerNorm, 1=Linear, 4=Linear."""
    return {
        "proj_t": _linear(sd, "proj_t"),
        "proj_i": _linear(sd, "proj_i"),
        "g_t": _linear(sd, "g_t"),
        "g_i": _linear(sd, "g_i"),
        "gate": _linear(sd, "gate"),
        "ln_fused": _ln(sd, "ln_fused"),
        "cls_ln": _ln(sd, "cls.0"),
        "cls_fc1": _linear(sd, "cls.1"),
        "cls_fc2": _linear(sd, "cls.4"),
    }


def fusion_model_from_torch(
    sd: Dict, backend: str, clip_cfg: Optional[CLIPConfig] = None,
    siglip_cfg: Optional[SigLIPConfig] = None, generic_cfg=None, deepseek_cfg=None,
) -> dict:
    """Full reference fusion checkpoint (backbone.* + head): CLIP, generic,
    DeepSeek-V2 (``models/deepseek_v2.deepseek_v2_params_from_torch``, its
    text tower converted on the state dict's device) or the SigLIP family
    ("siglip", "auto"); another name raises."""
    from multimodal_content_moderation_tpu_torch.models.fusion import _check_backend

    backend = _check_backend(backend)
    if backend == "deepseek_v2":
        from multimodal_content_moderation_tpu_torch.models.deepseek_v2 import (
            deepseek_v2_params_from_torch,
        )

        backbone = deepseek_v2_params_from_torch(sd, deepseek_cfg, prefix="backbone.")
    elif backend == "clip":
        backbone = clip_params_from_torch(sd, clip_cfg, prefix="backbone.")
    elif backend == "generic":
        from multimodal_content_moderation_tpu_torch.models.generic import (
            generic_params_from_torch,
        )

        backbone = generic_params_from_torch(sd, generic_cfg, prefix="backbone.")
    else:
        backbone = siglip_params_from_torch(sd, siglip_cfg, prefix="backbone.")
    return {"backbone": backbone, "head": fusion_head_from_torch(sd)}


def mtl_head_from_torch(sd: Dict, num_tasks: int) -> dict:
    """Reference MultiTaskClassifier head; ``shared_head`` Sequential index
    1 = Linear; a task head is a bare Linear (``heads.{j}``) or a Sequential
    whose indices 0 and 3 are its Linears; ``log_vars`` where the head
    learns its task weights."""
    params = {
        "proj_t": _linear(sd, "proj_t"),
        "proj_i": _linear(sd, "proj_i"),
        "g_t": _linear(sd, "g_t"),
        "g_i": _linear(sd, "g_i"),
        "gate": _linear(sd, "gate"),
        "shared_fc": _linear(sd, "shared_head.1"),
    }
    params["heads"] = [
        {"fc": _linear(sd, f"heads.{j}")}
        if f"heads.{j}.weight" in sd
        else {"fc1": _linear(sd, f"heads.{j}.0"), "fc2": _linear(sd, f"heads.{j}.3")}
        for j in range(num_tasks)
    ]
    if "log_vars" in sd:
        params["log_vars"] = _t(sd["log_vars"])
    return params


def mtl_model_from_torch(
    sd: Dict, backend: str, num_tasks: int, clip_cfg: Optional[CLIPConfig] = None,
    siglip_cfg: Optional[SigLIPConfig] = None, generic_cfg=None,
) -> dict:
    """Full reference multi-task checkpoint: CLIP keeps its bare towers under
    ``tower_txt.text_model.*`` and ``tower_img.vision_model.*``; the shared
    SigLIP backbone ("auto", "siglip") and the generic one lie under
    ``backbone.*``, the generic one read without its projections and
    ``logit_scale`` (the multi-task model pools the raw towers). The
    multi-task head has no deepseek_v2 backbone."""
    if backend == "deepseek_v2":
        raise NotImplementedError("the multi-task head has no deepseek_v2 backbone")
    if backend == "clip":
        backbone = {
            "text_model": clip_text_tower_from_torch(
                sd, clip_cfg, prefix="tower_txt.text_model."
            ),
            "vision_model": clip_vision_tower_from_torch(
                sd, clip_cfg, prefix="tower_img.vision_model."
            ),
        }
    elif backend == "generic":
        from multimodal_content_moderation_tpu_torch.models.generic import (
            generic_params_from_torch,
        )

        backbone = generic_params_from_torch(sd, generic_cfg, prefix="backbone.")
        for name in ("text_projection", "visual_projection", "logit_scale"):
            backbone.pop(name, None)
    else:
        backbone = siglip_params_from_torch(sd, siglip_cfg, prefix="backbone.")
    return {"backbone": backbone, "head": mtl_head_from_torch(sd, num_tasks)}


# safetensors dtype names -> numpy types, little-endian as the format stores
# them (BF16 has no numpy type: it goes through torch)
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
    """A .safetensors file -> {name: array}: an 8-byte little-endian header
    length, a JSON header (each tensor's ``dtype``, ``shape`` and
    ``data_offsets`` into the data that follows; ``__metadata__`` skipped),
    then the raw little-endian data. Every dtype comes back as
    ``safetensors.numpy.load_file`` gives it, a numpy array of that type,
    except BF16, which numpy lacks: a ``torch.bfloat16`` tensor. The arrays
    are views of one buffer read from the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if info["dtype"] == "BF16":
            itemsize = 2
        elif info["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[info["dtype"]])
            itemsize = dt.itemsize
        else:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read here")
        if end - start != count * itemsize or not 0 <= start <= end <= len(data):
            raise ValueError(f"{path}: {name} has data_offsets {info['data_offsets']} for "
                             f"{info['dtype']} {list(shape)}")
        if info["dtype"] == "BF16":
            out[name] = (torch.frombuffer(data, dtype=torch.bfloat16, count=count, offset=start)
                         if count else torch.empty(0, dtype=torch.bfloat16)).reshape(shape)
        else:
            out[name] = np.frombuffer(data, dtype=dt, count=count, offset=start).reshape(shape)
    return out


def write_safetensors(sd: Dict[str, Union[np.ndarray, torch.Tensor]], path: str) -> str:
    """{name: array or tensor} -> a .safetensors file of F32 tensors (what
    the JAX package's export writes), with the standard library and numpy:
    an 8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and data offsets (names sorted), padded with spaces to 8
    bytes, then the raw little-endian data."""
    header, blobs, offset = {}, [], 0
    for name in sorted(sd):
        x = sd[name]
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        raw = np.ascontiguousarray(x, "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(x)),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return path


def load_safetensors(path: str) -> Dict[str, Union[np.ndarray, torch.Tensor]]:
    """Load a .safetensors file into a state dict of numpy arrays: with
    ``safetensors.numpy`` where the package is installed, else with
    ``read_safetensors`` (which also reads BF16, as torch tensors)."""
    try:
        from safetensors.numpy import load_file
    except ImportError:
        return read_safetensors(path)
    return load_file(path)


def to_dtype(tree, dtype: torch.dtype):
    """Cast every floating leaf of a nested dict/list of tensors."""
    return map_leaves(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
