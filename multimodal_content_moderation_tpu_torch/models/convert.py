"""Reference checkpoint (a torch state dict) -> the port's parameter trees.

The reference fusion checkpoint keeps the encoder under ``backbone.*`` and
the head modules at the top level; the multi-task one keeps CLIP's bare
towers under ``tower_txt.*`` / ``tower_img.*`` and a shared SigLIP or
generic backbone under ``backbone.*``. The heads are read here; each
family's module reads its encoder's Hugging Face names (torch
``nn.Linear.weight`` (out, in) transposed to (in, out), a patch
``Conv2d.weight`` (d, C, p, p) to (C*p*p, d), the channel-major rows of the
uint8 wire, SigLIP's MAP-head ``in_proj_weight`` split into q / k / v),
through ``models/backbones.py``.

``model.safetensors`` is read with the ``safetensors`` package where it is
installed, else with ``read_safetensors``, a reader of the format built from
the standard library, so a checkpoint loads on a machine without the package;
``write_safetensors`` writes one (``models/export.py``) without it.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Union

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.models.backbones import backbone, multitask
from multimodal_content_moderation_tpu_torch.models.params import _linear, _ln, _t, map_leaves


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


def fusion_model_from_torch(sd: Dict, backend: str, encoder_cfg=None) -> dict:
    """Full reference fusion checkpoint (backbone.* + head) of a backend's
    family, its encoder read by ``Backbone.from_torch`` with ``encoder_cfg``
    (DeepSeek-V2's text tower converted on the state dict's device); another
    name raises."""
    return {"backbone": backbone(backend).from_torch(sd, encoder_cfg, "backbone."),
            "head": fusion_head_from_torch(sd)}


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


def mtl_model_from_torch(sd: Dict, backend: str, num_tasks: int, encoder_cfg=None) -> dict:
    """Full reference multi-task checkpoint (its family's
    ``MultiTask.from_torch``): CLIP keeps its bare towers under
    ``tower_txt.text_model.*`` and ``tower_img.vision_model.*``; the shared
    SigLIP backbone ("auto", "siglip") and the generic one lie under
    ``backbone.*``, the generic one read without its projections and
    ``logit_scale`` (the multi-task model pools the raw towers). A family
    without a multi-task backbone (deepseek_v2) raises."""
    return {"backbone": multitask(backend).from_torch(sd, encoder_cfg),
            "head": mtl_head_from_torch(sd, num_tasks)}


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
