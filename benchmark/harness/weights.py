"""Random weights of a configuration in the reference (Hugging Face) layout,
drawn on the device from the run's seed, in the dtype the cell runs them in,
as views of one buffer. The leaves are the configuration's family's
(``families/<family>.py``: ``backbone_spec``, built with the helpers here)
and the fusion head's (``head_spec``). Consecutive leaves are drawn in
groups of at most ``CHUNK`` elements: each group one normal draw in fp32,
cut into leaves and scaled in place (dense weights by 1/sqrt(fan in),
embeddings by 0.02, LayerNorm scales around 1, biases small), cast into the
buffer and freed, so a draw holds the model in its dtype and one group in
fp32. Group 0 draws from the seed itself, group k from (seed, k). The same
seed gives the same weights, so the reference draws them again after the
window instead of keeping a copy beside the program's."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import spec as bench_spec

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, kind, scale

CHUNK = 2 ** 29  # elements a group draws at once: 2 GiB in fp32


def add_ln(spec, name, d):
    spec += [(f"{name}.weight", (d,), "ones", 0.02), (f"{name}.bias", (d,), "normal", 0.02)]


def add_linear(spec, name, d_in, d_out, bias=True):
    spec.append((f"{name}.weight", (d_out, d_in), "normal", d_in ** -0.5))
    if bias:
        spec.append((f"{name}.bias", (d_out,), "normal", 0.02))


def add_encoder(spec, prefix, c):
    """A pre-LN encoder's layers under ``{prefix}.encoder.layers.<i>`` with
    CLIP's and SigLIP's names."""
    d, f = c["hidden_size"], c["intermediate_size"]
    for i in range(c["num_hidden_layers"]):
        b = f"{prefix}.encoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            add_linear(spec, f"{b}.self_attn.{p}", d, d)
        add_ln(spec, f"{b}.layer_norm1", d)
        add_linear(spec, f"{b}.mlp.fc1", d, f)
        add_linear(spec, f"{b}.mlp.fc2", f, d)
        add_ln(spec, f"{b}.layer_norm2", d)


def head_spec(cfg, feature_dim: int) -> Spec:
    f = cfg["head"]["fusion_dim"]
    labels = len(cfg["head"]["class_names"])
    s: Spec = []
    add_linear(s, "proj_t", feature_dim, f)
    add_linear(s, "proj_i", feature_dim, f)
    add_linear(s, "g_t", f, f)
    add_linear(s, "g_i", f, f)
    add_linear(s, "gate", 2 * f + 2, f)
    add_ln(s, "ln_fused", f)
    add_ln(s, "cls.0", 5 * f)
    add_linear(s, "cls.1", 5 * f, f)
    add_linear(s, "cls.4", f, labels)
    return s


def spec(cfg) -> Spec:
    family = bench_spec.family(cfg)
    return family.backbone_spec(cfg) + head_spec(cfg, family.feature_dim(cfg))


def groups(sizes: List[int]) -> List[Tuple[int, int]]:
    """[first, end) leaf ranges of consecutive leaves of at most ``CHUNK``
    elements together; a larger leaf is a group of its own."""
    out, first, n = [], 0, 0
    for i, size in enumerate(sizes):
        if i > first and n + size > CHUNK:
            out.append((first, i))
            first, n = i, 0
        n += size
    out.append((first, len(sizes)))
    return out


def _generator(seed: int, group: int, device) -> torch.Generator:
    s = int(seed) % (1 << 63)
    if group:
        s = int(np.random.SeedSequence([s, group]).generate_state(1, np.uint64)[0]) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


def _draw_group(leaves: Spec, starts: List[int], seed: int, group: int, device) -> torch.Tensor:
    """One group's leaves (``starts``: their offsets and the end) drawn in
    fp32 and scaled in place; no view of it outlives the call."""
    buf = torch.randn(starts[-1] - starts[0], generator=_generator(seed, group, device),
                      device=device, dtype=torch.float32)
    for (_, _, kind, scale), a, b in zip(leaves, starts, starts[1:]):
        t = buf[a - starts[0]:b - starts[0]]
        if kind == "const":
            t.fill_(scale)
        else:
            t.mul_(scale)
            if kind == "ones":
                t.add_(1.0)
    return buf


def draw_leaves(leaves: Spec, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} of ``leaves`` on ``device`` in ``dtype``, all views of
    one buffer."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in leaves]
    starts = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).tolist()
    flat = torch.empty(starts[-1], device=device, dtype=dtype)
    with torch.no_grad():
        for k, (first, end) in enumerate(groups(sizes)):
            flat[starts[first]:starts[end]].copy_(
                _draw_group(leaves[first:end], starts[first:end + 1], seed, k, device))
    return {name: flat[starts[i]:starts[i + 1]].view(shape)
            for i, (name, shape, _, _) in enumerate(leaves)}


def draw(cfg, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the configuration's fusion checkpoint on ``device``
    in ``dtype``, all views of one buffer."""
    return draw_leaves(spec(cfg), seed, device, dtype)
