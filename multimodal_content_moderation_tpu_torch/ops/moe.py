"""The sparse expert layer of DeepSeek-V2 (HF ``DeepseekV2MoE``): a router
over E experts, each token's top-k of them, and shared experts that every
token runs.

    logits = x W_gate (fp32 products of the activations)
    p = softmax(logits) (fp32); the k largest, ties to the lower expert; the
        weights are those probabilities (not renormalised) times
        ``scaling``
    y_j = bf16(w_j * down_e(bf16(silu(gate_e(x)) * up_e(x))))   (e the j-th expert)
    out = bf16(sum_j y_j + shared(x))   (fp32 sum in top-k order)

``p = {"gate": {"w": (d, E)}, "experts": {"gate_up": [E, 2F, d],
"down": [E, d, F]}, "shared": {"gate_up", "down"}}``: the experts keep HF's
(out, in) layout, stacked, with each expert's gate and up rows interleaved
by 8 (``split_gate_up`` undoes it); the shared experts are one SwiGLU of width
n_shared * F (``ops/layers.swiglu``).

On the card in bf16 with gradients off (``ops/layers.fused``), the layer
is the launches of ``csrc/moe.cu`` (the tokens laid out contiguous first;
a shape the kernels do not take raises, ``takes``): the gate
product (cuBLAS, fp32 out), ``moe_route`` (softmax, top-k, the per-expert
counts and the permutation of the slots, all on the card: nothing waits
for the host), ``moe_grouped`` twice (gate+up with the SiLU product, then
down with the routing weight, each one launch over every expert), the
shared experts, and ``moe_combine``. Elsewhere (the CPU, fp32, gradients)
``moe_reference`` runs it in plain PyTorch, an expert at a time, with the
same roundings (counted in ``moe.plain``). ``hist`` (an int32 [E] tensor)
accumulates the per-expert slot counts, for the router's imbalance counter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.ops import _build
from multimodal_content_moderation_tpu_torch.ops.layers import _matmul_f32, fused, swiglu
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count

BM = 128  # slots an m-tile of moe_grouped (csrc/moe.cu)
BN = 128  # its n-tile
BK = 64  # its k step
MAX_EXPERTS = 256
MAX_TILES = 65535  # the grid's y extent


def split_gate_up(w: torch.Tensor):
    """(gate, up) [..., F, d] of a stacked [..., 2F, d] whose rows 16q ..
    16q+7 are the gate's 8q .. 8q+7 and the next 8 the up's (views where the
    layout allows)."""
    *lead, f2, d = w.shape
    v = w.reshape(*lead, f2 // 16, 2, 8, d)
    return (v.select(-3, 0).reshape(*lead, f2 // 2, d), v.select(-3, 1).reshape(*lead, f2 // 2, d))


def route_reference(logits: torch.Tensor, k: int, scaling: float):
    """(idx [N, k] int64, weight [N, k] fp32): the k largest softmax
    probabilities of fp32 ``logits`` [N, E] in descending order, ties to the
    lower expert (a stable sort), times ``scaling``."""
    p = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(p, dim=-1, descending=True, stable=True).indices[:, :k]
    return order, p.gather(1, order) * scaling


def _sum_in_order(y: torch.Tensor, shared: Optional[torch.Tensor]) -> torch.Tensor:
    """sum_j y[:, j] (+ shared) in fp32, j in order, rounded once."""
    acc = y[:, 0].float()
    for j in range(1, y.shape[1]):
        acc = acc + y[:, j].float()
    if shared is not None:
        acc = acc + shared.float()
    return acc.to(y.dtype)


def experts_reference(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                      w_gu: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """[N, k, d] in x's dtype: each slot's weighted expert output, an expert
    at a time (fp32 products, the SiLU product and the weighted output each
    rounded once to x's dtype)."""
    N, k = idx.shape
    y = x.new_zeros(N, k, x.shape[-1])
    gate, up = split_gate_up(w_gu)
    for e in range(w_gu.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = (F.silu(_matmul_f32(xe, gate[e].t().to(x.dtype)))
             * _matmul_f32(xe, up[e].t().to(x.dtype))).to(x.dtype)
        ye = _matmul_f32(h, w_down[e].t().to(x.dtype)) * weight[tok, slot, None]
        y = y.index_put((tok, slot), ye.to(x.dtype))
    return y


def moe_reference(x: torch.Tensor, p, k: int, scaling: float,
                  hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer in plain PyTorch (module docstring)."""
    idx, weight = route_reference(_matmul_f32(x, p["gate"]["w"].to(x.dtype)), k, scaling)
    if hist is not None:
        hist.add_(torch.bincount(idx.reshape(-1), minlength=hist.shape[0]).to(hist.dtype))
    y = experts_reference(x, idx, weight, p["experts"]["gate_up"], p["experts"]["down"])
    return _sum_in_order(y, swiglu(x, p["shared"]) if "shared" in p else None)


def takes(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor, k: int) -> bool:
    """Whether the kernels take the layer: contiguous [N, d] activations, d
    and 2F multiples of 128 and F of 64 (whole n-tiles and k steps), at most
    256 experts, contiguous expert weights, and a grid of at most
    ``MAX_TILES`` m-tiles."""
    if x.dim() != 2 or not x.is_contiguous():
        return False
    N, d = x.shape
    E, f2, dk = w_gu.shape
    return (dk == d and w_down.shape == (E, d, f2 // 2) and d % BN == 0 and f2 % BN == 0
            and (f2 // 2) % BK == 0 and 0 < k <= E <= MAX_EXPERTS
            and -(-N * k // BM) + E <= MAX_TILES
            and w_gu.is_contiguous() and w_down.is_contiguous())


def _lib():
    lib = _build.load("moe")
    if lib.moe_route_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((lib.moe_route_launch, [p, i, i, i, ctypes.c_float] + [p] * 9),
                         (lib.moe_grouped_launch, [i] + [p] * 7 + [i] * 4 + [p]),
                         (lib.moe_combine_launch, [p] * 4 + [i] * 3 + [p])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _check(err: int) -> None:
    if err:
        _build.check(_build.load("moe"), "moe", err)


class Routing(NamedTuple):
    """What ``route`` leaves on the card: the top-k (``idx``, ``weight``, [N,
    k]), each expert's first sorted slot and first m-tile (``offsets``,
    ``tiles``, [E + 1]), and for the N k slots in expert order the token
    (``rows``) and weight (``wsorted``), and each slot's place in that order
    (``slot_pos``, [N, k])."""

    idx: torch.Tensor
    weight: torch.Tensor
    offsets: torch.Tensor
    tiles: torch.Tensor
    rows: torch.Tensor
    wsorted: torch.Tensor
    slot_pos: torch.Tensor


def route(logits: torch.Tensor, k: int, scaling: float, counts: torch.Tensor) -> Routing:
    """``moe_route_kernel`` + ``moe_permute_kernel`` on fp32 [N, E] logits;
    ``counts`` (int32 [E], zero on entry) receives the per-expert slots.
    Counted in ``route.launches``."""
    N, E = logits.shape
    dev = logits.device
    i32 = torch.int32
    idx = torch.empty(N, k, dtype=i32, device=dev)
    weight = torch.empty(N, k, dtype=torch.float32, device=dev)
    offsets = torch.empty(E + 1, dtype=i32, device=dev)
    tiles = torch.empty(E + 1, dtype=i32, device=dev)
    rows = torch.empty(N * k, dtype=i32, device=dev)
    wsorted = torch.empty(N * k, dtype=torch.float32, device=dev)
    slot_pos = torch.empty(N, k, dtype=i32, device=dev)
    _check(_lib().moe_route_launch(
        logits.data_ptr(), N, E, k, scaling, idx.data_ptr(), weight.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), tiles.data_ptr(), rows.data_ptr(),
        wsorted.data_ptr(), slot_pos.data_ptr(), _build.stream_ptr(dev)))
    route.launches += 1
    return Routing(idx, weight, offsets, tiles, rows, wsorted, slot_pos)


route.launches = 0


def grouped(gate_up: bool, a: torch.Tensor, r: Routing, w: torch.Tensor) -> torch.Tensor:
    """One ``moe_grouped_kernel`` launch over every expert: gate+up (``a`` =
    x [N, d], rows through ``r.rows``) -> h [S, F], or down (``a`` = h [S,
    F]) -> y [S, d] times each slot's weight. Counted in
    ``grouped.launches``."""
    E, NW, K = w.shape
    S = r.rows.shape[0]
    out = a.new_empty(S, NW // 2 if gate_up else NW)
    max_tiles = -(-S // BM) + E
    _check(_lib().moe_grouped_launch(
        int(gate_up), a.data_ptr(), r.rows.data_ptr(), w.data_ptr(), r.wsorted.data_ptr(),
        r.offsets.data_ptr(), r.tiles.data_ptr(), out.data_ptr(), E, K, NW, max_tiles,
        _build.stream_ptr(a.device)))
    grouped.launches += 1
    return out


grouped.launches = 0


def combine(y: torch.Tensor, slot_pos: torch.Tensor, shared: Optional[torch.Tensor]):
    """``moe_combine_kernel``: [N, d] = bf16(sum_j y[slot_pos[t, j]] +
    shared[t]). Counted in ``combine.launches``."""
    N, k = slot_pos.shape
    D = y.shape[1]
    out = y.new_empty(N, D)
    _check(_lib().moe_combine_launch(
        y.data_ptr(), slot_pos.data_ptr(), None if shared is None else shared.data_ptr(),
        out.data_ptr(), N, D, k, _build.stream_ptr(y.device)))
    combine.launches += 1
    return out


combine.launches = 0


def moe_layer(x: torch.Tensor, p, k: int, scaling: float,
              hist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert layer on [N, d] tokens (module docstring): on the ``fused``
    schedule the kernels, which raise on a shape they do not take; else
    ``moe_reference``'s steps (counted in ``moe.plain``). Under the spans
    ``moe.route``, ``moe.experts`` and ``moe.combine``; counted in
    ``moe.layers``."""
    count("moe.layers")
    w_gu, w_down = p["experts"]["gate_up"], p["experts"]["down"]
    if x.shape[0] == 0:
        return x.new_zeros(x.shape)
    gate_w = p["gate"]["w"]
    shared_p = p["shared"] if "shared" in p else None
    leaves = [gate_w, w_gu, w_down] + ([] if shared_p is None else
                                       [shared_p["gate_up"]["w"], shared_p["down"]["w"]])
    on_card = fused(x, *leaves)
    if on_card:
        x = x.contiguous()
        if not takes(x, w_gu, w_down, k):
            raise ValueError(
                f"moe_layer: the kernels take x [N, d], contiguous gate_up [E, 2F, d] and down "
                f"[E, d, F] with d and 2F multiples of {BN}, F of {BK}, 0 < k <= E <= "
                f"{MAX_EXPERTS} and at most {MAX_TILES} m-tiles; got x {tuple(x.shape)}, "
                f"gate_up {tuple(w_gu.shape)}, down {tuple(w_down.shape)}, k {k}")
    else:
        count("moe.plain")
    with annotate("moe.route"):
        logits = _matmul_f32(x, gate_w.to(x.dtype))
        if on_card:
            counts = torch.zeros(w_gu.shape[0], dtype=torch.int32, device=x.device)
            r = route(logits, k, scaling, counts)
            if hist is not None:
                hist.add_(counts)
        else:
            idx, weight = route_reference(logits, k, scaling)
            if hist is not None:
                hist.add_(torch.bincount(idx.reshape(-1), minlength=hist.shape[0]).to(hist.dtype))
    with annotate("moe.experts"):
        if on_card:
            y = grouped(False, grouped(True, x, r, w_gu), r, w_down)
        else:
            y = experts_reference(x, idx, weight, w_gu, w_down)
        shared = None if shared_p is None else swiglu(x, shared_p)
    with annotate("moe.combine"):
        return combine(y, r.slot_pos, shared) if on_card else _sum_in_order(y, shared)
