"""The sparse expert layer of DeepSeek-V2 (HF ``DeepseekV2MoE``) and of
Kimi-Linear (``KimiSparseMoeBlock``): a router over E experts, each token's
top-k of them, and shared experts that every token runs.

    logits = x W_gate (fp32 products of the activations)
    softmax (DeepSeek-V2): p = softmax(logits) (fp32); the k largest, ties to
        the lower expert; the weights are those probabilities (not
        renormalised) times ``scaling``
    sigmoid (``Router``, Kimi-Linear): s = sigmoid(logits); the k largest of
        s + bias (the score-correction bias chooses and does not weigh),
        ties to the lower expert; the weights s / (sum of the k s + 1e-20)
        times ``scaling``
    y_j = bf16(w_j * down_e(bf16(silu(gate_e(x)) * up_e(x))))   (e the j-th expert)
    out = bf16(sum_j y_j + shared(x))   (fp32 sum in top-k order)

The layer may hold a share of the router's experts, as expert parallelism
gives each card (``Router.first``: it holds experts [first, first + E) of
the gate's outputs, E the stacked experts' count): it routes over all of
them, computes the slots of the experts it holds and drops the rest (no
exchange on one card); ``remote`` (an int32 device scalar) counts the
dropped slots.

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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_content_moderation_tpu_torch.ops import _build
from multimodal_content_moderation_tpu_torch.ops.layers import _matmul_f32, fused, swiglu
from multimodal_content_moderation_tpu_torch.utils.profiling import annotate, count

# moe_grouped's tile (csrc/moe.cu)
BM = 128  # slots an m-tile, the unit of the permutation's tile offsets
HALF = 64  # rows a consumer warpgroup computes: the products' row granularity
BN = 256  # columns an n-tile (a last one may be half as wide)
BK = 64  # the k step
MAX_EXPERTS = 256


def split_gate_up(w: torch.Tensor):
    """(gate, up) [..., F, d] of a stacked [..., 2F, d] whose rows 16q ..
    16q+7 are the gate's 8q .. 8q+7 and the next 8 the up's (views where the
    layout allows)."""
    *lead, f2, d = w.shape
    v = w.reshape(*lead, f2 // 16, 2, 8, d)
    return (v.select(-3, 0).reshape(*lead, f2 // 2, d), v.select(-3, 1).reshape(*lead, f2 // 2, d))


class Router(NamedTuple):
    """How the gate's logits choose and weigh the experts, and which of them
    the layer holds: DeepSeek-V2's softmax (the default), or ``sigmoid``
    with the gate's ``bias`` in the choice and the k weights renormalised;
    experts [``first``, ``first`` + E) of the gate's outputs held (E the
    stacked experts')."""

    sigmoid: bool = False
    first: int = 0


SOFTMAX = Router()


def route_reference(logits: torch.Tensor, k: int, scaling: float,
                    router: Router = SOFTMAX, bias: Optional[torch.Tensor] = None):
    """(idx [N, k] int64, weight [N, k] fp32) over the gate's outputs, in
    descending order of the choice, ties to the lower expert (a stable
    sort): the k largest softmax probabilities of fp32 ``logits`` [N, E]
    times ``scaling``; or (``router.sigmoid``) the k largest sigmoid scores
    plus ``bias``, weighted by their scores renormalised over the k, times
    ``scaling``."""
    if not router.sigmoid:
        p = torch.softmax(logits.float(), dim=-1)
        order = torch.sort(p, dim=-1, descending=True, stable=True).indices[:, :k]
        return order, p.gather(1, order) * scaling
    s = torch.sigmoid(logits.float())
    choice = s + bias.float() if bias is not None else s
    order = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :k]
    w = s.gather(1, order)
    return order, w / (w.sum(-1, keepdim=True) + 1e-20) * scaling


def held_slots(idx: torch.Tensor, first: int, held: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local, remote): each slot's expert among the ``held`` from ``first``
    (-1 for an expert held elsewhere) and the count of those slots."""
    local = idx - first
    mine = (local >= 0) & (local < held)
    return torch.where(mine, local, torch.full_like(local, -1)), (~mine).sum()


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


def _bincount_held(idx: torch.Tensor, E: int) -> torch.Tensor:
    idx = idx.reshape(-1)
    return torch.bincount(idx[idx >= 0], minlength=E)


def moe_reference(x: torch.Tensor, p, k: int, scaling: float,
                  hist: Optional[torch.Tensor] = None, router: Router = SOFTMAX) -> torch.Tensor:
    """The layer in plain PyTorch (module docstring)."""
    idx, weight = route_reference(_matmul_f32(x, p["gate"]["w"].to(x.dtype)), k, scaling,
                                  router, p["gate"]["bias"] if "bias" in p["gate"] else None)
    idx = held_slots(idx, router.first, p["experts"]["gate_up"].shape[0])[0]
    if hist is not None:
        hist.add_(_bincount_held(idx, hist.shape[0]).to(hist.dtype))
    y = experts_reference(x, idx, weight, p["experts"]["gate_up"], p["experts"]["down"])
    return _sum_in_order(y, swiglu(x, p["shared"]) if "shared" in p else None)


def takes(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor, k: int,
          width: Optional[int] = None, first: int = 0) -> bool:
    """Whether the kernels take the layer: contiguous [N, d] activations, d
    and 2F multiples of 128 (whole or half n-tiles) and F of 64 (whole k
    steps), at most 256 experts routed (``width``, the gate's outputs; E
    where None) of which the E held lie inside, k of them a token, fewer
    than 2^31 slots, and contiguous expert weights; every tensor 16-byte
    aligned (TMA and 16-byte cp.async read them)."""
    if x.dim() != 2 or not x.is_contiguous():
        return False
    N, d = x.shape
    E, f2, dk = w_gu.shape
    width = E if width is None else width
    return (dk == d and w_down.shape == (E, d, f2 // 2) and d % (BN // 2) == 0
            and f2 % (BN // 2) == 0 and (f2 // 2) % BK == 0 and 0 < k <= width
            and 0 <= first and first + E <= width <= MAX_EXPERTS
            and N * k < 2 ** 31 and w_gu.is_contiguous() and w_down.is_contiguous()
            and all(t.data_ptr() % 16 == 0 for t in (x, w_gu, w_down)))


def _lib():
    lib = _build.load("moe")
    if lib.moe_route_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((lib.moe_route_launch, [p, i, i, i, ctypes.c_float, i, p, i, i]
                          + [p] * 10),
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


def route(logits: torch.Tensor, k: int, scaling: float, counts: torch.Tensor,
          router: Router = SOFTMAX, bias: Optional[torch.Tensor] = None,
          remote: Optional[torch.Tensor] = None) -> Routing:
    """``moe_route_kernel`` + ``moe_permute_kernel`` on fp32 [N, width]
    logits; ``counts`` (int32 [E], zero on entry, E the held experts)
    receives the per-expert slots, ``remote`` (an int32 scalar, or None)
    adds the slots of experts held elsewhere, whose ``idx`` and
    ``slot_pos`` are -1. ``bias``: the sigmoid router's fp32 [width].
    Counted in ``route.launches``."""
    N, width = logits.shape
    E = counts.shape[0]
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
        logits.data_ptr(), N, width, k, scaling, int(router.sigmoid),
        None if bias is None else bias.data_ptr(), router.first, E, idx.data_ptr(),
        weight.data_ptr(), counts.data_ptr(), None if remote is None else remote.data_ptr(),
        offsets.data_ptr(), tiles.data_ptr(), rows.data_ptr(), wsorted.data_ptr(),
        slot_pos.data_ptr(), _build.stream_ptr(dev)))
    route.launches += 1
    return Routing(idx, weight, offsets, tiles, rows, wsorted, slot_pos)


route.launches = 0


def grouped(gate_up: bool, a: torch.Tensor, r: Routing, w: torch.Tensor) -> torch.Tensor:
    """One ``moe_grouped_kernel`` launch over every expert, a block an SM
    walking the (expert, n-tile, m-tile) work that ``r.tiles`` gives on the
    card: gate+up (``a`` = x [N, d], rows through ``r.rows``) -> h [S, F],
    or down (``a`` = h [S, F]) -> y [S, d] times each slot's weight. Counted
    in ``grouped.launches``."""
    E, NW, K = w.shape
    S = r.rows.shape[0]
    out = a.new_empty(S, NW // 2 if gate_up else NW)
    _check(_lib().moe_grouped_launch(
        int(gate_up), a.data_ptr(), r.rows.data_ptr(), w.data_ptr(), r.wsorted.data_ptr(),
        r.offsets.data_ptr(), r.tiles.data_ptr(), out.data_ptr(), E, K, NW, S,
        _build.stream_ptr(a.device)))
    grouped.launches += 1
    return out


grouped.launches = 0


def combine(y: torch.Tensor, slot_pos: torch.Tensor, shared: Optional[torch.Tensor]):
    """``moe_combine_kernel``: [N, d] = bf16(sum_j y[slot_pos[t, j]] +
    shared[t]) over the held slots (``slot_pos`` >= 0). Counted in
    ``combine.launches``."""
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
              hist: Optional[torch.Tensor] = None, router: Router = SOFTMAX,
              remote: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert layer on [N, d] tokens (module docstring): on the ``fused``
    schedule the kernels, which raise on a shape they do not take; else
    ``moe_reference``'s steps (counted in ``moe.plain``). ``hist`` (int32
    [E]) adds the held experts' slots, ``remote`` (an int32 scalar) those
    routed to experts held elsewhere. Under the spans ``moe.route``,
    ``moe.experts`` and ``moe.combine``; counted in ``moe.layers``."""
    count("moe.layers")
    w_gu, w_down = p["experts"]["gate_up"], p["experts"]["down"]
    if x.shape[0] == 0:
        return x.new_zeros(x.shape)
    gate_w = p["gate"]["w"]
    bias = p["gate"]["bias"] if "bias" in p["gate"] else None
    shared_p = p["shared"] if "shared" in p else None
    leaves = [gate_w, w_gu, w_down] + ([] if shared_p is None else
                                       [shared_p["gate_up"]["w"], shared_p["down"]["w"]])
    on_card = fused(x, *leaves)
    E, width = w_gu.shape[0], gate_w.shape[1]
    if on_card:
        x = x.contiguous()
        if not takes(x, w_gu, w_down, k, width, router.first):
            raise ValueError(
                f"moe_layer: the kernels take x [N, d], contiguous gate_up [E, 2F, d] and down "
                f"[E, d, F], 16-byte aligned, with d and 2F multiples of {BN // 2}, F of {BK}, "
                f"0 < k <= width, the held experts inside width <= {MAX_EXPERTS} and "
                f"N k < 2^31; got x {tuple(x.shape)}, gate_up {tuple(w_gu.shape)}, down "
                f"{tuple(w_down.shape)}, k {k}, width {width}, first {router.first}")
    else:
        count("moe.plain")
    with annotate("moe.route"):
        logits = _matmul_f32(x, gate_w.to(x.dtype))
        if on_card:
            counts = torch.zeros(E, dtype=torch.int32, device=x.device)
            r = route(logits, k, scaling, counts, router,
                      None if bias is None else bias.float(), remote)
            if hist is not None:
                hist.add_(counts)
        else:
            idx, weight = route_reference(logits, k, scaling, router, bias)
            idx, dropped = held_slots(idx, router.first, E)
            if hist is not None:
                hist.add_(_bincount_held(idx, hist.shape[0]).to(hist.dtype))
            if remote is not None:
                remote.add_(dropped.to(remote.dtype))
    with annotate("moe.experts"):
        if on_card:
            y = grouped(False, grouped(True, x, r, w_gu), r, w_down)
        else:
            y = experts_reference(x, idx, weight, w_gu, w_down)
        shared = None if shared_p is None else swiglu(x, shared_p)
    with annotate("moe.combine"):
        return combine(y, r.slot_pos, shared) if on_card else _sum_in_order(y, shared)
