"""The port's optimizer (``training/optim.AdamW``) against the JAX package's
``build_optimizer`` (optax), step for step on a small parameter tree fed
the same gradients.

The tree has two trained groups (the encoder under ``backbone.*`` and the
head), a frozen vision tower whose gradient is not zero (it must keep its
weights and still count in the global norm), gradients large enough that
the clip engages on some steps, warmup + cosine / linear / constant
schedules, bf16 Adam accumulators and k=2 gradient accumulation
(``optax.MultiSteps``).

Tolerances: fp32 state atol 1e-6 (the same fp32 formulas; ``decay**count``
and the schedule's cosine are rounded once in another library). bf16
state atol 1e-5: m and v are rounded to bf16 when stored, and an fp32
difference of one ulp before that rounding can move one stored moment by
one bf16 ulp, i.e. an update by 2^-8 of its size (lr <= 5e-3 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_content_moderation_tpu.training.optim import build_optimizer
from multimodal_content_moderation_tpu_torch.models.bridge import optimizer_state_from_optax
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.training.optim import AdamW, make_schedule

SHAPES = {
    "backbone": {
        "text_model": {"w": (4, 3), "b": (3,)},
        "vision_model": {"w": (5,)},
        "text_projection": {"w": (3, 2)},
    },
    "head": {"a": {"w": (2, 2), "b": (2,)}},
}
KW = dict(lr_encoder=2e-3, lr_head=5e-3, weight_decay=0.02, max_grad_norm=1.0)


def _tree(fn):
    return jax.tree_util.tree_map(fn, SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _setup(seed, n_micro):
    g = np.random.default_rng(seed)
    params = _tree(lambda s: g.normal(size=s).astype(np.float32))
    grads = []
    for i in range(n_micro):
        scale = 3.0 if i % 3 == 0 else 0.05  # the clip engages on every third
        grads.append(_tree(lambda s: (g.normal(size=s) * scale).astype(np.float32)))
    return params, grads


def _run_jax(params, grads, total, accum, state=None, **kw):
    tx = build_optimizer(params, total_steps=total, **KW, **kw)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p) if state is None else state
    traj = []
    for gr in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, gr), state, p)
        p = optax.apply_updates(p, upd)
        traj.append(flatten(jax.tree_util.tree_map(np.asarray, p)))
    return traj, state


def _port(params, total, accum, **kw):
    named = {k: torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in flatten(params).items()}
    return named, AdamW(named, total_steps=total, accumulation_steps=accum, **KW, **kw)


def _run_port(named, opt, grads):
    traj = []
    for gr in grads:
        for k, v in flatten(gr).items():
            named[k].grad = torch.from_numpy(v)
        opt.step()
        traj.append({k: t.detach().numpy().copy() for k, t in named.items()})
    return traj


@pytest.mark.parametrize(
    "schedule,accum,acc_dtype,freeze",
    [
        ("cosine", 1, None, True),
        ("cosine", 2, None, True),
        ("linear", 1, "bfloat16", False),
        ("constant", 2, "bfloat16", True),
    ],
)
def test_five_step_trajectory_matches_optax(schedule, accum, acc_dtype, freeze):
    n_micro = 5 * accum
    params, grads = _setup(1, n_micro)
    kw = dict(warmup_ratio=0.4, schedule=schedule, freeze_image=freeze,
              accumulator_dtype=acc_dtype)
    want, _ = _run_jax(params, grads, 5, accum, **kw)
    named, opt = _port(params, 5, accum, **kw)
    got = _run_port(named, opt, grads)
    atol = 1e-6 if acc_dtype is None else 1e-5
    frozen = "backbone.vision_model.w"
    for step, (a, b) in enumerate(zip(got, want)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=f"{k} @ {step}")
        if freeze:
            np.testing.assert_array_equal(a[frozen], flatten(params)[frozen])
    assert opt.count == 5 and opt.mini_step == 0
    assert any(not np.allclose(got[-1][k], flatten(params)[k]) for k in got[-1] if k != frozen)


def test_frozen_gradient_counts_in_the_global_norm():
    """Step 1: only the frozen leaf's gradient is large, so the clip scales
    every trained leaf's gradient by ~1e-3 (optax clips before it
    partitions). Step 2 is not clipped; Adam's moments then mix both steps,
    so the trajectory shows whether step 1 was scaled."""
    params, _ = _setup(2, 0)
    small = _tree(lambda s: np.full(s, 0.01, np.float32))
    big = _tree(lambda s: np.full(s, 0.01, np.float32))
    big["backbone"]["vision_model"]["w"] = np.full((5,), 100.0, np.float32)
    grads = [big, small]
    kw = dict(warmup_ratio=0.0, schedule="constant", freeze_image=True)
    want, _ = _run_jax(params, grads, 5, 1, **kw)
    named, opt = _port(params, 5, 1, **kw)
    got = _run_port(named, opt, grads)
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got[-1]["backbone.vision_model.w"],
                                  params["backbone"]["vision_model"]["w"])
    # without the frozen leaf in the norm, step 1 would not be clipped
    unclipped, _ = _run_jax(params, [small, small], 5, 1, **kw)
    assert not np.allclose(got[-1]["head.a.w"], unclipped[-1]["head.a.w"], atol=1e-6, rtol=0)


def _optax_schedule(peak, total, warmup_ratio, schedule):
    """The schedule ``build_optimizer`` composes (training/optim.py:119-133)."""
    warmup = max(int(total * warmup_ratio), 0)
    if schedule == "constant":
        return optax.constant_schedule(peak)
    decay = max(total - warmup, 1)
    down = (optax.linear_schedule(peak, 0.0, decay) if schedule == "linear"
            else optax.cosine_decay_schedule(peak, decay))
    if warmup == 0:
        return down
    return optax.join_schedules([optax.linear_schedule(0.0, peak, warmup), down], [warmup])


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("total,warmup", [(20, 0.25), (7, 0.0), (1, 0.05)])
def test_schedules_match_optax(schedule, total, warmup):
    """The learning rate of each update, at counts past the end too (fp32
    against float64: rtol 1e-6)."""
    sched = make_schedule(0.1, total, warmup, schedule)
    want = _optax_schedule(0.1, total, warmup, schedule)
    for count in range(total + 3):
        np.testing.assert_allclose(sched(count), float(want(count)), rtol=1e-6, atol=1e-9)
    if warmup and total > 4 and schedule != "constant":
        assert sched(0) == 0.0  # the first update of a warmup uses schedule(0)


@pytest.mark.parametrize("accum,acc_dtype", [(1, None), (2, "bfloat16")])
def test_state_carried_from_optax_mid_run(accum, acc_dtype):
    """Both packages continue from the same mid-run state (3 JAX steps, then
    the bridge), and agree on the next 2 steps."""
    n_micro = 5 * accum + (1 if accum > 1 else 0)  # stop mid-accumulation too
    params, grads = _setup(3, n_micro)
    kw = dict(warmup_ratio=0.2, schedule="cosine", freeze_text=True, accumulator_dtype=acc_dtype)
    split = 3 * accum + (1 if accum > 1 else 0)
    head, state = _run_jax(params, grads[:split], 6, accum, **kw)
    want, _ = _run_jax(
        jax.tree_util.tree_map(np.asarray, _unflatten(head[-1])), grads[split:], 6, accum,
        state=state, **kw,
    )
    named, opt = _port(_unflatten(head[-1]), 6, accum, **kw)
    opt.load_state_dict(optimizer_state_from_optax(state))
    assert opt.count == 3 and opt.mini_step == (1 if accum > 1 else 0)
    got = _run_port(named, opt, grads[split:])
    atol = 1e-6 if acc_dtype is None else 1e-5
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


def _unflatten(flat):
    tree = _tree(lambda s: None)
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = np.array(v)
    return tree
