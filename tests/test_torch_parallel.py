"""The port's parallel rules against the JAX package's, in one process.

- The Megatron rules: on every parameter of tiny CLIP, SigLIP and generic
  (BERT + ViT) fusion and multi-task models, the dimension the port splits
  over the model axis equals JAX's ``param_shardings(...).spec`` on
  ``build_mesh(4, 2)`` (8 virtual CPU devices); the hidden-31 fallback
  replicates in both; the port's own head-count fallback keeps a 3-head
  block whole where JAX splits its columns.
- The layout: rank to (data, model) coordinates equal JAX's
  ``build_mesh(n, m).devices`` for 8x1, 4x2, 2x4 and 1x8.
- A mesh of one process: the batch, the rows, the eval positions and the
  gathers are the identity; a batch that does not divide by the data axis
  raises with JAX's message.
- Dropout under a mesh draws the global batch's mask: a rank's rows (and
  its heads) of it, bit for bit.
- The vocabulary-parallel lookup of an unsplit table is the plain lookup.
The multi-process runs are in ``tests/test_torch_multiprocess*.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_content_moderation_tpu.parallel.mesh import build_mesh as j_build_mesh
from multimodal_content_moderation_tpu.parallel.sharding import (
    param_shardings as j_param_shardings,
)
from multimodal_content_moderation_tpu_torch.models.params import flatten
from multimodal_content_moderation_tpu_torch.ops import layers as tl
from multimodal_content_moderation_tpu_torch.parallel import collectives
from multimodal_content_moderation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    build_mesh,
    layout,
)
from multimodal_content_moderation_tpu_torch.parallel.sharding import (
    _spec_for,
    param_shardings,
    tower_heads,
)


def _jax_dims(jparams, mesh):
    """{dotted name: the dimension JAX splits over "model", or None}."""
    out = {}
    for name, sharding in flatten(j_param_shardings(jparams, mesh)).items():
        spec = tuple(sharding.spec)
        out[name] = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
    return out


def _models():
    from test_torch_generic import _pair as generic_pair
    from test_torch_multitask import _pair as mtl_pair
    from test_torch_pixel_path import _pair as fusion_pair

    yield "clip fusion", *fusion_pair("clip")
    yield "siglip fusion", *fusion_pair("siglip")
    yield "generic fusion", *generic_pair("fusion")
    yield "clip mtl", *mtl_pair("clip")
    yield "auto mtl", *mtl_pair("auto")
    yield "generic mtl", *generic_pair("mtl")


def test_rules_match_jax_on_every_parameter():
    mesh = j_build_mesh(4, 2)
    split_somewhere = 0
    for label, _, jparams, tmodel in _models():
        want = _jax_dims(jparams, mesh)
        shapes = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
        assert set(shapes) == set(want), label
        got = param_shardings(shapes, 2, tower_heads(tmodel))
        assert got == want, (label, {n for n in got if got[n] != want[n]})
        split_somewhere += sum(d is not None for d in got.values())
        # the towers' blocks are split; the heads, projections and the MAP head are not
        assert got["backbone.text_model.layers.0.attn.q.w"] == 1, label
        assert got["backbone.text_model.layers.0.attn.o.w"] == 0, label
        assert got["backbone.text_model.layers.0.fc2.b"] is None, label
        assert all(d is None for n, d in got.items() if n.startswith("head.")), label
    assert split_somewhere > 0


def test_token_embedding_is_split_over_the_vocabulary():
    assert _spec_for("backbone.text_model.token_embedding", 2) == (MODEL_AXIS, None)
    assert _spec_for("backbone.text_model.word_embeddings", 2) is None  # JAX's rule: by name
    assert _spec_for("backbone.vision_model.head.attn.q.w", 2) is None  # SigLIP's MAP head
    assert _spec_for("head.heads.0.fc1.w", 2) is None


def test_rules_fall_back_on_indivisible_axes_and_head_counts():
    mesh = j_build_mesh(4, 2)
    jtree = {"backbone": {"text_model": {"layers": [
        {"attn": {"q": {"w": jnp.zeros((31, 31)), "b": jnp.zeros((31,))}}}]}}}
    want = _jax_dims(jtree, mesh)
    got = param_shardings({n: (31, 31) if n.endswith(".w") else (31,) for n in want}, 2)
    assert got == want == {"backbone.text_model.layers.0.attn.q.w": None,
                           "backbone.text_model.layers.0.attn.q.b": None}
    # 48 columns of 3 heads: JAX splits them across a head; the port keeps
    # the attention whole (its kernels take whole heads) and splits the MLP
    shapes = {"backbone.text_model.layers.0.attn.q.w": (48, 48),
              "backbone.text_model.layers.0.attn.o.w": (48, 48),
              "backbone.text_model.layers.0.fc1.w": (48, 96)}
    jtree = {"backbone": {"text_model": {"layers": [
        {"attn": {"q": {"w": jnp.zeros((48, 48))}, "o": {"w": jnp.zeros((48, 48))}},
         "fc1": {"w": jnp.zeros((48, 96))}}]}}}
    assert _jax_dims(jtree, mesh) == {"backbone.text_model.layers.0.attn.q.w": 1,
                                      "backbone.text_model.layers.0.attn.o.w": 0,
                                      "backbone.text_model.layers.0.fc1.w": 1}
    got = param_shardings(shapes, 2, {"backbone.text_model.": 3})
    assert got == {"backbone.text_model.layers.0.attn.q.w": None,
                   "backbone.text_model.layers.0.attn.o.w": None,
                   "backbone.text_model.layers.0.fc1.w": 1}
    assert param_shardings(shapes, 1) == dict.fromkeys(shapes)


@pytest.mark.parametrize("num_data,num_model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_layout_matches_jax(num_data, num_model):
    want = np.vectorize(lambda d: d.id)(j_build_mesh(num_data, num_model).devices)
    np.testing.assert_array_equal(layout(8, num_data, num_model), want)
    if num_model < 8:
        np.testing.assert_array_equal(layout(8, -1, num_model), want)


def test_layout_refuses_a_grid_that_leaves_a_rank_out():
    with pytest.raises(ValueError, match="needs 2 processes"):
        layout(1, -1, 2)
    with pytest.raises(ValueError, match="needs 4 processes"):
        layout(8, 2, 2)


def test_a_mesh_of_one_process_is_the_identity():
    mesh = build_mesh()
    assert (mesh.num_data, mesh.num_model, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.is_main
    batch = {"x": torch.arange(6).reshape(3, 2), "_valid": torch.tensor(3)}
    assert all(torch.equal(mesh.shard_batch(batch)[k], v) for k, v in batch.items())
    np.testing.assert_array_equal(mesh.positions(5, 4), np.arange(5))
    local = torch.arange(10.0).reshape(5, 2)
    assert torch.equal(mesh.gather_rows(local, np.arange(5), 5), local)
    assert float(mesh.mean(torch.tensor(2.5))) == 2.5


def test_rows_of_a_batch_that_does_not_divide_raise():
    mesh = build_mesh()
    mesh.num_data, mesh.data_index = 2, 1  # this rank's place on a 2x1 grid
    assert mesh.rows(8) == slice(4, 8)
    np.testing.assert_array_equal(mesh.positions(10, 4), [2, 3, 6, 7])
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        mesh.rows(5)


def test_dropout_keeps_its_rows_and_heads_of_the_global_mask():
    x = torch.ones(4, 2, 3, 3)
    g = torch.Generator().manual_seed(3)
    whole = tl.dropout(torch.ones(8, 4, 3, 3), 0.5, g)
    try:
        collectives.set_data_shard(1, 2)
        g = torch.Generator().manual_seed(3)
        mine = tl.dropout(x, 0.5, g, heads=(2, 4))
    finally:
        collectives.set_data_shard(0, 1)
    assert torch.equal(mine, whole[4:, 2:])
    # the generator moved on as far as one process's draw takes it
    g1 = torch.Generator().manual_seed(3)
    tl.dropout(torch.ones(8, 4, 3, 3), 0.5, g1)
    assert torch.equal(g.get_state(), g1.get_state())


def test_unsplit_vocabulary_lookup_is_the_plain_lookup():
    table = torch.randn(10, 4)
    ids = torch.tensor([[0, 9, 3]], dtype=torch.int32)
    assert torch.equal(collectives.vocab_parallel_lookup(table, ids), table[ids.long()])
