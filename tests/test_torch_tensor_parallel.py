"""Tensor parallelism over `model` and ring attention over `seq` in the
port's trainer, held against the one-process port and the JAX package, on
gloo processes on the CPU.

Each mesh case spawns one process per rank (tests/torch_mesh_ranks.py).
Every rank starts from the JAX package's parameters for the same mesh
(its make_train_state, so the weights are the JAX sharded step's), keeps
its slice (shard_params) and calls the port's train step once on the same
global batch. The meshes are the JAX package's: MeshSpec(model=2),
MeshSpec(seq=2) with ring attention, its dp x sp x tp
MeshSpec(data=2, seq=2, model=2) with ring attention
(tests/test_ops.py), the same without `data` (the multi-card check's
mesh), and the MoE family's EP x TP MeshSpec(expert=2, model=2)
(tests/test_model.py).

Checks, in f32:

- the step's loss against the one-process port's on the global batch
  (1e-5) and against the JAX package's sharded step on the same mesh
  (1e-5; JAX's own bf16 tests use 1e-3 and 2e-2);
- every leaf's gradient after the step against the one-process gradient's
  slice for this rank (1e-6: the same sums, split over ranks);
- two ranks whose coordinates agree on every axis a leaf is cut over hold
  bit-equal gradients of it: over `model` the conjugate collectives give
  every rank the same gradient of a replicated leaf, over `seq` and
  `data` the step's sums and means do.

The one-process port runs ring attention on a stand-in mesh of one rank
(the ring consumes its one chunk), the other cases as configured. A
planted fault, positions not offset by the `seq` coordinate (RoPE wrong
on every chunk after the first), must fail the loss comparison.
"""

import itertools

import jax
import numpy as np
import pytest

import torch_mesh_ranks
from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.parallel import sharding as jsh
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models import transformer as ttr
from dynolog_tpu_torch.parallel import launch, sharding

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            dtype="float32")
BATCH, SEQ = 4, 16
CASES = {
    "tp2": ({"model": 2}, {"attn_impl": "flash"}),
    "sp2_ring": ({"seq": 2}, {"attn_impl": "ring"}),
    "sp2xtp2_ring": ({"seq": 2, "model": 2}, {"attn_impl": "ring"}),
    "dp2xsp2xtp2_ring": ({"data": 2, "seq": 2, "model": 2},
                         {"attn_impl": "ring"}),
    "ep2xtp2_moe": ({"expert": 2, "model": 2},
                    {"attn_impl": "flash", "n_experts": 4}),
}


def _jax_step(spec, dims):
    """(numpy parameters, tokens, loss) of the JAX package's sharded train
    step on MeshSpec(**spec)."""
    cfg = jtr.TransformerConfig(**dims)
    mesh = jsh.make_mesh(jsh.MeshSpec(**spec))
    batch = jtrain.make_batch(jax.random.PRNGKey(1), cfg, BATCH, SEQ)
    with mesh:
        params, opt = jtrain.make_train_state(jax.random.PRNGKey(0), cfg,
                                              mesh)
        np_params = jax.tree_util.tree_map(np.array, params)
        _, _, loss = jtrain.make_train_step(cfg, mesh)(
            params, opt, jax.device_put(batch, jsh.batch_sharding(mesh)))
    return np_params, np.array(batch).astype(np.int64), float(loss)


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_one_process_and_jax(name):
    spec, overrides = CASES[name]
    dims = {**DIMS, **overrides}
    np_params, tokens, jax_loss = _jax_step(spec, dims)
    world = int(np.prod(list(spec.values())))
    ranks = launch.spawn(torch_mesh_ranks.train_rank, world, "gloo",
                         (spec, dims, np_params, tokens), timeout_s=90)
    one_loss, one_grads = torch_mesh_ranks.one_process(dims, np_params,
                                                         tokens)

    assert sorted(tuple(r["coord"].values()) for r in ranks) == sorted(
        itertools.product(*(range(spec.get(a, 1))
                            for a in torch_mesh_ranks.AXES)))
    for r in ranks:
        assert abs(r["loss"] - one_loss) < 1e-5, (r["loss"], one_loss)
        assert abs(r["loss"] - jax_loss) < 1e-5, (r["loss"], jax_loss)
        for path, got in r["grads"].items():
            np.testing.assert_allclose(
                got, torch_mesh_ranks.block_of(one_grads[path], path, spec,
                                          r["coord"]),
                rtol=0, atol=1e-6, err_msg=f"{path} on {r['coord']}")
    for a, b in itertools.combinations(ranks, 2):
        for path, got in a["grads"].items():
            cut = [n for n in sharding.rule_for(path) if n]
            if all(a["coord"][n] == b["coord"][n] for n in cut):
                np.testing.assert_array_equal(
                    got, b["grads"][path],
                    err_msg=f"{path} on {a['coord']} and {b['coord']}")


def test_positions_without_seq_offset_fail():
    spec, overrides = CASES["sp2_ring"]
    dims = {**DIMS, **overrides}
    np_params, tokens, jax_loss = _jax_step(spec, dims)
    ranks = launch.spawn(torch_mesh_ranks.train_rank, 2, "gloo",
                         (spec, dims, np_params, tokens,
                          "positions_without_seq_offset"), timeout_s=90)
    assert all(abs(r["loss"] - jax_loss) > 1e-3 for r in ranks), ranks


def test_ring_shift_and_gather_from_group():
    """Three ranks, so the next and the previous coordinate differ:
    ring_shift brings each rank its predecessor's value and sends each
    gradient back to the rank the value came from; gather_from_group
    concatenates in rank order and hands each rank its slice of the
    gradient."""
    world = 3
    ranks = launch.spawn(torch_mesh_ranks.comm_rank, world, "gloo",
                         timeout_s=60)
    for r, (shifted, x_grad, gathered, y_grad) in enumerate(ranks):
        np.testing.assert_array_equal(shifted, (r - 1) % world)
        np.testing.assert_array_equal(x_grad, 10.0 * ((r + 1) % world))
        np.testing.assert_array_equal(
            gathered, [[10 * i + j for i in range(world) for j in range(2)]])
        np.testing.assert_array_equal(y_grad, [2 * r, 2 * r + 1])


def test_heads_that_do_not_split_over_model_raise():
    class Model3(torch_mesh_ranks.OneRank):
        def size(self, dim):
            return 3 if self.mesh_dim_names[dim] == "model" else 1

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            return object()

    with pytest.raises(ValueError, match="heads do not split"):
        ttrain.make_train_step(ttr.TransformerConfig(**DIMS), Model3())
