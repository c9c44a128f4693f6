"""Reference and flash attention, and MoE layers, over a `seq` cut in the
port's trainer, held against the one-process port and the JAX package, on
gloo processes on the CPU.

Each mesh case spawns one process per rank (tests/torch_mesh_ranks.py).
Every rank starts from the JAX package's parameters for the same mesh
(its make_train_state, so the weights are the JAX sharded step's), keeps
its slice (shard_params) and calls the port's train step once on the same
global batch. The meshes are the JAX package's: its dp x sp x tp
MeshSpec(data=2, seq=2, model=2) with reference attention
(tests/test_model.py), `seq` alone under reference and flash attention
(the kernels' plain versions on the CPU), and the MoE family over `seq`
with `data`, `expert` and `model`, and under ring attention. Each rank
holds four rows or more, so a rank's rows interleave with the other
`seq` ranks' chunks in the MoE's slot order; the {data: 2, seq: 2} MoE
case (B=8, capacity factor 0.5) drops choices, so that order decides
which.

Checks, in f32 (the tolerances of tests/test_torch_tensor_parallel.py):

- the step's loss against the one-process port's on the global batch
  (1e-5) and against the JAX package's sharded step on the same mesh
  (1e-5);
- every leaf's gradient after the step, the router's included, against
  the one-process gradient's slice for this rank (1e-6);
- two ranks whose coordinates agree on every axis a leaf is cut over hold
  bit-equal gradients of it.

Planted faults must fail these checks: the sequence gathered with
gather_from_group's narrow-only backward, MoE slots counted in rank order
instead of global token order, and the MoE aux loss counted on every
`seq` rank.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.parallel import sharding as jsh
from dynolog_tpu_torch.parallel import launch, sharding

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            dtype="float32")
SEQ = 16
MOE = {"n_experts": 4}
# name: (mesh, model options, global batch rows)
CASES = {
    "sp2_reference": ({"seq": 2}, {"attn_impl": "reference"}, 4),
    "sp2_flash": ({"seq": 2}, {"attn_impl": "flash"}, 4),
    "sp4_flash": ({"seq": 4}, {"attn_impl": "flash"}, 4),
    "dp2xsp2xtp2_reference": ({"data": 2, "seq": 2, "model": 2},
                              {"attn_impl": "reference"}, 4),
    "sp2_moe": ({"seq": 2}, {**MOE, "attn_impl": "flash"}, 4),
    "dp2xsp2_moe_drop": ({"data": 2, "seq": 2},
                         {**MOE, "attn_impl": "reference",
                          "moe_capacity_factor": 0.5}, 8),
    "sp2xep2_moe": ({"seq": 2, "expert": 2},
                    {**MOE, "attn_impl": "flash"}, 4),
    "sp2xep2xtp2_moe": ({"seq": 2, "expert": 2, "model": 2},
                        {**MOE, "attn_impl": "reference"}, 4),
    "sp2xep2_moe_ring": ({"seq": 2, "expert": 2},
                         {**MOE, "attn_impl": "ring"}, 4),
}
# fault: the case it is planted in.
FAULTS = {
    "gather_with_narrow_backward": "sp2_flash",
    "positions_in_rank_order": "dp2xsp2_moe_drop",
    "aux_on_every_seq_rank": "sp2_moe",
}
_RUNS = {}


def _jax_step(spec, dims, rows):
    """(numpy parameters, tokens, loss) of the JAX package's sharded train
    step on MeshSpec(**spec)."""
    cfg = jtr.TransformerConfig(**dims)
    mesh = jsh.make_mesh(jsh.MeshSpec(**spec))
    batch = jtrain.make_batch(jax.random.PRNGKey(1), cfg, rows, SEQ)
    with mesh:
        params, opt = jtrain.make_train_state(jax.random.PRNGKey(0), cfg,
                                              mesh)
        np_params = jax.tree_util.tree_map(np.array, params)
        _, _, loss = jtrain.make_train_step(cfg, mesh)(
            params, opt, jax.device_put(batch, jsh.batch_sharding(mesh)))
    return np_params, np.array(batch).astype(np.int64), float(loss)


def _references(name):
    """The JAX sharded step's and the one-process port's results for case
    `name`, computed once per module."""
    if name not in _RUNS:
        spec, overrides, rows = CASES[name]
        dims = {**DIMS, **overrides}
        np_params, tokens, jax_loss = _jax_step(spec, dims, rows)
        _RUNS[name] = (np_params, tokens, jax_loss,
                       *torch_mesh_ranks.one_process(dims, np_params, tokens))
    return _RUNS[name]


def _failures(name, fault=None) -> list:
    """Every check of case `name` that the mesh run, with `fault` planted
    in each rank, fails."""
    spec, overrides, _ = CASES[name]
    dims = {**DIMS, **overrides}
    np_params, tokens, jax_loss, one_loss, one_grads = _references(name)
    world = int(np.prod(list(spec.values())))
    ranks = launch.spawn(torch_mesh_ranks.train_rank, world, "gloo",
                         (spec, dims, np_params, tokens, fault),
                         timeout_s=90)

    assert sorted(tuple(r["coord"].values()) for r in ranks) == sorted(
        itertools.product(*(range(spec.get(a, 1))
                            for a in torch_mesh_ranks.AXES)))
    out = []
    for r in ranks:
        for who, want in (("one process", one_loss), ("JAX", jax_loss)):
            if not abs(r["loss"] - want) < 1e-5:
                out.append(f"loss {r['loss']} on {r['coord']}, {who} {want}")
        for path, got in r["grads"].items():
            want = torch_mesh_ranks.block_of(one_grads[path], path, spec,
                                             r["coord"])
            err = float(np.max(np.abs(got - want)))
            if not err <= 1e-6:
                out.append(f"{path} on {r['coord']}: {err:.3g} from one "
                           "process")
    for a, b in itertools.combinations(ranks, 2):
        for path, got in a["grads"].items():
            cut = [n for n in sharding.rule_for(path) if n]
            if (all(a["coord"][n] == b["coord"][n] for n in cut)
                    and not np.array_equal(got, b["grads"][path])):
                out.append(f"{path} differs on {a['coord']} and "
                           f"{b['coord']}")
    return out


@pytest.mark.parametrize("name", CASES)
def test_seq_mesh_step_matches_one_process_and_jax(name):
    assert _failures(name) == []


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(fault):
    """Each fault fails the checks of the case it is planted in: the
    narrow-only backward drops the later chunks' share of k's and v's
    gradients (the loss is the same); slots in rank order drop other
    choices; the aux loss on every `seq` rank counts it twice."""
    failures = _failures(FAULTS[fault], fault)
    assert failures, fault
    if fault == "gather_with_narrow_backward":
        assert all(" from one process" in f for f in failures), failures
    else:
        assert any(f.startswith("loss ") for f in failures), failures


@pytest.mark.parametrize("fault", [None, "gather_with_narrow_backward"])
def test_gather_over_group_gradient(fault):
    """Three ranks, each weighting the gathered value by 1 + its rank:
    the forward concatenates the ranks' values along dim -2 in rank order,
    and each rank's gradient is its block of the sum of the three ranks'
    weights, as one-process autograd of the sum of the three losses gives
    it. gather_from_group's narrow-only backward keeps this rank's own
    weight alone."""
    world = 3
    ranks = launch.spawn(torch_mesh_ranks.gather_rank, world, "gloo",
                         (fault,), timeout_s=60)
    xs = [(torch.arange(24.0).reshape(2, 3, 4) + 100 * r).requires_grad_(
        True) for r in range(world)]
    whole = torch.cat(xs, -2)
    weight = torch.arange(float(whole.numel())).reshape(whole.shape)
    sum((whole * weight * (1 + r)).sum() for r in range(world)).backward()
    for r, (gathered, grad) in enumerate(ranks):
        np.testing.assert_array_equal(gathered, whole.detach().numpy())
        if fault is None:
            np.testing.assert_array_equal(grad, xs[r].grad.numpy())
        else:
            assert not np.array_equal(grad, xs[r].grad.numpy())
