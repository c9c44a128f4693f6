"""The port's GPipe pipeline over `pipe` (parallel.pipeline), held against
the JAX package's pipeline and the one-process port, on gloo processes on
the CPU.

Each mesh case spawns one process per rank (tests/torch_mesh_ranks.py).
Every rank starts from the JAX package's make_pipeline_train_state
weights for the same mesh (the stacked tree, converted by
params_from_jax), keeps its stage and calls the port's pipeline train step
once on the same global batch. The model is the JAX package's own
pipeline test's (tests/test_model.py), in f32: vocab 64, d_model 32, 4
layers, 4 heads, d_ff 64, B=8, S=16, n_micro=2. The meshes are
MeshSpec(pipe=2), MeshSpec(pipe=4) and the JAX package's dp x pp mesh
MeshSpec(data=2, pipe=4).

Checks:

- the step's loss against the JAX package's pipeline_loss on the same
  mesh and weights, and against its dense loss_fn (1e-5; JAX's own bf16
  test uses 2e-2);
- every leaf's gradient against the one-process port's dense gradient, to
  1e-6 of the leaf's largest entry (the same sums, cut into microbatches
  and stages: the differences are f32 roundings of reordered sums);
- embedding, w_out and final_scale bit-equal on every rank after the
  step (summed over `pipe`, averaged over `data`, the same AdamW update).

Planted faults must fail these checks: each microbatch's loss seeded
with 1 instead of 1 / n_micro; the embedding's gradient not summed over
`pipe`; the handoffs sent to the wrong stage.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.parallel import pipeline as jpipe
from dynolog_tpu.parallel import sharding as jsh
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models import transformer as ttr
from dynolog_tpu_torch.models.convert import params_from_jax
from dynolog_tpu_torch.parallel import launch, pipeline

DIMS = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
            dtype="float32")
BATCH, SEQ, N_MICRO = 8, 16, 2
CASES = {"pp2": {"pipe": 2}, "pp4": {"pipe": 4},
         "dp2xpp4": {"data": 2, "pipe": 4}}
GRAD_TOL = 1e-6


def _jax_pipeline(spec):
    """(numpy pipeline parameters, tokens, pipeline_loss) of the JAX
    package on MeshSpec(**spec)."""
    cfg = jtr.TransformerConfig(**DIMS)
    batch = jtrain.make_batch(jax.random.PRNGKey(1), cfg, BATCH, SEQ)
    mesh = jsh.make_mesh(jsh.MeshSpec(**spec))
    with mesh:
        params, _ = jpipe.make_pipeline_train_state(
            jax.random.PRNGKey(0), cfg, mesh)
        loss = jax.jit(lambda p, t: jpipe.pipeline_loss(
            p, t, cfg, mesh, N_MICRO))(params, batch)
    return (jax.tree_util.tree_map(np.array, params),
            np.array(batch).astype(np.int64), float(loss))


@pytest.fixture(scope="module")
def dense():
    """The JAX package's dense loss and the one-process port's loss and
    gradients, on the weights every case starts from (make_pipeline_
    train_state draws init_params' weights whatever the mesh)."""
    cfg = jtr.TransformerConfig(**DIMS)
    params = jtr.init_params(jax.random.PRNGKey(0), cfg)
    batch = jtrain.make_batch(jax.random.PRNGKey(1), cfg, BATCH, SEQ)
    jax_loss = float(jax.jit(lambda p, t: jtr.loss_fn(p, t, cfg))(
        params, batch))
    tparams = params_from_jax(jax.tree_util.tree_map(np.array, params),
                              "cpu", torch.float32)
    # One thread, as each rank runs: the sums' order does not then depend
    # on how many threads this process was given.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = ttrain.make_train_step(ttr.TransformerConfig(**DIMS))(
            tparams, ttrain.make_optimizer(tparams),
            torch.from_numpy(np.array(batch).astype(np.int64)))
    finally:
        torch.set_num_threads(threads)
    return {"jax_loss": jax_loss, "loss": float(loss),
            "grads": {n: p.grad.numpy()
                      for n, p in torch_mesh_ranks.named(tparams).items()}}


def _run(spec, fault=None):
    np_params, tokens, jax_loss = _jax_pipeline(spec)
    world = int(np.prod(list(spec.values())))
    ranks = launch.spawn(torch_mesh_ranks.pipe_rank, world, "gloo",
                         (spec, DIMS, np_params, tokens, N_MICRO, fault),
                         timeout_s=90)
    return ranks, jax_loss


def _failures(ranks, jax_loss, dense) -> list:
    out = []
    for r in ranks:
        where = r["coord"]
        for ref in (jax_loss, dense["jax_loss"]):
            if not abs(r["loss"] - ref) < 1e-5:
                out.append(f"loss {r['loss']} against {ref} on {where}")
        for path, got in r["grads"].items():
            want = dense["grads"][path]
            err = np.abs(got - want).max()
            if not err <= GRAD_TOL * np.abs(want).max():
                out.append(f"{path} on {where}: max error {err:.3g}")
    for a, b in itertools.combinations(ranks, 2):
        for name, got in a["replicated"].items():
            if not np.array_equal(got, b["replicated"][name]):
                out.append(f"{name} differs on {a['coord']} and "
                           f"{b['coord']} after the step")
    return out


@pytest.mark.parametrize("name", CASES)
def test_pipeline_step_matches_jax_and_one_process(name, dense):
    spec = CASES[name]
    ranks, jax_loss = _run(spec)
    assert sorted(tuple(r["coord"].values()) for r in ranks) == sorted(
        itertools.product(range(spec.get("data", 1)), range(spec["pipe"])))
    # Every stage reports its own layers and the replicated leaves: the
    # pipe ranks of one data coordinate hold every leaf once between them.
    held = [p for r in ranks if r["coord"]["data"] == 0 for p in r["grads"]]
    assert sorted(held) == sorted(
        list(dense["grads"]) + list(pipeline.REPLICATED) * (spec["pipe"] - 1))
    assert abs(dense["loss"] - dense["jax_loss"]) < 1e-5
    assert _failures(ranks, jax_loss, dense) == []


@pytest.mark.parametrize("fault,spec,kind", [
    ("no_micro_scaling", {"pipe": 2}, "max error"),
    ("embedding_not_summed", {"pipe": 2}, "embedding"),
    ("handoff_to_wrong_stage", {"pipe": 4}, "loss"),
])
def test_planted_faults_fail(fault, spec, kind, dense):
    ranks, jax_loss = _run(spec, fault)
    found = _failures(ranks, jax_loss, dense)
    assert any(kind in f for f in found), found


def test_params_from_jax_unstacks_the_pipeline_tree():
    """The JAX pipeline's stacked tree converts to the dense tree's layers,
    leaf for leaf; stage_params keeps a rank's block of them."""
    cfg = jtr.TransformerConfig(**DIMS)
    dense_np = jax.tree_util.tree_map(
        np.array, jtr.init_params(jax.random.PRNGKey(0), cfg))
    stacked = {**dense_np, "layers": {
        n: np.stack([layer[n] for layer in dense_np["layers"]])
        for n in dense_np["layers"][0]}}
    a = params_from_jax(stacked, "cpu", torch.float32)
    b = params_from_jax(dense_np, "cpu", torch.float32)
    for (na, la), (nb, lb) in zip(torch_mesh_ranks.named(a).items(),
                                  torch_mesh_ranks.named(b).items()):
        assert na == nb and la.requires_grad
        torch.testing.assert_close(la, lb, rtol=0, atol=0)

    class Stage2of4:  # the DeviceMesh methods sharding.axis reads
        mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

        def size(self, dim):
            return 4 if dim == 4 else 1

        def get_local_rank(self, name):
            return 2

        def get_group(self, name):
            return object()

    mine = pipeline.stage_params(a, Stage2of4())
    assert len(mine["layers"]) == 1 and mine["layers"][0] is a["layers"][2]
    assert all(mine[n] is a[n] for n in pipeline.REPLICATED)


def test_pipeline_refuses_what_it_cannot_stage():
    """MoE, attention other than "reference", and a layer count that does
    not divide into the stages raise ValueError, as the JAX package's
    assertions refuse them; the dense and MoE trainers still refuse a
    `pipe` axis."""
    class Pipe3:
        mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

        def size(self, dim):
            return 3 if dim == 4 else 1

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            return object()

    for overrides, match in (({"n_experts": 4}, "dense/reference"),
                             ({"attn_impl": "flash"}, "dense/reference"),
                             ({}, "must divide into pipe=3")):
        cfg = ttr.TransformerConfig(**{**DIMS, **overrides})
        with pytest.raises(ValueError, match=match):
            pipeline.make_pipeline_train_step(cfg, Pipe3(), N_MICRO)
        with pytest.raises(ValueError, match=match):
            pipeline.init_pipeline_params(cfg, Pipe3(), "cpu")
    with pytest.raises(NotImplementedError, match="GPipe"):
        ttrain.make_train_step(ttr.TransformerConfig(**DIMS), Pipe3())


def test_pipeline_names_are_exported():
    from dynolog_tpu_torch import parallel

    for name in ("init_pipeline_params", "pipeline_loss",
                 "make_pipeline_train_state", "make_pipeline_train_step"):
        assert name in parallel.__all__
        assert getattr(parallel, name) is getattr(pipeline, name)
