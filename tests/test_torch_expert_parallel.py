"""Expert parallelism of the port (models.moe under a parallel.sharding
mesh) held against the one-process port and the JAX package, on gloo
processes on the CPU.

Each case spawns one process per rank (parallel.launch.spawn). Every
rank starts from the JAX package's init_params output (converted with
params_from_jax) and keeps its slice (shard_params); all call the
expert-parallel train step once on the same global batch. The meshes are
those of the JAX package's tests: MeshSpec(expert=2) and
MeshSpec(data=2, expert=2) (batch over `data`, experts over `expert`).

Checks, in f32:

- the step's loss against the one-process port's on the global batch
  (1e-5) and against the JAX package's single-device loss (1e-5, the
  tolerance of tests/test_torch_model.py);
- every leaf's gradient after the step against the one-process gradient
  (its expert slice for the expert leaves), element by element (1e-6;
  the same sums split over ranks);
- the replicated leaves' gradients equal, bit for bit, across `expert`.
"""

import jax
import numpy as np
import pytest
import torch

from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models import transformer as ttr
from dynolog_tpu_torch.models.convert import params_from_jax
from dynolog_tpu_torch.parallel import launch, sharding

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            n_experts=4, dtype="float32")
BATCH, SEQ = 4, 16
EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")


def _named(tree) -> dict:
    out = {n: tree[n] for n in ("embedding", "w_out", "final_scale")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{i}/{n}": v for n, v in layer.items()})
    return out


def _ep_step(rank, world, spec, np_params, tokens):
    """One expert-parallel train step on this rank; its loss, gradients
    and mesh coordinates."""
    torch.set_num_threads(1)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    cfg = ttr.TransformerConfig(**DIMS)
    params = sharding.shard_params(
        params_from_jax(np_params, "cpu", torch.float32), mesh)
    step = ttrain.make_train_step(cfg, mesh)
    loss = step(params, ttrain.make_optimizer(params), torch.from_numpy(tokens))
    return {"loss": float(loss),
            "coord": {a: sharding.axis(mesh, a)[1] for a in ("data", "expert")},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in _named(params).items()}}


@pytest.mark.parametrize("spec", [{"expert": 2}, {"data": 2, "expert": 2}],
                         ids=["ep2", "dp2xep2"])
def test_expert_parallel_step_matches_one_process(spec):
    jcfg = jtr.TransformerConfig(**DIMS)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.array(jtrain.make_batch(jax.random.PRNGKey(1), jcfg, BATCH,
                                        SEQ)).astype(np.int64)
    np_params = jax.tree_util.tree_map(np.array, jparams)
    world = spec.get("data", 1) * spec["expert"]
    ranks = launch.spawn(_ep_step, world, "gloo",
                         (spec, np_params, tokens), timeout_s=60)

    # The one-process port on the global batch.
    cfg = ttr.TransformerConfig(**DIMS)
    params = params_from_jax(np_params, "cpu", torch.float32)
    one_loss = ttrain.make_train_step(cfg)(
        params, ttrain.make_optimizer(params), torch.from_numpy(tokens))
    one_grads = {n: p.grad.numpy() for n, p in _named(params).items()}
    jax_loss = float(jtr.loss_fn(jparams, tokens, jcfg))

    for r in ranks:
        assert abs(r["loss"] - float(one_loss)) < 1e-5, (r["loss"], one_loss)
        assert abs(r["loss"] - jax_loss) < 1e-5, (r["loss"], jax_loss)
        e = r["coord"]["expert"]
        for name, got in r["grads"].items():
            want = one_grads[name]
            if name.endswith(EXPERT_LEAVES):
                block = want.shape[0] // spec["expert"]
                want = want[e * block:(e + 1) * block]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f"{name} on {r['coord']}")
    for a in ranks:
        for b in ranks:
            if a["coord"]["data"] != b["coord"]["data"] or a is b:
                continue
            for name, got in a["grads"].items():
                if not name.endswith(EXPERT_LEAVES):
                    np.testing.assert_array_equal(got, b["grads"][name],
                                                  err_msg=name)


def test_make_train_state_keeps_this_ranks_experts():
    """make_train_state with a mesh draws the whole tree from the seed and
    keeps the slice of this rank: here rank 1 of MeshSpec(expert=2), whose
    rules cut only the expert leaves (a 1-process stand-in mesh)."""

    class Mesh:  # the DeviceMesh methods sharding.axis reads
        mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

        def size(self, dim):
            return 2 if dim == 3 else 1

        def get_local_rank(self, name):
            return 1

        def get_group(self, name):
            return object()

    cfg = ttr.TransformerConfig(**DIMS)
    full = ttr.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    mine, _ = ttrain.make_train_state(cfg, "cpu",
                                      torch.Generator().manual_seed(0),
                                      mesh=Mesh())
    for name, leaf in _named(mine).items():
        want = _named(full)[name].detach()
        if name.endswith(EXPERT_LEAVES):
            want = want[2:]
        assert leaf.requires_grad and leaf.is_leaf, name
        torch.testing.assert_close(leaf.detach(), want, rtol=0, atol=0)


@pytest.mark.parametrize("spec,overrides,match", [
    ({"pipe": 2}, {}, "GPipe"),
], ids=["pipe"])
def test_unported_axes_raise(spec, overrides, match):
    """The dense and MoE trainers refuse a `pipe` axis (the GPipe pipeline
    trains over it)."""
    class Mesh:
        mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

        def size(self, dim):
            return spec.get(self.mesh_dim_names[dim], 1)

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            return object()

    with pytest.raises(NotImplementedError, match=match):
        ttrain.make_train_step(ttr.TransformerConfig(**{**DIMS, **overrides}),
                               Mesh())
