"""The port's mesh and partition rules (dynolog_tpu_torch.parallel.sharding)
held against the JAX package's (dynolog_tpu.parallel.sharding): the same
mesh factorization, the same rules as data, the same rule per leaf of the
MoE parameter tree, and ranks placed in the mesh in row-major order, as
the JAX package reshapes its device list."""

import jax
import numpy as np
import pytest
import torch

from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.parallel import sharding as jsh
from dynolog_tpu_torch.models.convert import params_from_jax
from dynolog_tpu_torch.parallel import launch
from dynolog_tpu_torch.parallel import sharding as tsh

# The JAX package's meshes of the parallel forms the port runs.
MESHES = [{"model": 2}, {"seq": 2}, {"seq": 4}, {"data": 2, "seq": 4},
          {"data": 2, "seq": 2, "model": 2}, {"expert": 2, "model": 2}]


def _mesh_id(spec):
    return "x".join(f"{k}{v}" for k, v in spec.items())


class _At:
    """A stand-in mesh at one rank's coordinates: the DeviceMesh methods
    sharding.axis reads."""

    mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return int(self.coord[self.mesh_dim_names.index(name)])

    def get_group(self, name):
        return object()


def _placed(spec):
    """(the mesh's shape, shards): shards(array) lists (rank, block) of an
    array the JAX package placed on MeshSpec(**spec), the rank being the
    row-major index of the block's device in the mesh, as make_mesh lays
    ranks out."""
    shape = jsh.MeshSpec(**spec).shape
    devices = list(jsh.make_mesh(jsh.MeshSpec(**spec)).devices.flat)
    return shape, lambda arr: [(devices.index(sh.device), np.asarray(sh.data))
                               for sh in arr.addressable_shards]


@pytest.mark.parametrize("n", range(1, 17))
def test_for_devices_matches_jax(n):
    ours, ref = tsh.MeshSpec.for_devices(n), jsh.MeshSpec.for_devices(n)
    assert ours.shape == ref.shape
    assert ours.axis_names == ref.axis_names
    assert np.prod(ours.shape) == n


def test_param_rules_match_jax_as_data():
    assert list(tsh.PARAM_RULES) == list(jsh.PARAM_RULES)
    assert tsh.PARAM_RULES == {k: tuple(v)
                               for k, v in jsh.PARAM_RULES.items()}


def test_rule_per_leaf_matches_jax():
    cfg = jtr.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=4, d_ff=64, n_experts=4)
    tree = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), cfg))
    paths = [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]
    assert "layers/1/experts_down" in paths and "layers/0/router" in paths
    for path in paths:
        assert tsh.rule_for(path) == tuple(jsh._rule_for(path)), path


def _coords(rank, world, shape):
    mesh = tsh.make_mesh(tsh.MeshSpec(*shape), "cpu")
    import torch.distributed as dist

    return {name: (tsh.axis(mesh, name)[1],
                   sorted(dist.get_process_group_ranks(mesh.get_group(name))))
            for name in mesh.mesh_dim_names}


def test_free_port_lies_below_the_ephemeral_range():
    """The rendezvous port is one no socket is bound to and one the kernel
    does not hand out on its own (bind to port 0, outgoing connections):
    a port in the ephemeral range can be taken between its release and
    the rendezvous' bind."""
    import socket

    for _ in range(20):
        port = launch.free_port()
        assert port in launch.PORTS and port < 32768
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("localhost", port))


def test_make_mesh_places_ranks_row_major():
    """MeshSpec(data=2, expert=2) on 4 gloo processes: rank r sits at the
    row-major coordinate of r; the expert groups are {0, 1} and {2, 3},
    the data groups {0, 2} and {1, 3}."""
    shape = (2, 1, 1, 2, 1)
    ranks = launch.spawn(_coords, 4, "gloo", (shape,), timeout_s=60)
    for r, got in enumerate(ranks):
        want = np.unravel_index(r, shape)
        assert tuple(got[n][0] for n in tsh.MeshSpec().axis_names) == want
    assert ranks[0]["expert"][1] == [0, 1] and ranks[3]["expert"][1] == [2, 3]
    assert ranks[0]["data"][1] == [0, 2] and ranks[3]["data"][1] == [1, 3]


@pytest.mark.parametrize("spec", MESHES, ids=_mesh_id)
def test_local_batch_matches_jax_placement(spec):
    """Each rank's tokens are the block JAX's batch_sharding places on its
    device; its targets are the next tokens, so the targets of one data
    row's seq chunks, in order, are that row's tokens[:, 1:]."""
    mesh = jsh.make_mesh(jsh.MeshSpec(**spec))
    tokens = np.arange(4 * 16).reshape(4, 16)
    shape, shards = _placed(spec)
    targets = {}
    for rank, block in shards(jax.device_put(tokens,
                                             jsh.batch_sharding(mesh))):
        coord = np.unravel_index(rank, shape)
        mine, target = tsh.local_batch(torch.from_numpy(tokens),
                                       _At(shape, coord))
        np.testing.assert_array_equal(mine.numpy(), block)
        targets.setdefault(coord[0], {})[coord[1]] = target.numpy()
    rows = 4 // spec.get("data", 1)
    for d, chunks in targets.items():
        got = np.concatenate([chunks[c] for c in sorted(chunks)], axis=1)
        np.testing.assert_array_equal(got, tokens[d * rows:(d + 1) * rows,
                                                  1:])


@pytest.mark.parametrize("spec", MESHES, ids=_mesh_id)
def test_shard_params_matches_jax_placement(spec):
    """Each rank's slice of every leaf is the block the JAX package's
    make_train_state places on its device (PARAM_RULES over the mesh)."""
    cfg = jtr.TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                                n_heads=4, d_ff=64, dtype="float32",
                                n_experts=4 if "expert" in spec else 0)
    mesh = jsh.make_mesh(jsh.MeshSpec(**spec))
    with mesh:
        params, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, mesh)
    whole = params_from_jax(jax.tree_util.tree_map(np.array, params), "cpu",
                            torch.float32)
    shape, shards = _placed(spec)
    mine = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        for rank, block in shards(leaf):
            if rank not in mine:
                mine[rank] = tsh.shard_params(
                    whole, _At(shape, np.unravel_index(rank, shape)))
            tree = mine[rank]
            for key in name.split("/"):
                tree = tree[int(key)] if isinstance(tree, list) else tree[key]
            assert tree.is_leaf and tree.requires_grad, name
            np.testing.assert_array_equal(tree.detach().numpy(), block,
                                          err_msg=f"{name} on rank {rank}")
