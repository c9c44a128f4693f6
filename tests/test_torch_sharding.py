"""The port's mesh and partition rules (dynolog_tpu_torch.parallel.sharding)
held against the JAX package's (dynolog_tpu.parallel.sharding): the same
mesh factorization, the same rules as data, the same rule per leaf of the
MoE parameter tree, and ranks placed in the mesh in row-major order, as
the JAX package reshapes its device list."""

import jax
import numpy as np
import pytest

from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.parallel import sharding as jsh
from dynolog_tpu_torch.parallel import launch
from dynolog_tpu_torch.parallel import sharding as tsh


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
