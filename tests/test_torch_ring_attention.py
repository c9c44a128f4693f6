"""Ring attention of the port (dynolog_tpu_torch.parallel.ring_attention)
held against the JAX package's, on gloo processes on the CPU.

The inputs are the JAX package's test inputs (tests/test_ops.py `_qkv`:
B=2, S=64, H=4, D=16, f32), with a random output gradient. The port's
ring runs on MeshSpec(seq=2) and MeshSpec(seq=4) (one process per rank,
each holding its chunk of the sequence); a ring of 2 would hide a
rotation index that runs the wrong way, since the next and the previous
rank are then the same one. The JAX package's ring runs on its
MeshSpec(data=2, seq=4) over 8 virtual CPU devices.

Tolerances are those of tests/test_ops.py: the output at 1e-5 against
JAX's ring and against the whole-sequence attention, the gradients of
q, k and v at 1e-4 against the whole-sequence attention's (JAX's
reference_attention under jax.grad). Planted faults (a mask without the
key chunk's offset) must fail the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from dynolog_tpu.ops.flash_attention import reference_attention as jax_attn
from dynolog_tpu.parallel.ring_attention import ring_attention as jax_ring
from dynolog_tpu.parallel.sharding import MeshSpec, make_mesh
from dynolog_tpu_torch.ops.flash_attention import reference_attention
from dynolog_tpu_torch.parallel import launch
from dynolog_tpu_torch.parallel import ring_attention as ring


@pytest.fixture(scope="module")
def case():
    """q, k, v, g and JAX's outputs: its ring's on MeshSpec(data=2,
    seq=4), the whole-sequence attention's and its gradients."""
    kq, kk, kv, kg = jax.random.split(jax.random.PRNGKey(5), 4)
    q, k, v, g = (jax.random.normal(key, (2, 64, 4, 16), jnp.float32)
                  for key in (kq, kk, kv, kg))
    mesh = make_mesh(MeshSpec(data=2, seq=4, model=1))
    ring_out = jax_ring(q, k, v, mesh, causal=True)
    full, vjp = jax.vjp(lambda q, k, v: jax_attn(q, k, v, causal=True),
                        q, k, v)
    grads = vjp(g)
    return {"inputs": [np.array(x) for x in (q, k, v, g)],
            "ring": np.asarray(ring_out), "full": np.asarray(full),
            "grads": [np.asarray(x) for x in grads]}


def _assemble(ranks, i, seq):
    """The global [B, S, H, D] array of output `i` from the ranks' blocks
    (the seq chunks in coordinate order)."""
    blocks = sorted(ranks, key=lambda r: r[0]["seq"])
    assert [r[0]["seq"] for r in blocks] == list(range(seq))
    return np.concatenate([r[i] for r in blocks], axis=1)


@pytest.fixture(scope="module")
def run(case):
    """run(seq, fault=None): the ranks' results of the port's ring on
    MeshSpec(seq=seq), each spawn made once per module."""
    done = {}

    def get(seq, fault=None):
        if (seq, fault) not in done:
            done[seq, fault] = launch.spawn(
                torch_mesh_ranks.ring_rank, seq, "gloo",
                ({"seq": seq}, *case["inputs"], fault), timeout_s=60)
        return done[seq, fault]

    return get


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_forward_matches_jax(case, run, seq):
    out = _assemble(run(seq), 1, seq)
    np.testing.assert_allclose(out, case["ring"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, case["full"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_gradients_match_jax(case, run, seq):
    ranks = run(seq)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(_assemble(ranks, 2 + i, seq),
                                   case["grads"][i], rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("seq", [2, 4])
def test_mask_without_src_offset_fails(case, run, seq):
    """Keys masked by their offset in their chunk, not by their global
    position: queries see keys of later chunks."""
    out = _assemble(run(seq, "mask_without_src_offset"), 1, seq)
    assert np.abs(out - case["full"]).max() > 1e-2


def test_one_rank_ring_is_whole_attention(case):
    """Without a `seq` cut (a mesh of one rank, here a stand-in) the ring
    consumes the one chunk and never shifts: the whole-sequence attention,
    forward and backward, in the input's dtype."""

    class Mesh:  # the DeviceMesh methods sharding.axis reads
        mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

        def size(self, dim):
            return 1

    q, k, v, g = (torch.from_numpy(x).requires_grad_(True)
                  for x in case["inputs"])
    out = ring.ring_attention(q, k, v, Mesh())
    out.backward(g.detach())
    np.testing.assert_allclose(out.detach().numpy(), case["full"], rtol=0,
                               atol=1e-5)
    for x, want in zip((q, k, v), case["grads"]):
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-4)
    bf16 = ring.ring_attention_local(*(x.detach().bfloat16()
                                       for x in (q, k, v)), 1, 0, None)
    assert bf16.dtype == torch.bfloat16


def test_non_causal_ring_chunk_is_plain_attention(case):
    q, k, v, _ = (torch.from_numpy(x) for x in case["inputs"])
    out = ring.ring_attention_local(q, k, v, 1, 0, None, causal=False)
    torch.testing.assert_close(out, reference_attention(q, k, v,
                                                        causal=False),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("q_idx,k_idx", [(0, 0), (1, 0), (0, 1), (3, 1)])
def test_causal_mask_uses_global_positions(q_idx, k_idx):
    """Chunk q_idx's queries see chunk k_idx's keys by global position:
    all of an earlier chunk, none of a later one, the lower triangle of
    their own."""
    mask = ring._causal_mask(q_idx, k_idx, 4, "cpu")
    want = (q_idx * 4 + np.arange(4))[:, None] >= (k_idx * 4
                                                   + np.arange(4))[None, :]
    np.testing.assert_array_equal(mask.numpy(), want)
