"""Rank bodies of the port's multi-process parity tests
(tests/test_torch_ring_attention.py, tests/test_torch_tensor_parallel.py,
tests/test_torch_seq_parallel.py, tests/test_torch_pipeline.py), and the
helpers they share that import no JAX.

``parallel.launch.spawn`` starts each rank with the 'spawn' method, which
re-imports the module of the rank's function by name. The test modules
import JAX; this one imports only torch, numpy and the port, so a rank
starts in about half the time and the gloo ranks load the CPUs less.

Each body calls ``torch.set_num_threads(1)``: a test spawns up to 8 ranks
beside the other test workers. A `fault` names a planted fault that the
test's comparison must reject; the body plants it in its own process.
"""

import numpy as np
import torch
import torch.distributed as dist

from dynolog_tpu_torch.models import moe, train, transformer
from dynolog_tpu_torch.models.convert import params_from_jax
from dynolog_tpu_torch.parallel import comm, pipeline, sharding
from dynolog_tpu_torch.parallel import ring_attention as ring

AXES = ("data", "seq", "model", "expert")


def named(tree) -> dict:
    """{path: leaf} with PARAM_RULES' paths ("layers/0/wq")."""
    out = {n: tree[n] for n in ("embedding", "w_out", "final_scale")}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{i}/{n}": v for n, v in layer.items()})
    return out


class OneRank:
    """A stand-in mesh of one rank: the DeviceMesh methods sharding.axis
    reads, every axis of size 1."""

    mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

    def size(self, dim):
        return 1


def block_of(grad, path, spec, coord):
    """This rank's block of a whole leaf's gradient, by PARAM_RULES."""
    for dim, name in enumerate(sharding.rule_for(path)):
        size = spec.get(name, 1) if name else 1
        block = grad.shape[dim] // size
        grad = np.take(grad, range(coord[name] * block,
                                   (coord[name] + 1) * block), axis=dim) \
            if size > 1 else grad
    return grad


def one_process(dims, np_params, tokens):
    """(loss, {path: gradient}) of one train step of the port on one
    process, f32, from the JAX package's parameters on the global batch
    `tokens`; ring attention runs on a OneRank mesh (the ring consumes its
    one chunk)."""
    cfg = transformer.TransformerConfig(**dims)
    params = params_from_jax(np_params, "cpu", torch.float32)
    mesh = OneRank() if cfg.attn_impl == "ring" else None
    loss = train.make_train_step(cfg, mesh)(
        params, train.make_optimizer(params), torch.from_numpy(tokens))
    return float(loss), {n: p.grad.numpy() for n, p in named(params).items()}


def _chunks_in_rank_order(counts, mesh):
    """moe._chunks_before with the chunks taken in rank order (d, q, row)
    instead of global token order (d, row, q): the same whenever a rank
    holds one row."""
    d_size, d_rank, d_group = sharding.axis(mesh, "data")
    q_size, q_rank, q_group = sharding.axis(mesh, "seq")
    every = comm.all_gather(comm.all_gather(counts, q_size, q_group),
                            d_size, d_group)
    flat = every.reshape(-1, *counts.shape[1:])
    before = (torch.cumsum(flat, 0) - flat).reshape(every.shape)
    return before[d_rank, q_rank], flat.sum(0)


def _plant(fault) -> None:
    if fault is None:
        return
    if fault == "gather_with_narrow_backward":
        comm.gather_over_group = comm.gather_from_group
    elif fault == "positions_in_rank_order":
        moe._chunks_before = _chunks_in_rank_order
    elif fault == "aux_on_every_seq_rank":
        forward = transformer._forward_with_aux

        def whole_aux(params, tokens, cfg, mesh=None):
            logits, aux = forward(params, tokens, cfg, mesh)
            return logits, aux * sharding.axis(mesh, "seq")[0]

        transformer._forward_with_aux = whole_aux
    elif fault == "mask_without_src_offset":
        mask = ring._causal_mask
        ring._causal_mask = lambda q_idx, k_idx, s_loc, device: mask(
            q_idx, 0, s_loc, device)
    elif fault == "positions_without_seq_offset":
        positions = transformer.token_positions
        transformer.token_positions = lambda tokens, mesh=None: positions(
            tokens)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _coords(mesh) -> dict:
    return {a: sharding.axis(mesh, a)[1] for a in AXES}


def ring_rank(rank, world, spec, q, k, v, g, fault=None):
    """Ring attention on this rank's block of global q, k, v ([B, S, H, D]
    numpy), its output's gradient given by `g`: (coordinates, output,
    dq, dk, dv) of the block."""
    torch.set_num_threads(1)
    _plant(fault)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    coord = _coords(mesh)
    rows = q.shape[0] // spec.get("data", 1)
    cols = q.shape[1] // spec.get("seq", 1)

    def block(x):
        r, c = coord["data"] * rows, coord["seq"] * cols
        return torch.from_numpy(x[r:r + rows, c:c + cols].copy())

    qb, kb, vb = (block(x).requires_grad_(True) for x in (q, k, v))
    out = ring.ring_attention(qb, kb, vb, mesh)
    out.backward(block(g))
    return (coord, out.detach().numpy(),
            *(x.grad.numpy() for x in (qb, kb, vb)))


def train_rank(rank, world, spec, dims, np_params, tokens, fault=None):
    """One train step of the port under MeshSpec(**spec), f32, from the
    JAX package's parameters (numpy tree, each rank keeps its slice) on
    the global batch `tokens`: its loss, coordinates and every leaf's
    gradient after the step."""
    torch.set_num_threads(1)
    _plant(fault)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    cfg = transformer.TransformerConfig(**dims)
    params = sharding.shard_params(
        params_from_jax(np_params, "cpu", torch.float32), mesh)
    step = train.make_train_step(cfg, mesh)
    loss = step(params, train.make_optimizer(params), torch.from_numpy(
        np.asarray(tokens, np.int64)))
    return {"loss": float(loss), "coord": _coords(mesh),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in named(params).items()}}


def comm_rank(rank, world):
    """ring_shift and gather_from_group over the whole group, forward and
    backward, on values that name their rank: (shifted, its input's
    gradient, gathered, its input's gradient)."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    x = torch.full((2, 3), float(rank), requires_grad=True)
    shifted = comm.ring_shift(x, group)
    # The gradient of the shifted value is 10 x its receiver's rank.
    shifted.backward(torch.full_like(shifted, 10.0 * rank))
    y = (torch.arange(2.0) + 10 * rank).requires_grad_(True)
    gathered = comm.gather_from_group(y[None], -1, group)
    gathered.backward(torch.arange(2.0 * world)[None])
    return (shifted.detach().numpy(), x.grad.numpy(),
            gathered.detach().numpy(), y.grad.numpy())


def gather_rank(rank, world, fault=None):
    """gather_over_group over the whole group along dim -2 of a [2, 3, 4]
    value, under a loss that differs by rank (the gathered value weighted
    by 1 + rank): (gathered, its input's gradient)."""
    torch.set_num_threads(1)
    _plant(fault)
    x = (torch.arange(24.0).reshape(2, 3, 4) + 100 * rank).requires_grad_(
        True)
    gathered = comm.gather_over_group(x, -2, dist.group.WORLD)
    weight = torch.arange(float(gathered.numel())).reshape(gathered.shape)
    (gathered * weight * (1 + rank)).sum().backward()
    return gathered.detach().numpy(), x.grad.numpy()


def _plant_in_pipeline(fault, mesh, params) -> None:
    """Plants a fault of the pipeline in this rank's process:
    "no_micro_scaling", each microbatch's loss seeded with 1 instead of
    1 / n_micro; "embedding_not_summed", the embedding's gradient left out
    of the sum over `pipe`; "handoff_to_wrong_stage", the handoffs
    follow the stage order 0, 2, 1, 3 (coordinates 1 and 2 swapped), so
    stage 0's activations go to coordinate 2."""
    if fault is None:
        return
    if fault == "no_micro_scaling":
        backward = torch.autograd.backward

        def unscaled(tensors, grad_tensors=None, **kwargs):
            if grad_tensors is not None and grad_tensors.dim() == 0:
                grad_tensors = torch.ones_like(grad_tensors)
            return backward(tensors, grad_tensors, **kwargs)

        torch.autograd.backward = unscaled
    elif fault == "embedding_not_summed":
        all_reduce = dist.all_reduce
        pipe_ranks = dist.get_process_group_ranks(mesh.get_group("pipe"))

        def skip_embedding(t, *args, group=None, **kwargs):
            grad = params["embedding"].grad
            if (grad is not None and t.data_ptr() == grad.data_ptr()
                    and group is not None
                    and dist.get_process_group_ranks(group) == pipe_ranks):
                return None
            return all_reduce(t, *args, group=group, **kwargs)

        dist.all_reduce = skip_embedding
    elif fault == "handoff_to_wrong_stage":
        swap = {1: 2, 2: 1}
        axis, send_to, recv_from = pipeline.axis, comm.send_to, comm.recv_from

        def swapped_axis(m, name):
            size, coord, group = axis(m, name)
            return size, (swap.get(coord, coord) if name == "pipe"
                          else coord), group

        pipeline.axis = swapped_axis
        comm.send_to = lambda x, coord, group: send_to(
            x, swap.get(coord, coord), group)
        comm.recv_from = lambda out, coord, group: recv_from(
            out, swap.get(coord, coord), group)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def pipe_rank(rank, world, spec, dims, np_params, tokens, n_micro,
              fault=None):
    """One step of the port's GPipe trainer under MeshSpec(**spec), f32,
    from the JAX package's pipeline parameters (numpy tree, each rank
    keeps its stage) on the global batch `tokens`: its loss, coordinates,
    each of its leaves' gradient (paths with the global layer index) and
    the replicated leaves after the step."""
    torch.set_num_threads(1)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    cfg = transformer.TransformerConfig(**dims)
    params = pipeline.stage_params(
        params_from_jax(np_params, "cpu", torch.float32), mesh)
    first = pipeline.stage_layers(cfg.n_layers, mesh)[0]
    _plant_in_pipeline(fault, mesh, params)
    step = pipeline.make_pipeline_train_step(cfg, mesh, n_micro)
    loss = step(params, train.make_optimizer(params), torch.from_numpy(
        np.asarray(tokens, np.int64)))
    grads = {n: params[n].grad.numpy().copy()
             for n in pipeline.REPLICATED}
    for i, layer in enumerate(params["layers"]):
        grads.update({f"layers/{first + i}/{n}": v.grad.numpy().copy()
                      for n, v in layer.items()})
    return {"loss": float(loss),
            "coord": {a: sharding.axis(mesh, a)[1] for a in ("data", "pipe")},
            "grads": grads,
            "replicated": {n: params[n].detach().numpy().copy()
                           for n in pipeline.REPLICATED}}
