"""Collectives that autograd differentiates, as conjugate pairs.

A collective inside a model must say what its gradient is, and that
depends on how the ranks of the group use the result, not on the
collective alone. ``torch.distributed.nn.functional.all_reduce`` always
sums gradients in its backward; where every rank of the group computes
the same loss from the same replicated value, that counts the gradient
once per rank. These forms cover the uses here (Megatron-LM's f and g,
and the plain sum):

- ``copy_to_group`` (f): identity forward, all-reduce backward. A value
  replicated over the group that each rank uses differently (each for its
  own experts): the gradients of the uses add up.
- ``reduce_from_group`` (g): all-reduce forward, identity backward. Each
  rank holds a part of a sum that every rank then uses in the same way:
  each rank's loss already carries the whole gradient.
- ``sum_over_group``: all-reduce forward and backward. A sum over ranks
  whose losses differ, each depending on every rank's part. This is what
  ``torch.distributed.nn.functional.all_reduce`` computes, but PyTorch
  2.13 deprecates that function with a FutureWarning on every call, and
  the model calls it on every MoE layer and step.
- ``gather_from_group``: all-gather along a dimension forward, this
  rank's slice of the gradient backward. A value cut over the group (the
  embedding's columns, the logits' vocabulary) that every rank then uses
  whole in the same way: each rank's gradient of the whole value is
  already the whole gradient, so its slice is this rank's part.
- ``gather_over_group``: all-gather along a dimension forward,
  reduce-scatter backward. A value cut over the group (q, k and v cut
  over `seq`) that every rank uses whole but in its own way (each keeps
  its own chunk of the attention's output): the ranks' gradients of the
  whole value differ, so they are summed and each rank keeps its block.
  ``gather_from_group``'s backward would keep only this rank's own
  gradient of its block and drop what the other ranks' losses owe it
  (the later chunks' queries attend to this chunk's keys).
- ``ring_shift``: forward, each rank sends its value to the next
  coordinate of the group and receives the previous one's; backward, the
  gradient goes the other way. Ring attention rotates each K/V chunk one
  hop per step with it: a chunk's gradient returns to the rank that
  computed it.

With `group` None each is the identity.

The GPipe pipeline hands activations and their gradients between stages
with ``send_to`` and ``recv_from`` instead: point to point, not cyclic,
and outside autograd (``parallel.pipeline`` says why).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        size = dist.get_world_size(group)
        ctx.dim, ctx.rank, ctx.part = dim, dist.get_rank(group), x.shape[dim]
        return torch.cat(all_gather(x, size, group).unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.part, ctx.part), None, None


class _GatherOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(
            all_gather(x, dist.get_world_size(group), group).unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        size = dist.get_world_size(ctx.group)
        blocks = grad.unflatten(ctx.dim, (size, -1)).movedim(ctx.dim, 0)
        out = blocks.new_empty((blocks[0].numel(),))
        dist.reduce_scatter_tensor(out, blocks.contiguous().reshape(-1),
                                   group=ctx.group)
        return out.reshape(blocks.shape[1:]), None, None


def _p2p(group, send: torch.Tensor | None = None, dst: int = 0,
         recv: torch.Tensor | None = None, src: int = 0) -> None:
    """Sends `send` to coordinate `dst` of the group and receives into
    `recv` from coordinate `src`, either or both, in one batch; returns
    when both are done. P2POp takes global ranks."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, dst), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _shift(x: torch.Tensor, group, hops: int) -> torch.Tensor:
    """x sent `hops` coordinates up the group (mod its size); returns what
    arrives from `hops` coordinates down."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _p2p(group, x, (me + hops) % n, out, (me - hops) % n)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOverGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order."""
    return x if group is None else _GatherFromGroup.apply(x, dim, group)


def gather_over_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order; the
    gradient summed over the group, this rank's block kept."""
    if group is None:
        return x
    return _GatherOverGroup.apply(x, dim % x.dim(), group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The `x` of the previous coordinate of the group (the last one's on
    coordinate 0)."""
    return x if group is None else _RingShift.apply(x, group)


def send_to(x: torch.Tensor, coord: int, group) -> None:
    """Sends `x` to coordinate `coord` of the group (no gradient)."""
    _p2p(group, send=x, dst=coord)


def recv_from(out: torch.Tensor, coord: int, group) -> torch.Tensor:
    """`out`, filled with what coordinate `coord` of the group sends (no
    gradient)."""
    _p2p(group, recv=out, src=coord)
    return out


def all_gather(x: torch.Tensor, size: int, group) -> torch.Tensor:
    """[size, *x.shape]: every rank's `x`, in rank order (no gradient)."""
    if group is None:
        return x[None]
    out = x.new_empty((size * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(size, *x.shape)
