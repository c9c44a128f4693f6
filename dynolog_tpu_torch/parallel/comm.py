"""Collectives that autograd differentiates, as conjugate pairs.

A collective inside a model must say what its gradient is, and that
depends on how the ranks of the group use the result, not on the
collective alone. ``torch.distributed.nn.functional.all_reduce`` always
sums gradients in its backward; where every rank of the group computes
the same loss from the same replicated value, that counts the gradient
once per rank. Three forms cover the uses here (Megatron-LM's f and g,
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
  the model calls it twice per MoE layer and step.

With `group` None each is the identity.
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


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOverGroup.apply(x, group)


def all_gather(x: torch.Tensor, size: int, group) -> torch.Tensor:
    """[size, *x.shape]: every rank's `x`, in rank order (no gradient)."""
    if group is None:
        return x[None]
    out = x.new_empty((size * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(size, *x.shape)
