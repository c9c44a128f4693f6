"""Training step for the flagship workload: AdamW over the transformer of
``models.transformer``, the counterpart of ``dynolog_tpu/models/train.py``.

The JAX step is a pure function returning new parameters and optimizer
state. This one updates the parameters and the optimizer's state in
place (PyTorch's idiom; it keeps one copy of each in device memory) and
returns only the loss.

Under a mesh (``parallel.sharding.make_mesh``, axes `data`, `seq`,
`model` and `expert`) every process calls the same step on the same
global batch; each trains its block of it (its rows over `data`, its
chunk over `seq`) with its slice of the parameters, and the step computes
the JAX package's global function: the loss of the whole batch and, for
each leaf, the gradient of that loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dynolog_tpu_torch import resolve_device
from dynolog_tpu_torch.models.transformer import (
    TransformerConfig, check_supported, init_params, loss_fn, param_leaves)
from dynolog_tpu_torch.parallel.sharding import axis, local_batch, shard_params


def make_optimizer(params: dict, lr: float = 3e-4) -> torch.optim.AdamW:
    """The counterpart of ``optax.adamw(lr, weight_decay=0.01)``: both
    decouple the weight decay, decay every leaf, and keep the moments in
    the parameters' dtype. Fused: one pass over each group of tensors of
    one device and dtype reads p, g and both moments and writes p and the
    moments, as XLA fuses optax's update into the jitted step."""
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01, fused=True)


def make_train_state(cfg: TransformerConfig, device="cuda",
                     generator: torch.Generator | None = None,
                     lr: float = 3e-4, mesh=None):
    """(params, optimizer) on `device`, parameters drawn with `generator`.
    With a mesh, every process draws the whole tree from the same seed and
    keeps its slice (``shard_params``)."""
    params = init_params(cfg, device, generator)
    if mesh is not None:
        params = shard_params(params, mesh)
    return params, make_optimizer(params, lr)


def _sum_over_seq(tensors: list, mesh) -> None:
    """Each tensor replaced in place by its sum over `seq`."""
    group = axis(mesh, "seq")[2]
    if group is None:
        return
    for t in tensors:
        dist.all_reduce(t, group=group)


def _mean_over_data(tensors: list, mesh) -> None:
    """Each tensor replaced in place by its mean over `data`."""
    size, _, group = axis(mesh, "data")
    if group is None:
        return
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(size)


def make_train_step(cfg: TransformerConfig, mesh=None):
    """Returns step(params, optimizer, tokens) -> loss. The step updates
    `params` and the optimizer state IN PLACE (unlike the JAX package's
    pure step) and returns the loss as a 0-dim tensor on the device, not
    synchronised.

    With a mesh, `tokens` is the global batch (the same on every process)
    and the loss returned is the global batch's. Each rank's loss is its
    chunk's part of its data row's loss (with MoE, plus 1 / seq of the
    global aux loss), and every leaf is replicated over `seq`, so the
    gradients and the loss are summed over `seq`, then
    averaged over `data`: expert leaves among the ranks that hold the
    same experts. Over `model` and `expert` the collectives' conjugates
    (``parallel.comm``) already give every rank the whole gradient of its
    slice, and the replicated leaves come out equal."""
    check_supported(cfg, mesh)

    def step(params, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        tokens, targets = local_batch(tokens, mesh)
        loss = loss_fn(params, tokens, cfg, mesh, targets)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            tensors = [p.grad for p in param_leaves(params)] + [loss]
            _sum_over_seq(tensors, mesh)
            _mean_over_data(tensors, mesh)
        optimizer.step()
        return loss

    return step


def make_batch(generator: torch.Generator, cfg: TransformerConfig,
               batch_size: int, seq_len: int, device="cuda"):
    """Random tokens [batch_size, seq_len] in [0, vocab), drawn with
    `generator` (which must live on `device`)."""
    return torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                         generator=generator, device=resolve_device(device))
