"""GPipe pipeline parallelism over the mesh's `pipe` axis: the counterpart
of ``dynolog_tpu/parallel/pipeline.py``, under the same names.

The layer stack is cut into `pipe` contiguous stages: coordinate p of the
`pipe` group holds layers [p * L / pipe, (p + 1) * L / pipe)
(``stage_params``), and embedding, w_out and final_scale whole. Each
`data` rank takes its rows of the global batch and cuts them into
`n_micro` microbatches, which flow through the stages in the GPipe
schedule: at tick t, stage p holds microbatch t - p. Stage 0 embeds,
every stage runs its layers, and the last stage runs the head and the
mean NLL over [n_micro, mb, S - 1]. Other mesh axes of size > 1 hold
replicas, as the JAX package's ``in_specs`` make them. Only the dense
model with reference attention is staged, as in the JAX package.

Design. The JAX package differentiates one ``lax.scan`` over the ticks, in
which every device runs every tick, bubbles included, and the transpose
of ``ppermute`` carries the cotangents back. A literal port, autograd
through a chain of differentiable sends and receives, deadlocks easily:
on a stage whose loss is 0 no backward pass reaches its handoff nodes; on
stage 0 the received activations are unused, so their nodes are not even
in its graph; and the autograd engine's order among independent roots is
not a contract. So this module runs PyTorch's own GPipe idiom, an
explicit schedule. Each stage runs the forward of every microbatch,
receiving its input from the previous stage and sending its output to
the next, and keeps (input, output) per microbatch. Then it runs the
backwards in reverse order: the last stage seeds each microbatch's loss
with 1 / n_micro; every other stage receives its output's gradient from
the next stage and calls ``torch.autograd.backward(output, grad)``; and
every stage but the first sends its input's gradient back. The handoffs
(``comm.send_to``, ``comm.recv_from``) are point-to-point transfers
outside autograd; an input arrives detached and requires grad. Every
pair of stages posts its transfers in the same order, so no cycle can
form. The function and its gradients are JAX's; the bubble ticks, which
JAX computes on zeros, contribute nothing and are not run.

The gradients of embedding, w_out and final_scale are summed over `pipe`
(only stage 0, or only the last stage, holds a non-zero part), as
``shard_map``'s transpose of a replicated input sums them; then every
leaf and the loss are averaged over `data`. After a step the replicated
leaves are bit-equal on every `pipe` rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dynolog_tpu_torch.models.train import _mean_over_data, make_optimizer
from dynolog_tpu_torch.models.transformer import (
    TransformerConfig, _attention, _mlp, _rmsnorm, init_params, param_leaves)
from dynolog_tpu_torch.parallel import comm
from dynolog_tpu_torch.parallel.sharding import axis

# Leaves every stage holds whole.
REPLICATED = ("embedding", "w_out", "final_scale")


def check_pipeline(cfg: TransformerConfig, mesh) -> None:
    """ValueError for a model the pipeline cannot stage over `mesh`: MoE
    layers, attention other than "reference", or a layer count that does
    not divide into the `pipe` stages."""
    if cfg.n_experts != 0 or cfg.attn_impl != "reference":
        raise ValueError("the pipeline path supports the dense/reference "
                         "transformer config (n_experts == 0 and "
                         "attn_impl == 'reference')")
    n_stages = axis(mesh, "pipe")[0]
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"pipe={n_stages} stages")


def stage_layers(n_layers: int, mesh) -> range:
    """Indices of the layers this rank's stage holds."""
    n_stages, p, _ = axis(mesh, "pipe")
    per = n_layers // n_stages
    return range(p * per, (p + 1) * per)


def stage_params(params: dict, mesh) -> dict:
    """This rank's stage of a whole parameter tree: its block of layers
    and the replicated leaves (the same tensors, not copies)."""
    tree = {name: params[name] for name in REPLICATED}
    tree["layers"] = [params["layers"][i]
                      for i in stage_layers(len(params["layers"]), mesh)]
    return tree


def init_pipeline_params(cfg: TransformerConfig, mesh, device="cuda",
                         generator: torch.Generator | None = None) -> dict:
    """Parameters of this rank's stage: the whole tree drawn as
    ``init_params`` draws it with `generator` (so every rank, and the
    one-process trainer, draws the same weights), its block of layers
    kept."""
    check_pipeline(cfg, mesh)
    return stage_params(init_params(cfg, device, generator), mesh)


def make_pipeline_train_state(cfg: TransformerConfig, mesh, device="cuda",
                              generator: torch.Generator | None = None,
                              lr: float = 3e-4):
    """(params, optimizer) of this rank's stage; the optimizer is the
    dense trainer's fused AdamW."""
    params = init_pipeline_params(cfg, mesh, device, generator)
    return params, make_optimizer(params, lr)


def _stage_forward(layers: list, x, positions, cfg: TransformerConfig):
    for layer in layers:
        x = x + _attention(layer, _rmsnorm(x, layer["attn_scale"]),
                           positions, cfg)
        x = x + _mlp(layer, _rmsnorm(x, layer["mlp_scale"]), None)
    return x


def _head_loss(params: dict, x, tokens):
    """Mean next-token NLL of one microbatch [mb, S] from the last
    layer's output."""
    logits = (_rmsnorm(x, params["final_scale"]) @ params["w_out"]).float()
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logprobs, -1, tokens[:, 1:, None]).mean()


def _data_rows(tokens, mesh):
    size, rank, _ = axis(mesh, "data")
    if tokens.shape[0] % size:
        raise ValueError(f"{tokens.shape[0]} rows do not split over "
                         f"data={size}")
    rows = tokens.shape[0] // size
    return tokens[rank * rows:(rank + 1) * rows]


def pipeline_loss(params: dict, tokens, cfg: TransformerConfig, mesh,
                  n_micro: int):
    """Next-token loss of the global batch `tokens` [B, S] under the GPipe
    schedule; B must divide by data x n_micro. `params` is this rank's
    stage (``stage_params``).

    Unlike the JAX package's pure function, this one also runs the
    backward: it returns the loss (detached, the same on every rank) and
    leaves in each leaf's ``.grad`` the gradient of that loss, summed
    over `pipe` for the replicated leaves and averaged over `data`.
    Gradients are added to what ``.grad`` holds, so the caller zeroes
    them first, as the train step does."""
    check_pipeline(cfg, mesh)
    n_stages, p, group = axis(mesh, "pipe")
    first, last = p == 0, p == n_stages - 1
    tokens = _data_rows(tokens, mesh)
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"{b} rows of a data rank do not split into "
                         f"n_micro={n_micro} microbatches")
    micro = tokens.reshape(n_micro, b // n_micro, s)
    positions = torch.arange(s, device=tokens.device).expand(b // n_micro, s)
    embedding = params["embedding"]

    saved = []
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for m in range(n_micro):
        if first:
            x = embedding[micro[m]]
        else:
            x = comm.recv_from(
                embedding.new_empty((b // n_micro, s, cfg.d_model)),
                p - 1, group).requires_grad_(True)
        y = _stage_forward(params["layers"], x, positions, cfg)
        if last:
            y = _head_loss(params, y, micro[m])
            total += y.detach()
        else:
            comm.send_to(y.detach(), p + 1, group)
        saved.append((x, y))
    for m in reversed(range(n_micro)):
        x, y = saved.pop()
        grad = (torch.full_like(y, 1.0 / n_micro) if last
                else comm.recv_from(torch.empty_like(y), p + 1, group))
        torch.autograd.backward(y, grad)
        if not first:
            comm.send_to(x.grad, p - 1, group)

    loss = total / n_micro
    for name in REPLICATED:
        if params[name].grad is None:
            params[name].grad = torch.zeros_like(params[name])
    if group is not None:
        # psum over `pipe`: the loss lives on the last stage, each
        # replicated leaf's gradient on the stage that uses it.
        for t in [params[name].grad for name in REPLICATED] + [loss]:
            dist.all_reduce(t, group=group)
    _mean_over_data([leaf.grad for leaf in param_leaves(params)] + [loss],
                    mesh)
    return loss


def make_pipeline_train_step(cfg: TransformerConfig, mesh, n_micro: int):
    """Returns step(params, optimizer, tokens) -> loss: ``pipeline_loss``
    on the global batch, then the optimizer's step. Like the dense
    trainer's step it updates `params` and the optimizer state in place
    (the JAX step returns new ones) and returns the loss as a 0-dim
    tensor on the device. The learning rate is the optimizer's."""
    check_pipeline(cfg, mesh)

    def step(params, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = pipeline_loss(params, tokens, cfg, mesh, n_micro)
        optimizer.step()
        return loss

    return step
