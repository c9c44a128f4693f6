"""Mixture-of-Experts MLP, the counterpart of ``dynolog_tpu/models/moe.py``:
top-k routing with a fixed per-expert capacity, dense one-hot
dispatch/combine einsums, and the expert dimension split over the mesh's
`expert` axis.

The same function as the JAX package's, global over the mesh:

- routing in f32, the router leaf f32 whatever ``cfg.dtype`` is;
- top-k in a stable order: on equal probabilities the lowest expert index
  comes first, as ``jax.lax.top_k`` gives it (``torch.topk`` does not);
- slot priority: all first choices in global token order, then all
  second choices, and so on; the capacity counts the global batch;
- a choice past its expert's capacity is dropped (its dispatch and
  combine rows are zero), the kept gates are the renormalized top-k;
- dispatch in ``x.dtype``, combine computed in f32 and cast to it;
- the Switch load-balancing aux loss over the global batch.

Under a mesh (``parallel.sharding.make_mesh``) the batch's rows are
split over `data` and its sequence over `seq`, and both are replicated
over `expert` and `model`; each rank holds E / ep experts, each with
d_ff / tp of its hidden columns (EP x TP). Where XLA lowers the sharded
dispatch to collectives, this module calls them: an all-gather of
per-row (choice, expert) counts over `seq` and then over `data` (the
slots taken by the tokens before this rank's in global token order), a
sum of the dispatched slots over `data` and `seq`, the slots entering the
experts' column-cut products through f over `model` and their partial
outputs summed over `model`, a sum of the experts' outputs over
`expert`, and sums over `data` and `seq` for the aux loss's means
(``parallel.comm`` says how each differentiates). Routing, slot
positions and the aux loss are replicated over `model`; the aux loss is
the global one on every `data` and `seq` rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dynolog_tpu_torch.parallel import comm
from dynolog_tpu_torch.parallel.sharding import axis


def init_moe_layer(cfg, device, generator: torch.Generator | None = None
                   ) -> dict:
    """Router (f32) and stacked expert SwiGLU weights [E, d, f] / [E, f, d]
    in cfg.dtype, normal / sqrt(fan_in) drawn in f32 with `generator`."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / fan_in ** 0.5

    return {
        "router": normal((d, e), d),  # f32: routing numerics
        "experts_gate": normal((e, d, f), d).to(cfg.torch_dtype),
        "experts_up": normal((e, d, f), d).to(cfg.torch_dtype),
        "experts_down": normal((e, f, d), f).to(cfg.torch_dtype),
    }


def _capacity(n_tokens: int, cfg) -> int:
    cap = int(
        math.ceil(cfg.moe_top_k * n_tokens / cfg.n_experts * cfg.moe_capacity_factor)
    )
    return max(cap, 1)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties broken
    toward the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _chunks_before(counts: torch.Tensor, mesh) -> tuple:
    """counts: [B_local, k, E], the choices of each of this rank's rows
    (its chunk of each) to each expert -> ([B_local, k, E], the choices
    in the chunks before each of those in global token order; [k, E], the
    whole batch's).

    Global token order is row-major over the global [B, S] batch, and
    rank (d, q) holds chunk q of rows d * B_local ... (d + 1) * B_local - 1,
    so the chunks come in the order (d, row, q): a rank's rows interleave
    with the other `seq` ranks' chunks of them."""
    d_size, d_rank, d_group = axis(mesh, "data")
    q_size, q_rank, q_group = axis(mesh, "seq")
    every = comm.all_gather(comm.all_gather(counts, q_size, q_group),
                            d_size, d_group)  # [D, Q, B_local, k, E]
    ordered = every.transpose(1, 2)  # [D, B_local, Q, k, E]
    flat = ordered.reshape(-1, *counts.shape[1:])
    before = (torch.cumsum(flat, 0) - flat).reshape(ordered.shape)
    return before[d_rank, :, q_rank], flat.sum(0)


def _positions(choice: torch.Tensor, rows: int, mesh) -> torch.Tensor:
    """Slot of each (token, choice) in its expert's buffer, in integers:
    the number of earlier routed choices to the same expert, counting all
    choices of lower priority rank first and, within one priority rank,
    the tokens before this one in global token order (``_chunks_before``),
    then those before it in its chunk.
    choice: one-hot [T, k, E] int64, T = `rows` x S_local tokens in
    row-major order -> [T, k] int64."""
    t, k, e = choice.shape
    per_row = choice.reshape(rows, t // rows, k, e)
    earlier_in_chunk = torch.cumsum(per_row, 1) - per_row
    before, total = _chunks_before(per_row.sum(1), mesh)
    earlier_choices = torch.cumsum(total, 0) - total  # [k, E]
    pos = earlier_in_chunk + (before + earlier_choices)[:, None]
    return (pos * per_row).sum(-1).reshape(t, k)


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """x summed over each group in turn (``comm.sum_over_group``)."""
    for group in groups:
        x = comm.sum_over_group(x, group)
    return x


def moe_mlp(layer, x, cfg, mesh=None):
    """MoE feed-forward. x: [B, S, D] -> (y [B, S, D], aux_loss scalar).

    Under a mesh, x holds this rank's block of the batch (its rows, its
    chunk of the sequence) and `layer` its experts; y is this block's
    output and aux the global aux loss (the same on every rank)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    data_size, _, data_group = axis(mesh, "data")
    seq_size, _, seq_group = axis(mesh, "seq")
    ep_size, ep_rank, ep_group = axis(mesh, "expert")
    tp_group = axis(mesh, "model")[2]
    n_tokens = b * s
    n_global = n_tokens * data_size * seq_size
    cap = _capacity(n_global, cfg)
    e_local = layer["experts_gate"].shape[0]
    if e_local * ep_size != e:
        raise ValueError(f"{e_local} local experts x expert={ep_size} is not "
                         f"n_experts={e}")
    lo = ep_rank * e_local

    xf = x.reshape(n_tokens, d)
    # Routing in f32: tiny matmul, numerics matter.
    logits = xf.float() @ layer["router"]  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    choice = F.one_hot(gate_idx, e)  # [T, k, E] int64
    pos = _positions(choice, b, mesh)  # [T, k]
    keep = pos < cap
    # A dropped choice gets a zero slot row (jax.nn.one_hot of index cap).
    slot = F.one_hot(torch.where(keep, pos, 0), cap) * keep[..., None]

    # combine [T, k, E_local, C]: the gate weight at the (expert, slot)
    # this choice landed in, for this rank's experts; dispatch is its 0/1
    # skeleton.
    gates = comm.copy_to_group(gate_vals, ep_group)
    mask = (choice[:, :, lo:lo + e_local, None].float()
            * slot[:, :, None, :].float())
    combine = gates[..., None, None] * mask
    dispatch = (combine > 0.0).to(x.dtype)

    x_e = torch.einsum("tkec,td->ecd", dispatch,
                       comm.copy_to_group(xf, ep_group))  # [E_l, C, D]
    # Each data and seq rank filled the slots of its own tokens.
    for group in (data_group, seq_group):
        x_e = comm.reduce_from_group(x_e, group)
    x_e = comm.copy_to_group(x_e, tp_group)

    # Per-expert SwiGLU, batched over this rank's experts and hidden
    # columns; each model rank adds its columns' part.
    gate_p = torch.einsum("ecd,edf->ecf", x_e, layer["experts_gate"])
    up_p = torch.einsum("ecd,edf->ecf", x_e, layer["experts_up"])
    y_e = comm.reduce_from_group(
        torch.einsum("ecf,efd->ecd", F.silu(gate_p) * up_p,
                     layer["experts_down"]), tp_group)

    y = torch.einsum("tkec,ecd->td", combine.to(x.dtype), y_e)
    # Each expert rank added its experts' outputs.
    y = comm.reduce_from_group(y, ep_group)

    # Switch load-balancing aux loss (computed on primary assignments),
    # means over the global batch.
    routed = _sum_over(choice[:, 0, :].float().sum(0),
                       (data_group, seq_group))
    prob_sum = _sum_over(probs.sum(0), (data_group, seq_group))
    aux = torch.sum((routed / n_global) * (prob_sum / n_global)) * e

    return y.reshape(b, s, d), aux
