"""Ring attention: exact causal attention with the sequence cut over the
mesh's `seq` axis, the counterpart of
``dynolog_tpu/parallel/ring_attention.py``.

Each rank keeps its query chunk while the key/value chunks rotate one hop
per step around the `seq` group (``comm.ring_shift``, where the JAX
package calls ``jax.lax.ppermute``). The online-softmax m/l recurrence of
flash attention is carried across the steps in f32, so the result is full
causal attention, not an approximation, and no rank holds more than its
own chunk's keys. Autograd differentiates through the shifts: a chunk's
gradient travels back around the ring to the rank that computed it, as
JAX's scan + ppermute VJP sends it.

The JAX package runs no Pallas kernel here; the products stay plain
einsums.
"""

from __future__ import annotations

import torch

from dynolog_tpu_torch.parallel import comm
from dynolog_tpu_torch.parallel.sharding import axis

_NEG_INF = -1e30


def _causal_mask(q_idx: int, k_idx: int, s_loc: int, device) -> torch.Tensor:
    """[S_loc, S_loc] bool: query chunk `q_idx` may see key chunk `k_idx`'s
    key, by global positions (chunk index * S_loc + offset)."""
    iota = torch.arange(s_loc, device=device)
    return (q_idx * s_loc + iota)[:, None] >= (k_idx * s_loc + iota)[None, :]


def ring_attention_local(q, k, v, n: int, my_idx: int, group,
                         causal: bool = True) -> torch.Tensor:
    """This rank's attention output. q, k, v: its [B, S_local, H, D]
    chunks, coordinate `my_idx` of the `n` ranks of `group` (None for
    n = 1); returns [B, S_local, H, D] in q's dtype."""
    b, s_loc, h, d = q.shape
    qf = q.float() * torch.rsqrt(torch.tensor(float(d))).to(q.device)
    m = torch.full((b, h, s_loc), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_loc), device=q.device)
    acc = torch.zeros((b, s_loc, h, d), device=q.device)
    kv, src = torch.stack((k, v)), my_idx
    for step in range(n):
        # Scores against the chunk resident here, which came from `src`.
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kv[0].float())
        if causal:
            s = torch.where(_causal_mask(my_idx, src, s_loc, q.device), s,
                            _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, kv[1].float())
        m = m_new
        # n - 1 rotations: the last chunk is consumed where it lands.
        if step < n - 1:
            kv, src = comm.ring_shift(kv, group), (src - 1) % n
    l = torch.where(l == 0.0, 1.0, l)  # fully masked rows (never causal)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence cut over the mesh's `seq` axis.
    q, k, v: this rank's [B_local, S_local, H_local, D] blocks (its rows
    of the batch, its chunk of the sequence); returns its block of the
    output. The JAX package's function names its batch and sequence axes
    for shard_map; the port's blocks are already local, and `seq` is the
    mesh's one sequence axis.

    The JAX package keeps the heads replicated over `model` here, so XLA
    gathers them and every `model` rank computes every head. The port
    computes only this rank's heads (the columns of wq/wk/wv it holds):
    attention is the same function head by head, so the result is the
    same, and ``models.transformer`` sums the heads' output projections
    over `model`."""
    n, my_idx, group = axis(mesh, "seq")
    return ring_attention_local(q, k, v, n, my_idx, group, causal)
