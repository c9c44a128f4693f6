"""The yardstick: the card's published peaks and the operations and bytes
that the measured work needs, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
full 700 W limit. Counts follow what the inputs need, never what a kernel
happens to do: attention counts only the (query, key) pairs the causal mask
keeps, and a product recomputed by a kernel is not counted twice."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# Products of S x S x D over the kept pairs per attention call: the
# forward takes Q K^T and P V; the backward needs dP = dO V^T,
# dV = P^T dO, dQ = dS K and dK = dS^T Q. Flash attention's recompute of
# Q K^T in the backward (it keeps no P) is the kernel's choice, not
# counted.
ATTN_FWD_PRODUCTS = 2
ATTN_BWD_PRODUCTS = 4


def causal_pairs(seq_len: int) -> int:
    """(query, key) pairs a causal mask keeps in one sequence."""
    return seq_len * (seq_len + 1) // 2


def attention_flops(products: int, batch: int, seq_len: int, n_heads: int,
                    head_dim: int) -> float:
    """Operations of `products` S x S x D products over one attention
    call's kept pairs (a multiply and an add each)."""
    return 2.0 * products * causal_pairs(seq_len) * head_dim * batch * n_heads


def matmul_params(model: dict) -> int:
    """Parameters that enter a matrix product for every token: each
    layer's projections and MLP, and the output head (the embedding is a
    lookup). For a mixture of experts, the experts a token is routed to."""
    d, f = model["hidden_size"], model["intermediate_size"]
    per_layer = 4 * d * d + 3 * d * f
    return model["num_hidden_layers"] * per_layer + d * model["vocab_size"]


def train_flops_per_token(model: dict, seq_len: int) -> float:
    """Model operations of one trained token, forward and backward, no
    recompute: 6 per matrix parameter, plus the causal attention products
    (Q K^T and P V forward, twice each backward), averaged over the
    sequence's tokens."""
    d = model["hidden_size"]
    attn = (3 * attention_flops(2, 1, seq_len, model["num_attention_heads"],
                                d // model["num_attention_heads"])
            * model["num_hidden_layers"])
    return 6.0 * matmul_params(model) + attn / seq_len


def adamw_bytes(numels_and_sizes) -> int:
    """Bytes one AdamW step must move: per leaf, read the parameter, its
    gradient and both moments, and write the parameter and both moments,
    each at its element size. `numels_and_sizes`: (numel, bytes per
    element) per leaf."""
    return sum(7 * n * size for n, size in numels_and_sizes)


def attention_bytes(backward: bool, batch: int, seq_len: int, n_heads: int,
                    head_dim: int, elem: int) -> int:
    """Bytes one attention call must move: each [B, S, H, D] operand read
    once and each output written once, with the f32 row statistics."""
    big = batch * seq_len * n_heads * head_dim * elem
    row = batch * n_heads * seq_len * 4
    if backward:  # read q, k, v, o, dO, lse; write dq, dk, dv
        return 8 * big + row
    return 4 * big + row  # read q, k, v; write o and lse


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take for the work (the larger of its
    operations over the bf16 peak and its bytes over the memory rate),
    as a share of the time it took, in percent."""
    least = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / seconds
