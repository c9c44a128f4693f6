"""The operations and bytes behind mfu, flash_roofline and adamw_roofline,
held to sums worked out by hand at a tiny size."""

import pytest

from perfbench import counts

TINY = {"hidden_size": 8, "intermediate_size": 12, "num_attention_heads": 2,
        "num_hidden_layers": 3, "vocab_size": 10}


def test_causal_pairs():
    assert counts.causal_pairs(4) == 4 + 3 + 2 + 1


def test_attention_flops_by_hand():
    # Two products of S x S x D over 10 kept pairs (S=4), D=4, B=1, H=2.
    assert counts.attention_flops(2, 1, 4, 2, 4) == 2 * 2 * 10 * 4 * 1 * 2


def test_matmul_params_by_hand():
    per_layer = 4 * 8 * 8 + 3 * 8 * 12
    assert counts.matmul_params(TINY) == 3 * per_layer + 8 * 10


def test_train_flops_per_token_by_hand():
    s = 4
    attn = 3 * (2 * 2 * 10 * 4 * 2) * 3  # fwd + 2x bwd, 3 layers
    want = 6 * counts.matmul_params(TINY) + attn / s
    assert counts.train_flops_per_token(TINY, s) == pytest.approx(want)


def test_adamw_bytes_by_hand():
    # Two leaves: 5 bf16 elements and 3 f32 elements; 7 moves each.
    assert counts.adamw_bytes([(5, 2), (3, 4)]) == 7 * 10 + 7 * 12


def test_flash_products_are_what_mfu_counts():
    """The backward needs dP, dV, dQ and dK: twice the forward's two
    products, as train_flops_per_token counts them; the kernels' recompute
    of Q K^T is not counted."""
    assert counts.ATTN_FWD_PRODUCTS == 2
    assert counts.ATTN_BWD_PRODUCTS == 2 * counts.ATTN_FWD_PRODUCTS == 4
    fwd_bwd = counts.attention_flops(
        counts.ATTN_FWD_PRODUCTS + counts.ATTN_BWD_PRODUCTS, 1, 4, 2, 4)
    assert fwd_bwd == 3 * counts.attention_flops(2, 1, 4, 2, 4)


def test_attention_bytes_by_hand():
    big = 1 * 4 * 2 * 4 * 2
    row = 1 * 2 * 4 * 4
    assert counts.attention_bytes(False, 1, 4, 2, 4, 2) == 4 * big + row
    assert counts.attention_bytes(True, 1, 4, 2, 4, 2) == 8 * big + row


def test_roofline_takes_the_larger_bound():
    sec = 1.0
    by_ops = counts.roofline_pct(989e12 / 2, 0.0, sec)
    by_bytes = counts.roofline_pct(0.0, 3.35e12 / 4, sec)
    assert by_ops == pytest.approx(50.0)
    assert by_bytes == pytest.approx(25.0)
    assert counts.roofline_pct(989e12 / 2, 3.35e12 / 4, sec) == by_ops
