"""The port's transformer (dynolog_tpu_torch.models) held against the JAX
package's forward and loss on the CPU.

Both run on the JAX package's own init_params output, converted with
params_from_jax, and on the same token batch (JAX's threefry and torch's
generators draw different numbers from one seed). Tolerances: f32 logits
1e-4 and loss 1e-5 (the same math in another summation order); bf16
logits 0.2, the tolerance tests/test_ops.py gives the reference's own
flash-versus-reference comparison (bf16 rounding compounded over layers),
and bf16 loss 2e-2.
"""

import jax
import numpy as np
import pytest
import torch

from dynolog_tpu.models import transformer as jtr
from dynolog_tpu.models.train import make_batch as jax_make_batch
from dynolog_tpu_torch.models import transformer as ttr
from dynolog_tpu_torch.models.convert import params_from_jax

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64)
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (0.2, 2e-2)}


def _setup(dtype, attn_impl, n_experts=0):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=dtype, attn_impl=attn_impl,
                                 n_experts=n_experts)
    tcfg = ttr.TransformerConfig(**DIMS, dtype=dtype, attn_impl=attn_impl,
                                 n_experts=n_experts)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = jax_make_batch(jax.random.PRNGKey(1), jcfg, 2, 32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(np_params, "cpu", tcfg.torch_dtype)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(dtype, attn_impl, n_experts):
    jcfg, tcfg, jparams, tparams, tokens = _setup(dtype, attn_impl,
                                                  n_experts)
    ttokens = torch.from_numpy(np.array(tokens)).long()
    logits_tol, loss_tol = TOL[dtype]
    with torch.no_grad():
        logits = ttr.forward(tparams, ttokens, tcfg)
        loss = ttr.loss_fn(tparams, ttokens, tcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 32, 128)
    ref = np.asarray(jtr.forward(jparams, tokens, jcfg))
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=logits_tol)
    ref_loss = float(jtr.loss_fn(jparams, tokens, jcfg))
    assert abs(float(loss) - ref_loss) < loss_tol, (float(loss), ref_loss)


def test_converted_params_keep_tree_and_values():
    _, _, jparams, tparams, _ = _setup("bfloat16", "reference")
    assert set(tparams) == set(jparams)
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        assert set(tl) == set(jl)
        for name in jl:
            assert tl[name].dtype == torch.bfloat16
            assert tl[name].requires_grad
            np.testing.assert_array_equal(
                tl[name].detach().float().numpy(), np.asarray(jl[name], np.float32))


def test_converted_router_stays_f32():
    _, _, jparams, tparams, _ = _setup("bfloat16", "reference", n_experts=4)
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        assert set(tl) == set(jl) and "w_gate" not in tl
        assert jl["router"].dtype == np.float32
        assert tl["router"].dtype == torch.float32
        np.testing.assert_array_equal(tl["router"].detach().numpy(),
                                      np.asarray(jl["router"]))
        for name in ("experts_gate", "experts_up", "experts_down"):
            assert tl[name].dtype == torch.bfloat16 and tl[name].requires_grad
    leaves = ttr.param_leaves(tparams)
    assert len(leaves) == 3 + DIMS["n_layers"] * 10
    assert sum(p.dtype == torch.float32 for p in leaves) == DIMS["n_layers"]


def test_init_params_shapes_match_jax():
    cfg = ttr.TransformerConfig(**DIMS)
    params = ttr.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: jtr.init_params(
        jax.random.PRNGKey(0), jtr.TransformerConfig(**DIMS)))
    assert params["embedding"].shape == ref["embedding"].shape
    for jl, tl in zip(ref["layers"], params["layers"]):
        assert {n: tuple(t.shape) for n, t in tl.items()} == {
            n: tuple(a.shape) for n, a in jl.items()}
    assert all(p.dtype == torch.bfloat16 for p in ttr.param_leaves(params))


def test_llama_8b_like_matches_jax_widths():
    ours, ref = ttr.TransformerConfig.llama_8b_like(), \
        jtr.TransformerConfig.llama_8b_like()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
              "max_seq_len", "head_dim"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ttr.TransformerConfig.llama_8b_like(n_layers=2).d_model == 4096


@pytest.mark.parametrize("entry", ["forward", "loss_fn"])
def test_ring_without_a_mesh_raises(entry):
    """Ring attention needs the mesh's `seq` axis, as the JAX package's
    _attention says (ValueError); its weights need none."""
    cfg = ttr.TransformerConfig(**DIMS, attn_impl="ring")
    params = ttr.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    tokens = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="requires a mesh"):
        getattr(ttr, entry)(params, tokens, cfg)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_params(ttr.TransformerConfig(**DIMS))
