"""The port's MoE MLP (dynolog_tpu_torch.models.moe) held against the JAX
package's moe_mlp on the CPU, on one device.

Both run on the JAX package's init_moe_layer output (router f32, experts
in the model's dtype) and on the same numpy input. A routing flip on a
near-tie changes a token's output outright, so outputs are compared
element by element in f32; in bf16 the aux loss is compared at the bf16
loss tolerance and the output at the bf16 logits tolerance of
tests/test_torch_model.py. Tolerances: f32 output and gradients 1e-5,
aux 1e-6 (the same math in another summation order); bf16 output 0.2,
aux 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynolog_tpu.models import moe as jmoe
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu_torch.models import moe as tmoe
from dynolog_tpu_torch.models import transformer as ttr

DIMS = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, d_ff=48,
            n_experts=4)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (0.2, 2e-2)}


def _setup(dtype, seed=0, b=2, s=16, **overrides):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=dtype, **overrides)
    tcfg = ttr.TransformerConfig(**DIMS, dtype=dtype, **overrides)
    jlayer = jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg)
    tlayer = {name: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if name == "router" else tcfg.torch_dtype)
        for name, v in jlayer.items()}
    x = np.random.default_rng(seed).standard_normal(
        (b, s, DIMS["d_model"])).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(tcfg.torch_dtype)
    return jcfg, tcfg, jlayer, tlayer, jx, tx


def _jax_dropped(jlayer, jx, jcfg) -> int:
    """Choices the JAX reference drops: per expert, the routed choices past
    its capacity."""
    xf = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(xf @ jlayer["router"]),
                           jcfg.moe_top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.n_experts)
    cap = jmoe._capacity(xf.shape[0], jcfg)
    return int(np.maximum(counts - cap, 0).sum())


def _compare(dtype, **overrides):
    jcfg, tcfg, jlayer, tlayer, jx, tx = _setup(dtype, **overrides)
    jy, jaux = jmoe.moe_mlp(jlayer, jx, jcfg)
    with torch.no_grad():
        ty, taux = tmoe.moe_mlp(tlayer, tx, tcfg)
    assert ty.dtype == tcfg.torch_dtype and ty.shape == tx.shape
    y_tol, aux_tol = TOL[dtype]
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=0, atol=y_tol)
    assert abs(float(taux) - float(jaux)) < aux_tol, (float(taux), float(jaux))
    return jcfg, jlayer, jx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(dtype):
    jcfg, jlayer, jx = _compare(dtype)
    assert _jax_dropped(jlayer, jx, jcfg) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax_when_capacity_drops_tokens(dtype):
    jcfg, jlayer, jx = _compare(dtype, moe_capacity_factor=0.5)
    assert _jax_dropped(jlayer, jx, jcfg) > 0


def test_zero_router_ties_route_like_lax_top_k():
    """Every row ties: lax.top_k and the port pick experts 0 and 1; expert
    0 then takes the first `cap` tokens' first choices and drops the
    rest."""
    jcfg, tcfg, jlayer, tlayer, jx, tx = _setup("float32")
    jlayer = dict(jlayer, router=jnp.zeros_like(jlayer["router"]))
    tlayer = dict(tlayer, router=torch.zeros_like(tlayer["router"]))
    probs = torch.full((5, DIMS["n_experts"]), 1.0 / DIMS["n_experts"])
    assert tmoe.top_k(probs, 2)[1].tolist() == [[0, 1]] * 5
    jy, jaux = jmoe.moe_mlp(jlayer, jx, jcfg)
    ty, taux = tmoe.moe_mlp(tlayer, tx, tcfg)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=TOL["float32"][0])
    assert abs(float(taux) - float(jaux)) < TOL["float32"][1]
    assert _jax_dropped(jlayer, jx, jcfg) > 0


def test_moe_gradients_match_jax_grad():
    """Gradients of sum(y * w) + aux with respect to the input and every
    leaf (router included), against jax.grad, in f32."""
    jcfg, tcfg, jlayer, tlayer, jx, tx = _setup("float32", seed=3)
    w = np.random.default_rng(7).standard_normal(tx.shape).astype(np.float32)

    def jloss(layer, x):
        y, aux = jmoe.moe_mlp(layer, x, jcfg)
        return jnp.sum(y * w) + aux

    jgl, jgx = jax.grad(jloss, argnums=(0, 1))(jlayer, jx)
    tx.requires_grad_(True)
    for leaf in tlayer.values():
        leaf.requires_grad_(True)
    ty, taux = tmoe.moe_mlp(tlayer, tx, tcfg)
    ((ty * torch.from_numpy(w)).sum() + taux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    for name, leaf in tlayer.items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgl[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert float(tlayer["router"].grad.abs().max()) > 0


def test_init_moe_layer_router_stays_f32():
    cfg = ttr.TransformerConfig(**DIMS)
    layer = tmoe.init_moe_layer(cfg, "cpu", torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: jmoe.init_moe_layer(
        jax.random.PRNGKey(0), jtr.TransformerConfig(**DIMS)))
    assert {n: tuple(t.shape) for n, t in layer.items()} == {
        n: tuple(a.shape) for n, a in ref.items()}
    assert {n: str(t.dtype)[6:] for n, t in layer.items()} == {
        n: str(a.dtype) for n, a in ref.items()}
