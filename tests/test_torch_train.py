"""The port's AdamW train step (dynolog_tpu_torch.models.train) held against
the JAX package's make_train_step on the CPU, after 1 and 3 steps.

Both start from the JAX package's init_params output (converted with
params_from_jax) and train on the same token batch, dense and MoE
(n_experts=4, top-2; its router is f32 in both trees). Two checks per
leaf:

- its value, against an absolute tolerance;
- its change from the initial value, against the JAX step's change:
  |change_torch - change_jax| <= r * |change_jax| (L2 norms over the
  leaf). A step that does nothing, or moves the weights by the wrong
  amount or sign, gives a ratio near 1 or above.

Tolerances per dtype:

- f32: loss 1e-5, value 1e-5 absolute, change r = 1e-3 (3e-4 observed).
  torch.optim.AdamW and optax.adamw apply the same update,
  (1 - lr*wd) * p - lr * m_hat / (sqrt(v_hat) + eps), in another
  operation order.
- bf16: loss 1e-2, value 1e-2 absolute, change r = 0.25 (0.16 observed).
  A step moves a weight by about lr = 3e-4, under half a bf16 ulp for
  weights above ~0.08, so about half of the elements of a matrix change
  by one ulp and the rest not at all (the norm scales, 1.0, never move).
  Which elements tip over depends on each framework's rounding points,
  so the two changes differ on some elements; the value check alone
  could not tell a working step from one that does nothing, the change
  check can.
"""

import jax
import numpy as np
import pytest
import torch

from dynolog_tpu.models import train as jtrain
from dynolog_tpu.models import transformer as jtr
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models import transformer as ttr
from dynolog_tpu_torch.models.convert import params_from_jax

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
TOL = {"float32": (1e-5, 1e-5, 1e-3), "bfloat16": (1e-2, 1e-2, 0.25)}


def _leaves(tree):
    names = ["embedding", "w_out", "final_scale"]
    out = [(n, tree[n]) for n in names]
    for i, layer in enumerate(tree["layers"]):
        out += [(f"layers.{i}.{n}", layer[n]) for n in sorted(layer)]
    return out


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(dtype, n_steps, n_experts):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=dtype, attn_impl="flash",
                                 n_experts=n_experts)
    tcfg = ttr.TransformerConfig(**DIMS, dtype=dtype, attn_impl="flash",
                                 n_experts=n_experts)
    jparams, jopt = jtrain.make_train_state(jax.random.PRNGKey(0), jcfg)
    tokens = jtrain.make_batch(jax.random.PRNGKey(1), jcfg, 2, 16)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu", tcfg.torch_dtype)
    topt = ttrain.make_optimizer(tparams)
    jstep, tstep = jtrain.make_train_step(jcfg), ttrain.make_train_step(tcfg)
    ttokens = torch.from_numpy(np.array(tokens)).long()
    init = [np.asarray(x, np.float32) for _, x in _leaves(jparams)]
    loss_tol, leaf_tol, change_tol = TOL[dtype]
    for _ in range(n_steps):
        jparams, jopt, jloss = jstep(jparams, jopt, tokens)
        tloss = tstep(tparams, topt, ttokens)
        assert abs(float(tloss) - float(jloss)) < loss_tol
    moved = 0.0
    for (name, ref), (_, got), p0 in zip(_leaves(jparams), _leaves(tparams),
                                         init):
        # The MoE router is f32 in both trees, whatever the model's dtype.
        assert got.dtype == (torch.float32 if name.endswith("router")
                             else tcfg.torch_dtype), name
        got, ref = got.detach().float().numpy(), np.asarray(ref, np.float32)
        np.testing.assert_allclose(got, ref, rtol=0, atol=leaf_tol,
                                   err_msg=name)
        change_ref = np.linalg.norm(ref - p0)
        assert (np.linalg.norm((got - p0) - (ref - p0))
                <= change_tol * change_ref), name
        moved += change_ref
    assert moved > 0


def test_optimizer_keeps_moments_in_param_dtype():
    cfg = ttr.TransformerConfig(**DIMS)
    params, opt = ttrain.make_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(cfg)
    batch = ttrain.make_batch(torch.Generator().manual_seed(1), cfg, 2, 16,
                              "cpu")
    loss = step(params, opt, batch)
    assert torch.isfinite(loss)
    for p in ttr.param_leaves(params):
        state = opt.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == p.dtype
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0.01)


def test_optimizer_is_fused():
    """One fused AdamW pass per group of one device and dtype: the MoE
    tree mixes bf16 leaves and the f32 router, and fused=True takes
    both."""
    cfg = ttr.TransformerConfig(**DIMS, n_experts=4)
    params, opt = ttrain.make_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0))
    assert {p.dtype for p in ttr.param_leaves(params)} == {
        torch.bfloat16, torch.float32}
    assert all(g["fused"] and not g["foreach"] for g in opt.param_groups)
    ttrain.make_train_step(cfg)(params, opt, ttrain.make_batch(
        torch.Generator().manual_seed(1), cfg, 2, 16, "cpu"))
    assert all(int(opt.state[p]["step"]) == 1
               for p in ttr.param_leaves(params))


def test_make_batch_range_and_shape():
    cfg = ttr.TransformerConfig(**DIMS)
    batch = ttrain.make_batch(torch.Generator().manual_seed(2), cfg, 3, 10,
                              "cpu")
    assert batch.shape == (3, 10) and batch.dtype == torch.int64
    assert 0 <= int(batch.min()) and int(batch.max()) < cfg.vocab_size
