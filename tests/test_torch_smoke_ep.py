"""The measures of chip_smoke.py's multi-card expert-parallel check
(ep_train, leaf_checks, deviation) on gloo processes on the CPU, at a
tiny f32 width: a correct expert-parallel run lies within f32 rounding of
the one-process run, and one whose gradients are not averaged over
`data` lies further than the check's tolerance, on the gradient norms
and on the projections alike."""

import pytest
import torch

import chip_smoke
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models.transformer import TransformerConfig, init_params
from dynolog_tpu_torch.parallel import launch, sharding

CFG = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                        d_ff=64, max_seq_len=64, n_experts=4, moe_top_k=2,
                        attn_impl="flash", dtype="float32")
SPEC = {"data": 2, "expert": 2}
SEQ = 16


def _rank(rank, world, spec, drop_grad_mean):
    torch.set_num_threads(1)
    if drop_grad_mean:  # the loss is still averaged, the gradients not
        mean = ttrain._mean_over_data
        ttrain._mean_over_data = lambda tensors, mesh: mean(tensors[-1:],
                                                            mesh)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    return chip_smoke.ep_train(CFG, spec["data"], mesh, "cpu", SEQ)


@pytest.mark.parametrize("drop_grad_mean", [False, True],
                         ids=["correct", "gradients_not_averaged"])
def test_ep_check_measures(drop_grad_mean):
    ranks = launch.spawn(_rank, 4, "gloo", (SPEC, drop_grad_mean),
                         timeout_s=60)
    one = chip_smoke.ep_train(CFG, SPEC["data"], None, "cpu", SEQ)
    assert len(one["losses"]) == chip_smoke.EP_STEPS
    assert set(one["leaves"]) == {p for p, _ in chip_smoke.named_leaves(
        init_params(CFG, "cpu", torch.Generator().manual_seed(0)))}
    for got in ranks:
        dev = chip_smoke.deviation(got, one)
        assert dev["loss1"] <= 1e-5, dev  # the first loss precedes updates
        if drop_grad_mean:
            assert dev["norm"] > chip_smoke.EP_TOL, dev
            assert dev["projection"] > chip_smoke.EP_TOL, dev
        else:
            assert max(dev.values()) <= 1e-5, dev
