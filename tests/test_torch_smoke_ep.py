"""The measures of chip_smoke.py's multi-card checks (mesh_train,
leaf_checks, deviation) on gloo processes on the CPU, at a tiny f32
width: a correct expert-parallel run lies within f32 rounding of the
one-process run, and one whose gradients are not averaged over `data`
lies further than the check's tolerance, on the gradient norms and on
the projections alike; so do correct runs over the meshes of the
multi-card checks (a), (b), (d) and (e), whose leaves are cut over
`model` and `seq` too, and the GPipe ranks of phase 13 and the check (c), each
holding its stage's leaves; and the pipeline's capture check passes a
capture that the port's unitrace triggers through a live daemon."""

import dataclasses

import pytest
import torch

import chip_smoke
from daemon_utils import start_daemon, stop_daemon
from dynolog_tpu_torch.models import train as ttrain
from dynolog_tpu_torch.models.transformer import TransformerConfig, init_params
from dynolog_tpu_torch.parallel import launch, sharding

CFG = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                        d_ff=64, max_seq_len=64, n_experts=4, moe_top_k=2,
                        attn_impl="flash", dtype="float32")
SPEC = {"data": 2, "expert": 2}
SEQ = 16


class OneRank:
    """A stand-in mesh of one rank, for ring attention on one process:
    the DeviceMesh methods sharding.axis reads, every axis of size 1."""

    mesh_dim_names = ("data", "seq", "model", "expert", "pipe")

    def size(self, dim):
        return 1


def _rank(rank, world, spec, drop_grad_mean):
    torch.set_num_threads(1)
    if drop_grad_mean:  # the loss is still averaged, the gradients not
        mean = ttrain._mean_over_data
        ttrain._mean_over_data = lambda tensors, mesh: mean(tensors[-1:],
                                                            mesh)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    return chip_smoke.mesh_train(CFG, spec["data"], mesh, "cpu", SEQ)


def _mesh_rank(rank, world, cfg, spec, rows):
    torch.set_num_threads(1)
    mesh = sharding.make_mesh(sharding.MeshSpec(**spec), "cpu")
    return chip_smoke.mesh_train(cfg, rows, mesh, "cpu", SEQ)


@pytest.mark.parametrize("drop_grad_mean", [False, True],
                         ids=["correct", "gradients_not_averaged"])
def test_ep_check_measures(drop_grad_mean):
    ranks = launch.spawn(_rank, 4, "gloo", (SPEC, drop_grad_mean),
                         timeout_s=60)
    one = chip_smoke.mesh_train(CFG, SPEC["data"], None, "cpu", SEQ)
    assert len(one["losses"]) == chip_smoke.EP_STEPS
    assert set(one["leaves"]) == {p for _, p, _ in chip_smoke.named_leaves(
        init_params(CFG, "cpu", torch.Generator().manual_seed(0)))}
    for got in ranks:
        dev = chip_smoke.deviation(got, one)
        assert dev["loss1"] <= 1e-5, dev  # the first loss precedes updates
        if drop_grad_mean:
            assert dev["norm"] > chip_smoke.EP_TOL, dev
            assert dev["projection"] > chip_smoke.EP_TOL, dev
        else:
            assert max(dev.values()) <= 1e-5, dev


@pytest.mark.parametrize("case", list(chip_smoke.MESH_CASES))
def test_mesh_check_measures(case):
    """The multi-card checks' meshes, (a) the dense model with ring
    attention over MeshSpec(seq=2, model=2) against a one-rank ring run,
    (b) the MoE model over MeshSpec(expert=2, model=2), (d) the dense
    model with flash attention over MeshSpec(seq=2, model=2) and (e) the
    MoE model over MeshSpec(seq=2, expert=2) at MESH_ROWS rows, each
    against one process: the projections of leaves cut over `model` (and
    `expert`) are summed over the blocks, so a correct run lies within
    f32 rounding."""
    spec = chip_smoke.MESH_CASES[case]
    rows = chip_smoke.MESH_ROWS.get(case, 1)
    cfg = {"tp": dataclasses.replace(CFG, n_experts=0, attn_impl="ring"),
           "sp": dataclasses.replace(CFG, n_experts=0)}.get(case, CFG)
    ranks = launch.spawn(_mesh_rank, 4, "gloo", (cfg, spec, rows),
                         timeout_s=60)
    one = chip_smoke.mesh_train(cfg, rows,
                                OneRank() if case == "tp" else None, "cpu",
                                SEQ)
    for got in ranks:
        dev = chip_smoke.deviation(got, one)
        assert max(dev.values()) <= 1e-5, dev


PIPE_CFG = dataclasses.replace(CFG, n_experts=0, n_layers=4,
                               attn_impl="reference")


def _pipe_rank(rank, world, spec, capture):
    torch.set_num_threads(1)
    # A window of several steps: it is wall time on the poll thread, and a
    # loaded CPU must still fit two step() calls in it.
    chip_smoke.CAPTURE_MS = 400
    return chip_smoke._pipe_rank(rank, world, PIPE_CFG, spec, 4, 2, capture,
                                 "cpu", SEQ)


@pytest.mark.parametrize("pipe", [2, 4])
def test_pipe_check_measures(pipe):
    """The GPipe ranks' leaves, each stage's under the whole tree's paths
    and projection seeds, merged into one run: within f32 rounding of the
    dense trainer on one process."""
    ranks = launch.spawn(_pipe_rank, pipe, "gloo", ({"pipe": pipe}, None),
                         timeout_s=60)
    run = chip_smoke.merged(ranks)
    one = chip_smoke.mesh_train(PIPE_CFG, 4, None, "cpu", SEQ)
    assert set(run["leaves"]) == set(one["leaves"])
    dev = chip_smoke.deviation(run, one)
    assert max(dev.values()) <= 1e-5, dev


def test_pipe_capture_check(bin_dir, tmp_path):
    """A one-rank pipeline run under a capture that the port's unitrace
    triggers through a live daemon passes check_pipe_capture: the start
    time unitrace printed, a window opened within one step of it, and a
    summary that names the steps."""
    daemon = start_daemon(bin_dir)
    try:
        capture = {"endpoints": [daemon.endpoint], "ports": [daemon.port],
                   "job_id": 61, "log_file": str(tmp_path / "pipe.json")}
        ranks = launch.spawn(_pipe_rank, 1, "gloo", ({"pipe": 1}, capture),
                             timeout_s=90)
    finally:
        stop_daemon(daemon)
    assert ranks[0]["unitrace"][0] == 0, ranks[0]["unitrace"]
    assert chip_smoke.check_pipe_capture(ranks, 1) == []


def test_limits_hold_the_measured_noise_twice():
    """The first loss and the norms at EP_TOL, the rest at twice the
    in-run floor; a mesh's measured noise raises a limit to twice it,
    never lowers one."""
    floor = {"loss1": 0.5, "loss2": 0.001, "norm": 0.5, "projection": 0.03}
    limits = chip_smoke.limits_for(floor)
    assert limits == {"loss1": chip_smoke.EP_TOL, "loss2": chip_smoke.EP_TOL,
                      "norm": chip_smoke.EP_TOL, "projection": 0.06}
    limits = chip_smoke.limits_for(floor, {"loss2": 0.1, "norm": 0.001,
                                           "projection": 0.02})
    assert limits == {"loss1": chip_smoke.EP_TOL, "loss2": 0.2,
                      "norm": chip_smoke.EP_TOL, "projection": 0.06}
