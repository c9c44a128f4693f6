"""Collective telemetry on NVIDIA cards: all-gather / reduce-scatter /
all-reduce bandwidth and latency over NCCL, surfaced as dynolog metrics.

The counterpart of ``dynolog_tpu/collectives.py`` (BASELINE config 5:
"all-gather/reduce-scatter BW + latency counters surfaced as dynolog
metrics"). It runs ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce`` with one process per card and merges the bus bandwidth
and small-message latency into the exporter snapshot that dynologd's file
backend polls. The metric names are the JAX package's, which the daemon
already knows (field ids 13-20 in src/tpumon/TpuMetricBackend.cpp): the
``ici_*`` names carry NCCL's numbers here, over NVLink or PCIe, not ICI.

    python -m dynolog_tpu_torch.collectives --merge-into /tmp/dynolog_tpu_metrics.json

``measure`` spawns one process per card (``torch.cuda.device_count()``),
or, under ``torchrun``, measures in the ranks torchrun started. gloo on
the CPU (``device="cpu"``) serves the tests.

Bus-bandwidth accounting per device for n devices and a per-device shard
of S bytes (the standard ring-collective model): all_gather receives
(n-1)·S; reduce_scatter moves (n-1)/n · S; all-reduce costs
2·(n-1)/n · S. The time of an op is the slowest rank's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

LATENCY_SIZE = 8 * 1024  # small message for latency probe
DEFAULT_SIZE = 4 * 1024 * 1024  # per-device shard bytes for BW probe
WARMUP = 3
ITERS = 10
OPS = ("all_gather", "reduce_scatter", "all_reduce")


def wire_bytes(n: int, elems: int) -> dict:
    """Per-device bytes over the interconnect for an f32 shard of `elems`
    elements on n devices, ring model."""
    return {
        "all_gather": (n - 1) * elems * 4,
        "reduce_scatter": (n - 1) * elems * 4 / n if n > 1 else 0,
        "all_reduce": 2 * (n - 1) * elems * 4 / n if n > 1 else 0,
    }


def _shard_elems(shard_bytes: int, n: int) -> int:
    """f32 elements per device shard, rounded up to a multiple of n so the
    reduce-scatter divides evenly."""
    elems = max(n, shard_bytes // 4)
    return elems + (-elems) % n


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_op(fn, device, iters: int = ITERS) -> float:
    """Seconds per call on this rank, after WARMUP calls; the ranks start
    together and the slowest rank's time is returned to all."""
    import torch
    import torch.distributed as dist

    for _ in range(WARMUP):
        fn()
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                      device=device)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    return dt.item() / iters


def _measure_in_group(shard_bytes: int, device) -> dict:
    """measure() inside an initialized process group, on this rank's
    `device`; every rank returns the same metrics."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    elems = _shard_elems(shard_bytes, n)
    shard = torch.ones(elems, dtype=torch.float32, device=device)
    gathered = torch.empty(elems * n, dtype=torch.float32, device=device)
    scattered = torch.empty(elems // n, dtype=torch.float32, device=device)
    reduced = shard.clone()
    ops = {
        "all_gather": lambda: dist.all_gather_into_tensor(gathered, shard),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(scattered,
                                                             shard),
        "all_reduce": lambda: dist.all_reduce(reduced),
    }
    moved = wire_bytes(n, elems)
    metrics: dict[str, float] = {"collective_mesh_devices": float(n)}
    for name in OPS:
        dt = _time_op(ops[name], device)
        if n > 1 and moved[name] > 0:
            metrics[f"ici_{name}_gbps"] = moved[name] * 8 / dt / 1e9
        metrics[f"ici_{name}_us"] = dt * 1e6

    small = torch.ones(_shard_elems(LATENCY_SIZE, n), dtype=torch.float32,
                       device=device)
    metrics["ici_latency_us"] = _time_op(lambda: dist.all_reduce(small),
                                         device) * 1e6
    return metrics


def _rank_measure(rank: int, world: int, shard_bytes: int, device: str):
    import torch

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    return _measure_in_group(shard_bytes, dev)


def measure(shard_bytes: int = DEFAULT_SIZE, device="cuda",
            world_size: int | None = None) -> dict:
    """Returns {metric_name: value} with BW in Gbit/s and latency in µs.

    Under torchrun (a process group already initialized) every rank
    measures on its card and gets the result. Otherwise it spawns
    `world_size` ranks (default: one per card) on NCCL, or on gloo for
    device="cpu" (default 1 rank)."""
    import torch
    import torch.distributed as dist

    from dynolog_tpu_torch import resolve_device
    from dynolog_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _measure_in_group(shard_bytes, device)
    if device.type == "cuda":
        n, backend = world_size or torch.cuda.device_count(), "nccl"
    else:
        n, backend = world_size or 1, "gloo"
    return spawn(_rank_measure, n, backend, (shard_bytes, device.type))[0]


def merge_into_snapshot(metrics: dict, path: str) -> None:
    """Attach collective metrics to device 0's entry in the exporter
    snapshot (created if missing, with the daemon's default chip_type
    "tpu", as the JAX package writes it) so the daemon's file backend
    ingests them."""
    snapshot = {"devices": [], "ts_ms": int(time.time() * 1000)}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                snapshot = loaded
        except (OSError, ValueError):
            pass
    if not snapshot.get("devices"):
        snapshot["devices"] = [{"device": 0, "chip_type": "tpu", "metrics": {}}]
    dev0 = snapshot["devices"][0]
    dev0.setdefault("metrics", {}).update(
        {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
    )
    snapshot["ts_ms"] = int(time.time() * 1000)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snapshot, f)
    os.replace(tmp, path)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--shard-bytes", type=int, default=DEFAULT_SIZE)
    parser.add_argument(
        "--merge-into",
        help="exporter snapshot path to merge results into (file backend)",
    )
    args = parser.parse_args(argv)
    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if under_torchrun:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    try:
        metrics = measure(args.shard_bytes)
    finally:
        if under_torchrun:
            dist.destroy_process_group()
    if under_torchrun and int(os.environ["RANK"]) != 0:
        return
    print(json.dumps(metrics, indent=2))
    if args.merge_into:
        merge_into_snapshot(metrics, args.merge_into)


if __name__ == "__main__":
    main()
