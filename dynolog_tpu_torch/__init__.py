"""dynolog_tpu_torch: the PyTorch/CUDA port of dynolog_tpu's Python half.

It runs beside the JAX package and imports nothing of it (nor JAX):

- :mod:`dynolog_tpu_torch.client` — the in-process shim a PyTorch training
  job embeds so dynologd can trigger on-demand torch.profiler captures;
- :mod:`dynolog_tpu_torch.models` — the flagship transformer workload,
  dense or MoE, and its AdamW train step;
- :mod:`dynolog_tpu_torch.parallel` — the mesh, data, sequence (ring
  attention), tensor and expert parallelism and the GPipe pipeline over
  torch.distributed;
- :mod:`dynolog_tpu_torch.cluster` — the cluster fan-out: one synchronized
  capture across every host of a job (``python -m
  dynolog_tpu_torch.cluster.unitrace``);
- :mod:`dynolog_tpu_torch.collectives` — the NCCL collective probe for
  the daemon's file backend;
- :mod:`dynolog_tpu_torch.ops` — flash attention as hand-written CUDA
  kernels for Hopper, each with a plain PyTorch version;
- :mod:`dynolog_tpu_torch.supervise` — the mirror of the daemon's
  supervision, durable spill queue, fleet relay and watcher (diagnosing
  with :mod:`dynolog_tpu_torch.diagnose`) and resource governor;
  :mod:`dynolog_tpu_torch.host` — the perf(1) CLI sampler.

Entry points run on the card (``device="cuda"``) and raise where there is
none; only a caller that asks for ``device="cpu"`` gets the CPU.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """torch.device for `device`; raises if it names CUDA and there is no
    card, rather than running somewhere else."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
