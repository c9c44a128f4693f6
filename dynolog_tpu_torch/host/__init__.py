"""Host-side helpers that shell out to OS tooling (perf CLI fallback)."""

from dynolog_tpu_torch.host.perfcli import PerfCliSampler

__all__ = ["PerfCliSampler"]
