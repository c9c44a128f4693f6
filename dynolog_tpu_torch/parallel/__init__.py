"""Parallel forms of the flagship workload over torch.distributed.

- :mod:`~dynolog_tpu_torch.parallel.sharding` — the five-axis mesh, the
  parameter partition rules and each rank's slice of the parameter tree
  and of the batch;
- :mod:`~dynolog_tpu_torch.parallel.comm` — collectives that autograd can
  differentiate, written as conjugate pairs, and the ring shift;
- :mod:`~dynolog_tpu_torch.parallel.ring_attention` — exact causal
  attention with the sequence cut over ``seq``;
- :mod:`~dynolog_tpu_torch.parallel.launch` — one process per rank, joined
  in one process group.

Data parallelism over ``data``, ring attention over ``seq``, tensor
parallelism over ``model`` and expert parallelism over ``expert`` are
ported; the GPipe pipeline over ``pipe`` is not yet.
"""

from dynolog_tpu_torch.parallel.sharding import (
    PARAM_RULES,
    MeshSpec,
    local_batch,
    make_mesh,
    shard_params,
)

__all__ = ["MeshSpec", "PARAM_RULES", "make_mesh", "shard_params",
           "local_batch"]
