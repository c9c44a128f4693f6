"""Parallel forms of the flagship workload over torch.distributed.

- :mod:`~dynolog_tpu_torch.parallel.sharding` — the five-axis mesh, the
  parameter partition rules and each rank's slice of the parameter tree;
- :mod:`~dynolog_tpu_torch.parallel.comm` — collectives that autograd can
  differentiate, written as conjugate pairs;
- :mod:`~dynolog_tpu_torch.parallel.launch` — one process per rank, joined
  in one process group.

Expert parallelism over ``expert`` and data parallelism over ``data`` are
ported; tensor parallelism over ``model``, ring attention over ``seq`` and
the GPipe pipeline over ``pipe`` are not yet.
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
