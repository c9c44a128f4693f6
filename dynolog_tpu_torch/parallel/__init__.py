"""Parallel forms of the flagship workload over torch.distributed.

- :mod:`~dynolog_tpu_torch.parallel.sharding` — the five-axis mesh, the
  parameter partition rules and each rank's slice of the parameter tree
  and of the batch;
- :mod:`~dynolog_tpu_torch.parallel.comm` — collectives that autograd can
  differentiate, written as conjugate pairs, and the ring shift;
- :mod:`~dynolog_tpu_torch.parallel.ring_attention` — exact causal
  attention with the sequence cut over ``seq`` (reference and flash
  attention gather the sequence instead: ``models.transformer``);
- :mod:`~dynolog_tpu_torch.parallel.pipeline` — the GPipe pipeline over
  ``pipe``;
- :mod:`~dynolog_tpu_torch.parallel.launch` — one process per rank, joined
  in one process group.

Data parallelism over ``data``, sequence parallelism over ``seq``, tensor
parallelism over ``model``, expert parallelism over ``expert`` and the
GPipe pipeline over ``pipe`` are ported.
"""

from dynolog_tpu_torch.parallel.sharding import (
    PARAM_RULES,
    MeshSpec,
    local_batch,
    make_mesh,
    shard_params,
)

__all__ = [
    "MeshSpec",
    "PARAM_RULES",
    "make_mesh",
    "shard_params",
    "local_batch",
    "pipeline_loss",
    "make_pipeline_train_step",
    "make_pipeline_train_state",
    "init_pipeline_params",
]

_PIPELINE = ("init_pipeline_params", "make_pipeline_train_state",
             "make_pipeline_train_step", "pipeline_loss")


def __getattr__(name: str):
    # The pipeline's names load on first use: parallel.pipeline imports
    # models.transformer, which imports this package while it loads.
    if name in _PIPELINE:
        from dynolog_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
