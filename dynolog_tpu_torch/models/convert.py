"""Parameters of the JAX package's transformer, as numpy arrays, into the
port's parameter tree. The two packages share the tree and the [in, out]
weight layout, so this is a leaf-by-leaf copy with no transposes.

bf16 leaves come out of JAX as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` rejects; they go through f32 (exact for bf16) and are
cast back with ``.to(dtype)``. The MoE router stays f32, as the JAX tree
holds it whatever the model's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from dynolog_tpu_torch import resolve_device
from dynolog_tpu_torch.models.transformer import param_leaves

# Leaves kept in f32 whatever the model's dtype.
F32_LEAVES = ("router",)


def _leaf(x, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(x).astype(np.float32))
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """{embedding, w_out, final_scale, layers: [...]} of array-likes ->
    the same tree of `dtype` tensors (F32_LEAVES: f32) on `device`,
    requiring grad. The JAX pipeline's tree, whose `layers` is one dict of
    [n_layers, ...] stacks (``dynolog_tpu/parallel/pipeline.py``
    ``init_pipeline_params``), comes out as the same list of layers
    (``parallel.pipeline.stage_params`` keeps a rank's stage of it)."""
    device = resolve_device(device)
    layers = np_params["layers"]
    if isinstance(layers, dict):
        n = len(next(iter(layers.values())))
        layers = [{name: stack[i] for name, stack in layers.items()}
                  for i in range(n)]
    params = {
        name: _leaf(np_params[name], device, dtype)
        for name in ("embedding", "w_out", "final_scale")
    }
    params["layers"] = [
        {name: _leaf(value, device,
                     torch.float32 if name in F32_LEAVES else dtype)
         for name, value in layer.items()}
        for layer in layers
    ]
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params
