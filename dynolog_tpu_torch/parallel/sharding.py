"""Mesh and parameter sharding for the port's parallel forms: the
counterpart of ``dynolog_tpu/parallel/sharding.py`` over torch.distributed.

The JAX package names a ``jax.sharding.Mesh`` with five axes and lets XLA
insert the collectives from sharding annotations. Here the mesh is a
``torch.distributed`` DeviceMesh with the same axes in the same row-major
rank order, each process holds its own slice of the parameters
(``shard_params``) and of the batch (``local_batch``), and the model calls
the collectives itself (``parallel.comm``).

Ported: ``data`` (the batch's rows), ``seq`` (the batch's columns, under
every attention and MoE layers, as in the JAX package), ``model`` (tensor
parallelism: the columns of wq/wk/wv/w_gate/w_up/w_out/embedding and the
rows of wo/w_down) and ``expert`` (the stacked MoE expert weights, their
hidden dimension cut on ``model`` too).

``pipe`` is the GPipe pipeline's axis (``parallel.pipeline``), which
takes its own stage slice of the tree and of the batch: the dense and MoE
trainers (``shard_params``, ``local_batch``, ``models.train``) raise
NotImplementedError for a mesh whose ``pipe`` axis is larger than 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from dynolog_tpu_torch import resolve_device


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; dims must multiply to the process count.

    The five axes of the JAX package: `data` (DP), `seq` (sequence
    parallel), `model` (TP), `expert` (EP) and `pipe` (PP). Unused axes
    default to size 1."""

    data: int = 1
    seq: int = 1
    model: int = 1
    expert: int = 1
    pipe: int = 1
    axis_names: tuple = field(default=("data", "seq", "model", "expert", "pipe"))

    @property
    def shape(self) -> tuple:
        return (self.data, self.seq, self.model, self.expert, self.pipe)

    @classmethod
    def for_devices(cls, n: int) -> "MeshSpec":
        """A balanced dp x sp x tp factorization of n devices (largest
        factor to data, then model, then seq), as the JAX package's."""
        dims = [1, 1, 1]  # data, model, seq
        remaining = n
        order = [0, 1, 2]
        i = 0
        while remaining > 1:
            for p in (2, 3, 5, 7):
                if remaining % p == 0:
                    dims[order[i % 3]] *= p
                    remaining //= p
                    i += 1
                    break
            else:
                dims[0] *= remaining
                remaining = 1
        return cls(data=dims[0], model=dims[1], seq=dims[2])


def make_mesh(spec: MeshSpec, device="cuda"):
    """DeviceMesh over the initialized default process group, shaped
    `spec.shape` with `spec.axis_names`. Rank r sits at the row-major
    coordinate of r, as ``np.reshape(devices, spec.shape)`` places devices
    in the JAX package's mesh. With device "cuda" each process must have
    selected its card (``torch.cuda.set_device``) first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    n = math.prod(spec.shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {spec.shape} needs {n} processes, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device.type, spec.shape,
                            mesh_dim_names=spec.axis_names)


# Parameter partition rules, keyed by parameter-name suffix, as data: one
# entry per dimension, naming the mesh axis it is split over or None. The
# JAX package's PartitionSpecs, entry for entry and in the same order.
PARAM_RULES = {
    "embedding": (None, "model"),
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "w_out": (None, "model"),
    "scale": (None,),
    # MoE: router replicated; stacked expert weights [E, d, f] split on
    # `expert` (EP), the hidden dim on `model` (EP x TP).
    "router": (),
    "experts_gate": ("expert", None, "model"),
    "experts_up": ("expert", None, "model"),
    "experts_down": ("expert", "model", None),
}


def rule_for(path: str) -> tuple:
    """The partition rule of the leaf at `path` ("layers/0/wq"): the first
    PARAM_RULES entry whose key ends the path, else replicated."""
    for suffix, spec in PARAM_RULES.items():
        if path.endswith(suffix):
            return spec
    return ()


def axis(mesh, name: str):
    """(size, this rank's coordinate, process group) of mesh axis `name`;
    (1, 0, None) without a mesh or for an axis of size 1."""
    if mesh is None:
        return 1, 0, None
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank(name), mesh.get_group(name)


def check_mesh(mesh) -> None:
    """Raises NotImplementedError for a mesh the dense and MoE trainers do
    not run on: one whose `pipe` axis is larger than 1."""
    if axis(mesh, "pipe")[0] > 1:
        raise NotImplementedError(
            "the dense and MoE trainers do not run over mesh axis 'pipe'; "
            "the GPipe pipeline (parallel.pipeline) does")


def shard_params(params: dict, mesh) -> dict:
    """This rank's slice of the parameter tree under PARAM_RULES.

    A dimension whose rule names an axis of size n > 1 is cut into n equal
    blocks and this rank keeps the block of its coordinate on that axis;
    other dimensions stay whole. Every leaf comes back as a new contiguous
    tensor requiring grad, so the full tree can be freed."""
    check_mesh(mesh)

    def local(path: str, leaf: torch.Tensor) -> torch.Tensor:
        out = leaf.detach()
        for dim, name in enumerate(rule_for(path)):
            if name is None:
                continue
            size, rank, _ = axis(mesh, name)
            if out.shape[dim] % size:
                raise ValueError(f"{path}: dim {dim} ({out.shape[dim]}) does "
                                 f"not split over {name}={size}")
            block = out.shape[dim] // size
            out = out.narrow(dim, rank * block, block)
        return out.clone().requires_grad_(True)

    tree = {name: local(name, params[name])
            for name in ("embedding", "w_out", "final_scale")}
    tree["layers"] = [
        {name: local(f"layers/{i}/{name}", leaf)
         for name, leaf in layer.items()}
        for i, layer in enumerate(params["layers"])
    ]
    return tree


def local_batch(tokens: torch.Tensor, mesh) -> tuple:
    """(tokens, targets) of this rank from the global batch [B, S]: its
    rows (the batch split over `data`), its chunk of the columns (split
    over `seq`), replicated over the other axes, as the JAX package's
    ``batch_sharding`` places them. The targets are the next tokens: the
    last position of a chunk predicts the first token of the next chunk,
    so only the last chunk has no target for its last position (JAX drops
    ``logits[:, :-1]``'s last column of the whole sequence)."""
    check_mesh(mesh)
    cut = []
    for dim, name in enumerate(("data", "seq")):
        size, rank, _ = axis(mesh, name)
        if tokens.shape[dim] % size:
            raise ValueError(f"tokens dim {dim} ({tokens.shape[dim]}) does "
                             f"not split over {name}={size}")
        block = tokens.shape[dim] // size
        cut.append((rank * block, block))
    (row, rows), (col, cols) = cut
    tokens = tokens[row:row + rows]
    return tokens[:, col:col + cols], tokens[:, col + 1:col + cols + 1]
