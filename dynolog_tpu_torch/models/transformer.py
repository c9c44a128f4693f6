"""Flagship workload in PyTorch: the Llama-style decoder-only transformer of
``dynolog_tpu/models/transformer.py``, with the same parameter tree, the
same weight layout (``x @ W`` with W shaped [in, out]) and the same cast
order, so the JAX package's weights convert without transposes
(``models.convert.params_from_jax``).

Parameters are a plain dict of leaf tensors mirroring the reference's
pytree: {embedding, w_out, final_scale, layers: [{attn_scale, wq, wk, wv,
wo, mlp_scale, w_gate, w_up, w_down}, ...]}; with n_experts > 0 the MoE
leaves {router, experts_gate, experts_up, experts_down} of
``models.moe`` take the place of w_gate, w_up and w_down.

Under a mesh (``parallel.sharding.make_mesh``) each process holds its
slice of the parameters and of the batch, and the model calls the
collectives that XLA inserts in the JAX package (``parallel.comm``):
over `model`, activations enter the column-cut products (wq/wk/wv,
w_gate/w_up, w_out) through f and leave the row-cut ones (wo, w_down)
through g, each rank attends with its own heads, and the embedding's
and the logits' cut columns are gathered whole; over `seq`, positions are
global and attention is either ring attention (``parallel.ring_attention``)
or, for "reference" and "flash", the whole sequence's q, k and v gathered
(``comm.gather_over_group``), attended to as on one process, and this
rank's chunk of the output kept.

This is a *workload*, not a modeling library: the monitoring framework
only observes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dynolog_tpu_torch import resolve_device
from dynolog_tpu_torch.models.moe import init_moe_layer, moe_mlp
from dynolog_tpu_torch.ops.flash_attention import (
    flash_attention, reference_attention)
from dynolog_tpu_torch.parallel import comm
from dynolog_tpu_torch.parallel.ring_attention import ring_attention
from dynolog_tpu_torch.parallel.sharding import axis, check_mesh

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 1024
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 704  # ~8/3 * d_model, rounded to a multiple of 64
    max_seq_len: int = 512
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # "reference": plain attention; "flash": the CUDA flash kernels
    # (dynolog_tpu_torch.ops.flash_attention); "ring": ring attention over
    # the mesh's `seq` axis (needs a mesh).
    attn_impl: str = "reference"
    # MoE: n_experts > 0 replaces every dense MLP with a top-k-routed
    # mixture of SwiGLU experts (models.moe), expert-parallel over the
    # mesh's `expert` axis.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def llama_8b_like(cls, **overrides) -> "TransformerConfig":
        """Shape class of the north-star workload (Llama-3-8B widths)."""
        fields = dict(
            vocab_size=128256,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            d_ff=14336,
            max_seq_len=8192,
        )
        fields.update(overrides)
        return cls(**fields)


def check_supported(cfg: TransformerConfig, mesh=None) -> None:
    """Raises for a configuration the port cannot run on `mesh`: an
    unknown attention or a head count that does not split over `model`
    (ValueError), a mesh whose `pipe` axis is larger than 1
    (NotImplementedError, ``sharding.check_mesh``). Every attention runs
    over `seq`, dense or MoE, as in the JAX package."""
    if cfg.attn_impl not in ("reference", "flash", "ring"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    check_mesh(mesh)
    if cfg.n_heads % axis(mesh, "model")[0]:
        raise ValueError(f"{cfg.n_heads} heads do not split over "
                         f"model={axis(mesh, 'model')[0]}")


def init_params(cfg: TransformerConfig, device="cuda",
                generator: torch.Generator | None = None) -> dict:
    """Random parameters in the reference's tree and layout, drawn with
    `generator` (which must live on `device`): normal / sqrt(fan_in) drawn
    in f32, then cast to cfg.dtype (the MoE router stays f32), as the
    reference draws them. The
    numbers differ from the JAX package's (another generator); tests
    convert the JAX package's parameters instead."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device)
        return (w / fan_in ** 0.5).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    d, f = cfg.d_model, cfg.d_ff
    params = {
        "embedding": dense((cfg.vocab_size, d), d),
        "w_out": dense((d, cfg.vocab_size), d),
        "final_scale": ones(d),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_scale": ones(d),
            "wq": dense((d, d), d),
            "wk": dense((d, d), d),
            "wv": dense((d, d), d),
            "wo": dense((d, d), d),
            "mlp_scale": ones(d),
        }
        if cfg.n_experts > 0:
            layer.update(init_moe_layer(cfg, device, generator))
        else:
            layer.update({
                "w_gate": dense((d, f), d),
                "w_up": dense((d, f), d),
                "w_down": dense((f, d), f),
            })
        params["layers"].append(layer)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every parameter tensor, in a fixed order."""
    leaves = [params["embedding"], params["w_out"], params["final_scale"]]
    for layer in params["layers"]:
        leaves.extend(layer[name] for name in sorted(layer))
    return leaves


def _rmsnorm(x, scale):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


def _rope(x, positions, theta):
    """Rotary embeddings over the last (head_dim) axis, halves split (not
    interleaved). x: [B, S, H, D]; positions: [B, S]."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32) / half
    ).to(x.device)
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(layer, x, positions, cfg: TransformerConfig, mesh=None):
    """Attention over this rank's heads (n_heads / model of them) for its
    chunk of the sequence; the output projection's partial sums are added
    over `model`."""
    b, s, _ = x.shape
    t, _, group = axis(mesh, "model")
    h, hd = cfg.n_heads // t, cfg.head_dim
    x = comm.copy_to_group(x, group)
    q = (x @ layer["wq"]).reshape(b, s, h, hd)
    k = (x @ layer["wk"]).reshape(b, s, h, hd)
    v = (x @ layer["wv"]).reshape(b, s, h, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    if cfg.attn_impl == "ring":
        if mesh is None:
            raise ValueError("attn_impl='ring' requires a mesh")
        out = ring_attention(q, k, v, mesh, causal=True)
    else:
        attend = (flash_attention if cfg.attn_impl == "flash"
                  else reference_attention)
        _, seq_rank, seq_group = axis(mesh, "seq")
        if seq_group is None:
            out = attend(q, k, v, causal=True)
        else:
            # What XLA does with an operand cut over `seq` that it cannot
            # partition (the Pallas call): every rank attends over the
            # whole sequence and keeps its chunk.
            whole = comm.gather_over_group(torch.stack((q, k, v)), 2,
                                           seq_group)
            out = attend(*whole.unbind(0), causal=True).narrow(
                1, seq_rank * s, s)
    return comm.reduce_from_group(out.reshape(b, s, h * hd) @ layer["wo"],
                                  group)


def _mlp(layer, x, group):
    """SwiGLU over this rank's hidden columns, summed over `group`."""
    x = comm.copy_to_group(x, group)
    gate = torch.nn.functional.silu(x @ layer["w_gate"])
    return comm.reduce_from_group(
        (gate * (x @ layer["w_up"])) @ layer["w_down"], group)


def token_positions(tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """[B, S_local] global positions of this rank's tokens: its chunk of
    the sequence starts at its `seq` coordinate times S_local."""
    s = tokens.shape[1]
    first = axis(mesh, "seq")[1] * s
    return torch.arange(first, first + s,
                        device=tokens.device).expand(tokens.shape)


def _forward_with_aux(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, S] int -> (logits [B, S, vocab] f32, MoE aux loss summed
    over the layers, f32 scalar). Under a mesh, tokens are this rank's
    block and the logits its rows' and chunk's, over the whole
    vocabulary."""
    check_supported(cfg, mesh)
    group = axis(mesh, "model")[2]
    x = comm.gather_from_group(params["embedding"][tokens], -1, group)
    positions = token_positions(tokens, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        x = x + _attention(layer, _rmsnorm(x, layer["attn_scale"]),
                           positions, cfg, mesh)
        h = _rmsnorm(x, layer["mlp_scale"])
        if cfg.n_experts > 0:
            y, layer_aux = moe_mlp(layer, h, cfg, mesh)
            aux = aux + layer_aux
        else:
            y = _mlp(layer, h, group)
        x = x + y
    x = _rmsnorm(x, params["final_scale"])
    logits = comm.copy_to_group(x, group) @ params["w_out"]
    return comm.gather_from_group(logits, -1, group).float(), aux


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, S] int -> logits [B, S, vocab] float32."""
    return _forward_with_aux(params, tokens, cfg, mesh)[0]


def loss_fn(params, tokens, cfg: TransformerConfig, mesh=None,
            targets=None):
    """Next-token cross entropy (tokens serve as their own shifted targets).
    The full [B, S] sequence is forwarded and the last-position logits
    dropped afterwards, as the reference does. With MoE the Switch
    load-balancing aux loss is added, scaled by cfg.moe_aux_weight / the
    layer count (and by 1 / seq under a mesh, where every `seq` rank holds
    the global aux loss).

    Under a mesh, `tokens`, `targets` and `params` are this rank's shards
    (``parallel.sharding.local_batch``, ``shard_params``; `targets`
    defaults to ``tokens[:, 1:]``, which is right only for a whole
    sequence). The sum of the NLL is divided by the count of predicted
    positions in the whole sequence, so the losses of the `seq` ranks add
    up to their rows' loss, and the global loss is the mean of that over
    `data` (``models.train`` takes both)."""
    n_seq = axis(mesh, "seq")[0]
    if targets is None:
        if n_seq > 1:
            raise ValueError("a loss over a `seq` cut needs the targets of "
                             "local_batch")
        targets = tokens[:, 1:]
    logits, aux = _forward_with_aux(params, tokens, cfg, mesh)
    logprobs = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
    nll = -torch.gather(logprobs, -1, targets[..., None])
    loss = nll.sum() / (tokens.shape[0] * (tokens.shape[1] * n_seq - 1))
    if cfg.n_experts > 0:
        # Every `seq` rank holds the global aux loss and the step sums
        # the ranks' losses over `seq`: each adds its 1/seq share.
        loss = loss + cfg.moe_aux_weight * aux / (cfg.n_layers * n_seq)
    return loss
