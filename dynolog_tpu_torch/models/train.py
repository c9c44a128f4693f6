"""Training step for the flagship workload: AdamW over the transformer of
``models.transformer``, the counterpart of ``dynolog_tpu/models/train.py``
on one device.

The JAX step is a pure function returning new parameters and optimizer
state. This one updates the parameters and the optimizer's state in
place (PyTorch's idiom; it keeps one copy of each in device memory) and
returns only the loss.
"""

from __future__ import annotations

import torch

from dynolog_tpu_torch import resolve_device
from dynolog_tpu_torch.models.transformer import (
    TransformerConfig, init_params, loss_fn, param_leaves)


def make_optimizer(params: dict, lr: float = 3e-4) -> torch.optim.AdamW:
    """The counterpart of ``optax.adamw(lr, weight_decay=0.01)``: both
    decouple the weight decay, decay every leaf, and keep the moments in
    the parameters' dtype."""
    return torch.optim.AdamW(param_leaves(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_state(cfg: TransformerConfig, device="cuda",
                     generator: torch.Generator | None = None,
                     lr: float = 3e-4):
    """(params, optimizer) on `device`, parameters drawn with `generator`."""
    params = init_params(cfg, device, generator)
    return params, make_optimizer(params, lr)


def make_train_step(cfg: TransformerConfig):
    """Returns step(params, optimizer, tokens) -> loss. The step updates
    `params` and the optimizer state IN PLACE (unlike the JAX package's
    pure step) and returns the loss as a 0-dim tensor on the device, not
    synchronised."""

    def step(params, optimizer, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_batch(generator: torch.Generator, cfg: TransformerConfig,
               batch_size: int, seq_len: int, device="cuda"):
    """Random tokens [batch_size, seq_len] in [0, vocab), drawn with
    `generator` (which must live on `device`)."""
    return torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                         generator=generator, device=resolve_device(device))
