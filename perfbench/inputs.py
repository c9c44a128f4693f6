"""What the benchmark makes from the seed and hands to both sides: the
weights, in the type they are trained in, and the token batches.

Weights come from one generator on the card in one call per kind (a flat
buffer of every matrix, then the norm scales as ones), so the same seed
gives the same bits again after the measured window, when the reference
needs them."""

from __future__ import annotations

import torch

from perfbench import parts

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mix(seed: int, salt: int) -> int:
    """A generator seed for stream `salt` of run seed `seed`."""
    return (seed * 0x9E3779B1 + salt) % (2 ** 63)


def _layout(model: dict) -> list:
    """(name, shape, offset) of each matrix in the flat buffer, in leaf
    order, and the vectors with offset None."""
    out, offset = [], 0
    shapes = parts.load("reference", model["reference"]).leaf_shapes(model)
    for name, shape in shapes.items():
        if len(shape) == 2:
            out.append((name, shape, offset))
            offset += shape[0] * shape[1]
        else:
            out.append((name, shape, None))
    return out


def make_weights(model: dict, seed: int, device) -> dict:
    """Leaf name -> weight tensor in the model's dtype: every matrix normal
    with std ``initializer_range``, every norm scale ones."""
    dtype = DTYPES[model["torch_dtype"]]
    layout = _layout(model)
    total = sum(s[0] * s[1] for _, s, off in layout if off is not None)
    gen = torch.Generator(device=device).manual_seed(_mix(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat.mul_(model["initializer_range"])
    out = {}
    for name, shape, off in layout:
        if off is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = flat[off:off + shape[0] * shape[1]].view(shape)
    return out


class Batches:
    """Token batches [batch, seq_len] in [0, vocab) drawn in turn from one
    generator on the card: every step's rows differ."""

    def __init__(self, model: dict, traffic: dict, seed: int, device):
        self.shape = (traffic["batch"], traffic["seq_len"])
        self.vocab = model["vocab_size"]
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(_mix(seed, 2))

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)

