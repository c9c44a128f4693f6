"""The plain reference of a Llama-style decoder and its AdamW step, in
float32 with plain torch operations, TF32 off. Parameters and optimizer
moments are kept in the configuration's dtype (``torch_dtype``), as the
configuration trains them: every update is computed in float32 and
rounded to it.

It follows the published architecture (RMSNorm before attention and MLP,
rotary embeddings with the head split in halves, causal multi-head
attention, SwiGLU, untied output head, next-token cross entropy averaged
over the predicted positions) and torch's AdamW (decoupled weight decay,
bias-corrected moments). It imports nothing of the measured program: it
takes the weights and tokens the benchmark made, by leaf name, and works
everything else out itself.

To fit a 10-layer, 4096-token step in float32 on one card beside its own
optimizer state, each layer is recomputed in the backward
(``torch.utils.checkpoint``), and attention runs over a few heads at a time,
each group recomputed too. That changes where memory goes, not the
arithmetic.

``precision="fp8"`` is the control: every product of a weight matrix takes
its inputs rounded to float8 (e4m3 forward, e5m2 for the gradients, each
tensor scaled to its largest value, as fp8 training recipes keep linear
layers), the arithmetic one step below the model's bfloat16; attention
stays as in the reference.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

HEAD_GROUP = 8  # heads attended at a time
# The dtype a configuration's parameters and optimizer moments are kept in.
STATE_DTYPES = {"bfloat16": torch.bfloat16}


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to float8 `dtype` after scaling its largest magnitude to
    the format's largest value, returned in float32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Reference:
    """The model's function on float32 leaves, by name (see
    ``leaf_shapes``), in `precision` "fp32" or "fp8" (the control)."""

    def __init__(self, model: dict, precision: str = "fp32"):
        self.m = model
        self.d = model["hidden_size"]
        self.h = model["num_attention_heads"]
        self.hd = self.d // self.h
        self.eps = float(model["rms_norm_eps"])
        self.theta = float(model["rope_theta"])
        self.mm = _Fp8Matmul.apply if precision == "fp8" else torch.matmul

    def _norm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * scale

    def _rope(self, x):
        s, half = x.shape[1], x.shape[-1] // 2
        freqs = torch.exp(-math.log(self.theta) * torch.arange(
            0, half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
            * freqs
        cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attend(self, q, k, v):
        """Causal softmax attention; q, k, v [B, S, h, D] for some heads."""
        s = q.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.hd)
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _layer(self, w, i, x):
        p = f"layers.{i}."
        b, s, _ = x.shape
        y = self._norm(x, w[p + "attn_scale"])
        q = self._rope(self.mm(y, w[p + "wq"]).view(b, s, self.h, self.hd))
        k = self._rope(self.mm(y, w[p + "wk"]).view(b, s, self.h, self.hd))
        v = self.mm(y, w[p + "wv"]).view(b, s, self.h, self.hd)
        heads = [checkpoint(self._attend, q[:, :, g:g + HEAD_GROUP],
                            k[:, :, g:g + HEAD_GROUP],
                            v[:, :, g:g + HEAD_GROUP], use_reentrant=False)
                 for g in range(0, self.h, HEAD_GROUP)]
        x = x + self.mm(torch.cat(heads, 2).reshape(b, s, self.d),
                        w[p + "wo"])
        y = self._norm(x, w[p + "mlp_scale"])
        gate = torch.nn.functional.silu(self.mm(y, w[p + "w_gate"]))
        return x + self.mm(gate * self.mm(y, w[p + "w_up"]), w[p + "w_down"])

    def loss(self, w: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross entropy of tokens [B, S]."""
        x = w["embedding"][tokens]
        for i in range(self.m["num_hidden_layers"]):
            x = checkpoint(self._layer, w, i, x, use_reentrant=False)
        x = self._norm(x, w["final_scale"])
        logits = self.mm(x[:, :-1], w["w_out"])
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


def leaf_shapes(model: dict) -> dict:
    """Leaf name -> shape of the model's tree (x @ W layout, W [in, out])."""
    d, f, v = (model["hidden_size"], model["intermediate_size"],
               model["vocab_size"])
    shapes = {"embedding": (v, d), "w_out": (d, v), "final_scale": (d,)}
    for i in range(model["num_hidden_layers"]):
        p = f"layers.{i}."
        shapes.update({p + "attn_scale": (d,), p + "wq": (d, d),
                       p + "wk": (d, d), p + "wv": (d, d), p + "wo": (d, d),
                       p + "mlp_scale": (d,), p + "w_gate": (d, f),
                       p + "w_up": (d, f), p + "w_down": (f, d)})
    return shapes


class AdamW:
    """torch.optim.AdamW's update on float32 leaves: decoupled weight
    decay, then the bias-corrected Adam step, computed in float32. With a
    `state_dtype`, the parameters and both moments are kept in it: each is
    rounded to it after every update, as a model trained in that dtype
    keeps them."""

    def __init__(self, leaves: dict, lr, betas, eps, weight_decay,
                 state_dtype=None):
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.state_dtype = state_dtype
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in leaves.items():
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            if self.state_dtype is not None:
                for t in (p, self.m[k], self.v[k]):
                    t.copy_(t.to(self.state_dtype))


def train_readings(model: dict, optimizer: dict, leaves: dict, batches: list,
                   precision: str = "fp32") -> dict:
    """Trains float32 `leaves` (name -> tensor, updated in place) for one
    step per batch and returns what the comparison reads: each step's
    loss, each leaf's first-gradient norm and its change's norm after the
    last step. TF32 stays off throughout."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(model, precision)
        # The benchmark's weights are bfloat16 values, so their float32
        # copies keep the start exactly at half the memory.
        first = {k: p.detach().to(torch.bfloat16) for k, p in leaves.items()}
        for p in leaves.values():
            p.requires_grad_(True)
        opt = AdamW(leaves, optimizer["lr"], optimizer["betas"],
                    optimizer["eps"], optimizer["weight_decay"],
                    STATE_DTYPES.get(model["torch_dtype"]))
        losses, grad_norms = [], {}
        for n, tokens in enumerate(batches):
            for p in leaves.values():
                p.grad = None
            loss = ref.loss(leaves, tokens)
            loss.backward()
            losses.append(loss.item())
            if n == 0:
                grad_norms = {k: float(p.grad.norm())
                              for k, p in leaves.items()}
            opt.step(leaves)
        change = {}
        for k, p in leaves.items():
            change[k] = float((p.detach() - first.pop(k).float()).norm())
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
