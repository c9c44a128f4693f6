#!/usr/bin/env python3
"""Why the bf16 flash kernels carry P and dS as pairs of bf16.

The tensor cores take bf16 operands, so a kernel must hand them P (for
O += P V and dV += P^T dO) and dS (for dK += dS^T Q, dQ += dS K) in bf16.
This script emulates, in dense PyTorch on the CPU, what `chip_smoke.py`
checks on the card: a kernel whose f32 P and dP differ from the plain
version's only by the order of f32 sums and another exp (modelled as a
relative perturbation of a few f32 ulps), under `chip_smoke.agreement`'s
element-wise rule (one bf16 ulp of each output element + 1e-3 rms). It
prints the largest ratio of error to tolerance

- of dQ, dK and dV against the plain version that rounds at the same
  points (flash_*_plain with round_like_kernel=True, which decides for the
  backward kernels);
- of the forward's O = carry(P) V / l, against the plain version that
  carries P the same way and against the f32 plain version
  (flash_forward_plain, which decides for the forward kernel);

for three ways to carry P and dS:

- bf16: one rounding. A value whose two f32 versions straddle a bf16
  rounding boundary lands a bf16 ulp apart, and a large P or dS term
  moves a small output element by more than its own ulp;
- pair: hi = bf16(x), lo = bf16(x - hi), two products (16 bits);
- f32: no rounding (the JAX package's numerics).

Run: python3 scripts/torch_flash_rounding.py [--s 2048 --h 2 --d 128]
[--seed 0]
"""

from __future__ import annotations

import argparse
import math

import torch


def agreement_ratio(a, r) -> float:
    """chip_smoke.agreement's bf16 rule: max |a - r| / tol."""
    af, rf = a.float(), r.float()
    tol = 2.0 ** -7 * rf.abs() + 1e-3 * rf.pow(2).mean().sqrt()
    return ((af - rf).abs() / tol).max().item()


def bf16(x):
    return x.to(torch.bfloat16).float()


def pair(x):
    hi = bf16(x)
    return hi + bf16(x - hi)


def forward(p, v, carry):
    """O in bf16 from f32 P = exp(S - rowmax S), with P carried by `carry`
    into P V and the row sum l taken over the f32 P."""
    return (carry(p) @ v / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def grads(q, k, g, p, dp, delta, scale, carry):
    """dQ, dK, dV in bf16 from f32 P and dP, with P and dS carried by
    `carry` into the products that take them."""
    ds = p * (dp - delta[..., None])
    dq = (carry(ds) @ k) * scale
    dk = (carry(ds).mT @ q) * scale
    dv = carry(p).mT @ g
    return [x.to(torch.bfloat16) for x in (dq, dk, dv)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--s", type=int, default=2048)
    ap.add_argument("--h", type=int, default=2)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ulps", type=float, default=4.0,
                    help="f32 ulps of relative difference between the two "
                    "sides' P and dP")
    args = ap.parse_args()
    torch.manual_seed(args.seed)
    s, h, d = args.s, args.h, args.d
    q, k, v, g = (bf16(torch.randn(h, s, d)) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    scores = q @ k.mT * scale
    scores = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), scores,
                         -1e30)
    lse = torch.logsumexp(scores, -1)
    eps = args.ulps * 2.0 ** -24
    carries = (("bf16", bf16), ("pair", pair), ("f32", lambda x: x))

    p = torch.exp(scores - lse[..., None])
    out = bf16(p @ v)
    delta = (g * out).sum(-1)
    dp = g @ v.mT
    p_kernel = p * (1 + eps * torch.randn_like(p))
    dp_kernel = dp * (1 + eps * torch.randn_like(dp))
    print(f"H={h} S={s} D={d} causal, P and dP {args.ulps:g} f32 ulps apart;"
          f" max error / tolerance for dQ, dK, dV:")
    for name, carry in carries:
        ref = grads(q, k, g, p, dp, delta, scale, carry)
        got = grads(q, k, g, p_kernel, dp_kernel, delta, scale, carry)
        ratios = [agreement_ratio(a, r) for a, r in zip(got, ref)]
        print(f"  {name:5s} " + ", ".join(f"{x:.3f}" for x in ratios)
              + ("  FAILS the rule" if max(ratios) > 1 else ""))

    p_fwd = torch.exp(scores - scores.amax(-1, keepdim=True))
    p_fwd_kernel = p_fwd * (1 + eps * torch.randn_like(p_fwd))
    ref_f32 = forward(p_fwd, v, lambda x: x)
    print(f"H={h} S={s} D={d} causal, P {args.ulps:g} f32 ulps apart; max "
          f"error / tolerance of the forward's O against the plain version "
          f"that carries P the same way, and against the f32 one:")
    for name, carry in carries:
        got = forward(p_fwd_kernel, v, carry)
        same = agreement_ratio(got, forward(p_fwd, v, carry))
        f32 = agreement_ratio(got, ref_f32)
        print(f"  {name:5s} {same:.3f}, {f32:.3f}"
              + ("  FAILS the rule against the f32 plain version"
                 if f32 > 1 else ""))


if __name__ == "__main__":
    main()
