#!/usr/bin/env python3
"""How far apart equivalent bf16 runs of the MoE trainer lie, and which
mesh axis moves an expert-parallel run away from the one-process run.

chip_smoke.py's multi-card check trains its phase-10 model (Llama-3-8B
widths, 2 layers, 8 experts, top-2, bf16, flash attention) for two steps
and compares losses, gradient norms and gradient projections
(chip_smoke.ep_train, deviation). At init the router's probabilities are
near-uniform over the experts, so a rounding flips tokens' top-2 choices.
This script prints chip_smoke.deviation for:

- a repeat of the one-process run (B=2), which should be bit-equal;
- the one-process run with plain attention in place of the kernels (an
  equivalent computation that rounds differently);
- MeshSpec(data=2, expert=2) on 4 cards against the one-process run (B=2);
- MeshSpec(expert=2) on 2 cards against the one-process run (B=1);
- MeshSpec(data=2) on 2 cards against the one-process run (B=2).

Run on four cards: python3 scripts/torch_ep_noise.py
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynolog_tpu_torch.ops import _build  # noqa: E402
from dynolog_tpu_torch.parallel.launch import spawn  # noqa: E402


def main() -> int:
    if torch.cuda.device_count() < 4:
        print("torch_ep_noise: needs four cards", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 router
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    cfg = cs.moe_config()
    meshes = {"data=2 expert=2": {"data": 2, "expert": 2},
              "expert=2": {"data": 1, "expert": 2},
              "data=2": {"data": 2, "expert": 1}}
    ranks = {name: spawn(cs._ep_rank, spec["data"] * spec["expert"], "nccl",
                         (spec,), timeout_s=300)
             for name, spec in meshes.items()}
    one = {rows: cs.ep_train(cfg, rows) for rows in (1, 2)}
    plain = cs.ep_train(dataclasses.replace(cfg, attn_impl="reference"), 2)
    rows = [("repeat, B=2", cs.ep_train(cfg, 2), one[2]),
            ("plain attention, B=2", plain, one[2])]
    for name, spec in meshes.items():
        rows += [(f"{name} rank {r}", got, one[spec["data"]])
                 for r, got in enumerate(ranks[name])]
    for name, a, b in rows:
        print(f"{name}: losses {a['losses']} against {b['losses']}; "
              f"{cs.deviation(a, b)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
