#!/usr/bin/env python3
"""How far apart equivalent bf16 runs of the port's trainers lie, and which
mesh axis moves a multi-card run away from the run it is held to.

chip_smoke.py's multi-card checks train for two steps and compare losses,
gradient norms and gradient projections (chip_smoke.mesh_train,
deviation). At init the MoE router's probabilities are near-uniform over
the experts, so a rounding flips tokens' top-2 choices. This script prints
chip_smoke.deviation for the cases named on its command line:

ep, phase 10's MoE model as the expert-parallel check trains it:
- a repeat of the one-process run (B=2), which should be bit-equal;
- the one-process run with plain attention in place of the kernels (an
  equivalent computation that rounds differently);
- MeshSpec(data=2, expert=2) against the one-process run (B=2), and
  MeshSpec(expert=2) (B=1) and MeshSpec(data=2) (B=2) alone;

tp, the tensor-parallel check's cases (chip_smoke.MESH_CASES), B=1:
- a repeat of phase 12's one-card ring run (the dense model with ring
  attention on a one-rank mesh), and that run against the flash run on
  one process (phase 12's distance);
- MeshSpec(seq=2, model=2) with ring attention against the one-card ring
  run, and MeshSpec(seq=2) and MeshSpec(model=2) alone;
- for phase 10's model: a repeat, plain attention against flash, and
  MeshSpec(expert=2, model=2) and MeshSpec(model=2) against one process;

sp, the sequence-parallel checks' cases (chip_smoke.MESH_CASES "sp" and
"moe_sp"):
- a repeat of the dense flash trainer on one process (B=1), and the
  reference-attention run against it (the check (d)'s floor);
- MeshSpec(seq=2, model=2) with flash attention against the one-process
  flash run, and MeshSpec(seq=2) alone;
- for phase 10's model at B=2: a repeat, plain attention against flash
  (the check (e)'s floor), and MeshSpec(seq=2, expert=2),
  MeshSpec(seq=2) and MeshSpec(expert=2) against one process;

pp, the pipeline check's model (chip_smoke.PIPE_MESH: 4 layers,
reference attention, B=4 in 4 microbatches):
- a repeat of the dense trainer on one process, and the flash trainer
  against it (the check's floor);
- the GPipe trainer over MeshSpec(pipe=1), MeshSpec(pipe=2) and
  MeshSpec(pipe=4) against the dense trainer on one process, and a
  repeat of the pipe=4 run.

Run on four cards: python3 scripts/torch_mesh_noise.py [ep] [tp] [sp] [pp]
(all four without arguments).
"""

import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dynolog_tpu_torch.ops import _build  # noqa: E402
from dynolog_tpu_torch.parallel.launch import spawn  # noqa: E402


def on_mesh(cfg, spec: dict, rows: int | None = None) -> list:
    """chip_smoke.mesh_train's result of every rank of MeshSpec(**spec)
    (on `rows` rows, one a `data` rank by default)."""
    cs.free_cache()
    return spawn(cs._mesh_rank, math.prod(spec.values()), "nccl",
                 (cfg, spec, rows), timeout_s=300)


def ep_rows() -> list:
    cfg = cs.moe_config()
    one = {rows: cs.mesh_train(cfg, rows) for rows in (1, 2)}
    plain = cs.mesh_train(dataclasses.replace(cfg, attn_impl="reference"), 2)
    rows = [("repeat, B=2", cs.mesh_train(cfg, 2), one[2]),
            ("plain attention, B=2", plain, one[2])]
    for spec in ({"data": 2, "expert": 2}, {"expert": 2}, {"data": 2}):
        rows += [(f"{spec} rank {r}", got, one[spec.get("data", 1)])
                 for r, got in enumerate(on_mesh(cfg, spec))]
    return rows


def tp_rows() -> list:
    ring_cfg = cs.dense_config("ring")
    ring = on_mesh(ring_cfg, {})[0]
    rows = [("ring repeat", on_mesh(ring_cfg, {})[0], ring),
            ("ring against flash", ring, cs.mesh_train(cs.dense_config()))]
    for spec in ({"seq": 2, "model": 2}, {"seq": 2}, {"model": 2}):
        rows += [(f"ring {spec} rank {r}", got, ring)
                 for r, got in enumerate(on_mesh(ring_cfg, spec))]
    moe = cs.moe_config()
    one = cs.mesh_train(moe)
    plain = cs.mesh_train(dataclasses.replace(moe, attn_impl="reference"))
    rows += [("MoE repeat", cs.mesh_train(moe), one),
             ("MoE plain attention", plain, one)]
    for spec in ({"expert": 2, "model": 2}, {"model": 2}):
        rows += [(f"MoE {spec} rank {r}", got, one)
                 for r, got in enumerate(on_mesh(moe, spec))]
    return rows


def sp_rows() -> list:
    flash = cs.dense_config()
    one = cs.mesh_train(flash)
    rows = [("flash repeat", cs.mesh_train(flash), one),
            ("reference against flash",
             cs.mesh_train(cs.dense_config("reference")), one)]
    for spec in ({"seq": 2, "model": 2}, {"seq": 2}):
        rows += [(f"flash {spec} rank {r}", got, one)
                 for r, got in enumerate(on_mesh(flash, spec))]
    moe, b = cs.moe_config(), cs.MESH_ROWS["moe_sp"]
    one = cs.mesh_train(moe, b)
    plain = cs.mesh_train(dataclasses.replace(moe, attn_impl="reference"), b)
    rows += [(f"MoE repeat, B={b}", cs.mesh_train(moe, b), one),
             (f"MoE plain attention, B={b}", plain, one)]
    for spec in ({"seq": 2, "expert": 2}, {"seq": 2}, {"expert": 2}):
        rows += [(f"MoE {spec} B={b} rank {r}", got, one)
                 for r, got in enumerate(on_mesh(moe, spec, b))]
    return rows


def pp_rows() -> list:
    cfg = cs.pipe_config(cs.PIPE_MESH["n_layers"])
    rows, n_micro = cs.PIPE_MESH["rows"], cs.PIPE_MESH["n_micro"]
    one = cs.mesh_train(cfg, rows)
    out = [("dense repeat", cs.mesh_train(cfg, rows), one),
           ("flash against reference attention", cs.mesh_train(
               dataclasses.replace(cfg, attn_impl="flash"), rows), one)]

    def pipe(n):
        cs.free_cache()
        return cs.merged(spawn(cs._pipe_rank, n, "nccl",
                               (cfg, {"pipe": n}, rows, n_micro),
                               timeout_s=300))

    four = pipe(4)
    out += [(f"GPipe pipe={n}", pipe(n), one) for n in (1, 2)]
    return out + [("GPipe pipe=4", four, one),
                  ("GPipe pipe=4 repeat", pipe(4), four)]


def main() -> int:
    cases = sys.argv[1:] or ["ep", "tp", "sp", "pp"]
    if not set(cases) <= {"ep", "tp", "sp", "pp"}:
        print("usage: torch_mesh_noise.py [ep] [tp] [sp] [pp]",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < 4:
        print("torch_mesh_noise: needs four cards", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 router
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    for case in cases:
        for name, a, b in {"ep": ep_rows, "tp": tp_rows, "sp": sp_rows,
                           "pp": pp_rows}[case]():
            print(f"{name}: losses {a['losses']} against {b['losses']}; "
                  f"{cs.deviation(a, b)}; steps {a['step_ms']} ms; peak "
                  f"{a['peak_gib']:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
