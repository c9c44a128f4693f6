"""Readings that the limits of `correct` are set from, on the card, at a
cell's own size: for each seed, the program's first steps against the
reference (the lower reading), and on the seeds asked for, the control
(the reference in float8 products put in the program's place) and the
program with half of each batch left out (the upper readings). A step
that leaves the state unchanged reads 1 by the change's measure and is
not run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

Prints one JSON line per reading; nothing else of the program runs (no
dynologd, no shim)."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def half_batch(loss_fn):
    """`loss_fn` over the first half of each row's positions only: half of
    the batch's tokens left out, the mean taken over the rest."""
    def loss(params, tokens, cfg, mesh=None, targets=None):
        s = tokens.shape[1] // 2
        return loss_fn(params, tokens[:, :s], cfg, mesh,
                       None if targets is None else targets[:, :s - 1])
    return loss


def program(model, traffic, seed, device="cuda"):
    from perfbench.harness import Job

    job = Job(model, dict(traffic, warm_steps=0), seed, device, None)
    readings = job.readings
    job.free()
    return readings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    import dynolog_tpu_torch.models.train as train

    from perfbench import check, harness

    harness.use_checkout_caches(ROOT)
    _, _, model, traffic = harness.load_spec(ROOT, args.workload)
    harness.build(ROOT, model, cuda=True, daemon=False)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(args.out, "a") if args.out else None
    for seed in ints(args.seeds):
        t0 = time.time()
        prog = program(model, traffic, seed)
        ref = harness.reference_readings(model, traffic, seed, "cuda")
        rows = [("program", check.training_numbers(prog, ref))]
        if seed in ints(args.control_seeds):
            ctrl = harness.reference_readings(model, traffic, seed, "cuda",
                                              "fp8")
            rows.append(("control_fp8", check.training_numbers(ctrl, ref)))
        if seed in ints(args.fault_seeds):
            plain = train.loss_fn
            train.loss_fn = half_batch(plain)
            try:
                half = program(model, traffic, seed)
            finally:
                train.loss_fn = plain
            rows.append(("half_batch", check.training_numbers(half, ref)))
        for kind, numbers in rows:
            line = json.dumps({"seed": seed, "kind": kind, **numbers,
                               "losses_ref": ref["losses"],
                               "seconds": round(time.time() - t0, 1)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
