"""The capture-rate sweep of a capture cell, on the card: one job, one
window per interval between captures, longest interval first. For each
capture: when it was asked for, when its manifest landed, whether it landed
before the next was due, and its check. The knee is the shortest interval
at which every manifest lands before the next capture is due.

    python3 perfbench/sweep.py --workload <cell> --seed N \
        --every 6,4,3,2,1.5 --seconds 25 [--out FILE]"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--every", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    from perfbench import harness

    harness.use_checkout_caches(ROOT)
    _, _, model, traffic = harness.load_spec(ROOT, args.workload)
    harness.build(ROOT, model, cuda=True)
    warm = Path(tempfile.mkdtemp(prefix="perfbench_sweep_"))
    try:
        daemon, job = harness.start(ROOT, model, traffic, args.seed, "cuda",
                                    warm)
    finally:
        shutil.rmtree(warm, ignore_errors=True)
    out = open(args.out, "a") if args.out else None
    try:
        for every in (float(x) for x in args.every.split(",")):
            tmp = Path(tempfile.mkdtemp(prefix="perfbench_sweep_"))
            spec = dict(traffic, captures=dict(traffic["captures"],
                                               every_s=every))
            run = harness.measure(job, daemon, tmp, spec, args.seconds, False)
            caps = []
            for c in run.captures:
                m, f = c["manifest"], c["fired"]
                landed = m["ended_ms"] / 1e3 if m else None
                caps.append({
                    "asked_s": round(f["fired"] - run.t0, 3),
                    "late_s": round(f["fired"] - f["due"], 3),
                    "latency_ms": None if landed is None else round(
                        (landed - f["fired"]) * 1e3),
                    "before_next": landed is not None
                    and landed < f["due"] + every,
                    "timing": m and {k: m["timing"].get(k) for k in (
                        "park_ms", "profiler_start_ms", "window_ms",
                        "profiler_stop_ms", "export_ms", "write_ms",
                        "trace_bytes", "lost_launches")},
                    "problems": c["problems"]})
            shutil.rmtree(tmp, ignore_errors=True)
            line = json.dumps({
                "every_s": every, "steps": run.steps,
                "tokens_per_s": run.tokens / run.window_s,
                "all_before_next": all(c["before_next"] for c in caps),
                "failed": sum(bool(c["problems"]) for c in caps),
                "captures": caps})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        harness.stop(job, daemon)
    return 0


if __name__ == "__main__":
    sys.exit(main())
