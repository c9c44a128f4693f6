"""Runs one cell of the benchmark of dynolog_tpu_torch once, on the card it
is started on, and prints the result as the last line of its output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, where there is no card or fewer cards
than the cell asks for, where the program is not beside it, or where JAX,
Flax or the JAX package was loaded. See perfbench/README.md."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from perfbench import harness

    harness.use_checkout_caches(ROOT)
    cell = harness.load_spec(ROOT, args.workload)[1]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['chips']} card(s) asked for, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {loaded}", file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps({"detail": out["detail"]}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
