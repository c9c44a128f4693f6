"""What the shim's spans say of each capture in one run of a cell: runs the
cell as run.py does, with the same arguments, and after the window, while
dynologd and the captures' traces are still there, reads each capture's
spans back through `dyno selftrace` and lays them over its trace:

    python3 perfbench/phases.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Before run.py's own output it prints one JSON line ``{"phases": ...}`` to
standard error:

- ``captures_without_spans``: captures whose spans did not come back
  through `dyno selftrace` within ``spans.WAIT_S``, or came back without a
  span their manifest lists;
- ``phase_ms``: each span's length per capture, in ms, averaged over the
  captures that hold it (the spans from `dyno selftrace`, which also hold
  what followed the manifest: ``shim.artifact_write``, ``trace.convert``);
- ``step_op_offset_us``: each ProfilerStep#N span's start (the shim's
  clock: its ``step()``) to the first ``cpu_op`` on its thread at or after
  it (kineto's clock), median, max and count;
- ``gap_spans``: the captures' longest device idle gaps, each as [the
  innermost host op over it ("no_host_event" where none ran), seconds,
  the innermost of its capture's spans when it began]."""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOP_GAPS = 10


def step_op_offsets_us(events: list) -> list[float]:
    """For each ProfilerStep#N span, the us to the start of the first
    cpu_op on its thread at or after it; none where no op follows."""
    from perfbench import traces

    ops: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(float(e["ts"]))
    for starts in ops.values():
        starts.sort()
    out = []
    for e in events:
        if e.get("name", "").startswith(traces.STEP_PREFIX):
            starts, t = ops.get(e.get("tid"), []), float(e["ts"])
            i = bisect.bisect_left(starts, t)
            if i < len(starts):
                out.append(starts[i] - t)
    return out


def gap_spans(events: list, base_ns: int, span_list: list) -> list:
    """[host op, seconds, span] of the trace's longest idle gaps."""
    from perfbench import spans, traces

    _, gaps = traces.union_busy_us(traces.device_records(events))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP_GAPS]
    return [traces.named_gaps(events, [(a, b)], 1)[0]
            + [spans.innermost(span_list, base_ns / 1e3 + a)]
            for a, b in longest]


def read(daemon, captures: list) -> dict:
    """The phases of `captures` (the harness's facts of each)."""
    from perfbench import spans, traces

    fetched = spans.fetch(daemon, captures)
    missing, offsets, gaps = 0, [], []
    for facts, got in zip(captures, fetched):
        listed = {e["args"]["span_id"] for e in spans.of(facts)}
        if got is None or not listed <= {e["args"]["span_id"] for e in got}:
            missing += 1
        manifest = facts["manifest"] or {}
        path = manifest.get("trace_file")
        if manifest.get("status") != "ok" or not path or not os.path.exists(
                path):
            continue
        events, base_ns = traces.load(path)
        offsets += step_op_offsets_us(events)
        gaps += gap_spans(events, base_ns, got or spans.of(facts))
    return {"captures": len(captures), "captures_without_spans": missing,
            "phase_ms": spans.phase_ms(
                [got or spans.of(f) for f, got in zip(captures, fetched)]),
            "step_op_offset_us": {
                "median": statistics.median(offsets), "max": max(offsets),
                "n": len(offsets)} if offsets else None,
            "gap_spans": sorted(gaps, key=lambda g: -g[1])[:TOP_GAPS]}


def main() -> int:
    from perfbench import harness, run

    measure = harness.measure

    def measured(job, daemon, *args, **kw):
        out = measure(job, daemon, *args, **kw)
        print(json.dumps({"phases": read(daemon, out.captures)}),
              file=sys.stderr, flush=True)
        return out

    harness.measure = measured
    return run.main()


if __name__ == "__main__":
    sys.exit(main())
