"""The cost of one capture's spans in the job's process: recording the
spans the shim records of a capture (obs.span, nested as the shim nests
them), listing them as the manifest does (Chrome-trace events, written
as JSON) and sending them to dynologd (IpcClient.send_spans, as the shim
does after each manifest), each timed per capture on the host's clock,
beside a real dynologd from the checkout's build:

    python3 perfbench/span_cost.py [--captures N]

prints one JSON line: the median and 95th percentile (nearest rank) of
each, in us, and how many spans dynologd holds of the last capture."""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The spans of one duration capture of an app that steps, by parent:
# shim.capture's phases, shim.export's, and those on other threads.
CAPTURE = ("shim.park", "shim.profiler_start", "shim.lead", "shim.window",
           "shim.profiler_stop")
EXPORT = ("shim.kineto_save", "shim.free_session")
BESIDE = ("shim.step_held", "shim.finish")


def record_one(obs, journal, ctx) -> None:
    """One capture's spans into `journal`, under `ctx`."""
    with obs.span("shim.capture", ctx=ctx, journal=journal):
        here = obs.current()
        for name in CAPTURE:
            with obs.span(name, journal=journal):
                pass
        with obs.span("shim.export", journal=journal):
            for name in EXPORT:
                with obs.span(name, journal=journal):
                    pass
    for name in BESIDE:
        with obs.span(name, ctx=here, journal=journal):
            pass
    with obs.span("shim.artifact_write", ctx=ctx, journal=journal):
        pass


def _pctl(values: list, p: float) -> float:
    values = sorted(values)
    return values[max(math.ceil(p * len(values)), 1) - 1]


def measure(captures: int) -> dict:
    from dynolog_tpu_torch import obs
    from dynolog_tpu_torch.client import ipc
    from perfbench import spans
    from perfbench.daemon import Daemon, build

    build(ROOT)
    daemon = Daemon(ROOT)
    record_us, list_us, send_us, sent = [], [], [], 0
    try:
        journal = obs.SpanJournal()
        with ipc.IpcClient() as client:
            for _ in range(captures):
                ctx = obs.TraceContext.mint()
                t0 = time.perf_counter()
                record_one(obs, journal, ctx)
                t1 = time.perf_counter()
                json.dumps([s.chrome_event() for s in journal.snapshot()
                            if s.trace_id == ctx.trace_id], indent=2)
                t2 = time.perf_counter()
                sent = client.send_spans(journal.drain(),
                                         dest=daemon.endpoint)
                t3 = time.perf_counter()
                record_us.append((t1 - t0) * 1e6)
                list_us.append((t2 - t1) * 1e6)
                send_us.append((t3 - t2) * 1e6)
                time.sleep(0.02)  # the daemon drains between captures
        time.sleep(0.2)
        held = spans.selftrace(daemon, f"{ctx.trace_id:016x}") or []
    finally:
        daemon.stop()
    return {"captures": captures, "spans_per_capture": sent,
            "daemon_holds_of_last": len(held),
            "record_us": {"median": _pctl(record_us, 0.5),
                          "p95": _pctl(record_us, 0.95)},
            "list_us": {"median": _pctl(list_us, 0.5),
                        "p95": _pctl(list_us, 0.95)},
            "send_us": {"median": _pctl(send_us, 0.5),
                        "p95": _pctl(send_us, 0.95)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=200)
    print(json.dumps(measure(ap.parse_args().captures)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
