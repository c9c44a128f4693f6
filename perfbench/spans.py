"""A capture's spans: the shim's phases (``dynolog_tpu_torch/client/shim.py``'s
docstring lists them) as Chrome-trace "X" events, ``ts`` and ``dur`` in us
on the unix clock that the manifests, the traces and the harness's step
marks use too. The shim lists them in each capture's manifest (``spans``)
and sends them to dynologd, where `dyno selftrace --trace_id` serves them
(``selftrace``, ``fetch``). The shim's per-layer metrics read the
manifest's. A program that records none of a span has none to read, and
its readers return None."""

from __future__ import annotations

import json
import subprocess
import time

from perfbench.daemon import bin_dir

# The last span the shim sends of a capture: its manifest's write.
LAST = "shim.artifact_write"
WAIT_S = 5.0  # past the manifests, for the spans that follow them


def of(facts: dict) -> list[dict]:
    """The spans a capture's manifest lists (none without a manifest, or
    from a shim that lists none)."""
    return (facts.get("manifest") or {}).get("spans") or []


def selftrace(daemon, trace_id: str) -> list[dict] | None:
    """The spans `daemon` (a ``perfbench.daemon.Daemon``) holds of one
    request, as `dyno selftrace --trace_id` prints them. `trace_id` is 16
    hex digits, the first half of a manifest's ``trace_ctx``. None where
    dyno failed."""
    out = subprocess.run(
        [str(bin_dir(daemon.root) / "dyno"), "--hostname=localhost",
         f"--port={daemon.port}", "selftrace", f"--trace_id={trace_id}"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        return None
    return json.loads(out.stdout)["traceEvents"]


def fetch(daemon, captures: list) -> list:
    """Each capture's spans fetched through `dyno selftrace` by the trace-id
    of its manifest's ``trace_ctx``, waiting up to WAIT_S in all for each
    one's LAST span; None for a capture whose spans did not come."""
    deadline = time.time() + WAIT_S
    out = []
    for facts in captures:
        manifest, got = facts["manifest"], None
        if manifest and manifest.get("trace_ctx"):
            trace_id = manifest["trace_ctx"].split("/")[0]
            while got is None:
                events = selftrace(daemon, trace_id) or []
                if any(e.get("name") == LAST for e in events):
                    got = events
                elif time.time() >= deadline:
                    break
                else:
                    time.sleep(0.1)
        out.append(got)
    return out


def by_name(events: list) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e.get("name"), []).append(e)
    return out


def of_captures(run, name: str) -> list[dict]:
    """The spans, by name, of each of the run's captures whose manifest
    lists a `name` span."""
    named = [by_name(of(c)) for c in run.captures]
    return [n for n in named if name in n]


def total_us(named: dict, name: str) -> float:
    return sum(float(e.get("dur", 0)) for e in named.get(name, ()))


def mean_ms(run, name: str, among: str | None = None) -> float | None:
    """The summed length of each capture's `name` spans, in ms, averaged
    over the captures whose spans hold `among` (by default `name`); None
    where no capture's do."""
    caps = of_captures(run, among or name)
    if not caps:
        return None
    return sum(total_us(c, name) for c in caps) / len(caps) / 1e3


def phase_ms(span_lists: list) -> dict:
    """Each span name's summed length per capture, in ms, averaged over
    the captures (lists of spans) that hold it: the per-phase split."""
    sums: dict = {}
    for events in span_lists:
        named = by_name(events or [])
        for name in named:
            sums.setdefault(name, []).append(total_us(named, name) / 1e3)
    return {k: sum(v) / len(v) for k, v in sorted(sums.items())}


def innermost(events: list, at_us: float) -> str | None:
    """The name of the shortest span running at epoch us `at_us`."""
    over = [e for e in events
            if float(e["ts"]) <= at_us < float(e["ts"]) + float(e["dur"])]
    return min(over, key=lambda e: float(e["dur"]))["name"] if over else None
