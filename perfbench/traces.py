"""Reading a kineto Chrome trace: what a capture recorded, where the
device time went, and which launches lost their kernel records.

The arithmetic of ``dynolog_tpu_torch.trace.unmatched_launches`` and of
``chip_smoke.py``'s ``device_breakdown`` is copied here, not imported, so
that the yardstick stays with the benchmark."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
STEP_PREFIX = "ProfilerStep#"
FLASH_FWD_OP = "_FlashAttention"
FLASH_BWD_OP = "_FlashAttentionBackward"
ADAMW_OP = "Optimizer.step#AdamW.step"


def load(path: str) -> tuple[list, int]:
    """(events, baseTimeNanoseconds) of a Chrome trace file."""
    with open(path) as f:
        doc = json.load(f)
    return doc.get("traceEvents", []), int(doc.get("baseTimeNanoseconds", 0))


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def unmatched_launches(events: list, base_ns: int,
                       stop_ns: int | None = None) -> int:
    """Kernel launches with no device record (joined by correlation), made
    before epoch ns `stop_ns` where given: the stop synchronises the card
    first, so each of those has run and must have been recorded."""
    device = {_corr(e) for e in events if e.get("cat") in DEVICE_CATS}
    base_us = base_ns / 1e3
    stop_us = None if stop_ns is None else stop_ns / 1e3
    return sum(1 for e in events
               if e.get("cat") in LAUNCH_CATS
               and "Launch" in e.get("name", "")
               and _corr(e) not in device
               and (stop_us is None or float(e["ts"]) + base_us < stop_us))


def step_starts_ns(events: list, base_ns: int) -> list[int]:
    """Epoch ns at which each ProfilerStep#N span of the trace begins."""
    return sorted(int(round(float(e["ts"]) * 1e3)) + base_ns for e in events
                  if e.get("name", "").startswith(STEP_PREFIX))


def device_records(events: list) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def union_busy_us(records: list) -> tuple[float, list]:
    """(busy us, idle gaps as (start us, end us)) of the device records'
    union between the first start and the last end."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in records)
    busy, gaps, end = 0.0, [], None
    for a, b in spans:
        if end is None:
            busy, end = b - a, b
            continue
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, gaps


def _host_ops(events: list) -> list[dict]:
    """Host spans: torch's ops and record_function scopes (such as
    ``Optimizer.step#AdamW.step``), not the device's annotations."""
    return [e for e in events if e.get("cat") in HOST_CATS]


def launches_under(events: list, op_name: str) -> list[list]:
    """Per instance of host op `op_name`: the launches made on its thread
    inside its span (cuda runtime events), as lists of correlation ids."""
    by_tid: dict = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "Launch" in e.get("name", ""):
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), _corr(e)))
    out = []
    for op in _host_ops(events):
        if op.get("name") != op_name:
            continue
        t0 = float(op["ts"])
        t1 = t0 + float(op.get("dur", 0))
        out.append([c for ts, c in by_tid.get(op.get("tid"), ())
                    if t0 <= ts <= t1])
    return out


def op_instances(events: list, op_name: str, need=()) -> list[dict]:
    """The instances of host op `op_name` whose every launch has its
    device record and whose kernels include each name in `need`: for each,
    the device seconds of its kernels (``seconds``) and their names."""
    records = {}
    for e in device_records(events):
        records.setdefault(_corr(e), []).append(e)
    out = []
    for corrs in launches_under(events, op_name):
        if not corrs or any(c not in records for c in corrs):
            continue
        recs = [r for c in corrs for r in records[c]]
        names = [r.get("name", "") for r in recs]
        if all(any(n in k for k in names) for n in need):
            out.append({"seconds": sum(float(r.get("dur", 0))
                                       for r in recs) / 1e6,
                        "kernels": names})
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameters, and without
    its template arguments where they make it long."""
    name = name.replace("(anonymous namespace)", "anon")
    name = name.removeprefix("void ").split("(", 1)[0]
    return name.split("<", 1)[0] if len(name) > 80 else name


def top_device_ops(records: list, top: int = 10) -> list:
    """[name, seconds] of the device records' (short) names that took
    most time."""
    by_name: dict = {}
    for e in records:
        name = short_name(e.get("name", ""))
        by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0)) / 1e6
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]


def named_gaps(events: list, gaps: list, top: int = 10) -> list:
    """[name, seconds] of the longest idle gaps, each named by the
    innermost host op running when the device went idle ("no_host_event"
    where none ran)."""
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "")) for e in _host_ops(events)),
                 key=lambda o: o[0])
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = [o for o in ops if o[0] <= a < o[1]]
        name = min(inner, key=lambda o: o[1] - o[0])[2] if inner else (
            "no_host_event")
        out.append([name, (b - a) / 1e6])
    return out
