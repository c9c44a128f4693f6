"""Kineto trace summarizer: what a captured torch.profiler trace holds.

The counterpart of ``dynolog_tpu/trace.py`` for the port's captures. The
shim writes torch.profiler's Chrome-trace JSON (``*.pt.trace.json``); this
module answers the operator's next question — *what did the device spend
its time on* — and produces the same summary dict as the JAX package's
summarizer, so the diff and the diagnosis engine read either one:

- every device's kernels, memcpys and memsets become one plane per device,
  ``/device:GPU:<n>``, with one line per stream;
- the host's ``cpu_op`` events and the Python tracer's
  ``python_function`` frames become the plane ``/host:CPU``, with one
  line per thread, as the JAX package's host plane holds XLA's host
  events and the Python frames on the line of the thread that ran them;
  a frame's row is its whole name (``train.py(12): step``);
- steps come from the ``ProfilerStep#N`` spans ``TraceClient.step()``
  marks on the host (torch.profiler's, or the shim's own where the host
  tracer was off). Only spans a later ``step()`` closed are steps; the
  last one runs from the last ``step()`` to ``stop()``. Where the device
  ran work launched inside a step's span, the step's time is the device's
  — from the first such kernel's start to the last one's end, the
  counterpart of XLA's device "Steps" line — else it is the host span.
  (kineto's own ``gpu_user_annotation`` ProfilerStep spans hold only the
  kernels launched outside any nested annotation, such as the optimizer
  step's, so they cover a fraction of a step and are not used.)

Times arrive as microsecond floats and are held as integer picoseconds,
so the aggregation and its rounding are the JAX package's. A kernel row's
``shapes`` are the input shapes of the ``cpu_op`` that launched it (joined
by ``External id``), not a result shape: torch.profiler records inputs.

``finish_trace`` is the other half of a capture's save: the shim's finish
child runs it over the trace kineto wrote (adding the shim's step spans,
taking the shim's event park out of the Python frames, dropping the
host ops at host level 0 and a window's lead, and promoting a ring
sample to its compact profile), so that no parse of a trace runs in the
traced process.

CLI::

    python -m dynolog_tpu_torch.trace <trace_dir | manifest.json | file>
        [--top 15] [--plane SUBSTR] [--json] [--per-op] [--diff BASE]
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import math
import os
import sys
from dataclasses import dataclass, field

from dynolog_tpu_torch import failpoints, obs
from dynolog_tpu_torch.stream import stream_write

# Chrome traces the shim writes, and the summary written beside each.
TRACE_SUFFIX = ".pt.trace.json"
SUMMARY_SUFFIX = ".summary.json"
# Device-side event categories that take time on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_PREFIX = "ProfilerStep#"
# Max distinct input shapes tracked per aggregated op.
SHAPES_PER_OP = 4
# torch.profiler's "Input type" spellings -> XLA's element type names.
_DTYPES = {
    "float": "f32", "double": "f64", "c10::Half": "f16",
    "c10::BFloat16": "bf16", "c10::Float8_e4m3fn": "f8e4m3fn",
    "c10::Float8_e5m2": "f8e5m2", "long int": "s64", "int": "s32",
    "short int": "s16", "signed char": "s8", "unsigned char": "u8",
    "bool": "pred",
}
_ANON = "(anonymous namespace)"


@dataclass
class OpAggregate:
    name: str
    total_ps: int = 0
    count: int = 0
    # Cost-model totals; torch.profiler records none, so the roofline
    # columns stay absent unless a producer adds them.
    flops: float = 0.0
    bytes_accessed: float = 0.0
    shapes: set = field(default_factory=set)


@dataclass
class PlaneSummary:
    name: str
    lines: int = 0
    events: int = 0
    duration_ps: int = 0  # span of the plane's events
    ops: dict = field(default_factory=dict)  # name -> OpAggregate
    line_names: list = field(default_factory=list)
    step_durations_ps: list = field(default_factory=list)


def _ps(us) -> int:
    """Chrome-trace microseconds (float) -> integer picoseconds."""
    return int(round(float(us) * 1e6))


def _strip_args(name: str) -> str:
    """Cuts a demangled C++ name at its argument list: the first '(' at
    template depth 0 that follows a name character. A parenthesis after
    a space ('Memcpy HtoD (Pageable -> Device)') is not an argument
    list, nor is '(anonymous namespace)'."""
    depth, i = 0, 0
    while i < len(name):
        if name.startswith(_ANON, i):
            i += len(_ANON)
            continue
        c = name[i]
        if c == "<":
            depth += 1
        elif c == ">":
            depth = max(depth - 1, 0)
        elif c == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            return name[:i]
        i += 1
    return name


def _fold_templates(name: str) -> str:
    """Drops every top-level template argument list:
    'multi_tensor_apply_kernel<TensorListMetadata<4>, ...>' ->
    'multi_tensor_apply_kernel'."""
    out, depth = [], 0
    for c in name:
        if c == "<":
            depth += 1
        elif c == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(c)
    return "".join(out)


def _op_key(name: str, group: bool) -> str:
    """Aggregation key of an event name: without a leading 'void ' and
    the argument list ('void ns::k<128>(float*, int)' -> 'ns::k<128>');
    with group=True also without template arguments ('ns::k') and a
    trailing '.N' instance number, as the JAX package folds 'fusion.116'
    into 'fusion'."""
    if name.startswith("void "):
        name = name[5:]
    name = _strip_args(name)
    if group:
        name = _fold_templates(name)
        base = name.rsplit(".", 1)
        if len(base) == 2 and base[1].isdigit():
            name = base[0]
    return name


def _input_shapes(args: dict) -> str:
    """'bf16[1,2048,32,128]' for an op with one tensor input, a tuple
    '(bf16[2048,4096], bf16[4096,4096])' for several; '' when the op
    recorded no tensor inputs. Non-tensor inputs (scalars, lists) are
    skipped."""
    types, dims = args.get("Input type"), args.get("Input Dims")
    if not isinstance(types, list) or not isinstance(dims, list):
        return ""
    parts = []
    for t, d in zip(types, dims):
        dtype = _DTYPES.get(t)
        if dtype is None or not isinstance(d, list):
            continue
        parts.append(f"{dtype}[{','.join(str(x) for x in d)}]")
    if len(parts) > 1:
        return "(" + ", ".join(parts) + ")"
    return parts[0] if parts else ""


def _step_number(name: str) -> int | None:
    if not name.startswith(STEP_PREFIX):
        return None
    tail = name[len(STEP_PREFIX):]
    return int(tail) if tail.isdigit() else None


def _add_span(spans: dict, n: int, start: int, end: int) -> None:
    # A step's device work may sit on several streams: its span is their
    # union.
    if n in spans:
        s0, e0 = spans[n]
        spans[n] = (min(s0, start), max(e0, end))
    else:
        spans[n] = (start, end)


def _device_steps(devices: dict, launches: dict, host_steps: list) -> dict:
    """device -> {n: (start, end)}: for each host step span (start, end,
    n), the span of the device events whose launch (a runtime or driver
    call, joined by correlation) falls inside it."""
    starts = [start for start, _, _ in host_steps]
    out: dict = {}
    for device, lines in devices.items():
        for line in lines.values():
            for e in line:
                t = launches.get((e.get("args") or {}).get("correlation"))
                if t is None:
                    continue
                i = bisect.bisect_right(starts, t) - 1
                if i < 0 or t >= host_steps[i][1]:
                    continue
                start = _ps(e.get("ts", 0))
                _add_span(out.setdefault(device, {}), host_steps[i][2],
                          start, start + _ps(e.get("dur", 0)))
    return out


def summarize_trace_events(events: list, group: bool = True
                           ) -> list[PlaneSummary]:
    """Planes of one Chrome trace's events: one per device, then the
    host's."""
    shapes_by_ext: dict = {}
    ext_by_corr: dict = {}
    launches: dict = {}  # correlation -> launch time (ps)
    devices: dict = {}  # device -> {stream: [events]}
    host_lines: dict = {}  # tid -> [events]
    spans: dict = {}  # host ProfilerStep#N -> (start, end)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device = args.get("device", e.get("pid"))
            devices.setdefault(device, {}).setdefault(
                e.get("tid"), []).append(e)
        elif cat == "cpu_op":
            host_lines.setdefault(e.get("tid"), []).append(e)
            shape = _input_shapes(args)
            if shape and "External id" in args:
                shapes_by_ext[args["External id"]] = shape
        elif cat == "python_function":
            host_lines.setdefault(e.get("tid"), []).append(e)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            ext_by_corr[args["correlation"]] = args.get("External id")
            launches[args["correlation"]] = _ps(e.get("ts", 0))
        elif cat == "user_annotation":
            n = _step_number(e.get("name", ""))
            if n is not None:
                start = _ps(e.get("ts", 0))
                _add_span(spans, n, start, start + _ps(e.get("dur", 0)))
    # The highest-numbered span is the one stop() closed.
    closed = sorted((start, end, n) for n, (start, end) in spans.items()
                    if n < max(spans, default=0))
    dev_steps = _device_steps(devices, launches, closed)
    host_steps = {n: (start, end) for start, end, n in closed}

    def plane(name: str, lines: dict, steps: dict | None) -> PlaneSummary:
        p = PlaneSummary(name=name)
        t0 = t1 = None
        for line_key in sorted(lines, key=str):
            p.line_names.append(
                f"stream {line_key}" if name.startswith("/device")
                else f"thread {line_key}")
            p.lines += 1
            for e in lines[line_key]:
                p.events += 1
                start = _ps(e.get("ts", 0))
                dur = _ps(e.get("dur", 0))
                t0 = start if t0 is None else min(t0, start)
                t1 = start + dur if t1 is None else max(t1, start + dur)
                key = (e.get("name", "") if e.get("cat") == "python_function"
                       else _op_key(e.get("name", ""), group))
                agg = p.ops.setdefault(key, OpAggregate(key))
                agg.total_ps += dur
                agg.count += 1
                args = e.get("args") or {}
                ext = args.get("External id")
                if ext is None:
                    ext = ext_by_corr.get(args.get("correlation"))
                shape = shapes_by_ext.get(ext)
                if shape and len(agg.shapes) < SHAPES_PER_OP:
                    agg.shapes.add(shape)
        if steps:
            p.line_names.append("Steps")
            p.lines += 1
            p.events += len(steps)
            p.step_durations_ps = [end - start for _, (start, end)
                                   in sorted(steps.items()) if end > start]
            for start, end in steps.values():
                t0 = start if t0 is None else min(t0, start)
                t1 = end if t1 is None else max(t1, end)
        if t0 is not None:
            p.duration_ps = t1 - t0
        return p

    planes = [plane(f"/device:GPU:{d}", devices[d], dev_steps.get(d))
              for d in sorted(devices, key=str)]
    # Host steps count only where no device recorded any.
    host_steps = None if dev_steps else host_steps
    if host_lines or host_steps:
        planes.append(plane("/host:CPU", host_lines, host_steps))
    return planes


def summarize_trace_bytes(data: bytes, group: bool = True
                          ) -> list[PlaneSummary]:
    return summarize_trace_events(json.loads(data)["traceEvents"], group)


def _read_trace(trace_path: str, data: bytes | None) -> bytes:
    if data is not None:
        return data
    with open(trace_path, "rb") as f:
        return f.read()


def _derived_path(trace_path: str, ext: str) -> str:
    """<dir>/<run>.pt.trace.json -> <dir>/<run><ext>."""
    base = (trace_path[: -len(TRACE_SUFFIX)]
            if trace_path.endswith(TRACE_SUFFIX) else trace_path)
    return base + ext


def write_summary_json(trace_path: str, data: bytes | None = None) -> str:
    """Write <run>.summary.json next to a Chrome trace: the summarize()
    output (planes, step stats, top-op table), so every capture
    self-describes without the operator running anything."""
    summary = _summarize_planes(
        summarize_trace_bytes(_read_trace(trace_path, data)))
    out_path = _derived_path(trace_path, SUMMARY_SUFFIX)
    stream_write(out_path, [json.dumps(summary, indent=1).encode()])
    return out_path


def write_derived_artifacts(trace_path: str) -> list[str]:
    """The shim's summary child's entry point: writes the summary under a
    trace.convert span, parented to the capture's context when the shim
    handed one down via $DYNO_TRACE_CTX, and flushes the span to the
    daemon named by $DYNO_OBS_ENDPOINT on the way out. Returns the
    written paths; a failure costs the summary only (the trace is on
    disk)."""
    # Fault drill: trace.convert=throw kills this child the way a crash
    # does.
    failpoints.fire("trace.convert")
    written = []
    try:
        with obs.span("trace.convert", ctx=obs.from_env() or obs.current()):
            try:
                written.append(write_summary_json(trace_path))
            except (OSError, ValueError, KeyError, TypeError):
                pass  # best-effort: the canonical trace is on disk
    finally:
        obs.maybe_flush_env()
    return written


# What a capture at host level 0 drops from its trace, where the CPU
# activity ran for the Python tracer alone: torch's host ops, the
# autograd flows between them, and its own annotations (the
# ProfilerStep#N spans among them, and their projection onto the device
# timeline).
HOST_OP_CATEGORIES = ("cpu_op", "fwdbwd", "user_annotation",
                      "gpu_user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def step_events(times: list, tid: int, pid: int, base_ns: int) -> list[dict]:
    """ProfilerStep#N spans from step() times (epoch ns), span N from the
    N-th time to the next, as Chrome-trace events on a time base of
    `base_ns` (a kineto trace's baseTimeNanoseconds: its ts plus the base
    is epoch time in microseconds)."""
    return [{"ph": "X", "cat": "user_annotation",
             "name": f"{STEP_PREFIX}{n}", "pid": pid, "tid": tid,
             "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3,
             "args": {"source": "shim"}}
            for n, (t0, t1) in enumerate(zip(times, times[1:]))]


def _trim_lead(events: list, lead_us: float) -> list:
    """The events of a trace recorded from one step before its window,
    without that lead step: the window opens at the trace's own
    ProfilerStep#1 span where torch recorded one, else at `lead_us`. Gone
    are the host events that ended before it (those that straddle it are
    cut to start there), the runtime launches made before it, their flows
    and every device record of theirs (joined by correlation, wherever it
    ran), a device record with no launch that started before it, and
    ProfilerStep#0; torch's later spans are numbered from 0 again."""
    cut = min((float(e["ts"]) for e in events
               if e.get("cat") == "user_annotation"
               and e.get("name") == f"{STEP_PREFIX}1"), default=lead_us)
    launched, dropped = set(), set()
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            (dropped if float(e.get("ts", 0)) < cut else launched).add(corr)
    kept = []
    for e in events:
        ph, cat, ts = e.get("ph"), e.get("cat"), float(e.get("ts", 0))
        corr = (e.get("args") or {}).get("correlation")
        if ph == "M":
            kept.append(e)
        elif cat in DEVICE_CATS:
            if corr not in dropped and (corr in launched or ts >= cut):
                kept.append(e)
        elif cat in LAUNCH_CATS or ph in ("s", "f", "t"):
            if (e.get("id") if cat == "ac2g" else corr) in dropped or (
                    cat != "ac2g" and ts < cut):
                continue
            kept.append(e)
        elif _step_number(e.get("name", "")) is not None and cat in (
                "user_annotation", "gpu_user_annotation"):
            n = _step_number(e["name"])
            if n >= 1:
                kept.append({**e, "name": f"{STEP_PREFIX}{n - 1}"})
        elif ph == "X":
            end = ts + float(e.get("dur", 0))
            if end > cut:
                kept.append(e if ts >= cut else {**e, "ts": cut,
                                                 "dur": end - cut})
        elif ts >= cut:
            kept.append(e)
    return kept


# The shim's event park (client/shim.py) holds an app thread inside this
# function, a sys.monitoring callback, while a profiler starts. No profile
# hook fires inside such a callback, so torch's Python tracer, which
# records the frames on every thread's stack when it starts, never sees
# this frame return: it ends it when the frame that called it returns,
# and each frame below it when that frame's own caller returns.
PARK_FRAME = "_hold_at_python_event"


def _unpark_frames(events: list) -> list:
    """The events without the event park's frame (PARK_FRAME), each
    frame it sat on ending where torch's Python tracer ended the frame
    above it, the park frame's children moved to its caller."""
    frames = {}
    for e in events:
        if e.get("cat") == "python_function" and "args" in e:
            frames[(e.get("pid"), e.get("tid"),
                    e["args"].get("Python id"))] = e
    parks = [e for e in frames.values()
             if e.get("name", "").endswith(f"): {PARK_FRAME}")]
    if not parks:
        return events
    for park in parks:
        key = (park.get("pid"), park.get("tid"))
        chain = [park]
        while (e := frames.get((*key, chain[-1]["args"].get(
                "Python parent id")))) is not None:
            chain.append(e)
        ends = [float(e["ts"]) + float(e["dur"]) for e in chain]
        for e, end in zip(chain[1:], ends):
            e["dur"] = end - float(e["ts"])
        for child in frames.values():
            if ((child.get("pid"), child.get("tid")) == key
                    and child["args"].get("Python parent id")
                    == park["args"].get("Python id")):
                child["args"]["Python parent id"] = park["args"].get(
                    "Python parent id")
    dropped = {id(e) for e in parks}
    return [e for e in events if id(e) not in dropped]


def unmatched_launches(events: list, base_ns: int,
                       stop_ns: int | None = None) -> list[float]:
    """The epoch times (s) of the kernel launches among a Chrome trace's
    events (time base `base_ns`) that have no device record, joined by
    correlation: the launches whose kernel records the capture lost.
    With `stop_ns`, the epoch ns at which the profiler's stop began, only
    launches made before it count: the stop synchronizes the card first,
    so each of them has run, while a launch after it (another thread's,
    or a duration window's app still training) may never be recorded."""
    device = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") in DEVICE_CATS}
    base_us = base_ns / 1e3
    stop_us = None if stop_ns is None else stop_ns / 1e3
    return [(float(e["ts"]) + base_us) / 1e6 for e in events
            if e.get("cat") in LAUNCH_CATS
            and "Launch" in e.get("name", "")
            and (e.get("args") or {}).get("correlation") not in device
            and (stop_us is None or float(e["ts"]) + base_us < stop_us)]


def finish_trace(raw: str, out: str, steps: dict | None = None,
                 drop_host: bool = False, lead_ns: int | None = None,
                 stop_ns: int | None = None, profile: str | None = None,
                 top: int = 40, device: bool = True) -> dict:
    """Finishes a capture's Chrome trace as kineto saved it at `raw`,
    reading it once, and writes it to `out` (`raw` itself may be `out`):
    without the event park's frame (_unpark_frames); without the host
    ops (HOST_OP_CATEGORIES) where `drop_host`; without
    the lead step (see _trim_lead) where the window recorded from one
    step early, `lead_ns` being the epoch ns of its first step; with the
    spans of `steps` ({"times", "tid", "pid"}: see step_events) added,
    or only those where kineto saved no trace. With `profile`, also
    writes the finished trace's compact_profile(top) there. Returns the
    finished trace's bytes and the launches of its window that have no
    device record, made before `stop_ns` where given (unmatched_launches):
    {"write_bytes", "lost_launches"}; lost_launches is None where the
    capture did not record the `device` (its device tracer off), whose
    launches have no device record by design. The shim runs this in a
    child process."""
    if os.path.exists(raw):
        with open(raw) as f:
            doc = json.load(f)
    else:
        doc = {"schemaVersion": 1, "traceEvents": [],
               "displayTimeUnit": "ms",
               "baseTimeNanoseconds": steps["times"][0] // 10**9 * 10**9}
    base_ns = doc.get("baseTimeNanoseconds", 0)
    events = _unpark_frames(doc["traceEvents"])
    if lead_ns is not None:
        events = _trim_lead(events, (lead_ns - base_ns) / 1e3)
    if drop_host:
        events = [e for e in events if e.get("cat") not in HOST_OP_CATEGORIES]
    lost = (len(unmatched_launches(events, base_ns, stop_ns)) if device
            else None)
    if steps is not None:
        events.extend(step_events(base_ns=base_ns, **steps))
    doc["traceEvents"] = events
    data = json.dumps(doc).encode()  # one-shot: the C encoder
    with open(out, "wb") as f:
        f.write(data)
    if profile is not None:
        stream_write(profile, [json.dumps(
            _compact(events, len(data), top, group=False)).encode()])
    return {"write_bytes": len(data), "lost_launches": lost}


def finish_capture(spec_path: str) -> None:
    """The shim's finish child's entry point: finish_trace with the
    keyword arguments of the JSON file at `spec_path`; prints its result
    as one JSON line, which the shim reads."""
    with open(spec_path) as f:
        print(json.dumps(finish_trace(**json.load(f))))


def find_trace_files(target: str) -> list[str]:
    """Resolve a shim manifest (its trace_file, else its trace_dir), a
    trace dir (the newest *.pt.trace.json under it) or a trace file."""
    if target.endswith(TRACE_SUFFIX):
        return [target]
    if target.endswith(".json"):
        with open(target) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "traceEvents" in doc:
            return [target]
        if doc.get("trace_file"):
            return [doc["trace_file"]]
        target = doc["trace_dir"]
    if os.path.isfile(target):
        return [target]
    hits = glob.glob(os.path.join(glob.escape(target), "**",
                                  "*" + TRACE_SUFFIX), recursive=True)
    return [max(hits, key=os.path.getmtime)] if hits else []


def summarize(target: str, group: bool = True) -> dict:
    planes: list[PlaneSummary] = []
    for path in find_trace_files(target):
        with open(path, "rb") as f:
            planes.extend(summarize_trace_bytes(f.read(), group=group))
    return _summarize_planes(planes)


def compact_profile(data: bytes, top: int = 40, group: bool = False) -> dict:
    """Promote one serialized Chrome trace to a compact op-level profile
    — the capture ring's storage unit and the diagnosis engine's
    comparable: the summarize() output with the op table capped at `top`
    rows plus the trace's size. group=False by default: per-kernel rows
    (template arguments kept) are the diagnosable unit."""
    return _compact(json.loads(data)["traceEvents"], len(data), top, group)


def _compact(events: list, n_bytes: int, top: int, group: bool) -> dict:
    profile = _summarize_planes(summarize_trace_events(events, group=group))
    profile["top_ops"] = profile["top_ops"][:top]
    profile["trace_bytes"] = n_bytes
    return profile


def _summarize_planes(planes: list[PlaneSummary]) -> dict:
    out = {"planes": [], "top_ops": []}
    step_ps = sorted(
        d for p in planes for d in p.step_durations_ps)
    if step_ps:
        def _pctl(p):
            # nearest-rank: ceil(p*n)-th order statistic (p50 of 2 = lower)
            k = math.ceil(p * len(step_ps))
            return step_ps[min(max(k - 1, 0), len(step_ps) - 1)]
        out["steps"] = {
            "count": len(step_ps),
            "mean_ms": round(sum(step_ps) / len(step_ps) / 1e9, 3),
            "p50_ms": round(_pctl(0.50) / 1e9, 3),
            "p95_ms": round(_pctl(0.95) / 1e9, 3),
            "max_ms": round(step_ps[-1] / 1e9, 3),
        }
    merged: dict[str, OpAggregate] = {}
    device_planes = [p for p in planes if "device" in p.name.lower()
                     or "tpu" in p.name.lower() or "gpu" in p.name.lower()]
    for p in planes:
        out["planes"].append(
            {
                "name": p.name,
                "lines": p.lines,
                "events": p.events,
                "duration_ms": round(p.duration_ps / 1e9, 3),
            }
        )
        # Op table from device planes when present (the question operators
        # ask), host planes otherwise.
        if p in (device_planes or planes):
            for name, agg in p.ops.items():
                m = merged.setdefault(name, OpAggregate(name))
                m.total_ps += agg.total_ps
                m.count += agg.count
                m.flops += agg.flops
                m.bytes_accessed += agg.bytes_accessed
                for shape in agg.shapes:
                    if len(m.shapes) < SHAPES_PER_OP:
                        m.shapes.add(shape)
    total_ps = sum(a.total_ps for a in merged.values()) or 1
    for agg in sorted(merged.values(), key=lambda a: -a.total_ps):
        row = {
            "op": agg.name,
            "total_ms": round(agg.total_ps / 1e9, 3),
            "count": agg.count,
            "pct": round(agg.total_ps / total_ps * 100.0, 1),
        }
        # Roofline view when a cost model was recorded (sub-microsecond
        # zero-FLOP events are completion markers, not transfers).
        marker = (
            agg.flops == 0 and agg.count > 0
            and agg.total_ps / agg.count < 1e6
        )
        if agg.total_ps > 0 and agg.flops > 0:
            row["gflops_per_s"] = round(agg.flops / (agg.total_ps / 1e3), 1)
        if agg.total_ps > 0 and agg.bytes_accessed > 0 and not marker:
            row["gib_per_s"] = round(
                agg.bytes_accessed / (agg.total_ps / 1e12) / (1 << 30), 1)
        if agg.flops > 0 and agg.bytes_accessed > 0:
            row["flop_per_byte"] = round(agg.flops / agg.bytes_accessed, 2)
        if agg.shapes:
            # Sorted for deterministic JSON — the diagnosis diff compares
            # these lists across captures.
            row["shapes"] = sorted(agg.shapes)
        out["top_ops"].append(row)
    return out


def diff_summaries(base: dict, cur: dict) -> dict:
    """Op-level regression report between two summaries (same flags).

    Windows differ in length between captures, so the comparable unit is
    per-occurrence mean time (total_ms / count) plus each op's share of
    device time; rows are ranked by estimated total impact — the per-call
    delta times the current call count (an op only present on one side
    contributes its whole total there).
    """
    out: dict = {"ops": []}
    bs, cs = base.get("steps"), cur.get("steps")
    if bs and cs:
        out["steps"] = {
            "base_p50_ms": bs["p50_ms"],
            "p50_ms": cs["p50_ms"],
            "delta_p50_ms": round(cs["p50_ms"] - bs["p50_ms"], 3),
            "base_p95_ms": bs["p95_ms"],
            "p95_ms": cs["p95_ms"],
            "delta_p95_ms": round(cs["p95_ms"] - bs["p95_ms"], 3),
        }
    base_ops = {o["op"]: o for o in base.get("top_ops", [])}
    cur_ops = {o["op"]: o for o in cur.get("top_ops", [])}
    for name in base_ops.keys() | cur_ops.keys():
        b, c = base_ops.get(name), cur_ops.get(name)

        def per_call(o):
            return o["total_ms"] / o["count"] if o and o["count"] else None

        bpc, cpc = per_call(b), per_call(c)
        row = {
            "op": name,
            "base_ms_per_call": round(bpc, 4) if bpc is not None else None,
            "ms_per_call": round(cpc, 4) if cpc is not None else None,
            "base_pct": b["pct"] if b else None,
            "pct": c["pct"] if c else None,
            "base_count": b["count"] if b else 0,
            "count": c["count"] if c else 0,
        }
        if bpc is not None and cpc is not None:
            row["delta_ms_per_call"] = round(cpc - bpc, 4)
            impact = (cpc - bpc) * row["count"]
        elif c is not None:  # new op: its whole current total is the impact
            impact = c["total_ms"]
        else:  # op vanished: its baseline total came off the profile
            impact = -b["total_ms"]
        if row["base_pct"] is not None and row["pct"] is not None:
            row["delta_pp"] = round(row["pct"] - row["base_pct"], 1)
        row["impact_ms"] = round(impact, 3)
        out["ops"].append(row)
    out["ops"].sort(key=lambda r: -abs(r["impact_ms"]))
    return out


def _print_diff(diff: dict, baseline: str, top: int) -> None:
    print(f"regression report vs baseline {baseline}")
    if "steps" in diff:
        s = diff["steps"]
        print(
            f"steps vs baseline: p50 {s['base_p50_ms']:.3f} -> "
            f"{s['p50_ms']:.3f} ms ({s['delta_p50_ms']:+.3f}), "
            f"p95 {s['base_p95_ms']:.3f} -> {s['p95_ms']:.3f} "
            f"({s['delta_p95_ms']:+.3f})")
    print(f"\n{'op':<36} {'ms/call':>17} {'Δms/call':>9} "
          f"{'% device':>15} {'Δpp':>6} {'impact ms':>10}")

    def cell(v, fmt, width):
        return (format(v, fmt) if v is not None else "-").rjust(width)

    for row in diff["ops"][:top]:
        print(
            f"{row['op']:<36.36} "
            f"{cell(row['base_ms_per_call'], '.4f', 8)}->"
            f"{cell(row['ms_per_call'], '.4f', 0):<7} "
            f"{cell(row.get('delta_ms_per_call'), '+.4f', 9)} "
            f"{cell(row['base_pct'], '.1f', 6)}->"
            f"{cell(row['pct'], '.1f', 0):<5} "
            f"{cell(row.get('delta_pp'), '+.1f', 6)} "
            f"{row['impact_ms']:>+10.3f}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "target", nargs="?", default="",
        help="trace dir, shim manifest, or *.pt.trace.json")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--plane", default="", help="only planes containing this")
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--per-op", action="store_true",
        help="keep template arguments and instance numbers "
             "(flash_fwd_kernel<128>) instead of grouping by base name")
    ap.add_argument(
        "--diff", default="",
        help="baseline trace (dir/manifest/file): print an op-level "
             "regression report of TARGET vs the baseline instead of a "
             "summary — which ops got slower per call, which grew their "
             "share of device time")
    args = ap.parse_args(argv)
    if not args.target:
        ap.error("target required")

    summary = summarize(args.target, group=not args.per_op)
    if args.diff:
        if args.plane:
            print("note: --plane has no effect with --diff (op tables are "
                  "already device-plane scoped)", file=sys.stderr)
        baseline = summarize(args.diff, group=not args.per_op)
        if not baseline["planes"] or not summary["planes"]:
            print("no trace found", file=sys.stderr)
            return 1
        diff = diff_summaries(baseline, summary)
        if args.json:
            print(json.dumps(diff))
        else:
            _print_diff(diff, args.diff, args.top)
        return 0
    if args.plane:
        summary["planes"] = [
            p for p in summary["planes"] if args.plane in p["name"]
        ]
    summary["top_ops"] = summary["top_ops"][: args.top]
    if args.json:
        print(json.dumps(summary))
        return 0
    if not summary["planes"]:
        print("no trace found", file=sys.stderr)
        return 1
    print(f"{'plane':<40} {'lines':>6} {'events':>8} {'span ms':>9}")
    for p in summary["planes"]:
        print(f"{p['name']:<40.40} {p['lines']:>6} {p['events']:>8} "
              f"{p['duration_ms']:>9.3f}")
    if "steps" in summary:
        s = summary["steps"]
        print(f"\nsteps: {s['count']}  mean {s['mean_ms']:.3f} ms  "
              f"p50 {s['p50_ms']:.3f}  p95 {s['p95_ms']:.3f}  "
              f"max {s['max_ms']:.3f}")
    has_roofline = any(
        "gflops_per_s" in op or "gib_per_s" in op
        for op in summary["top_ops"])
    hdr = f"\n{'op':<40} {'total ms':>9} {'count':>7} {'%':>6}"
    if has_roofline:
        hdr += f" {'GFLOP/s':>9} {'GiB/s':>8} {'FLOP/B':>7}"
    print(hdr)
    for op in summary["top_ops"]:
        line = (f"{op['op']:<40.40} {op['total_ms']:>9.3f} {op['count']:>7} "
                f"{op['pct']:>6.1f}")
        if has_roofline:
            line += (f" {op.get('gflops_per_s', 0):>9.1f}"
                     f" {op.get('gib_per_s', 0):>8.1f}"
                     f" {op.get('flop_per_byte', 0):>7.2f}")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
