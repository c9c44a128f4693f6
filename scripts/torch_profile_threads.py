#!/usr/bin/env python3
"""Whether torch.profiler, started on one thread, records the ops of
another, and which thread pays the profiler's first start in a process.

The port's shim runs a duration capture on its poll thread while the
application trains on its own thread, and can warm the profiler up on the
poll thread before its first capture. This script checks both on the
torch it runs under, each case in a fresh child process (so the case's
first start is the process's first):

    flag        torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True) constructs
    cross_all   a capture at the shim's default levels (CPU, and CUDA
                where a card is present; shapes; Python frames) started
                and stopped on a side thread with profile_all_threads,
                while the main thread runs matmuls and relu for 200 ms:
                the main thread's cpu_ops, Python frames and the kernels
    cross_off   the same without profile_all_threads
    cold_main   two captures started on the main thread, no warmup
    warm_main   a start/stop on a side thread (a warmup), then a capture
                started on the main thread
    warm_side   a warmup on one side thread, then a capture started on
                another side thread

Each case prints one JSON line: its start and stop ms and what its trace
holds. Run from the repository root: python3 scripts/torch_profile_threads.py
(on the card; on a host without one it runs the CPU activity only).

With --stops (one card) it times the profiler's stop in a 200 ms window of
chip_smoke.py's dense trainer (llama-8B widths, 2 layers, bf16, B=1,
S=2048, each step synchronized), three rounds in turns:

    training     started and stopped on the training thread
    poll_busy    started and stopped on a side thread with
                 profile_all_threads, the training thread training on
    poll_paused  the same, the training thread parked at a step boundary
                 while the side thread stops
    poll_switch  as poll_busy, with the interpreter's switch interval cut
                 from 5 ms to 0.1 ms during the stop

and prints, per window, the stop's ms, the steps that overlap it against
the median step, the time the training thread was parked, and the
trace's events.

With --starts N (one card) it takes 4N captures of that trainer at the
default levels, each after two steps the host ran ahead of the card, in
four arms in turns. Three are two-step iteration captures from a step
boundary: through the port's TorchProfiler.start alone, as the shim
takes them (unprepared); start alone after torch.cuda.synchronize()
(drained); and torch.profiler's own WARMUP schedule, prepared at the
step before (torch_warmup). The fourth is a 200 ms duration window
started on a side thread with profile_all_threads while this thread
trains (poll), as the shim's poll thread opens one. It prints, for each
arm, the captures whose trace lacks a kernel record for a launch the
window made or whose flash_fwd calls are not 4 (launches lost, flash_fwd
calls, start ms; in the poll arm, launches of the window's first 100 ms
only, and any number of calls) and the start's ms.

With --shim-starts N [PROCESS ...] [--stderr-dir DIR] (one card) it
takes captures of that trainer through the port's TraceClient itself, a
window armed as the poll thread arms one while this thread trains and
calls step(), each saved and finished as the shim does it (its
PendingWrite waited on), in one process per PROCESS (iterations, duration
and mixed by default), its arms in turns: "iterations", 2N two-step iteration windows
whose profiler opens at the window's first step() (start_alone: a
TorchProfiler without a lead step) or one step() early, the lead step
trimmed by the finish (lead: the shim as it is); "duration", N 200 ms
duration windows on the poll thread, the shim's lead before each;
"iterations_py0", N windows as "lead" at Python tracer level 0
(chip_smoke.py phase 15's python_0 capture, whose steps are the
shortest); "iterations_mix", N of each of lead and lead_py0 in turns
(phase 15's default capture, then its python_0); "mixed", N of each of lead and duration; "poll", chip_smoke.py's phase 17
(b) process (the TraceClient started as an application starts one: its
poll loop, the profiler warmup not waited on, the capture ring, a long
step every 50 steps) with N duration and N iteration windows in turns
through a dynologd of its own (`dyno gputrace`), each finished in the
shim's child; "stepless", the same process never calling step(), N
duration windows; "stepless_idle", "stepless" beside chip_smoke's
IDLE_THREADS (in time.sleep(), Thread.join(), accept() and an idle
asyncio loop), which the event park counts as parked at once (it
prints the starts whose waiting threads lack one of them); "knobs",
chip_smoke.py phase 15's process in a child of its own, N rounds of its
eight knob captures through a dynologd of its own, a JSON line per
capture (knobs_child); "knobs_gc", the same with a gc.collect() on the
training thread in the middle of each window. A process whose captures opened the profiler two ways
(the duration windows with profile_all_threads, the iteration windows
thread-local under a schedule) ended up with no kernel record in any
trace (ROADMAP C17); each process stops once 12 captures in a row hold
none (the first three processes: or are lossy). Every 100 captures it
prints a progress line (captures so far, lossy ones), so that a run cut
by its time limit still counts. It prints, per arm, the lossy captures
(launch without its kernel record, in a duration window among the
launches before its profiler stop began; or, in an iteration window,
flash_fwd calls other than 4) as (launches lost, of them in the window's
first 100 ms, flash_fwd calls, profiler_start_ms, capture index), the
launches without a kernel record that kineto saved in a duration
window's lead (trimmed by the finish) with their latest offset from the
start call, the manifest's profiler_start_ms, the lead step's length
(an iteration window's lead_ms: min, median, max), the captures whose
kineto save lost any launch's record, lead included, with the offsets
of those launches from the start's return (losing_captures: capture,
lead_ms, first three offsets), and a one-sided Fisher
exact p for "start_alone loses more often than lead". A capture's lost
launches are counted by the port's rule (trace.unmatched_launches), and
held against the lost_launches its finish counted (mismatches printed).
"poll" and "stepless" print chip_smoke.poll_report's line per kind of
capture (warmup, ring, duration, iterations: lossy ones, parked share,
the parks that held them, step or event, and their park_ms: the arm to
park ms, profiler_start_ms) and the steps during the warmup, the
captures whose finish's lost_launches differs from the recount, and
every 100 captures the parked ones so far; every capture's park and
park_ms are in DIR/shim_starts_PROCESS.jsonl. Each process's
stderr (kineto's log, with KINETO_LOG_LEVEL=0 its record counts) goes to
DIR/shim_starts_PROCESS.stderr, and a poll process's captures to
DIR/shim_starts_PROCESS.jsonl.

With --warmup-first-step N [ARM ...] [--parallel K] (one card) it starts
the shim's profiler warmup (TraceClient._warmup, on a side thread as the
poll loop runs it) in N fresh processes per arm of the dense trainer,
each before the trainer's first step, K processes at a time: "shim" as
the shim starts it in an app that calls step(); "stepless" in an app
that never calls step() (ROADMAP C18, C19: held at its next Python
event); "cuda_init" as stepless, the warmup armed 20 ms into the app
thread's torch.cuda.init(), before the trainer is built (whether CUDA
was set up at the arm, and the init's ms, are printed);
"duration_first" no warmup, the process's first profiler session a 200
ms duration capture of an app that never calls step(), its manifest's
timing printed in the warmup's place. Each
process then takes steps until the warmup is over, 8 at least. Per
process it prints the warmup's timing, the steps and the
host times of those taken during the warmup, or the exit code (negative:
the signal that ended it) and the end of its stderr; then each arm's
exit codes.

With --ring N (one card) it takes N ring samples (the shim's 200 ms
duration window on a side thread, TraceClient._ring_sample, a second
apart, each waited on until its finish child is done) in one process of
that trainer, three times in fresh processes: without the shim's
profiler warmup, with it (on the side thread, as the poll loop runs
it), and with it at Python tracer level 0. Per sample it prints the
profiler's start ms; its stop ms split into the card's synchronize in
torch's profile.__exit__, the _disable_profiler call (kineto's
collection and, with Python frames on, the Python tracer's
post-processing) and the rest; kineto's save (export_ms) and the finish
child's write_ms; the steps that overlap the stop and save and
those that began while the child ran (chip_smoke.finish_steps); and the
median step.
"""

import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

WORK_S = 0.2
CASES = ("cross_all", "cross_off", "cold_main", "warm_main", "warm_side")
ARMS = ("unprepared", "drained", "torch_warmup", "poll")


def _smoke():
    """chip_smoke, imported from the repository root."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    return cs


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _profile(all_threads: bool):
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kwargs = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    return profile(activities=acts, record_shapes=True, with_stack=True,
                   **kwargs)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return round((time.perf_counter() - t0) * 1e3, 1)


def _work(a: torch.Tensor) -> int:
    n, t_end = 0, time.time() + WORK_S
    while time.time() < t_end:
        torch.relu(a @ a)
        n += 1
    if a.is_cuda:
        torch.cuda.synchronize()
    return n


def _on_thread(fn):
    out = {}
    t = threading.Thread(target=lambda: out.update(v=fn()))
    t.start()
    t.join()
    return out["v"]


def _holds(prof, tid: int) -> dict:
    path = tempfile.mktemp(suffix=".json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    mine = [e for e in events if e.get("tid") == tid]
    return {
        "main_cpu_ops": sum(e.get("cat") == "cpu_op" and e.get("name") in (
            "aten::mm", "aten::relu") for e in mine),
        "main_python_frames": sum(e.get("cat") == "python_function"
                                  for e in mine),
        "kernels": sum(e.get("cat") == "kernel" for e in events)}


def _capture_main(all_threads: bool) -> dict:
    """A capture started and stopped on this (the main) thread."""
    a = torch.randn(1024, 1024, device=_device())
    _work(a)
    prof = _profile(all_threads)
    start = _timed(prof.start)
    _work(a)
    stop = _timed(prof.stop)
    return {"start_ms": start, "stop_ms": stop}


def _warmup() -> dict:
    prof = _profile(True)
    return {"warmup_start_ms": _timed(prof.start),
            "warmup_stop_ms": _timed(prof.stop)}


def case(name: str) -> dict:
    a = torch.randn(1024, 1024, device=_device())
    _work(a)  # the device and its libraries up before any profiler
    if name in ("cross_all", "cross_off"):
        prof = _profile(name == "cross_all")
        go, done = threading.Event(), threading.Event()
        times = {}

        def poll():
            times["start_ms"] = _timed(prof.start)
            go.set()
            done.wait()
            times["stop_ms"] = _timed(prof.stop)

        t = threading.Thread(target=poll)
        t.start()
        go.wait()
        steps = _work(a)
        done.set()
        t.join()
        return {**times, "main_steps": steps,
                **_holds(prof, threading.get_native_id())}
    if name == "cold_main":
        first = _capture_main(True)
        return {"first": first, "second": _capture_main(True)}
    if name == "warm_main":
        return {**_on_thread(_warmup), "first": _capture_main(True)}
    if name == "warm_side":
        return {**_on_thread(_warmup),
                "first": _on_thread(lambda: _capture_main(True))}
    raise SystemExit(f"unknown case {name}")


def _stop_case(trainer, mode: str) -> dict:
    spans, times = [], {}

    def step():
        b = time.time() * 1e3
        trainer.step()
        torch.cuda.synchronize()
        spans.append((b, time.time() * 1e3))

    if mode == "training":
        prof = _profile(False)
        prof.start()
        t_end = time.time() + WORK_S
        while time.time() < t_end:
            step()
        times["t0"] = time.time() * 1e3
        prof.stop()
        times["t1"] = time.time() * 1e3
    else:
        prof = _profile(True)
        pause, parked, resume = (threading.Event() for _ in range(3))

        def poll():
            prof.start()
            time.sleep(WORK_S)
            if mode == "poll_paused":
                pause.set()
                parked.wait()
            interval = sys.getswitchinterval()
            if mode == "poll_switch":
                sys.setswitchinterval(1e-4)
            times["t0"] = time.time() * 1e3
            try:
                prof.stop()
            finally:
                sys.setswitchinterval(interval)
            times["t1"] = time.time() * 1e3
            resume.set()

        t = threading.Thread(target=poll)
        t.start()
        while not resume.is_set():
            step()
            if pause.is_set():
                times["park"] = time.time() * 1e3
                parked.set()
                resume.wait()
                times["parked_ms"] = round(time.time() * 1e3 - times["park"], 1)
        t.join()
    for _ in range(3):
        step()
    t0, t1 = times["t0"], times["t1"]
    path = tempfile.mktemp(suffix=".json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = len(json.load(f)["traceEvents"])
    os.unlink(path)
    steps = sorted(e - b for b, e in spans)
    return {"stop_ms": round(t1 - t0, 1),
            "overlapping_ms": [round(e - b, 1) for b, e in spans
                               if b < t1 and e > t0],
            "median_step_ms": round(steps[len(steps) // 2], 1),
            "parked_ms": times.get("parked_ms"), "events": events}


def _launches_without_kernel(path: str, since: float = 0.0
                             ) -> tuple[int, int, int]:
    """The kernel launches in a Chrome trace that have no device record,
    the trace's flash_fwd kernels and all its kernels. With `since` (a
    duration window's epoch start, s), only launches in the window's
    first 100 ms count: a launch near its end may run after the stop."""
    from dynolog_tpu_torch.trace import unmatched_launches

    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    lost = [t for t in unmatched_launches(events, doc["baseTimeNanoseconds"])
            if not since or t < since + 0.1]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(lost), sum("flash_fwd_kernel" in e.get("name", "")
                          for e in kernels), len(kernels)


def _poll_window(prof, trainer) -> tuple[float, float]:
    """A 200 ms duration capture on a side thread (all threads) while this
    thread trains; returns the window's start and its start's ms."""
    times, done = {}, threading.Event()

    def poll():
        tmp = tempfile.gettempdir()
        times["t0"] = time.time()
        times["start_ms"] = _timed(lambda: prof.start(tmp, all_threads=True))
        time.sleep(WORK_S)
        prof.stop()
        done.set()

    t = threading.Thread(target=poll)
    t.start()
    while not done.is_set():
        trainer.step()
    t.join()
    return times["t0"], times["start_ms"]


def starts(n: int) -> int:
    cs = _smoke()
    from torch.profiler import ProfilerAction

    from dynolog_tpu_torch.client.shim import (
        DEFAULT_TRACER_LEVELS, TorchProfiler, profile_options)
    from dynolog_tpu_torch.ops import _build

    _build.build_all()
    trainer = cs.Trainer(cs.dense_config())
    shim = TorchProfiler()
    tmp = tempfile.mkdtemp()
    opts = profile_options(DEFAULT_TRACER_LEVELS, True)
    arms = {arm: [] for arm in ARMS}
    for i in range(len(arms) * n):
        arm = ARMS[i % len(ARMS)]
        for _ in range(2):
            trainer.step()
        since = 0.0
        if arm == "poll":
            since, start = _poll_window(shim, trainer)
        else:
            prof = shim
            if arm == "torch_warmup":
                prof = profile(schedule=lambda s: (
                    ProfilerAction.WARMUP if s == 0
                    else ProfilerAction.RECORD), **opts)
                prof.start()  # prepared: CUPTI on, nothing recorded yet
            trainer.step()
            if arm == "drained":
                torch.cuda.synchronize()
            start = _timed(prof.step if arm == "torch_warmup"
                           else lambda: shim.start(tmp))
            for _ in range(2):
                trainer.step()
                prof.step()
            prof.stop()
        if arm != "torch_warmup":
            path = shim.export(tmp)
        else:
            path = os.path.join(tmp, "w.json")
            prof.export_chrome_trace(path)
        lost, fwd, _ = _launches_without_kernel(path, since)
        os.unlink(path)
        arms[arm].append((lost, fwd, start))
    for arm, rows in arms.items():
        starts_ms = sorted(r[2] for r in rows)
        print(json.dumps({
            "case": "starts", "arm": arm, "captures": len(rows),
            "lossy": [r for r in rows
                      if r[0] or (arm != "poll" and r[1] != 4)],
            "start_ms_median": starts_ms[len(starts_ms) // 2],
            "starts_of_20_ms_or_more": sum(x >= 20 for x in starts_ms),
            "start_ms_max": starts_ms[-1]}), flush=True)
    return 0


def _fisher_greater(a: int, n_a: int, b: int, n_b: int) -> float:
    """One-sided Fisher exact p that arm a's loss rate exceeds arm b's,
    given a of n_a and b of n_b captures lossy."""
    k, n = a + b, n_a + n_b
    total = math.comb(n, k)
    return sum(math.comb(n_a, i) * math.comb(n_b, k - i)
               for i in range(a, min(k, n_a) + 1)) / total


# The processes of --shim-starts and the arms each takes captures of in
# turns. "mixed" mixes duration windows (the poll thread's) with
# iteration windows (the training thread's): before every capture opened
# its profiler with one configuration, such a process lost every kernel
# record of every capture after 29-200 captures (ROADMAP C17). "poll"
# and "stepless" are chip_smoke.py's phase 17 (b) process (run_poll),
# captured through dynologd: the real client with its warmup and ring,
# and an app that never calls step().
SHIM_PROCESSES = {"iterations": ("start_alone", "lead"),
                  "iterations_py0": ("lead_py0",),
                  "iterations_mix": ("lead", "lead_py0"),
                  "duration": ("duration",),
                  "mixed": ("lead", "duration"),
                  "poll": (), "stepless": (), "stepless_idle": (),
                  "knobs": (), "knobs_gc": ()}


def poll_process(n: int, stepless: bool, stderr_dir: str | None,
                 idle: bool = False) -> int:
    """chip_smoke.run_poll for n captures of each kind (n duration windows
    where `stepless`; beside chip_smoke.IDLE_THREADS where `idle`)
    against a dynologd of its own: a progress line every 100 captures,
    then poll_report's lines (with `idle`, the starts whose waiting
    threads lack an idle one) and, with `stderr_dir`, every capture's
    facts in DIR/shim_starts_NAME.jsonl, every ring sample's timing
    (with the ms it was seen at) in DIR/shim_starts_NAME.ring.jsonl."""
    cs = _smoke()
    from dynolog_tpu_torch.ops import _build

    name = ("stepless_idle" if idle else "stepless") if stepless else "poll"
    _build.build_all()
    cs.DaemonBuild().run()
    daemon = cs.Daemon()

    def progress(i: int, captures: list) -> None:
        if (i + 1) % 100 == 0:
            print(json.dumps({"case": "shim_starts", "process": name,
                              "progress": i + 1,
                              "lossy": sum(cs.lossy(c, evals=True)
                                           for c in captures),
                              "parked": sum(c["timing"]["parked"] is True
                                            for c in captures)}),
                  flush=True)

    try:
        got = cs.run_poll(
            daemon, n, stepless, progress,
            stderr_dir and os.path.join(stderr_dir,
                                        f"shim_starts_{name}.stderr"), idle)
    finally:
        daemon.stop()
    if stderr_dir:
        for suffix, rows in (("jsonl", got["captures"]),
                             ("ring.jsonl", got["ring"])):
            with open(os.path.join(stderr_dir,
                                   f"shim_starts_{name}.{suffix}"), "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
    lines, failures = cs.poll_report(got)
    for line in lines:
        print(json.dumps({"case": "shim_starts", "process": name,
                          "report": line}), flush=True)
    print(json.dumps({
        "case": "shim_starts", "process": name,
        "captures": len(got["captures"]), "lossy": len(failures),
        "warmup_timing": got["warmup_timing"],
        "during_warmup": got["during_warmup"],
        "median_step_ms": got["median_step_ms"],
        "ring_samples": len(got["ring"]), "steps": got["steps"],
        "recount_mismatches": cs.recount_mismatches(got["captures"]),
        "idle_unwaited": cs.idle_unwaited(got) if idle else None,
        "last_error": got["last_error"]}), flush=True)
    return 0


def _step_records(path: str) -> list:
    """Per ProfilerStep#N span of a finished trace, in order (the last
    one runs from the window's last step() to the stop): the kernel
    launches made inside it (as trace.unmatched_launches counts them) and
    those of them with a device record, joined by correlation."""
    from dynolog_tpu_torch import trace

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") in trace.DEVICE_CATS}
    launches = [(float(e["ts"]), (e.get("args") or {}).get("correlation"))
                for e in events if e.get("cat") in trace.LAUNCH_CATS
                and "Launch" in e.get("name", "")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(trace.STEP_PREFIX))
    out = []
    for t0, t1 in spans:
        mine = [c for t, c in launches if t0 <= t < t1]
        out.append([len(mine), sum(c in device for c in mine)])
    return out


def _loss_side(steps: list) -> str | None:
    """Where a capture's poorest step (fewest device records) lost them:
    "device" where it made about as many launches as the richest step
    (its kernel records alone are missing), "host" where its launches
    are missing too; None without a step."""
    if not steps:
        return None
    launches, records = min(steps, key=lambda s: s[1])
    return ("device" if launches >= 0.9 * max(s[0] for s in steps)
            else "host")


def knobs_child(n: int, gc_mid: bool) -> int:
    """chip_smoke.py phase 15's process (`--shim-starts N knobs`): its
    dense trainer under one TraceClient (its poll loop, one TorchProfiler
    reconfigured by each capture) against a dynologd of its own, taken
    through n rounds of every entry of chip_smoke.KNOB_CAPTURES in order
    through `dyno gputrace`, each capture as the phase takes it
    (chip_smoke.knob_capture: no synchronize per step while it waits for
    the manifest; knob_trace, knob_check). With `gc_mid` (knobs_gc) the
    training thread runs gc.collect() once in the middle of each window.
    Prints a line per capture: its knob, steps, flash records, launches
    and device records per step, lost_launches, lead_ms, the saved
    sessions still alive in the middle of its window (and, with
    `gc_mid`, those the collection freed there); for a lossy capture
    (knob_check's failures, or lost launches where the device tracer
    ran: at device level 0 the finish counts every launch as lost)
    chip_smoke.lost_offsets and the side of the loss (_loss_side), and
    each line's seconds since the first capture. Then the lossy count
    per knob. A round's traces are deleted once the next round is
    over."""
    import gc
    import weakref

    cs = _smoke()
    from dynolog_tpu_torch import trace
    from dynolog_tpu_torch.client import TraceClient
    from dynolog_tpu_torch.ops import _build

    name = "knobs_gc" if gc_mid else "knobs"
    _build.build_all()
    build = cs.DaemonBuild()
    build.run()
    if build.error:
        raise RuntimeError(f"daemon build failed: {build.error}")
    daemon = cs.Daemon()
    trainer = cs.Trainer(cs.dense_config())
    job_id = 5600 + os.getpid() % 1000
    tmp = tempfile.mkdtemp(prefix="dynotpu_knobs_")
    client = TraceClient(job_id=job_id, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=1.0)
    sessions, mids = [], []  # weakrefs to saved sessions; per window
    save = client.profiler.export

    def export(trace_dir, **kw):
        if client.profiler._stopped is not None:
            sessions.append(weakref.ref(client.profiler._stopped))
        return save(trace_dir, **kw)

    def mid_window():
        sessions[:] = [r for r in sessions if r() is not None]
        alive = len(sessions)
        if gc_mid:
            gc.collect()
        mids.append((alive, alive - sum(r() is not None for r in sessions)))

    client.profiler.export = export
    lossy = {knob: [] for knob in cs.KNOB_CAPTURES}
    old, files = [], []
    try:
        if not client.start():
            raise RuntimeError("the knobs process's shim could not register")
        for _ in range(cs.STEPS):
            trainer.step()
            client.step()
            torch.cuda.synchronize()
        t_start = time.time()
        for rnd in range(n):
            for path in old:
                for f in (path, path.replace(trace.TRACE_SUFFIX,
                                             trace.SUMMARY_SUFFIX)):
                    if os.path.exists(f):
                        os.unlink(f)
            old, files = files, []
            for knob, flags in cs.KNOB_CAPTURES.items():
                log_file = os.path.join(tmp, f"{knob}_{rnd}.json")
                mids.clear()
                manifest, _ = cs.knob_capture(daemon, client, trainer, job_id,
                                              log_file, flags, mid_window)
                files.append(str(cs.manifest_path(log_file)))
                levels = cs.knob_levels(flags)
                cats, summary = cs.knob_trace(manifest)
                timing = manifest.get("timing") or {}
                if max(levels.values()) < 1:
                    found = [] if manifest["status"] == "error" and all(
                        f"{k}=0" in manifest.get("error", "") for k in (
                            "PROFILE_PYTHON_TRACER_LEVEL",
                            "PROFILE_HOST_TRACER_LEVEL",
                            "PROFILE_DEVICE_TRACER_LEVEL")) else [
                                f"{knob}: manifest {manifest}"]
                else:
                    found = cs.knob_check(knob, levels,
                                          "--notrace_json" not in flags,
                                          manifest, summary, cats)
                row = {"case": "shim_starts", "process": name, "round": rnd,
                       "knob": knob, "status": manifest["status"],
                       "steps": summary.get("steps", {}).get("count"),
                       "flash": {k: r and r["count"] for k, r in
                                 cs.flash_rows(summary).items()},
                       "lost_launches": timing.get("lost_launches"),
                       "lead_ms": timing.get("lead_ms"),
                       "alive_mid_window": mids[0][0] if mids else None,
                       "freed_mid_window": (mids[0][1] if mids and gc_mid
                                            else None),
                       "t_s": round(time.time() - t_start, 1)}
                if manifest["status"] == "ok":
                    files.append(manifest["trace_file"])
                    row["per_step"] = _step_records(manifest["trace_file"])
                if found or (timing.get("lost_launches")
                             and levels["device_tracer_level"] >= 1):
                    row["failures"] = found
                    if manifest["status"] == "ok":
                        row["lost_offsets"] = cs.lost_offsets(manifest)
                        row["loss"] = _loss_side(
                            row["per_step"][:cs.ITERATIONS])
                    lossy[knob].append(rnd)
                print(json.dumps(row), flush=True)
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
        daemon.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"case": "shim_starts", "process": name, "rounds": n,
                      "lossy_by_knob": {k: len(v) for k, v in lossy.items()},
                      "lossy_rounds": lossy}), flush=True)
    return 0


def shim_starts(n: int, names: list, stderr_dir: str | None) -> int:
    rc = 0
    for name in names or ("iterations", "duration", "mixed"):
        if name in ("poll", "stepless", "stepless_idle"):
            rc |= poll_process(n, name != "poll", stderr_dir,
                               name == "stepless_idle")
            continue
        if name in ("knobs", "knobs_gc"):
            # Its lines stream to this process's stdout as they come.
            err = (open(os.path.join(stderr_dir, f"shim_starts_{name}.stderr"),
                        "w") if stderr_dir else None)
            try:
                out = subprocess.run(
                    [sys.executable, __file__, "--knobs-child", str(n),
                     "1" if name == "knobs_gc" else "0"], stderr=err)
            finally:
                if err:
                    err.close()
            if out.returncode != 0:
                rc = 1
                print(f"shim-starts process {name} exited "
                      f"{out.returncode}", flush=True)
            continue
        out = subprocess.run(
            [sys.executable, __file__, "--shim-starts-child", str(n),
             ",".join(SHIM_PROCESSES[name])], capture_output=True,
            text=True, timeout=3000)
        print(out.stdout, end="", flush=True)
        if stderr_dir:
            with open(os.path.join(stderr_dir,
                                   f"shim_starts_{name}.stderr"), "w") as f:
                f.write(out.stderr)
        if out.returncode != 0:
            rc = 1
            print(f"shim-starts process {name} exited {out.returncode}: "
                  f"{out.stderr[-3000:]}", flush=True)
    return rc


def _window_losses(path: str, raw: str, arm: str, window, t_call: float,
                   stop_ns: int) -> tuple[int, int, int, int, list]:
    """What one capture of --shim-starts lost: the launches without a
    device record in its finished trace made before its profiler stop
    began at `stop_ns` (trace.unmatched_launches, the rule the shim's
    finish counts lost_launches by), those of them in the window's first
    100 ms, its flash_fwd kernels and all its kernels, the offsets (ms
    from the start call) of the launches without a device record that
    kineto saved before a duration window opened (in its lead, trimmed by
    the finish), and the offsets (ms from the start's return) of every
    launch without a device record that kineto saved before the stop."""
    from dynolog_tpu_torch.trace import unmatched_launches

    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    lost = unmatched_launches(events, doc["baseTimeNanoseconds"], stop_ns)
    opened = window.started_ms / 1e3
    kernels = [e for e in events if e.get("cat") == "kernel"]
    with open(raw) as f:
        doc = json.load(f)
    saved = unmatched_launches(doc["traceEvents"], doc["baseTimeNanoseconds"],
                               stop_ns)
    in_lead = [round((t - t_call) * 1e3, 1) for t in saved
               if t < opened] if arm == "duration" else []
    returned = opened + window.timing["profiler_start_ms"] / 1e3
    return (len(lost), sum(t < opened + 0.1 for t in lost),
            sum("flash_fwd_kernel" in e.get("name", "") for e in kernels),
            len(kernels), in_lead,
            [round((t - returned) * 1e3, 1) for t in saved])


def shim_starts_child(n: int, arms: tuple) -> int:
    cs = _smoke()

    from dynolog_tpu_torch.client.shim import (
        TorchProfiler, TraceClient, TraceConfig)
    from dynolog_tpu_torch.ops import _build

    tmp = tempfile.mkdtemp()
    raw = os.path.join(tmp, "kineto.json")

    class KeepRaw(TorchProfiler):
        """Keeps a copy of kineto's save, before the finish trims it."""

        def export(self, trace_dir, pipelined=False, profile_top=None):
            save = self._stopped.export_chrome_trace

            def kept(path):
                save(path)
                shutil.copy(path, raw)

            self._stopped.export_chrome_trace = kept
            return super().export(trace_dir, pipelined, profile_top)

    class NoLead(KeepRaw):
        lead_step = False

    def py0(prof):
        prof.configure({"PROFILE_PYTHON_TRACER_LEVEL": "0"})
        return prof

    _build.build_all()
    trainer = cs.Trainer(cs.dense_config())
    clients = {
        "start_alone": TraceClient(job_id=1, endpoint="unused",
                                   profiler=NoLead()),
        "lead": TraceClient(job_id=1, endpoint="unused", profiler=KeepRaw()),
        "lead_py0": TraceClient(job_id=1, endpoint="unused",
                                profiler=py0(KeepRaw())),
        "duration": TraceClient(job_id=1, endpoint="unused",
                                profiler=KeepRaw())}
    rows = {arm: [] for arm in arms}
    mismatches = []  # (capture, this count, the finish's lost_launches)
    blank = lossy_run = 0  # consecutive captures blank, and lossy
    for i in range(len(arms) * n):
        arm = arms[i % len(arms)]
        client = clients[arm]
        for _ in range(2):
            trainer.step()
            client.step()
        cfg = (TraceConfig(duration_ms=int(WORK_S * 1000))
               if arm == "duration" else TraceConfig(iterations=2))
        out = {}
        t_call = time.time()
        poll = threading.Thread(target=lambda: out.update(
            r=client._capture_window(cfg, tmp)))
        poll.start()
        while poll.is_alive():
            trainer.step()
            client.step()
        poll.join()
        error, window = out["r"]
        if error:
            raise RuntimeError(f"{arm} capture {i}: {error}")
        path, pending = client._export(tmp)
        done = (pending.wait() if pending is not None
                else client.profiler.last_finish)
        if "write_error" in done:
            raise RuntimeError(f"{arm} capture {i}: {done}")
        lost, first, fwd, kernels, in_lead, saved = _window_losses(
            path, raw, arm, window, t_call, client.profiler._stop_ns)
        if lost != done["lost_launches"]:
            mismatches.append((i, lost, done["lost_launches"]))
        os.unlink(path)
        rows[arm].append((lost, first, fwd,
                          window.timing["profiler_start_ms"], i, in_lead,
                          window.timing.get("lead_ms"), saved))
        blank = blank + 1 if not kernels else 0
        lossy_run = lossy_run + 1 if lost or (
            arm != "duration" and fwd != 4) else 0
        if (i + 1) % 100 == 0:
            print(json.dumps({"case": "shim_starts", "progress": i + 1,
                              "lossy": {a: sum(bool(r[0]) or (
                                  a != "duration" and r[2] != 4)
                                  for r in got) for a, got in rows.items()}}),
                  flush=True)
        if 12 in (blank, lossy_run):
            print(json.dumps({"case": "shim_starts", "error": "12 captures "
                              "in a row hold " + (
                                  "no kernel record" if blank == 12 else
                                  "launches without their kernel record")
                              + f", from capture {i - 11} on"}), flush=True)
            break
    lossy = {}
    for arm, got in rows.items():
        starts_ms = sorted(r[3] for r in got)
        lossy[arm] = [r[:5] for r in got
                      if r[0] or (arm != "duration" and r[2] != 4)]
        leads = [r[5] for r in got if r[5]]
        lead_ms = sorted(r[6] for r in got if r[6] is not None)
        saved = [x for r in got for x in r[7]]
        print(json.dumps({
            "case": "shim_starts", "arm": arm, "captures": len(got),
            "lossy": lossy[arm],
            "lossy_in_first_100_ms": sum(bool(r[1]) for r in lossy[arm]),
            "lead_losses": [(r[4], len(r[5]), max(r[5]), r[3])
                            for r in got if r[5]],
            "latest_lead_loss_ms": max((x for lead in leads for x in lead),
                                       default=None),
            "start_ms_median": starts_ms[len(starts_ms) // 2],
            "starts_of_20_ms_or_more": sum(x >= 20 for x in starts_ms),
            "start_ms_max": starts_ms[-1],
            "lead_ms": lead_ms and [lead_ms[0], lead_ms[len(lead_ms) // 2],
                                    lead_ms[-1]],
            "captures_losing_any_launch": sum(bool(r[7]) for r in got),
            "lost_after_start_return_ms": saved and [min(saved), max(saved)],
            "losing_captures": [(r[4], r[6], r[7][:3]) for r in got
                                if r[7]][:40]}),
            flush=True)
    print(json.dumps({"case": "shim_starts",
                      "lost_launches_mismatches": mismatches}), flush=True)
    if {"start_alone", "lead"} <= set(lossy):
        print(json.dumps({
            "case": "shim_starts", "fisher_p_start_alone_loses_more":
            _fisher_greater(len(lossy["start_alone"]), n,
                            len(lossy["lead"]), n)}))
    return 0


def _split_stops(prof, splits: list) -> None:
    """Wraps the TorchProfiler's stop to split each stop (ms) into the
    card's synchronize in torch's profile.__exit__, the _disable_profiler
    call (kineto's collection and the Python tracer's post-processing;
    torch's own _stats) and the rest."""
    stop = prof.stop

    def split() -> None:
        p, syncs, sync = prof._prof, [], torch.cuda.synchronize
        me = threading.get_ident()

        def timed_sync(*a, **kw):
            t = time.perf_counter()
            sync(*a, **kw)
            if threading.get_ident() == me:
                syncs.append(time.perf_counter() - t)

        torch.cuda.synchronize = timed_sync
        t0 = time.perf_counter()
        try:
            stop()
        finally:
            torch.cuda.synchronize = sync
        total = (time.perf_counter() - t0) * 1e3
        disable = p.profiler._stats.profiler_disable_call_duration_us / 1e3
        splits.append({"stop_ms": round(total, 1),
                       "sync_ms": round(sum(syncs) * 1e3, 1),
                       "disable_ms": round(disable, 1),
                       "rest_ms": round(total - sum(syncs) * 1e3 - disable,
                                        1)})

    prof.stop = split


def ring_child(n: int, warmup: bool, python: bool) -> int:
    cs = _smoke()

    from dynolog_tpu_torch.client.shim import RingConfig, TraceClient
    from dynolog_tpu_torch.ops import _build

    _build.build_all()
    trainer = cs.Trainer(cs.dense_config())
    tmp = tempfile.mkdtemp()
    client = TraceClient(job_id=1, endpoint="unused", warmup_profiler=warmup,
                         ring=RingConfig(every_n_steps=10**9, window_ms=200,
                                         dir=tmp))
    if not python:
        client.profiler.configure({"PROFILE_PYTHON_TRACER_LEVEL": "0"})
    spans, samples, splits, done = [], [], [], threading.Event()

    def poll():
        try:
            if warmup:
                client._warmup()
            _split_stops(client.profiler, splits)
            for i in range(n):
                time.sleep(1.0)
                t0 = time.time() * 1e3
                trace_dir = os.path.join(tmp, str(i))
                os.makedirs(trace_dir)
                pending, timing = client._ring_sample(trace_dir)
                timing.update(pending.wait())
                samples.append((t0, timing))
        finally:
            done.set()

    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    side = threading.Thread(target=poll)
    side.start()
    while not done.is_set():
        b = time.time() * 1e3
        trainer.step()
        client.step()
        torch.cuda.synchronize()
        spans.append((b, time.time() * 1e3))
    side.join()
    if len(samples) < n:
        raise RuntimeError(f"{len(samples)} of {n} ring samples")
    median = sorted(e - b for b, e in spans)[len(spans) // 2]
    print(json.dumps({"case": "ring", "warmup_profiler": warmup,
                      "python_tracer": python, "warmup": client.warmup_timing,
                      "last_error": client.last_error,
                      "median_step_ms": round(median, 1)}), flush=True)
    for i, ((t0, timing), split) in enumerate(zip(samples, splits)):
        print(json.dumps({
            "case": "ring", "warmup_profiler": warmup,
            "python_tracer": python, "sample": i,
            "start_ms": timing.get("profiler_start_ms"), **split,
            **cs.finish_steps(spans, t0, timing),
            "write_bytes": timing.get("write_bytes")}), flush=True)
    return 0


# The arms of --warmup-first-step (ROADMAP C18): the warmup as the shim
# runs it in an app that calls step() ("shim") and in one that never does
# ("stepless", ROADMAP C19); as "stepless", with CUDA set up only after
# the warmup began, which arms CUDA_INIT_LEAD_S into the app thread's
# torch.cuda.init() ("cuda_init"); and, with no warmup, a first profiler
# session that is a 200 ms duration capture of an app that never calls
# step() ("duration_first").
WARMUP_ARMS = ("shim", "stepless", "cuda_init", "duration_first")
CUDA_INIT_LEAD_S = 0.02


def warmup_first_step_child(arm: str) -> int:
    cs = _smoke()
    from dynolog_tpu_torch.client.shim import TraceClient, TraceConfig

    client = TraceClient(job_id=1, endpoint="unused", report_interval_s=0)
    target, armed = client._warmup, {}
    if arm == "duration_first":
        tmp = tempfile.mkdtemp(prefix="dynotpu_first_")
        target = functools.partial(client._run_trace, TraceConfig.parse(
            f"ACTIVITIES_LOG_FILE={tmp}/first.json\n"
            "ACTIVITIES_DURATION_MSECS=200\nTRACE_JSON=0"))
    if arm == "cuda_init":
        def late_warmup():
            time.sleep(CUDA_INIT_LEAD_S)
            armed["cuda_ready_at_arm"] = torch.cuda.is_initialized()
            client._warmup()

        warmup = threading.Thread(target=late_warmup)
        warmup.start()
        t0 = time.time()
        torch.cuda.init()
        armed["cuda_init_ms"] = round((time.time() - t0) * 1e3, 1)
        trainer = cs.Trainer(cs.dense_config())
    else:
        trainer = cs.Trainer(cs.dense_config())
        warmup = threading.Thread(target=target)
        warmup.start()
    spans = []
    while warmup.is_alive() or len(spans) < 8:
        b = time.time() * 1e3
        trainer.step()
        if arm == "shim":
            client.step()
        spans.append((b, time.time() * 1e3, warmup.is_alive()))
    warmup.join()
    torch.cuda.synchronize()
    if arm == "duration_first":
        client.warmup_timing = (client.last_manifest or {}).get("timing")
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"case": "warmup_first_step", "arm": arm,
                      "warmup_timing": client.warmup_timing, **armed,
                      "steps": len(spans),
                      "steps_during_warmup_ms": [
                          round(e - b, 1) for b, e, alive in spans if alive],
                      "last_error": client.last_error}), flush=True)
    return 0


def warmup_first_step(n: int, arms: list, parallel: int) -> int:
    """n fresh processes per arm, `parallel` at a time on the one card, the
    arms in turns; one JSON line per process: its warmup's timing and
    steps, or its exit code (negative: the signal that ended it) and the
    end of its stderr."""
    from concurrent.futures import ThreadPoolExecutor

    _smoke()  # the repository on sys.path
    from dynolog_tpu_torch.ops import _build

    _build.build_all()  # once, before the children load the libraries

    def one(job):
        i, arm = job
        out = subprocess.run(
            [sys.executable, "-X", "faulthandler", __file__,
             "--warmup-first-step-child", arm],
            capture_output=True, text=True, timeout=600)
        lines = out.stdout.strip().splitlines()
        print(json.dumps({"run": i, "rc": out.returncode,
                          **json.loads(lines[-1])})
              if out.returncode == 0 and lines else json.dumps(
                {"case": "warmup_first_step", "arm": arm, "run": i,
                 "rc": out.returncode, "stderr": out.stderr[-1500:]}),
              flush=True)
        return arm, out.returncode

    jobs = [(i, arm) for i in range(n) for arm in arms or WARMUP_ARMS]
    with ThreadPoolExecutor(max_workers=parallel) as pool:
        done = list(pool.map(one, jobs))
    print(json.dumps({"case": "warmup_first_step", "exits": {
        arm: sorted(rc for a, rc in done if a == arm)
        for arm in arms or WARMUP_ARMS}}), flush=True)
    return 0


def ring(n: int) -> int:
    rc = 0
    for warmup, python in ((False, True), (True, True), (True, False)):
        out = subprocess.run(
            [sys.executable, __file__, "--ring-child", str(n),
             str(int(warmup)), str(int(python))],
            capture_output=True, text=True, timeout=600)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            rc = 1
            print(f"ring child (warmup {warmup}, python {python}) exited "
                  f"{out.returncode}: {out.stderr[-3000:]}", flush=True)
    return rc


def stops() -> int:
    cs = _smoke()
    from dynolog_tpu_torch.ops import _build

    _build.build_all()
    trainer = cs.Trainer(cs.dense_config())
    for _ in range(3):
        trainer.step()
    prof = _profile(True)  # the process's first start, out of the way
    prof.start()
    prof.stop()
    for rnd in range(3):
        for mode in ("training", "poll_busy", "poll_paused", "poll_switch"):
            print(json.dumps({"case": f"stop_{mode}", "round": rnd,
                              **_stop_case(trainer, mode)}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--stops"]:
        return stops()
    if sys.argv[1:2] == ["--starts"]:
        return starts(int(sys.argv[2]))
    if sys.argv[1:2] == ["--shim-starts"]:
        names, stderr_dir = sys.argv[3:], None
        if "--stderr-dir" in names:
            k = names.index("--stderr-dir")
            stderr_dir = names[k + 1]
            names = names[:k] + names[k + 2:]
        return shim_starts(int(sys.argv[2]), names, stderr_dir)
    if sys.argv[1:2] == ["--knobs-child"]:
        return knobs_child(int(sys.argv[2]), sys.argv[3] == "1")
    if sys.argv[1:2] == ["--shim-starts-child"]:
        return shim_starts_child(int(sys.argv[2]),
                                 tuple(sys.argv[3].split(",")))
    if sys.argv[1:2] == ["--warmup-first-step"]:
        arms, parallel = sys.argv[3:], 1
        if "--parallel" in arms:
            k = arms.index("--parallel")
            parallel = int(arms[k + 1])
            arms = arms[:k] + arms[k + 2:]
        return warmup_first_step(int(sys.argv[2]), arms, parallel)
    if sys.argv[1:2] == ["--warmup-first-step-child"]:
        return warmup_first_step_child(sys.argv[2])
    if sys.argv[1:2] == ["--ring"]:
        return ring(int(sys.argv[2]))
    if sys.argv[1:2] == ["--ring-child"]:
        return ring_child(int(sys.argv[2]), sys.argv[3] == "1",
                          sys.argv[4] == "1")
    if sys.argv[1:2] == ["--case"]:
        print(json.dumps(case(sys.argv[2])))
        return 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0) if torch.cuda.is_available() else 'cpu'}")
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip().splitlines()[0])
    try:
        from torch._C._profiler import _ExperimentalConfig
        _ExperimentalConfig(profile_all_threads=True)
        print(json.dumps({"case": "flag", "ok": True}))
    except Exception as e:  # noqa: BLE001 - the answer is the output
        print(json.dumps({"case": "flag", "ok": False,
                          "error": f"{type(e).__name__}: {e}"}))
    rc = 0
    for name in CASES:
        out = subprocess.run([sys.executable, __file__, "--case", name],
                             capture_output=True, text=True, timeout=300)
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            rc = 1
            print(json.dumps({"case": name, "rc": out.returncode,
                              "stderr": out.stderr[-1500:]}))
            continue
        print(json.dumps({"case": name, **json.loads(lines[-1])}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
