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

With --shim-starts N (one card) it takes captures of that trainer
through the port's TraceClient itself, a window armed as the poll thread
arms one while this thread trains and calls step(): in one process 2N
two-step iteration windows in two arms in turns, the profiler opened at
the window's first step() (start_alone: a TorchProfiler without a lead
step) or one step() early, the lead step trimmed by the finish (lead:
the shim as it is); in a second process N 200 ms duration windows on the
poll thread (duration). A process that mixes the two kinds ends up with
no kernel record in any trace (ROADMAP C17); each process stops once 12
captures in a row hold none. Each trace is saved and finished as the
shim does it (its PendingWrite waited on). It prints, per arm, the lossy
captures as --starts does (a launch without its kernel record, in a
duration window among the launches of its first 100 ms only; or, in an
iteration window, flash_fwd calls other than 4), each with its index,
and the manifest's profiler_start_ms, and a one-sided Fisher exact p for
"start_alone loses more often than lead".

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

import json
import math
import os
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
    with open(path) as f:
        doc = json.load(f)
    events, base_us = doc["traceEvents"], doc["baseTimeNanoseconds"] / 1e3
    device = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    lost = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "Launch" in e.get("name", "")
               and (e.get("args") or {}).get("correlation") not in device
               and (not since or e["ts"] + base_us < since * 1e6 + 1e5)
               for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return lost, sum("flash_fwd_kernel" in e.get("name", "")
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
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
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


# The arms of --shim-starts, each tuple in a process of its own: a process
# that mixes poll-thread (profile_all_threads) windows with training-thread
# ones ends up with no kernel record in any trace (ROADMAP C17).
SHIM_PROCESSES = (("start_alone", "lead"), ("duration",))


def shim_starts(n: int) -> int:
    rc = 0
    for arms in SHIM_PROCESSES:
        out = subprocess.run(
            [sys.executable, __file__, "--shim-starts-child", str(n),
             ",".join(arms)], capture_output=True, text=True, timeout=3000)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            rc = 1
            print(f"shim-starts child {arms} exited {out.returncode}: "
                  f"{out.stderr[-3000:]}", flush=True)
    return rc


def shim_starts_child(n: int, arms: tuple) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from dynolog_tpu_torch.client.shim import (
        TorchProfiler, TraceClient, TraceConfig)
    from dynolog_tpu_torch.ops import _build

    class NoLead(TorchProfiler):
        lead_step = False

    _build.build_all()
    trainer = cs.Trainer(cs.dense_config())
    tmp = tempfile.mkdtemp()
    clients = {
        "start_alone": TraceClient(job_id=1, endpoint="unused",
                                   profiler=NoLead()),
        "lead": TraceClient(job_id=1, endpoint="unused"),
        "duration": TraceClient(job_id=1, endpoint="unused")}
    rows = {arm: [] for arm in arms}
    blank = 0  # consecutive captures with no kernel record at all
    for i in range(len(arms) * n):
        arm = arms[i % len(arms)]
        client = clients[arm]
        for _ in range(2):
            trainer.step()
            client.step()
        cfg = (TraceConfig(duration_ms=int(WORK_S * 1000))
               if arm == "duration" else TraceConfig(iterations=2))
        out = {}
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
        if pending is not None and "write_error" in (done := pending.wait()):
            raise RuntimeError(f"{arm} capture {i}: {done}")
        lost, fwd, kernels = _launches_without_kernel(
            path, window.started_ms / 1e3 if arm == "duration" else 0.0)
        os.unlink(path)
        rows[arm].append((lost, fwd, window.timing["profiler_start_ms"], i))
        blank = blank + 1 if not kernels else 0
        if blank == 12:
            print(json.dumps({"case": "shim_starts", "error": "12 captures "
                              f"in a row hold no kernel record, from capture "
                              f"{i - 11} on"}), flush=True)
            break
    lossy = {}
    for arm, got in rows.items():
        starts_ms = sorted(r[2] for r in got)
        lossy[arm] = [r for r in got
                      if r[0] or (arm != "duration" and r[1] != 4)]
        print(json.dumps({
            "case": "shim_starts", "arm": arm, "captures": len(got),
            "lossy": lossy[arm],
            "start_ms_median": starts_ms[len(starts_ms) // 2],
            "starts_of_20_ms_or_more": sum(x >= 20 for x in starts_ms),
            "start_ms_max": starts_ms[-1]}), flush=True)
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
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

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
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
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
        return shim_starts(int(sys.argv[2]))
    if sys.argv[1:2] == ["--shim-starts-child"]:
        return shim_starts_child(int(sys.argv[2]),
                                 tuple(sys.argv[3].split(",")))
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
