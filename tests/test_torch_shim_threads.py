"""Which thread opens each of the port shim's captures, with which profiler
configuration, and the lead a duration window records before its window
(dynolog_tpu_torch.client.shim, ROADMAP C15, C17 and C19).

Every capture a process takes — the warmup, duration windows, ring
samples, iteration windows — starts torch.profiler with
profile_all_threads and no schedule, and opens and closes on the poll
thread, as the JAX client's do: a process whose iteration windows the
training thread opened lost every kernel record on the card once
duration windows came between them. An iteration window opens one step
early, while the training thread is parked at that step(), and closes
while it is parked at the window's last step(). A duration window's and
the warmup's profiler start once the training thread has parked at its
next step(), or, in an app that has not stepped (or whose next step()
did not come in time), once every app thread is held at its next Python
event (the event park, a sys.monitoring hook on for the park only, C19),
and a start that goes ahead without a park says so in its timing. A
duration
window opens its window DURATION_LEAD_S after its profiler's start
returned, and a synchronized start starts the profiler early enough for
the window to open at the start time; the finish trims the lead. Held
against the JAX client's duration windows where it has one."""

import _thread
import asyncio
import ctypes
import json
import os
import queue
import selectors
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu.client.shim import TraceConfig as JaxTraceConfig
from dynolog_tpu_torch import failpoints, trace
from dynolog_tpu_torch.client import shim
from dynolog_tpu_torch.client.shim import (
    RingConfig, TorchProfiler, TraceClient, TraceConfig)


# The event park's rule of which threads it watches, as the shim has it.
_APP_THREADS = shim._app_threads


@pytest.fixture(autouse=True)
def _parks_watch_this_tests_threads(monkeypatch):
    """An event park watches every app thread of the process. Threads
    that earlier tests in this worker process left running (a server's
    accept loop, an idle pool's worker) are not this test's app, and
    each would hold every start the park's bound: the parks of this
    test watch the others. They are told apart as objects, not by their
    idents: a thread of this test can reuse the ident of one that ended
    since."""
    left = {t for t in threading.enumerate()
            if t is not threading.main_thread()}
    monkeypatch.setattr(shim, "_app_threads", lambda: {
        ident: t for ident, t in _APP_THREADS().items() if t not in left})


class _ConfigsIpc:
    """IpcClient double: a live daemon that hands the poll loop one of
    `texts` per request after start()'s own, once `ready()`."""

    def __init__(self, texts: list, ready=lambda: True):
        self.texts = list(texts)
        self.requests = 0
        self.ready = ready

    def register_context(self, *a, **kw):
        return 0

    def request_config(self, *a, **kw):
        self.requests += 1
        if self.requests < 2 or not self.texts or not self.ready():
            return ""
        return self.texts.pop(0)

    def take_late_config(self):
        return None

    def subscribe_kicks(self, *a, **kw):
        return True

    def wait_for_kick(self, timeout_s):
        time.sleep(min(timeout_s, 0.01))
        return False

    def send_perf_stats(self, *a, **kw):
        return True

    def send_spans(self, *a, **kw):
        return 0

    def close(self):
        pass


class _Sessions:
    """Stands in for torch.profiler.profile and the profiler's
    _ExperimentalConfig: records each session's keyword arguments, the
    keyword arguments of its experimental config, and the native ids of
    the threads that start and stop it, and runs the real profiler."""

    def __init__(self, monkeypatch):
        import torch._C._profiler as c_profiler
        import torch.profiler

        self.rows: list[dict] = []
        # Called at each start and stop; its value is kept as "at_start"
        # and "at_stop".
        self.probe = lambda: None
        real_profile = torch.profiler.profile
        real_config = c_profiler._ExperimentalConfig
        rows, sessions = self.rows, self

        def config(**kw):
            rows.append({"config": kw})
            return real_config(**kw)

        class Profile:
            def __init__(self, **kw):
                row = rows[-1] if rows and "kwargs" not in rows[-1] else {}
                if not row:
                    rows.append(row)
                row["kwargs"] = kw
                self.row = row
                self.real = real_profile(**kw)

            def start(self):
                self.row["start"] = threading.get_native_id()
                self.row["at_start"] = sessions.probe()
                self.real.start()

            def stop(self):
                self.row["stop"] = threading.get_native_id()
                self.row["at_stop"] = sessions.probe()
                self.real.stop()

            def export_chrome_trace(self, path):
                self.real.export_chrome_trace(path)

        monkeypatch.setattr(c_profiler, "_ExperimentalConfig", config)
        monkeypatch.setattr(torch.profiler, "profile", Profile)


def test_every_session_records_all_threads_on_its_chosen_thread(
        tmp_path, monkeypatch):
    """The warmup, a duration capture, an iteration capture and ring
    samples, all in one process: every session is started with
    profile_all_threads and no schedule, and started and stopped on the
    poll thread, as the JAX client's are. Every capture's profiler starts
    while the training thread is parked at a step() (its window
    "opening", and "parked" in its timing), an iteration window's also
    stops so ("closing"). Each capture is ok and holds the training
    thread's cpu_ops."""
    sessions = _Sessions(monkeypatch)
    client = TraceClient(
        job_id=7, endpoint=f"threads_test_{os.getpid()}",
        poll_interval_s=0.02, report_interval_s=0, warmup_profiler=True,
        ring=RingConfig(every_n_steps=5, keep=2, window_ms=30,
                        dir=str(tmp_path / "ring"), model="m",
                        min_interval_s=0.0))
    # The captures come once the app has stepped: one that came before
    # would park the app at its next Python event, as in an app that
    # never steps.
    client._client = _ConfigsIpc([
        f"ACTIVITIES_LOG_FILE={tmp_path}/d.json\n"
        "ACTIVITIES_DURATION_MSECS=50",
        f"ACTIVITIES_LOG_FILE={tmp_path}/i.json\nACTIVITIES_ITERATIONS=2"],
        ready=lambda: client._ever_stepped)
    sessions.probe = lambda: client._window and client._window.state
    a = torch.randn(32, 32)
    me = threading.get_native_id()
    pid = os.getpid()
    manifests = [tmp_path / f"d_{pid}.json", tmp_path / f"i_{pid}.json"]
    client.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not (
                all(m.exists() for m in manifests) and client.ring.captures):
            (a @ a).sum()
            client.step()
            time.sleep(0.002)
        poll = client._thread.native_id
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=60)
    assert client.warmup_timing and client.ring.captures >= 1, (
        client.last_error)
    for m in manifests:
        manifest = json.loads(m.read_text())
        assert manifest["status"] == "ok", manifest
        events = json.loads(open(manifest["trace_file"]).read())[
            "traceEvents"]
        assert any(e.get("cat") == "cpu_op" and e.get("tid") == me
                   for e in events)
    assert len(sessions.rows) >= 4, sessions.rows
    for row in sessions.rows:
        assert row.get("config") == {"profile_all_threads": True}, row
        assert "schedule" not in row["kwargs"], row
        assert row["start"] == row["stop"], row
    assert {row["start"] for row in sessions.rows} == {poll} != {me}
    # The warmup of an app that has not stepped yet holds its threads at
    # their next Python event ("parking"; at its next step() where it
    # stepped first); every capture after it parks at a step().
    warmup, *captures = sessions.rows
    assert warmup["at_start"] == warmup["at_stop"] == {
        "event": "parking", "step": "opening"}[
            client.warmup_timing["park"]], sessions.rows
    assert all(row["at_start"] == "opening" for row in captures), (
        sessions.rows)
    assert [row["at_stop"] for row in sessions.rows].count("closing") == 1
    assert client.warmup_timing["parked"] is True
    for m in manifests:
        timing = json.loads(m.read_text())["timing"]
        assert timing["parked"] is True and timing["park"] == "step"


def _busy_until(stop: threading.Event, work) -> None:
    while not stop.is_set():
        work()
        time.sleep(0.002)


def test_duration_window_trims_its_lead(tmp_path, monkeypatch):
    """A duration window opens its profiler a lead before its window: an
    op run only in the lead (a sigmoid) is recorded and trimmed, no event
    of the finished trace lies before the window's started_ms, its steps
    count from there, and its window_ms is about its duration_ms."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    assert shim.DURATION_LEAD_S > 0
    # A start slower than the lead (the process's first, seconds on the
    # CPU) leaves none: pay it first, without waiting for a step().
    monkeypatch.setattr(shim, "WARMUP_PARK_WAIT_S", 0.0)
    client._warmup()
    a = torch.randn(32, 32)
    in_lead = []

    def work():
        w = client._window
        if w is not None and w.state == "lead":
            in_lead.append(torch.sigmoid(a))
        (a @ a).sum()
        client.step()

    stop = threading.Event()
    app = threading.Thread(target=_busy_until, args=(stop, work))
    app.start()
    try:
        client._run_trace(TraceConfig.parse(
            f"ACTIVITIES_LOG_FILE={tmp_path}/lead.json\n"
            "ACTIVITIES_DURATION_MSECS=200"))
    finally:
        stop.set()
        app.join(timeout=30)
        client.stop()
    assert not app.is_alive() and in_lead
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    assert 200 <= manifest["timing"]["window_ms"] < 400, manifest["timing"]
    doc = json.loads(open(manifest["trace_file"]).read())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    timed = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert min(e["ts"] for e in timed) + base_us >= (
        manifest["started_ms"] * 1e3)
    names = {e.get("name") for e in timed if e.get("cat") == "cpu_op"}
    assert "aten::mm" in names and "aten::sigmoid" not in names
    spans = [e for e in timed
             if e.get("name", "").startswith(trace.STEP_PREFIX)]
    assert spans and all(e["args"] == {"source": "shim"} for e in spans)


def test_duration_window_against_the_jax_client(tmp_path):
    """The same duration capture through both clients: both manifests ok
    in duration mode; the port's window opens a lead after its
    profiler's start returned and, like the JAX window (its sleep
    between the profiler's start and stop), lasts its duration_ms."""
    text = "ACTIVITIES_LOG_FILE={}\nACTIVITIES_DURATION_MSECS=150"
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=jax_shim.RecordingProfiler(), report_interval_s=0)
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    try:
        t0 = time.time() * 1000
        jax_client._run_trace(JaxTraceConfig.parse(
            text.format(tmp_path / "jax.json")))
        t1 = time.time() * 1000
        client._run_trace(TraceConfig.parse(
            text.format(tmp_path / "port.json")))
    finally:
        jax_client.stop()
        client.stop()
    pid = os.getpid()
    ref = json.loads((tmp_path / f"jax_{pid}.json").read_text())
    ours = json.loads((tmp_path / f"port_{pid}.json").read_text())
    assert ref["status"] == ours["status"] == "ok", (ref, ours)
    assert ref["mode"] == ours["mode"] == "duration"
    assert t0 - 1 <= ref["started_ms"] < t1
    assert ours["started_ms"] - t1 >= shim.DURATION_LEAD_S * 1000 - 1
    timing = ref["timing"]
    jax_window = (ref["ended_ms"] - ref["started_ms"]
                  - timing["profiler_start_ms"] - timing["profiler_stop_ms"])
    for window_ms in (jax_window, ours["timing"]["window_ms"]):
        assert 150 <= window_ms < 300, (ref, ours)


def test_synchronized_start_opens_the_profiler_a_lead_early(tmp_path,
                                                            monkeypatch):
    """With PROFILE_START_TIME set, the profiler starts early enough for
    its start and lead to end by the start time, and the window opens at
    it; the JAX client starts its profiler at the start time."""
    starts = []

    class Seen(TorchProfiler):
        def start(self, trace_dir, lead=False):
            starts.append(time.time() * 1000)
            super().start(trace_dir, lead)

    class JaxSeen(jax_shim.RecordingProfiler):
        def start(self, trace_dir):
            starts.append(time.time() * 1000)
            super().start(trace_dir)

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=Seen(), report_interval_s=0)
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=JaxSeen(), report_interval_s=0)
    lead_ms = shim.DURATION_LEAD_S * 1000
    monkeypatch.setattr(shim, "WARMUP_PARK_WAIT_S", 0.0)
    try:
        # The profiler's first start in a process can take seconds on the
        # CPU: pay it outside the measured start, without a step().
        client._warmup()
        at = []
        for name, c, parse in (("port", client, TraceConfig.parse),
                               ("jax", jax_client, JaxTraceConfig.parse)):
            at.append(int(time.time() * 1000) + 1000)
            c._run_trace(parse(
                f"ACTIVITIES_LOG_FILE={tmp_path}/{name}.json\n"
                f"ACTIVITIES_DURATION_MSECS=50\nPROFILE_START_TIME={at[-1]}"))
    finally:
        client.stop()
        jax_client.stop()
    pid = os.getpid()
    ours = json.loads((tmp_path / f"port_{pid}.json").read_text())
    ref = json.loads((tmp_path / f"jax_{pid}.json").read_text())
    assert ours["status"] == ref["status"] == "ok", (ours, ref)
    _, port_start, jax_start = starts
    early_ms = lead_ms + shim.SYNC_START_ALLOWANCE_S * 1000
    assert at[0] - early_ms - 1 <= port_start < at[0] - lead_ms
    assert at[0] - 1 <= ours["started_ms"] < at[0] + 50
    assert at[1] - 1 <= jax_start < at[1] + 50
    assert ref["started_ms"] >= at[1] - 1


class _HeldOpen(TorchProfiler):
    """Holds each duration window open, its stop waiting (up to 30 s),
    until the training thread has run an op since the window opened: a
    window of 10 ms on a loaded host can pass while that thread is not
    scheduled at all, and then holds none of its ops."""

    def __init__(self):
        super().__init__()
        self.opened = False
        self.stepped = threading.Event()

    def start(self, trace_dir, lead=False):
        self.opened = False
        self.stepped.clear()
        super().start(trace_dir, lead)

    def open_window(self, at_ns):
        super().open_window(at_ns)
        self.opened = True

    def stop(self):
        if self.opened:
            self.stepped.wait(30)
        super().stop()


def test_mixed_captures_each_hold_the_training_threads_ops(tmp_path):
    """200 captures in one process, duration and iteration windows in
    turns, each finished in-process (the path that lost the card's
    kernel records soonest): every one is ok and holds cpu_ops of the
    training thread inside its window. A duration window stays open
    until the training thread has stepped in it (_HeldOpen)."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=_HeldOpen(), report_interval_s=0)
    client.profiler.configure({"PROFILE_PYTHON_TRACER_LEVEL": "0"})
    a = torch.randn(16, 16)
    me = threading.get_native_id()
    failpoints.arm("shim.finish_spawn", "error")
    held = []
    try:
        for i in range(200):
            kind = ("ACTIVITIES_ITERATIONS=2" if i % 2
                    else "ACTIVITIES_DURATION_MSECS=10")
            cfg = TraceConfig.parse(
                f"ACTIVITIES_LOG_FILE={tmp_path}/m{i}.json\n"
                f"PROFILE_PYTHON_TRACER_LEVEL=0\nTRACE_JSON=0\n{kind}")
            runner = threading.Thread(target=client._run_trace, args=(cfg,))
            runner.start()
            deadline = time.time() + 60
            while runner.is_alive() and time.time() < deadline:
                opened = client.profiler.opened
                (a @ a).sum()
                if opened:
                    client.profiler.stepped.set()
                client.step()
                time.sleep(0.001)
            runner.join(timeout=30)
            assert not runner.is_alive(), i
            manifest = client.last_manifest
            assert manifest["status"] == "ok", (i, manifest)
            assert manifest["timing"]["lost_launches"] == 0, (i, manifest)
            doc = json.loads(open(manifest["trace_file"]).read())
            base_us = doc["baseTimeNanoseconds"] / 1e3
            held.append(sum(
                e.get("cat") == "cpu_op" and e.get("tid") == me
                and e["ts"] + base_us >= manifest["started_ms"] * 1e3
                for e in doc["traceEvents"]))
            os.unlink(manifest["trace_file"])
    finally:
        failpoints.disarm("shim.finish_spawn")
        client.stop()
    assert failpoints.hits("shim.finish_spawn") >= 200
    assert all(held), [i for i, n in enumerate(held) if not n]


def test_stop_during_the_lead_ends_the_capture(tmp_path, monkeypatch):
    """stop() while a duration window's profiler records its lead: the
    poll thread's wait ends before the window opens, its own profiler is
    stopped, and the capture ends in an error manifest."""
    monkeypatch.setattr(shim, "DURATION_LEAD_S", 600.0)
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    runner = threading.Thread(target=client._run_trace, args=(
        TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path / 'x.json'}\n"
                          "ACTIVITIES_DURATION_MSECS=600000"),))
    runner.start()
    deadline = time.time() + 60
    # The window enters its lead once the profiler's start has returned.
    while time.time() < deadline and not (
            client._window is not None and client._window.state == "lead"):
        time.sleep(0.01)
    lead = client._window.state
    recording = client.profiler._prof is not None
    t0 = time.time()
    client.stop()
    runner.join(timeout=30)
    assert not runner.is_alive() and time.time() - t0 < 10
    assert lead == "lead" and recording
    manifest = json.loads((tmp_path / f"x_{os.getpid()}.json").read_text())
    assert manifest["status"] == "error" and "client stopped" in manifest[
        "error"], manifest
    assert client.profiler._prof is None and client._window is None


def test_stop_during_the_park_wait_starts_nothing(tmp_path):
    """stop() while a duration capture waits for the training thread to
    park (it has stepped, then paused): the profiler is never started,
    the capture ends in an error manifest, and no window is left."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         report_interval_s=0, step_start_timeout_s=600)
    for _ in range(3):
        client.step()
        time.sleep(0.5)  # recent steps of 0.5 s: a wait of about 1 s
    runner = threading.Thread(target=client._run_trace, args=(
        TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path / 'p.json'}\n"
                          "ACTIVITIES_DURATION_MSECS=50"),))
    runner.start()
    deadline = time.time() + 30
    while client._window is None and time.time() < deadline:
        time.sleep(0.005)
    assert client._window.state == "armed"
    client.stop()
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert [c for c in client.profiler.calls if c[0] == "start"] == []
    manifest = json.loads((tmp_path / f"p_{os.getpid()}.json").read_text())
    assert manifest["status"] == "error" and "client stopped" in manifest[
        "error"], manifest
    assert client._window is None


class _Gate:
    """A lock a thread blocks on in C by a bare acquire (wait()), not at
    a wait site the event park knows, until set()."""

    def __init__(self):
        self._lock = _thread.allocate_lock()
        self._lock.acquire()
        self._set = False

    def wait(self):
        self._lock.acquire()
        self._lock.release()  # on to the next waiter

    def set(self):
        if not self._set:
            self._set = True
            self._lock.release()


def _blocked_in_c(name: str = "blocked_in_c"):
    """An app thread that stays in C (a bare lock acquire) until its gate
    is set: it reaches no Python event, so no event park holds it."""
    release = _Gate()
    app = threading.Thread(target=release.wait, name=name)
    app.start()
    return release, app


@pytest.mark.parametrize("case", ["warmup_before_any_step",
                                  "duration_after_a_pause"])
def test_start_without_a_park_says_so(case, monkeypatch):
    """A start that goes ahead without the app parked — the warmup of an
    app that has not stepped, a duration capture of an app that stepped,
    then did not step within step_start_timeout_s — where an app thread
    stays in C past the event park's bound records parked false, no
    park, and that thread's name as unparked in its timing."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         report_interval_s=0, step_start_timeout_s=0.3)
    monkeypatch.setattr(shim, "WARMUP_PARK_WAIT_S", 0.2)
    monkeypatch.setattr(shim, "EVENT_PARK_WAIT_S", 0.2)
    release, app = _blocked_in_c()
    try:
        if case == "warmup_before_any_step":
            t0 = time.time()
            client._warmup()
            assert time.time() - t0 >= 0.2
            timing = client.warmup_timing
        else:
            client.step()
            client.step()  # then no step for longer than the wait
            error, window = client._capture_window(
                TraceConfig(duration_ms=20), "unused")
            assert error is None
            timing = window.timing
        assert timing["parked"] is False and timing["park"] is None
        assert timing["unparked"] == ["blocked_in_c"]
    finally:
        release.set()
        app.join(timeout=30)
        client.stop()


def test_warmup_parks_at_the_apps_first_step():
    """The warmup of an app that has stepped waits for its first step()
    after the warmup armed, drains the card and starts its profiler with
    the app parked there, and stops it before the app goes on (C18),
    then saves it, once: the calls the JAX client's warmup makes (one
    start and one stop before its first poll), which starts at once."""
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=jax_shim.RecordingProfiler(), warmup_profiler=True,
        report_interval_s=0)
    jax_client._stop.set()
    jax_client._poll_loop()  # the warmup, then no poll
    seen = []

    class Seen(shim.RecordingProfiler):
        def drain(self, device):
            self.calls.append(("drain", device))

        def start(self, trace_dir, lead=False):
            seen.append((client._window.state, client._step_count))
            super().start(trace_dir, lead)

        def stop(self):
            seen.append((client._window.state, client._step_count))
            super().stop()

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=Seen(), warmup_profiler=True,
                         report_interval_s=0, device=3)
    client.step()  # the app has stepped before the warmup
    poll = threading.Thread(target=client._warmup)
    poll.start()
    time.sleep(0.3)
    assert seen == [] and client._window.state == "armed"
    deadline = time.time() + 30
    while poll.is_alive() and time.time() < deadline:
        client.step()
        time.sleep(0.005)
    poll.join(timeout=30)
    assert not poll.is_alive()
    assert seen == [("opening", 2), ("opening", 2)]
    assert client.warmup_timing["parked"] is True
    assert client.warmup_timing["park"] == "step"
    assert client.warmup_timing["lost_launches"] == 0
    assert [c[0] for c in jax_client.profiler.calls] == ["start", "stop"]
    assert [c[0] for c in client.profiler.calls] == [
        "drain", "start", "stop", "export"]
    assert client.profiler.calls[0] == ("drain", 3)
    assert client._window is None


def test_warmup_holds_an_app_that_has_not_stepped():
    """The warmup of an app that has not stepped yet holds its thread at
    its next Python event, before its first step(), without waiting for
    one; drains the card, starts its profiler and stops it with that
    thread held throughout (C18, C19), then saves it, once: the calls
    the JAX client's warmup makes (one start and one stop before its
    first poll), which starts at once."""
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=jax_shim.RecordingProfiler(), warmup_profiler=True,
        report_interval_s=0)
    jax_client._stop.set()
    jax_client._poll_loop()  # the warmup, then no poll
    seen, spins = [], [0]

    class Seen(shim.RecordingProfiler):
        def drain(self, device):
            self.calls.append(("drain", device))

        def start(self, trace_dir, lead=False):
            seen.append((client._window.state, client._step_count, spins[0]))
            super().start(trace_dir, lead)

        def stop(self):
            seen.append((client._window.state, client._step_count, spins[0]))
            super().stop()

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=Seen(), warmup_profiler=True,
                         report_interval_s=0, device=3)
    go, done = threading.Event(), threading.Event()

    def app():
        while not go.is_set():  # the app, not stepping yet
            spins[0] += 1
            time.sleep(0.001)
        while not done.is_set():
            client.step()
            time.sleep(0.001)

    thread = threading.Thread(target=app)
    thread.start()
    try:
        t0 = time.time()
        client._warmup()  # on this thread, the poll thread's role
        took = time.time() - t0
        go.set()
    finally:
        go.set()
        done.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert took < shim.WARMUP_PARK_WAIT_S
    assert seen[0] == seen[1] and seen[0][:2] == ("parking", 0), seen
    assert client.warmup_timing["parked"] is True
    assert client.warmup_timing["park"] == "event"
    assert client.warmup_timing["lost_launches"] == 0
    assert [c[0] for c in jax_client.profiler.calls] == ["start", "stop"]
    assert [c[0] for c in client.profiler.calls] == [
        "drain", "start", "stop", "export"]
    assert client.profiler.calls[0] == ("drain", 3)
    assert client._window is None


def test_stop_during_the_warmups_park_wait_starts_nothing(monkeypatch):
    """stop() while the warmup waits for the app's threads to park (one
    stays in C): no profiler starts, warmup_done is set, no window is
    left, and the threads it held go on. stop() comes from a thread the
    park does not watch (one the threading module did not start)."""
    monkeypatch.setattr(shim, "WARMUP_PARK_WAIT_S", 600.0)
    release, blocked = _blocked_in_c()
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         warmup_profiler=True, report_interval_s=0)
    client._client = _ConfigsIpc([])
    seen, stopped = [], _thread.allocate_lock()
    stopped.acquire()

    def operator():
        deadline = time.time() + 30
        while time.time() < deadline and not (
                client._window is not None
                and client._window.state == "parking"):
            time.sleep(0.005)
        seen.append(client._window and client._window.state)
        client.stop()
        stopped.release()

    poll = threading.Thread(target=client._poll_loop)
    poll.start()
    _thread.start_new_thread(operator, ())
    try:
        # This thread is held at its next event until stop() ends the
        # park's wait.
        assert stopped.acquire(timeout=60)
        poll.join(timeout=30)
    finally:
        release.set()
        blocked.join(timeout=30)
    assert not poll.is_alive()
    assert seen == ["parking"]
    assert client.profiler.calls == []
    assert client.warmup_done.is_set() and client.warmup_timing == {}
    assert client._window is None


def test_poll_loop_captures_count_their_lost_launches(tmp_path):
    """The client as an application starts it — client.start(), the
    warmup and the ring on, the app training at once without waiting on
    warmup_done — with duration and iteration captures arriving through
    the daemon: every manifest is ok with lost_launches 0 (no card, no
    launch) and parked true, every ring sample's timing has
    lost_launches 0, and the warmup parked (at the app's next Python
    event, or its first step())."""
    pid = os.getpid()
    texts, manifests = [], []
    for i in range(4):
        kind = ("ACTIVITIES_ITERATIONS=2" if i % 2
                else "ACTIVITIES_DURATION_MSECS=50")
        texts.append(f"ACTIVITIES_LOG_FILE={tmp_path}/c{i}.json\n{kind}")
        manifests.append(tmp_path / f"c{i}_{pid}.json")
    client = TraceClient(
        job_id=7, endpoint=f"threads_poll_test_{pid}", poll_interval_s=0.02,
        report_interval_s=0, warmup_profiler=True,
        ring=RingConfig(every_n_steps=5, keep=2, window_ms=30,
                        dir=str(tmp_path / "ring"), model="m",
                        min_interval_s=0.0))
    client._client = _ConfigsIpc(texts)
    a = torch.randn(32, 32)
    samples = []
    client.start()
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not (
                all(m.exists() for m in manifests) and len(samples) >= 2):
            (a @ a).sum()
            client.step()
            if client.ring.captures > len(samples):
                samples.append(dict(client.ring.last_timing))
            time.sleep(0.002)
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=60)
    assert client.warmup_timing["parked"] is True, client.warmup_timing
    assert len(samples) >= 2, client.last_error
    for timing in samples:
        assert timing["lost_launches"] == 0, timing
    for m in manifests:
        manifest = json.loads(m.read_text())
        assert manifest["status"] == "ok", manifest
        assert manifest["timing"]["lost_launches"] == 0, manifest
        assert manifest["timing"]["parked"] is True, manifest
    assert client.last_error is None


def test_duration_start_waits_out_a_long_step():
    """A duration capture that arrives during a step ten times the app's
    recent ones (an eval's, a checkpoint's), longer than the two recent
    steps a synchronized start allows for the park: its start waits for
    the next step() and goes ahead parked there, as an iteration window
    waits for its first step; park_ms says how long it waited."""
    seen = []

    class Seen(shim.RecordingProfiler):
        def start(self, trace_dir, lead=False):
            seen.append((client._window.state, client._step_count))
            super().start(trace_dir, lead)

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=Seen(), report_interval_s=0)
    for _ in range(5):
        client.step()
        time.sleep(0.02)
    got = {}
    runner = threading.Thread(target=lambda: got.update(
        r=client._capture_window(TraceConfig(duration_ms=20), "unused")))
    runner.start()
    time.sleep(0.5)  # the long step: 25 recent steps
    assert client._park_wait_s() < 0.5 and seen == []
    deadline = time.time() + 30
    while runner.is_alive() and time.time() < deadline:
        client.step()
        time.sleep(0.005)
    runner.join(timeout=30)
    error, window = got["r"]
    assert error is None
    assert seen == [("opening", 6)]
    assert window.timing["parked"] is True
    assert window.timing["park_ms"] >= 450
    client.stop()


# ---------------------------------------------------------------- C19


class _Counted(shim.RecordingProfiler):
    """RecordingProfiler that reads an app thread's loop counter when its
    start and stop begin and when they return (``seen``: (call, before,
    after))."""

    def __init__(self, counter: list):
        super().__init__()
        self.counter = counter
        self.seen: list[tuple] = []

    def start(self, trace_dir, lead=False):
        before = self.counter[0]
        time.sleep(0.02)  # a start that takes a while
        super().start(trace_dir, lead)
        self.seen.append(("start", before, self.counter[0]))

    def stop(self):
        before = self.counter[0]
        time.sleep(0.02)
        super().stop()
        self.seen.append(("stop", before, self.counter[0]))


def _spinning(stop: threading.Event, counter: list, work=None) -> None:
    """An app thread that never calls step(): counts its loops (and runs
    `work` in each) until `stop`."""
    while not stop.is_set():
        if work is not None:
            work()
        counter[0] += 1
        time.sleep(0.0005)


def _tools_clean() -> bool:
    return all(sys.monitoring.get_tool(t) is None
               and sys.monitoring.get_events(t) == 0
               for t in shim.EVENT_PARK_TOOL_IDS)


@pytest.mark.parametrize("kind", ["warmup", "duration", "ring"])
def test_stepless_app_is_held_at_every_start(kind, tmp_path):
    """An app thread that never calls step() is held at its next Python
    event from before each profiler start to after it returned (the
    warmup's: to after its stop), and over each stop (C21): its loop
    counter does not move over them, while it runs between captures. The
    timing (the warmup's, the manifest's, the ring's last_timing) says
    parked, by the event park, and stop_parked."""
    counter, stop = [0], threading.Event()
    client = TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=_Counted(counter), report_interval_s=0,
        ring=RingConfig(every_n_steps=5, keep=2, window_ms=30,
                        dir=str(tmp_path / "ring"), model="m",
                        min_interval_s=0.0))
    app = threading.Thread(target=_spinning, args=(stop, counter))
    app.start()
    timings = []
    try:
        for i in range(3):
            moved, deadline = counter[0], time.time() + 30
            while counter[0] == moved and time.time() < deadline:
                time.sleep(0.005)
            assert counter[0] > moved  # it runs between captures
            if kind == "warmup":
                client._warmup()
                timings.append(client.warmup_timing)
            elif kind == "duration":
                client._run_trace(TraceConfig.parse(
                    f"ACTIVITIES_LOG_FILE={tmp_path}/d{i}.json\n"
                    "ACTIVITIES_DURATION_MSECS=30"))
                assert client.last_manifest["status"] == "ok"
                timings.append(client.last_manifest["timing"])
            else:
                assert client.ring.capture(client._ring_sample), (
                    client.ring.last_error)
                timings.append(client.ring.last_timing)
            assert _tools_clean()
    finally:
        stop.set()
        app.join(timeout=30)
        client.stop()
    starts = [s for s in client.profiler.seen if s[0] == "start"]
    assert len(starts) == 3
    assert all(before == after for _, before, after in starts), starts
    seen = client.profiler.seen
    assert [c for c, _, _ in seen] == ["start", "stop"] * 3
    if kind == "warmup":
        # Held from before the start to after the stop.
        assert all(seen[k][1] == seen[k + 1][2] for k in (0, 2, 4)), seen
    else:
        # Held over each stop too (C21).
        assert all(before == after for _, before, after in seen), seen
    for timing in timings:
        assert timing["parked"] is True and timing["park"] == "event", (
            timing)
        assert "unparked" not in timing and timing["park_ms"] >= 0
        if kind != "warmup":
            assert timing["stop_parked"] is True, timing
            assert timing["stop_park_ms"] >= 0


@pytest.mark.parametrize("blocker", ["lock_acquire", "ctypes_usleep"])
def test_thread_in_c_does_not_hold_a_start_past_its_bound(blocker,
                                                          monkeypatch):
    """A thread that stays in C, other than at a wait the park knows (a
    bare lock acquire, which leaves it holding the lock when it wakes; a
    ctypes call, which could launch work from C), reaches no Python
    event: the start waits for it EVENT_PARK_WAIT_S, no longer, holds the
    threads that did reach one, and goes ahead with parked false and that
    thread named."""
    monkeypatch.setattr(shim, "EVENT_PARK_WAIT_S", 1.0)
    release = _Gate()
    joined = threading.Thread(target=release.wait, name="joined")
    joined.start()
    libc = ctypes.CDLL(None)

    def blocked():
        if blocker == "lock_acquire":
            release.wait()
        else:
            libc.usleep(3_500_000)

    counter, stop = [0], threading.Event()
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=_Counted(counter), report_interval_s=0)
    app = threading.Thread(target=_spinning, args=(stop, counter))
    in_c = threading.Thread(target=blocked, name="in_c")
    in_c.start()
    time.sleep(0.5)  # the thread is in C
    app.start()
    try:
        t0 = time.time()
        error, window = client._capture_window(
            TraceConfig(duration_ms=20), "unused")
        took = time.time() - t0
    finally:
        release.set()
        stop.set()
        for t in (in_c, app, joined):
            t.join(timeout=30)
        client.stop()
    assert error is None
    assert window.timing["parked"] is False and window.timing["park"] is None
    # The threads in C were not held (this one arms the park); the
    # spinning app thread was.
    assert sorted(window.timing["unparked"]) == ["in_c", "joined"]
    assert 1.0 <= window.timing["park_ms"] / 1000 < 2.5
    assert took < 3.5
    (_, before, after), = [s for s in client.profiler.seen
                           if s[0] == "start"]
    assert before == after
    assert _tools_clean()


class _Waking(_Counted):
    """_Counted whose start first wakes a waiting app thread (`wake`, its
    seconds kept in `wake_s`), gives it time to run, keeps its count of
    wakes (`woke_in_start`) and what `probe()` finds then (`probed`)."""

    def __init__(self, counter: list, woke: list, wake, probe=None):
        super().__init__(counter)
        self.woke, self.wake, self.probe = woke, wake, probe
        self.woke_in_start = self.probed = None
        self.wake_s = 0.0

    def start(self, trace_dir, lead=False):
        t0 = time.time()
        self.wake()
        self.wake_s = time.time() - t0
        time.sleep(0.1)
        self.woke_in_start = self.woke[0]
        if self.probe is not None:
            self.probed = self.probe()
        super().start(trace_dir, lead)


# How long a sleeping waiter sleeps: the start it is counted parked for
# (0.3 s after it began) waits out its sleep, so that it wakes inside.
SLEEP_S = 2.0


def _waiter(kind: str, woke: list) -> SimpleNamespace:
    """An app thread named "waiter" (an idle pool's "waiter_0") that
    waits in `kind`'s call, then adds one to woke[0] (with no call in
    between, so that only an event at an instruction can hold it before
    it does): `thread` (None for the pool), `wake()`, `done()` (wakes
    it where it still waits, and cleans up), and the thread it joins
    (`joined`) or the Condition it waits on (`cond`)."""

    def count():
        woke[0] += 1

    if kind == "idle_pool_worker":
        pool = ThreadPoolExecutor(1, thread_name_prefix="waiter")
        pool.submit(int).result()  # its worker is up, then idle
        return SimpleNamespace(thread=None, wake=lambda: pool.submit(count),
                               done=pool.shutdown)
    got = SimpleNamespace(joined=None, cond=None)
    closers, cleanup = [], None
    if kind in ("event_wait", "queue_get"):
        event, items = threading.Event(), queue.Queue()
        got.cond = event._cond if kind == "event_wait" else items.not_empty

        def wait():
            event.wait() if kind == "event_wait" else items.get()

        def wake():
            event.set() if kind == "event_wait" else items.put(None)
    elif kind == "join":
        # The shim's threads are not watched: this one ends in the start.
        gate = threading.Event()
        joined = threading.Thread(target=gate.wait,
                                  name=shim.THREAD_PREFIX + "joined")
        joined.start()
        wait, wake, got.joined = joined.join, gate.set, joined
    elif kind in ("sleep", "from_time_sleep"):
        ends = []

        def wait():
            ends.append(time.monotonic() + SLEEP_S)
            if kind == "sleep":
                time.sleep(SLEEP_S)
            else:
                from time import sleep
                sleep(SLEEP_S)  # the callee resolved, not its name

        def wake():
            time.sleep(max(ends[0] - time.monotonic(), 0.0) + 0.05)
    elif kind == "accept":
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        closers.append(listener)

        def wait():
            listener.accept()[0].close()

        def wake():
            closers.append(socket.create_connection(listener.getsockname()))
    elif kind in ("recv", "selector"):
        a, b = socket.socketpair()
        closers += [a, b]

        def wait():
            if kind == "recv":
                a.recv(1)
            else:
                with selectors.DefaultSelector() as sel:
                    sel.register(a, selectors.EVENT_READ)
                    sel.select()

        def wake():
            b.send(b"x")
    else:  # an asyncio loop with nothing scheduled
        loop = asyncio.new_event_loop()

        def wait():
            loop.run_forever()  # count() runs in it once woken

        def wake():
            loop.call_soon_threadsafe(count)

        def cleanup():
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=30)
            loop.close()

    def run():
        wait()
        if kind != "asyncio":
            woke[0] += 1

    thread = threading.Thread(target=run, name="waiter")
    thread.start()

    def done():
        if thread.is_alive() and kind != "asyncio":
            wake()
        if cleanup is not None:
            cleanup()
        thread.join(timeout=30)
        for c in closers:
            c.close()
    got.thread, got.wake, got.done = thread, wake, done
    return got


WAITERS = ["event_wait", "queue_get", "idle_pool_worker", "join", "sleep",
           "from_time_sleep", "accept", "recv", "selector", "asyncio"]


@pytest.mark.parametrize("waiter", WAITERS)
def test_thread_waiting_on_another_is_parked_at_once(waiter, monkeypatch):
    """A thread waiting on another thread or on the outside (Event.wait(),
    Queue.get(), an idle ThreadPoolExecutor's worker, Thread.join(),
    time.sleep() however it was imported, a socket's accept() or recv(),
    an idle selector or asyncio loop) cannot reach the card before its
    next Python event: the start counts it as parked, with no wait for it
    (under 0.5 s, EVENT_PARK_WAIT_S is 5 s), and names it ``waiting``;
    woken in the start, it is held where it wakes until the start has
    returned."""
    monkeypatch.setattr(shim, "EVENT_PARK_WAIT_S", 5.0)
    counter, woke, stop = [0], [0], threading.Event()
    w = _waiter(waiter, woke)
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=_Waking(counter, woke, w.wake),
                         report_interval_s=0)
    app = threading.Thread(target=_spinning, args=(stop, counter),
                           name="app")
    app.start()
    time.sleep(0.3)  # the waiter is in its wait
    try:
        t0 = time.time()
        error, window = client._capture_window(
            TraceConfig(duration_ms=20), "unused")
        took = time.time() - t0 - client.profiler.wake_s
        deadline = time.time() + 30
        while not woke[0] and time.time() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        app.join(timeout=30)
        w.done()
        client.stop()
    assert error is None
    assert window.timing["parked"] is True
    assert window.timing["park"] == "event"
    # The spinning app thread, caught in its time.sleep(), counts too.
    name = "waiter" if w.thread is not None else "waiter_0"
    assert name in window.timing["waiting"], window.timing
    assert set(window.timing["waiting"]) <= {name, "app"}, window.timing
    assert window.timing["park_ms"] < 500 and took < 3.0, window.timing
    # Woken in the start, it ran only after the start returned.
    assert client.profiler.woke_in_start == 0 and woke[0] == 1
    (_, before, after), = [s for s in client.profiler.seen
                           if s[0] == "start"]
    assert before == after
    assert _tools_clean()


@pytest.mark.parametrize("waiter", ["join", "event_wait", "queue_get"])
def test_woken_thread_is_held_holding_no_lock_of_threadings(waiter):
    """A thread woken in the threading module's wait (Thread.join()'s,
    Condition.wait()'s) is held at its next Python event where it holds
    none of that module's locks: the joined thread's state lock released
    (join's _stop() done), the Condition's lock free, the module's own
    locks free; it runs on only after the start."""
    counter, woke, found = [0], [0], {}

    def probe():
        found["held"] = w.thread.ident in client._window.park.held
        locks = [threading._active_limbo_lock,
                 threading._shutdown_locks_lock]
        if w.joined is not None:
            # Its _stop() ran: the joined thread's state lock is released.
            found["joined_stopped"] = (w.joined._is_stopped
                                       and w.joined._tstate_lock is None)
        else:
            locks.append(w.cond._lock)
        found["free"] = []
        for lock in locks:
            free = lock.acquire(timeout=1.0)
            found["free"].append(free)
            if free:
                lock.release()
        return found

    w = _waiter(waiter, woke)
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=_Waking(counter, woke, w.wake, probe),
                         report_interval_s=0)
    time.sleep(0.3)  # the waiter is in its wait
    try:
        error, window = client._capture_window(
            TraceConfig(duration_ms=20), "unused")
        w.thread.join(timeout=30)
    finally:
        w.done()
        client.stop()
    assert error is None and window.timing["parked"] is True
    assert client.profiler.probed is found
    assert found["held"] and all(found["free"]), found
    assert found.get("joined_stopped", True), found
    assert client.profiler.woke_in_start == 0 and woke[0] == 1
    assert _tools_clean()


def test_warmup_parks_an_app_waiting_for_it():
    """The README's usage: the app's thread waits for warmup_done after
    start(). Waiting in Event.wait(), it counts as parked: the warmup
    starts with no wait for it (WARMUP_PARK_WAIT_S is 10 s) and says
    parked by the event park, that thread waiting."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         warmup_profiler=True, report_interval_s=0)
    client._client = _ConfigsIpc([])
    done = _thread.allocate_lock()
    done.acquire()

    def poll():
        time.sleep(0.3)  # this thread is in its wait by then
        try:
            client._poll_loop()
        finally:
            done.release()

    _thread.start_new_thread(poll, ())
    try:
        t0 = time.time()
        assert client.warmup_done.wait(timeout=120)
        took = time.time() - t0
    finally:
        client.stop()
        assert done.acquire(timeout=60)
    timing = client.warmup_timing
    assert timing["parked"] is True and timing["park"] == "event", timing
    assert timing["waiting"] == [threading.current_thread().name]
    assert timing["park_ms"] < 1000 and took < 0.3 + 2.0
    assert _tools_clean()


def test_a_thread_setting_up_cuda_is_not_held_with_its_lock(monkeypatch):
    """A thread that sets up CUDA holds torch.cuda's _initialization_lock
    across Python calls, and a profiler's stop synchronizes the card,
    which takes that lock until CUDA is set up (torch.cuda._lazy_init).
    The warmup's park holds no thread inside torch.cuda: its stop, which
    takes the lock, does not wait for a held thread (EVENT_HOLD_MAX_S);
    the thread is held once it has left torch.cuda, from before the
    start to after the stop."""
    monkeypatch.setattr(shim, "EVENT_HOLD_MAX_S", 5.0)
    gate, counter, stop, left = _Gate(), [0], threading.Event(), []

    def set_up():
        # Stands in for torch._C._cuda_init(), in C while the park arms.
        gate.wait()
        return False

    monkeypatch.setattr(torch.cuda, "_is_in_bad_fork", set_up)

    def app():
        try:
            torch.cuda._lazy_init()
        except Exception as e:  # noqa: BLE001 - no CUDA on this host
            left.append(type(e).__name__)
        else:
            left.append(None)
        _spinning(stop, counter)

    class TakesTheLock(_Counted):
        def stop(self):
            with torch.cuda._initialization_lock:
                super().stop()

    def release_once_armed():
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                sys.monitoring.get_events(t)
                for t in shim.EVENT_PARK_TOOL_IDS):
            time.sleep(0.001)
        time.sleep(0.05)
        gate.set()

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TakesTheLock(counter), report_interval_s=0)
    thread = threading.Thread(target=app, name="cuda_setup")
    thread.start()
    time.sleep(0.3)  # inside _lazy_init, holding the lock, in C
    _thread.start_new_thread(release_once_armed, ())
    try:
        t0 = time.time()
        client._warmup()
        took = time.time() - t0
    finally:
        gate.set()
        stop.set()
        thread.join(timeout=30)
    assert len(left) == 1  # it left _lazy_init
    assert took < shim.EVENT_HOLD_MAX_S
    assert client.warmup_timing["parked"] is True, client.warmup_timing
    assert client.warmup_timing["park"] == "event"
    (_, b0, a0), (_, b1, a1) = client.profiler.seen
    assert b0 == a0 == b1 == a1
    assert _tools_clean()


class _Doubled(torch.autograd.Function):
    """A Python Function whose backward is slow, and says where it runs."""

    inside = [False]
    threads: set = set()

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, grad):
        _Doubled.inside[0] = True
        _Doubled.threads.add(threading.get_ident())
        for _ in range(50):
            grad = grad + 0.0  # Python events inside the backward
            time.sleep(0.0002)
        _Doubled.inside[0] = False
        return grad * 2


@pytest.mark.parametrize("kind", ["duration", "warmup"])
def test_autograd_backward_is_not_held_mid_backward(kind):
    """On the CPU a Python Function's backward runs on the thread that
    called backward(), with Python events inside it: the event park does
    not hold that thread there (nor deadlocks), but at its next event
    after backward() returned; the start is parked."""
    counter, stop, at_start = [0], threading.Event(), []
    x = torch.randn(64, requires_grad=True)
    _Doubled.threads.clear()

    def train():
        _Doubled.apply(x).sum().backward()

    class Seen(_Counted):
        def start(self, trace_dir, lead=False):
            at_start.append(_Doubled.inside[0])
            super().start(trace_dir, lead)

    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=Seen(counter), report_interval_s=0)
    app = threading.Thread(target=_spinning, args=(stop, counter, train))
    app.start()
    try:
        for _ in range(5):
            if kind == "warmup":
                client._warmup()
                timing = client.warmup_timing
            else:
                error, window = client._capture_window(
                    TraceConfig(duration_ms=10), "unused")
                assert error is None
                timing = window.timing
            assert timing["parked"] is True and timing["park"] == "event"
    finally:
        stop.set()
        app.join(timeout=30)
        client.stop()
    assert not app.is_alive()
    assert _Doubled.threads == {app.ident}
    assert at_start == [False] * 5


def test_event_park_watches_the_apps_threads_only():
    """The threads an event park watches: the threading module's live
    threads but the arming thread, the shim's own (THREAD_PREFIX) and
    dummy threads (started outside the threading module, such as the
    autograd engine's)."""
    release = threading.Event()
    app = threading.Thread(target=release.wait, name="app")
    own = threading.Thread(target=release.wait,
                           name=shim.THREAD_PREFIX + "finisher")
    dummy = []

    def foreign():
        dummy.append(threading.current_thread())  # registers a dummy
        release.wait()

    got = {}
    arming = threading.Thread(
        target=lambda: got.update(watched=_APP_THREADS()))
    for t in (app, own):
        t.start()
    _thread.start_new_thread(foreign, ())
    deadline = time.time() + 10
    while not dummy and time.time() < deadline:
        time.sleep(0.001)
    try:
        arming.start()
        arming.join(timeout=10)
    finally:
        release.set()
        for t in (app, own):
            t.join(timeout=10)
    assert isinstance(dummy[0], threading._DummyThread)
    # Threads earlier tests in this process left running are watched too.
    watched = set(got["watched"])
    assert {app.ident, threading.main_thread().ident} <= watched
    assert not {own.ident, dummy[0].ident, arming.ident} & watched


def test_a_call_of_stop_is_never_held(tmp_path, monkeypatch):
    """A thread that calls stop() while a start waits for the app's
    threads to park is not held there: stop() ends the wait, nothing
    starts, and the capture ends in an error manifest."""
    monkeypatch.setattr(shim, "EVENT_PARK_WAIT_S", 600.0)
    release, blocked = _blocked_in_c()
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         report_interval_s=0)
    ran = _thread.allocate_lock()
    ran.acquire()

    def runner():
        try:
            client._run_trace(TraceConfig.parse(
                f"ACTIVITIES_LOG_FILE={tmp_path / 's.json'}\n"
                "ACTIVITIES_DURATION_MSECS=50"))
        finally:
            ran.release()

    try:
        t0 = time.time()
        # Not threading's start(), whose wait for the new thread would
        # hold this thread where it wakes once the park is armed.
        _thread.start_new_thread(runner, ())
        spins = 0
        # No call in this loop: once the park is armed, this thread's
        # next call is the one to stop().
        while (client._window is None or client._window.state != "parking"
               ) and spins < 10**9:
            spins += 1
        client.stop()
        took = time.time() - t0
        finished = ran.acquire(timeout=30)
    finally:
        release.set()
        blocked.join(timeout=30)
    assert finished and took < 5
    assert [c for c in client.profiler.calls if c[0] == "start"] == []
    manifest = json.loads((tmp_path / f"s_{os.getpid()}.json").read_text())
    assert manifest["status"] == "error" and "client stopped" in manifest[
        "error"], manifest
    assert client._window is None and _tools_clean()


@pytest.mark.parametrize("taken", [(), (3,), (3, 4)])
def test_sys_monitoring_is_left_as_found(taken):
    """After every start, and after stop(), the event park's tool id is
    free again with no event on, and a tool id another tool holds is
    left to it (with none free, the start goes ahead unparked, naming
    the threads it could not hold)."""
    for tool in taken:
        sys.monitoring.use_tool_id(tool, "another tool")
    counter, stop = [0], threading.Event()
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=_Counted(counter), report_interval_s=0)
    app = threading.Thread(target=_spinning, args=(stop, counter),
                           name="app")
    app.start()
    try:
        timings = []
        for _ in range(2):
            error, window = client._capture_window(
                TraceConfig(duration_ms=10), "unused")
            assert error is None
            timings.append(window.timing)
            for tool in shim.EVENT_PARK_TOOL_IDS:
                assert sys.monitoring.get_events(tool) == 0
                assert sys.monitoring.get_tool(tool) == (
                    "another tool" if tool in taken else None)
        stop.set()
        app.join(timeout=30)
        client.stop()
        for tool in shim.EVENT_PARK_TOOL_IDS:
            assert sys.monitoring.get_events(tool) == 0
            assert sys.monitoring.get_tool(tool) == (
                "another tool" if tool in taken else None)
        held = len(taken) < len(shim.EVENT_PARK_TOOL_IDS)
        for timing in timings:
            assert timing["parked"] is held, timing
            assert timing.get("unparked", ["app"]) == ["app"]
    finally:
        stop.set()
        app.join(timeout=30)
        for tool in taken:
            sys.monitoring.free_tool_id(tool)


def test_duration_capture_keeps_the_app_threads_frames(tmp_path):
    """A duration capture of an app that never steps, at
    PROFILE_PYTHON_TRACER_LEVEL=1 (torch's Python tracer installs its own
    profile function on every thread at the start, while the event park
    holds the app): the trace holds the app thread's frames, none of the
    park's (trace.PARK_FRAME, the park's callback), and no call of the
    app's loop body outlasts the window (torch's tracer never sees the
    park's frame return; the finish mends the frames below it)."""
    assert shim._EventPark._hold_at_python_event.__name__ == trace.PARK_FRAME
    a = torch.randn(32, 32)

    def body():
        torch.relu(a @ a)

    counter, stop = [0], threading.Event()
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    app = threading.Thread(target=_spinning, args=(stop, counter, body))
    app.start()
    try:
        for i in range(2):  # the first start is the process's slowest
            client._run_trace(TraceConfig.parse(
                f"ACTIVITIES_LOG_FILE={tmp_path}/f{i}.json\n"
                "ACTIVITIES_DURATION_MSECS=300\n"
                "PROFILE_PYTHON_TRACER_LEVEL=1"))
    finally:
        stop.set()
        app.join(timeout=30)
        client.stop()
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    assert manifest["timing"]["park"] == "event"
    events = json.loads(open(manifest["trace_file"]).read())["traceEvents"]
    frames = [e for e in events if e.get("cat") == "python_function"
              and e.get("tid") == app.native_id]
    assert not [e for e in events
                if trace.PARK_FRAME in e.get("name", "")]
    bodies = [e for e in frames if e["name"].endswith(": body")]
    assert bodies and any(e["name"].endswith(": _spinning") for e in frames)
    window_us = manifest["timing"]["window_ms"] * 1000
    assert max(e["dur"] for e in bodies) < window_us / 2, bodies[:3]


def test_finish_drops_the_park_frame_and_mends_the_frames_below():
    """trace._unpark_frames on the frames torch's Python tracer records
    for a thread held in the park's callback while it started: the
    park's frame goes, each frame below it ends where the tracer ended
    the one above it, and the park's children move to its caller;
    another thread's frames are left alone."""
    def frame(tid, pid_, fid, name, ts, dur):
        return {"ph": "X", "cat": "python_function", "pid": 1, "tid": tid,
                "name": name, "ts": ts, "dur": dur,
                "args": {"Python id": fid, "Python parent id": pid_}}

    park = f"dynolog_tpu_torch/client/shim.py(1): {trace.PARK_FRAME}"
    events = [
        frame(5, None, 1, "app.py(1): main", 0.0, 1000.0),
        frame(5, 1, 2, "app.py(9): loop", 0.0, 1000.0),
        frame(5, 2, 3, "app.py(20): work", 0.0, 900.0),
        frame(5, 3, 4, park, 0.0, 30.0),
        frame(5, 4, 5, "app.py(30): inner", 10.0, 5.0),
        frame(6, None, 4, "other.py(1): run", 0.0, 1000.0),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 5, "ts": 12.0, "dur": 1.0},
    ]
    got = trace._unpark_frames(events)
    by = {(e["tid"], e["name"]): e for e in got}
    assert (5, park) not in by and len(got) == len(events) - 1
    assert by[(5, "app.py(20): work")]["dur"] == 30.0
    assert by[(5, "app.py(9): loop")]["dur"] == 900.0
    assert by[(5, "app.py(1): main")]["dur"] == 1000.0
    assert by[(5, "app.py(30): inner")]["args"]["Python parent id"] == 3
    assert by[(6, "other.py(1): run")]["dur"] == 1000.0
    assert trace._unpark_frames(got) == got


def test_stepless_capture_against_the_jax_client(tmp_path):
    """Beside tests/test_torch_shim.py's
    test_duration_capture_of_an_app_that_never_steps: the same duration
    capture of an app thread that never calls step(), through both
    clients. Both manifests are ok in duration mode; the port's start
    held the app at its next Python event (parked, park "event") and its
    trace holds the app's aten::mm ops inside the window."""
    stop, counter = threading.Event(), [0]
    a = torch.randn(64, 64)
    app = threading.Thread(target=_spinning, args=(
        stop, counter, lambda: torch.relu(a @ a)))
    app.start()
    text = "ACTIVITIES_LOG_FILE={}\nACTIVITIES_DURATION_MSECS=300"
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_threads_nodaemon",
        profiler=jax_shim.RecordingProfiler(), report_interval_s=0)
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    try:
        jax_client._run_trace(JaxTraceConfig.parse(
            text.format(tmp_path / "jax.json")))
        client._run_trace(TraceConfig.parse(
            text.format(tmp_path / "port.json")))
    finally:
        stop.set()
        app.join(timeout=30)
        jax_client.stop()
        client.stop()
    pid = os.getpid()
    ref = json.loads((tmp_path / f"jax_{pid}.json").read_text())
    ours = json.loads((tmp_path / f"port_{pid}.json").read_text())
    assert ref["status"] == ours["status"] == "ok", (ref, ours)
    assert ref["mode"] == ours["mode"] == "duration"
    assert ours["timing"]["parked"] is True
    assert ours["timing"]["park"] == "event"
    doc = json.loads(open(ours["trace_file"]).read())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    assert [e for e in doc["traceEvents"]
            if e.get("cat") == "cpu_op" and e.get("name") == "aten::mm"
            and e.get("tid") == app.native_id
            and e["ts"] + base_us >= ours["started_ms"] * 1e3]
