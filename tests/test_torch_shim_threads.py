"""Which thread opens each of the port shim's captures, with which profiler
configuration, and the lead a duration window records before its window
(dynolog_tpu_torch.client.shim, ROADMAP C15 and C17).

Every capture a process takes — the warmup, duration windows, ring
samples, iteration windows — starts torch.profiler with
profile_all_threads and no schedule, and opens and closes on the poll
thread, as the JAX client's do: a process whose iteration windows the
training thread opened lost every kernel record on the card once
duration windows came between them. An iteration window opens one step
early, while the training thread is parked at that step(), and closes
while it is parked at the window's last step(). A duration window's and
the warmup's profiler start once the training thread has parked at its
next step() (at once before the app's first step()), and a start that
goes ahead without a park says so in its timing. A duration
window opens its window DURATION_LEAD_S after its profiler's start
returned, and a synchronized start starts the profiler early enough for
the window to open at the start time; the finish trims the lead. Held
against the JAX client's duration windows where it has one."""

import json
import os
import threading
import time

import pytest
import torch

from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu.client.shim import TraceConfig as JaxTraceConfig
from dynolog_tpu_torch import failpoints, trace
from dynolog_tpu_torch.client import shim
from dynolog_tpu_torch.client.shim import (
    RingConfig, TorchProfiler, TraceClient, TraceConfig)


class _ConfigsIpc:
    """IpcClient double: a live daemon that hands the poll loop one of
    `texts` per request after start()'s own."""

    def __init__(self, texts: list):
        self.texts = list(texts)
        self.requests = 0

    def register_context(self, *a, **kw):
        return 0

    def request_config(self, *a, **kw):
        self.requests += 1
        if self.requests < 2 or not self.texts:
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
    client._client = _ConfigsIpc([
        f"ACTIVITIES_LOG_FILE={tmp_path}/d.json\n"
        "ACTIVITIES_DURATION_MSECS=50",
        f"ACTIVITIES_LOG_FILE={tmp_path}/i.json\nACTIVITIES_ITERATIONS=2"])
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
    # The warmup too waits for the app's first step() and starts there.
    assert all(row["at_start"] == "opening" for row in sessions.rows), (
        sessions.rows)
    assert [row["at_stop"] for row in sessions.rows].count("closing") == 1
    assert client.warmup_timing["parked"] is True
    for m in manifests:
        assert json.loads(m.read_text())["timing"]["parked"] is True


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


@pytest.mark.parametrize("case", ["warmup_before_any_step",
                                  "duration_after_a_pause"])
def test_start_without_a_park_says_so(case, monkeypatch):
    """A start that goes ahead without the training thread parked — the
    warmup of an app that did not step within WARMUP_PARK_WAIT_S, a
    duration capture of an app that stepped, then did not step within
    step_start_timeout_s — records parked false in its timing."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         report_interval_s=0, step_start_timeout_s=0.3)
    monkeypatch.setattr(shim, "WARMUP_PARK_WAIT_S", 0.2)
    try:
        if case == "warmup_before_any_step":
            t0 = time.time()
            client._warmup()
            assert time.time() - t0 >= 0.2
            assert client.warmup_timing["parked"] is False
        else:
            client.step()
            client.step()  # then no step for longer than the wait
            error, window = client._capture_window(
                TraceConfig(duration_ms=20), "unused")
            assert error is None
            assert window.timing["parked"] is False
    finally:
        client.stop()


def test_warmup_parks_at_the_apps_first_step():
    """The warmup waits for the app's first step(), drains the card and
    starts its profiler with the app parked there, and stops it before
    the app goes on (C18), then saves it, once: the calls the JAX
    client's warmup makes (one start and one stop before its first
    poll), which starts at once."""
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
    assert seen == [("opening", 1), ("opening", 1)]
    assert client.warmup_timing["parked"] is True
    assert client.warmup_timing["lost_launches"] == 0
    assert [c[0] for c in jax_client.profiler.calls] == ["start", "stop"]
    assert [c[0] for c in client.profiler.calls] == [
        "drain", "start", "stop", "export"]
    assert client.profiler.calls[0] == ("drain", 3)
    assert client._window is None


def test_stop_during_the_warmups_park_wait_starts_nothing():
    """stop() while the warmup waits for the app's first step(): no
    profiler starts, warmup_done is set, and no window is left."""
    client = TraceClient(job_id=7, endpoint="dynotpu_threads_nodaemon",
                         profiler=shim.RecordingProfiler(),
                         warmup_profiler=True, report_interval_s=0)
    client._client = _ConfigsIpc([])
    poll = threading.Thread(target=client._poll_loop)
    poll.start()
    deadline = time.time() + 30
    while client._window is None and time.time() < deadline:
        time.sleep(0.005)
    assert client._window.state == "armed"
    client.stop()
    poll.join(timeout=30)
    assert not poll.is_alive()
    assert client.profiler.calls == []
    assert client.warmup_done.is_set() and client.warmup_timing == {}
    assert client._window is None


def test_poll_loop_captures_count_their_lost_launches(tmp_path):
    """The client as an application starts it — client.start(), the
    warmup and the ring on, the app training at once without waiting on
    warmup_done — with duration and iteration captures arriving through
    the daemon: every manifest is ok with lost_launches 0 (no card, no
    launch) and parked true, every ring sample's timing has
    lost_launches 0, and the warmup parked at the app's first step()."""
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
