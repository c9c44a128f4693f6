"""The port shim's pipelined capture finish (dynolog_tpu_torch.client.shim
PendingWrite, trace.finish_trace) and an iteration window's lead step.

The first three tests mirror the JAX package's
tests/test_stream_pipeline.py (the artifact and ok manifest with write_ms
and write_bytes, a failed write failing the capture loudly, stop()
joining the finisher) with a profiler whose save hands over the port's
PendingWrite. The rest drive a real TorchProfiler through the
TraceClient's poll thread: the finish runs in the child (json.load and
the promotion raise in this process), its trace equals the in-process
rewrite the shim did before the pipeline, a failed spawn finishes
in-process, and an iteration window that records from one step early is
trimmed to its own steps; the window's steps are held against the JAX
client's choice."""

import gc
import json
import os
import re
import shutil
import threading
import time
import weakref

import pytest
import torch

from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu_torch import failpoints, trace
from dynolog_tpu_torch.client import shim
from dynolog_tpu_torch.client.shim import (
    PendingWrite, RingConfig, TorchProfiler, TraceClient, TraceConfig)


def _wait_until(cond, timeout_s: float = 30.0) -> bool:
    deadline = time.time() + timeout_s
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def _kineto(n_kernels: int = 3) -> dict:
    events = [{"ph": "X", "cat": "kernel", "name": f"void k{i}(float*)",
               "pid": 0, "tid": 7, "ts": 10.0 * i, "dur": 5.0,
               "args": {"device": 0}} for i in range(n_kernels)]
    return {"schemaVersion": 1, "traceEvents": events,
            "baseTimeNanoseconds": time.time_ns() // 10**9 * 10**9}


class FakeFinishingProfiler:
    """A profiler whose save writes a hand-made kineto trace (unreadable
    with `broken`) and hands over the port's PendingWrite to finish it,
    as TorchProfiler.export(pipelined=True) does."""

    def __init__(self, broken: bool = False):
        self.broken = broken
        self._pending = None

    def start(self, trace_dir, lead=False):
        self._clock = shim._StepClock(at_step=False)

    def open_window(self, at_ns):
        pass

    def step(self):
        self._clock.mark()

    def stop(self):
        self._clock.close()

    def export(self, trace_dir, pipelined=False, profile_top=None):
        path = os.path.join(trace_dir, "run" + shim.TRACE_SUFFIX)
        raw, _, tmp = shim._finish_files(path)
        with open(raw, "w") as f:
            f.write("{torn" if self.broken else json.dumps(_kineto()))
        self._pending = PendingWrite(
            {"raw": raw, "out": tmp, "steps": self._clock.spec()}, path)
        return path

    def take_pending_write(self):
        pending, self._pending = self._pending, None
        return pending


def _run_capture(tmp_path, profiler):
    client = TraceClient(job_id=1, endpoint=f"dynotpu_pipe_test_{os.getpid()}",
                         profiler=profiler, report_interval_s=0)
    cfg = TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path}/t.json\n"
                            "ACTIVITIES_DURATION_MSECS=10")
    client._run_trace(cfg, pipelined=True)
    return client, cfg


def test_shim_pipelined_capture_writes_artifact_and_manifest(tmp_path):
    client, cfg = _run_capture(tmp_path, FakeFinishingProfiler())
    manifest_path = cfg.manifest_path(os.getpid())
    try:
        # The finisher owns the manifest: it lands, with the finish's
        # timing folded in, once the child has written the trace.
        assert _wait_until(lambda: os.path.exists(manifest_path))
        manifest = json.loads(open(manifest_path).read())
        assert manifest["status"] == "ok", manifest
        trace_file = manifest["trace_file"]
        assert manifest["timing"]["write_bytes"] == os.path.getsize(
            trace_file) == manifest["timing"]["trace_bytes"]
        assert manifest["timing"]["write_ms"] >= 0
        doc = json.loads(open(trace_file).read())
        assert [e["cat"] for e in doc["traceEvents"]] == ["kernel"] * 3
        assert client.traces_completed == 1
        assert os.listdir(cfg.trace_dir(os.getpid())) == [
            os.path.basename(trace_file)]  # no tmp left behind
    finally:
        client.stop()


def test_shim_pipelined_write_failure_fails_capture_loudly(tmp_path):
    """The finish child fails (kineto's save is unreadable): the manifest
    records the error and no trace or tmp debris survives."""
    client, cfg = _run_capture(tmp_path, FakeFinishingProfiler(broken=True))
    manifest_path = cfg.manifest_path(os.getpid())
    try:
        assert _wait_until(lambda: os.path.exists(manifest_path))
        manifest = json.loads(open(manifest_path).read())
        assert manifest["status"] == "error"
        assert "trace finish failed" in manifest["error"], manifest
        assert client.traces_completed == 0
        assert client.last_error
        assert os.listdir(cfg.trace_dir(os.getpid())) == []
    finally:
        client.stop()


def test_shim_stop_joins_inflight_finisher(tmp_path):
    """TraceClient.stop() does not strand a pipelined finish: after stop()
    returns, the capture's manifest exists."""
    client, cfg = _run_capture(tmp_path, FakeFinishingProfiler())
    assert client._finishers and client._finishers[0].is_alive()
    client.stop()
    manifest_path = cfg.manifest_path(os.getpid())
    assert os.path.exists(manifest_path)
    assert json.loads(open(manifest_path).read())["status"] == "ok"


# -- a real TorchProfiler through the poll thread ---------------------------


class _ConfigOnceIpc:
    """IpcClient double: a live daemon that hands `text` to the poll
    loop's first request (start()'s own request gets nothing)."""

    def __init__(self, text: str = ""):
        self.text = text
        self.requests = 0

    def register_context(self, *a, **kw):
        return 0

    def request_config(self, *a, **kw):
        self.requests += 1
        if self.requests < 2:
            return ""
        text, self.text = self.text, ""
        return text

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


def _serve(tmp_path, text: str, profiler=None, work=None, done=None,
           **kw) -> TraceClient:
    """Starts a TraceClient whose poll thread receives `text` (a config,
    or "" for none), then trains on this thread (`work`, then step())
    until `done(client)`; returns the stopped client."""
    client = TraceClient(job_id=7, endpoint=f"pipe_test_{os.getpid()}",
                         poll_interval_s=0.02, report_interval_s=0,
                         profiler=profiler or TorchProfiler(), **kw)
    client._client = _ConfigOnceIpc(text)
    a = torch.randn(32, 32)
    work = work or (lambda c: (a @ a).sum())
    done = done or (lambda c: c.last_manifest is not None)
    client.start()
    try:
        deadline = time.time() + 60
        while not done(client) and time.time() < deadline:
            work(client)
            client.step()
            time.sleep(0.002)
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=60)
    return client


def _no_parse_here(monkeypatch):
    """Makes every parse of a trace raise in this process."""
    def refuse(*a, **kw):
        raise AssertionError("a trace was parsed in the traced process")

    monkeypatch.setattr(json, "load", refuse)
    monkeypatch.setattr(trace, "compact_profile", refuse)
    monkeypatch.setattr(trace, "finish_trace", refuse)


def test_duration_capture_finishes_in_the_child(tmp_path, monkeypatch):
    _no_parse_here(monkeypatch)
    client = _serve(tmp_path, f"ACTIVITIES_LOG_FILE={tmp_path}/d.json\n"
                    "ACTIVITIES_DURATION_MSECS=100")
    monkeypatch.undo()
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    timing = manifest["timing"]
    assert timing["write_bytes"] == os.path.getsize(manifest["trace_file"])
    assert {"profiler_stop_ms", "export_ms", "write_ms"} <= set(timing)
    summary = trace.summarize(manifest["trace_file"])
    assert summary["steps"]["count"] >= 2
    assert any(o["op"] == "aten::mm" for o in summary["top_ops"])


def test_ring_sample_promotes_in_the_child(tmp_path, monkeypatch):
    _no_parse_here(monkeypatch)
    client = _serve(tmp_path, "", ring=RingConfig(
        every_n_steps=5, keep=2, window_ms=30, dir=str(tmp_path / "ring"),
        model="m", min_interval_s=0.0, top_ops=100_000),
        done=lambda c: c.ring.captures > 0)
    monkeypatch.undo()
    assert client.ring.captures >= 1, client.ring.last_error
    doc = json.loads(open(client.ring.entries()[-1]).read())
    assert doc["kind"] == "dynolog_tpu.ring_profile" and doc["model"] == "m"
    assert any(o["op"] == "aten::mm" for o in doc["summary"]["top_ops"])
    timing = client.ring.last_timing
    assert {"take_ms", "promote_ms", "write_ms", "write_bytes"} <= set(timing)
    assert timing["trace_bytes"] == doc["summary"]["trace_bytes"] == timing[
        "write_bytes"]
    assert client.traces_completed == 0


def _seed_write_steps(path: str, clock, drop_host: bool) -> None:
    """The shim's in-process rewrite before the finish child took it
    over, verbatim: the reference the child's output is held to."""
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
        if drop_host:
            doc["traceEvents"] = [e for e in doc["traceEvents"]
                                  if e.get("cat") not in (
                                      "cpu_op", "fwdbwd", "user_annotation",
                                      "gpu_user_annotation")]
    else:
        doc = {"schemaVersion": 1, "traceEvents": [],
               "displayTimeUnit": "ms",
               "baseTimeNanoseconds": clock.times[0] // 10**9 * 10**9}
    doc["traceEvents"].extend(clock.events(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        f.write(json.dumps(doc))


class KeepingProfiler(TorchProfiler):
    """Keeps a copy of kineto's save, the capture's step clock and the
    epoch ns its window opened at (None where it opened at its start)."""

    def __init__(self, keep: str):
        super().__init__()
        self.keep = keep

    def export(self, trace_dir, pipelined=False, profile_top=None):
        save = self._stopped.export_chrome_trace

        def kept(path):
            save(path)
            shutil.copy(path, self.keep)

        self._stopped.export_chrome_trace = kept
        self.clock = self._clock
        self.opened_ns = self._opens_ns if self._lead else None
        return super().export(trace_dir, pipelined, profile_top)


def _trim_kept(path: str, opened_ns) -> None:
    """Trims a kept kineto save to its window as the finish does (after
    taking out the event park's frame, where the app was held at a
    Python event), so that the rewrite before the finish child, which
    knew no lead, can be held to the finished trace."""
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] = trace._trim_lead(
        trace._unpark_frames(doc["traceEvents"]),
        (opened_ns - doc["baseTimeNanoseconds"]) / 1e3)
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("host", [2, 0])
def test_finished_trace_equals_the_in_process_rewrite(tmp_path, host):
    keep = str(tmp_path / "kineto.json")
    prof = KeepingProfiler(keep)
    client = _serve(tmp_path, f"ACTIVITIES_LOG_FILE={tmp_path}/e.json\n"
                    "ACTIVITIES_DURATION_MSECS=60\n"
                    f"PROFILE_HOST_TRACER_LEVEL={host}", profiler=prof)
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    finished = json.loads(open(manifest["trace_file"]).read())
    assert prof.opened_ns is not None  # a duration window has a lead
    _trim_kept(keep, prof.opened_ns)
    shutil.copy(keep, keep + ".2")
    _seed_write_steps(keep, prof.clock, drop_host=host == 0)
    shim._write_steps(keep + ".2", prof.clock, drop_host=host == 0)
    assert finished == json.loads(open(keep).read())
    assert finished == json.loads(open(keep + ".2").read())
    cats = {e.get("cat") for e in finished["traceEvents"]}
    assert ("cpu_op" in cats) == (host > 0)
    assert sum(e.get("args") == {"source": "shim"}
               for e in finished["traceEvents"]) >= 2


def test_failed_spawn_finishes_in_process(tmp_path):
    failpoints.arm("shim.finish_spawn", "error*1")
    try:
        client = _serve(tmp_path, f"ACTIVITIES_LOG_FILE={tmp_path}/f.json\n"
                        "ACTIVITIES_DURATION_MSECS=60")
    finally:
        failpoints.disarm("shim.finish_spawn")
    assert failpoints.hits("shim.finish_spawn") >= 1
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    assert manifest["timing"]["write_bytes"] == os.path.getsize(
        manifest["trace_file"])
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] >= 2
    assert not [n for n in os.listdir(os.path.dirname(manifest["trace_file"]))
                if n.endswith(".tmp")]


# -- the lead step ---------------------------------------------------------


def test_iteration_window_trims_its_lead_step(tmp_path):
    """The profiler opens one step() before the window: the lead step's
    own op (a sigmoid, run nowhere else) is recorded, then trimmed, and
    the trace holds the window's 3 steps, torch's spans numbered from 0
    as without a lead."""
    b = torch.randn(32, 32)
    lead_ran = []

    def work(client):
        w = client._window
        if w is not None and client._step_count == w.start_at - 1:
            lead_ran.append(w.state)
            torch.sigmoid(b)
        (b @ b).sum()

    client = _serve(tmp_path, f"ACTIVITIES_LOG_FILE={tmp_path}/l.json\n"
                    "ACTIVITIES_ITERATIONS=3", work=work)
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    assert lead_ran == ["active"]  # recorded, in the profiler's lead step
    assert "write_ms" in manifest["timing"]
    events = json.loads(open(manifest["trace_file"]).read())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert "aten::mm" in names and "aten::sigmoid" not in names
    spans = sorted(e["name"] for e in events if e.get("cat") ==
                   "user_annotation" and e["name"].startswith("ProfilerStep"))
    assert spans == [f"{trace.STEP_PREFIX}{n}" for n in range(4)]
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] == 3


def test_iteration_window_records_its_lead(tmp_path):
    """An iteration window's manifest says how long its lead step was,
    from its profiler's start returning to the step() that opens the
    window (lead_ms): a start loses the records of launches made just
    after it (C15), and the lead is what keeps them out of the window."""
    seen = {}

    class Seen(TorchProfiler):
        def start(self, trace_dir, lead=False):
            super().start(trace_dir, lead)
            seen["returned"] = time.monotonic()

        def step(self):
            seen.setdefault("first", time.monotonic())
            super().step()

    client = _serve(tmp_path, f"ACTIVITIES_LOG_FILE={tmp_path}/h.json\n"
                    "ACTIVITIES_ITERATIONS=2", profiler=Seen())
    manifest = client.last_manifest
    assert manifest["status"] == "ok", manifest
    assert 0 <= manifest["timing"]["lead_ms"] <= (
        seen["first"] - seen["returned"]) * 1000
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] == 2


@pytest.mark.parametrize("saved", ["in_process", "pipelined", "unsaved"])
def test_stopped_session_is_freed_without_the_cyclic_gc(tmp_path, saved):
    """A stopped torch.profiler.profile holds bound methods of itself
    (its action_map), a reference cycle: left alone, its results (the
    autograd profiler, which holds kineto's) live on until a cyclic
    collection frees them, on whichever thread's allocation sets it off,
    possibly the app's inside a later capture's window (ROADMAP C22).
    With the GC off, the session and its autograd profiler are gone once
    export() returns, pipelined or not, or, where a session was stopped
    and never saved, once the next one stops; the saved trace keeps its
    steps."""
    a = torch.randn(32, 32)
    prof = TorchProfiler()

    def session():
        prof.start(str(tmp_path))
        for _ in range(2):
            (a @ a).sum()
            prof.step()
        prof.stop()
        return weakref.ref(prof._stopped), weakref.ref(prof._stopped.profiler)

    def alive(refs) -> list:
        # Not in the assert, whose rewrite would keep what r() returns.
        return [r() is not None for r in refs]

    # A process's first start sets torch up, and what that keeps (a
    # warning's frames, under pytest) may hold the session: not checked.
    session()
    prof.export(str(tmp_path))
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        refs = session()
        assert alive(refs) == [True, True]
        if saved == "unsaved":
            later = session()
        else:
            path = prof.export(str(tmp_path), pipelined=saved == "pipelined")
        assert alive(refs) == [False, False]
        if saved == "unsaved":
            assert alive(later) == [True, True]
            path = prof.export(str(tmp_path))
            assert alive(later) == [False, False]
    finally:
        if enabled:
            gc.enable()
    if saved == "pipelined":
        assert prof.take_pending_write().wait()["lost_launches"] == 0
    assert trace.summarize(path)["steps"]["count"] == 2


def _jax_start_at(base: int, roundup: int) -> int:
    """The step at which the JAX client's iteration window begins when it
    is armed at step `base`, read from its start timeout."""
    client = jax_shim.TraceClient(
        job_id=1, endpoint="dynotpu_pipe_nodaemon",
        profiler=jax_shim.RecordingProfiler(), step_start_timeout_s=0.05)
    client._step_count, client._timing = base, {}
    error = client._capture_window(TraceConfig(
        iterations=2, iteration_roundup=roundup), "unused")
    return int(re.search(r"did not reach step (\d+)", error).group(1))


@pytest.mark.parametrize("base,roundup", [(4, 1), (4, 3), (4, 4), (5, 3)])
def test_lead_window_steps_against_the_jax_client(tmp_path, base, roundup):
    """The port's window is the JAX client's, opened one step() early,
    where that step is still to come; where it has passed (always at
    roundup 1), the window moves to the next roundup boundary."""
    jax_start = _jax_start_at(base, roundup)
    opened, marks = [], []

    class Seen(TorchProfiler):
        def start(self, trace_dir, lead=False):
            opened.append((client._step_count, lead))
            super().start(trace_dir, lead)

        def step(self):
            marks.append(client._step_count)
            super().step()

        def stop(self):
            marks.append(("stop", client._step_count))
            super().stop()

    client = TraceClient(job_id=7, endpoint="dynotpu_pipe_nodaemon",
                         profiler=Seen(), report_interval_s=0)
    for _ in range(base):
        client.step()
    got = {}
    cfg = TraceConfig(iterations=2, iteration_roundup=roundup)
    runner = threading.Thread(target=lambda: got.update(
        r=client._capture_window(cfg, str(tmp_path))))
    runner.start()
    assert _wait_until(lambda: client._window is not None, 10)
    while runner.is_alive():
        client.step()
        time.sleep(0.001)
    runner.join(timeout=30)
    error, window = got["r"]
    assert error is None
    want = jax_start if jax_start - 1 > base else jax_start + roundup
    assert (window.start_at, window.end_at) == (want, want + 2)
    assert opened == [(want - 1, True)]
    # Its edges are the JAX window's steps: it opens at step() number
    # start_at and stops at end_at, and the finished trace holds its two
    # steps and the stop's span, from the window's opening on.
    assert marks == [want, want + 1, want + 2, ("stop", want + 2)]
    opens_ns = client.profiler._opens_ns
    assert opens_ns == client.profiler._clock.times[0]
    doc = json.loads(open(client.profiler.export(str(tmp_path))).read())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    spans = sorted((e for e in doc["traceEvents"]
                    if e.get("name", "").startswith(trace.STEP_PREFIX)),
                   key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == [
        f"{trace.STEP_PREFIX}{n}" for n in range(3)]
    assert spans[0]["ts"] + base_us == pytest.approx(opens_ns / 1e3, abs=1)
    assert min(e["ts"] for e in doc["traceEvents"] if e.get("ph") == "X"
               ) + base_us >= opens_ns / 1e3 - 1


def _hand_written_lead_trace() -> dict:
    """A kineto trace of a window recorded from one step early: step
    spans #0 (the lead, ts 0-100), #1 and #2 (the window) and the stop's
    #3; a launch in each step (correlation 1, 2, 3) whose kernel runs
    later on the card (the lead's past the window's start), their ac2g
    flows, a kernel with no launch before the window (9) and one after
    it (10), a frame that straddles the window's start, and metadata."""
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}}]
    for n, ts in enumerate((0.0, 100.0, 200.0, 300.0)):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"ProfilerStep#{n}", "pid": 1, "tid": 1,
                       "ts": ts, "dur": 100.0 if n < 3 else 1.0})
    for corr, ts in ((1, 50.0), (2, 150.0), (3, 250.0)):
        events += [
            {"ph": "X", "cat": "cpu_op", "name": f"aten::op{corr}",
             "pid": 1, "tid": 1, "ts": ts - 5, "dur": 20.0,
             "args": {"External id": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": ts, "dur": 5.0,
             "args": {"correlation": corr, "External id": corr}},
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr,
             "pid": 1, "tid": 1, "ts": ts},
            {"ph": "X", "cat": "kernel", "name": f"void k{corr}(float*)",
             "pid": 0, "tid": 7, "ts": ts + 70, "dur": 20.0,
             "args": {"device": 0, "correlation": corr}},
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": corr,
             "pid": 0, "tid": 7, "ts": ts + 70, "bp": "e"}]
    events += [
        {"ph": "X", "cat": "kernel", "name": "void k9(float*)", "pid": 0,
         "tid": 7, "ts": 20.0, "dur": 5.0,
         "args": {"device": 0, "correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "void k10(float*)", "pid": 0,
         "tid": 7, "ts": 210.0, "dur": 5.0,
         "args": {"device": 0, "correlation": 10}},
        {"ph": "X", "cat": "python_function", "name": "train.py(1): loop",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 301.0}]
    return {"schemaVersion": 1, "traceEvents": events,
            "baseTimeNanoseconds": 10**18}


@pytest.mark.parametrize("host_spans", [True, False])
def test_finish_drops_the_lead_steps_device_records(tmp_path, host_spans):
    """On a hand-written kineto trace: the lead step's launch, its flows
    and its kernel (which ran after the window began) go, as does a
    kernel with no launch that started before it; the window's steps
    hold exactly its own kernels. The window opens at torch's
    ProfilerStep#1 where the trace has one, else at `lead_ns`."""
    doc = _hand_written_lead_trace()
    if not host_spans:
        doc["traceEvents"] = [e for e in doc["traceEvents"]
                              if e.get("cat") != "user_annotation"]
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(doc))
    out = tmp_path / "out.json"
    got = trace.finish_trace(str(raw), str(out), lead_ns=10**18 + 100_000)
    assert got == {"write_bytes": out.stat().st_size, "lost_launches": 0}
    events = json.loads(out.read_text())["traceEvents"]
    kernels = sorted(e["args"]["correlation"] for e in events
                     if e.get("cat") == "kernel")
    assert kernels == [2, 3, 10]
    assert sorted(e["args"]["correlation"] for e in events
                  if e.get("cat") == "cuda_runtime") == [2, 3]
    assert sorted(e["id"] for e in events if e.get("cat") == "ac2g") == [
        2, 2, 3, 3]
    assert sorted(e["name"] for e in events if e.get("cat") == "cpu_op") == [
        "aten::op2", "aten::op3"]
    [frame] = [e for e in events if e.get("cat") == "python_function"]
    assert (frame["ts"], frame["dur"]) == (100.0, 201.0)
    assert any(e.get("ph") == "M" for e in events)
    if host_spans:
        assert sorted(e["name"] for e in events
                      if e.get("cat") == "user_annotation") == [
            "ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
        planes = trace.summarize_trace_events(events)
        assert planes[0].name == "/device:GPU:0"
        assert len(planes[0].step_durations_ps) == 2


def test_iteration_window_without_lead_gains_only_the_step_spans(tmp_path):
    """An iteration window without a lead step at host level 2 was final
    as kineto saved it while torch wrote its ProfilerStep#N spans. Every
    capture now records all threads with no schedule (C17), so the finish
    adds the shim's spans to this one too: it hands over a PendingWrite,
    and the finished trace holds one span per step() and nothing else
    that kineto did not save."""
    a = torch.randn(16, 16)
    prof = KeepingProfiler(str(tmp_path / "kineto.json"))
    prof.start(str(tmp_path))
    (a @ a).sum()
    prof.step()
    prof.stop()
    path = prof.export(str(tmp_path), pipelined=True)
    pending = prof.take_pending_write()
    assert "write_error" not in pending.wait()
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path), "kineto.json"])
    saved = json.loads((tmp_path / "kineto.json").read_text())
    finished = json.loads(open(path).read())
    spans = prof.clock.events(saved["baseTimeNanoseconds"])
    assert [e["name"] for e in spans] == [
        f"{trace.STEP_PREFIX}0", f"{trace.STEP_PREFIX}1"]
    assert finished["traceEvents"] == saved["traceEvents"] + spans


# -- launches whose kernel records a capture lost ---------------------------

_BASE_NS = 10**18
_LEAD_NS = _BASE_NS + 100_000  # the window opens at ts 100
_STOP_NS = _BASE_NS + 350_000  # the profiler's stop began at ts 350


def _planted_trace() -> dict:
    """_hand_written_lead_trace with launches planted that have no device
    record (correlation 20-25): in the lead (cudaLaunchKernel at ts 50),
    in the window (cudaLaunchKernel at 160, cuLaunchKernel at 170), after
    the stop began (cudaLaunchKernel at 400), and two in the window that
    launch no kernel (cudaStreamSynchronize, and a cudaMemcpyAsync whose
    gpu_memcpy record is there). Two launches of the window lost their
    records."""
    doc = _hand_written_lead_trace()
    for corr, cat, name, ts in (
            (20, "cuda_runtime", "cudaLaunchKernel", 50.0),
            (21, "cuda_runtime", "cudaLaunchKernel", 160.0),
            (22, "cuda_driver", "cuLaunchKernel", 170.0),
            (23, "cuda_runtime", "cudaLaunchKernel", 400.0),
            (24, "cuda_runtime", "cudaStreamSynchronize", 180.0),
            (25, "cuda_runtime", "cudaMemcpyAsync", 190.0)):
        doc["traceEvents"].append(
            {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
             "ts": ts, "dur": 2.0, "args": {"correlation": corr}})
    doc["traceEvents"].append(
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": 195.0, "dur": 3.0,
         "args": {"device": 0, "correlation": 25}})
    return doc


def test_finish_counts_the_windows_lost_launches(tmp_path):
    """finish_trace counts the launches of the window, made before the
    stop began, that have no device record: the two planted in the
    window, not the one in the (trimmed) lead, the one after the stop,
    the matched ones or the calls that launch no kernel. Without a stop
    time every unmatched launch left in the window counts."""
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(_planted_trace()))
    out = tmp_path / "out.json"
    got = trace.finish_trace(str(raw), str(out), lead_ns=_LEAD_NS,
                             stop_ns=_STOP_NS)
    assert got == {"write_bytes": out.stat().st_size, "lost_launches": 2}
    events = json.loads(out.read_text())["traceEvents"]
    assert [t * 1e6 - _BASE_NS / 1e3 for t in trace.unmatched_launches(
        events, _BASE_NS, _STOP_NS)] == pytest.approx([160.0, 170.0])
    assert trace.finish_trace(str(raw), str(out), lead_ns=_LEAD_NS)[
        "lost_launches"] == 3
    assert trace.finish_trace(str(raw), str(out))["lost_launches"] == 4
    # A capture that did not record the device lost nothing.
    assert trace.finish_trace(str(raw), str(out), lead_ns=_LEAD_NS,
                              stop_ns=_STOP_NS, device=False)[
        "lost_launches"] is None
    raw.write_text(json.dumps(_hand_written_lead_trace()))
    assert trace.finish_trace(str(raw), str(out), lead_ns=_LEAD_NS,
                              stop_ns=_STOP_NS)["lost_launches"] == 0


class PlantedProfiler(FakeFinishingProfiler):
    """Saves _planted_trace as kineto's and hands its finish (lead and stop
    at the planted times; the `device` recorded or not) to the port's
    PendingWrite."""

    def __init__(self, device: bool = True):
        super().__init__()
        self.device = device

    def export(self, trace_dir, pipelined=False, profile_top=None):
        path = os.path.join(trace_dir, "run" + shim.TRACE_SUFFIX)
        raw, _, tmp = shim._finish_files(path)
        with open(raw, "w") as f:
            f.write(json.dumps(_planted_trace()))
        self._pending = PendingWrite(
            {"raw": raw, "out": tmp, "steps": self._clock.spec(),
             "lead_ns": _LEAD_NS, "stop_ns": _STOP_NS,
             "device": self.device}, path)
        return path


@pytest.mark.parametrize("finish", ["child", "in_process"])
def test_lossy_capture_says_so_in_its_manifest(tmp_path, finish):
    """A capture whose window lost two launches' kernel records, finished
    in the child or (its spawn refused) in-process: the manifest is ok,
    as the JAX client's for a trace on disk, its timing's lost_launches
    is 2, and last_error says what was lost. A capture that lost none
    has lost_launches 0 and leaves last_error alone."""
    if finish == "in_process":
        failpoints.arm("shim.finish_spawn", "error")
    try:
        client, cfg = _run_capture(tmp_path, PlantedProfiler())
        client.stop()
    finally:
        failpoints.disarm("shim.finish_spawn")
    manifest = json.loads(open(cfg.manifest_path(os.getpid())).read())
    assert manifest["status"] == "ok", manifest
    assert manifest["timing"]["lost_launches"] == 2
    assert client.traces_completed == 1
    assert "2 launches in its window have no kernel record" in (
        client.last_error or "")
    jax_client = jax_shim.TraceClient(
        job_id=1, endpoint="dynotpu_pipe_nodaemon",
        profiler=jax_shim.RecordingProfiler(), report_interval_s=0)
    jax_cfg = jax_shim.TraceConfig.parse(
        f"ACTIVITIES_LOG_FILE={tmp_path}/jax.json\n"
        "ACTIVITIES_DURATION_MSECS=10")
    jax_client._run_trace(jax_cfg)
    jax_client.stop()
    ref = json.loads(open(jax_cfg.manifest_path(os.getpid())).read())
    assert ref["status"] == manifest["status"]
    clean, clean_cfg = _run_capture(tmp_path / "clean",
                                    FakeFinishingProfiler())
    clean.stop()
    manifest = json.loads(open(clean_cfg.manifest_path(os.getpid())).read())
    assert manifest["timing"]["lost_launches"] == 0
    assert clean.last_error is None


def test_capture_without_the_device_tracer_loses_no_launch(tmp_path):
    """At PROFILE_DEVICE_TRACER_LEVEL=0 the profiler records no kernel,
    so every launch of the window lacks its kernel record by design: the
    finish counts none as lost (lost_launches None), the manifest is ok
    and last_error stays None. TorchProfiler hands the finish the
    capture's device level."""
    client, cfg = _run_capture(tmp_path, PlantedProfiler(device=False))
    client.stop()
    manifest = json.loads(open(cfg.manifest_path(os.getpid())).read())
    assert manifest["status"] == "ok", manifest
    assert manifest["timing"]["lost_launches"] is None
    assert client.last_error is None
    prof = TorchProfiler()
    for level, device in (("0", False), ("1", True)):
        prof.configure({"PROFILE_DEVICE_TRACER_LEVEL": level})
        prof.start(str(tmp_path))
        prof.step()
        prof.stop()
        path = str(tmp_path / ("d" + level + shim.TRACE_SUFFIX))
        assert prof._finish_spec(path, None)["device"] is device
        prof.export(str(tmp_path))
