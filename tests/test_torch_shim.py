"""The PyTorch shim (dynolog_tpu_torch.client) on the CPU: an iteration
capture opened and closed by step() on the training thread, a duration
capture on the poll thread of an app that steps and of one that never
does (beside the JAX client's), a capture triggered through a real
dynologd, and the IPC wire held to the JAX package's layout."""

import json
import os
import struct
import threading
import time

import pytest
import torch

from daemon_utils import start_daemon, stop_daemon
from dynolog_tpu import obs as jax_obs
from dynolog_tpu.client import ipc as jax_ipc
from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu.client.shim import TraceConfig as JaxTraceConfig
from dynolog_tpu_torch.client import TorchProfiler, TraceClient, TraceConfig
from dynolog_tpu_torch import failpoints, obs, trace
from dynolog_tpu_torch.client import ipc
from dynolog_tpu_torch.client.shim import (
    RecordingProfiler, sweep_stale_artifacts)
from dynolog_tpu_torch.models.train import (
    make_batch, make_train_state, make_train_step)
from dynolog_tpu_torch.models.transformer import TransformerConfig

TINY = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                         d_ff=64, dtype="float32", attn_impl="flash")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _drive(client, cfg_text, work, timeout_s=60.0):
    """Runs `cfg_text`'s capture as the poll thread would, while this
    (training) thread does `work` and calls step() until the capture
    ends. Each step yields the GIL, so a fast `work` cannot run its steps
    out before the capture thread has armed its window."""
    runner = threading.Thread(
        target=client._run_trace, args=(TraceConfig.parse(cfg_text),))
    runner.start()
    deadline = time.time() + timeout_s
    while runner.is_alive() and time.time() < deadline:
        work()
        client.step()
        time.sleep(0.001)
    runner.join(timeout=30)
    assert not runner.is_alive()


@pytest.fixture()
def offline_client():
    # No daemon: nothing is registered, captures are driven directly.
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    yield client
    client.stop()


def test_capture_records_training_thread_ops(offline_client, tmp_path):
    """An iteration capture starts and stops on the thread that runs the
    model, with profile_all_threads as every capture (C17): the trace
    holds aten::mm cpu_ops from THAT thread, and the shim's step spans."""
    a = torch.randn(32, 32)
    log = tmp_path / "trace.json"
    _drive(offline_client,
           f"ACTIVITIES_LOG_FILE={log}\nACTIVITIES_ITERATIONS=3",
           lambda: (a @ a).sum())
    assert offline_client.traces_completed == 1, offline_client.last_error
    manifest = json.loads((tmp_path / f"trace_{os.getpid()}.json").read_text())
    assert manifest["status"] == "ok" and manifest["mode"] == "iterations"
    assert manifest["timing"]["profiler_start_ms"] >= 0
    assert manifest["timing"]["profiler_stop_ms"] >= 0
    events = _events(manifest["trace_file"])
    me = threading.get_native_id()
    mms = [e for e in events
           if e.get("cat") == "cpu_op" and e.get("name") == "aten::mm"]
    assert mms and all(e["tid"] == me for e in mms), mms[:2]
    steps = {e["name"] for e in events
             if e.get("name", "").startswith("ProfilerStep#")}
    assert len(steps) >= 3, steps


def test_stop_leaves_events_unparsed(tmp_path):
    """stop() on the training thread only ends kineto's collection: it
    parses no event into FunctionEvents (torch's acc_events would), and
    the exported trace still holds its ProfilerStep#N spans."""
    a = torch.randn(32, 32)
    prof = TorchProfiler()
    prof.start(str(tmp_path))
    for _ in range(3):
        (a @ a).sum()
        prof.step()
    prof.stop()
    profile = prof._stopped.profiler
    assert profile._function_events is None and profile._needs_processing
    assert profile._stats.parse_kineto_call_duration_us == 0
    events = _events(prof.export(str(tmp_path)))
    assert profile._function_events is None
    steps = {e["name"] for e in events
             if e.get("name", "").startswith("ProfilerStep#")}
    assert len(steps) >= 3, steps
    assert any(e.get("name") == "aten::mm" for e in events)


def test_iteration_window_opens_at_the_roundup_boundary(tmp_path):
    """An iteration capture starts the profiler at the step() of the next
    roundup boundary strictly after the current step, as the JAX shim's
    window begins, and stops it when its iterations are done."""
    seen = []

    class Seen(RecordingProfiler):
        def start(self, trace_dir, all_threads=False):
            seen.append(("start", client._step_count))
            super().start(trace_dir, all_threads)

        def stop(self):
            seen.append(("stop", client._step_count))
            super().stop()

    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         profiler=Seen(), report_interval_s=0)
    try:
        for _ in range(4):
            client.step()
        # Each step waits a while for the window to be armed.
        _drive(client, f"ACTIVITIES_LOG_FILE={tmp_path / 'p.json'}\n"
               "ACTIVITIES_ITERATIONS=3\nPROFILE_START_ITERATION_ROUNDUP=4",
               lambda: client._window is not None or time.sleep(0.05))
    finally:
        client.stop()
    assert client.last_manifest["status"] == "ok", client.last_manifest
    # From step 4 (itself a boundary), the next boundary of 4 is step 8.
    assert seen == [("start", 8), ("stop", 11)]


def test_iteration_capture_holds_only_its_window(tmp_path):
    """A capture started at a step boundary holds none of the ops before
    it, and its steps are torch's own ProfilerStep#N spans from 0."""
    a = torch.randn(32, 32)
    prof = TorchProfiler()
    torch.relu(a)
    prof.start(str(tmp_path))
    for _ in range(3):
        (a @ a).sum()
        prof.step()
    prof.stop()
    events = _events(prof.export(str(tmp_path)))
    names = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert "aten::mm" in names and "aten::relu" not in names
    steps = sorted(e["name"] for e in events
                   if e.get("name", "").startswith(trace.STEP_PREFIX))
    assert steps == [f"{trace.STEP_PREFIX}{n}" for n in (0, 1, 2, 3)]
    assert trace.summarize_trace_events(events)[-1].step_durations_ps


def test_duration_capture_of_train_steps(offline_client, tmp_path):
    gen = torch.Generator().manual_seed(0)
    params, opt = make_train_state(TINY, "cpu", gen)
    step = make_train_step(TINY)
    batch = make_batch(gen, TINY, 2, 16, "cpu")
    log = tmp_path / "dur.json"
    _drive(offline_client,
           f"ACTIVITIES_LOG_FILE={log}\nACTIVITIES_DURATION_MSECS=500",
           lambda: step(params, opt, batch))
    assert offline_client.traces_completed == 1, offline_client.last_error
    manifest = offline_client.last_manifest
    assert manifest["mode"] == "duration" and manifest["status"] == "ok"
    names = {e.get("name") for e in _events(manifest["trace_file"])}
    assert "aten::mm" in names


def _busy(stop: threading.Event, tid: list) -> None:
    """An app thread that never calls step(): matmuls until `stop`."""
    tid.append(threading.get_native_id())
    a = torch.randn(64, 64)
    while not stop.is_set():
        torch.relu(a @ a)
        time.sleep(0.001)


def test_duration_capture_of_an_app_that_never_steps(tmp_path):
    """A duration capture runs on the poll thread in both packages, so an
    app that never calls step() is traced; the port's trace holds that
    app thread's aten::mm ops (ROADMAP C1) and no step."""
    stop, tid = threading.Event(), []
    app = threading.Thread(target=_busy, args=(stop, tid))
    app.start()
    text = "ACTIVITIES_LOG_FILE={}\nACTIVITIES_DURATION_MSECS=500"
    jax_client = jax_shim.TraceClient(
        job_id=7, endpoint="dynotpu_torch_nodaemon",
        profiler=jax_shim.RecordingProfiler(), step_start_timeout_s=3,
        report_interval_s=0)
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         profiler=TorchProfiler(), step_start_timeout_s=3,
                         report_interval_s=0)
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
    manifest = json.loads((tmp_path / f"port_{pid}.json").read_text())
    assert ref["status"] == manifest["status"] == "ok", (ref, manifest)
    assert ref["mode"] == manifest["mode"] == "duration"
    events = _events(manifest["trace_file"])
    mms = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("name") == "aten::mm" and e.get("tid") == tid[0]]
    assert mms, {e.get("tid") for e in events}
    assert not [e for e in events
                if e.get("name", "").startswith(trace.STEP_PREFIX)]
    assert "steps" not in trace.summarize(manifest["trace_file"])


def test_duration_capture_counts_the_steps_of_an_app_that_steps(
        offline_client, tmp_path):
    """A duration window on the poll thread still counts the training
    thread's steps: the shim writes their spans on that thread."""
    a = torch.randn(32, 32)

    def work():
        (a @ a).sum()
        time.sleep(0.02)

    _drive(offline_client,
           f"ACTIVITIES_LOG_FILE={tmp_path / 'steps.json'}\n"
           "ACTIVITIES_DURATION_MSECS=1000", work)
    manifest = offline_client.last_manifest
    assert manifest["status"] == "ok", manifest
    events = _events(manifest["trace_file"])
    spans = [e for e in events
             if e.get("name", "").startswith(trace.STEP_PREFIX)]
    assert all(e["args"] == {"source": "shim"} for e in spans)
    assert {e["tid"] for e in spans} == {threading.get_native_id()}
    steps = trace.summarize(manifest["trace_file"])["steps"]
    assert steps["count"] >= 5 and len(spans) == steps["count"] + 1, steps
    assert 0.018 <= steps["p50_ms"] / 1e3 <= 1.0, steps


def test_stop_ends_an_open_duration_window(tmp_path):
    """stop() during a long duration window: the poll thread's wait ends,
    it stops its own profiler and writes an error manifest."""
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         profiler=TorchProfiler(), report_interval_s=0)
    runner = threading.Thread(target=client._run_trace, args=(
        TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path / 'long.json'}\n"
                          "ACTIVITIES_DURATION_MSECS=600000"),))
    runner.start()
    deadline = time.time() + 60
    while client._window is None and time.time() < deadline:
        time.sleep(0.01)
    assert client._window is not None
    t0 = time.time()
    client.stop()
    runner.join(timeout=30)
    assert not runner.is_alive() and time.time() - t0 < 10
    manifest = json.loads(
        (tmp_path / f"long_{os.getpid()}.json").read_text())
    assert manifest["status"] == "error", manifest
    assert "client stopped" in manifest["error"]
    assert client.profiler._prof is None and client._window is None


def _wait_for(path, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    return os.path.exists(path)


def test_summary_child_writes_summary_after_manifest(offline_client,
                                                     tmp_path):
    """A completed capture gets <run>.summary.json from a child process,
    after its manifest: the summary is trace.summarize() of the trace."""
    a = torch.randn(32, 32)
    _drive(offline_client,
           f"ACTIVITIES_LOG_FILE={tmp_path / 's.json'}\n"
           "ACTIVITIES_ITERATIONS=3", lambda: (a @ a).sum())
    assert offline_client.traces_completed == 1, offline_client.last_error
    manifest_path = tmp_path / f"s_{os.getpid()}.json"
    trace_file = offline_client.last_manifest["trace_file"]
    summary_path = trace_file[: -len(trace.TRACE_SUFFIX)] + (
        trace.SUMMARY_SUFFIX)
    assert _wait_for(summary_path), "no summary within 60 s"
    [proc] = offline_client.summary_procs
    assert proc.wait(timeout=30) == 0
    assert os.path.getmtime(manifest_path) <= os.path.getmtime(summary_path)
    summary = json.loads(open(summary_path).read())
    assert summary == trace.summarize(trace_file)
    assert summary["steps"]["count"] == 3


def test_capture_completes_without_summary_child(offline_client, tmp_path):
    failpoints.arm("shim.export_spawn", "error*1")
    try:
        a = torch.randn(16, 16)
        _drive(offline_client,
               f"ACTIVITIES_LOG_FILE={tmp_path / 'n.json'}\n"
               "ACTIVITIES_ITERATIONS=2", lambda: (a @ a).sum())
    finally:
        failpoints.disarm("shim.export_spawn")
    assert offline_client.traces_completed == 1, offline_client.last_error
    assert offline_client.last_manifest["status"] == "ok"
    assert not offline_client.summary_procs


def test_capture_aborts_when_app_never_steps(tmp_path):
    """An iteration capture's window opens at a step: an app that never
    steps gets an error manifest (a duration capture needs no step)."""
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         step_start_timeout_s=0.2, report_interval_s=0)
    try:
        client._run_trace(TraceConfig.parse(
            f"ACTIVITIES_LOG_FILE={tmp_path / 't.json'}\n"
            "ACTIVITIES_ITERATIONS=2"))
        assert client.traces_completed == 0
        manifest = client.last_manifest
        assert manifest["status"] == "error"
        assert "did not reach step" in manifest["error"]
    finally:
        client.stop()


def test_window_left_open_is_closed_at_its_timeout(tmp_path):
    """The app stops stepping inside a window: the capture times out with
    an error manifest, the poll thread closes the profiler it opened
    (C17: it opens and closes every capture), the training thread's next
    step() finds no window, and the next capture works again."""
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         step_trace_timeout_s=0.3, report_interval_s=0)
    a = torch.randn(16, 16)
    try:
        runner = threading.Thread(target=client._run_trace, args=(
            TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path / 'a.json'}\n"
                              "ACTIVITIES_ITERATIONS=50"),))
        runner.start()
        while client._window is None or client._window.state == "armed":
            (a @ a).sum()
            client.step()
        runner.join(timeout=30)
        assert not runner.is_alive()
        assert "timed out" in client.last_manifest["error"]
        assert client.profiler._prof is None  # closed at the timeout
        client.step()
        assert client._window is None
        _drive(client, f"ACTIVITIES_LOG_FILE={tmp_path / 'b.json'}\n"
               "ACTIVITIES_ITERATIONS=2", lambda: (a @ a).sum())
        assert client.traces_completed == 1, client.last_error
    finally:
        client.stop()


def test_capture_after_an_aborted_one_works(tmp_path):
    """The app stops stepping before an iteration window opens: the
    capture aborts with an error manifest and leaves no window or
    profiler behind, and the next capture works."""
    client = TraceClient(job_id=7, endpoint="dynotpu_torch_nodaemon",
                         step_start_timeout_s=0.3, report_interval_s=0)
    try:
        for _ in range(3):
            client.step()
        client._run_trace(TraceConfig.parse(
            f"ACTIVITIES_LOG_FILE={tmp_path / 'a.json'}\n"
            "ACTIVITIES_ITERATIONS=2"))
        assert "did not reach step 4" in client.last_manifest["error"]
        assert client._window is None and client.profiler._prof is None
        a = torch.randn(16, 16)
        _drive(client, f"ACTIVITIES_LOG_FILE={tmp_path / 'b.json'}\n"
               "ACTIVITIES_ITERATIONS=2", lambda: (a @ a).sum())
        assert client.traces_completed == 1, client.last_error
    finally:
        client.stop()


def test_trace_config_parses_like_the_jax_shim():
    text = ("PROFILE_START_TIME=1234\\nACTIVITIES_LOG_FILE=/tmp/trace.json\n"
            "ACTIVITIES_ITERATIONS=5\nPROFILE_START_ITERATION_ROUNDUP=4\n"
            "TRACE_CONTEXT=00000000000000ab/00000000000000cd")
    ours, ref = TraceConfig.parse(text), JaxTraceConfig.parse(text)
    for attr in ("log_file", "start_time_ms", "duration_ms", "iterations",
                 "iteration_roundup", "trace_ctx", "raw"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert ours.trace_dir(42) == ref.trace_dir(42) == "/tmp/trace_42"
    assert ours.manifest_path(42) == ref.manifest_path(42)


def test_sweep_reclaims_only_dead_uncompleted_sessions(tmp_path):
    base = tmp_path / "trace"
    dead = 2 ** 22 + 12345  # above pid_max on Linux: never alive
    old = time.time() - 3600
    stale = tmp_path / f"trace_{dead}"
    done = tmp_path / f"trace_{dead + 1}"
    foreign = tmp_path / f"other_{dead}"
    live = tmp_path / f"trace_{os.getpid()}"
    for d in (stale, done, foreign, live):
        d.mkdir()
    (tmp_path / f"trace_{dead + 1}.json").write_text("{}")
    leftover = live / "x.pt.trace.json.tmp"
    leftover.write_text("{")
    for p in (leftover, stale, done, foreign, live):
        os.utime(p, (old, old))
    reclaimed = sweep_stale_artifacts(str(base), ttl_s=60)
    assert sorted(reclaimed) == sorted([str(stale), str(leftover)])
    assert done.exists() and foreign.exists() and live.exists()


@pytest.mark.parametrize("text", [
    "00000000000000ab/00000000000000cd", "0000000000000000/00000000000000cd",
    "00000000000000ab-00000000000000cd", "ab/cd", "zz000000000000ab/0000000000000001"])
def test_trace_context_parses_like_jax_package(text):
    ours, ref = obs.TraceContext.parse(text), jax_obs.TraceContext.parse(text)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert ours.header() == ref.header() == text
    assert obs.CONFIG_KEY == jax_obs.CONFIG_KEY


@pytest.mark.parametrize("name", [
    "METADATA", "CONTEXT", "REQUEST_HEADER", "PERF_STATS", "SUBSCRIBE",
    "SPAN", "INT32"])
def test_wire_struct_matches_jax_package(name):
    ours, ref = getattr(ipc, name), getattr(jax_ipc, name)
    assert isinstance(ours, struct.Struct)
    assert (ours.format, ours.size) == (ref.format, ref.size)


def test_wire_constants_match_jax_package():
    for name in dir(jax_ipc):
        if name.startswith(("MSG_TYPE_", "CONFIG_TYPE_")) or name in (
                "DAEMON_ENDPOINT", "SPAN_VERSION", "_MAX_DGRAM"):
            assert getattr(ipc, name) == getattr(jax_ipc, name), name


def test_daemon_triggered_capture_of_train_loop(bin_dir, tmp_path):
    """setKinetOnDemandRequest through a real dynologd reaches the port's
    shim, which captures the running CPU train loop."""
    daemon = start_daemon(bin_dir)
    client = TraceClient(job_id=4321, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=0.5)
    try:
        assert client.start(), "shim could not register with the daemon"
        gen = torch.Generator().manual_seed(1)
        params, opt = make_train_state(TINY, "cpu", gen)
        step = make_train_step(TINY)
        batch = make_batch(gen, TINY, 2, 16, "cpu")
        trace_base = str(tmp_path / "trace.json")
        resp = daemon.rpc({
            "fn": "setKinetOnDemandRequest",
            "config": (f"ACTIVITIES_LOG_FILE={trace_base}\n"
                       "ACTIVITIES_ITERATIONS=2"),
            "job_id": 4321, "pids": [0], "process_limit": 3,
        })
        assert resp and resp.get("processesMatched"), resp
        deadline = time.time() + 30
        while client.traces_completed == 0 and time.time() < deadline:
            step(params, opt, batch)
            client.step()
        assert client.traces_completed == 1, client.last_error
        manifest = json.loads(
            (tmp_path / f"trace_{os.getpid()}.json").read_text())
        assert manifest["status"] == "ok", manifest
        names = {e.get("name") for e in _events(manifest["trace_file"])}
        assert "aten::mm" in names
    finally:
        client.stop()
        stop_daemon(daemon)
