"""The per-capture profiler knobs of `dyno gputrace` in the port's shim
(dynolog_tpu_torch.client.shim: CaptureKnobs, profile_options,
TorchProfiler, RecordingProfiler), held to the JAX package's
JaxProfiler.configure and its capture ring; the Python frames in the
summarizer's host plane against the JAX summarizer's; and the span
journal's Chrome trace against the JAX package's, byte for byte."""

import json
import os
import random
import re
import threading
import time

import jax
import pytest
import torch
from jax._src.lib import _profiler as jax_native_profiler
from torch.profiler import ProfilerActivity

from daemon_utils import run_dyno, start_daemon, stop_daemon
from dynolog_tpu import obs as jax_obs
from dynolog_tpu import trace as jax_trace
from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu_torch import obs, trace
from dynolog_tpu_torch.client import shim
from dynolog_tpu_torch.client.shim import (
    DEFAULT_TRACER_LEVELS, RecordingProfiler, RingConfig, TorchProfiler,
    TraceClient, TraceConfig, profile_options)

# Config texts as the dyno CLI writes them (with its first lines), and
# the knobs' spellings an operator can get wrong.
HEAD = "PROFILE_START_TIME=0\nACTIVITIES_LOG_FILE=/tmp/k.json\n" \
       "ACTIVITIES_ITERATIONS=2"
CONFIGS = {
    "plain": "",
    "python_0": "PROFILE_PYTHON_TRACER_LEVEL=0",
    "host_0": "PROFILE_HOST_TRACER_LEVEL=0",
    "host_1": "PROFILE_HOST_TRACER_LEVEL=1",
    "host_3": "PROFILE_HOST_TRACER_LEVEL=3",
    "device_0": "PROFILE_DEVICE_TRACER_LEVEL=0",
    "all_set": ("PROFILE_PYTHON_TRACER_LEVEL=0\nPROFILE_HOST_TRACER_LEVEL=1"
                "\nPROFILE_DEVICE_TRACER_LEVEL=2"),
    "bad_integer": "PROFILE_HOST_TRACER_LEVEL=two",
    "bad_float": "PROFILE_PYTHON_TRACER_LEVEL=1.5",
    "negative": "PROFILE_HOST_TRACER_LEVEL=-1",
    "lower_case_key": "profile_python_tracer_level=0",
    "notrace_json": "TRACE_JSON=0",
    "trace_json_false": "TRACE_JSON=False",
    "trace_json_no": "TRACE_JSON=NO",
    "trace_json_yes": "TRACE_JSON=yes",
    "trace_json_1": "TRACE_JSON=1",
    "cli_knobs": ("PROFILE_PYTHON_TRACER_LEVEL=0\nPROFILE_HOST_TRACER_LEVEL=3"
                  "\nTRACE_JSON=0"),
}


def _raw(text: str) -> tuple[dict, dict]:
    """The config's raw keys as each package's TraceConfig parses them."""
    full = HEAD + ("\n" + text if text else "")
    return (jax_shim.TraceConfig.parse(full).raw, TraceConfig.parse(full).raw)


def _jax_levels(p: jax_shim.JaxProfiler) -> dict:
    """The levels a JAX capture runs at: ProfileOptions()'s, with the
    knobs JaxProfiler.start sets on it. A negative level fails the native
    setter, and start() then captures with the default options."""
    opts = jax.profiler.ProfileOptions()
    levels = {"python_tracer_level": opts.python_tracer_level,
              "host_tracer_level": opts.host_tracer_level,
              "device_tracer_level": 1}
    levels.update({k: v for k, v in p.tracer_levels.items() if v >= 0})
    return levels


def _assert_same(ours: shim.CaptureKnobs, ref: jax_shim.JaxProfiler):
    assert ours.tracer_levels == ref.tracer_levels
    assert ours.export_trace_json == ref.export_trace_json
    assert ours.levels == _jax_levels(ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configure_resolves_like_jax(name):
    jax_raw, raw = _raw(CONFIGS[name])
    assert raw == jax_raw
    ref = jax_shim.JaxProfiler()
    ref.configure(jax_raw)
    for ours in (TorchProfiler(), RecordingProfiler()):
        ours.configure(raw)
        _assert_same(ours, ref)


@pytest.mark.parametrize("first,then", [
    ("cli_knobs", "plain"), ("all_set", "python_0"),
    ("notrace_json", "host_0"), ("host_3", "bad_integer")])
def test_absent_key_reverts_to_default(first, then):
    """One capture's knobs never carry over to the next."""
    ref, ours = jax_shim.JaxProfiler(), TorchProfiler()
    for name in (first, then):
        jax_raw, raw = _raw(CONFIGS[name])
        ref.configure(jax_raw)
        ours.configure(raw)
        _assert_same(ours, ref)
    assert ours.levels == {
        **DEFAULT_TRACER_LEVELS, **_raw_levels(CONFIGS[then])}


def _raw_levels(text: str) -> dict:
    p = TorchProfiler()
    p.configure(_raw(text)[1])
    return p.tracer_levels


def test_defaults_are_the_jax_capture_defaults():
    opts = jax.profiler.ProfileOptions()
    assert DEFAULT_TRACER_LEVELS == {
        "python_tracer_level": opts.python_tracer_level,
        "host_tracer_level": opts.host_tracer_level,
        "device_tracer_level": 1}
    assert (opts.python_tracer_level, opts.host_tracer_level) == (1, 2)
    # jaxlib's options have no device level: the JAX device tracer always
    # runs, and PROFILE_DEVICE_TRACER_LEVEL sets a Python attribute that
    # the native session never reads (ROADMAP Queue C, C13).
    assert not hasattr(jax_native_profiler.ProfileOptions(),
                       "device_tracer_level")


CPU, CUDA = ProfilerActivity.CPU, ProfilerActivity.CUDA


@pytest.mark.parametrize("levels,cuda,want", [
    ((1, 2, 1), True, ([CPU, CUDA], True, True, False)),
    ((1, 2, 1), False, ([CPU], True, True, False)),
    ((0, 2, 1), True, ([CPU, CUDA], True, False, False)),
    ((1, 1, 1), True, ([CPU, CUDA], False, True, False)),
    ((1, 3, 1), True, ([CPU, CUDA], True, True, True)),
    ((1, 0, 1), True, ([CPU, CUDA], False, True, False)),
    ((1, 0, 1), False, ([CPU], False, True, False)),
    ((1, 2, 0), True, ([CPU], True, True, False)),
    ((0, 0, 0), True, ([], False, False, False)),
    ((1, 0, 0), True, ([CPU], False, True, False)),
    ((0, 0, 1), True, ([CUDA], False, False, False)),
    ((0, 0, 1), False, ([], False, False, False)),
    ((2, 9, 5), True, ([CPU, CUDA], True, True, True)),
])
def test_levels_map_onto_torch_profiler_arguments(levels, cuda, want):
    python, host, device = levels
    got = profile_options({"python_tracer_level": python,
                           "host_tracer_level": host,
                           "device_tracer_level": device}, cuda)
    acts, shapes, stack, memory = want
    assert got == {"activities": acts, "record_shapes": shapes,
                   "with_stack": stack, "profile_memory": memory,
                   "with_modules": memory}


# -- captures on the CPU, through the shim ---------------------------------


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _cats(events) -> dict:
    out: dict = {}
    for e in events:
        out[e.get("cat")] = out.get(e.get("cat"), 0) + 1
    return out


def _work(a):
    def run():
        (a @ a).sum()
        time.sleep(0.02)
    return run


def _drive(client, cfg_text, work, timeout_s=60.0):
    """Runs `cfg_text`'s capture as the poll thread would, while this
    (training) thread does `work` and calls step() until it ends."""
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
    return client.last_manifest


@pytest.fixture()
def client():
    c = TraceClient(job_id=7, endpoint="dynotpu_knobs_nodaemon",
                    profiler=TorchProfiler(), report_interval_s=0)
    yield c
    c.stop()
    for proc in c.summary_procs:
        proc.wait(timeout=60)


def _capture(client, tmp_path, knobs: str, name: str, n: int = 3):
    a = torch.randn(32, 32)
    text = (f"ACTIVITIES_LOG_FILE={tmp_path / name}.json\n"
            f"ACTIVITIES_ITERATIONS={n}" + ("\n" + knobs if knobs else ""))
    return _drive(client, text, _work(a))


@pytest.mark.parametrize("knobs,python", [
    ("", True), ("PROFILE_PYTHON_TRACER_LEVEL=1", True),
    ("PROFILE_PYTHON_TRACER_LEVEL=0", False)])
def test_python_frames_follow_the_python_level(client, tmp_path, knobs,
                                               python):
    manifest = _capture(client, tmp_path, knobs, "py")
    assert manifest["status"] == "ok", manifest
    cats = _cats(_events(manifest["trace_file"]))
    assert ("python_function" in cats) == python, cats
    assert cats.get("cpu_op"), cats
    summary = trace.summarize(manifest["trace_file"])
    assert summary["steps"]["count"] == 3


def _python_only(host) -> bool:
    """Whether a JAX host plane holds Python frames and nothing else."""
    return bool(host.ops) and all(op.startswith("$") for op in host.ops)


def test_host_level_0_keeps_the_steps(client, tmp_path):
    """At host level 0 the trace holds the Python frames and no host op,
    as the JAX capture's host plane does, and the summary still counts
    the window's steps, from the spans the shim writes for them, as many
    as at level 2."""
    assert _python_only(_jax_capture(
        tmp_path, 1, {"PROFILE_HOST_TRACER_LEVEL": "0"}))
    counts = {}
    for level in (2, 0):
        manifest = _capture(client, tmp_path,
                            f"PROFILE_HOST_TRACER_LEVEL={level}",
                            f"host{level}")
        assert manifest["status"] == "ok", manifest
        events = _events(manifest["trace_file"])
        cats = _cats(events)
        spans = [e for e in events
                 if e.get("name", "").startswith(trace.STEP_PREFIX)]
        assert len(spans) == 4
        if level == 0:
            assert "cpu_op" not in cats and cats.get("python_function"), cats
            assert all(e["args"] == {"source": "shim"} for e in spans)
            assert {e["tid"] for e in spans} == {threading.get_native_id()}
        counts[level] = trace.summarize(manifest["trace_file"])["steps"]
    assert counts[0]["count"] == counts[2]["count"] == 3
    # Every step sleeps 20 ms: both windows time about that.
    for s in counts.values():
        assert 0.018 <= s["p50_ms"] / 1e3 <= 1.0, counts


def test_host_level_0_duration_capture_keeps_the_app_frames(client,
                                                          tmp_path):
    """A duration capture at host level 0 runs on the poll thread: its
    trace keeps the training thread's Python frames and steps, and none
    of torch's host ops or annotations."""
    a = torch.randn(32, 32)
    manifest = _drive(client, f"ACTIVITIES_LOG_FILE={tmp_path / 'd0.json'}\n"
                      "ACTIVITIES_DURATION_MSECS=1000\n"
                      "PROFILE_HOST_TRACER_LEVEL=0", _work(a))
    assert manifest["status"] == "ok", manifest
    events = _events(manifest["trace_file"])
    me = threading.get_native_id()
    assert [e for e in events if e.get("cat") == "python_function"
            and e.get("tid") == me]
    assert "cpu_op" not in _cats(events)
    assert all(e["args"] == {"source": "shim"} and e["tid"] == me
               for e in events if e.get("cat") == "user_annotation")
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] >= 5


@pytest.mark.parametrize("steps", [0, 3])
def test_poll_thread_capture_gets_its_steps_at_export(tmp_path, steps):
    """A capture opened with a lead (mid-step) records no torch
    ProfilerStep#N span: _write_steps appends the clock's spans, one per
    step() on the stepping thread, after kineto's events, which it keeps
    as they are, with or without spans to add."""
    a = torch.randn(16, 16)
    prof = TorchProfiler()
    prof.start(str(tmp_path), lead=True)
    for _ in range(steps):
        (a @ a).sum()
        prof.step()
    prof.stop()
    prof._stopped.export_chrome_trace(str(tmp_path / "k.json"))
    doc = json.loads((tmp_path / "k.json").read_text())
    shim._write_steps(str(tmp_path / "k.json"), prof._clock)
    written = json.loads((tmp_path / "k.json").read_text())
    spans = prof._clock.events(doc["baseTimeNanoseconds"])
    assert len(spans) == steps
    assert all(e["tid"] == threading.get_native_id() for e in spans)
    assert written.pop("traceEvents") == doc.pop("traceEvents") + spans
    assert written == doc


def test_shim_steps_match_torch_steps_in_one_window(tmp_path):
    """One window at host level 2: the spans the shim writes lie on the
    ProfilerStep#N spans torch.profiler writes under a schedule, which
    the shim no longer passes (every capture records all threads, C17):
    kineto's ts plus its base is epoch time, so the summary reads the
    same steps from either."""
    from torch.profiler import ProfilerAction, profile

    prof = profile(**shim.profile_options(DEFAULT_TRACER_LEVELS, False),
                   schedule=lambda _step: ProfilerAction.RECORD)
    a = torch.randn(32, 32)
    prof.start()
    clock = shim._StepClock()
    for _ in range(3):
        (a @ a).sum()
        time.sleep(0.05)
        prof.step()
        clock.mark()
    clock.close()
    prof.stop()
    prof.export_chrome_trace(str(tmp_path / "k.json"))
    with open(tmp_path / "k.json") as f:
        doc = json.load(f)
    ours = clock.events(doc["baseTimeNanoseconds"])
    theirs = sorted((e for e in doc["traceEvents"]
                     if e.get("name", "").startswith(trace.STEP_PREFIX)),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ours] == [e["name"] for e in theirs]
    for o, t in zip(ours, theirs):
        assert abs(o["ts"] - t["ts"]) < 25e3, (o, t)  # half a step, in us
    others = [e for e in doc["traceEvents"]
              if not e.get("name", "").startswith(trace.STEP_PREFIX)]
    by_torch = trace._summarize_planes(trace.summarize_trace_events(
        doc["traceEvents"]))["steps"]
    by_shim = trace._summarize_planes(trace.summarize_trace_events(
        others + ours))["steps"]
    assert by_torch["count"] == by_shim["count"] == 3
    assert abs(by_torch["p50_ms"] - by_shim["p50_ms"]) < 25.0


def test_no_tracer_left_is_an_error_manifest(client, tmp_path):
    """With the host and device tracers off the Python tracer still runs,
    as in the JAX capture: an ok manifest holding Python frames only.
    Only with the Python tracer off as well is nothing left to record:
    an error manifest naming the three knobs."""
    off = {"PROFILE_HOST_TRACER_LEVEL": "0", "PROFILE_DEVICE_TRACER_LEVEL": "0"}
    assert _python_only(_jax_capture(tmp_path, 1, off))
    manifest = _capture(client, tmp_path, "\n".join(
        f"{k}={v}" for k, v in off.items()), "python_only")
    assert manifest["status"] == "ok", manifest
    cats = _cats(_events(manifest["trace_file"]))
    assert cats.get("python_function") and "cpu_op" not in cats, cats
    assert "kernel" not in cats
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] == 3
    knobs = ("PROFILE_PYTHON_TRACER_LEVEL=0", "PROFILE_HOST_TRACER_LEVEL=0",
             "PROFILE_DEVICE_TRACER_LEVEL=0")
    manifest = _capture(client, tmp_path, "\n".join(knobs), "none")
    assert manifest["status"] == "error"
    assert all(k in manifest["error"] for k in knobs), manifest["error"]
    assert client.traces_completed == 1 and len(client.summary_procs) == 1
    # The next capture runs at the defaults again.
    manifest = _capture(client, tmp_path, "", "after")
    assert manifest["status"] == "ok", manifest
    assert "python_function" in _cats(_events(manifest["trace_file"]))


def _knob_text(flags: list) -> str:
    """The config text the dyno CLI writes for these gputrace flags."""
    return "\n".join(
        "TRACE_JSON=0" if flag == "--notrace_json"
        else "PROFILE_" + flag.lstrip("-").partition("=")[0].upper()
        + "=" + flag.partition("=")[2] for flag in flags)


def test_one_profiler_through_every_knob_capture_keeps_its_steps(client,
                                                                  tmp_path):
    """chip_smoke.py phase 15's cycle on the CPU: one TorchProfiler,
    reconfigured by each capture's config, through every entry of its
    KNOB_CAPTURES in order (sessions with the CPU activity and without
    it, a start that raises). Each capture runs at the levels the JAX
    capture runs at for the same config; every one that runs a tracer
    keeps both its steps and loses no launch (counts none at device
    level 0), and the one with no tracer left is an error manifest
    naming the three knobs."""
    import chip_smoke

    for name, flags in chip_smoke.KNOB_CAPTURES.items():
        text = _knob_text(flags)
        manifest = _capture(client, tmp_path, text, name,
                            n=chip_smoke.ITERATIONS)
        ref = jax_shim.JaxProfiler()
        ref.configure(_raw(text)[0])
        levels = chip_smoke.knob_levels(flags)
        assert client.profiler.levels == levels == _jax_levels(ref), name
        if max(levels.values()) < 1:
            assert manifest["status"] == "error", manifest
            assert all(k in manifest["error"] for k in (
                "PROFILE_PYTHON_TRACER_LEVEL=0", "PROFILE_HOST_TRACER_LEVEL=0",
                "PROFILE_DEVICE_TRACER_LEVEL=0")), manifest["error"]
            continue
        assert manifest["status"] == "ok", manifest
        # None where the device tracer is off: no kernel is recorded.
        assert manifest["timing"]["lost_launches"] == (
            0 if levels["device_tracer_level"] >= 1 else None), manifest
        summary = trace.summarize(manifest["trace_file"])
        assert summary["steps"]["count"] == chip_smoke.ITERATIONS, name


def _summary_path(trace_file: str) -> str:
    return trace_file[: -len(trace.TRACE_SUFFIX)] + trace.SUMMARY_SUFFIX


@pytest.mark.parametrize("value", ["0", "false", "No"])
def test_trace_json_off_leaves_no_summary_child(tmp_path, value):
    profiler = RecordingProfiler()
    client = TraceClient(job_id=7, endpoint="dynotpu_knobs_nodaemon",
                         profiler=profiler, report_interval_s=0)
    try:
        off = _capture(client, tmp_path, f"TRACE_JSON={value}", "off")
        assert off["status"] == "ok" and os.path.exists(off["trace_file"])
        assert not client.summary_procs
        on = _capture(client, tmp_path, "", "on")
        [proc] = client.summary_procs
        assert proc.wait(timeout=60) == 0
    finally:
        client.stop()
    assert os.path.exists(_summary_path(on["trace_file"]))
    assert not os.path.exists(_summary_path(off["trace_file"]))


def test_recording_profiler_records_the_shim_calls(tmp_path):
    profiler = RecordingProfiler()
    client = TraceClient(job_id=7, endpoint="dynotpu_knobs_nodaemon",
                         profiler=profiler, report_interval_s=0)
    try:
        manifest = _capture(client, tmp_path,
                            "PROFILE_PYTHON_TRACER_LEVEL=0", "rec", n=2)
    finally:
        client.stop()
    trace_dir = str(tmp_path / f"rec_{os.getpid()}")
    assert [c[0] for c in profiler.calls] == [
        "configure", "start", "step", "step", "stop", "export"]
    assert profiler.calls[0][1]["PROFILE_PYTHON_TRACER_LEVEL"] == "0"
    assert profiler.calls[1] == ("start", trace_dir)
    assert profiler.calls[-1] == ("export", trace_dir)
    assert profiler.levels["python_tracer_level"] == 0
    assert manifest["status"] == "ok"
    assert trace.summarize(manifest["trace_file"])["steps"]["count"] == 2


def test_gputrace_knobs_through_a_live_daemon(bin_dir, tmp_path):
    """`dyno gputrace --python_tracer_level=0 --notrace_json` reaches the
    port's shim through dynologd: the capture records no Python frame,
    leaves its trace and manifest, and starts no summary child."""
    daemon = start_daemon(bin_dir)
    client = TraceClient(job_id=4333, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=0)
    a = torch.randn(32, 32)
    try:
        assert client.start(), "shim could not register with the daemon"
        result = run_dyno(
            bin_dir, daemon.port, "gputrace", "--job_id=4333",
            "--iterations=3", "--python_tracer_level=0", "--notrace_json",
            f"--log_file={tmp_path / 'knobs.json'}")
        assert "PROFILE_PYTHON_TRACER_LEVEL=0" in result.stdout, result
        assert "TRACE_JSON=0" in result.stdout, result
        deadline = time.time() + 30
        while client.traces_completed == 0 and time.time() < deadline:
            _work(a)()
            client.step()
        assert client.traces_completed == 1, client.last_error
    finally:
        client.stop()
        stop_daemon(daemon)
    manifest = json.loads(
        (tmp_path / f"knobs_{os.getpid()}.json").read_text())
    assert manifest["status"] == "ok", manifest
    assert manifest["config"]["TRACE_JSON"] == "0"
    cats = _cats(_events(manifest["trace_file"]))
    assert cats.get("cpu_op") and "python_function" not in cats, cats
    assert not client.summary_procs
    time.sleep(0.5)
    assert not os.path.exists(_summary_path(manifest["trace_file"]))


# -- the ring after a knob capture, against the JAX ring -------------------


def _jax_python_rows(profile: dict) -> list:
    return [o["op"] for o in profile["top_ops"] if o["op"].startswith("$")]


def _python_rows(profile: dict) -> list:
    return [o["op"] for o in profile["top_ops"]
            if re.search(r"\.py\(\d+\): ", o["op"])]


@pytest.mark.parametrize("knobs", [
    "", "PROFILE_PYTHON_TRACER_LEVEL=0\nTRACE_JSON=0"])
def test_ring_samples_at_the_last_configured_levels(tmp_path, knobs):
    """A ring sample after a knob capture runs at the levels that
    capture's configure left, writes no derived artifact, and leaves the
    knobs as they were, as the JAX ring does."""
    jax_raw, raw = _raw(knobs)
    ref = jax_shim.JaxProfiler()
    ref.configure(jax_raw)
    jax_ring = jax_shim.CaptureRing(jax_shim.RingConfig(
        every_n_steps=1, window_ms=50, dir=str(tmp_path / "jax_ring"),
        min_interval_s=0.0, top_ops=100_000))
    jax_path = jax_ring.capture(ref)
    assert jax_path, jax_ring.last_error
    jax_profile = json.loads(open(jax_path).read())["summary"]
    # The JAX ring turns the export off for its sample and back after.
    assert (ref.tracer_levels, ref.export_trace_json) == (
        ({}, True) if not knobs else ({"python_tracer_level": 0}, False))

    client = TraceClient(
        job_id=7, endpoint="dynotpu_knobs_nodaemon", profiler=TorchProfiler(),
        report_interval_s=0,
        ring=RingConfig(every_n_steps=1, window_ms=50,
                        dir=str(tmp_path / "ring"), min_interval_s=0.0,
                        top_ops=100_000))
    a = torch.randn(32, 32)
    try:
        manifest = _capture(client, tmp_path, knobs, "before_ring")
        assert manifest["status"] == "ok", manifest
        levels = client.profiler.tracer_levels
        procs = list(client.summary_procs)
        sampler = threading.Thread(
            target=client.ring.capture, args=(client._ring_sample,))
        sampler.start()
        while sampler.is_alive():
            _work(a)()
            client.step()
        sampler.join()
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=60)
    assert client.ring.captures == 1, client.ring.last_error
    assert client.summary_procs == procs  # no derived artifact
    assert client.profiler.tracer_levels == levels == ref.tracer_levels
    assert client.profiler.export_trace_json == ref.export_trace_json
    profile = json.loads(open(client.ring.last_path).read())["summary"]
    assert bool(_python_rows(profile)) == bool(_jax_python_rows(jax_profile))
    assert bool(_python_rows(profile)) == (not knobs)


# -- the host plane's Python frames, against the JAX summarizer ------------


def _jax_capture(tmp_path, python: int, knobs: dict | None = None):
    """The host plane of a JAX capture at this Python level (and these
    further config keys) of three jitted calls."""
    @jax.jit
    def work(x):
        return jax.numpy.sin(x) @ jax.numpy.cos(x).T

    x = jax.numpy.ones((64, 64))
    work(x).block_until_ready()
    p = jax_shim.JaxProfiler(export_trace_json=False)
    p.configure({"PROFILE_PYTHON_TRACER_LEVEL": str(python), **(knobs or {})})
    out = tmp_path / ("jax_py%d_%s" % (python, "_".join(
        f"{k}{v}" for k, v in sorted((knobs or {}).items()))))
    p.start(str(out))
    for _ in range(3):
        work(x).block_until_ready()
    p.stop()
    pending = p.take_pending_write()
    if pending is not None:
        assert "write_error" not in pending.wait()
    [path] = jax_trace.find_xplane_files(str(out))
    with open(path, "rb") as f:
        planes = jax_trace.summarize_xplane_bytes(f.read())
    return {p.name: p for p in planes}["/host:CPU"]


def _port_capture(tmp_path, python: int):
    prof = TorchProfiler()
    prof.configure({"PROFILE_PYTHON_TRACER_LEVEL": str(python)})
    a = torch.randn(32, 32)
    prof.start(str(tmp_path))
    for _ in range(3):
        (a @ a).sum()
        prof.step()
    prof.stop()
    events = _events(prof.export(str(tmp_path)))
    [host] = trace.summarize_trace_events(events)
    return host, events


def test_python_frames_are_host_plane_events_in_both_packages(tmp_path):
    """JAX puts its Python tracer's frames on the host plane, on the line
    of the thread that ran them, as events and op rows of their own; the
    port's summarizer does the same with torch's python_function
    frames."""
    jax_on, jax_off = _jax_capture(tmp_path, 1), _jax_capture(tmp_path, 0)
    jax_frames = sum(agg.count for op, agg in jax_on.ops.items()
                     if op.startswith("$"))
    assert 0 < jax_frames <= jax_on.events
    assert not [op for op in jax_off.ops if op.startswith("$")]

    on, events = _port_capture(tmp_path, 1)
    off, _ = _port_capture(tmp_path, 0)
    frames = [e for e in events if e.get("cat") == "python_function"
              and e.get("ph") == "X"]
    assert frames
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    # The plane's events: the thread's ops and frames, and its 3 steps.
    assert on.events == len(frames) + len(cpu_ops) + 3
    assert {f"thread {e['tid']}" for e in frames} <= set(on.line_names)
    # A frame's row is its whole name: one row per function, not per file.
    names = {e["name"] for e in frames}
    assert names <= set(on.ops)
    assert sum(on.ops[n].count for n in names) == len(frames)
    assert not [op for op in off.ops if re.search(r"\.py\(\d+\): ", op)]


def test_python_frames_leave_device_planes_alone():
    """Device planes and their op rows are the same with and without the
    host's Python frames."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 50.0, "args": {"External id": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 10.0, "dur": 2.0,
         "args": {"correlation": 5, "External id": 1}},
        {"ph": "X", "cat": "kernel", "name": "void gemm<128>(float*)",
         "pid": 0, "tid": 7, "ts": 20.0, "dur": 30.0,
         "args": {"device": 0, "correlation": 5}},
    ]
    frames = [{"ph": "X", "cat": "python_function", "pid": 1, "tid": 1,
               "name": f"train.py({n}): step", "ts": float(n),
               "dur": 60.0, "args": {"Python id": n}} for n in (1, 2)]
    without = trace._summarize_planes(trace.summarize_trace_events(events))
    with_frames = trace._summarize_planes(
        trace.summarize_trace_events(events + frames))
    assert without["top_ops"] == with_frames["top_ops"]
    assert without["planes"][0] == with_frames["planes"][0]
    assert with_frames["planes"][1]["events"] == (
        without["planes"][1]["events"] + 2)


# -- the span journal's Chrome trace ---------------------------------------


def _spans(mod):
    return [
        mod.Span(name="shim.capture", trace_id=0xab, span_id=0xcd,
                 parent_id=0, start_us=2_000_000, dur_us=15_000, pid=41),
        mod.Span(name="shim.export", trace_id=0xab, span_id=0xef,
                 parent_id=0xcd, start_us=1_000_000, dur_us=7, pid=41),
        mod.Span(name="trace.convert", trace_id=2**64 - 1,
                 span_id=1, parent_id=2**63, start_us=1_500_000,
                 dur_us=0, pid=42),
    ]


@pytest.mark.parametrize("n", [0, 1, 3])
def test_chrome_trace_is_byte_equal_to_jax(n):
    ours, ref = obs.SpanJournal(), jax_obs.SpanJournal()
    for a, b in zip(_spans(obs)[:n], _spans(jax_obs)[:n]):
        ours.record(a)
        ref.record(b)
    assert json.dumps(ours.chrome_trace()) == json.dumps(ref.chrome_trace())
    assert [s.chrome_event() for s in ours.snapshot()] == [
        s.chrome_event() for s in ref.snapshot()]
    assert len(ours.drain()) == n and ours.snapshot() == []


def test_chrome_trace_of_recorded_spans_is_byte_equal_to_jax():
    """Spans recorded through span() (nested, one injected clock, ids
    from one seed) give the same document in both packages."""
    docs = []
    for mod in (obs, jax_obs):
        journal = mod.SpanJournal(capacity=2)
        clock = iter(x / 10 for x in range(100))
        random.seed(7)
        ctx = mod.TraceContext.mint()
        with mod.span("shim.capture", ctx=ctx, journal=journal,
                      now=lambda: next(clock)):
            with mod.span("shim.export", journal=journal,
                          now=lambda: next(clock)):
                pass
        with mod.span("shim.artifact_write", ctx=ctx, journal=journal,
                      now=lambda: next(clock)):
            pass
        docs.append(json.dumps(journal.chrome_trace()).encode())
    assert docs[0] == docs[1]
    assert len(json.loads(docs[0])["traceEvents"]) == 2  # capacity 2
