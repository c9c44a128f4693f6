"""The port's capture spans (dynolog_tpu_torch.client.shim): each phase of a
capture is one obs span under the capture's trace-id, listed in its
manifest and sent to dynologd after it, and each manifest timing key is its
span's length."""

import json
import os
import threading
import time

import pytest
import torch

from dynolog_tpu_torch import obs
from dynolog_tpu_torch.client import TorchProfiler, TraceClient, TraceConfig
from dynolog_tpu_torch.client.shim import RecordingProfiler, RingConfig

# The poll thread's phases under shim.capture, in order, and the timing
# key each one feeds.
PHASES = {"shim.park": "park_ms", "shim.profiler_start": "profiler_start_ms",
          "shim.lead": "lead_ms", "shim.window": "window_ms",
          "shim.profiler_stop": "profiler_stop_ms",
          "shim.export": "export_ms"}


def _client(profiler, **kw):
    return TraceClient(job_id=7, endpoint="dynotpu_spans_nodaemon",
                       profiler=profiler, report_interval_s=0, **kw)


class _Sent:
    """Records the spans the client sends to dynologd at each manifest
    (the real IpcClient still sends them)."""

    def __init__(self, client):
        self.spans: list[obs.Span] = []
        send = client._client.send_spans

        def record(spans, dest):
            spans = list(spans)
            self.spans.extend(spans)
            return send(spans, dest=dest)

        client._client.send_spans = record

    def of(self, manifest: dict) -> list[obs.Span]:
        trace_id = int(manifest["trace_ctx"].split("/")[0], 16)
        return [s for s in self.spans if s.trace_id == trace_id]


def _capture(client, cfg_text: str, pipelined: bool = False,
             work=lambda: None) -> tuple[dict, list, list]:
    """Runs `cfg_text`'s capture as the poll thread would while this
    (training) thread does `work` and calls step(); returns the manifest,
    the spans sent under its trace-id and the (start us, end us) of every
    step() call."""
    sent = _Sent(client)
    # An app that has stepped: its capture waits for its next step() to
    # park it (one that never stepped would be parked at its threads'
    # next Python event instead).
    client.step()
    runner = threading.Thread(target=client._run_trace,
                              args=(TraceConfig.parse(cfg_text), pipelined))
    calls = []
    runner.start()
    deadline = time.time() + 60
    while runner.is_alive() and time.time() < deadline:
        work()
        t0 = time.time()
        client.step()
        calls.append((t0 * 1e6, time.time() * 1e6))
        time.sleep(0.002)
    runner.join(timeout=30)
    assert not runner.is_alive()
    client.stop()  # joins the finisher of a pipelined capture
    manifest = client.last_manifest
    assert manifest is not None, client.last_error
    return manifest, sent.of(manifest), calls


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _end(s: obs.Span) -> int:
    return s.start_us + s.dur_us


def _check_tree(manifest: dict, spans: list, phases: dict) -> dict:
    """Every phase of `phases` once under shim.capture (each a child of
    it, or of the span named by its value), their timing keys equal to
    their lengths, the poll thread's children inside the capture and
    summing to no more than it. Returns the spans by name."""
    named = _by_name(spans)
    (capture,) = named["shim.capture"]
    assert len(named["shim.artifact_write"]) == 1
    ids = {s.span_id: s.name for s in spans}
    for name, parent in phases.items():
        assert len(named.get(name, [])) == 1, (name, sorted(named))
        (span,) = named[name]
        assert ids[span.parent_id] == (parent or "shim.capture"), name
        if name in PHASES:
            assert manifest["timing"][PHASES[name]] == span.dur_us // 1000
    # The manifest lists the capture's spans as sent, but its own write.
    listed = {e["args"]["span_id"]: (e["name"], e["ts"], e["dur"])
              for e in manifest["spans"]}
    sent = {f"{s.span_id:016x}": (s.name, s.start_us, s.dur_us)
            for s in spans}
    assert all(sent[k] == v for k, v in listed.items())
    assert {s.name for s in spans if f"{s.span_id:016x}" in listed} >= {
        "shim.capture", *phases}
    assert "shim.artifact_write" not in {v[0] for v in listed.values()}
    poll = [named[n][0] for n, p in phases.items()
            if p is None and n in PHASES]
    assert sum(s.dur_us for s in poll) <= capture.dur_us
    assert all(capture.start_us <= s.start_us and _end(s) <= _end(capture)
               for s in poll)
    return named


def _trace_steps_us(manifest: dict) -> list[float]:
    with open(manifest["trace_file"]) as f:
        doc = json.load(f)
    base_us = int(doc.get("baseTimeNanoseconds", 0)) / 1e3
    return sorted(float(e["ts"]) + base_us for e in doc["traceEvents"]
                  if e.get("name", "").startswith("ProfilerStep#"))


def test_duration_capture_records_each_phase_once(tmp_path):
    """A duration capture of an app that steps: park, start, lead, window,
    stop and save are each one span under shim.capture, each timing key
    its span's length; the training thread's park at the start is a
    shim.step_held inside one of its step() calls."""
    client = _client(RecordingProfiler())
    manifest, spans, calls = _capture(
        client, f"ACTIVITIES_LOG_FILE={tmp_path}/d.json\n"
                "ACTIVITIES_DURATION_MSECS=100")
    assert manifest["status"] == "ok", manifest
    named = _check_tree(manifest, spans, dict.fromkeys(PHASES))
    assert "shim.stop_park" not in named and "shim.drain" not in named
    held = named["shim.step_held"]
    assert len(held) == 1
    capture = named["shim.capture"][0]
    assert held[0].parent_id == capture.span_id
    assert any(a <= held[0].start_us and _end(held[0]) <= b
               for a, b in calls)
    # The lead ends where the window opens.
    lead, window = named["shim.lead"][0], named["shim.window"][0]
    assert _end(lead) <= window.start_us


def test_window_span_shares_the_manifest_and_trace_clock(tmp_path):
    """The shim.window span opens at the manifest's started_ms, and the
    trace's ProfilerStep#N spans (the step() calls of the window) start
    inside it: one unix clock for the spans, the manifest and the trace."""
    client = _client(RecordingProfiler())
    manifest, spans, _ = _capture(
        client, f"ACTIVITIES_LOG_FILE={tmp_path}/c.json\n"
                "ACTIVITIES_DURATION_MSECS=150")
    (window,) = _by_name(spans)["shim.window"]
    assert abs(window.start_us / 1e3 - manifest["started_ms"]) <= 1
    steps = _trace_steps_us(manifest)
    assert steps
    assert all(window.start_us <= t <= _end(window) for t in steps), (
        window, steps)


def test_iteration_capture_records_each_phase_and_both_edges(tmp_path):
    """An iteration capture: its park, start, window, stop and save are
    spans under shim.capture, and the training thread parks at both of the
    window's edges, each a shim.step_held inside a step() call."""
    client = _client(RecordingProfiler())
    manifest, spans, calls = _capture(
        client, f"ACTIVITIES_LOG_FILE={tmp_path}/i.json\n"
                "ACTIVITIES_ITERATIONS=3")
    assert manifest["status"] == "ok" and manifest["mode"] == "iterations"
    phases = {k: None for k in PHASES if k != "shim.lead"}
    named = _check_tree(manifest, spans, phases)
    assert "shim.lead" not in named  # this profiler opens at its start
    held = named["shim.step_held"]
    assert len(held) == 2
    for span in held:
        assert any(a <= span.start_us and _end(span) <= b
                   for a, b in calls), (span, calls[-5:])
    start, stop = named["shim.profiler_start"][0], named[
        "shim.profiler_stop"][0]
    assert held[0].start_us <= start.start_us and _end(start) <= _end(
        held[0])
    assert held[1].start_us <= stop.start_us and _end(stop) <= _end(held[1])


@pytest.mark.parametrize("cfg", [
    "ACTIVITIES_DURATION_MSECS=100", "ACTIVITIES_ITERATIONS=2"],
    ids=["duration", "iterations"])
def test_torch_profiler_capture_splits_the_save(tmp_path, cfg):
    """torch.profiler's capture, pipelined as the poll loop runs it: the
    save's shim.export holds kineto's save and the session's release, and
    the finish on its own thread is a shim.finish under it whose length is
    write_ms. An iteration window (with its lead step) holds shim.lead."""
    a = torch.randn(32, 32)
    client = _client(TorchProfiler())
    manifest, spans, _ = _capture(
        client, f"ACTIVITIES_LOG_FILE={tmp_path}/t.json\n{cfg}",
        pipelined=True, work=lambda: (a @ a).sum())
    assert manifest["status"] == "ok", manifest
    iterations = "ITERATIONS" in cfg
    phases = {**dict.fromkeys(PHASES), "shim.kineto_save": "shim.export",
              "shim.free_session": "shim.export",
              "shim.finish": "shim.export"}
    if iterations:
        phases["shim.lead"] = "shim.window"
    named = _check_tree(manifest, spans, phases)
    export = named["shim.export"][0]
    save, free = named["shim.kineto_save"][0], named["shim.free_session"][0]
    assert save.dur_us + free.dur_us <= export.dur_us
    assert _end(save) <= free.start_us
    (finish,) = named["shim.finish"]
    assert manifest["timing"]["write_ms"] == finish.dur_us // 1000
    assert finish.start_us >= save.start_us
    if iterations:
        lead, window = named["shim.lead"][0], named["shim.window"][0]
        assert window.start_us <= lead.start_us and _end(lead) <= _end(
            window)


def test_failing_stop_still_records_its_span(tmp_path):
    """A profiler whose stop raises fails the capture, and its
    shim.profiler_stop is recorded all the same, its length the
    manifest's profiler_stop_ms."""

    class FailingStop(RecordingProfiler):
        def stop(self):
            super().stop()
            time.sleep(0.02)
            raise RuntimeError("stop broke")

    client = _client(FailingStop())
    manifest, spans, _ = _capture(
        client, f"ACTIVITIES_LOG_FILE={tmp_path}/f.json\n"
                "ACTIVITIES_DURATION_MSECS=50")
    assert manifest["status"] == "error"
    assert "profiler stop failed" in manifest["error"]
    (stop,) = _by_name(spans)["shim.profiler_stop"]
    assert stop.dur_us >= 20_000
    assert manifest["timing"]["profiler_stop_ms"] == stop.dur_us // 1000


def test_step_without_a_window_records_nothing():
    """The step() of an app that no capture asked records no span."""
    client = _client(RecordingProfiler())
    before = obs.JOURNAL.recorded
    for _ in range(200):
        client.step()
    assert obs.JOURNAL.recorded == before
    assert client._window is None


def test_warmup_records_its_phases_under_its_own_trace():
    """The profiler warmup's park, drain, start, stop and save are spans
    under a shim.warmup of a trace-id of its own, each its warmup_timing
    key's length."""
    client = _client(TorchProfiler(), warmup_profiler=True)
    client._stop.set()  # the warmup alone, started at once
    client._warmup()
    timing = client.warmup_timing
    assert timing, client.last_error
    roots = [s for s in obs.JOURNAL.snapshot() if s.name == "shim.warmup"]
    root = roots[-1]
    spans = [s for s in obs.JOURNAL.snapshot()
             if s.trace_id == root.trace_id]
    named = _by_name(spans)
    keys = {"shim.park": "park_ms", "shim.drain": "drain_ms",
            "shim.profiler_start": "profiler_start_ms",
            "shim.profiler_stop": "profiler_stop_ms",
            "shim.export": "export_ms"}
    for name, key in keys.items():
        (span,) = named[name]
        assert span.parent_id == root.span_id, name
        assert timing[key] == span.dur_us // 1000, name
    assert "shim.capture" not in named


def test_ring_sample_nests_its_capture_under_ring_capture(tmp_path):
    """A ring sample's capture is a shim.capture under shim.ring_capture,
    with the same phases as an on-demand one."""
    client = _client(RecordingProfiler(), ring=RingConfig(
        every_n_steps=1, min_interval_s=0, window_ms=30,
        dir=str(tmp_path / "ring")))
    stop = threading.Event()

    def app():
        while not stop.is_set():
            client.step()
            time.sleep(0.002)

    stepping = threading.Thread(target=app)
    stepping.start()
    try:
        time.sleep(0.05)
        assert client.ring.capture(client._ring_sample), client.ring.last_error
    finally:
        stop.set()
        stepping.join(timeout=30)
    assert not stepping.is_alive()
    spans = obs.JOURNAL.snapshot()
    ring = [s for s in spans if s.name == "shim.ring_capture"][-1]
    tree = [s for s in spans if s.trace_id == ring.trace_id]
    named = _by_name(tree)
    (capture,) = named["shim.capture"]
    assert capture.parent_id == ring.span_id
    for name in PHASES:
        (span,) = named[name]
        assert span.parent_id == capture.span_id, name
    assert client.ring.last_timing["window_ms"] == named[
        "shim.window"][0].dur_us // 1000


def test_manifest_lists_its_spans_after_another_capture_s_flush(tmp_path):
    """A capture whose manifest is written after another capture's (whose
    flush sent its spans to dynologd first) still lists them."""
    client = _client(RecordingProfiler())
    sent = _Sent(client)
    mine, other = obs.TraceContext.mint(), obs.TraceContext.mint()
    with obs.span("shim.capture", ctx=mine) as capture:
        pass
    for ctx, name in ((other, "other"), (mine, "mine")):
        cfg = TraceConfig.parse(f"ACTIVITIES_LOG_FILE={tmp_path}/{name}.json")
        client._finish_trace(cfg, os.getpid(), str(tmp_path), None, 0,
                             "no trace", {}, ctx)
    assert capture in sent.spans  # flushed with the other's manifest
    manifest = client.last_manifest
    assert manifest["trace_ctx"] == mine.header()
    assert [(e["name"], e["ts"], e["dur"]) for e in manifest["spans"]] == [
        ("shim.capture", capture.start_us, capture.dur_us)]
