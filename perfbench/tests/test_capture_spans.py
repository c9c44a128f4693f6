"""The shim's per-layer metrics, read from the spans each capture's
manifest lists: their arithmetic on synthetic spans and step marks, their
discovery, and a whole run through dynologd in which every capture's spans
come back through `dyno selftrace` under its manifest's trace-id."""

import shutil
import tempfile
from pathlib import Path

import pytest

from perfbench import harness, parts, phases, spans
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_discovery import BENCH

READERS = ("capture_held_ms", "capture_stop_ms", "capture_save_ms",
           "capture_host_stall_ms")
T0_US = 1_000_000_000_000  # the window's start, epoch us


def _span(name, ts_ms, dur_ms):
    return {"name": name, "ph": "X", "ts": T0_US + ts_ms * 1e3,
            "dur": dur_ms * 1e3}


def _capture(at_ms, stop_ms=300.0, save_ms=100.0, held_ms=(20.0,),
             new=True):
    """A capture's facts whose spans begin `at_ms` into the window: park
    50 ms, start 5, lead 50, window 500, stop, save, finish 1000. Without
    `new`, only the spans a shim before the phase spans recorded."""
    t = at_ms
    events = [_span("shim.capture", t, 2000), _span("shim.export", t + 900,
                                                    save_ms),
              _span("shim.artifact_write", t + 2000, 1)]
    if new:
        events += [_span("shim.park", t, 50),
                   _span("shim.profiler_start", t + 50, 5),
                   _span("shim.lead", t + 55, 50),
                   _span("shim.window", t + 105, 500),
                   _span("shim.profiler_stop", t + 605, stop_ms),
                   _span("shim.finish", t + 1000, 1000)]
        events += [_span("shim.step_held", t + 40, h) for h in held_ms]
    return {"fired": {"fired": (T0_US / 1e3 + at_ms - 5) / 1e3},
            "manifest": {"ended_ms": T0_US / 1e3 + at_ms + 2001,
                         "spans": events}}


def _run(captures, marks_ms=(), loss_every=1000):
    marks = [int((T0_US + m * 1e3) * 1e3) for m in marks_ms]
    return harness.Run(captures=captures, marks=marks, steps=len(marks),
                       traffic={"loss_every": loss_every})


def read(name, run):
    return harness.read_metric(name, run)


def test_means_over_the_captures_with_spans():
    caps = [_capture(1000, stop_ms=300, save_ms=100, held_ms=(20, 10)),
            _capture(8000, stop_ms=500, save_ms=300, held_ms=(10,)),
            {"fired": {"fired": 1.0}, "manifest": None}]
    run = _run(caps)
    assert read("capture_stop_ms", run) == pytest.approx(400.0)
    assert read("capture_save_ms", run) == pytest.approx(200.0)
    assert read("capture_held_ms", run) == pytest.approx(20.0)


def test_a_capture_that_held_no_step_reads_zero():
    assert read("capture_held_ms",
                _run([_capture(0, held_ms=())])) == pytest.approx(0.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_spans(name):
    assert read(name, _run([])) is None
    assert read(name, _run([{"fired": {"fired": 1.0}, "manifest": None}])
                ) is None


@pytest.mark.parametrize("name", ["capture_held_ms", "capture_stop_ms",
                                  "capture_host_stall_ms"])
def test_a_program_without_the_phase_spans_reads_nothing(name):
    """A shim that records only shim.capture, shim.export and
    shim.artifact_write has no phase to read (its save it has)."""
    run = _run([_capture(1000, new=False)], marks_ms=range(0, 6000, 100))
    assert read(name, run) is None
    assert read("capture_save_ms", run) == pytest.approx(100.0)


def test_host_stall_is_the_dispatch_time_over_the_clean_median():
    # Steps every 100 ms; the capture spans 1000-3001 ms (park to finish)
    # and holds up two steps by 150 ms each. Every 5th interval holds a
    # loss read, 400 ms longer, and counts for nothing.
    marks, t = [], 0.0
    for i in range(80):
        marks.append(t)
        t += 100.0
        if i in (7, 12):
            t += 150.0
        if (i + 1) % 5 == 0:
            t += 400.0
    run = _run([_capture(1000)], marks_ms=marks, loss_every=5)
    assert read("capture_host_stall_ms", run) == pytest.approx(300.0)


def test_host_stall_divides_by_the_captures():
    marks = [100.0 * i for i in range(200)]
    marks = [m + (300.0 if m > 1500 else 0) + (300.0 if m > 11500 else 0)
             for m in marks]
    run = _run([_capture(1000), _capture(11000)], marks_ms=marks)
    assert read("capture_host_stall_ms", run) == pytest.approx(300.0)


def test_phase_split_and_innermost_span():
    caps = [_capture(0, stop_ms=200), _capture(7000, stop_ms=400)]
    split = spans.phase_ms([spans.of(c) for c in caps])
    assert split["shim.profiler_stop"] == pytest.approx(300.0)
    assert split["shim.window"] == pytest.approx(500.0)
    events = spans.of(caps[0])
    assert spans.innermost(events, T0_US + 300e3) == "shim.window"
    assert spans.innermost(events, T0_US + 45e3) == "shim.step_held"
    assert spans.innermost(events, T0_US - 1e3) is None


def test_every_capture_s_spans_come_back_through_selftrace():
    """A tiny run through dynologd and the shim: each capture's manifest
    lists each phase once under its trace-id, the readers read them, and
    after the window every one of them comes back through `dyno selftrace`
    with the manifest's write (phases.read)."""
    bench, model, traffic = tiny.spec("deepseek_llm_7b.gputrace")
    harness.build(ROOT, model, cuda=False)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench_spans_"))
    daemon = job = None
    try:
        daemon, job = harness.start(ROOT, model, traffic, 2**31 + 9, "cpu",
                                    tmp)
        run = harness.measure(job, daemon, tmp, traffic, 4.0, False)
        run.traffic = traffic
        assert len(run.captures) >= 2
        for c in run.captures:
            assert not c["problems"], c["problems"]
            trace_id = c["manifest"]["trace_ctx"].split("/")[0]
            listed = spans.of(c)
            assert {e["args"]["trace_id"] for e in listed} == {trace_id}
            named = spans.by_name(listed)
            for name in ("shim.capture", "shim.park", "shim.profiler_start",
                         "shim.lead", "shim.window", "shim.profiler_stop",
                         "shim.export", "shim.kineto_save",
                         "shim.free_session", "shim.finish"):
                assert len(named.get(name, [])) == 1, (name, sorted(named))
            timing = c["manifest"]["timing"]
            assert timing["profiler_stop_ms"] == int(
                named["shim.profiler_stop"][0]["dur"]) // 1000
        fetched = spans.fetch(daemon, run.captures)
        for c, got in zip(run.captures, fetched):
            assert got is not None
            assert {e["args"]["span_id"] for e in got} >= {
                e["args"]["span_id"] for e in spans.of(c)}
        seen = phases.read(daemon, run.captures)
        assert seen["captures"] == len(run.captures)
        assert seen["captures_without_spans"] == 0
        assert seen["phase_ms"]["shim.artifact_write"] >= 0
        # The offsets' arithmetic: test_clock_offsets_and_gaps_of_a_trace
        # (a loaded CPU may leave a tiny window no step with an op after it).
        assert set(seen) >= {"step_op_offset_us", "gap_spans"}
        for name in READERS[:3]:
            assert read(name, run) >= 0, name
    finally:
        harness.stop(job, daemon)
        shutil.rmtree(tmp, ignore_errors=True)


def test_clock_offsets_and_gaps_of_a_trace():
    """phases' reading of a trace: each ProfilerStep span to the next
    cpu_op on its thread, and an idle gap named by its host op and by the
    capture's span over it."""
    events = [
        {"name": "ProfilerStep#1", "ts": 100.0, "dur": 500, "tid": 1},
        {"name": "aten::mm", "cat": "cpu_op", "ts": 160.0, "dur": 10,
         "tid": 1},
        {"name": "aten::add", "cat": "cpu_op", "ts": 90.0, "dur": 5,
         "tid": 1},
        {"name": "ProfilerStep#2", "ts": 600.0, "dur": 10, "tid": 2},
        {"name": "k1", "cat": "kernel", "ts": 200.0, "dur": 100},
        {"name": "k2", "cat": "kernel", "ts": 400.0, "dur": 100},
    ]
    assert phases.step_op_offsets_us(events) == [60.0]
    window = {"name": "shim.window", "ts": 5_000.0 + 250, "dur": 300}
    (gap,) = phases.gap_spans(events, 5_000_000, [window])
    assert gap[0] == "no_host_event" and gap[1] == pytest.approx(1e-4)
    assert gap[2] == "shim.window"


@pytest.mark.parametrize("name", READERS)
def test_shim_span_metrics_are_found(name):
    """The shim's span metrics: each a reader found by its name, a shim
    metric of the capture cell that moves its tokens/s."""
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry["layer"] == "shim" and entry["source"] == "program_span"
    assert entry["moves"] == "captured_tokens_per_s"
    assert entry["workloads"] == ["deepseek_llm_7b.gputrace"]
    assert callable(parts.load("metrics", name).read)


def test_span_cost_sends_each_capture_s_spans():
    """The microbenchmark of a capture's spans records, lists and sends
    all of them, and dynologd holds them."""
    from perfbench import span_cost

    out = span_cost.measure(5)
    assert out["spans_per_capture"] == 12 == out["daemon_holds_of_last"]
    assert out["record_us"]["median"] > 0 and out["send_us"]["p95"] > 0
    assert out["list_us"]["median"] > 0
