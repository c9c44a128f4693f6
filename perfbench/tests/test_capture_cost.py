"""capture_cost_ms's arithmetic on synthetic step times and captures."""

import pytest

from perfbench import harness


def _run(step_ms, spans_ms, t0=1000.0):
    """A run whose steps start at t0 (s) and whose captures span
    `spans_ms` (request ms, end ms) on the same clock."""
    caps = [{"fired": {"fired": a / 1e3},
             "manifest": {"started_ms": a, "timing": {
                 "window_ms": b - a, "profiler_stop_ms": 0,
                 "export_ms": 0}}} for a, b in spans_ms]
    return harness.Run(step_ms=step_ms, captures=caps, t0=t0)


def cost(run):
    return harness.read_metric("capture_cost_ms", run)


def test_extra_time_over_the_clean_median_per_capture():
    # Ten steps of 100 ms from t0 = 1000 s; one capture over steps 3-4,
    # which took 300 ms each instead of 100.
    steps = [100.0] * 10
    steps[3] = steps[4] = 300.0
    run = _run(steps, [(1_000_310.0, 1_000_690.0)])
    assert cost(run) == pytest.approx(400.0)


def test_two_captures_share_the_extra():
    steps = [100.0] * 10
    steps[1] = 250.0
    steps[7] = 250.0
    t = 1_000_000.0
    run = _run(steps, [(t + 110, t + 240), (t + 860, t + 1000)])
    assert cost(run) == pytest.approx(150.0)


def test_nothing_to_read_without_captures():
    assert cost(_run([100.0] * 5, [])) is None
