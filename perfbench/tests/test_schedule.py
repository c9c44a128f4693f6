"""The capture schedule: an open loop at the traffic's fixed rate, with no
capture due so late that its stop and export would fall after the window,
and each request made with the traffic's own `dyno` arguments."""

import threading
import time

import pytest

from perfbench import harness


class _Dyno:
    """Stands in for dynologd: records each request's time and arguments."""

    def __init__(self):
        self.asked = []
        self.lock = threading.Lock()

    def gputrace(self, job_id, log_file, args):
        with self.lock:
            self.asked.append((time.time(), job_id, list(args)))
        return 0, ""


@pytest.mark.parametrize("last_due,want", [(0.0, 4), (0.25, 3), (0.55, 2)])
def test_no_capture_is_due_after_the_last_due_time(tmp_path, last_due, want):
    # Due at 0.1, 0.4, 0.7 and 1.0 s of a 1.0 s window.
    dyno = _Dyno()
    spec = {"every_s": 0.3, "first_after_s": 0.1,
            "last_due_before_end_s": last_due,
            "dyno_args": ["--iterations=2", "--python_tracer_level=0"]}
    t0 = time.time()
    caps = harness.Captures(dyno, 42, tmp_path, spec, t0, t0 + 1.0 + 1e-6)
    caps.start()
    caps.join(timeout=5)
    assert len(caps.fired) == want == len(dyno.asked)
    for k, (asked, job_id, args) in enumerate(dyno.asked):
        assert job_id == 42
        assert args == spec["dyno_args"]
        assert asked - t0 >= 0.1 + 0.3 * k - 1e-3
    assert all(f["due"] <= t0 + 1.0 - last_due + 1e-6 for f in caps.fired)


def test_halt_ends_the_schedule(tmp_path):
    dyno = _Dyno()
    spec = {"every_s": 10.0, "first_after_s": 10.0, "dyno_args": []}
    t0 = time.time()
    caps = harness.Captures(dyno, 1, tmp_path, spec, t0, t0 + 60)
    caps.start()
    caps.halt.set()
    caps.join(timeout=5)
    assert not caps.is_alive() and caps.fired == []


@pytest.mark.parametrize("dyno_args", [
    ["--iterations=2"],
    ["--duration_ms=300", "--python_tracer_level=0"]],
    ids=["iterations", "python_tracer_level_0"])
def test_another_capture_mix_runs_as_data(dyno_args):
    """A later mix (iteration windows, a knob) needs only its traffic's
    dyno arguments: the whole run on the CPU, through dynologd and the
    shim, checks every capture and comes out correct."""
    from perfbench.tests import tiny

    out = tiny.run("deepseek_llm_7b.gputrace", seconds=4.0,
                   dyno_args=dyno_args)
    res = out["result"]
    assert res["correct"] is True, out["detail"]
    assert res["attempted"] >= 2 and res["failed"] == 0


def test_shim_arguments_come_from_the_traffic(tmp_path):
    """The traffic's `shim` reaches TraceClient: here the capture ring's
    autotrigger, which samples the attached job as data asks."""
    from perfbench.tests import tiny
    from perfbench.tests.conftest import ROOT

    bench, model, traffic = tiny.spec("deepseek_llm_7b.attached")
    traffic["shim"] = {"ring": {"every_n_steps": 5, "min_interval_s": 0.5,
                                "window_ms": 100, "dir": str(tmp_path)}}
    out = harness.run_spec(ROOT, bench, "deepseek_llm_7b.attached", model,
                           traffic, 11, 4.0, False, "cpu")
    assert out["result"]["correct"] is True, out["detail"]
    assert any(p.is_file() for p in tmp_path.rglob("*"))
