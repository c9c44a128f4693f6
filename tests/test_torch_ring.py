"""The port's continuous capture ring (dynolog_tpu_torch.client.shim
CaptureRing): sampling cadence, compact promotion, K-retention, TTL sweep,
contained failures, env opt-in, a sample through TraceClient's poll
thread with a real torch.profiler on the CPU, and the first-capture
divergence from the JAX package's ring."""

import json
import os
import pathlib
import sys
import time

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from xspace_fixture import build_xspace  # noqa: E402

from dynolog_tpu.client import shim as jax_shim  # noqa: E402
from dynolog_tpu_torch import diagnose, trace  # noqa: E402
from dynolog_tpu_torch.client import shim  # noqa: E402
from dynolog_tpu_torch.client.shim import (  # noqa: E402
    CaptureRing, RingConfig, TorchProfiler, TraceClient)

KERNELS = {f"void fusion.{i}(float*)": 0.01 * i for i in range(1, 9)}


def _kineto(kernel_ms) -> str:
    events, t = [], 0.0
    for name, ms in kernel_ms.items():
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                       "tid": 7, "ts": t, "dur": ms * 1e3,
                       "args": {"device": 0}})
        t += ms * 1e3 + 1.0
    return json.dumps({"traceEvents": events})


class FakeTake:
    """A ring window's stand-in: writes a Chrome trace into the dir it is
    given, as TraceClient._ring_sample exports one."""

    def __init__(self, kernel_ms=None):
        self.kernel_ms = kernel_ms or KERNELS
        self.dirs = []

    def __call__(self, trace_dir):
        self.dirs.append(trace_dir)
        path = os.path.join(trace_dir, "w" + trace.TRACE_SUFFIX)
        with open(path, "w") as f:
            f.write(_kineto(self.kernel_ms))
        return path, {"window_ms": 1}


def _ring(tmp_path, **kw) -> CaptureRing:
    defaults = dict(every_n_steps=10, keep=3, window_ms=1,
                    dir=str(tmp_path / "ring"), model="m",
                    min_interval_s=0.0)
    defaults.update(kw)
    return CaptureRing(RingConfig(**defaults))


def test_ring_samples_on_step_boundary_and_promotes(tmp_path):
    ring = _ring(tmp_path)
    take = FakeTake()
    for step in range(1, 10):
        ring.note_step(step)
        assert not ring.due(), step
    ring.note_step(10)
    assert ring.due()
    path = ring.capture(take)
    assert path and os.path.exists(path), ring.last_error
    doc = json.loads(pathlib.Path(path).read_text())
    assert doc["schema"] == 1
    assert doc["kind"] == "dynolog_tpu.ring_profile"
    assert doc["model"] == "m" and doc["step"] == 10
    # Per-kernel resolution: the diagnosable unit.
    assert [o["op"] for o in doc["summary"]["top_ops"]][:2] == [
        "fusion.8", "fusion.7"]
    assert doc["summary"]["trace_bytes"] > 0
    assert ring.last_timing["window_ms"] == 1
    assert {"take_ms", "promote_ms"} <= set(ring.last_timing)
    # The raw capture dir is gone — the ring keeps summaries.
    assert not any(os.path.exists(d) for d in take.dirs)


def test_ring_envelope_matches_jax_ring(tmp_path):
    ours = _ring(tmp_path, dir=str(tmp_path / "a"))
    ours.note_step(10)
    theirs = jax_shim.CaptureRing(jax_shim.RingConfig(
        every_n_steps=10, keep=3, window_ms=1, dir=str(tmp_path / "b"),
        model="m", min_interval_s=0.0))
    theirs._last_capture_t = float("-inf")  # past the JAX ring's cap
    theirs.note_step(10)

    class FakeXplaneProfiler:
        def start(self, trace_dir):
            self.dir = trace_dir

        def stop(self):
            run = os.path.join(self.dir, "plugins", "profile", "run")
            os.makedirs(run)
            with open(os.path.join(run, "h.xplane.pb"), "wb") as f:
                f.write(build_xspace(planes=1, events_per_line=20))

    a = json.loads(pathlib.Path(ours.capture(FakeTake())).read_text())
    b = json.loads(pathlib.Path(
        theirs.capture(FakeXplaneProfiler())).read_text())
    assert set(a) == set(b)
    assert {k: a[k] for k in ("schema", "kind", "model", "step",
                              "window_ms")} == {
        k: b[k] for k in ("schema", "kind", "model", "step", "window_ms")}
    assert set(a["summary"]) - {"trace_bytes"} == set(b["summary"]) - {
        "xspace_bytes"}


def test_ring_burst_arms_once_and_rate_cap_holds(tmp_path):
    ring = _ring(tmp_path, min_interval_s=3600.0)
    # A burst crossing several boundaries between polls arms exactly once.
    ring.note_step(35)
    assert ring.due()
    assert ring.capture(FakeTake())
    # Next boundary is rate-capped (one capture per hour).
    ring.note_step(45)
    assert not ring.due()


def test_first_boundary_arms_unlike_jax_ring(tmp_path, monkeypatch):
    """The JAX package's ring starts its clock at 0.0 and compares it
    with time.monotonic(): on a host up for 100 s with a one-hour cap, its
    first boundary is rate-capped. The port's ring starts "never
    captured" and arms."""
    monkeypatch.setattr(time, "monotonic", lambda: 100.0)
    cfg = dict(every_n_steps=10, window_ms=1, dir=str(tmp_path),
               min_interval_s=3600.0)
    theirs = jax_shim.CaptureRing(jax_shim.RingConfig(**cfg))
    ours = CaptureRing(RingConfig(**cfg))
    theirs.note_step(10)
    ours.note_step(10)
    assert not theirs.due()
    assert ours.due()


def test_ring_keeps_newest_k(tmp_path):
    ring = _ring(tmp_path, keep=2)
    paths = []
    for i in range(4):
        ring.note_step((i + 1) * 10)
        p = ring.capture(FakeTake())
        assert p, ring.last_error
        paths.append(p)
        time.sleep(0.002)  # distinct created_ms stamps
    kept = ring.entries()
    assert len(kept) == 2
    assert kept[-1] == paths[-1]
    assert paths[0] not in kept and paths[1] not in kept


def test_ring_ttl_sweep_reclaims_expired(tmp_path):
    ring = _ring(tmp_path, ttl_s=100.0)
    ring.note_step(10)
    old = ring.capture(FakeTake())
    ring.note_step(20)
    fresh = ring.capture(FakeTake())
    past = time.time() - 500
    os.utime(old, (past, past))
    reclaimed = ring.sweep()
    assert old in reclaimed
    assert os.path.exists(fresh)
    assert not os.path.exists(old)


def test_ring_profile_diagnoses_against_baseline(tmp_path, capsys):
    baseline = tmp_path / "base.json"
    diagnose.save_baseline(
        str(baseline),
        trace.compact_profile(_kineto(KERNELS).encode()), model="m")
    slower = dict(KERNELS)
    slower["void fusion.7(float*)"] *= 2.0
    ring = _ring(tmp_path)
    ring.note_step(10)
    assert ring.capture(FakeTake(slower))
    rc = diagnose.main([
        "--ring", str(tmp_path / "ring"), "--model", "m",
        "--baseline", str(baseline), "--json",
        "--out", str(tmp_path / "report.json")])
    assert rc == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["verdict"] == "regressed"
    assert report["target"]["kind"] == "dynolog_tpu.ring_profile"
    assert any(f["op"] == "fusion.7" and f["kind"] == "fusion_regression"
               for f in report["findings"])


def test_ring_failure_is_contained(tmp_path):
    def broken(trace_dir):
        raise RuntimeError("no backend")

    ring = _ring(tmp_path)
    ring.note_step(10)
    assert ring.capture(broken) is None
    assert "ring capture failed" in ring.last_error
    assert not ring.due()  # failed sample consumed; next boundary re-arms
    ring.note_step(20)
    assert ring.due()


class _NoDaemonIpc:
    """IpcClient double: every poll answers instantly with no config (a
    live daemon with nothing pending), so the poll loop spins at its
    nominal cadence."""

    def register_context(self, *a, **kw):
        return 0

    def request_config(self, *a, **kw):
        return ""

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


def test_trace_client_ring_via_poll_loop(tmp_path):
    """End to end through the real TraceClient: steps arm the ring, the
    poll thread arms a window, step() opens and closes torch.profiler on
    this (training) thread, and the poll thread promotes the trace."""
    # The window records Python frames (the JAX capture's default levels),
    # and on a CPU capture their rows outrank the ops: keep every row.
    client = TraceClient(
        job_id=7, endpoint=f"ring_test_{os.getpid()}", poll_interval_s=0.05,
        profiler=TorchProfiler(), report_interval_s=0,
        ring=RingConfig(every_n_steps=5, keep=2, window_ms=30,
                        dir=str(tmp_path / "ring"), model="m",
                        min_interval_s=0.0, top_ops=100_000))
    client._client = _NoDaemonIpc()
    client.start()
    a = torch.randn(32, 32)
    try:
        deadline = time.time() + 30
        while time.time() < deadline and client.ring.captures == 0:
            (a @ a).sum()
            client.step()
            time.sleep(0.002)
    finally:
        client.stop()
    assert client.ring.captures >= 1, client.ring.last_error
    doc = json.loads(pathlib.Path(client.ring.entries()[-1]).read_text())
    summary = doc["summary"]
    assert [p["name"] for p in summary["planes"]] == ["/host:CPU"]
    assert any(o["op"] == "aten::mm" for o in summary["top_ops"])
    assert client.ring.last_timing["window_ms"] >= 30
    assert client.traces_completed == 0  # ring samples are not captures


def test_ring_env_opt_in(tmp_path, monkeypatch):
    monkeypatch.setenv("DYNO_TPU_RING_EVERY_N", "50")
    monkeypatch.setenv("DYNO_TPU_RING_DIR", str(tmp_path / "r"))
    monkeypatch.setenv("DYNO_TPU_RING_KEEP", "junk")  # soft-fails
    client = TraceClient(job_id=1, endpoint="ring_env_test")
    assert client.ring is not None
    assert client.ring.config.every_n_steps == 50
    assert client.ring.config.dir == str(tmp_path / "r")
    assert client.ring.config.keep == RingConfig.keep
    ref = jax_shim.RingConfig.from_env()
    assert vars(RingConfig.from_env()) == vars(ref)
    monkeypatch.setenv("DYNO_TPU_RING_EVERY_N", "0")
    assert TraceClient(job_id=1, endpoint="ring_env_test").ring is None


@pytest.mark.parametrize("name,kept", [
    ("a" + shim.TRACE_SUFFIX, True), ("a" + shim.SUMMARY_SUFFIX, True),
    ("a.pt.trace.json.tmp", True), ("notes.txt", False),
])
def test_session_dir_with_summary_is_still_the_shims(tmp_path, name, kept):
    run = tmp_path / "trace_123"
    run.mkdir()
    (run / name).write_text("")
    assert (shim._trace_session_dir(str(run), "trace") == 123) == kept
