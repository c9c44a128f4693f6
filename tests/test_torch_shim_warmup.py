"""The shim's profiler warmup (TraceClient(warmup_profiler=...),
warmup_done, _sweep_warmup_dirs) in the port (dynolog_tpu_torch.client.shim)
and in the JAX package side by side: the same calls, the same events and
errors, and sweeps that leave each other's directories alone. A fresh
process shows what the warmup buys: the first capture starts warm."""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from dynolog_tpu.client import shim as jax_shim
from dynolog_tpu_torch.client import shim

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jax_shim, "torch": shim}


def _client(mod, profiler, warmup: bool):
    return mod.TraceClient(job_id=7, endpoint="dynotpu_warmup_nodaemon",
                           profiler=profiler, warmup_profiler=warmup,
                           report_interval_s=0, step_start_timeout_s=3)


def _warm(client) -> None:
    """Runs the client's poll loop up to its first poll, here: the warmup
    (if any) and warmup_done, with no daemon to poll."""
    client._stop.set()
    client._poll_loop()
    client._stop.clear()


def _duration_capture(mod, client, tmp_path, name: str) -> dict:
    """One 50 ms duration capture run as the poll thread runs it; returns
    its manifest as written on disk."""
    log = tmp_path / f"{name}.json"
    client._run_trace(mod.TraceConfig.parse(
        f"ACTIVITIES_LOG_FILE={log}\nACTIVITIES_DURATION_MSECS=50"))
    client.stop()  # the JAX client's finishers write late manifests
    return json.loads((tmp_path / f"{name}_{os.getpid()}.json").read_text())


class _FailingStart:
    """A profiler mixin whose first start() raises, as a profiler that
    cannot initialize would."""

    failed = False

    def start(self, trace_dir, *args, **kwargs):
        if not self.failed:
            self.failed = True
            raise RuntimeError("no profiler here")
        super().start(trace_dir, *args, **kwargs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_warmup_runs_before_the_first_capture(pkg, tmp_path):
    mod = PACKAGES[pkg]
    profiler = mod.RecordingProfiler()
    client = _client(mod, profiler, warmup=True)
    assert not client.warmup_done.is_set()
    _warm(client)
    assert client.warmup_done.is_set() and client.last_error is None
    start, stop = profiler.calls[:2]
    warmup_dir = start[1]
    prefix = "dynolog_tpu_torch_warmup_" if pkg == "torch" else (
        "dynolog_tpu_warmup_")
    assert start[0] == "start" and stop == ("stop", None)
    assert os.path.basename(warmup_dir).startswith(prefix)
    assert not os.path.exists(warmup_dir)  # removed in a finally
    n_warm = len(profiler.calls)
    manifest = _duration_capture(mod, client, tmp_path, "after")
    assert manifest["status"] == "ok", manifest
    capture = [c for c in profiler.calls[n_warm:] if c[0] == "start"]
    assert capture == [("start", manifest["trace_dir"])]
    assert all(c[1] == warmup_dir for c in profiler.calls[:n_warm]
               if c[0] in ("start", "export"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_warmup_lands_in_last_error(pkg, tmp_path):
    mod = PACKAGES[pkg]
    failing = type("Failing", (_FailingStart, mod.RecordingProfiler), {})
    client = _client(mod, failing(), warmup=True)
    _warm(client)
    assert client.warmup_done.is_set()
    assert client.last_error == "profiler warmup failed: no profiler here"
    manifest = _duration_capture(mod, client, tmp_path, "after_failure")
    assert manifest["status"] == "ok", manifest
    assert client.traces_completed == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_warmup_makes_no_call(pkg):
    mod = PACKAGES[pkg]
    profiler = mod.RecordingProfiler()
    client = _client(mod, profiler, warmup=False)
    assert not client.warmup_done.is_set()
    _warm(client)
    assert client.warmup_done.is_set()
    assert profiler.calls == [] and client.last_error is None
    client.stop()


def _dirs(root: Path, old: float) -> dict:
    """An expired and a fresh warmup dir of each package under `root`."""
    made = {}
    for pkg, prefix in (("torch", "dynolog_tpu_torch_warmup_"),
                        ("jax", "dynolog_tpu_warmup_")):
        for age in ("expired", "fresh"):
            d = root / f"{prefix}{age}"
            d.mkdir()
            (d / "x.pt.trace.json").write_text("{}")
            if age == "expired":
                os.utime(d, (old, old))
            made[pkg, age] = d
    return made


def test_each_sweep_reclaims_its_own_expired_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    made = _dirs(tmp_path, time.time() - 3600)
    assert shim._sweep_warmup_dirs(60) == [str(made["torch", "expired"])]
    assert jax_shim._sweep_warmup_dirs(60) == [str(made["jax", "expired"])]
    assert {k for k, d in made.items() if d.exists()} == {
        ("torch", "fresh"), ("jax", "fresh")}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("ttl_s", [0, -1])
def test_sweep_without_a_ttl_sweeps_nothing(pkg, ttl_s, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    made = _dirs(tmp_path, time.time() - 10 * 24 * 3600)
    assert PACKAGES[pkg]._sweep_warmup_dirs(ttl_s) == []
    assert all(d.exists() for d in made.values())


def test_start_sweeps_and_survives_a_failed_sweep(tmp_path, monkeypatch):
    """start() sweeps the warmup dirs before it registers, and a sweep
    that raises does not fail it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    made = _dirs(tmp_path, time.time() - 3600)
    for broken in (False, True):
        if broken:
            def boom(ttl_s):
                raise OSError("sweep failed")
            monkeypatch.setattr(shim, "_sweep_warmup_dirs", boom)
        client = _client(shim, shim.RecordingProfiler(), warmup=False)
        client.sweep_ttl_s = 60
        order = []
        client._client.register_context = (
            lambda *a, **k: order.append(made["torch", "expired"].exists()))
        client._client.request_config = lambda *a, **k: None
        assert client.start() is False  # no daemon: untraced, not failed
        assert client.warmup_done.wait(10)
        client.stop()
        assert order == [False]  # swept before it registered
    assert made["torch", "fresh"].exists() and made["jax", "expired"].exists()


# One fresh process: the warmup on the poll thread pays the profiler's
# first start, then a duration capture (on the same thread) of a training
# thread that steps. Prints the warmup's timing, the manifest and the
# capture's events' earliest epoch time (us).
_FRESH = r"""
import json, sys, threading, time
import torch
from dynolog_tpu_torch.client.shim import TorchProfiler, TraceClient, TraceConfig

client = TraceClient(job_id=7, endpoint="dynotpu_warmup_nodaemon",
                     profiler=TorchProfiler(), warmup_profiler=True,
                     report_interval_s=0)
done = threading.Event()

def poll():
    client._stop.set()
    client._poll_loop()
    client._stop.clear()
    time.sleep(0.3)  # the window opens well after the warmup's
    client._run_trace(TraceConfig.parse(
        f"ACTIVITIES_LOG_FILE={sys.argv[1]}\nACTIVITIES_DURATION_MSECS=100"))
    done.set()

a = torch.randn(64, 64)
t = threading.Thread(target=poll)
t.start()
while not done.is_set():
    (a @ a).sum()
    client.step()
    time.sleep(0.005)
t.join()
m = client.last_manifest
doc = json.load(open(m["trace_file"]))
base_us = doc["baseTimeNanoseconds"] / 1e3
first = min(e["ts"] + base_us for e in doc["traceEvents"] if e.get("ph") == "X")
print(json.dumps({"warmup": client.warmup_timing, "manifest": m,
                  "first_event_us": first}))
"""


def test_warmup_makes_the_first_capture_start_warm(tmp_path):
    """In a fresh process the warmup pays torch.profiler's first start
    (about 2 s on a CPU), the first capture after it starts in under half
    that, and the capture's trace holds no event from before its window:
    the warmup left nothing behind."""
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, str(tmp_path / "fresh.json")],
        capture_output=True, text=True, timeout=150, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    m, warmup = got["manifest"], got["warmup"]
    assert m["status"] == "ok", m
    assert m["timing"]["profiler_start_ms"] < warmup["profiler_start_ms"] / 2
    # Kineto's clock and time.time() agree within a few ms; the warmup's
    # events would lie 300 ms or more before the window.
    assert got["first_event_us"] >= m["started_ms"] * 1e3 - 50e3, got
