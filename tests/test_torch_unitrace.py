"""The port's cluster fan-out (dynolog_tpu_torch.cluster): unitrace's
requests and the framed RPC client held to the JAX package's, host
discovery against stub schedulers, and one synchronized capture across
two live daemons, each serving a port TraceClient on the CPU."""

import argparse
import json
import os
import re
import socket
import stat
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import dynolog_tpu
import dynolog_tpu_torch
from daemon_utils import start_daemon, stop_daemon
from dynolog_tpu import obs as jax_obs
from dynolog_tpu.cluster import rpc as jax_rpc
from dynolog_tpu.cluster import unitrace as jax_unitrace
from dynolog_tpu_torch import obs
from dynolog_tpu_torch.cluster import rpc, unitrace

REPO_ROOT = Path(__file__).resolve().parent.parent


def _args(**overrides) -> argparse.Namespace:
    """unitrace's parsed arguments with its defaults, as main() builds
    them (plus all_hosts, which main() adds after discovery)."""
    fields = dict(
        log_file="/tmp/pod.json", iterations=-1, iteration_roundup=1,
        duration_ms=500, job_id=55, process_limit=3, pids="0,17",
        metric="job55.step_time_p50_ms", above="25", below="",
        for_ticks=2, cooldown_s=300, max_fires=0, peer_sync=False,
        sync_delay_ms=2000, port=1778, all_hosts=[])
    fields.update(overrides)
    return argparse.Namespace(**fields)


def _jax_args(**overrides) -> argparse.Namespace:
    """The same arguments for the JAX package's unitrace, whose
    auto-trigger also reads --capture and --profiler-port (their
    defaults: the port always sends them)."""
    return _args(capture="shim", profiler_port=9012, **overrides)


@pytest.mark.parametrize("overrides", [
    {}, {"iterations": 3, "iteration_roundup": 5}, {"pids": ""}],
    ids=["duration", "iterations", "no_pids"])
def test_trace_requests_match_jax_package(overrides):
    start_ms = 1_700_000_000_123
    assert unitrace.build_trace_config(_args(**overrides), start_ms) == \
        jax_unitrace.build_trace_config(_jax_args(**overrides), start_ms)
    assert unitrace.build_gputrace_request(_args(**overrides), start_ms) == \
        jax_unitrace.build_gputrace_request(_jax_args(**overrides), start_ms)


@pytest.mark.parametrize("overrides", [
    {},
    {"above": "", "below": "10.5"},
    {"peer_sync": True, "sync_delay_ms": 4000,
     "all_hosts": ["h1", "h2:1779", "fe80::1", "[fe80::2]:1780"]},
], ids=["above", "below", "peer_sync"])
def test_autotrigger_request_matches_jax_package(overrides):
    for label in ("h1", "h2:1779"):
        ours = unitrace.build_autotrigger_request(_args(**overrides), label)
        assert ours == jax_unitrace.build_autotrigger_request(
            _jax_args(**overrides), label)
        assert ours["capture"] == "shim"
    if overrides.get("peer_sync"):
        assert ours["peers"] == "h1:1778,[fe80::1]:1778,[fe80::2]:1780"


def test_discovery_and_host_parsing_match_jax_package(tmp_path, monkeypatch):
    for name, script in (
            ("squeue", 'echo "node[1-3]"\n'),
            ("scontrol", 'printf "node1\\nnode2\\nnode3\\n"\n'),
            ("kubectl", 'printf "10.8.0.4\\n10.8.1.7\\n\\n"\n')):
        p = tmp_path / name
        p.write_text("#!/bin/sh\n" + script)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    assert unitrace.discover_slurm_hosts("1234") == [
        "node1", "node2", "node3"]
    assert unitrace.discover_gke_hosts("job-name=train", "default") == [
        "10.8.0.4", "10.8.1.7"]
    for entry in ("h1", "h1:1779", "[fe80::1]:1780", "fe80::1"):
        assert unitrace.split_host_port(entry, 1778) == \
            jax_unitrace.split_host_port(entry, 1778)
    doc = {"metrics": {"a": {"m": 1.0, "x": 2.0}, "b": {}},
           "hosts_detail": {"b": {"state": "lost"}, "c": {"state": "live"}}}
    assert unitrace.fleet_rows(doc, ["m"]) == \
        jax_unitrace.fleet_rows(doc, ["m"])


@pytest.mark.parametrize("argv", [
    ["--hosts", "a", "--tpu-name", "pod", "--zone", "z", "--log-file", "t"],
    ["--hosts", "a", "--autotrigger", "--metric", "m", "--above", "1",
     "--capture", "push", "--log-file", "t"],
    ["--hosts", "a", "--autotrigger", "--metric", "m", "--above", "1",
     "--profiler-port", "9012", "--log-file", "t"],
], ids=["tpu_name", "capture_push", "profiler_port"])
def test_dropped_options_are_rejected(argv):
    """Cloud TPU VM discovery and the push capture are not ported."""
    out = subprocess.run(
        [sys.executable, "-m", "dynolog_tpu_torch.cluster.unitrace", *argv],
        capture_output=True, text=True, timeout=60, cwd=REPO_ROOT)
    assert out.returncode == 2, out
    assert "unrecognized arguments" in out.stderr


class _FrameServer:
    """One-connection framed-JSON server on localhost: records each
    request frame as received, answers it with `reply` (and, for a
    fetchTrace, the chunk frames and the END frame)."""

    def __init__(self, reply: dict, chunks=()):
        self.sock = socket.create_server(("localhost", 0))
        self.port = self.sock.getsockname()[1]
        self.frames: list[bytes] = []
        self.reply, self.chunks = reply, chunks
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        with conn:
            while True:
                head = conn.recv(4, socket.MSG_WAITALL)
                if len(head) < 4:
                    return
                (n,) = struct.unpack("<i", head)
                self.frames.append(head + conn.recv(n, socket.MSG_WAITALL))
                body = json.dumps(self.reply).encode()
                out = struct.pack("<i", len(body)) + body
                for chunk in self.chunks:
                    out += struct.pack("<i", len(chunk)) + chunk
                if self.chunks:
                    out += struct.pack("<i", 0)
                conn.sendall(out)

    def close(self):
        self.sock.close()
        self.thread.join(timeout=5)


def _frames(client_mod, action, reply, chunks=()) -> tuple[list, object]:
    server = _FrameServer(reply, chunks)
    try:
        with client_mod.FramedRpcClient("localhost", server.port,
                                        timeout_s=5) as client:
            result = action(client)
    finally:
        server.close()
    return server.frames, result


def test_rpc_frames_match_jax_package(tmp_path):
    ctx = "00000000000000aa/00000000000000bb"
    request = {"fn": "setKinetOnDemandRequest", "config": "A=1\nB=2",
               "job_id": 55, "pids": [0], "process_limit": 3,
               "trace_ctx": ctx}
    ok = {"status": "ok", "processesMatched": [1]}
    ours, got = _frames(rpc, lambda c: c.call(request), ok)
    theirs, want = _frames(jax_rpc, lambda c: c.call(request), ok)
    assert ours == theirs and len(ours) == 1 and got == want == ok

    hello = {"status": "ok", "proto": 1}
    ours, got = _frames(rpc, lambda c: c.hello(), hello)
    theirs, want = _frames(jax_rpc, lambda c: c.hello(), hello)
    sent = [json.loads(f[4:]) for f in ours + theirs]
    builds = [s.pop("build") for s in sent]
    for s in sent:
        s.pop("trace_ctx")
    assert sent[0] == sent[1] == {"fn": "hello", "proto": 1}
    assert builds == [f"py-{dynolog_tpu_torch.__version__}",
                      f"py-{dynolog_tpu.__version__}"]
    assert got == want == {"status": "ok", "proto": 1, "negotiated": 1}

    header = {"status": "ok", "stream": "chunks"}
    fetch = {"fn": "fetchTrace", "path": "/t/x.json", "trace_ctx": ctx}
    chunks = [b"abc" * 100, b"def"]
    sunk = {"ours": [], "theirs": []}
    ours, got = _frames(rpc, lambda c: c.call_streaming(
        fetch, sunk["ours"].append), header, chunks)
    theirs, _ = _frames(jax_rpc, lambda c: c.call_streaming(
        fetch, sunk["theirs"].append), header, chunks)
    assert ours == theirs and got["streamed_bytes"] == 303
    assert b"".join(sunk["ours"]) == b"".join(sunk["theirs"])
    _, got = _frames(rpc, lambda c: c.fetch_to_file(
        "/t/x.json", str(tmp_path / "fetched.json")), header, chunks)
    assert got["status"] == "ok"
    assert (tmp_path / "fetched.json").read_bytes() == b"".join(chunks)


def test_rpc_connect_failpoint_reads_as_unreachable():
    from dynolog_tpu_torch import failpoints

    failpoints.arm("cluster.rpc_connect", "error*1")
    try:
        with rpc.FramedRpcClient("localhost", 1, timeout_s=1) as client:
            assert client.call({"fn": "getStatus"}) is None
    finally:
        failpoints.disarm("cluster.rpc_connect")


def test_trace_context_additions_parse_in_jax_package():
    parent = obs.TraceContext.mint()
    child = parent.child()
    theirs = jax_obs.TraceContext.parse(child.header())
    assert (theirs.trace_id, theirs.span_id) == (child.trace_id,
                                                 child.span_id)
    assert child.trace_id == parent.trace_id
    assert child.span_id not in (0, parent.span_id)
    token_ctx = obs.current()
    try:
        obs.set_current(parent)
        assert obs.current() is parent
        with obs.span("cluster.rpc.x") as rec:
            assert rec.trace_id == parent.trace_id
            assert rec.parent_id == parent.span_id
    finally:
        obs.set_current(token_ctx)


RANK_SCRIPT = """
import sys, time
import torch
from dynolog_tpu_torch.client import TraceClient
torch.set_num_threads(1)
client = TraceClient(job_id=55, endpoint={endpoint!r}, poll_interval_s=0.2,
                     report_interval_s=0)
assert client.start(), client.last_error
print("REGISTERED", flush=True)
a = torch.randn(64, 64)
deadline = time.time() + 60
while time.time() < deadline and client.traces_completed < 1:
    (a @ a).sum()
    client.step()
    time.sleep(0.01)
client.stop()
for proc in client.summary_procs:
    proc.wait(timeout=60)
sys.exit(0 if client.traces_completed >= 1 else 3)
"""


def _unitrace(*argv, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "dynolog_tpu_torch.cluster.unitrace", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "PYTHONPATH": str(REPO_ROOT)})


def test_fanout_gives_two_daemons_one_start_time(bin_dir, tmp_path):
    """unitrace --hosts against two live daemons, each serving a port
    TraceClient in its own process: both capture, and both manifests carry
    the PROFILE_START_TIME unitrace printed, the windows opening at or
    after it, under the one control-plane trace id it printed; --query
    prints one row per host."""
    daemons = [start_daemon(bin_dir) for _ in range(2)]
    ranks = []
    try:
        for d in daemons:
            rank = subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT.format(endpoint=d.endpoint)],
                stdout=subprocess.PIPE, text=True, cwd=REPO_ROOT,
                env={**os.environ, "PYTHONPATH": str(REPO_ROOT)})
            assert rank.stdout.readline().strip() == "REGISTERED"
            ranks.append(rank)
        hosts = ",".join(f"localhost:{d.port}" for d in daemons)
        log_file = tmp_path / "pod.json"
        out = _unitrace(f"--hosts={hosts}", "--job-id=55",
                        f"--log-file={log_file}", "--duration-ms=200",
                        "--start-time-delay=2")
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.count("[ok]") == 2, out.stdout
        start = int(re.search(r"synchronized start: (\d+)",
                              out.stdout).group(1))
        trace_id = re.search(r"control-plane trace id: ([0-9a-f]{16})",
                             out.stdout).group(1)
        for rank in ranks:
            assert rank.wait(timeout=90) == 0
        manifests = sorted(tmp_path.glob("pod_*.json"))
        assert len(manifests) == 2, sorted(p.name for p in tmp_path.iterdir())
        for m in manifests:
            doc = json.loads(m.read_text())
            assert doc["status"] == "ok" and doc["mode"] == "duration", doc
            assert int(doc["config"]["PROFILE_START_TIME"]) == start
            assert doc["started_ms"] >= start, (doc["started_ms"], start)
            assert doc["trace_ctx"].startswith(trace_id)

        out = _unitrace(f"--hosts={hosts}", "--query=job55.steps_per_sec")
        assert out.returncode == 0, out.stdout + out.stderr
        rows = out.stdout.strip().splitlines()
        assert rows[0].split() == ["host", "job55.steps_per_sec"]
        assert [r.split()[0] for r in rows[1:]] == hosts.split(",")
    finally:
        for rank in ranks:
            rank.kill()
            rank.wait()
        for d in daemons:
            stop_daemon(d)
