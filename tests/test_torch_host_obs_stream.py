"""The port's perf CLI sampler, latency histograms and chunk streaming
against the JAX package's: the same `perf script` text parses to the
same samples, summary and commands; the same observations render the
same OpenMetrics exposition, byte for byte; the same chunks reach the
same sinks with the same results.

Inputs are drawn from seeded generators; every comparison is exact. No
test needs perf(1): the sampler's subprocess leg runs a stand-in script
that prints canned `perf script` text."""

from __future__ import annotations

import json
import math
import os
import stat
import threading

import numpy as np
import pytest

from dynolog_tpu import obs as jax_obs
from dynolog_tpu import stream as jax_stream
from dynolog_tpu import trace as jax_trace
from dynolog_tpu.host import perfcli as jax_perfcli
from dynolog_tpu_torch import obs as torch_obs
from dynolog_tpu_torch import stream as torch_stream
from dynolog_tpu_torch.host import perfcli as torch_perfcli

PERFCLI = {"jax": jax_perfcli, "torch": torch_perfcli}
OBS = {"jax": jax_obs, "torch": torch_obs}
STREAM = {"jax": jax_stream, "torch": torch_stream}
# The atomic chunked write each package's artifacts go through.
WRITE = {"jax": jax_trace.stream_write, "torch": torch_stream.stream_write}

CANNED = """\
python 12345/12346 [003]  1710.123456:     250000 task-clock:  ffff someip
swapper     0/0     [000]  1710.123789:          1 cycles:  ffff other
# a comment line
           bench 777/778 [001]  1711.000001:     125000 task-clock: 55 sym
not a sample line at all
pt_main_thread 4242/4250 [007] 1712.5:   1000 raw_syscalls:sys_enter: x
"""


def _script_text(seed: int, n: int = 200) -> str:
    rng = np.random.default_rng(seed)
    comms = ["python", "pt_main_thread", "dynologd", "kworker/3:1",
             "cuda-EvtHandlr", "ncclProxy 0"]
    events = ["task-clock", "cycles", "cpu-clock", "cycles:u",
              "raw_syscalls:sys_enter", "instructions"]
    lines = []
    for _ in range(n):
        pid = int(rng.integers(1, 1 << 22))
        lines.append(
            f"{' ' * int(rng.integers(0, 12))}{rng.choice(comms)} "
            f"{pid}/{pid + int(rng.integers(0, 40))} "
            f"[{int(rng.integers(0, 64)):03d}] "
            f"{float(rng.uniform(1, 1e5)):.6f}: "
            f"{int(rng.integers(1, 1 << 30)):>10} {rng.choice(events)}: "
            f"{int(rng.integers(0, 1 << 48)):x} sym")
        if rng.random() < 0.1:
            lines.append("# lost 3 events")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_perf_script_parses_alike(seed):
    text = CANNED if seed is None else _script_text(seed)
    out = {}
    for pkg, P in PERFCLI.items():
        samples = [s for s in map(P.parse_script_line, text.splitlines())
                   if s]
        out[pkg] = ([vars(s) for s in samples], P.summarize(samples))
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["samples"] > 0


@pytest.mark.parametrize("kwargs", [
    {}, {"pid": 4242}, {"cpus": "0-3"}, {"pid": 7, "cpus": "1"},
    {"events": ("cycles", "instructions"), "freq": 999},
])
def test_perf_commands_alike(kwargs):
    cmds = {pkg: (P.PerfCliSampler(**kwargs).record_cmd(2.0, "/t/p.data"),
                  P.PerfCliSampler(**kwargs).script_cmd("/t/p.data"))
            for pkg, P in PERFCLI.items()}
    assert cmds["torch"] == cmds["jax"]


def _fake_perf(d) -> str:
    """A stand-in perf(1): `record -o F ...` creates F, `script` prints
    the canned text."""
    canned = d / "canned.txt"
    canned.write_text(CANNED + _script_text(3, 50))
    path = d / "perf"
    path.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = record ]; then\n'
        '  while [ "$1" != -o ]; do shift; done; : > "$2"; exit 0\n'
        "fi\n"
        f'cat "{canned}"\n')
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_perf_sampler_and_cli_alike(tmp_path, monkeypatch, capsys):
    perf = _fake_perf(tmp_path)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ.get('PATH', '')}")
    out = {}
    for pkg, P in PERFCLI.items():
        samples = P.PerfCliSampler(pid=1, perf_bin=perf).sample(0.01)
        rc = P.main(["--duration", "0.01", "--pid", "1", "--json"])
        out[pkg] = ([vars(s) for s in samples], rc,
                    json.loads(capsys.readouterr().out))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 0 and out["torch"][2]["samples"] > 50


def test_perf_cli_without_perf_alike(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))  # holds no perf
    out = {}
    for pkg, P in PERFCLI.items():
        rc = P.main(["--duration", "0.01"])
        out[pkg] = (rc, capsys.readouterr().out)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1 and "error" in json.loads(out["torch"][1])


def _observations(seed: int) -> list:
    rng = np.random.default_rng(seed)
    values = list(rng.lognormal(-3.0, 2.0, size=300))
    # The edges: each bound exactly, beyond the last, zero, negative and
    # NaN clock skew.
    values += list(jax_obs.DEFAULT_BOUNDS) + [25.0, 0.0, -1.0, math.nan]
    labels = rng.choice(["5", "7", "14 h2", "14 h0", "a\"b"],
                        size=len(values))
    return list(zip(values, labels))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_equal(seed):
    texts = {}
    for pkg, O in OBS.items():
        labeled = O.HistogramFamily(
            "dynolog_capture_latency_seconds", "RPC to manifest",
            label_key="phase")
        plain = O.HistogramFamily("dynolog_rpc_seconds", "one series")
        for value, label in _observations(seed):
            labeled.observe(float(value), str(label))
            plain.observe(float(value))
        texts[pkg] = O.render_exposition([labeled, plain])
    assert texts["torch"] == texts["jax"]
    assert texts["torch"].endswith("# EOF\n")
    assert torch_obs.DEFAULT_BOUNDS == jax_obs.DEFAULT_BOUNDS


def test_histogram_counts_alike():
    hists = {pkg: O.Histogram() for pkg, O in OBS.items()}
    for value, _ in _observations(5):
        for h in hists.values():
            h.observe(float(value))
    jax_h, torch_h = hists["jax"], hists["torch"]
    assert (torch_h.buckets, torch_h.count, torch_h.sum) == \
        (jax_h.buckets, jax_h.count, jax_h.sum)
    values = [0.0005, 1e-9, 123456.789, 2.5, 1.0 / 3.0, 1e21]
    assert [torch_obs._fmt(v) for v in values] == \
        [jax_obs._fmt(v) for v in values]


def _blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n,chunk", [(0, 16), (100, 16), (4096, 4096),
                                     (5000, 1024), (3 << 20, None)])
def test_chunk_views_alike(n, chunk):
    data = _blob(n, n)
    args = () if chunk is None else (chunk,)
    views = {pkg: [bytes(v) for v in S.chunk_views(data, *args)]
             for pkg, S in STREAM.items()}
    assert views["torch"] == views["jax"]
    assert b"".join(views["torch"]) == data
    assert torch_stream.CHUNK_BYTES == jax_stream.CHUNK_BYTES


def _sinks(write, d):
    def to_file(chunks):
        return write(str(d / "artifact"), chunks)

    def dies(chunks):
        for i, _ in enumerate(chunks):
            if i == 2:
                raise ValueError("sink died at chunk 2")
        return "never"

    def count(chunks):
        return sum(len(c) for c in chunks)

    return [to_file, dies, count]


def _results(results) -> list:
    return [(r.value, type(r.error).__name__ if r.error else None,
             str(r.error) if r.error else None) for r in results]


@pytest.mark.parametrize("producer_fails", [False, True])
def test_fanout_alike(tmp_path, producer_fails):
    data = _blob(7, 40_000)
    out = {}
    for pkg, S in STREAM.items():
        d = tmp_path / pkg
        d.mkdir()

        def chunks():
            for i, chunk in enumerate(S.chunk_views(data, 4096)):
                if producer_fails and i == 5:
                    raise OSError("producer died")
                yield chunk

        if producer_fails:
            with pytest.raises(OSError):
                S.fanout(chunks(), _sinks(WRITE[pkg], d), max_chunks=2)
            results = None
        else:
            results = _results(S.fanout(chunks(), _sinks(WRITE[pkg], d),
                                        max_chunks=2))
        out[pkg] = (results, sorted(os.listdir(d)),
                    [open(d / n, "rb").read() for n in sorted(os.listdir(d))])
    assert out["torch"] == out["jax"]
    results, names, blobs = out["torch"]
    if producer_fails:
        assert names == []  # the artifact never renamed into place
    else:
        assert results[1][1] == "ValueError" and results[2][0] == len(data)
        assert blobs == [data]


def test_bounded_queue_failure_and_abandon_alike():
    out = {}
    for pkg, S in STREAM.items():
        q = S.BoundedChunkQueue(max_chunks=2)
        got, err = [], []

        def consume():
            try:
                for chunk in q:
                    got.append(chunk)
            except S.StreamFailed as e:
                err.append(str(e))

        t = threading.Thread(target=consume)
        t.start()
        assert q.put(b"a") and q.put(b"b")
        q.fail(RuntimeError("collector died"))
        t.join(timeout=10)
        abandoned = S.BoundedChunkQueue(max_chunks=1)
        abandoned.abandon()
        out[pkg] = (got, err, abandoned.put(b"x"))
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([b"a", b"b"], ["collector died"], False)
