"""The port's SinkWal, DurableSink and acked transport against the JAX
package's: the same on-disk spill queue, byte for byte, in both
directions.

The queue is the C++ daemon's format (segment names, CRC-framed records,
the tmp+rename ack watermark), so a spill dir one package wrote must
recover, peek and ack in the other. Payloads are drawn from a seeded
generator; every comparison is exact (bytes, sequence numbers, counters).
Socket waits are bounded by the senders' own 2 s timeout."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from dynolog_tpu import failpoints as jax_failpoints
from dynolog_tpu import supervise as jax_supervise
from dynolog_tpu_torch import failpoints as torch_failpoints
from dynolog_tpu_torch import supervise as torch_supervise

PACKAGES = {"jax": (jax_supervise, jax_failpoints),
            "torch": (torch_supervise, torch_failpoints)}
# Small segments, so a few dozen records seal several of them.
SEGMENT_BYTES = 256


def _payloads(n: int, seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [json.dumps({"i": i, "cpu_util": float(rng.random()),
                        "pad": "x" * int(rng.integers(0, 90))}).encode()
            for i in range(n)]


def _queue_files(d) -> dict:
    """Every file of the queue but the boot epoch (a wall-clock stamp)."""
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d)) if name != "epoch"}


def _stats(wal) -> dict:
    return {k: v for k, v in wal.stats().items() if k not in ("dir", "epoch")}


def _write(S, d, payloads, *, ack=0, compat_level=1):
    wal = S.SinkWal(str(d), segment_bytes=SEGMENT_BYTES, fsync=False,
                    compat_level=compat_level)
    seqs = [wal.append(lambda seq, p=p: p) for p in payloads]
    if ack:
        assert wal.ack(ack)
    return wal, seqs


@pytest.mark.parametrize("compat_level", [0, 1])
def test_same_appends_give_byte_equal_segments(tmp_path, compat_level):
    payloads = _payloads(30)
    out = {}
    for name, (S, _) in PACKAGES.items():
        wal, seqs = _write(S, tmp_path / name, payloads, ack=9,
                           compat_level=compat_level)
        out[name] = (seqs, _stats(wal), wal.peek(64))
        wal.close()
        out[name] += (_queue_files(tmp_path / name),)
    assert out["torch"] == out["jax"]
    seqs, stats, peeked, files = out["torch"]
    assert seqs == list(range(1, 31))
    assert stats["segments"] > 2  # several sealed segments and an open one
    assert [seq for seq, _ in peeked] == list(range(10, 31))
    assert files["ack"] == b"9\n"


def _damage(d, kind: str) -> None:
    segs = sorted(n for n in os.listdir(d) if n.startswith("wal-"))
    path = os.path.join(d, segs[-1] if kind == "torn" else segs[-2])
    data = open(path, "rb").read()
    if kind == "torn":
        data = data[:-5]  # a crash mid-append: the last frame cut short
    else:
        data = data[:20] + bytes([data[20] ^ 0xFF]) + data[21:]  # CRC damage
    open(path, "wb").write(data)


@pytest.mark.parametrize("damage", ["torn", "crc"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_queue_recovers_across_packages(tmp_path, writer, reader, damage):
    W, R = PACKAGES[writer][0], PACKAGES[reader][0]
    wal, _ = _write(W, tmp_path / "q", _payloads(24, seed=1), ack=5)
    wal.close()
    _damage(tmp_path / "q", damage)
    shutil.copytree(tmp_path / "q", tmp_path / "own")
    results = {}
    for who, S, d in (("reader", R, tmp_path / "q"),
                      ("writer", W, tmp_path / "own")):
        wal = S.SinkWal(str(d), segment_bytes=SEGMENT_BYTES, fsync=False)
        peeked = wal.peek(64)
        acked = wal.ack(peeked[len(peeked) // 2][0])
        seq = wal.append(lambda seq: json.dumps({"wal_seq": seq}))
        results[who] = (peeked, acked, seq, _stats(wal))
        wal.close()
        results[who] += (_queue_files(d),)
    # The other package recovers the queue exactly as its writer does.
    assert results["reader"] == results["writer"]
    peeked, acked, seq, stats, _ = results["reader"]
    assert acked and peeked[0][0] == 6
    if damage == "torn":
        assert stats["corrupt_records"] == 0
        assert seq == 24  # the torn record is gone; its seq is reused
    else:
        assert stats["corrupt_records"] > 0
        assert seq == 25


def _fake_clock():
    t = [0.0]

    def now():
        return t[0]

    return t, now


def _drive_sink(S, fp, d, spec: str, site: str) -> dict:
    fp.disarm_all()
    # Hit counts live as long as the process: count this run's alone (an
    # earlier test in the same worker process may have fired the site).
    before = fp.hits(site)
    fp.arm(site, spec)
    t, now = _fake_clock()
    wal = S.SinkWal(str(d), segment_bytes=SEGMENT_BYTES, fsync=False)
    delivered = []

    def send(batch):
        delivered.extend(json.loads(p)["i"] for _, p in batch)
        return batch[-1][0]

    sink = S.DurableSink(wal, send, breaker=S.SinkBreaker(
        "t", retry_initial_s=1.0, retry_max_s=4.0, now=now))
    returned = []
    try:
        for i in range(8):
            returned.append(sink.publish(
                lambda seq, i=i: json.dumps({"i": i, "wal_seq": seq})))
            t[0] += 5.0  # past any backoff window
        sink.drain()
    finally:
        fp.disarm_all()
    out = {"returned": returned, "delivered": delivered,
           "deferred": len(sink.deferred), "drops": sink.deferred_drops,
           "stats": _stats(wal), "hits": fp.hits(site) - before}
    wal.close()
    out["files"] = _queue_files(d)
    return out


@pytest.mark.parametrize("site,spec", [
    ("wal.append.write", "errno:ENOSPC*3"),
    ("wal.ack.persist", "errno:EIO*2"),
    ("wal.seal.rename", "errno:EIO*2"),
])
def test_durable_sink_under_failpoints(tmp_path, site, spec):
    runs = {name: _drive_sink(S, fp, tmp_path / name, spec, site)
            for name, (S, fp) in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    run = runs["torch"]
    assert run["hits"] >= 1
    # Never lost and never corrupt: every interval delivered. A refused
    # ack leaves the watermark where it was, so its records replay
    # (at-least-once); every other refusal delivers each interval once.
    assert set(run["delivered"]) == set(range(8))
    if site != "wal.ack.persist":
        assert sorted(run["delivered"]) == list(range(8))
    else:
        assert len(run["delivered"]) > 8
    assert run["deferred"] == 0 and run["drops"] == 0
    assert run["stats"]["corrupt_records"] == 0
    if site == "wal.append.write":
        assert 0 in run["returned"]  # an interval was deferred


@pytest.mark.parametrize("sender,relay", [("torch", "jax"),
                                          ("jax", "torch")])
def test_acked_transport_across_packages(tmp_path, sender, relay):
    S, R = PACKAGES[sender][0], PACKAGES[relay][0]
    server = R.AckingRelay(0)
    out = None
    try:
        wal = S.SinkWal(str(tmp_path / "spill"), fsync=False)
        tx = S.AckedTcpSender("127.0.0.1", server.port)
        sink = S.DurableSink(wal, tx)
        try:
            for i in range(5):
                sink.publish(lambda seq, i=i: json.dumps(
                    {"host": "h0", "i": i, "wal_seq": seq}))
            out = (sink.delivered, wal.stats(), server.unique())
        finally:
            tx.close()
            wal.close()
    finally:
        server.sever()
    delivered, stats, seen = out
    assert delivered == 5
    assert stats["acked_seq"] == stats["last_seq"] == 5
    assert stats["pending_records"] == 0
    assert seen == {1, 2, 3, 4, 5}
