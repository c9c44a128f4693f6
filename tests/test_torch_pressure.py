"""The port's resource governance against the JAX package's: the same
probes and tick script give the same pressure levels and `resources`
snapshots, and every atomic write of the mirror (artifacts, the fleet
diagnosis report, the relay's snapshot) leaves no tmp behind under its
failpoint.

Probes (usage, reclaim, fd, RSS, statvfs) are injected, so every
comparison is exact."""

from __future__ import annotations

import errno
import json
import os
import time

import pytest

from dynolog_tpu import failpoints as jax_failpoints
from dynolog_tpu import supervise as jax_supervise
from dynolog_tpu_torch import failpoints as torch_failpoints
from dynolog_tpu_torch import supervise as torch_supervise

PACKAGES = {"jax": (jax_supervise, jax_failpoints),
            "torch": (torch_supervise, torch_failpoints)}


class FakeVfs:
    f_blocks = 1000
    f_bavail = 1000


def _budget(S, gov, probes):
    """Three classes over a byte budget: the lowest priority reclaims
    first, the never-evict class is never asked."""
    sizes = {"ring": 4000, "art": 4000, "wal": 4000}
    asked = []

    def reclaimer(name):
        def reclaim(target):
            asked.append((name, target))
            freed = min(target, sizes[name])
            sizes[name] -= freed
            return freed
        return reclaim

    gov.register("ring_profiles", priority=0,
                 usage=lambda: (sizes["ring"], 4), reclaim=reclaimer("ring"))
    gov.register("trace_artifacts", priority=10,
                 usage=lambda: (sizes["art"], 4), reclaim=reclaimer("art"))
    gov.register("wal_spill", priority=100, never_evict=True,
                 usage=lambda: (sizes["wal"], 4))
    steps = [("tick",), ("set", sizes, "wal", 9500), ("tick",),
             ("admit",), ("set", sizes, "wal", 100), ("tick",)]
    return steps, asked


def _watermarks(S, gov, probes):
    return [("tick",), ("set", probes, "fds", 85), ("tick",), ("admit",),
            ("set", probes, "fds", 96), ("tick",), ("admit",),
            ("set", probes, "fds", 10), ("set", probes, "rss", 120),
            ("tick",), ("set", probes, "rss", 160), ("tick",),
            ("set", probes, "rss", 50), ("tick",), ("admit",)], []


def _statvfs_floor(S, gov, probes):
    gov.register("artifacts", priority=0, root="/artifacts",
                 usage=lambda: (0, 0))
    vfs = probes["vfs"]
    return [("tick",), ("set", vfs, "f_bavail", 80), ("tick",),
            ("set", vfs, "f_bavail", 20), ("tick",), ("admit",),
            ("set", vfs, "f_bavail", 900), ("tick",)], []


def _write_failure(S, gov, probes):
    return [("fail", "wal.append.write", errno.ENOSPC), ("admit",),
            ("tick",), ("tick",), ("admit",),
            ("reclaim_fail", "autotrigger.prune", "t_trig1_1.json")], []


SCENARIOS = {"budget": _budget, "watermarks": _watermarks,
             "statvfs_floor": _statvfs_floor,
             "write_failure": _write_failure}
GOVERNOR_ARGS = {"budget": dict(disk_budget_bytes=9000),
                 "watermarks": dict(max_fds=100, rss_soft_mb=100),
                 "statvfs_floor": dict(disk_min_free_pct=5.0),
                 "write_failure": dict(max_fds=1000)}


def _drive(S, name: str) -> list:
    probes = {"fds": 10, "rss": 50, "vfs": FakeVfs()}
    health = S.ComponentHealth("resources")
    gov = S.ResourceGovernor(
        health=health, fd_probe=lambda: probes["fds"],
        rss_probe=lambda: probes["rss"],
        statvfs=lambda root: probes["vfs"], **GOVERNOR_ARGS[name])
    steps, asked = SCENARIOS[name](S, gov, probes)
    trail = []
    for step in steps:
        op = step[0]
        if op == "tick":
            trail.append(gov.tick())
        elif op == "admit":
            trail.append(gov.admit("gputrace capture"))
        elif op == "set":
            target, key, value = step[1:]
            if isinstance(target, dict):
                target[key] = value
            else:
                setattr(target, key, value)
            continue
        elif op == "fail":
            gov.note_write_failure(*step[1:])
        elif op == "reclaim_fail":
            gov.note_reclaim_failure(*step[1:])
        snap = health.snapshot()
        snap.pop("seconds_since_tick", None)  # the wall clock's
        trail.append((gov.snapshot(), snap))
    trail.append(asked)
    return trail


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_governors_agree(name):
    jax_trail, torch_trail = (_drive(S, name) for S, _ in
                              PACKAGES.values())
    assert torch_trail == jax_trail
    levels = {t for t in torch_trail if isinstance(t, str)}
    assert torch_supervise.PRESSURE_HARD in levels or name == "budget"


def _tree(root, ages):
    root.mkdir()
    now = time.time()
    for i, age in enumerate(ages):
        sub = root / f"d{i % 2}"
        sub.mkdir(exist_ok=True)
        p = sub / f"f{i}"
        p.write_bytes(b"x" * (100 * (i + 1)))
        os.utime(p, (now - age, now - age))


def test_dir_usage_and_reclaim_agree(tmp_path):
    ages = [7200, 3600, 10, 5000, 1]
    out = {}
    for pkg, (S, _) in PACKAGES.items():
        root = tmp_path / pkg
        _tree(root, ages)
        before = S.dir_usage(str(root))
        freed = S.reclaim_oldest_files(str(root), 250, grace_s=60)
        left = sorted(p.name for p in root.rglob("f*"))
        out[pkg] = (before, freed, left, S.dir_usage(str(root)))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] > 0 and out["torch"][0][1] == 5


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_atomic_artifact_write_leaves_no_tmp(tmp_path, pkg):
    S, fp = PACKAGES[pkg]
    out = str(tmp_path / "capture.pt.trace.json")
    fp.disarm_all()
    fp.arm("trace.artifact.write", "errno:ENOSPC*1")
    try:
        assert S.atomic_artifact_write(out, "{}") is False
        assert os.listdir(tmp_path) == []
        assert S.atomic_artifact_write(out, "{}") is True
        assert os.listdir(tmp_path) == ["capture.pt.trace.json"]
    finally:
        fp.disarm_all()


def test_diagnosis_report_write_refused_leaves_no_tmp(tmp_path):
    envelope = {"schema": 1, "kind": "dynolog_tpu.baseline", "summary": {
        "planes": [{"name": "/device:GPU:0", "lines": 1, "events": 1,
                    "duration_ms": 1.0}],
        "top_ops": [{"op": "flash_tc::flash_fwd_kernel<128>",
                     "total_ms": 1.0, "count": 2, "pct": 100.0}]}}
    target, baseline = tmp_path / "cur.json", tmp_path / "base.json"
    target.write_text(json.dumps(envelope))
    baseline.write_text(json.dumps(envelope))
    torch_failpoints.disarm_all()
    torch_failpoints.arm("diagnose.report.write", "errno:ENOSPC*1")
    try:
        with pytest.raises(OSError):
            torch_supervise.run_diagnosis_engine(str(target), str(baseline))
        assert sorted(os.listdir(tmp_path)) == ["base.json", "cur.json"]
        report = torch_supervise.run_diagnosis_engine(
            str(target), str(baseline), "00000000000000aa/00000000000000bb")
    finally:
        torch_failpoints.disarm_all()
    assert report["verdict"] == "clean"
    assert json.loads(open(report["report_path"]).read())["trace_ctx"] == \
        "00000000000000aa/00000000000000bb"
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_relay_snapshot_refused_keeps_the_previous_file(tmp_path):
    files = {}
    for pkg, (S, fp) in PACKAGES.items():
        path = str(tmp_path / f"{pkg}.json")
        relay = S.FleetRelay(snapshot_path=path, snapshot_interval_s=3600,
                             now_ms=lambda: 1_000_000)
        try:
            relay.view.ingest_line(json.dumps(
                {"host": "h1", "boot_epoch": 7, "wal_seq": 1, "m": 1.0}))
            assert relay.write_snapshot() is True
            before = open(path).read()
            relay.view.ingest_line(json.dumps(
                {"host": "h1", "boot_epoch": 7, "wal_seq": 2, "m": 2.0}))
            fp.arm("state.snapshot.write", "errno:ENOSPC*1")
            assert relay.write_snapshot() is False
            assert open(path).read() == before
            assert not os.path.exists(path + ".tmp")
            assert relay.view.ackable("h1") == 1
            assert relay.write_snapshot() is True
            files[pkg] = json.loads(open(path).read())
        finally:
            fp.disarm_all()
            relay.sever()
    assert files["torch"] == files["jax"]
    assert files["torch"]["fleet"]["hosts"]["h1"]["applied_seq"] == 2
