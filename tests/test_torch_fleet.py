"""The port's fleet relay, rollup algebra and watcher against the JAX
package's: the same record lines give the same fleet documents and
snapshots, snapshots restore across packages, the acked TCP wire works
in both directions, and the port's watcher closes the loop on
torch.profiler (kineto) captures with the port's engine.

No arithmetic separates the two mirrors beyond sums of the same floats in
the same order, so every comparison is exact. Clocks are injected
(``now_ms``, ``now``); socket waits are bounded by the senders' own
timeout, and every relay is severed in a ``finally``."""

from __future__ import annotations

import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynolog_tpu import failpoints as jax_failpoints
from dynolog_tpu import supervise as jax_supervise
from dynolog_tpu_torch import failpoints as torch_failpoints
from dynolog_tpu_torch import supervise as torch_supervise
from dynolog_tpu_torch import trace

PACKAGES = {"jax": (jax_supervise, jax_failpoints),
            "torch": (torch_supervise, torch_failpoints)}


def _record(host, epoch, seq, **extra):
    return json.dumps(
        {"host": host, "boot_epoch": epoch, "wal_seq": seq, **extra})


def _leaf_rollup(S, hosts, pod, base, metric="steps"):
    view = S.FleetView(now_ms=lambda: 1_000_000)
    value = base
    for h in hosts:
        view.ingest_line(_record(h, 1, 2, pod=pod, **{metric: value}))
        value += 0.5
    return view.export_rollup()


# Each script is a list of steps run against one FleetView: ("ingest",
# line[, shed]), ("tick", ms), ("sweep",), ("snapshot",), ("commit",).
SCRIPTS = {
    "dedup_epochs_gaps": [
        *(("ingest", _record("h1", 7, s, cpu_util=0.5 + s))
          for s in (1, 2, 3)),
        ("ingest", _record("h1", 7, 2)),            # replay: suppressed
        ("ingest", _record("h1", 9, 1, cpu_util=3.0)),  # re-imaged host
        ("ingest", _record("h1", 7, 6)),            # zombie epoch
        ("ingest", _record("h1", 9, 5)),            # sender evicted 2..4
        ("ingest", _record("h2", 1, 50, pod="p1")),  # first contact
        ("ingest", _record("", 1, 1)),               # untracked
    ],
    "liveness_flaps": [
        ("ingest", _record("h1", 7, 1)), ("tick", 1500), ("sweep",),
        ("tick", 5000), ("sweep",), ("ingest", _record("h1", 7, 2)),
        ("tick", 5001), ("sweep",), ("ingest", _record("h1", 7, 3)),
        ("tick", 5001), ("sweep",), ("ingest", _record("h1", 7, 4)),
        ("tick", 1000), ("ingest", _record("h1", 7, 5)),
        ("ingest", _record("h2", 3, 1, pod="p0")), ("tick", 700),
        ("sweep",),
    ],
    "durable_acks": [
        ("durable",), ("ingest", _record("h1", 7, 1, steps_per_sec=3.5)),
        ("snapshot",), ("ingest", _record("h1", 7, 2)), ("commit",),
        ("snapshot",), ("commit",), ("ingest", _record("h1", 7, 3)),
    ],
    "hello_versions_hostile": [
        ("ingest", json.dumps({"host": "h1", "boot_epoch": 4,
                               "fleet_hello": 1, "proto": 1,
                               "build": "0.7.0"})),
        ("ingest", _record("h1", 4, 1, proto=1, build="0.7.0", m=1.0)),
        ("ingest", _record("h2", 4, 1, proto=9, build="9.9", m=2.0,
                           extra="text", nested={"a": 1})),
        ("ingest", _record("h3", 4, 1, m=3.0)),  # a pre-version sender
        ("ingest", "not json"), ("ingest", "[1, 2]"),
        ("ingest", json.dumps({"host": "h4", "wal_seq": "abc",
                               "fleet_hello": "yes"})),
        ("ingest", _record("h1", 4, 2, health_degraded=2, rpc_port=4100,
                           rpc_host="10.0.0.1", pod="p9")),
    ],
    "admission": [
        ("ingest", _record("h1", 1, 1, m=1.0)),
        ("ingest", _record("h1", 1, 2, m=2.0), True),  # shed rollup
        ("ingest", _record("h2", 1, 1)), ("ingest", _record("h3", 1, 9)),
    ],
    "child_rollups": [
        ("child", "relay-a", 5, 1, ["a1", "a2"], "p0", 2.0),
        ("child", "relay-b", 6, 1, ["b1"], "p1", 8.0),
        ("child", "relay-a", 5, 1, ["a1", "a2"], "p0", 2.0),  # replay
        ("ingest", _record("leaf", 1, 1, pod="p0", steps=1.0)),
        ("tick", 6000), ("sweep",),
        ("child", "relay-b", 6, 2, ["b1", "b2"], "p1", 8.0),
    ],
}
VIEW_ARGS = {"liveness_flaps": dict(stale_after_ms=1000, lost_after_ms=5000,
                                    flap_threshold=2, flap_damp_ms=2000),
             "admission": dict(max_hosts=2),
             "child_rollups": dict(stale_after_ms=1000, lost_after_ms=5000)}
METRICS = ["m", "cpu_util", "steps", "steps_per_sec"]


def _run_script(S, name: str):
    clock = [1_000_000]
    view = S.FleetView(now_ms=lambda: clock[0], **VIEW_ARGS.get(name, {}))
    trail = []
    for step in SCRIPTS[name]:
        op = step[0]
        if op == "ingest":
            replies: list = []
            got = view.ingest_line(step[1], *step[2:], hello_reply=replies)
            trail.append((got, replies))
        elif op == "child":
            _, relay, epoch, seq, hosts, pod, base = step
            doc = _leaf_rollup(S, hosts, pod, base)
            trail.append(view.ingest_line(json.dumps(
                {**doc, "host": relay, "boot_epoch": epoch,
                 "wal_seq": seq})))
        elif op == "tick":
            clock[0] += step[1]
        elif op == "sweep":
            view.sweep()
        elif op == "durable":
            view.durable_acks = True
        elif op == "snapshot":
            trail.append(view.snapshot_state())
        elif op == "commit":
            view.commit_durable()
        trail.append({h: view.ackable(h) for h in ("h1", "h2", "relay-a")})
    return view, trail, clock


def _documents(view) -> dict:
    return {"detail": view.query(top_k=16, detail=True, metrics=METRICS,
                                 skew_metric="m"),
            "plain": view.query(),
            "snapshot": view.snapshot_state(),
            "export": view.export_rollup()}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_records_give_equal_documents(name):
    out = {}
    for pkg, (S, _) in PACKAGES.items():
        view, trail, _ = _run_script(S, name)
        out[pkg] = (trail, _documents(view))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("source,target", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("name", ["dedup_epochs_gaps",
                                  "hello_versions_hostile", "child_rollups"])
def test_snapshot_restores_across_packages(name, source, target):
    S, T = PACKAGES[source][0], PACKAGES[target][0]
    view, _, clock = _run_script(S, name)
    section = view.snapshot_state()
    views = {}
    for who, M in (("other", T), ("same", S)):
        restored = M.FleetView(now_ms=lambda: clock[0],
                               **VIEW_ARGS.get(name, {}))
        n = restored.restore(json.loads(json.dumps(section)))
        # Re-delivery after the restart: the overlap dedupes.
        restored.ingest_line(_record("h1", 9, 5))
        restored.ingest_line(_record("h1", 9, 6, cpu_util=1.25))
        views[who] = (n, _documents(restored))
    assert views["other"] == views["same"]
    assert views["other"][0] > 0


def _rollup_strategy():
    host = st.tuples(st.sampled_from(["p0", "p1", "p2"]),
                     st.integers(min_value=-8, max_value=8))
    return st.lists(st.lists(host, min_size=1, max_size=4), min_size=1,
                    max_size=4)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(_rollup_strategy(), st.booleans())
def test_merge_rollups_agree(leaves, lose_first):
    docs = {}
    for pkg, (S, _) in PACKAGES.items():
        rollups = []
        for i, hosts in enumerate(leaves):
            view = S.FleetView(now_ms=lambda: 1_000_000)
            for j, (pod, value) in enumerate(hosts):
                view.ingest_line(_record(f"r{i}-h{j}", 1, 1, pod=pod,
                                         steps=value / 2))
            rollups.append(view.export_rollup())
        if lose_first:
            rollups[0] = S.degrade_lost_rollup(rollups[0])
        merged = {}
        for r in rollups:
            merged = S.merge_rollups(merged, r)
        docs[pkg] = (rollups, merged,
                     S.merge_rollups(rollups[-1], merged))
    assert docs["torch"] == docs["jax"]
    # Cross-package: the port folds the JAX mirror's rollups alike.
    assert torch_supervise.merge_rollups(docs["jax"][1], {}) == \
        jax_supervise.merge_rollups(docs["torch"][1], {})


@pytest.mark.parametrize("sender,relay", [("torch", "jax"),
                                          ("jax", "torch")])
def test_acked_sender_and_fleet_relay_across_packages(tmp_path, sender,
                                                      relay):
    S, R = PACKAGES[sender][0], PACKAGES[relay][0]
    server = R.FleetRelay(0, snapshot_path=str(tmp_path / "state.json"),
                          snapshot_interval_s=0.05)
    try:
        wal = S.SinkWal(str(tmp_path / "spill"), fsync=False)
        tx = S.AckedTcpSender("127.0.0.1", server.port)
        sink = S.DurableSink(wal, tx)
        try:
            for i in range(6):
                sink.publish(lambda seq, i=i: json.dumps(
                    {"host": "h0", "boot_epoch": wal.epoch, "wal_seq": seq,
                     "steps_per_sec": float(i)}))
            sink.drain()
            stats = wal.stats()
        finally:
            tx.close()
            wal.close()
        doc = server.view.query(detail=True, metrics=["steps_per_sec"])
    finally:
        server.sever()
    h0 = doc["hosts_detail"]["h0"]
    assert h0["records"] == h0["applied_seq"] == 6
    assert h0["seq_gaps"] == 0
    assert stats["acked_seq"] == 6 and stats["pending_records"] == 0
    assert doc["metrics"]["h0"]["steps_per_sec"] == 5.0


def _skewed_doc(S, values=(4.0, 1.0, 4.5), pods=("p0",), **extra):
    view = S.FleetView(now_ms=lambda: 1_000_000)
    for pod in pods:
        for i, value in enumerate(values):
            view.ingest_line(_record(f"{pod}-w{i}", 1, 1, pod=pod,
                                     steps_per_sec=value,
                                     rpc_port=42000 + i, **extra))
    return view.query(detail=True, metrics=["steps_per_sec"],
                      skew_metric="steps_per_sec")


PICKS = [
    dict(values=(4.0, 1.0, 4.5), spread=1.0),
    dict(values=(4.0, 1.0, 4.5), spread=10.0),
    dict(values=(3.0, 1.0), spread=1.0, rpc_host="10.0.0.1"),  # a tie
    dict(values=(2.0, 2.0, 1.9), spread=0.05, pods=("pa", "pz")),
    dict(values=(2.0, 2.0, 1.9), spread=0.05, pods=("pa", "pz"),
         skip=("pa",)),
    dict(values=(5.0, 1.0, 1.0), spread=0.5, skip=("p0",)),
]


@pytest.mark.parametrize("case", range(len(PICKS)))
def test_pick_diagnosis_agrees(case):
    args = dict(PICKS[case])
    spread, skip = args.pop("spread"), args.pop("skip", ())
    picks = {pkg: S.pick_diagnosis(_skewed_doc(S, **args),
                                   metric="steps_per_sec", spread=spread,
                                   skip_pods=skip)
             for pkg, (S, _) in PACKAGES.items()}
    assert picks["torch"] == picks["jax"]


def test_pick_diagnosis_dwell_rule_agrees():
    picks = {}
    for pkg, (S, _) in PACKAGES.items():
        clock = [1_000_000]
        view = S.FleetView(stale_after_ms=1000, lost_after_ms=60_000,
                           now_ms=lambda: clock[0])
        view.ingest_line(_record("s0", 1, 1, pod="p0"))
        clock[0] += 4000
        view.ingest_line(_record("s1", 1, 1, pod="p0"))
        view.sweep()
        picks[pkg] = S.pick_diagnosis(view.query(detail=True), dwell_ms=3000)
    assert picks["torch"] == picks["jax"]
    assert picks["torch"]["reason"] == "straggler_dwell"


def _kineto_capture(d, name: str, kernel_ms: dict, ctx: str) -> str:
    """A capture shaped as the port's shim writes it: a Chrome trace of
    two closed ProfilerStep spans, each launching every kernel once, and
    its manifest <name>_<pid>.json carrying the request's trace_ctx."""
    run = d / f"{name}_{os.getpid()}"
    run.mkdir()
    events, t, corr = [], 0.0, 0
    for step in range(3):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"ProfilerStep#{step}", "pid": 1, "tid": 1,
                       "ts": step * 100.0, "dur": 100.0 if step < 2 else 1.0,
                       "args": {}})
        for kernel, ms in (kernel_ms.items() if step < 2 else ()):
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                           "ts": step * 100.0 + corr, "dur": 1.0,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": kernel,
                           "pid": 0, "tid": 7, "ts": 1000.0 + t,
                           "dur": ms * 1e3,
                           "args": {"device": 0, "correlation": corr}})
            t += ms * 1e3 + 1.0
    trace_file = run / ("r" + trace.TRACE_SUFFIX)
    trace_file.write_text(json.dumps({"traceEvents": events}))
    manifest = d / f"{name}_{os.getpid()}.json"
    manifest.write_text(json.dumps({
        "trace_dir": str(run), "trace_file": str(trace_file),
        "status": "ok", "trace_ctx": ctx}))
    return str(manifest)


KERNELS = ("void flash_tc::flash_fwd_kernel<128>(CUtensorMap)",
           "void flash_tc::flash_dkv_kernel<128>(CUtensorMap)",
           "nvjet_tst_256x128_64x4")


def test_watcher_diagnoses_kineto_captures_under_one_trace_context(
        tmp_path):
    captures = []

    def trigger(host, rpc, trace_ctx):
        # The straggler's kernels run twice as long per call.
        scale = 2.0 if host == "p0-w1" else 1.0
        captures.append((host, rpc, trace_ctx))
        d = tmp_path / f"capture{len(captures)}"
        d.mkdir()
        return _kineto_capture(d, host, {
            k: ms * scale for k, ms in zip(KERNELS, (0.125, 0.26, 5.0))},
            trace_ctx)

    now = [100.0]
    view = torch_supervise.FleetView(now_ms=lambda: 1_000_000)
    for i, value in enumerate((4.0, 1.0, 4.5)):
        view.ingest_line(_record(f"p0-w{i}", 1, 1, pod="p0",
                                 steps_per_sec=value, rpc_port=42000 + i,
                                 rpc_host="127.0.0.1"))
    watcher = torch_supervise.FleetWatcher(
        view, metric="steps_per_sec", spread=1.0, cooldown_s=60,
        trigger=trigger, now=lambda: now[0])
    report = watcher.tick()
    assert report is not None
    assert report["candidate"]["outlier"] == "p0-w1"
    assert [c[0] for c in captures] == ["p0-w1", report["candidate"]["peer"]]
    assert captures[0][1] == ("127.0.0.1", 42001)
    assert len({ctx for _, _, ctx in captures}) == 1
    on_disk = json.loads(open(report["report_path"]).read())
    assert report["report_path"].endswith(
        f"p0-w1_{os.getpid()}.fleet_diagnosis.json")
    assert on_disk["trace_ctx"] == captures[0][2] == report["trace_ctx"]
    assert on_disk["verdict"] == "regressed"
    flagged = {f["op"] for f in on_disk["findings"]
               if f["kind"] == "compute_regression"}
    assert {"flash_tc::flash_fwd_kernel<128>",
            "flash_tc::flash_dkv_kernel<128>"} <= flagged
    assert not [p for p in os.listdir(tmp_path / "capture1")
                if p.endswith(".tmp")]
    # Inside the cooldown the persisting breach does not fire again; past
    # it, it does.
    assert watcher.tick() is None
    now[0] += 61
    assert watcher.tick() is not None
    assert watcher.fires == 2


def test_the_jax_engine_cannot_read_what_the_port_diagnoses(tmp_path):
    """Why the port's watcher carries its own engine: the JAX mirror's
    default leg reads a kineto capture pair as clean (ROADMAP C3)."""
    target = _kineto_capture(tmp_path, "slow", {KERNELS[0]: 0.25}, "a/b")
    base = _kineto_capture(tmp_path, "fast", {KERNELS[0]: 0.125}, "a/b")
    ported = torch_supervise.run_diagnosis_engine(target, base, "a/b")
    assert ported["verdict"] == "regressed"
    assert jax_supervise.run_diagnosis_engine(
        target, base, "a/b")["verdict"] == "clean"


def test_watcher_decisions_agree_across_packages(tmp_path):
    out = {}
    for pkg, (S, _) in PACKAGES.items():
        now = [0.0]
        view = S.FleetView(now_ms=lambda: 1_000_000)
        for pod in ("pa", "pz"):
            for i, value in enumerate((4.0, 1.0, 4.5)):
                view.ingest_line(_record(f"{pod}-{i}", 1, 1, pod=pod,
                                         steps_per_sec=value))
        calls = []
        watcher = S.FleetWatcher(
            view, metric="steps_per_sec", spread=1.0, cooldown_s=600,
            trigger=lambda host, rpc, ctx: calls.append((host, rpc))
            or (None if host == "pz-1" else f"{host}.json"),
            diagnose=lambda target, baseline, ctx: {"verdict": "regressed"},
            now=lambda: now[0])
        ticks = []
        for _ in range(4):
            got = watcher.tick()
            ticks.append(got and {k: v for k, v in got.items()
                                  if k != "trace_ctx"})
            now[0] += 1
        out[pkg] = (ticks, calls, watcher.fires)
    assert out["torch"] == out["jax"]
    ticks, calls, fires = out["torch"]
    assert fires == 1 and ticks[0] is not None  # pz's capture failed
    assert ticks[2:] == [None, None]  # both pods cooling


@pytest.mark.parametrize("site,spec", [("relay.merge.apply", "error*1"),
                                       ("relay.upstream.export", "error*1")])
def test_relay_failpoints_agree(site, spec):
    out = {}
    for pkg, (S, fp) in PACKAGES.items():
        child = _leaf_rollup(S, ["a1"], "p0", 2.0)
        fp.disarm_all()
        # Hit counts live as long as the process: count this run's alone.
        before = fp.hits(site)
        fp.arm(site, spec)
        try:
            view = S.FleetView(now_ms=lambda: 1_000_000)
            got = [view.ingest_line(json.dumps(
                {**child, "host": "relay-a", "boot_epoch": 5,
                 "wal_seq": seq})) for seq in (1, 1, 2)]
            exports = [view.export_rollup(), view.export_rollup()]
            out[pkg] = (got, exports, view.query(detail=True),
                        fp.hits(site) - before)
        finally:
            fp.disarm_all()
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == 1
