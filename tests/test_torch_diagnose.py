"""The port's diagnosis engine (dynolog_tpu_torch.diagnose) against the JAX
package's on the same summaries, its CUDA-aware classifier, its CLI's exit
codes, and baselines crossing between the two engines."""

import json
import os
import pathlib

import numpy as np
import pytest

from dynolog_tpu import diagnose as jax_diagnose
from dynolog_tpu import obs as jax_obs
from dynolog_tpu import trace as jax_trace
from dynolog_tpu_torch import diagnose, obs, trace

# Names both classifiers put in one category: XLA ops, and CUDA kernels
# that are neither collectives, fusions, matmuls nor copies.
NAMES = [
    "fusion.1", "fusion.7", "all-reduce.3", "copy.2", "dot_general",
    "flash_tc::flash_fwd_kernel<128>", "flash_tc::flash_dkv_kernel<128>",
    "rsqrt", "all-gather.4", "transpose.5", "exponential.6",
]


def _summary(rng, names, with_steps=True, scale=None, shapes=None):
    """A seeded summary in summarize()'s shape: random totals and counts
    per op, optionally slowed per op (`scale`) or reshaped (`shapes`)."""
    scale, shapes = scale or {}, shapes or {}
    rows = []
    for name in names:
        count = int(rng.integers(1, 40))
        total = round(float(rng.uniform(0.01, 20.0))
                      * scale.get(name, 1.0), 3)
        row = {"op": name, "total_ms": total, "count": count}
        if name in shapes:
            row["shapes"] = shapes[name]
        rows.append(row)
    whole = sum(r["total_ms"] for r in rows) or 1
    for r in rows:
        r["pct"] = round(r["total_ms"] / whole * 100.0, 1)
    rows.sort(key=lambda r: -r["total_ms"])
    out = {"planes": [{"name": "/device:GPU:0", "lines": 2,
                       "events": 100, "duration_ms": 50.0}],
           "top_ops": rows}
    if with_steps:
        p50 = round(float(rng.uniform(10, 60)), 3)
        p95 = round(p50 * float(rng.uniform(1.0, 2.0)), 3)
        out["steps"] = {"count": 8, "mean_ms": p50, "p50_ms": p50,
                        "p95_ms": p95, "max_ms": p95}
    return out


def _pair(seed):
    rng = np.random.default_rng(seed)
    base_names = list(rng.permutation(NAMES)[:9])
    cur_names = base_names[2:] + [n for n in NAMES if n not in base_names]
    scale = {n: float(rng.choice([0.5, 1.0, 1.02, 1.5, 3.0]))
             for n in cur_names}
    base = _summary(np.random.default_rng(seed + 100), base_names,
                    shapes={base_names[3]: ["bf16[1,2048,4096]"]})
    cur = _summary(np.random.default_rng(seed + 100), cur_names,
                   with_steps=seed % 3 != 2, scale=scale,
                   shapes={base_names[3]: ["bf16[2,2048,4096]"]})
    return base, cur


@pytest.mark.parametrize("seed", range(6))
def test_diff_diagnose_and_report_match_jax_engine(seed):
    assert [diagnose.classify_op(n) for n in NAMES] == [
        jax_diagnose.classify_op(n) for n in NAMES]
    base, cur = _pair(seed)
    assert trace.diff_summaries(base, cur) == jax_trace.diff_summaries(
        base, cur)
    for top in (3, 50):
        got = diagnose.diagnose(base, cur, top=top)
        assert got == jax_diagnose.diagnose(base, cur, top=top)
        assert diagnose.format_report(got) == jax_diagnose.format_report(got)


def test_diagnose_matches_jax_engine_on_xla_names():
    """With only names both classifiers agree on, the whole report is
    the JAX engine's."""
    rng = np.random.default_rng(7)
    names = ["fusion.1", "fusion.2", "all-reduce.3", "copy.4",
             "dot_general.5", "rsqrt.6"]
    base = _summary(rng, names)
    cur = _summary(np.random.default_rng(7), names,
                   scale={"fusion.2": 2.0, "all-reduce.3": 1.5,
                          "copy.4": 0.5})
    got = diagnose.diagnose(base, cur)
    assert got == jax_diagnose.diagnose(base, cur)
    assert got["verdict"] == "regressed"
    assert diagnose.format_report(got) == jax_diagnose.format_report(got)


REFERENCE_NAMES = [
    "all-reduce.17", "reduce-scatter", "fusion.3", "dot_general", "copy.4",
    "rsqrt", "all-gather-start.2", "collective-permute.1", "send.5",
    "recv-done.6", "all-to-all", "convolution.3", "loop_fusion.12",
    "transpose.9", "reshape.1", "einsum", "matmul.4", "exponential.2",
    "custom-call.7", "while.1",
]


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_classifier_keeps_reference_categories(name):
    assert diagnose.classify_op(name) == jax_diagnose.classify_op(name)


@pytest.mark.parametrize("name,category", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("c10d::allreduce_", "collective"),
    ("triton_poi_fused_add_mul_0", "fusion"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("cutlass::Kernel2<cutlass_80_tensorop_s16816gemm>", "matmul"),
    ("aten::mm", "matmul"),
    ("aten::addmm", "matmul"),
    ("aten::bmm", "matmul"),
    ("aten::linear", "matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "data-movement"),
    ("Memset (Device)", "data-movement"),
    ("aten::contiguous", "data-movement"),
    ("flash_tc::flash_fwd_kernel<128>", "compute"),
    ("flash_tc::flash_dq_kernel<128>", "compute"),
    ("flash_tc::flash_dkv_kernel<128>", "compute"),
    ("at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<at::native::(anonymous namespace)::TensorListMetadata<2>, "
     "at::native::(anonymous namespace)::BinaryOpListAlphaFunctor"
     "<c10::BFloat16, 2, 2, 0>, std::plus<float>, float>", "compute"),
])
def test_classifier_cuda_names(name, category):
    assert diagnose.classify_op(name) == category


def _trace_file(path, kernel_ms):
    """A minimal device trace: kernels named by `kernel_ms`'s keys, one
    call each per step, launched inside the host's span of two closed
    steps."""
    events, t, corr = [], 0.0, 0
    for step in range(2):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"ProfilerStep#{step}", "pid": 1, "tid": 1,
                       "ts": step * 100.0, "dur": 100.0, "args": {}})
        for name, ms in kernel_ms.items():
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                           "ts": step * 100.0 + corr, "dur": 1.0,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "pid": 0, "tid": 7, "ts": 1000.0 + t,
                           "dur": ms * 1e3,
                           "args": {"device": 0, "correlation": corr}})
            t += ms * 1e3 + 1.0
    events.append({"ph": "X", "cat": "user_annotation",
                   "name": "ProfilerStep#2", "pid": 1, "tid": 1, "ts": 200.0,
                   "dur": 1.0, "args": {}})
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _capture(tmp_path, name, kernel_ms):
    """A shim-shaped capture: <name>_<pid>/<run>.pt.trace.json and the
    manifest <name>_<pid>.json next to it."""
    run = tmp_path / f"{name}_{os.getpid()}"
    run.mkdir()
    trace_file = _trace_file(run / ("r" + trace.TRACE_SUFFIX), kernel_ms)
    manifest = tmp_path / f"{name}_{os.getpid()}.json"
    manifest.write_text(json.dumps({
        "trace_dir": str(run), "trace_file": str(trace_file),
        "status": "ok", "trace_ctx": "00000000000000aa/00000000000000bb"}))
    return manifest


BASE_KERNELS = {"void flash_tc::flash_fwd_kernel<128>(CUtensorMap)": 0.125,
                "nvjet_tst_256x128_64x4": 5.0}
SLOW_KERNELS = {"void flash_tc::flash_fwd_kernel<128>(CUtensorMap)": 0.25,
                "nvjet_tst_256x128_64x4": 5.0}


def test_cli_diagnoses_a_capture_against_a_saved_baseline(tmp_path, capsys):
    base = _capture(tmp_path, "base", BASE_KERNELS)
    cur = _capture(tmp_path, "cur", SLOW_KERNELS)
    saved = tmp_path / "b.json"
    assert diagnose.main([str(base), "--save-baseline", str(saved),
                          "--model", "m"]) == 0
    doc = json.loads(saved.read_text())
    assert doc["kind"] == "dynolog_tpu.baseline" and doc["schema"] == 1
    capsys.readouterr()
    out = tmp_path / "report.json"
    assert diagnose.main([str(cur), "--baseline", str(saved), "--json",
                          "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == json.loads(out.read_text())
    assert report["kind"] == "dynolog_tpu.diagnosis"
    assert report["verdict"] == "regressed"
    assert report["trace_ctx"] == "00000000000000aa/00000000000000bb"
    [finding] = [f for f in report["findings"]
                 if f["op"] == "flash_tc::flash_fwd_kernel<128>"]
    assert finding["kind"] == "compute_regression"
    assert finding["severity_pct"] == 100.0
    # A predicted manifest path (no pid suffix) resolves to the newest.
    assert diagnose.main([str(tmp_path / "cur.json"), "--baseline",
                          str(saved)]) == 0
    assert "diagnosis: regressed" in capsys.readouterr().out


def test_baselines_cross_between_engines(tmp_path):
    summary = trace.summarize(str(_capture(tmp_path, "x", BASE_KERNELS)))
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    diagnose.save_baseline(str(ours), summary, model="m", source="s")
    jax_diagnose.save_baseline(str(theirs), summary, model="m", source="s")
    a, b = jax_diagnose.load_baseline(str(ours)), diagnose.load_baseline(
        str(theirs))
    a.pop("created_ms"), b.pop("created_ms")
    assert a == b
    assert jax_diagnose.resolve_summary(str(ours))[0] == summary
    bad = tmp_path / "future.json"
    bad.write_text(json.dumps({"schema": 2, "summary": summary}))
    for engine in (diagnose, jax_diagnose):
        with pytest.raises(ValueError, match="schema"):
            engine.load_baseline(str(bad))


def test_jax_engine_finds_no_trace_in_a_torch_capture(tmp_path):
    """ROADMAP Queue C, C3: the daemon's auto-trigger runs the JAX
    engine, which finds no xplane in a torch capture and reads the
    regression as clean; the port's engine reads it as regressed."""
    saved = tmp_path / "b.json"
    diagnose.save_baseline(str(saved), trace.summarize(
        str(_capture(tmp_path, "base", BASE_KERNELS)), group=False))
    cur = str(_capture(tmp_path, "cur", SLOW_KERNELS))
    base_summary = diagnose.load_baseline(str(saved))["summary"]
    jax_cur, _ = jax_diagnose.resolve_summary(cur)
    assert jax_cur == {"planes": [], "top_ops": []}
    assert jax_diagnose.diagnose(base_summary, jax_cur)["verdict"] == "clean"
    ours, _ = diagnose.resolve_summary(cur)
    assert diagnose.diagnose(base_summary, ours)["verdict"] == "regressed"


@pytest.mark.parametrize("case", [
    "no_target", "no_baseline", "missing_target", "empty_ring",
    "empty_save", "bad_baseline",
])
def test_cli_exit_codes_match_jax_engine(case, tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    (tmp_path / "junk.json").write_text("{\"x\": 1}")
    good = tmp_path / "good.json"
    diagnose.save_baseline(str(good), {"planes": [{"name": "p"}],
                                       "top_ops": []})
    args = {
        "no_target": [],
        "no_baseline": [str(good)],
        "missing_target": [str(tmp_path / "missing_9.json"), "--baseline",
                           str(good)],
        "empty_ring": ["--ring", str(empty), "--baseline", str(good)],
        "empty_save": [str(empty), "--save-baseline",
                       str(tmp_path / "o.json")],
        "bad_baseline": [str(good), "--baseline",
                         str(tmp_path / "junk.json")],
    }[case]
    want = {"no_target": 2, "no_baseline": 2}.get(case, 1)
    assert jax_diagnose.main(list(args)) == want
    assert diagnose.main(list(args)) == want


def test_engine_runs_under_handed_down_context(monkeypatch, tmp_path):
    header = "00000000000000aa/00000000000000bb"
    monkeypatch.setenv(obs.ENV_TRACE_CTX, header)
    assert obs.from_env() == obs.TraceContext.parse(header)
    assert obs.from_env().header() == jax_obs.from_env().header()
    assert obs.ENV_FLUSH_ENDPOINT == jax_obs.ENV_FLUSH_ENDPOINT
    monkeypatch.delenv(obs.ENV_FLUSH_ENDPOINT, raising=False)
    obs.JOURNAL.drain()
    saved = tmp_path / "b.json"
    assert diagnose.main([str(_capture(tmp_path, "x", BASE_KERNELS)),
                          "--save-baseline", str(saved)]) == 0
    spans = {s.name: s for s in obs.JOURNAL.drain()}
    assert {"diagnose.engine", "diagnose.load"} <= set(spans)
    engine = spans["diagnose.engine"]
    assert engine.trace_id == 0xAA and engine.parent_id == 0xBB
    # Flushing toward a daemon that is not there costs nothing.
    monkeypatch.setenv(obs.ENV_FLUSH_ENDPOINT, "dynotpu_torch_nodaemon")
    with obs.span("diagnose.engine"):
        pass
    assert obs.maybe_flush_env() == 0
    assert not obs.JOURNAL.drain()


def test_newest_ring_profile(tmp_path):
    model = tmp_path / "m"
    model.mkdir()
    old, new = model / "1_s2.ringprof.json", model / "2_s4.ringprof.json"
    for p in (old, new):
        p.write_text("{}")
    os.utime(old, (1, 1))
    assert diagnose.newest_ring_profile(str(tmp_path)) == str(new)
    assert diagnose.newest_ring_profile(str(tmp_path), "m") == str(new)
    assert diagnose.newest_ring_profile(str(tmp_path), "x") is None
    assert pathlib.Path(jax_diagnose.newest_ring_profile(
        str(tmp_path))) == new
