"""The port's kineto summarizer (dynolog_tpu_torch.trace) against the JAX
package's XSpace summarizer on the same events, on a real torch.profiler
capture on the CPU, and on a hand-written device trace."""

import json
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from xspace_fixture import (  # noqa: E402
    _event, _event_metadata, _field_bytes, _field_str, _line)

from dynolog_tpu import trace as jax_trace  # noqa: E402
from dynolog_tpu_torch import trace  # noqa: E402
from dynolog_tpu_torch.client.shim import TorchProfiler  # noqa: E402

T0_NS = 1_700_000_000_000_000


def _synthetic(seed: int, n_ops: int = 6, n_steps: int = 4,
               per_step: int = 30):
    """Seeded device events: (op id, start ns, duration ns) back to back
    in `n_steps` groups, and each group's span (start ns, duration ns)."""
    rng = np.random.default_rng(seed)
    events, steps, t = [], [], 0
    for _ in range(n_steps):
        first = t
        for _ in range(per_step):
            op = int(rng.integers(1, n_ops + 1))
            dur = int(rng.integers(1_000, 40_000))
            events.append((op, t, dur))
            t += dur + int(rng.integers(100, 2_000))
        last_op, last_start, last_dur = events[-1]
        steps.append((first, last_start + last_dur - first))
        t += int(rng.integers(5_000, 50_000))  # the device idles between
    return events, steps


def _xspace(events, steps, n_ops: int = 6) -> bytes:
    """The events as one XSpace device plane: an "XLA Ops" line and a
    "Steps" line (the JAX package's step source)."""
    ops = [_event(op, start * 1000, dur * 1000) for op, start, dur in events]
    step_events = [_event(100 + i, start * 1000, dur * 1000)
                   for i, (start, dur) in enumerate(steps)]
    plane = _field_str(2, "/device:TPU:0")
    plane += _field_bytes(3, _line(0, "XLA Ops", T0_NS, ops))
    plane += _field_bytes(3, _line(1, "Steps", T0_NS, step_events))
    for op in range(1, n_ops + 1):
        plane += _field_bytes(4, _event_metadata(
            op, f"%fusion.{op} = bf16[128,128]", f"fusion.{op}"))
    for i in range(len(steps)):
        plane += _field_bytes(4, _event_metadata(100 + i, str(i), str(i)))
    return _field_bytes(1, plane)


def _us(ns: int) -> float:
    return (T0_NS + ns) / 1000.0


def _kineto(events, steps) -> bytes:
    """The same events as a kineto Chrome trace: kernels on device 0,
    stream 7, each launched by a runtime call inside the host's span of
    its step; the host's step spans end with the sliver from the last
    step() to stop(). The host runs ahead of the device, and kineto's
    device ProfilerStep span (a fraction of the step) is not a step."""
    per_step = len(events) // len(steps)
    out = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}}]
    host_ns = 1_000_000  # the host spans' length, shorter than the steps
    for i, (op, start, dur) in enumerate(events):
        step = i // per_step
        out.append({"ph": "X", "cat": "kernel",
                    "name": f"void fusion.{op}(float*, int)", "pid": 0,
                    "tid": 7, "ts": _us(start), "dur": dur / 1000.0,
                    "args": {"device": 0, "stream": 7, "correlation": i}})
        launch = -10 * host_ns + step * host_ns + (i % per_step) * 100
        out.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                    "ts": _us(launch), "dur": 0.05,
                    "args": {"correlation": i}})
    for i in range(len(steps) + 1):
        dur = host_ns if i < len(steps) else 46_000  # the closing sliver
        out.append({"ph": "X", "cat": "user_annotation",
                    "name": f"ProfilerStep#{i}", "pid": 1, "tid": 1,
                    "ts": _us(-10 * host_ns + i * host_ns),
                    "dur": dur / 1000.0, "args": {}})
    out.append({"ph": "X", "cat": "gpu_user_annotation",
                "name": "ProfilerStep#0", "pid": 0, "tid": 7,
                "ts": _us(steps[0][0]), "dur": 1.0, "args": {"device": 0}})
    return json.dumps({"traceEvents": out}).encode()


def _table(summary):
    return [(o["op"], o["total_ms"], o["count"], o["pct"])
            for o in summary["top_ops"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("group", [False, True])
def test_summary_matches_xspace_summarizer(seed, group):
    events, steps = _synthetic(seed)
    ref = jax_trace._summarize_planes(jax_trace.summarize_xplane_bytes(
        _xspace(events, steps), group=group))
    got = trace._summarize_planes(trace.summarize_trace_bytes(
        _kineto(events, steps), group=group))
    assert _table(got) == _table(ref)
    assert got["steps"] == ref["steps"]
    assert got["steps"]["count"] == len(steps)  # the sliver is not a step
    assert [p["name"] for p in got["planes"]] == ["/device:GPU:0"]


def _cpu_capture(directory, n_steps: int = 3) -> str:
    prof = TorchProfiler()
    a = torch.randn(32, 32)
    prof.start(str(directory))
    for _ in range(n_steps):
        (a @ a).sum()
        prof.step()
    prof.stop()
    return prof.export(str(directory))


def test_cpu_capture_gives_host_plane_and_drops_closing_sliver(tmp_path):
    path = _cpu_capture(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ProfilerStep#")]
    # torch.profiler records one span more than step() calls: the last
    # one runs from the last step() to stop().
    assert len(spans) == 4, [e["name"] for e in spans]
    summary = trace.summarize(path)
    assert [p["name"] for p in summary["planes"]] == ["/host:CPU"]
    assert summary["steps"]["count"] == 3
    rows = {o["op"]: o for o in summary["top_ops"]}
    assert rows["aten::mm"]["count"] == 3
    assert rows["aten::mm"]["shapes"] == ["(f32[32,32], f32[32,32])"]
    assert not any("gflops_per_s" in o or "gib_per_s" in o
                   for o in summary["top_ops"])


def _kernel(name, stream, ts, dur, corr, **args):
    return {"ph": "X", "cat": "kernel", "pid": 0, "tid": stream, "ts": ts,
            "dur": dur, "name": name,
            "args": {"device": 0, "stream": stream, "correlation": corr,
                     **args}}


def _launch(ts, corr, ext=None, cat="cuda_runtime"):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": 9,
            "tid": 9, "ts": ts, "dur": 1.0, "args": args}


def _hand_written_device_trace() -> dict:
    """Two streams on device 0, launches joined to their ops by
    External id and by correlation, two template instances of one
    kernel, and two closed steps whose device work runs after the host
    spans that launched it."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9, "tid": 9,
         "ts": 10.0, "dur": 8.0,
         "args": {"External id": 5, "Input type": ["c10::BFloat16",
                                                   "c10::BFloat16"],
                  "Input Dims": [[2048, 4096], [4096, 4096]]}},
        {"ph": "X", "cat": "cpu_op", "name": "FlashAttention", "pid": 9,
         "tid": 9, "ts": 20.0, "dur": 5.0,
         "args": {"External id": 6,
                  "Input type": ["c10::BFloat16", "Scalar"],
                  "Input Dims": [[1, 2048, 32, 128], []]}},
        # Launched by aten::mm, known only through the runtime call.
        _launch(12.0, 11, ext=5),
        _kernel("void cutlass::Kernel2<cutlass_80_gemm<128>>(Params)", 7,
                100.0, 50.0, 11),
        _launch(22.0, 12, ext=6),
        _kernel("void flash_tc::flash_fwd_kernel<128>(CUtensorMap, int)", 7,
                160.0, 125.0, 12, **{"External id": 6}),
        _launch(30.0, 13, cat="cuda_driver"),
        _kernel("void multi_tensor_apply_kernel<TensorListMetadata<2>, "
                "Add>(TensorListMetadata<2>)", 13, 150.0, 20.0, 13),
        _launch(70.0, 14),
        _kernel("void multi_tensor_apply_kernel<TensorListMetadata<4>, "
                "Lerp>(TensorListMetadata<4>)", 13, 300.0, 30.0, 14),
        _launch(80.0, 15),
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 400.0,
         "dur": 5.0, "name": "Memcpy DtoH (Device -> Pinned)",
         "args": {"device": 0, "stream": 7, "correlation": 15}},
        # kineto's device span of step 0: not a step.
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 100.0, "dur": 10.0, "name": "ProfilerStep#0",
         "args": {"device": 0}},
        {"ph": "X", "cat": "user_annotation", "pid": 9, "tid": 9,
         "ts": 5.0, "dur": 60.0, "name": "ProfilerStep#0", "args": {}},
        {"ph": "X", "cat": "user_annotation", "pid": 9, "tid": 9,
         "ts": 65.0, "dur": 30.0, "name": "ProfilerStep#1", "args": {}},
        {"ph": "X", "cat": "user_annotation", "pid": 9, "tid": 9,
         "ts": 95.0, "dur": 0.5, "name": "ProfilerStep#2", "args": {}},
    ]
    return {"traceEvents": ev}


def test_device_trace_planes_streams_shapes_and_steps():
    data = json.dumps(_hand_written_device_trace()).encode()
    planes = trace.summarize_trace_bytes(data, group=False)
    assert [p.name for p in planes] == ["/device:GPU:0", "/host:CPU"]
    gpu = planes[0]
    assert gpu.line_names == ["stream 13", "stream 7", "Steps"]
    summary = trace._summarize_planes(planes)
    rows = {o["op"]: o for o in summary["top_ops"]}
    # The op table is the device's: no host op appears in it.
    assert set(rows) == {
        "flash_tc::flash_fwd_kernel<128>",
        "cutlass::Kernel2<cutlass_80_gemm<128>>",
        "multi_tensor_apply_kernel<TensorListMetadata<2>, Add>",
        "multi_tensor_apply_kernel<TensorListMetadata<4>, Lerp>",
        "Memcpy DtoH (Device -> Pinned)",
    }
    assert rows["flash_tc::flash_fwd_kernel<128>"]["shapes"] == [
        "bf16[1,2048,32,128]"]
    assert rows["cutlass::Kernel2<cutlass_80_gemm<128>>"]["shapes"] == [
        "(bf16[2048,4096], bf16[4096,4096])"]
    assert rows["flash_tc::flash_fwd_kernel<128>"]["total_ms"] == 0.125
    # Host steps #0 and #1 were closed by step(), #2 by stop(). Step 0's
    # device work (launched at 12-30 us) runs 100-285 us on two streams;
    # step 1's (launched at 70-80 us) runs 300-405 us.
    assert summary["steps"] == {"count": 2, "mean_ms": 0.145,
                                "p50_ms": 0.105, "p95_ms": 0.185,
                                "max_ms": 0.185}

    grouped = trace._summarize_planes(trace.summarize_trace_bytes(data))
    folded = {o["op"]: o for o in grouped["top_ops"]}
    assert folded["multi_tensor_apply_kernel"]["count"] == 2
    assert folded["multi_tensor_apply_kernel"]["total_ms"] == 0.05
    assert "flash_tc::flash_fwd_kernel" in folded


def test_host_steps_where_no_device_work_was_launched():
    doc = _hand_written_device_trace()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e["cat"] not in ("cuda_runtime", "cuda_driver")]
    summary = trace._summarize_planes(trace.summarize_trace_bytes(
        json.dumps(doc).encode()))
    assert summary["steps"]["count"] == 2
    assert summary["steps"]["max_ms"] == 0.06  # host span #0


@pytest.mark.parametrize("name,per_op,grouped", [
    ("void flash_tc::flash_dkv_kernel<128>(CUtensorMap, float*)",
     "flash_tc::flash_dkv_kernel<128>", "flash_tc::flash_dkv_kernel"),
    ("void at::native::(anonymous namespace)::kern<4, F<float> >(int, F)",
     "at::native::(anonymous namespace)::kern<4, F<float> >",
     "at::native::(anonymous namespace)::kern"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
     "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
     "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)",
     "Memcpy HtoD (Pageable -> Device)"),
    ("aten::mm", "aten::mm", "aten::mm"),
    ("fusion.116", "fusion.116", "fusion"),
])
def test_op_key(name, per_op, grouped):
    assert trace._op_key(name, group=False) == per_op
    assert trace._op_key(name, group=True) == grouped


def test_find_trace_files_resolves_manifest_dir_and_file(tmp_path):
    run = tmp_path / "trace_123"
    run.mkdir()
    old = run / ("a" + trace.TRACE_SUFFIX)
    new = run / ("b" + trace.TRACE_SUFFIX)
    for p in (old, new):
        p.write_text(json.dumps({"traceEvents": []}))
    past = time.time() - 100
    os.utime(old, (past, past))
    assert trace.find_trace_files(str(run)) == [str(new)]
    assert trace.find_trace_files(str(old)) == [str(old)]
    manifest = tmp_path / "trace_123.json"
    manifest.write_text(json.dumps({"trace_dir": str(run),
                                    "trace_file": str(old)}))
    assert trace.find_trace_files(str(manifest)) == [str(old)]
    manifest.write_text(json.dumps({"trace_dir": str(run),
                                    "trace_file": None}))
    assert trace.find_trace_files(str(manifest)) == [str(new)]
    assert trace.find_trace_files(str(tmp_path / "none")) == []
    assert trace.summarize(str(tmp_path / "none")) == jax_trace.summarize(
        str(tmp_path / "none"))


def test_summary_and_compact_profile(tmp_path):
    path = tmp_path / ("run" + trace.TRACE_SUFFIX)
    data = json.dumps(_hand_written_device_trace()).encode()
    path.write_bytes(data)
    out = trace.write_summary_json(str(path))
    assert out == str(tmp_path / ("run" + trace.SUMMARY_SUFFIX))
    assert json.loads(pathlib.Path(out).read_text()) == trace.summarize(
        str(path))
    assert trace.write_derived_artifacts(str(path)) == [out]
    profile = trace.compact_profile(data, top=2)
    ref = jax_trace.compact_profile(_xspace(*_synthetic(0)), top=2)
    assert set(profile) - {"trace_bytes"} == set(ref) - {"xspace_bytes"}
    assert len(profile["top_ops"]) == 2 and profile["trace_bytes"] == len(
        data)
    # Per-kernel rows: template instances stay apart.
    assert trace.compact_profile(data)["top_ops"][0]["op"] == (
        "flash_tc::flash_fwd_kernel<128>")


def _run_cli(module, args, capsys):
    rc = module.main(args)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("case", ["empty_dir", "diff_empty"])
def test_cli_error_exit_codes_match(case, tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    args = {"empty_dir": [str(empty)],
            "diff_empty": [str(empty), "--diff", str(empty)]}[case]
    rc_ref, _ = _run_cli(jax_trace, args, capsys)
    rc, out = _run_cli(trace, args, capsys)
    assert rc == rc_ref == 1
    assert "no trace found" in out.err


def test_cli_summary_and_diff(tmp_path, capsys):
    base, cur = tmp_path / "b.pt.trace.json", tmp_path / "c.pt.trace.json"
    events, steps = _synthetic(0)
    base.write_bytes(_kineto(events, steps))
    slower = [(op, start, dur * 2 if op == 3 else dur)
              for op, start, dur in events]
    cur.write_bytes(_kineto(slower, steps))
    rc, out = _run_cli(trace, [str(cur), "--json"], capsys)
    assert rc == 0
    assert [o["op"] for o in json.loads(out.out)["top_ops"]] == ["fusion"]
    rc, out = _run_cli(trace, [str(cur), "--json", "--per-op", "--top", "3"],
                       capsys)
    assert rc == 0
    summary = json.loads(out.out)
    assert len(summary["top_ops"]) == 3 and summary["steps"]["count"] == 4
    rc, out = _run_cli(trace, [str(cur)], capsys)
    assert rc == 0 and "/device:GPU:0" in out.out and "steps: 4" in out.out
    rc, out = _run_cli(trace, [str(cur), "--per-op", "--diff", str(base),
                               "--json"], capsys)
    assert rc == 0
    diff = json.loads(out.out)
    assert diff["ops"][0]["op"] == "fusion.3"
    assert diff["ops"][0]["delta_ms_per_call"] > 0
    rc, out = _run_cli(trace, [str(cur), "--diff", str(base)], capsys)
    assert rc == 0 and "regression report vs baseline" in out.out
