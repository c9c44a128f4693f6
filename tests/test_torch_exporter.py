"""The port's NVML exporter (dynolog_tpu_torch.exporter) on the CPU: the
snapshot schema and atomic write of the JAX package's exporter, NVML's
calls through a stubbed library handle, [] without NVML, the snapshot
through a real dynologd's file backend, and the CUDA-init probe."""

import ctypes
import json
import re
import time
from pathlib import Path

import pytest
import torch

import daemon_utils
from dynolog_tpu import exporter as jax_exporter
from dynolog_tpu_torch import _torchinit, exporter
from dynolog_tpu_torch.exporter import Nvml

REPO = Path(__file__).resolve().parent.parent
H100_BYTES = 85_520_809_984


def _daemon_metric_names() -> set[str]:
    """The names the daemon's file backend keeps (tpuFieldIdToName)."""
    text = (REPO / "src" / "tpumon" / "TpuMetricBackend.cpp").read_text()
    block = text[text.index("tpuFieldIdToName()"):]
    block = block[: block.index("};")]
    return set(re.findall(r'\{k\w+, "(\w+)"\}', block))


class FakeNvmlLib:
    """libnvidia-ml's functions as the exporter calls them: return codes,
    and results written through the ctypes pointers it passes."""

    def __init__(self, names, ecc_on=True, fail=()):
        self.names, self.ecc_on, self.fail = names, ecc_on, set(fail)
        self.shut = False

    def _rc(self, fn):
        return 999 if fn in self.fail else 0

    def nvmlShutdown(self):
        self.shut = True
        return 0

    def nvmlDeviceGetCount_v2(self, n):
        n._obj.value = len(self.names)
        return self._rc("count")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle._obj.value = 1000 + index
        return 0

    def nvmlDeviceGetName(self, handle, buf, length):
        name = self.names[handle.value - 1000].encode()
        ctypes.memmove(buf, name + b"\0", len(name) + 1)
        return self._rc("name")

    def nvmlDeviceGetMemoryInfo(self, handle, info):
        index = handle.value - 1000
        info._obj.total = H100_BYTES
        info._obj.used = 1 << 30 + index
        info._obj.free = H100_BYTES - info._obj.used
        return self._rc("memory")

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util._obj.gpu, util._obj.memory = 97, 41
        return self._rc("utilization")

    def nvmlDeviceGetEccMode(self, handle, current, pending):
        current._obj.value = pending._obj.value = int(self.ecc_on)
        return self._rc("ecc")

    def nvmlDeviceGetTotalEccErrors(self, handle, kind, counter, count):
        assert (kind, counter) == (1, 0)  # uncorrected, volatile
        count._obj.value = 2
        return 0


def test_snapshot_rows_from_nvml():
    nvml = Nvml(FakeNvmlLib(["NVIDIA H100 80GB HBM3"] * 2))
    rows = exporter.collect_device_metrics(nvml)
    assert [r["device"] for r in rows] == [0, 1]
    assert rows[0]["chip_type"] == "nvidia_h100_80gb_hbm3"
    assert rows[1]["metrics"] == {
        "hbm_used_bytes": float(1 << 31), "hbm_total_bytes": float(H100_BYTES),
        "tpu_duty_cycle_pct": 97.0, "membw_util_pct": 41.0,
        "uncorrectable_ecc_errors": 2.0}
    # Only names the daemon's file backend keeps.
    assert set(rows[0]["metrics"]) <= _daemon_metric_names()


@pytest.mark.parametrize("fail,missing", [
    ((), set()),
    (("utilization",), {"tpu_duty_cycle_pct", "membw_util_pct"}),
    (("memory",), {"hbm_used_bytes", "hbm_total_bytes"}),
    (("ecc",), {"uncorrectable_ecc_errors"}),
])
def test_unsupported_metric_is_left_out(fail, missing):
    [row] = exporter.collect_device_metrics(
        Nvml(FakeNvmlLib(["NVIDIA H100 80GB HBM3"], fail=fail)))
    full = {"hbm_used_bytes", "hbm_total_bytes", "tpu_duty_cycle_pct",
            "membw_util_pct", "uncorrectable_ecc_errors"}
    assert set(row["metrics"]) == full - missing


def test_ecc_off_and_no_devices():
    [row] = exporter.collect_device_metrics(
        Nvml(FakeNvmlLib(["NVIDIA A100-SXM4-40GB"], ecc_on=False)))
    assert "uncorrectable_ecc_errors" not in row["metrics"]
    assert row["chip_type"] == "nvidia_a100-sxm4-40gb"
    assert exporter.collect_device_metrics(
        Nvml(FakeNvmlLib(["x"], fail=("count",)))) == []


def test_no_nvml_is_an_empty_device_list(tmp_path):
    assert Nvml.load("libdynotpu_no_such_nvml.so.1") is None
    assert exporter.collect_device_metrics(None) == []
    snap = exporter.write_snapshot(str(tmp_path / "m.json"), None)
    assert snap["devices"] == []


def test_snapshot_schema_and_atomic_write_match_jax_exporter(
        tmp_path, monkeypatch):
    assert exporter.DEFAULT_PATH == jax_exporter.DEFAULT_PATH
    nvml = Nvml(FakeNvmlLib(["NVIDIA H100 80GB HBM3"]))
    ours = exporter.write_snapshot(str(tmp_path / "a.json"), nvml)
    rows = exporter.collect_device_metrics(nvml)
    monkeypatch.setattr(jax_exporter, "collect_device_metrics", lambda: rows)
    monkeypatch.setattr(jax_exporter, "collect_sdk_metrics", dict)
    ref = jax_exporter.write_snapshot(str(tmp_path / "b.json"))
    assert set(ours) == set(ref) == {"devices", "ts_ms"}
    assert ours["devices"] == ref["devices"]
    assert abs(ours["ts_ms"] - time.time() * 1000) < 60_000
    assert json.loads((tmp_path / "a.json").read_text()) == ours
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.json", "b.json"]


def test_cli_once_without_nvml(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(Nvml, "load", classmethod(lambda cls: None))
    path = tmp_path / "snap.json"
    exporter.main(["--once", "--path", str(path), "--init-timeout-s", "30"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(path.read_text())
    assert printed["devices"] == []


def test_snapshot_reaches_daemon_query(cpp_build, tmp_path):
    """exporter snapshot -> dynologd's file backend -> queryMetrics, as
    the card's run does with real NVML. The daemon names the card's row
    tpu0 and drops a name it has no field id for (ROADMAP Queue C, C4):
    a GPU-only metric written beside the kept ones never reaches it."""
    path = tmp_path / "snap.json"
    snap = exporter.write_snapshot(str(path), Nvml(FakeNvmlLib(
        ["NVIDIA H100 80GB HBM3"])))
    snap["devices"][0]["metrics"]["power_draw_w"] = 312.0
    path.write_text(json.dumps(snap))
    d = daemon_utils.start_daemon(
        cpp_build / "src",
        extra_flags=(
            "--enable_tpu_monitor", "--tpu_metric_backend=file",
            f"--tpu_metrics_file={path}",
            "--tpu_monitor_reporting_interval_s=1",
        ),
    )
    try:
        metric = "tpu0.hbm_total_bytes"
        deadline, values = time.time() + 15, None
        while time.time() < deadline and not values:
            q = d.rpc({"fn": "queryMetrics", "metrics": [metric],
                       "start_ts": 0,
                       "end_ts": int(time.time() * 1000) + 10_000})
            values = q.get("metrics", {}).get(metric, {}).get("values")
            time.sleep(0.3)
        assert values and values[-1] == float(H100_BYTES), q
        dropped = "tpu0.power_draw_w"
        q = d.rpc({"fn": "queryMetrics", "metrics": [dropped],
                   "start_ts": 0, "end_ts": int(time.time() * 1000) + 10_000})
        assert not q.get("metrics", {}).get(dropped, {}).get("values"), q
    finally:
        daemon_utils.stop_daemon(d)


def test_probe_backend_reports_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    err = _torchinit.probe_backend(timeout_s=120)
    assert err is not None and err.startswith("cuda init failed")
