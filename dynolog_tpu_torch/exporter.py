"""Device-metric exporter for the daemon's `file` backend, on NVIDIA cards.

The counterpart of ``dynolog_tpu/exporter.py``. It publishes a JSON
snapshot of each card's metrics that the C++ daemon's FileTpuBackend
(src/tpumon/TpuMetricBackend.cpp) polls: run
``python -m dynolog_tpu_torch.exporter`` next to
``dynologd --enable_tpu_monitor --tpu_metric_backend=file``.

The source is NVML, loaded with ctypes from ``libnvidia-ml.so.1`` (the
driver's library; no Python package is needed). The snapshot carries only
names the daemon keeps:

    hbm_used_bytes, hbm_total_bytes  nvmlDeviceGetMemoryInfo
    tpu_duty_cycle_pct               utilization.gpu: the share of time a
                                     kernel ran
    membw_util_pct                   utilization.memory
    uncorrectable_ecc_errors         volatile uncorrected count, where ECC
                                     is on

Snapshot schema (the JAX package's)::

    {"devices": [{"device": 0, "chip_type": "nvidia_h100_80gb_hbm3",
                  "metrics": {"hbm_used_bytes": ..., ...}}],
     "ts_ms": <unix ms>}

Without NVML the device list is empty, as the JAX package's is without a
backend. Writes are atomic (tmp file + rename) so the daemon never reads
a torn file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

DEFAULT_PATH = "/tmp/dynolog_tpu_metrics.json"
NVML_LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_DEVICE_NAME_BUFFER_SIZE = 96
NVML_FEATURE_ENABLED = 1
NVML_MEMORY_ERROR_TYPE_UNCORRECTED = 1
NVML_VOLATILE_ECC = 0


class NvmlError(RuntimeError):
    """An NVML call returned an error code."""


class _MemoryInfo(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMemoryInfo": [
        ctypes.c_void_p, ctypes.POINTER(_MemoryInfo)],
    "nvmlDeviceGetUtilizationRates": [
        ctypes.c_void_p, ctypes.POINTER(_Utilization)],
    "nvmlDeviceGetEccMode": [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetTotalEccErrors": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ulonglong)],
}


class Nvml:
    """The NVML calls the exporter makes, on an initialized library
    handle (``Nvml.load()``, or any object with the same functions)."""

    def __init__(self, lib):
        self._lib = lib

    @classmethod
    def load(cls, name: str = NVML_LIBRARY) -> "Nvml | None":
        """dlopen + nvmlInit; None where the library is missing or will
        not initialize (no driver, no card)."""
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            return None
        for fn, argtypes in _SIGNATURES.items():
            try:
                f = getattr(lib, fn)
            except AttributeError:
                return None
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        if lib.nvmlInit_v2() != NVML_SUCCESS:
            return None
        return cls(lib)

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self._lib, fn)(*args)
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{fn} returned {rc}")

    def _handle(self, index: int) -> ctypes.c_void_p:
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index,
                   ctypes.byref(handle))
        return handle

    def shutdown(self) -> None:
        self._lib.nvmlShutdown()

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def name(self, index: int) -> str:
        buf = ctypes.create_string_buffer(NVML_DEVICE_NAME_BUFFER_SIZE)
        self._call("nvmlDeviceGetName", self._handle(index), buf,
                   NVML_DEVICE_NAME_BUFFER_SIZE)
        return buf.value.decode(errors="replace")

    def memory(self, index: int) -> tuple[int, int]:
        """(used, total) bytes of device memory."""
        info = _MemoryInfo()
        self._call("nvmlDeviceGetMemoryInfo", self._handle(index),
                   ctypes.byref(info))
        return info.used, info.total

    def utilization(self, index: int) -> tuple[int, int]:
        """(gpu, memory) percent over the driver's last sample period."""
        util = _Utilization()
        self._call("nvmlDeviceGetUtilizationRates", self._handle(index),
                   ctypes.byref(util))
        return util.gpu, util.memory

    def uncorrectable_ecc(self, index: int) -> int | None:
        """Volatile uncorrected ECC error count; None where ECC is off."""
        handle = self._handle(index)
        current, pending = ctypes.c_int(), ctypes.c_int()
        self._call("nvmlDeviceGetEccMode", handle, ctypes.byref(current),
                   ctypes.byref(pending))
        if current.value != NVML_FEATURE_ENABLED:
            return None
        count = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEccErrors", handle,
                   NVML_MEMORY_ERROR_TYPE_UNCORRECTED, NVML_VOLATILE_ECC,
                   ctypes.byref(count))
        return count.value


def collect_device_metrics(nvml: Nvml | None) -> list[dict]:
    """One metrics dict per card NVML sees; [] without NVML. A metric a
    card does not support is left out of its row."""
    if nvml is None:
        return []
    try:
        count = nvml.device_count()
    except NvmlError:
        return []
    devices = []
    for i in range(count):
        metrics: dict[str, float] = {}
        try:
            used, total = nvml.memory(i)
            metrics["hbm_used_bytes"] = float(used)
            metrics["hbm_total_bytes"] = float(total)
        except NvmlError:
            pass
        try:
            gpu, mem = nvml.utilization(i)
            metrics["tpu_duty_cycle_pct"] = float(gpu)
            metrics["membw_util_pct"] = float(mem)
        except NvmlError:
            pass
        try:
            ecc = nvml.uncorrectable_ecc(i)
            if ecc is not None:
                metrics["uncorrectable_ecc_errors"] = float(ecc)
        except NvmlError:
            pass
        try:
            kind = nvml.name(i)
        except NvmlError:
            kind = "gpu"
        devices.append({
            "device": i,
            "chip_type": kind.lower().replace(" ", "_"),
            "metrics": metrics,
        })
    return devices


def write_snapshot(path: str = DEFAULT_PATH,
                   nvml: Nvml | None = None) -> dict:
    snapshot = {
        "devices": collect_device_metrics(nvml),
        "ts_ms": int(time.time() * 1000),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snapshot, f)
    os.replace(tmp, path)
    return snapshot


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", default=DEFAULT_PATH)
    parser.add_argument(
        "--interval-s", type=float, default=5.0, help="poll interval"
    )
    parser.add_argument(
        "--once", action="store_true", help="write one snapshot and exit"
    )
    parser.add_argument(
        "--init-timeout-s", type=float, default=120.0,
        help="abort if the first device snapshot takes longer (a wedged "
             "driver hangs NVML init indefinitely; an exporter that hangs "
             "reports nothing AND looks alive to supervisors)"
    )
    args = parser.parse_args(argv)
    # Watchdog armed for the FIRST snapshot only: NVML init happens inside
    # it, and a wedged driver hangs init indefinitely.
    if args.init_timeout_s > 0:
        import signal

        def _init_timeout(signum, frame):
            print(
                f"exporter: device init exceeded "
                f"{args.init_timeout_s:.0f}s (driver wedged?); aborting",
                file=sys.stderr, flush=True)
            os._exit(3)

        signal.signal(signal.SIGALRM, _init_timeout)
        signal.setitimer(signal.ITIMER_REAL, args.init_timeout_s)
    nvml = Nvml.load()
    try:
        snap = write_snapshot(args.path, nvml)
        if args.init_timeout_s > 0:
            signal.setitimer(signal.ITIMER_REAL, 0)
        while not args.once:
            time.sleep(args.interval_s)
            snap = write_snapshot(args.path, nvml)
    finally:
        if nvml is not None:
            nvml.shutdown()
    print(json.dumps(snap))


if __name__ == "__main__":
    main()
