"""Builds the hand-written CUDA kernels with nvcc and loads them by ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes).
Libraries go to ``build/torch_kernels/`` at the repository root (or
``$DYNOLOG_TORCH_BUILD_DIR``), named by a hash of their sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Building happens at first use; ``build_all()`` builds every library in
parallel (one nvcc per source) and is what ``chip_smoke.py`` calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
HEADERS = ("flash_common.cuh", "sm90_common.cuh")

# Library name -> its source, and the C entry points it exports with their
# ctypes argument types (pointers and the stream as c_void_p, ints as c_int).
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARIES = {
    "flash_fwd": ("flash_fwd.cu", {  # f32, CUDA cores
        "flash_fwd": [_P] * 5 + [_I] * 6 + [_P],
    }),
    "flash_fwd_sm90": ("flash_fwd_sm90.cu", {  # bf16, wgmma + TMA
        "flash_fwd": [_P] * 5 + [_I] * 6 + [_P],
    }),
    "flash_bwd": ("flash_bwd.cu", {  # f32, CUDA cores
        "flash_dq": [_P] * 7 + [_I] * 6 + [_P],
        "flash_dkv": [_P] * 8 + [_I] * 6 + [_P],
    }),
    "flash_bwd_sm90": ("flash_bwd_sm90.cu", {  # bf16, wgmma + TMA
        "flash_dq": [_P] * 7 + [_I] * 6 + [_P],
        "flash_dkv": [_P] * 8 + [_I] * 6 + [_P],
    }),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(os.environ.get("DYNOLOG_TORCH_BUILD_DIR")
                or REPO_ROOT / "build" / "torch_kernels")


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    source = LIBRARIES[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (source, *HEADERS):
        h.update((CSRC / part).read_bytes())
    return build_dir() / f"lib{name}.{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None) -> dict[str, float]:
    """Builds every stale library, one nvcc each, all started together.
    Returns seconds per library built (0.0 when it was already built) and
    writes each compiler log (registers, spills) next to its library."""
    names = list(names or LIBRARIES)
    started, seconds = {}, {}
    t0 = time.time()
    for name in names:
        if _lib_path(name).exists():
            seconds[name] = 0.0
        else:
            started[name] = _start(name)
    errors = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.time() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def call(lib_name: str, fn: str, *args) -> None:
    """Calls a C entry point and raises if it returned a CUDA error."""
    err = getattr(load(lib_name), fn)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {err}")
