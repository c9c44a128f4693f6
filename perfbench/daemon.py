"""dynologd and dyno for a run: built once into the checkout's `build/`
(cmake and ninja where present, else g++ over the sources), started per
run on a port of its own, and driven through the `dyno` CLI as an operator
would. Copied from ``chip_smoke.py`` (``DaemonBuild``, ``gxx_build``,
``Daemon``, ``dyno_gputrace``)."""

from __future__ import annotations

import os
import select
import shutil
import subprocess
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# The card machine's GCC 13+ needs <cstdint> spelled out for the daemon.
CXX_COMPAT_FLAGS = ["-include", "cstdint"]


def bin_dir(root: Path) -> Path:
    return root / "build" / "src"


def build(root: Path) -> str:
    """Builds build/src/dynologd and dyno unless both are there; returns
    the route taken ("prebuilt", "cmake" or "g++")."""
    bins = bin_dir(root)
    if (bins / "dynologd").exists() and (bins / "dyno").exists():
        return "prebuilt"
    if shutil.which("cmake") and shutil.which("ninja"):
        out_dir = root / "build"
        for cmd in (
            ["cmake", "-S", str(root), "-B", str(out_dir), "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=Release",
             "-DCMAKE_CXX_FLAGS=" + " ".join(CXX_COMPAT_FLAGS)],
            ["cmake", "--build", str(out_dir), "--target", "dynologd",
             "dyno"],
        ):
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)}:\n{out.stdout[-4000:]}"
                                   f"{out.stderr[-4000:]}")
        return "cmake"
    _gxx_build(root, root / "build")
    return "g++"


def _gxx_build(repo: Path, out_dir: Path) -> None:
    text = (repo / "src" / "CMakeLists.txt").read_text()
    block = text[text.index("add_library(dynotpu_core STATIC"):]
    block = block[: block.index(")")]
    srcs = [w for w in block.split() if w.endswith(".cpp")]
    obj_dir = out_dir / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "src").mkdir(parents=True, exist_ok=True)
    flags = ["-std=c++17", "-O2", f"-I{repo}", "-pthread", *CXX_COMPAT_FLAGS]

    def compile_one(src: str) -> Path:
        obj = obj_dir / (src.replace("/", "_") + ".o")
        subprocess.run(["g++", *flags, "-c", str(repo / "src" / src), "-o",
                        str(obj)], check=True, capture_output=True)
        return obj

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        objs = list(pool.map(compile_one, srcs))
    lib = obj_dir / "libdynotpu_core.a"
    lib.unlink(missing_ok=True)
    subprocess.run(["ar", "rcs", str(lib), *map(str, objs)], check=True)
    for main, name in (("daemon/Main.cpp", "dynologd"),
                       ("cli/dyno.cpp", "dyno")):
        subprocess.run(["g++", *flags, str(repo / "src" / main), str(lib),
                        "-o", str(out_dir / "src" / name), "-lpthread",
                        "-ldl"], check=True, capture_output=True)


class Daemon:
    """A dynologd on a port of its own with a unique IPC endpoint."""

    def __init__(self, root: Path):
        self.root = root
        self.endpoint = f"perfbench_{uuid.uuid4().hex[:12]}"
        self.proc = subprocess.Popen(
            [str(bin_dir(root) / "dynologd"), "--port=0",
             "--enable_ipc_monitor", f"--ipc_endpoint_name={self.endpoint}",
             "--kernel_monitor_reporting_interval_s=60", "--nouse_JSON"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.port = None
        deadline = time.time() + 15
        fd, pending = self.proc.stdout.fileno(), ""
        while self.port is None and time.time() < deadline:
            ready, _, _ = select.select([fd], [], [], 1.0)
            if not ready:
                continue
            chunk = os.read(fd, 4096).decode(errors="replace")
            if not chunk:
                break
            pending += chunk
            for line in pending.split("\n")[:-1]:
                if line.startswith("DYNOLOG_PORT="):
                    self.port = int(line.split("=", 1)[1])
            pending = pending.split("\n")[-1]
        if self.port is None:
            self.stop()
            raise RuntimeError("dynologd did not announce its port")

    def gputrace(self, job_id: int, log_file: str,
                 args=()) -> tuple[int, str]:
        """`dyno gputrace` for `job_id` into `log_file`, with the further
        arguments `args` (the window, the knobs); (exit code, output)."""
        out = subprocess.run(
            [str(bin_dir(self.root) / "dyno"), "--hostname=localhost",
             f"--port={self.port}", "gputrace", f"--job_id={job_id}",
             f"--log_file={log_file}", *args],
            capture_output=True, text=True, timeout=60)
        return out.returncode, out.stdout + out.stderr

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self.proc.stdout is not None:
            self.proc.stdout.close()
