#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dynolog_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main path and fails (non-zero exit, no result line)
if any phase fails:

1. device: the card's name and power limit; TF32 off for f32 products;
2. build: the CUDA kernels (one nvcc per source, in parallel) and, in the
   background, dynologd/dyno (cmake + ninja, else a parallel g++);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the tests' shapes and at the main path's attention shape
   (B=1, S=2048, H=32, D=128, bf16, causal), element by element (see
   `agreement`), with its time (median and range of timed batches), the
   plain version's, a PyTorch library call's as a yardstick, and its
   bound; bf16 runs the tensor-core kernels (flash_*_sm90.cu), f32 the
   CUDA-core ones; the forward kernel is held to the f32 plain version
   (the JAX package's numerics), the bf16 backward kernels to the plain
   versions that carry P and dS as they do (round_like_kernel=True) and,
   by relative L2 error, to the f32 plain versions; at the main path's
   shape the agreement rule must also reject planted faults (a dropped
   tile);
4. trainer: the flagship transformer at full llama-8B width, cut to
   2 layers, bf16, flash attention, B=1, S=2048, trained with AdamW;
5. capture: while it trains, dynologd triggers an on-demand capture
   through the port's TraceClient (torch.profiler), whose Chrome trace
   must name all three tensor-core kernels and hold the training thread's
   CPU ops.

The launch counters are zeroed just before the main path (phases 4-5)
and read just after. The last lines are the card's name and power limit,
a JSON object with one entry per kernel, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import select
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
BIN_DIR = REPO / "build" / "src"
# src/ takes <cstdint> for granted through other standard headers, which
# GCC 13 and later no longer include; force it in rather than edit src/.
CXX_COMPAT_FLAGS = ["-include", "cstdint"]

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its FLOP over the rate of
# its input type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Products per kernel: Q K^T and P V; + dO V^T and dS K; + P^T dO, dS^T Q.
PRODUCTS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
REPLACES = {
    "flash_fwd": "dynolog_tpu/ops/flash_attention.py:62",
    "flash_dq": "dynolog_tpu/ops/flash_attention.py:143",
    "flash_dkv": "dynolog_tpu/ops/flash_attention.py:184",
}
# The main path's (bf16) sources; f32 cases run flash_fwd.cu and
# flash_bwd.cu.
SOURCES = {
    "flash_fwd": "dynolog_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
    "flash_dq": "dynolog_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
    "flash_dkv": "dynolog_tpu_torch/ops/csrc/flash_bwd_sm90.cu",
}
# Largest relative L2 error of a bf16 backward kernel's output against the
# f32 plain version (the JAX package's numerics). P and dS enter the
# tensor-core products as bf16 pairs (16 significant bits), so what remains
# is the output's own bf16 rounding and the order of the f32 sums.
BWD_F32_REL_L2 = 5e-3
SLICE = dict(b=1, s=2048, h=32, d=128)
N_LAYERS = 2
STEPS = 5  # uncaptured, timed train steps before the capture


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ daemon build


class DaemonBuild(threading.Thread):
    """Builds build/src/dynologd and dyno unless both are present: cmake +
    ninja where installed, else g++ over the dynotpu_core sources of
    src/CMakeLists.txt, one job per core."""

    def __init__(self):
        super().__init__(name="daemon_build", daemon=True)
        self.seconds = 0.0
        self.route = "prebuilt"
        self.error: str | None = None

    def run(self) -> None:
        t0 = time.time()
        try:
            if not ((BIN_DIR / "dynologd").exists()
                    and (BIN_DIR / "dyno").exists()):
                if shutil.which("cmake") and shutil.which("ninja"):
                    self.route = "cmake"
                    self._cmake()
                else:
                    self.route = "g++"
                    gxx_build(REPO, REPO / "build")
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            self.error = f"{type(e).__name__}: {e}"
        self.seconds = time.time() - t0

    def _cmake(self) -> None:
        build = REPO / "build"
        for cmd in (
            ["cmake", "-S", str(REPO), "-B", str(build), "-G", "Ninja",
             "-DCMAKE_BUILD_TYPE=Release",
             "-DCMAKE_CXX_FLAGS=" + " ".join(CXX_COMPAT_FLAGS)],
            ["cmake", "--build", str(build), "--target", "dynologd", "dyno",
             "--", "-k", "0"],
        ):
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)}:\n{out.stdout[-4000:]}"
                                   f"{out.stderr[-4000:]}")


def gxx_build(repo: Path, build: Path) -> None:
    """g++ build of dynologd and dyno into build/src (the route of
    scripts/manual_build.sh, with one compile job per core)."""
    text = (repo / "src" / "CMakeLists.txt").read_text()
    block = text[text.index("add_library(dynotpu_core STATIC"):]
    block = block[: block.index(")")]
    srcs = [w for w in block.split() if w.endswith(".cpp")]
    obj_dir = build / "obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    (build / "src").mkdir(parents=True, exist_ok=True)
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
    for main, out in (("daemon/Main.cpp", "dynologd"), ("cli/dyno.cpp", "dyno")):
        subprocess.run(["g++", *flags, str(repo / "src" / main), str(lib),
                        "-o", str(build / "src" / out), "-lpthread", "-ldl"],
                       check=True, capture_output=True)


# ------------------------------------------------------------ the daemon


class Daemon:
    def __init__(self):
        self.endpoint = f"dynotpu_smoke_{uuid.uuid4().hex[:12]}"
        self.proc = subprocess.Popen(
            [str(BIN_DIR / "dynologd"), "--port=0", "--enable_ipc_monitor",
             f"--ipc_endpoint_name={self.endpoint}",
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

    def rpc(self, request: dict) -> dict | None:
        """Length-prefixed JSON RPC round trip (the dyno CLI's wire)."""
        with socket.create_connection(("localhost", self.port),
                                      timeout=10) as s:
            body = json.dumps(request).encode()
            s.sendall(struct.pack("<i", len(body)) + body)
            head = s.recv(4, socket.MSG_WAITALL)
            if len(head) < 4:
                return None
            (n,) = struct.unpack("<i", head)
            return json.loads(s.recv(n, socket.MSG_WAITALL))

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


# ------------------------------------------------------------ measuring


def time_ms(fn, reps: int = 10, batches: int = 5,
            warmup: int = 3) -> tuple[float, float, float]:
    """Device time of one fn() call: (median, min, max) over `batches`
    timed batches of `reps` calls each (CUDA events around each batch),
    after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        per_call.append(t0.elapsed_time(t1) / reps)
    per_call.sort()
    return per_call[len(per_call) // 2], per_call[0], per_call[-1]


def fmt_time(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} ms (range {t[1]:.4f}-{t[2]:.4f})"


def bound_ms(name: str, b: int, s: int, h: int, d: int, dtype: str,
             causal: bool) -> tuple[float, str]:
    """Least time on an H100 for `name`'s work on these shapes: FLOP of
    its S x S x D products over the (q, k) pairs the mask keeps, against
    the bytes it must move (each [B, S, H, D] operand and each f32 row
    vector read once, each output written once)."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 2.0 * PRODUCTS[name] * pairs * d * b * h
    big = b * s * h * d * (2 if dtype == "bfloat16" else 4)
    row = b * h * s * 4
    nbytes = {"flash_fwd": 4 * big + row, "flash_dq": 5 * big + 2 * row,
              "flash_dkv": 6 * big + 2 * row}[name]
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(log_text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) per entry function of an nvcc
    `-Xptxas -v` log; the kernel is its mangled name cut to the name and
    the head dimension, with the element type where the name carries it."""
    rows, kernel, spills = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next(k for k in ("flash_fwd_kernel", "flash_dq_kernel",
                                    "flash_dkv_kernel", "") if k in mangled)
            head_dim = mangled.split("ILi", 1)[-1].split("E", 1)[0]
            dtype = ("f32" if "ILi" + head_dim + "EfE" in mangled else
                     "bf16")
            kernel = f"{name or mangled}<{head_dim}, {dtype}>"
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            rows.append((kernel, regs, spills))
            kernel = None
    return rows


def device_breakdown(events, top: int = 8) -> str:
    """Where the captured steps' device time went: kernel time by name,
    and the busy share of the window from the first kernel's start to the
    last one's end (kernels of one stream do not overlap)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    window = (max(e["ts"] + e["dur"] for e in kernels)
              - min(e["ts"] for e in kernels))
    busy = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ours = sorted((name.split("(")[0], us) for name, us in by_name.items()
                  if "flash_" in name and "_kernel" in name)
    return (f"captured window {window / 1e3:.2f} ms, kernels busy "
            f"{busy / 1e3:.2f} ms ({busy / window:.1%}); top: " + "; ".join(
                f"{name[:60]} {us / 1e3:.2f} ms" for name, us in rows)
            + "; hand-written: " + "; ".join(
                f"{name} {us / 1e3:.2f} ms" for name, us in ours))


# bf16 keeps 8 significant bits: one ulp is at most 2^-7 of the value.
BF16_RTOL = 2.0 ** -7
CASES = [
    # (b, s, h, d, dtype, causal, plain block): the tests' shapes, S=40
    # with blocks 256 falling to 40, then the main path's shape (last).
    (2, 40, 4, 16, torch.float32, True, 256),
    (2, 48, 4, 16, torch.float32, False, 16),
    (2, 64, 4, 16, torch.bfloat16, True, 32),
    (2, 64, 4, 16, torch.bfloat16, False, 32),
    (1, 130, 2, 32, torch.float32, True, 64),
    (1, 200, 2, 64, torch.bfloat16, False, 64),
    (SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"], torch.bfloat16, True,
     64),
]


def agreement(a, r) -> tuple[float, float, float]:
    """(max abs error, largest ratio of error to tolerance, relative L2
    error) of kernel output `a` against plain output `r`, element by
    element; they agree if the ratio is at most 1.

    - f32 (outputs and lse): |a - r| <= 1e-4. Both sum in f32 in another
      order with another exp: 1.7e-6 seen at the tests' shapes.
    - bf16: |a - r| <= 2^-7 |r| + 1e-3 rms(r). Both compute in f32 from
      the same bf16 inputs and round once to bf16, so an element may land
      one bf16 ulp apart, and an ulp is at most 2^-7 of the element; the
      small absolute term covers elements that cancel to near 0.

    The tolerance scales with each element, not with the largest (causal
    attention's first rows average a few values of V and are the largest),
    so a kernel wrong on a share of the rows or keys fails it even where
    those elements are small."""
    af, rf = a.float(), r.float()
    diff = (af - rf).abs()
    if r.dtype == torch.float32:
        tol = torch.full_like(rf, 1e-4)
    else:
        tol = BF16_RTOL * rf.abs() + 1e-3 * rf.pow(2).mean().sqrt()
    return (diff.max().item(), (diff / tol).max().item(),
            (diff.norm() / rf.norm()).item())


def rel_l2(a, r) -> float:
    return ((a.float() - r.float()).norm() / r.float().norm()).item()


def compare_case(F, case, gen):
    """Runs the kernels and their plain versions on one case's inputs;
    returns the inputs, the plain outputs that decide, per kernel the
    agreement of each of its outputs with them, and for bf16 the relative
    L2 error of each backward output against the f32 plain versions.

    The backward kernels are held to the plain versions that carry P and
    dS as they do (round_like_kernel=True; for f32 inputs the same as the
    default)."""
    b, s, h, d, dtype, causal, blk = case
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    out, lse = F.flash_forward(q, k, v, causal)
    p_out, p_lse = F.flash_forward_plain(q, k, v, causal, blk, blk)
    delta = F._delta(p_out, g)
    dq = F.flash_dq(q, k, v, g, p_lse, delta, causal)
    dk, dv = F.flash_dkv(q, k, v, g, p_lse, delta, causal)
    p_dq = F.flash_dq_plain(q, k, v, g, p_lse, delta, causal, blk, blk,
                            round_like_kernel=True)
    p_dk, p_dv = F.flash_dkv_plain(q, k, v, g, p_lse, delta, causal, blk,
                                   blk, round_like_kernel=True)
    f32 = {}
    if dtype == torch.bfloat16:
        f32["flash_dq"] = [F.flash_dq_plain(q, k, v, g, p_lse, delta, causal,
                                            blk, blk)]
        f32["flash_dkv"] = list(F.flash_dkv_plain(q, k, v, g, p_lse, delta,
                                                  causal, blk, blk))
    torch.cuda.synchronize()
    plain = {"flash_fwd": [p_out, p_lse], "flash_dq": [p_dq],
             "flash_dkv": [p_dk, p_dv]}
    got = {"flash_fwd": [out, lse], "flash_dq": [dq], "flash_dkv": [dk, dv]}
    agree = {name: [agreement(a, r) for a, r in zip(got[name], plain[name])]
             for name in plain}
    vs_f32 = {name: [rel_l2(a, r) for a, r in zip(got[name], refs)]
              for name, refs in f32.items()}
    return (q, k, v, g, p_lse, delta), plain, agree, vs_f32


def planted_faults(F, inputs, plain, tile: int = 64) -> list[str]:
    """Checks that the agreement rule rejects a kernel that drops the last
    tile: the forward and dQ without the last `tile` keys' V, dK/dV
    without the last `tile` rows of dO. At the causal main-path shape
    that changes only the last rows or keys, a small share of the output.
    The faults are made from the plain versions that decide. Returns a
    failure message per fault the rule accepts."""
    q, k, v, g, lse, delta = inputs
    v_cut, g_cut = v.clone(), g.clone()
    v_cut[:, -tile:] = 0
    g_cut[:, -tile:] = 0
    faulty = {
        "flash_fwd": [F.flash_forward_plain(q, k, v_cut)[0]],
        "flash_dq": [F.flash_dq_plain(q, k, v_cut, g, lse, delta,
                                      round_like_kernel=True)],
        "flash_dkv": list(F.flash_dkv_plain(q, k, v, g_cut, lse, delta,
                                            round_like_kernel=True)),
    }
    failures = []
    for name, outs in faulty.items():
        found = [agreement(a, r) for a, r in zip(outs, plain[name])]
        rejected = any(ratio > 1 for _, ratio, _ in found)
        log(f"  planted fault in {name}: " + ", ".join(
            f"max abs err {e:.3g} ({ratio:.3g}x tol, rel L2 {l2:.3g}, "
            f"max|plain| {r.float().abs().max().item():.3g})"
            for (e, ratio, l2), r in zip(found, plain[name]))
            + ("; rejected" if rejected else "; ACCEPTED"))
        if not rejected:
            failures.append(f"the agreement rule accepts a planted fault in "
                            f"{name}: {found}")
    return failures


def phase_kernels(F) -> dict:
    """Each kernel against its plain version on the card at every case;
    returns the main-path-shape numbers per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, failures = {}, []
    for case in CASES:
        b, s, h, d, dtype, causal, _ = case
        inputs, plain, agree, vs_f32 = compare_case(F, case, gen)
        where = f"B={b} S={s} H={h} D={d} {str(dtype)[6:]} causal={causal}"
        line = []
        for name, found in agree.items():
            ok = all(ratio <= 1 for _, ratio, _ in found)
            l2_f32 = vs_f32.get(name, [])
            ok_f32 = all(x <= BWD_F32_REL_L2 for x in l2_f32)
            line.append(f"{name} {'ok' if ok and ok_f32 else 'DISAGREES'} "
                        + ", ".join(
                            f"err {e:.3g} ({ratio:.3g}x tol, rel L2 {l2:.3g})"
                            for e, ratio, l2 in found)
                        + (" | rel L2 vs f32 plain " + ", ".join(
                            f"{x:.3g}" for x in l2_f32) if l2_f32 else ""))
            if not ok:
                failures.append(f"{name} disagrees with its plain version at "
                                f"{where}: (max abs err, x tol, rel L2) per "
                                f"output {found}")
            if not ok_f32:
                failures.append(f"{name} is more than {BWD_F32_REL_L2} (rel "
                                f"L2) from the f32 plain version at {where}:"
                                f" {l2_f32}")
            if s == SLICE["s"]:
                results[name] = {"max_abs_err": max(e for e, _, _ in found)}
        log(f"  {where}: " + "; ".join(line))
    failures += planted_faults(F, inputs, plain)
    q, k, v, g, p_lse, delta = inputs
    try:
        F.flash_attention(q, k, v, True, 128, 128)
        failures.append("flash_attention took block_q=128 on the card, "
                        "whose kernels use fixed 64 x 64 tiles")
    except ValueError:
        pass
    if failures:
        raise AssertionError("\n".join(failures))

    # Times at the main path's shape.
    b, s, h, d = SLICE["b"], SLICE["s"], SLICE["h"], SLICE["d"]
    timed = {
        "flash_fwd": (lambda: F.flash_forward(q, k, v, True),
                      lambda: F.flash_forward_plain(q, k, v, True)),
        "flash_dq": (lambda: F.flash_dq(q, k, v, g, p_lse, delta, True),
                     lambda: F.flash_dq_plain(q, k, v, g, p_lse, delta,
                                              round_like_kernel=True)),
        "flash_dkv": (lambda: F.flash_dkv(q, k, v, g, p_lse, delta, True),
                      lambda: F.flash_dkv_plain(q, k, v, g, p_lse, delta,
                                                round_like_kernel=True)),
    }
    # Yardstick only, never called by the port: PyTorch's fused attention,
    # forward, and its backward (which yields dQ, dK and dV in one call).
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2)
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True))
    log(f"  library: scaled_dot_product_attention forward {fmt_time(lib_fwd)}"
        f", backward (dQ, dK and dV in one call) {fmt_time(lib_bwd)}")
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd,
               "flash_dkv": lib_bwd}
    pairs = s * (s + 1) / 2
    for name, (kernel, plain_fn) in timed.items():
        bound, bound_by = bound_ms(name, b, s, h, d, "bfloat16", True)
        t = time_ms(kernel)
        t_plain = time_ms(plain_fn, reps=1, batches=3, warmup=1)
        results[name].update(
            ms=t[0], plain_ms=t_plain[0], bound_ms=bound, bound_by=bound_by,
            library_ms=library[name][0])
        tflops = 2.0 * PRODUCTS[name] * pairs * d * b * h / t[0] / 1e9
        log(f"  {name} at B={b} S={s} H={h} D={d} bf16 causal: kernel "
            f"{fmt_time(t)}, {tflops:.1f} TFLOP/s; plain {fmt_time(t_plain)};"
            f" library {fmt_time(library[name])}; bound {bound:.4f} ms "
            f"({bound_by}); max abs err {results[name]['max_abs_err']:.3g}")
    log("  library_ms: flash_fwd is scaled_dot_product_attention forward; "
        "flash_dq and flash_dkv both carry its whole backward")
    return results


def phase_train_and_capture(F, daemon, cfg, steps_min: int,
                            device: str = "cuda") -> dict:
    """The main path: the trainer under the port's TraceClient, with a
    capture triggered through dynologd."""
    from dynolog_tpu_torch.client import TraceClient
    from dynolog_tpu_torch.models.train import (
        make_batch, make_train_state, make_train_step)
    from dynolog_tpu_torch.models.transformer import param_leaves

    gen = torch.Generator(device=device).manual_seed(0)
    params, optimizer = make_train_state(cfg, device, gen)
    n_params = sum(p.numel() for p in param_leaves(params))
    batch = make_batch(gen, cfg, SLICE["b"], SLICE["s"], device)
    step = make_train_step(cfg)
    log(f"  d_model={cfg.d_model} heads={cfg.n_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} n_layers={cfg.n_layers}: "
        f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}, "
        f"B={SLICE['b']} S={SLICE['s']}")

    job_id = 4300 + os.getpid() % 1000
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_smoke_"))
    client = TraceClient(job_id=job_id, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=1.0)
    if not client.start():
        raise RuntimeError("the shim could not register with dynologd")
    me = threading.get_native_id()
    losses, step_ms = [], []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        F.reset_launches()
        n_steps = 0
        # Steps outside the capture window, timed.
        for _ in range(steps_min):
            t0 = time.perf_counter()
            losses.append(step(params, optimizer, batch))
            client.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n_steps += 1
        trace_base = str(tmp / "trace.json")
        t_rpc = time.time()
        resp = daemon.rpc({
            "fn": "setKinetOnDemandRequest",
            "config": (f"ACTIVITIES_LOG_FILE={trace_base}\n"
                       "ACTIVITIES_ITERATIONS=2"),
            "job_id": job_id, "pids": [0], "process_limit": 3,
        })
        if not (resp and resp.get("processesMatched")):
            raise RuntimeError(f"setKinetOnDemandRequest: {resp}")
        deadline = time.time() + 120
        while client.traces_completed == 0 and time.time() < deadline:
            losses.append(step(params, optimizer, batch))
            client.step()
            n_steps += 1
            if client.last_manifest is not None:
                break
        torch.cuda.synchronize()
        counts = dict(F.launches)
    finally:
        client.stop()
    peak = torch.cuda.max_memory_allocated()

    final_loss = float(losses[-1])
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"non-finite loss: {[float(x) for x in losses]}")
    for name, n in counts.items():
        if n < cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {n} times in {n_steps} "
                                 f"steps of {cfg.n_layers} layers")
    warm = step_ms[1:] or step_ms
    log(f"  trained {n_steps} steps: loss {float(losses[0]):.4f} -> "
        f"{final_loss:.4f}; step {sorted(warm)[len(warm) // 2]:.1f} ms "
        f"(median of {len(warm)} uncaptured steps after the first, "
        f"{[round(x, 1) for x in step_ms]}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")

    # Phase 5 checks: the capture.
    if client.traces_completed != 1:
        raise AssertionError(f"capture did not complete: {client.last_error}")
    manifest = json.loads(Path(f"{trace_base[:-5]}_{os.getpid()}.json")
                          .read_text())
    if manifest["status"] != "ok":
        raise AssertionError(f"capture manifest: {manifest}")
    with open(manifest["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = [e.get("name", "") for e in events
                    if e.get("cat") == "kernel"]
    for name in F.launches:  # bf16: the tensor-core kernels, flash_tc::
        if not any(f"flash_tc::{name}_kernel" in n for n in kernel_names):
            raise AssertionError(f"no tensor-core {name} kernel in the "
                                 f"captured trace")
    cpu_ops = [e for e in events
               if e.get("cat") == "cpu_op" and e.get("tid") == me]
    if not cpu_ops:
        raise AssertionError("no cpu_op events from the training thread")
    latency = manifest["ended_ms"] - t_rpc * 1000
    log("  " + device_breakdown(events))
    log(f"  capture: status ok, {len(kernel_names)} kernel events, "
        f"{len(cpu_ops)} training-thread cpu_ops, "
        f"{manifest['timing'].get('trace_bytes', 0) / 1e6:.1f} MB trace; "
        f"latency RPC->manifest {latency:.0f} ms; timing "
        f"{manifest['timing']}")
    shutil.rmtree(tmp, ignore_errors=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
        from dynolog_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2

    t_start = time.time()
    daemon_build = DaemonBuild()
    daemon = None
    try:
        log("phase 1: device")
        smi = nvidia_smi_line()
        log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("  TF32 off for f32 matmuls and cuDNN")

        log("phase 2: build")
        daemon_build.start()
        t0 = time.time()
        built = _build.build_all()
        log(f"  CUDA kernels built in {time.time() - t0:.1f} s: {built}")
        for name in _build.LIBRARIES:
            log_text = _build._lib_path(name).with_suffix(".log").read_text()
            for kernel, regs, spills in ptxas_summary(log_text):
                log(f"  {name} ptxas: {kernel}: {regs} registers, {spills}")

        log("phase 3: kernels against their plain versions")
        results = phase_kernels(F)
        log("kernels: " + ", ".join(F.launches))

        daemon_build.join()
        if daemon_build.error:
            raise RuntimeError(f"daemon build failed: {daemon_build.error}")
        log(f"  dynologd/dyno ({daemon_build.route}) ready after "
            f"{daemon_build.seconds:.1f} s")
        daemon = Daemon()

        log("phase 4+5: trainer under a daemon-triggered capture")
        from dynolog_tpu_torch.models.transformer import TransformerConfig

        # Full llama-8B widths; depth is the only cut.
        cfg = TransformerConfig.llama_8b_like(
            n_layers=N_LAYERS, dtype="bfloat16", attn_impl="flash")
        counts = phase_train_and_capture(F, daemon, cfg, STEPS)
    except Exception:  # noqa: BLE001 - any phase failing fails the run
        traceback.print_exc()
        return 1
    finally:
        if daemon is not None:
            daemon.stop()
        if daemon_build.is_alive():
            daemon_build.join()  # leave no compiler running behind us

    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
