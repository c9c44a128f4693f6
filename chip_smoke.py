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
   CPU ops;
6. summary: the capture summarized (dynolog_tpu_torch.trace): the device
   plane, each flash kernel counted once per layer and captured step at
   about its phase-3 time, two steps of about the uncaptured step's time,
   and the shim's summary file beside the trace within 60 s of the
   manifest;
7. diagnosis: the capture saved as a baseline, a second capture of the
   same model at B=2, and the diagnosis CLI reading it as regressed with
   a finding for each flash kernel;
8. ring: a short run under the capture ring (RingConfig), whose stored
   profile names the three flash kernels and diagnoses against the
   baseline; the sample is a duration window on the shim's poll thread,
   whose trace must hold the training thread's cpu_ops; each sample's
   profiler stop, kineto's save and the finish child's write (ms), the
   steps over the stop and save and those that began while the child ran
   are logged (`finish_steps`);
9. exporter: NVML's snapshot for the daemon's file backend, read back
   through a second dynologd with `dyno query`;
10. MoE trainer: the dense trainer freed, the MoE family at the same
   widths with Mixtral-8x7B's 8 experts and top-2 routing (capacity
   factor 1.25), 2 layers, bf16, flash attention, B=1, S=2048, trained
   under a second daemon-triggered capture, whose summary must name the
   three flash kernels at their call counts and read the expert GEMMs as
   `matmul`;
11. collectives: the NCCL probe (python -m dynolog_tpu_torch.collectives,
   one process per card) merged into phase 9's snapshot, and
   collective_mesh_devices and ici_all_reduce_us read back through
   `dyno query`;

12. ring attention: the dense trainer of phase 4 with ring attention
   (attn_impl="ring") on a one-rank NCCL mesh, two steps, whose losses
   and, per leaf, gradient norm and projection after the first step are
   held against the same steps of the flash trainer on one process: the
   distance between ring numerics (f32 softmax, plain products) and the
   flash kernels' at full width;
13. pipeline: the GPipe trainer (reference attention, as the JAX
   package's pipeline) at the same widths, 2 layers, B=2 in 2
   microbatches, on a one-rank NCCL mesh MeshSpec(pipe=1), trained under a
   capture that the port's unitrace (python -m
   dynolog_tpu_torch.cluster.unitrace --hosts localhost:<port>) triggers
   in duration mode (on the shim's poll thread): the capture must begin
   at or after the PROFILE_START_TIME unitrace printed and within one
   step of it, its trace must hold the training thread's cpu_ops and its
   summary must name the steps (its `finish_steps` are logged); its
   losses and per-leaf gradient norms
   and projections are held against the dense trainer with reference
   attention on one process on the same batch;
14. fleet straggler loop: the port's FleetRelay (durable acks) takes the
   records of three dynologd senders h0, h1, h2 (one pod), each with a
   dense flash trainer of phase 4 in a process of its own under the
   port's TraceClient, h0 and h1 at B=1 and h2 at B=2 (the straggler);
   each job step rate reaches the relay (read from each daemon's store,
   ROADMAP C12), h0's and h1's rates set the spread, and the port's
   FleetWatcher must fire once, on h2 with h0 or h1 as the peer, capture
   both under one trace context through their daemons' advertised rpc
   ports, and have the port's engine (dynolog_tpu_torch.diagnose) write a
   `regressed` report with a finding for each flash kernel; every host
   live, no sequence gap, records equal to the applied sequence; the
   capture latencies of phases 5, 7 and 14 rendered as a histogram
   exposition, and h2 sampled with the perf CLI where `perf` is on PATH;
15. capture knobs: phase 4's trainer under one shim, captured three
   times in turns through the dyno CLI (`dyno gputrace --iterations=2`)
   at the default levels (the JAX capture's: Python frames, host ops
   with shapes, device), with --python_tracer_level=0,
   --host_tracer_level=0, --device_tracer_level=0, --host_tracer_level=3
   and --notrace_json, with the host and device tracers both off, and
   with all three tracers off; each capture's timing, events by
   category, steps and flash rows are logged (and each setting's median
   and range of stop, export and bytes), and each must hold Python
   frames only with the Python tracer on (at host level 0 too, as in the
   JAX capture), cpu_ops only with the host tracer, kernels (and the
   three flash kernels at their call counts) only with the device
   tracer, two steps, a summary file unless --notrace_json, and, with no
   tracer left, an error manifest naming the three knobs;
16. first capture and a step-less app: phase 4's trainer in fresh
   processes (`chip_smoke.py --first-capture SPEC`), one at a time under
   the one dynologd, (a) four with the shim's profiler warmup off and on
   in turns, each taking 3 steps, then (with the warmup) training until
   warmup_done, then captured twice through `dyno gputrace
   --iterations=2`: each capture's profiler start, stop, export and
   bytes, the warmup's own ms and the steps that overlapped it are
   logged, and every manifest must be ok and name the three flash
   kernels; (b) one whose loop never calls client.step(), captured
   through `dyno gputrace --duration_ms=500`: an ok manifest whose trace
   names the three flash kernels and holds the training thread's
   cpu_ops, and a summary that names no step (its `finish_steps` are
   logged); every warmup held the app (parked) without waiting for a
   step() that never comes;
17. mixed captures: (a) phase 4's trainer in a fresh process
   (`chip_smoke.py --mixed SPEC`) under one TraceClient, after 3
   uncaptured steps: 60 duration windows and 60 `--iterations=2` windows
   in turns, each finished in-process: every manifest ok with no launch
   of its window lost (its timing's lost_launches 0), and every
   iteration window with each flash kernel at its call count; (b) the
   real client: phase 4's trainer in a fresh process (`chip_smoke.py
   --poll SPEC`) under a TraceClient started as an application starts
   one, with the profiler warmup (not waited on: the app trains at once)
   and the capture ring on, and a long step (5 train steps) every 50
   steps; 30 duration and 30 `--iterations=2` windows in turns through
   the dyno CLI, each finished in the shim's child: every manifest ok
   with lost_launches 0, every iteration window with the three flash kernels at one count, its
   call count or more where a long step fell inside, every ring sample
   and the warmup with lost_launches 0, and their timing (parked) and
   the steps over the warmup logged; (c) (b)'s process never calling
   client.step(), the ring off, with four idle threads beside its
   training thread (in time.sleep(), Thread.join(), a socket's accept()
   and an idle asyncio loop): 100 duration windows, every manifest ok
   with lost_launches 0 (equal to the launches its trace lacks a kernel
   record for), every start and the warmup parked (the app's threads
   held at their next Python event, the idle ones counted as waiting)
   after a park of under 1000 ms;

then, with two cards or more, phase 10's model trained expert-parallel
over NCCL (data x expert, one process per card) for two steps, held in
the same way against the same steps on one process; and with four cards
or more, (a) the dense trainer with ring attention over
MeshSpec(seq=2, model=2) against phase 12's one-card ring run, (b)
phase 10's model over MeshSpec(expert=2, model=2) (flash attention on
each rank's heads) against one process, (d) the dense trainer with flash
attention over MeshSpec(seq=2, model=2) (each rank attends over the
gathered sequence with its heads and keeps its chunk) against phase 4's
trainer on one process, (e) phase 10's model over MeshSpec(seq=2,
expert=2) at B=2 (each rank holds both rows' chunk) against the same
model on one process at B=2, and (c) the GPipe trainer at 4
layers (one a stage) over MeshSpec(pipe=4), B=4 in 4 microbatches, each
rank under a capture of its own daemon that one unitrace run over the
four daemons triggers (every rank's trace must hold the handoffs' NCCL
send/recv kernels), against the same model on one process (with fewer
cards each is logged as not run: NCCL cannot place two ranks on one
card). `python3 chip_smoke.py --ep` builds the kernels and runs the
expert-parallel check alone; `python3 chip_smoke.py --mesh` builds them
and the daemon, and runs phase 12 and the checks (a), (b), (d), (e) and
(c); `python3 chip_smoke.py --stepless` builds them and the daemon, and
runs phase 17 (c) alone.

The launch counters are zeroed just before each main path (phases 4-5,
the dense trainer; phase 10, the MoE trainer; phase 12's ring run; phase
13's pipeline run; phase 14's three trainers, each in its own process;
phase 15's trainer; phase 16's and 17's processes, each from its start;
in each rank of a multi-card check, its steps) and
read just after; phases 7 and 8 drive the dense trainer again, each with
the counters zeroed before it and read after it. The last lines are the
card's name and power limit, a JSON object with one entry per kernel
(launches: phases 4-5 and 10 together, and in launches_by_path each
path's own: ring and pp (phase 13), whose plain products launch no
kernel, fleet (phase 14's trainers together), knobs (phase 15),
first_capture (phase 16's processes together), mixed, mixed_poll and
stepless_poll (phase 17 (a), (b) and (c)), the
expert-parallel ranks' total as moe_ep, the ranks' totals of (a), (b),
(d), (e) and (c) as tp, moe_tp, sp, moe_sp and pp_mesh, or null where a
check did not run), and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import importlib
import json
import math
import os
import re
import select
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
from collections import Counter
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
# Phase 10: Mixtral-8x7B's routing (8 experts, top 2) at the same widths.
MOE = dict(n_experts=8, moe_top_k=2)
# Phase 12 and the multi-card checks train for EP_STEPS steps on each
# side, one row of S=2048 per `data` rank, and hold the losses (the second
# follows the first update) and each leaf's gradient after the first step
# to the run they compare with (mesh_train, deviation). EP_TOL is JAX's
# own tolerance for a sharded bf16 loss, relative for a gradient norm: a
# gradient summed once too often or not averaged over `data` moves a norm
# by a factor, not by a few bf16 roundings.
EP_STEPS, EP_TOL = 2, 2e-2
# The multi-card checks on four cards: (a) the dense trainer with ring
# attention, the JAX package's dp x sp x tp mesh with `data` dropped (the
# EP check holds `data`); (b) phase 10's model over its EP x TP mesh,
# again without `data`; (d) the dense trainer with flash attention over
# (a)'s mesh, so its step and peak compare with ring attention's; (e)
# phase 10's model over `seq` and `expert`, at MESH_ROWS rows: with two
# rows a rank, the MoE slot order (row, chunk) differs from rank order.
MESH_CASES = {"tp": {"seq": 2, "model": 2},
              "moe_tp": {"expert": 2, "model": 2},
              "sp": {"seq": 2, "model": 2},
              "moe_sp": {"seq": 2, "expert": 2}}
MESH_ROWS = {"moe_sp": 2}  # global batch rows; one a `data` rank otherwise
# How far each case's mesh run lay from the run it is held to, when
# scripts/torch_mesh_noise.py measured it (NVIDIA H100 80GB HBM3, 700 W,
# torch 2.11; every rank alike, a repeat bit-equal). The MoE model's
# numbers are routing's: in bf16 the `model` cut rounds every layer's
# partial sums apart, the router of the next layer flips near-tied
# choices, and the router's own gradient norm moves most (model=2 alone:
# second loss 0.165, norm 0.030). A check holds each of these at twice
# its value at least. The pipeline's numbers are the same for pipe=1, 2
# and 4: microbatching (B=4 in 4) moves them, the stages do not. Over
# `seq` (same cards, torch 2.11): (d) lies as far as (a), the `model` cut's
# partial sums (seq=2 alone: second loss 0.00022, projection 0.0078);
# (e)'s distance is expert=2's alone (0.051, 0.098; seq=2 alone at B=2:
# 0.00034, 0.0066).
MESH_NOISE = {
    "tp": {"loss2": 0.0027518, "norm": 0.00047846, "projection": 0.019803},
    "moe_tp": {"loss2": 0.13079, "norm": 0.026408, "projection": 0.36328},
    "sp": {"loss2": 0.0016875, "norm": 0.00048588, "projection": 0.027423},
    "moe_sp": {"loss2": 0.047313, "norm": 0.0047357, "projection": 0.095519},
    "pp": {"loss2": 0.00010872, "norm": 0.00031659, "projection": 0.012172},
}
# Phase 13 and the multi-card check (c): the GPipe trainer (reference
# attention, as the JAX package's pipeline runs) at `rows` rows of S=2048
# in `n_micro` microbatches, held against the dense trainer with
# reference attention on one process, on the same batch. Phase 13 is one
# stage at N_LAYERS layers; (c) is the JAX package's dp x pp mesh
# {data: 2, pipe: 4} with `data` dropped to fit four cards, one layer a
# stage.
PIPE_ONE = dict(spec={"pipe": 1}, n_layers=N_LAYERS, rows=2, n_micro=2)
PIPE_MESH = dict(spec={"pipe": 4}, n_layers=4, rows=4, n_micro=4)
# The pipeline trains under one capture that the port's unitrace triggers
# through every rank's daemon, in duration mode, this long after it runs.
UNITRACE_DELAY_S, CAPTURE_MS = 2, 400
STEPS = 5  # uncaptured, timed train steps before the capture
ITERATIONS = 2  # steps per daemon-triggered capture
# The capture latency (RPC -> manifest) of earlier runs of this script on
# an H100 80GB HBM3 at 700 W, logged beside this run's.
EARLIER_LATENCY_MS = "680-1145"
# Phases 5 and 10's captures at the shim's earlier fixed levels (CPU and
# CUDA activities with input shapes, no Python frames) on an H100 80GB
# HBM3 at 700 W: profiler stop ms, export ms, trace MB; logged beside
# this run's, taken at the JAX capture's default levels.
EARLIER_CAPTURE = {"dense": (96, 30, 2.4), "moe": (121, 44, 4.2)}


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
    def __init__(self, extra_flags=()):
        self.endpoint = f"dynotpu_smoke_{uuid.uuid4().hex[:12]}"
        self.proc = subprocess.Popen(
            [str(BIN_DIR / "dynologd"), "--port=0", "--enable_ipc_monitor",
             f"--ipc_endpoint_name={self.endpoint}",
             "--kernel_monitor_reporting_interval_s=60", "--nouse_JSON",
             *extra_flags],
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


class Trainer:
    """The flagship transformer and its AdamW state on the card, shared by
    every phase that trains; batches are made from the seed once per
    batch size."""

    def __init__(self, cfg, device: str = "cuda"):
        from dynolog_tpu_torch.models.train import (
            make_batch, make_train_state, make_train_step)
        from dynolog_tpu_torch.models.transformer import param_leaves

        self.cfg, self.device = cfg, device
        self.gen = torch.Generator(device=device).manual_seed(0)
        self.params, self.optimizer = make_train_state(cfg, device, self.gen)
        self.n_params = sum(p.numel() for p in param_leaves(self.params))
        self._make_batch = make_batch
        self.batches = {}
        self.batch(SLICE["b"])
        self._step = make_train_step(cfg)

    def batch(self, b: int):
        if b not in self.batches:
            self.batches[b] = self._make_batch(self.gen, self.cfg, b,
                                               SLICE["s"], self.device)
        return self.batches[b]

    def step(self, b: int = SLICE["b"]):
        return self._step(self.params, self.optimizer, self.batch(b))


def manifest_path(trace_base: str) -> Path:
    return Path(f"{trace_base[:-5]}_{os.getpid()}.json")


def capture(daemon, client, trainer, job_id: int, trace_base: str, b: int,
            losses: list) -> tuple[dict, float, int]:
    """Triggers an on-demand capture of ITERATIONS steps through dynologd
    and trains at batch size `b` until the shim has written its manifest.
    Returns the manifest, the latency from the RPC to the manifest (ms)
    and the number of steps run."""
    done, prev = client.traces_completed, client.last_manifest
    t_rpc = time.time()
    resp = daemon.rpc({
        "fn": "setKinetOnDemandRequest",
        "config": (f"ACTIVITIES_LOG_FILE={trace_base}\n"
                   f"ACTIVITIES_ITERATIONS={ITERATIONS}"),
        "job_id": job_id, "pids": [0], "process_limit": 3,
    })
    if not (resp and resp.get("processesMatched")):
        raise RuntimeError(f"setKinetOnDemandRequest: {resp}")
    deadline, n = time.time() + 120, 0
    while client.traces_completed == done and time.time() < deadline:
        losses.append(trainer.step(b))
        client.step()
        n += 1
        if client.last_manifest is not prev:
            break
    torch.cuda.synchronize()
    if client.traces_completed != done + 1:
        raise AssertionError(f"capture did not complete: {client.last_error}")
    manifest = json.loads(manifest_path(trace_base).read_text())
    if manifest["status"] != "ok":
        raise AssertionError(f"capture manifest: {manifest}")
    return manifest, manifest["ended_ms"] - t_rpc * 1000, n


def phase_train_and_capture(F, daemon, trainer, client, job_id: int,
                            tmp: Path, steps_min: int) -> dict:
    """The main path: the trainer under the port's TraceClient, with a
    capture triggered through dynologd."""
    cfg = trainer.cfg
    log(f"  d_model={cfg.d_model} heads={cfg.n_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} n_layers={cfg.n_layers}: "
        f"{trainer.n_params / 1e9:.3f} B parameters, {cfg.dtype}, "
        f"B={SLICE['b']} S={SLICE['s']}")
    me = threading.get_native_id()
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    n_steps = 0
    # Steps outside the capture window, timed.
    for _ in range(steps_min):
        t0 = time.perf_counter()
        losses.append(trainer.step())
        client.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n_steps += 1
    trace_base = str(tmp / "trace.json")
    manifest, latency, n = capture(daemon, client, trainer, job_id,
                                   trace_base, SLICE["b"], losses)
    n_steps += n
    counts = dict(F.launches)
    peak = torch.cuda.max_memory_allocated()

    final_loss = float(losses[-1])
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"non-finite loss: {[float(x) for x in losses]}")
    for name, count in counts.items():
        if count < cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {count} times in {n_steps}"
                                 f" steps of {cfg.n_layers} layers")
    warm = step_ms[1:] or step_ms
    median_ms = sorted(warm)[len(warm) // 2]
    log(f"  trained {n_steps} steps: loss {float(losses[0]):.4f} -> "
        f"{final_loss:.4f}; step {median_ms:.1f} ms "
        f"(median of {len(warm)} uncaptured steps after the first, "
        f"{[round(x, 1) for x in step_ms]}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")

    # Phase 5 checks: the capture.
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
    log("  " + device_breakdown(events))
    frames = sum(e.get("cat") == "python_function" for e in events)
    if not frames:
        raise AssertionError("no Python frames at the default levels")
    stop, export, mb = EARLIER_CAPTURE["moe" if cfg.n_experts else "dense"]
    log(f"  capture: status ok, {len(kernel_names)} kernel events, "
        f"{len(cpu_ops)} training-thread cpu_ops, {frames} Python frames, "
        f"{manifest['timing'].get('trace_bytes', 0) / 1e6:.1f} MB trace; "
        f"latency RPC->manifest {latency:.0f} ms; timing "
        f"{manifest['timing']} (without Python frames, earlier runs: stop "
        f"{stop} ms, export {export} ms, {mb} MB)")
    return {"counts": counts, "manifest": manifest, "latency_ms": latency,
            "manifest_path": manifest_path(trace_base), "step_ms": median_ms}


def flash_rows(summary: dict) -> dict:
    """The summary's rows of the three tensor-core kernels (D=128)."""
    rows = {o["op"]: o for o in summary["top_ops"]}
    return {name: rows.get(f"flash_tc::{name}_kernel<128>")
            for name in PRODUCTS}


def wait_for(path: Path, deadline: float) -> bool:
    while not path.exists() and time.time() < deadline:
        time.sleep(0.1)
    return path.exists()


def stop_span(started_ms: float, timing: dict) -> tuple[float, float]:
    """The wall-clock span (ms) of a capture's profiler stop, from its
    start time and its manifest timing."""
    t0 = (started_ms + timing.get("profiler_start_ms", 0)
          + timing.get("window_ms", 0))
    return t0, t0 + timing.get("profiler_stop_ms", 0)


def overlapping(spans: list, t0_ms: float, t1_ms: float) -> list:
    """The times (ms) of the steps whose wall-clock (begin, end) span in
    ms meets [t0_ms, t1_ms]."""
    return [round(e - b, 1) for b, e in spans if b < t1_ms and e > t0_ms]


def finish_steps(spans: list, started_ms: float, timing: dict) -> dict:
    """A poll-thread capture's cost to the training thread: its
    profiler_stop_ms, export_ms (kineto's save) and write_ms (the finish
    child), the steps (ms) that overlap its stop and save, and those that
    began while the child ran."""
    t0, t1 = stop_span(started_ms, timing)
    saved = t1 + timing.get("export_ms", 0)
    child = [round(e - b, 1) for b, e in spans
             if saved <= b < saved + timing.get("write_ms", 0)]
    return {**{k: timing.get(k) for k in (
                "profiler_stop_ms", "export_ms", "write_ms")},
            "steps_over_stop_and_save": overlapping(spans, t0, saved),
            "steps_while_child_ran": child}


def thread_cpu_ops(trace_file: str, tid: int) -> int:
    """The cpu_op events of thread `tid` in a Chrome trace."""
    with open(trace_file) as f:
        return sum(e.get("cat") == "cpu_op" and e.get("tid") == tid
                   for e in json.load(f)["traceEvents"])


def phase_summary(cap: dict, results: dict, n_layers: int) -> dict:
    """A capture (phase 5's, or phase 10's) through the port's
    summarizer, and the summary the shim's child wrote beside it; returns
    the summary."""
    from dynolog_tpu_torch import diagnose, trace

    manifest = cap["manifest"]
    t0 = time.time()
    summary = trace.summarize(str(cap["manifest_path"]), group=False)
    took = time.time() - t0
    planes = [p["name"] for p in summary["planes"]]
    if "/device:GPU:0" not in planes:
        raise AssertionError(f"no device plane in the summary: {planes}")
    with open(manifest["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    want = n_layers * ITERATIONS
    # Each kernel's row holds every call of it in the trace, at the calls'
    # total time; the median call, robust to one call stretched by the
    # card, is about the phase-3 median.
    for name, row in flash_rows(summary).items():
        if row is None:
            raise AssertionError(f"flash_tc::{name}_kernel<128> is not in "
                                 "the summary")
        calls = [e["dur"] / 1e3 for e in events if e.get("cat") == "kernel"
                 and f"flash_tc::{name}_kernel<128>" in e.get("name", "")]
        median = statistics.median(calls) if calls else math.nan
        ratio = median / results[name]["ms"]
        log(f"  {name}: {row['count']} calls, {row['total_ms']:.4f} ms in "
            f"the summary; calls in the trace (ms) "
            f"{[round(c, 4) for c in calls]}, median {ratio:.2f}x its "
            f"phase-3 median {results[name]['ms']:.4f} ms")
        if (row["count"] != want or len(calls) != want
                or not math.isclose(row["total_ms"], sum(calls),
                                    abs_tol=2e-3)
                or not 0.5 <= ratio <= 2.0):
            raise AssertionError(
                f"{name}: {row['count']} calls in the summary, "
                f"{row['total_ms']:.4f} ms, and {calls} ms in the trace "
                f"(want {want} calls, median about "
                f"{results[name]['ms']:.4f} ms)")
    # The steps are the device's: about the uncaptured step's time.
    steps = summary.get("steps", {})
    if (steps.get("count") != ITERATIONS
            or not 0.5 <= steps["p50_ms"] / cap["step_ms"] <= 2.0):
        raise AssertionError(f"steps in the summary: {steps}, against a "
                             f"{cap['step_ms']:.1f} ms step")
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    spans = [(e["cat"], e["name"], round(e.get("dur", 0) / 1e3, 3))
             for e in events if e.get("name", "").startswith("ProfilerStep#")]
    log(f"  steps: {steps} (uncaptured step {cap['step_ms']:.1f} ms); "
        f"ProfilerStep spans (category, name, ms): "
        f"{spans}; events by category: {cats}")
    for row in summary["top_ops"][:8]:
        log(f"  top: {row['op'][:70]} {row['total_ms']:.3f} ms x "
            f"{row['count']} ({row['pct']}%) -> "
            f"{diagnose.classify_op(row['op'])}")
    gemms = [o["op"] for o in summary["top_ops"] if "nvjet" in o["op"]]
    wrong = [op for op in gemms if diagnose.classify_op(op) != "matmul"]
    if wrong:
        raise AssertionError(f"cuBLAS GEMMs not read as matmul: {wrong}")
    log(f"  {len(gemms)} nvjet GEMM rows, all matmul; "
        f"{len(summary['top_ops'])} rows in all")
    # The shim's child writes <run>.summary.json after the manifest.
    trace_file = manifest["trace_file"]
    summary_path = Path(trace_file[: -len(trace.TRACE_SUFFIX)]
                        + trace.SUMMARY_SUFFIX)
    if not wait_for(summary_path, manifest["ended_ms"] / 1000 + 60):
        raise AssertionError(f"no {summary_path.name} within 60 s of the "
                             "manifest")
    after = summary_path.stat().st_mtime - cap["manifest_path"].stat().st_mtime
    if after < 0:
        raise AssertionError("the summary was written before the manifest")
    written = json.loads(summary_path.read_text())
    if written != trace.summarize(trace_file):
        raise AssertionError("the shim's summary differs from summarize()")
    log(f"  trace {manifest['timing'].get('trace_bytes', 0) / 1e6:.1f} MB "
        f"summarized in {took:.2f} s; the shim's summary landed "
        f"{after:.2f} s after the manifest; capture latency RPC->manifest "
        f"{cap['latency_ms']:.0f} ms (earlier runs: {EARLIER_LATENCY_MS} "
        "ms)")
    return summary


def run_cli(args: list[str], timeout: float = 300):
    """Runs `python args...` from the repository root."""
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)


def phase_diagnosis(F, daemon, trainer, client, job_id: int, tmp: Path,
                    cap: dict) -> tuple[Path, float]:
    """Baseline from the phase-5 capture; a second capture at B=2 must be
    diagnosed as regressed, naming each flash kernel. Returns the
    baseline's path and the capture's latency (ms)."""
    base = tmp / "baseline.json"
    out = run_cli(["-m", "dynolog_tpu_torch.diagnose",
                   str(cap["manifest_path"]), "--save-baseline", str(base)])
    if out.returncode != 0:
        raise AssertionError(f"--save-baseline: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    b, losses = 2, []
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    for _ in range(2):  # uncaptured steps at the new shape
        losses.append(trainer.step(b))
        client.step()
    trace_base = str(tmp / "trace_b2.json")
    manifest, latency, n = capture(daemon, client, trainer, job_id,
                                   trace_base, b, losses)
    counts = dict(F.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"non-finite loss at B=2: {losses}")
    for name, count in counts.items():
        if count < trainer.cfg.n_layers * (2 + n):
            raise AssertionError(f"{name} launched {count} times at B=2")
    log(f"  B={b}: {2 + n} steps, launches {counts}, peak memory "
        f"{peak / 2**30:.2f} GiB, capture latency {latency:.0f} ms")
    out = run_cli(["-m", "dynolog_tpu_torch.diagnose",
                   str(manifest_path(trace_base)), "--baseline", str(base),
                   "--json", "--top", "50"])
    if out.returncode != 0:
        raise AssertionError(f"diagnose: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    report = json.loads(out.stdout)
    log(f"  verdict {report['verdict']}: {report['headline']}")
    for f in report["findings"][:5]:
        log(f"  finding: ({f['kind']}) {f['message'][:150]}")
    if report["verdict"] != "regressed":
        raise AssertionError(f"B=2 diagnosed as {report['verdict']}")
    for name in PRODUCTS:
        op = f"flash_tc::{name}_kernel<128>"
        found = [(f["kind"], f["severity_pct"]) for f in report["findings"]
                 if f["op"] == op]
        kinds = [kind for kind, _ in found]
        log(f"  {op}: (kind, severity %) {found}")
        if not {"compute_regression", "fusion_shape_change"} & set(kinds):
            raise AssertionError(f"no regression finding for {op}: {kinds}")
    return base, latency


def phase_ring(F, daemon, trainer, tmp: Path, base: Path) -> None:
    """A short run under the capture ring: a stored profile naming the
    three flash kernels, diagnosable against the baseline. The sample is
    a duration window on the shim's poll thread: its trace must hold the
    training thread's cpu_ops (read before the ring deletes it), and the
    steps that overlap its profiler stop are logged."""
    from dynolog_tpu_torch.client import RingConfig, TraceClient

    ring_dir = tmp / "ring"
    client = TraceClient(
        job_id=5300 + os.getpid() % 1000, endpoint=daemon.endpoint,
        poll_interval_s=0.2, report_interval_s=1.0,
        ring=RingConfig(every_n_steps=2, window_ms=200, min_interval_s=0,
                        dir=str(ring_dir)))
    me, samples, take = threading.get_native_id(), [], client._ring_sample

    def inspected(trace_dir: str):
        # The finished trace is copied (no parse here, on the poll
        # thread) before the ring deletes it, and read after the run.
        t0 = time.time() * 1000
        pending, timing = take(trace_dir)
        done = pending.wait(30.0)
        kept = tmp / f"ring_sample_{len(samples)}.json"
        if "write_error" not in done:
            shutil.copy(pending.path, kept)
        samples.append((t0, {**timing, **done}, kept))
        return pending, timing

    client._ring_sample = inspected
    if not client.start():
        raise RuntimeError("the ring's shim could not register")
    F.reset_launches()
    n, t0, spans = 0, time.time(), []
    try:
        while client.ring.captures == 0 and time.time() - t0 < 120:
            b = time.time() * 1000
            trainer.step()
            client.step()
            torch.cuda.synchronize()
            spans.append((b, time.time() * 1000))
            n += 1
    finally:
        client.stop()
    counts = dict(F.launches)
    if client.ring.captures == 0:
        raise AssertionError(f"no ring profile: {client.ring.last_error}")
    for started, timing, kept in samples:
        cpu_ops = thread_cpu_ops(str(kept), me) if kept.exists() else 0
        log(f"  ring sample: {cpu_ops} training-thread cpu_ops; "
            f"{finish_steps(spans, started, timing)} against the run's "
            f"median step {statistics.median(e - b for b, e in spans):.1f} "
            "ms")
        if not cpu_ops:
            raise AssertionError("a ring sample's trace holds no cpu_op of "
                                 "the training thread")
    for name, count in counts.items():
        if count < trainer.cfg.n_layers * n:
            raise AssertionError(f"{name} launched {count} times in {n} "
                                 "ring-run steps")
    doc = json.loads(Path(client.ring.last_path).read_text())
    missing = [name for name, row in flash_rows(doc["summary"]).items()
               if row is None]
    if missing:
        raise AssertionError(f"ring profile lacks {missing}: "
                             f"{[o['op'] for o in doc['summary']['top_ops']]}")
    log(f"  {n} steps, launches {counts}; ring profile "
        f"{Path(client.ring.last_path).name} of step {doc['step']}, "
        f"window {doc['window_ms']} ms configured, timing "
        f"{client.ring.last_timing}")
    out = run_cli(["-m", "dynolog_tpu_torch.diagnose", "--ring",
                   str(ring_dir), "--baseline", str(base)])
    if out.returncode != 0:
        raise AssertionError(f"diagnose --ring: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    log("  " + out.stdout.splitlines()[0])


def phase_exporter(tmp: Path) -> Path:
    """NVML's snapshot for the daemon's file backend, read back through a
    second dynologd with `dyno query`; returns the snapshot's path."""
    from dynolog_tpu_torch._torchinit import probe_backend

    err = probe_backend(timeout_s=120)
    if err:
        raise AssertionError(f"CUDA init probe: {err}")
    snap = tmp / "gpu_metrics.json"
    out = run_cli(["-m", "dynolog_tpu_torch.exporter", "--once", "--path",
                   str(snap)], timeout=180)
    if out.returncode != 0:
        raise AssertionError(f"exporter: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    devices = json.loads(snap.read_text())["devices"]
    if not devices:
        raise AssertionError("the exporter found no device through NVML")
    dev = devices[0]
    total = dev["metrics"].get("hbm_total_bytes", 0.0)
    want = torch.cuda.get_device_properties(0).total_memory
    log(f"  CUDA init probe ok; device 0: {dev['chip_type']}, "
        f"{dev['metrics']}; torch total_memory {want}")
    if abs(total - want) > 0.01 * want:
        raise AssertionError(f"hbm_total_bytes {total} is not within 1% of "
                             f"{want}")
    got = query_snapshot(snap, ["tpu0.hbm_total_bytes"])
    if got["tpu0.hbm_total_bytes"] != total:
        raise AssertionError(f"dyno query: {got}")
    log(f"  dyno query tpu0.hbm_total_bytes -> {got['tpu0.hbm_total_bytes']:.0f}")
    return snap


def query_snapshot(snap: Path, names: list[str]) -> dict:
    """The last value of each `names` metric that a dynologd reading
    `snap` through its file backend returns to `dyno query`."""
    daemon = Daemon(extra_flags=(
        "--enable_tpu_monitor", "--tpu_metric_backend=file",
        f"--tpu_metrics_file={snap}", "--tpu_monitor_reporting_interval_s=1"))
    got, text = {}, ""
    try:
        deadline = time.time() + 20
        while len(got) < len(names) and time.time() < deadline:
            time.sleep(0.5)
            q = subprocess.run(
                [str(BIN_DIR / "dyno"), f"--port={daemon.port}", "query",
                 "--metrics=" + ",".join(names)],
                capture_output=True, text=True, timeout=30)
            text = q.stdout.strip()
            if q.returncode == 0 and "response = " in text:
                resp = json.loads(text.split("response = ", 1)[1])
                for name in names:
                    values = (resp.get("metrics", {}).get(name, {})
                              .get("values"))
                    if values:
                        got[name] = values[-1]
    finally:
        daemon.stop()
    if len(got) < len(names):
        raise AssertionError(f"dyno query of {names}: {text[-1000:]}")
    return got


def expert_gemm_rows(summary: dict, n_experts: int) -> list[dict]:
    """The summary's kernel rows launched by a batched product over the
    experts: two [E, a, b] x [E, b, c] operands (the expert SwiGLU's
    einsums and their gradients). The memsets and copies such an op
    launches beside its GEMM are not kernels and are left out."""
    rows = []
    for row in summary["top_ops"]:
        if row["op"].startswith(("Memset", "Memcpy")):
            continue
        for shape in row.get("shapes", []):
            dims = [[int(x) for x in d.split(",")]
                    for d in re.findall(r"\[([\d,]+)\]", shape)]
            if (len(dims) == 2 and len(dims[0]) == len(dims[1]) == 3
                    and dims[0][0] == dims[1][0] == n_experts
                    and dims[0][2] == dims[1][1]):
                rows.append(row)
                break
    return rows


def phase_moe(F, daemon, tmp: Path, results: dict) -> dict:
    """Phase 10: the MoE trainer at Llama-3-8B widths under a
    daemon-triggered capture, summarized; returns its launch counts."""
    from dynolog_tpu_torch import diagnose
    from dynolog_tpu_torch.client import TraceClient

    cfg = moe_config()
    log(f"  {cfg.n_experts} experts, top-{cfg.moe_top_k}, capacity factor "
        f"{cfg.moe_capacity_factor}")
    trainer = Trainer(cfg)
    job_id = 4700 + os.getpid() % 1000
    moe_tmp = tmp / "moe"
    moe_tmp.mkdir()
    client = TraceClient(job_id=job_id, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=1.0)
    if not client.start():
        raise RuntimeError("the MoE trainer's shim could not register")
    try:
        cap = phase_train_and_capture(F, daemon, trainer, client, job_id,
                                      moe_tmp, STEPS)
        summary = phase_summary(cap, results, cfg.n_layers)
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
    rows = expert_gemm_rows(summary, cfg.n_experts)
    if not rows:
        raise AssertionError("no expert GEMM ([E, a, b] x [E, b, c]) row in "
                             "the MoE capture's summary")
    for row in rows:
        log(f"  expert GEMM: {row['op'][:70]} {row['total_ms']:.3f} ms x "
            f"{row['count']} {row['shapes']} -> "
            f"{diagnose.classify_op(row['op'])}")
    wrong = [r["op"] for r in rows if diagnose.classify_op(r["op"]) != "matmul"]
    if wrong:
        raise AssertionError(f"expert GEMMs not read as matmul: {wrong}")
    return cap["counts"]


def phase_collectives(snap: Path) -> None:
    """Phase 11: the NCCL probe merged into phase 9's snapshot and read
    back through `dyno query`."""
    out = run_cli(["-m", "dynolog_tpu_torch.collectives", "--merge-into",
                   str(snap)], timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"collectives: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    metrics = json.loads(snap.read_text())["devices"][0]["metrics"]
    probe = {k: v for k, v in metrics.items()
             if k.startswith("ici_") or k == "collective_mesh_devices"}
    log(f"  {probe}")
    n = torch.cuda.device_count()
    if probe.get("collective_mesh_devices") != n:
        raise AssertionError(f"collective_mesh_devices is not {n}: {probe}")
    if (n > 1) != ("ici_all_reduce_gbps" in probe):
        raise AssertionError(f"bandwidth keys with {n} card(s): {probe}")
    names = ["tpu0.collective_mesh_devices", "tpu0.ici_all_reduce_us"]
    got = query_snapshot(snap, names)
    # Doubles through the daemon's JSON.
    if not all(math.isclose(got[f"tpu0.{k}"], probe[k], rel_tol=1e-5)
               for k in ("collective_mesh_devices", "ici_all_reduce_us")):
        raise AssertionError(f"dyno query returned {got} for {probe}")
    log(f"  dyno query {got}")


def dense_config(attn_impl: str = "flash"):
    """Phase 4's model: Llama-3-8B widths, 2 layers, bf16."""
    from dynolog_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig.llama_8b_like(
        n_layers=N_LAYERS, dtype="bfloat16", attn_impl=attn_impl)


def moe_config():
    """Phase 10's model: Llama-3-8B widths, 2 layers, Mixtral-8x7B's
    routing, bf16, flash attention."""
    return dataclasses.replace(dense_config(), **MOE)


def check_stop_unparsed(trainer, tmp: Path) -> dict:
    """The shim's profiler stopped after two steps of the trainer: torch
    must have parsed no event into FunctionEvents on the training thread
    (ROADMAP C9). Returns torch's profiler stats for the log."""
    from dynolog_tpu_torch.client import TorchProfiler

    prof = TorchProfiler()
    prof.start(str(tmp))
    for _ in range(ITERATIONS):
        trainer.step()
        prof.step()
    t0 = time.perf_counter()
    prof.stop()
    stop_ms = (time.perf_counter() - t0) * 1e3
    profile = prof._stopped.profiler
    stats = dict(vars(profile._stats), stop_ms=stop_ms)
    if profile._function_events is not None or stats.get(
            "parse_kineto_call_duration_us"):
        raise AssertionError(f"the profiler's stop parsed its events: {stats}")
    Path(prof.export(str(tmp))).unlink()
    return stats


def named_leaves(params: dict, first_layer: int = 0) -> list:
    """(index, path, leaf) in param_leaves' order, paths as PARAM_RULES
    reads them ("layers/0/router"). A pipeline stage's tree holds the
    layers from `first_layer` on: paths and indices are those of the
    whole tree, so a leaf's projection seed is the same on every run."""
    out = [(k, name, params[name])
           for k, name in enumerate(("embedding", "w_out", "final_scale"))]
    for i, layer in enumerate(params["layers"], first_layer):
        out += [(3 + i * len(layer) + j, f"layers/{i}/{name}", layer[name])
                for j, name in enumerate(sorted(layer))]
    return out


def leaf_checks(path: str, grad: torch.Tensor, mesh, seed: int) -> tuple:
    """(norm, projection) of a whole leaf's gradient, from this rank's
    slice of it: the projection is its dot product with a N(0, 1) tensor
    drawn from `seed` at the whole leaf's shape (this rank's block of it),
    so it moves when an element changes sign or place, which the norm
    does not see. The blocks' sums are added over each axis the leaf is
    cut over."""
    import torch.distributed as dist

    from dynolog_tpu_torch.parallel.sharding import axis, rule_for

    g = grad.float()
    sizes = [axis(mesh, name)[:2] if name else (1, 0)
             for name in rule_for(path)]
    whole = [n * size for n, (size, _) in zip(g.shape, sizes)]
    r = torch.randn(whole + list(g.shape[len(whole):]), device=g.device,
                    generator=torch.Generator(device=g.device).manual_seed(
                        seed))
    for dim, (size, rank) in enumerate(sizes):
        r = r.narrow(dim, rank * g.shape[dim], g.shape[dim])
    out = torch.stack([g.square().sum(), (g * r).sum()])
    for name in rule_for(path):
        group = axis(mesh, name)[2] if name else None
        if group is not None:
            dist.all_reduce(out, group=group)
    return float(out[0].sqrt()), float(out[1])


def mesh_train(cfg, rows: int = 1, mesh=None, device: str = "cuda",
               seq: int = SLICE["s"]) -> dict:
    """EP_STEPS train steps from seed 0 on the global batch of seed 1
    (`rows` rows of `seq` tokens), on one process or, with `mesh`, on this
    rank. Returns the losses, each whole leaf's gradient norm and
    projection after the first step (``leaf_checks``), the launches
    (zeroed just before the steps), and on the card each step's time (host
    clock to a synchronise) and the steps' peak memory, leaf_checks'
    temporaries left out (None off the card)."""
    from dynolog_tpu_torch.models.train import (
        make_batch, make_train_state, make_train_step)

    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    cuda = torch.device(device).type == "cuda"
    params, opt = make_train_state(
        cfg, device, torch.Generator(device=device).manual_seed(0), mesh=mesh)
    tokens = make_batch(torch.Generator(device=device).manual_seed(1), cfg,
                        rows, seq, device)
    step = make_train_step(cfg, mesh)
    F.reset_launches()
    losses, leaves, step_ms, peaks = [], {}, [], []
    for i in range(EP_STEPS):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, tokens)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        for n, path, leaf in named_leaves(params) if i == 0 else ():
            leaves[path] = leaf_checks(path, leaf.grad, mesh, 2 + n)
    return {"losses": losses, "leaves": leaves,
            "launches": dict(F.launches), "step_ms": step_ms,
            "peak_gib": max(peaks) if cuda else None}


def free_cache() -> None:
    """Returns this process's cached device memory to the card, for the
    rank that shares card 0 with it."""
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_rank(rank: int, world: int, cfg, spec: dict,
               rows: int | None = None) -> dict:
    """One rank of a multi-card check, or of phase 12's one-rank ring run
    (mesh_train under MeshSpec(**spec), on `rows` rows, one a `data` rank
    by default)."""
    from dynolog_tpu_torch.parallel.sharding import MeshSpec, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's runs
    rows = spec.get("data", 1) if rows is None else rows
    return mesh_train(cfg, rows, make_mesh(MeshSpec(**spec)))


def deviation(a: dict, b: dict) -> dict:
    """How far mesh_train's run `a` lies from run `b`: the loss difference
    of each step and, over the leaves, the largest difference of the
    gradient norm and of the projection, each over b's norm."""
    out = {f"loss{i + 1}": abs(x - y)
           for i, (x, y) in enumerate(zip(a["losses"], b["losses"]))}
    for j, key in enumerate(("norm", "projection")):
        out[key] = max(abs(a["leaves"][k][j] - v[j]) / v[0]
                       for k, v in b["leaves"].items())
    return out


def hold(who: str, got: dict, cfg, ref: dict | None = None,
         limits: dict | None = None) -> list:
    """Failure messages for mesh_train's run `got` of `cfg`: a kernel of
    its path launched fewer times than once per layer and step, or, held
    against run `ref`, a deviation over its limit."""
    dev = deviation(got, ref) if ref is not None else {}
    worst = worst_leaves(got, ref) if ref is not None else {}
    log(f"  {who}: losses {got['losses']}; {dev} (leaves {worst}); launches "
        f"{got['launches']}; steps {[round(t, 1) for t in got['step_ms']]} "
        f"ms; peak memory {got['peak_gib']:.2f} GiB")
    failures = []
    if cfg.attn_impl == "flash":
        short = {k: v for k, v in got["launches"].items()
                 if v < cfg.n_layers * EP_STEPS}
        if short:
            failures.append(f"{who} launched {short} in {EP_STEPS} steps of "
                            f"{cfg.n_layers} layers")
    over = {k: v for k, v in dev.items() if not v <= limits[k]}
    if over:
        failures.append(f"{who} is further than {limits}: {over}")
    return failures


def limits_for(floor: dict, measured: dict | None = None) -> dict:
    """EP_TOL for the first loss and the norms; the second loss and the
    projections at twice `floor`, the distance between two equivalent
    one-process runs that round differently, and at least EP_TOL; each
    `measured` key (MESH_NOISE) at twice its value at least."""
    out = {k: EP_TOL if k in ("loss1", "norm") else max(EP_TOL, 2 * v)
           for k, v in floor.items()}
    for k, v in (measured or {}).items():
        out[k] = max(out[k], 2 * v)
    return out


def worst_leaves(a: dict, b: dict) -> dict:
    """The leaf of the largest norm and projection difference
    (``deviation``) of run `a` from run `b`."""
    return {key: max(b["leaves"], key=lambda k: abs(
        a["leaves"][k][j] - b["leaves"][k][j]) / b["leaves"][k][0])
        for j, key in enumerate(("norm", "projection"))}


def phase_multicard_ep() -> dict | None:
    """With two cards or more, EP_STEPS expert-parallel steps over NCCL
    held against the same steps on one process; returns the ranks' total
    launches, or None with one card.

    The second loss and the projections are held to limits_for the
    distance of a plain-attention one-process run: at init the router's
    probabilities are near-uniform over the experts, so a rounding flips
    tokens' top-2 choices and moves those numbers by more than EP_TOL (on
    an H100 at 700 W, 0.087 for the second loss and 0.20 for a
    projection)."""
    from dynolog_tpu_torch.parallel.launch import spawn

    n = torch.cuda.device_count()
    if n < 2:
        log("  multi-card EP: not run: 1 card (NCCL cannot place two ranks "
            "on one card); the gloo CPU tests cover expert parallelism")
        return None
    world = 4 if n >= 4 else 2
    spec = {"data": world // 2, "expert": 2}
    cfg = moe_config()
    free_cache()
    t0 = time.time()
    ranks = spawn(_mesh_rank, world, "nccl", (cfg, spec), timeout_s=300)
    t_ranks = time.time() - t0
    one = mesh_train(cfg, spec["data"])
    floor = deviation(
        mesh_train(dataclasses.replace(cfg, attn_impl="reference"),
                   spec["data"]), one)
    limits = limits_for(floor)
    log(f"  with plain attention {floor}; limits {limits}")
    failures = hold("the one-process run", one, cfg)
    for r, got in enumerate(ranks):
        failures += hold(f"rank {r}", got, cfg, one, limits)
    log(f"  multi-card EP: {world} cards, mesh {spec}, {EP_STEPS} steps at "
        f"B={spec['data']} S={SLICE['s']}; ranks {t_ranks:.1f} s")
    if failures:
        raise AssertionError("\n".join(failures))
    return {name: sum(r["launches"][name] for r in ranks)
            for name in ranks[0]["launches"]}


def phase_ring_attention() -> tuple[dict, dict, dict]:
    """Phase 12: EP_STEPS steps of the dense trainer with ring attention on
    a one-rank NCCL mesh, held against the same steps of the flash trainer
    on one process (the first loss and the norms to EP_TOL, the second
    loss and the projections to EP_TOL too: the dense model routes
    nothing, so no rounding flips a choice). Returns the ring run, its
    distance from the flash run (the yardstick of the check (a)) and the
    flash run (the reference of the check (d))."""
    from dynolog_tpu_torch.parallel.launch import spawn

    cfg = dense_config("ring")
    free_cache()
    ring = spawn(_mesh_rank, 1, "nccl", (cfg, {}), timeout_s=300)[0]
    flash = mesh_train(dense_config())
    distance = deviation(ring, flash)
    failures = hold("flash, one process", flash, dense_config()) + hold(
        "ring attention, one-rank mesh", ring, cfg, flash,
        {k: EP_TOL for k in distance})
    if failures:
        raise AssertionError("\n".join(failures))
    return ring, distance, flash


def phase_multicard_mesh(ring: dict, ring_distance: dict,
                         flash: dict) -> dict | None:
    """With four cards or more, EP_STEPS steps of each MESH_CASES mesh over
    NCCL: (a) "tp", the dense trainer with ring attention, against phase
    12's one-card ring run, its floor phase 12's distance (ring against
    flash numerics at full width); (b) "moe_tp", phase 10's model, against
    one process, its floor a plain-attention one-process run's distance,
    as the EP check's; (d) "sp", the dense flash trainer, against phase
    12's flash run on one process, its floor a reference-attention
    one-process run's distance; (e) "moe_sp", phase 10's model at B=2,
    against one process at B=2, its floor as (b)'s. Each is held to
    limits_for its floor and its MESH_NOISE; the cache is freed before
    each. Returns each case's total launches over its ranks, or None with
    fewer cards."""
    from dynolog_tpu_torch.parallel.launch import spawn

    if torch.cuda.device_count() < 4:
        log(f"  multi-card TP and SP: not run: {torch.cuda.device_count()} "
            "card(s); the gloo CPU tests cover tensor, sequence and expert "
            "parallelism")
        return None
    moe = moe_config()
    plain = {"attn_impl": "reference"}
    one_moe = {rows: mesh_train(moe, rows)
               for rows in (1, MESH_ROWS["moe_sp"])}
    refs = {
        "tp": (dense_config("ring"), ring, ring_distance),
        "moe_tp": (moe, one_moe[1], deviation(
            mesh_train(dataclasses.replace(moe, **plain)), one_moe[1])),
        "sp": (dense_config(), flash, deviation(
            mesh_train(dense_config("reference")), flash)),
        "moe_sp": (moe, one_moe[2], deviation(
            mesh_train(dataclasses.replace(moe, **plain), 2), one_moe[2])),
    }
    failures, counts = [], {}
    for rows, run in one_moe.items():
        failures += hold(f"MoE, one process, B={rows}", run, moe)
    for name, spec in MESH_CASES.items():
        cfg, ref, floor = refs[name]
        rows = MESH_ROWS.get(name, 1)
        limits = limits_for(floor, MESH_NOISE[name])
        free_cache()
        t0 = time.time()
        ranks = spawn(_mesh_rank, 4, "nccl", (cfg, spec, rows),
                      timeout_s=300)
        log(f"  {name}: mesh {spec}, {cfg.attn_impl} attention, {EP_STEPS} "
            f"steps at B={rows} S={SLICE['s']}, ranks {time.time() - t0:.1f} "
            f"s; reference losses {ref['losses']}; floor {floor}; limits "
            f"{limits}")
        for r, got in enumerate(ranks):
            failures += hold(f"{name} rank {r}", got, cfg, ref, limits)
        counts[name] = {k: sum(r["launches"][k] for r in ranks)
                        for k in ranks[0]["launches"]}
    if failures:
        raise AssertionError("\n".join(failures))
    return counts


def pipe_config(n_layers: int):
    """Llama-3-8B widths, `n_layers` layers, bf16, reference attention."""
    return dataclasses.replace(dense_config("reference"), n_layers=n_layers)


def _pipe_rank(rank: int, world: int, cfg, spec: dict, rows: int,
               n_micro: int, capture: dict | None = None,
               device: str = "cuda", seq: int = SLICE["s"]) -> dict:
    """One rank of phase 13 or of the check (c): EP_STEPS steps of the
    GPipe trainer on this rank of MeshSpec(**spec) from seed 0 on the
    global batch of seed 1 (`rows` rows of `seq` tokens), as mesh_train
    runs the dense trainer. Returns the losses, this rank's leaves'
    gradient norms and projections after the first step (paths and seeds
    of the whole tree), the launches, the steps' times and peak.

    Under `capture` ({"endpoints", "ports", "job_id", "log_file"}) every
    rank's TraceClient registers with its own daemon (endpoints[rank]),
    rank 0 runs the port's unitrace over every daemon (ports) after the
    first step, and the ranks train on, in step, until every rank's
    capture has completed. Each rank then also returns its manifest, the
    wall-clock ms at which each of its client.step() calls began, each
    step's wall-clock (begin, end) ms and its training thread's id; rank
    0 returns unitrace's exit code and output. Off the card
    (`device`) the times are the host's and the peak is None."""
    import torch.distributed as dist

    from dynolog_tpu_torch.client import TraceClient
    from dynolog_tpu_torch.models.train import make_batch
    from dynolog_tpu_torch.parallel.pipeline import (
        make_pipeline_train_state, make_pipeline_train_step, stage_layers)
    from dynolog_tpu_torch.parallel.sharding import MeshSpec, make_mesh

    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's runs
    cuda = torch.device(device).type == "cuda"
    mesh = make_mesh(MeshSpec(**spec), device)
    params, opt = make_pipeline_train_state(
        cfg, mesh, device, torch.Generator(device=device).manual_seed(0))
    tokens = make_batch(torch.Generator(device=device).manual_seed(1), cfg,
                        rows, seq, device)
    step = make_pipeline_train_step(cfg, mesh, n_micro)
    first = stage_layers(cfg.n_layers, mesh)[0]
    client = unitrace = None
    if capture is not None:
        client = TraceClient(job_id=capture["job_id"],
                             endpoint=capture["endpoints"][rank],
                             poll_interval_s=0.2, report_interval_s=1.0)
        if not client.start():
            raise RuntimeError(f"rank {rank}'s shim could not register")
        dist.barrier()  # every shim registered before the trigger
    F.reset_launches()
    losses, leaves, step_ms, peaks, marks, spans = [], {}, [], [], [], []
    flag = torch.zeros((), dtype=torch.int32, device=device)
    deadline = time.time() + 180
    try:
        while True:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0, wall = time.perf_counter(), time.time() * 1000
            losses.append(float(step(params, opt, tokens)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            spans.append((wall, wall + step_ms[-1]))
            if cuda:
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            for n, path, leaf in (named_leaves(params, first)
                                  if len(losses) == 1 else ()):
                leaves[path] = leaf_checks(path, leaf.grad, mesh, 2 + n)
            if client is not None:
                marks.append(int(time.time() * 1000))
                client.step()
            # Every rank takes the same steps: stop when all are done.
            flag.fill_(int(time.time() > deadline or (
                len(losses) >= EP_STEPS
                and (client is None or client.traces_completed >= 1))))
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            if flag.item():
                break
            if capture is not None and rank == 0 and unitrace is None:
                # After the first step (NCCL's set-up, seconds), so that
                # the start time falls among steady steps.
                unitrace = subprocess.Popen(
                    [sys.executable, "-m",
                     "dynolog_tpu_torch.cluster.unitrace",
                     "--hosts=" + ",".join(f"localhost:{p}"
                                           for p in capture["ports"]),
                     f"--job-id={capture['job_id']}",
                     f"--log-file={capture['log_file']}",
                     f"--duration-ms={CAPTURE_MS}",
                     f"--start-time-delay={UNITRACE_DELAY_S}"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, cwd=REPO)
    finally:
        if client is not None:
            client.stop()
            for proc in client.summary_procs:
                proc.wait(timeout=120)
        if unitrace is not None:
            out, _ = unitrace.communicate(timeout=60)
    got = {"losses": losses[:EP_STEPS], "leaves": leaves,
           "launches": dict(F.launches), "step_ms": step_ms,
           "peak_gib": max(peaks) if cuda else None}
    if client is not None:
        if client.traces_completed < 1:
            raise RuntimeError(f"rank {rank}: no capture in {len(losses)} "
                               f"steps: {client.last_error}")
        got.update(manifest=client.last_manifest, marks=marks, spans=spans,
                   tid=threading.get_native_id())
    if unitrace is not None:
        got["unitrace"] = (unitrace.returncode, out)
    return got


def merged(ranks: list) -> dict:
    """The pipeline ranks' runs as one run of the whole tree: each rank's
    leaves, the losses (the same on every rank), the launches summed, the
    slowest rank's step times and the largest peak. Raises if two ranks
    disagree on a loss or on a replicated leaf's numbers."""
    run = {"losses": ranks[0]["losses"], "leaves": {}, "step_ms": [
        max(t) for t in zip(*(r["step_ms"] for r in ranks))],
        "peak_gib": max(r["peak_gib"] or 0 for r in ranks),
        "launches": {k: sum(r["launches"][k] for r in ranks)
                     for k in ranks[0]["launches"]}}
    for r, got in enumerate(ranks):
        if got["losses"] != run["losses"]:
            raise AssertionError(f"rank {r}'s losses {got['losses']} differ "
                                 f"from rank 0's {run['losses']}")
        for path, numbers in got["leaves"].items():
            if run["leaves"].setdefault(path, numbers) != numbers:
                raise AssertionError(f"{path} differs on rank {r}: "
                                     f"{numbers}, {run['leaves'][path]}")
    return run


def trace_split(trace_file: str, n_steps: int) -> dict:
    """A captured pipeline rank's kernel time per step (ms): compute, the
    NCCL send/recv kernels of the stage handoffs (which hold a stage that
    waits on its peer, so they carry the bubble's wait too), and the idle
    time between the first kernel and the last."""
    with open(trace_file) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    handoff = [e for e in kernels
               if re.search(r"nccl.*(Send|Recv)", e.get("name", ""))]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(e["dur"] for e in kernels)
    nccl = sum(e["dur"] for e in handoff)
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"steps": n_steps, "handoff_kernels": len(handoff),
            **{k: round(v / 1e3 / max(n_steps, 1), 3) for k, v in (
                ("compute_ms", total - nccl), ("handoff_ms", nccl),
                ("idle_ms", span - busy))}}


def check_pipe_capture(ranks: list, n_hosts: int) -> list:
    """Failure messages for the capture of a pipeline run: unitrace must
    have triggered every host, every rank's manifest must carry the start
    time unitrace printed, its window must open at or after it and within
    one step of it, its trace must hold the training thread's cpu_ops
    (the window runs on the shim's poll thread), its summary must name
    the steps and, with more than one stage, its trace must hold the
    handoffs' NCCL send/recv kernels. Logs the steps that overlap each
    rank's profiler stop."""
    from dynolog_tpu_torch import trace

    rc, out = ranks[0]["unitrace"]
    found = re.search(r"synchronized start: (\d+)", out)
    if rc != 0 or out.count("[ok]") != n_hosts or not found:
        return [f"unitrace exited {rc} and printed:\n{out}"]
    start, failures = int(found.group(1)), []
    log(f"  unitrace: {' | '.join(out.strip().splitlines())}")
    for r, got in enumerate(ranks):
        m, marks = got["manifest"], got["marks"]
        after = [i for i, b in enumerate(marks) if b >= start]
        opened = max((i for i, b in enumerate(marks)
                      if b <= m["started_ms"]), default=-1)
        summary = trace.summarize(m["trace_file"], group=False)
        steps = summary.get("steps", {})
        split = trace_split(m["trace_file"], steps.get("count", 0))
        cpu_ops = thread_cpu_ops(m["trace_file"], got["tid"])
        log(f"  rank {r}: {cpu_ops} training-thread cpu_ops; "
            f"{finish_steps(got['spans'], m['started_ms'], m['timing'])} "
            f"against the median step "
            f"{statistics.median(e - b for b, e in got['spans']):.1f} ms")
        if not cpu_ops:
            failures.append(f"rank {r}'s trace holds no cpu_op of its "
                            "training thread")
        log(f"  rank {r}: capture {m['status']}, PROFILE_START_TIME "
            f"{m['config'].get('PROFILE_START_TIME')}, began "
            f"{m['started_ms'] - start} ms after it, at step {opened + 1} of "
            f"{len(marks)} (the first at or after it: step "
            f"{after[0] + 1 if after else None}); timing {m['timing']}; "
            f"summary steps {steps}; per step {split}")
        if (m["status"] != "ok"
                or m["config"].get("PROFILE_START_TIME") != str(start)
                or m["started_ms"] < start or not after
                or opened - after[0] > 1):
            failures.append(f"rank {r}'s capture did not begin within one "
                            f"step of {start}: {m}")
        if not steps.get("count"):
            failures.append(f"rank {r}'s summary names no step: {steps}")
        if len(ranks) > 1 and not split["handoff_kernels"]:
            failures.append(f"rank {r}'s trace holds no NCCL send/recv "
                            "kernel")
    return failures


def phase_pipeline(daemon) -> dict:
    """Phase 13: EP_STEPS steps of the GPipe trainer (PIPE_ONE) on a
    one-rank NCCL mesh, under a capture that the port's unitrace triggers
    through `daemon`, held against the dense trainer with reference
    attention on one process on the same batch, its floor the distance of
    the flash trainer's run from that one. Returns the pipeline's run."""
    from dynolog_tpu_torch.parallel.launch import spawn

    cfg = pipe_config(PIPE_ONE["n_layers"])
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_pipe_"))
    capture = {"endpoints": [daemon.endpoint], "ports": [daemon.port],
               "job_id": 5100 + os.getpid() % 1000,
               "log_file": str(tmp / "pipe.json")}
    free_cache()
    ranks = spawn(_pipe_rank, 1, "nccl",
                  (cfg, PIPE_ONE["spec"], PIPE_ONE["rows"],
                   PIPE_ONE["n_micro"], capture), timeout_s=300)
    run = merged(ranks)
    ref = mesh_train(cfg, PIPE_ONE["rows"])
    floor = deviation(mesh_train(dense_config(), PIPE_ONE["rows"]), ref)
    limits = limits_for(floor)
    log(f"  GPipe {PIPE_ONE}: {len(ranks[0]['step_ms'])} steps; "
        f"flash against reference attention, one process: {floor}; "
        f"limits {limits}")
    failures = hold("dense, reference attention, one process", ref, cfg)
    failures += hold("GPipe, one-rank mesh", run, cfg, ref, limits)
    failures += check_pipe_capture(ranks, 1)
    shutil.rmtree(tmp, ignore_errors=True)
    free_cache()
    if failures:
        raise AssertionError("\n".join(failures))
    return run


def phase_multicard_pipeline() -> dict | None:
    """The check (c), with four cards or more: EP_STEPS steps of the GPipe
    trainer over PIPE_MESH's MeshSpec(pipe=4), each rank under a capture
    of its own daemon that one unitrace run triggers, held against the same
    model (4 layers, reference attention) on one process, to limits_for
    the flash run's distance from it and MESH_NOISE["pp"]. Returns the
    ranks' total launches, or None with fewer cards."""
    from dynolog_tpu_torch.parallel.launch import spawn

    if torch.cuda.device_count() < 4:
        log(f"  multi-card pipeline: not run: {torch.cuda.device_count()} "
            "card(s); the gloo CPU tests cover the pipeline over pipe=2, 4 "
            "and data=2 x pipe=4")
        return None
    cfg = pipe_config(PIPE_MESH["n_layers"])
    rows = PIPE_MESH["rows"]
    ref = mesh_train(cfg, rows)
    floor = deviation(mesh_train(dataclasses.replace(cfg, attn_impl="flash"),
                                 rows), ref)
    limits = limits_for(floor, MESH_NOISE["pp"])
    daemons = [Daemon() for _ in range(4)]
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_pipe4_"))
    try:
        capture = {"endpoints": [d.endpoint for d in daemons],
                   "ports": [d.port for d in daemons],
                   "job_id": 5200 + os.getpid() % 1000,
                   "log_file": str(tmp / "pipe4.json")}
        free_cache()
        t0 = time.time()
        ranks = spawn(_pipe_rank, 4, "nccl",
                      (cfg, PIPE_MESH["spec"], rows, PIPE_MESH["n_micro"],
                       capture), timeout_s=300)
        log(f"  pp: mesh {PIPE_MESH}, {len(ranks[0]['step_ms'])} steps at "
            f"S={SLICE['s']}, ranks {time.time() - t0:.1f} s; reference "
            f"losses {ref['losses']}; floor {floor}; limits {limits}")
        failures = hold("dense, 4 layers, reference attention, one process",
                        ref, cfg)
        for r, got in enumerate(ranks):
            log(f"  pp rank {r}: steps "
                f"{[round(t, 1) for t in got['step_ms']]} ms; peak memory "
                f"{got['peak_gib']:.2f} GiB")
        failures += hold("pp", merged(ranks), cfg, ref, limits)
        failures += check_pipe_capture(ranks, len(daemons))
    finally:
        for d in daemons:
            d.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("\n".join(failures))
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


# ------------------------------------------------------------ phase 14


# Phase 14: three dense flash trainers on the one card (FLEET_ROWS rows of
# S=2048 each), each under a dynologd that sends its records to the port's
# FleetRelay; h2 trains at B=2 and is the straggler.
FLEET_ROWS = {"h0": 1, "h1": 1, "h2": 2}
FLEET_LIVE_S = 30  # bound for every host to reach `live` at the relay
FLEET_METRIC_S = 240  # bound for every host's step rate to reach the relay
FLEET_CAPTURE_S = 120  # bound for one capture's manifest
FLEET_BREACH_S = 30  # bound for the watcher to see the straggler
FLEET_TRAIN_S = 600  # a trainer stops by itself after this long
# The engine's cut of ranked findings: every one. A finding ranks by its
# impact, per-call time times calls, and under time-slicing a flash
# kernel's per-call time is noise: a run of this phase had 80 findings,
# and a cut at 50 dropped dQ's, whose impact was 0.1 ms.
FLEET_DIAGNOSE_TOP = 1000


def fleet_trainer(spec: dict) -> int:
    """`chip_smoke.py --fleet-trainer SPEC`: one of phase 14's trainers,
    the dense flash trainer at spec["rows"] rows under a port TraceClient
    registered with spec["endpoint"], until spec["stop"] exists. Writes
    its step times, peak memory and launches to spec["result"]."""
    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    from dynolog_tpu_torch.client import TraceClient

    trainer = Trainer(dense_config())
    rows, stop = spec["rows"], Path(spec["stop"])
    trainer.batch(rows)
    client = TraceClient(job_id=spec["job_id"], endpoint=spec["endpoint"],
                         poll_interval_s=0.2, report_interval_s=1.0)
    if not client.start():
        raise RuntimeError(f"trainer {spec['host']}: the shim could not "
                           "register with its dynologd")
    step_ms, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    t_end = time.time() + FLEET_TRAIN_S
    try:
        while not stop.exists() and time.time() < t_end:
            t0 = time.perf_counter()
            losses.append(float(trainer.step(rows)))
            client.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
    warm = sorted(step_ms[3:] or step_ms)
    Path(spec["result"]).write_text(json.dumps({
        "steps": len(step_ms), "step_ms": warm[len(warm) // 2],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": dict(F.launches), "traces": client.traces_completed,
        "finite": all(math.isfinite(x) for x in losses)}))
    return 0


class RateForwarder(threading.Thread):
    """Every half second, each host's newest `metric` from its dynologd's
    metric store (queryMetrics), merged into the host's relay entry as an
    untracked record: no wal_seq, so it moves no watermark. dynologd's
    relay records carry its collectors' rows only, never the IPC
    monitor's job telemetry (ROADMAP C12), so without this the relay
    never sees a step rate."""

    def __init__(self, relay, daemons: dict, metric: str):
        super().__init__(name="rate_forwarder", daemon=True)
        self.relay, self.daemons, self.metric = relay, daemons, metric
        self.halt = threading.Event()
        self.forwarded = 0
        self.error: str | None = None

    def forward(self) -> None:
        now = int(time.time() * 1000)
        for host, daemon in self.daemons.items():
            resp = daemon.rpc({"fn": "queryMetrics", "metrics": [self.metric],
                               "start_ts": now - 5000, "end_ts": now + 1000})
            values = (((resp or {}).get("metrics") or {}).get(self.metric)
                      or {}).get("values") or []
            if values:
                self.relay.view.ingest_line(json.dumps(
                    {"host": host, self.metric: float(values[-1])}))
                self.forwarded += 1

    def run(self) -> None:
        while not self.halt.wait(0.5):
            try:
                self.forward()
            except Exception as e:  # noqa: BLE001 - read by the phase
                self.error = f"{type(e).__name__}: {e}"

    def stop(self) -> None:
        self.halt.set()
        self.join(timeout=10)


def fleet_trigger(tmp: Path, job_id: int, captures: dict):
    """The watcher's trigger: an iteration-window capture through the
    host's advertised rpc coordinates (dynolog_tpu_torch.cluster.rpc, the
    `gputrace` verb's body), stamped with the watcher's trace context;
    returns the manifest's path once it is on disk."""
    from dynolog_tpu_torch.cluster.rpc import FramedRpcClient

    def trigger(host: str, rpc: tuple, trace_ctx: str) -> str:
        base = tmp / f"fleet_{host}.json"
        t0 = time.time()
        with FramedRpcClient(rpc[0], int(rpc[1]), timeout_s=10) as client:
            resp = client.call({
                "fn": "setKinetOnDemandRequest",
                "config": (f"ACTIVITIES_LOG_FILE={base}\n"
                           f"ACTIVITIES_ITERATIONS={ITERATIONS}"),
                "job_id": job_id, "pids": [0], "process_limit": 3,
                "trace_ctx": trace_ctx})
        if not (resp and resp.get("processesMatched")):
            raise AssertionError(f"{host} at {rpc}: {resp}")
        while time.time() < t0 + FLEET_CAPTURE_S:
            hits = [p for p in tmp.glob(f"fleet_{host}_*.json")
                    if p.stem.rsplit("_", 1)[-1].isdigit()]
            if hits:
                manifest = json.loads(hits[0].read_text())
                if manifest["status"] != "ok":
                    raise AssertionError(f"{host}'s capture: {manifest}")
                captures[host] = {
                    "manifest": manifest,
                    "latency_ms": manifest["ended_ms"] - t0 * 1000}
                return str(hits[0])
            time.sleep(0.05)
        raise AssertionError(f"no manifest from {host} within "
                             f"{FLEET_CAPTURE_S} s")
    return trigger


def phase_fleet(smi: str, latencies: dict) -> dict:
    """Phase 14: the fleet straggler loop. The port's FleetRelay (durable
    acks) takes the records of three dynologd senders h0, h1, h2 (one pod),
    each with a trainer of FLEET_ROWS rows under its shim; h0's and h1's
    step rates set the watcher's spread, and the port's FleetWatcher must
    fire once, on h2 with h0 or h1 as the peer, capture both under one
    trace context and have the port's engine read h2 as regressed in each
    flash kernel. Returns the trainers' launches together."""
    from dynolog_tpu_torch import obs
    from dynolog_tpu_torch.host.perfcli import PerfCliSampler, summarize
    from dynolog_tpu_torch.supervise import (
        FLEET_LIVE, FleetRelay, FleetWatcher, run_diagnosis_engine)

    t_phase = time.time()
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_fleet_"))
    job_id = 5400 + os.getpid() % 1000
    metric = f"job{job_id}.steps_per_sec"
    stop = tmp / "stop"
    relay = FleetRelay(0, snapshot_path=str(tmp / "relay_state.json"),
                       max_metrics_per_host=256)
    daemons, trainers, forwarder = {}, {}, None
    try:
        for host in FLEET_ROWS:
            daemons[host] = Daemon((
                "--kernel_monitor_reporting_interval_s=1",
                "--use_tcp_relay", "--relay_host=127.0.0.1",
                f"--relay_port={relay.port}", "--sink_relay_ack",
                f"--sink_spill_dir={tmp / ('spill_' + host)}",
                f"--fleet_host_id={host}",
                "--fleet_advertise_host=127.0.0.1"))
        for host, rows in FLEET_ROWS.items():
            spec = {"host": host, "rows": rows, "job_id": job_id,
                    "endpoint": daemons[host].endpoint, "stop": str(stop),
                    "result": str(tmp / f"{host}.result.json")}
            trainers[host] = subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"),
                 "--fleet-trainer", json.dumps(spec)], cwd=REPO)

        def detail() -> dict:
            return relay.view.query(detail=True, metrics=[metric],
                                    skew_metric=metric)

        t0 = time.time()
        while time.time() < t0 + FLEET_LIVE_S:
            states = {h: (detail()["hosts_detail"].get(h) or {}).get("state")
                      for h in FLEET_ROWS}
            if all(s == FLEET_LIVE for s in states.values()):
                break
            time.sleep(0.1)
        if not all(s == FLEET_LIVE for s in states.values()):
            raise AssertionError(f"hosts not live within {FLEET_LIVE_S} s:"
                                 f" {states}")
        log(f"  every host live at the relay {time.time() - t0:.1f} s "
            f"after the daemons started (bound {FLEET_LIVE_S} s)")

        forwarder = RateForwarder(relay, daemons, metric)
        forwarder.start()
        # Every host's rate on the relay, the first windows (model build,
        # warm-up) past: three reports of a nonzero rate in a row.
        seen = {h: [] for h in FLEET_ROWS}
        t0 = time.time()
        while time.time() < t0 + FLEET_METRIC_S:
            for h in FLEET_ROWS:
                if trainers[h].poll() is not None:
                    raise AssertionError(f"trainer {h} exited "
                                         f"{trainers[h].returncode}")
            rates = detail()["metrics"]
            for h in FLEET_ROWS:
                value = (rates.get(h) or {}).get(metric)
                if value and (not seen[h] or seen[h][-1] != value):
                    seen[h].append(value)
            if all(len(v) >= 4 for v in seen.values()):
                break
            time.sleep(0.2)
        if forwarder.error or not all(len(v) >= 4 for v in seen.values()):
            raise AssertionError(f"step rates at the relay after "
                                 f"{FLEET_METRIC_S} s: {seen}; forwarder "
                                 f"{forwarder.error}")
        rates = {h: detail()["metrics"][h][metric] for h in FLEET_ROWS}
        # The spread that counts as a straggler: a quarter of the healthy
        # hosts' rate, each host's the median of its reports (a 1 s window
        # holds a whole number of steps, so one report moves by a step).
        healthy = statistics.mean(statistics.median(seen[h])
                                  for h in ("h0", "h1"))
        spread = 0.25 * healthy
        log(f"  {smi}: steps_per_sec at the relay {rates} "
            f"({time.time() - t0:.1f} s after the trainers started; "
            f"reports {seen}); spread threshold {spread:.3f}, 0.25 x the "
            f"mean {healthy:.3f} of h0's and h1's median reports")

        captures: dict = {}
        engine_s = []

        def diagnose(target, baseline, trace_ctx):
            t = time.time()
            report = run_diagnosis_engine(target, baseline, trace_ctx,
                                          top=FLEET_DIAGNOSE_TOP)
            engine_s.append(time.time() - t)
            return report

        watcher = FleetWatcher(
            relay.view, metric=metric, spread=spread,
            trigger=fleet_trigger(tmp, job_id, captures), diagnose=diagnose)
        # Tick as the relay would until the breach shows (a tick without a
        # candidate charges no cooldown); the breach time is the start of
        # the tick that saw it.
        t0, report = time.time(), None
        while report is None and time.time() < t0 + FLEET_BREACH_S:
            t_breach = time.time()
            report = watcher.tick()
            if report is None:
                time.sleep(0.2)
        if report is None:
            raise AssertionError(f"the watcher did not fire within "
                                 f"{FLEET_BREACH_S} s: {detail()}")
        breach_to_report_ms = (
            Path(report["report_path"]).stat().st_mtime - t_breach) * 1000
        if watcher.tick() is not None or watcher.fires != 1:
            raise AssertionError(f"the watcher fired {watcher.fires} times "
                                 "inside its cooldown")
        cand = report["candidate"]
        ctx = report["trace_ctx"]
        on_disk = json.loads(Path(report["report_path"]).read_text())
        log(f"  {smi}: watcher fired once ({cand['reason']}): outlier "
            f"{cand['outlier']} at {cand['outlier_value']:.3f}, peer "
            f"{cand['peer']} at {cand['peer_value']:.3f}, spread "
            f"{cand['spread']:.3f}; breach to report on disk "
            f"{breach_to_report_ms:.0f} ms; engine "
            f"{sum(engine_s):.2f} s; trace_ctx {ctx}")
        for host, cap in captures.items():
            log(f"  {smi}: capture of {host}: latency RPC->manifest "
                f"{cap['latency_ms']:.0f} ms, trace_ctx "
                f"{cap['manifest']['trace_ctx']}, timing "
                f"{cap['manifest']['timing']}")
            with open(cap["manifest"]["trace_file"]) as f:
                events = json.load(f)["traceEvents"]
            for name in PRODUCTS:
                calls = sorted(e["dur"] / 1e3 for e in events
                               if e.get("cat") == "kernel" and
                               f"flash_tc::{name}_kernel<128>" in e["name"])
                log(f"    {name} calls (ms, sorted): "
                    f"{[round(c, 4) for c in calls]}")
        failures = []
        if cand["outlier"] != "h2" or cand["peer"] not in ("h0", "h1"):
            failures.append(f"picked {cand['outlier']} against "
                            f"{cand['peer']}, not h2 against h0 or h1")
        # One trace id (the part before "/"); each daemon parents its own
        # span under the watcher's.
        ids = {c["manifest"]["trace_ctx"].split("/")[0]
               for c in captures.values()}
        if (len(captures) != 2 or ids != {ctx.split("/")[0]}
                or on_disk.get("trace_ctx") != ctx):
            failures.append(f"trace contexts: captures {ids}, watcher "
                            f"{ctx}, report {on_disk.get('trace_ctx')}")
        log(f"  verdict {on_disk['verdict']}: {on_disk['headline']}; "
            f"{len(on_disk['findings'])} of {on_disk['finding_count']} "
            f"findings in the report")
        if on_disk["verdict"] != "regressed":
            failures.append(f"h2 diagnosed {on_disk['verdict']}")
        for name in PRODUCTS:
            op = f"flash_tc::{name}_kernel<128>"
            found = [(f["kind"], f["severity_pct"])
                     for f in on_disk["findings"] if f["op"] == op]
            ranks = [(i + 1, f["impact_ms"])
                     for i, f in enumerate(on_disk["findings"])
                     if f["op"] == op]
            log(f"  {op}: (kind, severity %) {found}; (rank, impact ms) "
                f"{ranks}")
            if not {"compute_regression", "fusion_shape_change"} & {
                    kind for kind, _ in found}:
                failures.append(f"no regression finding for {op}")

        for host, cap in captures.items():
            latencies[f"14 {host}"] = cap["latency_ms"] / 1000
        family = obs.HistogramFamily(
            "dynolog_capture_latency_seconds",
            "RPC to manifest latency of the smoke's daemon-triggered "
            "captures", label_key="phase")
        for phase, seconds in latencies.items():
            family.observe(seconds, phase)
        log(f"  {smi}: capture latencies (s) {latencies}; exposition:")
        for line in obs.render_exposition([family]).splitlines():
            if not line.startswith("#") and "_bucket" not in line:
                log(f"    {line}")

        sampler = PerfCliSampler(pid=trainers["h2"].pid)
        if sampler.available():
            got = summarize(sampler.sample(2.0))
            log(f"  perf on h2 (pid {trainers['h2'].pid}), 2 s: "
                f"{got['samples']} samples; top comms "
                f"{list(got['by_comm'].items())[:5]}")
        else:
            log("  perf is not on PATH: the perf CLI sampler was not run "
                "on the card")

        forwarder.stop()
        stop.touch()
        results = {}
        for host, proc in trainers.items():
            if proc.wait(timeout=180) != 0:
                failures.append(f"trainer {host} exited {proc.returncode}")
                continue
            results[host] = json.loads(
                (tmp / f"{host}.result.json").read_text())
        relay.write_snapshot()
        doc = detail()
        for host in FLEET_ROWS:
            h = doc["hosts_detail"][host]
            wal = daemons[host].rpc({"fn": "health"})["durability"]["sinks"]
            wal = next(iter(wal.values()))
            log(f"  {smi}: {host} at the relay: records {h['records']}, "
                f"applied_seq {h['applied_seq']}, durable (acked) seq "
                f"{h.get('durable_seq')}, seq_gaps {h['seq_gaps']}; sender "
                f"WAL last_seq {wal['last_seq']}, acked_seq "
                f"{wal['acked_seq']}")
            if h["seq_gaps"] != 0 or h["records"] != h["applied_seq"]:
                failures.append(f"{host}: seq_gaps {h['seq_gaps']}, records"
                                f" {h['records']}, applied "
                                f"{h['applied_seq']}")
        log(f"  relay ingest {doc['global']['ingest']}; rate records "
            f"forwarded {forwarder.forwarded}")
        for host, r in results.items():
            log(f"  {smi}: trainer {host} (B={FLEET_ROWS[host]}): "
                f"{r['steps']} steps, step {r['step_ms']:.1f} ms (median "
                f"after the first 3), peak memory {r['peak_gib']:.2f} GiB, "
                f"captures {r['traces']}, launches {r['launches']}")
            if not r["finite"]:
                failures.append(f"trainer {host}: non-finite loss")
            for name, count in r["launches"].items():
                if count < N_LAYERS * r["steps"]:
                    failures.append(f"trainer {host}: {name} launched "
                                    f"{count} times in {r['steps']} steps")
        if failures:
            raise AssertionError("\n".join(failures))
        log(f"  phase 14 took {time.time() - t_phase:.1f} s")
        return {name: sum(r["launches"][name] for r in results.values())
                for name in PRODUCTS}
    finally:
        if forwarder is not None:
            forwarder.stop()
        stop.touch()
        for proc in trainers.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for daemon in daemons.values():
            daemon.stop()
        relay.sever()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 15

# `dyno gputrace`'s per-capture knobs, captures of ITERATIONS steps in
# this order on one shim: a knob must not outlast its capture.
KNOB_CAPTURES = {
    "default": [],
    "python_0": ["--python_tracer_level=0"],
    "host_0": ["--host_tracer_level=0"],
    "device_0": ["--device_tracer_level=0"],
    "host_3": ["--host_tracer_level=3"],
    "notrace_json": ["--notrace_json"],
    "python_only": ["--host_tracer_level=0", "--device_tracer_level=0"],
    "no_tracer": ["--python_tracer_level=0", "--host_tracer_level=0",
                  "--device_tracer_level=0"],
}
KNOB_ROUNDS = 3  # captures of each entry: a stop's spread is tens of ms
KNOB_FLAGS = {"--python_tracer_level": "python_tracer_level",
              "--host_tracer_level": "host_tracer_level",
              "--device_tracer_level": "device_tracer_level"}


def dyno_gputrace(port: int, job_id: int, log_file: str, flags: list,
                  window: str = f"--iterations={ITERATIONS}") -> str:
    """Runs the dyno CLI's gputrace against the dynologd at `port` for a
    window of ITERATIONS steps (or `window`); returns its output."""
    out = subprocess.run(
        [str(BIN_DIR / "dyno"), "--hostname=localhost", f"--port={port}",
         "gputrace", f"--job_id={job_id}", window, f"--log_file={log_file}",
         *flags],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or "Matched 1 processes" not in out.stdout:
        raise RuntimeError(f"dyno gputrace {flags}: rc {out.returncode}: "
                           f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    return out.stdout


def knob_check(name: str, levels: dict, trace_json: bool, manifest: dict,
               summary: dict, cats: dict) -> list[str]:
    """What a capture at these levels must hold: Python frames only with
    the Python tracer on (at host level 0 too, as in the JAX capture),
    cpu_ops only with the host tracer, kernels only with the device
    tracer, the three flash kernels at their call counts and the window's
    steps wherever a tracer ran."""
    python, host, device = (levels["python_tracer_level"],
                            levels["host_tracer_level"],
                            levels["device_tracer_level"])
    failures = []
    if manifest["status"] != "ok":
        return [f"{name}: manifest {manifest.get('error')}"]
    if ("python_function" in cats) != (python >= 1):
        failures.append(f"{name}: {cats.get('python_function')} "
                        "python_function events")
    if ("cpu_op" in cats) != (host >= 1):
        failures.append(f"{name}: cpu_op {cats.get('cpu_op')}")
    if ("kernel" in cats) != (device >= 1):
        failures.append(f"{name}: kernel {cats.get('kernel')}")
    want = N_LAYERS * ITERATIONS
    for kernel, row in flash_rows(summary).items():
        if (device >= 1) != (row is not None and row["count"] == want):
            failures.append(f"{name}: {kernel} row {row}")
    if summary.get("steps", {}).get("count") != ITERATIONS:
        failures.append(f"{name}: steps {summary.get('steps')}")
    if manifest["config"].get("TRACE_JSON") != (None if trace_json else "0"):
        failures.append(f"{name}: config {manifest['config']}")
    return failures


def lost_offsets(manifest: dict) -> str:
    """Where a capture's launches without a kernel record fall: their
    count and first and last offsets (ms) from its profiler's start,
    beside its lead step's and window's ms."""
    from dynolog_tpu_torch import trace

    with open(manifest["trace_file"]) as f:
        doc = json.load(f)
    at = [round(t * 1000 - manifest["started_ms"], 1)
          for t in trace.unmatched_launches(
              doc["traceEvents"], doc.get("baseTimeNanoseconds", 0))]
    return (f"{len(at)} launches without a kernel record, "
            f"{min(at, default=None)} to {max(at, default=None)} ms after "
            f"the start; lead {manifest['timing'].get('lead_ms')} ms, "
            f"window {manifest['timing'].get('window_ms')} ms")


def knob_levels(flags: list) -> dict:
    """The tracer levels a capture with these dyno flags runs at."""
    from dynolog_tpu_torch.client.shim import DEFAULT_TRACER_LEVELS

    levels = dict(DEFAULT_TRACER_LEVELS)
    for flag in flags:
        key, _, value = flag.partition("=")
        if key in KNOB_FLAGS:
            levels[KNOB_FLAGS[key]] = int(value)
    return levels


def knob_capture(daemon, client, trainer, job_id: int, log_file: str,
                 flags: list, mid_window=None) -> tuple[dict, int]:
    """One capture of phase 15: `dyno gputrace` with `flags`, then the
    training thread steps, with no synchronize per step, until the
    capture's manifest has landed. `mid_window()`, where given, runs on
    the training thread once in the middle of the window (after the
    step() that ends the window's first step). Returns the manifest and
    the steps taken."""
    prev, n_steps, mid_done = client.last_manifest, 0, None
    dyno_gputrace(daemon.port, job_id, log_file, flags)
    deadline = time.time() + 120
    while client.last_manifest is prev and time.time() < deadline:
        trainer.step()
        client.step()
        n_steps += 1
        w = client._window
        if (mid_window is not None and w is not None and w is not mid_done
                and w.state == "active" and w.end_at is not None
                and client._step_count == w.end_at - 1):
            mid_window()
            mid_done = w
    torch.cuda.synchronize()
    return json.loads(manifest_path(log_file).read_text()), n_steps


def knob_trace(manifest: dict) -> tuple[dict, dict]:
    """A phase 15 capture's trace read as the phase reads it, on the
    training thread: its events by category and its summary
    (trace.summarize, ungrouped); none for a capture that failed."""
    from dynolog_tpu_torch import trace

    cats: dict = {}
    if manifest["status"] != "ok":
        return cats, {"top_ops": []}
    with open(manifest["trace_file"]) as f:
        for e in json.load(f)["traceEvents"]:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return cats, trace.summarize(manifest["trace_file"], group=False)


def phase_knobs(F, daemon, smi: str) -> dict:
    """Phase 15: phase 4's trainer under one shim, captured KNOB_ROUNDS
    times for each entry of KNOB_CAPTURES (in turns) through the dyno
    CLI, so the CLI's config text reaches the shim. Each capture's timing,
    events by category, steps, flash rows and summary file are logged and
    checked (knob_check; no summary file with --notrace_json; an error
    manifest naming the three knobs when no tracer is left), then each
    setting's median and range of stop, export and bytes. Returns the
    kernels' launches."""
    from dynolog_tpu_torch import trace
    from dynolog_tpu_torch.client import TraceClient

    trainer = Trainer(dense_config())
    job_id = 5600 + os.getpid() % 1000
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_knobs_"))
    client = TraceClient(job_id=job_id, endpoint=daemon.endpoint,
                         poll_interval_s=0.2, report_interval_s=1.0)
    if not client.start():
        raise RuntimeError("the knob phase's shim could not register")
    failures, landed = [], []
    timings: dict = {name: [] for name in KNOB_CAPTURES}
    try:
        torch.cuda.synchronize()
        F.reset_launches()
        n_steps, step_ms = 0, []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            trainer.step()
            client.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n_steps += 1
        uncaptured = statistics.median(step_ms[1:])
        for rnd in range(KNOB_ROUNDS):
            for name, flags in KNOB_CAPTURES.items():
                levels = knob_levels(flags)
                trace_json = "--notrace_json" not in flags
                log_file = str(tmp / f"{name}_{rnd}.json")
                manifest, steps = knob_capture(daemon, client, trainer,
                                               job_id, log_file, flags)
                n_steps += steps
                if max(levels.values()) < 1:
                    error = manifest.get("error", "")
                    log(f"  {smi}: {name} {flags}: status "
                        f"{manifest['status']}, error {error!r}")
                    knobs = ("PROFILE_PYTHON_TRACER_LEVEL=0",
                             "PROFILE_HOST_TRACER_LEVEL=0",
                             "PROFILE_DEVICE_TRACER_LEVEL=0")
                    if manifest["status"] != "error" or not all(
                            k in error for k in knobs):
                        failures.append(f"{name}: manifest {manifest}")
                    continue
                timing = {k: manifest["timing"].get(k) for k in (
                    "profiler_start_ms", "lead_ms", "window_ms",
                    "profiler_stop_ms", "export_ms", "write_ms",
                    "trace_bytes", "lost_launches")}
                cats, summary = knob_trace(manifest)
                if manifest["status"] == "ok":
                    landed.append((name, manifest, trace_json))
                    timings[name].append(timing)
                found = knob_check(name, levels, trace_json, manifest,
                                   summary, cats)
                if found and manifest["status"] == "ok":
                    found.append(f"{name}: {lost_offsets(manifest)}")
                failures += found
                steps = summary.get("steps", {})
                flash = {k: (r["count"], r["total_ms"]) if r else None
                         for k, r in flash_rows(summary).items()}
                log(f"  {smi}: {name} {flags} (python, host, device levels "
                    f"{levels['python_tracer_level']}, "
                    f"{levels['host_tracer_level']}, "
                    f"{levels['device_tracer_level']}): timing {timing}; "
                    f"events by category {cats}; steps "
                    f"{steps.get('count')}, p50 {steps.get('p50_ms')} ms "
                    f"against the uncaptured {uncaptured:.1f} ms; flash "
                    f"(calls, ms) {flash}")
        # The summary files, read after every capture: by the time the
        # others have landed, a --notrace_json capture's would have too.
        for name, manifest, trace_json in landed:
            trace_file = manifest["trace_file"]
            path = Path(trace_file[: -len(trace.TRACE_SUFFIX)]
                        + trace.SUMMARY_SUFFIX)
            ok = wait_for(path, manifest["ended_ms"] / 1000 + 120) if (
                trace_json) else path.exists()
            if ok != trace_json:
                failures.append(f"{name}: summary file {path.exists()} "
                                f"with TRACE_JSON {trace_json}")
        log(f"  summary files checked for {len(landed)} captures: present"
            " where TRACE_JSON is on, absent where it is off")
        for name, rows in timings.items():
            if not rows:
                continue
            cols = {k: sorted(r[k] for r in rows) for k in (
                "profiler_stop_ms", "export_ms", "trace_bytes")}
            log(f"  {smi}: {name}, {len(rows)} captures: " + "; ".join(
                f"{k} median {statistics.median(v)} ({v[0]}-{v[-1]})"
                for k, v in cols.items()))
        counts = dict(F.launches)
        for kernel, count in counts.items():
            if count < N_LAYERS * n_steps:
                failures.append(f"{kernel} launched {count} times in "
                                f"{n_steps} steps")
        log(f"  {n_steps} steps, launches {counts}")
        if failures:
            raise AssertionError("\n".join(failures))
        return counts
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
        del trainer
        free_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 16

# Phase 16: phase 4's dense trainer in fresh processes, one at a time,
# under the one dynologd: FIRST_CAPTURE_RUNS alternate the shim's profiler
# warmup off and on (two iteration captures each), then one process that
# never calls client.step(), captured in duration mode.
FIRST_CAPTURE_RUNS = (False, True, False, True)  # warmup_profiler
FIRST_CAPTURE_WARM_STEPS = 3
WARMUP_WAIT_S = 120  # as bench.py waits on warmup_done
STEPLESS_MS = 500
TIMING_KEYS = ("profiler_start_ms", "window_ms", "profiler_stop_ms",
               "export_ms", "write_ms", "trace_bytes")


def first_capture_trainer(spec: dict) -> int:
    """`chip_smoke.py --first-capture SPEC`: one process of phase 16. The
    dense flash trainer takes FIRST_CAPTURE_WARM_STEPS uncaptured steps,
    starts a TraceClient (spec["warmup"]: warmup_profiler) on the
    dynologd at spec["endpoint"] and trains until warmup_done, then is
    captured through the dyno CLI: twice for ITERATIONS steps, or, with
    spec["stepless"], once for STEPLESS_MS while it never calls
    client.step(). Writes the warmup's timing, the steps that overlapped
    it, each capture's timing and what its trace holds, and the launches
    to spec["result"]."""
    from dynolog_tpu_torch import trace
    from dynolog_tpu_torch.client import TraceClient

    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    trainer = Trainer(dense_config())
    me, spans, stepless = threading.get_native_id(), [], spec["stepless"]

    def timed_step(client=None) -> None:
        b = time.time() * 1000
        trainer.step()
        if client is not None:
            client.step()
        torch.cuda.synchronize()
        spans.append((b, time.time() * 1000))

    def facts(m: dict) -> dict:
        out = {"status": m["status"], "error": m.get("error"),
               "mode": m["mode"],
               "timing": {k: m["timing"].get(k) for k in TIMING_KEYS}}
        if m["status"] != "ok":
            return out
        with open(m["trace_file"]) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        out.update(
            flash={name: any(f"flash_tc::{name}_kernel" in k for k in kernels)
                   for name in F.launches},
            cpu_ops=thread_cpu_ops(m["trace_file"], me),
            steps=trace.summarize(m["trace_file"]).get("steps"),
            stop_overlap=overlapping(spans, *stop_span(m["started_ms"],
                                                       m["timing"])),
            finish=finish_steps(spans, m["started_ms"], m["timing"]))
        return out

    F.reset_launches()
    for _ in range(FIRST_CAPTURE_WARM_STEPS):
        timed_step()
    client = TraceClient(job_id=spec["job_id"], endpoint=spec["endpoint"],
                         poll_interval_s=0.2, report_interval_s=1.0,
                         warmup_profiler=spec["warmup"])
    stepper = None if stepless else client
    if not client.start():
        raise RuntimeError("the shim could not register with dynologd")
    captures = []
    try:
        n0, deadline = len(spans), time.time() + WARMUP_WAIT_S
        while not client.warmup_done.is_set():
            if time.time() > deadline:
                raise RuntimeError(f"no warmup_done in {WARMUP_WAIT_S} s")
            timed_step(stepper)
        during = [round(e - b, 1) for b, e in spans[n0:]]
        for i in range(1 if stepless else 2):
            log_file = f"{spec['tmp']}/first_{spec['run']}_{i}.json"
            prev = client.last_manifest
            dyno_gputrace(spec["port"], spec["job_id"], log_file, [],
                          f"--duration_ms={STEPLESS_MS}" if stepless
                          else f"--iterations={ITERATIONS}")
            deadline = time.time() + 120
            while client.last_manifest is prev and time.time() < deadline:
                timed_step(stepper)
            captures.append(facts(json.loads(
                manifest_path(log_file).read_text())))
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
    Path(spec["result"]).write_text(json.dumps({
        "warmup_timing": client.warmup_timing, "during_warmup": during,
        "uncaptured_ms": round(spans[FIRST_CAPTURE_WARM_STEPS - 1][1]
                               - spans[FIRST_CAPTURE_WARM_STEPS - 1][0], 1),
        "captures": captures, "steps": len(spans),
        "launches": dict(F.launches), "last_error": client.last_error}))
    return 0


def phase_first_capture(daemon, smi: str) -> dict:
    """Phase 16: (a) fresh processes of phase 4's trainer, warmup off and
    on in turns (FIRST_CAPTURE_RUNS), each captured twice through `dyno
    gputrace --iterations`: every manifest ok and naming the three flash
    kernels; each capture's profiler start, stop, export and bytes, the
    warmup's own ms and the steps that overlapped it are logged. (b) A
    process that never calls client.step(), captured with `dyno gputrace
    --duration_ms`: an ok manifest whose trace names the three flash
    kernels and holds the training thread's cpu_ops, and a summary with
    no steps. Returns the processes' launches together."""
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_first_"))
    runs = [(w, False) for w in FIRST_CAPTURE_RUNS] + [(True, True)]
    launches: dict = {}
    failures, firsts = [], {False: [], True: []}
    try:
        for run, (warmup, stepless) in enumerate(runs):
            spec = {"run": run, "warmup": warmup, "stepless": stepless,
                    "job_id": 7000 + 10 * (os.getpid() % 100) + run,
                    "endpoint": daemon.endpoint, "port": daemon.port,
                    "tmp": str(tmp),
                    "result": str(tmp / f"run{run}.result.json")}
            proc = subprocess.run(
                [sys.executable, str(REPO / "chip_smoke.py"),
                 "--first-capture", json.dumps(spec)], cwd=REPO, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"run {run}'s trainer exited "
                                   f"{proc.returncode}")
            got = json.loads(Path(spec["result"]).read_text())
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
                if v < N_LAYERS * got["steps"]:
                    failures.append(f"run {run}: {k} launched {v} times in "
                                    f"{got['steps']} steps")
            kind = "stepless" if stepless else "iterations"
            log(f"  {smi}: run {run} ({kind}, warmup_profiler={warmup}): "
                f"warmup {got['warmup_timing']}; steps during it "
                f"{got['during_warmup']} ms against the uncaptured "
                f"{got['uncaptured_ms']} ms; last_error {got['last_error']}")
            if warmup and not got["warmup_timing"]:
                failures.append(f"run {run}: the warmup did not run: "
                                f"{got['last_error']}")
            elif warmup and not (
                    got["warmup_timing"].get("parked") is True
                    and got["warmup_timing"]["park_ms"] < 10_000):
                # Held at the app's next Python event (C19), not after a
                # wait of WARMUP_PARK_WAIT_S for a step() that never comes.
                failures.append(f"run {run}: the warmup was not parked "
                                f"at once: {got['warmup_timing']}")
            for i, cap in enumerate(got["captures"]):
                log(f"  run {run} capture {i + 1}: {cap['status']} "
                    f"({cap['mode']}); timing {cap['timing']}; flash "
                    f"{cap.get('flash')}; {cap.get('cpu_ops')} training-"
                    f"thread cpu_ops; steps {cap.get('steps')}; steps "
                    f"overlapping the stop {cap.get('stop_overlap')} ms"
                    + (f"; {cap.get('finish')}" if stepless else ""))
                if cap["status"] != "ok" or not all(cap["flash"].values()):
                    failures.append(f"run {run} capture {i + 1}: {cap}")
                    continue
                if not stepless:
                    firsts[warmup].append(
                        (cap["timing"]["profiler_start_ms"], i))
                elif cap["mode"] != "duration" or not cap["cpu_ops"] or (
                        cap["steps"] is not None):
                    failures.append(f"stepless capture: {cap}")
        for warmup, starts in firsts.items():
            log(f"  {smi}: warmup_profiler={warmup}: profiler_start_ms of "
                f"the first captures {[ms for ms, i in starts if i == 0]}, "
                f"of the second {[ms for ms, i in starts if i == 1]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("\n".join(failures))
    return launches


# ------------------------------------------------------------ phase 17 (a)

# Phase 17 (a): phase 4's dense trainer in a process of its own under one
# TraceClient, captured MIXED_CAPTURES times in each kind, in turns: a
# duration window of MIXED_DURATION_MS on the poll thread's side (as
# `dyno gputrace --duration_ms` and the ring take it) and a window of
# ITERATIONS steps. Every finish runs in-process (shim.finish_spawn
# armed): before the repair of ROADMAP C17, a process that mixed the two
# kinds lost every kernel record for good within its first 60 captures
# that way. The summary children are off (TRACE_JSON=0): they run after
# the manifest and play no part in a capture.
MIXED_CAPTURES = 60
MIXED_DURATION_MS = 200
MIXED_BLANK_STOP = 12  # captures in a row with no kernel record end it


def capture_facts(manifest: dict) -> dict:
    """What a capture holds, from its manifest and its trace: the kind,
    status, timing (parked, park, park_ms, profiler_start_ms,
    lost_launches, ...), the three flash kernels' records and all kernel
    records, and `recounted`: the launches without a kernel record made
    before the window's end, by the port's rule
    (trace.unmatched_launches), which a shim from before the manifest
    counted them does not give."""
    from dynolog_tpu_torch import trace

    t = manifest["timing"]
    got = {"kind": manifest["mode"], "status": manifest["status"],
           "error": manifest.get("error"),
           "started_ms": manifest["started_ms"],
           "timing": {k: t.get(k) for k in (
               "parked", "park", "park_ms", "unparked", "waiting",
               "lost_launches", *TIMING_KEYS)}}
    if manifest["status"] != "ok":
        return got
    with open(manifest["trace_file"]) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    got.update(kernels=len(kernels), flash={
        name: sum(f"flash_tc::{name}_kernel" in k for k in kernels)
        for name in PRODUCTS})
    got["recounted"] = len(trace.unmatched_launches(
        events, doc["baseTimeNanoseconds"],
        (manifest["started_ms"] + t["window_ms"]) * 10**6))
    return got


def recount_mismatches(captures: list) -> list:
    """(index, the finish's lost_launches, the recount) of the captures
    whose two counts differ."""
    return [(i, c["timing"]["lost_launches"], c["recounted"])
            for i, c in enumerate(captures)
            if "recounted" in c and c["timing"]["lost_launches"] is not None
            and c["timing"]["lost_launches"] != c["recounted"]]


def lost_of(c: dict) -> int | None:
    """A capture's lost launches: its timing's count, else the recount
    (None for a warmup or ring sample of a shim that did not count)."""
    lost = c["timing"].get("lost_launches")
    return c.get("recounted") if lost is None else lost


def lossy(c: dict, evals: bool = False) -> bool:
    """A capture that failed, lost kernel records, or (an iteration
    window) holds a flash kernel at other than N_LAYERS * ITERATIONS
    records; where `evals` (phase 17 (b)'s long steps, each POLL_EVAL_STEPS
    train steps) the three at one count, that or more, a multiple of
    N_LAYERS."""
    if c["status"] != "ok" or lost_of(c):
        return True
    if c["kind"] != "iterations":
        return False
    counts = set(c["flash"].values())
    if not evals:
        return counts != {N_LAYERS * ITERATIONS}
    return not (len(counts) == 1 and min(counts) >= N_LAYERS * ITERATIONS
                and min(counts) % N_LAYERS == 0)


def mixed_trainer(spec: dict) -> int:
    """`chip_smoke.py --mixed SPEC`: phase 17 (a)'s process. The dense flash
    trainer under a TraceClient whose poll thread's role a side thread
    plays (_run_trace, one capture at a time, each finished in-process
    before it returns) while this thread trains and calls client.step();
    duration and iteration windows in turns. Writes each capture's
    capture_facts, and the launches, to spec["result"]."""
    from dynolog_tpu_torch import failpoints
    from dynolog_tpu_torch.client import TraceClient
    from dynolog_tpu_torch.client.shim import TraceConfig

    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    trainer = Trainer(dense_config())
    failpoints.arm("shim.finish_spawn", "error")
    client = TraceClient(job_id=spec["job_id"], endpoint="unused",
                         report_interval_s=0)
    F.reset_launches()
    steps, captures, blank = 0, [], 0
    for _ in range(FIRST_CAPTURE_WARM_STEPS):
        trainer.step()
        client.step()
        steps += 1
    for i in range(2 * MIXED_CAPTURES):
        kind = "iterations" if i % 2 else "duration"
        log_file = f"{spec['tmp']}/mixed_{i}.json"
        cfg = TraceConfig.parse(
            f"ACTIVITIES_LOG_FILE={log_file}\nTRACE_JSON=0\n"
            + (f"ACTIVITIES_ITERATIONS={ITERATIONS}" if kind == "iterations"
               else f"ACTIVITIES_DURATION_MSECS={MIXED_DURATION_MS}"))
        poll = threading.Thread(target=client._run_trace, args=(cfg,))
        poll.start()
        while poll.is_alive():
            trainer.step()
            client.step()
            steps += 1
        poll.join()
        m = json.loads(manifest_path(log_file).read_text())
        got = capture_facts(m)
        if m["status"] == "ok":
            os.unlink(m["trace_file"])
        captures.append(got)
        blank = blank + 1 if not got.get("kernels") else 0
        if blank == MIXED_BLANK_STOP:
            break
    client.stop()
    Path(spec["result"]).write_text(json.dumps({
        "captures": captures, "steps": steps,
        "launches": dict(F.launches), "last_error": client.last_error}))
    return 0


def phase_mixed(smi: str) -> dict:
    """Phase 17 (a): MIXED_CAPTURES duration and as many iteration windows
    in turns in one process (mixed_trainer): every manifest ok with no
    lost launch (capture_facts, lossy), and every iteration window with
    each flash kernel at N_LAYERS * ITERATIONS records. Logs each kind's
    lossy captures, its profiler start and stop, and the first capture
    that held no kernel record. Returns the process's launches."""
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_mixed_"))
    spec = {"job_id": 7700 + os.getpid() % 100, "tmp": str(tmp),
            "result": str(tmp / "result.json")}
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "--mixed",
             json.dumps(spec)], cwd=REPO, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the mixed trainer exited {proc.returncode}")
        got = json.loads(Path(spec["result"]).read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failures = []
    for k, v in got["launches"].items():
        if v < N_LAYERS * got["steps"]:
            failures.append(f"{k} launched {v} times in {got['steps']} steps")
    caps = got["captures"]
    if len(caps) < 2 * MIXED_CAPTURES:
        failures.append(f"{len(caps)} of {2 * MIXED_CAPTURES} captures: "
                        f"the last {MIXED_BLANK_STOP} held no kernel record")
    for kind in ("duration", "iterations"):
        mine = [(i, c) for i, c in enumerate(caps) if c["kind"] == kind]
        bad = [(i, c) for i, c in mine if lossy(c)]
        blank = [i for i, c in mine if not c.get("kernels")]
        log(f"  {smi}: {len(mine)} {kind} windows, {len(bad)} lossy "
            f"{[(i, lost_of(c), c.get('flash')) for i, c in bad[:8]]}; "
            f"first with no kernel record: {blank[0] if blank else None}; "
            f"profiler_start_ms median "
            f"{statistics.median(c['timing']['profiler_start_ms'] or 0 for _, c in mine)}"
            f", max {max(c['timing']['profiler_start_ms'] or 0 for _, c in mine)}"
            f"; profiler_stop_ms median "
            f"{statistics.median(c['timing']['profiler_stop_ms'] or 0 for _, c in mine)}")
        failures += [f"{kind} capture {i}: {c}" for i, c in bad[:8]]
    log(f"  phase 17 (a) took {time.time() - t0:.1f} s, {got['steps']} steps; "
        f"last_error {got['last_error']}")
    if failures:
        raise AssertionError("\n".join(failures))
    return got["launches"]


# ------------------------------------------------------------ phase 17 (b)

# Phase 17 (b), the real client: phase 4's dense trainer in a process of
# its own under a TraceClient built as an application builds one
# (client.start(): the poll loop, its profiler warmup, the capture ring),
# which trains at once, without waiting on warmup_done. Duration windows
# of POLL_WINDOW_MS and ITERATIONS-step windows arrive in turns through
# dynologd (`dyno gputrace`), each finished in the shim's nice-19 child,
# and every POLL_EVAL_EVERY steps one step() spans POLL_EVAL_STEPS train
# steps (an eval or a checkpoint's place), long enough for a duration
# start's park wait of two recent steps to run out. In a `stepless`
# process the app never calls client.step(): duration windows only, no
# ring. `scripts/torch_profile_threads.py --shim-starts poll|stepless`
# runs the same process for longer.
POLL_CAPTURES = 30  # of each kind
POLL_WINDOW_MS = 200
POLL_RING_EVERY = 60  # steps
POLL_EVAL_EVERY = 50
POLL_EVAL_STEPS = 5


def poll_trainer(spec: dict) -> int:
    """`chip_smoke.py --poll SPEC`: phase 17 (b)'s process. Trains until
    the file spec["stop"] exists, under a TraceClient on the dynologd at
    spec["endpoint"] with the warmup and (unless spec["stepless"]) the
    ring on, beside IDLE_THREADS where spec["idle"]. Writes the warmup's
    timing, the host times (ms) of the steps that ended before
    warmup_done and the median of the 200 after them, each ring sample's
    timing, the steps and train steps, the launches and last_error to
    spec["result"]."""
    from dynolog_tpu_torch.client import RingConfig, TraceClient

    F = importlib.import_module("dynolog_tpu_torch.ops.flash_attention")
    trainer = Trainer(dense_config())
    if spec.get("idle"):
        start_idle_threads()
    stepless = spec["stepless"]
    ring = None if stepless else RingConfig(
        every_n_steps=POLL_RING_EVERY, window_ms=POLL_WINDOW_MS, keep=2,
        dir=spec["ring_dir"], model="poll", min_interval_s=0.0)
    client = TraceClient(job_id=spec["job_id"], endpoint=spec["endpoint"],
                         poll_interval_s=0.2, report_interval_s=1.0,
                         warmup_profiler=True, ring=ring)
    F.reset_launches()
    if not client.start():
        raise RuntimeError("the shim could not register with dynologd")
    stop, steps, spans, samples = Path(spec["stop"]), 0, [], []
    try:
        while not stop.exists():
            b = time.time() * 1000
            for _ in range(POLL_EVAL_STEPS
                           if steps % POLL_EVAL_EVERY == POLL_EVAL_EVERY - 1
                           else 1):
                trainer.step()
            if not stepless:
                client.step()
            steps += 1
            spans.append((b, time.time() * 1000,
                          client.warmup_done.is_set()))
            if client.ring and client.ring.captures > len(samples):
                samples.append({**client.ring.last_timing,
                                "seen_ms": int(time.time() * 1000)})
    finally:
        client.stop()
        for proc in client.summary_procs:
            proc.wait(timeout=120)
    torch.cuda.synchronize()
    during = [round(e - b, 1) for b, e, done in spans if not done]
    after = sorted(e - b for b, e, done in spans[len(during):][:200])
    Path(spec["result"]).write_text(json.dumps({
        "warmup_timing": client.warmup_timing, "during_warmup": during,
        "median_step_ms": round(after[len(after) // 2], 1) if after else None,
        "ring": samples, "steps": steps,
        "spans": [[round(b, 1), round(e, 1)] for b, e, _ in spans],
        "train_steps": steps + (POLL_EVAL_STEPS - 1) * (
            steps // POLL_EVAL_EVERY),
        "launches": dict(F.launches), "last_error": client.last_error}))
    return 0


def run_poll(daemon, n: int, stepless: bool, progress=None,
             stderr_path: str | None = None, idle: bool = False) -> dict:
    """Starts poll_trainer in a process of its own (with IDLE_THREADS
    where `idle`) and captures it through the dyno CLI n times in each
    kind (duration and iteration windows in turns; n duration windows
    where `stepless`), each capture's manifest awaited and its trace read
    (capture_facts) and deleted before the next; stops after
    MIXED_BLANK_STOP captures in a row with no kernel record.
    `progress(i, captures)` is called after each. Returns the process's
    result with "captures"."""
    tmp = Path(tempfile.mkdtemp(prefix="dynotpu_poll_"))
    job_id = 7800 + os.getpid() % 100 + (50 if stepless else 0)
    spec = {"job_id": job_id, "endpoint": daemon.endpoint,
            "stepless": stepless, "idle": idle, "ring_dir": str(tmp / "ring"),
            "stop": str(tmp / "stop"), "result": str(tmp / "result.json")}
    err = open(stderr_path, "w") if stderr_path else None
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--poll",
         json.dumps(spec)], cwd=REPO, stderr=err)
    captures, blank = [], 0
    try:
        for i in range(n if stepless else 2 * n):
            kind = "iterations" if i % 2 and not stepless else "duration"
            log_file = str(tmp / f"poll_{i}.json")
            window = (f"--iterations={ITERATIONS}" if kind == "iterations"
                      else f"--duration_ms={POLL_WINDOW_MS}")
            deadline = time.time() + 300
            while True:  # the client registers once its trainer is built
                try:
                    dyno_gputrace(daemon.port, job_id, log_file, [], window)
                    break
                except RuntimeError:
                    if i or time.time() > deadline or proc.poll() is not None:
                        raise
                    time.sleep(1.0)
            path = Path(f"{log_file[:-5]}_{proc.pid}.json")
            if not wait_for(path, time.time() + 120):
                raise RuntimeError(f"capture {i}: no manifest in 120 s")
            m = json.loads(path.read_text())
            captures.append(capture_facts(m))
            for f in (m.get("trace_file"), str(path)):
                if f:
                    Path(f).unlink(missing_ok=True)
            if progress:
                progress(i, captures)
            blank = blank + 1 if not captures[-1].get("kernels") else 0
            if blank == MIXED_BLANK_STOP:
                break
    except BaseException:
        if proc.poll() is None:
            # The stacks of every thread go to the process's stderr.
            proc.send_signal(signal.SIGUSR1)
            time.sleep(2.0)
            proc.kill()
        raise
    finally:
        Path(spec["stop"]).touch()
        try:
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
            if err:
                err.close()
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"the poll trainer exited {proc.returncode}")
        got = json.loads(Path(spec["result"]).read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {**got, "captures": captures}


def start_steps(got: dict) -> list:
    """Per on-demand duration capture of a run_poll result, the longest
    step (host ms; eval steps left out) that overlaps its start, from
    the park's arm to the start's return (started_ms less the lead,
    profiler_start_ms and park_ms); None where no step overlaps it."""
    from dynolog_tpu_torch.client.shim import DURATION_LEAD_S

    spans = [sp for k, sp in enumerate(got.get("spans", []))
             if k % POLL_EVAL_EVERY != POLL_EVAL_EVERY - 1]
    out = []
    for c in got["captures"]:
        t = c["timing"]
        if c["kind"] != "duration" or t.get("profiler_start_ms") is None:
            continue
        returned = c["started_ms"] - DURATION_LEAD_S * 1000
        armed = returned - t["profiler_start_ms"] - (t.get("park_ms") or 0)
        out.append(max(overlapping(spans, armed, returned), default=None))
    return out


def poll_report(got: dict) -> tuple[list, list]:
    """Log lines of a run_poll result, per kind of capture (warmup, ring,
    duration, iterations): its captures, lossy ones (index among the
    samples or the on-demand captures, lost launches, flash records),
    parked share, the parks that held them (step or event) and their
    park_ms median and max, profiler_start_ms median and max, and the
    first capture with no kernel record; the on-demand captures whose
    finish's lost_launches differs from the recount; and the failures of
    phase 17 (b)'s rules."""
    rows = [{"kind": "warmup", "status": "ok", "timing": got["warmup_timing"]}
            ] if got["warmup_timing"] else []
    rows += [{"kind": "ring", "status": "ok", "timing": t}
             for t in got["ring"]]
    lines, failures = [], []
    for kind in ("warmup", "ring", "duration", "iterations"):
        mine = [(i, c) for i, c in enumerate(got["captures"] if kind in (
            "duration", "iterations") else rows) if c["kind"] == kind]
        if not mine:
            continue
        bad = [(i, lost_of(c), c.get("flash")) for i, c in mine
               if lossy(c, evals=True)]
        starts = [c["timing"].get("profiler_start_ms") or 0 for _, c in mine]
        parks = [c["timing"].get("park_ms") or 0 for _, c in mine]
        blank = [i for i, c in mine if c.get("kernels") == 0]
        lines.append(
            f"{len(mine)} {kind}: {len(bad)} lossy {bad[:8]}; parked "
            f"{sum(c['timing'].get('parked') is True for _, c in mine)}"
            f"/{len(mine)}, by park "
            f"{dict(Counter(c['timing'].get('park') for _, c in mine))}, "
            f"park_ms median {statistics.median(parks)}, max {max(parks)}; "
            f"profiler_start_ms median "
            f"{statistics.median(starts)}, max {max(starts)}; first with no "
            f"kernel record: {blank[0] if blank else None}")
        failures += [f"{kind} capture {b}" for b in bad[:8]]
    mismatches = recount_mismatches(got["captures"])
    lines.append(f"lost_launches against the recount: "
                 f"{len(mismatches)} differ {mismatches[:8]}")
    over = [ms for ms in start_steps(got) if ms is not None]
    if over:
        lines.append(f"the longest step over each duration start: median "
                     f"{statistics.median(over)}, max {max(over)} ms, over "
                     f"{len(over)} starts (median step "
                     f"{got['median_step_ms']} ms)")
    failures += [f"capture {i}: lost_launches {lost}, recount {n}"
                 for i, lost, n in mismatches[:8]]
    return lines, failures


def phase_poll(daemon, smi: str) -> dict:
    """Phase 17 (b): run_poll at POLL_CAPTURES of each kind. Every
    capture ok with lost_launches 0 in its manifest, every iteration
    window with each flash kernel at N_LAYERS * ITERATIONS records, the
    ring's samples and the warmup with no lost launch, each kernel
    launched in every train step; the warmup's timing (parked) and the
    steps over it are logged. Returns the process's launches."""
    t0 = time.time()
    got = run_poll(daemon, POLL_CAPTURES, stepless=False)
    lines, failures = poll_report(got)
    for line in lines:
        log(f"  {smi}: {line}")
    log(f"  warmup {got['warmup_timing']}; steps before warmup_done "
        f"{got['during_warmup']} ms against a median of "
        f"{got['median_step_ms']} ms")
    caps = got["captures"]
    if len(caps) < 2 * POLL_CAPTURES:
        failures.append(f"{len(caps)} of {2 * POLL_CAPTURES} captures: the "
                        f"last {MIXED_BLANK_STOP} held no kernel record")
    failures += [f"capture {i}: lost_launches missing from its manifest"
                 for i, c in enumerate(caps)
                 if c["status"] == "ok"
                 and c["timing"]["lost_launches"] is None]
    if not got["warmup_timing"] or not got["ring"]:
        failures.append(f"warmup {got['warmup_timing']}, {len(got['ring'])} "
                        f"ring samples: {got['last_error']}")
    for k, v in got["launches"].items():
        if v < N_LAYERS * got["train_steps"]:
            failures.append(f"{k} launched {v} times in "
                            f"{got['train_steps']} train steps")
    log(f"  phase 17 (b) took {time.time() - t0:.1f} s, {got['steps']} "
        f"steps; last_error {got['last_error']}")
    if failures:
        raise AssertionError("\n".join(failures))
    return got["launches"]


# ------------------------------------------------------------ phase 17 (c)

# Phase 17 (c): phase 17 (b)'s process never calling client.step() (run_poll
# with stepless: the warmup on, no ring), beside IDLE_THREADS, captured
# STEPLESS_CAPTURES times in duration windows through dynologd. With its
# starts unparked, such a process lost its training thread's kernel
# records from its 54th capture on (ROADMAP C19); the shim now holds its
# threads at their next Python event for every start, the warmup's too,
# and counts a thread idle in a known blocking call as parked at once
# (C19's remainder: before, each such thread held every start 2 s and
# left it unparked).
STEPLESS_CAPTURES = 100
# The idle threads of a stepless app (a server, a notebook) beside its
# training thread, by name: each waits for good in a blocking call.
IDLE_THREADS = ("idle_sleep", "idle_join", "idle_accept", "idle_asyncio")
PARK_MS_LIMIT = 1000  # a start's park_ms in phase 17 (c)


def start_idle_threads() -> None:
    """IDLE_THREADS, daemon threads: one in time.sleep(3600), one in
    Thread.join() of a thread that never ends (it waits on an Event no
    one sets), one in accept() on a listening socket no one connects to,
    and one running an asyncio loop with nothing scheduled."""
    import asyncio

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    never = threading.Thread(target=threading.Event().wait,
                             name="idle_never", daemon=True)
    never.start()
    loop = asyncio.new_event_loop()
    for name, target in (("idle_sleep", lambda: time.sleep(3600)),
                         ("idle_join", never.join),
                         ("idle_accept", listener.accept),
                         ("idle_asyncio", loop.run_forever)):
        threading.Thread(target=target, name=name, daemon=True).start()


def idle_unwaited(got: dict) -> list:
    """The starts of a run_poll result with idle threads (the warmup,
    then each capture by index) whose timing does not name every one of
    IDLE_THREADS as waiting: (start, its waiting names)."""
    starts = [("warmup", got["warmup_timing"] or {})] + [
        (i, c["timing"]) for i, c in enumerate(got["captures"])]
    return [(k, t.get("waiting")) for k, t in starts
            if not set(IDLE_THREADS) <= set(t.get("waiting") or ())]


def phase_stepless(daemon, smi: str) -> dict:
    """Phase 17 (c): run_poll(stepless, idle) at STEPLESS_CAPTURES. Every
    capture ok with lost_launches 0 in its manifest, equal to the
    recount; every start and the warmup parked, in under PARK_MS_LIMIT
    ms; each kernel launched in every train step. Returns the process's
    launches."""
    t0 = time.time()
    got = run_poll(daemon, STEPLESS_CAPTURES, stepless=True, idle=True)
    lines, failures = poll_report(got)
    for line in lines:
        log(f"  {smi}: {line}")
    log(f"  warmup {got['warmup_timing']}; steps before warmup_done "
        f"{got['during_warmup']} ms against a median of "
        f"{got['median_step_ms']} ms")
    unwaited = idle_unwaited(got)
    log(f"  starts without every idle thread waiting: {len(unwaited)} "
        f"{unwaited[:4]}")
    caps = got["captures"]
    if len(caps) < STEPLESS_CAPTURES:
        failures.append(f"{len(caps)} of {STEPLESS_CAPTURES} captures: the "
                        f"last {MIXED_BLANK_STOP} held no kernel record")
    failures += [f"capture {i}: lost_launches missing from its manifest"
                 for i, c in enumerate(caps)
                 if c["status"] == "ok"
                 and c["timing"]["lost_launches"] is None]
    failures += [f"capture {i} not parked: {c['timing']}"
                 for i, c in enumerate(caps)
                 if c["timing"]["parked"] is not True][:8]
    warmup = got["warmup_timing"] or {}
    if warmup.get("parked") is not True:
        failures.append(f"warmup not parked: {got['warmup_timing']}, "
                        f"{got['last_error']}")
    failures += [f"{k} park_ms {t.get('park_ms')}" for k, t in [
        ("warmup", warmup)] + [(f"capture {i}", c["timing"])
                               for i, c in enumerate(caps)]
        if (t.get("park_ms") or 0) >= PARK_MS_LIMIT][:8]
    for k, v in got["launches"].items():
        if v < N_LAYERS * got["train_steps"]:
            failures.append(f"{k} launched {v} times in "
                            f"{got['train_steps']} train steps")
    log(f"  phase 17 (c) took {time.time() - t0:.1f} s, {got['steps']} "
        f"steps; last_error {got['last_error']}")
    if failures:
        raise AssertionError("\n".join(failures))
    return got["launches"]


def main_alone(_build, mode: str) -> int:
    """`chip_smoke.py --ep` (two cards or more): the kernels built and the
    expert-parallel check alone. `chip_smoke.py --mesh` (four cards or
    more): the kernels and the daemon built, phase 12 and the checks (a),
    (b) and (c). `chip_smoke.py --stepless` (one card): the kernels and
    the daemon built, phase 17 (c) alone."""
    need = {"--ep": 2, "--mesh": 4, "--stepless": 1}[mode]
    if torch.cuda.device_count() < need:
        print(f"chip_smoke {mode}: needs {need} cards or more",
              file=sys.stderr)
        return 2
    daemon_build = DaemonBuild()
    try:
        smi = nvidia_smi_line()
        log(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        if mode in ("--mesh", "--stepless"):
            daemon_build.start()
        log(f"CUDA kernels built: {_build.build_all()}")
        if mode == "--ep":
            phase_multicard_ep()
        elif mode == "--stepless":
            daemon_build.join()
            if daemon_build.error:
                raise RuntimeError(f"daemon build failed: "
                                   f"{daemon_build.error}")
            daemon = Daemon()
            try:
                log("phase 17 (c): the real client in an app that never "
                    "steps")
                log(f"  launches {phase_stepless(daemon, smi)}")
            finally:
                daemon.stop()
        else:
            log("phase 12: ring attention")
            ring, distance, flash = phase_ring_attention()
            log("multi-card tensor, sequence and expert parallelism")
            phase_multicard_mesh(ring, distance, flash)
            daemon_build.join()
            if daemon_build.error:
                raise RuntimeError(f"daemon build failed: "
                                   f"{daemon_build.error}")
            log("multi-card pipeline")
            phase_multicard_pipeline()
    except Exception:  # noqa: BLE001 - the check failing fails the run
        traceback.print_exc()
        return 1
    finally:
        if daemon_build.is_alive():
            daemon_build.join()  # leave no compiler running behind us
    print(smi)
    return 0


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
    if sys.argv[1:2] == ["--fleet-trainer"] and len(sys.argv) == 3:
        return fleet_trainer(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--first-capture"] and len(sys.argv) == 3:
        return first_capture_trainer(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--mixed"] and len(sys.argv) == 3:
        return mixed_trainer(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--poll"] and len(sys.argv) == 3:
        # run_poll asks a process that stopped answering for the stacks
        # of its threads.
        faulthandler.register(signal.SIGUSR1, all_threads=True)
        return poll_trainer(json.loads(sys.argv[2]))
    if sys.argv[1:] in (["--ep"], ["--mesh"], ["--stepless"]):
        return main_alone(_build, sys.argv[1])
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--ep | --mesh | --stepless]",
              file=sys.stderr)
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
        from dynolog_tpu_torch.client import TraceClient

        # Full llama-8B widths; depth is the only cut.
        cfg = dense_config()
        trainer = Trainer(cfg)
        job_id = 4300 + os.getpid() % 1000
        tmp = Path(tempfile.mkdtemp(prefix="dynotpu_smoke_"))
        client = TraceClient(job_id=job_id, endpoint=daemon.endpoint,
                             poll_interval_s=0.2, report_interval_s=1.0)
        if not client.start():
            raise RuntimeError("the shim could not register with dynologd")
        try:
            cap = phase_train_and_capture(F, daemon, trainer, client, job_id,
                                          tmp, STEPS)
            counts = cap["counts"]
            log(f"  profiler stop without the capture, after "
                f"{ITERATIONS} steps: torch's stats "
                f"{check_stop_unparsed(trainer, tmp)}")
            log("phase 6: summary of the capture")
            phase_summary(cap, results, cfg.n_layers)
            log("phase 7: diagnosis of a B=2 capture against the baseline")
            base, b2_latency_ms = phase_diagnosis(F, daemon, trainer, client,
                                                  job_id, tmp, cap)
        finally:
            client.stop()
            for proc in client.summary_procs:
                proc.wait(timeout=120)
        log("phase 8: capture ring")
        phase_ring(F, daemon, trainer, tmp, base)
        log("phase 9: exporter to the daemon's file backend")
        snap = phase_exporter(tmp)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 10: MoE trainer under a daemon-triggered capture")
        moe_counts = phase_moe(F, daemon, tmp, results)
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 11: NCCL collective probe to the daemon's file backend")
        phase_collectives(snap)
        log("phase 12: ring attention")
        ring, ring_distance, flash = phase_ring_attention()
        log("phase 13: GPipe trainer under a capture triggered by unitrace")
        pipe = phase_pipeline(daemon)
        log("phase 14: fleet straggler loop")
        free_cache()
        fleet_counts = phase_fleet(smi, {"5": cap["latency_ms"] / 1000,
                                         "7": b2_latency_ms / 1000})
        log("phase 15: capture knobs through dyno gputrace")
        knob_counts = phase_knobs(F, daemon, smi)
        log("phase 16: first capture and a step-less app")
        first_counts = phase_first_capture(daemon, smi)
        log("phase 17 (a): mixed captures")
        mixed_counts = phase_mixed(smi)
        log("phase 17 (b): the real client")
        poll_counts = phase_poll(daemon, smi)
        log("phase 17 (c): the real client in an app that never steps")
        stepless_counts = phase_stepless(daemon, smi)
        log("multi-card expert parallelism")
        ep_counts = phase_multicard_ep()
        log("multi-card tensor, sequence and expert parallelism")
        mesh_counts = phase_multicard_mesh(ring, ring_distance, flash) or {}
        log("multi-card pipeline")
        pipe_counts = phase_multicard_pipeline()
        shutil.rmtree(tmp, ignore_errors=True)
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
            "replaces": REPLACES[name],
            "launches": counts[name] + moe_counts[name],
            "launches_by_path": {
                "dense": counts[name], "moe": moe_counts[name],
                "ring": ring["launches"][name],
                "pp": pipe["launches"][name], "fleet": fleet_counts[name],
                "knobs": knob_counts[name],
                "first_capture": first_counts[name],
                "mixed": mixed_counts[name],
                "mixed_poll": poll_counts[name],
                "stepless_poll": stepless_counts[name],
                "moe_ep": ep_counts and ep_counts[name],
                **{path: mesh_counts[path][name] if mesh_counts else None
                   for path in MESH_CASES},
                "pp_mesh": pipe_counts and pipe_counts[name]},
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
