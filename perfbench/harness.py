"""One run of one cell: set-up, the measured window, the comparison.

The cell's configuration, traffic and metrics are found by name:
``configs/<config>.json`` (the model as it is run; its ``program`` names
``programs/<program>.py``, how the port runs it, and its ``reference``
names ``reference/<reference>.py``, the plain reference it is held to),
``traffic/<mix>.json`` (what the job does and what operators ask of it)
and ``metrics/<metric>.py`` (a reader per metric, ``read(run)``, None where
it finds nothing to read). Nothing here names a cell or a model.

The timed entry is the port's train step (the program's ``train_step``,
with ``make_optimizer``'s fused AdamW) followed by ``TraceClient.step()``,
in a loop that dispatches ahead and, every ``loss_every`` steps, reads the
loss of the step ``loss_lag`` (default 0) before the one just dispatched:
with a lag, that many steps stay queued on the card through the read.
A CUDA event recorded after each step gives the step boundaries on the
device's clock. Captures, where the traffic asks for them, are requested
through the `dyno` CLI on a fixed schedule by a thread of their own (an
open loop), whatever the job is doing."""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

from perfbench import check, inputs, parts, traces
from perfbench.daemon import Daemon, build as build_daemon

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dynolog_tpu")
MANIFEST_WAIT_S = 60  # past the window's close, for a capture to land
LATE_S = 1.0  # a capture request fired later than this after its due time
# Every build and kernel cache of the program, at a fixed path in the
# checkout's build/, so that only a checkout's first run builds.
CACHE_DIRS = (("DYNOLOG_TORCH_BUILD_DIR", "torch_kernels"),
              ("TRITON_CACHE_DIR", "triton"),
              ("TORCH_EXTENSIONS_DIR", "torch_extensions"))


def use_checkout_caches(root: Path) -> None:
    for var, sub in CACHE_DIRS:
        os.environ[var] = str(root / "build" / sub)


def build(root: Path, model: dict, cuda: bool, daemon: bool = True) -> None:
    """Builds what the checkout lacks: dynologd and dyno (with `daemon`,
    on a thread of their own) and, on a card, the kernels that the
    configuration's program names (its ``KERNELS``)."""
    built: dict = {}
    thread = threading.Thread(
        target=lambda: built.update(route=build_daemon(root)), daemon=True)
    if daemon:
        thread.start()
    if cuda:
        from dynolog_tpu_torch.ops import _build
        program = parts.load("programs", model["program"])
        _build.build_all(list(program.KERNELS))
    if daemon:
        thread.join()
        if "route" not in built:
            raise RuntimeError("dynologd did not build")


def load_spec(root: Path, workload: str):
    """(benchmark, cell, model config, traffic) of `workload`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    model = json.loads((root / config["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return bench, cell, model, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of `cell` reports: with `trace`, its
    per-layer metrics, else its end-to-end ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run) -> float | None:
    """The metric's reader (perfbench/metrics/<name>.py) applied to `run`."""
    return parts.load("metrics", name).read(run)


class Job:
    """The program under test: the port's train step, its optimizer and
    its shim, on weights and tokens made from the seed. Set-up drives its
    first ``checked_steps`` steps through the window's own call and keeps
    what the comparison reads of them (``readings``). The traffic's
    ``shim`` (optional) holds TraceClient's keyword arguments, ``ring`` as
    RingConfig's."""

    def __init__(self, model: dict, traffic: dict, seed: int, device: str,
                 endpoint: str | None, job_id: int = 0):
        import torch

        from dynolog_tpu_torch.client import TraceClient
        from dynolog_tpu_torch.client.shim import RingConfig
        from dynolog_tpu_torch.models.train import make_optimizer

        self.torch = torch
        self.traffic = traffic
        self.cuda = torch.device(device).type == "cuda"
        program = parts.load("programs", model["program"])
        self.cfg = program.port_config(model)
        opt = model["optimizer"]
        weights = inputs.make_weights(model, seed, device)
        self.params = program.tree(weights, model)
        self.leaves = program.leaves(self.params)
        self.optimizer = make_optimizer(self.params, lr=opt["lr"])
        group = self.optimizer.param_groups[0]
        stated = (tuple(opt["betas"]), opt["eps"], opt["weight_decay"])
        if (tuple(group["betas"]), group["eps"],
                group["weight_decay"]) != stated:
            raise ValueError(f"the port's AdamW {group} is not the "
                             f"configuration's {opt}")
        self._step = program.train_step(self.cfg)
        self.batches = inputs.Batches(model, traffic, seed, device)
        self.tokens_per_step = traffic["batch"] * traffic["seq_len"]
        self.client = None
        if endpoint is not None:
            shim = dict(traffic.get("shim") or {})
            if "ring" in shim:
                shim["ring"] = RingConfig(**shim["ring"])
            self.client = TraceClient(job_id=job_id, endpoint=endpoint,
                                      **{"warmup_profiler": True, **shim})
            if not self.client.start():
                raise RuntimeError("the shim could not register with "
                                   "dynologd")
        self.readings = self._checked_steps(weights, opt["betas"][0])
        del weights
        gc.collect()
        for _ in range(traffic["warm_steps"]):
            float(self.step())
        if self.client is not None and not self.client.warmup_done.wait(120):
            raise RuntimeError("the shim's profiler warmup did not end")
        self.sync()

    def step(self):
        """The timed entry: one train step, then the shim's step()."""
        loss = self._step(self.params, self.optimizer, self.batches.next())
        if self.client is not None:
            self.client.step()
        return loss

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _checked_steps(self, weights: dict, beta1: float) -> dict:
        """Runs the first steps; each loss, each leaf's first gradient's
        norm (its optimizer's first moment after one step, over 1 - beta1)
        and each leaf's change after the last of them."""
        torch = self.torch
        losses, grad_norms = [], {}
        for n in range(self.traffic["checked_steps"]):
            losses.append(float(self.step()))
            if n == 0:  # a leaf the optimizer never stepped reads 0
                state = self.optimizer.state
                grad_norms = {
                    k: float(state[p]["exp_avg"].float().norm()) / (1 - beta1)
                    if "exp_avg" in state.get(p, {}) else 0.0
                    for k, p in self.leaves.items()}
        with torch.no_grad():
            change = {k: float((p.float() - weights[k].float()).norm())
                      for k, p in self.leaves.items()}
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change}

    def free(self) -> None:
        self.params = self.leaves = self.optimizer = self._step = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


class Captures(threading.Thread):
    """Requests a `dyno gputrace` capture with the traffic's `dyno_args`
    at each due time, `first_after_s` after `t0` and every `every_s` after
    that, whatever the job is doing (an open loop). None is due later than
    `last_due_before_end_s` before `t_end`, so that every capture's stop
    and export fall inside the window."""

    def __init__(self, daemon: Daemon, job_id: int, tmp: Path, spec: dict,
                 t0: float, t_end: float):
        super().__init__(name="perfbench_captures", daemon=True)
        self.daemon, self.job_id, self.tmp = daemon, job_id, tmp
        self.spec, self.t0, self.t_end = spec, t0, t_end
        self.fired: list[dict] = []
        self.halt = threading.Event()

    def run(self) -> None:
        k = 0
        while True:
            due = self.t0 + self.spec["first_after_s"] + k * self.spec[
                "every_s"]
            last = self.t_end - self.spec.get("last_due_before_end_s", 0.0)
            if due > last or self.halt.wait(max(0.0, due - time.time())):
                return
            log_file = str(self.tmp / f"cap{k}.json")
            fired = time.time()
            rc, out = self.daemon.gputrace(self.job_id, log_file,
                                           self.spec["dyno_args"])
            self.fired.append({"due": due, "fired": fired, "rc": rc,
                               "out": out[-500:], "log_file": log_file})
            k += 1


def warm_captures(job: Job, daemon: Daemon, tmp: Path, spec: dict,
                  n: int) -> None:
    """Set-up of the capture path: `n` captures as the window asks them,
    one at a time, the job training until each has landed and its summary
    child has ended (a process's first capture stops slower than later
    ones)."""
    for k in range(n):
        log_file = str(tmp / f"warm{k}.json")
        rc, out = daemon.gputrace(job.client.job_id, log_file,
                                  spec["dyno_args"])
        if rc != 0:
            raise RuntimeError(f"dyno gputrace: rc {rc}: {out[-2000:]}")
        deadline = time.time() + MANIFEST_WAIT_S
        while (not _manifest(log_file, os.getpid()).exists()
               and time.time() < deadline):
            job.step()
        job.sync()
        for proc in job.client.summary_procs:
            proc.wait(timeout=120)


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _manifest(log_file: str, pid: int) -> Path:
    return Path(f"{log_file[:-5]}_{pid}.json")


def _capture_facts(fired: dict, marks_ns: list, pid: int, trace: bool,
                   on_card: bool) -> dict:
    """A fired capture's check and, with `trace`, what its trace says."""
    path = _manifest(fired["log_file"], pid)
    manifest = json.loads(path.read_text()) if path.exists() else None
    events, base_ns = None, 0
    if manifest and manifest.get("status") == "ok" and manifest.get(
            "trace_file") and os.path.exists(manifest["trace_file"]):
        events, base_ns = traces.load(manifest["trace_file"])
    problems = check.capture_problems(manifest, events, base_ns, marks_ns,
                                      on_card)
    if manifest is None:  # what dyno said of the request
        problems.append(f"dyno rc {fired['rc']}: {fired['out']}")
    facts = {"fired": fired, "manifest": manifest, "problems": problems}
    if trace and events is not None and not facts["problems"]:
        facts["trace"] = trace_facts(events)
    return facts


def trace_facts(events: list) -> dict:
    """What the metric readers take from one device trace."""
    records = traces.device_records(events)
    busy, gaps = traces.union_busy_us(records)
    span = (max(float(e["ts"]) + float(e.get("dur", 0)) for e in records)
            - min(float(e["ts"]) for e in records)) if records else 0.0
    return {
        "busy_s": busy / 1e6, "span_s": span / 1e6,
        "flash_fwd": traces.op_instances(events, traces.FLASH_FWD_OP,
                                         ("flash_fwd_kernel",)),
        "flash_bwd": traces.op_instances(events, traces.FLASH_BWD_OP,
                                         ("flash_dq_kernel",
                                          "flash_dkv_kernel")),
        "adamw": traces.op_instances(events, traces.ADAMW_OP),
        "top_ops": traces.top_device_ops(records, 40),
        "gaps": traces.named_gaps(events, gaps, 10),
    }


def _own_profile(job: Job, n_steps: int, tmp: Path) -> dict:
    """The harness's own torch.profiler over `n_steps` steps (no capture
    runs then): the trace's facts."""
    from torch.profiler import ProfilerActivity, profile

    job.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            job.step()
        job.sync()
    out = str(tmp / "own_profile.json")
    prof.export_chrome_trace(out)
    facts = trace_facts(traces.load(out)[0])
    os.unlink(out)
    return facts


def _breakdown(facts: list) -> dict:
    ops: dict = {}
    gaps = []
    for f in facts:
        for name, sec in f["top_ops"]:
            ops[name] = ops.get(name, 0.0) + sec
        gaps.extend(f["gaps"])
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}


def measure(job: Job, daemon: Daemon, tmp: Path, traffic: dict,
            seconds: float, trace: bool) -> Run:
    """The measured window: the job's steps for `seconds`, under captures
    at the traffic's rate where it asks for them; then, untimed, the steps
    that let every capture asked for land (a minute at most) and, with
    `trace` where the traffic asks for it, the harness's own profile. The
    peak memory, the step times and each capture's check (and, with
    `trace`, its trace's facts) are read before it returns."""
    torch, cuda, pid = job.torch, job.cuda, os.getpid()
    events, marks, losses = [], [], []
    t0 = time.time()
    t_end = t0 + seconds
    captures = None
    if traffic.get("captures"):
        captures = Captures(daemon, job.client.job_id, tmp,
                            traffic["captures"], t0, t_end)
        captures.start()
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    n = 0
    while time.time() < t_end:
        loss = job._step(job.params, job.optimizer, job.batches.next())
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        marks.append(time.time_ns())
        job.client.step()
        losses.append(loss)
        n += 1
        if n % traffic["loss_every"] == 0:
            float(losses[-1 - traffic.get("loss_lag", 0)])
    job.sync()
    window_s = time.time() - t0

    # Captures still open at the close: the job trains on (untimed) until
    # each has landed or a minute has passed.
    fired = []
    if captures is not None:
        captures.halt.set()
        captures.join(timeout=120)
        fired = captures.fired
        deadline = time.time() + MANIFEST_WAIT_S
        while time.time() < deadline and not all(
                _manifest(f["log_file"], pid).exists() for f in fired):
            job._step(job.params, job.optimizer, job.batches.next())
            marks.append(time.time_ns())
            job.client.step()
        job.sync()
    profile = None
    if trace and traffic.get("profile_steps"):
        profile = _own_profile(job, traffic["profile_steps"], tmp)
    return Run(
        t0=t0, window_s=window_s, steps=n,
        tokens=n * job.tokens_per_step,
        step_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
        peak=torch.cuda.max_memory_allocated() if cuda else 0,
        finite=bool(torch.isfinite(torch.stack(losses)).all()),
        fired=fired, marks=marks, profile=profile,
        captures=[_capture_facts(f, marks, pid, trace, cuda)
                  for f in fired])


def start(root: Path, model: dict, traffic: dict, seed: int, device: str,
          tmp: Path) -> tuple[Daemon, Job]:
    """A started dynologd and the job registered with it, set up as the
    window finds them, its capture path warmed where the traffic asks for
    captures (`tmp` takes the warm captures' traces). The checkout's
    builds are there (``build``)."""
    daemon = Daemon(root)
    job = None
    try:
        job = Job(model, traffic, seed, device, daemon.endpoint,
                  7000 + os.getpid() % 1000)
        if traffic.get("captures"):
            warm_captures(job, daemon, tmp, traffic["captures"],
                          traffic.get("warm_captures", 0))
    except BaseException:
        stop(job, daemon)
        raise
    return daemon, job


def stop(job: Job | None, daemon: Daemon | None) -> None:
    """Stops the job's shim (waiting for its summary children) and
    dynologd; either may be None."""
    if job is not None and job.client is not None:
        job.client.stop()
        for proc in job.client.summary_procs:
            proc.wait(timeout=120)
    if daemon is not None:
        daemon.stop()


def reference_readings(model: dict, traffic: dict, seed: int, device: str,
                       precision: str = "fp32") -> dict:
    """The configuration's plain reference over the first
    ``checked_steps`` steps, on the weights and tokens made again from
    the seed."""
    import torch

    with torch.no_grad():
        weights = inputs.make_weights(model, seed, device)
        leaves = {k: w.float() for k, w in weights.items()}
        del weights
        batches = inputs.Batches(model, traffic, seed, device)
        tokens = [batches.next() for _ in range(traffic["checked_steps"])]
    ref = parts.load("reference", model["reference"]).train_readings(
        model, model["optimizer"], leaves, tokens, precision)
    del leaves, tokens
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ref


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of `workload`: {"result": its result line as a dict (see
    run.py), with each number compared and its limit under "checks";
    "detail": what the comparison found}."""
    bench, _, model, traffic = load_spec(root, workload)
    return run_spec(root, bench, workload, model, traffic, seed, seconds,
                    trace, device, t_start)


def run_spec(root: Path, bench: dict, workload: str, model: dict,
             traffic: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """run_cell on a configuration and traffic given as dicts."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    build(root, model, cuda)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench_"))
    daemon = job = None
    try:
        daemon, job = start(root, model, traffic, seed, device, tmp)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        run = measure(job, daemon, tmp, traffic, seconds, trace)
        run.setup_s = setup_s
        run.leaf_sizes = [(p.numel(), p.element_size())
                          for p in job.leaves.values()]
    finally:
        stop(job, daemon)
        shutil.rmtree(tmp, ignore_errors=True)
    job.free()
    run.model, run.traffic, run.seed = model, traffic, seed

    # The reference, once the program's state is freed.
    ref = reference_readings(model, traffic, seed, device)
    numbers = check.training_numbers(job.readings, ref)

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in model["limits"].items()}
    checks["losses_nonfinite"] = {"value": int(not run.finite), "limit": 0}
    failed_caps = [c for c in run.captures if c["problems"]]
    if run.captures:
        attempted, failed = len(run.captures), len(failed_caps)
        checks["captures_failed"] = {"value": failed, "limit": 0}
    else:
        attempted, failed = run.steps, 0 if run.finite else run.steps
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": run.peak},
    }
    if trace:
        facts = [c["trace"] for c in run.captures if "trace" in c]
        if run.profile is not None:
            facts.append(run.profile)
        result["device"]["busy_s"] = sum(f["busy_s"] for f in facts)
        result["device"]["window_s"] = sum(f["span_s"] for f in facts)
        if facts:
            result["breakdown"] = _breakdown(facts)
    result["checks"] = checks
    detail = {"loss_gap": numbers["loss_gap"], "worst": numbers["worst"],
              "left_out": numbers["left_out"],
              "program_losses": job.readings["losses"],
              "reference_losses": ref["losses"],
              "captures_late": sum(f["fired"] - f["due"] > LATE_S
                                   for f in run.fired),
              "capture_problems": [c["problems"] for c in failed_caps]}
    return {"result": result, "detail": detail}


def forbidden_modules() -> list[str]:
    """Modules of JAX, Flax or the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
