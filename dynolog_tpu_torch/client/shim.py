"""In-process trace shim for PyTorch applications.

The counterpart of ``dynolog_tpu/client/shim.py``: at app start it
registers with the local dynologd over the IPC fabric, then polls for
on-demand configs (and wakes early on the daemon's config "kick"
datagrams). When the operator runs ``dyno gputrace``, the received
key=value config is parsed and a torch.profiler capture at the config's
tracer levels (by default the JAX capture's: CPU and CUDA activities,
input shapes, Python frames) is taken and written as a kineto
Chrome-trace JSON, with a manifest next to it. If the app calls step(),
the shim also reports step rate and step-time percentiles to the daemon
("pstat").

The poll thread starts and stops every capture's profiler, as in the JAX
shim, and records all threads (``profile_all_threads``: torch.profiler
otherwise records the CPU ops of the starting thread only). Every
profiler starts with the app parked, its threads held off the card: a
start that met a kernel launch from another thread could lose every
later kernel record of the process (ROADMAP C17, C19). In an app that
calls ``step()``, the training thread parks in ``step()``; in one that
has not stepped (or whose next ``step()`` did not come in time), every
app thread the ``threading`` module started, but the shim's own, is held
at its next Python event (a PEP 669 ``sys.monitoring`` CALL or PY_START,
on for the park only: ``_EventPark``). A thread waiting on another
thread or on the outside (``Event.wait()``, ``Queue.get()``, ``join()``,
``time.sleep()``, a socket's ``accept()`` or ``recv()``, an idle pool
worker or asyncio loop) counts as parked and is held where it wakes; one
that stays in C otherwise for longer than ``EVENT_PARK_WAIT_S`` is left
to run. A capture's ``timing`` says
whether it was ``parked``, by which ``park`` ("step" or "event"), after
how long (``park_ms``), and which threads were ``waiting``.
Every capture opens its profiler a lead before its window: a start
loses its first launches' device records there, not in the window, and
the finish trims the lead from the trace. A duration capture starts the
profiler at the training thread's next ``step()``, waiting for it up to
``step_start_timeout_s`` (at its threads' next Python event in an app
that never steps, which is traced too), opens its window
``DURATION_LEAD_S`` after the start returned, sleeps the
window and stops it; the ``step()`` calls that fall in the window only
mark its ProfilerStep#N spans. An iteration capture's edges are steps:
the poll thread *arms* a window, the training thread's ``step()`` one
step before its first iteration (the lead step) parks while the poll
thread starts the profiler, and the ``step()`` at its end parks while
the poll thread stops it; the window's ``lead_ms`` is the lead step's
length, from the start's return.

Either way the poll thread then saves kineto's trace and goes back to
polling. What is left of the trace's save (adding the step spans,
dropping what the capture's levels and lead step leave out, and a ring
sample's promotion) runs in a child process at nice 19
(``PendingWrite``, ``trace.finish_trace``), so no trace is parsed in the
training process; a finisher thread waits on it and writes the manifest,
whose ``timing`` gets the child's ``write_ms`` and ``write_bytes``, and
``lost_launches``: the kernel launches of the window, made before the
stop began, whose kernel records the capture lost (torch.profiler can
lose them, XLA's capture does not; the manifest stays ``ok`` with its
trace on disk, and ``last_error`` says what was lost; None at device
tracer level 0, which records no kernel). A second child
at low priority then writes the trace's summary (``<run>.summary.json``)
beside it.

Each phase of a capture is one ``obs`` span under the capture's trace-id
(the manifest's ``trace_ctx``), sent to dynologd after the manifest, where
``dyno selftrace --trace_id=<id>`` serves them on the unix clock that the
manifest and kineto's trace use too. The manifest lists them as well
(``spans``: Chrome-trace "X" events, ``ts`` and ``dur`` in us), all but
its own ``shim.artifact_write``. Each phase is timed once: its
``timing`` key is its span's ``dur_us // 1000``. The tree, on the poll
thread but where it says otherwise:

    shim.capture           arming to the end of kineto's save
      shim.park            park_ms: arming to the app parked, or the
                           event park's hold
      shim.profiler_start  profiler_start_ms
      shim.lead            lead_ms: the start's return to the window's
                           opening (a duration window's DURATION_LEAD_S;
                           an iteration window's lead step, ended by the
                           training thread's step() that opens it)
      shim.window          window_ms: the window's opening to the stop's
                           beginning; an iteration window counts from the
                           start's return, so its shim.lead (the lead
                           step) lies inside it, and an event-parked
                           window holds its stop's park:
        shim.stop_park     stop_park_ms
      shim.profiler_stop   profiler_stop_ms (ROADMAP C16)
      shim.export          export_ms: the save in this process
        shim.kineto_save   kineto's export_chrome_trace
        shim.free_session  the session's release (_free_session)
        shim.finish        write_ms: the PendingWrite, spawning its child
                           to the rename (its own thread)
      shim.step_held       the training thread parked in step() at a
                           window's edge (the training thread; no key)
    shim.artifact_write    the manifest's write

A ring sample's shim.capture lies under ``shim.ring_capture``. The warmup
records its park, ``shim.drain`` (drain_ms), start, stop and export under
a ``shim.warmup`` of a trace-id of its own (``warmup_timing``).

``TraceClient(warmup_profiler=True)`` pays the profiler's one-time
start-up cost with a throwaway start/stop on the poll thread before its
first poll, the app parked from before its start to after its stop
(``WARMUP_PARK_WAIT_S``), and sets ``warmup_done`` when it is over (at
once without a warmup), so the first capture starts as fast as later
ones.

The continuous-capture ring (``CaptureRing``, opted into with
``DYNO_TPU_RING_EVERY_N`` or ``ring=RingConfig(...)``) samples a short
window every 1-in-N steps through the same machinery and keeps compact
profiles the diagnosis engine reads directly.

Config keys understood (the text the dyno CLI emits):

    PROFILE_START_TIME=<unix ms, 0 = now>
    ACTIVITIES_LOG_FILE=<output path>
    ACTIVITIES_DURATION_MSECS=<ms>          (duration mode)
    ACTIVITIES_ITERATIONS=<n>               (iteration mode)
    PROFILE_START_ITERATION_ROUNDUP=<r>
    TRACE_CONTEXT=<trace-id/span-id>

and the per-capture profiler knobs (``dyno gputrace --python_tracer_level
--host_tracer_level --device_tracer_level --notrace_json``), which hold
for one capture only; an absent key is the JAX capture's default
(``jax.profiler.ProfileOptions()``: Python 1, host 2, device 1):

    PROFILE_PYTHON_TRACER_LEVEL=<n>   0 no Python frames; >=1 with_stack
                                      (torch traces Python only beside
                                      the CPU activity, which then runs
                                      at host level 0 too)
    PROFILE_HOST_TRACER_LEVEL=<n>     0 no host ops (the finish drops
                                      the CPU activity's ops and the
                                      shim writes the ProfilerStep#N
                                      spans itself); 1 CPU ops; 2 with
                                      input shapes; 3 also memory and
                                      modules
    PROFILE_DEVICE_TRACER_LEVEL=<n>   0 no CUDA activity; >=1 CUDA where a
                                      card is present
    TRACE_JSON=0                      no summary child (the trace and its
                                      manifest are still written)

Usage::

    from dynolog_tpu_torch.client import TraceClient

    client = TraceClient(job_id=42)
    client.start()
    for batch in data:
        train_step(batch)
        client.step()   # iteration captures start and stop here
"""

from __future__ import annotations

import _thread
import collections
import dis
import functools
import inspect
import json
import logging
import math
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import dynolog_tpu_torch
from dynolog_tpu_torch import failpoints, obs, trace
from dynolog_tpu_torch.client import ipc
from dynolog_tpu_torch.stream import stream_write

_log = logging.getLogger("dynolog_tpu_torch.shim")

# Chrome-trace files the shim writes into a capture's trace dir, and the
# summaries written beside them.
TRACE_SUFFIX = trace.TRACE_SUFFIX
SUMMARY_SUFFIX = trace.SUMMARY_SUFFIX
# A ring sample's compact profile, written by its finish beside its trace.
SAMPLE_PROFILE_SUFFIX = ".profile.json"


def _ttl_from_env() -> float:
    """Stale-artifact sweep TTL: DYNO_TPU_SWEEP_TTL_S, else a day (long past
    any live capture, short enough that a crash-looping job cannot fill the
    trace volume). A typo'd value falls back to the default."""
    raw = os.environ.get("DYNO_TPU_SWEEP_TTL_S")
    if raw is None:
        return 24 * 3600
    try:
        return float(raw)
    except ValueError:
        _log.warning("DYNO_TPU_SWEEP_TTL_S=%r is not a number; using default",
                     raw)
        return 24 * 3600


DEFAULT_SWEEP_TTL_S = _ttl_from_env()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists (another user's), or unknowable: keep it
    return True


def _trace_session_dir(path: str, prefix: str) -> int | None:
    """The pid of a `<prefix>_<pid>` trace-session dir, or None if `path`
    does not look like one: the shim's own trace base name as the prefix,
    and only what the shim itself writes there (Chrome traces, their
    summaries and .tmp leftovers)."""
    base = os.path.basename(path.rstrip(os.sep))
    head, sep, pid_part = base.rpartition("_")
    if not sep or head != prefix or not pid_part.isdigit():
        return None
    try:
        entries = os.listdir(path)
    except OSError:
        return None
    if any(not e.endswith((TRACE_SUFFIX, SUMMARY_SUFFIX, ".tmp"))
           for e in entries):
        return None
    return int(pid_part)


def _reclaim(path: str, cutoff: float, reclaimed: list[str]) -> None:
    try:
        if os.path.getmtime(path) >= cutoff:
            return
        os.unlink(path)
    except OSError:
        return
    _log.info("reclaimed stale artifact: %s", path)
    reclaimed.append(path)


def sweep_stale_artifacts(
    trace_base: str, ttl_s: float = DEFAULT_SWEEP_TTL_S, *,
    now: float | None = None
) -> list[str]:
    """Garbage-collects debris a killed capture left around ``trace_base``
    (the log_file path minus its .json suffix), touching ONLY artifacts
    that carry the trace base's own name prefix — the parent is often a
    shared /tmp:

    - expired ``*.tmp`` files inside `<base>_<pid>` trace-session dirs;
    - `<base>_<pid>` session dirs whose pid is dead, that are older than
      ``ttl_s`` and that have NO `<base>_<pid>.json` manifest (the
      manifest marks a completed capture, which is never reclaimed);
    - expired `<base>_<pid>.json.tmp` manifest leftovers of dead pids.

    Returns the reclaimed paths. Best-effort: races lose politely."""
    trace_base = os.path.abspath(trace_base)
    root = os.path.dirname(trace_base)
    prefix = os.path.basename(trace_base)
    if ttl_s <= 0 or not prefix or not os.path.isdir(root):
        return []
    cutoff = (now if now is not None else time.time()) - ttl_s
    reclaimed: list[str] = []
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    for name in entries:
        path = os.path.join(root, name)
        if os.path.isdir(path):
            pid = _trace_session_dir(path, prefix)
            if pid is None:
                continue
            for entry in os.listdir(path):
                if entry.endswith(".tmp"):
                    _reclaim(os.path.join(path, entry), cutoff, reclaimed)
            try:
                expired = os.path.getmtime(path) < cutoff
            except OSError:
                continue
            if not expired or _pid_alive(pid) or os.path.exists(
                    path + ".json"):
                continue
            shutil.rmtree(path, ignore_errors=True)
            _log.info("reclaimed stale trace-session dir (pid %d gone): %s",
                      pid, path)
            reclaimed.append(path)
        elif name.endswith(".json.tmp"):
            head, sep, pid_part = name[: -len(".json.tmp")].rpartition("_")
            if (sep and head == prefix and pid_part.isdigit()
                    and not _pid_alive(int(pid_part))):
                _reclaim(path, cutoff, reclaimed)
    return reclaimed


WARMUP_PREFIX = "dynolog_tpu_torch_warmup_"


def _sweep_warmup_dirs(ttl_s: float) -> list[str]:
    """Startup sweep of SIGKILL'd warmup leftovers in the system tempdir
    (WARMUP_PREFIX dirs are created per process and removed in a finally:
    only a killed process leaves one behind). The JAX package's warmup
    dirs carry another prefix: neither sweep touches the other's."""
    if ttl_s <= 0:
        return []
    cutoff = time.time() - ttl_s
    reclaimed = []
    tmpdir = tempfile.gettempdir()
    try:
        entries = os.listdir(tmpdir)
    except OSError:
        return []
    for name in entries:
        if not name.startswith(WARMUP_PREFIX):
            continue
        path = os.path.join(tmpdir, name)
        try:
            if not os.path.isdir(path) or os.path.getmtime(path) >= cutoff:
                continue
        except OSError:
            continue
        shutil.rmtree(path, ignore_errors=True)
        _log.info("reclaimed stale warmup dir: %s", path)
        reclaimed.append(path)
    return reclaimed


@dataclass
class RingConfig:
    """Continuous-capture ring knobs (see CaptureRing).

    Env overrides (read by ``from_env``, the same variables as the JAX
    package's shim), so a training job opts in with environment alone:

        DYNO_TPU_RING_EVERY_N      sample 1-in-N steps (0 = ring off)
        DYNO_TPU_RING_KEEP         profiles retained per model
        DYNO_TPU_RING_WINDOW_MS    capture window per sample
        DYNO_TPU_RING_DIR          ring root directory
        DYNO_TPU_RING_MODEL        model tag (per-model subdirectory)
        DYNO_TPU_RING_TTL_S        max profile age
        DYNO_TPU_RING_MIN_INTERVAL_S  rate cap between samples
    """

    every_n_steps: int = 0  # 0 = ring off
    keep: int = 8
    window_ms: int = 100
    dir: str = ""  # empty = <tempdir>/dynolog_tpu_ring
    model: str = "default"
    ttl_s: float = 24 * 3600
    # Rate cap independent of step rate: a 5ms-step job with every_n=100
    # must not profile twice a second.
    min_interval_s: float = 30.0
    top_ops: int = 40

    def root(self) -> str:
        return self.dir or os.path.join(
            tempfile.gettempdir(), "dynolog_tpu_ring")

    @classmethod
    def from_env(cls, env=None) -> "RingConfig":
        env = os.environ if env is None else env
        cfg = cls()
        for key, attr, cast in (
            ("DYNO_TPU_RING_EVERY_N", "every_n_steps", int),
            ("DYNO_TPU_RING_KEEP", "keep", int),
            ("DYNO_TPU_RING_WINDOW_MS", "window_ms", int),
            ("DYNO_TPU_RING_DIR", "dir", str),
            ("DYNO_TPU_RING_MODEL", "model", str),
            ("DYNO_TPU_RING_TTL_S", "ttl_s", float),
            ("DYNO_TPU_RING_MIN_INTERVAL_S", "min_interval_s", float),
        ):
            raw = env.get(key)
            if raw is None:
                continue
            try:
                setattr(cfg, attr, cast(raw))
            except ValueError:
                # A typo'd knob must not abort the training job; the
                # ring simply keeps its default for that field.
                _log.warning("%s=%r is not a %s; ignored",
                             key, raw, cast.__name__)
        return cfg


class CaptureRing:
    """Rolling, sampled profile ring: every 1-in-N training steps
    (rate-capped), capture a short window and *promote* its Chrome trace
    to a compact op-level profile (trace.compact_profile), retaining the
    newest K per model in a TTL'd ring directory. The raw trace and its
    temp dir are deleted after promotion — the ring stores
    diagnosis-ready summaries, not traces.

    Profiles are schema-versioned envelopes the diagnosis engine accepts
    directly: ``python -m dynolog_tpu_torch.diagnose --ring DIR --baseline
    B`` diagnoses the newest one.

    The first boundary after start arms a sample: the ring starts "never
    captured", so the rate cap applies between samples only. (The JAX
    package's ring starts its clock at 0 and compares it with
    time.monotonic(), so on a host up for less than min_interval_s its
    first sample is rate-capped.)
    """

    PROFILE_SUFFIX = ".ringprof.json"

    def __init__(self, config: RingConfig):
        self.config = config
        self.captures = 0
        self.last_path: str | None = None
        self.last_error: str | None = None
        # Where the last stored sample's time went (ms): the window's
        # profiler timing, the whole take (window and save), the finish
        # child's write (trace and profile) and the promotion (the wait on
        # the child, and the store).
        self.last_timing: dict = {}
        self._pending = False
        self._last_capture_t: float | None = None  # never captured
        self._last_step_seen = 0

    # -- sampling decision (called from step(), must stay trivial) ------

    def note_step(self, step_count: int) -> None:
        n = self.config.every_n_steps
        if n <= 0 or self._pending:
            return
        # Boundary crossing, not equality: with every_n=100 a burst of
        # steps between polls must arm at most once.
        if step_count // n > self._last_step_seen // n:
            self._last_step_seen = step_count
            if (self._last_capture_t is None
                    or time.monotonic() - self._last_capture_t
                    >= self.config.min_interval_s):
                self._pending = True
            # else: rate-capped; the next boundary re-tests.
        else:
            self._last_step_seen = step_count

    def due(self) -> bool:
        return self._pending

    # -- capture + promotion (poll thread) ------------------------------

    def capture(self, take) -> str | None:
        """One ring sample: `take(trace_dir)` captures a window of
        config.window_ms and returns (trace, timing dict), the trace a
        Chrome trace's path, which is promoted here, or the PendingWrite
        of its finish, which promotes it in its child and is waited on
        here; the profile is stored and the ring pruned. Returns the
        stored profile path (None on failure; last_error says why, and
        what a stored sample lost: its last_timing's lost_launches)."""
        self._pending = False
        self._last_capture_t = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="dynolog_tpu_torch_ring_cap_")
        try:
            with obs.span("shim.ring_capture") as take_span:
                got, timing = take(tmp)
            with obs.span("shim.ring_promote") as promote:
                if isinstance(got, PendingWrite):
                    done = got.wait(30.0)
                    if "write_error" in done:
                        raise RuntimeError(done["write_error"])
                    timing = {**timing, **done}
                    with open(got.profile_path, "rb") as f:
                        profile = json.loads(f.read())
                else:
                    with open(got, "rb") as f:
                        profile = trace.compact_profile(
                            f.read(), top=self.config.top_ops)
                path = self._store(profile)
            self.last_timing = {
                **timing, "take_ms": _ms(take_span),
                "promote_ms": _ms(promote),
                "trace_bytes": profile["trace_bytes"]}
            self.captures += 1
            self.last_path = path
            lost = timing.get("lost_launches")
            # A sample that lost kernel records is stored, and says so.
            self.last_error = (f"ring sample {path}: {lost} launches in its "
                               "window have no kernel record"
                               if lost else None)
            return path
        except Exception as e:  # noqa: BLE001 - the ring is best-effort
            # telemetry; a failed sample must never cost the poll loop
            # (on-demand tracing rides it).
            self.last_error = f"ring capture failed: {e}"
            return None
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _store(self, profile: dict) -> str:
        model_dir = os.path.join(self.config.root(), self.config.model)
        os.makedirs(model_dir, exist_ok=True)
        doc = {
            # The diagnosis engine's envelope: it refuses mismatched
            # schemas loudly.
            "schema": 1,
            "kind": "dynolog_tpu.ring_profile",
            "model": self.config.model,
            "created_ms": int(time.time() * 1000),
            "step": self._last_step_seen,
            "window_ms": self.config.window_ms,
            "pid": os.getpid(),
            "summary": profile,
        }
        path = os.path.join(
            model_dir,
            "%d_s%d%s" % (doc["created_ms"], doc["step"],
                          self.PROFILE_SUFFIX))
        stream_write(path, [json.dumps(doc, indent=1).encode()])
        self._prune(model_dir)
        return path

    def _prune(self, model_dir: str) -> None:
        entries = self.entries(model_dir)
        for victim in entries[: max(len(entries) - self.config.keep, 0)]:
            try:
                os.unlink(victim)
            except OSError:
                pass

    def entries(self, model_dir: str | None = None) -> list[str]:
        """This model's stored profiles, oldest first."""
        model_dir = model_dir or os.path.join(
            self.config.root(), self.config.model)
        try:
            names = os.listdir(model_dir)
        except OSError:
            return []
        return sorted(
            os.path.join(model_dir, n) for n in names
            if n.endswith(self.PROFILE_SUFFIX))

    def sweep(self, now: float | None = None) -> list[str]:
        """TTL sweep across EVERY model under the ring root (startup
        hygiene): expired profiles are reclaimed."""
        if self.config.ttl_s <= 0:
            return []
        cutoff = (now if now is not None else time.time()) - self.config.ttl_s
        reclaimed: list[str] = []
        root = self.config.root()
        try:
            models = os.listdir(root)
        except OSError:
            return []
        for model in models:
            model_dir = os.path.join(root, model)
            if not os.path.isdir(model_dir):
                continue
            for path in self.entries(model_dir):
                try:
                    if os.path.getmtime(path) >= cutoff:
                        continue
                    os.unlink(path)
                except OSError:
                    continue
                _log.info("reclaimed expired ring profile: %s", path)
                reclaimed.append(path)
        return reclaimed


_run_seq_lock = threading.Lock()
_run_seq = 0


def _unique_run_name() -> str:
    """File stem for one capture: milliseconds plus a per-process counter,
    so back-to-back captures never share a file."""
    global _run_seq
    with _run_seq_lock:
        _run_seq += 1
        seq = _run_seq
    return "%s_%03d_p%d_%d" % (
        time.strftime("%Y_%m_%d_%H_%M_%S"), int(time.time() * 1000) % 1000,
        os.getpid(), seq)


@dataclass
class TraceConfig:
    """Parsed on-demand trace request."""

    log_file: str = ""
    start_time_ms: int = 0
    duration_ms: int = 500
    iterations: int = -1
    iteration_roundup: int = 1
    # Control-plane trace context (TRACE_CONTEXT=..., injected by the
    # daemon's RPC verb): the id this capture's spans are recorded under.
    trace_ctx: str = ""
    raw: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "TraceConfig":
        cfg = cls()
        for line in text.replace("\\n", "\n").splitlines():
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            key = key.strip().upper()
            value = value.strip()
            cfg.raw[key] = value
            try:
                if key == "ACTIVITIES_LOG_FILE":
                    cfg.log_file = value
                elif key == "PROFILE_START_TIME":
                    cfg.start_time_ms = int(value)
                elif key == "ACTIVITIES_DURATION_MSECS":
                    cfg.duration_ms = int(value)
                elif key == "ACTIVITIES_ITERATIONS":
                    cfg.iterations = int(value)
                elif key == "PROFILE_START_ITERATION_ROUNDUP":
                    cfg.iteration_roundup = int(value)
                elif key == obs.CONFIG_KEY:
                    cfg.trace_ctx = value
            except ValueError:
                pass
        return cfg

    def _base(self) -> str:
        base = self.log_file or os.path.join(
            tempfile.gettempdir(), "dynolog_tpu_torch_trace.json")
        return base[:-5] if base.endswith(".json") else base

    def trace_dir(self, pid: int) -> str:
        """Directory the Chrome trace is written to, derived from log_file
        per pid (as dyno prints it)."""
        return f"{self._base()}_{pid}"

    def manifest_path(self, pid: int) -> str:
        return f"{self._base()}_{pid}.json"


# The per-capture tracer-level keys of the on-demand config and the
# levels a capture runs at when its config omits them: those of
# jax.profiler.ProfileOptions(), so a plain `dyno gputrace` records what
# it records of a JAX job (the JAX device tracer is always on).
TRACER_LEVEL_KEYS = (
    ("PROFILE_PYTHON_TRACER_LEVEL", "python_tracer_level"),
    ("PROFILE_HOST_TRACER_LEVEL", "host_tracer_level"),
    ("PROFILE_DEVICE_TRACER_LEVEL", "device_tracer_level"),
)
DEFAULT_TRACER_LEVELS = {"python_tracer_level": 1, "host_tracer_level": 2,
                         "device_tracer_level": 1}


def profile_options(levels: dict, cuda: bool) -> dict:
    """torch.profiler.profile's keyword arguments for a capture at these
    tracer levels, `cuda` saying whether a card is present: the host level
    sets the CPU activity (1), input shapes (2), memory and module
    hierarchy (3); the device level the CUDA activity; the Python level
    with_stack, torch's Python tracer. That tracer records only beside the
    CPU activity, so at host level 0 the CPU activity runs for the Python
    frames alone, and the finish drops its host ops (trace.finish_trace)."""
    from torch.profiler import ProfilerActivity

    host = levels["host_tracer_level"]
    python = levels["python_tracer_level"] >= 1
    activities = []
    if host >= 1 or python:
        activities.append(ProfilerActivity.CPU)
    if levels["device_tracer_level"] >= 1 and cuda:
        activities.append(ProfilerActivity.CUDA)
    return {"activities": activities, "record_shapes": host >= 2,
            "with_stack": python, "profile_memory": host >= 3,
            "with_modules": host >= 3}


class CaptureKnobs:
    """The per-capture knobs of the config text, parsed as the JAX
    package's JaxProfiler.configure parses them. ``tracer_levels`` holds
    the levels this capture's config set; ``levels`` the ones it runs at;
    ``export_trace_json`` whether the capture gets its summary child."""

    def __init__(self):
        self.export_trace_json = True
        self.tracer_levels: dict[str, int] = {}

    def configure(self, raw: dict) -> None:
        """Applies one capture's knobs. Absent keys revert to the
        defaults, so no knob leaks into the next capture; a level that is
        not an integer is ignored."""
        self.tracer_levels = {}
        self.export_trace_json = True
        for key, attr in TRACER_LEVEL_KEYS:
            if key in raw:
                try:
                    self.tracer_levels[attr] = int(raw[key])
                except ValueError:
                    pass
        if "TRACE_JSON" in raw:
            self.export_trace_json = raw["TRACE_JSON"].lower() not in (
                "0", "false", "no")

    @property
    def levels(self) -> dict:
        """The levels the capture runs at: the defaults, overridden by
        the levels its config set (a negative one keeps the default, as
        the CLI's -1 does)."""
        return {**DEFAULT_TRACER_LEVELS,
                **{k: v for k, v in self.tracer_levels.items() if v >= 0}}


class _StepClock:
    """The wall-clock times (epoch ns) of a capture's step() calls and its
    stop, and the thread that called step(). Span N runs from the N-th time
    to the next, as torch.profiler's ProfilerStep#N spans do, so the
    summarizer reads them alike: the last span, from the last step() to
    the stop, is not a step. A window that step() opens at its first step
    (an iteration capture without a lead step) counts its start as the
    first time; one that opens earlier (the poll thread's, mid-step, or an
    iteration window's a step early) has its first span open at its first
    step()."""

    def __init__(self, at_step: bool = True):
        self.tid = threading.get_native_id()
        self.times = [time.time_ns()] if at_step else []

    def mark(self) -> None:
        self.tid = threading.get_native_id()
        self.times.append(time.time_ns())

    def close(self) -> None:
        self.times.append(time.time_ns())

    def spec(self) -> dict:
        """The spans' arguments of trace.step_events, as JSON."""
        return {"times": list(self.times), "tid": self.tid,
                "pid": os.getpid()}

    def events(self, base_ns: int) -> list[dict]:
        """The spans as Chrome-trace events on a time base of `base_ns`."""
        return trace.step_events(base_ns=base_ns, **self.spec())


def _write_steps(tmp: str, clock: _StepClock, drop_host: bool = False
                 ) -> dict:
    """Adds the clock's step spans to the Chrome trace at `tmp`, without
    the host ops where `drop_host`, or writes a trace holding only them
    where the profiler wrote none (in this process). Returns
    trace.finish_trace's result."""
    return trace.finish_trace(tmp, tmp, steps=clock.spec(),
                              drop_host=drop_host)


def _child_env() -> dict:
    """The environment of the shim's child processes: this one's, with
    the package on PYTHONPATH."""
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(dynolog_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_parent + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _finish_files(path: str) -> tuple[str, str, str]:
    """The temporary files of the finish of the trace that lands at
    `path`: kineto's save, the finish's arguments, and the finished trace
    before its rename. Their .tmp suffix is what the stale-artifact sweep
    reclaims."""
    return path + ".raw.tmp", path + ".spec.tmp", path + ".tmp"


def _ms(span: obs.Span) -> int:
    """A recorded span's length in whole ms: the timing key of its
    phase."""
    return span.dur_us // 1000


def _unlink_all(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


class PendingWrite:
    """One capture's deferred finish, on its own thread: the counterpart of
    the JAX shim's PendingWrite. kineto saved the trace in this process
    (its results live here); the rest — reading it back, adding the step
    spans, dropping what the capture's levels and lead step leave out,
    and for a ring sample the compact profile — is seconds of pure-Python
    work, so it runs in a child process at nice 19
    (trace.finish_capture), which this thread waits on with the GIL
    released, then renames the finished trace into place. Where the child
    cannot be spawned it finishes on this thread instead. `spec` holds
    trace.finish_trace's arguments; the finished trace lands at `path`,
    a ring sample's profile at spec["profile"]. Its result carries the
    finish's count of the window's launches whose kernel records the
    capture lost (``lost_launches``), which the child prints."""

    def __init__(self, spec: dict, path: str):
        self.path = path
        self.profile_path = spec.get("profile")
        self.result: dict | None = None
        self.error: str | None = None
        self._spec = spec
        # The context it is made in (its capture's shim.export), for its
        # shim.finish span on its own thread, which contextvars miss.
        self._ctx = obs.current()
        self._proc: subprocess.Popen | None = None
        self._done = threading.Event()
        # Unsupervised by design: one per capture, joined through wait()
        # by whoever needs the trace (the finisher, the ring).
        self._thread = threading.Thread(
            target=self._run, name="dynolog_tpu_torch_trace_finish",
            daemon=True)
        self._thread.start()

    def _spawn(self, spec_path: str) -> subprocess.Popen | None:
        with open(spec_path, "w") as f:
            json.dump(self._spec, f)
        code = ("import os; os.nice(19); "
                "from dynolog_tpu_torch.trace import finish_capture; "
                f"finish_capture({spec_path!r})")
        try:
            if failpoints.fire("shim.finish_spawn"):
                raise OSError("failpoint shim.finish_spawn")
            return subprocess.Popen(
                [sys.executable, "-c", code], env=_child_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True)
        except OSError as e:
            _log.warning("finish child not started for %s (%s): finishing "
                         "in-process", self.path, e)
            return None

    def _run(self) -> None:
        raw, spec_path, tmp = _finish_files(self.path)
        try:
            with obs.span("shim.finish", ctx=self._ctx) as span:
                self._proc = self._spawn(spec_path)
                if self._proc is None:
                    finished = trace.finish_trace(**self._spec)
                else:
                    out, err = self._proc.communicate()
                    if self._proc.returncode != 0:
                        tail = err.decode(
                            errors="replace").strip().splitlines()
                        raise RuntimeError(
                            f"finish child exited {self._proc.returncode}"
                            + (f": {tail[-1]}" if tail else ""))
                    finished = json.loads(
                        out.decode().strip().splitlines()[-1])
                os.replace(tmp, self.path)
            self.result = {"write_ms": _ms(span),
                           "write_bytes": os.path.getsize(self.path),
                           "lost_launches": finished["lost_launches"]}
        except Exception as e:  # noqa: BLE001 - the finish is its own
            # failure domain: the error reaches the manifest via wait().
            self.error = f"trace finish failed: {e}"
        finally:
            _unlink_all(raw, spec_path, tmp)
            self._done.set()

    def wait(self, timeout_s: float = 120.0) -> dict:
        """Blocks until the finish ended; returns {"write_ms",
        "write_bytes", "lost_launches"} or {"write_error": ...}. A child
        still running at the timeout is killed (the finish then cleans up
        after it)."""
        if not self._done.wait(timeout_s):
            if self._proc is not None:
                self._proc.kill()
            return {"write_error":
                    f"trace finish did not end within {timeout_s:g}s"}
        if self.error is not None:
            return {"write_error": self.error}
        return dict(self.result)


def _free_session(prof) -> None:
    """Frees a stopped torch.profiler.profile's results (its autograd
    profiler, which holds kineto's) now, on the calling thread. The
    profile holds bound methods of itself in its action_map: a reference
    cycle that, left alone, the cyclic GC frees on whichever thread's
    allocation sets it off, possibly the app's inside a later capture's
    window (ROADMAP C22)."""
    prof.profiler = None
    getattr(prof, "action_map", {}).clear()


class TorchProfiler(CaptureKnobs):
    """Default profiler backend: a torch.profiler capture at the tracer
    levels of the capture's config (``configure``; see profile_options).

    Every capture is started and stopped on the TraceClient's poll
    thread, records every thread's ops (``profile_all_threads``), and
    gets its ProfilerStep#N spans from the step() calls of the stepping
    thread, which the finish adds (``_StepClock``). An iteration capture
    opens with ``lead=True`` one step before its window (``lead_step``),
    while the training thread is parked at that step(), and its window
    opens at its first step(). A duration capture (and the warmup) opens
    with ``lead=True`` too, and its window opens at open_window(),
    ``DURATION_LEAD_S`` after start() returned.
    Records lost to a slow start then fall in the lead, which the finish
    trims. At host level 0 the finish drops the host ops. With every
    tracer off, start() raises. The finish counts the window's launches
    made before the stop began that have no kernel record
    (``lost_launches``, trace.unmatched_launches).

    export() may run on any thread after stop() — the TraceClient's poll
    thread calls it. It saves kineto's trace in this process, then
    finishes it (trace.finish_trace): in this process (its result in
    ``last_finish``), or with ``pipelined=True`` in a PendingWrite that
    the caller takes with take_pending_write() and waits on before the
    trace is complete."""

    # The TraceClient opens an iteration window one step early.
    lead_step = True

    def __init__(self):
        super().__init__()
        self._prof = None
        self._stopped = None
        self._clock: _StepClock | None = None
        self._host_on = self._device_on = True
        self._lead = False
        self._opens_ns: int | None = None
        self._stop_ns: int | None = None
        self._pending_write: PendingWrite | None = None
        self.last_finish: dict = {}

    def start(self, trace_dir: str, lead: bool = False) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import profile

        levels = self.levels
        if max(levels.values()) < 1:
            raise RuntimeError(
                "no tracer left to run: PROFILE_PYTHON_TRACER_LEVEL=0, "
                "PROFILE_HOST_TRACER_LEVEL=0 and PROFILE_DEVICE_TRACER_LEVEL=0"
                " leave torch.profiler no activity")
        opts = profile_options(levels, torch.cuda.is_available())
        self._host_on = levels["host_tracer_level"] >= 1
        self._device_on = levels["device_tracer_level"] >= 1
        self._lead = lead
        self._opens_ns = None
        if opts["activities"]:
            # One configuration for every capture, which the poll thread
            # opens (C17): profile_all_threads, so that the training
            # thread's ops are recorded; no schedule, so no torch
            # ProfilerStep#N spans (the finish adds the shim's); and no
            # acc_events: with it, stop() parses every kineto event into
            # FunctionEvents on the stopping thread, which nothing here
            # reads (export() saves kineto's own results).
            opts["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
            self._prof = profile(**opts)
            self._prof.start()
        # The first span opens once the window's steps begin, as torch's
        # does.
        self._clock = _StepClock(at_step=not lead)

    def open_window(self, at_ns: int) -> None:
        """Opens the window of a capture started with ``lead=True`` where
        no step() opens it (a duration window, at the end of its lead) at
        epoch ns `at_ns`: the finish trims what was recorded before it."""
        self._opens_ns = at_ns

    @staticmethod
    def drain(device: int) -> None:
        """Waits for the work queued on card `device`, where this process
        has set up CUDA (the warmup's start, C18)."""
        import torch

        if (torch.cuda.is_available() and torch.cuda.is_initialized()
                and device < torch.cuda.device_count()):
            torch.cuda.synchronize(device)

    def step(self) -> None:
        self._clock.mark()
        if self._lead and self._opens_ns is None:
            # An iteration window opens at its first step().
            self._opens_ns = self._clock.times[-1]

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        self._clock.close()
        self._stop_ns = time.time_ns()
        if prof is not None:
            prof.stop()
        if self._stopped is not None:  # stopped, never saved
            _free_session(self._stopped)
        self._stopped = prof

    def _finish_spec(self, path: str, profile_top: int | None) -> dict:
        """trace.finish_trace's arguments for the stopped capture."""
        raw, _, tmp = _finish_files(path)
        spec = {"raw": raw, "out": tmp, "steps": self._clock.spec(),
                "drop_host": not self._host_on,
                "lead_ns": self._opens_ns if self._lead else None,
                "stop_ns": self._stop_ns, "device": self._device_on}
        if profile_top is not None:
            spec.update(profile=path[: -len(TRACE_SUFFIX)]
                        + SAMPLE_PROFILE_SUFFIX,
                        top=profile_top)
        return spec

    def export(self, trace_dir: str, pipelined: bool = False,
               profile_top: int | None = None) -> str:
        """Saves the stopped capture's Chrome trace into `trace_dir` and
        returns the path it lands at (tmp + rename). With `pipelined` the
        capture is complete only once its PendingWrite
        (take_pending_write) is; with `profile_top` the finish also
        writes the trace's compact_profile(top) at the PendingWrite's
        profile_path. The session's results are freed before it
        returns (_free_session)."""
        prof, self._stopped = self._stopped, None
        path = os.path.join(trace_dir, _unique_run_name() + TRACE_SUFFIX)
        spec = self._finish_spec(path, profile_top)
        raw, _, tmp = _finish_files(path)
        try:
            if prof is not None:
                with obs.span("shim.kineto_save"):
                    prof.export_chrome_trace(raw)
            if pipelined:
                self._pending_write = PendingWrite(spec, path)
                return path
            self.last_finish = trace.finish_trace(**spec)
            os.replace(tmp, path)
        except BaseException:
            _unlink_all(raw, tmp)
            raise
        finally:
            if prof is not None:
                with obs.span("shim.free_session"):
                    _free_session(prof)
        _unlink_all(raw)
        return path

    def take_pending_write(self) -> PendingWrite | None:
        """Hands the caller the pending finish of the capture export()
        just saved with ``pipelined=True``. The caller must wait() on it
        before the trace is complete."""
        pending, self._pending_write = self._pending_write, None
        return pending


class RecordingProfiler(CaptureKnobs):
    """Test backend: records the shim's calls (``calls``: ("configure",
    raw), ("start", trace_dir), ("step", None), ("stop", None),
    ("export", trace_dir)) instead of tracing, and exports a trace that
    holds only the ProfilerStep#N spans of the steps it saw, so a capture
    completes with its manifest and summary (``last_finish``: the
    finish's result, no launch lost)."""

    def __init__(self):
        super().__init__()
        self.calls: list[tuple[str, object]] = []
        self._clock: _StepClock | None = None
        self.last_finish: dict = {}

    def configure(self, raw: dict) -> None:
        self.calls.append(("configure", dict(raw)))
        super().configure(raw)

    def start(self, trace_dir: str, lead: bool = False) -> None:
        self.calls.append(("start", trace_dir))
        self._clock = _StepClock(at_step=not lead)

    def open_window(self, at_ns: int) -> None:
        """Nothing to trim: only the window's step() calls are seen."""

    def step(self) -> None:
        self.calls.append(("step", None))
        self._clock.mark()

    def stop(self) -> None:
        self.calls.append(("stop", None))
        self._clock.close()

    def export(self, trace_dir: str) -> str:
        self.calls.append(("export", trace_dir))
        path = os.path.join(trace_dir, _unique_run_name() + TRACE_SUFFIX)
        self.last_finish = _write_steps(path + ".tmp", self._clock)
        os.replace(path + ".tmp", path)
        return path


class _Window:
    """One capture window, opened and closed by the poll thread, which
    arms it. The training thread's step() at its start_at (less its lead
    steps) moves it to opening and parks until the poll thread has
    started the profiler; an iteration window is then active, a duration
    window (end_at None, start_at the next step) in its lead until the
    poll thread makes it active. A duration window (or the warmup's) that
    no step() moved to opening is parking while the poll thread holds the
    app's threads at their next Python event (`park`, an _EventPark) and
    starts the profiler; step() leaves it alone. While active, step()
    marks its steps; an iteration window's step() at end_at moves it to
    closing and parks until the poll thread has stopped it (stopped).
    Every transition happens under the client's step condition."""

    def __init__(self, trace_dir: str, start_at: int, end_at: int | None,
                 lead: int = 0):
        self.trace_dir = trace_dir
        self.start_at = start_at  # iteration mode: the window's first count
        self.end_at = end_at  # iteration mode: the count that stops it
        # Iteration mode: the steps the profiler opens before start_at.
        self.lead = lead
        self.state = "armed"
        self.error: str | None = None
        self.timing: dict = {}
        self.started_ms = 0
        self.park: _EventPark | None = None
        # The capture's span context (the poll thread makes the window
        # inside it), for the training thread's shim.step_held spans.
        self.ctx = obs.current()
        # An iteration window's shim.lead: begun by the poll thread at the
        # start's return, ended and recorded by the lead step's end.
        self.lead_span: obs.Span | None = None


# The prefix of every thread the shim starts (the poll thread, finishers,
# finish and summary waiters): the event park never holds one.
THREAD_PREFIX = "dynolog_tpu_torch_"
# How long a start that found no app thread parked in step() waits for
# each app thread to reach its next Python event (_EventPark); a thread
# that stays in C longer (a long call, a bare lock acquire, a ctypes call;
# not one waiting at a wait site, _WAITS, or in a blocking builtin,
# _BLOCKING, which counts as parked at once) is not held, and the start
# says "parked": false. The warmup waits WARMUP_PARK_WAIT_S instead: a
# process's first steps hold the longest calls into C (the card's set-up,
# its first kernels' loads).
EVENT_PARK_WAIT_S = 2.0
# How long a thread held at a Python event waits for the start (the
# warmup's: and its stop) to return before it goes on regardless.
EVENT_HOLD_MAX_S = 60.0
# The sys.monitoring tool ids the event park may take: the two PEP 669
# leaves unnamed (0-2 and 5 are the debugger's, coverage's, profilers'
# and optimizers').
EVENT_PARK_TOOL_IDS = (3, 4)
# A thread is never held inside these files' code: the shim (its step
# lock), the threading, queue and logging modules (their locks) and an
# import (a module's lock), any of which a profiler's start may need;
# but for the threading module's frames at the foot of every thread it
# started (_THREAD_FOOT). Nor inside torch.cuda's package (_EventPark):
# a thread that sets up CUDA holds its _initialization_lock across
# Python calls, and a profiler's stop synchronizes the card, which takes
# that lock until CUDA is set up.
_NO_PARK_FILES = frozenset((
    __file__, threading.__file__, queue.__file__, logging.__file__,
    "<frozen importlib._bootstrap>", "<frozen importlib._bootstrap_external>"))
_THREAD_FOOT = frozenset(f.__code__ for f in (
    threading.Thread._bootstrap, threading.Thread._bootstrap_inner,
    threading.Thread.run))


def _calls(code, attr: str) -> list[int]:
    """The offsets of the CALL instructions of `code` that call a
    method named `attr` (the attribute loaded last before them)."""
    loaded, offsets = None, []
    for ins in dis.get_instructions(code):
        if ins.opname == "LOAD_ATTR":
            loaded = ins.argval
        elif ins.opname == "CALL" and loaded == attr:
            offsets.append(ins.offset)
    return offsets


def _wait_sites() -> tuple[dict, frozenset]:
    """Where a thread waits in the threading module's Python for another
    thread: {code: offsets of its blocking calls} for
    threading.Condition.wait (which Event.wait, Queue.get and put,
    Semaphore.acquire, Barrier.wait and Future.result wait in), its
    acquires between releasing the Condition's lock and restoring it,
    and for Thread.join, _wait_for_tstate_lock's acquire, whose lock it
    releases before it leaves the module; and the offsets in
    Condition.wait of its _acquire_restore calls, the first Python event
    of a thread that wakes there, before it holds any lock again."""
    cond = threading.Condition.wait.__code__
    released = min(_calls(cond, "_release_save"), default=None)
    restores = _calls(cond, "_acquire_restore")
    waits = {cond: frozenset(
        o for o in _calls(cond, "acquire")
        if released is not None and released < o < min(restores, default=0))}
    join = getattr(threading.Thread, "_wait_for_tstate_lock", None)
    if join is not None:
        waits[join.__code__] = frozenset(_calls(join.__code__, "acquire"))
    return waits, frozenset(restores)


def _blocking_builtins() -> tuple:
    """The builtins a thread waits in, for another thread or for the
    outside, holding no lock and launching nothing: time.sleep;
    select.select and the poll methods of the objects the selectors
    module waits in (an idle asyncio loop, a socketserver); a socket's
    _accept (socket.accept's), recv, recv_into and recvfrom; and
    SimpleQueue.get (an idle ThreadPoolExecutor worker's)."""
    import _queue
    import _socket
    import select

    found = [time.sleep, select.select]
    methods = [(_socket.socket, ("_accept", "recv", "recv_into", "recvfrom")),
               (_queue.SimpleQueue, ("get",))]
    if hasattr(select, "poll"):
        methods.append((type(select.poll()), ("poll",)))
    for name, method in (("epoll", "poll"), ("devpoll", "poll"),
                         ("kqueue", "control")):
        if hasattr(select, name):
            methods.append((getattr(select, name), (method,)))
    for cls, names in methods:
        found += [vars(cls)[name] for name in names]
    return tuple(found)


# The instructions that load the root of a call's load chain, and the
# frame's namespaces each looks its name up in, in order.
_NAME_LOADS = {
    "LOAD_FAST": ("f_locals",), "LOAD_FAST_CHECK": ("f_locals",),
    "LOAD_DEREF": ("f_locals",), "LOAD_GLOBAL": ("f_globals", "f_builtins"),
    "LOAD_NAME": ("f_locals", "f_globals", "f_builtins")}
_JUMPS = frozenset(dis.hasjrel + dis.hasjabs)


@functools.lru_cache(maxsize=4096)
def _load_chain(code, offset: int) -> tuple | None:
    """How the CALL at `offset` in `code` loads its callable: (the root's
    load instruction, the root's name, the attribute names loaded off
    it), read back from the CALL over its arguments by their stack
    effects; None where the instruction is no CALL or the callable is not
    such a chain (a jump among its arguments, a subscript, a call)."""
    ins = list(dis.get_instructions(code))
    at = next((k for k, i in enumerate(ins) if i.offset == offset), None)
    if at is None or ins[at].opname != "CALL":
        return None
    k, left, attrs = at - 1, ins[at].arg, []
    while k >= 0 and (left > 0 or ins[k].opname == "LOAD_ATTR"):
        i = ins[k]
        if i.is_jump_target or i.opcode in _JUMPS:
            return None
        if left > 0:
            left -= dis.stack_effect(
                i.opcode, i.arg if i.opcode >= dis.HAVE_ARGUMENT else None)
        else:
            attrs.append(i.argval)
        k -= 1
    if left != 0 or k < 0 or ins[k].opname not in _NAME_LOADS:
        return None
    return ins[k].opname, ins[k].argval, tuple(reversed(attrs))


def _blocking_call(frame) -> bool:
    """Whether `frame`, another thread's innermost, is in a call of one
    of _BLOCKING: the callable of the CALL at its f_lasti, resolved
    from its load chain through the frame's namespaces and the chain's
    attributes (inspect.getattr_static: no descriptor or __getattr__
    runs), is one of those objects. A name alone is not enough."""
    chain = _load_chain(frame.f_code, frame.f_lasti)
    if chain is None:
        return False
    op, name, attrs = chain
    for space in _NAME_LOADS[op]:
        names = getattr(frame, space)
        if name in names:
            obj = names[name]
            break
    else:
        return False
    try:
        for attr in attrs:
            obj = inspect.getattr_static(obj, attr)
    except Exception:  # noqa: BLE001 - not resolved: not known to block
        return False
    return any(obj is b for b in _BLOCKING)


_WAITS, _WAKES = _wait_sites()
_BLOCKING = _blocking_builtins()
_COND_WAIT = threading.Condition.wait.__code__
_WAITING_FILES = frozenset((threading.__file__, queue.__file__))


def _past_waits(frame):
    """The first frame from `frame` down outside the threading and queue
    modules (a thread's foot frames, _THREAD_FOOT, count as outside):
    where a thread that waited in their code runs next once it has left
    it, holding none of their locks."""
    while (frame is not None and frame.f_code.co_filename in _WAITING_FILES
           and frame.f_code not in _THREAD_FOOT):
        frame = frame.f_back
    return frame


def _app_threads() -> dict:
    """The threads an event park watches, by ident: the threading
    module's live threads but the calling one, the shim's own
    (THREAD_PREFIX) and dummy threads, which the threading module did not
    start (such as the autograd engine's device threads, which run
    Python only inside a backward)."""
    me = threading.get_ident()
    return {t.ident: t for t in threading.enumerate()
            if t.ident != me and not isinstance(t, threading._DummyThread)
            and not t.name.startswith(THREAD_PREFIX)}


class _EventPark:
    """Holds the app's threads off the card while a profiler starts, in
    an app that does not park in step() (ROADMAP C19): PEP 669's CALL and
    PY_START events are on, on a free sys.monitoring tool id, from hold()
    to release(), and a watched thread (_app_threads) that reaches one
    waits in the callback until release(), at most EVENT_HOLD_MAX_S.

    A thread is not held inside a file of _NO_PARK_FILES or of torch.cuda,
    inside autograd's backward (a Python Function's backward runs on the
    calling thread on the CPU; on the card the engine's device thread,
    which is not watched, runs it while the calling thread waits in C),
    or at a call of TraceClient.stop() or __exit__(), which ends the
    wait. A thread blocked at a wait site of the threading module
    (_WAITS: Condition.wait, Thread.join) or in a blocking builtin
    (_BLOCKING: time.sleep, a socket's accept and receives, the
    selectors' waits, SimpleQueue.get) counts as parked (`waiting`): it
    reaches the card only after its next Python event, where it is held:
    in Condition.wait at its _acquire_restore call, else at the latest at
    the first instruction it runs in its resume frame (_past_waits of its
    innermost), whose code gets INSTRUCTION events before the thread
    counts. A thread that stays in C otherwise (loss.backward() on the
    card, a bare lock acquire, a ctypes call) holds the start at most the
    bound given to hold()."""

    def __init__(self):
        self.watched = _app_threads()
        self.held: set[int] = set()
        self.waiting: set[int] = set()
        self.escaped: set[int] = set()
        # A waiting thread's resume frame, and the codes that have
        # INSTRUCTION events on for resume frames.
        self._resume: dict = {}
        self._stepped: set = set()
        self._gate = _thread.allocate_lock()
        self._tool: int | None = None
        self._released = False
        torch = sys.modules.get("torch")
        self._graph_task = getattr(getattr(torch, "_C", None),
                                   "_current_graph_task_id", None)
        dirs = {}
        for name in ("cuda", "autograd"):
            path = getattr(getattr(torch, name, None), "__file__", None)
            dirs[name] = (os.path.dirname(path) + os.sep,) if path else ()
        self._no_park_dirs = dirs["cuda"]
        self._no_wait_dirs = dirs["cuda"] + dirs["autograd"]

    @staticmethod
    def _events(mon) -> tuple:
        return mon.events.CALL, mon.events.PY_START, mon.events.INSTRUCTION

    def hold(self, bound_s: float, stop: threading.Event) -> bool:
        """Turns the events on and waits until every watched thread still
        alive is held or waiting, `stop` is set or `bound_s` has passed;
        True if every one is. The events stay on, and the held threads
        held, until release()."""
        mon = getattr(sys, "monitoring", None)
        for tool in EVENT_PARK_TOOL_IDS if mon else ():
            try:
                mon.use_tool_id(tool, "dynolog_tpu_torch event park")
            except ValueError:  # taken
                continue
            self._tool = tool
            break
        else:
            return not self.watched
        self._gate.acquire()
        for event in self._events(mon):
            mon.register_callback(tool, event, self._hold_at_python_event)
        mon.set_events(tool, mon.events.CALL | mon.events.PY_START)
        deadline = time.monotonic() + bound_s
        while self.unheld():
            if stop.is_set() or time.monotonic() > deadline:
                return False
            time.sleep(0.0005)
        return True

    def unheld(self) -> list[str]:
        """The names of the watched threads alive, not held and not
        waiting (which updates `waiting`). A thread counts as waiting only
        while the events are on, in a snapshot taken once its resume
        frame's code has INSTRUCTION events on: woken any earlier, it is
        not at its wait in it."""
        resume = {}
        while self._tool is not None:
            frames = sys._current_frames()
            resume = {}
            for ident in self.watched:
                if ident not in self.held and ident in frames:
                    at = self._resume_frame(frames[ident])
                    if at is not None:
                        resume[ident] = at
            new = {f.f_code for f in resume.values()} - self._stepped
            if not new:
                break
            for code in new:
                sys.monitoring.set_local_events(
                    self._tool, code, sys.monitoring.events.INSTRUCTION)
            self._stepped |= new
        self._resume, self.waiting = resume, set(resume)
        return [t.name for ident, t in self.watched.items()
                if ident not in self.held and ident not in self.waiting
                and t.is_alive()]

    def _resume_frame(self, frame):
        """Where `frame`, another thread's innermost, blocked at a wait
        site (_WAITS) or in a blocking builtin (_BLOCKING), is held once
        it wakes, at the latest: its resume frame (_past_waits), which it
        reaches holding none of the threading module's locks. None where
        it is not at such a wait, or may not be held there, or is inside
        torch.autograd's code (a backward, where it would not be held
        once woken)."""
        if not (frame.f_lasti in _WAITS.get(frame.f_code, ())
                or _blocking_call(frame)):
            return None
        frame = _past_waits(frame)
        return frame if frame is not None and self._holdable(
            frame, self._no_wait_dirs) else None

    def _holdable(self, frame, no_dirs: tuple | None = None) -> bool:
        """Whether a thread may be held in `frame` (its innermost): none
        of its frames runs code of _NO_PARK_FILES (but _THREAD_FOOT) or of
        torch.cuda (or of `no_dirs`' packages)."""
        no_dirs = self._no_park_dirs if no_dirs is None else no_dirs
        while frame is not None:
            name = frame.f_code.co_filename
            if ((name in _NO_PARK_FILES and frame.f_code not in _THREAD_FOOT)
                    or name.startswith(no_dirs)):
                return False
            frame = frame.f_back
        return True

    def release(self) -> bool:
        """Turns the events off, frees the tool id and lets the held
        threads go on; False if one went on before (EVENT_HOLD_MAX_S)."""
        if self._tool is not None:
            mon = sys.monitoring
            mon.set_events(self._tool, 0)
            for code in self._stepped:
                mon.set_local_events(self._tool, code, 0)
            for event in self._events(mon):
                mon.register_callback(self._tool, event, None)
            mon.free_tool_id(self._tool)
            self._tool = None
            self._released = True
            self._resume = {}
            self._gate.release()
        return not self.escaped

    def _hold_at_python_event(self, code, offset, *call) -> None:
        # Its name is trace.PARK_FRAME. Nothing in here runs Python but
        # this frame (no event fires inside a callback): the held frame
        # is the only one torch's Python tracer can see and not see end.
        ident = _thread.get_ident()
        if (ident not in self.watched or ident in self.held
                or self._released):
            return
        frame = sys._getframe(1)
        resume = self._resume.get(ident)
        if code is _COND_WAIT and offset in _WAKES:
            # Woken in Condition.wait, before it takes its lock again.
            frame = _past_waits(frame)
        elif (resume is not None and frame is not resume
              and frame.f_code.co_filename in _WAITING_FILES):
            # A waiting thread on its way out of the threading or queue
            # modules' code, to its resume frame.
            return
        if ((call and getattr(call[0], "__func__", call[0]) in (
                TraceClient.stop, TraceClient.__exit__))
                or not self._holdable(frame)
                or (self._graph_task is not None
                    and self._graph_task() != -1)):
            if ident in self.waiting:
                # Counted as parked, it runs Python unheld.
                self.escaped.add(ident)
            return
        self.held.add(ident)
        if self._gate.acquire(True, EVENT_HOLD_MAX_S):
            self._gate.release()
        else:
            self.escaped.add(ident)


_BUSY = "a previous capture is still open"
# A duration window (and the warmup) opens this long after its profiler's
# start has returned, and the finish trims what was recorded before
# (C15). On an H100 80GB HBM3 (700 W), in 1300 duration windows every
# launch whose kernel record a start lost was made within 55.5 ms after
# that start returned; starts took 2 ms to 4.7 s.
DURATION_LEAD_S = 0.1
# How long the warmup waits for the app to park, as every other start
# does (C17, C19): at its next step() in an app that has stepped, else
# for each of its threads to reach its next Python event (_EventPark); a
# start that goes ahead without it says "parked": false.
WARMUP_PARK_WAIT_S = 10.0
# What a synchronized duration capture allows its profiler's start: on an
# H100 80GB HBM3 (700 W) starts with the app parked took a median 19 ms,
# at most 143 ms in 300 captures of a mixed process (C17).
SYNC_START_ALLOWANCE_S = 0.25
# How many of the spans already sent to dynologd the shim keeps, so that a
# manifest written after another capture's flush still lists all of its
# capture's spans (a capture records about 15).
SENT_SPANS_KEPT = 512


class TraceClient:
    """Registers with dynologd and serves on-demand trace requests."""

    def __init__(
        self,
        job_id: int = 0,
        device: int = 0,
        endpoint: str = ipc.DAEMON_ENDPOINT,
        poll_interval_s: float = 1.0,
        profiler=None,
        step_start_timeout_s: float = 60.0,
        step_trace_timeout_s: float = 600.0,
        warmup_profiler: bool = False,
        report_interval_s: float = 10.0,
        stall_grace_s: float = 60.0,
        sweep_ttl_s: float = DEFAULT_SWEEP_TTL_S,
        ring: RingConfig | None = None,
    ):
        self.job_id = job_id
        self.device = device
        self.endpoint = endpoint
        self.poll_interval_s = poll_interval_s
        # Iteration-mode guards: how long to wait for the app to step into
        # the capture window, and for the window to end once open. A
        # timeout fails the capture loudly (error manifest + last_error)
        # instead of tracing the wrong window.
        self.step_start_timeout_s = step_start_timeout_s
        self.step_trace_timeout_s = step_trace_timeout_s
        # warmup_profiler: pay torch.profiler's one-time start-up (seconds
        # on a CPU, tens to hundreds of ms on a card) with a throwaway
        # capture on the poll thread before its first poll, so the FIRST
        # on-demand capture starts as fast as later ones. The cost is per
        # process.
        self.warmup_profiler = warmup_profiler
        self.profiler = profiler if profiler is not None else TorchProfiler()
        self._client = ipc.IpcClient()
        self._ancestry = ipc.pid_ancestry()
        self._last_subscribe = 0.0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._step_count = 0
        self._step_cv = threading.Condition()
        self._window: _Window | None = None
        # Step telemetry ("pstat"): durations between step() calls,
        # drained every report_interval_s by the poll thread. <= 0
        # disables.
        self.report_interval_s = report_interval_s
        self._step_durations: list[float] = []
        self._last_step_t: float | None = None
        self._ever_stepped = False
        self._last_report_t = time.monotonic()
        # Rate comes from the step-count delta per report, so a job whose
        # step period exceeds the report interval still has an exact rate.
        self._reported_steps = 0
        self._recent_step_s = 0.0
        # Idle span after which a job with no measured step time yet is
        # declared stalled; once a step time is known the threshold scales
        # with it.
        self.stall_grace_s = stall_grace_s
        self.sweep_ttl_s = sweep_ttl_s
        self._swept_dirs: set[str] = set()
        # Continuous capture ring: explicit config wins, else the
        # DYNO_TPU_RING_* env opts a job in with no code change.
        ring_cfg = ring if ring is not None else RingConfig.from_env()
        self.ring = (
            CaptureRing(ring_cfg) if ring_cfg.every_n_steps > 0 else None)
        # Summary children of completed captures (see _spawn_summary).
        self.summary_procs: list[subprocess.Popen] = []
        # Finisher threads of pipelined captures (_finish_pipelined), and
        # the lock that serializes the captures' manifests.
        self._finishers: list[threading.Thread] = []
        self._finish_lock = threading.Lock()
        # The last spans sent to dynologd, for later manifests (_spans_of).
        self._sent_spans: collections.deque = collections.deque(
            maxlen=SENT_SPANS_KEPT)
        self.instance_rank: int | None = None
        self.traces_completed = 0
        self.last_error: str | None = None
        self.last_manifest: dict | None = None
        # Daemon-restart ride-through: after _absent_threshold no-reply
        # polls the daemon is absent — polls back off exponentially, and
        # the first reply after an absence re-announces this pid.
        self.reconnect_backoff_max_s = 30.0
        self.daemon_reconnects = 0
        self._absent_polls = 0
        self._absent_threshold = 2
        self._need_reannounce = False
        # Set once the (optional) profiler warmup has finished; apps that
        # want the first capture at steady-state latency can wait on it.
        # warmup_timing holds the warmup's own start, stop and export ms.
        self.warmup_done = threading.Event()
        self.warmup_timing: dict = {}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> bool:
        """Registers and spawns the polling thread. False if the daemon is
        unreachable (the app keeps running untraced)."""
        # Startup sweep: reclaim what a SIGKILL'd predecessor left behind
        # before this run adds its own artifacts.
        try:
            _sweep_warmup_dirs(self.sweep_ttl_s)
            if self.ring:
                self.ring.sweep()
        except Exception as e:  # noqa: BLE001 - sweep must never kill start()
            _log.warning("startup artifact sweep failed: %s", e)
        self.instance_rank = self._client.register_context(
            self.job_id, self.device, dest=self.endpoint)
        if self.instance_rank is not None:
            # One synchronous poll so this process is in the daemon's
            # trace registry before start() returns, then opt in to kicks.
            self._client.request_config(
                self.job_id, self._ancestry, ipc.CONFIG_TYPE_ACTIVITIES,
                dest=self.endpoint)
            self._client.subscribe_kicks(self.job_id, dest=self.endpoint)
            self._last_subscribe = time.monotonic()
        self._thread = threading.Thread(
            target=self._poll_loop, name="dynolog_tpu_torch_shim",
            daemon=True)
        self._thread.start()
        return self.instance_rank is not None

    def stop(self) -> None:
        """Stops polling: a capture still open is closed by the poll
        thread that opened it, which stop() joins, and every capture
        still finishing writes its manifest first."""
        self._stop.set()
        with self._step_cv:
            self._step_cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
        for finisher in self._finishers:
            # No capture's manifest or span flush is stranded by shutdown.
            finisher.join(timeout=30)
        self._finishers = []
        self._client.close()

    def __enter__(self) -> "TraceClient":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def step(self) -> None:
        """Call once per training iteration, on the training thread: an
        iteration capture's edges are these calls (this thread parks at
        each while the poll thread starts or stops the profiler), a
        capture marks its steps here, and step-rate/latency telemetry
        counts these calls."""
        now = time.monotonic()
        with self._step_cv:
            self._step_count += 1
            if self._last_step_t is not None:
                self._step_durations.append(now - self._last_step_t)
                self._recent_step_s = now - self._last_step_t
            else:
                # Epoch-opening step: the measurement origin of the next
                # report, excluded from its count.
                self._last_report_t = now
                self._reported_steps = self._step_count
            self._ever_stepped = True
            self._last_step_t = now
            if self._window is not None:
                self._drive_window(self._window, self._step_count)
            self._step_cv.notify_all()
            count = self._step_count
        if self.ring:
            # Outside the cv (trivial counter arithmetic): arms the poll
            # thread to take a ring sample at its next tick.
            self.ring.note_step(count)

    # -- capture window (training thread, under _step_cv) ---------------

    def _drive_window(self, w: _Window, count: int) -> None:
        if w.state == "active":
            if w.lead_span is not None and count == w.start_at:
                # The lead step's end (C15): its span ends here.
                w.lead_span.dur_us = max(
                    int(time.time() * 1e6) - w.lead_span.start_us, 0)
                obs.JOURNAL.record(w.lead_span)
                w.timing["lead_ms"] = _ms(w.lead_span)
            self.profiler.step()
        if w.state == "armed" and count >= w.start_at - w.lead:
            w.state = "opening"
        elif (w.state == "active" and w.end_at is not None
              and count >= w.end_at):
            w.state = "closing"
        else:
            return
        # The poll thread starts every capture's profiler, and stops an
        # iteration window's, while this thread, the one that launches the
        # app's work, is parked here (C17: on an H100 80GB HBM3 at 700 W,
        # processes that mixed iteration and duration windows lost every
        # kernel record for good from a capture whose start met a launch
        # from another thread, after 35-381 captures, whichever thread
        # started the iteration windows; with every start parked, 600 ran
        # clean). An iteration window's edges stay these step() calls.
        self._step_cv.notify_all()
        with obs.span("shim.step_held", ctx=w.ctx):
            self._step_cv.wait_for(
                lambda: w.state not in ("opening", "closing"))

    def _stop_profiler(self, w: _Window, state: str) -> None:
        with obs.span("shim.profiler_stop") as span:
            try:
                self.profiler.stop()
            except Exception as e:  # noqa: BLE001 - never kill the app
                w.error = w.error or f"profiler stop failed: {e}"
        w.timing["profiler_stop_ms"] = _ms(span)
        w.state = state

    # -- poll thread -----------------------------------------------------

    def _warmup(self) -> None:
        """One throwaway capture on the poll thread at the default levels,
        into a temp dir removed after it; a failure lands in last_error
        and polling goes on. The app stays parked from before the
        profiler's start to after its stop, the card drained before the
        start: the process's first profiler session meets no launch and
        no kernel in flight. An app that has stepped parks at its next
        step() (waited for at most WARMUP_PARK_WAIT_S), any other at its
        threads' next Python event (_EventPark, its threads waited for at
        most WARMUP_PARK_WAIT_S). It leaves no capture behind: export()
        takes the stopped one, and the next start() makes its own step
        clock. Its spans lie under a shim.warmup of a trace-id of its own."""
        tmp = tempfile.mkdtemp(prefix=WARMUP_PREFIX)
        try:
            with obs.span("shim.warmup"):
                window = _Window(tmp, 0, None)
                # C18: on an H100 80GB HBM3 (700 W), fresh processes of the
                # dense trainer died (SIGABRT) in their first profiler
                # session when it met the app's launches: 1 of 20 with the
                # warmup started at once, 1 of 20 and 3 of 20 with it
                # started with the app parked at its first step() but
                # stopped while the app went on (the aborts were in the
                # stop), 0 of 20 with the card drained first; 0 of 40 with
                # the app parked through the start and stop and the card
                # drained first (this code).
                if self._start_parked(
                        window,
                        WARMUP_PARK_WAIT_S if self._ever_stepped else 0.0,
                        hold=True, event_wait_s=WARMUP_PARK_WAIT_S) is None:
                    return  # stopped while it waited for the park
                with obs.span("shim.profiler_stop") as stop:
                    try:
                        self.profiler.stop()
                    finally:
                        self._drop_window(window)
                with obs.span("shim.export") as export:
                    self.profiler.export(tmp)
            self.warmup_timing = {
                **window.timing,
                "profiler_stop_ms": _ms(stop),
                "export_ms": _ms(export),
                "lost_launches": getattr(self.profiler, "last_finish",
                                         {}).get("lost_launches")}
        except Exception as e:  # noqa: BLE001 - warmup must never kill polling
            self.last_error = f"profiler warmup failed: {e}"
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _start_parked(self, window: _Window, wait_s: float,
                      hold: bool = False,
                      event_wait_s: float | None = None) -> float | None:
        """Makes `window` (a duration window, or the warmup's) the
        client's window and starts the profiler for it on this (the poll)
        thread, with a lead, once the app is parked (C17, C19): at the
        training thread's next step() (see _drive_window), waited for at
        most `wait_s`; where no step() came, at its threads' next Python
        event (_EventPark, each waited for at most `event_wait_s`, by
        default EVENT_PARK_WAIT_S). The window's timing says whether it
        was ``parked``, by which ``park`` ("step" or "event"; None where
        it was not), how long it waited for the park (``park_ms``), the
        threads the event park counted as parked while they waited on
        another thread (``waiting``) and, where a thread was not held,
        its name (``unparked``). With `hold` (the warmup) the card is
        drained first (``drain_ms``) and the app stays parked after the start
        (its training thread parks at its next step() where it was not),
        until the caller stops the window and releases its park
        (_release_park). Returns the time the start returned, the window
        in its lead, or None where another window is open or stop() came
        during the wait (called before, it starts at once, unparked). A
        failed start raises, and leaves no window."""
        with self._step_cv:
            if self._window is not None:
                return None
            window.start_at = self._step_count + 1
            self._window = window
        # After stop() (a test that runs the warmup alone) the start goes
        # ahead at once.
        waits = not self._stop.is_set()
        try:
            with obs.span("shim.park") as park:
                with self._step_cv:
                    if waits and wait_s > 0:
                        self._step_cv.wait_for(
                            lambda: (window.state != "armed"
                                     or self._stop.is_set()),
                            timeout=wait_s)
                    if waits and window.state == "armed":
                        window.state = "parking"  # step() leaves it alone
                if window.state == "parking" and not self._stop.is_set():
                    # Outside the step lock: a thread inside step() must be
                    # able to leave it and reach its next event.
                    window.park = _EventPark()
                    parked = window.park.hold(
                        EVENT_PARK_WAIT_S if event_wait_s is None
                        else event_wait_s, self._stop)
                    window.timing.update(parked=parked,
                                         park="event" if parked else None)
                    if not parked:
                        window.timing["unparked"] = window.park.unheld()
                    if window.park.waiting:
                        window.timing["waiting"] = sorted(
                            window.park.watched[i].name
                            for i in window.park.waiting)
                else:
                    parked = window.state == "opening"
                    window.timing.update(parked=parked,
                                         park="step" if parked else None)
        except BaseException:
            self._drop_window(window)
            raise
        window.timing["park_ms"] = _ms(park)
        with self._step_cv:
            if waits and self._stop.is_set():
                self._drop_window(window)
                return None
            try:
                if hold and hasattr(self.profiler, "drain"):
                    with obs.span("shim.drain") as drain:
                        self.profiler.drain(self.device)
                    window.timing["drain_ms"] = _ms(drain)
                with obs.span("shim.profiler_start") as start:
                    self.profiler.start(window.trace_dir, lead=True)
                    if not hold:
                        window.state = "lead"
                        self._step_cv.notify_all()
                        self._release_park(window)
            except BaseException:
                self._drop_window(window)
                raise
            window.timing["profiler_start_ms"] = _ms(start)
        return (start.start_us + start.dur_us) / 1e6

    def _drop_window(self, window: _Window) -> None:
        """Ends `window` (the warmup's after its stop, any other before
        its start): the app's step() goes on, and its park lets go."""
        with self._step_cv:
            self._window = None
            window.state = "stopped"
            self._step_cv.notify_all()
        self._release_park(window)

    def _release_park(self, window: _Window) -> None:
        """Lets the threads the window's event park holds go on; where
        one went on before (EVENT_HOLD_MAX_S), the window was not parked
        throughout."""
        if window.park is not None and not window.park.release():
            window.timing.update(parked=False, park=None)

    def _park_wait_s(self) -> float:
        """How long a synchronized start allows for the training thread
        to park at its next step(): two of its recent steps, at least
        0.1 s and at most step_start_timeout_s; none in an app that never
        stepped."""
        if not self._ever_stepped:
            return 0.0
        return min(max(2 * self._recent_step_s, 0.1),
                   self.step_start_timeout_s)

    def _park_bound_s(self) -> float:
        """How long a duration start waits for the training thread to park
        at its next step(): step_start_timeout_s, as long as an iteration
        window waits for its first step, in an app that has stepped, so
        that a long step (an eval's, a checkpoint's) is waited out; none
        in an app that never stepped, whose start parks its threads at
        their next Python event instead, as one does where this wait ran
        out (C17: on an H100 80GB HBM3 at 700 W, a process whose starts
        went ahead unparked where a wait of two recent steps ran out lost
        the kernel records of its autograd thread's launches for good
        after 199 captures; C19: one that never stepped lost its training
        thread's from its 54th capture)."""
        return self.step_start_timeout_s if self._ever_stepped else 0.0

    def _poll_loop(self) -> None:
        if self.warmup_profiler:
            self._warmup()
        self.warmup_done.set()
        while not self._stop.is_set():
            try:
                text = self._client.request_config(
                    self.job_id, self._ancestry, ipc.CONFIG_TYPE_ACTIVITIES,
                    dest=self.endpoint,
                    # Short ladders: absence is ridden out by the backoff
                    # in _wait_for_tick, not inside one send.
                    retries=2 if self._absent_polls else 4)
            except OSError as e:  # daemon went away; keep trying
                self.last_error = str(e)
                text = None
            if text is None:
                self._absent_polls += 1
                if self._absent_polls == self._absent_threshold:
                    _log.warning(
                        "dynolog daemon unreachable; polling with backoff "
                        "(up to %.0fs) until it returns",
                        self.reconnect_backoff_max_s)
            else:
                # Any reply is daemon liveness; after an absence the
                # daemon may have restarted and lost this registration.
                if self._absent_polls:
                    self._need_reannounce = True
                self._absent_polls = 0
                if self._need_reannounce and self._reannounce():
                    self._need_reannounce = False
            if not text:
                # A late reply to a timed-out request still carries a
                # config the daemon already cleared: capture it.
                text = self._client.take_late_config()
            if text:
                try:
                    self._run_trace(TraceConfig.parse(text), pipelined=True)
                except Exception as e:  # noqa: BLE001 - never kill the app
                    self.last_error = f"trace failed: {e}"
            try:
                self._maybe_report_stats()
            except Exception as e:  # noqa: BLE001 - telemetry must never
                # kill the poll thread
                self.last_error = f"stats report failed: {e}"
            if self.ring and self.ring.due() and not text:
                # Ring sample on an idle tick only: an on-demand capture
                # that just ran owns this window. CaptureRing.capture
                # contains its own failures (last_error on the ring).
                self.ring.capture(self._ring_sample)
                if self.ring.last_error:
                    self.last_error = self.ring.last_error
            # Kick-subscription keep-alive (the daemon expires stale ones).
            if time.monotonic() - self._last_subscribe > 30.0:
                self._client.subscribe_kicks(self.job_id, dest=self.endpoint)
                self._last_subscribe = time.monotonic()
            self._wait_for_tick()

    def _wait_for_tick(self) -> None:
        """Sleep until the next poll, or until the daemon kicks (sliced at
        200 ms to keep stop() prompt); back off while the daemon is
        absent."""
        interval = self.poll_interval_s
        if self._absent_polls >= self._absent_threshold:
            interval = min(
                self.poll_interval_s *
                (2 ** min(self._absent_polls - self._absent_threshold + 1,
                          20)),
                self.reconnect_backoff_max_s)
        deadline = time.monotonic() + interval
        while not self._stop.is_set():
            left = deadline - time.monotonic()
            if left <= 0:
                return
            if self._client.wait_for_kick(min(left, 0.2)):
                return

    def _reannounce(self) -> bool:
        """Re-registers this pid after the daemon came back; True once the
        daemon confirmed it."""
        try:
            rank = self._client.register_context(
                self.job_id, self.device, dest=self.endpoint)
            if rank is None:
                self.last_error = "re-announce: no reply to register_context"
                return False
            self.instance_rank = rank
            self._client.subscribe_kicks(self.job_id, dest=self.endpoint)
            self._last_subscribe = time.monotonic()
        except OSError as e:
            self.last_error = str(e)
            return False
        self.daemon_reconnects += 1
        _log.info("dynolog daemon is back (ride-through #%d); pid "
                  "re-announced", self.daemon_reconnects)
        return True

    def _maybe_report_stats(self) -> None:
        if self.report_interval_s <= 0:
            return
        with self._step_cv:
            if not self._ever_stepped:
                # No step() ever: publish nothing (a permanent zero-rate
                # series would misfire step-rate auto-triggers).
                return
        now = time.monotonic()
        window_s = now - self._last_report_t
        if window_s < self.report_interval_s:
            return
        with self._step_cv:
            durations = self._step_durations
            self._step_durations = []
            steps = self._step_count - self._reported_steps
            if steps == 0:
                # An empty window is a stall only once the idle span
                # dwarfs both the report interval and the recent step
                # time (or the stall grace, before any step time is known).
                threshold = max(
                    2 * self.report_interval_s,
                    4 * self._recent_step_s
                    if self._recent_step_s > 0 else self.stall_grace_s)
                if (self._last_step_t is not None
                        and now - self._last_step_t <= threshold):
                    return
                # Stalled: close the stepping epoch (the next step opens a
                # fresh window) and report the zero rate.
                self._last_step_t = None
                self._recent_step_s = 0.0
            self._reported_steps = self._step_count
        self._last_report_t = now
        if steps == 0:
            self._client.send_perf_stats(self.job_id, window_s, 0,
                                         dest=self.endpoint)
            return
        kwargs: dict = {}
        if durations:
            durations.sort()

            def pctl(p: float) -> float:
                # Nearest-rank, like the daemon's MetricStore stats.
                k = max(math.ceil(p * len(durations)), 1)
                return durations[min(k - 1, len(durations) - 1)]

            kwargs = dict(p50_ms=pctl(0.50) * 1000.0,
                          p95_ms=pctl(0.95) * 1000.0,
                          max_ms=durations[-1] * 1000.0)
        self._client.send_perf_stats(self.job_id, window_s, steps,
                                     dest=self.endpoint, **kwargs)

    # -- one capture (poll thread) ---------------------------------------

    def _ring_sample(self, trace_dir: str) -> tuple:
        """One ring window, a duration capture on this (the poll) thread,
        saved into `trace_dir`. Returns the trace (its PendingWrite, whose
        finish also writes the compact profile, where the profiler hands
        one over, else its path) and the window's timing with the save's
        export_ms."""
        error, _, timing, trace_file, pending = self._capture(
            TraceConfig(duration_ms=self.ring.config.window_ms), trace_dir,
            profile_top=self.ring.config.top_ops)
        if error:
            raise RuntimeError(error)
        return pending or trace_file, timing

    def _capture(self, cfg: TraceConfig, trace_dir: str,
                 ctx: obs.TraceContext | None = None, **kw) -> tuple:
        """One capture's work on this (the poll) thread, under a
        shim.capture span whose parent is `ctx` (else the ambient span):
        its window and, where that ran clean, the save (shim.export; `kw`
        goes to the profiler's export). Returns (error or None, window,
        its timing with the save's export_ms and, where the save left no
        finish, the trace's trace_bytes and lost_launches, the trace path
        or None, its PendingWrite or None)."""
        trace_file = pending = None
        with obs.span("shim.capture", ctx=ctx):
            error, window = self._capture_window(cfg, trace_dir)
            timing = dict(window.timing)
            if error is None:
                try:
                    with obs.span("shim.export") as export:
                        trace_file, pending = self._export(trace_dir, **kw)
                    timing["export_ms"] = _ms(export)
                    if pending is None:
                        timing["trace_bytes"] = os.path.getsize(trace_file)
                        timing["lost_launches"] = getattr(
                            self.profiler, "last_finish", {}).get(
                                "lost_launches")
                except Exception as e:  # noqa: BLE001 - fails the capture
                    error = f"trace export failed: {e}"
        return error, window, timing, trace_file, pending

    def _export(self, trace_dir: str, **kw) -> tuple:
        """The stopped capture's save: (trace path, its PendingWrite or
        None where the trace is complete as saved). A profiler without
        take_pending_write (RecordingProfiler) exports in full."""
        take = getattr(self.profiler, "take_pending_write", None)
        if take is None:
            return self.profiler.export(trace_dir), None
        return self.profiler.export(trace_dir, pipelined=True, **kw), take()

    def _run_trace(self, cfg: TraceConfig, pipelined: bool = False) -> None:
        """One capture, to its manifest. The poll loop runs it
        `pipelined`: where the trace needs a finish, a finisher thread
        waits on it and writes the manifest, and this returns once kineto
        has saved the trace; otherwise the manifest is written before it
        returns."""
        # Fault drill: shim.run_trace=throw proves the poll loop contains
        # a capture-path crash (last_error set, polling continues).
        failpoints.fire("shim.run_trace")
        pid = os.getpid()
        trace_dir = cfg.trace_dir(pid)
        # First capture against this trace base: reclaim expired debris
        # carrying this base's name prefix before writing next to it.
        base = os.path.abspath(trace_dir)[: -len(f"_{pid}")]
        if base not in self._swept_dirs:
            self._swept_dirs.add(base)
            try:
                sweep_stale_artifacts(base, self.sweep_ttl_s)
            except Exception as e:  # noqa: BLE001 - never costs the capture
                _log.warning("artifact sweep of %s failed: %s", base, e)
        os.makedirs(trace_dir, exist_ok=True)
        if hasattr(self.profiler, "configure"):
            # This capture's knobs (tracer levels, TRACE_JSON), before its
            # window is armed; unknown keys are ignored.
            self.profiler.configure(cfg.raw)
        ctx = obs.TraceContext.parse(cfg.trace_ctx) or obs.TraceContext.mint()
        received_ms = int(time.time() * 1000)
        if cfg.start_time_ms > 0:
            # Synchronized start across hosts: a duration window's
            # profiler starts early enough for the wait for the training
            # thread to park, the start and the lead to end by the start
            # time, where the window opens.
            early_s = 0.0 if cfg.iterations > 0 else (
                DURATION_LEAD_S + SYNC_START_ALLOWANCE_S
                + self._park_wait_s())
            delay = cfg.start_time_ms / 1000.0 - early_s - time.time()
            if delay > 0:
                time.sleep(delay)
        error, window, timing, trace_file, pending = self._capture(
            cfg, trace_dir, ctx)
        timing = {"received_ms": received_ms, **timing}
        args = (cfg, pid, trace_dir, trace_file, window.started_ms, error,
                timing, ctx)
        if pending is None:
            self._finish_trace(*args)
        elif not pipelined:
            self._finish_pipelined(pending, *args)
        else:
            # The poll loop goes back to serving configs while the finish
            # child runs; the finisher owns this capture's manifest.
            finisher = threading.Thread(
                target=self._finish_pipelined, args=(pending, *args),
                name="dynolog_tpu_torch_trace_finisher", daemon=True)
            finisher.start()
            self._finishers = [
                t for t in self._finishers if t.is_alive()] + [finisher]

    def _finish_pipelined(self, pending: PendingWrite, cfg, pid, trace_dir,
                          trace_file, started_ms, error, timing, ctx
                          ) -> None:
        """A capture's tail once its trace is saved: waits out the finish,
        folds its write_ms and write_bytes into the manifest's timing
        (trace_bytes: the finished trace's) and writes the manifest. A
        failed finish fails the capture loudly; it left no trace or tmp
        behind."""
        try:
            done = pending.wait()
            write_error = done.pop("write_error", None)
            timing.update(done)
            if "write_bytes" in done:
                timing["trace_bytes"] = done["write_bytes"]
            self._finish_trace(cfg, pid, trace_dir, trace_file, started_ms,
                               error or write_error, timing, ctx)
        except Exception as e:  # noqa: BLE001 - the finisher must never die
            # silently: the manifest is the completion signal.
            self.last_error = f"trace finalize failed: {e}"

    def _capture_window(self, cfg: TraceConfig, trace_dir: str):
        """Runs one capture's window; returns (error or None, window). A
        duration window runs here, on the poll thread, as the JAX shim's
        does: start, sleep, stop, whether or not the app steps. The
        window opens DURATION_LEAD_S after its profiler's start
        returned (at a synchronized start time where that is later): its
        started_ms, window_ms and steps count from there, and the finish
        trims the lead."""
        if cfg.iterations > 0:
            return self._iteration_window(cfg, trace_dir)
        window = _Window(trace_dir, 0, None)
        try:
            started = self._start_parked(window, self._park_bound_s())
        except Exception as e:  # noqa: BLE001 - fails the capture
            return f"profiler start failed: {e}", window
        if started is None:
            return ("trace aborted: client stopped" if self._stop.is_set()
                    else _BUSY), window
        # The window opens a lead after the start returned, or at the start
        # time where one is set and later.
        opens_at = max(started + DURATION_LEAD_S, cfg.start_time_ms / 1000.0)
        with obs.span("shim.lead") as lead:
            stopped = self._stop.wait(max(opens_at - time.time(), 0.0))
        window.timing["lead_ms"] = _ms(lead)
        # An app held at its next Python event for the start is held so
        # for the stop too (C21): on an H100 80GB HBM3 (700 W), 2 of 14
        # fresh processes of an app that never steps hung in their first
        # capture's stop, torch's _disable_profiler against the app's
        # loss.backward().
        park = _EventPark() if window.timing.get("park") == "event" else None
        try:
            with obs.span("shim.window") as span:
                if not stopped:
                    # The window's opening, on the clock of its span.
                    opened_ns = span.start_us * 1000
                    self.profiler.open_window(opened_ns)
                    window.started_ms = opened_ns // 10**6
                    with self._step_cv:
                        window.state = "active"  # step() marks steps now
                    stopped = self._stop.wait(cfg.duration_ms / 1000.0)
                with self._step_cv:
                    self._window = None
                if park is not None:
                    with obs.span("shim.stop_park") as held:
                        window.timing["stop_parked"] = park.hold(
                            EVENT_PARK_WAIT_S, self._stop)
                    window.timing["stop_park_ms"] = _ms(held)
            window.timing["window_ms"] = _ms(span)
            self._stop_profiler(window, "stopped")
        finally:
            if park is not None and not park.release():
                window.timing["stop_parked"] = False
        return ("trace aborted: client stopped" if stopped
                else window.error), window

    def _iteration_window(self, cfg: TraceConfig, trace_dir: str):
        """Arms an iteration window, opens its profiler here once the
        training thread has parked at the window's lead boundary and
        closes it once that thread has parked at the window's end;
        returns (error or None, window)."""
        with self._step_cv:
            base = self._step_count
            # The next roundup boundary STRICTLY after the current step:
            # the window always begins at a future iteration.
            roundup = max(cfg.iteration_roundup, 1)
            start_at = ((base // roundup) + 1) * roundup
            lead = 1 if getattr(self.profiler, "lead_step", False) else 0
            if start_at - lead <= base:
                # The lead step's step() has passed (always at roundup
                # 1): the window moves to the next boundary, so that it
                # still has its lead.
                start_at += roundup
            window = _Window(trace_dir, start_at, start_at + cfg.iterations,
                             lead)
            if self._window is not None:
                return (_BUSY, window)
            self._window = window
            with obs.span("shim.park") as park:
                opened = self._step_cv.wait_for(
                    lambda: window.state != "armed" or self._stop.is_set(),
                    timeout=self.step_start_timeout_s)
            window.timing["park_ms"] = _ms(park)
            if window.state == "armed":
                self._window = None
                # The step named is the one that opens the profiler.
                return (f"trace aborted: app did not reach step "
                        f"{window.start_at - window.lead} within "
                        f"{self.step_start_timeout_s:g}s (at "
                        f"{self._step_count})"
                        if not opened else "trace aborted: client stopped",
                        window)
            try:
                with obs.span("shim.profiler_start") as start:
                    if lead:
                        self.profiler.start(trace_dir, lead=True)
                    else:
                        self.profiler.start(trace_dir)
            except Exception as e:  # noqa: BLE001 - fails the capture
                self._window = None
                window.state = "stopped"
                self._step_cv.notify_all()
                return f"profiler start failed: {e}", window
            window.timing["profiler_start_ms"] = _ms(start)
            # At the lead boundary's step().
            window.timing.update(parked=True, park="step")
            window.started_ms = start.start_us // 1000
            limit = self.step_trace_timeout_s
            # window_ms counts from the start's return: the lead step
            # (shim.lead, C15) lies inside it.
            with obs.span("shim.window") as span:
                if lead:
                    window.lead_span = obs.Span(
                        "shim.lead", span.trace_id, obs.mint_id(),
                        span.span_id, int(time.time() * 1e6), 0)
                window.state = "active"
                self._step_cv.notify_all()
                closed = self._step_cv.wait_for(
                    lambda: window.state != "active" or self._stop.is_set(),
                    timeout=limit)
            window.timing["window_ms"] = _ms(span)
            timed_out = window.state == "active"
            # Closed here whether the training thread parked at its end or
            # the window timed out; its next step() finds no window.
            self._stop_profiler(window, "stopped")
            self._window = None
            self._step_cv.notify_all()
            if timed_out:
                return (f"trace timed out: the window did not close within "
                        f"{limit:g}s (at step {self._step_count})"
                        if not closed else "trace aborted: client stopped",
                        window)
            return window.error, window

    def _finish_trace(self, cfg, pid, trace_dir, trace_file, started_ms,
                      error, timing, ctx) -> None:
        """Writes the manifest at the path dyno prints (log_file_<pid>.json):
        status is "ok" only if the Chrome trace is on disk, as in the JAX
        shim; a trace whose window lost kernel records (its timing's
        lost_launches above 0) is ok, and last_error says what it lost.
        Finishers and the poll thread write their captures' manifests one
        at a time."""
        with self._finish_lock:
            if error is None and not (
                    trace_file and os.path.exists(trace_file)):
                error = "capture produced no trace file"
            manifest = {
                "pid": pid,
                "job_id": self.job_id,
                "trace_dir": trace_dir,
                "trace_file": trace_file,
                "started_ms": started_ms,
                "ended_ms": int(time.time() * 1000),
                "mode": "iterations" if cfg.iterations > 0 else "duration",
                "config": cfg.raw,
                "status": "error" if error else "ok",
                "timing": timing,
                "trace_ctx": ctx.header(),
                "spans": self._spans_of(ctx),
            }
            if error:
                manifest["error"] = error
                self.last_error = error
            elif timing.get("lost_launches"):
                self.last_error = (
                    f"capture {trace_file}: {timing['lost_launches']} "
                    "launches in its window have no kernel record")
            # Atomic: the manifest's existence IS the completion signal.
            # A refused write (ENOSPC, or the trace.artifact.write drill)
            # leaves nothing behind and lands in last_error.
            wrote = False
            with obs.span("shim.artifact_write", ctx=ctx):
                try:
                    failpoints.fire("trace.artifact.write")
                    stream_write(cfg.manifest_path(pid),
                                 [json.dumps(manifest, indent=2).encode()])
                    wrote = True
                except OSError as e:
                    self.last_error = f"manifest write refused: {e}"
            self.last_manifest = manifest
            if wrote and not error:
                self.traces_completed += 1
                if getattr(self.profiler, "export_trace_json", True):
                    self._spawn_summary(trace_file, ctx)
            # Ship this capture's spans to the daemon (fire-and-forget).
            sent = obs.JOURNAL.drain()
            self._sent_spans.extend(sent)
            try:
                self._client.send_spans(sent, dest=self.endpoint)
            except OSError as e:
                self.last_error = f"span flush failed: {e}"

    def _spans_of(self, ctx) -> list[dict]:
        """The spans recorded so far under `ctx`'s trace-id, still in the
        journal or sent at an earlier manifest, as Chrome-trace events in
        the order they began (every span of a capture but its
        shim.artifact_write). Under _finish_lock."""
        events = [s.chrome_event()
                  for s in (*self._sent_spans, *obs.JOURNAL.snapshot())
                  if s.trace_id == ctx.trace_id]
        return sorted(events, key=lambda e: e["ts"])

    def _spawn_summary(self, trace_file: str, ctx) -> None:
        """Writes <run>.summary.json beside a completed capture's trace
        in a child process at nice 19: summarizing is seconds of
        pure-Python work that in-process would take the GIL from the
        training loop, and a crash there must cost only the summary. It
        starts after the manifest, so the capture's latency does not
        include it. The child records a trace.convert span under the
        capture's context and flushes it to the daemon."""
        env = _child_env()
        env[obs.ENV_TRACE_CTX] = ctx.header()
        env[obs.ENV_FLUSH_ENDPOINT] = self.endpoint
        code = ("import os; os.nice(19); "
                "from dynolog_tpu_torch.trace import write_derived_artifacts; "
                f"write_derived_artifacts({trace_file!r})")
        try:
            if failpoints.fire("shim.export_spawn"):
                raise OSError("failpoint shim.export_spawn")
            proc = subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
        except OSError as e:  # the capture is complete without it
            _log.warning("summary child not started for %s: %s",
                         trace_file, e)
            return
        self.summary_procs = [
            p for p in self.summary_procs if p.poll() is None] + [proc]
        # Reap without blocking anything (wait() releases the GIL).
        threading.Thread(target=proc.wait, daemon=True,
                         name="dynolog_tpu_torch_summary_reaper").start()
