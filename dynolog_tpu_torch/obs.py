"""Control-plane self-tracing — the PyTorch shim's half.

A copy of the parts of ``dynolog_tpu/obs.py`` the port's shim and its
cluster fan-out (``cluster.unitrace``, ``cluster.rpc``) use, so the port
imports nothing of the JAX package:

- ``TraceContext``: the 64-bit trace-id/span-id pair naming one
  control-plane request across the daemon and its clients. The daemon
  injects it into the on-demand config as ``TRACE_CONTEXT=...``; the shim
  parses it back out. The header spelling ("%016x/%016x") is pinned by
  both sides' tests. unitrace mints one per invocation (``set_current``)
  and stamps each host's request with a ``child`` of it.
- ``SpanJournal`` / ``span()``: a bounded ring of completed spans plus a
  context manager that times a section and records it. The shim flushes
  the ring to the daemon over the fire-and-forget ``"span"`` IPC datagram,
  so ``dyno selftrace`` shows the daemon's and the shim's spans together.
- ``from_env`` / ``flush_spans`` / ``maybe_flush_env``: how a child process
  (the diagnose CLI, the shim's summary child) joins the request that
  started it. It reads its parent's context from ``$DYNO_TRACE_CTX`` and
  flushes its spans to the daemon named by ``$DYNO_OBS_ENDPOINT`` on exit.

Stdlib only, and injectable (``now``), so tests drive time synthetically.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from dataclasses import dataclass, field

# The on-demand config key carrying the context daemon -> shim
# (src/core/SpanJournal.h kTraceContextConfigKey).
CONFIG_KEY = "TRACE_CONTEXT"
# Environment hand-off to child processes: the parent's context, and the
# daemon IPC endpoint the child flushes its spans to.
ENV_TRACE_CTX = "DYNO_TRACE_CTX"
ENV_FLUSH_ENDPOINT = "DYNO_OBS_ENDPOINT"
# Wire limit for span names (src/tracing/IPCMonitor.h ClientSpan.name,
# NUL terminator included).
NAME_BYTES = 48


def mint_id() -> int:
    """Fresh nonzero 64-bit id (the C++ side uses the same range)."""
    while True:
        v = random.getrandbits(64)
        if v:
            return v


@dataclass(frozen=True)
class TraceContext:
    """One request's identity: trace_id names the request, span_id the
    sender's span (the parent of whatever the receiver does with it)."""

    trace_id: int
    span_id: int

    def header(self) -> str:
        return f"{self.trace_id:016x}/{self.span_id:016x}"

    def child(self) -> "TraceContext":
        """Same trace, fresh span-id — what a caller hands downstream."""
        return TraceContext(self.trace_id, mint_id())

    @classmethod
    def mint(cls) -> "TraceContext":
        return cls(mint_id(), mint_id())

    @classmethod
    def parse(cls, text: str) -> "TraceContext | None":
        """Exactly '<16 hex>/<16 hex>' (the C++ parser is byte-identical);
        anything else — wrong length, stray chars, zero trace-id — is
        None, never an exception (the field arrives from the network)."""
        if not isinstance(text, str) or len(text) != 33 or text[16] != "/":
            return None
        try:
            trace_id = int(text[:16], 16)
            span_id = int(text[17:], 16)
        except ValueError:
            return None
        if trace_id == 0:
            return None
        return cls(trace_id, span_id)


@dataclass
class Span:
    """One completed span (field-compatible with the C++ journal's)."""

    name: str
    trace_id: int
    span_id: int
    parent_id: int
    start_us: int
    dur_us: int
    pid: int = field(default_factory=os.getpid)


class SpanJournal:
    """Bounded ring of completed spans. Thread-safe; oldest entries are
    overwritten (a flight recorder, like the C++ ring). ``drain()`` hands
    the contents to a flusher exactly once."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._capacity = max(int(capacity), 0)
        self._spans: list[Span] = []
        self.recorded = 0

    def record(self, span: Span) -> None:
        if self._capacity == 0:
            return
        with self._lock:
            self.recorded += 1
            self._spans.append(span)
            if len(self._spans) > self._capacity:
                del self._spans[: len(self._spans) - self._capacity]

    def drain(self) -> list[Span]:
        with self._lock:
            spans, self._spans = self._spans, []
            return spans


#: Process-wide journal — the shim records here and drains it toward the
#: daemon after each capture.
JOURNAL = SpanJournal()

_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "dynolog_tpu_torch_trace_ctx", default=None)


def current() -> TraceContext | None:
    """The ambient trace context, if any (set_current/span manage it)."""
    return _current.get()


def set_current(ctx: TraceContext | None) -> None:
    _current.set(ctx)


def from_env(environ=None) -> TraceContext | None:
    """Context handed to this process via $DYNO_TRACE_CTX (a child
    process's inheritance path)."""
    return TraceContext.parse((environ or os.environ).get(ENV_TRACE_CTX, ""))


@contextlib.contextmanager
def span(
    name: str,
    ctx: TraceContext | None = None,
    journal: SpanJournal | None = None,
    now=time.time,
):
    """Times a section and records it on exit (exceptions included — a
    failing capture's span is exactly the interesting one). The section
    runs with the ambient context set to THIS span (same trace, this
    span-id as parent), so nested spans parent correctly. Yields the
    recorded-on-exit Span (ids valid inside the block; timing filled at
    exit)."""
    parent = ctx if ctx is not None else current()
    rec = Span(
        name=name[: NAME_BYTES - 1],
        trace_id=parent.trace_id if parent else mint_id(),
        span_id=mint_id(),
        parent_id=parent.span_id if parent else 0,
        start_us=int(now() * 1e6),
        dur_us=0,
    )
    token = _current.set(TraceContext(rec.trace_id, rec.span_id))
    try:
        yield rec
    finally:
        _current.reset(token)
        rec.dur_us = max(int(now() * 1e6) - rec.start_us, 0)
        (journal if journal is not None else JOURNAL).record(rec)


def flush_spans(
    endpoint: str, journal: SpanJournal | None = None
) -> int:
    """Drains the journal and sends each span to the daemon's IPC
    endpoint as a fire-and-forget "span" datagram (the daemon merges
    them into its own ring for `selftrace`). Best-effort: a dead daemon
    costs nothing but the drained spans. Returns the count sent."""
    journal = journal if journal is not None else JOURNAL
    spans = journal.drain()
    if not spans:
        return 0
    from dynolog_tpu_torch.client import ipc  # lazy: obs stays stdlib-only

    try:
        with ipc.IpcClient() as client:
            return client.send_spans(spans, dest=endpoint)
    except OSError:
        return 0  # no socket dir / bind failure: self-tracing is best-effort


def maybe_flush_env(journal: SpanJournal | None = None) -> int:
    """flush_spans() toward $DYNO_OBS_ENDPOINT when set (a child
    process's exit path); no-op otherwise."""
    endpoint = os.environ.get(ENV_FLUSH_ENDPOINT)
    if not endpoint:
        return 0
    return flush_spans(endpoint, journal)
