"""Bounded chunk pipeline and atomic artifact writes for the port (a copy
of ``dynolog_tpu/stream.py`` plus ``stream_write`` from
``dynolog_tpu/trace.py``).

The capture pipeline's unit of flow is a byte chunk (~1MB): a producer
feeds chunks into a bounded queue and a writer drains them into
`stream_write` (tmp + rename) while the producer keeps going; the same
chunk discipline rides the wire, where the daemon's fetchTrace verb
streams artifacts as CHUNK/END frames. The pieces:

- `stream_write`: the atomic chunked file write every artifact of the
  port goes through (the shim's manifest, summaries, diagnosis reports);
- `chunk_views`: zero-copy memoryview slices of a collected buffer;
- `BoundedChunkQueue`: single-producer/single-consumer queue with
  close/fail/abandon semantics — backpressure bounds memory to
  max_chunks x chunk size, a dead consumer can never wedge the
  producer, and a producer failure surfaces at the consumer as
  `StreamFailed` (so `stream_write`'s tmp-cleanup discipline fires
  instead of renaming a short artifact into place);
- `fanout`: one chunk iterable to N sinks, each in its own thread and
  failure domain, paced by the slowest LIVE sink.

The shim keeps writing the trace file torch.profiler's
``export_chrome_trace`` makes; it has no in-memory profile buffer to
stream off the training thread (see ROADMAP.md on ``PendingWrite``).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

# Default chunk size: large enough that a multi-MB trace is a handful
# of queue hops, small enough that the first bytes hit their sink while
# later ones are still being produced.
CHUNK_BYTES = 1 << 20

_CLOSE = object()


class StreamFailed(Exception):
    """The producer side of a chunk stream failed; the bytes consumed so
    far are a prefix, not the artifact."""


def chunk_views(data, chunk_bytes: int = CHUNK_BYTES):
    """Zero-copy chunk iterator over an in-memory buffer (the shape
    a collector hands over, e.g. a file read whole)."""
    view = memoryview(data)
    for i in range(0, len(view), chunk_bytes):
        yield view[i:i + chunk_bytes]


class BoundedChunkQueue:
    """Bounded chunk hand-off between one producer and one consumer.

    Producer calls ``put`` per chunk (blocks on backpressure; returns
    False once the consumer abandoned — stop producing), then ``close``;
    on failure it calls ``fail(exc)`` instead. The consumer just
    iterates: chunks arrive in order, iteration ends at close, and a
    producer failure re-raises as ``StreamFailed`` AT THE CONSUMER — so
    a sink like ``stream_write`` unwinds through its own
    tmp-cleanup instead of finalizing a truncated artifact. The consumer
    calls ``abandon()`` when it dies first, which drains the queue and
    unblocks the producer promptly.
    """

    def __init__(self, max_chunks: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=max(max_chunks, 1))
        self._abandoned = threading.Event()

    def put(self, chunk) -> bool:
        while not self._abandoned.is_set():
            try:
                self._q.put(chunk, timeout=0.05)
            except queue.Full:
                continue
            if self._abandoned.is_set():
                # Raced abandon(): its drain freed the slot this put
                # landed in. The chunk goes nowhere — report the
                # abandonment so the producer stops.
                return False
            return True
        return False

    def close(self) -> None:
        """Marks end of stream (the consumer's iteration completes)."""
        self.put(_CLOSE)

    def fail(self, exc: BaseException) -> None:
        """Marks the stream failed; the consumer raises StreamFailed."""
        self.put(StreamFailed(str(exc)))

    def abandon(self) -> None:
        """Consumer-side bail-out: unblocks and stops the producer."""
        self._abandoned.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __iter__(self):
        while True:
            # Polled get, mirroring put(): abandon() can be called from a
            # third thread (PendingWrite.wait timeout) while the consumer
            # is blocked here, and its drain may have swallowed _CLOSE —
            # a bare get() would strand the consumer forever. Surfacing
            # as StreamFailed (not a clean stop) keeps the contract that
            # only a close() the consumer actually saw finalizes an
            # artifact.
            if self._abandoned.is_set():
                raise StreamFailed("stream abandoned")
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _CLOSE:
                return
            if isinstance(item, StreamFailed):
                raise item
            yield item


@dataclass
class SinkResult:
    """One fanout sink's outcome: its return value, or the exception it
    died with (never both)."""

    value: object = None
    error: BaseException | None = None


def fanout(chunks, sinks, max_chunks: int = 8) -> list[SinkResult]:
    """Feed one chunk iterable to every sink concurrently.

    Each sink is a callable taking a chunk iterable, run in its own
    thread over its own bounded queue: backpressure is the slowest LIVE
    sink (the pump blocks until every live queue accepted the chunk),
    and each sink is its own failure domain — a sink that throws is
    abandoned (its queue drained so the pump never blocks on the dead
    lane) while the others stream on. A sink must treat its input as a
    prefix until its iterator completes cleanly (`StreamFailed` marks a
    producer-side abort). Returns one SinkResult per sink, in order.
    """
    queues = [BoundedChunkQueue(max_chunks) for _ in sinks]
    results = [SinkResult() for _ in sinks]

    def _run(i: int, sink) -> None:
        try:
            results[i].value = sink(iter(queues[i]))
        except BaseException as e:  # noqa: BLE001 - each sink is its own
            # failure domain; the error is reported, never raised across
            results[i].error = e
            queues[i].abandon()

    threads = [
        threading.Thread(
            target=_run, args=(i, sink),
            name=f"dynolog_tpu_torch_stream_sink_{i}", daemon=True)
        for i, sink in enumerate(sinks)
    ]
    for t in threads:
        t.start()
    try:
        for chunk in chunks:
            delivered = False
            for q in queues:
                delivered = q.put(chunk) or delivered
            if not delivered:
                break  # every sink is gone; stop pumping
        for q in queues:
            q.close()
    except BaseException as e:  # noqa: BLE001 - producer failure must
        # reach every sink as StreamFailed, not vanish into this thread
        for q in queues:
            q.fail(e)
        raise
    finally:
        for t in threads:
            t.join()
    return results


def stream_write(path: str, chunks) -> int:
    """Atomic chunked file write: tmp + rename, tmp unlinked on ANY
    failure (no orphaned .tmp next to the artifact), bytes written
    returned. A reader never sees a torn file."""
    tmp_path = path + ".tmp"
    written = 0
    try:
        with open(tmp_path, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                written += len(chunk)
        os.replace(tmp_path, path)
    finally:
        try:
            os.unlink(tmp_path)  # no-op after a successful rename
        except OSError:
            pass
    return written
