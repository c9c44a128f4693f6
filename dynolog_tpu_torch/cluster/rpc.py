"""Framed JSON-RPC client for the daemon's control plane: the port's own
copy of ``dynolog_tpu/cluster/rpc.py`` (the port imports nothing of the
JAX package), with the port's failpoints, obs and version. Its frames are
byte-identical to the JAX client's (``tests/test_torch_unitrace.py``).

Speaks the dyno CLI's wire format directly — little-endian int32 length
prefix + JSON body in both directions (src/rpc/JsonRpcServer.cpp) — over
a persistent TCP connection. The daemon's event-loop transport keeps
connections open across requests, so cluster fan-out (unitrace polling N
hosts) reuses one kept-alive socket per host instead of spawning a
`dyno` subprocess (fresh process + fresh TCP connect + one-shot
connection) per host per poll.

Failure model: every IO is deadline-bounded (a blackholed host costs
`timeout_s`, never a kernel TCP timeout). A round trip retries exactly
once on a fresh connect, and ONLY when the daemon provably never
executed the request — the request frame failed to send, or the peer
closed cleanly before any response byte (the idle-reap signature on a
stale keep-alive connection; the daemon reaps after
--rpc_idle_timeout_ms, so the first failure after a long pause between
polls is expected). A timeout or mid-response failure is NOT retried:
the daemon may have executed the verb, and setKinetOnDemandRequest /
addTraceTrigger are not idempotent.
"""

from __future__ import annotations

import json
import logging
import socket
import struct

_log = logging.getLogger("dynolog_tpu_torch.cluster.rpc")

# The framed wire prefix, a module-level Struct so the wire format is
# statically visible.
FRAME_HEADER = struct.Struct("<i")

# Server-side cap (src/rpc/JsonRpcServer.cpp kMaxFrameBytes); a length
# beyond it means a corrupt stream, not a big response.
MAX_FRAME_BYTES = 64 << 20

DEFAULT_TIMEOUT_S = 10.0

# Wire proto this client speaks (dynotpu::kWireProtoVersion —
# docs/COMPATIBILITY.md). Sent in hello();
# every other request is proto-agnostic, so a client that never says
# hello is a perfectly valid v0 peer.
PROTO_VERSION = 1


class FramedRpcClient:
    """One reusable connection to one daemon's RPC port."""

    def __init__(self, host: str, port: int,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None

    def __enter__(self) -> "FramedRpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _connect(self) -> None:
        from dynolog_tpu_torch import failpoints

        if failpoints.fire("cluster.rpc_connect"):
            raise OSError(
                f"failpoint cluster.rpc_connect ({self.host}:{self.port})")
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
        return buf

    class _PeerClosedClean(Exception):
        """EOF/reset before any response byte: the stale-keep-alive
        signature (the request was never processed — safe to retry)."""

    def _stale(self) -> bool:
        """Whether the cached connection's peer already hung up (FIN/RST
        queued locally). Checked BEFORE sending, so a request is never
        written into a dead connection — where the failure would arrive
        mid-round-trip as an ambiguous reset."""
        sock = self._sock
        try:
            sock.setblocking(False)
            try:
                return sock.recv(1, socket.MSG_PEEK) == b""
            except (BlockingIOError, InterruptedError):
                return False  # alive, nothing pending
            except OSError:
                return True
            finally:
                sock.settimeout(self.timeout_s)
        except OSError:
            return True

    def call(self, request: dict) -> dict | None:
        """One framed round trip; None on any failure.

        Self-tracing: the round trip runs under a cluster.rpc.<fn> span
        in the local journal (dynolog_tpu_torch.obs), and unless the caller
        already set one, the request is stamped with a `trace_ctx` wire
        field naming that span — the daemon's verb span (and everything
        downstream, shim included) parents under it, so one unitrace
        invocation is one trace-id across the whole pod. Old daemons
        ignore the extra field.

        Retries once on a fresh connection ONLY for failures where the
        daemon provably never ran the request: a send-side failure (it
        cannot parse a partial frame) or a clean close before any
        response byte. A receive timeout or mid-response failure is
        final — the verb may have executed, and blindly re-sending a
        non-idempotent RPC (gputrace, addTraceTrigger) could run it
        twice. A connect failure is also final: retrying a dead host
        would just double the caller's wait.
        """
        from dynolog_tpu_torch import obs  # lazy: keep import-time cost off

        with obs.span("cluster.rpc." + str(request.get("fn", "?"))):
            ctx = obs.current()  # the span just opened
            if "trace_ctx" not in request and ctx is not None:
                request = {**request, "trace_ctx": ctx.header()}
            return self._roundtrip(json.dumps(request).encode())

    def hello(self) -> dict | None:
        """Versioned wire hello: announce this client's proto/build and
        return the daemon's reply with ``negotiated`` added — the proto
        the pair settled on (min of the two sides). Returns
        ``{"negotiated": 0}`` against a daemon that predates the hello
        verb (it answers nothing for an unknown fn — exactly the v0
        behavior the negotiation defaults to), and None only on
        transport failure."""
        from dynolog_tpu_torch import __version__

        resp = self.call({"fn": "hello", "proto": PROTO_VERSION,
                          "build": f"py-{__version__}"})
        if resp is None:
            # An old daemon closes the connection on an unknown verb —
            # indistinguishable from a transport fault at this layer, so
            # probe liveness cheaply before calling the link v0.
            probe = self.call({"fn": "getStatus"})
            if probe is None:
                return None
            return {"negotiated": 0}
        out = dict(resp)
        # Raise-free coercion (the server-side asInt posture): a skewed
        # or hostile peer answering a wrong-typed proto degrades the
        # link to v0 instead of crashing the caller.
        proto = resp.get("proto")
        if isinstance(proto, bool) or not isinstance(proto, (int, float)):
            proto = 0
        out["negotiated"] = min(int(proto), PROTO_VERSION)
        return out

    def call_streaming(self, request: dict, sink) -> dict | None:
        """A framed round trip whose response may be CHUNK-streamed
        (fetchTrace): after the JSON header frame, length-prefixed raw
        chunk frames are drained to ``sink(bytes)`` until the zero-length
        END frame. Returns the header dict with ``streamed_bytes`` added
        (non-streamed responses return as-is); None on transport failure
        — INCLUDING a truncated stream, in which case the sink has seen
        a prefix: callers must write to a tmp path and discard on None
        (`fetch_to_file` below owns that discipline).

        The deadline is PER FRAME, not per call: every recv re-arms the
        socket timeout, so a slow but progressing multi-MB stream is
        never cut off by ``timeout_s`` — only a genuine mid-stream stall
        is. No retry once the header arrived: re-requesting a stream
        already partially consumed would hand the sink duplicate bytes.
        """
        from dynolog_tpu_torch import obs  # lazy: keep import-time cost off

        with obs.span("cluster.rpc." + str(request.get("fn", "?"))):
            ctx = obs.current()
            if "trace_ctx" not in request and ctx is not None:
                request = {**request, "trace_ctx": ctx.header()}
            header = self._roundtrip(json.dumps(request).encode())
        if header is None or header.get("stream") != "chunks":
            return header
        total = 0
        try:
            while True:
                (length,) = FRAME_HEADER.unpack(
                    self._recv_exact(FRAME_HEADER.size))
                if length < 0 or length > MAX_FRAME_BYTES:
                    raise ConnectionError(f"bad chunk length {length}")
                if length == 0:
                    break  # END frame: the stream is complete
                remaining = length
                while remaining:
                    piece = self._sock.recv(min(remaining, 1 << 16))
                    if not piece:
                        raise ConnectionError("peer closed mid-chunk")
                    sink(piece)
                    total += len(piece)
                    remaining -= len(piece)
        except (OSError, ValueError) as e:
            self.close()
            _log.warning(
                "streamed %s truncated after %d bytes: %s",
                request.get("fn"), total, e)
            return None
        header["streamed_bytes"] = total
        return header

    def fetch_to_file(self, path: str, dest: str) -> dict | None:
        """Fetch one remote artifact (fetchTrace) into ``dest``
        atomically: chunks stream into ``dest + ".tmp"``, renamed into
        place only after the END frame — a truncated stream leaves no
        partial artifact behind (tmp unlinked) and returns None."""
        import os

        tmp = dest + ".tmp"
        try:
            with open(tmp, "wb") as f:
                header = self.call_streaming(
                    {"fn": "fetchTrace", "path": path}, f.write)
            if header is None or header.get("status") != "ok":
                os.unlink(tmp)
                return header
            os.replace(tmp, dest)
            return header
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    def _roundtrip(self, body: bytes) -> dict | None:
        had_cached = self._sock is not None
        for _attempt in (0, 1):
            # Connect + send: a failure here is retriable (the daemon
            # never saw a complete frame). A cached connection whose
            # peer already hung up is replaced BEFORE sending.
            try:
                if self._sock is not None and self._stale():
                    self.close()
                if self._sock is None:
                    had_cached = False
                    self._connect()
                self._sock.sendall(FRAME_HEADER.pack(len(body)) + body)
            except OSError:
                self.close()
                if not had_cached:
                    return None
                had_cached = False
                continue
            # ...a failure from here on usually is not.
            try:
                try:
                    first = self._sock.recv(FRAME_HEADER.size)
                except ConnectionResetError:
                    # Reset before ANY response byte: the daemon closed
                    # the connection out from under the request (idle
                    # reap racing the send). A healthy daemon answers or
                    # FINs — it never resets a request it executed.
                    raise self._PeerClosedClean from None
                if not first:
                    raise self._PeerClosedClean
                header = first + (
                    self._recv_exact(FRAME_HEADER.size - len(first))
                    if len(first) < FRAME_HEADER.size else b"")
                (length,) = FRAME_HEADER.unpack(header)
                if length < 0 or length > MAX_FRAME_BYTES:
                    raise ConnectionError(f"bad frame length {length}")
                return json.loads(self._recv_exact(length).decode())
            except self._PeerClosedClean:
                self.close()
                if not had_cached:
                    return None
                had_cached = False  # stale keep-alive: one fresh retry
            except (OSError, ValueError):
                self.close()
                return None  # may have executed: never blind-retry
        return None
