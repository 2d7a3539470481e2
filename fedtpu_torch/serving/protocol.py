"""The ``serve`` wire protocol: newline-delimited JSON over TCP (the
port's copy of ``fedtpu.serving.protocol``: a port server answers a
``fedtpu`` client, and the reverse).

One JSON object per line, ``PROTOCOL_VERSION = 1``. The server binds
localhost only — this is a same-host ingestion socket (the loadgen, a
sidecar, a gateway), not an internet-facing API.

Client -> server ops:

    {"op": "hello", "v": 1}
        -> {"op": "welcome", "v": 1, "cohort": C, "version": n}
    {"op": "update", "user": 123, "t": 1.5, "lat": 0.2[, "version": 7]}
        -> {"op": "ack", "verdict": "accept", "version": n}
    {"op": "updates", "events": [[user, t, lat], ...]}
        -> {"op": "acks", "n": len, "counts": {verdict: n}, "version": n,
            "tick": k}
    {"op": "stats"}
        -> {"op": "stats", ...engine/admission snapshot...}
           (includes the machine-readable "signals" block the autoscale
           control plane polls: backlog, window rates, SLO burn)
    {"op": "configure", "tick_interval_s": 0.1, "flush_every": 64}
        -> {"op": "configured", "tick_interval_s": ..., "flush_every": ...}
           (autoscale knob actuation; omitted/null fields are unchanged)
    {"op": "pre_drain"[, "path": "..."]}
        -> {"op": "pre_drained", "spooled": n, "path": "..."}
           (spool the pending updates to disk ahead of a capacity loss)
    {"op": "drain"}
        -> {"op": "drained", "tick": k, "incorporated": n}

``t`` is the arrival's virtual-clock timestamp and ``lat`` the client's
train+upload latency (see traces.py); ``version``, when present, is the
model version the client claims to have pulled — otherwise the server
infers it from ``t - lat`` against its own apply history. The batch
``updates`` frame exists purely for load: one syscall + one parse per
thousands of arrivals is what lets the loadgen replay millions of
simulated users through a single socket.

Idempotent sessions (v1, optional fields): ``update``/``updates`` frames
may carry ``"nonce"`` (a per-client-session identifier that SURVIVES
socket reconnects) and ``"seq"`` (monotonic per nonce, one per frame).
The engine remembers each session's high-water seq and its last ack, so
a frame retried after a lost ack is answered with the ORIGINAL counts
(flagged ``"duplicate": true``) instead of being incorporated twice —
the exactly-once contract the retrying gateway client leans on.

Gateway routing (``fedtpu_torch.serving.gateway``): a frame for a user
another gateway owns is refused with an error frame carrying a
``"redirect"`` object naming the owner — ``{"gateway": g,
"num_gateways": N, "port_file": ...}`` — which the retrying client
follows.

Causal tracing (v1, optional field): a stamped frame may carry
``"trace"`` — the deterministic ``trace_id(nonce, seq)`` digest. The
trace id is a PURE function of the idempotency stamp (never wall time),
so a retried frame carries the SAME id and the merged fleet timeline
(``fedtpu timeline``) shows client-stamp -> gateway-WAL -> dedup-drop ->
incorporation as one logical update. Servers derive the id themselves
when the field is absent, so old clients still get traced.

Anything unparseable or unknown gets ``{"op": "error", ...}`` and the
connection stays up — a load generator mid-replay should not lose its
socket to one malformed frame.

Framing helpers below are shared by server, gateway, and loadgen;
stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import socket
from typing import Iterator, Optional

PROTOCOL_VERSION = 1

# Batch frames bigger than this are refused (protocol error, connection
# survives): bounds per-frame memory on the server regardless of client.
MAX_BATCH_EVENTS = 65536

# A line longer than this is a protocol violation — prevents one bad
# client growing the recv buffer without bound. With a plain bytearray
# buffer the connection is dropped (ConnectionError); with a LineBuffer
# the oversized line is refused AT the cap in a streaming way (yield
# None, discard until the next newline) and the connection survives per
# the error-frame contract — the server uses the latter so a loadgen
# mid-replay does not lose its socket to one runaway frame.
MAX_LINE_BYTES = 8 * 1024 * 1024


class LineBuffer(bytearray):
    """Recv buffer that survives oversized lines.

    ``discarding`` marks that the tail of a refused line is still in
    flight: recv_lines swallows bytes until the terminating newline
    without buffering them, so memory stays bounded by
    ``MAX_LINE_BYTES`` + one recv chunk no matter how the peer segments
    the line. ``dropped`` counts refused lines for telemetry.
    """

    def __init__(self, *a):
        super().__init__(*a)
        self.discarding = False
        self.dropped = 0


def send_msg(sock: socket.socket, obj: dict) -> None:
    # sort_keys: frame bytes feed the netlog's deterministic byte
    # counters (frame_bytes), so the encoding must be canonical — the
    # same payload dict must always serialize to the same bytes.
    sock.sendall(json.dumps(obj, sort_keys=True,
                            separators=(",", ":")).encode() + b"\n")


def recv_lines(sock: socket.socket, buf: bytearray) -> Iterator[Optional[bytes]]:
    """Yield complete lines accumulated in ``buf`` from one recv().

    Returns without yielding when no full line arrived yet; raises
    ``ConnectionError`` on EOF. ``buf`` carries the partial tail between
    calls. A line exceeding ``MAX_LINE_BYTES`` — whether it arrived in
    one chunk or in many small TCP segments — is refused the moment the
    cap is crossed: with a ``LineBuffer`` the refusal is yielded as
    ``None`` (caller answers an error frame, connection survives) and
    the line's remaining bytes are discarded as they stream in; with a
    plain ``bytearray`` the legacy contract holds and ``ConnectionError``
    is raised.
    """
    chunk = sock.recv(1 << 16)
    if not chunk:
        raise ConnectionError("peer closed")
    buf += chunk
    while True:
        if getattr(buf, "discarding", False):
            nl = buf.find(b"\n")
            if nl < 0:
                del buf[:]            # mid-refused-line: drop, stay bounded
                return
            del buf[:nl + 1]
            buf.discarding = False
            continue
        nl = buf.find(b"\n")
        if nl < 0:
            if len(buf) > MAX_LINE_BYTES:
                if not isinstance(buf, LineBuffer):
                    raise ConnectionError("line exceeds MAX_LINE_BYTES")
                buf.discarding = True
                buf.dropped += 1
                del buf[:]
                yield None            # the cap refusal, exactly once
                continue
            return
        if isinstance(buf, LineBuffer) and nl > MAX_LINE_BYTES:
            # Oversized but already complete in the buffer (cap crossed
            # and terminated inside one recv chunk's worth of tail).
            del buf[:nl + 1]
            buf.dropped += 1
            yield None
            continue
        line = bytes(buf[:nl])
        del buf[:nl + 1]
        if line:
            yield line


def parse_msg(line: bytes) -> Optional[dict]:
    """Parse one frame; None (not an exception) for malformed input so
    the server can answer with an ``error`` op instead of dropping."""
    try:
        obj = json.loads(line)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) else None


def error_msg(reason: str) -> dict:
    return {"op": "error", "v": PROTOCOL_VERSION, "reason": reason}


def trace_id(nonce, seq) -> str:
    """Deterministic causal-trace id of one logical frame: a pure digest
    of the idempotency stamp (nonce, seq) — NEVER wall time — so a retry
    resending the same stamp carries the same id, and two same-seed
    passes of a pinned campaign produce bitwise-identical timelines.
    16 hex chars: collision-safe for a fleet's worth of frames while
    keeping event lines small."""
    return hashlib.sha256(f"{nonce}:{int(seq)}".encode()).hexdigest()[:16]


def gateway_port_file(base: str, index: int) -> str:
    """Per-gateway port-file path (``<base>.g<i>``) — the one derivation
    rule shared by the gateway fleet, its clients, and the health probe,
    so a redirect frame's owner is discoverable from the base path
    alone."""
    return f"{base}.g{int(index)}"


def net_proxy_port_file(path: str) -> str:
    """Port-file path of the wire-fault proxy fronting the server whose
    own port file is ``path`` (``<path>.net``). When a ``--net-fault-plan``
    is active the server writes this file BEFORE its real one, so any
    client that discovered the real port file can atomically prefer the
    proxy — that single derivation rule is how loadgen, GatewayClient,
    and the LiveController all route through the chaos wire without
    flags of their own (see ``serving.netproxy``)."""
    return f"{path}.net"


class Connection:
    """Blocking request/response client used by loadgen and tests."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = bytearray()
        self._pending: list[bytes] = []

    def request(self, obj: dict) -> dict:
        send_msg(self.sock, obj)
        return self.recv()

    def recv(self) -> dict:
        while not self._pending:
            self._pending.extend(recv_lines(self.sock, self._buf))
        msg = parse_msg(self._pending.pop(0))
        if msg is None:
            raise ConnectionError("malformed frame from server")
        return msg

    def hello(self) -> dict:
        resp = self.request({"op": "hello", "v": PROTOCOL_VERSION})
        if resp.get("op") != "welcome":
            raise ConnectionError(f"handshake refused: {resp}")
        return resp

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
