"""Retrying protocol client for the serving ingestion tier.

:class:`GatewayClient` is the protocol-level client helper ``loadgen``
rides: the port's copy of ``fedtpu.serving.client``, for one server. It
wraps the blocking :class:`fedtpu_torch.serving.protocol.Connection`
with what a fault-tolerant caller needs —

- capped exponential backoff with jitter + reconnect on any connection
  error (ECONNREFUSED while a server restarts, a dropped socket, a
  send/recv timeout), re-reading the port file on every reconnect so a
  restarted server's fresh ephemeral port is picked up;
- idempotent sessions: each client holds one ``nonce`` that SURVIVES
  reconnects and stamps every update frame with a monotonic ``seq``, so
  a retry after a lost ack is deduplicated server-side
  (``serve_duplicate_drop``) and answered with the original counts —
  retried traffic is absorbed, never double-incorporated.

``fedtpu``'s client also routes over a gateway fleet (``num_gateways >
1``: per-gateway port files, redirect following, failover) and prefers
a wire-fault proxy's port file; both wait for the gateway and the proxy
(ROADMAP A8c), and ``num_gateways > 1`` raises naming it.

Retry sleeps are wall-clock plumbing, not virtual-time semantics: the
jitter RNG is seedable for reproducible tests, but admission/tick
determinism never depends on it.

Backend-free: stdlib only (the loadgen never touches the card).
"""

from __future__ import annotations

import random
import time
import uuid
from typing import List, Optional

from fedtpu_torch.config import _not_ported
from fedtpu_torch.serving import protocol

DEFAULT_RETRIES = 8
DEFAULT_BACKOFF_S = 0.05
DEFAULT_BACKOFF_MAX_S = 2.0

# Port files are re-read per connect attempt with this bound (not the
# request timeout): the outer retry ladder owns the waiting.
_PORT_POLL_S = 2.0


class GatewayClient:
    """Session-holding, retrying client of one server, at a direct
    ``port`` or the one in ``port_file``."""

    def __init__(self, *, host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 port_file: Optional[str] = None,
                 num_gateways: int = 1, timeout: float = 30.0,
                 retries: int = DEFAULT_RETRIES,
                 backoff_s: float = DEFAULT_BACKOFF_S,
                 backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
                 seed: Optional[int] = None):
        if port is None and not port_file:
            raise ValueError("need port or port_file")
        if int(num_gateways) > 1:
            _not_ported(f"num_gateways={int(num_gateways)} (the gateway "
                        "fleet)", "A8c")
        self.host = host
        self.port = port
        self.port_file = port_file
        self.num_gateways = 1
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        # The session identity: deliberately per-CLIENT, not per-socket —
        # a retry on a fresh connection must still dedup server-side.
        self.nonce = uuid.uuid4().hex[:16]
        self._seq = 0
        self._rng = random.Random(seed)
        self._conn: Optional[protocol.Connection] = None
        self._welcome: dict = {}
        # fedtpu's counters; nothing here redirects (no gateway fleet).
        self.stats = {"attempted": 0, "retried": 0, "redirected": 0,
                      "reconnects": 0, "frames": 0}

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def stamped(self, obj: dict) -> dict:
        """``obj`` plus this session's idempotency stamp. Stamp ONCE per
        logical frame, before any retries — a connection reset between
        frame send and ack recv is retryable precisely because the
        resend carries the SAME seq, so the server's session table
        answers the original verdict instead of incorporating twice.
        Re-stamping an already-stamped frame would forge a "new" frame
        out of a retry and break exactly-once, so it is refused here.

        The stamp also carries the causal ``trace`` id — a pure digest
        of (nonce, seq), so the retry that resends this frame resends
        the same trace id (protocol.trace_id)."""
        if "seq" in obj or "nonce" in obj:
            raise ValueError("frame already carries an idempotency stamp; "
                             "retries must resend it, never re-stamp")
        seq = self.next_seq()
        return dict(obj, nonce=self.nonce, seq=seq,
                    trace=protocol.trace_id(self.nonce, seq))

    # -- the connection --------------------------------------------------
    def _connect(self) -> protocol.Connection:
        if self._conn is not None:
            return self._conn
        port = self.port
        if self.port_file:
            # Re-read every time: a restarted server rewrites the file
            # with its fresh ephemeral port.
            from fedtpu_torch.serving.loadgen import read_port_file
            try:
                port = read_port_file(self.port_file, timeout=_PORT_POLL_S)
            except TimeoutError as e:
                raise ConnectionError(str(e)) from e
        conn = protocol.Connection(self.host, int(port),
                                   timeout=self.timeout)
        try:
            welcome = conn.hello()
        except (ConnectionError, OSError):
            conn.close()
            raise
        self._conn = conn
        self._welcome = welcome
        return conn

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _sleep(self, attempt: int) -> None:
        cap = min(self.backoff_max_s, self.backoff_s * (2 ** attempt))
        time.sleep(cap * (0.5 + self._rng.random()))  # jitter: [0.5, 1.5)x

    def hello(self) -> dict:
        """Connect (with the retry ladder) and return the welcome. The
        hello rides the session trace id at seq 0, so a timeline can
        attribute even pre-update handshakes to this session."""
        self.request({"op": "hello", "v": protocol.PROTOCOL_VERSION,
                      "nonce": self.nonce,
                      "trace": protocol.trace_id(self.nonce, 0)})
        return self._welcome

    # -- the retrying request path -------------------------------------
    def request(self, obj: dict) -> dict:
        """One frame -> one response, surviving connection loss
        (reconnect + capped exponential backoff with jitter). Raises
        ``ConnectionError`` when the server stayed unreachable through
        the whole ladder."""
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            self.stats["attempted"] += 1
            try:
                return self._connect().request(obj)
            except (ConnectionError, OSError) as e:
                last_err = e
                self._drop()
                self.stats["reconnects"] += 1
                if attempt < self.retries:
                    self.stats["retried"] += 1
                    self._sleep(attempt)
        raise ConnectionError(
            f"server unreachable for frame {obj.get('op')!r} "
            f"after retries: {last_err}")

    # -- bulk ingestion ------------------------------------------------
    def send_events(self, events: List[list]) -> dict:
        """The loadgen bulk path: ``events`` (rows ``[user, t, lat]``, in
        trace order) as one session-stamped ``updates`` frame; returns
        the acked per-verdict counts. A ``"duplicate": true`` ack
        carries the ORIGINAL counts of a frame whose first ack was lost,
        so taking it is exact, not double counting."""
        resp = self.request(self.stamped({"op": "updates",
                                          "events": list(events)}))
        if resp.get("op") != "acks":
            raise ConnectionError(f"server refused batch: {resp}")
        self.stats["frames"] += 1
        return {verdict: int(n)
                for verdict, n in (resp.get("counts") or {}).items()}

    def welcome(self) -> dict:
        return self._welcome

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
