"""Retrying protocol client for the serving/gateway ingestion tier (the
port's copy of ``fedtpu.serving.client``).

:class:`GatewayClient` is the one protocol-level client helper shared by
``loadgen`` and the autoscale :class:`LiveController`: it wraps the
blocking :class:`fedtpu_torch.serving.protocol.Connection` with everything
a fault-tolerant caller needs —

- capped exponential backoff with jitter + reconnect on any connection
  error (ECONNREFUSED while a gateway restarts, a dropped socket, a
  send/recv timeout), re-reading the port file on every reconnect so a
  restarted server's fresh ephemeral port is picked up;
- redirect following: an ``error`` frame carrying a ``redirect`` object
  (a frame that reached the wrong gateway) is resent to the named owner;
- failover: when a gateway stays unreachable through the whole backoff
  ladder it is marked dead for a cooldown and the frame is offered to
  the next gateway — the path that keeps traffic flowing after a shard
  death, once a survivor has adopted the dead shard's ids;
- idempotent sessions: each client holds one ``nonce`` that SURVIVES
  reconnects and stamps every update frame with a monotonic ``seq``, so
  a retry after a lost ack is deduplicated server-side
  (``serve_duplicate_drop``) and answered with the original counts —
  retried traffic is absorbed, never double-incorporated.

Retry sleeps are wall-clock plumbing, not virtual-time semantics: the
jitter RNG is seedable for reproducible tests, but admission/tick
determinism never depends on it.

Backend-free: stdlib only (the loadgen never touches the card). A port
client talks to a ``fedtpu`` fleet, and a ``fedtpu`` client to the
port's: the wire is one.
"""

from __future__ import annotations

import os
import random
import time
import uuid
from typing import Dict, List, Optional

from fedtpu_torch.serving import protocol

DEFAULT_RETRIES = 8
DEFAULT_BACKOFF_S = 0.05
DEFAULT_BACKOFF_MAX_S = 2.0

# A redirect chain longer than this is a routing loop (two gateways each
# claiming the other owns the user), answered as an error, not a spin.
_REDIRECT_HOPS = 4

# After a gateway burns the whole retry ladder it is skipped for this
# long: a permanently-dead peer must not charge every later frame the
# full backoff ladder before failover.
_DEAD_COOLDOWN_S = 5.0

# Port files are re-read per connect attempt with this bound (not the
# request timeout): the outer retry ladder owns the waiting.
_PORT_POLL_S = 2.0


class GatewayClient:
    """Session-holding, retrying client over one or N gateways.

    ``num_gateways == 1`` (optionally with a direct ``port``) is the
    plain single-server mode loadgen and the autoscale controller used
    before the fleet existed — same wire behavior plus retry/reconnect.
    With ``num_gateways > 1``, ``port_file`` is the BASE path each
    gateway derives its own file from (protocol.gateway_port_file).
    """

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
        self.host = host
        self.port = port
        self.port_file = port_file
        self.num_gateways = max(1, int(num_gateways))
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        # The session identity: deliberately per-CLIENT, not per-socket —
        # a retry on a fresh connection must still dedup server-side.
        self.nonce = uuid.uuid4().hex[:16]
        self._seq = 0
        self._rng = random.Random(seed)
        self._conns: Dict[int, protocol.Connection] = {}
        self._welcome: Dict[int, dict] = {}
        self._dead: Dict[int, float] = {}
        self.stats = {"attempted": 0, "retried": 0, "redirected": 0,
                      "reconnects": 0, "frames": 0}

    # -- routing -------------------------------------------------------
    def owner_of(self, user: int) -> int:
        """The gateway owning ``user`` — the store's modular contract."""
        return int(user) % self.num_gateways

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def stamped(self, obj: dict) -> dict:
        """``obj`` plus this session's idempotency stamp. Stamp ONCE per
        logical frame, before any retries — a connection reset between
        frame send and ack recv (the lost-ack window a ``net_torn_frame``
        at the post-ack boundary injects) is retryable precisely because
        the resend carries the SAME seq, so the server's session table
        answers the original verdict instead of incorporating twice.
        Re-stamping an already-stamped frame would forge a "new" frame
        out of a retry and break exactly-once, so it is refused here.

        The stamp also carries the causal ``trace`` id — a pure digest
        of (nonce, seq), so the retry that resends this frame resends
        the same trace id and the fleet timeline shows ONE logical
        update across the retry (protocol.trace_id)."""
        if "seq" in obj or "nonce" in obj:
            raise ValueError("frame already carries an idempotency stamp; "
                             "retries must resend it, never re-stamp")
        seq = self.next_seq()
        return dict(obj, nonce=self.nonce, seq=seq,
                    trace=protocol.trace_id(self.nonce, seq))

    # -- connections ---------------------------------------------------
    def _path_for(self, gateway: int) -> Optional[str]:
        if not self.port_file:
            return None
        if self.num_gateways == 1:
            return self.port_file
        return protocol.gateway_port_file(self.port_file, gateway)

    @staticmethod
    def _prefer_proxy(path: str) -> str:
        """Route through the wire-fault proxy when one fronts this
        gateway (``<path>.net`` exists). Only meaningful AFTER the real
        port file at ``path`` exists: the server writes ``.net`` before
        its real port file, so that ordering is what makes the
        preference race-free. The chaos wire is opt-in server-side and
        transparent here: loadgen and the LiveController inherit it
        through this one hook."""
        proxied = protocol.net_proxy_port_file(path)
        return proxied if os.path.exists(proxied) else path

    def _connect(self, gateway: int) -> protocol.Connection:
        conn = self._conns.get(gateway)
        if conn is not None:
            return conn
        port = self.port
        path = self._path_for(gateway)
        if path is not None:
            # Re-read every time: a restarted gateway rewrites the file
            # with its fresh ephemeral port. Wait on the REAL port file
            # first — it is the server-ready signal, and the proxy's
            # ``.net`` file is guaranteed to be written BEFORE it, so
            # only after the real file exists is the proxy preference
            # race-free (probing ``.net`` while the server is still
            # starting would commit to the direct path and route chaos
            # traffic around a proxy that appears a moment later).
            from fedtpu_torch.serving.loadgen import read_port_file
            try:
                port = read_port_file(path, timeout=_PORT_POLL_S)
                proxied = self._prefer_proxy(path)
                if proxied != path:
                    port = read_port_file(proxied, timeout=_PORT_POLL_S)
            except TimeoutError as e:
                raise ConnectionError(str(e)) from e
        if port is None:
            raise ConnectionError(f"no port known for gateway {gateway}")
        conn = protocol.Connection(self.host, int(port),
                                   timeout=self.timeout)
        try:
            welcome = conn.hello()
        except (ConnectionError, OSError):
            conn.close()
            raise
        self._conns[gateway] = conn
        self._welcome[gateway] = welcome
        return conn

    def _drop(self, gateway: int) -> None:
        conn = self._conns.pop(gateway, None)
        if conn is not None:
            conn.close()

    def _sleep(self, attempt: int) -> None:
        cap = min(self.backoff_max_s, self.backoff_s * (2 ** attempt))
        time.sleep(cap * (0.5 + self._rng.random()))  # jitter: [0.5, 1.5)x

    def hello(self, gateway: int = 0) -> dict:
        """Connect (with the retry ladder) and return the welcome. The
        hello rides the session trace id at seq 0, so a fleet timeline
        can attribute even pre-update handshakes to this session."""
        self.request({"op": "hello", "v": protocol.PROTOCOL_VERSION,
                      "nonce": self.nonce,
                      "trace": protocol.trace_id(self.nonce, 0)},
                     gateway=gateway)
        return self._welcome.get(gateway, {})

    # -- the retrying request path -------------------------------------
    def request(self, obj: dict, gateway: int = 0,
                failover: bool = True) -> dict:
        """One frame -> one response, surviving connection loss
        (reconnect + capped exponential backoff with jitter), misrouting
        (redirect frames are followed to the named owner), and — with
        ``failover`` — gateway death (the frame moves to the next index;
        the adopt path makes a survivor answer for a dead shard). Raises
        ``ConnectionError`` only when every candidate stayed unreachable
        through its whole ladder."""
        first = int(gateway) % self.num_gateways
        targets = [first]
        if failover:
            targets += [g for g in range(self.num_gateways) if g != first]
        hops = 0
        last_err: Optional[Exception] = None
        while targets:
            target = targets.pop(0)
            if self._dead.get(target, 0.0) > time.monotonic() and targets:
                continue  # recently proven dead; try the next peer first
            for attempt in range(self.retries + 1):
                self.stats["attempted"] += 1
                try:
                    resp = self._connect(target).request(obj)
                except (ConnectionError, OSError) as e:
                    last_err = e
                    self._drop(target)
                    self.stats["reconnects"] += 1
                    if attempt < self.retries:
                        self.stats["retried"] += 1
                        self._sleep(attempt)
                    continue
                self._dead.pop(target, None)
                redirect = (resp.get("redirect")
                            if resp.get("op") == "error" else None)
                if isinstance(redirect, dict) and hops < _REDIRECT_HOPS:
                    hops += 1
                    self.stats["redirected"] += 1
                    owner = int(redirect.get("gateway", target))
                    targets = [owner] + [t for t in targets if t != owner]
                    break  # leave this ladder, go ask the named owner
                return resp
            else:
                self._dead[target] = time.monotonic() + _DEAD_COOLDOWN_S
        raise ConnectionError(
            f"no gateway reachable for frame {obj.get('op')!r} "
            f"after retries: {last_err}")

    # -- bulk ingestion ------------------------------------------------
    def send_events(self, events: List[list]) -> dict:
        """The loadgen bulk path: partition ``events`` (rows
        ``[user, t, lat]``) by owning gateway, send one session-stamped
        ``updates`` frame per owner (trace order preserved within each,
        owner order fixed — replay determinism), and merge the acked
        per-verdict counts. A ``"duplicate": true`` ack carries the
        ORIGINAL counts of a frame whose first ack was lost, so merging
        it is exact, not double counting."""
        per: Dict[int, list] = {}
        for row in events:
            per.setdefault(self.owner_of(row[0]), []).append(row)
        counts: dict = {}
        for g in sorted(per):
            frame = self.stamped({"op": "updates", "events": per[g]})
            resp = self.request(frame, gateway=g)
            if resp.get("op") != "acks":
                raise ConnectionError(f"server refused batch: {resp}")
            self.stats["frames"] += 1
            for verdict, n in (resp.get("counts") or {}).items():
                counts[verdict] = counts.get(verdict, 0) + int(n)
        return counts

    def request_each(self, obj: dict) -> Dict[int, Optional[dict]]:
        """Send ``obj`` to every gateway individually (no failover — a
        drain aimed at gateway 1 must not drain gateway 0 twice); dead
        gateways report None instead of raising."""
        out: Dict[int, Optional[dict]] = {}
        for g in range(self.num_gateways):
            try:
                out[g] = self.request(dict(obj), gateway=g, failover=False)
            except (ConnectionError, OSError):
                out[g] = None
        return out

    def welcome(self, gateway: int = 0) -> dict:
        return self._welcome.get(gateway, {})

    def close(self) -> None:
        for g in list(self._conns):
            self._drop(g)

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
