"""``loadgen`` — replay an arrival trace against a running server (the
port's copy of ``fedtpu.serving.loadgen``).

Streams a JSONL trace (serving.traces) through the socket
protocol in batch frames, aggregates the per-verdict admission counts
the server acks back, and optionally issues a final ``drain`` +
``stats`` so the run ends with everything incorporated and a full SLO
snapshot in hand.

All traffic rides the retrying :class:`fedtpu_torch.serving.client
.GatewayClient`: a refused connection or a dropped socket mid-replay is
retried with capped exponential backoff instead of crashing the run,
redirect frames are followed, and every batch is session-stamped so a
retry after a lost ack is deduplicated server-side rather than
double-counted. With ``num_gateways > 1`` the trace is partitioned by
owning gateway per flush and the final drain/stats fans out per member.

Replay is as-fast-as-possible by design: arrival TIMESTAMPS carry the
virtual clock, so the server's admission/staleness/latency behavior is
identical whether the trace is streamed in one burst or paced over an
hour — wall time only changes the throughput numbers. That is what lets
one process push millions of simulated users through a localhost socket
in seconds.

Backend-free: numpy + stdlib only (the loadgen never touches the card).
"""

from __future__ import annotations

import time
from typing import Optional

from fedtpu_torch.serving.client import (DEFAULT_BACKOFF_S, DEFAULT_RETRIES,
                                   GatewayClient)
from fedtpu_torch.serving.protocol import MAX_BATCH_EVENTS
from fedtpu_torch.serving.traces import read_trace


def read_port_file(path: str, timeout: float = 30.0) -> int:
    """Poll ``path`` (written by the server once bound) for the port —
    ephemeral-port discovery when the server was started with port 0."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as fh:
                txt = fh.read().strip()
            if txt:
                return int(txt)
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"no port appeared in {path} within {timeout}s")


def run_loadgen(trace_path: str, host: str = "127.0.0.1",
                port: Optional[int] = None,
                port_file: Optional[str] = None,
                batch: int = 1024, max_events: int = 0,
                drain: bool = True, timeout: float = 120.0,
                num_gateways: int = 1,
                retries: int = DEFAULT_RETRIES,
                backoff_s: float = DEFAULT_BACKOFF_S,
                seed: int = 0) -> dict:
    """Replay ``trace_path`` against the server at ``host:port`` (or the
    port in ``port_file`` — with ``num_gateways > 1`` the BASE path each
    gateway derives its own file from). Returns a summary dict: events
    sent, frames, aggregated admission counts, retry/redirect counters,
    wall seconds, events/sec, and — when ``drain`` — the server's
    post-drain stats snapshot (per-gateway when fleet-sized).

    ``batch`` events ride per protocol frame (capped at the protocol's
    MAX_BATCH_EVENTS); ``max_events > 0`` truncates the replay (bounded
    smoke tests over big traces).
    """
    if port is None and not port_file:
        raise ValueError("need port or port_file")
    batch = max(1, min(int(batch), MAX_BATCH_EVENTS))
    header, events = read_trace(trace_path)

    counts: dict = {}
    sent = 0
    t0 = time.monotonic()
    with GatewayClient(host=host, port=port, port_file=port_file,
                       num_gateways=num_gateways, timeout=timeout,
                       retries=retries, backoff_s=backoff_s,
                       seed=seed) as client:
        welcome = client.hello()
        pending: list = []

        def _flush():
            nonlocal sent
            if not pending:
                return
            for verdict, n in client.send_events(pending).items():
                counts[verdict] = counts.get(verdict, 0) + int(n)
            sent += len(pending)
            pending.clear()

        for ev in events:
            # v2 adversarial traces: attacker events ride a 5-element row
            # (version slot None) so honest frames stay byte-identical to
            # the v1 wire format.
            if ev.poison > 0.0:
                pending.append([ev.user, ev.t, ev.lat, None, ev.poison])
            else:
                pending.append([ev.user, ev.t, ev.lat])
            if len(pending) >= batch:
                _flush()
            if max_events and sent + len(pending) >= max_events:
                break
        _flush()
        stats = None
        if drain:
            if client.num_gateways == 1:
                client.request({"op": "drain"})
                stats = client.request({"op": "stats"})
                stats.pop("op", None)
            else:
                # Per-member, no failover: a drain aimed at a dead
                # gateway must not drain a survivor twice.
                client.request_each({"op": "drain"})
                per = client.request_each({"op": "stats"})
                stats = {str(g): (s if s is None
                                  else {k: v for k, v in s.items()
                                        if k != "op"})
                         for g, s in per.items()}
        frames = client.stats["frames"]
        retry_stats = dict(client.stats)
    wall = time.monotonic() - t0
    return {
        "trace": trace_path,
        "trace_users": header.users,
        "trace_arrivals": header.arrivals,
        "events_sent": sent,
        "frames": frames,
        "batch": batch,
        "num_gateways": int(max(1, num_gateways)),
        "cohort": welcome.get("cohort"),
        "admission": counts,
        "attempted": retry_stats["attempted"],
        "retried": retry_stats["retried"],
        "redirected": retry_stats["redirected"],
        "reconnects": retry_stats["reconnects"],
        "wall_s": wall,
        "events_per_sec": (sent / wall) if wall > 0 else 0.0,
        "server_stats": stats,
    }
