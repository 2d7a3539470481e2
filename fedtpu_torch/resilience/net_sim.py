"""Deterministic wire-fault campaign replay (the port's copy of
``fedtpu.resilience.net_sim``, which ``check --net-sim`` runs).

Replays a PINNED NetFaultPlan (the ``SIM_*`` constants below) against a
REAL (small) :class:`fedtpu_torch.serving.engine.ServingEngine` through
the real request dispatcher (``fedtpu_torch.serving.server._handle``),
modeling
the wire exactly as the fault proxy enforces it — frame ordinals,
reconnect hellos, retries that resend the same stamped seq, lost acks,
replayed frames — and canonicalizes the resulting decision/verdict
stream into JSONL compared bitwise against the committed golden
(``tests/goldens/net_sim.jsonl``), reusing the autoscale control
plane's write/compare machinery.

Why a golden and not a threshold assertion: the exactly-once story is a
CHAIN (client stamp -> retry ladder -> WAL append -> session dedup ->
original-verdict ack), and a silent change anywhere in it — the session
table, the WAL ordering, the ack shape, the schedule materialization —
moves the decision stream. The golden turns every such move into a
reviewed regeneration instead of an accident, exactly the contract the
autoscale and defense goldens already enforce.

No sockets: the "wire" here is the deterministic frame/connection
ordinal arithmetic shared with ``fedtpu_torch.serving.netproxy``, which is
what makes the replay bitwise-stable enough to gate. Its lines hold no
model number, so the port's equal ``fedtpu``'s golden wherever the trace
synthesizer draws ``fedtpu``'s trace (numpy's version decides that). Like
the defense sim this module does touch the device (engine ticks are
real), so it only runs when explicitly invoked.
"""

from __future__ import annotations

import json

# One write/compare implementation repo-wide: the autoscale, defense,
# and net golden gates must never drift in format or failure reporting.
from fedtpu_torch.autoscale.controller import (compare_decisions,
                                               write_decisions)
from fedtpu_torch.resilience.netfaults import NetFaultPlan

# ---------------------------------------------------------------------------
# Simulation contract: these constants are part of the committed golden
# (tests/goldens/net_sim.jsonl). Changing ANY of them — or the schedule
# materialization in netfaults.py, the session/WAL machinery in
# serving/engine.py, the dispatcher in serving/server.py, or the trace
# synthesizer — legitimately regenerates the golden; the gate exists so
# that regeneration is a reviewed decision, not an accident.

SIM_USERS = 24
SIM_ARRIVALS = 240
SIM_HORIZON_S = 20.0
SIM_SEED = 13
SIM_BATCH = 24                      # trace rows per updates frame
SIM_COHORT = 8
SIM_BUFFER = 2
SIM_TICK_INTERVAL_S = 0.5
# The session nonce is pinned (a live client draws a uuid): determinism.
SIM_NONCE = "netsim0campaign1"

# The pinned campaign: every kind fires at least once, both sides of the
# WAL-append/ack boundary are torn, and a probabilistic partition tail
# exercises the seeded materialization path.
SIM_PLAN = {
    "seed": SIM_SEED,
    "faults": [
        {"kind": "net_partition", "gateway": 0, "frame": 3, "frames": 2},
        {"kind": "net_slow_link", "gateway": 0, "frame": 7, "frames": 2,
         "chunk_bytes": 128, "delay_s": 0.0},
        {"kind": "net_torn_frame", "gateway": 0, "frame": 9,
         "boundary": "pre_ack", "cut_bytes": 48},
        {"kind": "net_torn_frame", "gateway": 0, "frame": 12,
         "boundary": "post_ack", "cut_bytes": 48},
        {"kind": "net_dup_frame", "gateway": 0, "frame": 15},
        {"kind": "net_reset", "gateway": 0, "frame": 17, "phase": "mid"},
        {"kind": "net_reset", "gateway": 0, "frame": 3, "phase": "accept"},
        {"kind": "net_partition", "gateway": 0, "probability": 0.25,
         "window": [19, 26]},
    ],
}

# A runaway retry loop (a plan that swallows every retry forever) must
# fail loudly, not hang the check.
_MAX_WIRE_FRAMES = 400


def _sim_config():
    from fedtpu_torch.config import ServingConfig
    return ServingConfig(
        cohort=SIM_COHORT, buffer_size=SIM_BUFFER,
        tick_interval_s=SIM_TICK_INTERVAL_S,
        data_rows=64, model_hidden=(8,), seed=0)


def simulate(*, registry=None, tracer=None, device="cuda",
             init_params=None) -> dict:
    """Replay the pinned campaign. Returns ``{"lines": [...], "summary":
    {...}}`` where ``lines`` is the canonical wire-decision JSONL — one
    line per wire frame (ordinal, fault verdict, delivery outcome, ack
    essentials) — and ``summary`` scores the campaign: fired faults,
    client-merged admission vs engine incorporation (the exactly-once
    bar), and the schedule digest. ``device`` and ``init_params`` are the
    engine's (the card; the slots' initial params)."""
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.server import _handle
    from fedtpu_torch.serving.traces import synthesize_trace
    from fedtpu_torch.telemetry.metrics import MetricsRegistry

    plan = NetFaultPlan.load(SIM_PLAN, num_gateways=1)
    _, t, user, lat = synthesize_trace(
        SIM_USERS, SIM_ARRIVALS, SIM_HORIZON_S, seed=SIM_SEED)
    rows = [[int(user[i]), float(t[i]), float(lat[i])]
            for i in range(len(t))]
    batches = [rows[i:i + SIM_BATCH] for i in range(0, len(rows), SIM_BATCH)]

    eng = ServingEngine(
        _sim_config(),
        registry=registry if registry is not None else MetricsRegistry(),
        tracer=tracer, device=device, init_params=init_params)

    seq = 0
    deliveries = [{"op": "hello", "v": 1}]
    for batch in batches:
        seq += 1
        # Stamped ONCE, like GatewayClient.stamped: retries resend it.
        deliveries.append({"op": "updates", "events": batch,
                           "nonce": SIM_NONCE, "seq": seq})
    deliveries.append({"op": "drain"})

    lines = []
    merged: dict = {}
    fired: dict = {}
    frame = 0
    conn = 1
    queue = list(deliveries)
    while queue:
        msg = queue[0]
        frame += 1
        if frame > _MAX_WIRE_FRAMES:
            raise RuntimeError("net sim did not converge: the campaign "
                               "swallows retries without bound")

        def _reconnect():
            """Connection lost: the client reconnects (a fresh hello
            frame ahead of the retry) — possibly through accept-phase
            resets, each burning a connection ordinal."""
            nonlocal conn
            conn += 1
            while True:
                f = plan.at_accept(0, conn)
                if f is None:
                    break
                fired[f.kind] = fired.get(f.kind, 0) + 1
                lines.append(json.dumps(
                    {"conn": conn, "fault": "net_reset", "phase": "accept",
                     "outcome": "reconnect"},
                    sort_keys=True, separators=(",", ":")))
                conn += 1
            queue.insert(0, {"op": "hello", "v": 1})

        fault = plan.at_frame(0, frame)
        rec = {"frame": frame, "conn": conn, "op": msg.get("op"),
               "fault": fault.kind if fault else None}
        if "seq" in msg:
            rec["seq"] = msg["seq"]
        lost_before_server = fault is not None and (
            fault.kind in ("net_partition", "net_reset")
            or (fault.kind == "net_torn_frame"
                and fault.boundary == "pre_ack"))
        if lost_before_server:
            # The frame never reached the server: nothing processed,
            # nothing acked — the retry is a first delivery.
            fired[fault.kind] = fired.get(fault.kind, 0) + 1
            rec["delivered"] = False
            rec["outcome"] = "retry"
            if fault.kind == "net_torn_frame":
                rec["cut_bytes"] = fault.cut_bytes
            lines.append(json.dumps(rec, sort_keys=True,
                                    separators=(",", ":")))
            _reconnect()
            continue
        resp = _handle(eng, msg)
        rec["delivered"] = True
        if fault is not None and fault.kind == "net_torn_frame":
            # post_ack: WAL'd, processed, acked — and the ack died on
            # the wire. The client retries the SAME seq and must get
            # the original verdict back as a duplicate.
            fired[fault.kind] = fired.get(fault.kind, 0) + 1
            rec["outcome"] = "ack_lost"
            lines.append(json.dumps(rec, sort_keys=True,
                                    separators=(",", ":")))
            _reconnect()
            continue
        queue.pop(0)
        if resp.get("op") == "acks":
            rec["counts"] = {k: int(v) for k, v
                             in sorted((resp.get("counts") or {}).items())}
            rec["duplicate"] = bool(resp.get("duplicate", False))
            for k, v in rec["counts"].items():
                merged[k] = merged.get(k, 0) + v
        elif resp.get("op") == "drained":
            rec["incorporated"] = int(resp.get("incorporated", 0))
        if fault is not None and fault.kind == "net_slow_link":
            fired[fault.kind] = fired.get(fault.kind, 0) + 1
            rec["outcome"] = "paced"
            rec["chunk_bytes"] = fault.chunk_bytes
        elif fault is not None and fault.kind == "net_dup_frame":
            # Replay the last committed frame; the duplicate verdict is
            # swallowed by the wire, counted by the server.
            fired[fault.kind] = fired.get(fault.kind, 0) + 1
            dup = _handle(eng, msg)
            rec["outcome"] = "replayed"
            rec["replay_duplicate"] = bool(dup.get("duplicate", False))
        lines.append(json.dumps(rec, sort_keys=True, separators=(",", ":")))

    from fedtpu_torch.serving.admission import ADMITTED
    client_admitted = sum(int(n) for v, n in merged.items()
                          if v in ADMITTED)
    summary = {
        "arrivals": len(rows),
        "batches": len(batches),
        "wire_frames": frame,
        "connections": conn,
        "fired": {k: int(v) for k, v in sorted(fired.items())},
        "admission": {k: int(v) for k, v in sorted(merged.items())},
        "incorporated": eng.incorporated,
        "duplicate_drops": eng.duplicate_drops,
        # The exactly-once bar: every update the client was told was
        # admitted must be incorporated exactly once despite torn acks
        # and replays.
        "lost_acked": client_admitted - eng.incorporated,
        "digest": plan.digest,
    }
    if tracer is not None:
        tracer.event("net_sim_summary", **summary)
    return {"lines": lines, "summary": summary}


__all__ = ["simulate", "write_decisions", "compare_decisions",
           "SIM_PLAN", "SIM_SEED", "SIM_USERS", "SIM_ARRIVALS",
           "SIM_BATCH", "SIM_NONCE"]
