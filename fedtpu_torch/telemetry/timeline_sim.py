"""Deterministic causal-trace replay (the port's copy of
``fedtpu.telemetry.timeline_sim``).

Replays the PINNED two-gateway campaign (the ``SIM_*`` constants below,
``fedtpu``'s) against two real (small) port
:class:`fedtpu_torch.serving.engine.ServingEngine` instances through the
real request dispatcher (``fedtpu_torch.serving.server._handle``), each
engine writing a schema-v2 events sink through a role-scoped
:class:`fedtpu_torch.telemetry.trace.Tracer`; then merges the two sinks with
:mod:`fedtpu_torch.telemetry.timeline` and renders the deterministic JSONL,
which must equal the committed golden (``tests/goldens/timeline_sim.jsonl``)
byte for byte.

The campaign includes a deliberate retry: one frame is re-sent with its
original idempotency stamp, so the lines pin the whole exactly-once causal
story under one trace_id (client_stamp -> wal -> admit -> buffer_insert on
the first delivery, client_stamp -> dedup_drop on the retry, incorporate at
the drain tick) across two gateway processes.

The campaign's arrivals are ``SIM_ARRIVALS_FILE``: the golden's 64
arrivals exactly, as ``serving.traces.synthesize_trace`` draws them from
the ``SIM_*`` constants under numpy 2.0. The file is replayed on every
machine, because that Zipf draw depends on numpy's version (numpy 2.3
draws another trace).

Run it as ``python -m fedtpu_torch.telemetry.timeline_sim`` (``--golden
PATH`` compares, ``--write PATH`` writes, ``--platform cpu`` runs the
engines on the CPU). The engines tick for real, so it runs only when
invoked, never at import.
"""

from __future__ import annotations

import json
import os
import tempfile

from fedtpu_torch.autoscale.controller import compare_decisions, write_decisions

# The campaign: these constants are part of the committed golden, as in
# fedtpu.
SIM_USERS = 16
SIM_ARRIVALS = 64
SIM_HORIZON_S = 8.0
SIM_SEED = 7
SIM_BATCH = 8                       # trace rows per global chunk
SIM_GATEWAYS = 2
SIM_COHORT = 8
SIM_BUFFER = 2
SIM_TICK_INTERVAL_S = 0.5
# The session nonce is pinned (a live client draws a uuid), and the retried
# frame is pinned by its seq: determinism.
SIM_NONCE = "tlsim0campaign42"
SIM_RETRY_SEQ = 3
SIM_RUN_IDS = ("tlsim0g0", "tlsim0g1")
# The golden's arrivals (t, user, lat) as numpy 2.0's synthesize_trace
# draws them from the constants above, every float exact.
SIM_ARRIVALS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "timeline_sim_arrivals.json")


def _sim_config():
    from fedtpu_torch.config import ServingConfig
    return ServingConfig(
        cohort=SIM_COHORT, buffer_size=SIM_BUFFER,
        tick_interval_s=SIM_TICK_INTERVAL_S,
        data_rows=64, model_hidden=(8,), seed=0)


def sim_rows() -> list:
    """The campaign's ``[user, t, lat]`` rows, read from
    ``SIM_ARRIVALS_FILE``."""
    with open(SIM_ARRIVALS_FILE) as fh:
        doc = json.load(fh)
    t, user, lat = doc["t"], doc["user"], doc["lat"]
    return [[int(user[i]), float(t[i]), float(lat[i])]
            for i in range(len(t))]


def simulate(events_dir=None, device="cuda") -> dict:
    """Replay the pinned campaign on ``device``. Returns ``{"lines": [...],
    "summary": {...}}``: ``lines`` the merged deterministic timeline JSONL,
    ``summary`` the campaign's per-gateway incorporation and dedup totals,
    chain count and the retried trace_id's stage sequence.

    ``events_dir``: where the two sinks (and WALs) are written; a temporary
    directory (removed) when None. The directory never reaches the lines:
    the renderer labels sources by role."""
    from fedtpu_torch.serving import protocol
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.server import _handle
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    from fedtpu_torch.telemetry.timeline import (deterministic_lines,
                                                 load_timeline, trace_chains)
    from fedtpu_torch.telemetry.trace import Tracer

    tmp = None
    if events_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="fedtpu_torch_tlsim_")
        events_dir = tmp.name
    try:
        paths = [os.path.join(events_dir, f"events.g{g}.jsonl")
                 for g in range(SIM_GATEWAYS)]
        tracers = [Tracer(paths[g], run_id=SIM_RUN_IDS[g],
                          role=f"gateway-{g}", process_index=g)
                   for g in range(SIM_GATEWAYS)]
        engines = [ServingEngine(_sim_config(), registry=MetricsRegistry(),
                                 tracer=tracers[g], device=device)
                   for g in range(SIM_GATEWAYS)]
        for g, eng in enumerate(engines):
            # A real WAL (the gateway's per-member path), so every chain
            # carries its WAL leg.
            eng.wal_path = os.path.join(events_dir, f"wal.g{g}.jsonl")

        rows = sim_rows()

        # The fleet client's framing: one session nonce, a global seq, each
        # chunk split by owner (user % num_gateways) into one stamped frame
        # per owning gateway, stamped once.
        for g in range(SIM_GATEWAYS):
            _handle(engines[g],
                    {"op": "hello", "v": protocol.PROTOCOL_VERSION,
                     "nonce": SIM_NONCE,
                     "trace": protocol.trace_id(SIM_NONCE, 0)})
        seq = 0
        frames = []                 # (gateway, frame) in send order
        for i in range(0, len(rows), SIM_BATCH):
            chunk = rows[i:i + SIM_BATCH]
            for g in range(SIM_GATEWAYS):
                owned = [r for r in chunk if r[0] % SIM_GATEWAYS == g]
                if not owned:
                    continue
                seq += 1
                frames.append((g, {
                    "op": "updates", "events": owned,
                    "nonce": SIM_NONCE, "seq": seq,
                    "trace": protocol.trace_id(SIM_NONCE, seq)}))
        retry = next((f for f in frames if f[1]["seq"] == SIM_RETRY_SEQ),
                     frames[0])
        for g, frame in frames:
            _handle(engines[g], frame)
        # The retry: the same stamp and trace; the engine answers with the
        # original verdict and the chain gains only client_stamp and
        # dedup_drop under the same trace_id.
        dup = _handle(engines[retry[0]], retry[1])
        drains = [_handle(engines[g], {"op": "drain"})
                  for g in range(SIM_GATEWAYS)]
        for tr in tracers:
            tr.close()

        sources = load_timeline(paths)
        lines = deterministic_lines(sources)
        chains = trace_chains(sources)
        retry_tid = protocol.trace_id(SIM_NONCE, int(retry[1]["seq"]))
        retry_chain = next((c for c in chains if c["chain"] == retry_tid),
                           None)
        summary = {
            "arrivals": len(rows),
            "frames": len(frames),
            "chains": len(chains),
            "retry_duplicate": bool(dup.get("duplicate", False)),
            "retry_trace": retry_tid,
            "retry_stages": ([s["stage"] for s in retry_chain["stages"]]
                             if retry_chain else []),
            "incorporated": [int(d.get("incorporated", 0))
                             for d in drains],
            "duplicate_drops": [int(e.duplicate_drops) for e in engines],
        }
        return {"lines": lines, "summary": summary}
    finally:
        if tmp is not None:
            tmp.cleanup()


def main(argv=None) -> int:
    """Print, write or check the campaign's lines:
    ``python -m fedtpu_torch.telemetry.timeline_sim --golden
    tests/goldens/timeline_sim.jsonl`` (exit 1 on a mismatch)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", metavar="PATH", default=None,
                    help="write the canonical timeline JSONL here")
    ap.add_argument("--golden", metavar="PATH", default=None,
                    help="compare against this golden; exit 1 on mismatch")
    ap.add_argument("--platform", choices=["default", "cpu"],
                    default="default",
                    help="'default' runs the engines on the GPU, 'cpu' on "
                         "the CPU")
    args = ap.parse_args(argv)
    sim = simulate(device="cpu" if args.platform == "cpu" else "cuda")
    if args.write:
        write_decisions(args.write, sim["lines"])
        print(f"wrote {len(sim['lines'])} timeline lines -> {args.write}")
    if args.golden:
        res = compare_decisions(sim["lines"], args.golden)
        print(("OK: " if res["ok"] else "MISMATCH: ") + res["reason"])
        return 0 if res["ok"] else 1
    if not args.write:
        for line in sim["lines"]:
            print(line)
    return 0


__all__ = ["simulate", "sim_rows", "write_decisions", "compare_decisions",
           "SIM_NONCE", "SIM_SEED", "SIM_RETRY_SEQ", "SIM_GATEWAYS"]

if __name__ == "__main__":
    raise SystemExit(main())
