"""Deterministic poisoning-defense replay (the port's copy of
``fedtpu.robust.defense_sim``).

Drives a REAL (small) :class:`fedtpu_torch.serving.engine.ServingEngine`
with screening enabled over a seeded adversarial trace
(``serving.traces``, v2 poison mode) in pure virtual time, then
canonicalizes the engine's defense decision log — one JSON line per
screen strike / quarantine. ``fedtpu`` compares those lines against its
committed golden through ``check --defense-sim``, and so does the port's
``check``; the tests also hold the lines against ``fedtpu``'s own
``simulate()`` run in-process, and ``chip_smoke.py`` the card's against
the CPU's.

``write_decisions`` / ``compare_decisions`` come from the autoscale
control plane (``fedtpu_torch.autoscale.controller``), as ``fedtpu``'s
do: one write/compare implementation for every decision log.
"""

from __future__ import annotations

import json
from typing import Optional

# One write/compare implementation repo-wide (re-exported below).
from fedtpu_torch.autoscale.controller import (compare_decisions,
                                               write_decisions)

# ---------------------------------------------------------------------------
# Simulation contract: ``fedtpu``'s constants (its golden's). The engine
# shape is small enough that the sim is a few seconds on the CPU, big
# enough that slots coalesce and the K-buffer actually buffers.

SIM_USERS = 40
SIM_ARRIVALS = 600
SIM_HORIZON_S = 30.0
SIM_SEED = 7
SIM_POISON_FRAC = 0.2
SIM_POISON_SCALE = 10.0
# Engine shape: small enough that the sim is a few seconds on CPU, big
# enough that slots coalesce and the K-buffer actually buffers.
SIM_COHORT = 8
SIM_BUFFER = 2
SIM_TICK_INTERVAL_S = 0.5
SIM_QUARANTINE_STRIKES = 3


def _sim_config():
    from fedtpu_torch.config import ServingConfig
    return ServingConfig(
        cohort=SIM_COHORT, buffer_size=SIM_BUFFER,
        tick_interval_s=SIM_TICK_INTERVAL_S,
        data_rows=64, model_hidden=(8,), seed=0,
        screen=True, quarantine_strikes=SIM_QUARANTINE_STRIKES)


def simulate(*, trace_path: Optional[str] = None,
             users: int = SIM_USERS, arrivals: int = SIM_ARRIVALS,
             horizon_s: float = SIM_HORIZON_S, seed: int = SIM_SEED,
             poison_frac: float = SIM_POISON_FRAC,
             poison_scale: float = SIM_POISON_SCALE,
             registry=None, tracer=None, device="cuda",
             init_params=None) -> dict:
    """Replay the adversarial trace through a screening engine. Returns
    ``{"lines": [...], "summary": {...}}`` where ``lines`` is the
    canonical defense-decision JSONL (one line per screen strike or
    quarantine, virtual-time-derived only) and ``summary`` scores the
    campaign: who was quarantined vs who actually attacked, and the
    final model accuracy (the containment metric). ``device`` and
    ``init_params`` are the engine's (the card; the slots' initial
    params, e.g. ``fedtpu``'s own)."""
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.traces import poisoned_user_ids, read_trace
    from fedtpu_torch.telemetry.metrics import MetricsRegistry

    if trace_path:
        header, events = read_trace(trace_path)
        rows = [([ev.user, ev.t, ev.lat, None, ev.poison]
                 if ev.poison > 0.0 else [ev.user, ev.t, ev.lat])
                for ev in events]
        users, seed = header.users, header.seed
        poison_frac = float(header.params.get("poison_frac", 0.0))
    else:
        from fedtpu_torch.serving.traces import synthesize_trace
        header, t, user, lat = synthesize_trace(
            users, arrivals, horizon_s, seed=seed,
            poison_frac=poison_frac, poison_scale=poison_scale)
        attackers_arr = poisoned_user_ids(users, seed, poison_frac)
        atk = frozenset(int(u) for u in attackers_arr)
        rows = [([int(user[i]), float(t[i]), float(lat[i]), None,
                  float(poison_scale)] if int(user[i]) in atk
                 else [int(user[i]), float(t[i]), float(lat[i])])
                for i in range(len(t))]
    attackers = sorted(int(u) for u in
                       poisoned_user_ids(users, seed, poison_frac))

    eng = ServingEngine(
        _sim_config(),
        registry=registry if registry is not None else MetricsRegistry(),
        tracer=tracer, device=device, init_params=init_params)
    counts = eng.offer_many(rows)
    eng.drain()

    lines = [json.dumps(row, sort_keys=True, separators=(",", ":"))
             for row in eng.defense_log]
    quarantined = sorted(eng.quarantined)
    atk_set = set(attackers)
    summary = {
        "arrivals": len(rows),
        "admission": {k: int(v) for k, v in sorted(counts.items())},
        "ticks": eng.tick_count,
        "incorporated": eng.incorporated,
        "screened": eng.screened_total,
        "attackers": attackers,
        "quarantined": quarantined,
        "quarantined_attackers": sorted(u for u in quarantined
                                        if u in atk_set),
        "quarantined_honest": sorted(u for u in quarantined
                                     if u not in atk_set),
        "eval_accuracy": eng.eval_accuracy(),
    }
    if tracer is not None:
        tracer.event("defense_sim_summary", **summary)
    return {"lines": lines, "summary": summary}


__all__ = ["simulate", "write_decisions", "compare_decisions",
           "SIM_USERS", "SIM_ARRIVALS", "SIM_HORIZON_S", "SIM_SEED",
           "SIM_POISON_FRAC", "SIM_POISON_SCALE"]
