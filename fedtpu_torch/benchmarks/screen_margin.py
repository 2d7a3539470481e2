"""The screened serving cell's knob margins, on the card.

``chip_smoke.py``'s screened cell (phase (p): ``SERVE_POISON``'s v2 trace
through a screening ``ServingEngine`` at the income MLP's full width) is
replayed here over a grid of the screen's knobs: the norm multiple, the
cosine limit and the flush cadence. For each point it prints the
quarantined attackers and honest users, the screened count, and whether
the decision log is the one ``SERVE_SCREEN`` gives. The cell's knobs are
chosen inside the region where no honest user is quarantined and at least
one attacker is.

Run from the repository root, on a machine with a card::

    python -m fedtpu_torch.benchmarks.screen_margin

The last line of its output is one JSON object with every point.
"""

from __future__ import annotations

import hashlib
import json
import time

MULTS = (3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 6.5, 7.0, 8.0, 10.0, 12.0, 16.0,
         24.0)
COSS = (-0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0)
FLUSHES = (0, 16, 32, 64)


def point(cs, rows: list, attackers: set, **knobs) -> dict:
    """One replay of the cell with ``knobs`` over ``SERVE_SCREEN``."""
    eng = cs.serve_replay(cs.serve_engine("cuda", **{**cs.SERVE_SCREEN,
                                                     **knobs}), rows)
    log = "\n".join(json.dumps(r, sort_keys=True) for r in eng.defense_log)
    return {**knobs, "caught": sum(u in attackers for u in eng.quarantined),
            "honest": sorted(u for u in eng.quarantined
                             if u not in attackers),
            "screened": eng.screened_total, "ticks": eng.tick_count,
            "log_sha": hashlib.sha256(log.encode()).hexdigest()[:16]}


def main() -> None:
    import chip_smoke as cs
    import torch
    from fedtpu_torch.serving.traces import (poisoned_user_ids,
                                             synthesize_trace, write_trace)
    if not torch.cuda.is_available():
        raise SystemExit("screen_margin: no card")
    cs.phase_device()
    cs.phase_build()
    import tempfile
    with tempfile.TemporaryDirectory() as directory:
        path = f"{directory}/poison.jsonl"
        write_trace(path, *synthesize_trace(**cs.SERVE_POISON))
        rows = cs.serve_rows(path)
    attackers = set(poisoned_user_ids(
        cs.SERVE_POISON["users"], cs.SERVE_POISON["seed"],
        cs.SERVE_POISON["poison_frac"]).tolist())
    t0 = time.perf_counter()
    chosen = point(cs, rows, attackers)
    points = []
    grid = ([{"screen_norm_mult": m, "screen_cos_min": c}
             for c in COSS for m in MULTS]
            + [{"flush_every": f} for f in FLUSHES])
    for knobs in grid:
        p = point(cs, rows, attackers, **knobs)
        p["same_log"] = p["log_sha"] == chosen["log_sha"]
        points.append(p)
        print(f"{json.dumps(knobs)}: {p['caught']} attackers, honest "
              f"{p['honest'][:8]}{'...' if len(p['honest']) > 8 else ''} "
              f"({len(p['honest'])}), {p['screened']} screened, "
              f"{p['ticks']} ticks, log {p['log_sha']}"
              f"{' = the cell' if p['same_log'] else ''}", flush=True)
    print(f"cell {cs.SERVE_SCREEN} on {cs.SERVE_POISON}: {chosen['caught']} "
          f"attackers, {len(chosen['honest'])} honest; {len(points)} points "
          f"in {time.perf_counter() - t0:.1f} s; {cs.CARD['smi']}",
          flush=True)
    print(json.dumps({"cell": chosen, "points": points}), flush=True)


if __name__ == "__main__":
    main()
