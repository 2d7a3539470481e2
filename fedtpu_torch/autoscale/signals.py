"""SLO burn from the latency histogram (the port's copy of
``slo_burn_from_hist``, ``fedtpu/autoscale/signals.py:47-67``, which the
serving engine's ``signals()`` calls; the rest of ``fedtpu.autoscale`` is
ROADMAP A8c).

With objective ``objective_s`` on update-to-incorporation latency and an
allowed violation share ``error_budget``, burn is

    (share of observed latencies > objective_s) / error_budget

so 1.0 means the budget is being consumed exactly as provisioned. The
share comes from the cumulative ``update_to_incorporation`` histogram
(``telemetry.metrics`` ``le`` buckets): the objective is resolved against
the closest bucket bound at or above it, never an interpolation.
"""

from __future__ import annotations

from typing import Mapping, Optional


def slo_burn_from_hist(hist: Optional[Mapping], objective_s: float,
                       error_budget: float) -> float:
    """Error-budget burn rate from a cumulative-bucket histogram dict
    (the ``telemetry.metrics.Histogram.to_dict`` shape). 0.0 when the
    histogram is missing or empty."""
    if not hist or not hist.get("count"):
        return 0.0
    if error_budget <= 0:
        raise ValueError("error_budget must be > 0")
    count = int(hist["count"])
    bins = [float(b) for b in hist.get("bins", ())]
    bucket_counts = [int(c) for c in hist.get("bucket_counts", ())]
    within = 0
    for b, c in zip(bins, bucket_counts):
        if b >= objective_s:
            within = c
            break
    else:
        within = count        # objective beyond the last bound: all pass
    violating = count - within
    return (violating / count) / error_budget
