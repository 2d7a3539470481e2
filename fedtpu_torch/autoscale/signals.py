"""SignalBus: fold live telemetry into versioned controller snapshots (the
port's copy of ``fedtpu.autoscale.signals``).

The control plane never reads raw event streams. Every control tick the
:class:`SignalBus` folds whatever sources are present — the serving
``stats`` protocol payload (its machine-readable ``signals`` block),
per-process supervisor heartbeat files, and the cohort prefetch gauges
riding inside the stats counters — into one immutable
:class:`Snapshot`, stamped with a monotonically increasing ``version``.
Policies see snapshots and nothing else, which is what makes the
decision sequence replayable: record the snapshot stream and the policy
is a pure function of it.

SLO burn follows the error-budget convention: with objective
``objective_s`` on update-to-incorporation latency and an allowed
violation share ``error_budget``, burn is

    (share of observed latencies > objective_s) / error_budget

so 1.0 means the budget is being consumed exactly as provisioned and
anything above it is an overload signal. The share comes from the
cumulative ``update_to_incorporation`` histogram (telemetry.metrics
``le`` buckets) — the objective is resolved against the closest bucket
bound at or above it, so burn is exact with respect to what the
histogram can represent, never an interpolation.

No torch and no sockets in this module — folding is pure bookkeeping,
the same testability bar as admission control.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Tuple

from fedtpu_torch.resilience.supervisor import read_heartbeat

SNAPSHOT_SCHEMA_VERSION = 1

# A heartbeat older than this (wall seconds) marks its member ``stale``
# — the same liveness idea as the supervisor's --hang-timeout, scaled
# for a control loop that ticks every second or two.
DEFAULT_STALE_AFTER_S = 15.0


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


@dataclass(frozen=True)
class Snapshot:
    """One versioned controller input. ``t`` is the virtual clock the
    producing system runs on (trace seconds for serving); ``members``
    is the gang view as ``(process_index, status)`` pairs; ``notice``
    is the process index of a pending preemption notice (-1: none)."""

    version: int
    t: float
    backlog: int = 0              # admitted-but-not-incorporated depth
    buffered: int = 0             # K-buffer fill
    incorporated: int = 0
    admitted: int = 0
    window_decisions: int = 0     # admission decisions inside the window
    rates: Mapping[str, float] = field(default_factory=dict)
    slo_burn: float = 0.0
    prefetch_stall_s: float = 0.0
    prefetch_stalls: int = 0
    members: Tuple[Tuple[int, str], ...] = ()
    notice: int = -1

    def to_json(self) -> dict:
        return {
            "v": SNAPSHOT_SCHEMA_VERSION,
            "version": self.version,
            "t": self.t,
            "backlog": self.backlog,
            "buffered": self.buffered,
            "incorporated": self.incorporated,
            "admitted": self.admitted,
            "window_decisions": self.window_decisions,
            "rates": dict(self.rates),
            "slo_burn": self.slo_burn,
            "prefetch_stall_s": self.prefetch_stall_s,
            "prefetch_stalls": self.prefetch_stalls,
            "members": [list(m) for m in self.members],
            "notice": self.notice,
        }


def read_gang_members(heartbeat_base: str, process_count: int,
                      now: Optional[float] = None,
                      stale_after_s: float = DEFAULT_STALE_AFTER_S,
                      ) -> Tuple[Tuple[int, str], ...]:
    """Gang membership view from per-process heartbeat files (the
    ``heartbeat_path_for`` derivation the supervisor writes). Statuses:
    the heartbeat's own ``status`` field (``parked`` / ``running`` /
    ``serving`` / ...), downgraded to ``stale`` when the beat is older
    than ``stale_after_s`` wall seconds and to ``missing`` when the
    file does not exist."""
    from fedtpu_torch.resilience.distributed import heartbeat_path_for
    if now is None:
        now = _time.time()
    members = []
    for p in range(process_count):
        path = heartbeat_path_for(heartbeat_base, p)
        rec = read_heartbeat(path) if os.path.exists(path) else None
        if rec is None:
            members.append((p, "missing"))
            continue
        status = str(rec.get("status", "unknown"))
        age = now - float(rec.get("time", 0.0))
        if status != "parked" and age > stale_after_s:
            status = "stale"
        members.append((p, status))
    return tuple(members)


class SignalBus:
    """Folds telemetry sources into the next :class:`Snapshot`.

    ``objective_s`` / ``error_budget`` configure the SLO-burn fold; a
    serving stats payload that already carries a ``slo_burn`` (satellite
    export) wins over the histogram recomputation, so live mode and
    simulation read identical numbers.
    """

    def __init__(self, objective_s: float = 1.0,
                 error_budget: float = 0.1):
        if objective_s <= 0 or error_budget <= 0:
            raise ValueError("objective_s and error_budget must be > 0")
        self.objective_s = float(objective_s)
        self.error_budget = float(error_budget)
        self._version = 0

    @property
    def version(self) -> int:
        """Version the NEXT fold will stamp."""
        return self._version

    def fold(self, t: float, stats: Optional[Mapping] = None,
             members: Sequence[Tuple[int, str]] = (),
             notice: int = -1,
             latency_hist: Optional[Mapping] = None) -> Snapshot:
        """One control tick: fold a serving ``signals`` block (the
        ``stats`` op's machine-readable section — or any dict with the
        same keys), a gang membership view, and an optional raw latency
        histogram into a fresh snapshot."""
        s = dict(stats or {})
        rates = dict(s.get("rates") or {})
        burn = s.get("slo_burn")
        if burn is None:
            burn = slo_burn_from_hist(
                latency_hist or s.get("update_to_incorporation_hist"),
                self.objective_s, self.error_budget)
        snap = Snapshot(
            version=self._version,
            t=float(t),
            backlog=int(s.get("backlog", 0)),
            buffered=int(s.get("buffered", 0)),
            incorporated=int(s.get("incorporated", 0)),
            admitted=int(s.get("admitted", 0)),
            window_decisions=int(s.get("window_decisions", 0)),
            rates=rates,
            slo_burn=float(burn),
            prefetch_stall_s=float(s.get("prefetch_stall_s", 0.0)),
            prefetch_stalls=int(s.get("prefetch_stalls", 0)),
            members=tuple((int(i), str(st)) for i, st in members),
            notice=int(notice),
        )
        self._version += 1
        return snap
