"""Admission control for the serving front-end (the port's copy of
``fedtpu.serving.admission``).

Every arriving client update passes through :class:`AdmissionController`
before it may touch the engine. The controller runs entirely on the
TRACE (virtual) clock — the arrival timestamps in the trace, not wall
time — so the same trace + config yields the same sequence of verdicts
bit for bit, regardless of host speed. Checks are ordered cheapest /
hardest first, and the order is part of the contract (tests pin it):

    1. rate       — global token bucket (``rate_limit`` updates/s of
                    virtual time, burst ``rate_burst``). Over budget =>
                    ``reject_rate``.
    2. backpressure — the engine's pending (admitted-but-not-yet-
                    incorporated) queue depth. At ``max_pending`` =>
                    ``reject_backpressure``; this is the K-buffer
                    overload signal, the inbound twin of the
                    ``async_starvation`` SLO event.
    3. staleness  — how many model versions behind the client's pulled
                    version is. Beyond ``stale_reject`` =>
                    ``reject_stale`` (the update would be discounted to
                    noise anyway); beyond ``stale_deprioritize`` =>
                    ``deprioritize`` (admitted, but queued behind fresh
                    work).
    4. otherwise  — ``accept``.

Per-verdict counters land in the shared MetricsRegistry under
``admission_<verdict>`` so they flow through the normal ``counters``
snapshot. The controller additionally keeps a
sliding window (``window_s`` of virtual time) over its own verdict
stream — :meth:`AdmissionController.window_rates` — so the autoscale
control plane reads per-verdict rates off the SAME bookkeeping path the
cumulative counters use, never a second tally that could drift.

No torch in this module — admission is pure host bookkeeping.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

from fedtpu_torch.telemetry.metrics import MetricsRegistry

ACCEPT = "accept"
DEPRIORITIZE = "deprioritize"
REJECT_RATE = "reject_rate"
REJECT_STALE = "reject_stale"
REJECT_BACKPRESSURE = "reject_backpressure"
# Defense verdict (the poisoning screen of serving.engine): the update was
# admitted by the checks above but refused by the poisoning screen (or
# its sender is quarantined). Counted through record(), never decide() —
# screening happens at/after the engine boundary, not in the token path.
SCREENED = "screened"

# Verdict order is display / schema order, not check order. SCREENED
# must stay LAST: checkpoints store counts as a list in this order, and
# restore_state zips — old 5-entry checkpoints restore as a prefix.
VERDICTS = (ACCEPT, DEPRIORITIZE, REJECT_RATE, REJECT_STALE,
            REJECT_BACKPRESSURE, SCREENED)

ADMITTED = frozenset({ACCEPT, DEPRIORITIZE})


class TokenBucket:
    """Token bucket on an external (virtual) clock.

    ``rate`` tokens/s refill up to ``burst`` capacity; each admitted
    request spends one token. The clock is whatever the caller passes
    to :meth:`take` — monotone non-decreasing virtual seconds. A
    ``rate`` of 0 disables limiting (always allows).
    """

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float):
        if rate < 0 or burst <= 0:
            raise ValueError("rate must be >= 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = 0.0

    def take(self, now: float, n: float = 1.0) -> bool:
        """Try to spend ``n`` tokens at virtual time ``now``."""
        if self.rate == 0.0:
            return True
        if now > self._t:
            self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
            self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def state(self) -> tuple:
        """``(tokens, last_refill_t)`` — the fill level and its virtual
        timestamp, everything :meth:`restore_state` needs to continue
        the verdict sequence bitwise across a checkpoint/restore."""
        return (self.tokens, self._t)

    def restore_state(self, tokens: float, t: float) -> None:
        self.tokens = float(tokens)
        self._t = float(t)


@dataclass(frozen=True)
class AdmissionPolicy:
    """The serve-side admission knobs."""

    rate_limit: float = 0.0        # updates/s of virtual time; 0 = off
    rate_burst: float = 64.0       # token-bucket capacity
    max_pending: int = 0           # queue-depth cutoff; 0 = off
    stale_deprioritize: int = 4    # versions behind => deprioritize
    stale_reject: int = 16         # versions behind => reject
    window_s: float = 10.0         # sliding stats window (virtual s)

    def __post_init__(self):
        if self.stale_reject < self.stale_deprioritize:
            raise ValueError("stale_reject must be >= stale_deprioritize")
        if self.max_pending < 0:
            raise ValueError("max_pending must be >= 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")


class AdmissionController:
    """Applies :class:`AdmissionPolicy` to one arrival at a time."""

    def __init__(self, policy: AdmissionPolicy,
                 registry: Optional[MetricsRegistry] = None):
        self.policy = policy
        self.registry = registry
        self._bucket = TokenBucket(policy.rate_limit, policy.rate_burst)
        self.counts = {v: 0 for v in VERDICTS}
        # Sliding window over (virtual_t, verdict) — fed by the same
        # `_count` call the cumulative counters use. Not checkpointed:
        # a resumed controller's rates warm back up over one window_s.
        self._window: deque = deque()

    def decide(self, now: float, staleness: int, pending: int) -> str:
        """Verdict for an update arriving at virtual time ``now`` whose
        pulled version is ``staleness`` versions old, while ``pending``
        admitted updates are still waiting for incorporation."""
        p = self.policy
        if not self._bucket.take(now):
            return self._count(REJECT_RATE, now)
        if p.max_pending and pending >= p.max_pending:
            return self._count(REJECT_BACKPRESSURE, now)
        if staleness > p.stale_reject:
            return self._count(REJECT_STALE, now)
        if staleness > p.stale_deprioritize:
            return self._count(DEPRIORITIZE, now)
        return self._count(ACCEPT, now)

    def record(self, verdict: str, now: float = 0.0) -> str:
        """Count a verdict decided OUTSIDE the policy checks — the
        defense screen's rejections (quarantine refusals at offer time,
        in-tick screened updates). Pure bookkeeping: no token is spent,
        so a screened update still consumed its rate token at decide()
        time, exactly like any other admitted-then-dropped frame."""
        if verdict not in self.counts:
            raise ValueError(f"unknown verdict {verdict!r}")
        return self._count(verdict, now)

    def _count(self, verdict: str, now: float = 0.0) -> str:
        self.counts[verdict] += 1
        self._window.append((now, verdict))
        self._evict(now)
        if self.registry is not None:
            self.registry.counter("admission_" + verdict).inc()
        return verdict

    def _evict(self, now: float) -> None:
        cutoff = now - self.policy.window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    def window_rates(self, now: Optional[float] = None) -> dict:
        """Per-verdict share of the decisions inside the sliding window
        ending at virtual time ``now`` (default: the newest decision's
        timestamp). Shares of an empty window are all 0.0."""
        if now is not None:
            self._evict(now)
        total = len(self._window)
        tally = {v: 0 for v in VERDICTS}
        for _, verdict in self._window:
            tally[verdict] += 1
        return {"window_s": self.policy.window_s,
                "decisions": total,
                "rates": {v: (tally[v] / total if total else 0.0)
                          for v in VERDICTS}}

    # ------------------------------------------------------------------
    # checkpoint support (serving.engine persists this so a
    # --resume continues the exact verdict sequence — a fresh token
    # bucket would refill to full burst and diverge from the
    # uninterrupted run whenever rate limiting is on)

    def state(self) -> dict:
        """Host state for checkpointing: bucket fill + per-verdict
        counts, in :data:`VERDICTS` order."""
        tokens, t = self._bucket.state()
        return {"bucket_tokens": tokens, "bucket_t": t,
                "counts": [self.counts[v] for v in VERDICTS]}

    def restore_state(self, bucket_tokens: float, bucket_t: float,
                      counts) -> None:
        """Inverse of :meth:`state`. Registry counters are bumped by the
        delta so report totals cover the whole run, not just the
        post-resume segment."""
        self._bucket.restore_state(bucket_tokens, bucket_t)
        for v, n in zip(VERDICTS, counts):
            delta = int(n) - self.counts[v]
            self.counts[v] = int(n)
            if self.registry is not None and delta > 0:
                self.registry.counter("admission_" + v).inc(delta)
