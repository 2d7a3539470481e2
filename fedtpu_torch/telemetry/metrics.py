"""Process-local counters / gauges / histograms (the port's copy of
``fedtpu.telemetry.metrics``).

A ``MetricsRegistry`` is plain host-side bookkeeping. The serving engine
increments it as it runs (ticks, incorporated updates, admission
verdicts, quarantines) and its ``Histogram`` carries the
update-to-incorporation latency that checkpoints persist bucket by
bucket. Every instrument updates under one registry-wide lock: ``x += n``
is a read-modify-write that loses updates under concurrency, and
``snapshot()`` must not observe a half-applied histogram.

Histogram buckets are cumulative-style upper bounds (Prometheus ``le``
semantics).

Not ported (ROADMAP A11): ``fedtpu``'s JAX compile-event probe and its
device-memory gauges (``jax.live_arrays``).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence

# Upper bounds for the staleness histogram: async staleness is a small
# non-negative integer (ticks since last pull), heavy-tailed under low
# arrival rates — powers of two cover the studyable range.
DEFAULT_STALENESS_BINS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: Optional[threading.Lock] = None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: Optional[threading.Lock] = None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` upper bounds) with
    running count/sum/min/max. ``bucket_counts[i]`` counts observations
    ``<= bins[i]``; one implicit +Inf bucket equals ``count``."""

    __slots__ = ("bins", "bucket_counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, bins: Sequence[float] = DEFAULT_STALENESS_BINS,
                 lock: Optional[threading.Lock] = None):
        self.bins = tuple(float(b) for b in bins)
        self.bucket_counts = [0] * len(self.bins)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock if lock is not None else threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            for i, b in enumerate(self.bins):
                if v <= b:
                    self.bucket_counts[i] += 1

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    def to_dict(self) -> dict:
        return {"bins": list(self.bins),
                "bucket_counts": list(self.bucket_counts),
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": (self.sum / self.count) if self.count else None}


class MetricsRegistry:
    """One lock for the whole registry, shared into every instrument it
    creates: instrument updates, name->instrument map growth, snapshot
    and reset all serialize against each other, so a background-compile
    ``inc()`` can neither lose an update nor tear a snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(lock=self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(lock=self._lock)
            return g

    def histogram(self, name: str,
                  bins: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(
                    bins if bins is not None else DEFAULT_STALENESS_BINS,
                    lock=self._lock)
            return self._histograms[name]

    def snapshot(self) -> dict:
        """JSON-ready view — the payload of a ``counters`` event."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.to_dict()
                               for k, h in self._histograms.items()},
            }

    def reset(self) -> None:
        """Clear all instruments IN PLACE — the registry object's identity
        survives (the compile probe holds a reference across runs)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The per-process registry the run loop / checkpoint layer share."""
    return _DEFAULT
