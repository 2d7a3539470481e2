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

``install_compile_probe`` is the counterpart of ``fedtpu``'s probe of
JAX's compile events: the port compiles two things, a CUDA graph per
captured step (``parallel.round.capture_round_step``) and the kernels'
``nvcc`` build (``ops._build``), and each reports through
``compile_event`` into the default registry once the probe is installed:
counters ``graph_captures`` / ``graph_capture_secs`` and
``kernel_builds`` / ``kernel_build_secs`` (``fedtpu``'s are
``jax_compile_events`` / ``jax_compile_secs``). ``device_memory_gauges``
reads ``torch.cuda.memory_stats`` under ``fedtpu``'s gauge names.
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
        survives (compile events count into it across runs)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The per-process registry the run loop / checkpoint layer share."""
    return _DEFAULT


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of a nested dict (numbers and other leaves
    count 0)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    return 0


def compile_event(kind: str, secs: float) -> None:
    """One compile event of ``kind`` ('graph_capture' or 'kernel_build')
    that took ``secs`` host seconds: counters ``<kind>s`` and
    ``<kind>_secs`` of the default registry (the port's counterpart of
    ``fedtpu``'s compile probe)."""
    reg = default_registry()
    reg.counter(f"{kind}s").inc()
    reg.counter(f"{kind}_secs").inc(float(secs))


def device_memory_gauges(registry: Optional[MetricsRegistry] = None,
                         device=None) -> None:
    """Device-memory gauges of a run on the card, from
    ``torch.cuda.memory_stats``, under ``fedtpu``'s names:
    ``device_bytes_in_use`` (allocated bytes), ``live_array_count``
    (active blocks) and ``live_array_bytes`` (active bytes). A run on the
    CPU sets none, as ``fedtpu``'s CPU backend reports no memory stats."""
    import torch
    reg = registry if registry is not None else default_registry()
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return
    stats = torch.cuda.memory_stats(dev)
    reg.gauge("device_bytes_in_use").set(stats["allocated_bytes.all.current"])
    reg.gauge("live_array_count").set(stats["active.all.current"])
    reg.gauge("live_array_bytes").set(stats["active_bytes.all.current"])
