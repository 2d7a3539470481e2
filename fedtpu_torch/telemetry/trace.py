"""Span/event tracer with a versioned JSONL sink (the port's copy of
``fedtpu.telemetry.trace``).

Event schema (``EVENT_SCHEMA_VERSION = 2``), one JSON object per line:

    v              int    schema version
    run_id         str    one uuid4 hex per tracer (joins every event of a run)
    kind           str    'manifest' | 'span' | 'round' | 'counters' | 'log' |
                          'trace' | ...
    phase          str?   span phase label ('build', 'chunk', 'eval',
                          'checkpoint', 'stop_check', 'launch',
                          'cohort_gather', ...); for kind 'trace' the causal
                          stage ('client_stamp', 'wal', 'admit',
                          'buffer_insert', 'dedup_drop', 'incorporate')
    round          int?   1-based round (tick) the event belongs to, when any
    t_start        float  seconds since the tracer's epoch (monotonic)
    dur_s          float  span duration; 0.0 for instantaneous events
    process_index  int    fleet process identity: FEDTPU_PROCESS_ID or 0
    pid            int    OS pid of the emitting process
    launch_id      str?   gang launch id (FEDTPU_LAUNCH_ID) when one
    role           str    emitting role: 'run', 'serve', 'gateway-<i>', ...
    payload        dict   kind-specific data (metric values, counters...)

v1 files (no identity fields) stay readable: every consumer reads the
identity with the defaults ``process_index=0``, ``role='run'``.

Timing rule: a span over device work closes on a HOST READ of that work's
result, never on a launch (a launch returns before the device finishes).
``Span.end_after_fetch`` packages the rule; the round loop closes its
chunk spans after the chunk's one pinned read (``_Fetch.get``). No span
adds a device synchronisation of its own, no payload value is a device
tensor (each is a host number the caller already read), and no tracer
call runs inside a CUDA-graph capture.

Crash flight recorder: every Tracer keeps a bounded ring of its most recent
event lines (``FlightRecorder``), flushed to ``events.crash.<role>.jsonl``
next to the sink by the serving crash barrier (``_safe_handle``).

Writes flush per event, so a crashed run's sink still holds everything
emitted before the crash.
"""

from __future__ import annotations

import collections
import json
import os
import time
import uuid
from typing import Optional

EVENT_SCHEMA_VERSION = 2

# Ring capacity of the per-process crash flight recorder: the serving
# fleet's last few ticks of context without a long run's whole history.
FLIGHT_RECORDER_CAPACITY = 256


def process_identity(role: Optional[str] = None,
                     process_index: Optional[int] = None) -> dict:
    """The v2 identity stamp for this process. ``process_index`` falls
    back to FEDTPU_PROCESS_ID, ``launch_id`` to FEDTPU_LAUNCH_ID; both are
    absent on a plain single-process run, which stamps as (0, 'run')."""
    if process_index is None:
        try:
            process_index = int(os.environ.get("FEDTPU_PROCESS_ID", "0") or 0)
        except ValueError:
            process_index = 0
    return {"process_index": int(process_index), "pid": os.getpid(),
            "launch_id": os.environ.get("FEDTPU_LAUNCH_ID"),
            "role": role or "run"}


def crash_artifact_path(events_path: Optional[str], role: str) -> str:
    """Where ``role``'s flight recorder is flushed:
    ``events.crash.<role>.jsonl`` in the sink's directory (the working
    directory when the tracer has no sink)."""
    base = os.path.dirname(events_path) if events_path else "."
    return os.path.join(base or ".", f"events.crash.{role}.jsonl")


class FlightRecorder:
    """Bounded ring of the most recent serialized event lines, O(1) an
    event (a ``deque`` with ``maxlen``)."""

    def __init__(self, capacity: int = FLIGHT_RECORDER_CAPACITY):
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)

    def record(self, line: str) -> None:
        self._ring.append(line)

    def __len__(self) -> int:
        return len(self._ring)

    def lines(self) -> list:
        return list(self._ring)

    def flush(self, path: str) -> int:
        """Write the ring to ``path`` (overwrite: a process's last crash is
        the one worth keeping) and return the line count. Never raises: it
        runs inside crash paths, where a second I/O error must not mask
        the first failure."""
        lines = self.lines()
        if not lines:
            return 0
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                for line in lines:
                    fh.write(line + "\n")
            os.replace(tmp, path)
        except OSError:
            return 0
        return len(lines)


def _host_read(tree) -> None:
    """Read every tensor of ``tree`` to the host: the proof that the device
    work that produced them finished."""
    if isinstance(tree, dict):
        for v in tree.values():
            _host_read(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _host_read(v)
    elif hasattr(tree, "cpu"):
        tree.cpu()


class Span:
    """One open phase window, made by ``Tracer.span``: a context manager
    (closes on ``__exit__``) or closed by ``end`` / ``end_after_fetch``."""

    def __init__(self, tracer: "Tracer", phase: str,
                 round: Optional[int] = None, **payload):
        self._tracer = tracer
        self.phase = phase
        self.round = round
        self.payload = dict(payload)
        self._t0 = time.monotonic()
        self._closed = False

    def end(self, **extra) -> float:
        """Close the span (idempotent) and emit it; returns the duration."""
        dur = time.monotonic() - self._t0
        if not self._closed:
            self._closed = True
            self._tracer.event("span", phase=self.phase, round=self.round,
                               dur_s=dur, **{**self.payload, **extra})
        return dur

    def end_after_fetch(self, tree, **extra) -> float:
        """Close the span on a host read of ``tree``: the read is the proof
        that the device work inside the span finished."""
        _host_read(tree)
        return self.end(**extra)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(**({"error": repr(exc)} if exc is not None else {}))


class Tracer:
    """Appends schema-v2 events to a JSONL sink; one per run. Timestamps
    are seconds since the tracer's construction (monotonic). Every line
    also lands in the flight recorder."""

    def __init__(self, path: str, run_id: Optional[str] = None,
                 role: Optional[str] = None,
                 process_index: Optional[int] = None):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex
        self.identity = process_identity(role, process_index)
        self.role = self.identity["role"]
        self.flight = FlightRecorder()
        self._epoch = time.monotonic()
        self._f = open(path, "a")

    @property
    def enabled(self) -> bool:
        return True

    def _now(self) -> float:
        return time.monotonic() - self._epoch

    def event(self, kind: str, phase: Optional[str] = None,
              round: Optional[int] = None, dur_s: float = 0.0,
              t_start: Optional[float] = None, **payload) -> None:
        """Emit one event. ``t_start`` defaults to now minus ``dur_s``, so a
        caller that timed a window itself gets its start."""
        if self._f.closed:
            return
        rec = {"v": EVENT_SCHEMA_VERSION, "run_id": self.run_id,
               "kind": kind, "phase": phase, "round": round,
               "t_start": (self._now() - dur_s if t_start is None
                           else t_start),
               "dur_s": dur_s, **self.identity, "payload": payload}
        line = json.dumps(rec, default=_json_default)
        self.flight.record(line)
        self._f.write(line + "\n")
        self._f.flush()

    def span(self, phase: str, round: Optional[int] = None,
             **payload) -> Span:
        return Span(self, phase, round=round, **payload)

    def counters(self, snapshot: dict) -> None:
        """Emit a registry snapshot (kind 'counters'); the report's totals
        come from the last one in the log."""
        self.event("counters", **snapshot)

    def flush_crash(self, reason: str = "") -> Optional[str]:
        """Flush the flight recorder to ``events.crash.<role>.jsonl`` next
        to the sink; returns the path (None when the ring was empty).
        Never raises."""
        path = crash_artifact_path(self.path, self.role)
        if reason:
            self.flight.record(json.dumps(
                {"v": EVENT_SCHEMA_VERSION, "run_id": self.run_id,
                 "kind": "crash_flush", "phase": None, "round": None,
                 "t_start": self._now(), "dur_s": 0.0, **self.identity,
                 "payload": {"reason": reason}}, default=_json_default))
        return path if self.flight.flush(path) else None

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class _NullSpan:
    phase = None
    round = None
    payload: dict = {}

    def end(self, **extra) -> float:
        return 0.0

    def end_after_fetch(self, tree, **extra) -> float:
        return 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


class NullTracer:
    """Telemetry-off tracer: ``Tracer``'s surface, every call a no-op, so
    the disabled path costs a method call per event, not a branch per
    call site."""

    path = None
    run_id = None
    role = "run"

    def __init__(self):
        self.identity = process_identity()
        self.flight = FlightRecorder(capacity=1)

    @property
    def enabled(self) -> bool:
        return False

    def event(self, kind, phase=None, round=None, dur_s=0.0, t_start=None,
              **payload) -> None:
        pass

    def span(self, phase, round=None, **payload) -> _NullSpan:
        return _NullSpan()

    def counters(self, snapshot) -> None:
        pass

    def flush_crash(self, reason: str = "") -> Optional[str]:
        return None

    def close(self) -> None:
        pass


def _json_default(obj):
    """Sink-side coercion of numpy scalars and arrays, and of 0-d and CPU
    tensors: the tracer must never crash the run it observes. A CUDA
    tensor is refused: reading it here would be a device synchronisation
    the caller did not ask for."""
    if getattr(obj, "is_cuda", False):
        raise TypeError("a CUDA tensor in an event payload: read it to the "
                        "host first")
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return repr(obj)


def make_tracer(path: Optional[str], run_id: Optional[str] = None,
                role: Optional[str] = None,
                process_index: Optional[int] = None):
    """The one constructor call sites use: a real ``Tracer`` when ``path``
    is set, a ``NullTracer`` otherwise. ``role`` scopes the identity
    stamp ('run' by default; the gateway fleet passes 'gateway-<i>')."""
    return (Tracer(path, run_id=run_id, role=role,
                   process_index=process_index)
            if path else NullTracer())
