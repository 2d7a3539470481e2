"""The telemetry-off tracer (the port's copy of ``NullTracer`` from
``fedtpu.telemetry.trace``). The event sink that writes ``events.jsonl``
is ROADMAP A11, so every tracer of the port is this one."""

from __future__ import annotations

from typing import Optional


class NullTracer:
    """Telemetry-off tracer: the calls of ``fedtpu``'s ``Tracer`` that the
    engine, the server and the logger make, every one a no-op. They are
    written against this API unconditionally, so the disabled path costs
    a method call per event, not a branch per call site."""

    def event(self, kind, phase=None, round=None, dur_s=0.0, t_start=None,
              **payload) -> None:
        pass

    def counters(self, snapshot) -> None:
        pass

    def flush_crash(self, reason: str = "") -> Optional[str]:
        return None

    def close(self) -> None:
        pass
