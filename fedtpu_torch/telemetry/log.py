"""Leveled logger (the port's copy of ``fedtpu.telemetry.log``).

``info`` / ``warning`` / ``debug`` print when the level allows AND mirror
into the tracer (kind ``log``); ``parity`` prints reference-parity lines
byte for byte, unprefixed, under the verbose gate only.
"""

from __future__ import annotations

from typing import Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30}


class TelemetryLogger:
    def __init__(self, verbose: bool = True, tracer=None,
                 level: str = "info"):
        self.verbose = verbose
        self._tracer = tracer
        self._threshold = _LEVELS.get(level, 20)

    def _emit(self, level: str, msg: str) -> None:
        if self.verbose and _LEVELS[level] >= self._threshold:
            print(msg, flush=True)
        if self._tracer is not None:
            self._tracer.event("log", level=level, msg=msg)

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def warning(self, msg: str) -> None:
        self._emit("warning", msg)

    def parity(self, msg: str) -> None:
        """Reference-parity line: byte-exact stdout, no sink mirror, no
        level filtering beyond the verbose gate (the reference prints these
        unconditionally; ``--quiet`` maps to ``verbose=False``)."""
        if self.verbose:
            print(msg, flush=True)
