"""The heartbeat reader (the port's copy of ``read_heartbeat`` from
``fedtpu.resilience.supervisor``, which the autoscale signals read; the
supervisor itself, ``supervise --gang``, is ROADMAP A11)."""

from __future__ import annotations

import json
from typing import Optional


def read_heartbeat(path: str) -> Optional[dict]:
    """Last heartbeat payload, or None (missing/mid-crash garbage)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None
