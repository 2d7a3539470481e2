"""The one percentile summary the serving engine reports (the port's copy
of ``_percentiles`` from ``fedtpu.telemetry.report``; the rest of the
report tool is ROADMAP A11)."""

from __future__ import annotations

from typing import List

import numpy as np


def _percentiles(durs: List[float]) -> dict:
    a = np.asarray(durs, dtype=np.float64)
    return {"p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "p99_s": float(np.percentile(a, 99)),
            "mean_s": float(a.mean()),
            "max_s": float(a.max())}
