"""Versioned JSONL arrival traces: schema, heavy-tailed synthesis, replay
(the port's copy of ``fedtpu.serving.traces``: the same arrays and the
same file bytes).

A trace file is newline-delimited JSON. Line 1 is a header::

    {"kind": "trace_header", "v": 1, "users": 1000000, "arrivals": 50000,
     "seed": 0, "horizon_s": 60.0, "generator": "zipf_lognormal",
     "params": {...}}

Every subsequent line is one client-update arrival, sorted by ``t``::

    {"kind": "arrival", "t": 0.0123, "user": 48713, "lat": 0.87}

``t`` is the arrival time (seconds since trace start, virtual clock) at
which the update *reaches the server*; ``lat`` is the client's local
train+upload latency, so the model version the client pulled is the one
the server had at ``t - lat``. Admission and the serving engine run on
this virtual clock, which is what makes replay deterministic: identical
trace + seed => bitwise-identical metric history, independent of wall
time.

The synthesizer is deliberately heavy-tailed in both dimensions that
matter for admission control: per-user activity is Zipf-distributed
(a few hot users dominate, exercising the rate limiter) and both
inter-arrival gaps and client latencies are lognormal (bursts and
stragglers, exercising backpressure and staleness cutoffs).

No torch anywhere in this module — numpy + stdlib only, so loadgen and
offline tooling never touch a device.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import IO, Iterator

import numpy as np

TRACE_SCHEMA_VERSION = 1
# v2 adds the ADVERSARIAL-USER mode (robust.defense_sim, the screen):
# a seeded, deterministic attacker id set whose arrival lines carry a
# "poison" field — the amplified sign-flip weight scale the serving
# engine injects as a negative arrival weight. A v2 reader accepts v1
# files unchanged; plain synthesis (poison_frac=0) still writes v1, so
# existing goldens and trace fixtures stay byte-identical.
TRACE_SCHEMA_VERSION_POISON = 2
_READABLE_VERSIONS = (1, 2)
# Seed decorrelation for the attacker draw: the attacker set must not
# correlate with the arrival process drawn from the same seed.
_POISON_SEED_SALT = 0x9E3779B9


@dataclass(frozen=True)
class TraceHeader:
    """Parsed header line of a trace file."""

    v: int
    users: int
    arrivals: int
    seed: int
    horizon_s: float
    generator: str = "unknown"
    params: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "kind": "trace_header",
            "v": self.v,
            "users": self.users,
            "arrivals": self.arrivals,
            "seed": self.seed,
            "horizon_s": self.horizon_s,
            "generator": self.generator,
            "params": self.params,
        }


@dataclass(frozen=True)
class Arrival:
    """One client-update arrival. ``t`` >= ``lat`` >= 0; ``t`` is ascending.

    ``poison`` is 0.0 for honest arrivals (every v1 arrival). For a v2
    adversarial trace it is the positive sign-flip scale the serving
    engine turns into a negative arrival weight (``-poison``) so the
    screen has something real to catch.
    """

    t: float
    user: int
    lat: float
    poison: float = 0.0


def poisoned_user_ids(users: int, seed: int, poison_frac: float) -> np.ndarray:
    """The deterministic attacker id set for a v2 adversarial trace.

    A seeded permutation of the user range, decorrelated from the
    arrival RNG by salting the seed, truncated to
    ``round(poison_frac * users)`` ids. Shared by the synthesizer (to
    mark arrival lines), the defense sim (to score quarantine
    precision), and the chaos campaign (to assert containment), so the
    three can never disagree about who the attackers were.
    """
    if not (0.0 <= poison_frac <= 1.0):
        raise ValueError("poison_frac must be in [0, 1]")
    k = int(round(poison_frac * users))
    if k == 0:
        return np.empty(0, dtype=np.int64)
    rng = np.random.default_rng(seed ^ _POISON_SEED_SALT)
    return np.sort(rng.permutation(users)[:k]).astype(np.int64)


def synthesize_trace(users: int,
                     arrivals: int,
                     horizon_s: float = 60.0,
                     seed: int = 0,
                     zipf_a: float = 1.2,
                     gap_sigma: float = 1.0,
                     lat_mean_s: float = 0.5,
                     lat_sigma: float = 0.75,
                     poison_frac: float = 0.0,
                     poison_scale: float = 10.0) -> tuple[TraceHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Draw a heavy-tailed arrival trace; fully vectorized, one RNG.

    Returns ``(header, t, user, lat)`` as numpy arrays sorted by ``t``.

    - user ids ~ Zipf(zipf_a) folded into [0, users): heavy-tailed
      per-user activity (hot users hammer the token bucket).
    - inter-arrival gaps ~ lognormal(0, gap_sigma), normalized so the
      last arrival lands at ``horizon_s`` (bursty but bounded horizon).
    - client latency ~ lognormal around ``lat_mean_s`` (stragglers pull
      stale versions; the tail drives reject_stale).

    ``poison_frac > 0`` enables the adversarial mode: the header becomes
    v2 and records ``poison_frac``/``poison_scale`` in ``params``. The
    arrival *arrays are unchanged* — attackers are a deterministic
    function of the header (:func:`poisoned_user_ids`), and
    :func:`write_trace` marks their lines. With ``poison_frac == 0``
    the output is byte-identical to a v1 trace from the same seed.
    """
    if users < 1 or arrivals < 1:
        raise ValueError("users and arrivals must be >= 1")
    if not (0.0 <= poison_frac <= 1.0):
        raise ValueError("poison_frac must be in [0, 1]")
    if poison_frac > 0.0 and poison_scale <= 0.0:
        raise ValueError("poison_scale must be > 0 when poison_frac > 0")
    rng = np.random.default_rng(seed)
    # Zipf draws are unbounded above; fold into the user range. (z - 1)
    # keeps user 0 the hottest.
    user = (rng.zipf(zipf_a, size=arrivals) - 1) % users
    gaps = rng.lognormal(mean=0.0, sigma=gap_sigma, size=arrivals)
    t = np.cumsum(gaps)
    t = t * (horizon_s / float(t[-1]))
    mu = math.log(max(lat_mean_s, 1e-9)) - 0.5 * lat_sigma * lat_sigma
    lat = rng.lognormal(mean=mu, sigma=lat_sigma, size=arrivals)
    # A client cannot have pulled before the trace started.
    lat = np.minimum(lat, t)
    params = {
        "zipf_a": zipf_a,
        "gap_sigma": gap_sigma,
        "lat_mean_s": lat_mean_s,
        "lat_sigma": lat_sigma,
    }
    v = TRACE_SCHEMA_VERSION
    if poison_frac > 0.0:
        v = TRACE_SCHEMA_VERSION_POISON
        params["poison_frac"] = float(poison_frac)
        params["poison_scale"] = float(poison_scale)
    header = TraceHeader(
        v=v,
        users=int(users),
        arrivals=int(arrivals),
        seed=int(seed),
        horizon_s=float(horizon_s),
        generator="zipf_lognormal",
        params=params,
    )
    return header, t, user.astype(np.int64), lat


def write_trace(path: str, header: TraceHeader, t: np.ndarray,
                user: np.ndarray, lat: np.ndarray) -> None:
    """Write a trace file (header + one arrival line per event)."""
    if not (len(t) == len(user) == len(lat) == header.arrivals):
        raise ValueError("header.arrivals does not match array lengths")
    # v2 adversarial traces: the attacker set is a pure function of the
    # header, so marking happens here and the arrival arrays stay the
    # same shape for every caller.
    attackers: frozenset = frozenset()
    scale = 0.0
    if header.v == TRACE_SCHEMA_VERSION_POISON:
        frac = float(header.params.get("poison_frac", 0.0))
        scale = float(header.params.get("poison_scale", 0.0))
        if frac <= 0.0 or scale <= 0.0:
            raise ValueError("v2 trace header must carry positive "
                             "poison_frac and poison_scale params")
        attackers = frozenset(
            int(u) for u in poisoned_user_ids(header.users, header.seed, frac))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(header.to_json(), sort_keys=True) + "\n")
        for i in range(len(t)):
            u = int(user[i])
            if u in attackers:
                fh.write('{"kind": "arrival", "t": %.9f, "user": %d, '
                         '"lat": %.9f, "poison": %.9f}\n'
                         % (float(t[i]), u, float(lat[i]), scale))
            else:
                fh.write('{"kind": "arrival", "t": %.9f, "user": %d, "lat": %.9f}\n'
                         % (float(t[i]), u, float(lat[i])))


def read_header(fh: IO[str]) -> TraceHeader:
    line = fh.readline()
    if not line:
        raise ValueError("empty trace file")
    obj = json.loads(line)
    if obj.get("kind") != "trace_header":
        raise ValueError("trace file does not start with a trace_header line")
    v = int(obj.get("v", -1))
    if v not in _READABLE_VERSIONS:
        raise ValueError(f"unsupported trace schema v={v} "
                         f"(this build reads v in {_READABLE_VERSIONS})")
    return TraceHeader(
        v=v,
        users=int(obj["users"]),
        arrivals=int(obj["arrivals"]),
        seed=int(obj.get("seed", 0)),
        horizon_s=float(obj.get("horizon_s", 0.0)),
        generator=str(obj.get("generator", "unknown")),
        params=dict(obj.get("params", {})),
    )


def read_trace(path: str) -> tuple[TraceHeader, Iterator[Arrival]]:
    """Open a trace for streaming replay.

    Returns the parsed header and a generator of :class:`Arrival` in
    file order (ascending ``t``). Streaming — a 1M-user trace is never
    fully materialized by the reader; the caller decides how much to
    buffer.
    """
    fh = open(path, "r", encoding="utf-8")
    header = read_header(fh)

    def _iter() -> Iterator[Arrival]:
        last_t = -math.inf
        try:
            for line in fh:
                if not line.strip():
                    continue
                obj = json.loads(line)
                if obj.get("kind") != "arrival":
                    continue
                t = float(obj["t"])
                if t < last_t:
                    raise ValueError("trace arrivals are not sorted by t")
                last_t = t
                yield Arrival(t=t, user=int(obj["user"]),
                              lat=float(obj.get("lat", 0.0)),
                              poison=float(obj.get("poison", 0.0)))
        finally:
            fh.close()

    return header, _iter()


def load_trace_arrays(path: str) -> tuple[TraceHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Read a whole trace into ``(header, t, user, lat)`` numpy arrays.

    Convenience for benches and the in-process replay path; prefer
    :func:`read_trace` when the trace may be huge relative to memory.
    """
    header, events = read_trace(path)
    t = np.empty(header.arrivals, dtype=np.float64)
    user = np.empty(header.arrivals, dtype=np.int64)
    lat = np.empty(header.arrivals, dtype=np.float64)
    n = 0
    for ev in events:
        if n >= header.arrivals:
            raise ValueError("trace has more arrivals than its header claims")
        t[n], user[n], lat[n] = ev.t, ev.user, ev.lat
        n += 1
    if n != header.arrivals:
        raise ValueError(f"trace has {n} arrivals, header claims {header.arrivals}")
    return header, t, user, lat
