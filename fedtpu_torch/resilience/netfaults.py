"""Deterministic wire faults: the NetFaultPlan for the gateway fleet (the
port's copy of ``fedtpu.resilience.netfaults``).

This module proves the INGESTION WIRE recovers from transport
pathologies. A NetFaultPlan is the same idea as the round-fault
FaultPlan (``fedtpu_torch.resilience.faults``) — a seeded, JSON-driven
schedule materialized ONCE at load time into a canonical, digest-stamped
tuple — but its clock is not the
training round: it is the per-gateway WIRE FRAME ORDINAL (the k-th
newline-terminated frame a gateway's fault proxy receives from clients,
hellos and retries included). Counting frames instead of wall time is
what makes wire chaos replayable: the same plan against the same trace
fires the same fault on the same byte of the same frame on every run.

Plan schema (path or inline JSON via ``--net-fault-plan``)::

    {"seed": 0,
     "faults": [
       {"kind": "net_partition",  "gateway": 1, "frame": 3, "frames": 3},
       {"kind": "net_slow_link",  "gateway": 0, "frame": 2, "frames": 2,
        "chunk_bytes": 512, "delay_s": 0.01},
       {"kind": "net_torn_frame", "gateway": 1, "frame": 4,
        "boundary": "pre_ack", "cut_bytes": 64},
       {"kind": "net_dup_frame",  "gateway": 0, "frame": 5},
       {"kind": "net_reset",      "gateway": 0, "frame": 2,
        "phase": "mid"}]}

``frame`` is 1-based. Instead of a fixed ``frame`` an entry may carry
``"probability": p`` with an optional ``"window": [lo, hi]`` — expanded
at load time from ``np.random.RandomState(seed)`` exactly like the
round-fault plans, so the "random" campaign is still a pure function of
the plan.

Fault semantics (enforced by ``fedtpu_torch.serving.netproxy``):

* ``net_partition`` — blackhole the gateway for a window of ``frames``
  frames: each frame in the window is swallowed (never reaches the
  server) and the carrying connection is closed. The client sees a dead
  gateway and must retry/fail over; nothing was acked, so nothing can be
  lost.
* ``net_slow_link`` — per-connection bandwidth/latency cap for a window:
  frames are relayed to the server in ``chunk_bytes`` pieces with
  ``delay_s`` of pacing between pieces. Semantics are untouched — only
  wall time moves — so histories stay bitwise identical.
* ``net_torn_frame`` — close mid-frame after ``cut_bytes`` bytes.
  ``boundary: "pre_ack"`` cuts BEFORE the WAL-append/ack boundary (the
  server sees a torn line and drops the connection; the frame was never
  processed, so the client's retry is a first delivery).
  ``boundary: "post_ack"`` relays the whole frame, lets the server
  WAL-append + process + ack, then kills the connection WITHOUT
  delivering the ack — the lost-ack window. The client's retry of the
  same stamped seq must dedup server-side and return the ORIGINAL
  verdict counts (serving/engine.py sessions).
* ``net_dup_frame`` — replay the last committed frame: after relaying a
  frame and its ack, the proxy re-sends the identical bytes and swallows
  the extra response. The server must count a duplicate drop and answer
  the original counts; the client never notices.
* ``net_reset`` — RST. ``phase: "accept"`` resets the ``frame``-th
  ACCEPTED CONNECTION the instant it connects (here ``frame`` is a
  connection ordinal); ``phase: "mid"`` resets both sides after
  receiving the ``frame``-th frame, mid-batch, before any relay.

This module is import-light on purpose (numpy only, no torch): the proxy
and loadgen load plans from processes that never touch the card. A plan
materializes to ``fedtpu``'s schedule and digest, bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import numpy as np

NET_KINDS = ("net_partition", "net_slow_link", "net_torn_frame",
             "net_dup_frame", "net_reset")

_BOUNDARIES = ("pre_ack", "post_ack")
_PHASES = ("accept", "mid")

# Default horizon for probabilistic windows: a loadgen pass against the
# chaos traces is well under this many frames per gateway.
DEFAULT_FRAME_HORIZON = 64


@dataclasses.dataclass(frozen=True)
class NetFault:
    """One materialized wire-fault occurrence."""

    kind: str
    gateway: int                      # gateway index whose proxy enforces it
    frame: int                        # 1-based frame (net_reset/accept:
                                      # 1-based connection) ordinal
    frames: int = 1                   # window length (partition/slow_link)
    cut_bytes: int = 64               # net_torn_frame: bytes relayed pre-cut
    boundary: str = "pre_ack"         # net_torn_frame: pre/post ack boundary
    chunk_bytes: int = 1024           # net_slow_link: relay chunk cap
    delay_s: float = 0.0              # net_slow_link: pacing per chunk
    phase: str = "mid"                # net_reset: accept | mid

    def covers(self, frame: int) -> bool:
        """Whether a window kind spans the given frame ordinal."""
        return self.frame <= frame < self.frame + self.frames

    def payload(self) -> dict:
        """Tracer/decision-log payload (only the fields this kind uses).
        The fault kind is keyed ``fault`` — ``kind`` is the event kind
        slot in the tracer schema."""
        out = {"fault": self.kind, "gateway": self.gateway,
               "frame": self.frame}
        if self.kind in ("net_partition", "net_slow_link"):
            out["frames"] = self.frames
        if self.kind == "net_slow_link":
            out["chunk_bytes"] = self.chunk_bytes
            out["delay_s"] = self.delay_s
        if self.kind == "net_torn_frame":
            out["boundary"] = self.boundary
            out["cut_bytes"] = self.cut_bytes
        if self.kind == "net_reset":
            out["phase"] = self.phase
        return out


@dataclasses.dataclass(frozen=True)
class NetFaultPlan:
    """Materialized, validated wire-fault schedule + its content digest."""

    seed: int
    faults: Tuple[NetFault, ...]
    digest: str                       # sha256[:16] of the canonical dump

    @classmethod
    def load(cls, spec, num_gateways: int = 1,
             frames: int = DEFAULT_FRAME_HORIZON) -> "NetFaultPlan":
        """Parse + materialize + validate a plan. ``spec`` is a JSON file
        path, an inline JSON string (first non-space char ``{``), or an
        already-parsed dict — the same three forms FaultPlan.load takes.
        Probabilistic entries are expanded here, so the returned plan —
        and its digest — is the exact campaign the proxies will enforce."""
        if isinstance(spec, str):
            if spec.lstrip().startswith("{"):
                raw = json.loads(spec)
            else:
                with open(spec) as fh:
                    raw = json.load(fh)
        else:
            raw = dict(spec)
        if not isinstance(raw, dict):
            raise ValueError("net fault plan must be a JSON object with a "
                             "'faults' list")
        seed = int(raw.get("seed", 0))
        rng = np.random.RandomState(seed)
        faults = []
        for i, entry in enumerate(raw.get("faults", ())):
            kind = entry.get("kind")
            if kind not in NET_KINDS:
                raise ValueError(f"net fault #{i}: unknown kind {kind!r} "
                                 f"(one of {NET_KINDS})")
            gateway = int(entry.get("gateway", 0))
            if not 0 <= gateway < num_gateways:
                raise ValueError(f"net fault #{i}: gateway {gateway} "
                                 f"outside [0, {num_gateways})")
            if "probability" in entry:
                p = float(entry["probability"])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"net fault #{i}: probability {p} "
                                     "outside [0, 1]")
                lo, hi = entry.get("window", (1, frames))
                lo, hi = int(lo), int(hi)
                # One draw per frame in the window, in frame order — a
                # pure function of (plan seed, entry order).
                hits = [lo + j for j, u
                        in enumerate(rng.random_sample(max(0, hi - lo + 1)))
                        if u < p]
            else:
                if "frame" not in entry:
                    raise ValueError(f"net fault #{i}: needs 'frame' or "
                                     "'probability'")
                hits = [int(entry["frame"])]
            window = int(entry.get("frames", 1))
            if window < 1:
                raise ValueError(f"net fault #{i}: frames {window} < 1")
            if kind not in ("net_partition", "net_slow_link") and window != 1:
                raise ValueError(f"net fault #{i}: only windowed kinds take "
                                 "'frames'")
            cut = int(entry.get("cut_bytes", 64))
            if kind == "net_torn_frame" and cut < 1:
                raise ValueError(f"net fault #{i}: cut_bytes {cut} < 1")
            boundary = str(entry.get("boundary", "pre_ack"))
            if kind == "net_torn_frame" and boundary not in _BOUNDARIES:
                raise ValueError(f"net fault #{i}: boundary {boundary!r} "
                                 f"not one of {_BOUNDARIES}")
            chunk = int(entry.get("chunk_bytes", 1024))
            if kind == "net_slow_link" and chunk < 1:
                raise ValueError(f"net fault #{i}: chunk_bytes {chunk} < 1")
            delay = float(entry.get("delay_s", 0.0))
            if delay < 0:
                raise ValueError(f"net fault #{i}: delay_s {delay} < 0")
            phase = str(entry.get("phase", "mid"))
            if kind == "net_reset" and phase not in _PHASES:
                raise ValueError(f"net fault #{i}: phase {phase!r} not one "
                                 f"of {_PHASES}")
            for k in hits:
                if k < 1:
                    raise ValueError(f"net fault #{i}: frame {k} < 1")
                faults.append(NetFault(
                    kind=kind, gateway=gateway, frame=k, frames=window,
                    cut_bytes=cut, boundary=boundary, chunk_bytes=chunk,
                    delay_s=delay, phase=phase))
        faults.sort(key=lambda f: (f.gateway, f.frame, f.kind))
        canon = json.dumps(
            {"seed": seed,
             "faults": [dataclasses.asdict(f) for f in faults]},
            sort_keys=True)
        return cls(seed=seed, faults=tuple(faults),
                   digest=hashlib.sha256(canon.encode()).hexdigest()[:16])

    def for_gateway(self, gateway: int) -> Tuple[NetFault, ...]:
        """The faults one gateway's proxy enforces, in schedule order."""
        return tuple(f for f in self.faults if f.gateway == int(gateway))

    def at_frame(self, gateway: int, frame: int) -> Optional[NetFault]:
        """First fault striking the given frame ordinal on a gateway.
        Overlapping entries resolve in schedule order — deterministic by
        construction. ``net_reset``/``accept`` entries never match here
        (their ordinal counts CONNECTIONS, see ``at_accept``)."""
        for f in self.for_gateway(gateway):
            if f.kind == "net_reset" and f.phase == "accept":
                continue
            if f.kind in ("net_partition", "net_slow_link"):
                if f.covers(frame):
                    return f
            elif f.frame == frame:
                return f
        return None

    def at_accept(self, gateway: int, conn: int) -> Optional[NetFault]:
        """The ``net_reset``/``accept`` fault striking the ``conn``-th
        accepted connection on a gateway, if any."""
        for f in self.for_gateway(gateway):
            if (f.kind == "net_reset" and f.phase == "accept"
                    and f.frame == conn):
                return f
        return None


__all__ = ["NET_KINDS", "DEFAULT_FRAME_HORIZON", "NetFault", "NetFaultPlan"]
