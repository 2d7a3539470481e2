"""Pure virtual-clock scaling policies: Snapshot in, decision list out
(the port's copy of ``fedtpu.autoscale.policy``).

A policy is a pure function of (policy config, snapshot stream): it
carries its between-tick memory in an explicit JSON-serializable state
dict that the caller threads through :meth:`Policy.decide`, and it
never reads a clock, a file, or a socket. That purity is the contract
the simulator's golden gate rests on — identical config + snapshot
stream must yield a bitwise-identical decision sequence.

Decisions are ordered (the actuator executes them left to right) and
drawn from a closed vocabulary::

    grow(n)              add n gang members (reshard grow notice)
    shrink(n)            remove n gang members (reshard shrink notice)
    set_cohort_size(v)   retarget the serving engine's per-tick cohort
                         (its count-driven flush threshold)
    set_tick_cadence(v)  retarget the serving tick interval (seconds)
    pre_drain(victim)    spool the pending updates ahead of losing
                         ``victim`` — always ordered BEFORE the shrink
                         that loses it
    hold                 no action this tick

The default :class:`ThresholdHysteresisPolicy` is a plain
threshold-with-hysteresis controller: a scale signal must persist for
``hysteresis_ticks`` consecutive snapshots before it acts, and every
action opens a ``cooldown_ticks`` refractory window so the control loop
cannot flap faster than the actuated system can respond. A preemption
NOTICE bypasses both — the deadline does not wait for hysteresis.

Third-party policies register through :func:`register_policy` and are
selected by name (``autoscale --policy``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from fedtpu_torch.autoscale.signals import Snapshot
from fedtpu_torch.config import AutoscaleConfig

DECISION_SCHEMA_VERSION = 1

GROW = "grow"
SHRINK = "shrink"
SET_COHORT_SIZE = "set_cohort_size"
SET_TICK_CADENCE = "set_tick_cadence"
PRE_DRAIN = "pre_drain"
HOLD = "hold"

KINDS = (GROW, SHRINK, SET_COHORT_SIZE, SET_TICK_CADENCE, PRE_DRAIN, HOLD)


@dataclass(frozen=True)
class Decision:
    """One actuator instruction. Unused fields keep their defaults so
    every decision serializes with the same fixed shape (bitwise
    goldens tolerate no optional keys)."""

    kind: str
    n: int = 0           # grow/shrink member count
    value: float = 0.0   # set_cohort_size / set_tick_cadence target
    victim: int = -1     # pre_drain target process index

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown decision kind {self.kind!r}; "
                             f"pick from {list(KINDS)}")

    def to_json(self) -> dict:
        return {"kind": self.kind, "n": self.n, "value": self.value,
                "victim": self.victim}


def grow(n: int = 1) -> Decision:
    return Decision(GROW, n=int(n))


def shrink(n: int = 1) -> Decision:
    return Decision(SHRINK, n=int(n))


def set_cohort_size(v: int) -> Decision:
    return Decision(SET_COHORT_SIZE, value=float(v))


def set_tick_cadence(v: float) -> Decision:
    return Decision(SET_TICK_CADENCE, value=float(v))


def pre_drain(victim: int) -> Decision:
    return Decision(PRE_DRAIN, victim=int(victim))


def hold() -> Decision:
    return Decision(HOLD)


def decision_line(snapshot: Snapshot, decisions: List[Decision]) -> str:
    """One canonical-JSON line of the decision sequence: snapshot
    version + virtual time + the ordered decisions. Same canonical form
    as the serving history lines (sorted keys, no whitespace), so byte
    comparison IS the replay check."""
    return json.dumps({"v": DECISION_SCHEMA_VERSION,
                       "version": snapshot.version,
                       "t": snapshot.t,
                       "decisions": [d.to_json() for d in decisions]},
                      sort_keys=True, separators=(",", ":"))


class Policy:
    """Pluggable policy interface. Subclasses implement :meth:`decide`
    as a pure function of ``(snapshot, state)`` and return the ordered
    decision list plus the successor state dict."""

    name = "base"

    def initial_state(self) -> dict:
        return {}

    def decide(self, snapshot: Snapshot,
               state: dict) -> Tuple[List[Decision], dict]:
        raise NotImplementedError


class ThresholdHysteresisPolicy(Policy):
    """The default controller (see module docstring for the shape)."""

    name = "threshold"

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg

    def initial_state(self) -> dict:
        return {"hot": 0, "cold": 0, "cooldown": 0}

    def _overload(self, snap: Snapshot) -> bool:
        c = self.cfg
        reject = (snap.rates.get("reject_backpressure", 0.0)
                  + snap.rates.get("reject_rate", 0.0))
        return (snap.backlog >= c.backlog_high
                or snap.slo_burn >= c.burn_high
                or reject >= c.reject_high)

    def _underload(self, snap: Snapshot) -> bool:
        c = self.cfg
        reject = (snap.rates.get("reject_backpressure", 0.0)
                  + snap.rates.get("reject_rate", 0.0))
        return (snap.backlog <= c.backlog_low
                and snap.slo_burn <= c.burn_high / 2.0
                and reject < c.reject_high / 2.0)

    def decide(self, snapshot: Snapshot,
               state: dict) -> Tuple[List[Decision], dict]:
        c = self.cfg
        st = dict(state) if state else self.initial_state()
        if snapshot.notice >= 0:
            # Preemption notice: spool ahead of the loss, then shrink.
            # No hysteresis — the deadline is the scheduler's, not ours.
            st = {"hot": 0, "cold": 0, "cooldown": c.cooldown_ticks}
            return [pre_drain(snapshot.notice), shrink(1)], st
        if st.get("cooldown", 0) > 0:
            st["cooldown"] = st["cooldown"] - 1
            return [hold()], st
        overload = self._overload(snapshot)
        underload = self._underload(snapshot)
        st["hot"] = st.get("hot", 0) + 1 if overload else 0
        st["cold"] = (st.get("cold", 0) + 1
                      if underload and not overload else 0)
        if st["hot"] >= c.hysteresis_ticks:
            st = {"hot": 0, "cold": 0, "cooldown": c.cooldown_ticks}
            return [grow(1), set_tick_cadence(c.tick_fast_s),
                    set_cohort_size(c.cohort_high)], st
        if st["cold"] >= c.hysteresis_ticks:
            st = {"hot": 0, "cold": 0, "cooldown": c.cooldown_ticks}
            return [shrink(1), set_tick_cadence(c.tick_slow_s),
                    set_cohort_size(c.cohort_low)], st
        return [hold()], st


POLICIES: Dict[str, Callable[[AutoscaleConfig], Policy]] = {
    "threshold": ThresholdHysteresisPolicy,
}


def register_policy(name: str,
                    factory: Callable[[AutoscaleConfig], Policy]) -> None:
    """Register a policy factory under ``name`` (the plugin hook).
    Re-registering a taken name is an error — silent replacement would
    make `--policy` mean different things in different processes."""
    if name in POLICIES:
        raise ValueError(f"policy {name!r} is already registered")
    POLICIES[name] = factory


def get_policy(name: str, cfg: AutoscaleConfig) -> Policy:
    try:
        factory = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; "
                         f"pick from {sorted(POLICIES)}") from None
    return factory(cfg)
