"""Autoscale actuation: the virtual-time simulator and the live controller
(the port's copy of ``fedtpu.autoscale.controller``).

Two consumers of the same (SignalBus -> Policy) stack:

- :func:`simulate` — a deterministic control-loop replay in PURE virtual
  time. A heavy-tailed arrival trace (``serving.traces``) runs through
  the REAL :class:`AdmissionController` and a closed-form service model
  (capacity x cohort / tick-interval updates per second); every
  ``control_interval_s`` the bus folds a snapshot, the policy decides,
  and the decisions feed back into the model (grow/shrink move capacity,
  cadence/cohort retarget the drain rate, a preemption notice triggers
  pre-drain + shrink). No wall clock anywhere, so the decision JSONL is
  bitwise-replayable: ``fedtpu``'s golden (``check --autoscale-sim``) is
  the port's too wherever the trace synthesizer draws ``fedtpu``'s trace.

- :class:`LiveController` — the same loop against a real deployment:
  polls the serving ``stats`` op for the machine-readable signals
  block, reads gang heartbeat files for membership, and executes
  decisions through the serving ``configure``/``pre_drain`` protocol
  ops and SIGUSR1/SIGUSR2 to the gang supervisor, which forwards them
  to every member: a training gang's live reshard
  (``fedtpu_torch.resilience.reshard``) or a gateway fleet.
  Preemption notices arrive through a notice FILE (``{"victim": p}``),
  so a drill and a real maintenance hook share one mechanism.

``write_decisions`` / ``compare_decisions`` are the one write/compare
implementation of every decision log (the autoscale, defense and net
sims).

torch-free throughout: the simulator runs in the CLI path that never
touches the card (like loadgen), and the live controller is a sidecar
that never touches a device.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import time as _time
from collections import deque
from typing import Dict, List, Optional

from fedtpu_torch.autoscale.policy import (GROW, HOLD, PRE_DRAIN,
                                           SET_COHORT_SIZE, SET_TICK_CADENCE,
                                           SHRINK, Decision, Policy,
                                           decision_line, get_policy)
from fedtpu_torch.autoscale.signals import SignalBus, read_gang_members
from fedtpu_torch.config import AutoscaleConfig
from fedtpu_torch.serving.admission import (ADMITTED, AdmissionController,
                                            AdmissionPolicy)
from fedtpu_torch.serving.engine import LATENCY_BINS_S
from fedtpu_torch.telemetry.metrics import Histogram

# ---------------------------------------------------------------------------
# Simulation contract: these constants are part of the committed golden
# (tests/goldens/autoscale_sim.jsonl). Changing ANY of them — or the
# default AutoscaleConfig, the default policy, the admission model, or
# the trace synthesizer — legitimately regenerates the golden; the gate
# exists so that regeneration is a reviewed decision, not an accident.

SIM_USERS = 2000
SIM_ARRIVALS = 6000
SIM_HORIZON_S = 30.0
SIM_SEED = 7
SIM_PROCESSES = 2
# A preemption notice for process 1 lands mid-burst (the backlog is a
# few hundred deep at 2.5 s), so the golden's pre_drain spools real
# pending work before the shrink, not an empty queue.
SIM_NOTICE_AT_S = 2.5
SIM_NOTICE_VICTIM = 1
# Admission knobs for the simulated front door: the rate limit bites on
# bursts, backpressure bites when the backlog outruns the drain rate.
SIM_ADMISSION = AdmissionPolicy(rate_limit=400.0, rate_burst=64.0,
                                max_pending=4096, stale_deprioritize=4,
                                stale_reject=16, window_s=5.0)
# Service-model starting point (the policy retargets both at runtime).
SIM_TICK_INTERVAL_S = 0.5
# Safety valve: a policy that never drains the queue still terminates.
_SIM_MAX_TICKS = 4096


def simulate(cfg: Optional[AutoscaleConfig] = None, *,
             policy: Optional[Policy] = None,
             trace_path: Optional[str] = None,
             users: int = SIM_USERS, arrivals: int = SIM_ARRIVALS,
             horizon_s: float = SIM_HORIZON_S, seed: int = SIM_SEED,
             processes: int = SIM_PROCESSES,
             notice_at_s: float = SIM_NOTICE_AT_S,
             notice_victim: int = SIM_NOTICE_VICTIM,
             tracer=None) -> dict:
    """Replay a bursty heavy-tailed trace against a policy in pure
    virtual time. Returns ``{"lines": [...], "summary": {...}}`` where
    ``lines`` is the canonical decision JSONL (one line per control
    tick) and ``summary`` aggregates what the control loop did."""
    cfg = cfg if cfg is not None else AutoscaleConfig()
    policy = policy if policy is not None else get_policy(cfg.policy, cfg)
    if trace_path:
        from fedtpu_torch.serving.traces import load_trace_arrays
        _, t, user, lat = load_trace_arrays(trace_path)
    else:
        from fedtpu_torch.serving.traces import synthesize_trace
        _, t, user, lat = synthesize_trace(users, arrivals, horizon_s,
                                           seed=seed)
    adm = AdmissionController(SIM_ADMISSION)
    hist = Histogram(bins=LATENCY_BINS_S)
    bus = SignalBus(cfg.objective_s, cfg.error_budget)
    pstate = policy.initial_state()

    capacity = int(processes)
    tick_interval = float(SIM_TICK_INTERVAL_S)
    cohort = int(cfg.cohort_low)
    members: Dict[int, str] = {p: "serving" for p in range(capacity)}
    queue: deque = deque()          # admitted arrival timestamps (virtual)
    notice_pending = notice_at_s >= 0
    admitted = incorporated = spooled = 0
    counts: Dict[str, int] = {}
    lines: List[str] = []
    i, n = 0, len(t)

    k = 0
    while (i < n or queue) and k < _SIM_MAX_TICKS:
        k += 1
        t_now = k * cfg.control_interval_s
        # Ingest every arrival up to this control tick through REAL
        # admission. Staleness model: versions advance once per engine
        # tick, so a client that trained for `lat` is ~lat/tick versions
        # behind — deterministic, no device needed.
        while i < n and t[i] <= t_now:
            staleness = (int(lat[i] / tick_interval)
                         if tick_interval > 0 else 0)
            verdict = adm.decide(float(t[i]), staleness, len(queue))
            if verdict in ADMITTED:
                queue.append(float(t[i]))
                admitted += 1
            i += 1
        # Serve: capacity members x cohort updates per engine tick.
        if tick_interval > 0:
            served = int(capacity * cohort * cfg.control_interval_s
                         / tick_interval)
        else:
            served = len(queue)
        served = min(served, len(queue))
        for _ in range(served):
            hist.observe(t_now - queue.popleft())
            incorporated += 1
        notice = (notice_victim
                  if notice_pending and t_now >= notice_at_s else -1)
        win = adm.window_rates(t_now)
        snap = bus.fold(
            t_now,
            stats={"backlog": len(queue), "incorporated": incorporated,
                   "admitted": admitted,
                   "window_decisions": win["decisions"],
                   "rates": win["rates"]},
            members=sorted(members.items()), notice=notice,
            latency_hist=hist.to_dict())
        decisions, pstate = policy.decide(snap, pstate)
        for d in decisions:
            counts[d.kind] = counts.get(d.kind, 0) + 1
            if d.kind == GROW:
                for _ in range(d.n):
                    if capacity >= cfg.max_capacity:
                        break
                    parked = [p for p, s in sorted(members.items())
                              if s != "serving"]
                    p = parked[0] if parked else len(members)
                    members[p] = "serving"
                    capacity += 1
            elif d.kind == SHRINK:
                for _ in range(d.n):
                    if capacity <= cfg.min_capacity:
                        break
                    victim = (notice if notice >= 0
                              else max(p for p, s in members.items()
                                       if s == "serving"))
                    members[victim] = "parked"
                    capacity -= 1
                if notice >= 0:
                    notice_pending = False
            elif d.kind == SET_TICK_CADENCE:
                tick_interval = float(d.value)
            elif d.kind == SET_COHORT_SIZE:
                cohort = int(d.value)
            elif d.kind == PRE_DRAIN:
                # Durability copy of the whole backlog ahead of the loss.
                spooled += len(queue)
        lines.append(decision_line(snap, decisions))
        if tracer is not None:
            tracer.event("autoscale_decision", round=snap.version,
                         t_virtual=snap.t, backlog=snap.backlog,
                         slo_burn=snap.slo_burn, notice=snap.notice,
                         decisions=[d.to_json() for d in decisions])
    summary = {
        "control_ticks": len(lines),
        "arrivals": n,
        "admitted": admitted,
        "incorporated": incorporated,
        "spooled": spooled,
        "backlog_end": len(queue),
        "capacity_end": capacity,
        "decisions": {kind: counts.get(kind, 0) for kind in sorted(counts)},
        "truncated": bool(queue) or i < n,
    }
    if tracer is not None:
        tracer.event("autoscale_summary", **summary)
    return {"lines": lines, "summary": summary}


def write_decisions(path: str, lines: List[str]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        for line in lines:
            fh.write(line + "\n")
    os.replace(tmp, path)


def compare_decisions(lines: List[str], golden_path: str) -> dict:
    """Bitwise golden comparison, audit-gate style: every line must
    match exactly. Returns ``{"ok": bool, "reason": str}``."""
    try:
        with open(golden_path, encoding="utf-8") as fh:
            golden = [ln.rstrip("\n") for ln in fh if ln.strip()]
    except OSError as e:
        return {"ok": False, "reason": f"golden unreadable: {e}"}
    if len(golden) != len(lines):
        return {"ok": False,
                "reason": (f"decision count {len(lines)} != golden "
                           f"{len(golden)}")}
    for idx, (got, want) in enumerate(zip(lines, golden)):
        if got != want:
            return {"ok": False,
                    "reason": (f"first divergence at line {idx + 1}: "
                               f"got {got[:120]} want {want[:120]}")}
    return {"ok": True, "reason": f"{len(lines)} decision lines match"}


# ---------------------------------------------------------------------------
# live mode


class LiveController:
    """Attach the control loop to a running deployment (see module
    docstring). Wall time only paces the polling; every decision input
    is the deployment's own virtual-clock telemetry."""

    def __init__(self, cfg: AutoscaleConfig, policy: Optional[Policy] = None,
                 *, host: str = "127.0.0.1", port: int = 0,
                 supervisor_pid: int = 0, heartbeat: Optional[str] = None,
                 process_count: int = 0, notice_file: Optional[str] = None,
                 spool_path: Optional[str] = None, tracer=None):
        self.cfg = cfg
        self.policy = (policy if policy is not None
                       else get_policy(cfg.policy, cfg))
        self.host, self.port = host, int(port)
        self.supervisor_pid = int(supervisor_pid)
        self.heartbeat = heartbeat
        self.process_count = int(process_count)
        self.notice_file = notice_file
        self.spool_path = spool_path
        self.tracer = tracer
        self.bus = SignalBus(cfg.objective_s, cfg.error_budget)
        self.state = self.policy.initial_state()
        self._conn = None
        self._noticed: set = set()
        self.acted: Dict[str, int] = {}

    def _connection(self):
        # The retrying client, not a raw Connection: a control tick that
        # lands while the serving process restarts (the exact moment a
        # controller exists for) reconnects with backoff instead of
        # killing the control loop.
        if self._conn is None:
            from fedtpu_torch.serving.client import GatewayClient
            self._conn = GatewayClient(host=self.host, port=self.port,
                                       retries=4, backoff_s=0.1)
            self._conn.hello()
        return self._conn

    def _poll_stats(self) -> dict:
        if not self.port:
            return {}
        resp = self._connection().request({"op": "stats"})
        return dict(resp.get("signals") or {})

    def _poll_notice(self) -> int:
        """A pending preemption notice (victim index), -1 when none.
        Each notice file payload is acted on once."""
        if not self.notice_file or not os.path.exists(self.notice_file):
            return -1
        try:
            with open(self.notice_file, encoding="utf-8") as fh:
                rec = json.load(fh)
            victim = int(rec.get("victim", -1))
        except (OSError, ValueError):
            return -1
        if victim < 0 or victim in self._noticed:
            return -1
        return victim

    def step(self, now: Optional[float] = None):
        """One control tick: fold, decide, act. Returns the
        ``(snapshot, decisions)`` pair for callers that log or test."""
        stats = self._poll_stats()
        members = ()
        if self.heartbeat and self.process_count:
            members = read_gang_members(self.heartbeat, self.process_count)
        notice = self._poll_notice()
        snap = self.bus.fold(float(stats.get("t", now or _time.time())),
                             stats=stats, members=members, notice=notice)
        decisions, self.state = self.policy.decide(snap, self.state)
        if notice >= 0:
            self._noticed.add(notice)
        if self.tracer is not None:
            self.tracer.event("autoscale_decision", round=snap.version,
                              t_virtual=snap.t, backlog=snap.backlog,
                              slo_burn=snap.slo_burn, notice=snap.notice,
                              decisions=[d.to_json() for d in decisions])
        self._act(decisions)
        return snap, decisions

    def _act(self, decisions: List[Decision]) -> None:
        for d in decisions:
            if d.kind == HOLD:
                continue
            self.acted[d.kind] = self.acted.get(d.kind, 0) + 1
            if d.kind == PRE_DRAIN and self.port:
                msg = {"op": "pre_drain"}
                if self.spool_path:
                    msg["path"] = self.spool_path
                resp = self._connection().request(msg)
                if self.tracer is not None:
                    self.tracer.event("autoscale_pre_drain",
                                      victim=d.victim,
                                      spooled=resp.get("spooled"),
                                      path=resp.get("path"))
            elif d.kind == SET_TICK_CADENCE and self.port:
                self._connection().request(
                    {"op": "configure", "tick_interval_s": d.value})
            elif d.kind == SET_COHORT_SIZE and self.port:
                self._connection().request(
                    {"op": "configure", "flush_every": int(d.value)})
            elif d.kind in (GROW, SHRINK) and self.supervisor_pid:
                # The reshard notice path: the gang supervisor forwards
                # SIGUSR1 (shrink) / SIGUSR2 (grow) to every member.
                sig = (_signal.SIGUSR1 if d.kind == SHRINK
                       else _signal.SIGUSR2)
                try:
                    os.kill(self.supervisor_pid, sig)
                except OSError as e:
                    if self.tracer is not None:
                        self.tracer.event("autoscale_act_failed",
                                          decision=d.kind, error=str(e))
                    continue
            if self.tracer is not None:
                self.tracer.event("autoscale_act", decision=d.kind, n=d.n,
                                  value=d.value, victim=d.victim)

    def run(self, duration_s: float = 0.0,
            interval_s: Optional[float] = None,
            stop_after_notice: bool = False) -> dict:
        """Poll until ``duration_s`` elapses (0 = forever /
        KeyboardInterrupt) or, with ``stop_after_notice``, until a
        preemption notice has been acted on — the drill mode the chaos
        harness drives. Returns a run summary."""
        interval = (interval_s if interval_s is not None
                    else self.cfg.control_interval_s)
        start = _time.monotonic()
        ticks = 0
        try:
            while True:
                _, decisions = self.step()
                ticks += 1
                if stop_after_notice and any(d.kind == PRE_DRAIN
                                             for d in decisions):
                    break
                if duration_s and _time.monotonic() - start >= duration_s:
                    break
                _time.sleep(interval)
        except KeyboardInterrupt:
            pass
        finally:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
        summary = {"control_ticks": ticks, "acted": dict(self.acted),
                   "wall_s": _time.monotonic() - start}
        if self.tracer is not None:
            self.tracer.event("autoscale_summary", **summary)
        return summary
