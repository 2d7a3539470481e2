"""The live elastic reshard's protocol (``fedtpu.resilience.reshard``):
resize a training gang on a preemption notice, with no restart.

A gang supervisor (``fedtpu_torch.resilience.supervisor``) answers a
member's death by tearing the gang down and relaunching it with
``--resume``. This module turns a preemption NOTICE (the grace window a
scheduler gives a host before taking it) into a one-round live reshard:

1. **Notice.** The supervisor forwards SIGUSR1 (shrink) and SIGUSR2 (grow
   back) to every member; or a ``preempt_notice`` / ``preempt_cancel``
   entry of the fault plan names the round (every member holds the same
   plan, so no agreement is needed).
2. **Agreement.** A signal races the round loop, so each member publishes
   the loop-top round at which it saw the signal
   (``resilience.distributed.publish_reshard_record``, tagged with the
   launch's generation), and every member reshards at ``max(published) +
   1``: the first loop-top at which every peer's record is visible (a
   record published before round r's dispatch is readable at every peer's
   loop-top r + 1, since round r's collective orders the write before the
   read).
3. **Redistribution.** The survivors move the state with the wire-free
   plan (``fedtpu_torch.parallel.reshard``) and rebuild the round for the
   shrunk mesh; the departing member PARKS (heartbeat status ``parked``,
   its process, its CUDA context and its exchange buffer alive), so that a
   cancelled notice grows the gang back without a relaunch; at the run's
   end it exits ``EXIT_RESHARDED`` (76), which the supervisor takes as
   success.
4. **Commit.** A two-phase ack barrier (phase A: every member before the
   reshard is at its loop-top with no collective in flight; phase B:
   every member after it holds the moved state) bounds every failure: a
   participant that dies mid-reshard leaves the barrier to time out
   (``collective_timeout``, 60 s when unset), the survivors raise
   ``ReshardFailed``, and the crash takes the gang-restart path. The
   generation tags keep the relaunched gang from acting on this life's
   half-finished records.

The rejoining member's state travels through a SPOOL the survivors'
leader writes under ``.reshard/``: the replicated values, the join rows'
values (the live global model; moments start fresh, as an elastic
resume's joiner's) and a control blob (the metric history, the early-stop
comparator, the DP ledger), so the rejoiner needs nothing of its parked
copy but its structure. The spool is numpy (``.npz`` and ``.json``, as
``fedtpu``'s); 16-bit tensors travel as float32, which holds them exactly.

The round loop (``fedtpu_torch.orchestration.loop``) calls ``poll`` at
every loop-top and moves the state itself; every cross-process step lives
here. Torch-free, like the rest of the protocol's files."""

from __future__ import annotations

import dataclasses
import json
import os
import signal as _signal
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fedtpu_torch.resilience.distributed import (await_reshard_records,
                                                 heartbeat_path_for,
                                                 publish_reshard_record,
                                                 read_reshard_record,
                                                 reshard_dir)
from fedtpu_torch.resilience.faults import RESHARD_KINDS, FaultPlan
from fedtpu_torch.resilience.supervisor import EXIT_RESHARDED, write_heartbeat

__all__ = [
    "EXIT_RESHARDED",
    "ENV_PREEMPT_VICTIM",
    "ENV_RESHARD_CRASH",
    "ReshardFailed",
    "ReshardRequest",
    "ReshardController",
]

# The signal path's victim: the process index the notice targets (a real
# scheduler names the host; the drills set this variable). Default: the
# highest-indexed active process.
ENV_PREEMPT_VICTIM = "FEDTPU_PREEMPT_VICTIM"

# The failure drill: the matching process SIGKILLs itself after its
# reshard_begin event and before its phase-A ack, so its peers' barrier
# times out into the gang-restart path.
ENV_RESHARD_CRASH = "FEDTPU_RESHARD_CRASH"

_DONE = "run_done"


class ReshardFailed(RuntimeError):
    """The reshard could not complete (a participant died or never acked,
    or the shape cannot be resharded without a wire). The loop lets it
    propagate as a crash, so the gang supervisor restarts and resumes."""


@dataclasses.dataclass(frozen=True)
class ReshardRequest:
    """One agreed reshard, fired at a loop-top."""

    mode: str            # 'shrink' | 'grow'
    round: int           # 0-based loop-top round it fires at
    target_clients: int  # client count after it (0: the loop computes)
    victim: int          # departing or rejoining process (-1: none)
    seq: int             # the reshard's ordinal within the run
    # The signal path's agreement: (process, loop-top round it saw the
    # notice at) of every participant; empty for a plan entry.
    notices: tuple = ()


class ReshardController:
    """The reshard protocol of one process of one run: the plan's
    schedule, the signal path's agreement, the ack barriers, the grow
    spool and the victim's park loop."""

    def __init__(self, *, plan: Optional[FaultPlan] = None,
                 process_index: int = 0, process_count: int = 1,
                 launch_id: Optional[str] = None, restart_count: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 ack_timeout: float = 60.0, tracer=None, registry=None,
                 heartbeat: Optional[str] = None):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.launch_id = launch_id
        self.restart_count = int(restart_count)
        self.checkpoint_dir = checkpoint_dir
        self.ack_timeout = float(ack_timeout) if ack_timeout else 60.0
        self.tracer = tracer
        self.registry = registry
        self.heartbeat = heartbeat
        # The reshard kinds fire once a run: a gang restarted mid-reshard
        # resumes at the old topology and must not replay the notice that
        # just failed.
        self._scheduled = ([f for f in plan.faults
                            if f.kind in RESHARD_KINDS]
                           if plan is not None and restart_count == 0 else [])
        self.seq = 0
        self.active = tuple(range(self.process_count))
        self.parked_victim: Optional[int] = None
        # The signal path, lock-free on purpose: the handler runs on the
        # main thread between bytecodes and every other reader is the
        # main-thread loop; a lock taken in the handler would deadlock the
        # moment the signal lands while the loop holds it.
        self._sig_mode: Optional[str] = None
        self._notice_round: Optional[int] = None

    # ------------------------------------------------------------ signals

    def install_signal_handlers(self) -> None:
        """SIGUSR1 -> shrink notice, SIGUSR2 -> grow notice (main thread
        only, the signal module's rule)."""
        if threading.current_thread() is not threading.main_thread():
            return
        for name, mode in (("SIGUSR1", "shrink"), ("SIGUSR2", "grow")):
            sig = getattr(_signal, name, None)
            if sig is not None:
                _signal.signal(sig, self._make_handler(mode))

    def _make_handler(self, mode: str):
        def _handler(signum, frame):
            # A flag store only: no lock, no I/O.
            if self._sig_mode is None:
                self._sig_mode = mode
        return _handler

    def request_signal(self, mode: str) -> None:
        """The signal's programmatic stand-in (tests)."""
        if self._sig_mode is None:
            self._sig_mode = mode

    # ------------------------------------------------------------ polling

    def _default_victim(self, mode: str) -> int:
        env = os.environ.get(ENV_PREEMPT_VICTIM, "")
        if env:
            return int(env)
        if mode == "grow":
            return self.parked_victim if self.parked_victim is not None else -1
        return max(self.active) if self.active else -1

    def _poll_plan(self, rnd: int) -> Optional[ReshardRequest]:
        due = [f for f in self._scheduled if f.round - 1 == rnd]
        if not due:
            return None
        self._scheduled = [f for f in self._scheduled if f.round - 1 != rnd]
        f = due[0]
        mode = "shrink" if f.kind == "preempt_notice" else "grow"
        victim = f.process_index if self.process_count > 1 else -1
        if mode == "grow" and self.parked_victim is not None:
            victim = self.parked_victim
        return ReshardRequest(mode=mode, round=rnd,
                              target_clients=f.target_clients,
                              victim=victim, seq=self.seq)

    def _poll_signal(self, rnd: int) -> Optional[ReshardRequest]:
        mode = self._sig_mode
        if mode is None:
            return None
        if mode == "grow" and self.parked_victim is None \
                and self.process_count > 1:
            self._sig_mode = None       # nothing to grow back
            return None
        if self.process_count == 1:
            self._sig_mode = None
            return ReshardRequest(mode=mode, round=rnd, target_clients=0,
                                  victim=-1, seq=self.seq)
        if self.checkpoint_dir is None:
            raise ReshardFailed("signal-path reshard needs --checkpoint-dir "
                                "for the agreement records")
        name = f"notice{self.seq}"
        if self._notice_round is None:
            self._notice_round = rnd
            publish_reshard_record(
                self.checkpoint_dir, name, self.process_index,
                {"round": rnd, "mode": mode,
                 "victim": self._default_victim(mode)},
                self.restart_count, launch_id=self.launch_id)
        participants = (self.active if mode == "grow"
                        else tuple(range(self.process_count)))
        participants = tuple(p for p in participants
                             if p != self.parked_victim)
        records = {}
        for p in participants:
            rec = read_reshard_record(self.checkpoint_dir, name, p,
                                      self.restart_count,
                                      launch_id=self.launch_id)
            if rec is None:
                return None             # not all published yet
            records[p] = rec
        agreed = max(int(r["round"]) for r in records.values())
        if rnd < agreed + 1:
            return None                 # fire at the first loop-top after
        lead = records[min(records)]    # the last notice
        self._sig_mode = None
        self._notice_round = None
        return ReshardRequest(mode=str(lead["mode"]), round=rnd,
                              target_clients=0, victim=int(lead["victim"]),
                              seq=self.seq,
                              notices=tuple((p, int(r["round"]))
                                            for p, r in sorted(
                                                records.items())))

    def poll(self, rnd: int) -> Optional[ReshardRequest]:
        """At loop-top ``rnd`` (0-based): the reshard to run now, or None.
        A plan entry (exact round) comes first; a signal converges through
        the agreement."""
        req = self._poll_plan(rnd)
        if req is not None:
            return req
        return self._poll_signal(rnd)

    # ------------------------------------------------------- ack barriers

    def maybe_crash(self) -> None:
        """The failure drill: die unannounced mid-protocol when this
        process is the configured target."""
        if os.environ.get(ENV_RESHARD_CRASH, "") == str(self.process_index):
            os.kill(os.getpid(), _signal.SIGKILL)

    def publish_ack(self, seq: int, phase: str, rnd: int) -> None:
        if self.process_count == 1 or self.checkpoint_dir is None:
            return
        publish_reshard_record(self.checkpoint_dir, f"ack{seq}{phase}",
                               self.process_index, {"round": rnd},
                               self.restart_count, launch_id=self.launch_id)

    def await_acks(self, seq: int, phase: str, participants) -> None:
        """Block until every participant acked (seq, phase); a missing
        peer raises ``ReshardFailed``."""
        if self.process_count == 1 or self.checkpoint_dir is None:
            return
        try:
            await_reshard_records(self.checkpoint_dir, f"ack{seq}{phase}",
                                  participants, self.restart_count,
                                  launch_id=self.launch_id,
                                  timeout=self.ack_timeout)
        except TimeoutError as e:
            raise ReshardFailed(str(e)) from e

    # ------------------------------------------------------------- events

    def event(self, kind: str, rnd: int, **payload) -> None:
        if self.tracer is not None:
            self.tracer.event(kind, round=rnd, seq=self.seq,
                              process=self.process_index, **payload)
        if self.registry is not None:
            self.registry.counter(kind).inc()

    # -------------------------------------------------------------- spool

    def _spool_paths(self, seq: int) -> Tuple[str, str]:
        d = reshard_dir(self.checkpoint_dir)
        return (os.path.join(d, f"spool{seq}.npz"),
                os.path.join(d, f"spool{seq}.json"))

    def write_spool(self, seq: int, join_rows: Dict[str, np.ndarray],
                    replicated: Dict[str, np.ndarray],
                    control: dict) -> None:
        """The leader's export for a grow: each client tensor's join value
        by path, each replicated tensor by path, and the control blob.
        The npz first, then the json (both atomic); the rejoiner wakes on
        the grow record, published only after this returns."""
        npz_path, json_path = self._spool_paths(seq)
        os.makedirs(os.path.dirname(npz_path), exist_ok=True)
        payload = {f"J{p}": np.asarray(v) for p, v in join_rows.items()}
        payload.update({f"R{p}": np.asarray(v)
                        for p, v in replicated.items()})
        tmp = f"{npz_path}.tmp.{os.getpid()}.npz"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, npz_path)
        tmp = f"{json_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(dict(control, launch=self.launch_id,
                           restarts=self.restart_count), fh)
        os.replace(tmp, json_path)

    def read_spool(self, seq: int) -> Tuple[Dict[str, np.ndarray],
                                            Dict[str, np.ndarray], dict]:
        npz_path, json_path = self._spool_paths(seq)
        with np.load(npz_path, allow_pickle=False) as z:
            join = {k[1:]: z[k] for k in z.files if k.startswith("J")}
            repl = {k[1:]: z[k] for k in z.files if k.startswith("R")}
        with open(json_path) as fh:
            control = json.load(fh)
        if control.get("launch") != self.launch_id or \
                control.get("restarts") != self.restart_count:
            raise ReshardFailed(
                f"grow spool {json_path} belongs to another generation "
                f"(launch {control.get('launch')!r}, restarts "
                f"{control.get('restarts')!r})")
        return join, repl, control

    # --------------------------------------------------------------- park

    def park(self, seq: int, rnd: int) -> dict:
        """The departed member's wait: keep the process (and the
        supervisor's view of it) alive until the survivors grow the gang
        back (returns the leader's grow record) or the run ends (the
        run-done marker, or a SIGTERM from the supervisor), then exit
        ``EXIT_RESHARDED``."""
        leader = min(p for p in self.active if p != self.process_index)
        hb_path = (heartbeat_path_for(self.heartbeat, self.process_index)
                   if self.heartbeat else None)
        stop = {"sig": None}
        restore = []
        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                stop["sig"] = signum
            for s in (_signal.SIGTERM, _signal.SIGINT):
                restore.append((s, _signal.signal(s, _on_term)))
        done_path = os.path.join(reshard_dir(self.checkpoint_dir), _DONE)
        last_beat = 0.0

        def depart():
            # The heartbeat says so first: the supervisor nudges a member
            # only while it reads ``parked``, and a nudge that reached this
            # process after its park would kill it mid-exit.
            if hb_path:
                try:
                    write_heartbeat(hb_path, status="departed", round=rnd,
                                    restarts=self.restart_count)
                except OSError:
                    pass
            raise SystemExit(EXIT_RESHARDED)

        try:
            while True:
                if stop["sig"] is not None:
                    depart()
                try:
                    with open(done_path) as fh:
                        rec = json.load(fh)
                except (OSError, ValueError):
                    rec = {}
                if rec.get("launch", 0) == self.launch_id:
                    depart()
                grow = read_reshard_record(self.checkpoint_dir,
                                           f"grow{seq + 1}", leader,
                                           self.restart_count,
                                           launch_id=self.launch_id)
                if grow is not None:
                    return grow
                now = time.monotonic()
                if hb_path and now - last_beat >= 2.0:
                    try:
                        write_heartbeat(hb_path, status="parked", round=rnd,
                                        restarts=self.restart_count)
                    except OSError:
                        pass
                    last_beat = now
                time.sleep(0.25)
        finally:
            for s, h in restore:
                _signal.signal(s, h)

    def publish_grow(self, seq: int, rnd: int, payload: dict) -> None:
        """The survivors' grow announcement the parked member polls for;
        published after ``write_spool``, so its visibility implies the
        spool's completeness."""
        if self.process_count == 1 or self.checkpoint_dir is None:
            return
        publish_reshard_record(self.checkpoint_dir, f"grow{seq}",
                               self.process_index, dict(payload, round=rnd),
                               self.restart_count, launch_id=self.launch_id)

    # ---------------------------------------------------------- run end

    def finish(self) -> None:
        """The run-end marker for a member still parked (the leader only,
        the lowest active index); nothing when nobody is parked."""
        if (self.parked_victim is None or self.checkpoint_dir is None
                or self.process_index != min(self.active)):
            return
        path = os.path.join(reshard_dir(self.checkpoint_dir), _DONE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"launch": self.launch_id,
                       "restarts": self.restart_count,
                       "time": time.time()}, fh)
        os.replace(tmp, path)

    # ------------------------------------------------------- bookkeeping

    @property
    def pending(self) -> bool:
        """A reshard is scheduled or signalled and not yet run."""
        return self._sig_mode is not None or bool(self._scheduled)

    def clear_signal(self) -> None:
        self._sig_mode = None

    def committed(self, mode: str, victim: int) -> None:
        """Record a completed reshard: the ordinal and the active set (who
        takes part in barriers and checkpoints)."""
        self.seq += 1
        if mode == "shrink" and victim >= 0:
            self.active = tuple(p for p in self.active if p != victim)
            self.parked_victim = victim
        elif mode == "grow" and victim >= 0:
            self.active = tuple(sorted(set(self.active) | {victim}))
            self.parked_victim = None
