"""Deterministic fault injection: the FaultPlan and its in-loop injector
(``fedtpu.resilience.faults``).

A FaultPlan is a seeded, JSON-driven schedule of failures the round loop
applies to itself: the same plan against the same config gives the same
fault at the same round on every run, so recovery (supervisor restart,
divergence rollback) is testable as an exact equality.

Plan schema (path or inline JSON via ``RunConfig.fault_plan`` /
``run --fault-plan``)::

    {"seed": 0,
     "faults": [
       {"kind": "client_dropout", "round": 3, "clients": [1]},
       {"kind": "straggler",      "round": 2, "clients": [0], "delay_s": 0.05},
       {"kind": "nan_update",     "round": 4, "clients": [2]},
       {"kind": "process_kill",   "round": 5, "signal": "SIGKILL",
        "process_index": 0},
       {"kind": "ckpt_corrupt",   "round": 6}]}

``round`` is 1-based. Instead of a fixed ``round`` an entry may carry
``"probability": p`` with an optional ``"rounds": [lo, hi]`` window,
materialized once at load time from the plan seed
(``np.random.RandomState``), so the schedule, and its digest, are a pure
function of the plan: equal to ``fedtpu``'s for the same spec.

The kinds, on the port's flat state (``params (C, D)``):

* ``client_dropout`` — zero the named clients' sample-mask rows for that
  one round, in place (the mask is a static input of the round's CUDA
  graph). Under ``weighting='data_size'`` fedtpu's in-graph weights are
  ``mask.sum(axis=1)``; the port's are the build-time shard sizes, so
  their rows are zeroed too: the dropped client's aggregation weight is
  exactly zero. ``"sticky": true`` keeps the client out for the rest of
  the run.
* ``straggler`` — ``time.sleep(delay_s)`` on the host before the round:
  only timing changes.
* ``nan_update`` — NaN into the named rows of ``state["params"]``, in
  place; the loop's divergence guard fires (halt or rollback).
* ``process_kill`` — ``os.kill(self, signal)`` when this process's index
  matches: SIGKILL dies mid-round, SIGTERM exercises the drain.
* ``ckpt_corrupt`` — truncate and stomp the latest complete checkpoint's
  largest state file (its one ``torch.save`` archive, or a gang round's
  largest part), caught only by the restore's fallback walk.
* ``collective_hang`` — the matching process sleeps ``delay_s`` (default:
  about forever) before the round; in a training gang its peers then stall
  in the round's exchange until their collective watchdog fires.
  ``process_index: -1`` on it or on ``process_kill`` means every process.
* ``preempt_notice`` / ``preempt_cancel`` — the elastic-reshard schedule,
  consumed by the reshard controller (``fedtpu_torch.resilience.reshard``):
  a live shrink to ``target_clients`` and the grow back, with no
  restart.

A plan names clients by their index in the whole run. In a training gang
every member holds the whole plan and applies a client's fault only to the
rows it owns (``FaultInjector(rows=)``): a dropout zeroes the owner's mask
and weight rows, a ``nan_update`` poisons the owner's params rows, and the
gang's own consensus (the chunk's gathered metrics and finiteness flag)
makes the rest of the decision the same on every member.

Only the in-loop edits touch torch (the plan itself is numpy and JSON)."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal as _signal
import time
from typing import Optional, Sequence, Tuple

import numpy as np

KINDS = ("client_dropout", "straggler", "nan_update", "process_kill",
         "ckpt_corrupt", "collective_hang", "preempt_notice",
         "preempt_cancel")

# Faults that fire at most once per RUN, across supervisor restarts: a
# restarted run resumes below the fault round, so re-arming a kill would
# loop forever. Armed only on the first launch (FEDTPU_RESTARTS == 0).
ONCE_KINDS = ("process_kill", "ckpt_corrupt", "collective_hang",
              "preempt_notice", "preempt_cancel")

# Kinds consumed by the elastic-reshard controller, never
# applied by the injector; their rounds still bound the chunk width.
RESHARD_KINDS = ("preempt_notice", "preempt_cancel")

# process_index=-1 on a process-targeted fault means every process.
ALL_PROCESSES = -1

_SIGNALS = ("SIGKILL", "SIGTERM", "SIGINT")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One materialized fault occurrence."""

    kind: str
    round: int                        # 1-based round the fault strikes
    clients: Tuple[int, ...] = ()
    delay_s: float = 0.0              # straggler / collective_hang
    signal: str = "SIGKILL"           # process_kill only
    process_index: int = 0            # process_kill / preempt_* only
    sticky: bool = False              # client_dropout only
    target_clients: int = 0           # preempt_* only: post-reshard C

    def payload(self) -> dict:
        """Tracer-event payload (only the fields this kind uses); the kind
        is keyed ``fault`` (``kind`` is the event's own slot)."""
        out = {"fault": self.kind, "fault_round": self.round}
        if self.clients:
            out["clients"] = list(self.clients)
        if self.kind == "straggler":
            out["delay_s"] = self.delay_s
        if self.kind == "process_kill":
            out["signal"] = self.signal
            out["process_index"] = self.process_index
        if self.kind == "collective_hang":
            out["process_index"] = self.process_index
            if self.delay_s:
                out["delay_s"] = self.delay_s
        if self.kind in RESHARD_KINDS:
            out["process_index"] = self.process_index
            out["target_clients"] = self.target_clients
        if self.sticky:
            out["sticky"] = True
        return out


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Materialized, validated fault schedule + its content digest."""

    seed: int
    faults: Tuple[Fault, ...]
    digest: str                       # sha256[:16] of the canonical dump

    @classmethod
    def load(cls, spec, num_clients: int, rounds: int) -> "FaultPlan":
        """Parse, materialize and validate a plan. ``spec`` is a JSON file
        path, an inline JSON string (first non-space char ``{``), or a
        parsed dict. Probabilistic entries are expanded here, so the plan
        and its digest are the exact schedule the run executes."""
        if isinstance(spec, str):
            if spec.lstrip().startswith("{"):
                raw = json.loads(spec)
            else:
                with open(spec) as fh:
                    raw = json.load(fh)
        else:
            raw = dict(spec)
        if not isinstance(raw, dict):
            raise ValueError("fault plan must be a JSON object with a "
                             "'faults' list")
        seed = int(raw.get("seed", 0))
        rng = np.random.RandomState(seed)
        faults = []
        for i, entry in enumerate(raw.get("faults", ())):
            kind = entry.get("kind")
            if kind not in KINDS:
                raise ValueError(f"fault #{i}: unknown kind {kind!r} "
                                 f"(one of {KINDS})")
            if "probability" in entry:
                p = float(entry["probability"])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"fault #{i}: probability {p} outside "
                                     "[0, 1]")
                lo, hi = entry.get("rounds", (1, rounds))
                lo, hi = int(lo), int(hi)
                # One draw per round of the window, in round order.
                hits = [lo + j for j, u
                        in enumerate(rng.random_sample(max(0, hi - lo + 1)))
                        if u < p]
            else:
                if "round" not in entry:
                    raise ValueError(f"fault #{i}: needs 'round' or "
                                     "'probability'")
                hits = [int(entry["round"])]
            clients = tuple(int(c) for c in entry.get("clients", ()))
            for c in clients:
                if not 0 <= c < num_clients:
                    raise ValueError(f"fault #{i}: client {c} outside "
                                     f"[0, {num_clients})")
            if kind in ("client_dropout", "nan_update") and not clients:
                raise ValueError(f"fault #{i}: {kind} needs 'clients'")
            sig = str(entry.get("signal", "SIGKILL"))
            if kind == "process_kill" and sig not in _SIGNALS:
                raise ValueError(f"fault #{i}: signal {sig!r} not one of "
                                 f"{_SIGNALS}")
            delay = float(entry.get("delay_s", 0.0))
            if kind == "straggler" and delay <= 0:
                raise ValueError(f"fault #{i}: straggler needs delay_s > 0")
            target = int(entry.get("target_clients", 0))
            if kind == "preempt_notice" and not 1 <= target < num_clients:
                raise ValueError(
                    f"fault #{i}: preempt_notice needs target_clients in "
                    f"[1, {num_clients}) — the post-shrink client count")
            if kind == "preempt_cancel" and not 0 <= target <= num_clients:
                raise ValueError(
                    f"fault #{i}: preempt_cancel target_clients {target} "
                    f"outside [0, {num_clients}] (0 = the original count)")
            for k in hits:
                if not 1 <= k <= rounds:
                    raise ValueError(f"fault #{i}: round {k} outside "
                                     f"[1, {rounds}]")
                faults.append(Fault(
                    kind=kind, round=k, clients=clients, delay_s=delay,
                    signal=sig,
                    process_index=int(entry.get("process_index", 0)),
                    sticky=bool(entry.get("sticky", False)),
                    target_clients=target))
        faults.sort(key=lambda f: f.round)
        canon = json.dumps(
            {"seed": seed,
             "faults": [dataclasses.asdict(f) for f in faults]},
            sort_keys=True)
        return cls(seed=seed, faults=tuple(faults),
                   digest=hashlib.sha256(canon.encode()).hexdigest()[:16])


def _rows(clients: Sequence[int], device):
    import torch
    return torch.as_tensor(tuple(clients), dtype=torch.long, device=device)


def local_rows(clients: Sequence[int], rows: Tuple[int, int]) -> list:
    """The run's ``clients`` that a training gang member owns, as its own
    row indices: ``rows`` ``(first, count)`` is its block (``(0, C)``, all
    of them unmoved, outside a gang)."""
    first, count = rows
    return [c - first for c in clients if first <= c < first + count]


def drop_clients(mask, clients: Sequence[int], weights=None) -> None:
    """Zero the named clients' sample-mask rows IN PLACE (and their rows of
    ``weights``, the data-size FedAvg weights, when given): exact weight-0
    exclusion and exclusion from the client-mean metrics. Shared by the
    dropout fault and rollback exclusion."""
    mask.index_fill_(0, _rows(clients, mask.device), 0.0)
    if weights is not None:
        weights.index_fill_(0, _rows(clients, weights.device), 0.0)


def poison_client_slots(params, clients: Sequence[int]) -> None:
    """NaN into the named client rows of the flat ``params (C, D)``, in
    place (any floating dtype)."""
    params.index_fill_(0, _rows(clients, params.device), float("nan"))


def perturb_params(params, attempt: int, scale: float, *,
                   rows: Tuple[int, int], uniform=None) -> None:
    """Rollback retry #``attempt``'s restart point, in place:
    ``params * (1 + scale * (2u - 1))``, ``u ~ U[0, 1)``. ``uniform``
    (the draw, shaped like ``params``) replaces the port's own, e.g. with
    ``fedtpu``'s ``jax.random`` draw in the flat layout; the port's own
    follows the same law from a ``torch.Generator`` seeded by ``attempt``
    on the state's device, so every re-run perturbs identically. ``rows``
    ``(first, total)``: ``params`` are the block of a run of ``total``
    clients starting at row ``first`` (``(0, C)`` in one process); the
    draw is the whole run's ``(total, D)``, one process's, of which a gang
    member takes its rows (as ``fedtpu``'s one key over the whole
    tree)."""
    import torch
    if uniform is None:
        first, total = rows
        gen = torch.Generator(device=params.device)
        gen.manual_seed(int(attempt))
        uniform = torch.rand((total,) + tuple(params.shape[1:]),
                             generator=gen, dtype=params.dtype,
                             device=params.device)[
                                 first:first + params.shape[0]]
    else:
        uniform = torch.as_tensor(uniform).to(device=params.device,
                                              dtype=params.dtype)
    params.mul_(1.0 + scale * (2.0 * uniform - 1.0))


def corrupt_checkpoint(directory: str, step: Optional[int] = None,
                       mode: str = "stomp", fraction: Optional[float] = None,
                       seed: int = 0) -> Optional[int]:
    """In-place corruption of the latest complete checkpoint's largest
    state file, as ``fedtpu`` picks the largest file under the round's
    state: the port's ``round_<N>/state`` (one ``torch.save`` archive), or
    a gang round's largest ``state.p<i>-of-<P>`` part, ties to the lowest
    part. ``mode='stomp'``: truncate it to half and
    stomp its header. ``mode='torn'``: a torn write, truncated to a seeded
    fraction of its bytes (``fraction``, or uniform on [0.05, 0.6) by
    ``seed``), the prefix left intact. The round still looks committed, so
    only a restore (and ``load_checkpoint_fallback``'s walk) finds out.
    Returns the corrupted step, or None when there is nothing to
    corrupt."""
    if mode not in ("stomp", "torn"):
        raise ValueError(f"corrupt_checkpoint mode {mode!r}: "
                         "pick 'stomp' or 'torn'")
    from fedtpu_torch.orchestration.checkpoint import latest_step, state_files
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    # max keeps the first of equal sizes: ties go to the lowest part.
    target = max(state_files(directory, step), key=os.path.getsize)
    size = os.path.getsize(target)
    with open(target, "r+b") as fh:
        if mode == "torn":
            if fraction is None:
                fraction = float(
                    np.random.RandomState(seed).uniform(0.05, 0.6))
            fh.truncate(max(1, int(size * float(fraction))))
        else:
            fh.truncate(max(1, size // 2))
            fh.seek(0)
            fh.write(b"\xde\xad\xbe\xef" * 16)
    return step


class FaultInjector:
    """Applies a FaultPlan inside the round loop.

    The loop calls ``chunk_limit`` (shrink a chunk so a fault round runs as
    its own width-1 dispatch), ``pre_round`` (apply every fault due for the
    next round) and ``post_round`` (undo the non-sticky dropout).

    ``restart_count > 0`` (a supervisor restart, ``FEDTPU_RESTARTS``)
    disarms the once-per-run kinds, so a resumed run replays the fault
    window cleanly instead of re-killing itself forever.

    The port's edits are in place: the mask, the data-size weights and the
    params are static inputs of the round's CUDA graph, which a rebinding
    would leave reading the old buffers. ``post_round`` copies the saved
    rows back on the same stream, after the round's replay is queued.

    ``rows`` ``(first, count)``: a training gang member's block of the
    clients; a client fault edits only the rows of the clients in it
    (every fault still emits its event on every member). None: the plan's
    client indices are the rows themselves."""

    def __init__(self, plan: FaultPlan, restart_count: int = 0,
                 tracer=None, registry=None, process_index: int = 0,
                 rows: Optional[Tuple[int, int]] = None):
        self.plan = plan
        self._armed = [f for f in plan.faults
                       if f.kind not in RESHARD_KINDS
                       and not (f.kind in ONCE_KINDS and restart_count > 0)]
        self._reshard_rounds = tuple(
            f.round for f in plan.faults
            if f.kind in RESHARD_KINDS and restart_count == 0)
        self._tracer = tracer
        self._registry = registry
        self._proc = process_index
        # The member's block (first, count); the loop sets it again after
        # a live reshard moves it.
        self.rows = rows
        self._saved = None

    @property
    def armed_count(self) -> int:
        return len(self._armed)

    def chunk_limit(self, rnd: int, take: int) -> int:
        """Largest chunk width starting at 0-based round ``rnd`` that keeps
        every fault round in a width-1 dispatch (a fault at 1-based round k
        applies before round index k-1, and its undo needs that round to
        end the chunk)."""
        rounds = [f.round - 1 for f in self._armed if f.round - 1 >= rnd]
        rounds += [r - 1 for r in self._reshard_rounds if r - 1 >= rnd]
        nxt = min(rounds, default=None)
        if nxt is None or nxt >= rnd + take:
            return take
        return 1 if nxt == rnd else nxt - rnd

    def _event(self, f: Fault) -> None:
        if self._tracer is not None:
            self._tracer.event("fault", round=f.round, **f.payload())
        if self._registry is not None:
            self._registry.counter("faults_injected").inc()
            self._registry.counter(f"faults_{f.kind}").inc()

    def pre_round(self, rnd: int, state: dict, batch: dict,
                  checkpoint_dir: Optional[str] = None,
                  weights=None) -> list:
        """Apply every armed fault due at 0-based round ``rnd``, editing
        ``state["params"]``, ``batch["mask"]`` and ``weights`` (the
        data-size FedAvg weights, or None) in place. Returns the faults
        applied."""
        due = [f for f in self._armed if f.round - 1 == rnd]
        if not due:
            return due
        self._armed = [f for f in self._armed if f.round - 1 != rnd]
        mine = self.rows or (0, batch["mask"].shape[0])
        for f in due:
            # The event before the fault: SIGKILL never returns, and the
            # sink flushes per event.
            self._event(f)
            if f.kind == "client_dropout":
                if self._saved is None and not f.sticky:
                    self._saved = (batch["mask"].clone(),
                                   None if weights is None
                                   else weights.clone())
                drop_clients(batch["mask"], local_rows(f.clients, mine),
                             weights)
            elif f.kind == "straggler":
                time.sleep(f.delay_s)
            elif f.kind == "nan_update":
                poison_client_slots(state["params"],
                                    local_rows(f.clients, mine))
            elif f.kind == "process_kill":
                if f.process_index in (self._proc, ALL_PROCESSES):
                    os.kill(os.getpid(), getattr(_signal, f.signal))
            elif f.kind == "ckpt_corrupt":
                if checkpoint_dir and self._proc == 0:
                    corrupt_checkpoint(checkpoint_dir)
            elif f.kind == "collective_hang":
                if f.process_index in (self._proc, ALL_PROCESSES):
                    time.sleep(f.delay_s if f.delay_s > 0 else 3600.0)
        return due

    def post_round(self, rnd: int, batch: dict, weights=None) -> None:
        """Undo the non-sticky dropouts after the dispatch that consumed
        them: the mask (and weights) saved before the round's first one go
        back in place, so every later round is bitwise an unfaulted
        run's."""
        if self._saved is not None:
            mask, saved_weights = self._saved
            batch["mask"].copy_(mask)
            if weights is not None and saved_weights is not None:
                weights.copy_(saved_weights)
            self._saved = None

    def exclude(self, clients: Sequence[int]) -> None:
        """Rollback excluded these clients: drop their still-armed faults
        (a departed client cannot re-inject), which is what makes
        exclusion converge for a sticky divergence source."""
        cs = set(clients)
        self._armed = [f for f in self._armed
                       if not (f.clients and set(f.clients) <= cs)]
