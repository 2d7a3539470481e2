"""ServingEngine: admitted arrivals -> driven FedBuff ticks (the port's
copy of ``fedtpu.serving.engine``).

The bridge between the ingestion path (traces / sockets / admission) and
the asynchronous engine (``fedtpu_torch.parallel.async_fed``). A bounded
COHORT of ``C`` engine slots stands in for millions of users: each user
gets a STABLE slot through a :class:`SlotBinder` (LRU over the C slots),
so two concurrently-active users never share a slot. Engine memory stays
cohort-sized while the arrival stream is unbounded. Admitted updates queue
per user; when a tick fires, every bound slot with an eligible queued
update "arrives" in that tick's ``(1, C)`` signed mask and the driven step
(``build_async_round_fn(driven=True)``) trains exactly those slots.
Multiple updates queued on one slot coalesce into that one arrival: tick
count scales with the flush cadence, not the arrival count.

Eviction (a new user arriving with all C slots bound) reclaims the
least-recently-active user's slot. Without a store the incoming user
inherits the evictee's warm slot state. With a
:class:`fedtpu_torch.cohort.store.ClientStateStore` attached
(:meth:`ServingEngine.attach_store`), eviction persists the evictee's slot
into its record and loads the incomer's record (if it has one) into the
slot, for each of the tick's binds, before the device step: per-user
identity over a population far larger than the C slots. On the card the
slot's tensors are the captured graph's static buffers, so a swap writes
INTO them (``index_copy_``), never rebinding the state.

Two clocks, deliberately separate:

- the VIRTUAL clock (trace timestamps) drives everything semantic:
  admission, tick firing, staleness, and the update-to-incorporation
  latency (tick virtual time minus arrival ``t``). The per-tick metric
  history therefore contains only virtual-time numerics and is
  bitwise-identical across replays of the same trace + seed, and equal to
  ``fedtpu``'s;
- the WALL clock is only ever used for throughput telemetry
  (rounds/sec-under-load in the drain summary), never for decisions.

Ticks fire on either cadence (both may be active):
- time-driven: every ``tick_interval_s`` virtual seconds;
- count-driven: as soon as ``flush_every`` eligible updates pend.

Deprioritized admissions become eligible one tick LATER than accepted
ones, so deprioritization is a measurable latency penalty, not a no-op.

Version bookkeeping mirrors the device's K-buffer rule exactly on the
host (arrived-slot counts accumulate; the version bumps when
``buffer_size`` arrivals have accumulated): no device read on the hot
path. Staleness of an arriving update is inferred server-side: the client
pulled at ``t - lat``, so its version is the newest apply at or before
that time (an explicit ``version`` in the message wins).

On the card a tick is one replay of the driven step captured once as a
CUDA graph (``parallel.round.capture_round_step``): its K1 (the sum mode,
twice under the screen) and K2 launches and the local step's GEMMs, with
the tick's mask written into the graph's input. The only host read of a
tick is the screen's ``(C,)`` flags, and only with ``screen=True``.
``eval_accuracy`` runs K3 on the card. On the CPU the kernels' plain
versions run. torch is imported lazily in ``__init__``: constructing
configs or importing this module stays backend-free (loadgen).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from fedtpu_torch.serving.admission import (ADMITTED, DEPRIORITIZE,
                                            SCREENED, VERDICTS,
                                            AdmissionController,
                                            AdmissionPolicy)
from fedtpu_torch.telemetry.metrics import (Histogram, MetricsRegistry,
                                            default_registry)
from fedtpu_torch.telemetry.report import _percentiles
from fedtpu_torch.telemetry.trace import NullTracer

# Prometheus-style `le` upper bounds for update-to-incorporation latency
# (virtual seconds). Sub-tick to minutes: covers flush cadences from the
# bench's tight loops to lazy 30 s intervals.
LATENCY_BINS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                  10.0, 30.0, 60.0)

# History keys, in row order. One value per fired tick; everything is
# virtual-time-derived, which is what makes the history replayable
# bitwise (module docstring).
HISTORY_KEYS = ("tick_t", "tick_updates", "tick_slots", "tick_version",
                "tick_nbuf", "tick_pending")
# The integer ones: a checkpoint stores the history as float64, and a
# resumed row must serialize byte-identically to a fresh one.
_HISTORY_INTS = frozenset({"tick_updates", "tick_slots", "tick_version",
                           "tick_pending"})

# Exact-latency window: summary() percentiles are computed over at most
# this many most-recent incorporation latencies. The cumulative
# ``update_to_incorporation`` Histogram keeps the FULL-run distribution;
# the window only bounds the exact list so a long-running server does
# not grow one float per incorporated update forever.
LATENCY_WINDOW = 100_000

# Apply-log compaction bounds: once the (apply time, version) log passes
# MAX entries it is trimmed to the KEEP newest. Verdict-preserving as
# long as ``stale_reject < _APPLIES_KEEP`` (see _compact_applies).
_APPLIES_MAX = 8192
_APPLIES_KEEP = 4096

# Rolling-norm ring width for the defense screen (cfg.screen=True): the
# device's rolling median spans this many accepted ticks. Fixed rather
# than configurable — the ring rides the engine state/checkpoints, and a
# width change would invalidate every checkpoint for a tuning knob
# nobody needs to turn (warmup/mult are the tuning surface).
SCREEN_WINDOW = 64


@dataclass(frozen=True)
class _Pending:
    """One admitted, not-yet-incorporated update."""

    t: float            # virtual arrival time
    user: int
    elig_tick: int      # first tick index this entry may ride
    poison: float = 0.0  # adversarial weight scale (traces v2); 0 = honest
    # Causal trace id of the frame that carried this update
    # (protocol.trace_id). Telemetry-only: NOT persisted by checkpoint()
    # — pendings restored across a kill lose trace attribution, but the
    # WAL replay re-offers them with their original trace so the live
    # resume path keeps the chain intact.
    trace_id: Optional[str] = None


class SlotBinder:
    """Stable user -> engine-slot binding with LRU eviction.

    Replaces the residue map ``user % C``: a binding, once made, holds
    until the user is the least-recently-active one AND a new user needs
    a slot — so no two simultaneously-active users ever share a slot.
    All decisions are pure functions of the (deterministic) bind-call
    order, keeping trace replays bitwise-identical. Recency is
    participation order, touched once per ``bind``.
    """

    def __init__(self, capacity: int):
        from collections import OrderedDict
        self.capacity = int(capacity)
        self._slot_of: dict = {}
        self._order = OrderedDict()          # oldest-bound-user first
        # pop() hands out the lowest free slot first, so a fresh binder
        # fills slots 0, 1, 2, ... in first-arrival order.
        self._free = list(range(self.capacity - 1, -1, -1))
        self.evictions = 0

    def peek(self, user: int):
        """The user's current slot, or None — no recency touch."""
        return self._slot_of.get(int(user))

    def bind(self, user: int):
        """Return ``(slot, evicted_user)``; ``evicted_user`` is None
        unless this bind reclaimed an LRU slot."""
        user = int(user)
        if user in self._slot_of:
            self._order.move_to_end(user)
            return self._slot_of[user], None
        if self._free:
            slot, evicted = self._free.pop(), None
        else:
            evicted, _ = self._order.popitem(last=False)
            slot = self._slot_of.pop(evicted)
            self.evictions += 1
        self._slot_of[user] = slot
        self._order[user] = None
        return slot, evicted

    def state(self) -> dict:
        """Checkpoint view: users in LRU order + their slots."""
        users = list(self._order)
        return {"users": np.asarray(users, np.int64),
                "slots": np.asarray([self._slot_of[u] for u in users],
                                    np.int64),
                "evictions": np.int64(self.evictions)}

    def restore_state(self, users, slots, evictions: int = 0) -> None:
        from collections import OrderedDict
        self._slot_of = {int(u): int(s) for u, s in zip(users, slots)}
        self._order = OrderedDict((int(u), None) for u in users)
        bound = set(self._slot_of.values())
        self._free = [s for s in range(self.capacity - 1, -1, -1)
                      if s not in bound]
        self.evictions = int(evictions)


@dataclass
class EngineClock:
    """Virtual clock + tick-firing schedule (pure host arithmetic,
    split out so tests can pin the cadence without a device)."""

    tick_interval_s: float
    now: float = 0.0
    next_fire: float = field(init=False)

    def __post_init__(self):
        self.next_fire = self.tick_interval_s

    def advance(self, t: float) -> None:
        # Arrival timestamps are sorted (traces.py enforces it); clamping
        # instead of raising keeps multi-connection servers alive when
        # two loadgens interleave slightly out of order.
        self.now = max(self.now, float(t))

    def due(self) -> bool:
        return self.tick_interval_s > 0 and self.now >= self.next_fire

    def fire_time(self) -> float:
        """Consume one scheduled firing, returning its virtual time."""
        t = self.next_fire
        self.next_fire += self.tick_interval_s
        return t


def _observe_array(hist: Histogram, values: np.ndarray) -> None:
    """Vectorized ``Histogram.observe_many`` — identical semantics, numpy
    reductions instead of a per-value Python loop (the hot path sees a
    tick's whole latency batch at once; 1M-arrival replays would spend
    seconds in the scalar loop)."""
    if values.size == 0:
        return
    hist.count += int(values.size)
    hist.sum += float(values.sum())
    hist.min = min(hist.min, float(values.min()))
    hist.max = max(hist.max, float(values.max()))
    for i, b in enumerate(hist.bins):
        hist.bucket_counts[i] += int((values <= b).sum())


class ServingEngine:
    """Feeds a driven async FedBuff state from admitted arrivals.

    Single-threaded by design, like the round loop — the server's socket
    loop and in-process replays both call it from one thread.
    """

    def __init__(self, cfg, registry: Optional[MetricsRegistry] = None,
                 tracer=None, device="cuda", init_params=None,
                 capture: Optional[bool] = None):
        """``cfg`` is a :class:`fedtpu_torch.config.ServingConfig`.

        ``device``: the card by default, ``"cpu"`` for the plain versions.
        ``init_params``: a ``(C, D)`` tensor of the slots' initial params
        (e.g. ``fedtpu``'s own, through ``convert.params_from_jax``);
        without it the port draws its own, from a ``torch.Generator``
        seeded ``cfg.seed``. ``capture``: None captures the tick as a CUDA
        graph on the card (and runs it eagerly on the CPU); False runs it
        uncaptured on the card too; True on the CPU raises."""
        import torch

        from fedtpu_torch.config import ModelConfig, OptimConfig, ShardConfig
        from fedtpu_torch.data.sharding import pack_clients
        from fedtpu_torch.data.tabular import synthetic_income_like
        from fedtpu_torch.models.registry import build_model
        from fedtpu_torch.ops.optim import build_optimizer
        from fedtpu_torch.orchestration.loop import resolve_device
        from fedtpu_torch.parallel import async_fed
        from fedtpu_torch.parallel.round import (CAPTURE_LOCK,
                                                 capture_round_step,
                                                 warm_up_round)

        self.cfg = cfg
        self.registry = registry if registry is not None else default_registry()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.C = int(cfg.cohort)
        self.M = int(cfg.buffer_size)
        self._apply_n = self.M if self.M >= 2 else 1
        # Poisoning defense (fedtpu_torch.robust).
        self.screen = bool(cfg.screen)
        self.quarantine_strikes = int(cfg.quarantine_strikes)

        self.admission = AdmissionController(
            AdmissionPolicy(rate_limit=cfg.rate_limit,
                            rate_burst=cfg.rate_burst,
                            max_pending=cfg.max_pending,
                            stale_deprioritize=cfg.stale_deprioritize,
                            stale_reject=cfg.stale_reject,
                            window_s=cfg.admission_window_s),
            registry=self.registry)
        self.clock = EngineClock(tick_interval_s=cfg.tick_interval_s)
        self.flush_every = int(cfg.flush_every)
        # Default landing spot for pre_drain() spools (run_server points
        # this at the checkpoint dir); None = caller must pass a path.
        self.spool_dir: Optional[str] = None
        # Idempotent sessions: nonce -> [high-water seq, last ack counts].
        # A frame retried after a lost ack replays its ORIGINAL ack
        # instead of re-incorporating (session_check); checkpointed so
        # the contract survives a kill+resume.
        self._sessions: dict = {}
        self.duplicate_drops = 0
        # Optional write-ahead log: session-stamped frames are appended
        # BEFORE incorporation, so an ack can never outlive the update it
        # acknowledged; a kill between ack and checkpoint is replayed by
        # replay_wal() on resume.
        self.wal_path: Optional[str] = None

        # The cohort's training fixture: synthetic income-shaped shards,
        # one per slot, as fedtpu's.
        self.device = resolve_device(device)
        dev = self.device
        x, y = synthetic_income_like(cfg.data_rows, cfg.data_features,
                                     cfg.data_classes, seed=cfg.seed)
        packed = pack_clients(x, y, ShardConfig(num_clients=self.C,
                                                shuffle=False))
        self.model = build_model(ModelConfig(
            input_dim=cfg.data_features, num_classes=cfg.data_classes,
            hidden_sizes=tuple(cfg.model_hidden)))
        tx = build_optimizer(OptimConfig())
        self.batch = {k: torch.from_numpy(v).to(dev) for k, v in
                      {"x": packed.x, "y": packed.y,
                       "mask": packed.mask}.items()}
        if init_params is None:
            # The served slots' shared model, drawn from a generator seeded
            # cfg.seed (the screened cell's knobs were set on this draw).
            init_params = self.model.init(torch.Generator().manual_seed(
                int(cfg.seed))).expand(self.C, -1)
        self.state = async_fed.init_async_state(
            None, self.C,
            self.model, tx, same_init=True, device=dev, params=init_params,
            buffer_size=self.M,
            screen_window=SCREEN_WINDOW if self.screen else 0)
        self.step = async_fed.build_async_round_fn(
            self.model, tx, cfg.data_classes, self.C,
            staleness_power=cfg.staleness_power, server_lr=cfg.server_lr,
            local_steps=cfg.local_steps, buffer_size=self.M,
            ticks_per_step=1, driven=True,
            screen=self.screen,
            screen_norm_mult=float(cfg.screen_norm_mult),
            screen_cos_min=float(cfg.screen_cos_min),
            screen_warmup=int(cfg.screen_warmup),
            screen_window=SCREEN_WINDOW,
            clip_norm=float(cfg.screen_clip_norm))
        # Where the screened flags sit in the captured graph's packed
        # outputs (parallel.round.pack_outputs: loss (C,), counts
        # (C, K, K), then the per-client entries in step.outputs' order).
        self._screened_at = (self.C * (1 + cfg.data_classes ** 2)
                             + self.C * self.step.outputs[0].index(
                                 "screened") if self.screen else 0)
        # The full fixture, for eval_accuracy (the containment metric).
        self._eval_x = torch.from_numpy(x).to(dev)
        self._eval_y = torch.from_numpy(y).to(dev)
        self._graph = None
        if capture is None:
            capture = dev.type == "cuda"
        if capture:
            # One eager tick (result dropped: its launches are real and
            # counted), then the capture; every fired tick is a replay.
            # Engines built in several threads (the gateway fleet) take
            # the two steps one engine at a time; a failed capture raises.
            with CAPTURE_LOCK:
                warm_up_round(self.step, self.state, self.batch)
                self._graph = capture_round_step(self.step, self.state,
                                                 self.batch)

        # Host-side serving state (all of it checkpointed; see
        # checkpoint()/restore()).
        self.binder = SlotBinder(self.C)
        self.store = None            # optional ClientStateStore (attach_store)
        # Defense reputation: screened-update strikes per user; at
        # quarantine_strikes the user id is quarantined — refused at
        # offer().
        self.strikes: dict = {}
        self.quarantined: set = set()
        self.screened_total = 0
        # Canonical defense decision rows (virtual-time-derived only) —
        # the defense_sim golden artifact reads these.
        self.defense_log: list = []
        self.pending: list[_Pending] = []
        self.tick_count = 0
        self.version = 0
        self.nbuf_host = 0.0
        self.incorporated = 0
        # Apply history for server-side staleness inference: parallel
        # sorted arrays of (virtual apply time, version after the apply).
        self._applies_t: list[float] = []
        self._applies_v: list[int] = []
        self.history: dict = {k: [] for k in HISTORY_KEYS}
        self.latencies: list[float] = []
        self._lat_hist = self.registry.histogram("update_to_incorporation",
                                                 bins=LATENCY_BINS_S)
        self._wall_start = time.monotonic()

    # ------------------------------------------------------------------
    # ingestion

    def pulled_version(self, t_pull: float) -> int:
        """The model version a client that pulled at ``t_pull`` got."""
        i = bisect.bisect_right(self._applies_t, t_pull)
        return self._applies_v[i - 1] if i else 0

    def _compact_applies(self) -> None:
        """Trim the apply log to the ``_APPLIES_KEEP`` newest entries once
        it passes ``_APPLIES_MAX`` — only recent entries are ever
        decisive. Verdict-preserving: each log entry bumps the version by
        one, so a pull older than the kept window is at least
        ``_APPLIES_KEEP`` versions stale whether looked up in the full
        log (true pulled version) or the trimmed one (floor of 0); both
        sides of every ``stale_reject < _APPLIES_KEEP`` bar agree, so
        replay determinism and the resume contract are untouched. An
        exotic config with a deeper staleness bar keeps the full log."""
        if (len(self._applies_t) > _APPLIES_MAX
                and self.admission.policy.stale_reject < _APPLIES_KEEP):
            del self._applies_t[:-_APPLIES_KEEP]
            del self._applies_v[:-_APPLIES_KEEP]

    def _trace(self, stage: str, trace, **fields) -> None:
        """Emit one causal-trace event (kind 'trace', phase = stage) for
        the logical frame ``trace`` (protocol.trace_id). No-op without a
        trace id so untraced paths (tests driving offer() directly, old
        clients) pay one truthiness check."""
        if trace:
            self.tracer.event("trace", phase=stage, round=self.tick_count,
                              trace_id=str(trace), **fields)

    def offer(self, t: float, user: int, lat: float,
              version: Optional[int] = None, poison: float = 0.0,
              trace: Optional[str] = None) -> str:
        """Admit (or not) one arriving update; fires any due ticks first.

        Returns the admission verdict. Admitted updates queue per USER
        (the slot is bound at tick time by the :class:`SlotBinder`) and
        become eligible at the NEXT tick (one tick later when
        deprioritized). ``poison`` is the trace-carried adversarial
        weight scale (0 for honest updates) — the fault-injection hook
        the defense screen is measured against. ``trace`` is the causal
        trace id of the carrying frame: the admission verdict and the
        K-buffer insert are emitted against it, in virtual time.
        """
        self.clock.advance(t)
        self._fire_due()
        if int(user) in self.quarantined:
            # Quarantined senders are refused at the door — no token
            # spent, no queue entry, counted under admission_screened.
            self.registry.counter("serve_quarantine_refusals").inc()
            verdict = self.admission.record(SCREENED, self.clock.now)
            self._trace("admit", trace, user=int(user), verdict=verdict,
                        t_virtual=float(t))
            return verdict
        pulled = (int(version) if version is not None
                  else self.pulled_version(t - lat))
        staleness = max(0, self.version - pulled)
        verdict = self.admission.decide(self.clock.now, staleness,
                                        len(self.pending))
        self._trace("admit", trace, user=int(user), verdict=verdict,
                    t_virtual=float(t))
        if verdict in ADMITTED:
            elig = self.tick_count + (2 if verdict == DEPRIORITIZE else 1)
            self.pending.append(_Pending(t=float(t), user=int(user),
                                         elig_tick=elig,
                                         poison=float(poison),
                                         trace_id=(str(trace) if trace
                                                   else None)))
            self._trace("buffer_insert", trace, user=int(user),
                        elig_tick=elig, t_virtual=float(t))
            self.registry.gauge("serve_pending").set(len(self.pending))
            if self.flush_every and self._eligible_count() >= self.flush_every:
                self._tick(self.clock.now)
        return verdict

    def offer_many(self, events, trace: Optional[str] = None) -> dict:
        """Batch ingestion: ``events`` is an iterable of
        ``(user, t, lat)`` rows, optionally extended with
        ``version`` and ``poison`` columns (the protocol's ``updates``
        frame / trace replay). ``trace`` is the carrying frame's causal
        id — every row of a batch shares it (frame-scoped tracing).
        Returns per-verdict counts for the batch."""
        counts: dict = {}
        for row in events:
            version = (int(row[3]) if len(row) > 3 and row[3] is not None
                       else None)
            poison = float(row[4]) if len(row) > 4 else 0.0
            v = self.offer(float(row[1]), int(row[0]), float(row[2]),
                           version=version, poison=poison, trace=trace)
            counts[v] = counts.get(v, 0) + 1
        return counts

    # ------------------------------------------------------------------
    # idempotent sessions + write-ahead log

    def session_check(self, nonce, seq, n_events: int,
                      trace: Optional[str] = None) -> Optional[dict]:
        """Idempotency gate for a session-stamped frame. None means new
        work — process it, then :meth:`session_commit`. A frame at or
        below the session's high-water seq is a client retry after a
        lost ack: counted as ``serve_duplicate_drop`` (counter + traced
        event) and answered with the ORIGINAL per-verdict counts when it
        is the newest frame (exact ack replay — the single-in-flight
        protocol makes that the only live retry), or a pure
        ``duplicate`` count for anything older."""
        if nonce is None or seq is None:
            return None
        last = self._sessions.get(str(nonce))
        if last is None or int(seq) > last[0]:
            return None
        n = int(n_events)
        self.duplicate_drops += n
        self.registry.counter("serve_duplicate_drop").inc(n)
        self.tracer.event("serve_duplicate_drop", round=self.tick_count,
                          nonce=str(nonce), seq=int(seq), events=n,
                          **({"trace_id": str(trace)} if trace else {}))
        self._trace("dedup_drop", trace, nonce=str(nonce), seq=int(seq),
                    events=n)
        return dict(last[1]) if int(seq) == last[0] else {"duplicate": n}

    def session_commit(self, nonce, seq, counts: dict) -> None:
        if nonce is None or seq is None:
            return
        self._sessions[str(nonce)] = [int(seq), dict(counts)]

    def wal_append(self, nonce, seq, rows,
                   trace: Optional[str] = None) -> None:
        """Durability write for one admitted frame: rows are
        ``[user, t, lat]`` (optionally ``+ [version, poison]``). Appended +
        flushed BEFORE the frame is processed, so every acked update is
        either in a checkpoint or in the WAL; checkpoint() truncates it
        once state is durable. No-op until ``wal_path`` is set. The
        frame's causal ``trace`` id is persisted with the entry (so a
        WAL replay re-offers under the original id) and emitted as the
        'wal' trace stage. (``fedtpu``'s disk-full injection hook,
        ``wal_shortwrite``, belongs to its chaos fuzzer: ROADMAP A11b, second
        part.)"""
        if not self.wal_path:
            return
        import json
        import os
        os.makedirs(os.path.dirname(self.wal_path) or ".", exist_ok=True)
        entry = {"nonce": None if nonce is None else str(nonce),
                 "seq": None if seq is None else int(seq),
                 "events": [list(r) for r in rows]}
        if trace:
            entry["trace"] = str(trace)
        self._trace("wal", trace, nonce=entry["nonce"], seq=entry["seq"],
                    events=len(entry["events"]))
        line = json.dumps(entry, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with open(self.wal_path, "a", encoding="utf-8") as fh:
            fh.write(line)
            fh.flush()

    def replay_wal(self) -> int:
        """Resume path: re-offer every WAL frame the restored checkpoint
        does not already cover. Idempotent two ways — frames the
        checkpoint saw are skipped by session_check (their seq is at or
        below the restored high-water mark), and the replay itself
        commits sessions so the client's own retries dedup afterwards.
        Ordered file replay against the restored state reproduces the
        original verdicts (virtual-time determinism). Returns the number
        of events re-offered; a torn tail line (the kill mid-append)
        ends the replay cleanly."""
        import json
        import os
        if not self.wal_path or not os.path.exists(self.wal_path):
            return 0
        replayed = 0
        with open(self.wal_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    break  # torn tail write: nothing after it is valid
                rows = entry.get("events") or []
                if self.session_check(entry.get("nonce"), entry.get("seq"),
                                      len(rows),
                                      trace=entry.get("trace")) is not None:
                    continue
                counts: dict = {}
                for r in rows:
                    v = self.offer(float(r[1]), int(r[0]), float(r[2]),
                                   version=(int(r[3]) if len(r) > 3
                                            and r[3] is not None
                                            else None),
                                   poison=(float(r[4]) if len(r) > 4
                                           else 0.0),
                                   trace=entry.get("trace"))
                    counts[v] = counts.get(v, 0) + 1
                    replayed += 1
                self.session_commit(entry.get("nonce"), entry.get("seq"),
                                    counts)
        if replayed:
            self.tracer.event("serve_wal_replay", round=self.tick_count,
                              events=replayed)
        return replayed

    # ------------------------------------------------------------------
    # per-user identity (cohort store backing)

    def attach_store(self, total_users: int, backend: str = "memory",
                     path: Optional[str] = None, shard_index: int = 0,
                     num_shards: int = 1):
        """Back slot eviction with a per-user state store: each of
        ``total_users`` user ids owns one record shaped like a single
        engine slot (params, anchor, Adam's moments and count, pull
        tick). From now on, evicting a user persists its slot into its
        record, and a returning user's record is loaded back into the slot
        it lands on. ``shard_index``/``num_shards`` attach the id-shard a
        gateway owns (the fleet's routing keeps every offered user inside
        it). Returns the store (callers checkpoint it through
        :meth:`checkpoint`, which attaches its touched rows to the same
        checkpoint as the engine state)."""
        from fedtpu_torch.cohort.store import ClientStateStore, state_template
        self.store = ClientStateStore(
            state_template(self.state, self.C), total_users,
            backend=backend, path=path, shard_index=shard_index,
            num_shards=num_shards)
        return self.store

    def _read_slots(self, slots) -> list:
        """The per-client tensors of ``slots`` on the host, in
        ``per_client_view`` order: one ``(K, *shape)`` numpy array each,
        bit for bit. The rows are gathered on the device and copied to the
        host asynchronously, with one wait for all of them."""
        import torch
        from fedtpu_torch.parallel.round import per_client_view
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        rows = [t.index_select(0, idx).to("cpu", non_blocking=True)
                for t in per_client_view(self.state, self.C)]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return [r.numpy() for r in rows]

    def _write_slots(self, slots, values) -> None:
        """Slots ``slots`` set to ``values`` (per slot, one ``(*shape)``
        array per per-client tensor, ``per_client_view`` order), copied
        INTO the state's tensors (on the card, the captured graph's static
        buffers), never rebinding them: one host-to-device copy and one
        ``index_copy_`` per tensor."""
        import torch
        from fedtpu_torch.parallel.round import per_client_view
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for i, t in enumerate(per_client_view(self.state, self.C)):
            rows = np.stack([v[i] for v in values])
            t.index_copy_(0, idx, torch.from_numpy(rows).to(self.device))

    def writeback_slots(self) -> int:
        """Persist every currently-BOUND slot's engine state into its
        user's store record, without evicting — completes the store
        image before a shard export (the gateway ``flush`` op), so a
        survivor adopting the records sees every user's newest state,
        not just past evictees'. Returns the number of slots written."""
        if self.store is None:
            return 0
        bind = self.binder.state()
        if bind["users"].size:
            self.store.write(bind["users"], self._read_slots(bind["slots"]),
                             participated=False)
        return int(bind["users"].size)

    def _swap_slots(self, swaps: list) -> None:
        """Store-backed eviction for one tick's binds, ``swaps`` their
        ``(slot, evicted_user, new_user)`` in bind order: each persists
        the evictee's slot record, then loads the incomer's record into
        the slot (first-ever users have no record and inherit the slot's
        warm state — their record is created when THEY are evicted).

        The store sees ``fedtpu``'s sequence of writes and reads, swap
        after swap; the device sees one read of the swapped slots before
        and one write of the slots whose state changed after. Between the
        two the slots live on the host, so a user bound earlier in the
        tick and evicted again leaves the record its slot holds at that
        point, as one device read and write a swap would give."""
        slots = sorted({slot for slot, _, _ in swaps})
        rows = self._read_slots(slots)
        held = {slot: [r[i] for r in rows] for i, slot in enumerate(slots)}
        changed = set()
        for slot, evicted_user, new_user in swaps:
            self.store.write(np.asarray([evicted_user], np.int64),
                             [v[None] for v in held[slot]])
            # Participation, not version, decides whether a record holds
            # real slot state: reputation writes (set_reputation) bump the
            # version without touching the leaves, and swapping such a
            # zero-filled record into a live slot would wipe it.
            new = np.asarray([new_user], np.int64)
            if int(self.store.participation(new)[0]) > 0:
                held[slot] = [r[0] for r in self.store.read(new)]
                changed.add(slot)
            self.registry.counter("serve_slot_evictions").inc()
        if changed:
            order = sorted(changed)
            self._write_slots(order, [held[slot] for slot in order])

    # ------------------------------------------------------------------
    # ticking

    def _eligible_count(self, drain: bool = False) -> int:
        if drain:
            return len(self.pending)
        # elig_tick <= tick_count: eligible for the tick about to fire
        # (tick indices == fired-tick count so far). Entries admitted
        # after the last firing carry elig_tick == tick_count + 1.
        return sum(1 for p in self.pending
                   if p.elig_tick <= self.tick_count + 1)

    def _fire_due(self) -> None:
        while self.clock.due():
            self._tick(self.clock.fire_time())

    def _tick(self, t_fire: float, drain: bool = False) -> int:
        """Fire one engine tick at virtual time ``t_fire``; returns how
        many pending updates it incorporated (0 skips the device call —
        an empty tick would train nobody)."""
        self.tick_count += 1
        k = self.tick_count
        ready = [p for p in self.pending
                 if drain or p.elig_tick <= k]
        if not ready:
            self._record_tick(t_fire, 0, 0)
            return 0
        self.pending = [p for p in self.pending
                        if not (drain or p.elig_tick <= k)]
        # Entries admitted before their sender was quarantined are
        # dropped here, not incorporated — containment covers the queue.
        if self.quarantined:
            dropped = [p for p in ready if p.user in self.quarantined]
            if dropped:
                ready = [p for p in ready
                         if p.user not in self.quarantined]
                for _ in dropped:
                    self.admission.record(SCREENED, t_fire)
                self.registry.counter("serve_quarantine_refusals").inc(
                    len(dropped))
            if not ready:
                self._record_tick(t_fire, 0, 0)
                return 0
        # Stable identity binding, in arrival order (deterministic under
        # replay). Two distinct ready users always land on two distinct
        # slots — the residue map's aliasing cannot happen.
        tick_slots = set()
        poison_of: dict = {}
        user_of: dict = {}
        swaps = []
        for p in ready:
            slot, evicted = self.binder.bind(p.user)
            if evicted is not None and self.store is not None:
                swaps.append((slot, evicted, p.user))
            tick_slots.add(slot)
            user_of[slot] = p.user
            # Coalesced entries on one slot: a poisoned one dominates —
            # the arrival carries the strongest adversarial weight.
            poison_of[slot] = max(poison_of.get(slot, 0.0),
                                  float(p.poison))
        if swaps:
            self._swap_slots(swaps)
        slots = sorted(tick_slots)
        mask = np.zeros((1, self.C), np.float32)
        for s in slots:
            mask[0, s] = -poison_of[s] if poison_of[s] > 0 else 1.0
        scr = self._device_tick(mask)
        scr_slots: set = set()
        if self.screen:
            scr_slots = {s for s in slots if scr[s] > 0}
            for s in sorted(scr_slots):
                self._strike(user_of[s], t_fire)
        incorporated = [p for p in ready
                        if self.binder.peek(p.user) not in scr_slots]
        n_screened = len(ready) - len(incorporated)
        if n_screened:
            for _ in range(n_screened):
                self.admission.record(SCREENED, t_fire)
            self.screened_total += n_screened
            self.tracer.event("serve_screened", round=self.tick_count,
                              t_virtual=float(t_fire),
                              n_screened=n_screened)
        # Host mirror of the in-graph K-buffer apply rule: each ACCEPTED
        # arriving slot counts one buffered update; the global (and
        # therefore the version clients pull) moves when apply_n have
        # accumulated. Screened slots never joined the device buffer.
        self.nbuf_host += float(len(slots) - len(scr_slots))
        if self.nbuf_host >= self._apply_n:
            self.version += 1
            self.nbuf_host = 0.0
            self._applies_t.append(t_fire)
            self._applies_v.append(self.version)
            self._compact_applies()
        lats = np.asarray([t_fire - p.t for p in incorporated], np.float64)
        _observe_array(self._lat_hist, lats)
        self.latencies.extend(lats.tolist())
        if len(self.latencies) > LATENCY_WINDOW:
            del self.latencies[:len(self.latencies) - LATENCY_WINDOW]
        self.incorporated += len(incorporated)
        self.registry.counter("serve_updates_incorporated").inc(
            len(incorporated))
        # Close each traced update's causal chain at its incorporation
        # tick — emitted in virtual time, after tick_count advanced to
        # this tick, so the chain replays bitwise.
        for p in incorporated:
            self._trace("incorporate", p.trace_id, user=int(p.user),
                        t_virtual=float(t_fire))
        self._record_tick(t_fire, len(incorporated), len(slots))
        return len(incorporated)

    def _device_tick(self, mask: np.ndarray):
        """One driven tick of the state on the signed ``(1, C)`` mask: a
        replay of the captured graph, or the step itself. Returns the
        ``(C,)`` screened flags on the host under the screen (the tick's
        one device read: the verdict is computed on the device, the
        strike and quarantine bookkeeping is the host's), else None."""
        import torch
        arrivals = torch.from_numpy(mask)
        tick = torch.tensor(self.state["round"], dtype=torch.int32)
        if self._graph is not None:
            out = self._graph(arrivals, tick)
            self.state["round"] += 1
            scr = out[self._screened_at:self._screened_at + self.C]
        else:
            self.state, raw = self.step.fn(self.state, self.batch,
                                           arrivals.to(self.device),
                                           tick.to(self.device))
            scr = raw.get("screened")
        return scr.reshape(-1).cpu().numpy() if self.screen else None

    def _strike(self, user: int, t_fire: float) -> None:
        """One screened-update strike against ``user``; quarantines at
        the configured threshold. Both decisions are pure functions of
        the virtual-time tick stream, so they replay bitwise."""
        user = int(user)
        n = self.strikes.get(user, 0) + 1
        self.strikes[user] = n
        self.defense_log.append(
            {"kind": "screen", "tick": self.tick_count,
             "t": float(t_fire), "user": user, "strikes": n})
        if n >= self.quarantine_strikes and user not in self.quarantined:
            self.quarantined.add(user)
            self.defense_log.append(
                {"kind": "quarantine", "tick": self.tick_count,
                 "t": float(t_fire), "user": user})
            self.registry.counter("serve_quarantines").inc()
            self.tracer.event("serve_quarantine", round=self.tick_count,
                              t_virtual=float(t_fire), user=user,
                              strikes=n)
            if self.store is not None:
                self.store.set_reputation(
                    np.asarray([user], np.int64),
                    np.asarray([n], np.uint32), True)

    def _record_tick(self, t_fire: float, n_updates: int,
                     n_slots: int) -> None:
        row = (float(t_fire), int(n_updates), int(n_slots),
               int(self.version), float(self.nbuf_host),
               len(self.pending))
        for key, val in zip(HISTORY_KEYS, row):
            self.history[key].append(val)
        win = int(self.cfg.history_window)
        if win and len(self.history["tick_t"]) > win:
            cut = len(self.history["tick_t"]) - win
            for key in HISTORY_KEYS:
                del self.history[key][:cut]
        self.registry.counter("serve_ticks").inc()
        self.registry.gauge("serve_pending").set(len(self.pending))
        self.registry.gauge("serve_version").set(self.version)
        self.tracer.event("serve_tick", round=self.tick_count,
                          t_virtual=float(t_fire), n_updates=n_updates,
                          n_slots=n_slots, version=self.version,
                          pending=len(self.pending))

    # ------------------------------------------------------------------
    # drain / summary / persistence

    def drain(self) -> int:
        """Incorporate EVERYTHING still pending (eligibility waived) in
        one final tick, then flag K-buffer starvation if buffered updates
        never reached an apply — the ``async_starvation`` event,
        here an SLO signal rather than an end-of-run warning. Returns the
        number of updates the drain tick incorporated."""
        n = self._tick(self.clock.now, drain=True) if self.pending else 0
        if self.M >= 2 and self.nbuf_host > 0:
            self.tracer.event("async_starvation", round=self.tick_count,
                              pending=int(self.nbuf_host),
                              buffer_size=self.M)
            self.registry.counter("async_starvation_events").inc()
        return n

    def summary(self) -> dict:
        """Drain-time SLO snapshot; emitted as the ``serve_summary``
        event and returned to drain/stats protocol callers. Percentiles
        come from telemetry.report's one implementation, over the most
        recent :data:`LATENCY_WINDOW` incorporations (None until the
        first one — stats on an idle server must not crash it).
        ``wall_s``/``rounds_per_sec`` cover the current launch only;
        everything else survives checkpoint/restore."""
        wall = time.monotonic() - self._wall_start
        out = {
            "ticks": self.tick_count,
            "incorporated": self.incorporated,
            "version": self.version,
            "pending": len(self.pending),
            "buffered": float(self.nbuf_host),
            "admission": dict(self.admission.counts),
            "duplicate_drops": self.duplicate_drops,
            "update_to_incorporation": (_percentiles(self.latencies)
                                        if self.latencies else None),
            "wall_s": wall,
            "rounds_per_sec": (self.tick_count / wall) if wall > 0 else 0.0,
            "signals": self.signals(),
            # Defense block (present even with screen off, so chaos'
            # undefended control run reads the same keys): quarantined
            # ids, screened count, and the global model's accuracy on
            # the engine's training fixture — the containment metric.
            "screened": self.screened_total,
            "quarantined": sorted(self.quarantined),
            "eval_accuracy": self.eval_accuracy(),
        }
        return out

    def eval_accuracy(self) -> float:
        """Accuracy of the CURRENT global model on the full serving
        fixture — the poisoning-containment metric (a landed campaign
        tanks it; a contained one stays at the attacker-free baseline).
        One forward of the float32 MLP: K3 on the card (the port's
        held-out forward), its plain version on the CPU; one host read,
        the count of right rows, over the row count as ``fedtpu``'s numpy
        mean."""
        from fedtpu_torch.ops.cuda_kernels import fused_mlp_forward
        from fedtpu_torch.parallel.async_fed import async_global_params
        logits = fused_mlp_forward(async_global_params(self.state),
                                   self.model.mlp_dims, self._eval_x)
        right = int((logits.argmax(dim=-1) == self._eval_y).sum())
        return right / int(self._eval_y.shape[0])

    def signals(self) -> dict:
        """The machine-readable block the autoscale control plane polls
        through the ``stats`` protocol op: backlog depth, sliding-window
        per-verdict rates (straight off the AdmissionController's own
        window — no second tally), and SLO burn computed from the
        cumulative update-to-incorporation histogram against the
        configured objective. Shapes match what ``fedtpu``'s
        ``autoscale.signals.SignalBus.fold`` consumes."""
        from fedtpu_torch.autoscale.signals import slo_burn_from_hist
        win = self.admission.window_rates(self.clock.now)
        admitted = sum(self.admission.counts[v] for v in ADMITTED)
        return {
            "backlog": len(self.pending),
            "buffered": float(self.nbuf_host),
            "incorporated": self.incorporated,
            "admitted": admitted,
            "window_s": win["window_s"],
            "window_decisions": win["decisions"],
            "rates": win["rates"],
            "slo_burn": slo_burn_from_hist(
                self._lat_hist.to_dict(),
                self.cfg.slo_objective_s,
                self.cfg.slo_error_budget),
            "tick_interval_s": self.clock.tick_interval_s,
            "flush_every": self.flush_every,
        }

    def configure(self, tick_interval_s: Optional[float] = None,
                  flush_every: Optional[int] = None) -> dict:
        """Autoscale knob actuation: retarget the tick cadence and/or the
        count-driven flush threshold mid-run. The time-driven schedule is
        re-anchored at the current virtual time (the next firing is one
        NEW interval from now); 0 disables that trigger, matching the
        config semantics. Returns the applied values."""
        if tick_interval_s is not None:
            v = float(tick_interval_s)
            if v < 0:
                raise ValueError("tick_interval_s must be >= 0")
            self.clock.tick_interval_s = v
            self.clock.next_fire = self.clock.now + v
        if flush_every is not None:
            n = int(flush_every)
            if n < 0:
                raise ValueError("flush_every must be >= 0")
            self.flush_every = n
            if n and self._eligible_count() >= n:
                self._tick(self.clock.now)
        applied = {"tick_interval_s": self.clock.tick_interval_s,
                   "flush_every": self.flush_every}
        self.tracer.event("serve_configure", round=self.tick_count,
                          **applied)
        return applied

    def pre_drain(self, path: Optional[str] = None):
        """Preemption pre-drain: spool every pending (admitted, not yet
        incorporated) update to ``path`` as canonical JSONL — the
        durability copy an autoscale controller takes BEFORE a capacity
        loss, so a preemption deadline cannot lose admitted work. The
        queue itself is untouched (entries still incorporate normally if
        the engine survives; a successor replays the spool if it does
        not). Returns ``(count, path)``. Atomic tmp+rename, same
        convention as heartbeats."""
        import json
        import os
        if path is None:
            if not self.spool_dir:
                raise ValueError("pre_drain needs a path (no spool_dir "
                                 "configured)")
            path = os.path.join(self.spool_dir, "predrain.jsonl")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            for p in self.pending:
                fh.write(json.dumps(
                    {"t": p.t, "user": p.user, "elig_tick": p.elig_tick,
                     "poison": p.poison},
                    sort_keys=True, separators=(",", ":")) + "\n")
        os.replace(tmp, path)
        n = len(self.pending)
        self.registry.counter("serve_pre_drains").inc()
        self.tracer.event("serve_pre_drain", round=self.tick_count,
                          spooled=n, path=path)
        return n, path

    def emit_summary(self) -> dict:
        s = self.summary()
        self.tracer.event("serve_summary", round=self.tick_count, **s)
        self.tracer.counters(self.registry.snapshot())
        return s

    def checkpoint(self, directory: str) -> str:
        """Persist engine state + serving host state (pending queue,
        clock, apply log, admission bucket/counts, latency telemetry) +
        tick history via the port's round checkpoint (``torch.save``,
        ``fedtpu``'s ``round_<step>`` layout and its ``serve_*`` extras),
        step = tick count. Pending/latency arrays are only attached when
        nonempty, as ``fedtpu``'s, and restore treats absence as
        empty."""
        from fedtpu_torch.orchestration.checkpoint import save_checkpoint
        adm = self.admission.state()
        extra = {
            "serve_clock": np.float64(self.clock.now),
            "serve_next_fire": np.float64(self.clock.next_fire),
            "serve_version": np.int64(self.version),
            "serve_nbuf": np.float64(self.nbuf_host),
            "serve_tick_count": np.int64(self.tick_count),
            "serve_incorporated": np.int64(self.incorporated),
            # Admission state: without it a resumed token bucket refills
            # to full burst and the post-resume verdict sequence diverges
            # from an uninterrupted run whenever rate_limit > 0.
            "serve_bucket_tokens": np.float64(adm["bucket_tokens"]),
            "serve_bucket_t": np.float64(adm["bucket_t"]),
            "serve_admission_counts": np.asarray(adm["counts"], np.int64),
            # Latency telemetry: the cumulative histogram state (count,
            # sum, min, max + per-bucket counts) so post-resume summaries
            # and Prometheus exports cover the whole run.
            "serve_lat_hist": np.asarray(
                [self._lat_hist.count, self._lat_hist.sum,
                 self._lat_hist.min, self._lat_hist.max], np.float64),
            "serve_lat_buckets": np.asarray(self._lat_hist.bucket_counts,
                                            np.int64),
        }
        if self.latencies:
            extra["serve_latencies"] = np.asarray(self.latencies,
                                                  np.float64)
        if self.pending:
            extra["pend_t"] = np.asarray([p.t for p in self.pending])
            extra["pend_user"] = np.asarray([p.user for p in self.pending],
                                            np.int64)
            extra["pend_elig"] = np.asarray(
                [p.elig_tick for p in self.pending], np.int64)
            extra["pend_poison"] = np.asarray(
                [p.poison for p in self.pending], np.float64)
        # Defense reputation: strikes + quarantine must survive a resume
        # or the post-restore verdict stream diverges (a quarantined
        # attacker would be re-admitted). The per-user arrays are
        # attached only when non-empty.
        extra["serve_screened_total"] = np.int64(self.screened_total)
        if self.strikes:
            users = sorted(self.strikes)
            extra["strike_users"] = np.asarray(users, np.int64)
            extra["strike_counts"] = np.asarray(
                [self.strikes[u] for u in users], np.int64)
        if self.quarantined:
            extra["quarantined_users"] = np.asarray(
                sorted(self.quarantined), np.int64)
        if self._applies_t:
            extra["applies_t"] = np.asarray(self._applies_t)
            extra["applies_v"] = np.asarray(self._applies_v, np.int64)
        # Slot bindings: without them a resumed engine would re-bind
        # returning users to different slots than the uninterrupted run.
        bind = self.binder.state()
        extra["bind_evictions"] = bind["evictions"]
        if bind["users"].size:
            extra["bind_users"] = bind["users"]
            extra["bind_slots"] = bind["slots"]
        # Idempotency sessions: without them a resumed engine would
        # re-incorporate a client's post-kill retries.
        extra["serve_duplicate_drops"] = np.int64(self.duplicate_drops)
        if self._sessions:
            import json
            extra["serve_sessions"] = np.frombuffer(
                json.dumps(self._sessions, sort_keys=True).encode(),
                np.uint8).copy()
        # Attached user store: its touched records ride the same
        # checkpoint, so engine state and store restore together.
        if self.store is not None:
            extra.update(self.store.checkpoint_arrays())
        # Every extra as an array (a 0-d one for a scalar): the meta file
        # holds tensors, never numpy scalars.
        extra = {k: np.asarray(v) for k, v in extra.items()}
        path = save_checkpoint(directory, self.state, self.history,
                               self.tick_count, extra_meta=extra)
        # Everything the WAL guards is now durable; truncate so resume
        # replays only the post-checkpoint tail.
        if self.wal_path:
            import os
            if os.path.exists(self.wal_path):
                open(self.wal_path, "w").close()
        return path

    def restore(self, directory: str) -> int:
        """Restore engine + serving host state from the newest checkpoint
        under ``directory`` (written by :meth:`checkpoint`). Returns the
        restored tick count.

        The restored tensors are copied INTO the engine's state tensors,
        which on the card are the captured graph's static buffers (the
        state is never rebound); a checkpoint of another engine shape
        raises. The keys :meth:`checkpoint` always writes are read as
        such; those it writes only when non-empty (pending updates,
        strikes, quarantine, applies, bindings, latencies, sessions) are
        empty when absent. An attached store restores the records the
        checkpoint carries (digest-verified)."""
        from fedtpu_torch.orchestration.checkpoint import (
            load_checkpoint_raw, load_meta)
        from fedtpu_torch.parallel.async_fed import async_state_tensors
        state, history, step = load_checkpoint_raw(directory)
        meta = load_meta(directory)
        ours, theirs = (async_state_tensors(self.state),
                        async_state_tensors(state))
        if (sorted(state) != sorted(self.state)
                or [t.shape for t in ours] != [t.shape for t in theirs]):
            raise ValueError(
                f"checkpoint under {directory} holds another engine's "
                "state (cohort, model, K-buffer or screen differ)")
        for dst, src in zip(ours, theirs):
            dst.copy_(src)
        self.state["round"] = int(state["round"])
        # The history is stored as float64; the integer keys go back to
        # int so resumed rows serialize byte-identically to fresh ones.
        self.history = {k: [int(v) if k in _HISTORY_INTS else float(v)
                            for v in history.get(k, [])]
                        for k in HISTORY_KEYS}

        def scalar(key: str):
            return np.asarray(meta[key]).item()

        def listed(key: str) -> np.ndarray:
            return np.atleast_1d(meta.get(key, np.zeros(0)))

        self.tick_count = int(scalar("serve_tick_count"))
        self.version = int(scalar("serve_version"))
        self.nbuf_host = float(scalar("serve_nbuf"))
        self.incorporated = int(scalar("serve_incorporated"))
        self.clock.now = float(scalar("serve_clock"))
        self.clock.next_fire = float(scalar("serve_next_fire"))
        self._applies_t = [float(v) for v in listed("applies_t")]
        self._applies_v = [int(v) for v in listed("applies_v")]
        self.admission.restore_state(
            float(scalar("serve_bucket_tokens")),
            float(scalar("serve_bucket_t")),
            [int(v) for v in np.atleast_1d(meta["serve_admission_counts"])])
        self.latencies = [float(v) for v in listed("serve_latencies")]
        stats = np.atleast_1d(meta["serve_lat_hist"])
        h = self._lat_hist
        h.count = int(stats[0])
        h.sum = float(stats[1])
        if h.count:
            h.min = float(stats[2])
            h.max = float(stats[3])
        h.bucket_counts = [int(v) for v in
                           np.atleast_1d(meta["serve_lat_buckets"])]
        self.pending = [
            _Pending(t=float(t), user=int(u), elig_tick=int(e),
                     poison=float(pz))
            for t, u, e, pz in zip(listed("pend_t"), listed("pend_user"),
                                   listed("pend_elig"),
                                   listed("pend_poison"))]
        self.screened_total = int(scalar("serve_screened_total"))
        self.strikes = {int(u): int(n) for u, n in
                        zip(listed("strike_users"), listed("strike_counts"))}
        self.quarantined = {int(u) for u in listed("quarantined_users")}
        if "bind_users" in meta:
            self.binder.restore_state(listed("bind_users"),
                                      listed("bind_slots"),
                                      int(scalar("bind_evictions")))
        self.duplicate_drops = int(scalar("serve_duplicate_drops"))
        if self.duplicate_drops:
            self.registry.counter("serve_duplicate_drop").inc(
                self.duplicate_drops)
        if "serve_sessions" in meta:
            import json
            raw = listed("serve_sessions").astype(np.uint8)
            self._sessions = {
                k: [int(v[0]), dict(v[1])]
                for k, v in json.loads(bytes(raw).decode()).items()}
        if self.store is not None:
            self.store.restore_arrays(meta)
        # Re-seed the run-total registry instruments so a post-resume
        # counters snapshot reports the whole run, not the segment.
        if self.tick_count:
            self.registry.counter("serve_ticks").inc(self.tick_count)
        if self.incorporated:
            self.registry.counter("serve_updates_incorporated").inc(
                self.incorporated)
        self.registry.gauge("serve_version").set(self.version)
        self.registry.gauge("serve_pending").set(len(self.pending))
        return step

    def history_lines(self) -> list:
        """The per-tick metric history as canonical JSON lines — the
        bitwise-determinism artifact (same trace + seed => identical
        bytes across runs)."""
        import json
        rows = []
        n = len(self.history["tick_t"])
        for i in range(n):
            rows.append(json.dumps(
                {k: self.history[k][i] for k in HISTORY_KEYS},
                sort_keys=True, separators=(",", ":")))
        return rows

    def write_history(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            for line in self.history_lines():
                fh.write(line + "\n")
