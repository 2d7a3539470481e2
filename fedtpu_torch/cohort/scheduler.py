"""CohortScheduler: stream sampled cohorts through a fixed-size engine
(``fedtpu.cohort.scheduler``).

The synchronous engine holds every client on the device; this scheduler
holds ``cohort_size`` slots and, per round, (1) SAMPLES a cohort (uniform /
weighted / trace-driven availability, ``CohortSampler``), (2) lazily
initialises any never-seen member in the :class:`~fedtpu_torch.cohort.store.
ClientStateStore` (the init the synchronous engine gives that client: both
draw client c's from its seed of ``parallel.round.client_init_seeds``),
(3) gathers the chunk's records and data into host buffers on a prefetch
thread while the previous chunk runs, (4) runs ``cohorts_per_step``
cohorts as ONE step, on the card one replay of a CUDA graph, and (5) writes
the updated records back.

Round semantics are the synchronous plain-FedAvg round's, op for op:
cohort members train from the carried global (their own stored init on the
very first round: the carry is seeded with cohort 0's stored params), the
in-round eval is K2's, and the average is ``parallel.round.make_average``'s
(K1 in broadcast mode, or the ring over the cohort's mesh shards with K4),
or the median / trimmed mean over the cohort's members with data
(``robust_average``). With ``cohort_size == population`` (identity order)
the two engines are bitwise equal, round by round. Optimizer state is
per-client and never averaged; it rides the store between the rounds its
owner trains in.

Within one chunk the sampled cohorts are DISJOINT (one store read and
write per client per chunk), so ``cohorts_per_step <= population //
cohort_size``.

On the card. A chunk's inputs (the members' optimizer state, rows, labels,
mask and base weights) are the step's input buffers (``CohortStep.
input_buffers``), static device buffers of the captured graph. The
prefetch thread fills PINNED HOST tensors only, never a device buffer: a
chunk's host-to-device copies are issued on the replay's stream just
before its replay, so they cannot overwrite a buffer that a replay in
flight reads, and one buffer set and one graph serve every chunk (the next
chunk's step needs this one's carry anyway, so a second set would only
overlap the copies). The chunk's outputs (every cohort's slot params and
optimizer state, losses and confusion counts) are the graph's static
outputs: one batch of copies into pinned host memory, queued right after
the replay, and one wait, before the next replay is issued. The carry is
seeded at round 1 by a copy into the state before the first replay. A
capture that fails raises; no chunk runs uncaptured in its place.

``run_cohort_experiment`` is the ``run_experiment`` delegate for
``FedConfig.cohort_size > 0``: the same config surface, the same
``ExperimentResult``, the reference early-stop rule, and checkpoint /
resume through the port's layout (the store's touched records ride the
checkpoint's meta file, so the engine state and the store commit
together).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional

import numpy as np
import torch

from fedtpu_torch.cohort.store import ClientStateStore
from fedtpu_torch.models.registry import as_model
from fedtpu_torch.ops.metrics import METRIC_NAMES
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.parallel.mesh import ClientMesh
from fedtpu_torch.parallel.round import (CAPTURE_LOCK, assemble_metrics,
                                         capture_round_step,
                                         check_ring_devices,
                                         client_init_seeds, client_inits,
                                         make_average, per_client_view,
                                         robust_average, warm_up_round)
from fedtpu_torch.training.client import (make_local_eval_step,
                                          make_local_train_step)

SAMPLING_POLICIES = ("uniform", "weighted", "trace")


class CohortSampler:
    """Deterministic cohort sampling: ``sample(round0, num_cohorts)`` is a
    pure function of ``(seed, round0)``, so resume replays the same cohorts
    (``fedtpu``'s, id for id).

    - ``uniform``: distinct ids uniformly at random; the full-population
      draw (``num_cohorts * cohort_size == total``) returns IDENTITY
      order: everyone participates, and id order is what makes the
      reduction bitwise-comparable to the synchronous engine.
    - ``weighted``: distinct ids, probability proportional to a
      caller-supplied nonnegative ``weights`` array (O(total) host work,
      the documented cost of weighted sampling).
    - ``trace``: availability-driven: cohorts are the next distinct user
      ids from a serving trace's arrival order (wrapping), so the
      participation process is the measured one, not a model.
    """

    def __init__(self, total_clients: int, cohort_size: int,
                 policy: str = "uniform", seed: int = 0,
                 weights: Optional[np.ndarray] = None,
                 trace_users: Optional[np.ndarray] = None):
        if policy not in SAMPLING_POLICIES:
            raise ValueError(f"cohort_sampling must be one of "
                             f"{SAMPLING_POLICIES}, got {policy!r}")
        if not 0 < cohort_size <= total_clients:
            raise ValueError(f"cohort_size must be in [1, total_clients="
                             f"{total_clients}], got {cohort_size}")
        self.total = int(total_clients)
        self.k = int(cohort_size)
        self.policy = policy
        self.seed = int(seed)
        # Quarantined ids: refuse() removes them from every future draw.
        # Empty set = the unquarantined sampling code path, bitwise.
        self.quarantined: set = set()
        if policy == "weighted":
            if weights is None:
                raise ValueError("weighted sampling needs a weights array")
            w = np.asarray(weights, np.float64)
            if w.shape != (self.total,) or (w < 0).any() or w.sum() <= 0:
                raise ValueError("weights must be (total_clients,) "
                                 "nonnegative with a positive sum")
            self.p = w / w.sum()
        if policy == "trace":
            if trace_users is None:
                raise ValueError("trace sampling needs the trace's user "
                                 "id sequence (cohort_trace path)")
            tu = np.asarray(trace_users, np.int64)
            if tu.size == 0:
                raise ValueError("trace has no arrivals")
            if tu.min() < 0 or tu.max() >= self.total:
                raise ValueError(
                    f"trace user ids span [{tu.min()}, {tu.max()}] — "
                    f"outside the population [0, {self.total})")
            self.trace_users = tu

    def refuse(self, ids) -> None:
        """Quarantine ``ids``: no future sample() includes them. Raises if
        the surviving population cannot fill one cohort: a defense that
        quarantines the training population away must fail loudly, not
        sample ghosts."""
        self.quarantined |= {int(i) for i in np.atleast_1d(
            np.asarray(ids, np.int64))}
        if self.total - len(self.quarantined) < self.k:
            raise ValueError(
                f"{len(self.quarantined)} quarantined ids leave fewer "
                f"than cohort_size={self.k} of {self.total} clients — "
                "population exhausted (raise the population or review "
                "the quarantine thresholds, docs/robustness.md)")

    def sample(self, round0: int, num_cohorts: int = 1) -> np.ndarray:
        """``(num_cohorts, cohort_size)`` int64 ids, distinct across the
        WHOLE chunk (see the module docstring's disjointness contract).
        Quarantined ids never appear."""
        need = num_cohorts * self.k
        q = self.quarantined
        if need > self.total - len(q):
            raise ValueError(
                f"{num_cohorts} disjoint cohorts of {self.k} need "
                f"{need} distinct clients, population is {self.total}"
                + (f" minus {len(q)} quarantined" if q else ""))
        if self.policy == "trace":
            ids = self._from_trace(round0, need)
        elif self.policy == "weighted":
            rng = np.random.default_rng((self.seed, round0))
            p = self.p
            if q:
                p = p.copy()
                p[sorted(q)] = 0.0
                if p.sum() <= 0:
                    raise ValueError("quarantine removed every positively "
                                     "weighted client")
                p = p / p.sum()
            ids = rng.choice(self.total, size=need, replace=False, p=p)
        elif need == self.total and not q:
            # Full participation: identity order, no draw.
            ids = np.arange(self.total, dtype=np.int64)
        else:
            rng = np.random.default_rng((self.seed, round0))
            if need * 8 >= self.total - len(q):
                perm = rng.permutation(self.total)
                ids = np.array([c for c in perm if c not in q][:need],
                               np.int64)
            else:
                # Rejection sampling: O(need) for need << total; a
                # permutation would allocate the whole population.
                seen: set = set()
                out = []
                while len(out) < need:
                    for c in rng.integers(0, self.total,
                                          size=2 * (need - len(out))):
                        if c not in seen and c not in q:
                            seen.add(int(c))
                            out.append(int(c))
                            if len(out) == need:
                                break
                ids = np.array(out, np.int64)
        return np.asarray(ids, np.int64).reshape(num_cohorts, self.k)

    def _from_trace(self, round0: int, need: int) -> np.ndarray:
        tu = self.trace_users
        start = (round0 * self.k) % tu.size
        seen: set = set()
        out = []
        for i in range(2 * tu.size):
            u = int(tu[(start + i) % tu.size])
            if u not in seen and u not in self.quarantined:
                seen.add(u)
                out.append(u)
                if len(out) == need:
                    return np.array(out, np.int64)
        raise ValueError(
            f"trace holds only {len(seen)} distinct users (quarantined "
            f"excluded), cohort chunk needs {need} — shrink cohort_size/"
            "rounds_per_step or widen the trace")


# numpy has no bfloat16: a bfloat16 record leaf is stored as its bits.
_BITS = {torch.bfloat16: torch.int16}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, a bfloat16 one as its int16 bits (a view)."""
    return t.view(_BITS.get(t.dtype, t.dtype)).numpy()


def slot_leaves(params: torch.Tensor, opt: dict) -> list:
    """A cohort's record leaves as numpy (``per_client_view``'s order: the
    optimizer state's entries by name, then the params; bfloat16 as its
    bits)."""
    return [_numpy(t) for t in per_client_view(
        {"opt_state": opt, "params": params}, params.shape[0])]


def record_template(model, tx: Optimizer) -> list:
    """The store template of the cohort engine's records: ``(shape,
    dtype)`` of each ``slot_leaves`` leaf."""
    p1 = torch.zeros((1, as_model(model).param_count),
                     dtype=as_model(model).param_dtype)
    return [(a.shape[1:], a.dtype) for a in slot_leaves(p1, tx.init(p1))]


class CohortStep:
    """``fn(state, batch, *inputs) -> (state, raw)``: ``rounds`` cohorts
    of ``cohort_size`` slots (``build_cohort_round_fn``). ``state =
    {params (K, D), round}`` carries the global between cohorts; the
    inputs, in ``input_buffers``' order, are each optimizer-state entry
    ``(S, K, ...)`` (sorted by name), ``x (S, K, N, ...)``, ``y (S, K,
    N)``, ``mask (S, K, N)`` and the base weights ``(S, K)``; ``raw`` holds
    each cohort's post-round slot params ``params (S, K, D)`` and
    optimizer state ``opt`` (what the store writes back), ``loss (S, K)``
    and ``conf (S, K, C, C)``. ``batch`` is unused (the rows are inputs).
    The step reads nothing back to the host, so ``capture_round_step``
    captures it; the graph's outputs are ``raw`` itself (``pack``)."""

    outputs = ((), ())

    def __init__(self, fn: Callable, rounds: int, shapes: list):
        # ``shapes``: each input's (per-cohort shape, dtype).
        self.fn, self.rounds, self.shapes = fn, rounds, shapes

    @staticmethod
    def state_tensors(state: dict) -> list:
        return [state["params"]]

    @staticmethod
    def pack(raw: dict) -> dict:
        return raw

    def input_buffers(self, state: dict) -> tuple:
        dev = state["params"].device
        return tuple(torch.zeros((self.rounds,) + shape, dtype=dtype,
                                 device=dev) for shape, dtype in self.shapes)


def build_cohort_round_fn(model, tx: Optimizer, num_classes: int,
                          cohort_size: int, row_shape: tuple,
                          cohorts_per_step: int = 1,
                          mesh: Optional[ClientMesh] = None,
                          aggregation: str = "psum",
                          local_steps: int = 1, prox_mu: float = 0.0,
                          robust: str = "none", trim_ratio: float = 0.1,
                          device: torch.device = torch.device("cpu")
                          ) -> CohortStep:
    """The chunk of ``cohorts_per_step`` cohorts (``fedtpu``'s scan over
    cohorts) as a ``CohortStep``. ``row_shape``: a client's padded rows
    ``(N, ...)``. The per-cohort body is the synchronous plain-FedAvg
    round's (``build_round_fn``): ``make_local_train_step`` (``local_steps``,
    FedProx), the in-round eval (K2 for the float32 MLP), then the
    weighted mean into every slot through ``make_average`` (K1's broadcast
    mode, which carries the params over when the cohort's weights sum to
    0; or the ring over ``mesh``'s shards of the cohort), or, with
    ``robust`` 'median' / 'trimmed_mean', the order statistic over the
    members with data (``robust_average``: dataless slots sort past every
    live value as +inf, and a cohort with no data carries its params
    over)."""
    if robust not in ("none", "median", "trimmed_mean"):
        raise ValueError(
            f"cohort robust must be 'none', 'median' or 'trimmed_mean', "
            f"got {robust!r} (krum/geometric_median score whole updates "
            "and stay vmap-engine-only)")
    if robust != "none" and aggregation != "psum":
        raise ValueError("cohort robust aggregation needs the plain "
                         "psum backend (order statistics gather the "
                         "cohort block; the ring backend reduces)")
    if not 0.0 <= trim_ratio < 0.5:
        raise ValueError(f"trim_ratio must be in [0, 0.5), got "
                         f"{trim_ratio}")
    model = as_model(model)
    slot_dtype = model.param_dtype
    if mesh is None:
        mesh = ClientMesh(1, cohort_size, (device,))
    if mesh.num_shards * mesh.clients_per_shard != cohort_size:
        raise ValueError(f"a mesh of {mesh.num_shards} x "
                         f"{mesh.clients_per_shard} clients for a cohort "
                         f"of {cohort_size}")
    # The device as a tensor on it reports it (with its index).
    check_ring_devices(aggregation, mesh,
                       torch.empty(0, device=device).device)
    # The synchronous round's rule for the trained params' float32 p + u
    # (build_round_fn's ``wide``): one local step, every slot; the plain
    # and the robust reduction take it unrounded.
    wide = slot_dtype != torch.float32 and local_steps == 1
    local_train = make_local_train_step(model, tx, local_steps, prox_mu,
                                        wide=wide)
    local_eval = make_local_eval_step(model, num_classes)
    average = make_average(aggregation, mesh, slot_dtype, wide)
    opt1 = tx.init(torch.zeros((cohort_size, model.param_count),
                               dtype=slot_dtype))
    opt_keys = sorted(opt1)
    k = cohort_size
    shapes = ([(tuple(opt1[key].shape), opt1[key].dtype) for key in opt_keys]
              + [((k,) + tuple(row_shape), torch.float32),
                 ((k, row_shape[0]), torch.int32),
                 ((k, row_shape[0]), torch.float32),
                 ((k,), torch.float32)])

    def chunk(state, batch, *inputs):
        opt_xs = dict(zip(opt_keys, inputs))
        x, y, mask, weights = inputs[len(opt_keys):]
        params = state["params"]
        slots, opts, losses, confs = [], [], [], []
        for s in range(cohorts_per_step):
            trained, opt, loss = local_train(
                params, {key: v[s] for key, v in opt_xs.items()}, x[s],
                y[s], mask[s])
            confs.append(local_eval(trained, x[s], y[s], mask[s]))
            if robust == "none":
                params = average(trained, weights[s])
            else:
                part = (mask[s].sum(dim=1) > 0).to(torch.float32)
                params = robust_average(robust, trained, part, trim_ratio,
                                        0, 0, slot_dtype)
            slots.append(params)
            opts.append(opt)
            losses.append(loss)
        return ({"params": params,
                 "round": state["round"] + cohorts_per_step},
                {"params": torch.stack(slots),
                 "opt": {key: torch.stack([o[key] for o in opts])
                         for key in opt_keys},
                 "loss": torch.stack(losses), "conf": torch.stack(confs)})

    return CohortStep(chunk, cohorts_per_step, shapes)


class CohortScheduler:
    """Owns the store, the sampler, the chunk step (and on the card its
    graph), and the prefetch pipeline. ``run_chunk()`` advances
    ``cohorts_per_step`` rounds and returns the chunk's host metrics; the
    engine state between chunks is the global model in K slots plus the
    round counter (everything per-client lives in the store).

    ``init_params``: a ``(total, D)`` table of every client's init (e.g.
    ``fedtpu``'s, through ``convert.params_from_jax``) in place of the seed
    table's draws. ``capture``: chunks as CUDA graph replays (the card
    only). ``chunk_stats`` records each chunk's host seconds (lazy init,
    store read, store write, the prefetch stall) and, on the card, the
    device milliseconds of its copies and its step (CUDA events)."""

    def __init__(self, store: ClientStateStore, sampler: CohortSampler,
                 model, tx: Optimizer, num_classes: int, data_fn: Callable,
                 row_shape: tuple, init_seed: int = 0,
                 same_init: bool = False, weighting: str = "data_size",
                 mesh: Optional[ClientMesh] = None,
                 aggregation: str = "psum", local_steps: int = 1,
                 prox_mu: float = 0.0, cohorts_per_step: int = 1,
                 robust: str = "none", trim_ratio: float = 0.1,
                 device: torch.device = torch.device("cpu"),
                 capture: bool = False,
                 init_params: Optional[torch.Tensor] = None,
                 prefetch: bool = True, registry=None, tracer=None):
        if capture and device.type != "cuda":
            raise ValueError(f"capture needs the card; the run is on "
                             f"{device}")
        self.store = store
        self.sampler = sampler
        self.model = as_model(model)
        self.tx = tx
        self.data_fn = data_fn
        self.weighting = weighting
        self.k = sampler.k
        self.s = int(cohorts_per_step)
        self.device = device
        self.capture = capture
        self.registry = registry
        # The chunk's cohort_gather and cohort_writeback spans, emitted on
        # the caller's thread only (the prefetch thread emits nothing).
        self.tracer = tracer
        self.pin = device.type == "cuda"
        build = lambda width: build_cohort_round_fn(
            self.model, tx, num_classes, self.k, row_shape,
            cohorts_per_step=width, mesh=mesh, aggregation=aggregation,
            local_steps=local_steps, prox_mu=prox_mu, robust=robust,
            trim_ratio=trim_ratio, device=device)
        self.step = build(self.s)
        # The graph's warm-up runs one cohort eagerly.
        self._warm_step = build(1) if capture else None
        self.graph = None
        self.warmup_rounds = 0
        # Durable quarantine: records flagged in the store (by a serving
        # engine sharing it, or a prior run) never enter a cohort.
        flagged = store.quarantined_ids()
        if flagged.size:
            sampler.refuse(flagged)
        # The seed table the synchronous engine's init_federated_state
        # draws from: the only O(population) host structure here, 8 bytes
        # a client. A record's header key field holds its client's seed.
        self._seeds = np.ascontiguousarray(client_init_seeds(
            init_seed, store.total_clients, same_init))
        self._keys = self._seeds.view(np.uint32).reshape(-1, 2)
        self._init_params = init_params
        self._state = None
        self._round = 0
        self._pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._next = None
        self._wb_done = threading.Event()
        self._wb_done.set()
        self.chunk_stats: list = []

    # -- host <-> store ------------------------------------------------
    def ensure_init(self, ids: np.ndarray) -> int:
        """Initialise the never-seen members of one cohort (version 0):
        client c's init from its seed (or the ``init_params`` table) and a
        fresh optimizer state, written with ``participated=False``.
        Initialised records are never overwritten. Returns the count."""
        fresh = ids[self.store.versions(ids) == 0]
        if fresh.size:
            params = (self._init_params[torch.from_numpy(fresh)]
                      if self._init_params is not None
                      else client_inits(self.model, self._seeds[fresh]))
            params = params.to(self.model.param_dtype).contiguous()
            self.store.write(fresh, slot_leaves(params,
                                                      self.tx.init(params)),
                             keys=self._keys[fresh], participated=False)
        return int(fresh.size)

    def seed_from_state(self, state: dict, num_slots: int,
                        ids: np.ndarray) -> None:
        """Persist engine slots into the store: slot j of ``state`` (the
        synchronous or the asynchronous layout, on any device) becomes
        client ``ids[j]``'s record (version 1). The store's template must
        be the state's (``store.state_template(state, num_slots)``)."""
        self.store.write(ids, [_numpy(t.detach().cpu()) for t in
                               per_client_view(state, num_slots)],
                         keys=self._keys[ids], participated=False)

    def _prepare(self, round0: int, wb_done=None) -> dict:
        """Sample, initialise and gather one chunk into host tensors
        (pinned for the card). Runs on the prefetch worker while the
        previous chunk runs. Sampling, lazy init and the data slicing
        overlap freely (the in-flight chunk's members were initialised at
        its own prep, so lazy init skips them). The STORE READ must not:
        consecutive chunks may share members, and reading one before the
        previous write-back lands would hand round r+1 a round r-1
        optimizer record, so it waits on that chunk's write-back event."""
        t0 = time.perf_counter()
        ids = self.sampler.sample(round0, self.s)           # (S, K)
        fresh = sum(self.ensure_init(ids[s]) for s in range(self.s))
        t1 = time.perf_counter()
        data = [self.data_fn(ids[s]) for s in range(self.s)]
        if wb_done is not None:
            wb_done.wait()
        t2 = time.perf_counter()
        records = [self.store.read(ids[s]) for s in range(self.s)]
        # The step's inputs per cohort: the records' optimizer-state
        # leaves (all but the params), the rows, labels and mask, and the
        # base weights: data sizes, or 1 (a dataless member weighs 1).
        sources = ([[rec[j] for rec in records]
                    for j in range(len(records[0]) - 1)]
                   + [[d[key] for d in data] for key in ("x", "y", "mask")]
                   + [[d["mask"].sum(axis=1, dtype=np.float32)
                       if self.weighting == "data_size" else 1.0
                       for d in data]])
        inputs = []
        for (shape, dtype), per_cohort in zip(self.step.shapes, sources):
            buf = torch.empty((self.s,) + shape,
                              dtype=_BITS.get(dtype, dtype),
                              pin_memory=self.pin)
            view = buf.numpy()
            for s, value in enumerate(per_cohort):
                view[s] = value
            inputs.append(buf.view(dtype))
        # Cohort 0's stored params seed the engine's very first carry
        # (round-1 members train from their own stored inits, as in the
        # synchronous engine's round 1); once a round has run the carry
        # holds the global.
        params0 = None
        if self._state is None:
            params0 = torch.from_numpy(records[0][-1]).view(
                self.model.param_dtype)
        return {"ids": ids, "inputs": tuple(inputs), "params0": params0,
                "mask": np.stack([d["mask"] for d in data]),
                "stats": {"fresh": fresh, "init_s": t1 - t0,
                          "writeback_wait_s": t2 - t1,
                          "read_s": time.perf_counter() - t2}}

    def _take_prepared(self, round0: int) -> dict:
        if self._pool is None:
            return {**self._prepare(round0), "stall_s": 0.0}
        if self._next is None:
            self._next = self._pool.submit(self._prepare, round0)
        t0 = time.perf_counter()
        try:
            prep = self._next.result()
        finally:
            self._next = None
        stall = time.perf_counter() - t0
        if self.registry is not None:
            self.registry.gauge("cohort_prefetch_stall_s").set(stall)
            if stall > 1e-3:
                self.registry.counter("cohort_prefetch_stalls").inc()
        return {**prep, "stall_s": stall}

    def _schedule_next(self, round0: int, wb_done) -> None:
        if self._pool is not None and self._next is None:
            self._next = self._pool.submit(self._prepare, round0, wb_done)

    # -- engine state --------------------------------------------------
    @property
    def round(self) -> int:
        return self._round

    def state_for_checkpoint(self) -> Optional[dict]:
        return self._state

    def restore(self, state: dict, round0: int, store_arrays: dict) -> None:
        """Resume: the carry from a checkpoint's state, the round counter,
        and the store's touched records (digest-verified)."""
        self._state = {"params": state["params"].to(
            device=self.device, dtype=self.model.param_dtype).contiguous(),
            "round": int(round0)}
        self._round = int(round0)
        self.store.restore_arrays(store_arrays)

    def checkpoint_arrays(self) -> dict:
        """The store's touched records (``ClientStateStore.
        checkpoint_arrays``) once the prefetch in flight has finished its
        lazy init, so no record is half written while it is read."""
        if self._next is not None:
            wait([self._next])
        return self.store.checkpoint_arrays()

    # -- the chunk -----------------------------------------------------
    def _to_device(self, inputs: tuple) -> tuple:
        """The chunk's host inputs on the device, copied on the current
        stream: into the graph's input buffers (the graph captured at the
        first chunk, after its eager warm-up), or fresh tensors when
        uncaptured (the host tensors themselves on the CPU)."""
        if not self.capture:
            return tuple(t.to(self.device, non_blocking=True)
                         for t in inputs)
        if self.graph is None:
            with CAPTURE_LOCK:
                warm_up_round(self._warm_step, self._state, None)
                self.warmup_rounds = 1
                self.graph = capture_round_step(self.step, self._state, None)
        for buf, src in zip(self.graph.inputs, inputs):
            buf.copy_(src, non_blocking=True)
        return self.graph.inputs

    def _run_step(self, inputs: tuple) -> dict:
        """One graph replay, or the step uncaptured."""
        if not self.capture:
            self._state, raw = self.step.fn(self._state, None, *inputs)
            return raw
        raw = self.graph()
        self._state["round"] += self.s
        return raw

    def _fetch(self, raw: dict) -> dict:
        """The chunk's outputs on the host: on the card one batch of
        non-blocking copies into pinned memory, queued behind the step,
        and one wait."""
        if not self.pin:
            return raw

        def copy(tree):
            if isinstance(tree, dict):
                return {key: copy(v) for key, v in tree.items()}
            host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            host.copy_(tree, non_blocking=True)
            return host

        host = copy(raw)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host

    def run_chunk(self, prefetch_next: bool = True) -> dict:
        """Advance ``cohorts_per_step`` rounds; returns the chunk's ``ids
        (S, K)`` and its host metrics (``assemble_metrics`` per cohort,
        a leading (S,) axis on each entry), with ``loss (S, K)`` and
        ``conf (S, K, C, C)``. ``prefetch_next``: start preparing the next
        chunk meanwhile (its members lazily initialised); a run's last
        chunk does not, so no record is written for a chunk that never
        runs."""
        sp = (self.tracer.span("cohort_gather", round=self._round + self.s)
              if self.tracer else None)
        prep = self._take_prepared(self._round)
        if sp:
            sp.end()
        if self._state is None:
            self._state = {"params": prep["params0"].to(self.device).clone(),
                           "round": 0}
        self._wb_done = threading.Event()
        if prefetch_next:
            self._schedule_next(self._round + self.s, self._wb_done)
        stats = {**prep["stats"], "stall_s": prep["stall_s"]}
        marks = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
                 if self.pin else None)
        if marks:
            marks[0].record()
        inputs = self._to_device(prep["inputs"])
        if marks:
            marks[1].record()
        raw = self._run_step(inputs)
        if marks:
            marks[2].record()
        # From the step's launch through the host read of its outputs and
        # the store writes (fedtpu's span).
        sp = (self.tracer.span("cohort_writeback",
                               round=self._round + self.s)
              if self.tracer else None)
        out = self._fetch(raw)
        if marks:
            marks[3].record()
            marks[3].synchronize()
            # Device ms between the marks; the first chunk's copy window
            # holds the graph's warm-up and capture too.
            stats["h2d_ms"] = marks[0].elapsed_time(marks[1])
            stats["step_ms"] = marks[1].elapsed_time(marks[2])
            stats["d2h_ms"] = marks[2].elapsed_time(marks[3])
        t0 = time.perf_counter()
        ids = prep["ids"]
        for s in range(self.s):
            self.store.write(ids[s], slot_leaves(
                out["params"][s], {key: v[s] for key, v in
                                   out["opt"].items()}))
        self._wb_done.set()       # unblock the next chunk's store read
        stats["write_s"] = time.perf_counter() - t0
        if sp:
            sp.end()
        if self.registry is not None:
            self.registry.gauge("client_store_resident_bytes").set(
                self.store.resident_estimate_bytes())
            self.registry.gauge("client_store_apparent_bytes").set(
                self.store.apparent_nbytes)
        self._round += self.s
        self.chunk_stats.append(stats)
        loss, conf = out["loss"].cpu(), out["conf"].cpu()
        mask = torch.from_numpy(prep["mask"])
        per = [assemble_metrics(loss[s:s + 1], conf[s:s + 1], mask[s])
               for s in range(self.s)]
        metrics = {key: ({k2: torch.cat([p[key][k2] for p in per])
                          for k2 in METRIC_NAMES}
                         if isinstance(per[0][key], dict)
                         else torch.cat([p[key] for p in per]))
                   for key in per[0]}
        return {"ids": ids, "metrics": metrics, "conf": conf}

    def close(self) -> None:
        # A half-finished chunk (an exception between dispatch and
        # write-back) leaves the prefetch worker parked on the write-back
        # event; release it so shutdown(wait=True) cannot deadlock. A
        # prefetch that failed raises here unless run_chunk already did.
        self._wb_done.set()
        pending, self._next = self._next, None
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            if pending is not None:
                pending.result()
        finally:
            self.store.flush()


def _validate_cohort_config(cfg) -> None:
    """The cohort engine runs the plain-FedAvg path only (the parity
    contract); every composition its chunk does not reproduce is refused
    with ``fedtpu``'s words, a fault plan and rollback among them.
    ``model_parallel`` off its default is refused by the port's
    ``RunConfig`` first (ROADMAP A10); its check stays here for a config
    built around it."""
    fed = cfg.fed
    if fed.cohort_size > cfg.shard.num_clients:
        raise ValueError(
            f"cohort_size={fed.cohort_size} exceeds the population "
            f"(num_clients={cfg.shard.num_clients})")
    if fed.client_store not in ("memory", "mmap"):
        raise ValueError("client_store must be 'memory' or 'mmap', got "
                         f"{fed.client_store!r}")
    if fed.async_mode:
        raise ValueError("cohort_size composes with the synchronous "
                         "engine only; the serving front-end is the "
                         "store-backed async path (docs/scaling.md)")
    if cfg.run.model_parallel > 1:
        raise ValueError("cohort mode requires the 1-D engine "
                         "(model_parallel=1)")
    if fed.participation_rate < 1.0:
        raise ValueError("cohort mode replaces in-graph client sampling "
                         "with the cohort sampler — use --cohort-sampling, "
                         "not --participation-rate")
    if (fed.server_opt != "none" or fed.dp_clip_norm > 0
            or fed.dp_noise_multiplier > 0 or fed.dp_adaptive_clip):
        raise ValueError("cohort mode supports plain FedAvg averaging "
                         "only (no server_opt / DP): the delta path's "
                         "replicated server state is not yet streamed "
                         "through the client store")
    if fed.robust_aggregation not in ("none", "median", "trimmed_mean"):
        raise ValueError(
            f"cohort mode supports robust_aggregation 'median'/"
            f"'trimmed_mean' only (mask-aware order statistics over the "
            f"cohort block); {fed.robust_aggregation!r} scores whole "
            "updates and needs the vmap engine's full population")
    if fed.robust_aggregation != "none" and fed.weighting != "uniform":
        raise ValueError("cohort robust aggregation is unweighted — set "
                         "weighting='uniform' (the median of weighted "
                         "updates is not the weighted robust location)")
    if fed.robust_aggregation != "none" and fed.aggregation != "psum":
        raise ValueError("cohort robust aggregation needs the plain psum "
                         "backend (order statistics gather the cohort "
                         "block)")
    if fed.byzantine_clients:
        raise ValueError("cohort mode does not inject synthetic byzantine "
                         "clients (byzantine_clients) — adversarial load "
                         "comes from poisoned serving traces "
                         "(serving/traces.py --poison-frac)")
    if fed.compress != "none":
        raise ValueError("cohort mode does not support compressed "
                         "exchange")
    if fed.scaffold:
        raise ValueError("cohort mode does not support SCAFFOLD")
    if fed.personalize_steps > 0:
        raise ValueError("cohort mode does not support personalize_steps")
    if fed.init_weights_npz:
        raise ValueError("cohort mode does not support init_weights_npz "
                         "warm starts yet")
    if cfg.run.on_divergence != "halt" or cfg.run.fault_plan:
        raise ValueError("cohort mode supports on_divergence='halt' only "
                         "(no rollback/fault-plan)")
    if cfg.run.pipelined_stop:
        raise ValueError("cohort mode does not support pipelined_stop "
                         "(the store writeback is the chunk boundary)")
    if fed.cohort_sampling == "trace" and not fed.cohort_trace:
        raise ValueError("cohort_sampling='trace' needs --cohort-trace "
                         "<trace.jsonl>")


def _store_path_for(cfg) -> Optional[str]:
    if cfg.fed.client_store != "mmap":
        return None
    if cfg.fed.client_store_path:
        return cfg.fed.client_store_path
    if cfg.run.checkpoint_dir:
        return os.path.join(cfg.run.checkpoint_dir, "client_store.bin")
    raise ValueError("client_store='mmap' needs --client-store-path (or a "
                     "checkpoint_dir to place client_store.bin under)")


def build_cohort_scheduler(cfg, ds, device: torch.device,
                           capture: bool = False, init_params=None,
                           registry=None, tracer=None,
                           prefetch: bool = True) -> CohortScheduler:
    """The scheduler of a cohort run on the dataset ``ds``: the model and
    optimizer, the population's packed shards (host numpy), the sampler,
    the store (``_store_path_for``) and the chunk width ``S = max(1,
    min(rounds_per_step, population // cohort_size))``. ``init_params``:
    ``fedtpu``'s client-stacked params pytree of every client, in place
    of the seed table's draws."""
    from fedtpu_torch.convert import params_from_jax
    from fedtpu_torch.data.sharding import pack_clients
    from fedtpu_torch.models.registry import build_model
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.parallel.mesh import make_mesh

    model_cfg = cfg.model
    if model_cfg.kind == "mlp" and model_cfg.input_dim != ds.input_dim:
        model_cfg = dataclasses.replace(model_cfg, input_dim=ds.input_dim)
    if model_cfg.num_classes != ds.num_classes:
        model_cfg = dataclasses.replace(model_cfg,
                                        num_classes=ds.num_classes)
    model = build_model(model_cfg)
    tx = build_optimizer(cfg.optim)
    total, k = cfg.shard.num_clients, cfg.fed.cohort_size
    packed = pack_clients(ds.x_train, ds.y_train, cfg.shard)
    px, py, pm = packed.x, packed.y, packed.mask
    data_fn = lambda ids: {"x": px[ids], "y": py[ids], "mask": pm[ids]}
    weights = trace_users = None
    if cfg.fed.cohort_sampling == "weighted":
        # Data-size-proportional availability: clients with data show up.
        weights = pm.sum(axis=1)
    if cfg.fed.cohort_sampling == "trace":
        from fedtpu_torch.serving.traces import load_trace_arrays
        _, _, users, _ = load_trace_arrays(cfg.fed.cohort_trace)
        trace_users = np.asarray(users, np.int64) % total
    sampler = CohortSampler(total, k, policy=cfg.fed.cohort_sampling,
                            seed=cfg.fed.cohort_seed, weights=weights,
                            trace_users=trace_users)
    store = ClientStateStore(record_template(model, tx), total,
                             backend=cfg.fed.client_store,
                             path=_store_path_for(cfg))
    return CohortScheduler(
        store, sampler, model, tx, ds.num_classes, data_fn, px.shape[1:],
        init_seed=cfg.fed.init_seed, same_init=cfg.fed.same_init,
        weighting=cfg.fed.weighting,
        mesh=make_mesh(cfg.run.mesh_devices, k, device),
        aggregation=cfg.fed.aggregation, local_steps=cfg.fed.local_steps,
        prox_mu=cfg.fed.prox_mu,
        cohorts_per_step=max(1, min(cfg.run.rounds_per_step, total // k)),
        robust=cfg.fed.robust_aggregation, trim_ratio=cfg.fed.trim_ratio,
        device=device, capture=capture,
        init_params=(None if init_params is None
                     else params_from_jax(init_params)),
        prefetch=prefetch, registry=registry, tracer=tracer)


def run_cohort_experiment(cfg, dataset=None, verbose: bool = True,
                          resume: bool = False, device="cuda",
                          capture: Optional[bool] = None, init_params=None):
    """The cohort engine's round loop: ``run_experiment``'s delegate for
    ``cfg.fed.cohort_size > 0`` (``fedtpu``'s ``run_cohort_experiment``).
    The same ExperimentResult and reference early-stop rule (client-mean
    4-metric vector, allclose within ``tolerance`` for
    ``termination_patience`` rounds), the held-out eval on slot 0 of the
    carry at chunk ends, and checkpoints with the store's touched records
    in the meta file. ``device``, ``capture`` (None: every chunk a graph
    replay on the card) and ``init_params`` as ``run_experiment``'s."""
    from fedtpu_torch.convert import params_to_numpy
    from fedtpu_torch.data import load_dataset
    from fedtpu_torch.orchestration.checkpoint import (
        latest_step, load_checkpoint_raw, load_meta, retain_checkpoints,
        save_checkpoint)
    from fedtpu_torch.orchestration.loop import (ExperimentResult,
                                                 resolve_device)
    from fedtpu_torch.parallel.round import build_eval_fn
    from fedtpu_torch.telemetry.log import TelemetryLogger
    from fedtpu_torch.telemetry.metrics import default_registry
    from fedtpu_torch.telemetry.trace import make_tracer

    _validate_cohort_config(cfg)
    dev = resolve_device(device)
    graphs_on = dev.type == "cuda" if capture is None else bool(capture)
    if graphs_on and dev.type != "cuda":
        raise ValueError(f"capture=True needs the card; the run is on {dev}")
    tel = cfg.run.telemetry
    tracer = make_tracer(tel.events_path)
    registry = default_registry()
    registry.reset()
    log = TelemetryLogger(verbose=verbose, tracer=tracer,
                          level=tel.log_level)
    ds = dataset if dataset is not None else load_dataset(cfg.data)
    sched = build_cohort_scheduler(cfg, ds, dev, capture=graphs_on,
                                   init_params=init_params,
                                   registry=registry, tracer=tracer)
    store, sampler, s = sched.store, sched.sampler, sched.s
    total = cfg.shard.num_clients

    history = {k2: [] for k2 in METRIC_NAMES}
    pooled_hist = {k2: [] for k2 in METRIC_NAMES}
    per_client_hist = {k2: [] for k2 in METRIC_NAMES}
    test_hist = {k2: [] for k2 in METRIC_NAMES}
    eval_step = None
    losses, confusion, sec_per_round, cohort_ids = [], [], [], []
    prev_metric = None
    termination_count = cfg.fed.termination_patience
    stopped_early = False
    diverged = False
    rounds_run = 0
    start_round = 0

    ckdir = cfg.run.checkpoint_dir
    if resume and ckdir:
        step0 = latest_step(ckdir)
        if step0 is not None:
            state, hist, start_round = load_checkpoint_raw(ckdir, step0)
            meta = {key: (v.numpy() if isinstance(v, torch.Tensor) else v)
                    for key, v in load_meta(ckdir, step0).items()}
            sched.restore(state, start_round, meta)
            for k2 in METRIC_NAMES:
                history[k2] = list(hist.get(k2, []))
            if history[METRIC_NAMES[0]]:
                prev_metric = [history[k2][-1] for k2 in METRIC_NAMES]
            rounds_run = start_round
            log.info(f"Resumed cohort run at round {start_round} "
                     f"({len(store._touched)} touched records).")

    tracer.event("cohort_config", cohort_size=sampler.k, total_clients=total,
                 store=cfg.fed.client_store,
                 sampling=cfg.fed.cohort_sampling, cohorts_per_step=s,
                 store_apparent_bytes=store.apparent_nbytes)
    lap = time.perf_counter()
    try:
        rnd = start_round
        while rnd < cfg.fed.rounds and not stopped_early and not diverged:
            # A tail chunk narrower than the chunk width runs at full
            # width and is truncated on the host (its extra cohorts still
            # persist: they are real trained rounds; the history is what
            # the round budget bounds).
            chunk = sched.run_chunk(prefetch_next=rnd + s < cfg.fed.rounds)
            m = chunk["metrics"]
            now = time.perf_counter()
            dt, lap = (now - lap) / s, now
            take = min(s, cfg.fed.rounds - rnd)
            tracer.event("span", phase="chunk", round=rnd + take,
                         dur_s=dt * take, rounds=take)
            for j in range(take):
                r = rnd + j
                client_mean = {k2: float(m["client_mean"][k2][j])
                               for k2 in METRIC_NAMES}
                losses.append(m["loss"][j].numpy())
                confusion.append(chunk["conf"][j].numpy())
                cohort_ids.append(chunk["ids"][j])
                sec_per_round.append(dt)
                rounds_run = r + 1
                for k2 in METRIC_NAMES:
                    history[k2].append(client_mean[k2])
                    pooled_hist[k2].append(float(m["pooled"][k2][j]))
                    per_client_hist[k2].append(
                        m["per_client"][k2][j].numpy())
                registry.counter("rounds").inc()
                tracer.event(
                    "cohort_round", round=r + 1, dur_s=dt,
                    cohort_size=sampler.k,
                    accuracy=client_mean["accuracy"],
                    loss_mean=float(np.mean(losses[-1])),
                    store_resident_bytes=store.resident_estimate_bytes(),
                    prefetch_stall_s=float(
                        registry.gauge("cohort_prefetch_stall_s").value))
                if verbose and (r % cfg.run.log_every == 0):
                    gvals = ", ".join(f"{k2}: {client_mean[k2]:.4f}"
                                      for k2 in METRIC_NAMES)
                    log.parity(f"  Global Metrics (Round {r + 1}): "
                               f"[{gvals}]  ({dt * 1e3:.1f} ms/round, "
                               f"cohort {sampler.k}/{total})")
                cur = [client_mean[k2] for k2 in METRIC_NAMES]
                if cfg.run.halt_on_nonfinite and not (
                        np.all(np.isfinite(cur))
                        and np.all(np.isfinite(losses[-1]))):
                    log.warning(f"Non-finite loss/metrics at round "
                                f"{r + 1}; halting (diverged run).")
                    tracer.event("diverged", round=r + 1,
                                 reason=f"loss/metrics at round {r + 1}")
                    diverged = True
                    break
                if prev_metric is not None and np.allclose(
                        cur, prev_metric, atol=cfg.fed.tolerance):
                    termination_count -= 1
                    if termination_count == 0:
                        log.parity("Early stopping triggered: No "
                                   "significant change in metrics for "
                                   f"{cfg.fed.termination_patience} "
                                   "rounds.")
                        tracer.event("early_stop", round=r + 1)
                        stopped_early = True
                        break
                else:
                    prev_metric = cur
                    termination_count = cfg.fed.termination_patience
            # Held-out eval on the synchronous loop's cadence: one row per
            # due round; due rounds inside one chunk share the chunk-end
            # global (exact at cohorts_per_step=1).
            if (cfg.run.eval_test_every and not diverged
                    and len(ds.x_test)):
                due = sum(1 for j in range(take)
                          if rnd + 1 + j <= rounds_run
                          and (rnd + 1 + j) % cfg.run.eval_test_every == 0)
                if due:
                    if eval_step is None:
                        eval_step = build_eval_fn(sched.model,
                                                  ds.num_classes)
                        x_test = torch.from_numpy(ds.x_test).to(dev)
                        y_test = torch.from_numpy(ds.y_test).to(dev)
                    tm = eval_step(sched.state_for_checkpoint()["params"][0],
                                   x_test, y_test)
                    tm = torch.stack([tm[k2] for k2 in METRIC_NAMES]).tolist()
                    for _ in range(due):
                        for k2, v in zip(METRIC_NAMES, tm):
                            test_hist[k2].append(v)
            rnd += s
            if (ckdir and cfg.run.checkpoint_every > 0
                    and not stopped_early and not diverged
                    and (rnd % cfg.run.checkpoint_every == 0
                         or rnd >= cfg.fed.rounds)):
                save_checkpoint(ckdir, sched.state_for_checkpoint(),
                                history, min(rnd, rounds_run),
                                extra_meta={
                                    key: np.asarray(v) for key, v in
                                    sched.checkpoint_arrays().items()})
                if cfg.run.keep_checkpoints > 0:
                    retain_checkpoints(ckdir, cfg.run.keep_checkpoints)
    finally:
        sched.close()

    # The final global model = any slot of the carry (all identical after
    # a round); slot 0 by convention.
    state = sched.state_for_checkpoint()
    final_params = ({} if state is None
                    else params_to_numpy(state["params"][0], sched.model))
    tracer.event("cohort_summary", rounds=rounds_run,
                 cohort_size=sampler.k, total_clients=total,
                 touched_records=len(store._touched),
                 store_resident_bytes=store.resident_estimate_bytes(),
                 store_apparent_bytes=store.apparent_nbytes,
                 prefetch_stalls=int(
                     registry.counter("cohort_prefetch_stalls").value))
    tracer.event("run_end", round=rounds_run, stopped_early=stopped_early,
                 diverged=diverged)
    tracer.counters(registry.snapshot())
    tracer.close()
    return ExperimentResult(
        global_metrics=history, pooled_metrics=pooled_hist,
        per_client_metrics=per_client_hist, test_metrics=test_hist,
        loss=losses, sec_per_round=sec_per_round, rounds_run=rounds_run,
        stopped_early=stopped_early, final_params=final_params,
        config=cfg, diverged=diverged, confusion=confusion,
        rounds_trained=sched.round, warmup_rounds=sched.warmup_rounds,
        graph_launches=({s: dict(sched.graph.launches)}
                        if sched.graph is not None else {}),
        cohort={"store": store, "ids": cohort_ids,
                "chunk_stats": sched.chunk_stats})
