"""Host round loop for the synchronous and the asynchronous engine
(``fedtpu.orchestration.loop``).

``run_experiment`` keeps ``fedtpu``'s semantics for this path: chunks of
``rounds_per_step`` rounds with one metrics fetch each; the client-mean,
pooled, per-client, loss and held-out test histories; the non-finite halt
with an emergency checkpoint; early stopping with exactly the reference
logic (``np.allclose`` of the client-mean metrics, ``atol=tolerance``,
``termination_patience`` rounds); periodic checkpoints with retention,
resume (elastic to another client count too), the ``init_weights_npz``
warm start, the ``metrics_jsonl`` log and ``pipelined_stop``; on the delta
path the server optimizer's and the adaptive clip's state, SCAFFOLD's
variates, and the DP privacy ledger (``fedtpu_torch.orchestration.
privacy``), persisted in every checkpoint's meta and reported by
``ExperimentResult.privacy_spent``; after a run that did not diverge,
``personalize_steps`` of per-client fine-tuning from the final global
model (``fedtpu_torch.training.personalize``), reported beside it.

``FedConfig.async_mode`` runs the asynchronous FedBuff engine instead
(``fedtpu_torch.parallel.async_fed``), with ``fedtpu``'s refusals of the
synchronous stack's knobs: a round is a server tick, the history and the
early stop run on tick metrics, each tick's ``(C,)`` staleness is kept
(``ExperimentResult.staleness``), the held-out eval and ``final_params``
take the freshest anchor, a checkpoint carries the anchors, pull ticks and
the K-buffer (its meta says which engine wrote it, and a resume under the
other engine raises), an elastic resume re-pulls every client from the
freshest anchor, and a run whose K-buffer never filled ends with a warning.

``FedConfig.cohort_size > 0`` hands the run to the cohort engine
(``fedtpu_torch.cohort.scheduler.run_cohort_experiment``), as ``fedtpu``'s
loop does.

On the card each chunk is one replay of a CUDA graph of the round step
(``fedtpu_torch.parallel.round.capture_round_step``; one graph per chunk
width), the counterpart of ``fedtpu``'s jitted scan, and the host reads one
buffer per chunk: its losses, confusion counts and the state's finiteness
flag, computed on the device. What the step draws on the host (the
participation masks, the DP noise) goes to the device before the replay:
every round's masks once, up front; each chunk's noise as one pinned
buffer; the asynchronous engine's arrivals, like the masks, once, up
front, and each chunk's first tick from a device table. ``capture=False``
runs the same step uncaptured (for comparison); on the CPU there is no
graph.

Telemetry (``fedtpu_torch.telemetry``) as ``fedtpu``'s loop: with
``RunConfig.telemetry.events_path`` set the run writes the schema-v2 sink
(the ``build`` span, the manifest, ``resume``, a ``chunk`` span a chunk
closed after its one host read, a ``stop_check`` span, a ``round`` event a
round, the asynchronous ``async_tick``, ``early_stop``, ``diverged``, the
``eval`` and ``checkpoint`` spans, the ``counters`` snapshot and
``run_end``); off, it talks to a ``NullTracer``. ``RunConfig.profile_dir``
opens a ``torch.profiler`` window (``profile_rounds``) written as a Chrome
trace. The operational lines go through the leveled logger (mirrored into
the sink); the reference-parity lines are printed byte for byte and never
mirrored. Telemetry adds host work only: the history and the params are
bitwise those of a run with it off.

Resilience (``fedtpu_torch.resilience``) as ``fedtpu``'s loop applies it:
``RunConfig.fault_plan``'s injector shrinks a chunk so that a fault round
runs as its own width-1 dispatch and applies its faults around it, in
place, since the state, the mask and the data-size weights are static
inputs of the round's CUDA graph (the client-mean metrics use each round's
own mask); with a checkpoint dir, SIGTERM sets a flag that the loop top
turns into a drain checkpoint and ``Preempted`` (the CLI exits 75);
``heartbeat_file`` is rewritten atomically at start, at every chunk end
and at the end; ``on_divergence='rollback'`` restores the newest loadable
checkpoint into the live state tensors (no re-capture), truncates every
history, optionally excludes the offending clients at weight 0
(``rollback_exclude``) and perturbs the params from the second retry on.
The ``fault``, ``rollback``, ``exclusion`` and ``preempted`` events, their
counters and the manifest's plan digest go to the sink.

The live elastic reshard (``fedtpu_torch.resilience.reshard``), as
``fedtpu``'s loop runs it: a plan's ``preempt_notice`` / ``preempt_cancel``
or a SIGUSR1 / SIGUSR2 notice resizes the run at a loop-top, with no
restart. A shrink moves the state with the wire-free plan
(``fedtpu_torch.parallel.reshard``), rebuilds the experiment at the target
width through the partition view (the survivors' window of the data, bitwise
their rows of the full pack), captures new CUDA graphs for it, and keeps the
original build (graphs, exchange, process group) on a stack; in a gang the
departing member parks and the survivors run over their own process group
(``multihost.split``), or, a survivor alone, the one-process round. A grow
copies the grown state into the original graphs' static state tensors in
place and replays them: nothing is captured again. It needs
``rounds_per_step`` 1 and no pipelined stop (a gang's plan also a
checkpoint dir); a plan under another config raises at start, and a signal
under one drains instead (``reshard_degraded``). A failed reshard raises
``ReshardFailed``, the gang-restart path. The ``reshard_begin``,
``reshard_done`` and ``reshard_failed`` events and the ``reshard_move`` and
``reshard_build`` spans go to the sink.

A training gang (``fedtpu_torch.parallel.multihost``: ``run`` under
``supervise --num-processes N``) runs this loop on every member, each over
its own block of the clients, as ``fedtpu``'s loop runs under
``jax.distributed``: each round is the gang step's two pieces around the
exchange (``round.GangStep``; on the card two CUDA graphs), a chunk's
metrics are gathered from every member (the chunk's one host collective,
which also carries the members' SIGTERM flags, so that they drain at the
same round), process 0 prints and writes the metrics JSONL and the
configured sink while a peer writes ``<events>.p<i>``, checkpoints are
collective (each member's part, process 0's meta), resume agrees on a
common step (``resilience.distributed.agree_resume_step``) and checks
that every member restored it, and ``collective_timeout`` arms the
collective watchdog around the blocking windows. Early stop and the
divergence halt stay consensual: every member reads the same gathered
metrics. A gang's checkpoint restores into a gang of another size, or into
one process, and the other way round: at the same client count each member
its rows, bitwise; at another, the elastic resume. Not in a gang yet
(ROADMAP A10d): cohort mode, pipelined stop, rollback, personalization, a
warm start and the client-targeted faults.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
with no GPU and no such request they raise rather than fall back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedtpu_torch.config import ExperimentConfig, _not_ported
from fedtpu_torch.convert import params_from_jax, params_to_numpy
from fedtpu_torch.data import load_dataset
from fedtpu_torch.data.sharding import pack_clients
from fedtpu_torch.data.tabular import Dataset
from fedtpu_torch.models.registry import (FlatModel, build_model, jax_order,
                                          tree_leaves)
from fedtpu_torch.ops.metrics import METRIC_NAMES
from fedtpu_torch.ops.optim import Optimizer, build_optimizer
from fedtpu_torch.ops.server_opt import make_server_optimizer
from fedtpu_torch.orchestration.checkpoint import (
    complete_steps, latest_step, load_checkpoint_fallback,
    load_checkpoint_raw, load_meta, retain_checkpoints, save_checkpoint,
    saved_num_clients)
from fedtpu_torch.orchestration.privacy import PrivacyLedger
from fedtpu_torch.parallel import multihost
from fedtpu_torch.parallel.async_fed import (async_global_params,
                                             build_async_round_fn,
                                             build_gang_async_round_fn,
                                             init_async_state,
                                             record_tick_telemetry)
from fedtpu_torch.parallel.mesh import ClientMesh, make_mesh
from fedtpu_torch.parallel.ring import GangExchange
from fedtpu_torch.parallel.round import (_per_client_slots, assemble_metrics,
                                         build_eval_fn, build_round_fn,
                                         capture_gang_step,
                                         capture_round_step, check_knobs,
                                         client_init_seeds, client_inits,
                                         global_params, init_federated_state,
                                         pack_outputs, unpack_outputs,
                                         warm_up_round)
from fedtpu_torch.resilience.distributed import heartbeat_path_for
from fedtpu_torch.resilience.supervisor import Preempted, write_heartbeat
from fedtpu_torch.telemetry.log import TelemetryLogger
from fedtpu_torch.telemetry.manifest import build_manifest, profile_entry
from fedtpu_torch.telemetry.metrics import (default_registry,
                                            device_memory_gauges)
from fedtpu_torch.telemetry.trace import make_tracer
from fedtpu_torch.training.personalize import build_personalize_fn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``cuda`` needs a GPU. Also pins
    fp32 matrix products and convolutions to full fp32 (no TF32), as the
    reference computes at Precision.HIGHEST, and cuDNN to deterministic
    algorithms without autotuning (its choice is made on first use, before
    a CUDA graph captures, and a replay is bitwise the uncaptured step)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: fedtpu_torch runs on the GPU by default; pass "
            "device='cpu' (CLI: --platform cpu) to run the plain versions on "
            "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    return dev


@dataclasses.dataclass
class ExperimentResult:
    """History + final model, with ``fedtpu``'s field names."""

    global_metrics: Dict[str, List[float]]       # client mean per round
    pooled_metrics: Dict[str, List[float]]       # pooled over clients
    per_client_metrics: Dict[str, List[np.ndarray]]
    test_metrics: Dict[str, List[float]]         # held-out, global model
    loss: List[np.ndarray]                       # (C,) per round
    sec_per_round: List[float]
    rounds_run: int
    stopped_early: bool
    final_params: dict                           # fedtpu's pytree layout
    config: ExperimentConfig
    diverged: bool = False
    # (C, K, K) in-round confusion counts per round, the currency every
    # metric above derives from (fedtpu keeps them on the device).
    confusion: List[np.ndarray] = dataclasses.field(default_factory=list)
    # The state's own round counter: what final_params trained through
    # (> rounds_run after a pipelined stop's overshoot chunk).
    rounds_trained: int = 0
    # Rounds the CUDA graphs' warm-up ran (one eager round before the first
    # capture, result dropped); its kernel launches are real and counted.
    warmup_rounds: int = 0
    # Chunk width -> the kernel launches one replay of its graph makes.
    graph_launches: Dict[int, dict] = dataclasses.field(default_factory=dict)
    # The privacy ledger's view of the released state (fedtpu's fields):
    # the cumulative per-order RDP curve (None when DP noise is off), and
    # its honesty flags (fedtpu_torch.orchestration.privacy).
    dp_rdp_total: Optional[np.ndarray] = None
    dp_base_assumed: bool = False
    dp_guarantee_void: bool = False
    dp_composed: bool = False
    # Final adaptive clip norm; None when adaptive clipping is off.
    final_dp_clip: Optional[float] = None
    # Post-training personalization (FedConfig.personalize_steps > 0):
    # {"per_client": {name: (C,)}, "client_mean": {name: float}}; empty when
    # it is off.
    personalized_metrics: Dict[str, dict] = dataclasses.field(
        default_factory=dict)
    # The asynchronous engine's per-tick (C,) staleness: arrivals report
    # the staleness their update had, absentees their current age. Empty
    # for the synchronous engine.
    staleness: List[np.ndarray] = dataclasses.field(default_factory=list)
    # The cohort engine's (fedtpu_torch.cohort.scheduler): "store", its
    # ClientStateStore after the run; "ids", each round's (K,) sampled ids;
    # "chunk_stats", each chunk's host and device times
    # (CohortScheduler.chunk_stats). Empty for the other engines.
    cohort: dict = dataclasses.field(default_factory=dict)
    # Divergence rollbacks the run made (on_divergence='rollback').
    rollbacks: int = 0

    def summary(self) -> dict:
        warm = max(1, self.config.run.rounds_per_step)
        steady = (self.sec_per_round[warm:] if len(self.sec_per_round) > warm
                  else self.sec_per_round or [0.0])
        dp = self.privacy_spent()
        return {
            "rounds_run": self.rounds_run,
            "stopped_early": self.stopped_early,
            "diverged": self.diverged,
            "final_global_metrics": {k: v[-1] for k, v in
                                     self.global_metrics.items() if v},
            "mean_sec_per_round": float(np.mean(steady)),
            **({"personalized_client_mean":
                self.personalized_metrics.get("client_mean")}
               if self.personalized_metrics else {}),
            **({"dp": dp} if dp else {}),
            **({"final_dp_clip": self.final_dp_clip}
               if self.final_dp_clip is not None else {}),
            **({"mean_staleness":
                float(np.mean([s.mean() for s in self.staleness])),
                "max_staleness":
                float(max(s.max() for s in self.staleness))}
               if self.staleness else {}),
        }

    def privacy_spent(self) -> dict:
        """(epsilon, delta) spent by this run's DP aggregation, as
        ``fedtpu``'s ``ExperimentResult.privacy_spent``: empty when DP noise
        was off and no earlier segment spent any; the client-level
        subsampled Gaussian mechanism (q = participation_rate, sigma =
        dp_noise_multiplier), one invocation per round the released state
        trained through (``rounds_trained``: a pipelined stop's overshoot
        chunk counts), composed over resumed segments by the RDP curve
        (``fedtpu_torch.ops.dp_accountant``)."""
        fed = self.config.fed
        curve_spent = (self.dp_rdp_total is not None
                       and bool(np.any(np.asarray(self.dp_rdp_total) > 0)))
        if fed.dp_noise_multiplier <= 0 and not curve_spent:
            return {}
        from fedtpu_torch.ops.dp_accountant import (epsilon_from_rdp,
                                                    privacy_spent)
        steps = max(self.rounds_run, self.rounds_trained)
        if self.dp_rdp_total is not None:
            spent = epsilon_from_rdp(list(self.dp_rdp_total), fed.dp_delta)
        else:
            spent = privacy_spent(q=fed.participation_rate,
                                  noise_multiplier=fed.dp_noise_multiplier,
                                  steps=steps, delta=fed.dp_delta)
        out = {"epsilon": spent["epsilon"], "delta": spent["delta"],
               "rdp_order": spent["order"],
               "noise_multiplier": fed.dp_noise_multiplier,
               "sampling_rate": fed.participation_rate,
               "rounds": steps}
        if self.dp_composed:
            # (sigma, q) above are the current segment's only.
            out["composed_over_resumed_segments"] = True
        if self.dp_guarantee_void:
            # Unnoised rounds re-trained on the private data after noised
            # ones: no finite (eps, delta) holds for the released model.
            out["epsilon"] = math.inf
            out["rdp_order"] = None
            out["guarantee_void"] = ("rounds trained with noise off "
                                     "after noised rounds")
        if self.dp_base_assumed:
            out["resume_rdp"] = "assumed_current_config"
        return out


@dataclasses.dataclass
class Experiment:
    """Wired-up experiment: data on the device + round-step factory."""

    make_step: Callable[[int], Callable]   # rounds_per_step -> round_step
    state: dict
    batch: dict
    eval_step: Callable
    dataset: Dataset
    device: torch.device
    model: FlatModel
    mesh: ClientMesh
    client_weights: torch.Tensor           # (C,) FedAvg base weights
    tx: Optimizer
    # Post-training per-client fine-tune (FedConfig.personalize_steps > 0).
    personalize_fn: Optional[Callable] = None
    # The global model of the engine's state: slot 0 for the synchronous
    # engine (every slot holds it), the freshest anchor for the
    # asynchronous one; in a gang, process 0's, broadcast.
    global_fn: Callable = global_params
    # A training gang's member (fedtpu_torch.parallel.multihost): its gang
    # and its round's exchange.
    gang: Optional[object] = None
    exchange: Optional[object] = None

    @property
    def dims(self) -> Optional[tuple]:
        """The float32 MLP's widths, else None (``FlatModel.mlp_dims``)."""
        return self.model.mlp_dims


def warm_start_params(path: str, model: FlatModel) -> torch.Tensor:
    """The global model ``(D,)`` of a weights artifact
    (``fedtpu_torch.sweep.grid.save_best_weights``, fedtpu's format), held
    to the model's architecture with ``fedtpu``'s ``ValueError``; in the
    artifact's float32 (the state casts it into the slots' dtype, as
    ``fedtpu``'s ``astype``)."""
    from fedtpu_torch.sweep.grid import load_best_weights
    weights = load_best_weights(path)["weights"]
    # fedtpu lists the leaves in its pytree's order (a layer's b before
    # its w).
    shapes = dict(tree_leaves(weights))
    artifact = [tuple(np.shape(shapes[p])) for p in jax_order(shapes)]
    live = dict(model.leaves)
    expect = [tuple(live[p]) for p in jax_order(live)]
    if jax_order(shapes) != jax_order(live) or artifact != expect:
        raise ValueError(
            f"init_weights_npz architecture mismatch: artifact leaves "
            f"{artifact} vs model (per-client) {expect} — the artifact "
            "was saved for a different hidden_sizes/input_dim")
    return params_from_jax(weights)


def check_async_config(fed) -> None:
    """``fedtpu``'s refusals of an asynchronous run, in its order and with
    its messages (``fedtpu/orchestration/loop.py:262-268, 287-329``): its
    two fail-fast DP checks, then each knob of the synchronous aggregation
    stack that the tick process makes meaningless or unsound.
    ``model_parallel`` is refused by ``RunConfig`` itself (ROADMAP A10c)."""
    if fed.dp_noise_multiplier > 0 and fed.dp_clip_norm <= 0:
        raise ValueError("dp_noise_multiplier requires dp_clip_norm > 0 "
                         "(noise std is noise_multiplier * clip / weight)")
    if fed.dp_adaptive_clip and fed.dp_clip_norm <= 0:
        raise ValueError("dp_adaptive_clip needs dp_clip_norm > 0 as the "
                         "initial clip")
    if fed.weighting != "uniform":
        raise ValueError("async_mode requires weighting='uniform': the "
                         "FedBuff arrival mean is unweighted "
                         "(--weighting uniform)")
    if fed.participation_rate < 1.0:
        raise ValueError("async_mode replaces client sampling with its "
                         "own arrival process; use --arrival-rate, not "
                         "--participation-rate")
    if fed.server_opt != "none":
        raise ValueError("async_mode has its own server update "
                         "(server_lr-scaled discounted delta mean); "
                         "FedOpt server optimizers are unsupported")
    if fed.dp_clip_norm > 0 or fed.dp_noise_multiplier > 0:
        raise ValueError("async_mode does not support DP aggregation: "
                         "per-arrival releases need an async-specific "
                         "accountant fedtpu does not claim to have")
    if fed.robust_aggregation != "none" or fed.byzantine_clients:
        raise ValueError("async_mode does not support robust "
                         "aggregation rules (they need the full cohort "
                         "each round; arrivals are a sparse subset)")
    if fed.compress != "none":
        raise ValueError("async_mode does not support compressed "
                         "exchange")
    if fed.scaffold:
        raise ValueError("async_mode does not support SCAFFOLD (its "
                         "variate refresh assumes lockstep rounds)")
    if fed.personalize_steps > 0:
        raise ValueError("async_mode does not support personalize_steps: "
                         "post-training fine-tune starts every client "
                         "from the final averaged global, but async "
                         "client slots hold distinct (possibly stale) "
                         "local models, not that global")
    if fed.aggregation != "psum":
        raise ValueError("async_mode uses the psum aggregation path "
                         "only")


def check_resilience_config(cfg: ExperimentConfig) -> None:
    """``fedtpu``'s validation of the resilience knobs, with its messages
    (``fedtpu/orchestration/loop.py:578-606``), before any build work."""
    run = cfg.run
    if run.on_divergence not in ("halt", "rollback"):
        raise ValueError("on_divergence must be 'halt' or 'rollback', got "
                         f"{run.on_divergence!r}")
    if run.on_divergence == "rollback":
        if not (run.checkpoint_dir and run.checkpoint_every > 0):
            raise ValueError("on_divergence='rollback' needs a restore "
                             "point: set checkpoint_dir and "
                             "checkpoint_every > 0")
        if run.pipelined_stop:
            raise ValueError(
                "on_divergence='rollback' is incompatible with "
                "pipelined_stop: the pipelined divergence guard fires one "
                "in-flight chunk late, after the restore point's successor "
                "chunk already dispatched")
    if run.rollback_exclude:
        if run.on_divergence != "rollback":
            raise ValueError("rollback_exclude requires "
                             "on_divergence='rollback'")
        if cfg.fed.async_mode:
            raise ValueError("rollback_exclude requires the synchronous "
                             "engines: exclusion zeroes the sample mask, "
                             "which the async arrival process ignores")
        if cfg.fed.weighting != "data_size":
            raise ValueError(
                "rollback_exclude requires weighting='data_size': a "
                "zero-mask client has aggregation weight mask.sum()=0 only "
                "under data-size weighting (under 'uniform' it would still "
                "average in at weight 1)")


# The fault kinds a training gang applies (the reshard kinds are the
# reshard controller's); the others target clients or files by index,
# which a gang member would have to map onto its own block.
GANG_FAULT_KINDS = ("process_kill", "collective_hang", "straggler",
                    "preempt_notice", "preempt_cancel")


def check_gang_config(cfg: ExperimentConfig) -> None:
    """What a training gang does not run yet raises, before any build,
    naming the ROADMAP item that brings it (the aggregation branches
    besides plain FedAvg raise in ``round.check_gang_knobs``)."""
    fed, run = cfg.fed, cfg.run
    for on, what in (
            (fed.cohort_size > 0, "cohort mode (the multi-process cohort "
                                  "gather, fedtpu's future work too)"),
            (run.pipelined_stop, "pipelined_stop"),
            (run.on_divergence == "rollback", "on_divergence='rollback'"),
            (fed.personalize_steps > 0, "personalize_steps"),
            (bool(fed.init_weights_npz), "init_weights_npz")):
        if on:
            _not_ported(f"{what} in a training gang", "A10d")
    if run.fault_plan:
        from fedtpu_torch.resilience.faults import FaultPlan
        plan = FaultPlan.load(run.fault_plan,
                              num_clients=cfg.shard.num_clients,
                              rounds=fed.rounds)
        kinds = sorted({f.kind for f in plan.faults
                        if f.kind not in GANG_FAULT_KINDS})
        if kinds:
            _not_ported(f"fault kind(s) {kinds} in a training gang (it "
                        f"applies {list(GANG_FAULT_KINDS)})", "A10d")


def _copy_state_into(live: dict, restored: dict) -> None:
    """A restored state's values into the live state's tensors, in place
    (the captured graphs read those tensors), its numbers assigned."""
    for k, v in restored.items():
        if isinstance(v, dict):
            _copy_state_into(live[k], v)
        elif isinstance(v, torch.Tensor):
            live[k].copy_(v)
        else:
            live[k] = v


# build_experiment's default gang: this process's (multihost.current()).
_CURRENT = object()


def build_experiment(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                     device="cuda", init_params=None,
                     participation_masks=None, dp_noise=None,
                     arrival_masks=None, mesh: Optional[ClientMesh] = None,
                     gang=_CURRENT) -> Experiment:
    """Wire data -> device -> mesh -> model -> optimizer -> round factory
    (the tick factory under ``FedConfig.async_mode``).

    ``init_params``: a ``fedtpu`` client-stacked params pytree (numpy
    leaves) to start from instead of the seeded init (the asynchronous
    engine starts from their mean, or from the model they all hold, e.g.
    ``fedtpu``'s own anchors); ``FedConfig.init_weights_npz`` then
    broadcasts its model into every slot over it. ``participation_masks``:
    round index -> ``(C,)`` mask, replacing the port's own client-sampling
    draws; ``dp_noise``: round index -> the round's ``(D + 1,)`` unit
    normals, replacing the port's own DP noise draws (``build_round_fn``);
    ``arrival_masks``: tick -> ``(C,)`` arrivals, replacing the
    asynchronous engine's own draws (``build_async_round_fn``).

    In a training gang (``multihost.current()``) the member builds only its
    block of the clients (``local_client_slice``): their data rows, weights
    and state, its seeded inits drawn from the clients' own seeds as in one
    process (the asynchronous engine's shared start from all of them), on
    its own device; every mask and arrival table stays the gang's, the
    member taking its columns. The round exchanges through one
    ``GangExchange``, built here once.

    ``mesh`` and ``gang``: a live reshard's rebuild (the shrunk mesh,
    ``parallel.mesh.submesh``, and the survivors' gang or None for a
    survivor alone) instead of ``make_mesh`` over this process's gang."""
    if gang is _CURRENT:
        gang = multihost.current()
    dev = resolve_device(device)
    if gang is not None:
        if (dev.type == "cpu") != (gang.device.type == "cpu"):
            raise ValueError(f"a gang member on {gang.device} asked to run "
                             f"on {dev}")
        dev = gang.device
    ds = dataset if dataset is not None else load_dataset(cfg.data)
    # The data sets the MLP's input width and every model's class count, as
    # in fedtpu.
    model_cfg = cfg.model
    if model_cfg.kind == "mlp" and model_cfg.input_dim != ds.input_dim:
        model_cfg = dataclasses.replace(model_cfg, input_dim=ds.input_dim)
    if model_cfg.num_classes != ds.num_classes:
        model_cfg = dataclasses.replace(model_cfg,
                                        num_classes=ds.num_classes)
    model = build_model(model_cfg)
    tx = build_optimizer(cfg.optim)
    packed = pack_clients(ds.x_train, ds.y_train, cfg.shard)
    num_clients = cfg.shard.num_clients
    fed = cfg.fed

    server = None
    if fed.async_mode:
        check_async_config(fed)
    else:
        if fed.server_opt != "none":
            server = make_server_optimizer(
                fed.server_opt, learning_rate=fed.server_lr,
                momentum=fed.server_momentum, b1=fed.server_b1,
                b2=fed.server_b2, tau=fed.server_tau)
        # fedtpu's refusals, before the state is built, and the delta
        # path's server optimizer, decided once for the state and the
        # round.
        _, server, _, _ = check_knobs(
            fed.weighting, fed.participation_rate, fed.aggregation, server,
            fed.dp_clip_norm, fed.dp_noise_multiplier, fed.dp_adaptive_clip,
            fed.dp_target_quantile, fed.dp_clip_lr,
            fed.dp_count_noise_multiplier, fed.compress,
            fed.robust_aggregation, fed.trim_ratio, fed.krum_f,
            fed.byzantine_clients, fed.scaffold)

    params = None if init_params is None else params_from_jax(init_params)
    if mesh is None:
        mesh = make_mesh(cfg.run.mesh_devices, num_clients, dev, gang=gang)
    rows = multihost.local_client_slice(mesh)
    exchange = None
    if gang is not None:
        if dev.type == "cuda":
            # Built before the gang's first collective, so that no member
            # waits on another's nvcc inside a guarded window.
            from fedtpu_torch.ops._build import load_library
            load_library()
        if params is None:
            seeds = client_init_seeds(fed.init_seed, num_clients,
                                      fed.same_init)
            params = (client_inits(model, seeds[:1]).expand(num_clients, -1)
                      if fed.same_init else client_inits(model, seeds))
        if fed.async_mode:
            # Every client starts from the whole gang's shared global.
            params = init_async_state(None, num_clients, model, tx,
                                      params=params)["anchors"]
        params = params[rows]
        exchange = GangExchange("psum" if fed.async_mode else
                                fed.aggregation, gang, mesh,
                                model.param_count + 1, dev)
        num_clients = mesh.local_clients
        packed_rows = {k: getattr(packed, k)[rows]
                       for k in ("x", "y", "mask", "counts")}
    else:
        packed_rows = {k: getattr(packed, k)
                       for k in ("x", "y", "mask", "counts")}
    if fed.init_weights_npz:
        # The asynchronous engine's clients have pulled the warm start:
        # its anchors hold it too (init_async_state).
        params = warm_start_params(fed.init_weights_npz, model).expand(
            num_clients, -1)
    batch = {k: torch.from_numpy(np.ascontiguousarray(packed_rows[k])).to(
        dev) for k in ("x", "y", "mask")}
    weights = (packed_rows["counts"].astype(np.float32)
               if fed.weighting == "data_size"
               else np.ones(num_clients, np.float32))
    client_weights = torch.from_numpy(weights).to(dev)
    if fed.async_mode:
        state = init_async_state(
            fed.init_seed, num_clients, model, tx, same_init=fed.same_init,
            device=dev, params=params, buffer_size=fed.async_buffer_size,
            gang=gang is not None)
        make_step = lambda r: build_async_round_fn(
            model, tx, ds.num_classes, num_clients,
            arrival_rate=fed.async_arrival_rate,
            arrival_seed=fed.async_arrival_seed,
            staleness_power=fed.async_staleness_power,
            server_lr=fed.server_lr, local_steps=fed.local_steps,
            prox_mu=fed.prox_mu, buffer_size=fed.async_buffer_size,
            ticks_per_step=r, arrival_masks=arrival_masks)
        if gang is not None:
            make_step = lambda r: build_gang_async_round_fn(
                model, tx, ds.num_classes, mesh, exchange,
                arrival_rate=fed.async_arrival_rate,
                arrival_seed=fed.async_arrival_seed,
                staleness_power=fed.async_staleness_power,
                server_lr=fed.server_lr, local_steps=fed.local_steps,
                prox_mu=fed.prox_mu, buffer_size=fed.async_buffer_size,
                ticks_per_step=r, arrival_masks=arrival_masks)
    else:
        state = init_federated_state(
            fed.init_seed, num_clients, model, tx, same_init=fed.same_init,
            device=dev, params=params, server_opt=server,
            shared_start=fed.compress != "none", scaffold=fed.scaffold,
            adaptive_clip_init=(fed.dp_clip_norm if fed.dp_adaptive_clip
                                else None))
        make_step = lambda r: build_round_fn(
            model, tx, ds.num_classes, client_weights, rounds_per_step=r,
            mesh=mesh, aggregation=fed.aggregation,
            participation_rate=fed.participation_rate,
            participation_seed=fed.participation_seed,
            participation_masks=participation_masks,
            local_steps=fed.local_steps, prox_mu=fed.prox_mu,
            weighting=fed.weighting, server_opt=server,
            dp_clip_norm=fed.dp_clip_norm,
            dp_noise_multiplier=fed.dp_noise_multiplier, dp_seed=fed.dp_seed,
            dp_adaptive_clip=fed.dp_adaptive_clip,
            dp_target_quantile=fed.dp_target_quantile,
            dp_clip_lr=fed.dp_clip_lr,
            dp_count_noise_multiplier=fed.dp_count_noise_multiplier,
            dp_noise=dp_noise, compress=fed.compress,
            robust_aggregation=fed.robust_aggregation,
            trim_ratio=fed.trim_ratio, krum_f=fed.krum_f,
            byzantine_clients=fed.byzantine_clients, scaffold=fed.scaffold,
            exchange=exchange)
    personalize_fn = None
    if fed.personalize_steps > 0:
        personalize_fn = build_personalize_fn(model, tx, ds.num_classes,
                                              fed.personalize_steps)
    global_fn = async_global_params if fed.async_mode else global_params
    if gang is not None:
        # Process 0's global on every member: one process's slot 0 (a
        # ring's shards hold globals that differ in the last bits).
        own = (lambda st: st["global"]) if fed.async_mode else global_params
        global_fn = lambda st: gang.broadcast(own(st), 0)
    return Experiment(make_step=make_step, state=state, batch=batch,
                      eval_step=build_eval_fn(model, ds.num_classes),
                      dataset=ds, device=dev, model=model, mesh=mesh,
                      client_weights=client_weights, tx=tx,
                      personalize_fn=personalize_fn, global_fn=global_fn,
                      gang=gang, exchange=exchange)


class _Fetch:
    """One chunk's packed outputs on their way to the host: on the card a
    non-blocking copy into pinned memory and an event, queued right after
    the chunk (before the next replay overwrites the graph's outputs);
    ``get`` waits on the event."""

    def __init__(self, out: torch.Tensor):
        self.event = None
        # A gang's agreed finiteness flag (every member's), set when the
        # chunk's outputs are gathered.
        self.agreed: Optional[bool] = None
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = out

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def finite(self) -> bool:
        """The chunk-end state's finiteness flag (the last entry of
        ``pack_outputs``); in a gang, every member's."""
        if self.agreed is not None:
            return self.agreed
        return bool(self.get()[-1] > 0)


class _ProfileWindow:
    """The ``torch.profiler`` window of ``RunConfig.profile_dir`` /
    ``profile_rounds`` (``fedtpu``'s ``jax.profiler`` window): host
    activity, and the card's on a run there, written as a Chrome trace
    ``<profile_dir>/rounds_<a>-<b>.<pid>.trace.json`` (rounds a..b). With
    ``rounds`` K > 0 it opens at the first chunk end (after that chunk's
    host read, so the graphs' warm-up and capture stay out) and closes at
    the first chunk end covering >= K rounds, with a ``profile_window``
    start and stop event each; K = 0 traces the whole run."""

    def __init__(self, directory: Optional[str], rounds: int,
                 device: torch.device, tracer, start_round: int):
        self.directory = directory
        self.rounds = int(rounds)
        self.device = device
        self.tracer = tracer
        self._prof = None
        self._start_round = start_round
        self._pending = bool(directory and self.rounds > 0)
        if directory and self.rounds <= 0:
            self._open(start_round)

    def _open(self, rnd: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._start_round = rnd

    def _close(self, rnd: int) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"rounds_{self._start_round}-"
                            f"{rnd}.{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)

    def at_chunk_end(self, rnd: int) -> None:
        """After a chunk's host read; ``rnd`` is its last round."""
        if self._pending:
            self._pending = False
            self._open(rnd)
            self.tracer.event("profile_window", phase="start", round=rnd,
                              rounds=self.rounds)
        elif (self._prof is not None and self.rounds > 0
              and rnd - self._start_round >= self.rounds):
            covered = rnd - self._start_round
            self._close(rnd)
            self.tracer.event("profile_window", phase="stop", round=rnd,
                              rounds=covered)

    def close(self, rnd: int) -> None:
        """The run's end (or failure): a window still open is written."""
        if self._prof is not None:
            self._close(rnd)


def _state_layout(tree, prefix: str = "") -> dict:
    """name -> (shape, dtype) of every tensor of a state (nested dicts
    flattened), its round counter aside."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state_layout(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device).contiguous()
    return tree


def _restore_state(raw: dict, like: dict, device: torch.device) -> dict:
    """A saved state at the live client count onto ``device``, held to the
    live state's layout (optimizer kind, server optimizer, variates, clip,
    shapes, dtypes); its tensors are restored bit for bit."""
    saved, live = _state_layout(raw), _state_layout(like)
    if saved != live or ("shared_start" in raw) != ("shared_start" in like):
        raise ValueError(
            "resume mismatch: the checkpoint holds params "
            f"{tuple(raw['params'].shape)} and optimizer state "
            f"{sorted(raw['opt_state'])}; the config builds params "
            f"{tuple(like['params'].shape)} and {sorted(like['opt_state'])} "
            f"(state entries saved {sorted(saved)}, built {sorted(live)})")
    state = _to_device({k: v for k, v in raw.items() if k != "round"},
                       device)
    state["round"] = int(raw["round"])
    return state


def agree_resume(ckpt_dir: str, gang, restart_count: int, guard,
                 log) -> Optional[int]:
    """A gang's resume step (``fedtpu``'s agreement,
    ``fedtpu/orchestration/loop.py:940-990``): every member publishes the
    newest complete step it sees and the gang restores the minimum, or
    starts fresh together (None) when any member sees none. Without
    ``FEDTPU_LAUNCH_ID`` (a launch by hand) process 0's nonce, broadcast,
    tags the generation."""
    from fedtpu_torch.resilience.distributed import (ENV_LAUNCH_ID,
                                                     NO_CHECKPOINT,
                                                     agree_resume_step)
    local = latest_step(ckpt_dir)
    launch_id = os.environ.get(ENV_LAUNCH_ID) or None
    with guard("resume_agreement"):
        if launch_id is None:
            nonce = torch.tensor([int.from_bytes(os.urandom(4), "little")])
            launch_id = f"bcast:{int(gang.broadcast(nonce, 0)[0]):08x}"
        agreed = agree_resume_step(ckpt_dir, gang.process_index,
                                   gang.process_count, local,
                                   restart_count=restart_count,
                                   launch_id=launch_id)
    if agreed == NO_CHECKPOINT:
        log.info("Resume agreement: no complete checkpoint common to the "
                 "whole gang; starting fresh consensually.")
        return None
    if agreed != local:
        log.info(f"Resume agreement: restoring round {agreed} (local "
                 f"latest: {local}) — the newest step every process can "
                 "see.")
    return agreed


def gather_chunk(gang, flat: torch.Tensor, take: int, local_clients: int,
                 num_classes: int, outputs: tuple, flag: bool) -> tuple:
    """Every member's packed chunk outputs, gathered and merged into the
    gang's ``unpack_outputs`` (clients in member order; the per-round
    entries, equal on every member, from process 0; ``finite`` only when
    every member's state is finite), and whether any member raised
    ``flag`` (a SIGTERM caught since its last chunk)."""
    stack = gang.all_gather(torch.cat((
        flat.to(torch.float32).cpu(),
        torch.tensor([1.0 if flag else 0.0]))))
    parts = [unpack_outputs(row[:-1], take, local_clients, num_classes,
                            *outputs) for row in stack]
    per_client = ("loss", "conf") + tuple(outputs[0])
    raw = {k: torch.cat([p[k] for p in parts], dim=1) for k in per_client}
    raw.update({k: parts[0][k] for k in outputs[1]})
    raw["finite"] = all(p["finite"] for p in parts)
    return raw, bool((stack[:, -1] > 0).any())


def run_experiment(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                   verbose: bool = True, device="cuda", init_params=None,
                   participation_masks=None, resume: bool = False,
                   capture: Optional[bool] = None,
                   dp_noise=None, arrival_masks=None) -> ExperimentResult:
    """Run the federated loop (see module docstring). ``resume``: continue
    from the newest checkpoint under ``run.checkpoint_dir`` (a fresh run
    into a directory that holds rounds raises). ``capture``: None runs
    every chunk as a CUDA graph replay on the card and the plain step on
    the CPU; False runs the step uncaptured on the card too.
    ``participation_masks``, ``dp_noise`` and ``arrival_masks``:
    ``build_experiment``'s."""
    gang = multihost.current()
    if gang is not None:
        check_gang_config(cfg)
    if cfg.fed.cohort_size > 0:
        # The cohort engine: the population in a host-side store, only
        # cohort_size slots on the device (fedtpu_torch.cohort.scheduler).
        if any(a is not None for a in (participation_masks, dp_noise,
                                       arrival_masks)):
            raise ValueError("cohort mode samples its own cohorts: "
                             "participation_masks, dp_noise and "
                             "arrival_masks do not apply")
        from fedtpu_torch.cohort.scheduler import run_cohort_experiment
        return run_cohort_experiment(cfg, dataset=dataset, verbose=verbose,
                                     resume=resume, device=device,
                                     capture=capture,
                                     init_params=init_params)
    # The resilience knobs first: a bad combination fails before a build.
    check_resilience_config(cfg)
    proc = 0 if gang is None else gang.process_index
    # Process 0 prints, writes the metrics JSONL and keeps the configured
    # sink; a peer's sink is <events>.p<i> (one writer a file).
    io_proc = proc == 0
    verbose = verbose and io_proc
    tel = cfg.run.telemetry
    events_path = tel.events_path
    if events_path and not io_proc:
        events_path = f"{events_path}.p{proc}"
    tracer = make_tracer(events_path, role="run", process_index=proc)
    registry = default_registry()
    registry.reset()
    log = TelemetryLogger(verbose=verbose, tracer=tracer,
                          level=tel.log_level)
    with tracer.span("build"):
        exp = build_experiment(cfg, dataset, device=device,
                               init_params=init_params,
                               participation_masks=participation_masks,
                               dp_noise=dp_noise, arrival_masks=arrival_masks)
    dev = exp.device
    graphs_on = dev.type == "cuda" if capture is None else bool(capture)
    if graphs_on and dev.type != "cuda":
        raise ValueError(f"capture=True needs the card; the run is on {dev}")
    ds, state, batch = exp.dataset, exp.state, exp.batch
    num_clients, num_classes = cfg.shard.num_clients, ds.num_classes
    # The host's copy of the sample mask (the client-mean metrics' empty
    # shards): its own tensor, since faults edit the device mask in place;
    # in a gang, every member's rows.
    if cfg.run.checkpoint_dir and proc == 0:
        # A dead gang's reshard records never reach this run: process 0
        # clears them before the gang's first collective (the gather
        # below), so no peer has published one of this run's yet.
        from fedtpu_torch.resilience.distributed import clear_reshard_records
        clear_reshard_records(cfg.run.checkpoint_dir)
    mask_host = multihost.gather_rows(gang, batch["mask"]).cpu().clone()
    exchange = exp.exchange
    x_test = torch.from_numpy(ds.x_test).to(dev)
    y_test = torch.from_numpy(ds.y_test).to(dev)
    ckpt_dir = cfg.run.checkpoint_dir
    engine_async = "anchors" in state
    # Supervisor restart generation (FEDTPU_RESTARTS): in the manifest, and
    # it disarms the plan's once-per-run faults.
    restart_count = int(os.environ.get("FEDTPU_RESTARTS", "0") or 0)
    # The live reshard fires at an exact round boundary, between chunks of
    # one round, with the synchronous stop path.
    reshard_live = cfg.run.rounds_per_step == 1 and not cfg.run.pipelined_stop
    injector = None
    if cfg.run.fault_plan:
        from fedtpu_torch.resilience.faults import (RESHARD_KINDS,
                                                    FaultInjector, FaultPlan)
        plan = FaultPlan.load(cfg.run.fault_plan, num_clients=num_clients,
                              rounds=cfg.fed.rounds)
        if any(f.kind in RESHARD_KINDS for f in plan.faults):
            # fedtpu's refusals, with its messages: the plan promised an
            # exact-round reshard the config cannot deliver.
            if not reshard_live:
                raise ValueError("preempt_notice/preempt_cancel faults "
                                 "require rounds_per_step=1 and "
                                 "pipelined_stop off: the reshard fires at "
                                 "an exact round boundary")
            if gang is not None and not ckpt_dir:
                raise ValueError("multi-process elastic reshard needs "
                                 "checkpoint_dir: the commit barrier and "
                                 "grow spool live under "
                                 "<checkpoint_dir>/.reshard")
        injector = FaultInjector(plan, restart_count=restart_count,
                                 tracer=tracer, registry=registry,
                                 process_index=proc)
        log.info(f"Fault plan {plan.digest}: {len(plan.faults)} fault(s), "
                 f"{injector.armed_count} armed"
                 + (f" (restart {restart_count})" if restart_count else "")
                 + ".")
    # The data-size FedAvg weights a dropout or an exclusion zeroes (fedtpu
    # weighs by mask.sum(axis=1) in its graph); uniform weights stay ones.
    fault_weights = (exp.client_weights if cfg.fed.weighting == "data_size"
                     and not engine_async else None)

    heartbeat = (heartbeat_path_for(cfg.run.heartbeat_file, proc)
                 if cfg.run.heartbeat_file else None)

    # The collective watchdog (a gang with collective_timeout): armed only
    # around the blocking windows (a chunk's rounds with their exchanges,
    # its gathered metrics, a collective save, the resume agreement, a
    # broadcast of the global); a window open past the timeout becomes a
    # collective_hang event and exit 75 (fedtpu_torch.resilience.
    # distributed).
    watchdog = None
    if gang is not None and cfg.run.collective_timeout:
        from fedtpu_torch.resilience.distributed import CollectiveWatchdog
        watchdog = CollectiveWatchdog(
            cfg.run.collective_timeout, events_path=tel.events_path,
            process_index=proc, heartbeat=heartbeat,
            restart_count=restart_count).start()

    # The live elastic reshard's protocol (fedtpu_torch.resilience.reshard):
    # the plan's notices, SIGUSR1 / SIGUSR2 and the records of a gang.
    from fedtpu_torch.resilience.distributed import ENV_LAUNCH_ID
    from fedtpu_torch.resilience.reshard import ReshardController
    reshard_ctl = ReshardController(
        plan=injector.plan if injector is not None else None,
        process_index=proc,
        process_count=1 if gang is None else gang.process_count,
        launch_id=os.environ.get(ENV_LAUNCH_ID) or None,
        restart_count=restart_count, checkpoint_dir=ckpt_dir or None,
        ack_timeout=cfg.run.collective_timeout or 60.0, tracer=tracer,
        registry=registry, heartbeat=cfg.run.heartbeat_file or None)
    reshard_ctl.install_signal_handlers()
    # The builds a shrink replaced, newest last, for the grow back.
    reshard_stack: List[dict] = []

    def guard(phase: str, rnd: Optional[int] = None):
        if watchdog is None:
            return contextlib.nullcontext()
        return watchdog.guard(phase, rnd)

    def beat(status: str, rnd: int) -> None:
        """The liveness heartbeat (an atomic host-side rewrite): the
        supervisor's --hang-timeout reads its mtime."""
        if heartbeat:
            write_heartbeat(heartbeat, status=status, round=rnd,
                            restarts=restart_count)

    beat("starting", 0)
    if gang is not None:
        log.info(f"Training gang: {gang.process_count} processes, the "
                 f"{gang.backend} backend, process 0 on {dev}.")
    if tel.manifest:
        tracer.event("manifest", **build_manifest(
            cfg=cfg, mesh=exp.mesh, device=dev, gang=gang, extra={
                "program": "run",
                "engine": "async" if engine_async else "sync1d",
                "restarts": restart_count,
                **({"fault_plan": injector.plan.digest}
                   if injector is not None else {}),
                "profile": profile_entry(
                    exp.model, state, batch, num_classes,
                    cfg.fed.local_steps, cfg.run.profile_rounds)}))
    # The logical exchange a round: every client ships one model and
    # receives the average (int8 quarters it), an estimate as fedtpu's.
    registry.gauge("exchange_bytes_per_round_est").set(
        exp.model.param_count * state["params"].element_size()
        * num_clients // (4 if cfg.fed.compress == "int8" else 1))

    start_round = 0
    restored_history = None
    restored_meta = None
    if (not resume and ckpt_dir and cfg.run.checkpoint_every
            and complete_steps(ckpt_dir)):
        # A fresh run here would let a later resume restore the stale
        # higher round over its work, and retention would delete its
        # rounds as the older ones.
        raise ValueError(
            f"checkpoint dir {ckpt_dir!r} already holds round checkpoints "
            f"(latest: {complete_steps(ckpt_dir)[-1]}). Pass resume=True "
            "(--resume) to continue that run, or point checkpoint_dir at a "
            "clean directory.")
    agreed_step = None
    if resume and ckpt_dir and gang is not None:
        agreed_step = agree_resume(ckpt_dir, gang, restart_count, guard, log)
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None and (
            gang is None or agreed_step is not None):
        meta = load_meta(ckpt_dir, step=agreed_step)
        # The engine first, from the meta alone, as fedtpu does.
        saved_async = meta.get("engine_async")
        if saved_async is not None and bool(saved_async) != engine_async:
            raise ValueError(
                "resume engine mismatch: the checkpoint was written by the "
                f"{'async' if saved_async else 'synchronous'} engine but "
                "the current config selects the other; resume with the "
                "matching engine, or warm-start a fresh run from exported "
                "weights")
        saved_c = int(meta["num_clients"])
        part = None if gang is None else (proc, gang.process_count)
        if saved_c == num_clients:
            # Each member's own rows, whatever gang size (or one process)
            # wrote the round: the parts covering them, bit for bit.
            raw, restored_history, start_round = load_checkpoint_fallback(
                ckpt_dir, max_step=agreed_step, part=part)
            if engine_async and ("global" in state) != ("global" in raw):
                # A gang's asynchronous state carries the global; one
                # process's derives it: the freshest anchor of the round.
                if "global" in state:
                    raw["global"] = async_global_params(load_checkpoint_raw(
                        ckpt_dir, step=start_round)[0])
                else:
                    del raw["global"]
            state = _restore_state(raw, state, dev)
            log.info(f"Resumed from checkpoint at round {start_round}.")
            # The ledger's curve comes from the round actually restored.
            restored_meta = load_meta(ckpt_dir, step=start_round)
        else:
            # Elastic resume: a periodic checkpoint holds a post-average
            # state, every slot the global model; its mean over the slots
            # goes into every slot of the new count (a gang member's
            # slots), and each client starts fresh optimizer state
            # (moments cannot be re-shaped across counts). The server
            # optimizer's state and the adaptive clip do not depend on the
            # count and carry over; the per-client control variates restart
            # at zero, like the moments.
            raw, restored_history, start_round = load_checkpoint_raw(
                ckpt_dir, step=agreed_step)
            restored_meta = load_meta(ckpt_dir, step=start_round)
            if engine_async != ("anchors" in raw):
                raise ValueError(
                    "elastic resume engine mismatch: the checkpoint was "
                    f"written by the "
                    f"{'async' if 'anchors' in raw else 'synchronous'} "
                    "engine but the current config selects the other; "
                    f"resume with the matching engine (and client count "
                    f"{saved_c}), or warm-start a fresh run from exported "
                    "weights")
            dtype = state["params"].dtype
            slots_n = state["params"].shape[0]
            if engine_async:
                # A restart is every client re-pulling the current global,
                # the freshest anchor (the slots hold distinct local
                # models): params = anchors = it, pull ticks at the resume
                # tick, fresh optimizer state, and the pending K-buffer
                # dropped (its deltas reference a cohort that is gone).
                g = async_global_params(raw).to(device=dev, dtype=dtype)
                slots = g.expand(slots_n, -1).contiguous()
                state = {**state, "params": slots.clone(), "anchors": slots,
                         "pull_tick": torch.full(
                             (slots_n,), start_round, dtype=torch.int32,
                             device=dev),
                         "round": start_round}
                if "global" in state:
                    state["global"] = g.clone()
                dropped = float(raw.get("buf_count", 0.0))
                buf_note = (f", {int(dropped)} pending buffered updates "
                            "dropped" if dropped > 0 else "")
                log.info(f"Async elastic resume at tick {start_round}: "
                         f"{saved_c} -> {num_clients} clients (freshest-"
                         "anchor global carried over, every client "
                         f"re-pulled, fresh optimizer state{buf_note}).")
            else:
                g = raw["params"].to(torch.float32).numpy().mean(axis=0)
                params = torch.from_numpy(np.ascontiguousarray(
                    np.broadcast_to(g, (slots_n, g.shape[0])))).to(
                        device=dev, dtype=dtype)
                state = {**state, "params": params,
                         "opt_state": exp.tx.init(params),
                         "round": start_round}
                for key in ("server_opt_state", "dp_clip"):
                    if key in raw and key in state:
                        state[key] = _to_device(raw[key], dev)
                cv_note = (", control variates reset to zero"
                           if "client_cv" in state else "")
                log.info(f"Elastic resume at round {start_round}: "
                         f"{saved_num_clients(raw)} -> {num_clients} "
                         "clients (global model carried over, fresh client "
                         f"optimizer state{cv_note}).")
        if gang is not None:
            # The agreement bounds the step; the restore is each member's
            # own, and a member whose agreed round failed to load walked
            # back: refuse to train desynced.
            with guard("resume_verify"):
                rounds = gang.all_gather(torch.tensor([start_round]))
            if int(rounds.min()) != int(rounds.max()):
                raise RuntimeError(
                    "post-restore desync: the gang restored different "
                    f"rounds {rounds.flatten().tolist()} (agreed step: "
                    f"{agreed_step}); refusing to train desynced")
    if restored_history is not None:
        # A gang member stamps its wall clock: the chaos rows time a gang
        # restart from the supervisor's relaunch to it.
        tracer.event("resume", round=start_round,
                     **({"wall": time.time()} if gang is not None else {}))

    # The DP RDP bookkeeping (fedtpu_torch.orchestration.privacy), written
    # into every checkpoint's meta whether or not DP is on, so a DP-off
    # resume carries the earlier segments' spend forward.
    ledger = PrivacyLedger(cfg.fed, start_round=start_round,
                           restored_meta=restored_meta)

    history = {k: [] for k in METRIC_NAMES}
    pooled_hist = {k: [] for k in METRIC_NAMES}
    per_client_hist = {k: [] for k in METRIC_NAMES}
    test_hist = {k: [] for k in METRIC_NAMES}
    losses: List[np.ndarray] = []
    confusion: List[np.ndarray] = []
    staleness: List[np.ndarray] = []
    sec_per_round: List[float] = []
    prev_metric = None
    termination_count = cfg.fed.termination_patience
    flags = {"stopped_early": False, "diverged": False}
    rounds_run = 0
    if restored_history is not None:
        for k in METRIC_NAMES:
            history[k] = list(restored_history.get(k, []))
        if history[METRIC_NAMES[0]]:
            prev_metric = [history[k][-1] for k in METRIC_NAMES]
        rounds_run = start_round

    # Retention protects the best client-mean-accuracy round this run (and,
    # on resume, the run before it) saved.
    best_saved = None
    if (cfg.run.keep_checkpoints > 0 and ckpt_dir
            and restored_history is not None):
        acc_hist = history["accuracy"]
        for s in complete_steps(ckpt_dir):
            if 0 < s <= len(acc_hist) and (best_saved is None
                                           or acc_hist[s - 1] > best_saved[0]):
                best_saved = (acc_hist[s - 1], s)

    def save(directory: str, step: int) -> None:
        # Collective in a gang: every member writes its part.
        with guard("checkpoint_save", step):
            save_checkpoint(directory, state, history, step,
                            extra_meta=ledger.checkpoint_meta(step),
                            gang=gang)

    def retain_after_save(step: int) -> None:
        nonlocal best_saved
        if cfg.run.keep_checkpoints <= 0:
            return
        acc = history["accuracy"][-1] if history["accuracy"] else -math.inf
        if best_saved is None or acc > best_saved[0]:
            best_saved = (acc, step)
        if io_proc:
            retain_checkpoints(ckpt_dir, cfg.run.keep_checkpoints,
                               protect=(best_saved[1],))

    def halt_diverged(reason: str, label_round: int) -> None:
        """Stop the run; with a checkpoint dir, save the current state
        (labelled with the round it holds) under ``diverged/``, where resume
        does not look."""
        log.warning(f"Non-finite {reason}; halting (diverged run).")
        tracer.event("diverged", round=label_round, reason=reason)
        if ckpt_dir:
            save(os.path.join(ckpt_dir, "diverged"), label_round)
        flags["stopped_early"] = flags["diverged"] = True

    # Divergence rollback (on_divergence='rollback'): the retry budget is
    # the run's, not an incident's, so a run that keeps diverging halts.
    rollback = {"attempts": 0, "resume_at": None}
    excluded: set = set()

    def try_rollback(reason: str, label_round: int, offenders=()) -> bool:
        """Restore the newest loadable checkpoint, truncate every history
        to it, optionally exclude the offending clients, and tell the loop
        to re-enter at the restored round. False (the caller halts) when
        the policy is off, the budget is spent or nothing restores. The
        first retry is a pure replay (round-keyed draws make it bitwise);
        from the second on the params are perturbed by rollback_perturb.
        The restored values go into the live state tensors, which the
        captured graphs read: nothing is re-captured."""
        nonlocal prev_metric, termination_count, rounds_run, mask_host
        if cfg.run.on_divergence != "rollback":
            return False
        if rollback["attempts"] >= cfg.run.rollback_retries:
            log.warning("Rollback budget exhausted "
                        f"({cfg.run.rollback_retries}); halting.")
            return False
        try:
            raw, hist2, j = load_checkpoint_fallback(ckpt_dir)
        except FileNotFoundError:
            return False
        rollback["attempts"] += 1
        _copy_state_into(state, _restore_state(raw, state, dev))
        # The divergent rounds were appended before the guard fired: the
        # client-mean history comes from the checkpoint, the others drop
        # the rounds past j they hold.
        drop = max(0, rounds_run - j)
        for k in METRIC_NAMES:
            history[k] = list(hist2.get(k, []))
            del pooled_hist[k][max(0, len(pooled_hist[k]) - drop):]
            del per_client_hist[k][max(0, len(per_client_hist[k]) - drop):]
        for lst in (losses, confusion, sec_per_round, staleness):
            del lst[max(0, len(lst) - drop):]
        if cfg.run.eval_test_every:
            edrop = sum(1 for rr in range(j + 1, rounds_run + 1)
                        if rr % cfg.run.eval_test_every == 0)
            for k in METRIC_NAMES:
                del test_hist[k][max(0, len(test_hist[k]) - edrop):]
        rounds_run = j
        prev_metric = ([history[k][-1] for k in METRIC_NAMES]
                       if history[METRIC_NAMES[0]] else None)
        termination_count = cfg.fed.termination_patience
        if cfg.run.rollback_exclude and offenders:
            fresh = sorted(set(offenders) - excluded)
            if fresh:
                excluded.update(fresh)
                from fedtpu_torch.resilience.faults import drop_clients
                drop_clients(batch["mask"], fresh, fault_weights)
                mask_host = batch["mask"].cpu().clone()
                if injector is not None:
                    # A departed client cannot re-inject: a sticky NaN
                    # source would otherwise defeat the retry.
                    injector.exclude(fresh)
                tracer.event("exclusion", round=j, clients=list(fresh))
                registry.counter("clients_excluded").inc(len(fresh))
                log.warning(f"Excluding diverging client(s) {fresh} from "
                            "aggregation (mask weight 0) for the retry.")
        if rollback["attempts"] >= 2 and cfg.run.rollback_perturb > 0:
            from fedtpu_torch.resilience.faults import perturb_params
            perturb_params(state["params"], rollback["attempts"],
                           cfg.run.rollback_perturb)
        tracer.event("rollback", round=label_round, restored_round=j,
                     attempt=rollback["attempts"], reason=reason,
                     excluded=sorted(excluded))
        registry.counter("rollbacks").inc()
        log.warning(f"Non-finite {reason}; rolled back to round {j} "
                    f"(attempt {rollback['attempts']}/"
                    f"{cfg.run.rollback_retries}).")
        lap[0] = time.perf_counter()    # the restore is not a round's time
        rollback["resume_at"] = j
        return True

    if (cfg.run.on_divergence == "rollback"
            and not complete_steps(ckpt_dir)):
        # A divergence before the first periodic save still needs a
        # restore point: the initial (or resumed) state as round
        # start_round.
        save(ckpt_dir, start_round)

    chunk = cfg.run.rounds_per_step
    steps: Dict[int, Callable] = {}
    graphs: Dict[int, Callable] = {}
    warmup_rounds = 0

    def get_step(width: int):
        if width not in steps:
            steps[width] = exp.make_step(width)
        return steps[width]

    def step_tables():
        """Client sampling, and the asynchronous engine's arrivals: every
        round's on the device up front, so a chunk's are a device-to-device
        copy (into the graph's buffer); and the DP noise's draw. Drawn
        again for a reshard's rebuild."""
        draw = (get_step(chunk).draw_arrivals if engine_async
                else get_step(chunk).draw_masks)
        return ((draw(0, cfg.fed.rounds).to(dev)
                 if draw is not None and cfg.fed.rounds > 0 else None),
                None if engine_async else get_step(chunk).draw_noise)

    mask_table, draw_noise = step_tables()
    # So is a chunk's first tick.
    tick_table = (torch.arange(cfg.fed.rounds + 1, dtype=torch.int32,
                               device=dev) if engine_async else None)
    noise_ahead: Dict[tuple, torch.Tensor] = {}

    def chunk_noise(rnd: int, take: int) -> Optional[torch.Tensor]:
        """The chunk's DP noise, drawn on the host (a pure function of the
        seed and the rounds) and sent to the device from pinned memory;
        drawn ahead, while the previous chunk runs, where it can be."""
        if draw_noise is None:
            return None
        if (rnd, take) in noise_ahead:
            return noise_ahead.pop((rnd, take))
        host = draw_noise(rnd, take)
        if dev.type == "cuda":
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    def draw_ahead(rnd: int) -> None:
        noise_ahead.clear()
        if draw_noise is not None and rnd < cfg.fed.rounds:
            take = min(chunk, cfg.fed.rounds - rnd)
            noise_ahead[(rnd, take)] = chunk_noise(rnd, take)

    def dispatch(rnd: int, take: int, chunk_mask: torch.Tensor) -> _Fetch:
        nonlocal state, warmup_rounds
        masks = None if mask_table is None else mask_table[rnd:rnd + take]
        # The round step's inputs (masks, DP noise), or the tick's
        # (arrivals, the chunk's first tick).
        inputs = ((masks, tick_table[rnd]) if engine_async
                  else (masks, chunk_noise(rnd, take)))
        if graphs_on:
            if take not in graphs:
                if not graphs:
                    warm_up_round(get_step(1), state, batch)
                    warmup_rounds = 1
                capture = (capture_round_step if gang is None
                           else capture_gang_step)
                graphs[take] = capture(get_step(take), state, batch)
            out = graphs[take](*inputs)
            state["round"] = rnd + take
        else:
            state, raw = get_step(take).fn(state, batch, *inputs)
            out = pack_outputs(raw, *get_step(take).outputs)
        fetch = _Fetch(out)
        # The host mask of the chunk's rounds (a dropout round's own).
        fetch.mask = chunk_mask
        draw_ahead(rnd + take)
        return fetch

    jsonl = (open(cfg.run.metrics_jsonl, "a")
             if cfg.run.metrics_jsonl and io_proc else None)
    lap = [time.perf_counter()]
    # The profile window (profile_rounds K > 0) opens after the first
    # chunk's read, so the graphs' warm-up and capture stay out of it, and
    # closes at the first chunk boundary covering >= K rounds; K = 0 traces
    # the whole run.
    prof = _ProfileWindow(cfg.run.profile_dir, cfg.run.profile_rounds, dev,
                          tracer, start_round)

    def process_chunk(rnd0: int, take: int, fetched: _Fetch,
                      state_round: int) -> None:
        """History, logs, JSONL, the metric divergence guard and early
        stopping of one chunk, from its one host buffer. ``state_round``:
        the round the current ``state`` holds (one chunk further on when
        pipelined), the label of an emergency checkpoint."""
        nonlocal prev_metric, termination_count, rounds_run
        if gang is None:
            raw = unpack_outputs(fetched.get(), take, num_clients,
                                 num_classes, *get_step(take).outputs)
        else:
            # The gang's metrics: every member's clients, gathered (the
            # chunk's one host collective), with the members' SIGTERM flags
            # so that they all drain at the same round.
            with guard("chunk_fetch", rnd0 + take):
                raw, preempt["agreed"] = gather_chunk(
                    gang, fetched.get(), take, exp.mesh.local_clients,
                    num_classes, get_step(take).outputs,
                    preempt["sig"] is not None)
            fetched.agreed = raw["finite"]
        # s/round is fedtpu's lap (its ``timer.lap()`` at the chunk fetch):
        # the time from one chunk's read to the next over the chunk's
        # rounds, so the host work between them (history, logs, held-out
        # eval, checkpoints, a capture) counts too.
        now = time.perf_counter()
        dt = (now - lap[0]) / take
        lap[0] = now
        # The chunk span closes here, after the chunk's host read.
        tracer.event("span", phase="chunk", round=rnd0 + take,
                     dur_s=dt * take, rounds=take)
        prof.at_chunk_end(rnd0 + take)
        # The host's decision window (history, logs, early stop); ended at
        # every exit below (Span.end is idempotent).
        sp_stop = tracer.span("stop_check", round=rnd0 + take)
        loss_c, conf_c = raw["loss"], raw["conf"]
        m_all = assemble_metrics(loss_c, conf_c, fetched.mask)
        for j in range(take):
            r = rnd0 + j
            client_mean = {k: float(m_all["client_mean"][k][j])
                           for k in METRIC_NAMES}
            per_client = {k: m_all["per_client"][k][j].numpy()
                          for k in METRIC_NAMES}
            losses.append(loss_c[j].numpy())
            confusion.append(conf_c[j].numpy())
            if engine_async:
                staleness.append(raw["staleness"][j].numpy())
            sec_per_round.append(dt)
            rounds_run = r + 1
            for k in METRIC_NAMES:
                history[k].append(client_mean[k])
                pooled_hist[k].append(float(m_all["pooled"][k][j]))
                per_client_hist[k].append(per_client[k])
            loss_mean = float(np.mean(losses[-1]))
            registry.counter("rounds").inc()
            tracer.event("round", round=r + 1, dur_s=dt,
                         accuracy=client_mean["accuracy"],
                         loss_mean=loss_mean,
                         **({"staleness_mean": float(staleness[-1].mean()),
                             "staleness_max": float(staleness[-1].max())}
                            if engine_async else {}))
            if engine_async:
                record_tick_telemetry(registry, tracer, r + 1,
                                      staleness[-1])
            if jsonl is not None:
                jsonl.write(json.dumps({
                    "round": r + 1, "sec_per_round": dt,
                    "client_mean": client_mean,
                    "pooled": {k: pooled_hist[k][-1] for k in METRIC_NAMES},
                    "loss_mean": loss_mean,
                    **({"staleness_mean": float(staleness[-1].mean())}
                       if engine_async else {})}) + "\n")
                jsonl.flush()

            if verbose and r % cfg.run.log_every == 0:
                log.parity(f"\nRound {r + 1}:\n")
                if cfg.run.log_per_client:
                    for c in range(num_clients):
                        vals = ", ".join(f"{k}: {per_client[k][c]:.4f}"
                                         for k in METRIC_NAMES)
                        log.parity(f"  CLIENT {c} - Local Metrics "
                                   f"(Round {r + 1}): [{vals}]")
                gvals = ", ".join(f"{k}: {client_mean[k]:.4f}"
                                  for k in METRIC_NAMES)
                stale_note = (f"  (mean staleness {staleness[-1].mean():.2f})"
                              if engine_async else "")
                log.parity(f"  Global Metrics (Round {r + 1}): [{gvals}]  "
                           f"({dt * 1e3:.1f} ms/round){stale_note}")

            cur = [client_mean[k] for k in METRIC_NAMES]
            if cfg.run.halt_on_nonfinite and not (
                    np.all(np.isfinite(cur))
                    and np.all(np.isfinite(losses[-1]))):
                # The rollback policy first (restores, truncates, sets
                # resume_at); the run halts only when it declines.
                bad = ~np.isfinite(losses[-1])
                for k in METRIC_NAMES:
                    bad = bad | ~np.isfinite(per_client[k])
                offenders = tuple(int(c) for c in np.nonzero(bad)[0])
                if not try_rollback(f"loss/metrics at round {r + 1}", r + 1,
                                    offenders=offenders):
                    halt_diverged(f"loss/metrics at round {r + 1}",
                                  state_round)
                sp_stop.end()
                return

            # Early stopping — exact reference logic (FL_CustomMLP...:181-192).
            if prev_metric is not None and np.allclose(
                    cur, prev_metric, atol=cfg.fed.tolerance):
                termination_count -= 1
                if termination_count == 0:
                    log.parity("Early stopping triggered: No significant "
                               "change in metrics for "
                               f"{cfg.fed.termination_patience} rounds.")
                    if r + 1 < cfg.fed.rounds:
                        log.parity(f"Training stopped early at round "
                                   f"{r + 1}.")
                    tracer.event("early_stop", round=r + 1)
                    flags["stopped_early"] = True
                    sp_stop.end()
                    return
            else:
                prev_metric = cur
                termination_count = cfg.fed.termination_patience
        sp_stop.end()

    # ---- The live elastic reshard (fedtpu's loop :1563-1845) ----------
    def join_fn(join_map: dict, tick_round: int):
        """A join row's values (``reshard_state``'s ``join_rows``): the
        live global model for params and anchors, the current round for
        ``pull_tick``, zeros (fresh moments and variates) for the rest,
        as an elastic resume's joiner starts."""
        def rows(path, count, row_shape, dtype):
            if path in join_map:
                return torch.as_tensor(join_map[path]).to(dtype).expand(
                    (count,) + row_shape)
            if path == "pull_tick":
                return torch.full((count,) + row_shape, tick_round,
                                  dtype=dtype)
            return torch.zeros((count,) + row_shape, dtype=dtype)
        return rows

    def to_host(t: torch.Tensor) -> np.ndarray:
        """A spooled tensor: numpy, 16-bit floats as float32 (exact)."""
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()

    def match_layout(moved: dict, like: dict, glob) -> dict:
        """``moved`` held to the target build's layout: the asynchronous
        gang state's ``global`` (which one process derives from the
        freshest anchor) added as ``glob``, the live global (None: the
        moved state's freshest anchor), or dropped; any other difference
        raises ReshardFailed."""
        from fedtpu_torch.resilience.reshard import ReshardFailed
        if "global" in like and "global" not in moved:
            moved["global"] = (glob if glob is not None
                               else async_global_params(moved)).clone()
        elif "global" in moved and "global" not in like:
            del moved["global"]
        if _state_layout(moved) != _state_layout(like):
            raise ReshardFailed(
                f"the moved state {_state_layout(moved)} does not fit the "
                f"rebuilt round's {_state_layout(like)}")
        return moved

    def reshard_done(mode: str, rnd: int, steps_done, waits: dict,
                     **payload) -> None:
        reshard_ctl.event("reshard_done", rnd, mode=mode,
                          steps=[x.to_json() for x in steps_done],
                          barrier_s=waits, **payload)
        beat("running", rnd)
        # The reshard is not a round's time.
        lap[0] = time.perf_counter()

    def do_reshard(req, rnd: int) -> int:
        """Run one agreed reshard at loop-top ``rnd`` and return the round
        to go on from (the parked victim's: the grow round). A shrink moves
        the state with the wire-free plan, rebuilds the experiment for the
        kept shards and keeps the original build on ``reshard_stack``; a
        grow moves the state back into the original graphs' static state
        tensors and replays them. A participant that dies mid-protocol
        times the barrier out: ReshardFailed, the gang-restart path."""
        nonlocal state, batch, exp, gang, exchange, cfg, num_clients
        nonlocal mask_host, steps, graphs, mask_table, draw_noise
        nonlocal fault_weights, prev_metric, termination_count
        from fedtpu_torch.parallel.mesh import submesh
        from fedtpu_torch.parallel.reshard import (grow_row_map,
                                                   reshard_state,
                                                   shrink_row_map)
        from fedtpu_torch.resilience.reshard import ReshardFailed
        ctl = reshard_ctl
        seq = ctl.seq
        waits: dict = {}

        def acks(phase: str, participants) -> None:
            ctl.publish_ack(seq, phase, rnd)
            t0 = time.perf_counter()
            ctl.await_acks(seq, phase, participants)
            waits[phase] = time.perf_counter() - t0

        try:
            if req.mode == "shrink":
                mesh, cps = exp.mesh, exp.mesh.clients_per_shard
                target = req.target_clients
                survivors = (proc,)
                if gang is not None:
                    if ctl.parked_victim is not None:
                        log.warning("Ignoring shrink notice: a member is "
                                    "parked already (one reshard of a gang "
                                    "at a time).")
                        return rnd
                    survivors = tuple(p for p in ctl.active
                                      if p != req.victim)
                    kept = len(survivors) * mesh.local_shards
                    target = target or cps * kept
                    if (target != cps * kept or not survivors
                            or req.victim not in ctl.active):
                        raise ReshardFailed(
                            f"shrink target {target} does not match the "
                            f"surviving shards ({kept} shards x {cps} "
                            "clients/shard)")
                elif not target:
                    log.warning("Ignoring shrink notice: a single-process "
                                "signal shrink needs a fault-plan "
                                "target_clients.")
                    return rnd
                elif target % cps:
                    # A shard stands for one of fedtpu's devices: one
                    # process keeps whole shards, the first target / cps.
                    raise ReshardFailed(
                        f"shrink target {target} is not a whole number of "
                        f"shards ({mesh.num_shards} shards x {cps} "
                        "clients/shard; raise mesh_devices)")
                ctl.event("reshard_begin", rnd, mode="shrink",
                          victim=req.victim, target=target,
                          notices=[list(n) for n in req.notices])
                beat("resharding", rnd)
                ctl.maybe_crash()
                # Phase A: every member is at this loop-top with no
                # collective in flight. A victim that died first fails it,
                # before the group below is made.
                acks("a", ctl.active)
                new_gang = None
                if gang is not None:
                    # Every process of the world, in the same order.
                    new_gang = multihost.split(gang, survivors)
                    if proc == req.victim:
                        ctl.committed("shrink", req.victim)
                        log.info(f"Preempted member parking at round {rnd} "
                                 "(state handed off; will rejoin on "
                                 "grow).")
                        return victim_grow(ctl.park(seq, rnd))
                try:
                    dst_mesh, kept_shards = submesh(
                        mesh, process_indices=(survivors if gang is not None
                                               else None),
                        num_shards=target // cps, num_clients=target)
                except ValueError as e:
                    raise ReshardFailed(str(e)) from e
                rows = [r for sh in kept_shards
                        for r in range(sh * cps, (sh + 1) * cps)]
                if rows != list(range(rows[0], rows[0] + target)):
                    raise ReshardFailed(
                        f"surviving client rows {rows} are not one "
                        f"contiguous block of {target}; a shard is the "
                        "unit of a reshard (mesh_devices), and the "
                        "wire-free plan cannot renumber them")
                block_start = rows[0]
                with tracer.span("reshard_move", round=rnd):
                    try:
                        moved, done = reshard_state(
                            state,
                            src_rows=multihost.local_client_slice(mesh),
                            dst_rows=multihost.local_client_slice(dst_mesh),
                            row_map=shrink_row_map(block_start, target))
                    except ValueError as e:
                        raise ReshardFailed(str(e)) from e
                # The survivors' data through the partition view: sharded
                # as the original population, their window kept, each
                # kept client's packed rows bitwise its rows before.
                whole = cfg.shard.partition_clients or num_clients
                cfg2 = dataclasses.replace(cfg, shard=dataclasses.replace(
                    cfg.shard, num_clients=target, partition_clients=whole,
                    partition_offset=(cfg.shard.partition_offset
                                      + block_start)))
                reshard_stack.append({
                    "cfg": cfg, "exp": exp, "gang": gang,
                    "exchange": exchange, "state": state, "batch": batch,
                    "steps": steps, "graphs": graphs,
                    "mask_table": mask_table, "draw_noise": draw_noise,
                    "mask_host": mask_host, "num_clients": num_clients,
                    "fault_weights": fault_weights,
                    "block_start": block_start})
                with tracer.span("reshard_build", round=rnd):
                    exp2 = build_experiment(cfg2, exp.dataset, device=dev,
                                            mesh=dst_mesh, gang=new_gang)
                src_c = num_clients
                state = match_layout(moved, exp2.state, None)
                cfg, exp, gang, exchange = cfg2, exp2, new_gang, exp2.exchange
                batch, num_clients = exp2.batch, target
                steps, graphs = {}, {}
                mask_table, draw_noise = step_tables()
                noise_ahead.clear()
                mask_host = multihost.gather_rows(
                    gang, batch["mask"]).cpu().clone()
                fault_weights = (exp.client_weights
                                 if cfg.fed.weighting == "data_size"
                                 and not engine_async else None)
                # Phase B: every survivor holds the moved state; only then
                # does anyone run a round of the shrunk gang.
                acks("b", survivors)
                ctl.committed("shrink", req.victim)
                if history[METRIC_NAMES[0]]:
                    prev_metric = [history[k][-1] for k in METRIC_NAMES]
                termination_count = cfg.fed.termination_patience
                reshard_done("shrink", rnd, done, waits, target=target,
                             block_start=block_start)
                log.info(f"Elastic shrink at round {rnd}: {src_c} -> "
                         f"{target} clients (block offset {block_start}), "
                         "no restart.")
                return rnd

            # ---- grow -------------------------------------------------
            if not reshard_stack:
                log.warning("Ignoring grow notice: nothing shrunk.")
                return rnd
            st = reshard_stack[-1]
            orig_c, src_c = st["num_clients"], num_clients
            ctl.event("reshard_begin", rnd, mode="grow", victim=req.victim,
                      target=orig_c, notices=[list(n) for n in req.notices])
            beat("resharding", rnd)
            ctl.maybe_crash()
            glob = exp.global_fn(state)
            join_map = {k: glob for k in ("params", "anchors") if k in state}
            multi = st["gang"] is not None
            if multi and proc == min(ctl.active):
                # The leader spools what the rejoiner needs BEFORE the
                # grow record its park loop polls: the record's
                # visibility implies the spool's completeness.
                repl = {".".join(path): to_host(t) for path, t, pc in
                        _per_client_slots(state, exp.mesh.local_clients)
                        if not pc}
                if "global" in st["state"] and "global" not in repl:
                    repl["global"] = to_host(glob)
                ctl.write_spool(ctl.seq, {k: to_host(v) for k, v in
                                          join_map.items()}, repl, {
                    "round": rnd,
                    "history": {k: [float(v) for v in history[k]]
                                for k in METRIC_NAMES},
                    "prev_metric": prev_metric,
                    "termination_count": termination_count,
                    "ledger": {k: np.asarray(v).tolist() for k, v in
                               ledger.checkpoint_meta(rnd).items()}})
                ctl.publish_grow(ctl.seq, rnd, {
                    "src_clients": src_c, "block_start": st["block_start"]})
            participants = (tuple(sorted(set(ctl.active) | {req.victim}))
                            if multi and req.victim >= 0 else ctl.active)
            acks("a", participants)
            with tracer.span("reshard_move", round=rnd):
                grown, done = reshard_state(
                    state, src_rows=multihost.local_client_slice(exp.mesh),
                    dst_rows=multihost.local_client_slice(st["exp"].mesh),
                    row_map=grow_row_map(src_c, orig_c, st["block_start"]),
                    join_rows=join_fn(join_map, rnd))
            grown = match_layout(grown, st["state"], glob)
            acks("b", participants)
            if exchange is not None:
                # The survivors' exchange (their own IPC buffers, their
                # group's barrier); the original one comes back.
                exchange.close()
            reshard_stack.pop()
            cfg, exp, gang, exchange = (st["cfg"], st["exp"], st["gang"],
                                        st["exchange"])
            batch, num_clients = st["batch"], st["num_clients"]
            steps, graphs = st["steps"], st["graphs"]
            mask_table, draw_noise = st["mask_table"], st["draw_noise"]
            mask_host, fault_weights = st["mask_host"], st["fault_weights"]
            noise_ahead.clear()
            # Into the original graphs' static state tensors, in place:
            # their replays go on, nothing is captured again.
            _copy_state_into(st["state"], grown)
            state = st["state"]
            ctl.committed("grow", req.victim if multi else -1)
            if history[METRIC_NAMES[0]]:
                prev_metric = [history[k][-1] for k in METRIC_NAMES]
            termination_count = cfg.fed.termination_patience
            reshard_done("grow", rnd, done, waits, target=orig_c)
            log.info(f"Elastic grow at round {rnd}: {src_c} -> {orig_c} "
                     "clients, no restart, no recompile.")
            return rnd
        except ReshardFailed as e:
            ctl.event("reshard_failed", rnd, error=str(e))
            beat("reshard_failed", rnd)
            log.warning(f"Elastic reshard failed ({e}); degrading to the "
                        "gang-restart contract.")
            raise

    def victim_grow(rec: dict) -> int:
        """The parked member's rejoin: its rows of the grown state from
        the leader's spool (join rows and replicated values over its parked
        state's structure), copied into its own graphs' static state
        tensors; the host state (history, early-stop comparator, DP
        ledger) from the spool's control blob; it goes on at the grow
        round, its graphs and exchange untouched."""
        nonlocal state, prev_metric, termination_count, rounds_run, ledger
        from fedtpu_torch.parallel.reshard import grow_row_map, reshard_state
        ctl = reshard_ctl
        seq = ctl.seq           # advanced past the shrink by committed()
        r_grow = int(rec["round"])
        join_map, repl, control = ctl.read_spool(seq)
        ctl.event("reshard_begin", r_grow, mode="grow_rejoin", victim=proc,
                  target=num_clients)
        beat("resharding", r_grow)
        participants = tuple(sorted(set(ctl.active) | {proc}))
        waits: dict = {}
        for phase in ("a", "b"):
            if phase == "b":
                mine = multihost.local_client_slice(exp.mesh)
                with tracer.span("reshard_move", round=r_grow):
                    grown, done = reshard_state(
                        state, src_rows=mine, dst_rows=mine,
                        row_map=grow_row_map(int(rec["src_clients"]),
                                             num_clients,
                                             int(rec["block_start"])),
                        join_rows=join_fn(join_map, r_grow),
                        replicated_values={k: torch.from_numpy(v)
                                           for k, v in repl.items()})
            ctl.publish_ack(seq, phase, r_grow)
            t0 = time.perf_counter()
            ctl.await_acks(seq, phase, participants)
            waits[phase] = time.perf_counter() - t0
        _copy_state_into(state, grown)
        ctl.committed("grow", proc)
        for k in METRIC_NAMES:
            if control.get("history", {}).get(k) is not None:
                history[k] = list(control["history"][k])
        # The survivors' rule after a grow (do_reshard), not the spooled
        # pre-grow comparator: the early stop must stay consensual.
        prev_metric = ([history[k][-1] for k in METRIC_NAMES]
                       if history[METRIC_NAMES[0]] else None)
        termination_count = cfg.fed.termination_patience
        if control.get("ledger"):
            ledger = PrivacyLedger(
                cfg.fed, start_round=r_grow,
                restored_meta={k: np.asarray(v) for k, v in
                               control["ledger"].items()})
        rounds_run = r_grow
        reshard_done("grow_rejoin", r_grow, done, waits)
        return r_grow

    ckpt_every = cfg.run.checkpoint_every
    # Pipelined stop: chunk k+1 is dispatched before chunk k's outputs are
    # read. The history is the synchronous run's; a stop leaves the state one
    # (dropped) chunk further on; the state's finiteness flag is acted on
    # only at checkpoint and held-out-eval boundaries and at the end.
    pipelined = cfg.run.pipelined_stop
    pending = None
    last: Optional[_Fetch] = None       # the newest dispatched chunk
    rnd = start_round
    # The preemption drain: SIGTERM sets a flag that the loop top turns
    # into a checkpoint and Preempted (exit 75); installed only with a
    # checkpoint dir to drain to, on the main thread, and restored when the
    # loop ends.
    preempt = {"sig": None, "agreed": False}
    prev_term = None
    if ckpt_dir and threading.current_thread() is threading.main_thread():
        def _on_term(signum, frame):
            preempt["sig"] = signum
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    try:
        while rnd < cfg.fed.rounds and not flags["stopped_early"]:
            if (preempt["sig"] is not None if gang is None
                    else preempt["agreed"]):
                # The graceful drain: read the chunk in flight, checkpoint
                # (not a poisoned state: it would resume straight back into
                # divergence) and exit through Preempted (exit 75; the
                # supervisor restarts with --resume).
                if pending is not None:
                    process_chunk(*pending, state_round=rnd)
                    pending = None
                if not flags["stopped_early"]:
                    if not (cfg.run.halt_on_nonfinite and last is not None
                            and not last.finite()):
                        with tracer.span("checkpoint", round=rnd):
                            save(ckpt_dir, rnd)
                            retain_after_save(rnd)
                    tracer.event("preempted", round=rnd)
                    registry.counter("preemptions").inc()
                    log.warning(f"SIGTERM: drained checkpoint at round "
                                f"{rnd}; exiting for resume (preempted).")
                    beat("preempted", rnd)
                    raise Preempted(rnd)
                break
            if reshard_ctl.pending:
                if not reshard_live or (gang is not None and not ckpt_dir):
                    # A config that cannot reshard live (a plan entry
                    # refused at start, so only a SIGNAL gets here):
                    # degrade the notice to the drain, checkpoint + exit 75
                    # + a gang restart at the new size.
                    reshard_ctl.clear_signal()
                    if ckpt_dir:
                        tracer.event("reshard_degraded", round=rnd)
                        registry.counter("reshard_degraded").inc()
                        log.warning("Preemption notice under a config that "
                                    "cannot live-reshard (rounds_per_step"
                                    ">1, pipelined_stop, or no checkpoint_"
                                    "dir); draining via the preempt path.")
                        preempt["sig"] = getattr(signal, "SIGUSR1", 10)
                        continue
                    log.warning("Ignoring preemption notice: no "
                                "checkpoint_dir to drain to and no "
                                "live-reshard support in this config.")
                else:
                    req = reshard_ctl.poll(rnd)
                    if req is not None:
                        rnd = do_reshard(req, rnd)
                        last = None
                        continue
            take = min(chunk, cfg.fed.rounds - rnd)
            chunk_mask = mask_host
            if injector is not None:
                # A fault round runs as its own width-1 dispatch, so that
                # pre_round and post_round bracket exactly that round.
                take = injector.chunk_limit(rnd, take)
                due = injector.pre_round(rnd, state, batch,
                                         checkpoint_dir=ckpt_dir,
                                         weights=fault_weights)
                dropout = any(f.kind == "client_dropout" for f in due)
                if dropout:
                    # The host reads the device mask the injector left:
                    # the round's own (one sync, on a width-1 round).
                    chunk_mask = batch["mask"].cpu().clone()
            with guard("round_dispatch", rnd):
                last = dispatch(rnd, take, chunk_mask)
            if injector is not None:
                # After the dispatch is queued (same stream): the pre-fault
                # mask goes back, so every later round is bitwise an
                # unfaulted run's.
                injector.post_round(rnd, batch, weights=fault_weights)
                if dropout:
                    # What post_round leaves holds for good (a sticky
                    # dropout that no non-sticky one undid).
                    mask_host = batch["mask"].cpu().clone()
            if pipelined:
                if pending is not None:
                    process_chunk(*pending, state_round=rnd + take)
                pending = (rnd, take, last)
            else:
                process_chunk(rnd, take, last, state_round=rnd + take)
            rnd += take
            if rollback["resume_at"] is not None:
                # A divergence rolled back: re-enter at the restored round
                # (state and histories already rewound; the restored state
                # is finite).
                rnd, rollback["resume_at"] = rollback["resume_at"], None
                last = None
                beat("running", rnd)
                continue
            beat("running", rnd)
            if flags["stopped_early"]:
                # The overshoot chunk (pending) is dropped: no checkpoint or
                # eval of it.
                pending = None
                break

            # Held-out eval and checkpoints at chunk ends, every due round
            # inside the chunk counted (they share the chunk-end state), as
            # in fedtpu.
            eval_due = cfg.run.eval_test_every and sum(
                1 for j in range(take)
                if (rnd - j) % cfg.run.eval_test_every == 0)
            ckpt_due = bool(ckpt_every and ckpt_dir and any(
                (rnd - j) % ckpt_every == 0 for j in range(take)))
            if pipelined and pending is not None and (eval_due or ckpt_due):
                process_chunk(*pending, state_round=rnd)
                pending = None
                if flags["stopped_early"]:
                    break
            # The chunk-end state check: metrics can stay finite for a
            # round after params go non-finite (the reported loss is
            # pre-update), so no checkpoint or eval takes a poisoned state.
            if cfg.run.halt_on_nonfinite and (
                    not pipelined or ckpt_due or eval_due) \
                    and not last.finite():
                # Offenders unknown here (the poison is in the state, not
                # a client's metric): rollback without exclusion.
                if try_rollback(
                        f"params/optimizer state after round {rnd}", rnd):
                    rnd, rollback["resume_at"] = rollback["resume_at"], None
                    last = None
                    beat("running", rnd)
                    continue
                halt_diverged(f"params/optimizer state after round {rnd}",
                              rnd)
                break
            if eval_due:
                sp = tracer.span("eval", round=rnd)
                with guard("eval_broadcast", rnd):
                    glob = exp.global_fn(state)
                tm = exp.eval_step(glob, x_test, y_test)
                # The span closes after this host read of the metrics.
                tm = torch.stack([tm[k] for k in METRIC_NAMES]).tolist()
                sp.end()
                registry.counter("held_out_evals").inc()
                for _ in range(eval_due):
                    for k, v in zip(METRIC_NAMES, tm):
                        test_hist[k].append(v)
            if ckpt_due:
                # Labelled with, and holding, the chunk-end round.
                with tracer.span("checkpoint", round=rnd):
                    save(ckpt_dir, rnd)
                    retain_after_save(rnd)

        if pending is not None and not flags["stopped_early"]:
            process_chunk(*pending, state_round=rnd)
        # The deferred state check: when pipelined, and after an early
        # stop (the stopped chunk's state, or the overshoot's, is checked
        # nowhere else).
        if (pipelined or flags["stopped_early"]) and not flags["diverged"] \
                and cfg.run.halt_on_nonfinite and last is not None \
                and not last.finite():
            halt_diverged(f"params/optimizer state after round {rnd}", rnd)
        # A member still parked leaves with EXIT_RESHARDED (76) rather than
        # wait for a grow that will not come. Only at a clean end: on a
        # crash the supervisor's teardown collects it.
        reshard_ctl.finish()
    finally:
        if watchdog is not None:
            # The epilogue (final params, the exchange's teardown) runs
            # unguarded: a healthy run reached it.
            watchdog.stop()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        # The trace is finalized and the counters snapshot written on a
        # failing run too: the sink exists to diagnose such runs.
        prof.close(rounds_run)
        if jsonl is not None:
            jsonl.close()
        device_memory_gauges(registry, dev)
        tracer.counters(registry.snapshot())

    personalized: Dict[str, dict] = {}
    if exp.personalize_fn is not None and not flags["diverged"]:
        # Each client fine-tunes the final global model on its own shard;
        # the personalized models are reported, not kept (final_params stay
        # the global model).
        _, pm = exp.personalize_fn(state["params"], batch)
        # Metric names sorted, as fedtpu's come out of its jit.
        personalized = {
            "per_client": {k: pm["per_client"][k].cpu().numpy()
                           for k in sorted(pm["per_client"])},
            "client_mean": {k: float(pm["client_mean"][k])
                            for k in sorted(pm["client_mean"])},
        }
        vals = ", ".join(f"{k}: {v:.4f}"
                         for k, v in personalized["client_mean"].items())
        log.info(f"Personalized ({cfg.fed.personalize_steps} local steps) "
                 f"client-mean: [{vals}]")

    rounds_trained = int(state["round"])
    final_params = params_to_numpy(exp.global_fn(state), exp.model)
    if exchange is not None:
        exchange.close()
    result = ExperimentResult(
        global_metrics=history, pooled_metrics=pooled_hist,
        per_client_metrics=per_client_hist, test_metrics=test_hist,
        loss=losses, sec_per_round=sec_per_round, rounds_run=rounds_run,
        stopped_early=flags["stopped_early"],
        final_params=final_params, config=cfg, diverged=flags["diverged"],
        confusion=confusion,
        rounds_trained=rounds_trained, warmup_rounds=warmup_rounds,
        graph_launches={w: dict(g.launches) for w, g in graphs.items()},
        dp_rdp_total=ledger.rdp_at(rounds_trained),
        dp_base_assumed=ledger.base_assumed,
        dp_guarantee_void=ledger.void_at(rounds_trained),
        dp_composed=ledger.composed,
        final_dp_clip=(float(state["dp_clip"]) if "dp_clip" in state
                       else None),
        personalized_metrics=personalized, staleness=staleness,
        rollbacks=rollback["attempts"])
    dp = result.privacy_spent()
    if dp:
        notes = ""
        if dp.get("composed_over_resumed_segments"):
            notes += ("; composed over resumed segments — sigma/q shown are "
                      "the current segment's")
        if dp.get("guarantee_void"):
            notes += f"; GUARANTEE VOID: {dp['guarantee_void']}"
        log.info(f"DP budget spent: epsilon={dp['epsilon']:.3f} at "
                 f"delta={dp['delta']:.1e} (noise multiplier "
                 f"{dp['noise_multiplier']}, sampling rate "
                 f"{dp['sampling_rate']}, {dp['rounds']} rounds; RDP order "
                 f"{dp['rdp_order']}{notes})")
    if (engine_async and cfg.fed.async_buffer_size >= 2
            and not flags["diverged"] and "buf_count" in state):
        # K-buffer starvation: a buffer that never filled never moved the
        # global; the run is sound, and the user must hear it.
        pending = int(state["buf_count"])
        if pending > 0:
            log.warning(
                f"ASYNC K-BUFFER STARVATION: {pending} buffered update(s) "
                f"never reached --buffer-size {cfg.fed.async_buffer_size} "
                "by the final tick, so the global model did not advance "
                "on them. Lower --buffer-size or raise --arrival-rate/"
                "--rounds; a resumed run carries the pending buffer "
                "forward.")
            tracer.event("async_starvation", round=rounds_run,
                         pending=pending,
                         buffer_size=cfg.fed.async_buffer_size)
    beat("diverged" if flags["diverged"] else "done", rounds_run)
    tracer.event("run_end", round=rounds_run,
                 stopped_early=flags["stopped_early"],
                 diverged=flags["diverged"], rounds_trained=rounds_trained,
                 restarts=restart_count, rollbacks=rollback["attempts"])
    tracer.close()
    return result
