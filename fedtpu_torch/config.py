"""Typed configuration for the PyTorch port's federated run.

The port's own copies of ``fedtpu.config``'s dataclasses that
``ExperimentConfig`` holds (data, shard, model, optimizer, federation, run,
and the run's telemetry), and ``ServingConfig``, the ``serve`` front
end's. Every field of ``fedtpu``'s is a field here, with
``fedtpu``'s name and default, so one config reads the same on both sides.
A knob that this port does not run yet stays at its neutral default; any
other value raises ``NotImplementedError`` naming the ROADMAP item that will
port it, instead of being silently ignored.

All config dataclasses are frozen (hashable), as in ``fedtpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


AGGREGATIONS = ("psum", "ring", "ring-rsag")


def _not_ported(knob: str, item: str):
    raise NotImplementedError(
        f"{knob} is not ported to fedtpu_torch yet (ROADMAP {item}); "
        "run it with fedtpu")


def _refuse_unported(cfg, items: dict) -> None:
    """Raise for the first field named in ``items`` (field -> ROADMAP
    item) whose value is not its default."""
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if f.name in items and value != f.default:
            _not_ported(f"{type(cfg).__name__}.{f.name}={value!r}",
                        items[f.name])


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline settings (``fedtpu.config.DataConfig``)."""

    csv_path: Optional[str] = None       # None => synthetic income-like data
    # 'cifar10' selects the image loader (fedtpu_torch.data.cifar10); None =
    # tabular (fedtpu_torch.data.load_dataset).
    dataset_name: Optional[str] = None
    label_column: str = "income"
    test_size: float = 0.2
    split_seed: int = 42                 # random_state=42 everywhere in the reference
    scale_with_mean: bool = True
    # fedtpu's C++ CSV loader (True) or pandas (False), which fedtpu pins to
    # identical output; the port's one loader equals both, so either value
    # takes it.
    native_loader: bool = True
    # The reference fits its scaler on the FULL dataset before splitting —
    # train/test leakage kept as the parity default, as in fedtpu.
    scaler_leakage_parity: bool = True
    synthetic_rows: int = 2048
    synthetic_features: int = 14         # balanced_income_data.csv has 14 features + label
    synthetic_classes: int = 2


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """How the train set is carved into per-client shards
    (``fedtpu.config.ShardConfig``)."""

    num_clients: int = 8
    shuffle: bool = True
    shard_seed: int = 0
    unseeded_per_client_bug: bool = False
    strategy: str = "contiguous"         # 'contiguous' | 'label_sort' | 'dirichlet'
    dirichlet_alpha: float = 0.5
    # fedtpu's partition view for elastic-reshard runs; 0 = off.
    partition_clients: int = 0
    partition_offset: int = 0

    def __post_init__(self):
        _refuse_unported(self, {"partition_clients": "A10",
                                "partition_offset": "A10"})


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model family and shape (``fedtpu.config.ModelConfig``): the
    reference MLP, or the CIFAR-10 ConvNet (fedtpu_torch.models.registry)."""

    kind: str = "mlp"                    # 'mlp' | 'convnet'
    # () degenerates the MLP to a single Linear (logistic regression).
    hidden_sizes: Tuple[int, ...] = (50, 200)
    num_classes: int = 2
    input_dim: int = 14
    image_shape: Tuple[int, int, int] = (32, 32, 3)  # convnet only (HWC)
    conv_channels: Tuple[int, ...] = (32, 64)
    # The element type of the parameters and of every per-client state
    # buffer ('float32' | 'bfloat16' | 'float16'); a compute dtype other
    # than it runs the forward in that dtype, the logits cast back to the
    # param dtype (fedtpu_torch.models.registry).
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # fedtpu's opt-in Pallas forward for the held-out eval. The port's
    # held-out eval runs that kernel's counterpart (K3 on the card) for the
    # float32 MLP whichever the value, and the model's own forward for any
    # other model, as fedtpu does.
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam + StepLR as the reference's torch driver configures them
    (``fedtpu.config.OptimConfig``)."""

    name: str = "adam"                   # 'adam' | 'sgd'
    learning_rate: float = 0.004
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    steplr_step_size: int = 30
    steplr_gamma: float = 0.5
    momentum: float = 0.9                # sgd only


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Round orchestration (``fedtpu.config.FedConfig``): the synchronous
    round's fields, and the knobs of the other engines at their neutral
    values."""

    rounds: int = 300
    weighting: str = "data_size"         # 'data_size' | 'uniform'
    termination_patience: int = 10
    tolerance: float = 1e-4
    same_init: bool = False
    init_seed: int = 0
    # Client sampling: each client trains in a round with this probability,
    # deterministic in (participation_seed, round, client); absentees keep
    # their params and optimizer state. 1.0 == every client every round.
    participation_rate: float = 1.0
    participation_seed: int = 0
    # Reduction backend of the parameter average: 'psum' (K1 over the whole
    # client stack) | 'ring' (rotate-and-accumulate over the mesh's shards,
    # K4 on the card) | 'ring-rsag' (reduce-scatter + all-gather).
    aggregation: str = "psum"
    # E full-batch local updates a round (FedAvg's local epochs), and the
    # FedProx term mu/2 * ||w - w_round_start||^2 in their objective.
    local_steps: int = 1
    prox_mu: float = 0.0
    # Warm start: a weights artifact (fedtpu_torch.sweep.grid's .npz,
    # fedtpu's format) broadcast into every client slot.
    init_weights_npz: Optional[str] = None
    # SCAFFOLD control variates (needs weighting='uniform').
    scaffold: bool = False
    # The delta path: a server optimizer over the clients' updates
    # ('none' | 'fedavgm' | 'fedadagrad' | 'fedyogi' | 'fedadam'), central DP
    # (per-client clip, Gaussian noise, adaptive clip, the (eps, delta)
    # report's delta), robust rules with Byzantine injection, and the int8
    # exchange: fedtpu's knobs, semantics and refusals
    # (fedtpu_torch.parallel.round).
    server_opt: str = "none"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    server_b1: float = 0.9
    server_b2: float = 0.99
    server_tau: float = 1e-3
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_seed: int = 0
    dp_adaptive_clip: bool = False
    dp_target_quantile: float = 0.5
    dp_clip_lr: float = 0.2
    dp_count_noise_multiplier: float = 0.0
    dp_delta: float = 1e-5
    robust_aggregation: str = "none"
    trim_ratio: float = 0.1
    krum_f: int = 0
    byzantine_clients: int = 0
    compress: str = "none"
    # Post-training per-client fine-tuning: E local steps from the final
    # global model, reported beside it (fedtpu_torch.training.personalize);
    # 0 = off.
    personalize_steps: int = 0
    # The asynchronous FedBuff engine (fedtpu_torch.parallel.async_fed):
    # a round is a server tick, each a Bernoulli(async_arrival_rate) draw
    # of the clients that complete; their deltas, discounted (1+s)^-p by
    # staleness, move the global by server_lr times their mean, every
    # arrival tick, or once async_buffer_size >= 2 of them are buffered.
    # Needs weighting='uniform' and refuses the synchronous aggregation
    # stack's knobs, as fedtpu (orchestration.loop.check_async_config).
    async_mode: bool = False
    async_arrival_rate: float = 0.5
    async_arrival_seed: int = 0
    async_staleness_power: float = 0.5
    async_buffer_size: int = 0
    # The cohort engine (fedtpu_torch.cohort.scheduler): > 0 trains the
    # population of shard.num_clients through sampled cohorts of this many
    # slots, each client's params and optimizer state in a host-side store
    # ('memory' | 'mmap', the file at client_store_path, by default
    # <checkpoint_dir>/client_store.bin); cohorts drawn 'uniform',
    # 'weighted' (by data size) or from a serving trace's arrival order
    # ('trace', cohort_trace), seeded cohort_seed. Plain FedAvg only, as in
    # fedtpu (scheduler._validate_cohort_config).
    cohort_size: int = 0
    client_store: str = "memory"
    client_store_path: Optional[str] = None
    cohort_sampling: str = "uniform"
    cohort_seed: int = 0
    cohort_trace: Optional[str] = None

    def __post_init__(self):
        if self.weighting not in ("data_size", "uniform"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError(f"participation_rate must be in (0, 1], got "
                             f"{self.participation_rate}")
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"available: {AGGREGATIONS}")
        if self.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got "
                             f"{self.local_steps}")
        if self.prox_mu < 0:
            raise ValueError(f"prox_mu must be >= 0, got {self.prox_mu} "
                             "(negative mu amplifies drift instead of "
                             "bounding it)")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Structured-telemetry knobs (``fedtpu.config.TelemetryConfig``,
    ``fedtpu_torch.telemetry``): the JSONL event sink (None = telemetry
    off: the loop talks to a ``NullTracer``), the run manifest event, and
    the leveled logger's threshold."""

    events_path: Optional[str] = None
    manifest: bool = True
    log_level: str = "info"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Host loop settings (``fedtpu.config.RunConfig``) that this path reads."""

    log_every: int = 1
    log_per_client: bool = False
    # Rounds run per host sync (metrics fetched once per chunk); early stop
    # may overshoot by up to R-1 rounds, as in fedtpu.
    rounds_per_step: int = 1
    eval_test_every: int = 0             # 0 = disabled
    halt_on_nonfinite: bool = True
    # Shards of the clients axis (fedtpu_torch.parallel.mesh.make_mesh);
    # 0 = one shard per visible device of the run's type.
    mesh_devices: int = 0
    # Round checkpoints <checkpoint_dir>/round_<step>/{state,meta} every
    # checkpoint_every rounds (at chunk ends), keeping the keep_checkpoints
    # newest plus the best-accuracy round (0 = all); fedtpu_torch.
    # orchestration.checkpoint.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    keep_checkpoints: int = 0
    # One JSON line of metrics per round, appended to this path.
    metrics_jsonl: Optional[str] = None
    # Dispatch chunk k+1 before reading chunk k's metrics: the history is
    # the synchronous run's, the final state carries one chunk past a stop.
    pipelined_stop: bool = False
    # A torch.profiler trace of the round loop under profile_dir (a Chrome
    # trace): 0 traces the whole run; K > 0 a window that opens after the
    # first chunk's read and closes at the first chunk boundary covering
    # >= K rounds.
    profile_dir: Optional[str] = None
    profile_rounds: int = 0
    # The events sink, the manifest and the logger's level.
    telemetry: TelemetryConfig = TelemetryConfig()
    # Resilience (fedtpu_torch.resilience): a deterministic fault plan (a
    # JSON path or inline object), the divergence policy ('halt' or
    # 'rollback' to the newest loadable checkpoint, a retry budget per run,
    # the offenders excluded at weight 0, a relative perturbation from the
    # second retry on), and the liveness heartbeat file rewritten every
    # chunk. Validated by run_experiment before any build, as fedtpu's.
    fault_plan: Optional[str] = None
    on_divergence: str = "halt"
    rollback_retries: int = 2
    rollback_exclude: bool = False
    rollback_perturb: float = 1e-6
    heartbeat_file: Optional[str] = None
    # Not ported yet: each must stay at its default (_RUN_ITEMS).
    mpmd: bool = False
    model_parallel: int = 1
    compilation_cache: Optional[str] = None
    overlap_compile: bool = False
    collective_timeout: Optional[float] = None

    def __post_init__(self):
        if self.rounds_per_step < 1:
            raise ValueError("rounds_per_step must be >= 1")
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0")
        _refuse_unported(self, _RUN_ITEMS)


# RunConfig's knobs of paths not ported yet -> the ROADMAP item of each.
_RUN_ITEMS = {
    **dict.fromkeys(("mpmd", "model_parallel", "collective_timeout"), "A10"),
    **dict.fromkeys(("compilation_cache", "overlap_compile"), "A11c"),
}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = DataConfig()
    shard: ShardConfig = ShardConfig()
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    fed: FedConfig = FedConfig()
    run: RunConfig = RunConfig()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """``serve`` — the trace-driven serving front-end
    (``fedtpu_torch.serving``; ``fedtpu.config.ServingConfig``, every field
    with its default).

    A bounded cohort of ``cohort`` engine slots absorbs an unbounded
    user population (stable user -> slot bindings with LRU eviction —
    see fedtpu_torch.serving.engine.SlotBinder, and the per-user store
    behind it, ``ServingEngine.attach_store``); admitted updates become DRIVEN async
    FedBuff ticks. All admission/staleness/latency decisions run on the
    VIRTUAL clock carried by arrival timestamps, so identical trace +
    seed replays bitwise-identically."""

    host: str = "127.0.0.1"        # ingestion socket binds localhost only
    port: int = 0                  # 0 = ephemeral (see --port-file)
    cohort: int = 8                # concurrent engine slots (C)
    buffer_size: int = 0           # FedBuff K-buffer M; <= 1 applies per tick
    staleness_power: float = 0.5   # delta discount (1+s)^-p
    server_lr: float = 1.0
    local_steps: int = 1
    # Tick cadence — both may be active; 0 disables that trigger.
    tick_interval_s: float = 0.5   # virtual seconds between engine ticks
    flush_every: int = 0           # fire once this many eligible updates pend
    # Keep only the newest N per-tick history rows (0 = unbounded). The
    # history is the bitwise-determinism artifact, so it stays unbounded
    # by default; a supervised long-running server sets a window so the
    # row list (and its checkpoint) stops growing one row per tick.
    history_window: int = 0
    # Admission knobs (fedtpu_torch.serving.admission; virtual-time units).
    rate_limit: float = 0.0        # updates/s; 0 = off
    rate_burst: float = 64.0
    max_pending: int = 0           # queue-depth backpressure cutoff; 0 = off
    stale_deprioritize: int = 4    # versions behind => deprioritize
    stale_reject: int = 16         # versions behind => reject
    # Cohort training fixture (synthetic income-shaped shards).
    data_rows: int = 256
    data_features: int = 6
    data_classes: int = 2
    model_hidden: Tuple[int, ...] = (16, 8)
    seed: int = 0
    # SLO objective on update-to-incorporation latency (virtual s) and
    # the allowed violation share. Burn = violation_share/error_budget;
    # 1.0 means the budget is consumed exactly as provisioned
    # (fedtpu_torch.autoscale.signals.slo_burn_from_hist).
    slo_objective_s: float = 1.0
    slo_error_budget: float = 0.1
    # Sliding window (virtual s) for the admission stats the autoscale
    # control plane reads off the `stats` protocol op.
    admission_window_s: float = 10.0
    # Poisoning defense (fedtpu_torch.robust). screen=True
    # turns on the in-tick update screen (non-finite guard, norm-vs-
    # rolling-median, cosine-vs-server-direction); screened updates are
    # dropped before the K-buffer, counted under `admission_screened`,
    # and strike their sender — quarantine_strikes strikes quarantines
    # the user id.
    screen: bool = False
    screen_norm_mult: float = 4.0    # norm > mult * rolling median => screen
    screen_cos_min: float = -0.2     # cosine vs server direction below => screen
    screen_warmup: int = 8           # accepted ticks before norm screen arms
    screen_clip_norm: float = 0.0    # L2 clip on accepted updates; 0 = off
    quarantine_strikes: int = 3      # screened strikes until quarantine


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """``autoscale`` — the SLO-driven control plane
    (``fedtpu_torch.autoscale``; ``fedtpu.config.AutoscaleConfig``, every
    field with its default).

    Thresholds are read against :class:`fedtpu_torch.autoscale.signals.
    Snapshot` fields; the hysteresis/cooldown pair is what keeps the
    default policy from flapping (a scale signal must persist for
    ``hysteresis_ticks`` consecutive control ticks, and every action
    opens a ``cooldown_ticks`` refractory window)."""

    policy: str = "threshold"
    # SLO fold (must mirror the serving side's objective to be
    # meaningful; the simulator uses these directly).
    objective_s: float = 1.0
    error_budget: float = 0.1
    control_interval_s: float = 0.5   # snapshot cadence (virtual s live+sim)
    # Threshold knobs for the default policy.
    backlog_high: int = 256           # pending depth that means overload
    backlog_low: int = 32             # pending depth that means underload
    burn_high: float = 1.0            # SLO burn >= this is overload
    reject_high: float = 0.2          # window rate+backpressure reject share
    hysteresis_ticks: int = 2
    cooldown_ticks: int = 4
    # Actuation bounds / targets.
    min_capacity: int = 1             # gang floor (members)
    max_capacity: int = 8             # gang ceiling (members)
    cohort_high: int = 128            # set_cohort_size on scale-up
    cohort_low: int = 32              # set_cohort_size on scale-down
    tick_fast_s: float = 0.1          # set_tick_cadence on scale-up
    tick_slow_s: float = 1.0          # set_tick_cadence on scale-down

    def __post_init__(self):
        if self.objective_s <= 0 or self.error_budget <= 0:
            raise ValueError("objective_s and error_budget must be > 0")
        if self.control_interval_s <= 0:
            raise ValueError("control_interval_s must be > 0")
        if self.backlog_low > self.backlog_high:
            raise ValueError("backlog_low must be <= backlog_high")
        if self.hysteresis_ticks < 1 or self.cooldown_ticks < 0:
            raise ValueError("hysteresis_ticks >= 1 and "
                             "cooldown_ticks >= 0 required")
        if not (1 <= self.min_capacity <= self.max_capacity):
            raise ValueError("need 1 <= min_capacity <= max_capacity")
        if self.tick_fast_s <= 0 or self.tick_slow_s <= 0:
            raise ValueError("tick cadences must be > 0")


# fedtpu's presets: the income ones, the sklearn warm-start demo's and the
# CIFAR-10 ConvNet's. The income CSV is not in the repository, so the
# tabular presets run on the synthetic income-like data
# (DataConfig.csv_path=None).
PRESETS = {
    "income-2": ExperimentConfig(shard=ShardConfig(num_clients=2),
                                 fed=FedConfig(rounds=5)),
    "income-4": ExperimentConfig(shard=ShardConfig(num_clients=4),
                                 fed=FedConfig(rounds=300)),
    "income-8": ExperimentConfig(shard=ShardConfig(num_clients=8),
                                 fed=FedConfig(rounds=300)),
    # The sklearn MLPClassifier warm-start demo's (``parity``): hidden
    # (50, 400), uniform averaging, 5 rounds, the scaler without centring
    # (FL_SkLearn_MLPClassifier_Limitation.py:184).
    "sklearn-parity": ExperimentConfig(
        data=DataConfig(scale_with_mean=False),
        shard=ShardConfig(num_clients=4),
        model=ModelConfig(hidden_sizes=(50, 400)),
        fed=FedConfig(rounds=5, weighting="uniform")),
    # Non-IID label-skewed income shards, 32 clients.
    "income-32-noniid": ExperimentConfig(
        shard=ShardConfig(num_clients=32, strategy="dirichlet",
                          dirichlet_alpha=0.5),
        fed=FedConfig(rounds=300)),
    # The 2-layer ConvNet, 32 clients: FedAvg's payload stress config.
    # Real CIFAR-10 where the python batches exist locally, CIFAR-shaped
    # synthetic data otherwise (fedtpu_torch.data.cifar10).
    "cifar10-32": ExperimentConfig(
        data=DataConfig(dataset_name="cifar10", synthetic_rows=4096),
        shard=ShardConfig(num_clients=32),
        model=ModelConfig(kind="convnet", num_classes=10,
                          hidden_sizes=(256,), compute_dtype="bfloat16"),
        fed=FedConfig(rounds=50)),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
