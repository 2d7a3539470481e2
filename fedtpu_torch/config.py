"""Typed configuration for the PyTorch port's synchronous FedAvg path.

The port's own copies of ``fedtpu.config``'s data, shard, model and optimizer
configs, plus the subset of ``FedConfig`` / ``RunConfig`` that the averaging
path reads. Field names and defaults are ``fedtpu``'s, so one preset reads the
same on both sides. A knob of ``fedtpu`` that this port does not run yet is
still a field, at its neutral default; any other value raises
``NotImplementedError`` naming the ROADMAP item that will port it, instead of
being silently ignored.

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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline settings (``fedtpu.config.DataConfig``)."""

    csv_path: Optional[str] = None       # None => synthetic income-like data
    label_column: str = "income"
    test_size: float = 0.2
    split_seed: int = 42                 # random_state=42 everywhere in the reference
    scale_with_mean: bool = True
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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference MLP (``fedtpu.config.ModelConfig``, MLP family only)."""

    kind: str = "mlp"
    # () degenerates the MLP to a single Linear (logistic regression).
    hidden_sizes: Tuple[int, ...] = (50, 200)
    num_classes: int = 2
    input_dim: int = 14

    def __post_init__(self):
        if self.kind != "mlp":
            _not_ported(f"ModelConfig.kind={self.kind!r}", "A7")


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
    """Round orchestration (``fedtpu.config.FedConfig``): the averaging path's
    fields, and the knobs of the other paths at their neutral values."""

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
    # Not ported yet: each must stay at its default (see __post_init__).
    local_steps: int = 1
    prox_mu: float = 0.0
    scaffold: bool = False
    server_opt: str = "none"
    dp_clip_norm: float = 0.0
    dp_noise_multiplier: float = 0.0
    robust_aggregation: str = "none"
    byzantine_clients: int = 0
    compress: str = "none"
    async_mode: bool = False
    cohort_size: int = 0
    personalize_steps: int = 0

    def __post_init__(self):
        if self.weighting not in ("data_size", "uniform"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError(f"participation_rate must be in (0, 1], got "
                             f"{self.participation_rate}")
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"available: {AGGREGATIONS}")
        if self.local_steps != 1 or self.prox_mu:
            _not_ported("local_steps > 1 / prox_mu", "A3")
        if self.scaffold:
            _not_ported("scaffold", "A6")
        if self.server_opt != "none" or self.dp_clip_norm \
                or self.dp_noise_multiplier:
            _not_ported("server optimizers / DP", "A6")
        if self.robust_aggregation != "none" or self.byzantine_clients:
            _not_ported("robust aggregation", "A6")
        if self.compress != "none":
            _not_ported("compressed aggregation", "A6")
        if self.async_mode:
            _not_ported("async_mode", "A8")
        if self.cohort_size:
            _not_ported("cohort_size", "A9")
        if self.personalize_steps:
            _not_ported("personalize_steps", "A7")


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
    # Not ported yet: must stay at its default.
    model_parallel: int = 1

    def __post_init__(self):
        if self.rounds_per_step < 1:
            raise ValueError("rounds_per_step must be >= 1")
        if self.mesh_devices < 0:
            raise ValueError("mesh_devices must be >= 0")
        if self.model_parallel != 1:
            _not_ported("model_parallel > 1", "A10")


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


# fedtpu's income presets. The income CSV is not in the repository, so they
# run on the synthetic income-like data (DataConfig.csv_path=None).
PRESETS = {
    "income-2": ExperimentConfig(shard=ShardConfig(num_clients=2),
                                 fed=FedConfig(rounds=5)),
    "income-4": ExperimentConfig(shard=ShardConfig(num_clients=4),
                                 fed=FedConfig(rounds=300)),
    "income-8": ExperimentConfig(shard=ShardConfig(num_clients=8),
                                 fed=FedConfig(rounds=300)),
    # Non-IID label-skewed income shards, 32 clients.
    "income-32-noniid": ExperimentConfig(
        shard=ShardConfig(num_clients=32, strategy="dirichlet",
                          dirichlet_alpha=0.5),
        fed=FedConfig(rounds=300)),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
