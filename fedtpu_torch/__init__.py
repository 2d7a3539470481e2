"""fedtpu_torch — the PyTorch/CUDA port of fedtpu, for one NVIDIA H100.

A second package beside ``fedtpu`` (the JAX reference, which it never
imports). It mirrors ``fedtpu``'s module paths and function names; it runs
the synchronous engine (FedAvg, the server optimizers, central DP, the
robust rules, SCAFFOLD, the int8 exchange, personalization) of the income
presets and of the CIFAR-10 ConvNet (``cifar10-32``, bf16 compute), with
float32, bfloat16 or float16 params (``ModelConfig.param_dtype``), the
hyperparameter grid and the sklearn warm-start demo (``sklearn-parity``),
with hand-written CUDA kernels in place of the JAX package's Pallas kernels
(``fedtpu_torch.ops.cuda_kernels``).

    fedtpu_torch.config         — configs + fedtpu's presets
    fedtpu_torch.data           — the CSV and synthetic income data, CIFAR-10,
                                  sharding
    fedtpu_torch.models         — the MLP and the ConvNet on a flat parameter
                                  buffer, their spec (registry)
    fedtpu_torch.ops            — losses, metrics, optimizers, server
                                  optimizers, the DP accountant, CUDA kernels
    fedtpu_torch.parallel       — the federated round, its CUDA graph, int8
    fedtpu_torch.cohort         — the client store, the cohort engine
    fedtpu_torch.orchestration  — host round loop, early stopping, checkpoints,
                                  the privacy ledger
    fedtpu_torch.resilience     — fault plans, the supervisor and its exit
                                  codes, chaos, oracles, the wire faults
    fedtpu_torch.training       — local training, eval, personalization
    fedtpu_torch.sweep          — the hyperparameter grid, its .npz artifact
    fedtpu_torch.parity         — the sklearn MLPClassifier warm-start demo,
                                  over a numpy MLPClassifier
    fedtpu_torch.convert        — params / Adam state to and from fedtpu
    fedtpu_torch.utils          — timing
    fedtpu_torch.benchmarks     — the fused whole round vs the composed one

Entry points resolve lazily: a bare ``import fedtpu_torch`` builds no kernel
and touches no CUDA.
"""

__version__ = "0.1.0"

_LAZY = {
    "run_experiment": ("fedtpu_torch.orchestration.loop", "run_experiment"),
    "build_experiment": ("fedtpu_torch.orchestration.loop",
                         "build_experiment"),
    "build_round_fn": ("fedtpu_torch.parallel.round", "build_round_fn"),
    "init_federated_state": ("fedtpu_torch.parallel.round",
                             "init_federated_state"),
    "run_cohort_experiment": ("fedtpu_torch.cohort.scheduler",
                              "run_cohort_experiment"),
    "run_grid_search": ("fedtpu_torch.sweep.grid", "run_grid_search"),
    "PRESETS": ("fedtpu_torch.config", "PRESETS"),
    "get_preset": ("fedtpu_torch.config", "get_preset"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'fedtpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
