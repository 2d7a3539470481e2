"""Optimizers with the reference's torch-driver semantics (``fedtpu.ops.optim``).

Adam(lr0) under StepLR(step_size, gamma), one optimizer step per round: the
staircase schedule ``lr(t) = lr0 * gamma^floor(t / step_size)`` on the update
count. The update is written in optax's order (``optax.adam`` with
``eps_root=0``): moments ``(1-b)*g + b*m``, bias correction by division, then
``m_hat / (sqrt(v_hat) + eps)`` scaled by ``-lr(t)`` and added to the params.
SGD with momentum is optax's ``trace`` then the same scaling.

The optimizer steps the whole client-stacked ``(C, D)`` buffer at once. That
is exact per client because every client steps every round, so all clients
share one update count; client sampling would need one count per client
(not ported yet, see ``FedConfig``). FedAvg never touches this state: each
client's moments persist un-averaged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from fedtpu_torch.config import OptimConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (new_params, new_state)``; pure functions of tensors, as optax's."""

    init: Callable
    update: Callable


def step_lr(cfg: OptimConfig, count: int) -> float:
    """The staircase schedule at update ``count``, in float32 as optax
    computes it (the gamma power is exact for gamma = 0.5)."""
    p = math.floor(count / cfg.steplr_step_size)
    return float(np.float32(cfg.learning_rate)
                 * np.float32(cfg.steplr_gamma) ** np.float32(p))


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay**count in float32, as optax's tree_bias_correction.
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "adam":
        def init(params):
            return {"mu": torch.zeros_like(params),
                    "nu": torch.zeros_like(params), "count": 0}

        def update(grads, state, params):
            mu = (1 - cfg.b1) * grads + cfg.b1 * state["mu"]
            nu = (1 - cfg.b2) * (grads * grads) + cfg.b2 * state["nu"]
            count = state["count"] + 1
            mu_hat = mu / _bias_correction(cfg.b1, count)
            nu_hat = nu / _bias_correction(cfg.b2, count)
            upd = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
            new = params + (-step_lr(cfg, state["count"])) * upd
            return new, {"mu": mu, "nu": nu, "count": count}

        return Optimizer(init, update)
    if cfg.name == "sgd":
        def init(params):
            return {"trace": torch.zeros_like(params), "count": 0}

        def update(grads, state, params):
            trace = grads + cfg.momentum * state["trace"]
            new = params + (-step_lr(cfg, state["count"])) * trace
            return new, {"trace": trace, "count": state["count"] + 1}

        return Optimizer(init, update)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
