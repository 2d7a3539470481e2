"""Optimizers with the reference's torch-driver semantics (``fedtpu.ops.optim``).

Adam(lr0) under StepLR(step_size, gamma), the schedule stepped once per
optimizer update (once a round, or ``local_steps`` times): the
staircase schedule ``lr(t) = lr0 * gamma^floor(t / step_size)`` on the update
count. The update is written in optax's order (``optax.adam`` with
``eps_root=0``): moments ``(1-b)*g + b*m``, bias correction by division, then
``m_hat / (sqrt(v_hat) + eps)`` scaled by ``-lr(t)`` and added to the params.
SGD with momentum is optax's ``trace`` then the same scaling.

The optimizer steps the whole client-stacked ``(C, D)`` buffer at once, with
one update count per client (``count``, a ``(C,)`` int32 tensor beside the
params, as a vmapped optax state holds it): under client sampling a client
that sits a round out keeps its count, so the clients' schedules and bias
corrections drift apart. Both are computed per client on the device as
``(C, 1)`` float32 columns, with no host sync.

The state is kept in the params' dtype (bfloat16 or float16 params give
bfloat16 or float16 moments and traces, as optax keeps them), and the
update rounds where optax's does: each of its Python constants (``b1``,
``1 - b2``, ``eps``, the momentum) is first the value it takes in that
dtype, each product and sum is rounded to it, and the float32 bias
corrections and the float32 rate are cast to it before they are applied.
At float32 that is the float32 update. ``select_participants`` takes
a ``(C,)`` participation mask: a client whose entry is 0 keeps its params
and every state tensor, count included, bit for bit (``fedtpu.parallel.
round``'s ``select``). FedAvg never touches this state: each client's
moments persist un-averaged. ``build_sweep_adam`` is the hyperparameter
grid's: the same Adam direction at a constant rate per model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from fedtpu_torch.config import OptimConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (new_params, new_state)``; pure functions of tensors, as optax's.
    ``step(grads, state) -> (updates, new_state)``, where there is one, is
    optax's ``update``: the signed, scaled update in the grads' dtype, which
    ``update`` adds to the params (``apply_updates``)."""

    init: Callable
    update: Callable
    step: Optional[Callable] = None


def _applied(step: Callable) -> Callable:
    """``update`` of a ``step``: ``params + updates`` in the params'
    dtype."""
    def update(grads, state, params):
        upd, new_state = step(grads, state)
        return params + upd, new_state
    return update


def step_lr(cfg: OptimConfig, count: torch.Tensor) -> torch.Tensor:
    """The staircase schedule at each client's update ``count``, in float32
    as optax computes it: ``lr0 * gamma ** floor(count / step_size)``."""
    p = torch.floor(count.to(torch.float32) / cfg.steplr_step_size)
    return cfg.learning_rate * torch.pow(cfg.steplr_gamma, p)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    # 1 - decay**count in float32, as optax's tree_bias_correction.
    return 1.0 - torch.pow(decay, count.to(torch.float32))


@functools.lru_cache(maxsize=None)
def _in(dtype: torch.dtype, value: float) -> float:
    """``value`` rounded to ``dtype``: a weak-typed Python constant of
    optax's takes the dtype of the tensor it meets before the op."""
    return torch.tensor(value, dtype=dtype).item()


def _init_count(params: torch.Tensor) -> torch.Tensor:
    # One count per client: the leading axes of the stacked buffer.
    return torch.zeros(params.shape[:-1], dtype=torch.int32,
                       device=params.device)


def _col(t: torch.Tensor) -> torch.Tensor:
    """A per-client ``(C,)`` value as a ``(C, 1)`` column over the params."""
    return t[..., None]


def select_participants(part: Optional[torch.Tensor], new: dict,
                        old: dict) -> dict:
    """Participants take ``new``, absentees keep ``old`` (every entry)."""
    if part is None:
        return new
    keep = part > 0
    return {k: torch.where(keep if new[k].dim() == keep.dim() else
                           _col(keep), new[k], old[k]) for k in new}


def _adam_init(params: torch.Tensor) -> dict:
    return {"mu": torch.zeros_like(params), "nu": torch.zeros_like(params),
            "count": _init_count(params)}


def _scale_by_adam(cfg: OptimConfig, grads: torch.Tensor,
                   state: dict) -> tuple:
    """optax's ``scale_by_adam(b1, b2, eps, eps_root=0)``: the direction
    ``m_hat / (sqrt(v_hat) + eps)`` and the new moments and counts, in the
    grads' dtype."""
    dt = grads.dtype
    mu = _in(dt, 1 - cfg.b1) * grads + _in(dt, cfg.b1) * state["mu"]
    nu = (_in(dt, 1 - cfg.b2) * (grads * grads)
          + _in(dt, cfg.b2) * state["nu"])
    count = state["count"] + 1
    mu_hat = mu / _col(_bias_correction(cfg.b1, count).to(dt))
    nu_hat = nu / _col(_bias_correction(cfg.b2, count).to(dt))
    return (mu_hat / (torch.sqrt(nu_hat) + _in(dt, cfg.eps)),
            {"mu": mu, "nu": nu, "count": count})


def _scaled(cfg: OptimConfig, count: torch.Tensor,
            upd: torch.Tensor) -> torch.Tensor:
    """optax's ``scale_by_learning_rate``: ``-lr(count)`` cast to the
    update's dtype, times the update."""
    return _col(-step_lr(cfg, count)).to(upd.dtype) * upd


def build_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "adam":
        def step(grads, state):
            upd, new_state = _scale_by_adam(cfg, grads, state)
            return _scaled(cfg, state["count"], upd), new_state

        return Optimizer(_adam_init, _applied(step), step)
    if cfg.name == "sgd":
        def init(params):
            return {"trace": torch.zeros_like(params),
                    "count": _init_count(params)}

        def step(grads, state):
            trace = grads + _in(grads.dtype, cfg.momentum) * state["trace"]
            return (_scaled(cfg, state["count"], trace),
                    {"trace": trace, "count": state["count"] + 1})

        return Optimizer(init, _applied(step), step)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def build_sweep_adam(cfg: OptimConfig) -> Optimizer:
    """The sweep's optimizer (``fedtpu.sweep.grid``): optax's
    ``scale_by_adam(b1, b2, eps, eps_root=0)`` followed by ``p - lr * u``,
    a constant rate per model and no StepLR. ``update(grads, state, params,
    lr)`` takes ``lr`` as a column over the params' last axis (one rate a
    model, ``(M, 1)`` for ``(M, P)`` params); each model keeps its own
    update count."""
    def update(grads, state, params, lr):
        upd, new_state = _scale_by_adam(cfg, grads, state)
        return params - lr * upd, new_state

    return Optimizer(_adam_init, update)
