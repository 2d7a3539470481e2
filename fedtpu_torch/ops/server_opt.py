"""Server-side optimizers for delta-based federated aggregation (FedOpt,
``fedtpu.ops.server_opt``), on the port's flat parameter layout.

The weighted mean of client *updates*

    delta = sum_i w_i (trained_i - g) / sum_i w_i

is a pseudo-gradient for a first-order server optimizer on the global model
``g`` ("Adaptive Federated Optimization", Reddi et al. 2021):

    fedavgm    g += lr * m,           m = beta * m + delta
    fedadagrad g += lr * m/(sqrt(v)+tau),  v = v + delta^2
    fedyogi    ...                    v = v - (1-b2) delta^2 sign(v - delta^2)
    fedadam    ...                    v = b2 v + (1-b2) delta^2
    (all three adaptives share m = b1 * m + (1-b1) * delta)

``fedavgm`` with ``momentum=0, lr=1`` is FedAvg exactly. No bias
correction (the published algorithms start at ``m=v=0`` and rely on ``tau``).
``g``, ``delta`` and every state tensor are one flat float32 ``(D,)``
buffer (``fedtpu_torch.models.mlp``), where ``fedtpu`` keeps a pytree of
leaves: the arithmetic is elementwise, so the layouts agree entry for entry.

The DP Gaussian noise is drawn on the host (``unit_normals``) and handed to
the round step as a tensor, so a CUDA graph replay, a resume and the CPU
all see the same draw.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

SERVER_OPTIMIZERS = ("fedavgm", "fedadagrad", "fedyogi", "fedadam")


@dataclasses.dataclass(frozen=True)
class ServerOptimizer:
    """``init(g) -> state``; ``update(delta, state) -> (step, state)`` with
    the server applying ``g_new = g + step``. Pure functions of tensors."""

    name: str
    init: Callable
    update: Callable


def identity_server_optimizer() -> ServerOptimizer:
    """The FedAvg point of the family, ``fedavgm(momentum=0, lr=1)``: the
    delta path without a real server optimizer (DP-only aggregation,
    SCAFFOLD's eta_g = 1)."""
    return make_server_optimizer("fedavgm", learning_rate=1.0, momentum=0.0)


def make_server_optimizer(name: str, learning_rate: float = 1.0,
                          momentum: float = 0.9, b1: float = 0.9,
                          b2: float = 0.99, tau: float = 1e-3
                          ) -> ServerOptimizer:
    """Build one of ``SERVER_OPTIMIZERS`` (Reddi et al.'s defaults)."""
    if name not in SERVER_OPTIMIZERS:
        raise ValueError(f"unknown server optimizer {name!r}; "
                         f"available: {SERVER_OPTIMIZERS}")

    if name == "fedavgm":
        def init(g):
            return {"m": torch.zeros_like(g)}

        def update(delta, state):
            m = momentum * state["m"] + delta
            return learning_rate * m, {"m": m}

        return ServerOptimizer(name, init, update)

    def init(g):
        return {"m": torch.zeros_like(g), "v": torch.zeros_like(g)}

    def second_moment(v, d):
        if name == "fedadagrad":
            return v + torch.square(d)
        if name == "fedyogi":
            sq = torch.square(d)
            return v - (1.0 - b2) * sq * torch.sign(v - sq)
        return b2 * v + (1.0 - b2) * torch.square(d)       # fedadam

    def update(delta, state):
        m = b1 * state["m"] + (1.0 - b1) * delta
        v = second_moment(state["v"], delta)
        return learning_rate * m / (torch.sqrt(v) + tau), {"m": m, "v": v}

    return ServerOptimizer(name, init, update)


def clip_by_global_norm(delta: torch.Tensor,
                        clip_norm: Union[float, torch.Tensor]):
    """Per-client L2 clipping of ``delta (C, D)``: each row is scaled by
    ``min(1, clip_norm / ||delta_c||_2)``, the norm over the whole row,
    i.e. over all of a client's leaves jointly (the DP-FedAvg sensitivity
    bound: one clip per client, not per tensor). ``clip_norm`` may be a
    0-d device tensor (adaptive clipping). Returns ``(clipped, norms)``,
    ``norms (C,)``. As in ``fedtpu``, the norms and factors are float32
    whatever the update's dtype, and each factor is cast to that dtype
    before it scales the row."""
    d32 = delta.to(torch.float32)
    norms = torch.sqrt(torch.sum(torch.square(d32), dim=1))
    factor = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return delta * factor.to(delta.dtype)[:, None], norms


def unit_normals(seed: int, stream: int, rnd: int, size: int) -> np.ndarray:
    """``size`` float32 N(0, 1) draws of round ``rnd`` on the host, a pure
    function of ``(seed, stream, rnd)``; ``stream`` is a domain-separation
    tag, so two streams (and the participation draws, whose entropy is
    ``[seed, rnd]``) never repeat each other at the same seed and round."""
    gen = np.random.default_rng([seed, stream, rnd])
    return gen.standard_normal(size, dtype=np.float32)
