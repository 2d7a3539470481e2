"""Carry weights and optimizer state between ``fedtpu`` and the port.

``fedtpu`` holds client-stacked params as the pytree
``{'layers': [{'w': (C, in, out), 'b': (C, out)}]}`` and Adam state as
optax ``ScaleByAdamState(count, mu, nu)`` leaves of the same pytree shape
(count ``(C,)`` int32 once vmapped over clients). The port holds one flat
``(C, D)`` float32 buffer per quantity (``fedtpu_torch.models.mlp``). Both
directions take and give numpy, so this module needs no JAX; the round trip
is exact (the values are only re-laid out).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fedtpu_torch.models.mlp import flatten, unflatten


def _tree_to_flat(tree) -> torch.Tensor:
    return flatten({"layers": [
        {"w": torch.from_numpy(np.array(l["w"], dtype=np.float32)),
         "b": torch.from_numpy(np.array(l["b"], dtype=np.float32))}
        for l in tree["layers"]]})


def params_from_jax(tree) -> torch.Tensor:
    """``fedtpu`` params pytree (numpy leaves, client-stacked or not) -> the
    port's flat float32 buffer ``(C, D)`` or ``(D,)``, on the CPU."""
    return _tree_to_flat(tree)


def params_to_numpy(flat: torch.Tensor, dims: Sequence[int]) -> dict:
    """The port's flat buffer -> ``fedtpu``'s pytree layout, numpy leaves."""
    view = unflatten(flat.detach().cpu(), dims)
    return {"layers": [{"w": l["w"].numpy().copy(), "b": l["b"].numpy().copy()}
                       for l in view["layers"]]}


def adam_state_from_jax(mu, nu, count) -> dict:
    """optax ``ScaleByAdamState`` leaves (numpy) -> the port's Adam state.
    ``count`` is the per-client update count ``(C,)``; the clients' counts
    may differ (client sampling), and each keeps its own."""
    return {"mu": _tree_to_flat(mu), "nu": _tree_to_flat(nu),
            "count": torch.from_numpy(np.array(count, dtype=np.int32))}


def adam_state_to_numpy(state: dict, dims: Sequence[int]):
    """The port's Adam state -> ``(mu, nu, count)`` in optax's layout, with
    ``count`` as the ``(C,)`` int32 vector a vmapped optax state holds."""
    return (params_to_numpy(state["mu"], dims),
            params_to_numpy(state["nu"], dims),
            state["count"].detach().cpu().numpy().astype(np.int32))
