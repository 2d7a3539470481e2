"""Carry weights and optimizer state between ``fedtpu`` and the port.

``fedtpu`` holds client-stacked params as a pytree, the MLP's
``{'layers': [{'w': (C, in, out), 'b': (C, out)}]}`` or the ConvNet's
``{'convs': [{'w': (C, 3, 3, cin, cout), 'b'}], 'dense': {...}, 'head':
{...}}``, and Adam state as optax ``ScaleByAdamState(count, mu, nu)`` leaves
of the same pytree shape (count ``(C,)`` int32 once vmapped over clients).
The port holds one flat ``(C, D)`` float32 buffer per quantity, the leaves
mapped by path (``fedtpu_torch.models.registry``). Both directions take and
give numpy, so this module needs no JAX; the round trip is exact (the values
are only re-laid out).
"""

from __future__ import annotations

import numpy as np
import torch

from fedtpu_torch.models.registry import (as_model, build_tree, flatten,
                                          tree_leaves)


def _tree_to_flat(tree) -> torch.Tensor:
    return flatten(build_tree(
        (path, torch.from_numpy(np.array(leaf, dtype=np.float32)))
        for path, leaf in tree_leaves(tree)))


def params_from_jax(tree) -> torch.Tensor:
    """``fedtpu`` params pytree (numpy leaves, client-stacked or not) -> the
    port's flat float32 buffer ``(C, D)`` or ``(D,)``, on the CPU."""
    return _tree_to_flat(tree)


def params_to_numpy(flat: torch.Tensor, model) -> dict:
    """The port's flat buffer -> ``fedtpu``'s pytree layout, numpy leaves.
    ``model``: a ``registry.FlatModel``, or the float32 MLP's widths."""
    view = as_model(model).unflatten(flat.detach().cpu())
    return build_tree((path, leaf.numpy().copy())
                      for path, leaf in tree_leaves(view))


def adam_state_from_jax(mu, nu, count) -> dict:
    """optax ``ScaleByAdamState`` leaves (numpy) -> the port's Adam state.
    ``count`` is the per-client update count ``(C,)``; the clients' counts
    may differ (client sampling), and each keeps its own."""
    return {"mu": _tree_to_flat(mu), "nu": _tree_to_flat(nu),
            "count": torch.from_numpy(np.array(count, dtype=np.int32))}


def adam_state_to_numpy(state: dict, model):
    """The port's Adam state -> ``(mu, nu, count)`` in optax's layout, with
    ``count`` as the ``(C,)`` int32 vector a vmapped optax state holds."""
    return (params_to_numpy(state["mu"], model),
            params_to_numpy(state["nu"], model),
            state["count"].detach().cpu().numpy().astype(np.int32))
