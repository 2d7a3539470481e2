"""Carry weights and optimizer state between ``fedtpu`` and the port.

``fedtpu`` holds client-stacked params as a pytree, the MLP's
``{'layers': [{'w': (C, in, out), 'b': (C, out)}]}`` or the ConvNet's
``{'convs': [{'w': (C, 3, 3, cin, cout), 'b'}], 'dense': {...}, 'head':
{...}}``, and Adam state as optax ``ScaleByAdamState(count, mu, nu)`` leaves
of the same pytree shape (count ``(C,)`` int32 once vmapped over clients).
The port holds one flat ``(C, D)`` buffer per quantity in the param dtype,
the leaves mapped by path (``fedtpu_torch.models.registry``). Both
directions take and give numpy, so this module needs no JAX; the round trip
is exact (the values are only re-laid out).

A JAX bfloat16 array reaches numpy as ``ml_dtypes``' ``bfloat16``, which
torch cannot read and this module does not import: its leaves are told by
the dtype's name and carried bit for bit through an ``int16`` view. numpy
has no bfloat16 of its own, so the way back gives a bfloat16 leaf as
float32, exactly (every bfloat16 is a float32); float16 stays float16.
"""

from __future__ import annotations

import numpy as np
import torch

from fedtpu_torch.models.registry import (as_model, build_tree, flatten,
                                          tree_leaves)


def leaf_to_tensor(leaf) -> torch.Tensor:
    """One numpy leaf (float32, float16, or ``ml_dtypes``' bfloat16) -> a
    CPU tensor of the same dtype and bits."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    if arr.dtype not in (np.float32, np.float16):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def _tree_to_flat(tree) -> torch.Tensor:
    return flatten(build_tree((path, leaf_to_tensor(leaf))
                              for path, leaf in tree_leaves(tree)))


def params_from_jax(tree) -> torch.Tensor:
    """``fedtpu`` params pytree (numpy leaves, client-stacked or not) -> the
    port's flat buffer ``(C, D)`` or ``(D,)``, on the CPU, in the leaves'
    dtype."""
    return _tree_to_flat(tree)


def params_to_numpy(flat: torch.Tensor, model) -> dict:
    """The port's flat buffer -> ``fedtpu``'s pytree layout, numpy leaves
    (bfloat16 as float32, exactly). ``model``: a ``registry.FlatModel``,
    or the float32 MLP's widths."""
    view = as_model(model).unflatten(flat.detach().cpu())
    return build_tree((path, (leaf.float() if leaf.dtype == torch.bfloat16
                              else leaf).numpy().copy())
                      for path, leaf in tree_leaves(view))


def adam_state_from_jax(mu, nu, count) -> dict:
    """optax ``ScaleByAdamState`` leaves (numpy) -> the port's Adam state,
    in the leaves' dtype. ``count`` is the per-client update count
    ``(C,)``; the clients' counts may differ (client sampling), and each
    keeps its own."""
    return {"mu": _tree_to_flat(mu), "nu": _tree_to_flat(nu),
            "count": torch.from_numpy(np.array(count, dtype=np.int32))}


def adam_state_to_numpy(state: dict, model):
    """The port's Adam state -> ``(mu, nu, count)`` in optax's layout, with
    ``count`` as the ``(C,)`` int32 vector a vmapped optax state holds."""
    return (params_to_numpy(state["mu"], model),
            params_to_numpy(state["nu"], model),
            state["count"].detach().cpu().numpy().astype(np.int32))
