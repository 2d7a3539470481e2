"""The reference MLP (``fedtpu.models.mlp``) on one flat parameter buffer.

``fedtpu`` keeps its parameters as the pytree
``{'layers': [{'w': (in, out), 'b': (out,)}]}``, with a leading clients axis
when client-stacked. The port keeps the same tensors as views of ONE flat
buffer in the param dtype (float32 unless ``ModelConfig.param_dtype`` says
otherwise), ``(D,)`` for a model or ``(C, D)`` client-stacked, laid out
layer by layer as ``w`` (row-major, (in, out) — not ``nn.Linear``'s
(out, in)) then ``b``. ``unflatten`` gives the pytree view, so the public
layout stays ``fedtpu``'s; the flat buffer is what the optimizer steps, what
FedAvg averages in one kernel launch, and what the eval kernels copy into
shared memory as one contiguous block.

Init follows torch ``nn.Linear``'s law, U(-1/sqrt(fan_in), +1/sqrt(fan_in))
for weights and biases, drawn from an explicit ``torch.Generator``: the same
law as ``fedtpu``'s init, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def layer_dims(input_dim: int, hidden_sizes: Sequence[int],
               num_classes: int) -> Tuple[int, ...]:
    """``(input_dim, *hidden_sizes, num_classes)``."""
    return (int(input_dim), *(int(h) for h in hidden_sizes), int(num_classes))


def param_count(dims: Sequence[int]) -> int:
    """D: the length of one model's flat parameter buffer."""
    return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))


def leaf_bounds(dims: Sequence[int]) -> list:
    """``(start, end)`` in the flat row of each of ``fedtpu``'s leaves, per
    layer ``w`` then ``b`` (``unflatten``'s layout)."""
    out, off = [], 0
    for i, o in zip(dims[:-1], dims[1:]):
        out += [(off, off + i * o), (off + i * o, off + i * o + o)]
        off += i * o + o
    return out


def unflatten(flat: torch.Tensor, dims: Sequence[int]) -> dict:
    """Views ``{'layers': [{'w': (..., in, out), 'b': (..., out)}]}`` of a
    ``(..., D)`` buffer; writes through a view land in ``flat``."""
    if flat.shape[-1] != param_count(dims):
        raise ValueError(f"flat buffer has {flat.shape[-1]} params, dims "
                         f"{tuple(dims)} need {param_count(dims)}")
    lead = flat.shape[:-1]
    layers, off = [], 0
    for i, o in zip(dims[:-1], dims[1:]):
        w = flat[..., off:off + i * o].reshape(*lead, i, o)
        off += i * o
        b = flat[..., off:off + o]
        off += o
        layers.append({"w": w, "b": b})
    return {"layers": layers}


def flatten(params: dict) -> torch.Tensor:
    """Inverse of ``unflatten``: a fresh ``(..., D)`` buffer from a pytree."""
    parts = []
    for lyr in params["layers"]:
        w, b = lyr["w"], lyr["b"]
        parts += [w.reshape(*w.shape[:-2], -1), b]
    return torch.cat(parts, dim=-1).contiguous()


def mlp_init(generator: torch.Generator, input_dim: int,
             hidden_sizes: Sequence[int], num_classes: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One model's flat ``(D,)`` parameters in ``dtype``, on the
    generator's device."""
    dims = layer_dims(input_dim, hidden_sizes, num_classes)
    flat = torch.empty(param_count(dims), dtype=dtype,
                       device=generator.device)
    for lyr in unflatten(flat, dims)["layers"]:
        bound = 1.0 / math.sqrt(lyr["w"].shape[-2])
        lyr["w"].uniform_(-bound, bound, generator=generator)
        lyr["b"].uniform_(-bound, bound, generator=generator)
    return flat


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Forward pass -> logits. Works client-stacked as well: ``x (C, N, in)``
    with ``w (C, in, out)``, ``b (C, out)``."""
    layers = params["layers"]
    h = x
    for i, lyr in enumerate(layers):
        h = torch.matmul(h, lyr["w"]) + lyr["b"].unsqueeze(-2)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h
