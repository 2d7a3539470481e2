"""Quantized (int8) client-update exchange (``fedtpu.parallel.compress``).

Each shard of the clients mesh reduces its OWN clients first (the weighted
partial sum ``S_s = sum_{c on s} w_c * delta_c``, no client axis), then
quantizes that partial sum to int8 with one scalar scale per leaf, and the
int8 payloads and the scales are what crosses the wire:

    scale_s  = max|S_s| / 127                     one f32 scalar per leaf
    q_s      = round(S_s / scale_s)               int8 in [-127, 127]
    mean     = sum_s q_s * scale_s / max(total_w, 1)

A leaf is one tensor of ``fedtpu``'s pytree, i.e. one layer's ``w`` or
``b``: here a segment of the flat ``(D,)`` row (the model spec's
``leaf_bounds``, ``fedtpu_torch.models.registry``), each with its own
scale. The error is at most ``scale_s / 2`` per element of each partial
sum. The shards of the port's mesh share one device, so the "wire" is a
tensor; the arithmetic is ``fedtpu``'s.
"""

from __future__ import annotations

import torch

from fedtpu_torch.models.registry import as_model


def quantize_leaves(x: torch.Tensor, bounds: list):
    """Symmetric int8 quantization of ``x (S, D)`` with one scale per row
    and leaf. Returns ``(q int8 (S, D), scales (S, leaves))``; an all-zero
    leaf gets scale 0 and dequantizes to exact zeros."""
    scales = torch.stack([x[:, a:b].abs().amax(dim=1) for a, b in bounds],
                         dim=1) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    per_elem = torch.cat([safe[:, j:j + 1].expand(-1, b - a)
                          for j, (a, b) in enumerate(bounds)], dim=1)
    q = torch.clamp(torch.round(x / per_elem), -127, 127).to(torch.int8)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               bounds: list) -> torch.Tensor:
    """Inverse of ``quantize_leaves``: ``(S, D)`` float32."""
    per_elem = torch.cat([scales[:, j:j + 1].expand(-1, b - a)
                          for j, (a, b) in enumerate(bounds)], dim=1)
    return q.to(torch.float32) * per_elem


def quantized_weighted_mean(delta: torch.Tensor, w: torch.Tensor,
                            shards: int, model) -> torch.Tensor:
    """The weighted mean of ``delta (C, D)`` with weights ``w (C,)`` over a
    mesh of ``shards`` shards (contiguous blocks of clients), each shard's
    partial sum exchanged as int8 with one scale per leaf of ``model`` (a
    ``registry.FlatModel`` or the float32 MLP's widths): ``(D,)`` float32,
    or zeros when the weights sum to 0 (``0 / max(0, 1)``). A bfloat16 or
    float16 delta is summed and quantized from float32, as in ``fedtpu``."""
    c, d = delta.shape
    cb = c // shards
    partial = torch.bmm(w.view(shards, 1, cb),
                        delta.to(torch.float32).view(shards, cb, d)
                        ).view(shards, d)
    bounds = as_model(model).leaf_bounds
    q, scales = quantize_leaves(partial, bounds)
    total = dequantize(q, scales, bounds).sum(dim=0)
    return total / torch.clamp(w.sum(), min=1.0)
