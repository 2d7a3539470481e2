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
sum. A round quantizes its shards' partial sums (``quantize_partials``)
and dequantizes and sums every shard's (``dequantized_mean``). The shards
of one process's mesh share one device, so there the "wire" is a tensor;
in a training gang each member quantizes its own shards and the int8
rows and scales are gathered across the processes as one int8 block a
shard (``fedtpu_torch.parallel.ring.GangGather``). The arithmetic is
``fedtpu``'s.
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


def quantize_partials(delta: torch.Tensor, w: torch.Tensor, shards: int,
                      model):
    """Each of ``shards`` shards' (contiguous blocks of ``delta (C,
    D)``'s clients) weighted partial sum with weights ``w (C,)``, summed
    from float32 (a 16-bit delta too, as in ``fedtpu``), as int8 with one
    scale per leaf of ``model`` (a ``registry.FlatModel`` or the float32
    MLP's widths): ``(q int8 (shards, D), scales (shards, leaves))``, what
    crosses the wire (a gang member quantizes its own shards)."""
    c, d = delta.shape
    cb = c // shards
    partial = torch.bmm(w.view(shards, 1, cb),
                        delta.to(torch.float32).view(shards, cb, d)
                        ).view(shards, d)
    return quantize_leaves(partial, as_model(model).leaf_bounds)


def dequantized_mean(q: torch.Tensor, scales: torch.Tensor,
                     total_w: torch.Tensor, model) -> torch.Tensor:
    """Every shard's ``q``/``scales`` dequantized and summed in shard
    order, over ``max(total_w, 1)``: ``(D,)`` float32, zeros when the
    weights sum to 0."""
    total = dequantize(q, scales, as_model(model).leaf_bounds).sum(dim=0)
    return total / torch.clamp(total_w, min=1.0)
