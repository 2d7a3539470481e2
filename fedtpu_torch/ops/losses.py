"""Losses (``fedtpu.ops.losses``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedtpu_torch.ops.metrics import one_hot


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows where mask==1: logits (..., N, K), labels (..., N),
    mask (..., N) -> (...). Padded rows contribute exactly zero to the loss
    and its gradient, so the mean is over the true shard size. The label
    pick is a one-hot product, as in fedtpu (exact: products with 0/1)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = (logp * one_hot(labels, logits.shape[-1])).sum(dim=-1)
    denom = mask.sum(dim=-1).clamp_min(1.0)
    return -(ll * mask).sum(dim=-1) / denom
