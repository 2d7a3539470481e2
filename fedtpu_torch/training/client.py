"""Local training and evaluation, batched over the clients axis
(``fedtpu.training.client``).

* ``make_local_train_step`` is the reference's ``train_one_epoch``: ONE
  full-batch forward/backward/optimizer step on each client's whole shard per
  round. ``fedtpu`` vmaps a per-client step; here the client axis is a batch
  dimension of the ``(C, D)`` parameter buffer. Clients' losses do not
  interact, so the gradient of their sum is each client's own gradient. The
  forward and backward are plain matrix products (``torch.matmul`` and
  autograd), as ``fedtpu`` leaves them to XLA.
* ``make_local_eval_step`` is ``evaluate_local``: each client's confusion
  matrix on its own shard, through K2 (``fused_eval_confusion``) on the card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fedtpu_torch.models.mlp import mlp_apply, unflatten
from fedtpu_torch.ops.cuda_kernels import fused_eval_confusion
from fedtpu_torch.ops.losses import masked_cross_entropy
from fedtpu_torch.ops.optim import Optimizer


def make_local_train_step(dims: Sequence[int], tx: Optimizer) -> Callable:
    """Returns ``step(params, opt_state, x, y, mask, part=None) -> (params,
    opt_state, loss)``: params ``(C, D)``, x ``(C, N, in)``; ``loss (C,)``
    is each client's masked CE before the step. Under client sampling
    ``part (C,)`` is the round's participation mask: a client at 0 keeps
    its params and optimizer state (its loss is still reported)."""

    def step(params, opt_state, x, y, mask, part=None):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = masked_cross_entropy(mlp_apply(unflatten(p, dims), x), y,
                                        mask)
            (grads,) = torch.autograd.grad(loss.sum(), p)
        new_params, opt_state = tx.update(grads, opt_state, params, part)
        return new_params, opt_state, loss.detach()

    return step


def make_local_eval_step(dims: Sequence[int], num_classes: int) -> Callable:
    """Returns ``eval(params, x, y, mask) -> (C, K, K)`` confusion counts."""

    def step(params, x, y, mask):
        return fused_eval_confusion(params, dims, x, y, mask, num_classes)

    return step
