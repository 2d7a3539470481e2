"""Local training and evaluation, batched over the clients axis
(``fedtpu.training.client``).

* ``make_local_train_step`` is the reference's ``train_one_epoch``: ONE
  full-batch forward/backward/optimizer step on each client's whole shard per
  round, or ``local_steps`` of them (FedAvg's E local epochs: full batch, so
  an epoch is a step), with FedProx's ``prox_mu`` term. ``fedtpu`` vmaps a
  per-client step; here the client axis is a batch dimension of the
  ``(C, D)`` parameter buffer. Clients' losses do not interact, so the
  gradient of their sum is each client's own gradient. The forward and
  backward are the model's plain PyTorch ops and autograd (matrix products,
  and for the ConvNet one grouped convolution over the clients), as
  ``fedtpu`` leaves them to XLA.
* ``make_local_eval_step`` is ``evaluate_local``: each client's confusion
  matrix on its own shard, through K2 (``fused_eval_confusion``) on the card
  for the float32 MLP, through the model's own forward for any other
  (``fedtpu_torch.models.registry``).

Both take a model spec (``registry.FlatModel``) or, for the float32 MLP,
its widths.
"""

from __future__ import annotations

from typing import Callable

import torch

from fedtpu_torch.models.registry import as_model
from fedtpu_torch.ops.cuda_kernels import fused_eval_confusion
from fedtpu_torch.ops.losses import masked_cross_entropy
from fedtpu_torch.ops.metrics import confusion_matrix
from fedtpu_torch.ops.optim import Optimizer, select_participants


def make_local_train_step(model, tx: Optimizer,
                          local_steps: int = 1,
                          prox_mu: float = 0.0,
                          scaffold: bool = False,
                          wide: bool = False) -> Callable:
    """Returns ``step(params, opt_state, x, y, mask, part=None,
    correction=None) -> (params, opt_state, loss)``: params ``(C, D)``, x
    ``(C, N, ...)``, the model's rows.

    ``local_steps`` full-batch updates (``fedtpu.training.client``): the
    optimizer's count, and with it the StepLR schedule and Adam's bias
    correction, advances once per update. ``prox_mu`` adds FedProx's
    ``mu/2 * ||w - w0||^2`` to each client's objective, ``w0`` its params
    at the round's start (a constant: no gradient flows into it); its
    gradient is 0 at ``w0``, so it only acts from the second update on.
    ``loss (C,)`` is the last update's plain masked CE, taken before that
    update, without the prox term. Under client sampling ``part (C,)`` is
    the round's participation mask: a client at 0 keeps its params and
    optimizer state, count included, bit for bit across the E updates (its
    loss is still reported: as in ``fedtpu``, absentees train all E
    steps and the result is dropped). ``correction (C, D)``: SCAFFOLD's
    drift correction ``c - c_i``, added to each raw gradient before the
    optimizer sees it (Karimireddy et al. 2020's local rule, for any
    optimizer). With ``scaffold`` the step also returns, fourth, the first
    update's raw CE gradient ``(C, D)``: the gradient at the round-start
    model that refreshes the variates (option I), since the prox term's
    gradient is exactly 0 there and the correction comes after autograd.

    ``wide`` (one local step, no sampling): the returned params are the
    update's float32 sum ``p + u`` of the param-dtype params and update,
    before its rounding to a bfloat16 or float16 param dtype. ``fedtpu``'s
    compiled round reduces and evaluates those: XLA keeps the sum in
    float32 into the float32 casts that follow it (the round's
    ``tensordot``, the robust rules' gathers, the eval's forward); rounding
    them gives the stored params. At float32 they are the params."""
    if local_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    if prox_mu < 0:
        raise ValueError(f"prox_mu must be >= 0, got {prox_mu} "
                         "(negative mu amplifies drift instead of bounding "
                         "it)")
    if wide and local_steps != 1:
        raise ValueError("wide params are those of a single local step")
    model = as_model(model)
    wide = wide and model.param_dtype != torch.float32

    def one(params, opt_state, x, y, mask, anchor, correction):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            ce = masked_cross_entropy(model.apply(p, x), y, mask)
            objective = ce.sum()
            if prox_mu:
                objective = objective + 0.5 * prox_mu * torch.sum(
                    torch.square(p - anchor))
            (grads,) = torch.autograd.grad(objective, p)
        raw = grads
        if correction is not None:
            grads = grads + correction
        if wide:
            upd, opt_state = tx.step(grads, opt_state)
            new_params = params.to(torch.float32) + upd.to(torch.float32)
        else:
            new_params, opt_state = tx.update(grads, opt_state, params)
        return new_params, opt_state, ce.detach(), raw

    def step(params, opt_state, x, y, mask, part=None, correction=None):
        anchor = params.detach()
        new_params, new_opt = params, opt_state
        for i in range(local_steps):
            new_params, new_opt, loss, raw = one(new_params, new_opt, x, y,
                                                 mask, anchor, correction)
            if i == 0:
                first_grad = raw
        kept = select_participants(part, {"params": new_params, **new_opt},
                                   {"params": params, **opt_state})
        if scaffold:
            return kept.pop("params"), kept, loss, first_grad
        return kept.pop("params"), kept, loss

    return step


def make_local_eval_step(model, num_classes: int) -> Callable:
    """Returns ``eval(params, x, y, mask) -> (C, K, K)`` confusion counts:
    K2 for the float32 MLP, else the argmax of the model's logits counted
    by ``confusion_matrix`` (``fedtpu``'s in-round eval, which is never a
    kernel)."""
    model = as_model(model)
    dims = model.mlp_dims

    def kernel(params, x, y, mask):
        return fused_eval_confusion(params, dims, x, y, mask, num_classes)

    def plain(params, x, y, mask):
        preds = torch.argmax(model.apply(params, x), dim=-1)
        return confusion_matrix(y, preds, mask, num_classes)

    return kernel if dims is not None else plain
