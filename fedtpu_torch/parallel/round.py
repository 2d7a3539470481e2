"""The synchronous federated round on one device (``fedtpu.parallel.round``,
averaging path).

Per round, in the reference's order (FL_CustomMLP...:145-198):

    train        one full-batch step per client (batched over clients)
    eval         each client's TRAINED, not yet averaged model on its own
                 shard -> (C, K, K) confusion counts (K2 on the card)
    average      data-size- or uniformly-weighted FedAvg of the params
                 (K1 on the card), broadcast back into every client slot

Per-client Adam moments are never averaged. ``fedtpu`` scans
``rounds_per_step`` rounds inside one compiled program; here they are a
Python loop, and the host fetches the chunk's metrics once.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fedtpu_torch.models.mlp import mlp_init
from fedtpu_torch.ops.cuda_kernels import (fused_mlp_forward,
                                           weighted_average_clients)
from fedtpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.training.client import (make_local_eval_step,
                                          make_local_train_step)


def init_federated_state(generator: torch.Generator, num_clients: int,
                         dims: Sequence[int], tx: Optimizer,
                         same_init: bool = False,
                         device: torch.device = torch.device("cpu"),
                         params: torch.Tensor = None) -> dict:
    """Client-stacked params ``(C, D)`` + optimizer state on ``device``.

    Each client draws its own init from ``generator`` (the reproducible
    stand-in for the reference's unseeded per-rank init), or all clients
    share one draw when ``same_init``. ``params`` (``(C, D)``) replaces the
    draw, e.g. with ``fedtpu``'s own init through
    ``fedtpu_torch.convert.params_from_jax``."""
    if params is None:
        draw = lambda: mlp_init(generator, dims[0], dims[1:-1], dims[-1])
        if same_init:
            params = draw().expand(num_clients, -1)
        else:
            params = torch.stack([draw() for _ in range(num_clients)])
    if tuple(params.shape[:1]) != (num_clients,):
        raise ValueError(f"params for {params.shape[0]} clients, expected "
                         f"{num_clients}")
    params = params.to(device=device, dtype=torch.float32).contiguous()
    return {"params": params, "opt_state": tx.init(params), "round": 0}


def build_round_fn(dims: Sequence[int], tx: Optimizer, num_classes: int,
                   client_weights: torch.Tensor,
                   rounds_per_step: int = 1) -> Callable:
    """Returns ``round_step(state, batch) -> (state, raw)`` running
    ``rounds_per_step`` rounds; ``raw`` holds the stacked per-round
    ``loss (R, C)`` and ``conf (R, C, K, K)`` on the device (see
    ``assemble_metrics``).

    ``client_weights (C,)`` are the FedAvg weights: true shard sizes under
    ``weighting='data_size'``, ones under 'uniform'. Full participation keeps
    them fixed for the run, so whether their total is 0 (no client has data:
    params carry over, as in fedtpu) is decided once here, on the host."""
    local_train = make_local_train_step(dims, tx)
    local_eval = make_local_eval_step(dims, num_classes)
    average = bool(client_weights.sum() > 0)

    def round_step(state, batch):
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        params, opt_state = state["params"], state["opt_state"]
        losses, confs = [], []
        for _ in range(rounds_per_step):
            params, opt_state, loss = local_train(params, opt_state, x, y,
                                                  mask)
            confs.append(local_eval(params, x, y, mask))
            losses.append(loss)
            if average:
                glob = weighted_average_clients(params, client_weights)
                # In place: params is the optimizer's fresh output.
                params.copy_(glob.expand_as(params))
        new_state = {"params": params, "opt_state": opt_state,
                     "round": state["round"] + rounds_per_step}
        return new_state, {"loss": torch.stack(losses),
                           "conf": torch.stack(confs)}

    return round_step


def masked_client_mean(per_client: dict, mask: torch.Tensor) -> dict:
    """Mean over clients (last axis) excluding empty shards, so a dataless
    client does not deflate the global metric / early-stop signal."""
    nonempty = (mask.sum(dim=1) > 0).to(torch.float32)
    denom = nonempty.sum().clamp_min(1.0)
    return {k: (v * nonempty).sum(dim=-1) / denom
            for k, v in per_client.items()}


def assemble_metrics(loss: torch.Tensor, conf: torch.Tensor,
                     mask: torch.Tensor) -> dict:
    """Per-round metrics of a chunk: ``loss (R, C)``, ``conf (R, C, K, K)``
    -> per-client ``(R, C)``, client-mean and pooled ``(R,)`` entries."""
    per_client = metrics_from_confusion(conf)
    return {
        "loss": loss,
        "per_client": per_client,
        "client_mean": masked_client_mean(per_client, mask),
        "pooled": metrics_from_confusion(conf.sum(dim=1)),
    }


def global_params(state: dict) -> torch.Tensor:
    """The post-average global model: every client slot holds an identical
    copy, so take slot 0."""
    return state["params"][0]


def build_eval_fn(dims: Sequence[int], num_classes: int) -> Callable:
    """Held-out evaluation of the global model ``(D,)``; the forward is K3
    (``fused_mlp_forward``) on the card."""

    def eval_step(params, x, y):
        preds = torch.argmax(fused_mlp_forward(params, dims, x), dim=-1)
        mask = torch.ones(y.shape, dtype=torch.float32, device=y.device)
        return metrics_from_confusion(confusion_matrix(y, preds, mask,
                                                       num_classes))

    return eval_step
