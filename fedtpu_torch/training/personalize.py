"""Per-client personalization: local fine-tuning of the trained global
model (``fedtpu.training.personalize``).

After the federated rounds each client takes the global model and runs E
local full-batch steps on its own shard with a fresh optimizer state, with
no further averaging; its metrics on its own shard are then taken through
the in-round eval (K2 on the card for the float32 MLP). The reference has no analogue: its
training ends at the last averaged model.
"""

from __future__ import annotations

from typing import Callable

from fedtpu_torch.ops.metrics import metrics_from_confusion
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.parallel.round import masked_client_mean
from fedtpu_torch.training.client import (make_local_eval_step,
                                          make_local_train_step)


def build_personalize_fn(model, tx: Optimizer, num_classes: int,
                         steps: int) -> Callable:
    """``model``: a ``registry.FlatModel`` or the float32 MLP's widths.
    Returns ``personalize(params, batch) -> (personal_params, metrics)``:
    ``steps`` local full-batch updates per client from the given
    client-stacked ``(C, D)`` params with a fresh ``tx`` state, then each
    personalized model's confusion counts on its own shard. ``metrics``
    holds ``per_client`` (``(C,)`` per metric), the empty-shard-masked
    ``client_mean`` and the last update's ``loss (C,)``."""
    if steps < 1:
        raise ValueError(f"personalize steps must be >= 1, got {steps}")
    local_train = make_local_train_step(model, tx, local_steps=steps)
    local_eval = make_local_eval_step(model, num_classes)

    def personalize(params, batch):
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        personal, _, loss = local_train(params, tx.init(params), x, y, mask)
        per_client = metrics_from_confusion(local_eval(personal, x, y, mask))
        return personal, {"per_client": per_client,
                          "client_mean": masked_client_mean(per_client,
                                                            mask),
                          "loss": loss}

    return personalize
