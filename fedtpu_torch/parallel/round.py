"""The synchronous federated round (``fedtpu.parallel.round``, averaging
path).

Per round, in the reference's order (FL_CustomMLP...:145-198):

    sample       under client sampling, a (C,) participation mask
    train        one full-batch step per client (batched over clients), or
                 ``local_steps`` of them with FedProx's ``prox_mu`` term;
                 absentees keep their params and optimizer state
    eval         each client's TRAINED, not yet averaged model on its own
                 shard -> (C, K, K) confusion counts (K2 on the card)
    average      data-size- or uniformly-weighted FedAvg of the params over
                 the round's participants, broadcast back into every client
                 slot; a round whose weight total is 0 carries the params
                 over (decided on the device)

The average has three backends (``FedConfig.aggregation``):

- ``psum``: K1 (``weighted_average_clients`` in broadcast mode) over the
  whole ``(C, D)`` stack, whatever the mesh: one launch writes the average
  into every slot and decides the carry-over. Neither this nor XLA's psum
  has a shard order to honour.
- ``ring`` / ``ring-rsag``: ``fedtpu``'s formula over the clients mesh
  (``fedtpu_torch.parallel.mesh``). Each shard's partial sum
  ``sum_{i in shard} w_i p_i`` (one batched matmul) with the shard's weight
  total appended as one extra float is all-reduced in one call
  (``fedtpu_torch.parallel.ring``: K4 on the card for ``ring``), then each
  shard divides by its own total and broadcasts its own global into its
  own clients' slots.

Per-client Adam moments are never averaged. ``fedtpu`` scans
``rounds_per_step`` rounds inside one compiled program. Here the step is a
Python loop over the chunk's rounds; on the card ``capture_round_step``
captures it as one CUDA graph, which the host loop replays once per chunk,
and the host reads the chunk's outputs once (``pack_outputs``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from fedtpu_torch.models.mlp import mlp_init
from fedtpu_torch.ops.cuda_kernels import (LAUNCHES, count_replay,
                                           fused_mlp_forward,
                                           weighted_average_clients)
from fedtpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.parallel.mesh import ClientMesh
from fedtpu_torch.parallel.ring import make_all_reduce
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


def participation_mask(num_clients: int, rate: float, seed: int,
                       rnd: int) -> torch.Tensor:
    """Round ``rnd``'s ``(C,)`` float32 mask: client c participates when its
    uniform draw is below ``rate``. Deterministic in (seed, round, client),
    from an explicit ``torch.Generator`` (not ``fedtpu``'s ``jax.random``
    stream, which torch cannot replay)."""
    key = np.random.SeedSequence([seed, rnd]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(key))
    return (torch.rand(num_clients, generator=gen) < rate).to(torch.float32)


def state_finite(state: dict) -> torch.Tensor:
    """A device bool: every float tensor of params and optimizer state is
    entirely finite (no host read). Each tensor's largest magnitude (its
    inf-norm, which NaN and inf carry through) is finite exactly when the
    whole tensor is; ``_foreach_norm`` takes all of them in one
    multi-tensor launch on the card."""
    leaves = [state["params"]] + [v for v in state["opt_state"].values()
                                  if v.is_floating_point()]
    peaks = torch.stack(torch._foreach_norm(leaves, float("inf")))
    return torch.isfinite(peaks).all()


class RoundStep:
    """``step(state, batch, masks=None) -> (state, raw)`` running ``rounds``
    rounds (``build_round_fn``). ``draw_masks(first, count)`` gives the
    ``(count, C)`` participation masks of rounds ``first..`` on the host,
    or None without client sampling."""

    def __init__(self, fn: Callable, rounds: int,
                 draw_masks: Optional[Callable]):
        self.fn, self.rounds, self.draw_masks = fn, rounds, draw_masks

    def __call__(self, state: dict, batch: dict,
                 masks: Optional[torch.Tensor] = None):
        return self.fn(state, batch, masks)


def build_round_fn(dims: Sequence[int], tx: Optimizer, num_classes: int,
                   client_weights: torch.Tensor,
                   rounds_per_step: int = 1,
                   mesh: Optional[ClientMesh] = None,
                   aggregation: str = "psum",
                   participation_rate: float = 1.0,
                   participation_seed: int = 0,
                   participation_masks: Optional[Callable] = None,
                   local_steps: int = 1,
                   prox_mu: float = 0.0) -> RoundStep:
    """Returns ``round_step(state, batch, masks=None) -> (state, raw)``
    running ``rounds_per_step`` rounds; ``raw`` holds the stacked per-round
    ``loss (R, C)`` and ``conf (R, C, K, K)`` and ``finite``, a device bool
    that the new state's params and optimizer state are finite, all on the
    device (see ``assemble_metrics``). The step reads nothing back to the
    host, so it can be captured (``capture_round_step``).

    ``client_weights (C,)`` are the FedAvg base weights: true shard sizes
    under ``weighting='data_size'``, ones under 'uniform'; under sampling a
    round weighs them by its mask. ``mesh`` (default: one shard) cuts the
    clients into the shards the ring backends reduce over.
    ``participation_rate < 1`` samples clients each round
    (``participation_mask``); ``participation_masks`` (round index ->
    ``(C,)`` float32 mask) replaces those draws, e.g. with ``fedtpu``'s.
    Under sampling, ``masks (R, C)`` on the device gives the chunk's masks;
    without it the step draws them on the host (``draw_masks``) and copies
    them over. ``local_steps`` and ``prox_mu``: each round's local training
    (``make_local_train_step``)."""
    if not 0.0 < participation_rate <= 1.0:
        raise ValueError(f"participation_rate must be in (0, 1], got "
                         f"{participation_rate}")
    num_clients = client_weights.shape[0]
    dev = client_weights.device
    if mesh is None:
        mesh = ClientMesh(1, num_clients, (dev,))
    if mesh.num_shards * mesh.clients_per_shard != num_clients:
        raise ValueError(f"a mesh of {mesh.num_shards} x "
                         f"{mesh.clients_per_shard} clients for "
                         f"{num_clients} clients")
    if aggregation != "psum" and any(d != dev for d in mesh.devices):
        raise NotImplementedError(
            "a ring over shards on several devices is not ported to "
            "fedtpu_torch yet (ROADMAP A10): it needs the ring kernel over "
            "peer-mapped buffers")
    sampling = participation_rate < 1.0 or participation_masks is not None
    local_train = make_local_train_step(dims, tx, local_steps, prox_mu)
    local_eval = make_local_eval_step(dims, num_classes)
    all_reduce = make_all_reduce(aggregation, mesh.num_shards)
    shards, cb = mesh.num_shards, mesh.clients_per_shard

    def draw_masks(first_round: int, count: int) -> torch.Tensor:
        def one(r):
            if participation_masks is not None:
                return torch.as_tensor(np.array(participation_masks(r),
                                                dtype=np.float32))
            return participation_mask(num_clients, participation_rate,
                                      participation_seed, r)
        return torch.stack([one(first_round + j) for j in range(count)])

    def psum_average(params, w):
        return weighted_average_clients(params, w, broadcast=True)

    def ring_average(params, w):
        d = params.shape[1]
        blocks = params.view(shards, cb, d)
        partial = torch.bmm(w.view(shards, 1, cb), blocks).view(shards, d)
        total = w.view(shards, cb).sum(dim=1, keepdim=True)
        acc = all_reduce(torch.cat((partial, total), dim=1))
        tot = acc[:, d:]
        glob = acc[:, :d] / tot.clamp_min(1.0)
        # Zero participants in the round: params carry over unchanged.
        return torch.where(tot[:, :, None] > 0, glob[:, None, :],
                           blocks).reshape(num_clients, d)

    average = psum_average if aggregation == "psum" else ring_average

    def round_step(state, batch, masks=None):
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        params, opt_state = state["params"], state["opt_state"]
        if sampling and masks is None:
            masks = draw_masks(state["round"], rounds_per_step).to(dev)
        losses, confs = [], []
        for j in range(rounds_per_step):
            part = masks[j] if sampling else None
            params, opt_state, loss = local_train(params, opt_state, x, y,
                                                  mask, part)
            confs.append(local_eval(params, x, y, mask))
            losses.append(loss)
            params = average(params, client_weights * part if sampling
                             else client_weights)
        new_state = {"params": params, "opt_state": opt_state,
                     "round": state["round"] + rounds_per_step}
        return new_state, {"loss": torch.stack(losses),
                           "conf": torch.stack(confs),
                           "finite": state_finite(new_state)}

    return RoundStep(round_step, rounds_per_step,
                     draw_masks if sampling else None)


def pack_outputs(raw: dict) -> torch.Tensor:
    """A chunk's ``raw`` as one float32 vector: loss, confusion counts
    (exact in float32 below 2^24), then the finite flag as 1 or 0; one
    buffer for the host to read."""
    return torch.cat((raw["loss"].reshape(-1), raw["conf"].reshape(-1),
                      raw["finite"].reshape(1).to(torch.float32)))


def unpack_outputs(flat: torch.Tensor, rounds: int, num_clients: int,
                   num_classes: int) -> dict:
    """Inverse of ``pack_outputs``: ``loss (R, C)``, ``conf (R, C, K, K)``,
    ``finite`` (a Python bool)."""
    n_loss = rounds * num_clients
    n_conf = n_loss * num_classes * num_classes
    return {"loss": flat[:n_loss].view(rounds, num_clients),
            "conf": flat[n_loss:n_loss + n_conf].view(
                rounds, num_clients, num_classes, num_classes),
            "finite": bool(flat[n_loss + n_conf] > 0)}


def _state_tensors(state: dict) -> list:
    opt = state["opt_state"]
    return [state["params"], *(opt[k] for k in sorted(opt))]


class CapturedRounds:
    """A chunk of ``rounds`` rounds captured as one CUDA graph
    (``capture_round_step``). The state lives in the static tensors of
    ``state``, which each replay updates in place; ``__call__(masks=None)``
    copies the chunk's ``(R, C)`` participation masks (on the device) into
    the graph's mask buffer, replays the graph and returns its packed
    outputs (``pack_outputs``), a static tensor the next replay
    overwrites. ``launches`` holds the kernel launches one replay makes;
    each replay adds them to ``cuda_kernels.LAUNCHES``."""

    def __init__(self, graph, state, masks, out, launches, rounds):
        self.graph, self.state, self.masks, self.out = graph, state, masks, out
        self.launches, self.rounds = launches, rounds

    def __call__(self, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.masks is not None:
            self.masks.copy_(masks)
        self.graph.replay()
        count_replay(self.launches)
        return self.out


def _needs_the_card(state: dict) -> torch.device:
    dev = state["params"].device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
    return dev


def _mask_buffer(step: RoundStep, state: dict) -> Optional[torch.Tensor]:
    if step.draw_masks is None:
        return None
    return torch.zeros((step.rounds, state["params"].shape[0]),
                       dtype=torch.float32, device=state["params"].device)


def warm_up_round(step: RoundStep, state: dict, batch: dict) -> None:
    """Run ``step`` once, eagerly, on a side stream, its result dropped, so
    that the cuBLAS handles, kernel builds, function attributes and the
    cached SM count exist before ``capture_round_step`` captures. Once per
    run is enough, with a 1-round step: an R-round step launches the same
    kernels. Its launches are real, so they stay counted."""
    dev = _needs_the_card(state)
    live = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(live)
    with torch.cuda.stream(side):
        step(state, batch, _mask_buffer(step, state))
    live.wait_stream(side)


def capture_round_step(step: RoundStep, state: dict,
                       batch: dict) -> CapturedRounds:
    """``fedtpu``'s jitted scan of ``rounds_per_step`` rounds as a CUDA
    graph: the round step, its kernels (K1 or K4, and K2) and the train
    step's GEMMs, replayed with no per-op dispatch. Call ``warm_up_round``
    once before the first capture.

    ``state``'s tensors become the graph's static state: the captured step
    reads them and ends by copying the new state into them. Capture
    records the launches the step makes, ``cuda_kernels.LAUNCHES`` is set
    back (capture launches nothing), and each replay adds them. A capture
    that fails raises."""
    _needs_the_card(state)
    masks = _mask_buffer(step, state)
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    try:
        with torch.cuda.graph(graph):
            new_state, raw = step(state, batch, masks)
            for dst, src in zip(_state_tensors(state),
                                _state_tensors(new_state)):
                dst.copy_(src)
            out = pack_outputs(raw)
    finally:
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        LAUNCHES.update(before)
    return CapturedRounds(graph, state, masks, out, launches, step.rounds)


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
