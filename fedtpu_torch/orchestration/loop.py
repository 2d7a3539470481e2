"""Host round loop for the synchronous FedAvg path
(``fedtpu.orchestration.loop``).

``run_experiment`` keeps ``fedtpu``'s semantics for this path: chunks of
``rounds_per_step`` rounds with one metrics fetch each; the client-mean,
pooled, per-client, loss and held-out test histories; the non-finite halt;
and early stopping with exactly the reference logic (``np.allclose`` of the
client-mean metrics, ``atol=tolerance``, ``termination_patience`` rounds).
Checkpointing, fault injection, telemetry and pipelining are not ported.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
with no GPU and no such request they raise rather than fall back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedtpu_torch.config import ExperimentConfig
from fedtpu_torch.convert import params_from_jax, params_to_numpy
from fedtpu_torch.data.sharding import pack_clients
from fedtpu_torch.data.tabular import Dataset, load_tabular_dataset
from fedtpu_torch.models.mlp import layer_dims
from fedtpu_torch.ops.metrics import METRIC_NAMES
from fedtpu_torch.ops.optim import build_optimizer
from fedtpu_torch.parallel.mesh import ClientMesh, make_mesh
from fedtpu_torch.parallel.round import (assemble_metrics, build_eval_fn,
                                         build_round_fn, global_params,
                                         init_federated_state)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; ``cuda`` needs a GPU. Also pins
    fp32 matrix products to full fp32 (no TF32), as the reference computes
    at Precision.HIGHEST."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: fedtpu_torch runs on the GPU by default; pass "
            "device='cpu' (CLI: --platform cpu) to run the plain versions on "
            "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class ExperimentResult:
    """History + final model, with ``fedtpu``'s field names."""

    global_metrics: Dict[str, List[float]]       # client mean per round
    pooled_metrics: Dict[str, List[float]]       # pooled over clients
    per_client_metrics: Dict[str, List[np.ndarray]]
    test_metrics: Dict[str, List[float]]         # held-out, global model
    loss: List[np.ndarray]                       # (C,) per round
    sec_per_round: List[float]
    rounds_run: int
    stopped_early: bool
    final_params: dict                           # fedtpu's pytree layout
    config: ExperimentConfig
    diverged: bool = False
    # (C, K, K) in-round confusion counts per round, the currency every
    # metric above derives from (fedtpu keeps them on the device).
    confusion: List[np.ndarray] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        warm = max(1, self.config.run.rounds_per_step)
        steady = (self.sec_per_round[warm:] if len(self.sec_per_round) > warm
                  else self.sec_per_round or [0.0])
        return {
            "rounds_run": self.rounds_run,
            "stopped_early": self.stopped_early,
            "diverged": self.diverged,
            "final_global_metrics": {k: v[-1] for k, v in
                                     self.global_metrics.items() if v},
            "mean_sec_per_round": float(np.mean(steady)),
        }


@dataclasses.dataclass
class Experiment:
    """Wired-up experiment: data on the device + round-step factory."""

    make_step: Callable[[int], Callable]   # rounds_per_step -> round_step
    state: dict
    batch: dict
    eval_step: Callable
    dataset: Dataset
    device: torch.device
    dims: tuple
    mesh: ClientMesh
    client_weights: torch.Tensor           # (C,) FedAvg base weights


def build_experiment(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                     device="cuda", init_params=None,
                     participation_masks=None) -> Experiment:
    """Wire data -> device -> mesh -> model -> optimizer -> round factory.

    ``init_params``: a ``fedtpu`` client-stacked params pytree (numpy
    leaves) to start from instead of the seeded init.
    ``participation_masks``: round index -> ``(C,)`` mask, replacing the
    port's own client-sampling draws (``build_round_fn``)."""
    dev = resolve_device(device)
    ds = dataset if dataset is not None else load_tabular_dataset(cfg.data)
    dims = layer_dims(ds.input_dim, cfg.model.hidden_sizes, ds.num_classes)
    tx = build_optimizer(cfg.optim)
    packed = pack_clients(ds.x_train, ds.y_train, cfg.shard)

    gen = torch.Generator().manual_seed(cfg.fed.init_seed)
    state = init_federated_state(
        gen, cfg.shard.num_clients, dims, tx, same_init=cfg.fed.same_init,
        device=dev,
        params=None if init_params is None else params_from_jax(init_params))
    batch = {"x": torch.from_numpy(packed.x).to(dev),
             "y": torch.from_numpy(packed.y).to(dev),
             "mask": torch.from_numpy(packed.mask).to(dev)}
    weights = (packed.counts.astype(np.float32)
               if cfg.fed.weighting == "data_size"
               else np.ones(cfg.shard.num_clients, np.float32))
    client_weights = torch.from_numpy(weights).to(dev)
    mesh = make_mesh(cfg.run.mesh_devices, cfg.shard.num_clients, dev)
    make_step = lambda r: build_round_fn(
        dims, tx, ds.num_classes, client_weights, rounds_per_step=r,
        mesh=mesh, aggregation=cfg.fed.aggregation,
        participation_rate=cfg.fed.participation_rate,
        participation_seed=cfg.fed.participation_seed,
        participation_masks=participation_masks)
    return Experiment(make_step=make_step, state=state, batch=batch,
                      eval_step=build_eval_fn(dims, ds.num_classes),
                      dataset=ds, device=dev, dims=dims, mesh=mesh,
                      client_weights=client_weights)


def _state_finite(state: dict) -> bool:
    """Every float tensor of params and optimizer state entirely finite."""
    leaves = [state["params"]] + [v for v in state["opt_state"].values()
                                  if isinstance(v, torch.Tensor)]
    return bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all())


def run_experiment(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                   verbose: bool = True, device="cuda", init_params=None,
                   participation_masks=None) -> ExperimentResult:
    """Run the federated loop (see module docstring)."""
    exp = build_experiment(cfg, dataset, device=device,
                           init_params=init_params,
                           participation_masks=participation_masks)
    ds, state, batch = exp.dataset, exp.state, exp.batch
    mask_host = batch["mask"].cpu()
    x_test = torch.from_numpy(ds.x_test).to(exp.device)
    y_test = torch.from_numpy(ds.y_test).to(exp.device)
    steps: Dict[int, Callable] = {}

    history = {k: [] for k in METRIC_NAMES}
    pooled_hist = {k: [] for k in METRIC_NAMES}
    per_client_hist = {k: [] for k in METRIC_NAMES}
    test_hist = {k: [] for k in METRIC_NAMES}
    losses: List[np.ndarray] = []
    confusion: List[np.ndarray] = []
    sec_per_round: List[float] = []
    prev_metric = None
    termination_count = cfg.fed.termination_patience
    stopped_early = diverged = False
    rounds_run = rnd = 0

    def say(line: str) -> None:
        if verbose:
            print(line, flush=True)

    while rnd < cfg.fed.rounds:
        take = min(cfg.run.rounds_per_step, cfg.fed.rounds - rnd)
        if take not in steps:
            steps[take] = exp.make_step(take)
        t0 = time.perf_counter()
        state, raw = steps[take](state, batch)
        loss_c, conf_c = raw["loss"].cpu(), raw["conf"].cpu()   # syncs
        dt = (time.perf_counter() - t0) / take
        m_all = assemble_metrics(loss_c, conf_c, mask_host)

        for j in range(take):
            r = rnd + j
            client_mean = {k: float(m_all["client_mean"][k][j])
                           for k in METRIC_NAMES}
            per_client = {k: m_all["per_client"][k][j].numpy()
                          for k in METRIC_NAMES}
            losses.append(loss_c[j].numpy())
            confusion.append(conf_c[j].numpy())
            sec_per_round.append(dt)
            rounds_run = r + 1
            for k in METRIC_NAMES:
                history[k].append(client_mean[k])
                pooled_hist[k].append(float(m_all["pooled"][k][j]))
                per_client_hist[k].append(per_client[k])

            if r % cfg.run.log_every == 0:
                say(f"\nRound {r + 1}:\n")
                if cfg.run.log_per_client:
                    for c in range(cfg.shard.num_clients):
                        vals = ", ".join(f"{k}: {per_client[k][c]:.4f}"
                                         for k in METRIC_NAMES)
                        say(f"  CLIENT {c} - Local Metrics "
                            f"(Round {r + 1}): [{vals}]")
                gvals = ", ".join(f"{k}: {client_mean[k]:.4f}"
                                  for k in METRIC_NAMES)
                say(f"  Global Metrics (Round {r + 1}): [{gvals}]  "
                    f"({dt * 1e3:.1f} ms/round)")

            cur = [client_mean[k] for k in METRIC_NAMES]
            if cfg.run.halt_on_nonfinite and not (
                    np.all(np.isfinite(cur))
                    and np.all(np.isfinite(losses[-1]))):
                say(f"Non-finite loss/metrics at round {r + 1}; halting "
                    "(diverged run).")
                stopped_early = diverged = True
                break

            # Early stopping — exact reference logic (FL_CustomMLP...:181-192).
            if prev_metric is not None and np.allclose(
                    cur, prev_metric, atol=cfg.fed.tolerance):
                termination_count -= 1
                if termination_count == 0:
                    say("Early stopping triggered: No significant change in "
                        f"metrics for {cfg.fed.termination_patience} rounds.")
                    if r + 1 < cfg.fed.rounds:
                        say(f"Training stopped early at round {r + 1}.")
                    stopped_early = True
                    break
            else:
                prev_metric = cur
                termination_count = cfg.fed.termination_patience
        rnd += take
        # Chunk-end state check, early stop included: metrics can stay
        # finite for a round after params go non-finite (the reported loss
        # is pre-update).
        if not diverged and cfg.run.halt_on_nonfinite \
                and not _state_finite(state):
            say(f"Non-finite params/optimizer state after round {rnd}; "
                "halting (diverged run).")
            stopped_early = diverged = True
        if stopped_early:
            break

        # Held-out eval at chunk ends; every due round inside the chunk gets
        # an entry (they share the chunk-end params), as in fedtpu.
        eval_due = cfg.run.eval_test_every and sum(
            1 for j in range(take) if (rnd - j) % cfg.run.eval_test_every == 0)
        if eval_due:
            tm = exp.eval_step(global_params(state), x_test, y_test)
            tm = {k: float(v) for k, v in tm.items()}
            for _ in range(eval_due):
                for k in METRIC_NAMES:
                    test_hist[k].append(tm[k])

    return ExperimentResult(
        global_metrics=history, pooled_metrics=pooled_hist,
        per_client_metrics=per_client_hist, test_metrics=test_hist,
        loss=losses, sec_per_round=sec_per_round, rounds_run=rounds_run,
        stopped_early=stopped_early,
        final_params=params_to_numpy(global_params(state), exp.dims),
        config=cfg, diverged=diverged, confusion=confusion)
