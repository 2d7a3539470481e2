"""The federated hyperparameter grid (``fedtpu.sweep.grid``, the
reference's ``hyperparameters_tuning.py``) and the sweep's weights artifact.

Reference semantics (hyperparameters_tuning.py:68-132): 10 hidden-layer
combos x 9 learning rates = 90 configs; per config every client fits a
fresh ``MLPClassifier(max_iter=400, random_state=42)`` on its shard, its
metrics are taken BEFORE averaging, the weights are averaged uniformly over
the clients, the pooled metrics come from every client's predictions, and
the best pooled accuracy wins (strict ``>``, first in grid order).

The port runs ``fedtpu``'s launch plan on one flat buffer:

* A launch trains ``S`` slots (its architectures x its learning rates,
  arch-major) on every one of the ``C`` clients at once: params ``(C, S,
  P)``, i.e. ``C*S`` independent models of the launch's (bucket) dims.
  Client ``c``'s shard serves all ``S`` of its slots (copied once a launch
  into a ``(C*S, N, in)`` batch).
* Each model takes ``local_steps`` full-batch steps of
  ``ops.optim.build_sweep_adam`` (optax's ``scale_by_adam`` and ``p - lr *
  u``, one rate a slot, no StepLR), the forward and backward through
  ``torch.matmul`` and autograd as the round's train step.
  ``plateau_stop`` is sklearn's early stop: a stopped model's whole carry
  is frozen with ``torch.where``, with no host read inside the step loop.
* The eval of the trained, not yet averaged models is K2
  (``fused_eval_confusion``) over the ``C*S`` models, and the uniform mean
  over clients of every slot is one launch of K1 (``weighted_average_
  clients``) on ``(C, S*P)`` with unit weights.
* Bucket padding (each architecture zero-padded to its depth class's
  elementwise max, after its init at true shape) is exact for a ReLU MLP:
  padded activations stay 0, ReLU'(0) = 0 kills their gradients, Adam on
  zero gradients leaves zero weights zero, and the L2 term adds 0. With
  ``vmap_arch`` each depth class is one launch: the reference grid is 2.

``fedtpu`` compiles one XLA program a launch (``compile_count``) and may
compile the next while one runs (``overlap_compile``); the port has no
program to compile (its kernels build on first use), so ``compile_count``
is None and ``overlap_compile`` changes nothing. The init is the port's own
draw (a ``torch.Generator`` seeded 42, ``nn.Linear``'s law, as
``fedtpu``'s ``mlp_init`` with ``jax.random.key(42)``); ``init_params``
injects ``fedtpu``'s. Telemetry as ``fedtpu``'s grid: with
``RunConfig.telemetry.events_path`` set, the sink gets the manifest, one
``launch`` span a launch (closed after the launch's host read), the
``counters`` snapshot (``sweep_launches``, ``sweep_configs``, in a
registry of the sweep's own) and ``sweep_end``; ``launch_times`` keeps each
launch's wall and device seconds beside them.

The weights artifact is ``fedtpu``'s ``.npz``: each layer's ``w`` (in,
out) and ``b`` as ``layers.<i>.w`` / ``layers.<i>.b``, and a JSON ``meta``
(hyperparameters, metrics, accuracy) as bytes. Either package reads what
the other wrote.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from fedtpu_torch.config import ExperimentConfig, OptimConfig
from fedtpu_torch.convert import params_from_jax, params_to_numpy
from fedtpu_torch.data import load_dataset
from fedtpu_torch.data.sharding import pack_clients
from fedtpu_torch.data.tabular import Dataset
from fedtpu_torch.models.mlp import (layer_dims, mlp_apply, mlp_init,
                                     unflatten)
from fedtpu_torch.ops.cuda_kernels import (fused_eval_confusion,
                                           weighted_average_clients)
from fedtpu_torch.ops.losses import masked_cross_entropy
from fedtpu_torch.ops.metrics import metrics_from_confusion
from fedtpu_torch.ops.optim import build_sweep_adam

# hyperparameters_tuning.py:73-74, verbatim grid.
HIDDEN_GRID = ((50,), (100,), (50, 50), (100, 50), (50, 100), (50, 200),
               (50, 400), (100, 400), (400, 200), (200, 400))
LR_GRID = (0.002, 0.005, 0.004, 0.008, 0.01, 0.02, 0.05, 0.1, 0.2)


def build_sweep_fn(num_classes: int, local_steps: int, optim_cfg: OptimConfig,
                   plateau_stop: bool = False, tol: float = 1e-4,
                   n_iter_no_change: int = 10,
                   l2_alpha: float = 0.0) -> Callable:
    """``fedtpu``'s ``_build_sweep_fn``: returns ``sweep(params, opt_state,
    lrs, x, y, mask, dims, inspect=None) -> (avg_params (S, P), conf (C, S,
    K, K), pooled_conf (S, K, K), mean_steps (S,))`` for params ``(C, S,
    P)`` of ``dims``, ``build_sweep_adam`` state of the same layout, ``lrs
    (S,)`` float32 and the clients' ``x (C, N, in)``, ``y (C, N)``, ``mask
    (C, N)``: every (client, slot) model trained for up to ``local_steps``
    full-batch steps, evaluated on its client's shard (K2 on the card),
    then averaged uniformly over the clients per slot (K1 on the card).

    ``plateau_stop``: sklearn's ``max_iter`` as a cap (``_update_no_
    improvement_count``): ``best`` starts at +inf, a step is worse when its
    loss exceeds ``best - tol``, the counter resets on an improvement, and
    a model stops once the counter exceeds ``n_iter_no_change``; a stopped
    model's params, moments, count and bookkeeping are frozen, and
    ``mean_steps`` counts the steps the clients ran. ``l2_alpha``: sklearn's
    ``0.5 * alpha * sum(w^2) / max(n_samples, 1)`` on the weights (not the
    biases), in the loss the plateau watches and in the gradient.
    ``inspect``, if given, is called with the launch's device tensors
    (``trained (C*S, P)``, its ``x``, ``y``, ``mask`` per model, ``conf
    (C*S, K, K)``, ``avg (S*P,)``, ``steps (C*S,)`` and, in plateau mode,
    ``margin (local_steps, C*S)``: each step's loss minus the bar ``best -
    tol``, > 0 a step without improvement) before they are dropped."""
    adam = build_sweep_adam(optim_cfg)

    def sweep(params, opt_state, lrs, x, y, mask, dims, inspect=None):
        c, s, p = params.shape
        m = c * s
        dims = tuple(dims)
        # Client c's shard serves its S slots: one (C*S, N, ...) copy.
        xm = x.unsqueeze(1).expand(c, s, *x.shape[1:]).reshape(
            m, *x.shape[1:])
        ym = y.unsqueeze(1).expand(c, s, -1).reshape(m, -1)
        maskm = mask.unsqueeze(1).expand(c, s, -1).reshape(m, -1)
        lr = lrs.to(torch.float32).repeat(c)[:, None]          # (M, 1)
        n_rows = maskm.sum(dim=-1).clamp_min(1.0)

        def loss_and_grad(q):
            q = q.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = masked_cross_entropy(
                    mlp_apply(unflatten(q, dims), xm), ym, maskm)
                if l2_alpha > 0.0:
                    sq = sum(torch.square(lyr["w"]).sum(dim=(-2, -1))
                             for lyr in unflatten(q, dims)["layers"])
                    loss = loss + 0.5 * l2_alpha * sq / n_rows
                (grads,) = torch.autograd.grad(loss.sum(), q)
            return loss.detach(), grads

        q = params.reshape(m, p)
        st = {k: v.reshape(m, *v.shape[2:]) for k, v in opt_state.items()}
        if plateau_stop:
            best = torch.full((m,), float("inf"), device=q.device)
            no_imp = torch.zeros(m, dtype=torch.int32, device=q.device)
            active = torch.ones(m, dtype=torch.bool, device=q.device)
            steps = torch.zeros(m, dtype=torch.int32, device=q.device)
            margins = []
            for _ in range(local_steps):
                loss, grads = loss_and_grad(q)
                if inspect is not None:
                    margins.append(loss - (best - tol))
                q_new, st_new = adam.update(grads, st, q, lr)
                # A stopped model's whole carry is frozen.
                q = torch.where(active[:, None], q_new, q)
                st = {k: torch.where(active.view(-1, *[1] * (v.dim() - 1)),
                                     st_new[k], v) for k, v in st.items()}
                worse = loss > best - tol
                no_imp = torch.where(
                    active, torch.where(worse, no_imp + 1, 0), no_imp)
                best = torch.where(active, torch.minimum(best, loss), best)
                steps = steps + active.to(torch.int32)
                active = active & (no_imp <= n_iter_no_change)
        else:
            for _ in range(local_steps):
                _, grads = loss_and_grad(q)
                q, st = adam.update(grads, st, q, lr)
            steps = torch.full((m,), local_steps, dtype=torch.int32,
                               device=q.device)
        q = q.detach().contiguous()
        conf = fused_eval_confusion(q, dims, xm, ym, maskm, num_classes)
        # Uniform mean over the clients of every slot: one K1 launch.
        avg = weighted_average_clients(
            q.view(c, s * p), torch.ones(c, dtype=torch.float32,
                                         device=q.device))
        if inspect is not None:
            inspect({"trained": q, "x": xm, "y": ym, "mask": maskm,
                     "conf": conf, "avg": avg, "steps": steps,
                     **({"margin": torch.stack(margins)}
                        if plateau_stop and margins else {})})
        conf = conf.view(c, s, num_classes, num_classes)
        mean_steps = steps.view(c, s).sum(dim=0).to(torch.float32) / c
        return avg.view(s, p), conf, conf.sum(dim=0), mean_steps

    return sweep


def _bucket_shape(hidden, hidden_grid) -> tuple:
    """Elementwise max over the grid's same-depth entries: the padded
    shape every architecture of this depth runs at."""
    same_depth = [h for h in hidden_grid if len(h) == len(hidden)]
    return tuple(max(h[i] for h in same_depth) for i in range(len(hidden)))


def _pad_params(params: dict, input_dim: int, hidden, bucket,
                num_classes: int) -> dict:
    """Zero-pad a ``fedtpu``-layout params pytree (numpy) from ``hidden``
    dims to ``bucket`` dims (input/output dims unchanged)."""
    dims = [input_dim, *hidden, num_classes]
    bdims = [input_dim, *bucket, num_classes]
    layers = []
    for i, lyr in enumerate(params["layers"]):
        w, b = np.asarray(lyr["w"]), np.asarray(lyr["b"])
        layers.append({
            "w": np.pad(w, ((0, bdims[i] - dims[i]),
                            (0, bdims[i + 1] - dims[i + 1]))),
            "b": np.pad(b, (0, bdims[i + 1] - dims[i + 1])),
        })
    return {"layers": layers}


def _unpad_params(params: dict, input_dim: int, hidden, num_classes: int
                  ) -> dict:
    """Slice a bucket-padded params pytree back to its true dims."""
    dims = [input_dim, *hidden, num_classes]
    return {"layers": [
        {"w": np.asarray(lyr["w"])[:dims[i], :dims[i + 1]],
         "b": np.asarray(lyr["b"])[:dims[i + 1]]}
        for i, lyr in enumerate(params["layers"])]}


def _init_model(hidden, bucket, ds: Dataset, init_params) -> torch.Tensor:
    """One architecture's ``(P,)`` start at the bucket's dims: the injected
    ``fedtpu`` draw, else the port's own (seed 42), padded after the init
    at true shape."""
    if init_params is not None:
        tree = init_params[tuple(hidden)]
    else:
        gen = torch.Generator().manual_seed(42)
        tree = params_to_numpy(
            mlp_init(gen, ds.input_dim, hidden, ds.num_classes),
            layer_dims(ds.input_dim, hidden, ds.num_classes))
    if tuple(bucket) != tuple(hidden):
        tree = _pad_params(tree, ds.input_dim, hidden, bucket,
                           ds.num_classes)
    return params_from_jax(tree)


def launch_inputs(archs, lr_group, bucket, ds: Dataset, num_clients: int,
                  optim_cfg: OptimConfig, device, init_params=None) -> tuple:
    """One launch's ``(params (C, S, P), opt_state, lrs (S,), dims)`` on
    ``device``: each architecture's one init (the same for every client
    and rate) at the bucket's dims, arch-major over the slots."""
    dims = layer_dims(ds.input_dim, bucket, ds.num_classes)
    slabs = torch.stack([_init_model(h, bucket, ds, init_params)
                         for h in archs]).to(device)
    params = slabs.repeat_interleave(len(lr_group), dim=0).unsqueeze(
        0).expand(num_clients, len(archs) * len(lr_group), -1).contiguous()
    lrs = torch.tensor(list(lr_group) * len(archs), dtype=torch.float32,
                       device=device)
    return params, build_sweep_adam(optim_cfg).init(params), lrs, dims


def run_grid_search(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                    hidden_grid=None, lr_grid=None,
                    local_steps: int = 400, vmap_lr: bool = True,
                    keep_weights: bool = False,
                    plateau_stop: bool = False,
                    bucket_pad: bool = True,
                    vmap_arch: bool = True,
                    tie_tolerance: float = 1e-6,
                    overlap_compile: bool = True,
                    verbose: bool = True, device="cuda",
                    init_params: Optional[dict] = None,
                    inspect_launch: Optional[Callable] = None) -> dict:
    """Run the federated grid (``fedtpu``'s ``run_grid_search``: the same
    arguments, defaults, launch plan, table, winner, tie set and printed
    lines); returns the best-config summary.

    ``keep_weights``: keep the winner's averaged weights (numpy, true dims)
    under ``"weights"`` for ``save_best_weights``. ``plateau_stop``:
    sklearn's early stop with its default L2 alpha 1e-4 (``build_sweep_fn``);
    each row then carries the clients' mean steps. ``bucket_pad`` /
    ``vmap_arch`` / ``vmap_lr``: the launch plan (2 launches for the
    reference grid; one per architecture without ``vmap_arch``; one per
    (architecture, rate) with ``vmap_lr=False``). ``overlap_compile`` is
    accepted and changes nothing here. The winner is the strict-``>`` first
    hit in grid order; ``tie_set`` holds every config within
    ``tie_tolerance`` of the top accuracy.

    The port's own arguments: ``device``; ``init_params``, a ``{hidden
    tuple: fedtpu params pytree (numpy)}`` mapping injected in place of the
    seeded init; ``inspect_launch``, called after each launch with its index,
    architectures, rates, bucket dims and ``build_sweep_fn``'s device
    tensors. ``launch_times`` lists each launch's host wall time and, on the
    card, its device time (CUDA events, the window closed by the host's
    read of its metrics)."""
    from fedtpu_torch.orchestration.loop import resolve_device
    from fedtpu_torch.parallel.mesh import make_mesh
    from fedtpu_torch.telemetry.log import TelemetryLogger
    from fedtpu_torch.telemetry.manifest import build_manifest
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    from fedtpu_torch.telemetry.trace import make_tracer
    del overlap_compile          # no program to compile (module docstring)
    hidden_grid = HIDDEN_GRID if hidden_grid is None else hidden_grid
    lr_grid = LR_GRID if lr_grid is None else lr_grid
    dev = resolve_device(device)
    tel = cfg.run.telemetry
    tracer = make_tracer(tel.events_path)
    # The sweep's own registry, as fedtpu's: a run loop's reset of the
    # default one must not wipe it.
    registry = MetricsRegistry()
    log = TelemetryLogger(verbose=verbose, tracer=tracer,
                          level=tel.log_level)

    ds = dataset if dataset is not None else load_dataset(cfg.data)
    if tel.manifest:
        tracer.event("manifest", **build_manifest(
            cfg=cfg, mesh=make_mesh(cfg.run.mesh_devices,
                                    cfg.shard.num_clients, dev),
            device=dev, extra={"program": "sweep",
                               "grid_size": len(hidden_grid) * len(lr_grid)}))
    packed = pack_clients(ds.x_train, ds.y_train, cfg.shard)
    x = torch.from_numpy(packed.x).to(dev)
    y = torch.from_numpy(packed.y).to(dev)
    mask = torch.from_numpy(packed.mask).to(dev)
    c = cfg.shard.num_clients
    sweep_fn = build_sweep_fn(ds.num_classes, local_steps, cfg.optim,
                              plateau_stop=plateau_stop,
                              l2_alpha=1e-4 if plateau_stop else 0.0)

    # Each launch trains a list of same-bucket architectures x a list of
    # learning rates, the (arch, lr) product arch-major in the slot axis.
    if vmap_arch and vmap_lr and bucket_pad:
        classes: dict = {}
        for h in hidden_grid:
            classes.setdefault(len(h), []).append(h)
        launches = [(archs, list(lr_grid)) for archs in classes.values()]
    else:
        lr_groups = [list(lr_grid)] if vmap_lr else [[lr] for lr in lr_grid]
        launches = [([h], g) for h in hidden_grid for g in lr_groups]

    # (hidden, lr) -> row. Each launch keeps the weights of its first slot
    # at the launch's max accuracy, the only one of its slots the global
    # strict-> winner can be, so no launch's device output outlives it.
    results: dict = {}
    launch_times = []
    for n_launch, (archs, lr_group) in enumerate(launches):
        t0 = time.perf_counter()
        l = len(lr_group)
        sp_launch = tracer.span("launch", round=n_launch + 1,
                                architectures=len(archs),
                                learning_rates=l)
        bucket = (_bucket_shape(archs[0], hidden_grid) if bucket_pad
                  else tuple(archs[0]))
        params, opt_state, lrs, dims = launch_inputs(
            archs, lr_group, bucket, ds, c, cfg.optim, dev, init_params)
        held = {}
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        avg_params, conf, pooled_conf, mean_steps = sweep_fn(
            params, opt_state, lrs, x, y, mask, dims,
            inspect=held.update if inspect_launch is not None else None)
        del params, opt_state, conf
        pooled = metrics_from_confusion(pooled_conf)
        if events is not None:
            events[1].record()
        # Sorted by name, as fedtpu's metrics come out of its jit (its
        # printed and saved metrics dicts list them in that order).
        pooled = {k: pooled[k].cpu().numpy() for k in sorted(pooled)}
        mean_steps = mean_steps.cpu().numpy()
        cand = int(np.argmax(pooled["accuracy"]))   # first slot at launch max
        for a, hidden in enumerate(archs):
            for j, lr in enumerate(lr_group):
                i = a * l + j
                w = None
                if i == cand:
                    w = params_to_numpy(avg_params[i], dims)
                    if bucket != tuple(hidden):
                        w = _unpad_params(w, ds.input_dim, hidden,
                                          ds.num_classes)
                results[(tuple(hidden), float(lr))] = {
                    "metrics": {k: float(v[i]) for k, v in pooled.items()},
                    "mean_local_steps": float(mean_steps[i]),
                    "win": w,
                }
        # The host reads above finished the launch's device work.
        sp_launch.end(launch_max_accuracy=float(pooled["accuracy"].max()))
        registry.counter("sweep_launches").inc()
        registry.counter("sweep_configs").inc(len(archs) * l)
        launch_times.append({
            "architectures": len(archs), "learning_rates": l,
            "models": c * len(archs) * l, "wall_s": time.perf_counter() - t0,
            "device_s": (events[0].elapsed_time(events[1]) / 1e3
                         if events is not None else None)})
        if inspect_launch is not None:
            inspect_launch({"index": n_launch, "architectures": list(archs),
                            "learning_rates": list(lr_group),
                            "bucket": bucket, "dims": dims, **held})
        del avg_params, pooled_conf, held
        log.info(f"  launch {n_launch + 1}/{len(launches)} done "
                 f"({len(archs)} architectures x {l} learning rates)")

    # Reported in the reference's grid order (hidden outer, lr inner), so
    # the first-hit strict-> winner does not depend on the launch plan.
    best = {"accuracy": -1.0, "params": None, "metrics": None,
            "weights": None}
    table = []
    for hidden in hidden_grid:
        for lr in lr_grid:
            row = results[(tuple(hidden), float(lr))]
            metrics = row["metrics"]
            table.append({"hidden_layer_sizes": tuple(hidden),
                          "learning_rate": float(lr),
                          "mean_local_steps": row["mean_local_steps"],
                          **metrics})
            log.info(f"  grid [{hidden} lr={lr}]: "
                     f"acc={metrics['accuracy']:.4f} "
                     f"f1={metrics['f1']:.4f}")
            if metrics["accuracy"] > best["accuracy"]:
                best = {
                    "accuracy": metrics["accuracy"],
                    "params": {"hidden_layer_sizes": tuple(hidden),
                               "learning_rate": float(lr)},
                    "metrics": metrics,
                    "weights": None,
                }
    # The winner is its own launch's first slot at that launch's max: one
    # of the slots whose weights were kept above.
    winner_key = (tuple(best["params"]["hidden_layer_sizes"]),
                  best["params"]["learning_rate"])
    best["weights"] = results[winner_key]["win"]
    assert best["weights"] is not None
    _drop_nonwinning_weights(results, winner_key)

    # The tie set: the stable answer where several configs share the top
    # accuracy (tie_tolerance sits above float drift and below one
    # sample's accuracy quantum).
    top = best["accuracy"]
    tie_set = []
    for row in table:
        tied = row["accuracy"] >= top - tie_tolerance
        row["in_tie_set"] = tied
        if tied:
            tie_set.append({"hidden_layer_sizes": row["hidden_layer_sizes"],
                            "learning_rate": row["learning_rate"],
                            "accuracy": row["accuracy"]})

    # The reference's own two lines (hyperparameters_tuning.py:126-129).
    log.parity(f"\nBest Global Hyperparameters: {best['params']}")
    log.parity(f"Best Global Metrics: {best['metrics']}")
    if len(tie_set) > 1:
        log.info(f"Tie set ({len(tie_set)} configs within "
                 f"{tie_tolerance:g} of accuracy {top:.4f} — the strict-> "
                 "winner above is one arbitrary member):")
        for t in tie_set:
            log.info(f"  {t['hidden_layer_sizes']} "
                     f"lr={t['learning_rate']}")
    weights = best["weights"] if keep_weights else best.pop("weights")
    best["weight_shapes"] = ([list(lyr["w"].shape)
                              for lyr in weights["layers"]]
                             if weights else [])
    best["table"] = table
    best["tie_set"] = tie_set
    best["tie_tolerance"] = tie_tolerance
    best["launch_count"] = len(launches)
    best["compile_count"] = None
    best["launch_times"] = launch_times
    tracer.counters(registry.snapshot())
    tracer.event("sweep_end", best_accuracy=best["accuracy"],
                 launch_count=best["launch_count"],
                 tie_set_size=len(tie_set))
    tracer.close()
    return best


def _drop_nonwinning_weights(results: dict, winner_key) -> int:
    """Null out the kept ``win`` weights of every non-winning row; returns
    how many copies were dropped."""
    dropped = 0
    for key, row in results.items():
        if key != winner_key and row.get("win") is not None:
            row["win"] = None
            dropped += 1
    return dropped


def save_best_weights(path: str, best: dict) -> None:
    """Write ``best`` (``{"weights": {"layers": [{"w", "b"}, ...]},
    "params": {"hidden_layer_sizes", "learning_rate"}, "metrics",
    "accuracy"}``) as one ``.npz`` at exactly ``path``."""
    weights = best.get("weights")
    if not weights:
        raise ValueError("best has no weights — run run_grid_search with "
                         "keep_weights=True")
    arrays = {}
    for i, lyr in enumerate(weights["layers"]):
        arrays[f"layers.{i}.w"] = np.asarray(lyr["w"])
        arrays[f"layers.{i}.b"] = np.asarray(lyr["b"])
    arrays["meta"] = np.frombuffer(json.dumps(
        {"params": {"hidden_layer_sizes":
                    list(best["params"]["hidden_layer_sizes"]),
                    "learning_rate": best["params"]["learning_rate"]},
         "metrics": best["metrics"],
         "accuracy": best["accuracy"]}).encode(), dtype=np.uint8)
    # Through a file handle: np.savez(str) would append ".npz" to a path
    # without that suffix.
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_best_weights(path: str) -> dict:
    """Inverse of ``save_best_weights``: ``{"weights": {"layers": [{"w",
    "b"}, ...]}, "params": ..., "metrics": ..., "accuracy": ...}``, numpy
    leaves in ``fedtpu``'s layout (``fedtpu_torch.convert``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        n_layers = sum(1 for k in z.files if k.endswith(".w"))
        layers = [{"w": z[f"layers.{i}.w"], "b": z[f"layers.{i}.b"]}
                  for i in range(n_layers)]
    return {"weights": {"layers": layers}, **meta}
