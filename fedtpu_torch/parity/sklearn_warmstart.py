"""The sklearn ``MLPClassifier`` warm-start limitation, demonstrated and
fixed (``fedtpu.parity.sklearn_warmstart``).

The reference script FL_SkLearn_MLPClassifier_Limitation.py applies the
global averaged weights to each local model (:95-98) and then calls
``fit`` (:101), which re-initialises the parameters: federated averaging
never influences training. That is the titular limitation.

Part A reproduces it with N sequential host clients and a uniform mean of
their weights at the "root" (:108-122), on the port's numpy
``MLPClassifier`` (``fedtpu_torch.parity.mlp_classifier``: scikit-learn's
arithmetic, without scikit-learn), on the host. Part B runs the same
configuration through the port's own round (``run_experiment``, on the
card unless ``device="cpu"``), where local training continues from the
averaged params. The summary has ``fedtpu``'s keys, and the reference's
"Final Global Weight Statistics" lines are printed byte for byte as
``fedtpu`` prints them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from fedtpu_torch.config import ExperimentConfig
from fedtpu_torch.data import load_dataset
from fedtpu_torch.data.sharding import shard_indices
from fedtpu_torch.data.tabular import Dataset
from fedtpu_torch.ops.metrics import METRIC_NAMES
from fedtpu_torch.parity.mlp_classifier import MLPClassifier


def _prf_divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` in float64, 0 where ``den`` is 0 (``zero_division=0``)."""
    den = np.asarray(den, dtype=np.float64).copy()
    zero = den == 0
    den[zero] = 1
    out = np.asarray(num, dtype=np.float64) / den
    out[zero] = 0.0
    return out


def _weighted(values: np.ndarray, weights: np.ndarray) -> float:
    w = weights.astype(np.float64)
    return float(np.sum(values * w) / np.sum(w))


def _sklearn_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    """scikit-learn's accuracy and support-weighted precision, recall and
    f1 with ``zero_division=0`` (the reference's ``_compute_metrics``,
    FL_SkLearn...:56-66), in numpy: per label of the sorted union of the
    true and predicted labels, the same float64 divisions."""
    labels = np.union1d(y_true, y_pred)
    idx_t = np.searchsorted(labels, y_true)
    idx_p = np.searchsorted(labels, y_pred)
    k = len(labels)
    tp_sum = np.bincount(idx_t[y_true == y_pred], minlength=k)
    pred_sum = np.bincount(idx_p, minlength=k)
    true_sum = np.bincount(idx_t, minlength=k)
    precision = _prf_divide(tp_sum, pred_sum)
    recall = _prf_divide(tp_sum, true_sum)
    f1 = _prf_divide(2.0 * tp_sum.astype(np.float64),
                     1.0 * true_sum.astype(np.float64)
                     + pred_sum.astype(np.float64))
    return {"accuracy": float(np.mean((y_true == y_pred)
                                      .astype(np.float64))),
            "precision": _weighted(precision, true_sum),
            "recall": _weighted(recall, true_sum),
            "f1": _weighted(f1, true_sum)}


def run_sklearn_rounds(ds: Dataset, cfg: ExperimentConfig,
                       max_iter: int = 300, verbose: bool = True) -> dict:
    """Part A: the limitation, reproduced. Returns per-round pooled metrics
    plus a weight fingerprint per round showing that ``fit`` discarded the
    applied global weights. The ``[sklearn] round r`` lines are printed
    when ``verbose``, the parity lines too."""
    say = print if verbose else (lambda *_: None)
    idx = shard_indices(ds.y_train, cfg.shard)
    shards = [(ds.x_train[i], ds.y_train[i]) for i in idx]
    classes = np.unique(ds.y_train)

    # partial_fit once to materialise coefs_/intercepts_ (FL_SkLearn...:84).
    models = []
    for x, y in shards:
        m = MLPClassifier(activation="relu",
                          hidden_layer_sizes=tuple(cfg.model.hidden_sizes),
                          learning_rate_init=cfg.optim.learning_rate,
                          max_iter=max_iter, random_state=42)
        m.partial_fit(x, y, classes=classes)
        models.append(m)

    global_weights = None
    pooled_hist = {k: [] for k in METRIC_NAMES}
    fit_fingerprints = []
    for rnd in range(cfg.fed.rounds):
        all_true, all_pred = [], []
        for m, (x, y) in zip(models, shards):
            if rnd > 0 and global_weights is not None:
                # Apply the global weights (FL_SkLearn...:95-98)...
                split = len(m.coefs_)
                m.coefs_ = [w.copy() for w in global_weights[:split]]
                m.intercepts_ = [w.copy() for w in global_weights[split:]]
            # ...which fit() re-initialises (:101): the limitation.
            m.fit(x, y)
            all_true.append(y)
            all_pred.append(m.predict(x))
        # Uniform mean per layer at the "root" (:108-122).
        stacks = [m.coefs_ + m.intercepts_ for m in models]
        global_weights = [np.mean(layer, axis=0) for layer in zip(*stacks)]
        pooled = _sklearn_metrics(np.concatenate(all_true),
                                  np.concatenate(all_pred))
        for k in METRIC_NAMES:
            pooled_hist[k].append(pooled[k])
        # A deterministic re-init (random_state=42) makes every round's
        # post-fit weights identical if averaging has no effect.
        fit_fingerprints.append(float(sum(np.abs(w).sum()
                                          for w in models[0].coefs_)))
        say(f"[sklearn] round {rnd + 1}: pooled "
            + ", ".join(f"{k}={pooled[k]:.4f}" for k in METRIC_NAMES))

    # The reference's final "Global Weight Statistics" report
    # (FL_SkLearn_MLPClassifier_Limitation.py:146-150), byte for byte.
    weight_stats = [{"shape": list(np.shape(w)), "mean": float(np.mean(w)),
                     "std": float(np.std(w))}
                    for w in (global_weights or [])]
    if weight_stats:
        say("\nFinal Global Weight Statistics:")
        for i, st in enumerate(weight_stats):
            say(f"Layer {i + 1} - Shape: {tuple(st['shape'])}")
            say(f"Mean: {st['mean']:.6f}, Std: {st['std']:.6f}")

    fp = np.asarray(fit_fingerprints)
    return {
        "pooled_metrics": pooled_hist,
        "fit_fingerprints": fit_fingerprints,
        "global_weight_stats": weight_stats,
        # True: fit() gave the same weights every round despite the global
        # weights applied in between; averaging had no effect.
        "limitation_demonstrated": bool(np.allclose(fp, fp[0], rtol=1e-6)),
    }


def run_parity_demo(cfg: ExperimentConfig, dataset: Optional[Dataset] = None,
                    sklearn_max_iter: int = 300, verbose: bool = True,
                    device="cuda", init_params=None) -> dict:
    """Parts A and B; returns both trajectories and the verdicts, under
    ``fedtpu``'s keys. ``device`` and ``init_params`` are part B's
    (``run_experiment``'s)."""
    ds = dataset if dataset is not None else load_dataset(cfg.data)
    sk = run_sklearn_rounds(ds, cfg, max_iter=sklearn_max_iter,
                            verbose=verbose)

    # Part B: the same configuration through the port's round, where each
    # round's local training continues from the averaged params.
    from fedtpu_torch.orchestration.loop import run_experiment
    tcfg = cfg.replace(fed=dataclasses.replace(cfg.fed, weighting="uniform"))
    result = run_experiment(tcfg, dataset=ds, verbose=verbose, device=device,
                            init_params=init_params)
    # The same per-layer report on the final global params, w then b per
    # layer (sklearn's coefs_ + intercepts_ order).
    layers = result.final_params["layers"]
    flat = ([np.asarray(lyr["w"]) for lyr in layers]
            + [np.asarray(lyr["b"]) for lyr in layers])
    stats = [{"shape": list(w.shape), "mean": float(w.mean()),
              "std": float(w.std())} for w in flat]
    return {
        "sklearn": {k: sk[k] for k in ("pooled_metrics",
                                       "limitation_demonstrated",
                                       "global_weight_stats")},
        "fedtpu": {"pooled_metrics": result.pooled_metrics,
                   "rounds_run": result.rounds_run,
                   "global_weight_stats": stats},
        "limitation_demonstrated": sk["limitation_demonstrated"],
        # In the port's round, averaging feeds the next round.
        "fedtpu_uses_global_weights": True,
    }
