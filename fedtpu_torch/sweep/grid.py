"""The sweep's weights artifact (``fedtpu.sweep.grid``'s
``save_best_weights`` / ``load_best_weights``), in ``fedtpu``'s ``.npz``
format: each layer's ``w`` (in, out) and ``b`` as ``layers.<i>.w`` /
``layers.<i>.b``, and a JSON ``meta`` (hyperparameters, metrics, accuracy)
as bytes. Either package reads what the other wrote. The grid search itself
is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import json

import numpy as np


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
