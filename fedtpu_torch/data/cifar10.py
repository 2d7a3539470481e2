"""CIFAR-10 for the ConvNet stress config (``fedtpu.data.cifar10``), numpy
only.

Reads the standard CIFAR-10 python pickle batches (``cifar-10-batches-py``)
from a local directory where they exist; nothing is fetched. Without them it
makes a deterministic synthetic image set of CIFAR's shapes from a seed,
bitwise ``fedtpu``'s (seeded numpy on both sides), so packing, sharding and
the ConvNet's FedAvg run the same either way.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from fedtpu_torch.data.tabular import Dataset

# Looked up relative to the working directory, in this order.
_CANDIDATES = ("cifar-10-batches-py", "data/cifar-10-batches-py")


def find_cifar10_dir(root: Optional[str] = None) -> Optional[str]:
    for cand in ((root,) if root else _CANDIDATES):
        if cand and os.path.isdir(cand) and \
                os.path.exists(os.path.join(cand, "data_batch_1")):
            return cand
    return None


def _load_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # The batches are pickles of CIFAR-10's own distribution, read only
    # from a directory the user placed them in.
    with open(path, "rb") as f:
        blob = pickle.load(f, encoding="bytes")
    x = blob[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    y = np.asarray(blob[b"labels"], np.int32)
    return x, y


def synthetic_cifar_like(rows: int, seed: int = 11,
                         image_shape=(32, 32, 3), classes: int = 10,
                         center_scale: float = 0.12,
                         noise_std: float = 0.5,
                         label_noise: float = 0.15):
    """Class-conditioned Gaussian blobs with label noise, ``fedtpu``'s
    generator and defaults: deterministic, CIFAR-shaped and not separable.
    ``center_scale`` sets the class overlap (pairwise center distance about
    ``center_scale * sqrt(2 * dim)`` against per-direction noise std
    ``noise_std``); ``label_noise`` re-draws that fraction of labels
    uniformly (the true one possibly again), which caps the reachable
    accuracy below 1.0."""
    rng = np.random.default_rng(seed)
    y = np.arange(rows) % classes
    rng.shuffle(y)
    h, w, ch = image_shape
    centers = rng.normal(0.0, center_scale, size=(classes, h, w, ch))
    x = centers[y] + rng.normal(0.0, noise_std, size=(rows, h, w, ch))
    y_obs = y.copy()
    if label_noise > 0:
        flip = rng.random(rows) < label_noise
        y_obs[flip] = rng.integers(0, classes, int(flip.sum()))
    return x.astype(np.float32), y_obs.astype(np.int32)


def load_cifar10(root: Optional[str] = None, flatten: bool = True,
                 synthetic_rows: int = 4096) -> Dataset:
    """CIFAR-10's train/test split (real where the pickle batches exist
    locally, synthetic otherwise; the last fifth of the synthetic rows is
    the test set). ``flatten=True`` packs images as ``(N, H*W*C)`` rows in
    NHWC order, so the tabular sharding and packing apply unchanged; the
    ConvNet's apply reshapes them back."""
    d = find_cifar10_dir(root)
    if d is not None:
        xs, ys = zip(*(_load_batch(os.path.join(d, f"data_batch_{i}"))
                       for i in range(1, 6)))
        x_train = np.concatenate(xs).astype(np.float32) / 255.0
        y_train = np.concatenate(ys)
        x_test, y_test = _load_batch(os.path.join(d, "test_batch"))
        x_test = x_test.astype(np.float32) / 255.0
        y_test = np.asarray(y_test, np.int32)
    else:
        x, y = synthetic_cifar_like(synthetic_rows)
        n_test = max(1, len(x) // 5)
        x_train, y_train = x[:-n_test], y[:-n_test]
        x_test, y_test = x[-n_test:], y[-n_test:]

    if flatten:
        x_train = x_train.reshape(len(x_train), -1)
        x_test = x_test.reshape(len(x_test), -1)

    return Dataset(
        x_train=x_train, y_train=y_train.astype(np.int32),
        x_test=x_test, y_test=y_test.astype(np.int32),
        num_classes=10,
        feature_names=tuple(f"px{i}" for i in range(x_train.shape[1])),
        label_classes=np.arange(10),
    )
