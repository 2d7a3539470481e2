"""Host-side tabular data pipeline (``fedtpu.data.tabular``), numpy only.

Produces bitwise the same train/test arrays as ``fedtpu``'s pipeline for a
synthetic config. ``fedtpu`` takes its split from sklearn's
``train_test_split(test_size, random_state)``; that is a
``RandomState(seed).permutation(n)`` whose first ``ceil(test_size * n)``
indices are the test rows and the rest, in order, the train rows, which is
what ``_train_test_split`` computes here without sklearn.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from fedtpu_torch.config import DataConfig


@dataclasses.dataclass
class Dataset:
    """A preprocessed train/test split, still on host as float32/int32 numpy."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    feature_names: tuple
    label_classes: np.ndarray

    @property
    def input_dim(self) -> int:
        return self.x_train.shape[1]


def _standard_scale(x: np.ndarray, with_mean: bool,
                    stats_from: Optional[np.ndarray] = None):
    """StandardScaler semantics: (x - mean) / std with ddof=0; std==0 -> 1."""
    src = x if stats_from is None else stats_from
    mean = src.mean(axis=0) if with_mean else np.zeros(src.shape[1], src.dtype)
    std = src.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (x - mean) / std, (mean, std)


def _train_test_split(x, y, test_size: float, seed: int):
    """sklearn's ``train_test_split(test_size=..., random_state=seed)``."""
    n = len(y)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


def synthetic_income_like(rows: int, features: int, classes: int,
                          seed: int = 7):
    """A balanced, linearly-separable-ish stand-in for
    balanced_income_data.csv (class centres N(0, 2^2), unit noise)."""
    rng = np.random.default_rng(seed)
    y = np.arange(rows) % classes
    rng.shuffle(y)
    centers = rng.normal(0.0, 2.0, size=(classes, features))
    x = centers[y] + rng.normal(0.0, 1.0, size=(rows, features))
    return x.astype(np.float32), y.astype(np.int32)


def load_tabular_dataset(cfg: DataConfig) -> Dataset:
    """Load + preprocess per the reference pipeline (synthetic data only)."""
    if cfg.csv_path is not None:
        raise NotImplementedError(
            "fedtpu_torch reads no CSV yet: the income CSV is not in the "
            "repository, so the port runs on synthetic income-like data "
            "(csv_path=None)")
    x, y = synthetic_income_like(cfg.synthetic_rows, cfg.synthetic_features,
                                 cfg.synthetic_classes)
    label_classes = np.arange(cfg.synthetic_classes)
    feature_names = tuple(f"f{i}" for i in range(x.shape[1]))
    num_classes = int(len(np.unique(y)))

    if cfg.scaler_leakage_parity:
        # Reference behaviour: scale on the full data, then split.
        x, _ = _standard_scale(x, cfg.scale_with_mean)
        x_train, x_test, y_train, y_test = _train_test_split(
            x, y, cfg.test_size, cfg.split_seed)
    else:
        x_train, x_test, y_train, y_test = _train_test_split(
            x, y, cfg.test_size, cfg.split_seed)
        x_train, (mean, std) = _standard_scale(x_train, cfg.scale_with_mean)
        x_test = (x_test - (mean if cfg.scale_with_mean else 0.0)) / std

    return Dataset(
        x_train=np.asarray(x_train, dtype=np.float32),
        y_train=np.asarray(y_train, dtype=np.int32),
        x_test=np.asarray(x_test, dtype=np.float32),
        y_test=np.asarray(y_test, dtype=np.int32),
        num_classes=num_classes,
        feature_names=feature_names,
        label_classes=np.asarray(label_classes),
    )
