"""Host-side tabular data pipeline (``fedtpu.data.tabular``), numpy and the
``csv`` module only.

Produces bitwise the same train/test arrays as ``fedtpu``'s pipeline, from a
synthetic config or from a CSV. ``fedtpu`` takes its split from sklearn's
``train_test_split(test_size, random_state)``; that is a
``RandomState(seed).permutation(n)`` whose first ``ceil(test_size * n)``
indices are the test rows and the rest, in order, the train rows, which is
what ``_train_test_split`` computes here without sklearn.

A CSV is read as ``fedtpu``'s two loaders read it (its C++ loader and
pandas, which it pins to identical output), with one loader for both values
of ``DataConfig.native_loader``:

* a column is numeric when every cell that is not missing parses as a float
  (spaces around the number allowed, as pandas parses it); otherwise every
  cell is a string, kept as written, leading spaces included (the income
  data's label is ``" <=50K"``), and the column is encoded to the indices of
  its sorted unique values (sklearn's ``LabelEncoder``);
* the missing cells are pandas' default ``na_values`` (``_NA_TOKENS``: the
  empty cell, ``NA``, ``nan``, ``NULL``, ``None``, ...), matched against the
  cell as written. A missing cell reads as NaN in a numeric column, as
  pandas reads it (``fedtpu``'s C++ loader reads the non-empty tokens as
  strings). A string column with a missing cell raises, naming the column:
  pandas gives it a NaN among strings, which ``fedtpu``'s encoder cannot
  sort either;
* RFC-4180 quoting; blank lines skipped; a row with another field count
  than the header raises.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import Dict, Optional

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


# pandas.read_csv's default na_values: the cells read as missing.
_NA_TOKENS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _parse_float(cell: str) -> Optional[float]:
    """The cell as a float, or None where pandas would not read one."""
    text = cell.strip(" \t")
    if not text or "_" in text:     # float() takes "1_0"; pandas does not
        return None
    try:
        return float(text)
    except ValueError:
        return None


def _load_encoded(csv_path: str):
    """``(column names, float64 matrix, classes)`` of a CSV: string columns
    hold their codes in the matrix, and ``classes`` maps each to its sorted
    unique values (``fedtpu.data.tabular._load_encoded``)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{csv_path!r}: no header row")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{csv_path!r}: row {i + 2} has {len(r)} "
                             f"fields, the header {len(header)}")
    mat = np.empty((len(body), len(header)), np.float64)
    classes: Dict[str, np.ndarray] = {}
    for c, name in enumerate(header):
        cells = [r[c] for r in body]
        missing = [cell in _NA_TOKENS for cell in cells]
        values = [None if m else _parse_float(cell)
                  for cell, m in zip(cells, missing)]
        if all(v is not None or m for v, m in zip(values, missing)):
            mat[:, c] = [math.nan if v is None else v for v in values]
            continue
        if any(missing):
            raise ValueError(
                f"column {name!r} holds strings and a missing cell (row "
                f"{missing.index(True) + 2}): a string column is encoded by "
                "sorting its values, and a missing one has no place in "
                "that order")
        uniq, codes = np.unique(np.array(cells, dtype=object),
                                return_inverse=True)
        mat[:, c] = codes
        classes[name] = uniq
    return list(header), mat, classes


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
    """Load + preprocess per the reference pipeline: the synthetic rows, or
    the CSV at ``cfg.csv_path`` (see module docstring)."""
    if cfg.csv_path is None:
        x, y = synthetic_income_like(cfg.synthetic_rows,
                                     cfg.synthetic_features,
                                     cfg.synthetic_classes)
        label_classes = np.arange(cfg.synthetic_classes)
        feature_names = tuple(f"f{i}" for i in range(x.shape[1]))
    else:
        columns, mat, encoders = _load_encoded(cfg.csv_path)
        if cfg.label_column not in columns:
            raise KeyError(
                f"'{cfg.label_column}' not found in dataset columns. "
                f"Available columns: {list(columns)}")
        li = columns.index(cfg.label_column)
        y = mat[:, li]
        x = np.delete(mat, li, axis=1)
        # Labels re-encoded to 0..K-1 whatever their type: a numeric label
        # column such as {1, 2} is no class index as it stands.
        original_classes, y = np.unique(y, return_inverse=True)
        label_classes = encoders.get(cfg.label_column, original_classes)
        feature_names = tuple(c for c in columns if c != cfg.label_column)
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
