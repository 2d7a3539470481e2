"""A numpy ``MLPClassifier``: the part of scikit-learn's
(``sklearn.neural_network.MLPClassifier``, 1.9.0) that the warm-start
limitation demo calls (``fedtpu_torch.parity.sklearn_warmstart``), so that
the port runs the demo without scikit-learn.

What it computes, as ``sklearn/neural_network/_multilayer_perceptron.py``,
``_stochastic_optimizers.py`` and ``_base.py`` compute it, operation for
operation in the same numpy dtypes (so on the same BLAS the weights are
the same bits):

- ReLU hidden layers; the output is one logistic unit for two classes
  (``binary_log_loss``) and a softmax over the classes for more
  (``log_loss``). No port preset reaches the softmax path (every one of
  them has two classes); it is here because a ``DataConfig`` with
  ``synthetic_classes > 2`` reaches it.
- Glorot-uniform init (``_init_coef``), drawn from a fresh
  ``np.random.RandomState(random_state)`` on every ``fit`` and on the
  first ``partial_fit``, layer by layer, a layer's weights before its
  biases, in the input's dtype. ``fit`` re-initialises the weights
  whatever ``coefs_`` / ``intercepts_`` hold: that re-initialisation is
  the limitation the demo shows, and it is kept.
- Adam (``AdamOptimizer``: beta_1 0.9, beta_2 0.999, epsilon 1e-8, the
  per-step rate ``lr * sqrt(1 - b2^t) / (1 - b1^t)``) over minibatches of
  ``min(200, n)`` rows, the rows shuffled each epoch by the same
  ``RandomState`` (``sklearn.utils.shuffle``); the L2 term
  ``alpha = 1e-4`` in the loss and the gradients.
- ``fit`` stops when the epoch loss has not improved on the best by
  ``tol = 1e-4`` for more than ``n_iter_no_change = 10`` epochs, or after
  ``max_iter`` epochs. The latter is where scikit-learn warns
  ``ConvergenceWarning``: here it is a ``warnings.warn`` of this module's
  ``ConvergenceWarning`` with scikit-learn's text (not a parity line).
- The label binarizer's class order: ``classes_`` sorted, the positive
  class of the binary case ``classes_[1]``; ``predict`` thresholds the
  logistic output at 0.5 (above it: the positive class).

The logistic function and ``xlogy`` are scipy's (``scipy.special``),
scikit-learn's own: numpy's ``1 / (1 + exp(-x))`` in float32 differs from
``expit`` in the last bit of about one value in six. Not ported: the other
solvers, activations, ``warm_start``, early stopping on a validation split
and sample weights (the demo uses none of them).
"""

from __future__ import annotations

import warnings
from itertools import pairwise

import numpy as np
from scipy.special import expit, xlogy


class ConvergenceWarning(UserWarning):
    """``fit`` ran ``max_iter`` epochs without meeting its stop rule."""


def _gen_batches(n: int, batch_size: int):
    start = 0
    for _ in range(n // batch_size):
        yield slice(start, start + batch_size)
        start += batch_size
    if start < n:
        yield slice(start, n)


class MLPClassifier:
    """See the module docstring. ``coefs_`` / ``intercepts_`` are lists of
    ``(fan_in, fan_out)`` / ``(fan_out,)`` arrays, which the caller may
    assign (``fit`` discards them, ``partial_fit`` after the first call
    trains on from them)."""

    # scikit-learn's defaults, which the demo keeps.
    alpha = 1e-4
    tol = 1e-4
    n_iter_no_change = 10
    beta_1 = 0.9
    beta_2 = 0.999
    epsilon = 1e-8

    def __init__(self, hidden_layer_sizes=(100,), activation="relu", *,
                 learning_rate_init=0.001, max_iter=200, random_state=None):
        if activation != "relu":
            raise NotImplementedError(
                f"activation={activation!r}: the numpy MLPClassifier has "
                "the ReLU only")
        self.hidden_layer_sizes = hidden_layer_sizes
        self.learning_rate_init = learning_rate_init
        self.max_iter = max_iter
        self.random_state = random_state

    # -------------------------------------------------------------- labels
    def _binarize(self, y: np.ndarray) -> np.ndarray:
        """The label binarizer's ``transform(y).astype(bool)``: ``(n, 1)``
        for two classes, one-hot ``(n, K)`` for more."""
        if len(np.setdiff1d(np.unique(y), self.classes_)):
            raise ValueError(f"`y` has classes not in `self.classes_` "
                             f"{self.classes_}")
        if len(self.classes_) == 2:
            return (y == self.classes_[1]).reshape(-1, 1)
        return y.reshape(-1, 1) == self.classes_.reshape(1, -1)

    def _validate(self, x, y):
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        if x.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {x.shape}")
        return x, np.asarray(y).reshape(-1)

    # ------------------------------------------------------------- forward
    def _output(self, z: np.ndarray) -> np.ndarray:
        if self.out_activation_ == "logistic":
            expit(z, out=z)
        else:
            tmp = z - z.max(axis=1)[:, np.newaxis]
            np.exp(tmp, out=z)
            z /= z.sum(axis=1)[:, np.newaxis]
        return z

    def _forward_pass(self, activations: list) -> list:
        last = len(self.coefs_) - 1
        for i in range(last + 1):
            activations[i + 1] = activations[i] @ self.coefs_[i]
            activations[i + 1] += self.intercepts_[i]
            if i != last:
                np.maximum(activations[i + 1], 0, out=activations[i + 1])
        self._output(activations[last + 1])
        return activations

    def _loss(self, y: np.ndarray, y_prob: np.ndarray):
        eps = np.finfo(y_prob.dtype).eps
        y_prob = np.clip(y_prob, eps, 1 - eps)
        if self.out_activation_ == "logistic":
            return -np.average(xlogy(y, y_prob) + xlogy(1 - y, 1 - y_prob),
                               axis=0).sum()
        return -np.average(xlogy(y, y_prob), axis=0).sum()

    def _backprop(self, x, y, activations, deltas, coef_grads,
                  intercept_grads):
        n_samples = x.shape[0]
        activations = self._forward_pass(activations)
        loss = self._loss(y, activations[-1])
        values = 0
        for s in self.coefs_:
            s = s.ravel()
            values += np.dot(s, s)
        loss += (0.5 * self.alpha) * values / n_samples
        last = len(self.coefs_) - 1
        deltas[last] = activations[-1] - y
        self._layer_grad(last, n_samples, activations, deltas, coef_grads,
                         intercept_grads)
        for i in range(last, 0, -1):
            deltas[i - 1] = deltas[i] @ self.coefs_[i].T
            deltas[i - 1][activations[i] == 0] = 0
            self._layer_grad(i - 1, n_samples, activations, deltas,
                             coef_grads, intercept_grads)
        return loss, coef_grads, intercept_grads

    def _layer_grad(self, layer, n_samples, activations, deltas, coef_grads,
                    intercept_grads):
        coef_grads[layer] = activations[layer].T @ deltas[layer]
        coef_grads[layer] += self.alpha * self.coefs_[layer]
        coef_grads[layer] /= n_samples
        intercept_grads[layer] = np.sum(deltas[layer], axis=0) / n_samples

    # ---------------------------------------------------------------- init
    def _initialize(self, layer_units, dtype):
        self.n_iter_ = 0
        self.t_ = 0
        self.n_layers_ = len(layer_units)
        self.out_activation_ = ("logistic" if len(self.classes_) == 2
                                else "softmax")
        self.coefs_, self.intercepts_ = [], []
        for fan_in, fan_out in pairwise(layer_units):
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            coef = self._random_state.uniform(-bound, bound,
                                              (fan_in, fan_out))
            intercept = self._random_state.uniform(-bound, bound, fan_out)
            self.coefs_.append(coef.astype(dtype, copy=False))
            self.intercepts_.append(intercept.astype(dtype, copy=False))
        self.loss_curve_ = []
        self._no_improvement_count = 0
        self.best_loss_ = np.inf

    # ----------------------------------------------------------------- fit
    def _adam_step(self, params, grads):
        """``AdamOptimizer.update_params``, expression for expression (its
        per-step rate is a float64 scalar, so each update is computed in
        float64 and added into the float32 params)."""
        opt = self._optimizer
        opt["t"] += 1
        opt["ms"] = [self.beta_1 * m + (1 - self.beta_1) * grad
                     for m, grad in zip(opt["ms"], grads)]
        opt["vs"] = [self.beta_2 * v + (1 - self.beta_2) * (grad ** 2)
                     for v, grad in zip(opt["vs"], grads)]
        lr = (self.learning_rate_init * np.sqrt(1 - self.beta_2 ** opt["t"])
              / (1 - self.beta_1 ** opt["t"]))
        for param, m, v in zip(params, opt["ms"], opt["vs"]):
            param += -lr * m / (np.sqrt(v) + self.epsilon)

    def _fit(self, x, y, incremental: bool):
        hidden = list(self.hidden_layer_sizes)
        if any(h <= 0 for h in hidden):
            raise ValueError(f"hidden_layer_sizes must be > 0, got {hidden}")
        first_pass = not hasattr(self, "coefs_") or not incremental
        x, y = self._validate(x, y)
        if not incremental:
            self.classes_ = np.unique(y)
        y = self._binarize(y)
        n_samples, n_features = x.shape
        layer_units = [n_features] + hidden + [y.shape[1]]
        self._random_state = np.random.RandomState(self.random_state)
        if first_pass:
            self._initialize(layer_units, x.dtype)
        activations = [x] + [None] * (len(layer_units) - 1)
        deltas = [None] * (len(activations) - 1)
        coef_grads = [None] * (len(layer_units) - 1)
        intercept_grads = [None] * (len(layer_units) - 1)
        params = self.coefs_ + self.intercepts_
        if not incremental or not hasattr(self, "_optimizer"):
            self._optimizer = {"t": 0,
                               "ms": [np.zeros_like(p) for p in params],
                               "vs": [np.zeros_like(p) for p in params]}
        sample_idx = np.arange(n_samples, dtype=int)
        batch_size = min(200, n_samples)
        self.n_iter_ = 0
        for _ in range(self.max_iter):
            # sklearn.utils.shuffle: a permutation of the current order.
            perm = np.arange(n_samples)
            self._random_state.shuffle(perm)
            sample_idx = sample_idx[perm]
            accumulated_loss = 0.0
            for batch in _gen_batches(n_samples, batch_size):
                batch_idx = sample_idx[batch]
                activations[0] = x[batch_idx]
                batch_loss, coef_grads, intercept_grads = self._backprop(
                    activations[0], y[batch_idx], activations, deltas,
                    coef_grads, intercept_grads)
                accumulated_loss += batch_loss * (batch.stop - batch.start)
                self._adam_step(params, coef_grads + intercept_grads)
            self.n_iter_ += 1
            self.loss_ = accumulated_loss / x.shape[0]
            self.t_ += n_samples
            self.loss_curve_.append(self.loss_)
            if self.loss_curve_[-1] > self.best_loss_ - self.tol:
                self._no_improvement_count += 1
            else:
                self._no_improvement_count = 0
            if self.loss_curve_[-1] < self.best_loss_:
                self.best_loss_ = self.loss_curve_[-1]
            if self._no_improvement_count > self.n_iter_no_change:
                break
            if incremental:
                break
            if self.n_iter_ == self.max_iter:
                warnings.warn(
                    "Stochastic Optimizer: Maximum iterations (%d) reached "
                    "and the optimization hasn't converged yet."
                    % self.max_iter, ConvergenceWarning)
        if not all(np.isfinite(w).all()
                   for w in self.coefs_ + self.intercepts_):
            raise ValueError(
                "Solver produced non-finite parameter weights. The input "
                "data may contain large values and need to be "
                "preprocessed.")
        return self

    def fit(self, x, y) -> "MLPClassifier":
        """Train from a fresh init (whatever the weights hold) for up to
        ``max_iter`` epochs."""
        return self._fit(x, y, incremental=False)

    def partial_fit(self, x, y, classes=None) -> "MLPClassifier":
        """One epoch; the first call takes ``classes`` and initialises."""
        if not hasattr(self, "classes_"):
            if classes is None:
                raise ValueError("classes must be passed on the first call "
                                 "to partial_fit.")
            self.classes_ = np.unique(classes)
        elif classes is not None and not np.array_equal(
                self.classes_, np.unique(classes)):
            raise ValueError(f"`classes={classes!r}` is not the same as on "
                             f"last call to partial_fit, was: "
                             f"{self.classes_!r}")
        return self._fit(x, y, incremental=True)

    def predict(self, x) -> np.ndarray:
        if not hasattr(self, "coefs_"):
            raise ValueError("This MLPClassifier instance is not fitted yet.")
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        last = len(self.coefs_) - 1
        z = x
        for i in range(last + 1):
            z = z @ self.coefs_[i]
            z += self.intercepts_[i]
            if i != last:
                np.maximum(z, 0, out=z)
        self._output(z)
        if self.out_activation_ == "logistic":
            return self.classes_[(z.ravel() > 0.5).astype(np.intp)]
        return self.classes_.take(z.argmax(axis=1))
