"""RDP privacy accountant for the central-DP aggregation path
(``fedtpu.ops.dp_accountant``, the port's own copy: pure math, no JAX).

The mechanism ``fedtpu_torch.parallel.round`` implements is, per federated
round, exactly the (Poisson-)subsampled Gaussian mechanism at CLIENT level:
each client joins the round iid with probability q (``participation_rate``;
q=1 for full participation), submits a delta clipped to L2 norm C
(``dp_clip_norm``), and the released aggregate is the clipped sum plus
Gaussian noise of std z*C (``dp_noise_multiplier`` z; the 1/denominator
scaling applied to both sum and noise cancels in the privacy analysis).
T rounds compose T invocations.

Method: Renyi differential privacy (Mironov 2017) of the sampled Gaussian
mechanism (Mironov, Talwar, Zhang 2019, arXiv:1908.10530). For integer
order alpha >= 2 the per-step RDP of the SGM is

    eps_RDP(alpha) = 1/(alpha-1) * log( sum_{k=0}^{alpha} C(alpha,k)
                     (1-q)^(alpha-k) q^k exp((k^2 - k) / (2 sigma^2)) )

(ibid. Table 1 / eq. 3); RDP composes additively over the T rounds, and
converts to (epsilon, delta)-DP via epsilon = eps_RDP(alpha)*T +
log(1/delta)/(alpha-1) (Mironov 2017, Prop. 3), minimized over a grid of
integer orders. Integer orders lose a few percent of tightness vs a
fractional-order grid — acceptable for a reporting accountant, and the
direction of the loss is SAFE (epsilon is over-, never under-reported).

Everything is evaluated in log space (lgamma for the binomial
coefficients, logsumexp for the mixture) so sigma down to ~0.3 and alpha
up to 512 stay finite.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

# Default order grid: dense where the optimum usually lands (small alpha
# for big noise / many steps, larger alpha for tiny q or few steps).
DEFAULT_ORDERS: Sequence[int] = tuple(range(2, 65)) + (
    80, 96, 128, 192, 256, 384, 512)


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _logsumexp(vals: Iterable[float]) -> float:
    vals = list(vals)
    m = max(vals)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(v - m) for v in vals))


def rdp_sampled_gaussian(q: float, noise_multiplier: float,
                         order: int) -> float:
    """Per-step RDP of the sampled Gaussian mechanism at integer order.

    ``q``: Poisson sampling rate in [0, 1]; ``noise_multiplier``: noise
    std / clip norm (sigma); ``order``: integer Renyi order >= 2.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q={q} outside [0, 1]")
    if order < 2 or int(order) != order:
        raise ValueError(f"integer order >= 2 required, got {order}")
    sigma = noise_multiplier
    if sigma <= 0.0:
        return math.inf
    if q == 0.0:
        return 0.0
    if q == 1.0:
        # Plain Gaussian mechanism: alpha / (2 sigma^2).
        return order / (2.0 * sigma * sigma)
    order = int(order)
    terms = [
        _log_binom(order, k)
        + (order - k) * math.log1p(-q) + k * math.log(q)
        + (k * k - k) / (2.0 * sigma * sigma)
        for k in range(order + 1)
    ]
    return _logsumexp(terms) / (order - 1)


def rdp_vector(q: float, noise_multiplier: float,
               orders: Sequence[int] = DEFAULT_ORDERS) -> list:
    """Per-STEP RDP of the SGM at every order in the grid — the additive
    currency of composition. Heterogeneous segments (a resumed run whose
    noise multiplier or sampling rate changed) compose by summing their
    per-segment ``steps * rdp_vector`` element-wise; ``epsilon_from_rdp``
    converts the total."""
    if noise_multiplier <= 0.0:
        return [math.inf] * len(orders)
    return [rdp_sampled_gaussian(q, noise_multiplier, a) for a in orders]


def epsilon_from_rdp(rdp: Sequence[float], delta: float,
                     orders: Sequence[int] = DEFAULT_ORDERS) -> dict:
    """(epsilon, delta) from an ACCUMULATED RDP curve (one value per order
    in ``orders``): epsilon = min_a rdp[a] + log(1/delta)/(a-1). An
    all-zero curve is zero spend (epsilon 0) — the conversion penalty
    log(1/delta)/(a-1) applies to compositions, not to no mechanism at
    all (mirrors ``privacy_spent(steps=0)``)."""
    if delta <= 0.0 or delta >= 1.0:
        raise ValueError(f"delta={delta} outside (0, 1)")
    if len(rdp) != len(orders):
        raise ValueError(f"rdp curve has {len(rdp)} entries for "
                         f"{len(orders)} orders")
    if all(r == 0 for r in rdp):
        return {"epsilon": 0.0, "delta": delta, "order": None}
    best_eps, best_order = math.inf, None
    log_inv_delta = math.log(1.0 / delta)
    for a, r in zip(orders, rdp):
        eps = r + log_inv_delta / (a - 1)
        if eps < best_eps:
            best_eps, best_order = eps, a
    return {"epsilon": best_eps, "delta": delta, "order": best_order}


def privacy_spent(q: float, noise_multiplier: float, steps: int,
                  delta: float,
                  orders: Sequence[int] = DEFAULT_ORDERS) -> dict:
    """(epsilon, delta) after ``steps`` compositions of the SGM.

    Returns ``{"epsilon", "delta", "order"}`` where ``order`` is the Renyi
    order the minimum was attained at (order == max(orders) suggests the
    grid should be widened; math.inf epsilon means no noise)."""
    if delta <= 0.0 or delta >= 1.0:
        raise ValueError(f"delta={delta} outside (0, 1)")
    if steps < 0:
        raise ValueError(f"steps={steps} negative")
    if steps == 0 or q == 0.0:
        return {"epsilon": 0.0, "delta": delta, "order": None}
    if noise_multiplier <= 0.0:
        return {"epsilon": math.inf, "delta": delta, "order": None}
    return epsilon_from_rdp(
        [r * steps for r in rdp_vector(q, noise_multiplier, orders)],
        delta, orders)


def closed_form_gaussian_epsilon(noise_multiplier: float, steps: int,
                                 delta: float) -> float:
    """Analytic q=1 check value: minimizing T*a/(2 s^2) + log(1/d)/(a-1)
    over REAL a gives eps = T/(2 s^2) + sqrt(2 T log(1/d)) / s. Used by
    the tests to pin the accountant against algebra, not another
    implementation."""
    s = noise_multiplier
    t = float(steps)
    return t / (2 * s * s) + math.sqrt(2 * t * math.log(1 / delta)) / s


__all__ = ["DEFAULT_ORDERS", "rdp_sampled_gaussian", "rdp_vector",
           "epsilon_from_rdp", "privacy_spent",
           "closed_form_gaussian_epsilon"]
