"""PrivacyLedger: the resumable RDP bookkeeping of the DP aggregation path
(``fedtpu.orchestration.privacy``, the port's own copy).

The cumulative per-order RDP curve is the resumable currency of the privacy
spend: RDP composes additively, so a resume that CHANGES the noise
multiplier or the sampling rate still charges every round at the rate it
was actually noised with (charging all rounds at the current config's rate
would under-report epsilon, the unsafe direction). The curve is kept and
persisted in every checkpoint's meta UNCONDITIONALLY (a zero curve while DP
is off), so a DP-off resume segment carries the earlier segments' spend
forward instead of silently destroying it.

The loop asks the ledger three questions: the cumulative curve at a round
label, whether the guarantee is void at that label, and what to persist
with a checkpoint; it reports the final spend through
``ExperimentResult.privacy_spent``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fedtpu_torch.ops.dp_accountant import DEFAULT_ORDERS, rdp_vector


class PrivacyLedger:
    """Cumulative per-order RDP curve for one run segment, composing the
    restored spend of earlier resumed segments.

    Parameters
    ----------
    fed:
        The run's ``FedConfig`` — supplies the CURRENT segment's
        (participation_rate, dp_noise_multiplier).
    start_round:
        The resume point (0 for a fresh run). Rounds before it belong to
        earlier segments and are charged from ``restored_meta``'s curve.
    restored_meta:
        The checkpoint meta dict the run resumed from (None for a fresh
        run). Recognized keys: ``dp_rdp`` (cumulative curve),
        ``dp_rdp_orders`` (its order grid), ``dp_rdp_assumed`` and
        ``dp_guarantee_void`` (sticky honesty flags).
    """

    def __init__(self, fed, start_round: int = 0,
                 restored_meta: Optional[dict] = None):
        # Charging the CONFIGURED dp_noise_multiplier is correct under
        # adaptive clipping too: the engine calibrates the delta noise at
        # the effective z_delta and the clipped-count at z_count such that
        # the per-round composition equals one Gaussian mechanism of the
        # configured z (fedtpu_torch.parallel.round.
        # effective_delta_noise_multiplier, Andrew et al. 2021).
        self._noise_on = fed.dp_noise_multiplier > 0
        self.per_step = (np.asarray(rdp_vector(fed.participation_rate,
                                               fed.dp_noise_multiplier))
                         if self._noise_on
                         else np.zeros(len(DEFAULT_ORDERS)))
        self.start_round = start_round
        self.base = np.zeros(len(DEFAULT_ORDERS))
        # Both honesty flags persist WITH the curve and OR forward — once
        # a segment's accounting was assumed (a checkpoint without a curve) or its
        # guarantee voided (unnoised rounds, see void_at), no later
        # resume may silently launder the epsilon back to "clean".
        self.base_assumed = False
        self.void_base = False
        if start_round > 0:
            self._restore(restored_meta or {})

    def _restore(self, meta: dict) -> None:
        self.base_assumed = bool(np.asarray(meta.get("dp_rdp_assumed",
                                                     False)))
        self.void_base = bool(np.asarray(meta.get("dp_guarantee_void",
                                                  False)))
        saved_rdp = meta.get("dp_rdp")
        saved_orders = meta.get("dp_rdp_orders")
        if saved_rdp is not None:
            saved_rdp = np.asarray(saved_rdp, dtype=np.float64)
            if not np.any(saved_rdp > 0):
                # An all-zero curve is exactly zero spend on ANY grid —
                # no projection or assumption needed.
                self.base = np.zeros(len(DEFAULT_ORDERS))
            elif saved_orders is None and len(saved_rdp) == len(self.per_step):
                # Same-era checkpoint without the orders array: the grid
                # length matching today's is the best available identity
                # evidence.
                self.base = saved_rdp
            elif saved_orders is not None:
                # Re-project the saved curve onto today's order grid by
                # MONOTONE UPPER BOUND: Renyi divergence is non-decreasing
                # in the order (van Erven & Harremoes 2014, Thm. 3), so
                # for each of today's orders o the smallest saved value at
                # any order o' >= o over-estimates the true RDP at o —
                # the safe direction (epsilon is over-, never
                # under-reported). Exact matches project exactly (the
                # saved curve is itself monotone, so min over o' >= o
                # lands on o' == o when present); orders above the saved
                # grid's maximum get +inf and drop out of the epsilon
                # minimization. This keeps a DISJOINT grid change finite
                # (all-inf would read as a genuinely infinite spend)
                # without assuming any config's rate — and works
                # whether or not the current segment's noise is on, so a
                # noise-off resume can never zero out a positive restored
                # spend.
                o_arr = np.asarray(saved_orders, dtype=np.float64)
                if o_arr.shape != saved_rdp.shape:
                    # Mismatched curve/orders lengths (cross-version or
                    # partially-written meta): no per-order attribution
                    # is trustworthy — degrade to the unattributable
                    # path instead of crashing resume.
                    self._unattributable_spend()
                    return
                projected = np.asarray(
                    [np.min(saved_rdp[o_arr >= o])
                     if np.any(o_arr >= o) else np.inf
                     for o in DEFAULT_ORDERS])
                if np.any(np.isfinite(projected)):
                    self.base = projected
                else:
                    # Every saved order sits BELOW today's smallest —
                    # monotonicity bounds nothing. The spend exists but
                    # is unquantifiable on this grid.
                    self._unattributable_spend()
            else:
                # Unidentifiable grid (no orders array, length mismatch):
                # the spend exists but cannot be attributed per order.
                self._unattributable_spend()
        elif self._noise_on:
            # A checkpoint without the curve under a DP config: the
            # only available assumption is the current config's rate —
            # flagged in the report so the epsilon is never silently
            # wrong. (Without DP on, a missing curve stays zero: the
            # old non-DP behavior, not a claim — a missing curve,
            # unlike a recorded one, is no evidence of spend.)
            self.base = self.per_step * self.start_round
            self.base_assumed = True

    def _unattributable_spend(self) -> None:
        """A restored curve with POSITIVE spend that cannot be projected
        onto today's order grid. With noise currently on, charge the
        pre-resume rounds at the current config's rate, flagged. With
        noise off there is no rate to assume — per_step is zero, and
        charging zero would silently erase the recorded spend (the
        laundering the module docstring forbids); carry it as
        +inf instead (epsilon over-reported, the safe direction), still
        flagged so the report distinguishes it from a genuinely infinite
        spend."""
        self.base = (self.per_step * self.start_round if self._noise_on
                     else np.full(len(DEFAULT_ORDERS), np.inf))
        self.base_assumed = True

    @property
    def composed(self) -> bool:
        """True when the epsilon composes noised rounds from EARLIER
        resumed segments — the current segment's (sigma, q) alone cannot
        re-derive it."""
        return bool(np.any(self.base > 0))

    def rdp_at(self, round_label: int) -> np.ndarray:
        """Cumulative RDP curve when the state is at ``round_label``."""
        return self.base + self.per_step * max(
            0, round_label - self.start_round)

    def void_at(self, round_label: int) -> bool:
        """True when the released model has NO (epsilon, delta) guarantee
        despite a nonzero spend: some rounds after the noised ones
        re-trained on the private data with the noise OFF (that is not
        post-processing — it voids the guarantee)."""
        trained_unnoised = (not self._noise_on
                            and round_label > self.start_round)
        return bool(self.void_base
                    or (trained_unnoised and np.any(self.base > 0)))

    def checkpoint_meta(self, round_label: int) -> dict:
        """The DP bookkeeping persisted with every checkpoint (periodic
        and quarantine) — one definition so the save sites can't
        drift."""
        return {"dp_rdp": self.rdp_at(round_label),
                "dp_rdp_orders": np.asarray(DEFAULT_ORDERS),
                "dp_rdp_assumed": self.base_assumed,
                "dp_guarantee_void": self.void_at(round_label)}


__all__ = ["PrivacyLedger"]
