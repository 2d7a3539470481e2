"""First-class invariant oracles for chaos rows and fuzz campaigns
(``fedtpu.resilience.oracles``, whole).

Every resilience bar the repo enforces — exactly-once incorporation,
zero lost acked updates, bitwise virtual-time history vs. an
uninterrupted baseline, the 0/3/75/76 exit-code contract, monotone
round progression, checkpoint restorability, bounded SLO burn — used to
live as an ad-hoc boolean expression inside its chaos row. This module
extracts each bar into ONE pure function returning a structured
:class:`Verdict`, so the same implementation gates the hand-written
scenario matrix (fedtpu_torch.resilience.chaos), the compositional
fuzzer (fedtpu_torch.resilience.fuzz) and its committed corpus replays,
and so ``report`` can render
exactly WHICH invariant a campaign broke instead of a bare ``ok=False``.

Design constraints:

- Pure and stdlib-only (``checkpoint_restorable`` imports the
  checkpoint loader lazily): an oracle must be unit-testable with a
  synthetic dict and importable from the CLI parser path without
  dragging torch in.
- Deterministic rendering: :meth:`Verdict.as_dict` is canonical-JSON
  friendly (sorted keys, no floats derived from wall time), because
  fuzz verdict artifacts are compared BITWISE across replays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

#: The supervisor's exit-code contract (fedtpu_torch.resilience.supervisor):
#: 0 = clean finish, 3 = diverged (never restarted), 75 = preempted
#: (restart without backoff), 76 = resharded-away (clean departure).
CONTRACT_EXITS = (0, 3, 75, 76)

#: Exit codes a member may show MID-campaign without breaking the
#: contract: preemption, a supervised crash (SIGKILL / EIO) that the
#: gang restart absorbs.
TRANSIENT_EXITS = (1, 75, 137)

#: Exit codes a member may END a campaign on: clean finish or a clean
#: reshard departure. Anything else means the fleet never recovered.
FINAL_EXITS = (0, 76)


@dataclasses.dataclass
class Verdict:
    """One oracle's structured judgement of one run."""

    oracle: str
    ok: bool
    observed: object = None
    expected: object = None
    detail: str = ""

    def as_dict(self) -> dict:
        return {"oracle": self.oracle, "ok": bool(self.ok),
                "observed": self.observed, "expected": self.expected,
                "detail": self.detail}


def summarize(verdicts: Iterable[Verdict]) -> dict:
    """Fold a verdict list into the campaign-level judgement."""
    vs = list(verdicts)
    failed = [v.oracle for v in vs if not v.ok]
    return {"ok": not failed, "oracles": len(vs), "failed": failed}


# ---------------------------------------------------------------------------
# primitive oracles


def exactly_once(client_admitted: Optional[int],
                 fleet_admitted: Optional[int]) -> Verdict:
    """Every update the CLIENT was told was admitted is admitted by the
    fleet exactly once — the client-merged ack counts and the engines'
    own admission counters must agree despite retries, torn acks, and
    rollback re-offers (a retry that double-counts breaks it one way, a
    dropped re-offer the other)."""
    ok = (client_admitted is not None and fleet_admitted is not None
          and int(client_admitted) == int(fleet_admitted))
    return Verdict("exactly_once", ok, observed=fleet_admitted,
                   expected=client_admitted,
                   detail="client-merged admitted acks vs fleet admission "
                          "counters")


def no_lost_acked(lost_acked: Optional[int]) -> Verdict:
    """Zero lost acked updates: (client-admitted) - (incorporated +
    screened) must be exactly 0 — positive means an acked update
    vanished, negative means something was incorporated twice."""
    ok = lost_acked is not None and int(lost_acked) == 0
    return Verdict("no_lost_acked", ok, observed=lost_acked, expected=0,
                   detail="client_admitted - (incorporated + screened)")


def history_bitwise(history: dict, baseline: dict, mode: str = "full",
                    fault_round: Optional[int] = None) -> Verdict:
    """Bitwise virtual-time history vs. an uninterrupted baseline.

    ``mode='full'``: every round present in both and byte-equal (the
    sigkill/preempt/nan_rollback/mp_kill bar — recovery must leave NO
    trace in the math). ``mode='prefix_divergent'``: the pre-fault
    prefix is bitwise, the round set matches, and ``fault_round`` MUST
    differ (the dropout/reshard bar — identical history would mean the
    fault silently didn't apply)."""
    same_rounds = sorted(history) == sorted(baseline)
    if mode == "full":
        ok = same_rounds and all(history[r] == baseline[r]
                                 for r in history)
        first_diff = next((r for r in sorted(history)
                           if history.get(r) != baseline.get(r)), None)
        return Verdict("history_bitwise", ok,
                       observed={"rounds": len(history),
                                 "first_divergence": first_diff},
                       expected={"rounds": len(baseline),
                                 "first_divergence": None},
                       detail="full bitwise history replay")
    if mode != "prefix_divergent":
        raise ValueError(f"unknown history mode {mode!r}")
    if fault_round is None:
        raise ValueError("prefix_divergent needs fault_round")
    k = int(fault_round)
    prefix_ok = all(history.get(r) == baseline.get(r)
                    for r in range(1, k))
    diverged = history.get(k) != baseline.get(k)
    ok = prefix_ok and same_rounds and diverged
    return Verdict("history_bitwise", ok,
                   observed={"prefix_bitwise": prefix_ok,
                             "same_rounds": same_rounds,
                             "fault_round_differs": diverged},
                   expected={"prefix_bitwise": True, "same_rounds": True,
                             "fault_round_differs": True},
                   detail=f"bitwise prefix, round {k} must differ")


def exit_contract(exit_codes: Sequence[Sequence[int]]) -> Verdict:
    """The 0/3/75/76 supervisor contract over each member's exit-code
    timeline: 3 (diverged) never appears (it is never restarted, so a
    campaign that produces it did not recover), every mid-campaign exit
    is a transient the gang absorbs (75 preemption, a supervised
    crash), and every member ENDS on 0 or 76."""
    bad: List[dict] = []
    for g, codes in enumerate(exit_codes):
        codes = list(codes)
        if not codes:
            bad.append({"member": g, "reason": "no exit recorded"})
            continue
        if 3 in codes:
            bad.append({"member": g, "reason": "diverged (exit 3)"})
        if codes[-1] not in FINAL_EXITS:
            bad.append({"member": g,
                        "reason": f"final exit {codes[-1]}"})
        for c in codes[:-1]:
            if c not in TRANSIENT_EXITS:
                bad.append({"member": g,
                            "reason": f"non-transient mid-exit {c}"})
    return Verdict("exit_contract", not bad,
                   observed=[list(c) for c in exit_codes],
                   expected={"final": list(FINAL_EXITS),
                             "transient": list(TRANSIENT_EXITS)},
                   detail="; ".join(b["reason"] + f" (member {b['member']})"
                                    for b in bad))


def monotone_rounds(marks: Sequence[int], member: int = 0) -> Verdict:
    """Committed round/tick progress never moves backward: a crash may
    roll live state back, but by each round boundary the resend/replay
    machinery must have re-reached (at least) the prior mark."""
    marks = [int(m) for m in marks]
    bad = next((i for i in range(1, len(marks))
                if marks[i] < marks[i - 1]), None)
    return Verdict("monotone_rounds", bad is None,
                   observed={"member": member,
                             "regression_at": bad,
                             "marks": marks},
                   expected={"member": member, "regression_at": None},
                   detail=f"member {member} end-of-round progress marks")


def checkpoint_restorable(directory: str, label: str = "") -> Verdict:
    """At least one committed checkpoint under ``directory`` actually
    restores — the fallback walk
    (fedtpu_torch.orchestration.checkpoint.load_checkpoint_fallback) must
    get past torn/stomped rounds to a loadable one."""
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_fallback
    try:
        _, _, step = load_checkpoint_fallback(directory)
        return Verdict("checkpoint_restorable", True,
                       observed={"step": int(step)},
                       expected={"step": "any"},
                       detail=label or "fallback walk found a loadable round")
    except Exception as e:  # FileNotFoundError or a loader error
        return Verdict("checkpoint_restorable", False,
                       observed={"step": None},
                       expected={"step": "any"},
                       detail=f"{label or 'fallback walk'}: "
                              f"{type(e).__name__}: {e}")


def slo_burn_bounded(slo_burn: Optional[float], budget: float) -> Verdict:
    """SLO burn is measured and under budget (an unmeasured burn fails:
    the signal going dark is itself a violation)."""
    ok = slo_burn is not None and float(slo_burn) <= float(budget)
    return Verdict("slo_burn_bounded", ok, observed=slo_burn,
                   expected={"max": float(budget)},
                   detail="update-to-incorporation SLO burn")


def backlog_drained(backlog: Optional[int]) -> Verdict:
    """Every admitted update left the pending queue by drain time."""
    ok = backlog is not None and int(backlog) == 0
    return Verdict("backlog_drained", ok, observed=backlog, expected=0,
                   detail="pending backlog after final drain")


def quarantine_containment(quarantined: Iterable[int],
                           attackers: Iterable[int],
                           mode: str = "exact") -> Verdict:
    """The defense quarantined the right senders. ``mode='exact'``: the
    quarantine set IS the attacker set (no missed attacker, no honest
    casualty — the mp_poison_campaign bar). ``mode='subset'``: no
    honest sender quarantined (the fuzz bar: a campaign need not
    poison hard enough to trip every strike)."""
    q = {int(u) for u in quarantined}
    a = {int(u) for u in attackers}
    missed = sorted(a - q)
    honest = sorted(q - a)
    ok = not honest if mode == "subset" else (not missed and not honest)
    return Verdict("quarantine_containment", ok,
                   observed={"quarantined": sorted(q), "missed": missed,
                             "honest_quarantined": honest},
                   expected={"honest_quarantined": [],
                             **({"missed": []} if mode == "exact" else {})},
                   detail=f"{mode} containment vs the seeded attacker set")


def defense_effective(acc_defended: Optional[float],
                      acc_undefended: Optional[float],
                      acc_clean: Optional[float],
                      accuracy_tol: float,
                      degrade_min: float) -> Verdict:
    """The screen is worth having: the defended run holds clean-run
    accuracy (within ``accuracy_tol``) while the undefended run
    measurably degrades (by at least ``degrade_min``) — otherwise the
    attack was toothless and the row proves nothing."""
    ok = (acc_defended is not None and acc_undefended is not None
          and acc_clean is not None
          and acc_defended >= acc_clean - accuracy_tol
          and acc_undefended <= acc_clean - degrade_min)
    return Verdict("defense_effective", ok,
                   observed={"defended": acc_defended,
                             "undefended": acc_undefended,
                             "clean": acc_clean},
                   expected={"defended_min": (None if acc_clean is None
                                              else acc_clean - accuracy_tol),
                             "undefended_max": (None if acc_clean is None
                                                else acc_clean - degrade_min)},
                   detail="defended holds clean accuracy; undefended degrades")


# ---------------------------------------------------------------------------
# composite judges — the refactored chaos-row bars. Each reproduces the
# row's historical boolean verdict EXACTLY while exposing which invariant
# failed.


def judge_gateway_kill(*, survived: bool, retried: int, gang_restarts: int,
                       duplicate_drops: int, lost_acked: Optional[int],
                       client_admitted: Optional[int],
                       fleet_admitted: Optional[int],
                       backlog: Optional[int], slo_burn: Optional[float],
                       burn_budget: float) -> List[Verdict]:
    """The mp_gateway_kill bar: the gang survived a mid-load SIGKILL of
    an acked-but-unanswered gateway, the client actually retried, the
    restart actually happened, the retry was deduped, and nothing acked
    was lost."""
    return [
        Verdict("fleet_survived", bool(survived), observed=bool(survived),
                expected=True, detail="supervisor exited cleanly with a "
                                      "full fleet"),
        Verdict("retry_dedup_exercised",
                int(retried) >= 1 and int(duplicate_drops) >= 1,
                observed={"retried": int(retried),
                          "duplicate_drops": int(duplicate_drops)},
                expected={"retried": ">=1", "duplicate_drops": ">=1"},
                detail="the kill must force a retry and the retry must "
                       "dedup"),
        Verdict("gang_restarted", int(gang_restarts) >= 1,
                observed=int(gang_restarts), expected=">=1",
                detail="the kill must cost a gang restart"),
        exactly_once(client_admitted, fleet_admitted),
        no_lost_acked(lost_acked),
        backlog_drained(backlog),
        slo_burn_bounded(slo_burn, burn_budget),
    ]


def judge_net_row(*, survived: bool, netlog_match: bool, retried: int,
                  duplicate_drops: int, lost_acked: Optional[int],
                  client_admitted: Optional[int],
                  fleet_admitted: Optional[int], backlog: Optional[int],
                  gang_restarts: int, slo_burn: Optional[float],
                  burn_budget: float) -> List[Verdict]:
    """The wire-chaos bar (mp_net_partition / mp_slow_gateway /
    mp_torn_frame): both passes survived, the proxy decision logs match
    bitwise, retries were forced and deduped, nothing acked was lost,
    and — the whole point of wire-level recovery — ZERO gang
    restarts."""
    return [
        Verdict("fleet_survived", bool(survived), observed=bool(survived),
                expected=True, detail="both wire passes completed"),
        Verdict("netlog_bitwise", bool(netlog_match),
                observed=bool(netlog_match), expected=True,
                detail="proxy decision logs bitwise across two passes"),
        Verdict("retry_dedup_exercised",
                int(retried) >= 1 and int(duplicate_drops) >= 1,
                observed={"retried": int(retried),
                          "duplicate_drops": int(duplicate_drops)},
                expected={"retried": ">=1", "duplicate_drops": ">=1"},
                detail="the wire fault must force a retry and the retry "
                       "must dedup"),
        exactly_once(client_admitted, fleet_admitted),
        no_lost_acked(lost_acked),
        backlog_drained(backlog),
        Verdict("no_gang_restart", int(gang_restarts) == 0,
                observed=int(gang_restarts), expected=0,
                detail="wire faults must be absorbed below the "
                       "supervisor"),
        slo_burn_bounded(slo_burn, burn_budget),
    ]


__all__ = [
    "Verdict", "summarize", "exactly_once", "no_lost_acked",
    "history_bitwise", "exit_contract", "monotone_rounds",
    "checkpoint_restorable", "slo_burn_bounded", "backlog_drained",
    "quarantine_containment", "defense_effective", "judge_gateway_kill",
    "judge_net_row", "CONTRACT_EXITS", "TRANSIENT_EXITS", "FINAL_EXITS",
]
