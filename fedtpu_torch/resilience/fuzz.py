"""``fuzz`` — compositional chaos fuzzing over the fault space (the
port's copy of ``fedtpu.resilience.fuzz``).

Every chaos scenario in fedtpu_torch.resilience.chaos exercises ONE fault
family along a hand-written schedule. This module makes the COMPOSED
space searchable: a seeded generator samples a campaign — one canonical
JSON artifact unifying process faults (fedtpu_torch.resilience.faults
kinds), wire faults (a fedtpu_torch.resilience.netfaults plan),
preemption / reshard notices, and an optional poison fraction, with a
sha256 digest stamped into the manifest — and replays it against a
deterministic two-gateway gang in the SAME virtual frame/round-ordinal
clocks the existing plans use, never wall time, so any campaign replays
bitwise. The campaign JSON, its digest and the verdict artifact are
``fedtpu``'s byte for byte, so the committed ``tests/corpus/`` is read
as it is.

The gang is the in-process analogue of the supervised 2-process fleet
the gateway chaos rows launch (real :class:`ServingEngine` members — each
tick the captured driven tick on the card: K1's sum mode, twice under
the screen, and K2 — behind the real
``fedtpu_torch.serving.server._handle`` dispatcher, a retrying loadgen
with stamped nonce/seq sessions, per-member WALs and round checkpoints,
crash/restart with the supervisor's exit-code contract applied to member
lifecycles) — the same executor idiom as
fedtpu_torch.resilience.net_sim, widened from one engine to a fleet so
cross-family interactions (a SIGKILL inside a torn-ack retry window
after a torn checkpoint) actually compose. Members boot (and reboot)
in one process, one at a time; each boot captures its tick under
``round.CAPTURE_LOCK``. ``device`` and ``init_params`` are every
member's, at every boot (``init_params`` injected, a member starts from
those slot params: the tests inject ``fedtpu``'s).

Violations are judged by the fedtpu_torch.resilience.oracles library; a
failing campaign is shrunk by ddmin over its fault entries (re-running
the gang per step) to the smallest still-failing reproducer, which is
committed under ``tests/corpus/`` next to its bitwise verdict golden
and replayed forever after by ``check --fuzz-corpus``.

Recovery policy (found by ``fedtpu``'s fuzzer, pinned by the tests):
a WAL tail is only valid relative to the checkpoint that truncated the
log. When the restore walk falls back PAST the newest complete-looking
round (it was torn on disk), replaying the tail onto the older state
would fast-forward the session high-water marks over frames the
rollback erased, so the client's resends of those frames would dedup
into nothing — silently losing acked updates. The executor therefore
DISCARDS the stale tail and relies on the client's resend-all instead;
``replay_stale_wal_tail=True`` re-enables the naive behavior so the
committed reproducer can demonstrate the violation.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, List, Optional

import numpy as np

# One write/compare implementation repo-wide (module docstring of
# fedtpu_torch.resilience.net_sim explains why the gates share it).
from fedtpu_torch.autoscale.controller import (compare_decisions,
                                               write_decisions)
from fedtpu_torch.config import FuzzConfig
from fedtpu_torch.resilience import oracles
from fedtpu_torch.resilience.netfaults import NetFaultPlan

CAMPAIGN_SCHEMA = 1

#: Process-family fault kinds the campaign executor composes.
PROC_KINDS = ("process_kill", "ckpt_corrupt", "straggler",
              "client_dropout", "nan_update", "wal_short_write")
#: Fleet lifecycle notices.
NOTICE_KINDS = ("preempt_notice", "reshard_shrink")

#: Adversarial update scale for poisoned / NaN-ish rows (large enough
#: that the norm screen flags it against the honest rolling median).
POISON_SCALE = 8.0
NAN_SCALE = 1.0e9

#: Runaway-retry guard: a campaign whose plan swallows every retry
#: forever must fail loudly, not hang the fuzzer.
_MAX_WIRE_FRAMES = 4000

#: Default committed-corpus location (repo-relative), gated in tier-1.
DEFAULT_CORPUS_DIR = os.path.join("tests", "corpus")


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class Campaign:
    """One composed fault campaign — the canonical JSON artifact.

    ``faults`` are process-family entries (round-ordinal clocked),
    ``net_faults`` are fedtpu_torch.resilience.netfaults payloads (wire
    frame/connection-ordinal clocked), ``notices`` are preemption /
    reshard lifecycle entries, and ``poison_fraction`` seeds the
    attacker set. The digest is sha256 over the canonical form and is
    stamped into the manifest: a corpus file whose digest does not
    match its entries fails the gate loudly."""

    name: str
    seed: int
    rounds: int = 8
    poison_fraction: float = 0.0
    faults: List[dict] = dataclasses.field(default_factory=list)
    net_faults: List[dict] = dataclasses.field(default_factory=list)
    notices: List[dict] = dataclasses.field(default_factory=list)

    def canonical(self) -> dict:
        key = lambda e: _canon(e)  # noqa: E731 - stable entry order
        return {
            "schema": CAMPAIGN_SCHEMA,
            "name": str(self.name),
            "seed": int(self.seed),
            "rounds": int(self.rounds),
            "poison_fraction": float(self.poison_fraction),
            "faults": sorted((dict(e) for e in self.faults), key=key),
            "net_faults": sorted((dict(e) for e in self.net_faults),
                                 key=key),
            "notices": sorted((dict(e) for e in self.notices), key=key),
        }

    @property
    def digest(self) -> str:
        return hashlib.sha256(_canon(self.canonical()).encode()
                              ).hexdigest()[:16]

    def manifest(self) -> dict:
        out = self.canonical()
        out["digest"] = self.digest
        return out

    def to_json(self) -> str:
        return _canon(self.manifest())

    @classmethod
    def from_dict(cls, d: dict) -> "Campaign":
        c = cls(name=str(d["name"]), seed=int(d["seed"]),
                rounds=int(d.get("rounds", 8)),
                poison_fraction=float(d.get("poison_fraction", 0.0)),
                faults=[dict(e) for e in d.get("faults") or []],
                net_faults=[dict(e) for e in d.get("net_faults") or []],
                notices=[dict(e) for e in d.get("notices") or []])
        want = d.get("digest")
        if want is not None and want != c.digest:
            raise ValueError(
                f"campaign digest mismatch for {c.name!r}: manifest says "
                f"{want}, entries hash to {c.digest} — the artifact was "
                "edited without re-stamping")
        return c

    @classmethod
    def load(cls, spec) -> "Campaign":
        """Path / inline-JSON (starting ``{``) / dict — the same three
        spec forms the fault plans accept."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls.from_dict(spec)
        text = str(spec)
        if text.lstrip().startswith("{"):
            return cls.from_dict(json.loads(text))
        with open(text, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))


# ---------------------------------------------------------------------------
# seeded campaign sampling


def sample_campaign(seed: int, index: int,
                    cfg: Optional[FuzzConfig] = None) -> Campaign:
    """Deterministically sample campaign ``index`` of run ``seed``: a
    composed draw over every fault family. Entry masks inside the
    executor key off (seed, round) only, so ddmin-removing one entry
    never shifts another's behavior."""
    cfg = cfg or FuzzConfig()
    rng = np.random.RandomState((int(seed) * 1000003 + int(index) * 7919)
                                % (2 ** 31 - 1))
    rounds = int(cfg.rounds)
    c = Campaign(name=f"c{int(seed):04d}_{int(index):03d}", seed=int(seed),
                 rounds=rounds,
                 poison_fraction=(0.25 if rng.random_sample() < 0.3
                                  else 0.0))
    seen = set()

    def _add(bucket, entry):
        k = _canon(entry)
        if k not in seen:
            seen.add(k)
            bucket.append(entry)

    for _ in range(int(rng.randint(0, 4))):
        kind = PROC_KINDS[int(rng.randint(len(PROC_KINDS)))]
        r = 2 + int(rng.randint(rounds - 1))
        g = int(rng.randint(cfg.gateways))
        e = {"kind": kind, "round": r, "gateway": g}
        if kind == "ckpt_corrupt":
            e["mode"] = "torn" if rng.random_sample() < 0.5 else "stomp"
        elif kind == "straggler":
            e["delay_s"] = round(float(0.5 + 2.0 * rng.random_sample()), 3)
        elif kind in ("client_dropout", "nan_update"):
            e.pop("gateway")
            e["frac"] = 0.25
        elif kind == "wal_short_write":
            e["cut"] = 5 + int(rng.randint(40))
        _add(c.faults, e)

    net_pool = ("net_partition", "net_slow_link", "net_torn_frame",
                "net_torn_frame", "net_dup_frame", "net_reset")
    for _ in range(int(rng.randint(0, 4))):
        kind = net_pool[int(rng.randint(len(net_pool)))]
        g = int(rng.randint(cfg.gateways))
        f = 2 + int(rng.randint(rounds + 2))
        e = {"kind": kind, "gateway": g, "frame": f}
        if kind == "net_torn_frame":
            e["boundary"] = ("post_ack" if rng.random_sample() < 0.5
                             else "pre_ack")
            e["cut_bytes"] = 48
        elif kind == "net_reset":
            if rng.random_sample() < 0.3:
                e["phase"] = "accept"
                e["frame"] = 2 + int(rng.randint(3))
            else:
                e["phase"] = "mid"
        elif kind == "net_slow_link":
            e["frames"] = 2
            e["chunk_bytes"] = 128
            e["delay_s"] = 0.0
        elif kind == "net_partition" and rng.random_sample() < 0.25:
            e.pop("frame")
            e["probability"] = 0.25
            e["window"] = [f, f + 4]
        _add(c.net_faults, e)

    if rng.random_sample() < 0.25:
        _add(c.notices, {"kind": "preempt_notice",
                         "round": 2 + int(rng.randint(rounds - 2)),
                         "gateway": int(rng.randint(cfg.gateways))})
    if rng.random_sample() < 0.15:
        _add(c.notices, {"kind": "reshard_shrink",
                         "round": 2 + int(rng.randint(rounds - 2)),
                         "gateway": cfg.gateways - 1})
    return c


# ---------------------------------------------------------------------------
# the deterministic two-gateway campaign executor


def _serving_config(campaign: Campaign, cfg: FuzzConfig):
    from fedtpu_torch.config import ServingConfig
    screen = (campaign.poison_fraction > 0.0
              or any(e.get("kind") == "nan_update"
                     for e in campaign.faults))
    return ServingConfig(cohort=8, buffer_size=2, tick_interval_s=0.5,
                         data_rows=64, model_hidden=(8,), seed=0,
                         screen=screen, screen_warmup=4,
                         quarantine_strikes=3)


def run_campaign(campaign, cfg: Optional[FuzzConfig] = None,
                 workdir: Optional[str] = None, registry=None,
                 replay_stale_wal_tail: bool = False, device="cuda",
                 init_params=None, screen_stats: Optional[dict] = None
                 ) -> dict:
    """Replay one campaign against the deterministic in-process gang.

    Returns ``{"ok", "verdicts", "summary", "lines", "artifact"}`` —
    ``lines`` is the canonical wire/lifecycle JSONL (bitwise across
    same-seed replays), ``artifact`` the canonical verdict JSONL
    (manifest line, one line per oracle verdict, summary line) that the
    corpus gate compares against the committed golden. ``device`` and
    ``init_params`` are every member engine's, at every boot.
    ``screen_stats``, a dict, receives member g's screened ticks under key
    g, every life's in order (``ServingEngine.screen_stats``): what a
    card-vs-CPU comparison reads when a screen decision differs."""
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    from fedtpu_torch.resilience.faults import corrupt_checkpoint
    from fedtpu_torch.serving.admission import ADMITTED
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.server import _handle
    from fedtpu_torch.serving.traces import (poisoned_user_ids,
                                             synthesize_trace)
    from fedtpu_torch.telemetry.metrics import MetricsRegistry

    campaign = Campaign.load(campaign)
    cfg = cfg or FuzzConfig()
    scfg = _serving_config(campaign, cfg)
    own_dir = workdir is None
    wd = workdir or tempfile.mkdtemp(prefix="fedtpu-fuzz-")
    os.makedirs(wd, exist_ok=True)
    reg = registry if registry is not None else MetricsRegistry()

    rounds = int(campaign.rounds)
    per = int(cfg.arrivals_per_round)
    _, t, user, lat = synthesize_trace(
        cfg.users, per * rounds, 4.0 * rounds, seed=campaign.seed)
    attackers = set()
    if campaign.poison_fraction > 0.0:
        attackers = {int(u) for u in poisoned_user_ids(
            cfg.users, campaign.seed, campaign.poison_fraction)}

    faults_at = {}
    for e in campaign.faults:
        faults_at.setdefault(int(e["round"]), []).append(e)
    notices_at = {}
    for e in campaign.notices:
        notices_at.setdefault(int(e["round"]), []).append(e)
    plan = None
    if campaign.net_faults:
        plan = NetFaultPlan.load(
            {"seed": campaign.seed, "faults": campaign.net_faults},
            num_gateways=cfg.gateways)

    lines: List[str] = []
    fired: dict = {}
    merged: dict = {}
    retried = [0]
    total_frames = [0]

    def _line(rec: dict) -> None:
        lines.append(_canon(rec))

    members = []
    for g in range(cfg.gateways):
        members.append({
            "g": g, "engine": None,
            "wal": os.path.join(wd, f"wal_g{g}.jsonl"),
            "ckpt": os.path.join(wd, f"ckpt_g{g}"),
            "nonce": f"fuzz{int(campaign.seed) % 100000:05d}g{g}",
            "frame": 0, "conn": 1, "seq": 0,
            "history": [],      # stamped frames, resent after a crash
            "acked": {},        # seq -> first-ack counts
            "restarts": 0, "exit_codes": [], "departed": False,
            "corrupted_steps": set(), "marks": [],
        })

    def _boot(m) -> None:
        eng = ServingEngine(scfg, registry=reg, device=device,
                            init_params=init_params)
        if screen_stats is not None:
            eng.screen_stats = screen_stats.setdefault(m["g"], [])
        eng.wal_path = m["wal"]
        m["engine"] = eng

    def _recover(m, round_: int) -> List[dict]:
        """Crash recovery: newest RESTORABLE checkpoint (the fallback
        walk), then the WAL tail — but only when the walk landed on the
        newest complete-looking round (module docstring: a stale tail
        replayed onto an older state loses acked updates). Returns the
        client's reconnect frames (hello + resend-all)."""
        _boot(m)
        steps = complete_steps(m["ckpt"])
        restored = None
        for s in reversed(steps):
            try:
                m["engine"].restore(m["ckpt"], step=s)
                restored = s
                break
            except Exception:
                _boot(m)  # a torn load must not leave half a state
        eng = m["engine"]
        tail_valid = (not steps) or (restored == steps[-1])
        replayed = 0
        discarded = False
        if tail_valid or replay_stale_wal_tail:
            replayed = eng.replay_wal()
        elif os.path.exists(m["wal"]):
            open(m["wal"], "w").close()
            discarded = True
        m["restarts"] += 1
        _line({"g": m["g"], "event": "member_recover", "round": round_,
               "restored_step": restored, "wal_replayed": replayed,
               "tail_discarded": discarded})
        return _reconnect(m, resend=True)

    def _reconnect(m, resend: bool = False) -> List[dict]:
        """Bump the connection ordinal (burning accept-phase resets),
        and return the frames to (re)send: a fresh hello, plus — after
        a member restart — the client's full stamped history in order
        (the sessions make resend-all exactly-once)."""
        m["conn"] += 1
        while plan is not None:
            f = plan.at_accept(m["g"], m["conn"])
            if f is None:
                break
            fired[f.kind] = fired.get(f.kind, 0) + 1
            _line({"g": m["g"], "conn": m["conn"], "fault": "net_reset",
                   "phase": "accept", "outcome": "reconnect"})
            m["conn"] += 1
        frames = [{"op": "hello", "v": 1}]
        if resend:
            frames += [dict(fr) for fr in m["history"]]
        return frames

    def _crash(m, rc: int, round_: int, why: str) -> List[dict]:
        m["exit_codes"].append(int(rc))
        _line({"g": m["g"], "event": "member_crash", "round": round_,
               "rc": int(rc), "why": why})
        return _recover(m, round_)

    def _deliver(m, msg: dict, round_: int, kill: bool = False,
                 cut: Optional[int] = None) -> None:
        """Push one frame through the modeled wire + dispatcher,
        mirroring net_sim.simulate: frame ordinals, reconnect hellos,
        retries resending the same stamped seq, lost acks — plus the
        member-crash kinds the single-engine sim cannot express."""
        queue = [msg]
        while queue:
            msg = queue[0]
            m["frame"] += 1
            total_frames[0] += 1
            if total_frames[0] > _MAX_WIRE_FRAMES:
                raise RuntimeError(
                    "fuzz campaign did not converge: the plan swallows "
                    "retries without bound")
            fr = m["frame"]
            fault = plan.at_frame(m["g"], fr) if plan is not None else None
            rec = {"g": m["g"], "frame": fr, "conn": m["conn"],
                   "op": msg.get("op"),
                   "fault": fault.kind if fault else None}
            if "seq" in msg:
                rec["seq"] = msg["seq"]
            lost = fault is not None and (
                fault.kind in ("net_partition", "net_reset")
                or (fault.kind == "net_torn_frame"
                    and fault.boundary == "pre_ack"))
            if lost:
                fired[fault.kind] = fired.get(fault.kind, 0) + 1
                rec["delivered"] = False
                rec["outcome"] = "retry"
                _line(rec)
                retried[0] += 1
                queue[0:0] = _reconnect(m)
                continue
            eng = m["engine"]
            if cut is not None and msg.get("op") == "updates":
                armed_cut = int(cut)
                eng.wal_shortwrite = (
                    lambda nonce, seq, line: armed_cut)
            try:
                resp = _handle(eng, msg)
            except OSError:
                rec["delivered"] = True
                rec["outcome"] = "crash_wal_short_write"
                _line(rec)
                cut = None
                retried[0] += 1
                queue.pop(0)
                rest = queue
                queue = _crash(m, 1, round_, "wal_short_write")
                queue += rest
                continue
            finally:
                eng.wal_shortwrite = None
            rec["delivered"] = True
            if (fault is not None and fault.kind == "net_torn_frame"
                    and fault.boundary == "post_ack"):
                fired[fault.kind] = fired.get(fault.kind, 0) + 1
                rec["outcome"] = "ack_lost"
                _line(rec)
                retried[0] += 1
                queue[0:0] = _reconnect(m)
                continue
            if kill and msg.get("op") == "updates":
                kill = False
                rec["outcome"] = "killed_post_ack"
                _line(rec)
                retried[0] += 1
                queue.pop(0)
                rest = queue
                queue = _crash(m, 137, round_, "process_kill")
                queue += rest
                continue
            queue.pop(0)
            if resp.get("op") == "acks":
                counts = {k: int(v) for k, v in
                          sorted((resp.get("counts") or {}).items())}
                rec["counts"] = counts
                rec["duplicate"] = bool(resp.get("duplicate", False))
                seq = msg.get("seq")
                if seq is not None and seq not in m["acked"]:
                    m["acked"][seq] = counts
                    for k, v in counts.items():
                        merged[k] = merged.get(k, 0) + v
            elif resp.get("op") == "drained":
                rec["incorporated"] = int(resp.get("incorporated", 0))
            if fault is not None and fault.kind == "net_slow_link":
                fired[fault.kind] = fired.get(fault.kind, 0) + 1
                rec["outcome"] = "paced"
            elif fault is not None and fault.kind == "net_dup_frame":
                fired[fault.kind] = fired.get(fault.kind, 0) + 1
                dup = _handle(m["engine"], msg)
                rec["outcome"] = "replayed"
                rec["replay_duplicate"] = bool(
                    dup.get("duplicate", False))
            _line(rec)

    # --- campaign execution -------------------------------------------
    try:
        for m in members:
            _boot(m)
            _deliver(m, {"op": "hello", "v": 1}, 0)

        for r in range(1, rounds + 1):
            for e in notices_at.get(r, []):
                g = int(e.get("gateway", cfg.gateways - 1))
                m = members[g]
                if m["departed"]:
                    continue
                if e["kind"] == "preempt_notice":
                    fired["preempt_notice"] = (
                        fired.get("preempt_notice", 0) + 1)
                    m["engine"].checkpoint(m["ckpt"])
                    m["exit_codes"].append(75)
                    _line({"g": g, "event": "preempt", "round": r})
                    for fr in _recover(m, r):
                        _deliver(m, fr, r)
                elif e["kind"] == "reshard_shrink" and g != 0:
                    fired["reshard_shrink"] = (
                        fired.get("reshard_shrink", 0) + 1)
                    _deliver(m, {"op": "drain"}, r)
                    m["exit_codes"].append(76)
                    m["departed"] = True
                    _line({"g": g, "event": "reshard_shrink", "round": r})

            round_faults = faults_at.get(r, [])
            rows = []
            lo, hi = (r - 1) * per, r * per
            drop_mask = None
            nan_mask = None
            for e in round_faults:
                if e["kind"] == "client_dropout":
                    mrng = np.random.RandomState(
                        (campaign.seed * 31 + r * 7) % (2 ** 31 - 1))
                    drop_mask = mrng.random_sample(hi - lo) < float(
                        e.get("frac", 0.25))
                    fired["client_dropout"] = (
                        fired.get("client_dropout", 0) + 1)
                elif e["kind"] == "nan_update":
                    mrng = np.random.RandomState(
                        (campaign.seed * 37 + r * 11) % (2 ** 31 - 1))
                    nan_mask = mrng.random_sample(hi - lo) < float(
                        e.get("frac", 0.25))
                    fired["nan_update"] = fired.get("nan_update", 0) + 1
            for i in range(lo, hi):
                if drop_mask is not None and drop_mask[i - lo]:
                    continue
                u = int(user[i])
                poison = POISON_SCALE if u in attackers else 0.0
                if nan_mask is not None and nan_mask[i - lo]:
                    poison = NAN_SCALE
                row = [u, float(t[i]), float(lat[i])]
                if poison:
                    row += [None, poison]
                rows.append(row)

            for g in range(cfg.gateways):
                batch = [list(row) for row in rows
                         if int(row[0]) % cfg.gateways == g]
                if not batch:
                    continue
                dest = members[0] if members[g]["departed"] else members[g]
                for e in round_faults:
                    if (e["kind"] == "straggler"
                            and int(e.get("gateway", 0)) == g):
                        fired["straggler"] = fired.get("straggler", 0) + 1
                        for row in batch:
                            row[1] = float(row[1]) + float(
                                e.get("delay_s", 1.0))
                dest["seq"] += 1
                frame = {"op": "updates", "events": batch,
                         "nonce": dest["nonce"], "seq": dest["seq"]}
                dest["history"].append(frame)
                kill = any(e["kind"] == "process_kill"
                           and int(e.get("gateway", 0)) == dest["g"]
                           for e in round_faults)
                cut = next((int(e.get("cut", 16)) for e in round_faults
                            if e["kind"] == "wal_short_write"
                            and int(e.get("gateway", 0)) == dest["g"]),
                           None)
                if kill:
                    fired["process_kill"] = fired.get("process_kill",
                                                      0) + 1
                if cut is not None:
                    fired["wal_short_write"] = fired.get(
                        "wal_short_write", 0) + 1
                _deliver(dest, frame, r, kill=kill, cut=cut)

            for m in members:
                if not m["departed"] and r % cfg.ckpt_every == 0:
                    path = m["engine"].checkpoint(m["ckpt"])
                    _line({"g": m["g"], "event": "ckpt", "round": r,
                           "step": int(os.path.basename(path)
                                       .split("_")[-1])})
            for e in round_faults:
                if e["kind"] != "ckpt_corrupt":
                    continue
                m = members[int(e.get("gateway", 0))]
                step = corrupt_checkpoint(
                    m["ckpt"], mode=e.get("mode", "stomp"),
                    seed=campaign.seed * 31 + r)
                if step is not None:
                    fired["ckpt_corrupt"] = fired.get("ckpt_corrupt",
                                                      0) + 1
                    m["corrupted_steps"].add(int(step))
                _line({"g": m["g"], "event": "ckpt_corrupt", "round": r,
                       "step": step, "mode": e.get("mode", "stomp")})

            for m in members:
                if not m["departed"]:
                    m["marks"].append(int(m["engine"].tick_count))

        for m in members:
            if not m["departed"]:
                _deliver(m, {"op": "drain"}, rounds + 1)
                m["exit_codes"].append(0)

        # --- verdicts -------------------------------------------------
        sigs = [m["engine"].signals() for m in members]
        client_admitted = sum(int(n) for v, n in merged.items()
                              if v in ADMITTED)
        fleet_admitted = sum(int(s["admitted"]) for s in sigs)
        fleet_incorporated = sum(int(s["incorporated"]) for s in sigs)
        fleet_screened = sum(int(m["engine"].screened_total)
                             for m in members)
        backlog = sum(int(s["backlog"]) for s in sigs)
        burns = [s["slo_burn"] for s in sigs
                 if s.get("slo_burn") is not None]
        duplicate_drops = sum(int(m["engine"].duplicate_drops)
                              for m in members)
        quarantined = sorted(
            int(u) for m in members for u in m["engine"].quarantined)
        lost_acked = client_admitted - fleet_incorporated - fleet_screened

        verdicts = [
            oracles.exactly_once(client_admitted, fleet_admitted),
            oracles.no_lost_acked(lost_acked),
            oracles.backlog_drained(backlog),
            oracles.slo_burn_bounded(max(burns) if burns else None,
                                     cfg.burn_budget),
            oracles.exit_contract([m["exit_codes"] for m in members]),
        ]
        for m in members:
            verdicts.append(oracles.monotone_rounds(m["marks"],
                                                    member=m["g"]))
            steps = complete_steps(m["ckpt"])
            if steps and any(s not in m["corrupted_steps"]
                             for s in steps):
                verdicts.append(oracles.checkpoint_restorable(
                    m["ckpt"], label=f"gateway {m['g']}"))
        verdicts.append(oracles.quarantine_containment(
            quarantined, attackers, mode="subset"))

        summary = {
            "digest": campaign.digest,
            "arrivals": per * rounds,
            "wire_frames": int(total_frames[0]),
            "retried": int(retried[0]),
            "fired": {k: int(v) for k, v in sorted(fired.items())},
            "admission": {k: int(v) for k, v in sorted(merged.items())},
            "client_admitted": client_admitted,
            "fleet_admitted": fleet_admitted,
            "incorporated": fleet_incorporated,
            "screened": fleet_screened,
            "duplicate_drops": duplicate_drops,
            "lost_acked": lost_acked,
            "backlog": backlog,
            "quarantined": quarantined,
            "restarts": [int(m["restarts"]) for m in members],
            "exit_codes": [list(m["exit_codes"]) for m in members],
            "plan_digest": plan.digest if plan is not None else None,
        }
        fold = oracles.summarize(verdicts)
        artifact = ([_canon(campaign.manifest())]
                    + [_canon(v.as_dict()) for v in verdicts]
                    + [_canon({"summary": summary, **fold})])
        return {"ok": fold["ok"], "failed": fold["failed"],
                "verdicts": [v.as_dict() for v in verdicts],
                "summary": summary, "lines": lines, "artifact": artifact}
    finally:
        if own_dir:
            shutil.rmtree(wd, ignore_errors=True)


# ---------------------------------------------------------------------------
# ddmin delta-debugging


def _entries_of(campaign: Campaign) -> List[tuple]:
    return ([("faults", dict(e)) for e in campaign.faults]
            + [("net_faults", dict(e)) for e in campaign.net_faults]
            + [("notices", dict(e)) for e in campaign.notices])


def _with_entries(campaign: Campaign, entries: List[tuple]) -> Campaign:
    c = Campaign(name=campaign.name, seed=campaign.seed,
                 rounds=campaign.rounds,
                 poison_fraction=campaign.poison_fraction)
    for bucket, e in entries:
        getattr(c, bucket).append(dict(e))
    return c


def shrink_campaign(campaign, predicate: Optional[Callable] = None,
                    cfg: Optional[FuzzConfig] = None,
                    max_runs: int = 64, device="cuda",
                    init_params=None) -> dict:
    """ddmin over the campaign's fault entries: find a (1-minimal)
    subset that still satisfies ``predicate`` (default: the campaign
    fails at least one oracle on ``device``), re-running the gang per
    step. Returns ``{"campaign", "runs", "removed"}``."""
    campaign = Campaign.load(campaign)
    cfg = cfg or FuzzConfig()
    runs = [0]

    def _default(c: Campaign) -> bool:
        try:
            return not run_campaign(c, cfg=cfg, device=device,
                                    init_params=init_params)["ok"]
        except RuntimeError:
            return True  # a non-converging subset still reproduces

    inner = predicate or _default

    def _fails(c: Campaign) -> bool:
        runs[0] += 1
        if runs[0] > max_runs:
            raise RuntimeError(f"ddmin exceeded {max_runs} runs")
        return bool(inner(c))

    entries = _entries_of(campaign)
    n = 2
    while len(entries) >= 2:
        chunk = max(1, len(entries) // n)
        reduced = False
        for i in range(0, len(entries), chunk):
            rest = entries[:i] + entries[i + chunk:]
            if not rest:
                continue
            cand = _with_entries(campaign, rest)
            if _fails(cand):
                entries = rest
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(entries):
                break
            n = min(len(entries), n * 2)
    return {"campaign": _with_entries(campaign, entries),
            "runs": runs[0],
            "removed": (len(_entries_of(campaign)) - len(entries))}


# ---------------------------------------------------------------------------
# fuzz runs, corpus


def emit_event(events, kind: str, payload: dict) -> None:
    """Append one Tracer-shaped event (``{"v", "kind", "payload"}``) to
    ``events`` — a JSONL path or a tracer with ``.event`` — so ``report``
    reads a fuzz sink and a shared fleet sink identically."""
    if isinstance(events, str):
        with open(events, "a", encoding="utf-8") as fh:
            fh.write(_canon({"v": 1, "kind": kind,
                             "payload": payload}) + "\n")
    elif events is not None:
        events.event(kind, **payload)


def run_fuzz(budget: Optional[int] = None, seed: Optional[int] = None,
             cfg: Optional[FuzzConfig] = None,
             out_dir: Optional[str] = None,
             events: Optional[object] = None,
             shrink: Optional[bool] = None, device="cuda",
             init_params=None) -> dict:
    """Sample and replay ``budget`` campaigns on ``device``; shrink every
    failure to a minimal reproducer (written to ``out_dir`` when given,
    next to its verdict golden). ``events`` (a tracer with ``.event`` or
    a path) receives one ``fuzz_campaign`` event per campaign for
    ``report``."""
    gang = dict(device=device, init_params=init_params)
    cfg = cfg or FuzzConfig()
    budget = cfg.budget if budget is None else int(budget)
    seed = cfg.seed if seed is None else int(seed)
    do_shrink = cfg.shrink if shrink is None else bool(shrink)

    def _event(payload: dict) -> None:
        kind = payload.pop("kind")
        emit_event(events, kind, payload)

    rows = []
    reproducers = []
    for i in range(budget):
        c = sample_campaign(seed, i, cfg=cfg)
        try:
            res = run_campaign(c, cfg=cfg, **gang)
            row = {"name": c.name, "digest": c.digest,
                   "ok": res["ok"], "failed": res["failed"],
                   "entries": len(_entries_of(c)),
                   "fired": res["summary"]["fired"]}
        except RuntimeError as e:
            res = None
            row = {"name": c.name, "digest": c.digest, "ok": False,
                   "failed": ["executor"], "error": str(e),
                   "entries": len(_entries_of(c))}
        if not row["ok"] and do_shrink:
            mini = shrink_campaign(c, cfg=cfg, **gang)
            mc = mini["campaign"]
            mc.name = f"{c.name}_min"
            row["shrunk_entries"] = len(_entries_of(mc))
            row["shrink_runs"] = mini["runs"]
            row["minimized"] = mc.manifest()
            if out_dir:
                try:
                    mres = run_campaign(mc, cfg=cfg, **gang)
                    art = mres["artifact"]
                except RuntimeError:
                    art = [mc.to_json()]
                paths = write_corpus_entry(mc, art, out_dir)
                row["reproducer"] = paths["campaign"]
                reproducers.append(paths["campaign"])
        rows.append(row)
        _event({"kind": "fuzz_campaign", **row})
    report = {
        "ok": all(r["ok"] or "minimized" in r for r in rows),
        "campaigns": len(rows),
        "passed": sum(1 for r in rows if r["ok"]),
        "failed": [r["name"] for r in rows if not r["ok"]],
        "reproducers": reproducers,
        "seed": seed,
        "rows": rows,
    }
    _event({"kind": "fuzz_run",
            **{k: report[k] for k in ("ok", "campaigns", "passed",
                                      "failed", "seed")}})
    return report


def write_corpus_entry(campaign, artifact_lines: List[str],
                       corpus_dir: str) -> dict:
    """Commit one campaign + its bitwise verdict golden to the corpus."""
    campaign = Campaign.load(campaign)
    os.makedirs(corpus_dir, exist_ok=True)
    cpath = os.path.join(corpus_dir, f"{campaign.name}.json")
    with open(cpath, "w", encoding="utf-8") as fh:
        json.dump(campaign.manifest(), fh, sort_keys=True, indent=2)
        fh.write("\n")
    gpath = os.path.join(corpus_dir, f"{campaign.name}.golden.jsonl")
    write_decisions(gpath, artifact_lines)
    return {"campaign": cpath, "golden": gpath}


def run_corpus(corpus_dir: Optional[str] = None,
               cfg: Optional[FuzzConfig] = None, device="cuda",
               init_params=None) -> dict:
    """The corpus gate: every committed campaign must (a) carry a digest
    matching its entries, (b) pass every oracle, (c) replay bitwise — two
    same-seed runs on ``device`` produce byte-identical wire lines AND
    verdict artifacts — and (d) match its committed verdict golden. A
    directory with no campaign fails."""
    cfg = cfg or FuzzConfig()
    cdir = corpus_dir or DEFAULT_CORPUS_DIR
    files = sorted(glob.glob(os.path.join(cdir, "*.json")))
    rows = []
    for path in files:
        name = os.path.basename(path)[:-len(".json")]
        row = {"name": name, "ok": False, "reason": ""}
        try:
            c = Campaign.load(path)
        except (ValueError, KeyError, OSError) as e:
            row["reason"] = f"{type(e).__name__}: {e}"
            rows.append(row)
            continue
        row["digest"] = c.digest
        try:
            a, b = (run_campaign(c, cfg=cfg, device=device,
                                 init_params=init_params)
                    for _ in range(2))
        except RuntimeError as e:
            row["reason"] = f"executor: {e}"
            rows.append(row)
            continue
        bitwise = (a["lines"] == b["lines"]
                   and a["artifact"] == b["artifact"])
        golden = os.path.join(cdir, f"{name}.golden.jsonl")
        if not os.path.exists(golden):
            cmp = {"ok": False, "reason": f"missing golden {name}"}
        else:
            cmp = compare_decisions(a["artifact"], golden)
        row.update({
            "oracles_ok": a["ok"], "failed": a["failed"],
            "replay_bitwise": bitwise, "golden_ok": cmp["ok"],
            "ok": a["ok"] and bitwise and cmp["ok"],
            "reason": ("" if a["ok"] and bitwise and cmp["ok"] else
                       (cmp.get("reason") or
                        ("replay not bitwise" if not bitwise else
                         f"oracles failed: {a['failed']}"))),
        })
        rows.append(row)
    return {"ok": bool(rows) and all(r["ok"] for r in rows),
            "corpus": cdir, "campaigns": len(rows), "rows": rows,
            **({} if rows else {"reason": f"no campaigns under {cdir}"})}


__all__ = [
    "Campaign", "sample_campaign", "run_campaign", "shrink_campaign",
    "run_fuzz", "run_corpus", "write_corpus_entry", "write_decisions",
    "compare_decisions", "PROC_KINDS", "NOTICE_KINDS",
    "DEFAULT_CORPUS_DIR", "CAMPAIGN_SCHEMA",
]
