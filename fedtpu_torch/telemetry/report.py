"""Offline aggregation of a telemetry events JSONL (the port's copy of
``fedtpu.telemetry.report``; ``python -m fedtpu_torch.cli report``).

Reconstructs — from the event log ALONE, no run state needed — the
per-phase time breakdown, round-cadence percentiles, staleness
distribution, and counter/gauge totals, rendered as text, JSON, or a
Prometheus text-exposition snapshot for scraping.

numpy + stdlib only: the report must work on a machine with no card (the
log was produced on the GPU's host; the analysis runs anywhere). The
rendered bytes are ``fedtpu report``'s for the same log. Unknown event kinds and newer schema versions degrade to a warning line,
never a crash — logs outlive the code that wrote them.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from fedtpu_torch.telemetry.trace import EVENT_SCHEMA_VERSION


def load_events(path: str) -> Tuple[List[dict], int]:
    """Parse a JSONL sink; returns (events, malformed_line_count). A
    truncated final line (crash mid-write) is counted, not fatal."""
    events, bad = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict) and "kind" in rec:
                events.append(rec)
            else:
                bad += 1
    return events, bad


def _percentiles(durs: List[float]) -> dict:
    a = np.asarray(durs, dtype=np.float64)
    return {"p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "p99_s": float(np.percentile(a, 99)),
            "mean_s": float(a.mean()),
            "max_s": float(a.max())}


def _merge_counts(dicts) -> dict:
    """Sum a stream of {key: count} dicts into one sorted tally."""
    total: dict = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + int(v)
    return dict(sorted(total.items()))


def aggregate(events: List[dict], malformed: int = 0) -> dict:
    """One pass over the events into the report dict (see module
    docstring). Counter/gauge/histogram totals come from the LAST
    ``counters`` event — each is a full registry snapshot, so the last one
    is the run's final tally."""
    phases: dict = {}
    round_durs: List[float] = []
    round_nums: List[int] = []
    round_max = 0
    stale_means: List[float] = []
    manifest = None
    last_counters = None
    run_ids = []
    identities = []
    newer_schema = 0
    faults: List[dict] = []
    rollbacks: List[dict] = []
    exclusions: List[dict] = []
    restarts: List[dict] = []
    gang_restarts: List[dict] = []
    collective_hangs: List[dict] = []
    child_exits: List[dict] = []
    reshards: List[dict] = []
    reshard_failures: List[dict] = []
    reshard_degraded: List[dict] = []
    preempted_rounds: List[int] = []
    resume_rounds: List[int] = []
    diverged_at: Optional[dict] = None
    supervisor_exit: Optional[dict] = None
    serve_ticks = 0
    serve_start: Optional[dict] = None
    serve_last: Optional[dict] = None
    serve_summary: Optional[dict] = None
    starvation: List[dict] = []
    cohort_rounds = 0
    cohort_last: Optional[dict] = None
    cohort_config: Optional[dict] = None
    cohort_summary: Optional[dict] = None
    cohort_stall_s = 0.0
    autoscale_ticks = 0
    autoscale_kinds: dict = {}
    autoscale_acts: dict = {}
    autoscale_pre_drains: List[dict] = []
    autoscale_summary: Optional[dict] = None
    serve_pre_drains: List[dict] = []
    serve_configures = 0
    screened_events = 0
    screened_updates = 0
    quarantines: List[dict] = []
    net_faults: List[dict] = []
    netproxy_summaries: List[dict] = []
    fuzz_campaigns: List[dict] = []
    fuzz_run: Optional[dict] = None
    for e in events:
        v = e.get("v")
        if isinstance(v, int) and v > EVENT_SCHEMA_VERSION:
            newer_schema += 1
        rid = e.get("run_id")
        if rid and rid not in run_ids:
            run_ids.append(rid)
        # v2 identity keying: a merged fleet report must distinguish
        # sources by (run_id, role, process_index) — gateway sinks
        # restored from one checkpoint lineage (or pinned test runs)
        # legitimately COLLIDE on run_id alone. v1 events key as the
        # (0, 'run') defaults.
        if rid:
            ident = (rid, e.get("role") or "run",
                     int(e.get("process_index") or 0))
            if ident not in identities:
                identities.append(ident)
        kind = e.get("kind")
        payload = e.get("payload") or {}
        if kind == "span" and e.get("phase"):
            p = phases.setdefault(e["phase"],
                                  {"count": 0, "total_s": 0.0, "max_s": 0.0})
            d = float(e.get("dur_s") or 0.0)
            p["count"] += 1
            p["total_s"] += d
            p["max_s"] = max(p["max_s"], d)
        elif kind == "round":
            round_durs.append(float(e.get("dur_s") or 0.0))
            round_nums.append(int(e.get("round") or 0))
            if e.get("round"):
                round_max = max(round_max, int(e["round"]))
            if payload.get("staleness_mean") is not None:
                stale_means.append(float(payload["staleness_mean"]))
        elif kind == "manifest":
            manifest = payload
        elif kind == "counters":
            last_counters = payload
        # Resilience timeline (fedtpu.resilience; docs/resilience.md).
        # Supervisor events and in-run fault/rollback events usually share
        # one sink, so the report sees the whole incident end to end.
        elif kind == "fault":
            faults.append({"round": e.get("round"), **payload})
        elif kind == "rollback":
            rollbacks.append({"round": e.get("round"), **payload})
        elif kind == "exclusion":
            exclusions.append({"round": e.get("round"), **payload})
        elif kind == "restart":
            restarts.append(payload)
        elif kind == "gang_restart":
            gang_restarts.append(payload)
        elif kind == "collective_hang":
            collective_hangs.append({"round": e.get("round"), **payload})
        elif kind == "child_exit":
            child_exits.append(payload)
        # Elastic reshard timeline (fedtpu.resilience.reshard): a
        # completed reshard is a topology change WITHOUT a restart, so it
        # gets its own rows instead of riding gang_restart. The done
        # event's per-leaf plan steps collapse to totals here — the
        # report answers "what moved, how much, when", not "which leaf".
        elif kind == "reshard_done":
            steps = payload.get("steps") or []
            reshards.append({
                "round": e.get("round"),
                "mode": payload.get("mode"),
                "target_clients": payload.get("target"),
                "moved_leaves": len(steps),
                "moved_bytes": sum(int(s.get("nbytes") or 0)
                                   for s in steps),
                "join_rows": sum(int(s.get("join_rows") or 0)
                                 for s in steps)})
        elif kind == "reshard_failed":
            reshard_failures.append({"round": e.get("round"), **payload})
        elif kind == "reshard_degraded":
            reshard_degraded.append({"round": e.get("round"), **payload})
        elif kind == "preempted":
            preempted_rounds.append(int(e.get("round") or 0))
        elif kind == "resume":
            resume_rounds.append(int(e.get("round") or 0))
        elif kind == "diverged":
            diverged_at = {"round": e.get("round"), **payload}
        elif kind == "supervisor_exit":
            supervisor_exit = payload
        # Serving timeline (fedtpu.serving; docs/serving.md). The drain
        # summary carries the authoritative SLO numbers (admission
        # counts, update-to-incorporation percentiles, rounds/sec);
        # per-tick events supply the cadence when a run died pre-drain.
        elif kind == "serve_start":
            # LAST start wins: a supervised restart re-emits it, and the
            # current launch's identity (gateway index, generation) is
            # the one the merged fleet view should group by.
            serve_start = dict(payload)
        elif kind == "serve_tick":
            serve_ticks += 1
            serve_last = {"tick": e.get("round"), **payload}
        elif kind == "serve_summary":
            serve_summary = {"tick": e.get("round"), **payload}
        elif kind == "async_starvation":
            starvation.append({"round": e.get("round"), **payload})
        # Defense timeline (fedtpu.robust; docs/robustness.md): one
        # serve_screened event per tick that screened anything, one
        # serve_quarantine event per quarantined user id.
        elif kind == "serve_screened":
            screened_events += 1
            screened_updates += int(payload.get("n_screened") or 0)
        elif kind == "serve_quarantine":
            quarantines.append({"tick": e.get("round"), **payload})
        # Cohort timeline (fedtpu.cohort; docs/scaling.md). The summary
        # carries the end-of-run store footprint; per-round events supply
        # the cadence and resident-bytes trajectory when a run died early.
        elif kind == "cohort_config":
            cohort_config = payload
        elif kind == "cohort_round":
            cohort_rounds += 1
            cohort_last = {"round": e.get("round"), **payload}
            cohort_stall_s += float(payload.get("prefetch_stall_s") or 0.0)
        elif kind == "cohort_summary":
            cohort_summary = payload
        # Autoscale timeline (fedtpu.autoscale; docs/autoscale.md). One
        # decision event per control tick; act events record what the
        # controller actually did to the deployment.
        elif kind == "autoscale_decision":
            autoscale_ticks += 1
            for d in payload.get("decisions") or []:
                dk = d.get("kind")
                autoscale_kinds[dk] = autoscale_kinds.get(dk, 0) + 1
        elif kind == "autoscale_act":
            ak = payload.get("decision")
            autoscale_acts[ak] = autoscale_acts.get(ak, 0) + 1
        elif kind == "autoscale_pre_drain":
            autoscale_pre_drains.append(payload)
        elif kind == "autoscale_summary":
            autoscale_summary = payload
        elif kind == "serve_pre_drain":
            serve_pre_drains.append({"tick": e.get("round"), **payload})
        elif kind == "serve_configure":
            serve_configures += 1
        # Network timeline (fedtpu.serving.netproxy; docs/resilience.md):
        # one net_fault event per fired wire fault, one netproxy_summary
        # per proxied gateway at drain.
        elif kind == "net_fault":
            net_faults.append(payload)
        elif kind == "netproxy_summary":
            netproxy_summaries.append(payload)
        # Fuzz timeline (fedtpu.resilience.fuzz; docs/resilience.md):
        # one fuzz_campaign event per replayed campaign, one fuzz_run
        # summary at the end of the sweep.
        elif kind == "fuzz_campaign":
            fuzz_campaigns.append(payload)
        elif kind == "fuzz_run":
            fuzz_run = payload

    out: dict = {
        "events_total": len(events),
        "malformed_lines": malformed,
        "newer_schema_events": newer_schema,
        "run_ids": run_ids,
        "identities": [{"run_id": r, "role": ro, "process_index": p}
                       for r, ro, p in sorted(identities,
                                              key=lambda i: (i[1], i[2],
                                                             i[0]))],
        "manifest": None,
        "phases": {k: {**v, "mean_s": v["total_s"] / v["count"]}
                   for k, v in sorted(phases.items())},
        "rounds": {"count": len(round_durs), "last_round": round_max},
        "staleness": None,
        "counters": {}, "gauges": {}, "histograms": {},
        "resilience": None,
        "network": None,
        "serving": None,
        "cohort": None,
        "autoscale": None,
        "static_analysis": None,
        "fuzz": None,
    }
    if fuzz_campaigns or fuzz_run:
        violations = [c for c in fuzz_campaigns if not c.get("ok")]
        # Which oracle tripped, how often — the violation histogram is
        # the fuzzer's headline (what KIND of bug the space holds).
        oracle_hits: dict = {}
        for c in violations:
            for o in c.get("failed") or []:
                oracle_hits[o] = oracle_hits.get(o, 0) + 1
        out["fuzz"] = {
            "campaigns": len(fuzz_campaigns),
            "passed": sum(1 for c in fuzz_campaigns if c.get("ok")),
            "violations": [
                {"name": c.get("name"), "digest": c.get("digest"),
                 "failed": c.get("failed"),
                 "shrunk_entries": c.get("shrunk_entries"),
                 "reproducer": c.get("reproducer")}
                for c in violations],
            "failed_oracles": dict(sorted(oracle_hits.items())),
            "fired": _merge_counts(c.get("fired") or {}
                                   for c in fuzz_campaigns),
            "summary": fuzz_run,
        }
    if (autoscale_ticks or autoscale_acts or autoscale_summary
            or autoscale_pre_drains or serve_pre_drains or serve_configures):
        out["autoscale"] = {
            "control_ticks": autoscale_ticks,
            "decisions": dict(sorted(autoscale_kinds.items())),
            "acted": dict(sorted(autoscale_acts.items())),
            "pre_drains": autoscale_pre_drains,
            "serve_pre_drains": serve_pre_drains,
            "serve_configures": serve_configures,
            "summary": autoscale_summary,
        }
    if serve_ticks or serve_summary or starvation or serve_start:
        out["serving"] = {
            "ticks": serve_ticks,
            "start": serve_start,
            "last_tick": serve_last,
            "summary": serve_summary,
            "starvation": starvation,
        }
        if screened_events or quarantines:
            out["serving"]["defense"] = {
                "screened_ticks": screened_events,
                "screened_updates": screened_updates,
                "quarantines": quarantines,
                "quarantined_users": sorted(
                    {int(q["user"]) for q in quarantines
                     if q.get("user") is not None}),
            }
    if cohort_rounds or cohort_config or cohort_summary:
        out["cohort"] = {
            "rounds": cohort_rounds,
            "config": cohort_config,
            "last_round": cohort_last,
            "summary": cohort_summary,
            "prefetch_stall_s_total": cohort_stall_s,
        }
    if manifest:
        out["manifest"] = {k: manifest.get(k) for k in
                           ("config_hash", "package_version", "jax_version",
                            "backend", "device_count", "device_kinds",
                            "mesh_shape", "git_rev", "process_count",
                            "program", "engine", "restarts", "fault_plan")
                           if manifest.get(k) is not None}
        # The run's program-audit stamp (orchestration/loop.py manifest
        # wiring): schedule digest + comm bytes of the width-1 round.
        if manifest.get("audit"):
            out["static_analysis"] = manifest["audit"]
        # MPMD DAG shape (run.mpmd): which sub-programs ran at what
        # chunk width — the report's key for reading the per-sub-program
        # trace spans against the right schedule.
        if manifest.get("mpmd"):
            out["manifest"]["mpmd"] = manifest["mpmd"]
    # Device-time attribution (docs/observability.md): join the
    # manifest's static XLA cost model (flops / bytes accessed of the
    # width-1 round, orchestration/loop.py manifest wiring) with the
    # measured per-round durations into per-round MFU / roofline rows.
    # Without a hardware peak (FEDTPU_PEAK_FLOPS at run time) the rows
    # still carry achieved FLOP/s and arithmetic intensity — just no
    # MFU ratio. Pinned reference numbers live in benchmarks/RESULTS.md.
    prof = (manifest or {}).get("profile")
    if prof and not prof.get("error"):
        flops = float(prof.get("flops_per_round") or 0.0)
        bytes_rw = float(prof.get("bytes_per_round") or 0.0)
        peak = prof.get("peak_flops")
        rows = []
        if flops > 0:
            for rnd, d in zip(round_nums, round_durs):
                if d <= 0:
                    continue
                row = {"round": rnd, "dur_s": d,
                       "achieved_flops_per_s": flops / d}
                if peak:
                    row["mfu"] = flops / d / float(peak)
                rows.append(row)
        out["profile"] = {
            "flops_per_round": flops,
            "bytes_per_round": bytes_rw,
            "arithmetic_intensity": (flops / bytes_rw if bytes_rw
                                     else None),
            "peak_flops": (float(peak) if peak else None),
            "profile_rounds": prof.get("profile_rounds"),
            "rounds": rows,
        }
        if rows:
            ach = np.asarray([r["achieved_flops_per_s"] for r in rows])
            out["profile"]["achieved_flops_per_s"] = {
                "mean": float(ach.mean()), "max": float(ach.max())}
            if peak:
                out["profile"]["mfu"] = {
                    "mean": float(ach.mean() / float(peak)),
                    "max": float(ach.max() / float(peak))}
    if (faults or rollbacks or exclusions or restarts or gang_restarts
            or collective_hangs or child_exits or preempted_rounds
            or resume_rounds or diverged_at or supervisor_exit
            or reshards or reshard_failures or reshard_degraded):
        out["resilience"] = {
            "faults": faults,
            "rollbacks": rollbacks,
            "exclusions": exclusions,
            "restarts": len(restarts),
            "gang_restarts": len(gang_restarts),
            "collective_hangs": collective_hangs,
            "child_exit_codes": [c.get("rc") for c in child_exits],
            "reshards": reshards,
            "reshard_failures": reshard_failures,
            "reshard_degraded": reshard_degraded,
            "preempted_rounds": preempted_rounds,
            "resume_rounds": resume_rounds,
            "diverged": diverged_at,
            "supervisor_exit": supervisor_exit,
        }
    if round_durs:
        out["rounds"]["total_s"] = float(np.sum(round_durs))
        out["rounds"]["cadence"] = _percentiles(round_durs)
    if last_counters:
        out["counters"] = dict(last_counters.get("counters") or {})
        out["gauges"] = dict(last_counters.get("gauges") or {})
        out["histograms"] = dict(last_counters.get("histograms") or {})
    # Built AFTER the counters fold so the wire-fault view can sit next
    # to the server-side counters the faults are supposed to move
    # (redirects followed, duplicate frames dropped, oversized lines).
    if net_faults or netproxy_summaries:
        per_gateway: dict = {}
        for f in net_faults:
            g = int(f.get("gateway") or 0)
            row = per_gateway.setdefault(g, {})
            k = f.get("fault") or "unknown"
            row[k] = row.get(k, 0) + 1
        out["network"] = {
            "faults": len(net_faults),
            "per_gateway": {g: dict(sorted(v.items()))
                            for g, v in sorted(per_gateway.items())},
            "proxies": [
                {k: s.get(k) for k in ("gateway", "digest", "connections",
                                       "frames", "relayed_frames",
                                       "frame_bytes", "fired")}
                for s in netproxy_summaries],
            "redirects": out["counters"].get("gateway_redirects"),
            "duplicate_drops": out["counters"].get("serve_duplicate_drop"),
            "oversized_lines": out["counters"].get("serve_oversized_lines"),
        }
    hist = out["histograms"].get("staleness")
    if hist or stale_means:
        out["staleness"] = {
            **({"count": hist["count"], "mean": hist["mean"],
                "min": hist["min"], "max": hist["max"],
                "bins": hist["bins"],
                "bucket_counts": hist["bucket_counts"]} if hist else {}),
            **({"round_mean_of_means": float(np.mean(stale_means))}
               if stale_means else {}),
        }
    return out


def render_text(agg: dict) -> str:
    lines = ["fedtpu telemetry report",
             f"  events: {agg['events_total']}"
             + (f" ({agg['malformed_lines']} malformed lines skipped)"
                if agg["malformed_lines"] else "")]
    if agg.get("newer_schema_events"):
        lines.append(f"  warning: {agg['newer_schema_events']} events carry "
                     f"a schema newer than v{EVENT_SCHEMA_VERSION} — "
                     "fields this reader doesn't know are ignored")
    if agg.get("run_ids"):
        lines.append(f"  run_id: {', '.join(agg['run_ids'])}")
    idents = agg.get("identities") or []
    if len(idents) > 1:
        # More sources than run_ids == the v2 identity did its job:
        # same-run_id sinks split by (role, process_index).
        lines.append("  sources: " + ", ".join(
            f"{i['role']}/p{i['process_index']}" for i in idents))
    man = agg.get("manifest")
    if man:
        lines.append("  manifest: " + ", ".join(
            f"{k}={man[k]}" for k in sorted(man)))
    sa = agg.get("static_analysis")
    if sa:
        if "error" in sa:
            lines.append(f"static analysis: audit failed ({sa['error']})")
        else:
            lines.append(
                f"static analysis: engine={sa.get('engine')} "
                f"schedule={sa.get('schedule_digest')} "
                f"collectives={sa.get('collectives')} "
                f"comm={sa.get('comm_bytes_per_round')}B/round "
                f"findings={sa.get('findings')}")
    ph = agg.get("phases") or {}
    if ph:
        lines.append("phase breakdown:")
        width = max(len(k) for k in ph)
        for k, v in sorted(ph.items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {k:<{width}}  total {v['total_s']:9.3f} s  "
                         f"x{v['count']:<5d} mean {v['mean_s']:.4f} s  "
                         f"max {v['max_s']:.4f} s")
    prof = agg.get("profile")
    if prof:
        lines.append("device-time attribution:")
        ai = prof.get("arithmetic_intensity")
        lines.append(f"  cost model: {prof['flops_per_round']:.3e} "
                     f"FLOPs/round, {prof['bytes_per_round']:.3e} B/round"
                     + (f", intensity {ai:.2f} FLOP/B" if ai else ""))
        if prof.get("peak_flops"):
            lines.append(f"  peak: {prof['peak_flops']:.3e} FLOP/s")
        mfu = prof.get("mfu")
        ach = prof.get("achieved_flops_per_s")
        if ach:
            lines.append(f"  achieved: mean {ach['mean']:.3e} FLOP/s, "
                         f"max {ach['max']:.3e} FLOP/s"
                         + (f"  (MFU mean {mfu['mean'] * 100:.2f}%, "
                            f"max {mfu['max'] * 100:.2f}%)" if mfu else ""))
        rows = prof.get("rounds") or []
        for r in rows[:8]:
            lines.append(f"    round {r['round']}: {r['dur_s']:.4f} s, "
                         f"{r['achieved_flops_per_s']:.3e} FLOP/s"
                         + (f", MFU {r['mfu'] * 100:.2f}%"
                            if r.get("mfu") is not None else ""))
        if len(rows) > 8:
            lines.append(f"    ... {len(rows) - 8} more round(s)")
    rounds = agg.get("rounds") or {}
    if rounds.get("count"):
        c = rounds.get("cadence") or {}
        lines.append(f"rounds: {rounds['count']} "
                     f"(last round {rounds.get('last_round')}, "
                     f"total {rounds.get('total_s', 0.0):.3f} s)")
        if c:
            lines.append(f"  cadence p50 {c['p50_s']:.4f} s  "
                         f"p90 {c['p90_s']:.4f} s  p99 {c['p99_s']:.4f} s  "
                         f"mean {c['mean_s']:.4f} s  max {c['max_s']:.4f} s")
    st = agg.get("staleness")
    if st:
        if st.get("count"):
            lines.append(f"staleness: {st['count']} observations, "
                         f"mean {st['mean']:.3f}, min {st['min']:.0f}, "
                         f"max {st['max']:.0f}")
            lines.append("  histogram (<= bound: count): " + ", ".join(
                f"{b:g}: {n}" for b, n in zip(st["bins"],
                                              st["bucket_counts"])))
        elif st.get("round_mean_of_means") is not None:
            lines.append(f"staleness: mean-of-round-means "
                         f"{st['round_mean_of_means']:.3f}")
    res = agg.get("resilience")
    if res:
        lines.append("resilience:")
        for f in res.get("faults") or []:
            detail = ", ".join(f"{k}={f[k]}" for k in sorted(f)
                               if k not in ("fault", "fault_round", "round"))
            lines.append(f"  fault {f.get('fault')} @ round {f.get('round')}"
                         + (f" ({detail})" if detail else ""))
        for rb in res.get("rollbacks") or []:
            lines.append(f"  rollback @ round {rb.get('round')} -> "
                         f"restored round {rb.get('restored_round')} "
                         f"(attempt {rb.get('attempt')}, "
                         f"reason: {rb.get('reason')})")
        for ex in res.get("exclusions") or []:
            lines.append(f"  excluded clients {ex.get('clients')} "
                         f"@ round {ex.get('round')}")
        for ch in res.get("collective_hangs") or []:
            lines.append(f"  COLLECTIVE HANG @ round {ch.get('round')}: "
                         f"process {ch.get('process')} stuck in "
                         f"{ch.get('phase')} for {ch.get('waited_s')} s "
                         f"(timeout {ch.get('timeout_s')} s) -> exit 75")
        for rs in res.get("reshards") or []:
            mb = (rs.get("moved_bytes") or 0) / 2**20
            lines.append(f"  reshard {rs.get('mode')} @ round "
                         f"{rs.get('round')} -> "
                         f"{rs.get('target_clients')} client(s): "
                         f"{rs.get('moved_leaves')} leaves, "
                         f"~{mb:.2f} MiB placed, "
                         f"{rs.get('join_rows')} join row(s), no restart")
        for rf in res.get("reshard_failures") or []:
            lines.append(f"  RESHARD FAILED @ round {rf.get('round')}: "
                         f"{rf.get('error')} -> gang-restart fallback")
        for rd in res.get("reshard_degraded") or []:
            lines.append(f"  reshard degraded to checkpoint drain @ round "
                         f"{rd.get('round')} (config cannot live-reshard)")
        if res.get("restarts"):
            lines.append(f"  supervisor restarts: {res['restarts']} "
                         f"(child exit codes: "
                         f"{res.get('child_exit_codes')})")
        if res.get("gang_restarts"):
            lines.append(f"  gang restarts: {res['gang_restarts']} "
                         f"(child exit codes: "
                         f"{res.get('child_exit_codes')})")
        if res.get("preempted_rounds"):
            lines.append("  preempted (graceful drain) at rounds: "
                         f"{res['preempted_rounds']}")
        if res.get("resume_rounds"):
            lines.append(f"  resumed at rounds: {res['resume_rounds']}")
        if res.get("diverged"):
            d = res["diverged"]
            lines.append(f"  DIVERGED @ round {d.get('round')}: "
                         f"{d.get('reason')}")
        if res.get("supervisor_exit"):
            se = res["supervisor_exit"]
            lines.append(f"  supervisor exit: rc={se.get('rc')} "
                         f"reason={se.get('reason')}")
    hbs = agg.get("heartbeats")
    if hbs:
        if not res:
            lines.append("resilience:")
        for hb in hbs:
            lines.append(f"  heartbeat p{hb.get('process')}: "
                         f"{hb.get('status')}")
    net = agg.get("network")
    if net:
        lines.append("network (wire faults):")
        for g, kinds in sorted((net.get("per_gateway") or {}).items()):
            detail = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
            lines.append(f"  gateway {g}: {detail}")
        for p in net.get("proxies") or []:
            # connections - 1 = reconnects forced onto this gateway's
            # clients; frames - relayed_frames = frames the wire ate.
            lines.append(
                f"  proxy g{p.get('gateway')} [{p.get('digest')}]: "
                f"{p.get('connections')} conn(s), "
                f"{p.get('frames')} frame(s) "
                f"({p.get('relayed_frames')} relayed, "
                f"{p.get('frame_bytes')} B)")
        for key in ("redirects", "duplicate_drops", "oversized_lines"):
            if net.get(key) is not None:
                lines.append(f"  {key}: {net[key]:g}")
    fz = agg.get("fuzz")
    if fz:
        lines.append("fuzz (compositional chaos campaigns):")
        lines.append(f"  campaigns: {fz.get('campaigns')} "
                     f"({fz.get('passed')} passed all oracles)")
        fired = ", ".join(f"{k}={v}" for k, v in
                          sorted((fz.get("fired") or {}).items()))
        if fired:
            lines.append(f"  faults fired: {fired}")
        oh = fz.get("failed_oracles") or {}
        if oh:
            lines.append("  failed oracles: " + ", ".join(
                f"{k}={v}" for k, v in sorted(oh.items())))
        for v in fz.get("violations") or []:
            tail = (f" -> {v['shrunk_entries']}-entry reproducer"
                    if v.get("shrunk_entries") is not None else "")
            lines.append(f"  VIOLATION {v.get('name')} "
                         f"[{v.get('digest')}]: "
                         f"{', '.join(v.get('failed') or [])}{tail}")
            if v.get("reproducer"):
                lines.append(f"    committed: {v['reproducer']}")
    srv = agg.get("serving")
    if srv:
        lines.append("serving:")
        summ = srv.get("summary") or srv.get("last_tick") or {}
        if srv.get("ticks") or summ.get("ticks"):
            lines.append(f"  ticks: {summ.get('ticks', srv['ticks'])} "
                         f"(incorporated {summ.get('incorporated', '?')} "
                         f"update(s), version {summ.get('version', '?')})")
        adm = summ.get("admission")
        if adm:
            lines.append("  admission: " + ", ".join(
                f"{k}={adm[k]:g}" for k in sorted(adm)))
        lat = summ.get("update_to_incorporation")
        if lat:
            lines.append(f"  update_to_incorporation p50 {lat['p50_s']:.4f} s"
                         f"  p90 {lat['p90_s']:.4f} s  "
                         f"p99 {lat['p99_s']:.4f} s  "
                         f"mean {lat['mean_s']:.4f} s  "
                         f"max {lat['max_s']:.4f} s")
        if summ.get("rounds_per_sec") is not None:
            lines.append(f"  rounds/sec under load: "
                         f"{summ['rounds_per_sec']:.2f} "
                         f"({summ.get('wall_s', 0.0):.2f} s wall)")
        for sv in srv.get("starvation") or []:
            lines.append(f"  K-BUFFER STARVATION @ tick {sv.get('round')}: "
                         f"{sv.get('pending')} buffered update(s) never "
                         f"reached buffer_size {sv.get('buffer_size')}")
        defense = srv.get("defense")
        if defense:
            lines.append(f"  defense: {defense['screened_updates']} "
                         f"screened update(s) over "
                         f"{defense['screened_ticks']} tick(s), "
                         f"{len(defense['quarantined_users'])} user(s) "
                         f"quarantined")
            for q in defense.get("quarantines") or []:
                lines.append(f"    QUARANTINED user {q.get('user')} @ tick "
                             f"{q.get('tick')} (t {q.get('t_virtual')}, "
                             f"{q.get('strikes')} strike(s))")
    coh = agg.get("cohort")
    if coh:
        lines.append("cohort:")
        conf = coh.get("config") or {}
        if conf:
            lines.append(f"  config: cohort_size {conf.get('cohort_size')} "
                         f"of {conf.get('total_clients')} clients, "
                         f"store {conf.get('store')}, "
                         f"sampling {conf.get('sampling')}, "
                         f"{conf.get('cohorts_per_step')} cohort(s)/step")
        summ = coh.get("summary") or coh.get("last_round") or {}
        if coh.get("rounds") or summ.get("rounds"):
            lines.append(f"  rounds: {summ.get('rounds', coh['rounds'])} "
                         f"(touched {summ.get('touched_records', '?')} "
                         f"client record(s))")
        if summ.get("store_resident_bytes") is not None:
            res_mb = summ["store_resident_bytes"] / 2**20
            app_mb = (summ.get("store_apparent_bytes")
                      or conf.get("store_apparent_bytes") or 0) / 2**20
            lines.append(f"  store: resident ~{res_mb:.1f} MiB "
                         f"(apparent {app_mb:.1f} MiB)")
        if coh.get("prefetch_stall_s_total") or summ.get("prefetch_stalls"):
            lines.append(f"  prefetch: {summ.get('prefetch_stalls', '?')} "
                         f"stall(s), "
                         f"{coh.get('prefetch_stall_s_total', 0.0):.3f} s "
                         "stalled total")
    asc = agg.get("autoscale")
    if asc:
        lines.append("autoscale:")
        dec = ", ".join(f"{k}={v}" for k, v in
                        sorted((asc.get("decisions") or {}).items()))
        lines.append(f"  control ticks: {asc.get('control_ticks')}"
                     + (f" ({dec})" if dec else ""))
        act = ", ".join(f"{k}={v}" for k, v in
                        sorted((asc.get("acted") or {}).items()))
        if act:
            lines.append(f"  acted: {act}")
        for pd in asc.get("pre_drains") or []:
            lines.append(f"  pre-drain victim p{pd.get('victim')}: "
                         f"{pd.get('spooled')} update(s) spooled "
                         f"-> {pd.get('path')}")
        for pd in asc.get("serve_pre_drains") or []:
            lines.append(f"  server spool @ tick {pd.get('tick')}: "
                         f"{pd.get('spooled')} update(s) -> "
                         f"{pd.get('path')}")
        if asc.get("serve_configures"):
            lines.append(f"  server reconfigures: "
                         f"{asc['serve_configures']}")
        summ = asc.get("summary")
        if summ:
            lines.append("  summary: " + ", ".join(
                f"{k}={summ[k]}" for k in sorted(summ)
                if not isinstance(summ[k], (dict, list))))
    fleet = agg.get("gateway_fleet")
    if fleet:
        lines.append("gateway fleet (merged):")
        lines.append("  gateways: " + ", ".join(
            str(g) for g in fleet["gateways"]))
        if fleet.get("admission"):
            lines.append("  admission: " + ", ".join(
                f"{k}={fleet['admission'][k]:g}"
                for k in sorted(fleet["admission"])))
        lines.append(f"  incorporated: {fleet['incorporated']}")
        lines.append(f"  duplicate_drops: {fleet['duplicate_drops']}")
        if fleet.get("slo_burn_max") is not None:
            lines.append(f"  slo_burn (worst member): "
                         f"{fleet['slo_burn_max']:.3f}")
    srcs = agg.get("sources")
    if srcs:
        lines.append("per-source view:")
        for s in srcs:
            tag = (f" [gateway {s['gateway']}]"
                   if s.get("gateway") is not None
                   else f" [{s['role']}]"
                   if s.get("role") and s["role"] != "run" else "")
            lines.append(f"  {s['path']}{tag}: {s['events']} event(s)")
            adm = s.get("admission")
            if adm:
                lines.append("    admission: " + ", ".join(
                    f"{k}={adm[k]:g}" for k in sorted(adm)))
            lat = s.get("update_to_incorporation")
            if lat:
                lines.append(f"    update_to_incorporation "
                             f"p50 {lat['p50_s']:.4f} s  "
                             f"p99 {lat['p99_s']:.4f} s")
            if s.get("slo_burn") is not None:
                lines.append(f"    slo_burn: {s['slo_burn']:.3f}")
    if agg.get("counters"):
        lines.append("counters:")
        for k, v in sorted(agg["counters"].items()):
            lines.append(f"  {k} = {v:g}")
    if agg.get("gauges"):
        lines.append("gauges:")
        for k, v in sorted(agg["gauges"].items()):
            lines.append(f"  {k} = {v:g}")
    return "\n".join(lines)


def _prom_name(name: str) -> str:
    return "fedtpu_" + "".join(c if c.isalnum() or c == "_" else "_"
                               for c in name)


def render_prometheus(agg: dict) -> str:
    """Prometheus text-exposition snapshot of the aggregated log — a file
    a textfile-collector / pushgateway setup can scrape as-is."""
    lines: List[str] = []

    def emit(name, value, typ, labels=""):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} {typ}")
        lines.append(f"{n}{labels} {value:g}")

    for k, v in sorted((agg.get("counters") or {}).items()):
        emit(k + "_total", v, "counter")
    for k, v in sorted((agg.get("gauges") or {}).items()):
        emit(k, v, "gauge")
    for k, v in sorted((agg.get("phases") or {}).items()):
        emit(f"phase_{k}_seconds_total", v["total_s"], "counter")
        emit(f"phase_{k}_spans_total", v["count"], "counter")
    cadence = (agg.get("rounds") or {}).get("cadence")
    if cadence:
        for q, key in (("0.5", "p50_s"), ("0.9", "p90_s"),
                       ("0.99", "p99_s")):
            n = _prom_name("round_duration_seconds")
            lines.append(f'{n}{{quantile="{q}"}} {cadence[key]:g}')
    # Serving SLO quantiles from the drain summary (the exact-percentile
    # view; the cumulative-bucket histogram below is the scrapeable one).
    srv_lat = ((agg.get("serving") or {}).get("summary")
               or {}).get("update_to_incorporation")
    if srv_lat:
        n = _prom_name("update_to_incorporation_seconds")
        for q, key in (("0.5", "p50_s"), ("0.9", "p90_s"),
                       ("0.99", "p99_s")):
            lines.append(f'{n}{{quantile="{q}"}} {srv_lat[key]:g}')
    # Defense section (fedtpu.robust; docs/robustness.md): screening +
    # quarantine census. These lived only in the text report before —
    # a scrape-driven alert ("quarantines > 0") needs them here.
    defense = (agg.get("serving") or {}).get("defense")
    if defense:
        emit("screened_updates_total",
             defense.get("screened_updates") or 0, "counter")
        emit("quarantined_users",
             len(defense.get("quarantined_users") or []), "gauge")
    # Network section (fedtpu.serving.netproxy): per-gateway wire-fault
    # firing counts, labeled like the merged fleet view groups them.
    net = agg.get("network")
    if net and net.get("per_gateway"):
        n = _prom_name("net_faults_fired_total")
        lines.append(f"# TYPE {n} counter")
        for g, kinds in sorted(net["per_gateway"].items()):
            lines.append(f'{n}{{gateway="{g}"}} '
                         f'{sum(kinds.values()):g}')
    # Device-time attribution: the roofline numbers as gauges, so a
    # dashboard can trend MFU across runs.
    prof = agg.get("profile")
    if prof:
        emit("model_flops_per_round", prof.get("flops_per_round") or 0,
             "gauge")
        if prof.get("mfu"):
            emit("mfu_mean", prof["mfu"]["mean"], "gauge")
            emit("mfu_max", prof["mfu"]["max"], "gauge")
    for name, h in sorted((agg.get("histograms") or {}).items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        for b, c in zip(h["bins"], h["bucket_counts"]):
            lines.append(f'{n}_bucket{{le="{b:g}"}} {c}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{n}_sum {h['sum']:g}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"


def _source_view(path: str, events: List[dict], bad: int) -> dict:
    """The per-source admission/SLO slice of one log — what the merged
    report shows next to the combined numbers. Gateway sources (a
    ``serve_start`` carrying a fleet index) additionally expose the
    identity + dedup/incorporation totals the merged fleet view sums."""
    agg = aggregate(events, malformed=bad)
    srv = agg.get("serving") or {}
    summ = srv.get("summary") or srv.get("last_tick") or {}
    signals = summ.get("signals") or {}
    start = srv.get("start") or {}
    # Gateway identity: the serve_start payload when the run got that
    # far, else the v2 role stamp ('gateway-<i>') any event carries —
    # a member that crashed pre-start (or whose run_id collides with a
    # sibling's) still lands in the right fleet slot.
    gateway = start.get("gateway")
    role = None
    process_index = None
    for e in events:
        if role is None and e.get("role"):
            role = e["role"]
            process_index = int(e.get("process_index") or 0)
        if gateway is None and str(e.get("role") or "").startswith(
                "gateway-"):
            try:
                gateway = int(str(e["role"]).rsplit("-", 1)[1])
            except ValueError:
                pass
        if role is not None and gateway is not None:
            break
    return {"path": path, "events": len(events),
            "gateway": gateway,
            "role": role or "run",
            "process_index": process_index or 0,
            "admission": summ.get("admission"),
            "incorporated": summ.get("incorporated"),
            "duplicate_drops": summ.get("duplicate_drops"),
            "update_to_incorporation": summ.get("update_to_incorporation"),
            "slo_burn": signals.get("slo_burn")}


def _fleet_view(sources: List[dict]) -> dict:
    """The merged admission/SLO view over >= 2 gateway sources: summed
    admission counts, incorporation and dedup totals, and the WORST
    member's SLO burn (a fleet meets its objective only if every shard
    does)."""
    admission: dict = {}
    for s in sources:
        for k, v in (s.get("admission") or {}).items():
            admission[k] = admission.get(k, 0) + int(v)
    burns = [s["slo_burn"] for s in sources
             if s.get("slo_burn") is not None]
    return {
        "gateways": sorted(int(s["gateway"]) for s in sources),
        "admission": admission,
        "incorporated": sum(int(s.get("incorporated") or 0)
                            for s in sources),
        "duplicate_drops": sum(int(s.get("duplicate_drops") or 0)
                               for s in sources),
        "slo_burn_max": max(burns) if burns else None,
    }


def render_report(path, fmt: str = "text",
                  heartbeat: Optional[str] = None,
                  process_count: int = 0) -> Tuple[str, str]:
    """CLI entry: returns (rendered report in ``fmt``, Prometheus text).
    Both derive from one aggregation pass over the log.

    ``path`` may be one JSONL path or a list of them — multiple sinks
    (a serve log + a gang log + a controller log) merge into one
    combined aggregation plus a per-source admission/SLO view.
    ``heartbeat`` + ``process_count`` add live supervisor heartbeat
    status rows (serving/parked/stale/missing) to the resilience
    section.
    """
    paths = [path] if isinstance(path, str) else list(path)
    per_source = []
    events: List[dict] = []
    bad = 0
    for p in paths:
        ev, b = load_events(p)
        per_source.append((p, ev, b))
        events.extend(ev)
        bad += b
    agg = aggregate(events, malformed=bad)
    if len(paths) > 1:
        agg["sources"] = [_source_view(p, ev, b)
                          for p, ev, b in per_source]
        fleet = [s for s in agg["sources"]
                 if s.get("gateway") is not None]
        if len(fleet) >= 2:
            agg["gateway_fleet"] = _fleet_view(fleet)
    if heartbeat:
        from fedtpu_torch.autoscale.signals import read_gang_members
        agg["heartbeats"] = [
            {"process": idx, "status": status}
            for idx, status in read_gang_members(
                heartbeat, max(1, process_count))]
    if fmt == "json":
        rendered = json.dumps(agg, indent=2, sort_keys=True)
    else:
        rendered = render_text(agg)
    return rendered, render_prometheus(agg)
