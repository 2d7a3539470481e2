"""Causal fleet timeline (the port's copy of ``fedtpu.telemetry.timeline``;
``python -m fedtpu_torch.cli timeline``).

Merges N heterogeneous observability artifacts into ONE ordered fleet
view:

    * events JSONL sinks (schema v1/v2; ``fedtpu_torch.telemetry.trace``) —
      the run loop, the serving engines, the gateway fleet, the
      supervisor; v2 lines carry the ``(process_index, role)`` identity
      this merger keys on, v1 lines read with the (0, 'run') defaults;
    * netproxy decision logs (``*.netlog``;
      ``fedtpu_torch.serving.netproxy``) — schedule header, one line per
      fired wire fault in firing order, summary;
    * autoscale decision logs (``fedtpu_torch.autoscale.policy
      .decision_line`` canonical JSONL) — one line per control tick.

Two renderers:

    * **deterministic JSONL** (:func:`deterministic_lines`) — every
      wall-clock / process-identity accident (``t_start``, ``dur_s``,
      ``pid``, ``run_id``, ``launch_id``) stripped, payloads reduced to
      the :data:`PAYLOAD_WHITELIST` of virtual-time-deterministic
      fields, sources emitted in sorted-label order, and one ``chain``
      row per ``trace_id`` giving the update's causal stage sequence
      (client_stamp -> wal -> admit -> buffer_insert -> incorporate,
      with dedup_drop on the retry path). Canonical ``json.dumps``
      (sorted keys, no whitespace) so byte comparison IS the replay
      check — the timeline sim gates a pinned
      two-gateway campaign against ``tests/goldens/timeline_sim.jsonl``
      this way (see :mod:`fedtpu_torch.telemetry.timeline_sim`).

    * **Chrome trace JSON** (:func:`chrome_trace`) — load in Perfetto
      or ``chrome://tracing``. One trace pid per source, spans as
      complete ('X') events on the wall clock, instants for everything
      else, and flow arrows stitching each trace_id's stages across
      processes.

stdlib-only (not even numpy): like the report, the timeline of a
run on the card must render on a machine with no card.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from fedtpu_torch.telemetry.report import load_events

# Causal stage order of one update's trace chain. Within one engine
# tick the stages can only advance left to right; dedup_drop is the
# retry path's terminal stage (the original verdict was already acked).
# The MPMD trio (client_step → aggregate → metrics) is one chunk's pass
# through the DAG of sub-programs; appended at the END so existing
# goldens' ranks never move.
STAGES = ("client_stamp", "wal", "dedup_drop", "admit",
          "buffer_insert", "incorporate",
          "client_step", "aggregate", "metrics")
_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}

# Payload fields that are pure functions of the virtual-time campaign —
# the ONLY payload fields the deterministic renderer keeps. Everything
# else (wall seconds, percentile dicts, counter snapshots, paths) is an
# accident of the host that ran the campaign.
PAYLOAD_WHITELIST = frozenset({
    "trace_id", "user", "seq", "nonce", "verdict", "tick", "events",
    "gateway", "fault", "reason", "elig_tick", "t_virtual", "op",
    "rounds", "rc", "version", "decisions", "t", "incorporated",
    "pending", "n_screened", "frame", "conn", "outcome", "delivered",
    "duplicate", "strikes", "notice", "backlog",
})


# ---------------------------------------------------------------------------
# loading / classification


def _parse_jsonl(path: str) -> Tuple[List[dict], int]:
    recs, bad = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(obj, dict):
                recs.append(obj)
            else:
                bad += 1
    return recs, bad


def classify(path: str, records: List[dict]) -> str:
    """'events' | 'netlog' | 'decisions' — by filename convention first
    (``*.netlog`` is the proxy's contract), then by line shape."""
    if path.endswith(".netlog"):
        return "netlog"
    for rec in records:
        if "kind" in rec:
            return "events"
        if "decisions" in rec and "version" in rec:
            return "decisions"
        if "digest" in rec and "gateway" in rec:
            return "netlog"
    return "events"


def _source_label(kind: str, records: List[dict], path: str) -> str:
    """The deterministic display label: a role, never a path (temp-dir
    names must not leak into goldens)."""
    if kind == "netlog":
        g = next((r.get("gateway") for r in records
                  if r.get("gateway") is not None), None)
        return f"proxy-{g}" if g is not None else "proxy"
    if kind == "decisions":
        return "autoscale"
    for rec in records:
        role = rec.get("role")
        if role:
            p = rec.get("process_index")
            # Roles that already carry a fleet index ('gateway-1') stay
            # as-is; the generic 'run' role disambiguates by process.
            return (f"{role}.p{p}" if p and not role[-1:].isdigit()
                    else role)
    return "run"


def load_timeline(paths) -> List[dict]:
    """Load + classify each artifact. Returns one source dict per path:
    ``{"path", "type", "label", "records", "malformed"}``, sorted by
    label (ties broken by input order) so the merged view is stable no
    matter the argv order."""
    sources = []
    for order, path in enumerate(paths):
        if path.endswith(".netlog"):
            records, bad = _parse_jsonl(path)
            kind = "netlog"
        else:
            kind_guess, bad_guess = _parse_jsonl(path)
            kind = classify(path, kind_guess)
            if kind == "events":
                records, bad = load_events(path)
            else:
                records, bad = kind_guess, bad_guess
        sources.append({"path": path, "type": kind,
                        "label": _source_label(kind, records, path),
                        "records": records, "malformed": bad,
                        "order": order})
    sources.sort(key=lambda s: (s["label"], s["order"]))
    return sources


# ---------------------------------------------------------------------------
# causal chains


def trace_chains(sources: List[dict]) -> List[dict]:
    """Group every ``kind == 'trace'`` event by trace_id into causal
    chains. Stage order inside a chain: (engine tick, stage rank,
    source label, file position) — ticks are the virtual clock, the
    stage rank breaks same-tick ties causally."""
    by_id: Dict[str, List[tuple]] = {}
    for src in sources:
        if src["type"] != "events":
            continue
        for pos, rec in enumerate(src["records"]):
            if rec.get("kind") != "trace":
                continue
            payload = rec.get("payload") or {}
            tid = payload.get("trace_id")
            if not tid:
                continue
            stage = rec.get("phase")
            entry = {"stage": stage, "role": rec.get("role", "run"),
                     "round": rec.get("round")}
            for k in ("user", "seq", "nonce", "verdict", "events",
                      "t_virtual", "elig_tick", "op"):
                if payload.get(k) is not None:
                    entry[k] = payload[k]
            by_id.setdefault(str(tid), []).append(
                (rec.get("round") or 0,
                 _STAGE_RANK.get(stage, len(STAGES)),
                 src["label"], pos, entry))
    chains = []
    for tid in sorted(by_id):
        keyed = sorted(by_id[tid], key=lambda x: x[:4])
        chains.append({"chain": tid, "stages": [k[-1] for k in keyed]})
    return chains


# ---------------------------------------------------------------------------
# deterministic renderer (the goldenable one)


def _det_payload(payload: dict) -> dict:
    return {k: payload[k] for k in sorted(payload)
            if k in PAYLOAD_WHITELIST and payload[k] is not None}


def _det_row(src: dict, idx: int, rec: dict) -> Optional[dict]:
    if src["type"] == "events":
        row = {"src": src["label"], "i": idx, "kind": rec.get("kind"),
               "role": rec.get("role", "run")}
        if rec.get("phase") is not None:
            row["phase"] = rec["phase"]
        if rec.get("round") is not None:
            row["round"] = rec["round"]
        x = _det_payload(rec.get("payload") or {})
        if x:
            row["x"] = x
        return row
    if src["type"] == "netlog":
        # Proxy lines are deterministic by construction (ordinal
        # arithmetic, no wall clock) — pass them through whole.
        return {"src": src["label"], "i": idx, "kind": "netlog", "x": rec}
    if src["type"] == "decisions":
        return {"src": src["label"], "i": idx, "kind": "autoscale_decision",
                "x": {k: rec[k] for k in ("version", "t", "decisions")
                      if k in rec}}
    return None


def deterministic_lines(sources: List[dict]) -> List[str]:
    """The goldenable canonical-JSONL rendering (module docstring):
    one header line per source, every record as a wall-clock-free row
    in file order, then one ``chain`` row per trace_id."""
    rows: List[dict] = []
    for src in sources:
        rows.append({"source": src["label"], "type": src["type"],
                     "records": len(src["records"])})
        for idx, rec in enumerate(src["records"]):
            row = _det_row(src, idx, rec)
            if row is not None:
                rows.append(row)
    rows.extend(trace_chains(sources))
    return [json.dumps(r, sort_keys=True, separators=(",", ":"))
            for r in rows]


# ---------------------------------------------------------------------------
# Chrome trace renderer (the human one)


def _flow_id(tid: str) -> int:
    try:
        return int(tid, 16) & 0x7FFFFFFF
    except ValueError:
        return abs(hash(tid)) & 0x7FFFFFFF


def chrome_trace(sources: List[dict]) -> dict:
    """Chrome trace-event JSON ('traceEvents' array format): open in
    Perfetto / chrome://tracing. One pid per source; spans become
    complete ('X') slices on each source's own monotonic clock,
    everything else an instant; each trace_id's stages are stitched
    with flow ('s'/'t'/'f') arrows so one update reads as one arrowed
    path across the fleet's tracks."""
    events: List[dict] = []
    flow_seen: Dict[str, int] = {}
    flow_total: Dict[str, int] = {}
    for src in sources:
        if src["type"] == "events":
            for rec in src["records"]:
                tid = (rec.get("payload") or {}).get("trace_id")
                if rec.get("kind") == "trace" and tid:
                    flow_total[str(tid)] = flow_total.get(str(tid), 0) + 1
    for pid, src in enumerate(sources):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": src["label"]}})
        for idx, rec in enumerate(src["records"]):
            if src["type"] == "events":
                ts = float(rec.get("t_start") or 0.0) * 1e6
                dur = float(rec.get("dur_s") or 0.0) * 1e6
                payload = rec.get("payload") or {}
                name = rec.get("kind") or "event"
                if rec.get("phase"):
                    name = f"{name}:{rec['phase']}"
                base = {"pid": pid, "tid": 0, "name": name, "ts": ts,
                        "cat": rec.get("kind") or "event",
                        "args": {k: v for k, v in payload.items()
                                 if isinstance(v, (int, float, str, bool))}}
                if rec.get("round") is not None:
                    base["args"]["round"] = rec["round"]
                if dur > 0:
                    events.append({**base, "ph": "X", "dur": dur})
                else:
                    events.append({**base, "ph": "i", "s": "t"})
                tid = payload.get("trace_id")
                if rec.get("kind") == "trace" and tid:
                    tid = str(tid)
                    seen = flow_seen.get(tid, 0)
                    flow_seen[tid] = seen + 1
                    ph = ("s" if seen == 0
                          else "f" if seen + 1 == flow_total.get(tid, 0)
                          else "t")
                    flow = {"ph": ph, "pid": pid, "tid": 0,
                            "name": f"trace:{tid}", "cat": "trace",
                            "id": _flow_id(tid), "ts": ts}
                    if ph == "f":
                        flow["bp"] = "e"
                    events.append(flow)
            elif src["type"] == "netlog":
                # The proxy log has no wall clock — its ordinal (frame
                # number when present, else line index) IS its time
                # axis, rendered as microseconds.
                ts = float(rec.get("frame", idx))
                name = (rec.get("fault") or
                        ("summary" if "summary" in rec else "header"))
                events.append({"ph": "i", "s": "t", "pid": pid, "tid": 0,
                               "name": f"net:{name}", "cat": "netlog",
                               "ts": ts,
                               "args": {k: v for k, v in rec.items()
                                        if isinstance(v, (int, float,
                                                          str, bool))}})
            elif src["type"] == "decisions":
                ts = float(rec.get("t") or 0.0) * 1e6
                kinds = ",".join(d.get("kind", "?")
                                 for d in rec.get("decisions") or []) or "hold"
                events.append({"ph": "i", "s": "t", "pid": pid, "tid": 0,
                               "name": f"autoscale:{kinds}",
                               "cat": "autoscale", "ts": ts,
                               "args": {"version": rec.get("version"),
                                        "t": rec.get("t")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# CLI entry


def render_timeline(paths, fmt: str = "jsonl") -> str:
    """``fedtpu timeline`` body: merge ``paths`` and render. ``fmt``
    'jsonl' gives the deterministic canonical lines, 'chrome' the
    Perfetto-loadable JSON."""
    sources = load_timeline(paths)
    if fmt == "chrome":
        return json.dumps(chrome_trace(sources), indent=1, sort_keys=True)
    return "\n".join(deterministic_lines(sources))


def default_artifacts(events_path: str) -> List[str]:
    """Expand one events path into every sibling artifact the fleet
    convention derives from it: per-gateway sinks (``*.g<i>``),
    per-process sinks (``*.p<i>``), netproxy logs (``*.g<i>.netlog``).
    Lets ``fedtpu timeline events.jsonl`` pick up a whole fleet."""
    out = [events_path]
    d = os.path.dirname(events_path) or "."
    base = os.path.basename(events_path)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if name == base:
            continue
        stem = name.rsplit(".netlog", 1)[0] if name.endswith(".netlog") \
            else name
        core = stem.rsplit(".g", 1)[0] if ".g" in stem else stem
        core = core.rsplit(".p", 1)[0] if ".p" in core else core
        if core == base:
            out.append(os.path.join(d, name))
    return out


__all__ = ["STAGES", "PAYLOAD_WHITELIST", "load_timeline", "classify",
           "trace_chains", "deterministic_lines", "chrome_trace",
           "render_timeline", "default_artifacts"]
