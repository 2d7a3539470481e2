"""``chaos``: the resilience scenario matrix end to end
(``fedtpu.resilience.chaos``, its single-process rows).

Each scenario runs the SAME small synthetic training job twice — once
uninterrupted (the baseline, shared across scenarios) and once with a
deterministic fault plan (``fedtpu_torch.resilience.faults``), supervised
where the fault kills the process — then checks the recovery contract:

  sigkill       SIGKILL mid-round; ``supervise`` restarts with --resume.
                Survive + per-round metric history bitwise == baseline.
  preempt       SIGTERM mid-round; the loop drains a checkpoint and
                exits 75; restart without backoff. Same bar as sigkill.
  nan_rollback  NaN poisoned into one client's update; ``--on-divergence
                rollback`` restores the last good checkpoint and replays.
                Survive + history bitwise == baseline (the replay is
                round-keyed, so recovery is exact, not approximate).
  dropout       One client's mask zeroed for one round. Survive, prefix
                history bitwise == baseline, and the faulted round MUST
                differ (a dropout that changes nothing isn't a dropout).
  straggler     One client sleeps mid-round. Survive + history bitwise
                == baseline (wall-clock only; the math is untouched).

The registry holds every row of ``fedtpu``'s matrix; the others raise when
asked for, naming their ROADMAP item: the gang, elastic-reshard and
autoscale rows (``mp``, ``reshard``, ``autoscale``) A10; the gateway,
poisoning and wire rows (``gateway``, ``poison``, ``net``) A11b, second
part. With no ``scenarios`` the five single-process rows run.

"History" is the ``--metrics-jsonl`` per-round record with timing
stripped. Restarted and rolled-back runs append re-executed rounds to the
same sink, so the comparison takes the LAST record per round.

Every child is a subprocess (``python -m fedtpu_torch.cli``): the parent
imports neither torch nor numpy and survives whatever the scenario does to
the child; ``platform`` is the children's (``default`` = the GPU). Restart
and rollback counts are read back from the shared ``--events`` sink
through ``fedtpu_torch.telemetry.report``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

from fedtpu_torch.resilience import oracles

# THE scenario registry (fedtpu's, whole): every chaos row's name, family
# tags and one-line help. ``SCENARIOS``, the rows the port runs and the
# CLI's ``--scenarios`` help derive from it. Family tags: ``mp`` (training
# gang), ``reshard`` (elastic subset of mp), ``autoscale``, ``gateway``
# (ingestion fleet), ``poison``, ``net`` (wire faults); the single-process
# rows carry no tag.
SCENARIO_REGISTRY = (
    ("sigkill", (), "SIGKILL mid-round; supervisor restarts, replay"),
    ("preempt", (), "SIGTERM drain; checkpoint + exit 75, resume"),
    ("nan_rollback", (), "NaN divergence; rollback to last good round"),
    ("dropout", (), "client dropout round; exact zero-weight exclusion"),
    ("straggler", (), "slow client; lockstep timing-only perturbation"),
    ("mp_kill_worker", ("mp",), "gang worker SIGKILL; gang restart"),
    ("mp_kill_coordinator", ("mp",), "gang coordinator SIGKILL"),
    ("mp_hang", ("mp",), "collective wedge; watchdog abort + restart"),
    ("mp_preempt", ("mp",), "gang-wide SIGTERM; drain + gang resume"),
    ("mp_shrink", ("mp", "reshard"), "preempt notice; live shrink"),
    ("mp_grow", ("mp", "reshard"), "notice canceled; live grow-back"),
    ("mp_shrink_dead", ("mp", "reshard"),
     "shrink then departed process dies; no restart owed"),
    ("mp_autoscale_preempt", ("autoscale",),
     "serve + gang + live autoscaler through a preemption"),
    ("mp_gateway_kill", ("gateway",),
     "gateway SIGKILL mid-ingest; WAL/session exactly-once"),
    ("mp_store_shard_kill", ("gateway",),
     "store shard failover; flush/adopt, run-twice bitwise bar"),
    ("mp_poison_campaign", ("poison",),
     "poisoning campaign; quarantine containment vs clean run"),
    ("mp_net_partition", ("net",),
     "wire partition window + replayed frame; retry through blackhole"),
    ("mp_slow_gateway", ("net",),
     "bandwidth/latency caps + torn ack; paced link, dedup on retry"),
    ("mp_torn_frame", ("net",),
     "frames torn both sides of the WAL/ack boundary + mid-batch RST"),
)


def _family(tag: str) -> tuple:
    return tuple(n for n, fams, _ in SCENARIO_REGISTRY if tag in fams)


def scenarios_help() -> str:
    """The ``--scenarios`` help text, grouped by family — derived from
    the registry so help can never omit a row (fedtpu's, word for
    word)."""
    groups = [("single-process", tuple(n for n, fams, _ in SCENARIO_REGISTRY
                                       if not fams))]
    for tag, label in (("mp", "MP gang"), ("reshard", "RESHARD subset"),
                       ("autoscale", "AUTOSCALE"), ("gateway", "GATEWAY"),
                       ("poison", "POISON"), ("net", "NET wire")):
        groups.append((label, _family(tag)))
    parts = [f"{label}: {', '.join(names)}" for label, names in groups
             if names]
    return ("comma-separated subset to run. " + "; ".join(parts)
            + ". Default: all")


SCENARIOS = tuple(n for n, _, _ in SCENARIO_REGISTRY)
# The rows the port runs: one process each (under the single supervisor).
SINGLE_PROCESS_SCENARIOS = tuple(n for n, fams, _ in SCENARIO_REGISTRY
                                 if not fams)

# Metric-history fields compared across runs (sec_per_round is wall
# clock — the one thing faults are ALLOWED to change).
_HIST_KEYS = ("client_mean", "pooled", "loss_mean")


def _not_ported_row(name: str) -> None:
    """Raise for a row the port does not run yet, naming its item."""
    from fedtpu_torch.config import _not_ported
    fams = dict((n, f) for n, f, _ in SCENARIO_REGISTRY)[name]
    item = ("A10" if set(fams) & {"mp", "reshard", "autoscale"}
            else "A11b, second part")
    _not_ported(f"chaos scenario {name!r}", item)


def _fault_round(rounds: int) -> int:
    """Mid-run, 1-based — late enough that a checkpoint precedes it,
    early enough that recovery has rounds left to prove itself on."""
    return max(2, rounds // 2 + 1)


def _plan(rounds: int, kind: str) -> str:
    k = _fault_round(rounds)
    faults = {
        "sigkill": [{"kind": "process_kill", "round": k,
                     "signal": "SIGKILL"}],
        "preempt": [{"kind": "process_kill", "round": k,
                     "signal": "SIGTERM"}],
        "nan_rollback": [{"kind": "nan_update", "round": k,
                          "clients": [1]}],
        "dropout": [{"kind": "client_dropout", "round": k, "clients": [1]}],
        "straggler": [{"kind": "straggler", "round": k, "clients": [0],
                       "delay_s": 0.25}],
    }[kind]
    return json.dumps({"seed": 0, "faults": faults})


def _run_args(workdir: str, tag: str, rounds: int, num_clients: int,
              platform: str, hidden_sizes: Sequence[int] = (16,),
              synthetic_rows: Optional[int] = None) -> List[str]:
    out = ["run", "--csv", "", "--platform", platform,
           "--rounds", str(rounds), "--num-clients", str(num_clients),
           "--hidden-sizes", ",".join(str(h) for h in hidden_sizes),
           "--quiet", "--json",
           "--metrics-jsonl", os.path.join(workdir, f"{tag}.metrics.jsonl"),
           "--events", os.path.join(workdir, f"{tag}.events.jsonl")]
    if synthetic_rows is not None:
        out += ["--synthetic-rows", str(synthetic_rows)]
    return out


def _history(path: str) -> dict:
    """round -> timing-stripped metric record, LAST occurrence winning
    (restart/rollback replays re-append the rounds they redo)."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                      # torn final line from a kill
            out[rec["round"]] = {k: rec[k] for k in _HIST_KEYS if k in rec}
    return out


def _resilience(events_path: str) -> dict:
    from fedtpu_torch.telemetry.report import aggregate, load_events
    events, bad = load_events(events_path)
    return aggregate(events, malformed=bad).get("resilience") or {}


def run_scenario(name: str, workdir: str, baseline: dict, rounds: int,
                 num_clients: int, platform: str, timeout: int,
                 hidden_sizes: Sequence[int] = (16,),
                 synthetic_rows: Optional[int] = None) -> dict:
    """One scenario run + verdict row (see the module docstring for the
    bars)."""
    if name not in SINGLE_PROCESS_SCENARIOS:
        _not_ported_row(name)
    ck = os.path.join(workdir, f"{name}.ck")
    run_args = _run_args(workdir, name, rounds, num_clients, platform,
                         hidden_sizes, synthetic_rows)
    run_args += ["--fault-plan", _plan(rounds, name),
                 "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    if name == "nan_rollback":
        run_args += ["--on-divergence", "rollback", "--rollback-retries", "2"]
    if name in ("sigkill", "preempt"):
        argv = ["supervise", "--max-restarts", "2", "--events",
                os.path.join(workdir, f"{name}.events.jsonl"),
                "--", *run_args]
    else:
        argv = run_args
    out = subprocess.run([sys.executable, "-m", "fedtpu_torch.cli", *argv],
                         capture_output=True, text=True, timeout=timeout)

    hist = _history(os.path.join(workdir, f"{name}.metrics.jsonl"))
    res = _resilience(os.path.join(workdir, f"{name}.events.jsonl"))
    k = _fault_round(rounds)
    if name == "dropout":
        # The dropped round must CHANGE the aggregate at the fault round,
        # while the pre-fault prefix stays bitwise.
        hist_verdict = oracles.history_bitwise(
            hist, baseline, mode="prefix_divergent", fault_round=k)
    else:
        hist_verdict = oracles.history_bitwise(hist, baseline, mode="full")
    row = {
        "scenario": name,
        "rc": out.returncode,
        "survived": out.returncode == 0 and sorted(hist) == sorted(baseline),
        "history_match": hist_verdict.ok,
        "faults": len(res.get("faults") or []),
        "restarts": res.get("restarts") or 0,
        "rollbacks": len(res.get("rollbacks") or []),
        "gang_restarts": res.get("gang_restarts") or 0,
        "collective_hangs": len(res.get("collective_hangs") or []),
        "reshards": len(res.get("reshards") or []),
        "reshard_failures": len(res.get("reshard_failures") or []),
        "oracles": [hist_verdict.as_dict()],
    }
    row["ok"] = (row["survived"] and row["history_match"]
                 and row["faults"] >= 1
                 and (row["restarts"] >= 1
                      if name in ("sigkill", "preempt") else True)
                 and (row["rollbacks"] >= 1
                      if name == "nan_rollback" else True))
    if not row["ok"]:
        row["stderr_tail"] = (out.stderr or "")[-2000:]
    return row


def run_chaos(scenarios: Optional[Sequence[str]] = None, rounds: int = 10,
              num_clients: int = 4, workdir: Optional[str] = None,
              keep_artifacts: bool = False, timeout: int = 600,
              platform: str = "default", verbose: bool = True,
              hidden_sizes: Sequence[int] = (16,),
              synthetic_rows: Optional[int] = None) -> dict:
    """Execute the matrix; returns the report dict (``ok`` = all rows
    ok). Artifacts live under ``workdir`` (a fresh temp dir by default,
    removed afterwards unless ``keep_artifacts``). ``hidden_sizes`` and
    ``synthetic_rows``: the runs' widths (fedtpu's are hidden 16) and rows
    (default: the preset's)."""
    names = tuple(scenarios) if scenarios else SINGLE_PROCESS_SCENARIOS
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(f"unknown chaos scenario(s) {unknown}; "
                         f"pick from {list(SCENARIOS)}")
    for n in names:
        if n not in SINGLE_PROCESS_SCENARIOS:
            _not_ported_row(n)
    if rounds < 4:
        raise ValueError("chaos needs --rounds >= 4: a checkpoint must "
                         "precede the mid-run fault round")
    own_dir = workdir is None
    wd = workdir or tempfile.mkdtemp(prefix="fedtpu-chaos-")
    os.makedirs(wd, exist_ok=True)
    try:
        if verbose:
            print(f"[chaos] baseline run ({rounds} rounds, "
                  f"{num_clients} clients) in {wd}", flush=True)
        base = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli",
             *_run_args(wd, "baseline", rounds, num_clients, platform,
                        hidden_sizes, synthetic_rows)],
            capture_output=True, text=True, timeout=timeout)
        if base.returncode != 0:
            return {"ok": False, "error": "baseline run failed",
                    "rc": base.returncode,
                    "stderr_tail": (base.stderr or "")[-2000:],
                    "scenarios": [], "workdir": wd}
        baseline = _history(os.path.join(wd, "baseline.metrics.jsonl"))
        rows = []
        for name in names:
            if verbose:
                print(f"[chaos] scenario {name} ...", flush=True)
            row = run_scenario(name, wd, baseline, rounds, num_clients,
                               platform, timeout, hidden_sizes,
                               synthetic_rows)
            rows.append(row)
            if verbose:
                status = "ok" if row["ok"] else "FAIL"
                print(f"[chaos]   {name}: {status} rc={row['rc']} "
                      f"survived={row['survived']} "
                      f"history_match={row['history_match']} "
                      f"faults={row['faults']} restarts={row['restarts']} "
                      f"rollbacks={row['rollbacks']}", flush=True)
        return {"ok": all(r["ok"] for r in rows), "rounds": rounds,
                "num_clients": num_clients, "scenarios": rows,
                "workdir": wd if keep_artifacts else None}
    finally:
        if own_dir and not keep_artifacts:
            shutil.rmtree(wd, ignore_errors=True)
