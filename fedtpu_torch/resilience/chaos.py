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

The GATEWAY rows exercise the fault-tolerant ingestion tier
(fedtpu_torch.serving.gateway) — a 2-gateway fleet, each member owning
the id-shard of clients matching its store shard, each member's tick the
captured driven tick on the card:

  mp_gateway_kill      SIGKILL gateway 1 mid-load, AFTER it processes a
                       session-stamped frame but BEFORE the ack leaves
                       (the lost-ack window). The gang supervisor
                       restarts the fleet with --resume; the engine's
                       write-ahead log replays the acked tail and the
                       retrying client's resend dedups against it. Bars:
                       loadgen survives (retried >= 1), >= 1 gang
                       restart, >= 1 server-side duplicate drop, ZERO
                       lost acked updates (client exactly-once admitted
                       total == fleet admitted == fleet incorporated,
                       backlog 0 after the final drain), SLO burn within
                       ``GATEWAY_BURN_BUDGET``.
  mp_store_shard_kill  Shard death mid-round: gateway 1 flushes (slot
                       writeback + pending spool + digest-stamped,
                       generation-fenced checkpoint), is SIGKILLed, and
                       gateway 0 ADOPTS its shard, then takes all traffic
                       via the client's failover. No gang, deliberately:
                       the survivor must absorb, not restart. The WHOLE
                       scenario runs twice and the survivor's tick
                       history must match BITWISE, with zero lost
                       admitted updates and an exact spool handoff
                       (spooled == replayed).

The POISONING row closes the loop through the defense screen — a
2-gateway fleet under the gang supervisor, the SAME heavy-tailed arrival
process replayed three times:

  mp_poison_campaign   Defended + poisoned (20% of users are seeded
                       attackers submitting 10x sign-flipped updates),
                       defenses-off + poisoned, and defended + clean.
                       Bars: the defended fleet quarantines EXACTLY the
                       trace's deterministic attacker set, its model
                       accuracy stays within ``POISON_ACCURACY_TOL`` of
                       the clean baseline, zero gang restarts, and the
                       defenses-off run degrades by at least
                       ``POISON_DEGRADE_MIN``.

The NET rows (``mp_net_partition``, ``mp_slow_gateway``,
``mp_torn_frame``) front each member of the supervised fleet with its
deterministic wire-fault proxy (``_NET_PLANS``): zero lost acked updates,
duplicate drops > 0, backlog drained, ZERO gang restarts, SLO burn under
``NET_BURN_BUDGET``, and the whole pass runs twice with byte-identical
proxy decision logs.

The TRAINING-GANG rows run the same job as a gang of ``MP_PROCESSES``
``run`` processes (``MP_SHARDS_PER_PROC`` shards each, one
``torch.distributed`` process group: gloo on the CPU and between members
sharing one card) under ``supervise --num-processes``, against an
uninterrupted gang baseline launched the same way, each member's watchdog
at ``MP_COLLECTIVE_TIMEOUT``:

  mp_kill_worker       SIGKILL process 1 mid-round; the gang supervisor
                       tears down the survivor and relaunches the gang
                       with --resume. History bitwise == gang baseline,
                       every member resumed at the same round.
  mp_kill_coordinator  Same, but process 0 (the rendezvous host) dies; the
                       relaunch binds a fresh coordinator port. Same bar.
  mp_hang              Process 1 wedges before a round, so process 0's
                       exchange stalls; its watchdog turns the hang into
                       exit 75 (a ``collective_hang`` event) and the gang
                       restarts. Same bar.
  mp_preempt           SIGTERM to every process: each drains the collective
                       checkpoint at the same round, exits 75, and the gang
                       resumes without backoff. Same bar.

The ELASTIC rows run the live reshard (``fedtpu_torch.resilience.
reshard``) against the same gang baseline: a preemption NOTICE arrives
for worker 1 and the gang resizes with no restart. The bar is zero gang
restarts, a completed reshard in the events and a bitwise pre-notice
history (the rounds after it differ: the client set changed):

  mp_shrink       A plan notice preempts worker 1; the gang shrinks onto
                  process 0, which runs the one-process round; worker 1
                  parks and exits 76 at the run's end.
  mp_grow         mp_shrink plus a cancel two rounds later: the parked
                  worker rejoins from the leader's spool and the gang grows
                  back, replaying its original graphs. Two reshards.
  mp_shrink_dead  The preempted worker DIES mid-reshard (before its
                  phase-A ack): the survivor's barrier times out
                  (``MP_RESHARD_DEAD_TIMEOUT``), the reshard aborts
                  (``reshard_failed``) and the gang restarts and resumes,
                  the history then FULLY bitwise.

The AUTOSCALE row closes the loop through the control plane: the port's
``serve`` under driven load, a 2-process training gang and the live
``autoscale`` controller side by side; the harness writes a preemption
notice file and the CONTROLLER pre-drains the server's pending updates to
a spool and fires the shrink (SIGUSR1 through the gang supervisor):

  mp_autoscale_preempt  Zero gang restarts, >= 1 reshard, a nonzero
                        pre-drain spool, no lost admitted updates after the
                        final drain (admitted == incorporated, backlog 0),
                        SLO burn within ``AUTOSCALE_BURN_BUDGET``. No
                        history bar: the signal's round is wall-clock.

The registry holds every row of ``fedtpu``'s matrix, and the port runs
them all; with no ``scenarios`` every row runs.

"History" is the ``--metrics-jsonl`` per-round record with timing
stripped. Restarted and rolled-back runs append re-executed rounds to the
same sink, so the comparison takes the LAST record per round.

Every child is a subprocess (``python -m fedtpu_torch.cli``): the parent
imports no torch and survives whatever the scenario does to the child
(the fleet rows' trace synthesis and client imports numpy);
``platform`` is the children's (``default`` = the GPU). Restart and
rollback counts are read back from the shared ``--events`` sink through
``fedtpu_torch.telemetry.report``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
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
# One process each (under the single supervisor).
SINGLE_PROCESS_SCENARIOS = tuple(n for n, fams, _ in SCENARIO_REGISTRY
                                 if not fams)
# The training-gang rows: 2-process gangs, the reshard subset among them.
MP_SCENARIOS = _family("mp")
RESHARD_SCENARIOS = _family("reshard")
AUTOSCALE_SCENARIO = _family("autoscale")[0]
# The ingestion-tier rows: a 2-gateway fleet instead of a training gang.
# They need no baseline run (no run-loop history; the shard row carries
# its own bitwise bar by running twice).
GATEWAY_SCENARIOS = _family("gateway")
# mp_gateway_kill's SLO ceiling: a gateway death + gang restart stalls
# incorporation for the whole restart window, so the tier's burn budget
# sits above the autoscale drill's (2.0).
GATEWAY_BURN_BUDGET = 2.5
# The wire-fault rows (fedtpu_torch.resilience.netfaults / serving.
# netproxy): a 2-gateway fleet fronted by deterministic fault proxies — no
# process dies, the WIRE does.
NET_SCENARIOS = _family("net")
# No process restarts to amortize, but retry backoff stalls ingestion
# while a partition window burns through — same ceiling as the gateway
# tier.
NET_BURN_BUDGET = 2.5
# The poisoning-containment row: three fleet passes over one arrival
# process (defended + poisoned, defenses-off + poisoned, defended +
# clean).
POISON_SCENARIO = _family("poison")[0]
POISON_USERS = 40
POISON_ARRIVALS = 900
POISON_HORIZON_S = 30.0
POISON_TRACE_SEED = 7
POISON_FRAC = 0.2
POISON_SCALE = 10.0
POISON_ACCURACY_TOL = 0.01
POISON_DEGRADE_MIN = 0.05
# The gang rows' shape (fedtpu's constants): processes, and shards a
# process (fedtpu's virtual devices a process, the port's
# FEDTPU_SHARDS_PER_PROCESS); the watchdog budget, far above a healthy
# blocking window, far below the row's timeout.
MP_PROCESSES = 2
MP_SHARDS_PER_PROC = 2
MP_COLLECTIVE_TIMEOUT = 12.0
# mp_shrink_dead only: the reshard's ack barrier takes the collective
# timeout as its budget, and the survivor must time out (and log
# reshard_failed) BEFORE the gang supervisor's teardown grace kills it.
MP_RESHARD_DEAD_TIMEOUT = 6.0
# mp_autoscale_preempt's SLO ceiling (fedtpu's).
AUTOSCALE_BURN_BUDGET = 2.0
# The training-gang rows that restart the gang (the reshard rows resize it
# instead); every row of MP_SCENARIOS is held to the gang baseline.
GANG_SCENARIOS = tuple(n for n in MP_SCENARIOS
                       if n not in RESHARD_SCENARIOS)
# The fleet rows: each carries its own baseline inside the scenario.
FLEET_SCENARIOS = GATEWAY_SCENARIOS + (POISON_SCENARIO,) + NET_SCENARIOS
# The rows the port runs, in the registry's order (the default matrix):
# all of them.
PORTED_SCENARIOS = SCENARIOS

# Metric-history fields compared across runs (sec_per_round is wall
# clock — the one thing faults are ALLOWED to change).
_HIST_KEYS = ("client_mean", "pooled", "loss_mean")


def _fault_round(rounds: int) -> int:
    """Mid-run, 1-based — late enough that a checkpoint precedes it,
    early enough that recovery has rounds left to prove itself on."""
    return max(2, rounds // 2 + 1)


def _plan(rounds: int, kind: str, num_clients: int = 4) -> str:
    k = _fault_round(rounds)
    # The elastic notice: worker 1 is preempted; the survivor keeps its
    # own shards, so the shrunk width is half the clients.
    notice = {"kind": "preempt_notice", "round": k,
              "target_clients": num_clients // 2, "process_index": 1}
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
        "mp_kill_worker": [{"kind": "process_kill", "round": k,
                            "signal": "SIGKILL", "process_index": 1}],
        "mp_kill_coordinator": [{"kind": "process_kill", "round": k,
                                 "signal": "SIGKILL", "process_index": 0}],
        "mp_hang": [{"kind": "collective_hang", "round": k,
                     "process_index": 1}],
        # process_index -1 = every process: the whole-slice preemption.
        "mp_preempt": [{"kind": "process_kill", "round": k,
                        "signal": "SIGTERM", "process_index": -1}],
        "mp_shrink": [notice],
        "mp_shrink_dead": [notice],
        # Cancel two rounds after the notice: the parked worker rejoins
        # and the tail of the run trains at full width again.
        "mp_grow": [notice, {"kind": "preempt_cancel",
                             "round": min(k + 2, rounds)}],
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


def _mp_env() -> dict:
    """The gang children's environment: each lays ``MP_SHARDS_PER_PROC``
    shards over its device (the supervisor forwards it to every
    member)."""
    from fedtpu_torch.parallel.mesh import ENV_SHARDS_PER_PROCESS
    return dict(os.environ,
                **{ENV_SHARDS_PER_PROCESS: str(MP_SHARDS_PER_PROC)})


def _gang_argv(run_args: List[str], max_restarts: int,
               events: Optional[str] = None) -> List[str]:
    return (["supervise", "--num-processes", str(MP_PROCESSES),
             "--max-restarts", str(max_restarts), "--grace", "10"]
            + (["--events", events] if events else []) + ["--", *run_args])


def _member_resumes(events_path: str) -> List[List[int]]:
    """Each member's resume rounds, in order (process 0's sink, then the
    peers' ``.p<i>``): a gang that restored together lists the same
    rounds for every member."""
    from fedtpu_torch.telemetry.report import load_events
    out = []
    for i in range(MP_PROCESSES):
        path = events_path if i == 0 else f"{events_path}.p{i}"
        events, _ = load_events(path) if os.path.exists(path) else ([], 0)
        out.append([e.get("round") for e in events
                    if e.get("kind") == "resume"
                    and e.get("role") == "run"])
    return out


def _gang_restart_seconds(events_path: str) -> Optional[float]:
    """The gang's restart, wall seconds: from the supervisor's relaunch
    (its last ``gang_restart`` event's ``wall``) to the relaunched
    process 0's resume (its ``resume`` event's ``wall``); None without a
    restart."""
    from fedtpu_torch.telemetry.report import load_events
    events, _ = load_events(events_path)
    walls = [e["payload"].get("wall") for e in events
             if e["kind"] == "gang_restart"]
    resumed = [e["payload"].get("wall") for e in events
               if e["kind"] == "resume" and e.get("role") == "run"]
    if not walls or walls[-1] is None or not resumed or resumed[-1] is None:
        return None
    return resumed[-1] - walls[-1]


def _resilience(events_path: str) -> dict:
    from fedtpu_torch.telemetry.report import aggregate, load_events
    events, bad = load_events(events_path)
    return aggregate(events, malformed=bad).get("resilience") or {}


def _wait_for_round(path: str, rnd: int, proc, timeout_s: float) -> bool:
    """Poll a metrics JSONL until a record reaches round ``rnd``; False
    when ``proc`` exits or the budget runs out first."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        hist = _history(path)
        if hist and max(hist) >= rnd:
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.05)
    return False


def _run_autoscale_preempt(workdir: str, rounds: int, num_clients: int,
                           platform: str, timeout: int,
                           hidden_sizes: Sequence[int] = (16,),
                           synthetic_rows: Optional[int] = None) -> dict:
    """The control-plane drill (module docstring
    ``mp_autoscale_preempt``): serve under driven load, a 2-process gang
    and the live controller. The harness only writes the notice file;
    every action, the pre-drain spool and the SIGUSR1 shrink, is the
    controller's."""
    import signal as _signal

    from fedtpu_torch.serving.protocol import Connection
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    name = AUTOSCALE_SCENARIO
    trace = os.path.join(workdir, f"{name}.trace.jsonl")
    port_file = os.path.join(workdir, f"{name}.port")
    notice = os.path.join(workdir, f"{name}.notice.json")
    spool = os.path.join(workdir, f"{name}.spool.jsonl")
    hb = os.path.join(workdir, f"{name}.hb")
    serve_events = os.path.join(workdir, f"{name}.serve.events.jsonl")
    ctl_events = os.path.join(workdir, f"{name}.ctl.events.jsonl")
    header, t, user, lat = synthesize_trace(200, 3000, 20.0, seed=3)
    write_trace(trace, header, t, user, lat)

    row = {"scenario": name, "rc": -1, "survived": False,
           "history_match": True, "faults": 0, "restarts": 0,
           "rollbacks": 0, "gang_restarts": 0, "collective_hangs": 0,
           "reshards": 0, "reshard_failures": 0, "spooled": 0,
           "acted": {}, "backlog": None, "slo_burn": None,
           "lost_updates": None, "ok": False}
    serve = gang = None
    stderr_parts = []
    try:
        serve = subprocess.Popen(
            [sys.executable, "-m", "fedtpu_torch.cli", "serve",
             "--platform", platform, "--port-file", port_file,
             "--checkpoint-dir", os.path.join(workdir, f"{name}.serve.ck"),
             "--events", serve_events, "--quiet", "--json"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # Driven load: the whole trace, NO drain, so the pending backlog
        # is there for the controller's pre-drain.
        load = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli", "loadgen", trace,
             "--port-file", port_file, "--no-drain", "--retries", "30",
             "--quiet"], capture_output=True, text=True, timeout=timeout)
        if load.returncode != 0:
            row["error"] = "loadgen failed"
            stderr_parts.append(load.stderr or "")
            return row
        # A straggler on every round after the first keeps the run alive
        # long enough for the wall-clock notice to land with rounds to
        # spare after the shrink.
        pace = [{"kind": "straggler", "round": r, "clients": [0],
                 "delay_s": 0.4} for r in range(2, rounds + 1)]
        run_args = _run_args(workdir, name, rounds, num_clients, platform,
                             hidden_sizes, synthetic_rows)
        run_args += ["--fault-plan", json.dumps({"seed": 0, "faults": pace}),
                     "--checkpoint-dir", os.path.join(workdir, f"{name}.ck"),
                     "--checkpoint-every", "2",
                     "--collective-timeout", str(MP_COLLECTIVE_TIMEOUT)]
        gang = subprocess.Popen(
            [sys.executable, "-m", "fedtpu_torch.cli", "supervise",
             "--heartbeat", hb, "--num-processes", str(MP_PROCESSES),
             "--max-restarts", "2", "--grace", "10",
             "--events", os.path.join(workdir, f"{name}.events.jsonl"),
             "--", *run_args],
            env=_mp_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        # The notice goes down once the gang is mid-run (its signal
        # handlers are installed before round 0), so the controller's
        # first control tick sees it and the drill never depends on the
        # threshold policy's dynamics.
        if not _wait_for_round(
                os.path.join(workdir, f"{name}.metrics.jsonl"), 2, gang,
                timeout):
            row["error"] = "gang never reached round 2"
            return row
        tmp = f"{notice}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"victim": 1}, fh)
        os.replace(tmp, notice)
        ctl = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli", "autoscale",
             "--port-file", port_file, "--heartbeat", hb,
             "--num-processes", str(MP_PROCESSES),
             "--supervisor-pid", str(gang.pid), "--notice-file", notice,
             "--spool-path", spool, "--interval", "0.2",
             "--stop-after-notice", "--events", ctl_events,
             "--quiet", "--json"],
            capture_output=True, text=True, timeout=timeout)
        if ctl.returncode != 0:
            row["error"] = "controller failed"
            stderr_parts.append(ctl.stderr or "")
            return row
        try:
            gang_rc = gang.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            gang.kill()
            row["error"] = "gang timed out after the shrink"
            return row
        row["rc"] = gang_rc
        # The final drain and the signals block off the wire: the
        # no-lost-updates and SLO bars read what the controller polls.
        with open(port_file) as fh:
            port = int(fh.read().strip())
        with Connection("127.0.0.1", port) as conn:
            conn.hello()
            conn.request({"op": "drain"})
            signals = conn.request({"op": "stats"}).get("signals") or {}
        serve.send_signal(_signal.SIGTERM)
        serve_rc = serve.wait(timeout=60)
        row["slo_burn"] = signals.get("slo_burn")
        row["lost_updates"] = (int(signals.get("admitted") or 0)
                               - int(signals.get("incorporated") or 0))
        res = _resilience(os.path.join(workdir, f"{name}.events.jsonl"))
        row["restarts"] = res.get("restarts") or 0
        row["gang_restarts"] = res.get("gang_restarts") or 0
        row["reshards"] = len(res.get("reshards") or [])
        row["reshard_failures"] = len(res.get("reshard_failures") or [])
        from fedtpu_torch.telemetry.report import aggregate, load_events
        ev, bad = load_events(serve_events)
        asc = aggregate(ev, malformed=bad).get("autoscale") or {}
        row["spooled"] = sum(int(p.get("spooled") or 0)
                             for p in asc.get("serve_pre_drains") or [])
        ev, bad = load_events(ctl_events)
        acted = (aggregate(ev, malformed=bad).get("autoscale")
                 or {}).get("acted") or {}
        row["acted"] = dict(acted)
        row["backlog"] = int(signals.get("backlog") or 0)
        row["survived"] = gang_rc == 0 and serve_rc in (0, 75)
        row["ok"] = (row["survived"]
                     and row["gang_restarts"] == 0
                     and row["reshards"] >= 1
                     and row["reshard_failures"] == 0
                     and row["spooled"] > 0
                     and row["lost_updates"] == 0
                     and row["backlog"] == 0
                     and acted.get("pre_drain", 0) >= 1
                     and acted.get("shrink", 0) >= 1
                     and row["slo_burn"] is not None
                     and row["slo_burn"] <= AUTOSCALE_BURN_BUDGET)
        if not row["ok"]:
            stderr_parts.append((gang.stderr.read() or "")
                                if gang.stderr else "")
        return row
    except (subprocess.TimeoutExpired, OSError, ConnectionError,
            ValueError) as e:
        row["error"] = f"{type(e).__name__}: {e}"
        return row
    finally:
        for proc in (gang, serve):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if stderr_parts:
            row["stderr_tail"] = "\n".join(stderr_parts)[-2000:]


def _gateway_row(name: str) -> dict:
    """The shared verdict-row skeleton (every row carries the matrix's
    common keys so reporting never branches on scenario family)."""
    return {"scenario": name, "rc": -1, "survived": False,
            "history_match": True, "faults": 0, "restarts": 0,
            "rollbacks": 0, "gang_restarts": 0, "collective_hangs": 0,
            "reshards": 0, "reshard_failures": 0, "ok": False}


def _run_gateway_kill(workdir: str, platform: str, timeout: int) -> dict:
    """mp_gateway_kill (module docstring): 2-gateway fleet under
    ``supervise --num-processes 2``, gateway 1 SIGKILLs itself in the
    lost-ack window (ENV_KILL_AFTER), the loadgen rides the retrying
    client straight through the gang restart."""
    import signal as _signal

    from fedtpu_torch.serving.admission import ADMITTED
    from fedtpu_torch.serving.gateway import ENV_KILL_AFTER
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    name = "mp_gateway_kill"
    trace = os.path.join(workdir, f"{name}.trace.jsonl")
    port_base = os.path.join(workdir, f"{name}.port")
    ck = os.path.join(workdir, f"{name}.ck")
    hb = os.path.join(workdir, f"{name}.hb")
    sup_events = os.path.join(workdir, f"{name}.sup.events.jsonl")
    serve_events = os.path.join(workdir, f"{name}.serve.events.jsonl")
    header, t, user, lat = synthesize_trace(200, 2400, 20.0, seed=5)
    write_trace(trace, header, t, user, lat)

    row = _gateway_row(name)
    row.update({"retried": 0, "reconnects": 0, "duplicate_drops": 0,
                "lost_acked": None, "backlog": None, "slo_burn": None})
    env = dict(os.environ)
    # Gateway 1 dies after ACKING (processing, not answering) its 2nd
    # update frame — mid-loadgen with frames still to come.
    env[ENV_KILL_AFTER] = "1:2"
    sup = None
    stderr_parts = []
    try:
        sup = subprocess.Popen(
            [sys.executable, "-m", "fedtpu_torch.cli", "supervise",
             "--heartbeat", hb, "--num-processes", "2",
             "--max-restarts", "2", "--grace", "10",
             "--events", sup_events, "--",
             "gateway", "--platform", platform, "--num-gateways", "2",
             "--port-file", port_base, "--checkpoint-dir", ck,
             "--events", serve_events, "--quiet"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        load = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli", "loadgen", trace,
             "--port-file", port_base, "--num-gateways", "2",
             "--batch", "512", "--retries", "10",
             "--retry-backoff", "0.1", "--quiet", "--json"],
            capture_output=True, text=True,
            timeout=timeout)
        row["rc"] = load.returncode
        if load.returncode != 0:
            row["error"] = "loadgen failed"
            stderr_parts.append(load.stderr or "")
            return row
        summary = json.loads(load.stdout.strip().splitlines()[-1])
        row["retried"] = int(summary.get("retried") or 0)
        row["reconnects"] = int(summary.get("reconnects") or 0)

        per = summary.get("server_stats") or {}
        stats = [s for s in per.values() if s is not None]
        sigs = [s.get("signals") or {} for s in stats]
        row["duplicate_drops"] = sum(
            int(s.get("duplicate_drops") or 0) for s in stats)
        client_admitted = sum(
            int(n) for v, n in (summary.get("admission") or {}).items()
            if v in ADMITTED)
        fleet_admitted = sum(int(s.get("admitted") or 0) for s in sigs)
        fleet_incorporated = sum(int(s.get("incorporated") or 0)
                                 for s in sigs)
        row["backlog"] = sum(int(s.get("backlog") or 0) for s in sigs)
        # Two-sided: a lost acked update breaks it one way, a duplicate
        # incorporation the other.
        row["lost_acked"] = client_admitted - fleet_incorporated
        burns = [s.get("slo_burn") for s in sigs
                 if s.get("slo_burn") is not None]
        row["slo_burn"] = max(burns) if burns else None

        sup.send_signal(_signal.SIGTERM)
        sup_rc = sup.wait(timeout=timeout)
        res = _resilience(sup_events)
        row["restarts"] = res.get("restarts") or 0
        row["gang_restarts"] = res.get("gang_restarts") or 0
        row["survived"] = sup_rc in (0, 75) and len(stats) == 2
        row["restart_s"] = _restart_seconds(sup_events, port_base)
        verdicts = oracles.judge_gateway_kill(
            survived=row["survived"], retried=row["retried"],
            gang_restarts=row["gang_restarts"],
            duplicate_drops=row["duplicate_drops"],
            lost_acked=row["lost_acked"],
            client_admitted=client_admitted,
            fleet_admitted=fleet_admitted, backlog=row["backlog"],
            slo_burn=row["slo_burn"], burn_budget=GATEWAY_BURN_BUDGET)
        row["oracles"] = [v.as_dict() for v in verdicts]
        row["ok"] = oracles.summarize(verdicts)["ok"]
        if not row["ok"]:
            stderr_parts.append((sup.stderr.read() or "")
                                if sup.stderr else "")
        return row
    except (subprocess.TimeoutExpired, OSError, ConnectionError,
            ValueError) as e:
        row["error"] = f"{type(e).__name__}: {e}"
        return row
    finally:
        if sup is not None and sup.poll() is None:
            sup.kill()
            sup.wait(timeout=30)
        if stderr_parts:
            row["stderr_tail"] = "\n".join(stderr_parts)[-2000:]


def _restart_seconds(sup_events: str, port_base: str) -> Optional[float]:
    """The gang's restart, wall seconds: from the supervisor's relaunch
    (its ``gang_restart`` event's ``wall``) to the later of the relaunched
    gateways' port files (each written once its engine serves); None
    without a restart."""
    from fedtpu_torch.serving.protocol import gateway_port_file
    from fedtpu_torch.telemetry.report import load_events
    events, _ = load_events(sup_events)
    walls = [e["payload"].get("wall") for e in events
             if e["kind"] == "gang_restart"]
    if not walls or walls[-1] is None:
        return None
    up = max(os.path.getmtime(gateway_port_file(port_base, g))
             for g in range(2))
    return up - walls[-1]


def _store_shard_pass(passdir: str, events: list, platform: str,
                      timeout: int) -> dict:
    """One mp_store_shard_kill pass (the scenario runs two and compares
    the survivor histories bitwise): 2 standalone gateways, flush + kill
    gateway 1 mid-trace, adopt on gateway 0, finish over failover."""
    import signal as _signal
    import time as _time

    from fedtpu_torch.serving.client import GatewayClient
    from fedtpu_torch.serving.loadgen import read_port_file
    from fedtpu_torch.serving.protocol import gateway_port_file
    os.makedirs(passdir, exist_ok=True)
    port_base = os.path.join(passdir, "port")
    ck = os.path.join(passdir, "ck")
    hist = os.path.join(passdir, "hist.jsonl")
    spool = os.path.join(passdir, "shard1.spool.jsonl")
    out = {"ok": False, "spooled": None, "replayed": None,
           "adopted_rows": None, "owned": None, "backlog": None,
           "lost": None, "history": b""}
    procs = []
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedtpu_torch.cli", "gateway",
                 "--platform", platform, "--gateway-index", str(i),
                 "--num-gateways", "2", "--port-file", port_base,
                 "--checkpoint-dir", ck, "--total-users", "200",
                 "--history", hist,
                 "--events", os.path.join(passdir, "serve.events.jsonl"),
                 "--quiet"],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for i in range(2):
            read_port_file(gateway_port_file(port_base, i), timeout=60)
        half = len(events) // 2
        with GatewayClient(port_file=port_base, num_gateways=2,
                           retries=3, backoff_s=0.05, seed=0) as client:
            for lo in range(0, half, 256):
                client.send_events(events[lo:min(lo + 256, half)])
            flushed = client.request({"op": "flush", "path": spool},
                                     gateway=1, failover=False)
            if flushed.get("op") != "flushed":
                out["error"] = f"flush refused: {flushed}"
                return out
            out["spooled"] = int(flushed.get("spooled") or 0)
            t_kill = time.monotonic()
            procs[1].send_signal(_signal.SIGKILL)
            procs[1].wait(timeout=30)
            adopted = client.request(
                {"op": "adopt", "shard": 1,
                 "checkpoint_dir": os.path.join(ck, "g1"),
                 "spool": spool,
                 "generation": flushed.get("generation")},
                gateway=0, failover=False)
            if adopted.get("op") != "adopted":
                out["error"] = f"adopt refused: {adopted}"
                return out
            out["failover_s"] = time.monotonic() - t_kill
            out["replayed"] = int(adopted.get("replayed") or 0)
            out["adopted_rows"] = int(adopted.get("rows") or 0)
            out["owned"] = adopted.get("owned")
            for lo in range(half, len(events), 256):
                client.send_events(events[lo:lo + 256])
            client.request({"op": "drain"}, gateway=0, failover=False)
            stats = client.request({"op": "stats"}, gateway=0,
                                   failover=False)
        sig = stats.get("signals") or {}
        out["backlog"] = int(sig.get("backlog") or 0)
        out["lost"] = (int(sig.get("admitted") or 0)
                       - int(sig.get("incorporated") or 0))
        procs[0].send_signal(_signal.SIGTERM)
        rc = procs[0].wait(timeout=timeout)
        survivor_hist = f"{hist}.g0"
        deadline = _time.monotonic() + 30
        while (not os.path.exists(survivor_hist)
               and _time.monotonic() < deadline):
            _time.sleep(0.05)
        with open(survivor_hist, "rb") as fh:
            out["history"] = fh.read()
        out["ok"] = (rc in (0, 75)
                     and out["owned"] == [0, 1]
                     and out["spooled"] == out["replayed"]
                     and out["backlog"] == 0
                     and out["lost"] == 0)
        if not out["ok"]:
            out["stderr_tail"] = "\n".join(
                (p.stderr.read() or "") if p.stderr else ""
                for p in procs)[-2000:]
        return out
    except (subprocess.TimeoutExpired, OSError, ConnectionError,
            ValueError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _run_store_shard_kill(workdir: str, platform: str,
                          timeout: int) -> dict:
    """mp_store_shard_kill (module docstring): the whole degraded
    scenario runs TWICE and the survivor's tick history must match
    bitwise — the determinism verdict for the failover path itself."""
    from fedtpu_torch.serving.traces import synthesize_trace
    name = "mp_store_shard_kill"
    header, t, user, lat = synthesize_trace(200, 2000, 20.0, seed=7)
    events = [[int(u), float(tt), float(ll)]
              for u, tt, ll in zip(user, t, lat)]
    row = _gateway_row(name)
    row.update({"spooled": None, "replayed": None, "adopted_rows": None,
                "backlog": None, "lost_updates": None})
    passes = []
    for tag in ("a", "b"):
        p = _store_shard_pass(os.path.join(workdir, f"{name}.{tag}"),
                              events, platform, timeout)
        passes.append(p)
        if not p["ok"]:
            row["error"] = p.get("error", "pass failed")
            if "stderr_tail" in p:
                row["stderr_tail"] = p["stderr_tail"]
            break
    a = passes[0]
    row["rc"] = 0 if all(p["ok"] for p in passes) else 1
    row["spooled"], row["replayed"] = a["spooled"], a["replayed"]
    row["failover_s"] = [p.get("failover_s") for p in passes]
    row["adopted_rows"] = a["adopted_rows"]
    row["backlog"], row["lost_updates"] = a["backlog"], a["lost"]
    row["survived"] = all(p["ok"] for p in passes)
    row["history_match"] = (len(passes) == 2 and bool(a["history"])
                            and a["history"] == passes[1]["history"])
    row["ok"] = row["survived"] and row["history_match"]
    return row


# The pinned wire campaigns, one per NET row. Frame ordinals count every
# frame a gateway's proxy sees — hellos, retries, drains included — so
# they are chosen against the loadgen shape below (2000 events, batch
# 512 -> 4 updates frames per gateway after the initial hello). Every
# row carries at least one ack-boundary fault (post_ack tear or replay)
# so the duplicate-drops bar is meaningful on all three.
_NET_PLANS = {
    "mp_net_partition": {"seed": 21, "faults": [
        # Blackhole gateway 1 for 3 frames mid-load (the 2nd updates
        # frame plus the reconnect hellos that burn through the window)
        # and replay a committed frame on gateway 0.
        {"kind": "net_partition", "gateway": 1, "frame": 3, "frames": 3},
        {"kind": "net_dup_frame", "gateway": 0, "frame": 3},
    ]},
    "mp_slow_gateway": {"seed": 22, "faults": [
        # Pace gateway 0's link for 3 frames; tear gateway 1's ack AFTER
        # the WAL/ack boundary so the retry must dedup.
        {"kind": "net_slow_link", "gateway": 0, "frame": 2, "frames": 3,
         "chunk_bytes": 512, "delay_s": 0.005},
        {"kind": "net_torn_frame", "gateway": 1, "frame": 3,
         "boundary": "post_ack", "cut_bytes": 64},
    ]},
    "mp_torn_frame": {"seed": 23, "faults": [
        # Both sides of the boundary on gateway 1, a mid-batch RST and a
        # replayed frame on gateway 0.
        {"kind": "net_torn_frame", "gateway": 1, "frame": 2,
         "boundary": "pre_ack", "cut_bytes": 80},
        {"kind": "net_torn_frame", "gateway": 1, "frame": 6,
         "boundary": "post_ack", "cut_bytes": 80},
        {"kind": "net_reset", "gateway": 0, "frame": 3, "phase": "mid"},
        {"kind": "net_dup_frame", "gateway": 0, "frame": 5},
    ]},
}


def _net_pass(passdir: str, plan_json: str, trace: str, platform: str,
              timeout: int) -> dict:
    """One NET-row pass: 2-gateway fleet under the gang supervisor, each
    member fronted by its wire-fault proxy, the loadgen retrying through
    the chaos wire. Returns the verdict ingredients plus the
    concatenated proxy decision logs (the bitwise artifact)."""
    import signal as _signal

    from fedtpu_torch.serving.admission import ADMITTED
    os.makedirs(passdir, exist_ok=True)
    port_base = os.path.join(passdir, "port")
    ck = os.path.join(passdir, "ck")
    hb = os.path.join(passdir, "hb")
    sup_events = os.path.join(passdir, "sup.events.jsonl")
    serve_events = os.path.join(passdir, "serve.events.jsonl")
    out = {"ok": False, "rc": -1, "retried": 0, "reconnects": 0,
           "duplicate_drops": 0, "lost_acked": None, "backlog": None,
           "slo_burn": None, "restarts": 0, "gang_restarts": 0,
           "net_faults": 0, "netlog": b""}
    sup = None
    stderr_parts = []
    try:
        sup = subprocess.Popen(
            [sys.executable, "-m", "fedtpu_torch.cli", "supervise",
             "--heartbeat", hb, "--num-processes", "2",
             "--max-restarts", "2", "--grace", "10",
             "--events", sup_events, "--",
             "gateway", "--platform", platform, "--num-gateways", "2",
             "--port-file", port_base, "--checkpoint-dir", ck,
             "--net-fault-plan", plan_json,
             "--events", serve_events, "--quiet"],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        load = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli", "loadgen", trace,
             "--port-file", port_base, "--num-gateways", "2",
             "--batch", "512", "--retries", "12",
             "--retry-backoff", "0.05", "--quiet", "--json"],
            capture_output=True, text=True,
            timeout=timeout)
        out["rc"] = load.returncode
        if load.returncode != 0:
            out["error"] = "loadgen failed"
            stderr_parts.append(load.stderr or "")
            return out
        summary = json.loads(load.stdout.strip().splitlines()[-1])
        out["retried"] = int(summary.get("retried") or 0)
        out["reconnects"] = int(summary.get("reconnects") or 0)
        per = summary.get("server_stats") or {}
        stats = [s for s in per.values() if s is not None]
        sigs = [s.get("signals") or {} for s in stats]
        out["duplicate_drops"] = sum(
            int(s.get("duplicate_drops") or 0) for s in stats)
        client_admitted = sum(
            int(n) for v, n in (summary.get("admission") or {}).items()
            if v in ADMITTED)
        out["client_admitted"] = client_admitted
        out["fleet_admitted"] = sum(int(s.get("admitted") or 0)
                                    for s in sigs)
        fleet_incorporated = sum(int(s.get("incorporated") or 0)
                                 for s in sigs)
        out["backlog"] = sum(int(s.get("backlog") or 0) for s in sigs)
        out["lost_acked"] = client_admitted - fleet_incorporated
        burns = [s.get("slo_burn") for s in sigs
                 if s.get("slo_burn") is not None]
        out["slo_burn"] = max(burns) if burns else None

        sup.send_signal(_signal.SIGTERM)
        sup_rc = sup.wait(timeout=timeout)
        res = _resilience(sup_events)
        out["restarts"] = res.get("restarts") or 0
        out["gang_restarts"] = res.get("gang_restarts") or 0
        # The bitwise artifact: every proxy's decision log, in gateway
        # order (schedule header + firings + deterministic summary).
        chunks = []
        for i in range(2):
            log_path = f"{port_base}.g{i}.netlog"
            with open(log_path, "rb") as fh:
                chunks.append(fh.read())
        out["netlog"] = b"".join(chunks)
        out["net_faults"] = sum(
            1 for line in out["netlog"].splitlines()
            if b'"fault"' in line)
        out["ok"] = sup_rc in (0, 75) and len(stats) == 2
        if not out["ok"]:
            stderr_parts.append((sup.stderr.read() or "")
                                if sup.stderr else "")
        return out
    except (subprocess.TimeoutExpired, OSError, ConnectionError,
            ValueError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    finally:
        if sup is not None and sup.poll() is None:
            sup.kill()
            sup.wait(timeout=30)
        if stderr_parts:
            out["stderr_tail"] = "\n".join(stderr_parts)[-2000:]


def _run_net_row(name: str, workdir: str, platform: str,
                 timeout: int) -> dict:
    """One wire-chaos row (module docstring / NET_SCENARIOS): the whole
    pass runs TWICE with the same pinned plan and the proxy decision
    logs must match bitwise — the determinism verdict for the wire
    itself. Bars: zero lost acked updates, duplicate drops > 0, backlog
    drained, ZERO gang restarts, SLO burn under NET_BURN_BUDGET."""
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    plan_json = json.dumps(_NET_PLANS[name], sort_keys=True)
    trace = os.path.join(workdir, f"{name}.trace.jsonl")
    header, t, user, lat = synthesize_trace(200, 2000, 20.0, seed=11)
    write_trace(trace, header, t, user, lat)

    row = _gateway_row(name)
    row.update({"retried": 0, "reconnects": 0, "duplicate_drops": 0,
                "lost_acked": None, "backlog": None, "slo_burn": None,
                "net_faults": 0, "netlog_match": False})
    passes = []
    for tag in ("a", "b"):
        p = _net_pass(os.path.join(workdir, f"{name}.{tag}"),
                      plan_json, trace, platform, timeout // 2)
        passes.append(p)
        if not p["ok"]:
            row["error"] = p.get("error", "pass failed")
            if "stderr_tail" in p:
                row["stderr_tail"] = p["stderr_tail"]
            break
    a = passes[0]
    row["rc"] = a["rc"]
    for k in ("retried", "reconnects", "duplicate_drops", "lost_acked",
              "backlog", "slo_burn", "net_faults"):
        row[k] = a[k]
    row["restarts"] = a["restarts"]
    row["gang_restarts"] = a["gang_restarts"]
    row["faults"] = a["net_faults"]
    row["survived"] = all(p["ok"] for p in passes)
    row["netlog_match"] = (len(passes) == 2 and bool(a["netlog"])
                           and a["netlog"] == passes[1]["netlog"])
    row["history_match"] = row["netlog_match"]
    verdicts = oracles.judge_net_row(
        survived=row["survived"], netlog_match=row["netlog_match"],
        retried=row["retried"],
        duplicate_drops=row["duplicate_drops"],
        lost_acked=row["lost_acked"],
        client_admitted=a.get("client_admitted"),
        fleet_admitted=a.get("fleet_admitted"), backlog=row["backlog"],
        gang_restarts=row["gang_restarts"], slo_burn=row["slo_burn"],
        burn_budget=NET_BURN_BUDGET)
    row["oracles"] = [v.as_dict() for v in verdicts]
    row["ok"] = oracles.summarize(verdicts)["ok"]
    return row


def _poison_pass(passdir: str, trace: str, screen: bool, platform: str,
                 timeout: int) -> dict:
    """One mp_poison_campaign pass: a 2-gateway fleet under the gang
    supervisor, the trace replayed through the retrying client with a
    final drain, defense verdicts read off the per-gateway stats."""
    import signal as _signal
    os.makedirs(passdir, exist_ok=True)
    port_base = os.path.join(passdir, "port")
    sup_events = os.path.join(passdir, "sup.events.jsonl")
    out = {"ok": False, "rc": -1, "gang_restarts": 0, "screened": 0,
           "quarantined": [], "accuracy_min": None}
    gw_args = ["gateway", "--platform", platform, "--num-gateways", "2",
               "--port-file", port_base,
               "--checkpoint-dir", os.path.join(passdir, "ck"),
               "--cohort", "8", "--buffer-size", "2",
               "--total-users", str(POISON_USERS), "--quiet"]
    if screen:
        gw_args += ["--screen", "--quarantine-strikes", "3"]
    sup = None
    try:
        sup = subprocess.Popen(
            [sys.executable, "-m", "fedtpu_torch.cli", "supervise",
             "--heartbeat", os.path.join(passdir, "hb"),
             "--num-processes", "2", "--max-restarts", "2",
             "--grace", "10", "--events", sup_events, "--", *gw_args],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        load = subprocess.run(
            [sys.executable, "-m", "fedtpu_torch.cli", "loadgen", trace,
             "--port-file", port_base, "--num-gateways", "2",
             "--batch", "256", "--quiet", "--json"],
            capture_output=True, text=True,
            timeout=timeout)
        out["rc"] = load.returncode
        if load.returncode != 0:
            out["error"] = "loadgen failed"
            out["stderr_tail"] = (load.stderr or "")[-2000:]
            return out
        summary = json.loads(load.stdout.strip().splitlines()[-1])
        per = summary.get("server_stats") or {}
        stats = [s for s in per.values() if s is not None]
        out["screened"] = sum(int(s.get("screened") or 0) for s in stats)
        out["quarantined"] = sorted(
            {int(u) for s in stats for u in (s.get("quarantined") or [])})
        accs = [s.get("eval_accuracy") for s in stats
                if s.get("eval_accuracy") is not None]
        out["accuracy_min"] = min(accs) if accs else None
        sup.send_signal(_signal.SIGTERM)
        sup_rc = sup.wait(timeout=timeout)
        res = _resilience(sup_events)
        out["gang_restarts"] = res.get("gang_restarts") or 0
        out["ok"] = (sup_rc in (0, 75) and len(stats) == 2
                     and out["accuracy_min"] is not None)
        if not out["ok"]:
            out["stderr_tail"] = ((sup.stderr.read() or "")
                                  if sup.stderr else "")[-2000:]
        return out
    except (subprocess.TimeoutExpired, OSError, ConnectionError,
            ValueError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    finally:
        if sup is not None and sup.poll() is None:
            sup.kill()
            sup.wait(timeout=30)


def _run_poison_campaign(workdir: str, platform: str, timeout: int) -> dict:
    """mp_poison_campaign (module docstring): three fleet passes over the
    same arrival process — defended+poisoned, defenses-off+poisoned,
    defended+clean — scored against the trace's deterministic attacker
    set and the clean pass's accuracy."""
    from fedtpu_torch.serving.traces import (poisoned_user_ids, synthesize_trace,
                                       write_trace)
    name = POISON_SCENARIO
    poisoned = os.path.join(workdir, f"{name}.poisoned.jsonl")
    clean = os.path.join(workdir, f"{name}.clean.jsonl")
    header, t, user, lat = synthesize_trace(
        POISON_USERS, POISON_ARRIVALS, POISON_HORIZON_S,
        seed=POISON_TRACE_SEED, poison_frac=POISON_FRAC,
        poison_scale=POISON_SCALE)
    write_trace(poisoned, header, t, user, lat)
    # Same seed, no poison: identical arrival arrays, every user honest.
    ch, ct, cu, cl = synthesize_trace(
        POISON_USERS, POISON_ARRIVALS, POISON_HORIZON_S,
        seed=POISON_TRACE_SEED)
    write_trace(clean, ch, ct, cu, cl)
    attackers = sorted(int(u) for u in poisoned_user_ids(
        POISON_USERS, POISON_TRACE_SEED, POISON_FRAC))

    row = _gateway_row(name)
    row.update({"attackers": attackers, "quarantined": [],
                "quarantined_honest": [], "missed_attackers": attackers,
                "screened": 0, "accuracy_defended": None,
                "accuracy_undefended": None, "accuracy_clean": None})
    passes = {}
    for tag, trace, screen in (("defended", poisoned, True),
                               ("undefended", poisoned, False),
                               ("clean", clean, True)):
        p = _poison_pass(os.path.join(workdir, f"{name}.{tag}"), trace,
                         screen, platform, timeout)
        passes[tag] = p
        if not p["ok"]:
            row["error"] = f"{tag} pass failed: {p.get('error', 'see tail')}"
            if "stderr_tail" in p:
                row["stderr_tail"] = p["stderr_tail"]
            row["rc"] = p["rc"]
            return row
    d, u, c = passes["defended"], passes["undefended"], passes["clean"]
    atk = set(attackers)
    row["rc"] = 0
    row["screened"] = d["screened"]
    row["quarantined"] = d["quarantined"]
    row["quarantined_honest"] = sorted(set(d["quarantined"]) - atk)
    row["missed_attackers"] = sorted(atk - set(d["quarantined"]))
    row["accuracy_defended"] = d["accuracy_min"]
    row["accuracy_undefended"] = u["accuracy_min"]
    row["accuracy_clean"] = c["accuracy_min"]
    row["gang_restarts"] = max(p["gang_restarts"] for p in passes.values())
    row["survived"] = True
    verdicts = [
        oracles.quarantine_containment(d["quarantined"], atk,
                                       mode="exact"),
        oracles.Verdict("no_gang_restart", row["gang_restarts"] == 0,
                        observed=row["gang_restarts"], expected=0,
                        detail="defense must absorb the attack without a "
                               "restart"),
        oracles.defense_effective(d["accuracy_min"], u["accuracy_min"],
                                  c["accuracy_min"],
                                  POISON_ACCURACY_TOL,
                                  POISON_DEGRADE_MIN),
    ]
    row["oracles"] = [v.as_dict() for v in verdicts]
    row["ok"] = oracles.summarize(verdicts)["ok"]
    return row


def run_scenario(name: str, workdir: str, baseline: dict, rounds: int,
                 num_clients: int, platform: str, timeout: int,
                 hidden_sizes: Sequence[int] = (16,),
                 synthetic_rows: Optional[int] = None) -> dict:
    """One scenario run + verdict row (see the module docstring for the
    bars)."""
    if name == "mp_gateway_kill":
        return _run_gateway_kill(workdir, platform, timeout)
    if name in NET_SCENARIOS:
        return _run_net_row(name, workdir, platform, timeout)
    if name == POISON_SCENARIO:
        return _run_poison_campaign(workdir, platform, timeout)
    if name == "mp_store_shard_kill":
        return _run_store_shard_kill(workdir, platform, timeout)
    if name == AUTOSCALE_SCENARIO:
        return _run_autoscale_preempt(workdir, rounds, num_clients,
                                      platform, timeout, hidden_sizes,
                                      synthetic_rows)
    gang = name in MP_SCENARIOS
    reshard = name in RESHARD_SCENARIOS
    ck = os.path.join(workdir, f"{name}.ck")
    events = os.path.join(workdir, f"{name}.events.jsonl")
    run_args = _run_args(workdir, name, rounds, num_clients, platform,
                         hidden_sizes, synthetic_rows)
    run_args += ["--fault-plan", _plan(rounds, name, num_clients),
                 "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    if name == "nan_rollback":
        run_args += ["--on-divergence", "rollback", "--rollback-retries", "2"]
    env = None
    if gang:
        # Every gang row carries the watchdog: a hang anywhere becomes a
        # restart, never a hung row (mp_hang depends on it). It is the
        # reshard's ack budget too, shorter on mp_shrink_dead, whose
        # survivor must log the barrier's timeout before the teardown.
        ct = (MP_RESHARD_DEAD_TIMEOUT if name == "mp_shrink_dead"
              else MP_COLLECTIVE_TIMEOUT)
        run_args += ["--collective-timeout", str(ct)]
        argv = _gang_argv(run_args, 2, events)
        if reshard:
            # The parked victim reports through its heartbeat, and the
            # supervisor's all-parked SIGTERM (the backstop of a missed
            # run-done marker) reads the per-process heartbeat files.
            argv[1:1] = ["--heartbeat", os.path.join(workdir, f"{name}.hb")]
        env = _mp_env()
        if name == "mp_shrink_dead":
            # The victim SIGKILLs itself inside the reshard, after its
            # begin event and before its phase-A ack.
            from fedtpu_torch.resilience.reshard import ENV_RESHARD_CRASH
            env[ENV_RESHARD_CRASH] = "1"
    elif name in ("sigkill", "preempt"):
        argv = ["supervise", "--max-restarts", "2", "--events", events,
                "--", *run_args]
    else:
        argv = run_args
    out = subprocess.run([sys.executable, "-m", "fedtpu_torch.cli", *argv],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)

    hist = _history(os.path.join(workdir, f"{name}.metrics.jsonl"))
    res = _resilience(events)
    k = _fault_round(rounds)
    if name in ("dropout", "mp_shrink", "mp_grow"):
        # The dropped round, or the resized gang, must CHANGE the
        # aggregate at the fault round (identical would mean it did not
        # apply), while the prefix before it stays bitwise.
        hist_verdict = oracles.history_bitwise(
            hist, baseline, mode="prefix_divergent", fault_round=k)
    else:
        # mp_shrink_dead too: the aborted reshard leaves no trace in the
        # math, the restart's resume replays the tail bitwise.
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
    if gang:
        # No split-brain restore: every member resumed the same rounds.
        resumes = _member_resumes(events)
        row["member_resumes"] = resumes
        row["restart_s"] = _gang_restart_seconds(events)
        row["resumed_together"] = (all(r == resumes[0] for r in resumes)
                                   and bool(resumes[0]))
    # The notice rows inject no fault the injector applies (the reshard
    # controller takes the notice), and the live ones must NOT
    # gang-restart: that zero is the point of the elastic reshard.
    live = name in ("mp_shrink", "mp_grow")
    row["ok"] = (row["survived"] and row["history_match"]
                 and (row["faults"] >= 1 if not reshard else True)
                 and (row["restarts"] >= 1
                      if name in ("sigkill", "preempt") else True)
                 and (row["gang_restarts"] == 0 if live
                      else row["gang_restarts"] >= 1
                      and row["resumed_together"] if gang else True)
                 and (row["collective_hangs"] >= 1
                      if name == "mp_hang" else True)
                 and (row["rollbacks"] >= 1
                      if name == "nan_rollback" else True)
                 and (row["reshards"] >= 1 if name == "mp_shrink" else True)
                 and (row["reshards"] >= 2 if name == "mp_grow" else True)
                 and (row["reshards"] == 0 and row["reshard_failures"] >= 1
                      if name == "mp_shrink_dead" else True))
    if not row["ok"]:
        row["stderr_tail"] = (out.stderr or "")[-2000:]
    return row


def _detail(row: dict) -> str:
    """A gang or fleet row's own numbers for its verbose line
    (fedtpu's)."""
    name = row["scenario"]
    if name in MP_SCENARIOS:
        return (f" gang_restarts={row['gang_restarts']} "
                f"collective_hangs={row['collective_hangs']} "
                f"reshards={row['reshards']} "
                f"reshard_failures={row['reshard_failures']}")
    if name == AUTOSCALE_SCENARIO:
        return (f" gang_restarts={row['gang_restarts']} "
                f"reshards={row['reshards']} spooled={row['spooled']} "
                f"lost_updates={row['lost_updates']} "
                f"backlog={row['backlog']} slo_burn={row['slo_burn']}")
    if name == "mp_gateway_kill":
        return (f" gang_restarts={row['gang_restarts']} "
                f"retried={row['retried']} "
                f"duplicate_drops={row['duplicate_drops']} "
                f"lost_acked={row['lost_acked']} "
                f"slo_burn={row['slo_burn']}")
    if name == "mp_store_shard_kill":
        return (f" spooled={row['spooled']} replayed={row['replayed']} "
                f"adopted_rows={row['adopted_rows']} "
                f"lost_updates={row['lost_updates']}")
    if name in NET_SCENARIOS:
        return (f" net_faults={row['net_faults']} "
                f"retried={row['retried']} "
                f"duplicate_drops={row['duplicate_drops']} "
                f"lost_acked={row['lost_acked']} "
                f"netlog_match={row['netlog_match']} "
                f"slo_burn={row['slo_burn']}")
    if name == POISON_SCENARIO:
        return (f" quarantined={row['quarantined']} "
                f"honest={row['quarantined_honest']} "
                f"missed={row['missed_attackers']} "
                f"acc_def={row['accuracy_defended']} "
                f"acc_undef={row['accuracy_undefended']} "
                f"acc_clean={row['accuracy_clean']}")
    return ""


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
    names = tuple(scenarios) if scenarios else PORTED_SCENARIOS
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise ValueError(f"unknown chaos scenario(s) {unknown}; "
                         f"pick from {list(SCENARIOS)}")
    if rounds < 4:
        raise ValueError("chaos needs --rounds >= 4: a checkpoint must "
                         "precede the mid-run fault round")
    own_dir = workdir is None
    wd = workdir or tempfile.mkdtemp(prefix="fedtpu-chaos-")
    os.makedirs(wd, exist_ok=True)
    try:
        baseline: dict = {}
        if any(n in SINGLE_PROCESS_SCENARIOS for n in names):
            # The fleet rows carry their own baselines inside the
            # scenario; only training rows need the uninterrupted run.
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
        mp_baseline: dict = {}
        if any(n in MP_SCENARIOS for n in names):
            shards = MP_PROCESSES * MP_SHARDS_PER_PROC
            if num_clients % shards:
                raise ValueError(
                    f"gang scenarios need --num-clients divisible by "
                    f"{shards} ({MP_PROCESSES} processes x "
                    f"{MP_SHARDS_PER_PROC} shards); got {num_clients}")
            if verbose:
                print(f"[chaos] gang baseline ({MP_PROCESSES} processes) "
                      f"in {wd}", flush=True)
            # The uninterrupted gang through the rows' own launch path
            # (max_restarts 0: a baseline may not retry).
            base = subprocess.run(
                [sys.executable, "-m", "fedtpu_torch.cli", *_gang_argv(
                    _run_args(wd, "mp_baseline", rounds, num_clients,
                              platform, hidden_sizes, synthetic_rows), 0)],
                capture_output=True, text=True, timeout=timeout,
                env=_mp_env())
            if base.returncode != 0:
                return {"ok": False, "error": "gang baseline run failed",
                        "rc": base.returncode,
                        "stderr_tail": (base.stderr or "")[-2000:],
                        "scenarios": [], "workdir": wd}
            mp_baseline = _history(os.path.join(wd,
                                                "mp_baseline.metrics.jsonl"))
        rows = []
        for name in names:
            if verbose:
                print(f"[chaos] scenario {name} ...", flush=True)
            t0 = time.monotonic()
            row = run_scenario(name, wd,
                               mp_baseline if name in MP_SCENARIOS
                               else baseline, rounds, num_clients,
                               platform, timeout, hidden_sizes,
                               synthetic_rows)
            row["seconds"] = time.monotonic() - t0
            rows.append(row)
            if verbose:
                status = "ok" if row["ok"] else "FAIL"
                print(f"[chaos]   {name}: {status} rc={row['rc']} "
                      f"survived={row['survived']} "
                      f"history_match={row['history_match']} "
                      f"faults={row['faults']} restarts={row['restarts']} "
                      f"rollbacks={row['rollbacks']}{_detail(row)}",
                      flush=True)
        return {"ok": all(r["ok"] for r in rows), "rounds": rounds,
                "num_clients": num_clients, "scenarios": rows,
                "workdir": wd if keep_artifacts else None}
    finally:
        if own_dir and not keep_artifacts:
            shutil.rmtree(wd, ignore_errors=True)
