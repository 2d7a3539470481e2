"""The port's compositional fuzzer, gang supervisor, fleet chaos rows and
runtime probe (``fedtpu_torch.resilience.fuzz``, ``supervise_gang``,
``chaos``'s gateway, poisoning and wire rows, ``fedtpu_torch.analysis``)
against fedtpu's on the CPU, at fedtpu's frame: sampled campaigns and
digests, the committed corpus (``stale_tail`` against its golden and
fedtpu's run; ``torn_ack_short_write`` against fedtpu's in-process run
only), the WAL short write, the stale-tail guard, ddmin, the corpus gate,
the gang supervisor through stub children, the chaos families, and
``check``'s report, folds and refusals. The six fleet rows launch
subprocess fleets and take minutes each: marked ``slow``, as fedtpu's."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores.
torch.set_num_threads(1)

import ast  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import conftest  # noqa: E402
from fedtpu.resilience import chaos as j_chaos  # noqa: E402
from fedtpu.resilience import fuzz as j_fuzz  # noqa: E402
from fedtpu.resilience import supervisor as j_sup  # noqa: E402

from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.resilience import chaos as t_chaos  # noqa: E402
from fedtpu_torch.resilience import fuzz as t_fuzz  # noqa: E402
from fedtpu_torch.resilience import supervisor as t_sup  # noqa: E402

# The conftest's guard wants a quick-tier pick in every test module; this
# module names its own (sampled campaigns: milliseconds, no gang).
conftest.QUICK_TESTS.add(
    "test_torch_fuzz.py::test_sampled_campaigns_equal_fedtpus[0]")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "corpus")
# fedtpu's committed reproducer of the stale-WAL-tail bug (tests/test_fuzz.py).
STALE_TAIL = {
    "name": "stale_tail", "seed": 11, "rounds": 8,
    "faults": [
        {"kind": "ckpt_corrupt", "mode": "torn", "round": 6, "gateway": 0},
        {"kind": "process_kill", "round": 7, "gateway": 0}]}


@functools.lru_cache(maxsize=None)
def _fedtpu_init() -> torch.Tensor:
    """fedtpu's slot params of the campaign engine (the screen does not
    change them), as the port's ``(C, D)``."""
    from fedtpu.serving.engine import ServingEngine
    from fedtpu.telemetry.metrics import MetricsRegistry
    eng = ServingEngine(j_fuzz._serving_config(
        j_fuzz.Campaign(name="init", seed=0), j_fuzz.FuzzConfig()),
        registry=MetricsRegistry())
    return convert.params_from_jax(jax.tree.map(np.asarray,
                                                eng.state["params"]))


@functools.lru_cache(maxsize=None)
def _fedtpu_run(name: str) -> dict:
    return j_fuzz.run_campaign(os.path.join(CORPUS, f"{name}.json"))


def _t_run(campaign, **kw) -> dict:
    return t_fuzz.run_campaign(campaign, device="cpu",
                               init_params=_fedtpu_init(), **kw)


# ------------------------------------------------------------ campaigns

@pytest.mark.parametrize("seed", [0, 3, 11, 12345])
def test_sampled_campaigns_equal_fedtpus(seed):
    """``sample_campaign(seed, i)`` is fedtpu's: canonical JSON and digest
    bit for bit over 25 indices, default and a narrowed frame."""
    for cfg in (None, dict(rounds=5, gateways=3)):
        t_cfg = t_fuzz.FuzzConfig(**cfg) if cfg else None
        j_cfg = j_fuzz.FuzzConfig(**cfg) if cfg else None
        for i in range(25):
            t = t_fuzz.sample_campaign(seed, i, cfg=t_cfg)
            j = j_fuzz.sample_campaign(seed, i, cfg=j_cfg)
            assert t.to_json() == j.to_json() and t.digest == j.digest
    assert t_fuzz.PROC_KINDS == j_fuzz.PROC_KINDS
    assert t_fuzz.NOTICE_KINDS == j_fuzz.NOTICE_KINDS


@pytest.mark.parametrize("name", ["stale_tail", "torn_ack_short_write",
                                  "tampered"])
def test_corpus_campaigns_load_as_fedtpus(name, tmp_path):
    """Each committed campaign loads from a path, a dict and inline JSON to
    fedtpu's canonical form and its stamped digest; an entry edited
    without re-stamping is refused, by ``load`` and by the corpus gate."""
    stem = "stale_tail" if name == "tampered" else name
    src = os.path.join(CORPUS, f"{stem}.json")
    with open(src, encoding="utf-8") as fh:
        manifest = json.load(fh)
    if name == "tampered":
        manifest["faults"][0]["round"] = 5
        with pytest.raises(ValueError, match="digest mismatch"):
            t_fuzz.Campaign.load(manifest)
        (tmp_path / "stale_tail.json").write_text(json.dumps(manifest))
        gate = t_fuzz.run_corpus(str(tmp_path), device="cpu")
        assert not gate["ok"]
        assert "digest mismatch" in gate["rows"][0]["reason"]
        return
    want = j_fuzz.Campaign.load(src)
    for spec in (src, manifest, json.dumps(manifest)):
        got = t_fuzz.Campaign.load(spec)
        assert got.to_json() == want.to_json()
        assert got.digest == manifest["digest"]


@pytest.mark.parametrize("name", ["stale_tail", "torn_ack_short_write"])
def test_corpus_replay_is_fedtpus(name):
    """The committed campaign through the port's gang (fedtpu's init
    injected at every boot): its wire lines and verdict artifact equal
    fedtpu's in-process run, and a second run is bitwise. ``stale_tail``
    (no screen) also equals its committed golden. ``torn_ack_short_write``
    screens: one of its screen decisions sits on the edge, and fedtpu's
    own run can read incorporated 155, screened 14 where the golden says
    154, 15 (the decision tips with the host's float order), so it is held
    to fedtpu's run, not to the golden."""
    want = _fedtpu_run(name)
    got = _t_run(os.path.join(CORPUS, f"{name}.json"))
    assert got["lines"] == want["lines"]
    assert got["artifact"] == want["artifact"]
    assert got["ok"] and not got["failed"]
    again = _t_run(os.path.join(CORPUS, f"{name}.json"))
    assert (again["lines"], again["artifact"]) == (got["lines"],
                                                   got["artifact"])
    if name == "stale_tail":
        with open(os.path.join(CORPUS, f"{name}.golden.jsonl")) as fh:
            assert fh.read().splitlines() == got["artifact"]


@pytest.mark.parametrize("guard", ["on", "off"])
def test_stale_wal_tail_guard(guard):
    """With the guard (the default) ``stale_tail`` passes every oracle;
    replaying the stale tail onto the older round loses acked updates,
    caught by the same two oracles as fedtpu's test names."""
    res = _t_run(STALE_TAIL, replay_stale_wal_tail=(guard == "off"))
    if guard == "on":
        assert res["ok"] and res["summary"]["lost_acked"] == 0
        return
    assert not res["ok"]
    assert {"exactly_once", "no_lost_acked"} <= set(res["failed"])
    assert res["summary"]["lost_acked"] > 0


def _feed(eng, nonce, seq, n=6, t0=0.0):
    from fedtpu_torch.serving.server import _handle
    rows = [[u, t0 + 0.3 * u, 0.1] for u in range(n)]
    return _handle(eng, {"op": "updates", "events": rows, "nonce": nonce,
                         "seq": seq})


def test_wal_shortwrite_tears_cleanly_and_retry_dedups(tmp_path):
    """fedtpu's drill on the port's engine: a short WAL append raises
    ENOSPC after flushing the damaged prefix, the replay tears at it, the
    acked frame's retry dedups to its original counts and the torn,
    unacked frame's retry is fresh work, incorporated once."""
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.server import _handle

    def make():
        return ServingEngine(ServingConfig(
            cohort=8, buffer_size=2, tick_interval_s=0.5, data_rows=64,
            model_hidden=(8,), seed=0), device="cpu")

    wal = str(tmp_path / "wal.jsonl")
    eng = make()
    eng.wal_path = wal
    first = _feed(eng, "n0", 1)
    assert first["op"] == "acks" and not first.get("duplicate")
    eng.wal_shortwrite = lambda nonce, seq, line: 25
    with pytest.raises(OSError, match="No space left"):
        _feed(eng, "n0", 2, t0=10.0)
    eng.wal_shortwrite = None
    with open(wal, encoding="utf-8") as fh:
        assert len(fh.read().splitlines()[-1]) == 25
    eng2 = make()
    eng2.wal_path = wal
    assert eng2.replay_wal() == 6
    before = eng2.signals()["incorporated"]
    dup = _feed(eng2, "n0", 1)
    assert dup.get("duplicate") is True and dup["counts"] == first["counts"]
    assert not _feed(eng2, "n0", 2, t0=10.0).get("duplicate")
    assert _feed(eng2, "n0", 2, t0=10.0).get("duplicate") is True
    _handle(eng2, {"op": "drain"})
    sig = eng2.signals()
    assert sig["incorporated"] > before and sig["backlog"] == 0


@pytest.mark.parametrize("predicate", ["pure", "gang"])
def test_shrink_campaign_gives_fedtpus_reproducer(predicate, tmp_path):
    """ddmin over fedtpu's noisy campaign. ``pure``: a predicate that runs
    no gang (the stale-tail pair is present) gives fedtpu's reproducer,
    run count and removals. ``gang``: the port's own unguarded replay as
    the predicate shrinks to the stale-tail pair (fedtpu's slow test's
    claim), which round-trips through the corpus layout and its gate."""
    noisy = dict(STALE_TAIL, name="noisy", faults=STALE_TAIL["faults"] + [
        {"kind": "straggler", "round": 3, "gateway": 1, "delay_s": 1.0},
        {"kind": "client_dropout", "round": 2, "frac": 0.25}],
        net_faults=[{"kind": "net_torn_frame", "gateway": 1, "frame": 4,
                     "boundary": "post_ack", "cut_bytes": 48},
                    {"kind": "net_dup_frame", "gateway": 0, "frame": 9}],
        notices=[{"kind": "preempt_notice", "round": 4, "gateway": 1}])
    if predicate == "pure":
        def keeps_pair(c):
            return all(f in c.faults for f in STALE_TAIL["faults"])
        got = t_fuzz.shrink_campaign(noisy, predicate=keeps_pair)
        want = j_fuzz.shrink_campaign(noisy, predicate=keeps_pair)
        assert got["campaign"].to_json() == want["campaign"].to_json()
        assert (got["runs"], got["removed"]) == (want["runs"],
                                                 want["removed"])
        return

    def unguarded_fails(c):
        return not _t_run(c, replay_stale_wal_tail=True)["ok"]

    mini = t_fuzz.shrink_campaign(noisy, predicate=unguarded_fails)
    mc = mini["campaign"]
    assert mini["removed"] == 5 and mc.faults == STALE_TAIL["faults"]
    assert mc.net_faults == [] and mc.notices == []
    t_fuzz.write_corpus_entry(mc, _t_run(mc)["artifact"], str(tmp_path))
    gate = t_fuzz.run_corpus(str(tmp_path), device="cpu",
                             init_params=_fedtpu_init())
    assert gate["ok"], gate["rows"]


def test_run_corpus_refuses_an_empty_directory(tmp_path):
    report = t_fuzz.run_corpus(str(tmp_path), device="cpu")
    assert not report["ok"] and "no campaigns" in report["reason"]
    assert report == j_fuzz.run_corpus(str(tmp_path))


# ------------------------------------------------------- gang supervisor

# A stub gang member: records its identity and argv, then acts on the
# plan's entry for "<restarts>.<index>" (an exit code, or "sleep").
_STUB = r"""
import json, os, sys, time
r, i = os.environ["FEDTPU_RESTARTS"], os.environ["FEDTPU_PROCESS_ID"]
rec = {k: v for k, v in os.environ.items() if k.startswith("FEDTPU_")}
rec["argv"] = sys.argv[1:]
with open(os.path.join(os.environ["STUB_DIR"], f"{r}.{i}"), "w") as fh:
    json.dump(rec, fh)
act = json.loads(os.environ["STUB_PLAN"]).get(f"{r}.{i}", 0)
if act == "sleep":
    time.sleep(60)
sys.exit(act)
"""

_GANG_PLANS = {
    "env": {},
    "teardown": {"0.0": "sleep", "0.1": 1},
    "diverged": {"0.0": "sleep", "0.1": 3},
    "done": {"0.1": 76},
}


def _gang(sup, plan: dict, directory,
          child=("gateway", "--num-gateways", "2")) -> tuple:
    os.makedirs(directory)
    events = os.path.join(directory, "events.jsonl")
    rc = sup.supervise_gang(
        list(child), num_processes=2,
        max_restarts=1, backoff_base=0.0, grace=5.0,
        heartbeat=os.path.join(directory, "hb"), events=events,
        extra_env={"STUB_DIR": str(directory), "STUB_PLAN": json.dumps(plan)},
        _cmd_prefix=[sys.executable, "-c", _STUB], verbose=False)
    with open(events) as fh:
        kinds = [json.loads(line) for line in fh]
    exits = [e["payload"]["gang_rcs"] for e in kinds
             if e["kind"] == "child_exit"]
    members = {}
    for name in sorted(os.listdir(directory)):
        if name[0].isdigit():
            with open(os.path.join(directory, name)) as fh:
                members[name] = json.load(fh)
    return rc, exits, members


@pytest.mark.parametrize("case", sorted(_GANG_PLANS) + ["run_refused"])
def test_supervise_gang_is_fedtpus(case, tmp_path):
    """``supervise_gang`` through stub children, beside fedtpu's: the same
    exit code, launches and per-member exit codes. ``env``: each member's
    index, the gang size, one rendezvous address and launch id across the
    gang, restart count 0 and the heartbeat base; ``teardown``: member 1's
    crash SIGTERMs member 0 and relaunches the gang once, with
    ``--resume`` and a fresh launch id; ``diverged`` (3) and ``done`` (0,
    and 76 from one member) end without a restart. ``run_refused`` (the
    name it had while a ``run`` gang was refused): a ``run`` gang is
    launched and torn down as fedtpu's, its relaunch with ``--resume``."""
    if case == "run_refused":
        run = ("run", "--rounds", "4")
        plan = _GANG_PLANS["teardown"]
        got = _gang(t_sup, plan, tmp_path / "t", child=run)
        want = _gang(j_sup, plan, tmp_path / "j", child=run)
        assert got[:2] == want[:2] == (0, [[-15, 1], [0, 0]])
        # Member 0 of the first launch may be torn down before it writes
        # its record (member 1 exits at once), in either package.
        for members in (got[2], want[2]):
            assert {"0.1", "1.0", "1.1"} <= set(members) <= {
                "0.0", "0.1", "1.0", "1.1"}
            assert all(("--resume" in m["argv"]) == name.startswith("1.")
                       for name, m in members.items())
        return
    plan = _GANG_PLANS[case]
    got = _gang(t_sup, plan, tmp_path / "t")
    want = _gang(j_sup, plan, tmp_path / "j")
    assert got[:2] == want[:2]
    assert sorted(got[2]) == sorted(want[2])
    rc, exits, members = got
    assert rc == {"env": 0, "teardown": 0, "diverged": 3, "done": 0}[case]
    assert len(exits) == (2 if case == "teardown" else 1)
    for launch in {k.split(".")[0] for k in members}:
        ids = [members[f"{launch}.{i}"] for i in range(2)]
        assert [m["FEDTPU_PROCESS_ID"] for m in ids] == ["0", "1"]
        assert {m["FEDTPU_NUM_PROCESSES"] for m in ids} == {"2"}
        assert len({m["FEDTPU_COORDINATOR"] for m in ids}) == 1
        assert len({m["FEDTPU_LAUNCH_ID"] for m in ids}) == 1
        assert {m["FEDTPU_RESTARTS"] for m in ids} == {launch}
        assert all(m["argv"][m["argv"].index("--heartbeat") + 1]
                   == str(tmp_path / "t" / "hb") for m in ids)
        assert all(("--resume" in m["argv"]) == (launch != "0") for m in ids)
    if case == "teardown":
        assert exits[0] == [-15, 1] and exits[1] == [0, 0]
        assert (members["0.0"]["FEDTPU_LAUNCH_ID"]
                != members["1.0"]["FEDTPU_LAUNCH_ID"])
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_LAUNCH_ID"):
        from fedtpu.resilience import distributed as j_dist
        from fedtpu_torch.resilience import distributed as t_dist
        assert getattr(t_dist, name) == getattr(j_dist, name)


# --------------------------------------------------------------- chaos

def test_chaos_fleet_families_equal_fedtpus():
    """The family tuples, the fleet rows' constants and the wire plans are
    fedtpu's; the fleet rows run by default beside the single-process
    ones, the training-gang rows and the reshard and autoscale rows, with
    fedtpu's reshard timeout and SLO budget."""
    for name in ("MP_SCENARIOS", "RESHARD_SCENARIOS", "AUTOSCALE_SCENARIO",
                 "GATEWAY_SCENARIOS", "NET_SCENARIOS", "POISON_SCENARIO",
                 "GATEWAY_BURN_BUDGET", "NET_BURN_BUDGET", "POISON_USERS",
                 "POISON_ARRIVALS", "POISON_HORIZON_S", "POISON_TRACE_SEED",
                 "POISON_FRAC", "POISON_SCALE", "POISON_ACCURACY_TOL",
                 "POISON_DEGRADE_MIN", "_NET_PLANS", "MP_PROCESSES",
                 "MP_COLLECTIVE_TIMEOUT", "MP_RESHARD_DEAD_TIMEOUT",
                 "AUTOSCALE_BURN_BUDGET"):
        assert getattr(t_chaos, name) == getattr(j_chaos, name), name
    assert t_chaos.MP_SHARDS_PER_PROC == j_chaos.MP_DEVICES_PER_PROC
    assert t_chaos.scenarios_help() == j_chaos.scenarios_help()
    assert set(t_chaos.PORTED_SCENARIOS) == set(
        t_chaos.SINGLE_PROCESS_SCENARIOS + t_chaos.GANG_SCENARIOS
        + t_chaos.RESHARD_SCENARIOS + (t_chaos.AUTOSCALE_SCENARIO,)
        + t_chaos.FLEET_SCENARIOS) == set(j_chaos.SCENARIOS)


_ROW_BARS = {
    "mp_gateway_kill": lambda r: (r["gang_restarts"] >= 1
                                  and r["duplicate_drops"] >= 1
                                  and r["lost_acked"] == 0),
    "mp_store_shard_kill": lambda r: r["history_match"] is True,
    "mp_poison_campaign": lambda r: (
        r["quarantined"] == r["attackers"] and not r["quarantined_honest"]
        and r["gang_restarts"] == 0
        and r["accuracy_defended"] >= r["accuracy_clean"] - 0.01
        and r["accuracy_undefended"] <= r["accuracy_clean"] - 0.05),
    "mp_net_partition": lambda r: True,
    "mp_slow_gateway": lambda r: True,
    "mp_torn_frame": lambda r: True,
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(_ROW_BARS))
def test_fleet_chaos_row(name, tmp_path):
    """Each fleet row end to end on the CPU, as fedtpu's slow row tests
    (``tests/test_gateway.py``, ``test_netfaults.py``,
    ``test_robust_defense.py``): the row is ok, with fedtpu's extra bars."""
    row = t_chaos.run_scenario(name, str(tmp_path), {}, 0, 0,
                               platform="cpu", timeout=570)
    assert row["ok"], json.dumps(row, indent=2, default=str)
    assert _ROW_BARS[name](row), row


# --------------------------------------------------------------- check

def _fedtpu_report_keys() -> set:
    """The keys of the report fedtpu's ``run_check`` returns, read from
    its source (running it compiles the JAX round step)."""
    import fedtpu.analysis.check as j_check
    with open(j_check.__file__) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_check")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def _dead_fleet(base: str) -> None:
    """Port files for a two-gateway fleet whose port nothing listens on."""
    with socket.socket() as s:  # fedtpu: noqa[FTP009] bind-only port probe, never blocks on I/O
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for g in range(2):
        with open(f"{base}.g{g}", "w") as fh:
            fh.write(str(port))


def test_check_report_and_folds_are_fedtpus(tmp_path, capsys):
    """``check --platform cpu --json`` with every runnable fold: fedtpu's
    report keys (the port adds its own), recompiles 0, the transfer guard
    not applying on the CPU; each golden fold's verdict and reason equal
    to fedtpu's simulation against the same golden, the dead fleet's
    probe rows fedtpu's; the corpus fold replays both campaigns bitwise
    with every oracle passing (``stale_tail`` on its golden)."""
    from fedtpu.autoscale.controller import simulate as j_auto
    from fedtpu.resilience.net_sim import simulate as j_net
    from fedtpu.robust.defense_sim import simulate as j_defense
    from fedtpu.serving.gateway import probe_fleet as j_probe
    from fedtpu.telemetry.timeline_sim import simulate as j_timeline

    from fedtpu_torch.autoscale.controller import compare_decisions
    from fedtpu_torch.cli import main as t_main
    goldens = os.path.join(REPO, "tests", "goldens")
    base = str(tmp_path / "fleet")
    _dead_fleet(base)
    folds = {"autoscale_sim": j_auto, "defense_sim": j_defense,
             "net_sim": j_net, "timeline_sim": j_timeline}
    argv = ["check", "--platform", "cpu", "--json", "--gateway-probe", base,
            "--gateway-count", "2", "--fuzz-corpus", CORPUS]
    for key in folds:
        argv += [f"--{key.replace('_', '-')}",
                 os.path.join(goldens, f"{key}.jsonl")]
    rc = t_main(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _fedtpu_report_keys() <= set(report)
    assert report["recompiles"] == 0 and report["sentinel_available"]
    assert report["backend"] == "cpu"
    assert report["transfer_guard_applies"] is False
    for key, sim in folds.items():
        want = compare_decisions(sim()["lines"],
                                 os.path.join(goldens, f"{key}.jsonl"))
        got = report[key]
        assert (got["ok"], got["reason"]) == (want["ok"], want["reason"]), key
    probe = j_probe(base, 2)
    assert [(r["ok"], r["error"].split(":")[0])
            for r in report["gateway_probe"]] == [
        (r["ok"], r["error"].split(":")[0]) for r in probe]
    rows = {r["name"]: r for r in report["fuzz_corpus"]["rows"]}
    assert sorted(rows) == ["stale_tail", "torn_ack_short_write"]
    assert all(r["oracles_ok"] and r["replay_bitwise"] for r in rows.values())
    assert rows["stale_tail"]["golden_ok"]
    want_ok = (all(report[k]["ok"] for k in folds)
               and report["fuzz_corpus"]["ok"] and report["recompiles"] == 0)
    assert report["ok"] is False and want_ok is False and rc == 1


@pytest.mark.parametrize("flag,item", [
    (["--audit"], "A11d"), (["--lockdep"], "A11d"),
    # Its id is the one it had while --mpmd named A10, before A10's split.
    pytest.param(["--mpmd"], "A10c", id="flag2-A10"),
    (["--warmup-cache", "cache"], "A11c")])
def test_check_refuses_what_is_not_ported(flag, item):
    from fedtpu_torch.cli import main as t_main
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\)"):
        t_main(["check", "--platform", "cpu", *flag])


def test_recompile_sentinel_counts_compile_events():
    """The sentinel counts the registry's compile events inside its window
    only (the negative control the card's check runs with a real
    recapture), and adds them to ``unexpected_retraces``."""
    from fedtpu_torch.analysis.guards import (RecompileSentinel,
                                              RetraceError, first_nonfinite)
    from fedtpu_torch.telemetry.metrics import (MetricsRegistry,
                                                compile_event)
    reg = MetricsRegistry()
    sentinel = RecompileSentinel(label="probe", registry=reg, fail=True)
    compile_event("graph_capture", 0.0)
    with pytest.raises(RetraceError, match="2 unexpected"):
        with sentinel.armed():
            compile_event("graph_capture", 0.0)
            compile_event("kernel_build", 0.0)
    compile_event("kernel_build", 0.0)
    assert sentinel.count == 2
    assert reg.snapshot()["counters"]["unexpected_retraces"] == 2
    state = {"a": torch.zeros(2), "b": {"c": torch.tensor([1.0, np.nan])},
             "n": torch.zeros(2, dtype=torch.int32)}
    assert first_nonfinite(state) == "b/c"
    state["b"]["c"] = torch.ones(2)
    assert first_nonfinite(state) is None
