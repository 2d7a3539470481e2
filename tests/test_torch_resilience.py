"""The port's resilience loop (``fedtpu_torch.resilience`` and the round
loop's hooks) against fedtpu's on the CPU: fault plans and their digests,
the validation table, the injector, a dropout run, the divergence
rollback (its replay, its events, a perturbed second retry with fedtpu's
draw, the spent budget, the exclusion), the SIGTERM drain and resume, the
heartbeat, the corrupt checkpoint's fallback, the supervisor's restart
decisions, the chaos registry, the oracles, one supervised SIGKILL row
through the CLI, and C7 (``run`` exits 3 on a divergence halt, 75 after a
drain, in both CLIs)."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import conftest  # noqa: E402
import fedtpu.config as jcfg  # noqa: E402
import fedtpu.orchestration.loop as j_loop  # noqa: E402
from fedtpu.resilience import chaos as j_chaos  # noqa: E402
from fedtpu.resilience import faults as j_faults  # noqa: E402
from fedtpu.resilience import oracles as j_oracles  # noqa: E402
from fedtpu.resilience import supervisor as j_sup  # noqa: E402

import fedtpu_torch.config as tcfg  # noqa: E402
import fedtpu_torch.orchestration.loop as t_loop  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.orchestration import checkpoint as t_ckpt  # noqa: E402
from fedtpu_torch.resilience import chaos as t_chaos  # noqa: E402
from fedtpu_torch.resilience import faults as t_faults  # noqa: E402
from fedtpu_torch.resilience import oracles as t_oracles  # noqa: E402
from fedtpu_torch.resilience import supervisor as t_sup  # noqa: E402

from test_torch_round import (_assert_events_match, _event_pair,  # noqa: E402
                              _fedtpu_init as _build_fedtpu_init, _sink)

# The conftest's guard wants a quick-tier pick in every test module; this
# module names its own (the plan digests: milliseconds, no run).
conftest.QUICK_TESTS.add(
    "test_torch_resilience.py::test_plan_equals_fedtpus[inline]")

ROUNDS = 8


def _cfgs(fed=None, **run):
    """fedtpu's and the port's config of one small synthetic run (4
    clients, 14 -> 8 -> 2, 256 rows, no early stop)."""
    fed = {"rounds": ROUNDS, "termination_patience": 100, **(fed or {})}
    return tuple(m.ExperimentConfig(
        data=m.DataConfig(csv_path=None, synthetic_rows=256),
        shard=m.ShardConfig(num_clients=4),
        model=m.ModelConfig(hidden_sizes=(8,)),
        fed=m.FedConfig(**fed), run=m.RunConfig(**run))
        for m in (jcfg, tcfg))


_INITS = {}


def _fedtpu_init(j_cfg):
    """fedtpu's client-stacked init of the small model (built once: every
    config here shares data, clients and model)."""
    if "init" not in _INITS:
        _INITS["init"] = _build_fedtpu_init(j_cfg)
    return _INITS["init"]


def _plan(*faults, seed=0) -> str:
    return json.dumps({"seed": seed, "faults": list(faults)})


def _t_run(cfg, **kw):
    return t_loop.run_experiment(cfg, verbose=False, device="cpu", **kw)


def _same_run(a, b) -> None:
    """Two port runs bitwise: histories, losses, counts, final params."""
    assert a.rounds_run == b.rounds_run
    for name in ("global_metrics", "pooled_metrics", "test_metrics"):
        assert getattr(a, name) == getattr(b, name), name
    for x, y in zip(a.loss + a.confusion, b.loss + b.confusion):
        assert np.array_equal(x, y)
    ja, jb = (jax.tree.leaves(r.final_params) for r in (a, b))
    assert all(np.array_equal(x, y) for x, y in zip(ja, jb))


# ------------------------------------------------------------ fault plans

_SPECS = {
    "inline": _plan({"kind": "client_dropout", "round": 3, "clients": [1]},
                    {"kind": "straggler", "round": 2, "clients": [0],
                     "delay_s": 0.05},
                    {"kind": "nan_update", "round": 4, "clients": [2]},
                    {"kind": "process_kill", "round": 5, "signal": "SIGTERM",
                     "process_index": 0},
                    {"kind": "ckpt_corrupt", "round": 6}),
    "probabilistic": {"seed": 7, "faults": [
        {"kind": "client_dropout", "probability": 0.4, "clients": [0, 3],
         "sticky": True},
        {"kind": "straggler", "probability": 0.5, "rounds": [2, 6],
         "clients": [1], "delay_s": 0.01},
        {"kind": "collective_hang", "round": 7, "delay_s": 0.5,
         "process_index": -1}]},
    "reshard": {"faults": [
        {"kind": "preempt_notice", "round": 3, "target_clients": 2,
         "process_index": 1},
        {"kind": "preempt_cancel", "round": 5}]},
    "file": None,
}


@pytest.mark.parametrize("form", sorted(_SPECS))
def test_plan_equals_fedtpus(form, tmp_path):
    """Each spec form (inline JSON, a dict with probabilistic entries, the
    reshard kinds, a file) materializes to fedtpu's schedule, payloads and
    digest."""
    spec = _SPECS[form]
    if form == "file":
        spec = str(tmp_path / "plan.json")
        with open(spec, "w") as fh:
            fh.write(_SPECS["inline"])
    t = t_faults.FaultPlan.load(spec, num_clients=4, rounds=ROUNDS)
    j = j_faults.FaultPlan.load(spec, num_clients=4, rounds=ROUNDS)
    assert t.digest == j.digest and t.seed == j.seed
    assert [dataclasses.asdict(f) for f in t.faults] == \
        [dataclasses.asdict(f) for f in j.faults]
    assert [f.payload() for f in t.faults] == [f.payload() for f in j.faults]
    assert t_faults.KINDS == j_faults.KINDS
    assert t_faults.ONCE_KINDS == j_faults.ONCE_KINDS
    assert t_faults.RESHARD_KINDS == j_faults.RESHARD_KINDS


_BAD_ENTRIES = [
    {"kind": "meteor", "round": 1},
    {"kind": "straggler", "probability": 1.5, "delay_s": 1},
    {"kind": "straggler", "delay_s": 1},
    {"kind": "client_dropout", "round": 1, "clients": [9]},
    {"kind": "nan_update", "round": 1},
    {"kind": "process_kill", "round": 1, "signal": "SIGHUP"},
    {"kind": "straggler", "round": 1},
    {"kind": "preempt_notice", "round": 1, "target_clients": 4},
    {"kind": "preempt_cancel", "round": 1, "target_clients": 5},
    {"kind": "ckpt_corrupt", "round": ROUNDS + 1},
]


@pytest.mark.parametrize("entry", _BAD_ENTRIES)
def test_plan_refuses_what_fedtpu_refuses(entry):
    spec = {"faults": [entry]}
    with pytest.raises(ValueError) as j_err:
        j_faults.FaultPlan.load(spec, num_clients=4, rounds=ROUNDS)
    with pytest.raises(ValueError) as t_err:
        t_faults.FaultPlan.load(spec, num_clients=4, rounds=ROUNDS)
    assert str(t_err.value) == str(j_err.value)


# fedtpu's validation of the resilience knobs, each row (fed, run) refused
# by both with the same words before any build.
_VALIDATION = [
    ({}, dict(on_divergence="retry")),
    ({}, dict(on_divergence="rollback")),
    ({}, dict(on_divergence="rollback", checkpoint_dir="ck")),
    ({}, dict(on_divergence="rollback", checkpoint_dir="ck",
              checkpoint_every=2, pipelined_stop=True)),
    ({}, dict(rollback_exclude=True)),
    (dict(async_mode=True, weighting="uniform"),
     dict(on_divergence="rollback", rollback_exclude=True,
          checkpoint_dir="ck", checkpoint_every=2)),
    (dict(weighting="uniform"),
     dict(on_divergence="rollback", rollback_exclude=True,
          checkpoint_dir="ck", checkpoint_every=2)),
]


@pytest.mark.parametrize("row", range(len(_VALIDATION)))
def test_resilience_validation_equals_fedtpus(row, tmp_path):
    fed, run = _VALIDATION[row]
    if "checkpoint_dir" in run:
        run = dict(run, checkpoint_dir=str(tmp_path / "ck"))
    j_cfg, t_cfg = _cfgs(fed, **run)
    with pytest.raises(ValueError) as j_err:
        j_loop.run_experiment(j_cfg, verbose=False)
    with pytest.raises(ValueError) as t_err:
        _t_run(t_cfg)
    assert str(t_err.value) == str(j_err.value)
    assert not os.path.exists(tmp_path / "ck")


def test_reshard_kinds_and_cohort_mode_refuse_a_plan(tmp_path):
    """A plan with the reshard kinds under a config that cannot reshard
    live (two rounds a chunk) is refused at start with fedtpu's words;
    cohort mode refuses a plan and rollback with fedtpu's words."""
    j_cfg, t_cfg = _cfgs(fault_plan=json.dumps(_SPECS["reshard"]),
                         rounds_per_step=2)
    with pytest.raises(ValueError) as j_err:
        j_loop.run_experiment(j_cfg, verbose=False)
    with pytest.raises(ValueError) as t_err:
        _t_run(t_cfg)
    assert str(t_err.value) == str(j_err.value)
    assert "rounds_per_step=1" in str(t_err.value)
    for run in (dict(fault_plan=_SPECS["inline"]),
                dict(on_divergence="rollback", checkpoint_every=2,
                     checkpoint_dir=str(tmp_path / "ck"))):
        _, t_cfg = _cfgs(dict(cohort_size=2), **run)
        with pytest.raises(ValueError, match="supports on_divergence='halt' "
                           "only"):
            _t_run(t_cfg)


def test_injector_decisions_equal_fedtpus():
    """chunk_limit over every (round, width), once-kind disarming after a
    restart, and exclude, against fedtpu's injector."""
    plan = _SPECS["inline"]
    for restarts in (0, 1):
        t = t_faults.FaultInjector(
            t_faults.FaultPlan.load(plan, 4, ROUNDS), restart_count=restarts)
        j = j_faults.FaultInjector(
            j_faults.FaultPlan.load(plan, 4, ROUNDS), restart_count=restarts)
        assert t.armed_count == j.armed_count
        for rnd in range(ROUNDS):
            for take in range(1, ROUNDS - rnd + 1):
                assert t.chunk_limit(rnd, take) == j.chunk_limit(rnd, take)
        t.exclude([1])
        j.exclude([1])
        assert t.armed_count == j.armed_count
        assert [t.chunk_limit(r, 4) for r in range(ROUNDS)] == \
            [j.chunk_limit(r, 4) for r in range(ROUNDS)]
    # The reshard kinds bound the chunk on a first launch only.
    t = t_faults.FaultInjector(t_faults.FaultPlan.load(
        _SPECS["reshard"], 4, ROUNDS))
    j = j_faults.FaultInjector(j_faults.FaultPlan.load(
        _SPECS["reshard"], 4, ROUNDS))
    assert t.armed_count == j.armed_count == 0
    assert [t.chunk_limit(r, 8 - r) for r in range(ROUNDS)] == \
        [j.chunk_limit(r, 8 - r) for r in range(ROUNDS)]


def test_injector_edits_in_place():
    """The port's faults edit the live tensors (the CUDA graph's static
    inputs): dropout zeroes mask and weight rows and post_round restores
    them; nan_update NaNs the params rows; nothing is rebound."""
    plan = t_faults.FaultPlan.load(_plan(
        {"kind": "client_dropout", "round": 2, "clients": [1, 3]},
        {"kind": "nan_update", "round": 2, "clients": [0]}), 4, ROUNDS)
    inj = t_faults.FaultInjector(plan)
    mask, weights = torch.ones(4, 5), torch.arange(1.0, 5.0)
    params = torch.zeros(4, 3, dtype=torch.bfloat16)
    state, batch = {"params": params}, {"mask": mask}
    assert inj.pre_round(0, state, batch, weights=weights) == []
    due = inj.pre_round(1, state, batch, weights=weights)
    assert [f.kind for f in due] == ["client_dropout", "nan_update"]
    assert batch["mask"] is mask and state["params"] is params
    assert mask[[1, 3]].abs().sum() == 0 and mask[[0, 2]].min() == 1
    assert weights.tolist() == [1.0, 0.0, 3.0, 0.0]
    assert torch.isnan(params[0]).all() and not torch.isnan(params[1:]).any()
    inj.post_round(1, batch, weights=weights)
    assert mask.min() == 1 and weights.tolist() == [1.0, 2.0, 3.0, 4.0]


# ------------------------------------------------------------ faulted runs

@pytest.mark.parametrize("case", ["one", "sticky"])
def test_dropout_run_matches_fedtpu(case, tmp_path):
    """Dropout rounds from fedtpu's init: the same stop round, histories
    within 1e-4, per-client metrics (the confusion counts' currency)
    equal, a faulted round's client mean over its live clients. "sticky":
    client 3 out for good from round 3; in round 4 client 1 out for the
    round, then client 2 "for good", which fedtpu's undo of the round's
    first non-sticky dropout puts back after round 4."""
    faults = [{"kind": "client_dropout", "round": 4, "clients": [1]}]
    if case == "sticky":
        faults = [{"kind": "client_dropout", "round": 3, "clients": [3],
                   "sticky": True}, *faults,
                  {"kind": "client_dropout", "round": 4, "clients": [2],
                   "sticky": True}]
    j_cfg, t_cfg = _cfgs(rounds_per_step=3, fault_plan=_plan(*faults))
    rj = j_loop.run_experiment(j_cfg, verbose=False)
    rt = _t_run(t_cfg, init_params=_fedtpu_init(j_cfg))
    assert rt.rounds_run == rj.rounds_run == ROUNDS
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in rj.global_metrics:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-4)
        np.testing.assert_allclose(np.stack(rt.per_client_metrics[name]),
                                   np.stack(rj.per_client_metrics[name]),
                                   atol=1e-6)
    out = {"one": {3: [1]}, "sticky": {2: [3], 3: [1, 2, 3], 4: [3]}}[case]
    for r in range(ROUNDS):
        dropped = out.get(r, out[max(k for k in out if k <= r)]
                          if case == "sticky" and r >= 2 else [])
        live = [c for c in range(4) if c not in dropped]
        assert [c for c in range(4) if not rt.confusion[r][c].any()] == \
            dropped, r
        acc = rt.per_client_metrics["accuracy"][r]
        assert rt.global_metrics["accuracy"][r] == pytest.approx(
            float(np.mean(acc[live])), abs=1e-6)


def _nan_cfgs(tmp_path, faults, **run):
    return _cfgs(rounds_per_step=2, checkpoint_every=2,
                 checkpoint_dir=str(tmp_path / "ck"),
                 on_divergence="rollback", fault_plan=_plan(*faults), **run)


def test_nan_rollback_is_bitwise_and_its_events_equal_fedtpus(tmp_path):
    """A NaN update rolls back to the last checkpoint and replays: bitwise
    the port's own uninterrupted run, and the whole sink (fault, rollback,
    rounds, spans, counters) as fedtpu's for the same run."""
    j_cfg, t_cfg = _nan_cfgs(tmp_path, [
        {"kind": "nan_update", "round": 5, "clients": [1]}])
    j_ev, t_ev, rt = _event_pair(j_cfg, t_cfg, tmp_path,
                                 init_params=_fedtpu_init(j_cfg))
    # The diverged round's NaN loss mean, on both sides, made comparable.
    for t, j in zip(*([e["payload"] for e in ev if e["kind"] == "round"]
                      for ev in (t_ev, j_ev))):
        if np.isnan(t["loss_mean"]):
            assert np.isnan(j["loss_mean"])
            t["loss_mean"] = j["loss_mean"] = 0.0
    _assert_events_match(j_ev, t_ev)
    rb = [e["payload"] for e in t_ev if e["kind"] == "rollback"]
    assert rb == [{"restored_round": 4, "attempt": 1, "reason":
                   "loss/metrics at round 5", "excluded": []}]
    assert rt.rollbacks == 1 and not rt.diverged
    plain = _t_run(_cfgs(rounds_per_step=2)[1],
                   init_params=_fedtpu_init(j_cfg))
    _same_run(rt, plain)


def _fedtpu_draw(j_cfg, attempt: int) -> torch.Tensor:
    """fedtpu's perturbation draw of rollback ``attempt`` (its
    ``_perturb_tree``: ``jax.random.key(attempt)`` split per leaf of the
    client-stacked params) in the port's flat layout."""
    tree = _fedtpu_init(j_cfg)
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.key(attempt), len(leaves))
    draws = [np.asarray(jax.random.uniform(k, leaf.shape, leaf.dtype))
             for leaf, k in zip(leaves, keys)]
    return convert.params_from_jax(jax.tree.unflatten(treedef, draws))


def test_second_retry_with_fedtpus_draw_matches(tmp_path, monkeypatch):
    """Two NaN updates: the second rollback perturbs the restored params;
    with fedtpu's draw injected the run is fedtpu's (params within 1e-5);
    with the port's own draw it is deterministic."""
    faults = [{"kind": "nan_update", "round": 3, "clients": [1]},
              {"kind": "nan_update", "round": 5, "clients": [2]}]
    j_cfg, t_cfg = _nan_cfgs(tmp_path, faults, rollback_perturb=1e-3)
    rj = j_loop.run_experiment(j_cfg, verbose=False)
    own_perturb = t_faults.perturb_params
    attempts = []

    def fedtpus_draw(params, attempt, scale, **kw):
        attempts.append(attempt)
        own_perturb(params, attempt, scale,
                    **{**kw, "uniform": _fedtpu_draw(j_cfg, attempt)})

    with monkeypatch.context() as m:
        m.setattr(t_faults, "perturb_params", fedtpus_draw)
        rt = _t_run(dataclasses.replace(t_cfg, run=dataclasses.replace(
            t_cfg.run, checkpoint_dir=str(tmp_path / "t"))),
            init_params=_fedtpu_init(j_cfg))
    assert attempts == [2]
    assert rt.rollbacks == 2 and not rj.diverged and not rt.diverged
    assert rt.rounds_run == rj.rounds_run == ROUNDS
    for x, y in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(rj.final_params)):
        np.testing.assert_allclose(x, y, atol=1e-5)
    own = [_t_run(dataclasses.replace(t_cfg, run=dataclasses.replace(
        t_cfg.run, checkpoint_dir=str(tmp_path / f"own{i}"))),
        init_params=_fedtpu_init(j_cfg)) for i in range(2)]
    _same_run(*own)


@pytest.mark.parametrize("case", ["budget", "exclude"])
def test_budget_and_exclusion_match_fedtpu(case, tmp_path):
    """The spent budget halts with the state under diverged/; exclusion
    drops the offender at weight 0: the events' rollback and exclusion
    payloads, the stop and the divergence as fedtpu's."""
    if case == "budget":
        faults = [{"kind": "nan_update", "round": 3, "clients": [1]},
                  {"kind": "nan_update", "round": 6, "clients": [2]}]
        run = dict(rollback_retries=1)
    else:
        faults = [{"kind": "nan_update", "round": 5, "clients": [2]}]
        run = dict(rollback_exclude=True)
    j_cfg, t_cfg = _nan_cfgs(tmp_path, faults, **run)
    j_ev, t_ev, rt = _event_pair(j_cfg, t_cfg, tmp_path,
                                 init_params=_fedtpu_init(j_cfg))
    for kind in ("fault", "rollback", "exclusion", "diverged"):
        assert [e["payload"] for e in t_ev if e["kind"] == kind] == \
            [e["payload"] for e in j_ev if e["kind"] == kind], kind
    end = [e["payload"] for e in t_ev if e["kind"] == "run_end"]
    assert end == [e["payload"] for e in j_ev if e["kind"] == "run_end"]
    if case == "budget":
        assert rt.diverged and rt.rollbacks == 1
        assert t_ckpt.complete_steps(
            os.path.join(t_cfg.run.checkpoint_dir, "diverged")) == [6]
    else:
        assert not rt.diverged and rt.rounds_run == ROUNDS
        assert [e["payload"]["clients"] for e in t_ev
                if e["kind"] == "exclusion"] == [[2]]
        assert not rt.confusion[-1][2].any()


def test_sigterm_drain_and_resume(tmp_path):
    """An in-process SIGTERM (a process_kill fault) drains a checkpoint
    at the loop top and raises Preempted; the resume is bitwise the
    uninterrupted run; the preempted event and counter are in the sink."""
    _, plain_cfg = _cfgs(rounds_per_step=2)
    plain = _t_run(plain_cfg)
    ck, sink = str(tmp_path / "ck"), str(tmp_path / "ev.jsonl")
    _, cfg = _cfgs(rounds_per_step=2, checkpoint_dir=ck, checkpoint_every=4,
                   fault_plan=_plan({"kind": "process_kill", "round": 3,
                                     "signal": "SIGTERM"}),
                   telemetry=tcfg.TelemetryConfig(events_path=sink))
    with pytest.raises(t_sup.Preempted) as err:
        _t_run(cfg)
    assert err.value.round == 3 and t_ckpt.complete_steps(ck) == [3]
    events = _sink(sink)
    assert [e["round"] for e in events if e["kind"] == "preempted"] == [3]
    counters = [e for e in events if e["kind"] == "counters"][-1]
    assert counters["payload"]["counters"]["preemptions"] == 1
    resumed = _t_run(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, fault_plan=None)), resume=True)
    assert resumed.global_metrics == plain.global_metrics
    for x, y in zip(resumed.loss, plain.loss[3:]):
        assert np.array_equal(x, y)


def test_heartbeat_sequence_equals_fedtpus(tmp_path, monkeypatch):
    """Every heartbeat write of a run (status, round) as fedtpu's, the
    file atomic JSON, its last status 'done'."""
    seen = {"j": [], "t": []}
    for key, mod in (("j", j_loop), ("t", t_loop)):
        real = mod.write_heartbeat

        def record(path, _real=real, _key=key, **payload):
            seen[_key].append((payload["status"], payload["round"],
                               payload["restarts"]))
            _real(path, **payload)
        monkeypatch.setattr(mod, "write_heartbeat", record)
    hb = {k: str(tmp_path / f"{k}.hb") for k in seen}
    j_cfg, _ = _cfgs(rounds_per_step=4, heartbeat_file=hb["j"])
    _, t_cfg = _cfgs(rounds_per_step=4, heartbeat_file=hb["t"])
    j_loop.run_experiment(j_cfg, verbose=False)
    _t_run(t_cfg)
    assert seen["t"] == seen["j"] == [("starting", 0, 0), ("running", 4, 0),
                                      ("running", 8, 0), ("done", 8, 0)]
    last = t_sup.read_heartbeat(hb["t"])
    assert last["status"] == "done" and last["pid"] == os.getpid()
    assert t_sup.read_heartbeat(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("mode", ["stomp", "torn"])
def test_corrupt_checkpoint_falls_back(mode, tmp_path):
    """ckpt_corrupt's file edit on the port's layout (the round's one
    state archive): the round still looks committed, the fallback walk
    restores the previous one, and the fault plan's kind does it in a
    run."""
    ck = str(tmp_path / "ck")
    _, cfg = _cfgs(rounds_per_step=2, checkpoint_dir=ck, checkpoint_every=2)
    _t_run(cfg)
    assert t_ckpt.complete_steps(ck) == [2, 4, 6, 8]
    size = os.path.getsize(t_ckpt.state_file(ck, 8))
    assert t_faults.corrupt_checkpoint(ck, mode=mode, seed=3) == 8
    assert os.path.getsize(t_ckpt.state_file(ck, 8)) < size
    assert t_ckpt.complete_steps(ck) == [2, 4, 6, 8]
    with pytest.warns(RuntimeWarning, match="failed to restore"):
        _, _, step = t_ckpt.load_checkpoint_fallback(ck)
    assert step == 6
    with pytest.warns(RuntimeWarning, match="failed to restore"):
        v = t_oracles.checkpoint_restorable(ck)
    assert v.ok and v.observed == {"step": 6}
    assert t_faults.corrupt_checkpoint(str(tmp_path / "none")) is None


# ------------------------------------------------------------- supervisor

_SCRIPT = """import os, signal, sys
codes = [int(c) for c in sys.argv[1].split(",")]
c = codes[min(int(os.environ["FEDTPU_RESTARTS"]), len(codes) - 1)]
assert os.environ["FEDTPU_SUPERVISED"] == "1"
if c < 0:
    os.kill(os.getpid(), -c)
sys.exit(c)
"""


def _decisions(path: str) -> list:
    from fedtpu_torch.telemetry.report import load_events
    events, bad = load_events(path)
    assert bad == 0
    drop = ("pid", "dur_s")
    return [(e["kind"], {k: v for k, v in e["payload"].items()
                         if k not in drop}) for e in events
            if e["kind"] != "crash_flush"]


@pytest.mark.parametrize("codes", ["0", "3", "75,0", "1,1,0", "1,1,1",
                                   "-9,0"])
def test_supervise_decides_as_fedtpu(codes, tmp_path):
    """The same scripted children's exit codes (done, diverged, preempted,
    crashes, the spent budget, a SIGKILL) give fedtpu's restart decisions:
    the final code and every supervisor event."""
    script = tmp_path / "child.py"
    script.write_text(_SCRIPT)
    out = {}
    for key, sup in (("j", j_sup), ("t", t_sup)):
        ev = str(tmp_path / f"{key}.jsonl")
        out[key] = (sup.supervise(
            ["run", "--quiet"], max_restarts=2, backoff_base=0.01,
            backoff_max=0.02, events=ev, verbose=False,
            _cmd_prefix=[sys.executable, str(script), codes]),
            _decisions(ev))
    assert out["t"] == out["j"]
    assert out["t"][0] == {"0": 0, "3": 3, "75,0": 0, "1,1,0": 0,
                           "1,1,1": 1, "-9,0": 0}[codes]
    for rc in (0, 1, 3, 75, -9):
        for hung in (False, True):
            for streak in range(4):
                assert t_sup.restart_backoff(rc, hung, streak, 0.5, 3.0) == \
                    j_sup.restart_backoff(rc, hung, streak, 0.5, 3.0)
    assert (t_sup.EXIT_OK, t_sup.EXIT_DIVERGED, t_sup.EXIT_PREEMPTED,
            t_sup.EXIT_RESHARDED) == (j_sup.EXIT_OK, j_sup.EXIT_DIVERGED,
                                      j_sup.EXIT_PREEMPTED,
                                      j_sup.EXIT_RESHARDED)


def test_supervisor_imports_neither_torch_nor_numpy(monkeypatch):
    """The supervising parent (``supervise``, ``chaos``, the CLI's parser)
    imports neither torch nor numpy, so a restart holds no second CUDA
    context; a command other than ``run`` launched into a gang (a
    ``sweep`` member) names A10d-3."""
    import subprocess
    code = ("import sys; import fedtpu_torch.cli as c; "
            "import fedtpu_torch.resilience.supervisor, "
            "fedtpu_torch.resilience.chaos; c.build_parser(); "
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"
    from fedtpu_torch.cli import main as t_main
    monkeypatch.setenv("FEDTPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(NotImplementedError, match=r"\(ROADMAP A10d-3\)"):
        t_main(["sweep", "--platform", "cpu"])


# ------------------------------------------------------- chaos and oracles

def test_chaos_registry_and_help_equal_fedtpus():
    """The registry, its help and the single-process, training-gang and
    reshard plans are fedtpu's (at fedtpu's client counts); every row
    runs (the gateway, poisoning and wire rows: tests/test_torch_fuzz.py;
    the gang rows: tests/test_torch_gang.py; the reshard and autoscale
    rows: tests/test_torch_reshard.py); an unknown row is refused."""
    assert t_chaos.SCENARIO_REGISTRY == j_chaos.SCENARIO_REGISTRY
    assert t_chaos.scenarios_help() == j_chaos.scenarios_help()
    assert t_chaos.SCENARIOS == j_chaos.SCENARIOS
    for name in ("sigkill", "preempt", "nan_rollback", "dropout",
                 "straggler") + t_chaos.GANG_SCENARIOS:
        assert json.loads(t_chaos._plan(10, name)) == \
            json.loads(j_chaos._plan(10, name))
    for name in t_chaos.RESHARD_SCENARIOS:
        for clients in (4, 8):
            assert json.loads(t_chaos._plan(10, name, clients)) == \
                json.loads(j_chaos._plan(10, name, clients))
    assert {"mp_gateway_kill", "mp_poison_campaign", "mp_torn_frame",
            "mp_kill_worker", "mp_hang", "mp_shrink",
            "mp_autoscale_preempt"} <= set(t_chaos.PORTED_SCENARIOS)
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        t_chaos.run_chaos(["nope"])


def _oracle_fixtures(ck: str):
    base = {1: {"loss_mean": 0.5}, 2: {"loss_mean": 0.4},
            3: {"loss_mean": 0.3}}
    moved = {**base, 2: {"loss_mean": 0.45}}
    return [
        ("history_bitwise", (base, base), {}),
        ("history_bitwise", (moved, base), {}),
        ("history_bitwise", (moved, base), dict(mode="prefix_divergent",
                                                fault_round=2)),
        ("history_bitwise", (base, base), dict(mode="prefix_divergent",
                                               fault_round=2)),
        ("exit_contract", ([[75, 0], [1, 76]],), {}),
        ("exit_contract", ([[3], [], [0, 2, 1]],), {}),
        ("monotone_rounds", ([1, 2, 2, 4],), {}),
        ("monotone_rounds", ([1, 3, 2],), dict(member=1)),
        ("exactly_once", (10, 10), {}),
        ("exactly_once", (10, None), {}),
        ("no_lost_acked", (0,), {}),
        ("no_lost_acked", (-2,), {}),
        ("slo_burn_bounded", (1.5, 2.0), {}),
        ("slo_burn_bounded", (None, 2.0), {}),
        ("backlog_drained", (3,), {}),
        ("quarantine_containment", ([1, 2], [1, 2, 3]), {}),
        ("quarantine_containment", ([1, 2], [1, 2, 3]),
         dict(mode="subset")),
        ("defense_effective", (0.9, 0.7, 0.91, 0.02, 0.05), {}),
        ("defense_effective", (0.9, None, 0.91, 0.02, 0.05), {}),
        ("checkpoint_restorable", (ck,), dict(label="x")),
    ]


def test_oracles_equal_fedtpus_verdicts(tmp_path):
    """Each oracle on the same fixtures gives fedtpu's verdict (the
    checkpoint one on a directory with no round: both fail alike), and
    the composite judges and the summary agree."""
    for name, args, kw in _oracle_fixtures(str(tmp_path / "none")):
        t = getattr(t_oracles, name)(*args, **kw)
        j = getattr(j_oracles, name)(*args, **kw)
        assert t.as_dict() == j.as_dict(), name
    kw = dict(survived=True, retried=1, gang_restarts=0, duplicate_drops=1,
              lost_acked=0, client_admitted=5, fleet_admitted=5, backlog=0,
              slo_burn=1.0, burn_budget=2.5)
    t = t_oracles.judge_gateway_kill(**kw)
    j = j_oracles.judge_gateway_kill(**kw)
    assert [v.as_dict() for v in t] == [v.as_dict() for v in j]
    assert t_oracles.summarize(t) == j_oracles.summarize(j)
    kw = dict(kw, netlog_match=True)
    kw.pop("gang_restarts")
    t = t_oracles.judge_net_row(gang_restarts=1, **kw)
    j = j_oracles.judge_net_row(gang_restarts=1, **kw)
    assert [v.as_dict() for v in t] == [v.as_dict() for v in j]
    assert (t_oracles.CONTRACT_EXITS, t_oracles.TRANSIENT_EXITS,
            t_oracles.FINAL_EXITS) == (j_oracles.CONTRACT_EXITS,
                                       j_oracles.TRANSIENT_EXITS,
                                       j_oracles.FINAL_EXITS)


def test_supervised_sigkill_row_is_bitwise_and_reports_as_fedtpu(
        tmp_path, monkeypatch):
    """One chaos row through the CLI's children: the SIGKILLed run is
    restarted with --resume by ``supervise`` and its history is bitwise
    the baseline's; fedtpu's report renders the row's merged sink (the
    supervisor's and both children's events) as the port's does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    wd = str(tmp_path / "chaos")
    report = t_chaos.run_chaos(["sigkill"], rounds=6, num_clients=2,
                               platform="cpu",
                               hidden_sizes=(8,), synthetic_rows=256,
                               workdir=wd, keep_artifacts=True,
                               verbose=False, timeout=300)
    row, = report["scenarios"]
    assert report["ok"], row
    assert row["history_match"] and row["restarts"] == 1
    assert row["faults"] == 1 and row["rc"] == 0
    from fedtpu.telemetry.report import aggregate as j_aggregate
    from fedtpu.telemetry.report import load_events as j_load
    from fedtpu_torch.telemetry.report import aggregate, load_events
    path = os.path.join(wd, "sigkill.events.jsonl")
    t_res = aggregate(*load_events(path))["resilience"]
    j_res = j_aggregate(*j_load(path))["resilience"]
    assert t_res == j_res
    assert t_res["restarts"] == 1 and t_res["child_exit_codes"] == [-9, 0]


# ------------------------------------------------------------ C7, the CLIs

def test_c7_both_clis_exit_3_on_a_diverging_run(tmp_path, capsys):
    """C7: a divergence halt exits EXIT_DIVERGED (3) with the summary
    printed once, and a SIGTERM drain EXIT_PREEMPTED (75) with
    {"preempted": true, "round": r}, in fedtpu's CLI and the port's."""
    from fedtpu.cli import main as j_main
    from fedtpu_torch.cli import main as t_main
    common = ["--platform", "cpu", "--csv", "", "--num-clients", "2",
              "--hidden-sizes", "8", "--quiet", "--json"]
    for main, extra in ((j_main, []), (t_main, ["--synthetic-rows", "256"])):
        assert main(["run", "--learning-rate", "1e38", "--rounds", "3",
                     *common, *extra]) == 3
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["diverged"]
    plan = _plan({"kind": "process_kill", "round": 2, "signal": "SIGTERM"})
    for key, main, extra in (("j", j_main, []),
                             ("t", t_main, ["--synthetic-rows", "256"])):
        assert main(["run", "--rounds", "4", "--fault-plan", plan,
                     "--checkpoint-dir", str(tmp_path / key),
                     "--checkpoint-every", "2", *common, *extra]) == 75
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == {"preempted": True, "round": 2}


def test_cli_resilience_flags_reach_the_config():
    """run's resilience flags set the RunConfig fields fedtpu's set;
    --max-restarts is stripped from the supervised child's argv."""
    from fedtpu.cli import _strip_flag as j_strip
    from fedtpu_torch.cli import _strip_flag, build_parser, config_from_args
    argv = ["run", "--fault-plan", "p.json", "--on-divergence", "rollback",
            "--rollback-retries", "3", "--rollback-exclude",
            "--rollback-perturb", "1e-3", "--heartbeat", "hb",
            "--checkpoint-dir", "ck", "--checkpoint-every", "2"]
    run = config_from_args(build_parser().parse_args(argv)).run
    assert (run.fault_plan, run.on_divergence, run.rollback_retries,
            run.rollback_exclude, run.rollback_perturb,
            run.heartbeat_file) == ("p.json", "rollback", 3, True, 1e-3, "hb")
    full = argv + ["--max-restarts", "2", "--max-restarts=4"]
    assert _strip_flag(full, "--max-restarts") == \
        j_strip(full, "--max-restarts") == argv


def test_serve_writes_its_heartbeat(tmp_path):
    """run_server(heartbeat=...): 'serving' at the loop's wakeups, the
    shutdown's reason ('once') with the tick count last, as fedtpu's."""
    from fedtpu_torch.serving import server as t_server
    from fedtpu_torch.serving import traces as t_traces
    from fedtpu_torch.serving.loadgen import run_loadgen
    from test_torch_round import _serve_kw
    hb, pf = str(tmp_path / "hb"), str(tmp_path / "pf")
    trace = str(tmp_path / "t.jsonl")
    t_traces.write_trace(trace, *t_traces.synthesize_trace(
        users=50, arrivals=60, seed=0))
    box = {}
    th = threading.Thread(target=lambda: box.update(res=t_server.run_server(
        tcfg.ServingConfig(**_serve_kw()), heartbeat=hb, port_file=pf,
        once=True, verbose=False, device="cpu")))
    th.start()
    try:
        run_loadgen(trace, port_file=pf, timeout=60)
    finally:
        th.join(timeout=120)
    assert "res" in box
    last = t_sup.read_heartbeat(hb)
    assert last["status"] == "once" and last["tick"] == box["res"]["ticks"]
