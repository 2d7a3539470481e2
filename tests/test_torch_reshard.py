"""The port's live elastic reshard (``fedtpu_torch.resilience.reshard``,
``fedtpu_torch.parallel.reshard``, the loop's shrink and grow) on the CPU:
the protocol held to fedtpu's in the same process on the same record
files, the partition view bitwise fedtpu's, a one-process shrink and grow
back held to fedtpu's single-process reshard, a gloo gang of two that
shrinks (and grows back) held to its gang baseline and to the port's
one-process run of the same plan, and a checkpoint restored across gang
sizes. The four reshard and autoscale chaos rows run as ``slow`` tests.

Inputs are the small income run of ``tests/torch_gang_worker.py`` (hidden
16, 512 synthetic rows) at 8 clients, over 6 rounds."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores.
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import conftest  # noqa: E402
import fedtpu.config as jcfg  # noqa: E402
from fedtpu.data import sharding as j_sharding  # noqa: E402
from fedtpu.orchestration import loop as j_loop  # noqa: E402
from fedtpu.parallel import reshard as j_plan  # noqa: E402
from fedtpu.resilience import faults as j_faults  # noqa: E402
from fedtpu.resilience import reshard as j_reshard  # noqa: E402

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch.data import sharding as t_sharding  # noqa: E402
from fedtpu_torch.orchestration.loop import run_experiment  # noqa: E402
from fedtpu_torch.parallel import reshard as t_plan  # noqa: E402
from fedtpu_torch.resilience import chaos as t_chaos  # noqa: E402
from fedtpu_torch.resilience import faults as t_faults  # noqa: E402
from fedtpu_torch.resilience import reshard as t_reshard  # noqa: E402

import torch_gang_worker as worker  # noqa: E402
from test_torch_gang import (_fedtpu_inputs,  # noqa: E402
                             assert_one_process_is_fedtpus)

# The conftest's guard wants a quick-tier pick in every test module; this
# module names its own (the row maps: milliseconds, no process).
conftest.QUICK_TESTS.add(
    "test_torch_reshard.py::test_protocol_equals_fedtpus[row_maps]")

CLIENTS, SHARDS, ROUNDS = 8, 4, 6
NOTICE = {"kind": "preempt_notice", "round": 3, "target_clients": 4,
          "process_index": 1}
CANCEL = {"kind": "preempt_cancel", "round": 5}


def _plan(*faults) -> str:
    return json.dumps({"seed": 0, "faults": list(faults)})


# ------------------------------------------------------------- protocol

def _ctls(tmp_path, idx=0, count=2, launch="L0", **kw):
    """fedtpu's controller and the port's, of one process, on one
    directory."""
    return tuple(m.ReshardController(process_index=idx, process_count=count,
                                     launch_id=launch, restart_count=0,
                                     checkpoint_dir=str(tmp_path), **kw)
                 for m in (j_reshard, t_reshard))


def _row_maps(tmp_path):
    for args in ((2, 4), (0, 3)):
        assert t_plan.shrink_row_map(*args) == j_plan.shrink_row_map(*args)
    for args in ((4, 8), (4, 8, 2), (2, 8, 6)):
        assert t_plan.grow_row_map(*args) == j_plan.grow_row_map(*args)
    step = t_plan.ReshardStep("params", "client", 4, 0, 64)
    assert step.to_json() == dataclasses.asdict(
        j_plan.ReshardStep("params", "client", 4, 0, 64))
    # The wire-free plan: a shrink's carried rows bitwise, renumbered; a
    # grow's join rows from the callback; a row held by a peer raises.
    state = {"params": torch.arange(24.).reshape(8, 3),
             "opt_state": {"mu": torch.ones(8, 3)}, "srv": torch.zeros(3),
             "round": 5}
    moved, steps = t_plan.reshard_state(
        state, src_rows=slice(0, 8), dst_rows=slice(0, 4),
        row_map=t_plan.shrink_row_map(2, 4))
    assert torch.equal(moved["params"], state["params"][2:6])
    assert moved["round"] == 5 and torch.equal(moved["srv"], state["srv"])
    assert [(s.path, s.kind, s.join_rows) for s in steps] == [
        ("opt_state.mu", "client", 0), ("params", "client", 0),
        ("srv", "replicated", 0)]
    grown, steps = t_plan.reshard_state(
        moved, src_rows=slice(0, 4), dst_rows=slice(0, 8),
        row_map=t_plan.grow_row_map(4, 8, 2),
        join_rows=lambda p, n, shape, dt: torch.full((n,) + shape, -1.0))
    assert torch.equal(grown["params"][2:6], state["params"][2:6])
    assert bool((grown["params"][[0, 1, 6, 7]] == -1).all())
    assert steps[1].join_rows == 4
    with pytest.raises(ValueError, match="not held by this process"):
        t_plan.reshard_state(state, src_rows=slice(4, 8),
                             dst_rows=slice(0, 4),
                             row_map=t_plan.shrink_row_map(0, 4))


def _acks(tmp_path):
    for writer, reader in ((0, 1), (1, 0)):
        ctls = _ctls(tmp_path / f"w{writer}", ack_timeout=0.4)
        ctls[writer].publish_ack(0, "a", 3)
        ctls[reader].await_acks(0, "a", (0,))    # the other package's ack
        for ctl, failed in zip(ctls, (j_reshard.ReshardFailed,
                                      t_reshard.ReshardFailed)):
            with pytest.raises(failed):
                ctl.await_acks(0, "a", (0, 1))   # the peer never acks
            with pytest.raises(failed):          # phases do not alias
                ctl.await_acks(0, "b", (0,))


def _spool(tmp_path):
    join = {"params": np.arange(6, dtype=np.float32).reshape(2, 3)}
    repl = {"round": np.float32(5.0)}
    for i, ctl in enumerate(_ctls(tmp_path)):
        ctl.write_spool(i, join, repl, {"history": {"accuracy": [0.5]}})
    # Each package reads the other's spool: the same npz and json.
    for i, ctl in enumerate(_ctls(tmp_path)):
        j, r, control = ctl.read_spool(1 - i)
        np.testing.assert_array_equal(j["params"], join["params"])
        assert float(r["round"]) == 5.0
        assert control["history"] == {"accuracy": [0.5]}
    for ctl, failed in zip(_ctls(tmp_path, launch="L1"),
                           (j_reshard.ReshardFailed,
                            t_reshard.ReshardFailed)):
        with pytest.raises(failed, match="another generation"):
            ctl.read_spool(0)


def _plan_once(tmp_path):
    spec = json.loads(_plan(NOTICE))
    ctls = [m.ReshardController(
        plan=f.FaultPlan.load(spec, num_clients=CLIENTS, rounds=8),
        process_index=0, process_count=2, launch_id="L0", restart_count=r,
        checkpoint_dir=str(tmp_path))
        for r in (0, 1) for m, f in ((j_reshard, j_faults),
                                     (t_reshard, t_faults))]
    for ctl in ctls[:2]:
        assert ctl.poll(0) is None and ctl.poll(1) is None
        req = ctl.poll(2)
        assert (req.mode, req.victim, req.target_clients, req.round) == (
            "shrink", 1, 4, 2)
        assert ctl.poll(2) is None and not ctl.pending
    # A gang restart does not replay the notice that just failed.
    for ctl in ctls[2:]:
        assert all(ctl.poll(r) is None for r in range(8))


def _signal(tmp_path):
    """A fedtpu member and a port member see the notice at different
    loop-tops; both fire at max(published) + 1 with the same victim."""
    a = j_reshard.ReshardController(process_index=0, process_count=2,
                                    launch_id="L0",
                                    checkpoint_dir=str(tmp_path))
    b = t_reshard.ReshardController(process_index=1, process_count=2,
                                    launch_id="L0",
                                    checkpoint_dir=str(tmp_path))
    a.request_signal("shrink")
    assert a.poll(5) is None
    b.request_signal("shrink")
    assert b.poll(6) is None
    assert a.poll(6) is None
    ra, rb = a.poll(7), b.poll(7)
    assert (ra.mode, ra.victim, ra.round) == (rb.mode, rb.victim, rb.round) \
        == ("shrink", 1, 7)


def _commit_finish(tmp_path):
    done = os.path.join(str(tmp_path), ".reshard", "run_done")
    for ctl in _ctls(tmp_path):
        ctl.committed("shrink", 1)
        assert (ctl.active, ctl.parked_victim, ctl.seq) == ((0,), 1, 1)
        ctl.finish()
        with open(done) as fh:
            assert json.load(fh)["launch"] == "L0"
        os.remove(done)
        ctl.committed("grow", 1)
        assert ctl.active == (0, 1) and ctl.parked_victim is None
        ctl.finish()                  # nobody parked: no marker
        assert not os.path.exists(done)
    for ctl in _ctls(tmp_path, idx=1, count=3):
        ctl.committed("shrink", 2)    # active (0, 1): the leader is 0
        ctl.finish()
        assert not os.path.exists(done)


_CASES = {"row_maps": _row_maps, "acks": _acks, "spool": _spool,
          "plan_once": _plan_once, "signal": _signal,
          "commit_finish": _commit_finish}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_protocol_equals_fedtpus(case, tmp_path):
    """The row maps and ``ReshardStep``; the ack round trip and its
    timeout; the spool and its generation fence; the plan firing once and
    not after a restart; the signal agreement; ``committed`` and
    ``finish``, the leader only: fedtpu's functions and the port's on the
    same record files."""
    _CASES[case](tmp_path)


@pytest.mark.parametrize("strategy", ["contiguous", "label_sort",
                                      "dirichlet"])
def test_partition_view_equals_fedtpus(strategy):
    """``shard_indices`` and ``pack_clients`` under the partition window
    bitwise fedtpu's, each kept row bitwise its row of the full pack; a
    window outside the partition raises fedtpu's message."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(203, 5)).astype(np.float32)
    y = rng.integers(0, 3, 203).astype(np.int32)
    kw = dict(num_clients=4, strategy=strategy, partition_clients=8,
              partition_offset=2)
    j, t = jcfg.ShardConfig(**kw), tcfg.ShardConfig(**kw)
    for a, b in zip(j_sharding.shard_indices(y, j),
                    t_sharding.shard_indices(y, t)):
        np.testing.assert_array_equal(a, b)
    jp, tp = j_sharding.pack_clients(x, y, j), t_sharding.pack_clients(x, y, t)
    full = t_sharding.pack_clients(x, y, tcfg.ShardConfig(
        num_clients=8, strategy=strategy))
    for k in ("x", "y", "mask", "counts"):
        np.testing.assert_array_equal(getattr(jp, k), getattr(tp, k))
        np.testing.assert_array_equal(getattr(full, k)[2:6], getattr(tp, k))
    bad = dict(kw, partition_offset=6)
    with pytest.raises(ValueError) as j_err:
        j_sharding.pack_clients(x, y, jcfg.ShardConfig(**bad))
    with pytest.raises(ValueError) as t_err:
        t_sharding.pack_clients(x, y, tcfg.ShardConfig(**bad))
    assert str(t_err.value) == str(j_err.value)


# ------------------------------------------------------ one process

# DP-FedAvg under fedadam: uniform weights, sampling 0.5, an adaptive clip
# with count noise, the server optimizer's state beside it.
DP_FEDADAM = {"weighting": "uniform", "participation_rate": 0.5,
              "dp_clip_norm": 1.0, "dp_noise_multiplier": 1.0,
              "dp_adaptive_clip": True, "dp_count_noise_multiplier": 2.0,
              "server_opt": "fedadam", "server_lr": 0.01}


def _one_configs(plan=None, events=None, **fed):
    """fedtpu's test_reshard config (8 clients, 512 synthetic rows, 6
    rounds, no held-out eval) and the port's over 8 shards (fedtpu's 8
    virtual devices); ``fed``: more FedConfig knobs."""
    return tuple(m.ExperimentConfig(
        data=m.DataConfig(csv_path=None, synthetic_rows=512),
        shard=m.ShardConfig(num_clients=CLIENTS),
        fed=m.FedConfig(rounds=ROUNDS, termination_patience=10,
                        tolerance=1e-12, **fed),
        run=m.RunConfig(eval_test_every=0, fault_plan=plan,
                        telemetry=m.TelemetryConfig(events_path=events),
                        **extra))
        for m, extra in ((jcfg, {}), (tcfg, {"mesh_devices": 8})))


def _reshard_events(path) -> list:
    with open(path) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    return [(e["payload"]["mode"], e["payload"].get("target"),
             sorted({s["join_rows"] for s in e["payload"]["steps"]
                     if s["kind"] == "client"}))
            for e in events if e["kind"] == "reshard_done"]


@pytest.mark.parametrize("fed", [{}, DP_FEDADAM],
                         ids=["plain", "dp-fedadam"])
def test_one_process_shrink_grow_equals_fedtpus(fed, tmp_path):
    """fedtpu's single-process reshard (tests/test_reshard.py): 8 clients
    shrink to 4 at round 3 and grow back at round 5, with fedtpu's init
    injected (under DP + fedadam its masks and noise too, the shrunk
    mesh's masks by the clients' index in it): the same rounds and
    confusion counts, the metrics within the port's float32 tolerance, the
    same reshard_done modes, targets and join rows; the rounds before the
    notice bitwise the port's run without one. Under DP + fedadam also
    the final params within 1e-5, the clip within 1e-5 relative and the
    same privacy spend."""
    plan = _plan({k: v for k, v in NOTICE.items() if k != "process_index"},
                 CANCEL)
    j_cfg, t_cfg = _one_configs(plan, str(tmp_path / "j.jsonl"), **fed)
    inputs = _fedtpu_inputs(j_cfg)
    rj = j_loop.run_experiment(j_cfg, verbose=False)
    _, t_cfg = _one_configs(plan, str(tmp_path / "t.jsonl"), **fed)
    rt = run_experiment(t_cfg, verbose=False, device="cpu", **inputs)
    base = run_experiment(_one_configs(**fed)[1], verbose=False,
                          device="cpu", **inputs)
    assert rt.rounds_run == rj.rounds_run == ROUNDS
    # The per-client metrics come from the rounds' confusion counts (a
    # count apart moves one by more than 1e-3 at these shard sizes).
    for k, v in rj.per_client_metrics.items():
        for a, b in zip(rt.per_client_metrics[k], v):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(rt.loss, rj.loss):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    for k, v in rj.global_metrics.items():
        np.testing.assert_allclose(rt.global_metrics[k], v, rtol=0,
                                   atol=1e-6)
    got = _reshard_events(tmp_path / "t.jsonl")
    assert got == _reshard_events(tmp_path / "j.jsonl")
    assert got == [("shrink", 4, [0]), ("grow", 8, [4])]
    acc, bacc = rt.global_metrics["accuracy"], base.global_metrics["accuracy"]
    assert acc[:2] == bacc[:2] and acc[2] != bacc[2]
    if fed:
        np.testing.assert_allclose(
            _flat(rt.final_params),
            _flat(jax.tree.map(np.asarray, rj.final_params)), rtol=0,
            atol=1e-5)
        np.testing.assert_allclose(rt.final_dp_clip, rj.final_dp_clip,
                                   rtol=1e-5)
        assert rt.privacy_spent() == rj.privacy_spent()


# ------------------------------------------------------------- gangs

def _gang(tmp_path, spec: dict, tag: str, codes=(0, 0)) -> list:
    """A gloo gang of two ``tests/torch_gang_worker.py`` members on
    ``spec``; their exit codes must be ``codes``; each member's record
    (None for a member that left with 76, parked)."""
    store, out = tmp_path / f"{tag}.store", tmp_path / tag
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(store), "2", str(r),
         json.dumps(spec), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert tuple(p.returncode for p in procs) == tuple(codes), logs
    records = []
    for r in range(2):
        path = f"{out}.{r}"
        records.append(None if not os.path.exists(path)
                       else pickle.load(open(path, "rb")))
    return records


def _elastic_spec(tmp_path, tag, **kw) -> dict:
    return {"clients": CLIENTS, "shards": SHARDS, "rounds": ROUNDS,
            "rounds_per_step": 1, "dir": str(tmp_path / f"{tag}.ck"),
            "every": 2, "collective_timeout": 60, **kw}


def _one(spec: dict) -> dict:
    return worker.result_record(run_experiment(
        worker.gang_config(spec), verbose=False, device="cpu",
        resume=bool(spec.get("resume"))))


def _flat(params) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(v)) for v in
                           jax.tree.leaves(params)])




@pytest.mark.parametrize("aggregation,faults,fed", [
    ("psum", (NOTICE,), {}), ("ring", (NOTICE, CANCEL), {}),
    ("psum", (NOTICE, CANCEL), DP_FEDADAM)],
    ids=["psum-shrink", "ring-shrink-grow", "dp-fedadam-shrink-grow"])
def test_gang_reshard_matches_the_one_process_reshard(aggregation, faults,
                                                      fed, tmp_path):
    """A gang of two (two shards a member) on a plan: member 1 parks at
    round 3 and exits 76 when the run ends without a cancel, or rejoins at
    round 5; the rounds before the notice bitwise the gang's baseline, the
    rounds after it within 1e-5 of the port's one-process run of the same
    plan over the same four shards (whose first two the survivor keeps).
    The ring gang is bitwise one process on the CPU (tests/test_torch_gang.
    py), so its baseline is the one-process run, held bit for bit over the
    whole run, the grow included. Under DP + fedadam the survivor keeps
    the server state, the clip and the ledger through its one-process
    rounds (the fixed denominator over its own C), the rejoiner takes them
    from the spool: the privacy spend is one process's (the rejoiner's
    flagged as composed over a restored segment), the final clip within
    1e-6 relative of it, both members' the same."""
    ev = str(tmp_path / "ev.jsonl")
    plan = _plan(*faults)
    grow = len(faults) > 1
    gang = _gang(tmp_path, _elastic_spec(
        tmp_path, "g", aggregation=aggregation, plan=plan, events=ev,
        fed=fed), "g", codes=(0, 0) if grow else (0, 76))
    one = _one(_elastic_spec(tmp_path, "o", aggregation=aggregation,
                             plan=plan, fed=fed))
    if fed:
        assert_one_process_is_fedtpus(_elastic_spec(tmp_path, "f", fed=fed),
                                      tmp_path)
    got = gang[0]
    assert got["rounds_run"] == one["rounds_run"] == ROUNDS
    if aggregation == "ring":
        assert got["history"] == one["history"]
        assert np.array_equal(_flat(got["params"]), _flat(one["params"]))
    else:
        base = _gang(tmp_path, _elastic_spec(tmp_path, "b", fed=fed),
                     "b")[0]
        for k, v in base["history"].items():
            assert got["history"][k][:2] == v[:2]
    for k, v in one["history"].items():
        np.testing.assert_allclose(got["history"][k], v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_flat(got["params"]), _flat(one["params"]),
                               rtol=0, atol=1e-5)
    assert got["privacy"] == one["privacy"]
    if one["dp_clip"] is not None:
        assert abs(got["dp_clip"] - one["dp_clip"]) <= 1e-6 * one["dp_clip"]
    if grow:
        for key in ("history", "dp_clip"):
            assert gang[1][key] == got[key]
        assert np.array_equal(_flat(gang[1]["params"]), _flat(got["params"]))
        # The rejoiner's ledger comes from the spool, a restored segment
        # (as fedtpu's rejoiner's): the same spend, flagged as composed.
        spent = dict(gang[1]["privacy"])
        assert spent.pop("composed_over_resumed_segments",
                         False) == bool(fed)
        assert spent == got["privacy"]
    with open(ev) as fh:
        modes = [e["payload"]["mode"] for e in map(json.loads, fh)
                 if e["kind"] == "reshard_done"]
    assert modes == (["shrink", "grow"] if grow else ["shrink"])


@pytest.mark.parametrize("case", ["one_to_gang", "gang_to_one_elastic",
                                  "one_to_gang_elastic"])
def test_elastic_resume_across_gang_sizes(case, tmp_path):
    """A round saved by one process restores into a gang of two, and the
    other way round: at the same client count each member its rows,
    bitwise (the ring: the gang is bitwise one process on the CPU); at
    another client count fedtpu's elastic rule (the global mean in every
    slot, fresh moments), bitwise the one-process elastic resume of the
    one-process checkpoint of the same run."""
    ring = {"aggregation": "ring"}
    if case == "one_to_gang":
        first = _elastic_spec(tmp_path, "x", rounds=4, **ring)
        _one(first)
        resumed = _gang(tmp_path, dict(first, rounds=ROUNDS, resume=True),
                        "r")[0]
        want = _one(_elastic_spec(tmp_path, "w", **ring))
        assert resumed["history"] == want["history"]
        assert np.array_equal(_flat(resumed["params"]), _flat(want["params"]))
        return
    # At another client count: the saving run has 4 clients over 2
    # shards, the resuming one 8 over 4 (or the other way round).
    small = dict(clients=4, shards=2)
    saver, resumer = ((small, {}) if case == "one_to_gang_elastic"
                      else ({}, small))
    gang_saves = case == "gang_to_one_elastic"
    first = _elastic_spec(tmp_path, "x", rounds=4, **ring, **saver)
    twin = _elastic_spec(tmp_path, "y", rounds=4, **ring, **saver)
    if gang_saves:
        _gang(tmp_path, first, "s")
    else:
        _one(first)
    _one(twin)
    again = dict(first, rounds=ROUNDS, resume=True, **resumer)
    got = (_one(again) if gang_saves else _gang(tmp_path, again, "r")[0])
    want = _one(dict(twin, rounds=ROUNDS, resume=True, **resumer))
    assert got["history"] == want["history"]
    assert np.array_equal(_flat(got["params"]), _flat(want["params"]))
    assert len(got["history"]["accuracy"]) == ROUNDS


# ------------------------------------------------------------- chaos

@pytest.mark.slow
@pytest.mark.parametrize("name", t_chaos.RESHARD_SCENARIOS
                         + (t_chaos.AUTOSCALE_SCENARIO,))
def test_reshard_chaos_row(name, tmp_path):
    """The elastic and autoscale rows of the chaos matrix through the
    port's CLI on the CPU, every oracle passing (fedtpu's bars: zero gang
    restarts and >= 1 / >= 2 reshards for the live rows, a failed reshard
    then a bitwise restart for mp_shrink_dead, the spool, exactly-once
    and SLO bars for the autoscale drill)."""
    report = t_chaos.run_chaos([name], workdir=str(tmp_path),
                               platform="cpu", verbose=False, timeout=400)
    row = report["scenarios"][0]
    assert report["ok"] and row["ok"], row
