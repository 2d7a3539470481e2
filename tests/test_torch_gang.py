"""The port's training gang (``fedtpu_torch.parallel.multihost``) on the
CPU: gloo gangs of two ``run`` processes (``tests/torch_gang_worker.py``,
joined through a ``file://`` store) held to the port's one-process run of
the same config, which ``tests/test_torch_round.py`` holds to fedtpu:
``psum`` within float32 tolerance, ``ring`` and ``ring-rsag`` bitwise, the
asynchronous gang within float32 tolerance; each aggregation branch (the
server optimizers, DP-FedAvg, SCAFFOLD within float32 tolerance; the
int8 exchange and the robust rules with Byzantine clients bitwise), whose
one-process run of the same config is held to fedtpu's here too; and a
gang checkpoint resumed by a gang of the same size bitwise, DP's privacy
spend too. A ring gang refuses every branch with fedtpu's message. The
resume agreement and the collective watchdog are held in process against
fedtpu's. The four training-gang chaos rows run as ``slow`` tests."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores.
torch.set_num_threads(1)

import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import conftest  # noqa: E402
import fedtpu.config as jcfg  # noqa: E402
from fedtpu.ops.server_opt import gaussian_noise_tree  # noqa: E402
from fedtpu.orchestration import loop as j_loop  # noqa: E402
from fedtpu.parallel.round import (_DP_COUNT_STREAM,  # noqa: E402
                                   _DP_NOISE_STREAM)
from fedtpu.resilience import distributed as j_dist  # noqa: E402

from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.orchestration.loop import run_experiment  # noqa: E402
from fedtpu_torch.parallel import mesh as t_mesh  # noqa: E402
from fedtpu_torch.resilience import chaos as t_chaos  # noqa: E402
from fedtpu_torch.resilience import distributed as t_dist  # noqa: E402

import torch_gang_worker as worker  # noqa: E402

# The conftest's guard wants a quick-tier pick in every test module; this
# module names its own (the agreement records: milliseconds, no process).
conftest.QUICK_TESTS.add(
    "test_torch_gang.py::test_resume_agreement_equals_fedtpus")

WORLD = 2
# DP-FedAvg as chip_smoke's phase (e) runs it: uniform weights, sampling
# 0.5, an adaptive clip from 1.0, noise multiplier 1 and count noise 2.
DP = {"weighting": "uniform", "participation_rate": 0.5, "dp_clip_norm": 1.0,
      "dp_noise_multiplier": 1.0, "dp_adaptive_clip": True,
      "dp_count_noise_multiplier": 2.0}


def _robust(rule: str, **fed) -> dict:
    """A robust rule over 8 clients (krum needs 2f + 3 of them), 4 a
    member."""
    return {"clients": 8, "fed": {"weighting": "uniform",
                                  "robust_aggregation": rule, **fed}}


def _gang(tmp_path, spec: dict, tag: str = "g") -> list:
    """Run a gang of ``WORLD`` workers on ``spec``; each member's record."""
    store, out = tmp_path / f"{tag}.store", tmp_path / tag
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(store), str(WORLD), str(r),
         json.dumps(spec), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    records = []
    for r in range(WORLD):
        with open(f"{out}.{r}", "rb") as fh:
            records.append(pickle.load(fh))
    return records


def _one_process(spec: dict) -> dict:
    return worker.run_recorded(spec)


def _fedtpu_inputs(j_cfg) -> dict:
    """fedtpu's init, participation masks and DP noise of ``j_cfg``'s run
    as the port's ``run_experiment`` takes them, drawn as
    tests/test_torch_round.py draws them: the masks
    ``uniform(fold_in(fold_in(key(seed), round), client)) < rate``, the
    noise fedtpu's per-leaf delta draw then its count draw."""
    fed = j_cfg.fed
    init = jax.tree.map(np.asarray, j_loop.build_experiment(j_cfg)
                        .state["params"])
    out = {"init_params": init}
    if fed.participation_rate < 1.0:
        clients = jnp.arange(j_cfg.shard.num_clients)

        @jax.jit
        def draw(r):
            key = jax.random.fold_in(jax.random.key(fed.participation_seed),
                                     r)
            u = jax.vmap(lambda i: jax.random.uniform(
                jax.random.fold_in(key, i)))(clients)
            return (u < fed.participation_rate).astype(jnp.float32)
        out["participation_masks"] = lambda r: np.asarray(draw(r))
    if fed.dp_noise_multiplier > 0:
        template = jax.tree.map(lambda p: np.zeros(p.shape[1:], np.float32),
                                init)
        key = jax.random.key(fed.dp_seed)

        @jax.jit
        def draw_noise(r):
            return (gaussian_noise_tree(jax.random.fold_in(jax.random.fold_in(
                key, _DP_NOISE_STREAM), r), template, 1.0),
                jax.random.normal(jax.random.fold_in(jax.random.fold_in(
                    key, _DP_COUNT_STREAM), r)))

        def noise(r):
            delta, count = draw_noise(r)
            return np.concatenate((convert.params_from_jax(jax.tree.map(
                np.asarray, delta)).numpy(), [np.float32(count)]))
        out["dp_noise"] = noise
    return out


def assert_one_process_is_fedtpus(spec: dict) -> None:
    """The port's one-process run of ``spec``'s config (``worker.
    gang_config``: its widths, clients, mesh, rounds and knobs) against
    fedtpu's ``run_experiment`` of it on the CPU's virtual devices, with
    fedtpu's init, masks and DP noise injected: the same stop round, the
    mean and pooled histories within 1e-6, the losses within 1e-4 (the
    run-level tolerances of tests/test_torch_round.py), the final params
    within 1e-5, the final clip within 1e-5 relative and the same privacy
    spend. This is the link from a gang's oracle to fedtpu: the gang is
    held to the port's one-process run of the same config."""
    t_cfg = worker.gang_config({k: v for k, v in spec.items()
                                if k in ("clients", "shards", "rounds",
                                         "rounds_per_step", "fed")})
    j_cfg = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=worker.ROWS),
        shard=jcfg.ShardConfig(num_clients=t_cfg.shard.num_clients),
        model=jcfg.ModelConfig(hidden_sizes=worker.HIDDEN),
        fed=jcfg.FedConfig(**worker.fed_knobs(spec)),
        run=jcfg.RunConfig(mesh_devices=t_cfg.run.mesh_devices,
                           rounds_per_step=t_cfg.run.rounds_per_step))
    rj = j_loop.run_experiment(j_cfg, verbose=False)
    rt = run_experiment(t_cfg, verbose=False, device="cpu",
                        **_fedtpu_inputs(j_cfg))
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    for got, want in ((rt.global_metrics, rj.global_metrics),
                      (rt.pooled_metrics, rj.pooled_metrics)):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        _flat(rt.final_params),
        _flat(jax.tree.map(np.asarray, rj.final_params)), rtol=0, atol=1e-5)
    if rj.final_dp_clip is not None:
        np.testing.assert_allclose(rt.final_dp_clip, rj.final_dp_clip,
                                   rtol=1e-5)
    assert rt.privacy_spent() == rj.privacy_spent()


def _flat(params: dict) -> np.ndarray:
    leaves = []

    def walk(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        else:
            leaves.append(np.ravel(np.asarray(tree)))
    walk(params)
    return np.concatenate(leaves)


def _assert_members_equal(records: list) -> None:
    for r in records[1:]:
        assert r["history"] == records[0]["history"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["confusion"], records[0]["confusion"]))
        assert np.array_equal(_flat(r["params"]),
                              _flat(records[0]["params"]))
        assert r["dp_clip"] == records[0]["dp_clip"]
        assert r["privacy"] == records[0]["privacy"]


@pytest.mark.parametrize("spec,exact", [
    ({"aggregation": "psum"}, False),
    ({"aggregation": "ring"}, True),
    ({"aggregation": "ring-rsag"}, True),
    ({"async": True}, False),
    ({"fed": {"server_opt": "fedadam", "server_lr": 0.01}}, False),
    ({"fed": {"server_opt": "fedavgm"}}, False),
    ({"fed": DP}, False),
    ({"fed": {"weighting": "uniform", "scaffold": True, "local_steps": 3}},
     False),
    ({"fed": {"compress": "int8"}}, True),
    (_robust("median", byzantine_clients=1, participation_rate=0.5), True),
    (_robust("trimmed_mean", trim_ratio=0.2, byzantine_clients=5), True),
    (_robust("krum", krum_f=1, byzantine_clients=1), True),
    (_robust("geometric_median", byzantine_clients=2), True)],
    ids=["psum", "ring", "ring-rsag", "async", "fedadam", "fedavgm",
         "dp-fedavg", "scaffold", "int8", "median-byzantine",
         "trimmed-mean-byzantine", "krum-byzantine",
         "geometric-median-byzantine"])
def test_gang_equals_the_one_process_run(spec, exact, tmp_path):
    """Every member ends with the same history, counts, final params,
    clip and privacy spend; against the one-process run: the same rounds,
    confusion counts and privacy spend, under DP the same noise rows in
    every round on every member (the rows each round took, the gang's one
    draw), and params bitwise where the gang reduces the same rows in the
    same order (the rings' plain ring over the gathered rows, the robust
    rules over the gathered submissions, Byzantine rows by their global
    index, the int8 exchange's per-shard payloads), within 1e-5 where the
    members' partial sums are added in another order (psum, the
    asynchronous tick, the delta path, SCAFFOLD's variate mean), the
    adaptive clip within 1e-6 relative. Each aggregation branch's
    one-process run of the same config is held to fedtpu's
    (``assert_one_process_is_fedtpus``). The psum gang also writes process
    0's sink and the peer's ``.p1``, which the timeline labels per process
    and the report merges."""
    if "fed" in spec:
        assert_one_process_is_fedtpus(spec)
    events = str(tmp_path / "ev.jsonl")
    gang = _gang(tmp_path, {**spec, "events": events}
                 if spec.get("aggregation") == "psum" else spec)
    _assert_members_equal(gang)
    one = _one_process(spec)
    got = gang[0]
    assert got["rounds_run"] == one["rounds_run"] == worker.ROUNDS
    assert got["stopped_early"] == one["stopped_early"]
    assert got["privacy"] == one["privacy"]
    if one["dp_clip"] is not None:
        assert abs(got["dp_clip"] - one["dp_clip"]) <= 1e-6 * one["dp_clip"]
    if one["noise"] is None:
        assert all(member["noise"] is None for member in gang)
    else:
        assert len(one["noise"]) == worker.ROUNDS
        for member in gang:
            assert np.array_equal(member["noise"], one["noise"])
    if exact:
        assert got["history"] == one["history"]
        assert np.array_equal(_flat(got["params"]), _flat(one["params"]))
    else:
        np.testing.assert_allclose(_flat(got["params"]), _flat(one["params"]),
                                   rtol=0, atol=1e-5)
        for k, v in one["history"].items():
            np.testing.assert_allclose(got["history"][k], v, rtol=0,
                                       atol=1e-5)
    if not spec.get("async"):
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["confusion"], one["confusion"]))
    if spec.get("aggregation") == "psum":
        from fedtpu_torch.telemetry.report import render_report
        from fedtpu_torch.telemetry.timeline import load_timeline
        paths = [events, events + ".p1"]
        labels = sorted(src["label"] for src in load_timeline(paths))
        assert labels == ["run", "run.p1"]
        rendered, _ = render_report(paths, fmt="json")
        sources = json.loads(rendered)["sources"]
        assert len(sources) == 2


@pytest.mark.parametrize("spec", [
    {"aggregation": "ring"},
    {"fed": {**DP, "server_opt": "fedadam", "server_lr": 0.01}}],
    ids=["ring", "dp-fedadam"])
def test_gang_checkpoint_resumes_bitwise(spec, tmp_path):
    """Each member writes its own part of a gang round
    (``state.p<i>-of-2``, process 0 the meta; the server optimizer's
    state and the clip in every part); a gang of two resumes from it after
    agreeing on the step, and ends bitwise the uninterrupted run: the one
    process's for the ring, the uninterrupted gang's for DP + fedadam,
    with the same clip and privacy spend, composed over the resumed
    segments. So does one process resuming the gang's round (each part's
    rows, concatenated), against the one process's uninterrupted run
    (within 1e-5 under DP: the gang's first rounds add its partial sums
    in another order)."""
    ck = str(tmp_path / "ck")
    saving = {**spec, "dir": ck, "every": 2}
    _gang(tmp_path, {**saving, "rounds": 2}, "first")
    assert sorted(os.listdir(os.path.join(ck, "round_000002"))) == [
        "meta", "state.p0-of-2", "state.p1-of-2"]
    resumed = _gang(tmp_path, {**saving, "resume": True}, "resumed")
    _assert_members_equal(resumed)
    one = _one_process(spec)
    dp = "fed" in spec
    if dp:
        assert_one_process_is_fedtpus(spec)
    whole = _gang(tmp_path, spec, "whole")[0] if dp else one
    assert resumed[0]["history"] == whole["history"]
    assert np.array_equal(_flat(resumed[0]["params"]),
                          _flat(whole["params"]))
    assert resumed[0]["dp_clip"] == whole["dp_clip"]
    ck_one = str(tmp_path / "ck_one")
    shutil.copytree(os.path.join(ck, "round_000002"),
                    os.path.join(ck_one, "round_000002"))
    alone = worker.result_record(run_experiment(
        worker.gang_config({**saving, "dir": ck_one}), verbose=False,
        device="cpu", resume=True))
    if dp:
        same = ("epsilon", "delta", "rdp_order", "rounds")
        for rec in (resumed[0], alone):
            assert rec["privacy"]["composed_over_resumed_segments"]
            assert ({k: rec["privacy"][k] for k in same}
                    == {k: whole["privacy"][k] for k in same})
        np.testing.assert_allclose(_flat(alone["params"]),
                                   _flat(one["params"]), rtol=0, atol=1e-5)
    else:
        assert alone["history"] == one["history"]
        assert np.array_equal(_flat(alone["params"]), _flat(one["params"]))


@pytest.mark.parametrize("knobs,message", [
    ({"server_opt": "fedadam"}, "server_opt / DP aggregation requires"),
    ({"dp_clip_norm": 1.0}, "server_opt / DP aggregation requires"),
    ({"compress": "int8"}, "compress replaces the reduction"),
    ({"weighting": "uniform", "robust_aggregation": "krum"},
     "robust_aggregation composes with the plain psum"),
    ({"weighting": "uniform", "scaffold": True},
     "scaffold requires aggregation='psum'")],
    ids=["server-opt", "dp", "int8", "robust", "scaffold"])
def test_ring_gang_refuses_a_branch_with_fedtpus_message(knobs, message):
    """A ring gang's member refuses every aggregation branch with
    fedtpu's ``check_knobs`` message (the branches need psum), before
    anything is built."""
    from fedtpu_torch.config import OptimConfig
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.ops.server_opt import make_server_optimizer
    from fedtpu_torch.parallel.round import build_round_fn
    if "server_opt" in knobs:
        knobs = {**knobs, "server_opt": make_server_optimizer(
            knobs["server_opt"])}
    mesh = t_mesh.ClientMesh(4, 2, (torch.device("cpu"),), num_processes=2)
    with pytest.raises(ValueError, match=message):
        build_round_fn((14, 16, 2), build_optimizer(OptimConfig()), 2,
                       torch.ones(4), mesh=mesh, aggregation="ring",
                       **knobs)


def test_resume_agreement_equals_fedtpus(tmp_path):
    """The same agreement records give the same agreed step in both
    packages: the minimum over the gang, a stale launch's record ignored,
    no checkpoint anywhere as NO_CHECKPOINT, a missing peer a
    TimeoutError; process 0 clears a previous launch's records."""
    cases = [({0: 8, 1: 6}, "L"), ({0: 8, 1: None}, "L")]
    for steps, launch in cases:
        for name, mod in (("t", t_dist), ("j", j_dist)):
            d = str(tmp_path / f"{name}{len(steps)}{steps[1]}")
            mod.publish_local_step(d, 1, steps[1], 0, launch_id=launch)
            mod.publish_local_step(d, 2, 4, 0, launch_id="old")
            got = mod.agree_resume_step(d, 0, 2, steps[0], 0, timeout=5,
                                        launch_id=launch)
            assert got == (6 if steps[1] else mod.NO_CHECKPOINT)
            assert sorted(os.listdir(os.path.join(
                d, mod.AGREEMENT_DIR))) == ["p0.json", "p1.json"]
    for mod in (t_dist, j_dist):
        with pytest.raises(TimeoutError, match="never published"):
            mod.agree_resume_step(str(tmp_path / mod.__name__), 0, 2, 3,
                                  0, timeout=0.2, poll=0.05, launch_id="x")
    for name in ("AGREEMENT_DIR", "NO_CHECKPOINT", "ENV_COORDINATOR",
                 "ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "ENV_LAUNCH_ID"):
        assert getattr(t_dist, name) == getattr(j_dist, name)


def test_collective_watchdog_equals_fedtpus(tmp_path):
    """A window armed past the timeout fires once in both packages: the
    same ``collective_hang`` event (its wall-clock fields aside), the same
    heartbeat status and the abort with exit 75; a disarmed window never
    fires."""
    lines = {}
    for name, mod in (("t", t_dist), ("j", j_dist)):
        codes = []
        ev, hb = str(tmp_path / f"{name}.jsonl"), str(tmp_path / f"{name}.hb")
        wd = mod.CollectiveWatchdog(0.2, events_path=ev, process_index=1,
                                    heartbeat=hb, restart_count=2,
                                    poll=0.02, _abort=codes.append).start()
        with wd.guard("quiet", 3):
            pass
        wd.arm("chunk_fetch", 7)
        for _ in range(200):
            if codes:
                break
            time.sleep(0.02)
        wd.stop()
        assert codes == [75] and wd.fired
        with open(ev) as fh:
            rec = json.loads(fh.read())
        for key in ("waited_s", "pid"):
            rec["payload"].pop(key)
        rec.pop("dur_s")
        lines[name] = rec
        with open(hb) as fh:
            assert json.load(fh)["status"] == "collective_hang"
    assert lines["t"] == lines["j"]
    assert lines["t"]["kind"] == "collective_hang"
    assert lines["t"]["round"] == 7


def test_gang_mesh_names_a_shape_it_cannot_split():
    class Gang:
        process_count, process_index = 2, 1
    mesh = t_mesh.make_mesh(4, 8, "cpu", gang=Gang())
    assert (mesh.num_shards, mesh.local_shards, mesh.first_shard,
            mesh.local_clients) == (4, 2, 2, 4)
    with pytest.raises(ValueError, match="clients 8 = processes 2"):
        t_mesh.make_mesh(3, 8, "cpu", gang=Gang())


def test_shards_per_process_reaches_gang_members_only(monkeypatch):
    """``FEDTPU_SHARDS_PER_PROCESS`` sets a member's shards (fedtpu's
    virtual devices a process); a one-process mesh reads no such
    variable."""
    class Gang:
        process_count, process_index = 2, 0
    monkeypatch.setenv(t_mesh.ENV_SHARDS_PER_PROCESS, "2")
    assert t_mesh.make_mesh(0, 8, "cpu", gang=Gang()).num_shards == 4
    assert t_mesh.make_mesh(0, 8, "cpu").num_shards == 1


@pytest.mark.slow
@pytest.mark.parametrize("name", t_chaos.GANG_SCENARIOS)
def test_gang_chaos_row(name, tmp_path):
    """Each training-gang row through ``chaos`` against the gang baseline
    on the CPU: survived, the history bitwise, at least one gang restart,
    every member resumed at the same round (``mp_hang``: the watchdog's
    ``collective_hang``); each row bounded by its own subprocess time
    limit."""
    report = t_chaos.run_chaos([name], rounds=10, num_clients=4,
                               workdir=str(tmp_path), platform="cpu",
                               timeout=240, verbose=False)
    row, = report["scenarios"]
    assert report["ok"] and row["ok"], row
    assert row["gang_restarts"] >= 1 and row["resumed_together"]
