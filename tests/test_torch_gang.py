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

import contextlib  # noqa: E402
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

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.orchestration.loop import run_experiment  # noqa: E402
from fedtpu_torch.parallel import mesh as t_mesh  # noqa: E402
from fedtpu_torch.resilience import chaos as t_chaos  # noqa: E402
from fedtpu_torch.resilience import distributed as t_dist  # noqa: E402
from fedtpu_torch.resilience import faults as t_faults  # noqa: E402

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


def _plan(*faults) -> str:
    return json.dumps({"seed": 0, "faults": list(faults)})


# The loop's features (a gang of 2 over 4 clients: member 1 owns clients 2
# and 3). A pipelined stop: every round's metrics close (atol 1), so the
# run stops at round 3 with the overshoot chunk (rounds 5-6) in flight.
PIPELINED = {"rounds": 8, "run": {"pipelined_stop": True},
             "fed": {"termination_patience": 2, "tolerance": 1.0}}
# Rollback with checkpoints every 2 rounds ("dir": each run's own), the
# watchdog armed so that a member left alone in a collective fails fast.
ROLLBACK = {"rounds": 6, "dir": "ck", "every": 2, "collective_timeout": 60,
            "run": {"on_divergence": "rollback"}}
# Client 3 drops out of round 2; client 2's params go NaN at round 5: one
# rollback to round 4.
FAULTS = {**ROLLBACK, "plan": _plan(
    {"kind": "client_dropout", "round": 2, "clients": [3]},
    {"kind": "nan_update", "round": 5, "clients": [2]})}
# The checkpoint of round 4 stomped before round 5, whose NaN update then
# rolls back past it to round 2.
CORRUPT = {**ROLLBACK, "plan": _plan(
    {"kind": "ckpt_corrupt", "round": 5},
    {"kind": "nan_update", "round": 5, "clients": [3]})}
# Two NaN updates: the second rollback perturbs the restored params with
# the whole run's draw.
PERTURB = {**ROLLBACK, "run": {**ROLLBACK["run"], "rollback_perturb": 1e-3},
           "plan": _plan({"kind": "nan_update", "round": 3, "clients": [2]},
                         {"kind": "nan_update", "round": 5, "clients": [3]})}
# The offender excluded at weight 0 by its index in the whole run.
EXCLUDE = {**ROLLBACK, "run": {**ROLLBACK["run"], "rollback_exclude": True},
           "plan": _plan({"kind": "nan_update", "round": 5,
                          "clients": [2]})}
# A NaN update of member 1's client 3 in the pipelined stop's overshoot
# chunk, the client dropped and its NaN row trimmed from the round's
# trimmed mean (the sort puts NaN last: the global stays finite, member
# 1's optimizer moments do not, so the members' own flags differ): both
# members halt at round 5, one diverged/ round with both parts ("every"
# past the run), and the watchdog never fires.
OVERSHOOT = {**PIPELINED, "fed": {**PIPELINED["fed"], "weighting": "uniform",
                                  "robust_aggregation": "trimmed_mean",
                                  "trim_ratio": 0.25},
             "dir": "ck", "every": 8, "collective_timeout": 30,
             "plan": _plan(
    {"kind": "client_dropout", "round": 5, "clients": [3]},
    {"kind": "nan_update", "round": 5, "clients": [3]})}
# The same under the median, which passes a client's NaN on to the global
# as jnp.median does: every member's state goes non-finite at round 5.
OVERSHOOT_MEDIAN = {**OVERSHOOT, "fed": {
    **PIPELINED["fed"], "weighting": "uniform",
    "robust_aggregation": "median"}}
# Personalization after a warm start ("warm": the test writes the
# artifact).
PERSONALIZE = {"warm": True, "fed": {"personalize_steps": 3}}


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
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
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


# The spec keys that the one-process comparison with fedtpu carries into
# both runs' configs (``worker.gang_config``); any other key fails it, so
# that none is dropped silently.
FEDTPU_KEYS = frozenset({"aggregation", "async", "clients", "shards",
                         "rounds", "rounds_per_step", "fed", "run", "plan",
                         "dir", "every", "collective_timeout"})
# The events whose payloads the comparison holds equal.
FEDTPU_EVENTS = ("fault", "rollback", "exclusion", "diverged")


@contextlib.contextmanager
def _fedtpus_perturbation(init: dict):
    """While open, the port's rollback perturbs the restored params with
    fedtpu's draw of each attempt (its ``_perturb_tree``:
    ``jax.random.key(attempt)`` split per leaf of the client-stacked
    params) in the port's flat layout; ``init`` gives the leaves'
    shapes."""
    own = t_faults.perturb_params
    leaves, treedef = jax.tree.flatten(init)

    def fedtpus_draw(params, attempt, scale, **kw):
        keys = jax.random.split(jax.random.key(attempt), len(leaves))
        draw = convert.params_from_jax(jax.tree.unflatten(treedef, [
            np.asarray(jax.random.uniform(k, leaf.shape, leaf.dtype))
            for leaf, k in zip(leaves, keys)]))
        own(params, attempt, scale, **{**kw, "uniform": draw})

    t_faults.perturb_params = fedtpus_draw
    try:
        yield
    finally:
        t_faults.perturb_params = own


def assert_one_process_is_fedtpus(spec: dict, tmp_path) -> None:
    """The port's one-process run of ``spec``'s config (``worker.
    gang_config``: its widths, clients, mesh, rounds, knobs, loop options,
    fault plan and checkpoints, each side its own directory) against
    fedtpu's ``run_experiment`` of the same config on the CPU's virtual
    devices, with fedtpu's init, masks, DP noise and rollback perturbation
    injected: the same stop round, rounds trained and divergence, the
    fault, rollback (restored round, attempt, exclusion), exclusion and
    divergence events as fedtpu's, the mean, pooled and per-client
    histories within 1e-6 (the per-client metrics are the confusion
    counts' currency), the losses within 1e-4 (the run-level tolerances of
    tests/test_torch_round.py), the final params and the personalized
    metrics within 1e-5, the final clip within 1e-5 relative and the same
    privacy spend. This is the link from a gang's oracle to fedtpu: the
    gang is held to the port's one-process run of the same config."""
    unused = set(spec) - FEDTPU_KEYS
    assert not unused, f"spec keys the fedtpu comparison does not use: " \
        f"{sorted(unused)}"
    cfgs = {}
    for side, module in (("fedtpu", jcfg), ("port", tcfg)):
        mine = {**spec, "events": str(tmp_path / f"{side}.jsonl")}
        if spec.get("dir"):
            mine["dir"] = f"{spec['dir']}-{side}"
        cfgs[side] = worker.gang_config(mine, module)
    rj = j_loop.run_experiment(cfgs["fedtpu"], verbose=False)
    inputs = _fedtpu_inputs(cfgs["fedtpu"])
    with _fedtpus_perturbation(inputs["init_params"]):
        rt = run_experiment(cfgs["port"], verbose=False, device="cpu",
                            **inputs)
    for key in ("rounds_run", "stopped_early", "rounds_trained",
                "diverged"):
        assert getattr(rt, key) == getattr(rj, key), key
    events = {}
    for side in cfgs:
        with open(tmp_path / f"{side}.jsonl") as fh:
            events[side] = [(e["kind"], e["payload"]) for e in
                            map(json.loads, fh)
                            if e["kind"] in FEDTPU_EVENTS]
    assert events["port"] == events["fedtpu"]
    assert rt.rollbacks == sum(k == "rollback" for k, _ in events["port"])
    for got, want in ((rt.global_metrics, rj.global_metrics),
                      (rt.pooled_metrics, rj.pooled_metrics),
                      (rt.per_client_metrics, rj.per_client_metrics)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                       rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        _flat(rt.final_params),
        _flat(jax.tree.map(np.asarray, rj.final_params)), rtol=0, atol=1e-5)
    _assert_personalized(rt.personalized_metrics, jax.tree.map(
        np.asarray, rj.personalized_metrics), 1e-5)
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
                              _flat(records[0]["params"]), equal_nan=True)
        for key in ("dp_clip", "privacy", "rollbacks", "diverged",
                    "rounds_run", "rounds_trained"):
            assert r[key] == records[0][key], key
        _assert_personalized(r["personalized"],
                             records[0]["personalized"], 0)


def _assert_personalized(got: dict, want: dict, atol: float) -> None:
    """Personalized per-client and client-mean metrics within ``atol``
    (0: bitwise)."""
    assert sorted(got) == sorted(want)
    for part in got:
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            if atol:
                np.testing.assert_allclose(got[part][k], v, rtol=0,
                                           atol=atol, err_msg=k)
            else:
                assert np.array_equal(got[part][k], v), (part, k)


def _placed(spec: dict, tmp_path, tag: str) -> dict:
    """``spec`` with its checkpoint dir under ``tmp_path`` (one a run) and
    the warm start's artifact, written once from a one-round run's final
    model with the port's ``save_best_weights``."""
    spec = dict(spec)
    if spec.get("dir"):
        spec["dir"] = str(tmp_path / f"{tag}-{spec['dir']}")
    if spec.pop("warm", False):
        path = tmp_path / "warm.npz"
        if not path.exists():
            from fedtpu_torch.sweep.grid import save_best_weights
            first = worker.result_record(run_experiment(
                worker.gang_config({"rounds": 1}), verbose=False,
                device="cpu"))
            save_best_weights(str(path), {
                "weights": first["params"],
                "params": {"hidden_layer_sizes": list(worker.HIDDEN),
                           "learning_rate": 0.001},
                "metrics": {}, "accuracy": 0.0})
        spec["fed"] = {**spec.get("fed", {}), "init_weights_npz": str(path)}
    return spec


def _sink_rows(events: str, kind: str, members: int = 1) -> list:
    """Each member's ``kind`` events (process 0's sink, then the peers'
    ``.p<i>``)."""
    out = []
    for i in range(members):
        with open(events if i == 0 else f"{events}.p{i}") as fh:
            rows = [json.loads(line) for line in fh]
        out.append([r for r in rows if r["kind"] == kind])
    return out


def _sink(events: str, kind: str, members: int = 1) -> list:
    """Each member's ``kind`` events' payloads."""
    return [[r["payload"] for r in m]
            for m in _sink_rows(events, kind, members)]


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
    (_robust("geometric_median", byzantine_clients=2), True),
    (PIPELINED, False),
    ({**PIPELINED, "aggregation": "ring"}, True),
    ({**PERSONALIZE, "fed": {**PERSONALIZE["fed"], "server_opt": "fedadam",
                             "server_lr": 0.01}}, False),
    ({**PERSONALIZE, "aggregation": "ring"}, True),
    ({"async": True, "warm": True}, False),
    (FAULTS, False),
    ({**FAULTS, "aggregation": "ring"}, True),
    (CORRUPT, False),
    ({**CORRUPT, "aggregation": "ring"}, True),
    (PERTURB, False),
    ({**PERTURB, "aggregation": "ring"}, True),
    (EXCLUDE, False),
    ({**EXCLUDE, "aggregation": "ring"}, True),
    (OVERSHOOT, False),
    (OVERSHOOT_MEDIAN, True)],
    ids=["psum", "ring", "ring-rsag", "async", "fedadam", "fedavgm",
         "dp-fedavg", "scaffold", "int8", "median-byzantine",
         "trimmed-mean-byzantine", "krum-byzantine",
         "geometric-median-byzantine", "pipelined-stop",
         "pipelined-stop-ring", "warm-fedadam-personalize",
         "warm-personalize-ring", "warm-async", "dropout-nan-rollback",
         "dropout-nan-rollback-ring", "corrupt-then-nan",
         "corrupt-then-nan-ring", "second-retry-perturb",
         "second-retry-perturb-ring", "rollback-exclude",
         "rollback-exclude-ring", "nan-in-pipelined-overshoot",
         "median-nan-in-pipelined-overshoot"])
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
    adaptive clip within 1e-6 relative. Each aggregation branch's and
    each loop feature's one-process run of the same config (its loop
    options, fault plan and checkpoints too) is held to fedtpu's
    (``assert_one_process_is_fedtpus``). The psum gang also writes process
    0's sink and the peer's ``.p1``, which the timeline labels per process
    and the report merges.

    The loop's features the same way, every member's decision the same:
    a pipelined stop at the same round with the overshoot chunk trained;
    personalization after a warm start (under fedadam, the gang's shared
    start), the personalized metrics too; the asynchronous gang's anchors
    and global from a warm start; a dropout of a member-1 client
    (zero counts in its round) and a NaN update rolled back to the same
    round on both members and in one process (the sinks' ``rollback``
    events); a corrupt checkpoint walked past by the whole gang, counted
    on the member whose part was hit; the second retry's perturbation
    and the offender excluded by its index in the run, each on psum and
    bitwise on the ring; a NaN update in the pipelined overshoot chunk
    halting both members at the same round, under ``diverged/`` with both
    parts, whether the aggregate trims the NaN row (the members' own
    flags differ) or the median passes it on (fedtpu's NaN global)."""
    if {"fed", "run", "plan"} & set(spec):
        assert_one_process_is_fedtpus(_placed(spec, tmp_path, "j"), tmp_path)
    events = str(tmp_path / "ev.jsonl")
    sink = spec.get("aggregation") == "psum" or "plan" in spec
    gang = _gang(tmp_path, {**_placed(spec, tmp_path, "gang"),
                            "events": events} if sink
                 else _placed(spec, tmp_path, "gang"))
    _assert_members_equal(gang)
    one_events = str(tmp_path / "one.jsonl")
    one = _one_process({**_placed(spec, tmp_path, "one"),
                        "events": one_events})
    got = gang[0]
    assert got["rounds_run"] == one["rounds_run"] == (
        3 if "pipelined_stop" in spec.get("run", {}) else spec.get(
            "rounds", worker.ROUNDS))
    for key in ("stopped_early", "rounds_trained", "rollbacks",
                "diverged"):
        assert got[key] == one[key], key
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
        assert np.array_equal(_flat(got["params"]), _flat(one["params"]),
                              equal_nan=True)
    else:
        np.testing.assert_allclose(_flat(got["params"]), _flat(one["params"]),
                                   rtol=0, atol=1e-5)
        for k, v in one["history"].items():
            np.testing.assert_allclose(got["history"][k], v, rtol=0,
                                       atol=1e-5)
    _assert_personalized(got["personalized"], one["personalized"],
                         0 if exact else 1e-5)
    if not spec.get("async"):
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["confusion"], one["confusion"]))
    if "plan" in spec:
        _assert_faults_held(spec, gang, one, events, one_events, tmp_path)
    if spec.get("aggregation") == "psum":
        from fedtpu_torch.telemetry.report import render_report
        from fedtpu_torch.telemetry.timeline import load_timeline
        paths = [events, events + ".p1"]
        labels = sorted(src["label"] for src in load_timeline(paths))
        assert labels == ["run", "run.p1"]
        rendered, _ = render_report(paths, fmt="json")
        sources = json.loads(rendered)["sources"]
        assert len(sources) == 2


def _assert_faults_held(spec, gang, one, events, one_events,
                        tmp_path) -> None:
    """A fault plan's decisions, each member's against one process's: the
    rollbacks to the same round and their exclusions (the sinks'
    ``rollback`` events), the dropped client's zero counts in its round,
    the corrupt part counted on the member that failed to load it, a
    halt's ``diverged/`` round with every member's part."""
    rb = _sink(events, "rollback", len(gang))
    want = [{k: e[k] for k in ("restored_round", "attempt", "excluded")}
            for e in _sink(one_events, "rollback")[0]]
    for member in rb:
        assert [{k: e[k] for k in want[0]} for e in member] == want
    assert len(want) == one["rollbacks"]
    plan = json.loads(spec["plan"])["faults"]
    for f in plan:
        if f["kind"] == "client_dropout" and not one["diverged"]:
            for c in f["clients"]:
                assert not gang[0]["confusion"][f["round"] - 1][c].any()
        if f["kind"] == "ckpt_corrupt":
            # The round's largest part (ties to the lowest) failed to load
            # on its member alone; both walked back to round 2.
            assert want[0]["restored_round"] == 2
            assert one["restore_corrupt"] == 1
            assert [m["restore_corrupt"] for m in gang] == [1, 0]
    if one["diverged"]:
        from fedtpu_torch.orchestration.checkpoint import complete_steps
        ck = os.path.join(_placed(spec, tmp_path, "gang")["dir"],
                          "diverged")
        step, = complete_steps(ck)
        assert step == gang[0]["rounds_trained"]
        assert sorted(os.listdir(os.path.join(ck, f"round_{step:06d}"))) \
            == ["meta", "state.p0-of-2", "state.p1-of-2"]


@pytest.mark.parametrize("spec", [
    {"aggregation": "ring"},
    {"fed": {**DP, "server_opt": "fedadam", "server_lr": 0.01}},
    {"aggregation": "ring", "stomp": True}],
    ids=["ring", "dp-fedadam", "ring-stomped-part"])
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
    in another order).

    "stomped": the gang wrote rounds 2 and 4 and member 1's part of round
    4 is stomped; the resumed gang agrees on round 4, member 1 fails to
    load it, and the whole gang walks back to round 2 (one agreed walk,
    counted on member 1 alone) and ends bitwise the uninterrupted run."""
    spec = dict(spec)
    stomp = spec.pop("stomp", False)
    ck = str(tmp_path / "ck")
    saving = {**spec, "dir": ck, "every": 2}
    _gang(tmp_path, {**saving, "rounds": 4 if stomp else 2}, "first")
    assert sorted(os.listdir(os.path.join(ck, "round_000002"))) == [
        "meta", "state.p0-of-2", "state.p1-of-2"]
    events = str(tmp_path / "resumed.jsonl")
    if stomp:
        part = os.path.join(ck, "round_000004", "state.p1-of-2")
        with open(part, "r+b") as fh:
            fh.truncate(os.path.getsize(part) // 2)
            fh.seek(0)
            fh.write(b"\xde\xad\xbe\xef" * 16)
        saving["events"] = events
    resumed = _gang(tmp_path, {**saving, "resume": True}, "resumed")
    _assert_members_equal(resumed)
    if stomp:
        assert [m["restore_corrupt"] for m in resumed] == [0, 1]
        assert [[e["round"] for e in m] for m in _sink_rows(
            events, "resume", 2)] == [[2], [2]]
    one = _one_process(spec)
    dp = "fed" in spec
    if dp:
        assert_one_process_is_fedtpus(spec, tmp_path)
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
