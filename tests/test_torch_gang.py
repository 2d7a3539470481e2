"""The port's training gang (``fedtpu_torch.parallel.multihost``) on the
CPU: gloo gangs of two ``run`` processes (``tests/torch_gang_worker.py``,
joined through a ``file://`` store) held to the port's one-process run of
the same config, which ``tests/test_torch_round.py`` holds to fedtpu:
``psum`` within float32 tolerance, ``ring`` and ``ring-rsag`` bitwise, the
asynchronous gang within float32 tolerance, and a gang checkpoint resumed
by a gang of the same size bitwise. The resume agreement and the
collective watchdog are held in process against fedtpu's. The four
training-gang chaos rows run as ``slow`` tests."""

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

import numpy as np  # noqa: E402

import conftest  # noqa: E402
from fedtpu.resilience import distributed as j_dist  # noqa: E402

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
    res = run_experiment(worker.gang_config(spec), verbose=False,
                         device="cpu")
    return worker.result_record(res)


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


@pytest.mark.parametrize("spec,exact", [
    ({"aggregation": "psum"}, False),
    ({"aggregation": "ring"}, True),
    ({"aggregation": "ring-rsag"}, True),
    ({"async": True}, False)],
    ids=["psum", "ring", "ring-rsag", "async"])
def test_gang_equals_the_one_process_run(spec, exact, tmp_path):
    """Every member ends with the same history, counts and final params;
    against the one-process run: the same rounds and confusion counts, and
    params bitwise for the rings (the plain ring over the gathered rows is
    the one process's), within 1e-5 where the members' partial sums are
    added in another order (psum, the asynchronous tick). The psum gang
    also writes process 0's sink and the peer's ``.p1``, which the
    timeline labels per process and the report merges."""
    events = str(tmp_path / "ev.jsonl")
    gang = _gang(tmp_path, {**spec, "events": events}
                 if spec.get("aggregation") == "psum" else spec)
    _assert_members_equal(gang)
    one = _one_process(spec)
    got = gang[0]
    assert got["rounds_run"] == one["rounds_run"] == worker.ROUNDS
    assert got["stopped_early"] == one["stopped_early"]
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


def test_gang_checkpoint_resumes_bitwise(tmp_path):
    """Each member writes its own part of a gang round
    (``state.p<i>-of-2``, process 0 the meta); a gang of two resumes from
    it after agreeing on the step, and ends bitwise the one process's
    uninterrupted ring run; so does one process resuming the gang's round
    (each part's rows, concatenated)."""
    ck = str(tmp_path / "ck")
    spec = {"aggregation": "ring", "dir": ck, "every": 2}
    _gang(tmp_path, {**spec, "rounds": 2}, "first")
    assert sorted(os.listdir(os.path.join(ck, "round_000002"))) == [
        "meta", "state.p0-of-2", "state.p1-of-2"]
    resumed = _gang(tmp_path, {**spec, "resume": True}, "resumed")
    _assert_members_equal(resumed)
    one = _one_process({"aggregation": "ring"})
    assert resumed[0]["history"] == one["history"]
    assert np.array_equal(_flat(resumed[0]["params"]), _flat(one["params"]))
    ck_one = str(tmp_path / "ck_one")
    shutil.copytree(os.path.join(ck, "round_000002"),
                    os.path.join(ck_one, "round_000002"))
    alone = worker.result_record(run_experiment(
        worker.gang_config({**spec, "dir": ck_one}), verbose=False,
        device="cpu", resume=True))
    assert alone["history"] == one["history"]
    assert np.array_equal(_flat(alone["params"]), _flat(one["params"]))


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
