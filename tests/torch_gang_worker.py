"""One member of a CPU training gang of the port, for tests/test_torch_gang.py.

Run as ``python tests/torch_gang_worker.py STORE WORLD RANK SPEC OUT``:
joins the gloo gang through the ``file://`` store ``STORE`` (no port to
race for under xdist), runs ``run_experiment`` on the CPU with the config
that the JSON ``SPEC`` describes (``gang_config``), and pickles its history,
confusion counts, losses, final params, privacy spend, final clip, the
DP noise rows its rounds loaded, its personalized metrics, rollbacks,
rounds trained and restore counters into ``OUT.<rank>``. It imports torch
and the port only.
"""

import contextlib
import json
import os
import pickle
import sys

import numpy as np
import torch

# Shared with the test's one-process runs, so the two cannot drift.
HIDDEN = (16,)
NUM_CLIENTS = 4
SHARDS = 4
ROWS = 512
ROUNDS = 4


def fed_knobs(spec: dict) -> dict:
    """The FedConfig fields of ``spec``'s run (fedtpu's names)."""
    return {"rounds": spec.get("rounds", ROUNDS), "termination_patience": 100,
            "aggregation": spec.get("aggregation", "psum"),
            **spec.get("fed", {})}


def gang_config(spec: dict, config=None):
    """The small income run of ``spec``: ``aggregation``, ``async``,
    ``rounds``, the checkpoint ``dir`` / ``every``, the ``events`` sink,
    ``fed``, a dict of FedConfig overrides (an aggregation branch's knobs,
    personalization, a warm start), ``run``, a dict of RunConfig overrides
    (pipelined stop, the divergence policy), and ``clients``, ``shards``,
    ``rounds_per_step``, the fault ``plan`` and the
    ``collective_timeout``. ``config``: the module of the config classes,
    the port's ``fedtpu_torch.config`` by default (a test passes
    ``fedtpu``'s, whose fields are the same, for the same run there)."""
    if config is None:
        from fedtpu_torch import config
    fed = fed_knobs(spec)
    if spec.get("async"):
        fed.update(async_mode=True, weighting="uniform",
                   async_arrival_rate=0.5, async_buffer_size=2)
    run = dict(mesh_devices=spec.get("shards", SHARDS),
               rounds_per_step=spec.get("rounds_per_step", 2))
    if spec.get("dir"):
        run.update(checkpoint_dir=spec["dir"],
                   checkpoint_every=spec.get("every", 2))
    if spec.get("events"):
        run["telemetry"] = config.TelemetryConfig(events_path=spec["events"])
    if spec.get("plan"):
        run["fault_plan"] = spec["plan"]
    if spec.get("collective_timeout"):
        run["collective_timeout"] = spec["collective_timeout"]
    run.update(spec.get("run", {}))
    return config.ExperimentConfig(
        data=config.DataConfig(csv_path=None, synthetic_rows=ROWS),
        shard=config.ShardConfig(num_clients=spec.get("clients", NUM_CLIENTS)),
        model=config.ModelConfig(hidden_sizes=HIDDEN),
        fed=config.FedConfig(**fed), run=config.RunConfig(**run))


def result_record(res) -> dict:
    from fedtpu_torch.telemetry.metrics import default_registry
    counters = default_registry().snapshot()["counters"]
    return {"history": res.global_metrics, "rounds_run": res.rounds_run,
            "stopped_early": res.stopped_early, "loss": res.loss,
            "confusion": res.confusion, "params": res.final_params,
            "privacy": res.privacy_spent(), "dp_clip": res.final_dp_clip,
            "personalized": res.personalized_metrics,
            "rollbacks": res.rollbacks, "diverged": res.diverged,
            "rounds_trained": res.rounds_trained,
            "restore_corrupt": counters.get("checkpoint_restore_corrupt", 0)}


@contextlib.contextmanager
def recording_noise(rows: list):
    """While open, every round step the loop builds appends the DP noise
    row each of its rounds takes to ``rows``: a gang member's as its round
    loads it into the round's buffer, one process's from the chunk it is
    given."""
    from fedtpu_torch.orchestration import loop
    from fedtpu_torch.parallel.round import GangStep
    build = loop.build_round_fn

    def recorded(*args, **kw):
        step = build(*args, **kw)
        if step.draw_noise is None:
            return step
        if isinstance(step, GangStep):
            load = step.load_round

            def load_round(state, bufs, j, masks, noise):
                load(state, bufs, j, masks, noise)
                rows.append(bufs[1].numpy().copy())
            step.load_round = load_round
        else:
            fn = step.fn

            def run(state, batch, masks=None, noise=None):
                if noise is None:
                    noise = step.draw_noise(state["round"], step.rounds)
                rows.extend(noise.numpy().copy())
                return fn(state, batch, masks, noise)
            step.fn = run
        return step

    loop.build_round_fn = recorded
    try:
        yield rows
    finally:
        loop.build_round_fn = build


def run_recorded(spec: dict, **kw) -> dict:
    """``result_record`` of ``spec``'s run on the CPU, with ``noise``: the
    DP noise rows its rounds took (None without DP noise)."""
    from fedtpu_torch.orchestration.loop import run_experiment
    with recording_noise([]) as rows:
        record = result_record(run_experiment(
            gang_config(spec), verbose=False, device="cpu", **kw))
    record["noise"] = np.stack(rows) if rows else None
    return record


def main(store: str, world: int, rank: int, spec: dict, out: str) -> None:
    torch.set_num_threads(1)
    from fedtpu_torch.parallel import multihost
    multihost.initialize(f"file://{store}", world, rank, platform="cpu")
    try:
        record = run_recorded(spec, resume=bool(spec.get("resume")))
    finally:
        multihost.shutdown()
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(record, fh)


if __name__ == "__main__":
    # The repository's root, so that the port imports from the checkout.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         json.loads(sys.argv[4]), sys.argv[5])
