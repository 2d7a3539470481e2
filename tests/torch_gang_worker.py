"""One member of a CPU training gang of the port, for tests/test_torch_gang.py.

Run as ``python tests/torch_gang_worker.py STORE WORLD RANK SPEC OUT``:
joins the gloo gang through the ``file://`` store ``STORE`` (no port to
race for under xdist), runs ``run_experiment`` on the CPU with the config
that the JSON ``SPEC`` describes (``gang_config``), and pickles its history,
confusion counts, losses and final params into ``OUT.<rank>``. It imports
torch and the port only.
"""

import json
import os
import pickle
import sys

import torch

# Shared with the test's one-process runs, so the two cannot drift.
HIDDEN = (16,)
NUM_CLIENTS = 4
SHARDS = 4
ROWS = 512
ROUNDS = 4


def gang_config(spec: dict):
    """The small income run of ``spec``: ``aggregation``, ``async``,
    ``rounds``, the checkpoint ``dir`` / ``every``, and for the elastic
    runs ``clients``, ``shards``, ``rounds_per_step``, the fault ``plan``
    and the ``collective_timeout``."""
    from fedtpu_torch import config as tcfg
    fed = dict(rounds=spec.get("rounds", ROUNDS), termination_patience=100,
               aggregation=spec.get("aggregation", "psum"))
    if spec.get("async"):
        fed.update(async_mode=True, weighting="uniform",
                   async_arrival_rate=0.5, async_buffer_size=2)
    run = dict(mesh_devices=spec.get("shards", SHARDS),
               rounds_per_step=spec.get("rounds_per_step", 2))
    if spec.get("dir"):
        run.update(checkpoint_dir=spec["dir"],
                   checkpoint_every=spec.get("every", 2))
    if spec.get("events"):
        run["telemetry"] = tcfg.TelemetryConfig(events_path=spec["events"])
    if spec.get("plan"):
        run["fault_plan"] = spec["plan"]
    if spec.get("collective_timeout"):
        run["collective_timeout"] = spec["collective_timeout"]
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(csv_path=None, synthetic_rows=ROWS),
        shard=tcfg.ShardConfig(num_clients=spec.get("clients", NUM_CLIENTS)),
        model=tcfg.ModelConfig(hidden_sizes=HIDDEN),
        fed=tcfg.FedConfig(**fed), run=tcfg.RunConfig(**run))


def result_record(res) -> dict:
    return {"history": res.global_metrics, "rounds_run": res.rounds_run,
            "stopped_early": res.stopped_early, "loss": res.loss,
            "confusion": res.confusion, "params": res.final_params}


def main(store: str, world: int, rank: int, spec: dict, out: str) -> None:
    torch.set_num_threads(1)
    from fedtpu_torch.orchestration.loop import run_experiment
    from fedtpu_torch.parallel import multihost
    multihost.initialize(f"file://{store}", world, rank, platform="cpu")
    try:
        res = run_experiment(gang_config(spec), verbose=False, device="cpu",
                             resume=bool(spec.get("resume")))
    finally:
        multihost.shutdown()
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(result_record(res), fh)


if __name__ == "__main__":
    # The repository's root, so that the port imports from the checkout.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         json.loads(sys.argv[4]), sys.argv[5])
