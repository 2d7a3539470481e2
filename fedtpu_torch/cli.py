"""``python -m fedtpu_torch.cli {run,sweep,parity,presets,serve,gateway,
loadgen,autoscale,report,timeline,supervise,chaos,fuzz,check}``: the port's
counterparts of ``fedtpu run`` (the synchronous engine, or with ``--async``
the asynchronous FedBuff one; with ``--fault-plan``, ``--on-divergence``,
``--heartbeat`` and ``--max-restarts``, its resilience knobs),
``fedtpu sweep`` (the hyperparameter grid), ``fedtpu parity`` (the sklearn
``MLPClassifier`` warm-start limitation demo), ``fedtpu presets`` (the
shipped presets), ``fedtpu serve`` (the trace-driven serving front end on
the driven asynchronous tick), ``fedtpu gateway`` (one member of the
store-backed gateway fleet), ``fedtpu loadgen`` (replay an arrival trace
against a running server or fleet), ``fedtpu autoscale`` (the SLO-driven
control plane, simulated or live), the offline readers of a telemetry
sink, ``fedtpu report`` and ``fedtpu timeline``, ``fedtpu supervise`` (one
supervised child restarted with ``--resume``, or with ``--num-processes N``
a training gang or a gateway fleet as a gang), ``fedtpu chaos`` (the
resilience scenario matrix, every row of it), ``fedtpu fuzz`` (seeded
composed fault campaigns against an in-process two-gateway gang, shrunk
to reproducers) and ``fedtpu check``
(the runtime probe that the round step replays without a recapture,
with its simulation, fleet and corpus folds).

``run`` exits 0 when done, 3 (``EXIT_DIVERGED``) on a divergence halt,
75 (``EXIT_PREEMPTED``) after a SIGTERM drain and 76 (``EXIT_RESHARDED``)
as a gang member parked by an elastic shrink at the run's end, as
``fedtpu``'s.

Every flag is one that ``fedtpu.cli``'s parser also has, with the same
meaning; ``--platform default`` means the GPU, ``--platform cpu`` the plain
versions on the CPU. ``chaos`` adds ``--hidden-sizes`` and
``--synthetic-rows`` (its runs' widths and rows; fedtpu's fixes hidden 16).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from fedtpu_torch.config import (AGGREGATIONS, PRESETS,
                                 get_preset)


def _participation_rate(text: str) -> float:
    rate = float(text)
    if not 0.0 < rate <= 1.0:
        raise argparse.ArgumentTypeError(
            f"participation rate must be in (0, 1], got {rate}")
    return rate


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def _nonnegative_int(text: str) -> int:
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def _nonnegative_float(text: str) -> float:
    value = float(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def _positive_float(text: str) -> float:
    value = float(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be > 0, got {value}")
    return value


def _open_unit_float(text: str) -> float:
    value = float(text)
    if not 0.0 < value < 1.0:
        raise argparse.ArgumentTypeError(
            f"must be in the open interval (0, 1), got {value}")
    return value


def _hidden_sizes(text: str):
    return tuple(int(t) for t in text.split(",") if t.strip())


def _add_common_overrides(p: argparse.ArgumentParser) -> None:
    """The flags ``run`` and ``sweep`` share, as ``fedtpu.cli``'s."""
    p.add_argument("--preset", default="income-8", choices=sorted(PRESETS))
    p.add_argument("--csv", default=None,
                   help="dataset CSV path ('' = synthetic rows, the "
                        "presets' default)")
    p.add_argument("--label-column", default=None)
    p.add_argument("--synthetic-rows", type=int, default=None)
    p.add_argument("--num-clients", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--hidden-sizes", type=_hidden_sizes, default=None,
                   help="comma-separated, e.g. 50,200")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--weighting", choices=["data_size", "uniform"],
                   default=None)
    p.add_argument("--participation-rate", type=_participation_rate,
                   default=None,
                   help="per-round client sampling probability in (0, 1] "
                        "(default 1.0)")
    p.add_argument("--local-steps", type=_positive_int, default=None,
                   help="full-batch steps per client per round (classic "
                        "FedAvg E >= 1; reference does 1)")
    p.add_argument("--prox-mu", type=_nonnegative_float, default=None,
                   help="FedProx proximal coefficient >= 0 (0 = plain "
                        "FedAvg; meaningful with --local-steps > 1)")
    p.add_argument("--scaffold", action="store_true", default=None,
                   help="SCAFFOLD control-variate drift correction "
                        "(Karimireddy et al. 2020; needs --weighting "
                        "uniform)")
    p.add_argument("--server-opt",
                   choices=["none", "fedavgm", "fedadagrad", "fedyogi",
                            "fedadam"],
                   default=None,
                   help="server optimizer over client deltas (FedOpt; "
                        "'none' = the reference's parameter averaging)")
    p.add_argument("--server-lr", type=float, default=None,
                   help="server optimizer learning rate (default 1.0)")
    p.add_argument("--server-momentum", type=_nonnegative_float, default=None,
                   help="fedavgm momentum (default 0.9)")
    p.add_argument("--dp-clip-norm", type=_nonnegative_float, default=None,
                   help="per-client L2 clip of updates (DP-FedAvg; 0 = off)")
    p.add_argument("--dp-noise-multiplier", type=_nonnegative_float,
                   default=None,
                   help="Gaussian noise multiplier on the averaged clipped "
                        "delta (needs --dp-clip-norm > 0)")
    p.add_argument("--dp-delta", type=_open_unit_float, default=None,
                   help="target delta for the (epsilon, delta) report the "
                        "RDP accountant adds to the summary when DP noise "
                        "is on (default 1e-5; pick << 1/num_clients)")
    p.add_argument("--dp-adaptive-clip", action="store_true", default=None,
                   help="adaptive clipping (Andrew et al. 2021): the clip "
                        "norm tracks --dp-target-quantile of client update "
                        "norms, starting at --dp-clip-norm")
    p.add_argument("--dp-target-quantile", type=_open_unit_float,
                   default=None,
                   help="quantile of update norms the adaptive clip tracks "
                        "(default 0.5)")
    p.add_argument("--dp-clip-lr", type=_nonnegative_float, default=None,
                   help="geometric step size of the adaptive clip update "
                        "(default 0.2)")
    p.add_argument("--dp-count-noise-multiplier", type=_nonnegative_float,
                   default=None,
                   help="noise on the clipped-count release under adaptive "
                        "clipping with DP noise on; must exceed "
                        "dp_noise_multiplier/2 (the delta noise is then "
                        "raised so the composed round charges exactly "
                        "--dp-noise-multiplier)")
    p.add_argument("--compress", choices=["none", "int8"], default=None,
                   help="int8-quantize each mesh shard's summed update "
                        "before the exchange")
    p.add_argument("--robust-aggregation",
                   choices=["none", "median", "trimmed_mean", "krum",
                            "geometric_median"],
                   default=None,
                   help="Byzantine-robust aggregation rule (requires "
                        "--weighting uniform and full participation)")
    p.add_argument("--trim-ratio", type=_nonnegative_float, default=None,
                   help="fraction trimmed from each end per coordinate "
                        "(trimmed_mean)")
    p.add_argument("--krum-f", type=int, default=None,
                   help="krum's assumed number of malicious clients")
    p.add_argument("--byzantine-clients", type=int, default=None,
                   help="fault injection: first k clients submit 10x "
                        "sign-flipped updates")
    p.add_argument("--shard-strategy",
                   choices=["contiguous", "label_sort", "dirichlet"],
                   default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="the forward pass's dtype (the parameters keep "
                        "ModelConfig.param_dtype)")
    p.add_argument("--use-pallas", action="store_true",
                   help="fedtpu's fused-MLP held-out eval; the port runs "
                        "its counterpart (K3 on the GPU) for the float32 "
                        "MLP either way")
    p.add_argument("--rounds-per-step", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="retain only the k newest complete checkpoints "
                        "plus the best-accuracy round (0 = keep all)")
    p.add_argument("--metrics-jsonl", default=None,
                   help="append one JSON line of metrics per round")
    p.add_argument("--eval-test-every", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the round "
                        "loop here")
    p.add_argument("--profile-rounds", type=int, default=None, metavar="K",
                   help="with --profile-dir: capture only a K-round "
                        "steady-state window (starts after the first "
                        "chunk, so the graphs' capture is excluded); 0 "
                        "traces the whole run")
    p.add_argument("--events", default=None, metavar="JSONL",
                   help="append structured telemetry events here (run "
                        "manifest, per-phase spans, per-round cadence, "
                        "counter snapshots); analyze with "
                        "'python -m fedtpu_torch.cli report <file>'")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="'default' runs on the GPU, 'cpu' on the CPU")
    p.add_argument("--log-per-client", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="print the result summary as one JSON line")


def _add_serving_flags(p: argparse.ArgumentParser) -> None:
    """``fedtpu``'s serve flag surface (every flag of its
    ``_add_serving_flags``)."""
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1; the "
                        "protocol is a same-host ingestion socket)")
    p.add_argument("--port", type=_nonnegative_int, default=0,
                   help="TCP port (default 0 = ephemeral; pair "
                        "with --port-file)")
    p.add_argument("--port-file", default=None, metavar="FILE",
                   help="write the bound port here once listening "
                        "(ephemeral-port discovery for loadgen)")
    p.add_argument("--net-fault-plan", default=None, metavar="JSON",
                   help="seeded wire-fault schedule (path or inline "
                        "JSON): front the server with a deterministic "
                        "fault proxy on <port-file>.net (needs "
                        "--port-file)")
    p.add_argument("--cohort", type=_positive_int, default=8,
                   help="concurrent engine slots C; users get "
                        "stable slot bindings with LRU eviction "
                        "(default 8)")
    p.add_argument("--buffer-size", type=_nonnegative_int, default=0,
                   help="FedBuff K-buffer M: the global only moves "
                        "once M updates buffered (<=1 applies every "
                        "tick; default 0)")
    p.add_argument("--staleness-power", type=_nonnegative_float,
                   default=0.5,
                   help="delta discount (1+s)^-p (default 0.5)")
    p.add_argument("--tick-interval", type=_nonnegative_float,
                   default=0.5, metavar="S",
                   help="virtual seconds between engine ticks "
                        "(0 disables the timer; default 0.5)")
    p.add_argument("--flush-every", type=_nonnegative_int, default=0,
                   help="also fire a tick once this many eligible "
                        "updates pend (0 = timer only)")
    p.add_argument("--history-window", type=_nonnegative_int,
                   default=0, metavar="N",
                   help="keep only the newest N per-tick history "
                        "rows (0 = unbounded, the determinism "
                        "artifact; set for long-running servers)")
    p.add_argument("--rate-limit", type=_nonnegative_float,
                   default=0.0,
                   help="token-bucket admission rate in updates per "
                        "virtual second (0 = off)")
    p.add_argument("--rate-burst", type=_positive_float, default=64.0,
                   help="token-bucket burst capacity (default 64)")
    p.add_argument("--max-pending", type=_nonnegative_int, default=0,
                   help="reject_backpressure once this many admitted "
                        "updates await incorporation (0 = off)")
    p.add_argument("--stale-deprioritize", type=_nonnegative_int,
                   default=4,
                   help="versions behind at which an update is "
                        "deprioritized (default 4)")
    p.add_argument("--stale-reject", type=_nonnegative_int,
                   default=16,
                   help="versions behind at which an update is "
                        "rejected (default 16)")
    p.add_argument("--screen", action="store_true",
                   help="enable streaming update screening: non-finite "
                        "guard, norm-vs-rolling-median, and cosine "
                        "tests reject poisoned arrivals on the device "
                        "before the K-buffer")
    p.add_argument("--screen-norm-mult", type=_positive_float,
                   default=4.0,
                   help="screen when an update's norm exceeds this "
                        "multiple of the rolling median of accepted "
                        "norms (default 4)")
    p.add_argument("--screen-cos-min", type=float, default=-0.2,
                   help="screen when cosine against the server "
                        "direction falls below this (in [-1, 1); "
                        "default -0.2)")
    p.add_argument("--screen-warmup", type=_positive_int, default=8,
                   help="accepted-norm samples before the norm test "
                        "arms (default 8)")
    p.add_argument("--screen-clip-norm", type=_nonnegative_float,
                   default=0.0,
                   help="also clip accepted update norms to this bound "
                        "(0 = off)")
    p.add_argument("--quarantine-strikes", type=_positive_int,
                   default=3,
                   help="screened strikes before a user id is "
                        "quarantined (default 3)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="drain-time (and periodic) serving "
                        "checkpoints land here; required for "
                        "--resume")
    p.add_argument("--checkpoint-every-ticks", type=_nonnegative_int,
                   default=0,
                   help="also checkpoint every N engine ticks "
                        "(0 = drain-time only)")
    p.add_argument("--resume", action="store_true",
                   help="restore serving state (engine + pending "
                        "queue + history) from --checkpoint-dir")
    p.add_argument("--history", default=None, metavar="JSONL",
                   help="write the per-tick metric history here at "
                        "drain — the bitwise-determinism artifact")
    p.add_argument("--events", default=None, metavar="JSONL",
                   help="telemetry events sink (read back by 'report' and "
                        "'timeline'); a gateway fleet member writes "
                        "<events>.g<i>")
    p.add_argument("--heartbeat", default=None, metavar="FILE",
                   help="liveness heartbeat file, rewritten at every loop "
                        "wakeup (a gateway writes its per-member path)")
    p.add_argument("--once", action="store_true",
                   help="exit cleanly (drain + checkpoint) after "
                        "the first client connection closes — "
                        "bounded smoke runs")
    p.add_argument("--seed", type=_nonnegative_int, default=0,
                   help="engine init / synthetic-shard seed")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the GPU; cpu = the plain versions "
                        "on the CPU")
    p.add_argument("--json", action="store_true",
                   help="print the drain summary as one JSON line")
    p.add_argument("--quiet", action="store_true",
                   help="suppress server status lines")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="fedtpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("run", help="run the federated loop")
    _add_common_overrides(p)
    # run-only, as in fedtpu: the sweep has its own reduction, init and
    # stop semantics.
    p.add_argument("--aggregation", choices=list(AGGREGATIONS), default=None,
                   help="FedAvg reduction backend (default psum; ring = "
                        "rotate-and-accumulate over the clients mesh, the "
                        "ring kernel on the GPU)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    # run-only, as in fedtpu: the elastic reshard's partition window. A
    # shrunk gang trains --num-clients C as the window [offset, offset+C)
    # of a P-client partition, its shards bitwise the full-width run's.
    p.add_argument("--partition-clients", type=int, default=None,
                   help="shard the dataset as if for this many clients "
                        "and keep only the --num-clients window starting "
                        "at --partition-offset (elastic-reshard data "
                        "layout; default: no window)")
    p.add_argument("--partition-offset", type=_nonnegative_int,
                   default=None,
                   help="first global client row of the partition window "
                        "(requires --partition-clients)")
    p.add_argument("--init-weights", default=None, metavar="NPZ",
                   help="warm-start every client from a saved weights "
                        "artifact (the sweep's --save-weights output); "
                        "architecture must match")
    p.add_argument("--pipelined-stop", action="store_true",
                   help="overlap metric processing with the next chunk; "
                        "stop decisions lag one chunk (the recorded history "
                        "stays identical)")
    p.add_argument("--personalize-steps", type=_positive_int, default=None,
                   help="post-training per-client fine-tuning steps from "
                        "the final global model (personalized metrics in "
                        "the summary)")
    # run-only: the asynchronous FedBuff engine. --rounds counts server
    # ticks; composes with --local-steps/--prox-mu/--server-lr; needs
    # --weighting uniform (the arrival mean is unweighted).
    p.add_argument("--async", dest="async_mode", action="store_true",
                   help="asynchronous FedBuff-style federation: each tick "
                        "a Bernoulli(--arrival-rate) subset of clients "
                        "completes and ships staleness-discounted deltas; "
                        "--rounds counts ticks (needs --weighting uniform)")
    p.add_argument("--arrival-rate", type=_participation_rate, default=None,
                   help="async: per-tick completion probability in (0, 1] "
                        "(default 0.5)")
    p.add_argument("--arrival-seed", type=int, default=None,
                   help="async: seed of the deterministic arrival process "
                        "(default 0)")
    p.add_argument("--staleness-power", type=_nonnegative_float,
                   default=None,
                   help="async: arrival deltas are discounted "
                        "(1+staleness)^-p (default 0.5 = FedBuff's 1/sqrt; "
                        "0 disables discounting)")
    p.add_argument("--buffer-size", type=_nonnegative_int, default=None,
                   help="async: >= 2 selects true FedBuff K-buffer apply "
                        "semantics: the global only moves once this many "
                        "updates sit in the server buffer (default 0 = "
                        "apply every arrival tick)")
    # run-only: the cohort engine (fedtpu_torch.cohort.scheduler).
    # --num-clients is the POPULATION; --cohort-size is how many of them
    # are on the device per round.
    p.add_argument("--cohort-size", type=_positive_int, default=None,
                   help="stream rounds through a sampled cohort of this "
                        "many clients instead of holding all --num-clients "
                        "on the device; per-client state lives in a "
                        "host-side store (plain FedAvg path only; bitwise "
                        "the synchronous engine when equal to "
                        "--num-clients)")
    p.add_argument("--client-store", choices=["memory", "mmap"],
                   default=None,
                   help="cohort store backend: 'memory' (sparse calloc "
                        "pages) or 'mmap' (file-backed, survives as a "
                        "plain binary; default memory)")
    p.add_argument("--client-store-path", default=None, metavar="BIN",
                   help="mmap store backing file (default "
                        "<checkpoint-dir>/client_store.bin)")
    p.add_argument("--cohort-sampling",
                   choices=["uniform", "weighted", "trace"], default=None,
                   help="cohort sampling policy: uniform, weighted "
                        "(data-size-proportional), or trace (arrival order "
                        "of --cohort-trace)")
    p.add_argument("--cohort-seed", type=int, default=None,
                   help="cohort sampling seed (default 0; resume replays "
                        "the same cohorts)")
    p.add_argument("--cohort-trace", default=None, metavar="JSONL",
                   help="serving trace whose arrival order drives "
                        "--cohort-sampling trace")
    # run-only resilience knobs (fedtpu_torch.resilience).
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="deterministic fault schedule: a JSON file path or "
                        "inline JSON object (seeded; fedtpu's schema)")
    p.add_argument("--on-divergence", choices=["halt", "rollback"],
                   default=None,
                   help="non-finite guard policy: 'halt' (quarantine + "
                        "stop, the default) or 'rollback' (restore the "
                        "latest good checkpoint and retry; needs "
                        "--checkpoint-dir and --checkpoint-every)")
    p.add_argument("--rollback-retries", type=_nonnegative_int,
                   default=None,
                   help="rollback retry budget for the whole run "
                        "(default 2); exhausted -> halt as usual")
    p.add_argument("--rollback-exclude", action="store_true",
                   help="on rollback, permanently exclude the offending "
                        "client(s) from aggregation (mask weight 0; needs "
                        "--weighting data_size)")
    p.add_argument("--rollback-perturb", type=_nonnegative_float,
                   default=None,
                   help="relative parameter perturbation applied from the "
                        "SECOND rollback retry on (default 1e-6; the first "
                        "retry is always a pure replay)")
    p.add_argument("--heartbeat", default=None, metavar="FILE",
                   help="liveness heartbeat file the loop rewrites "
                        "atomically every chunk ('supervise "
                        "--hang-timeout' watches its mtime)")
    p.add_argument("--collective-timeout", type=_nonnegative_float,
                   default=None, metavar="SECONDS",
                   help="multi-process watchdog: abort with exit 75 "
                        "(restartable) when a blocking collective/fetch "
                        "stalls past this many seconds — a hung peer "
                        "becomes a gang restart, never a deadlock. Set it "
                        "above EVERY guarded phase's worst-case healthy "
                        "duration: the chunk walltime AND the collective "
                        "checkpoint save, which scales with model size (0 "
                        "disables)")
    p.add_argument("--max-restarts", type=_positive_int, default=None,
                   help="self-supervise: run as a child process "
                        "auto-restarted with --resume up to N times on "
                        "crash/preemption (shorthand for 'supervise -- run "
                        "...')")

    s = sub.add_parser("sweep", help="federated hyperparameter grid")
    _add_common_overrides(s)
    s.add_argument("--no-vmap-lr", action="store_true",
                   help="one launch per learning rate instead of every "
                        "rate in one launch (parity-check path)")
    s.add_argument("--table-jsonl", default=None,
                   help="write the full per-config result table here, one "
                        "JSON line per config (the reference only prints "
                        "the best, hyperparameters_tuning.py:126)")
    s.add_argument("--save-weights", default=None, metavar="NPZ",
                   help="persist the winning config's post-averaging "
                        "weights + hyperparameters + metrics as an .npz "
                        "(fedtpu's format; the reference only prints them, "
                        "hyperparameters_tuning.py:130-132)")
    s.add_argument("--no-vmap-arch", action="store_true",
                   help="one launch per architecture instead of one per "
                        "depth class (the default runs the 90-config grid "
                        "as 2 launches; parity-check path)")
    s.add_argument("--no-bucket-pad", action="store_true",
                   help="run each architecture at its own dims instead of "
                        "zero-padding it to its depth class's max dims "
                        "(the pad is exact)")
    s.add_argument("--no-overlap-compile", action="store_true",
                   help="accepted for fedtpu's command lines; the port "
                        "compiles no program, so it changes nothing")
    s.add_argument("--plateau-stop", action="store_true",
                   help="sklearn-faithful local fits: treat the step "
                        "budget as a cap and stop each (client, lr) fit "
                        "once its loss plateaus (tol 1e-4, 10 epochs)")

    parity_p = sub.add_parser("parity",
                              help="sklearn warm-start limitation demo")
    _add_common_overrides(parity_p)
    sub.add_parser("presets", help="list shipped presets")

    # Serving front-end: a long-running ingestion process feeding the
    # driven asynchronous tick from traced arrivals (fedtpu_torch.serving).
    serve_p = sub.add_parser("serve",
                             help="trace-driven FL serving front-end: "
                                  "accept streamed client updates over a "
                                  "localhost socket, admission-control "
                                  "them, and drive async FedBuff ticks")
    _add_serving_flags(serve_p)

    # Gateway fleet: N serve-shaped processes, each owning the id-shard
    # of clients matching its store shard, with redirect routing and the
    # flush/adopt shard-failover ops (fedtpu_torch.serving.gateway). Every
    # shared path below is a BASE each member derives its own file/subdir
    # from, so the fleet shares one command line.
    gateway_p = sub.add_parser("gateway",
                               help="one member of a fault-tolerant "
                                    "multi-gateway ingestion fleet: serve "
                                    "plus id-shard routing, redirects, "
                                    "and store-shard failover")
    _add_serving_flags(gateway_p)
    gateway_p.add_argument("--num-gateways", type=_positive_int, default=1,
                           help="fleet size N; this process owns users "
                                "with id %% N == its index (default 1)")
    gateway_p.add_argument("--gateway-index", type=_nonnegative_int,
                           default=None,
                           help="this member's index (default: the gang's "
                                "FEDTPU_PROCESS_ID, so a supervised fleet "
                                "needs no per-member flags)")
    gateway_p.add_argument("--total-users", type=_nonnegative_int,
                           default=0,
                           help="attach a per-user state store over this "
                                "population, sharded to the fleet "
                                "(0 = no store; required for adopt)")
    gateway_p.add_argument("--store", choices=["memory", "mmap"],
                           default="memory",
                           help="store backend (default memory)")
    gateway_p.add_argument("--store-path", default=None, metavar="FILE",
                           help="mmap backing file base path (each member "
                                "appends .g<i>)")

    # Load generation: replay (or synthesize) an arrival trace against a
    # running server; it never touches the card.
    load_p = sub.add_parser("loadgen",
                            help="replay a heavy-tailed arrival trace "
                                 "against a running 'serve' "
                                 "(fedtpu's docs/serving.md)")
    load_p.add_argument("trace", help="arrival-trace JSONL path "
                                      "(serving.traces schema v1/v2)")
    load_p.add_argument("--synthesize", action="store_true",
                        help="first write a fresh synthetic trace to the "
                             "given path (--users/--arrivals/--horizon/"
                             "--trace-seed), then replay it")
    load_p.add_argument("--users", type=_positive_int, default=1000000,
                        help="simulated user population for --synthesize "
                             "(default 1e6)")
    load_p.add_argument("--arrivals", type=_positive_int, default=100000,
                        help="arrival events for --synthesize "
                             "(default 1e5)")
    load_p.add_argument("--horizon", type=_positive_float, default=60.0,
                        help="virtual-time horizon in seconds for "
                             "--synthesize (default 60)")
    load_p.add_argument("--trace-seed", type=_nonnegative_int, default=0,
                        help="synthesizer seed (default 0)")
    load_p.add_argument("--poison-frac", type=_nonnegative_float,
                        default=0.0,
                        help="for --synthesize: fraction of users that "
                             "are seeded attackers (schema v2 adversarial "
                             "trace; 0 = honest v1 trace, the default)")
    load_p.add_argument("--poison-scale", type=_positive_float,
                        default=10.0,
                        help="sign-flip amplification the attackers "
                             "submit (default 10)")
    load_p.add_argument("--host", default="127.0.0.1")
    load_p.add_argument("--port", type=_nonnegative_int, default=None,
                        help="server port (or use --port-file)")
    load_p.add_argument("--port-file", default=None, metavar="FILE",
                        help="poll this file (written by serve "
                             "--port-file) for the port")
    load_p.add_argument("--batch", type=_positive_int, default=1024,
                        help="arrivals per protocol frame (default 1024)")
    load_p.add_argument("--num-gateways", type=_positive_int, default=1,
                        help="route through a gateway fleet of this size "
                             "(--port-file is then the fleet's BASE path; "
                             "default 1)")
    load_p.add_argument("--retries", type=_nonnegative_int, default=8,
                        help="per-frame retry attempts against a dying/"
                             "restarting gateway before giving up "
                             "(default 8)")
    load_p.add_argument("--retry-backoff", type=_positive_float,
                        default=0.05,
                        help="base of the capped exponential retry "
                             "backoff in seconds (default 0.05)")
    load_p.add_argument("--max-events", type=_nonnegative_int, default=0,
                        help="truncate the replay after this many events "
                             "(0 = whole trace)")
    load_p.add_argument("--no-drain", action="store_true",
                        help="skip the final drain+stats round-trip")
    load_p.add_argument("--timeout", type=_positive_float, default=120.0,
                        help="socket/port-file timeout in seconds")
    load_p.add_argument("--json", action="store_true",
                        help="print the replay summary as one JSON line")
    load_p.add_argument("--quiet", action="store_true",
                        help="suppress the human-readable summary")

    # SLO-driven autoscaling control plane (fedtpu_torch.autoscale). It
    # never touches the card: signals come over the serve socket +
    # heartbeat files, actions go out as protocol ops and signals.
    auto_p = sub.add_parser("autoscale",
                            help="SLO-driven autoscaling control plane: "
                                 "fold live signals into decisions and "
                                 "act through the reshard/serving knobs")
    auto_p.add_argument("--simulate", action="store_true",
                        help="replay a seeded bursty trace against the "
                             "policy in pure virtual time instead of "
                             "attaching to a live deployment; the decision "
                             "sequence is a bitwise-comparable artifact")
    auto_p.add_argument("--trace", default=None, metavar="JSONL",
                        help="simulate against this arrival trace instead "
                             "of the pinned synthetic one (the pinned one "
                             "is the golden contract)")
    auto_p.add_argument("--golden", default=None, metavar="PATH",
                        help="compare the simulated decision sequence "
                             "bitwise against this golden JSONL; any "
                             "divergence fails the command")
    auto_p.add_argument("--out", default=None, metavar="PATH",
                        help="write the decision sequence JSONL here "
                             "(golden (re)generation)")
    auto_p.add_argument("--policy", default="threshold",
                        help="policy name from the registry "
                             "(default threshold)")
    auto_p.add_argument("--objective", type=_positive_float, default=None,
                        metavar="S",
                        help="SLO objective on update-to-incorporation "
                             "latency in virtual seconds (default 1.0)")
    auto_p.add_argument("--error-budget", type=_positive_float,
                        default=None,
                        help="share of updates allowed past the objective "
                             "(burn 1.0 = budget exactly consumed; "
                             "default 0.1)")
    auto_p.add_argument("--interval", type=_positive_float, default=None,
                        metavar="S",
                        help="control-loop interval (default 0.5; live "
                             "mode polls at this wall-clock cadence, "
                             "simulation ticks this much virtual time)")
    auto_p.add_argument("--host", default="127.0.0.1",
                        help="live: serve host (default 127.0.0.1)")
    auto_p.add_argument("--port", type=_nonnegative_int, default=0,
                        help="live: serve port (or use --port-file; "
                             "0 = no serving signals/actions)")
    auto_p.add_argument("--port-file", default=None, metavar="FILE",
                        help="live: poll this file (written by serve "
                             "--port-file) for the port")
    auto_p.add_argument("--heartbeat", default=None, metavar="FILE",
                        help="live: gang heartbeat base path (per-process "
                             "files <base>.p<i>) for membership signals")
    auto_p.add_argument("--num-processes", type=_positive_int, default=1,
                        help="live: gang size behind --heartbeat")
    auto_p.add_argument("--supervisor-pid", type=_nonnegative_int,
                        default=0, metavar="PID",
                        help="live: 'fedtpu supervise' parent to signal "
                             "for grow/shrink (SIGUSR2/SIGUSR1; 0 = no "
                             "gang actions)")
    auto_p.add_argument("--notice-file", default=None, metavar="FILE",
                        help="live: poll this JSON file ({\"victim\": p}) "
                             "for preemption notices; each payload is "
                             "acted on once (pre-drain + shrink)")
    auto_p.add_argument("--spool-path", default=None, metavar="FILE",
                        help="live: where the server spools pending "
                             "updates on pre-drain (default: its "
                             "checkpoint dir)")
    auto_p.add_argument("--duration", type=_nonnegative_float, default=0.0,
                        metavar="S",
                        help="live: stop after this many wall seconds "
                             "(0 = until interrupted)")
    auto_p.add_argument("--stop-after-notice", action="store_true",
                        help="live: exit once a preemption notice has "
                             "been acted on (chaos drill mode)")
    auto_p.add_argument("--events", default=None, metavar="JSONL",
                        help="telemetry events sink (decision/act events; "
                             "read back by 'report' and 'timeline')")
    auto_p.add_argument("--json", action="store_true",
                        help="print the summary as one JSON line")
    auto_p.add_argument("--quiet", action="store_true",
                        help="suppress status lines")

    # Offline readers of a telemetry sink: no preset, no card (numpy and
    # the standard library only).
    report_p = sub.add_parser("report",
                              help="aggregate a telemetry events JSONL "
                                   "(phase breakdown, round cadence, "
                                   "staleness, counters)")
    report_p.add_argument("events", nargs="+",
                          help="events JSONL path(s) written via --events; "
                               "several sinks (serve + gang + controller) "
                               "merge into one combined view plus a "
                               "per-source admission/SLO breakdown")
    report_p.add_argument("--format", choices=["text", "json"],
                          default="text",
                          help="report rendering (default text)")
    report_p.add_argument("--prometheus", default=None, metavar="PATH",
                          help="also write a Prometheus text-exposition "
                               "snapshot of the aggregated log here")
    report_p.add_argument("--heartbeat", default=None, metavar="FILE",
                          help="supervisor heartbeat base path: adds live "
                               "per-process status rows (serving/parked/"
                               "stale/missing) to the resilience section")
    report_p.add_argument("--num-processes", type=_positive_int, default=1,
                          help="gang size for --heartbeat (per-process "
                               "files <base>.p<i>; default 1)")
    # Process supervision: restart on crash/preemption with --resume. The
    # parent imports neither torch nor numpy: it only starts children, so
    # a restart never holds a second CUDA context on the card.
    sup_p = sub.add_parser("supervise",
                           help="run a command of this CLI as a supervised "
                                "child: auto-restart with --resume on "
                                "crash/preemption")
    sup_p.add_argument("--num-processes", type=_positive_int, default=1,
                       help="launch the child as a gang of N processes "
                            "torn down and relaunched as a unit (a 'run' "
                            "training gang over torch.distributed, or a "
                            "gateway fleet)")
    sup_p.add_argument("--max-restarts", type=_nonnegative_int, default=2,
                       help="restart budget (default 2); divergence "
                            "(exit 3) is never restarted")
    sup_p.add_argument("--backoff", type=_nonnegative_float, default=1.0,
                       help="crash-restart backoff base in seconds, "
                            "doubled per restart (default 1.0; preemption "
                            "restarts — exit 75 — skip backoff)")
    sup_p.add_argument("--backoff-max", type=_nonnegative_float,
                       default=30.0,
                       help="backoff ceiling in seconds (default 30)")
    sup_p.add_argument("--grace", type=_nonnegative_float, default=15.0,
                       help="seconds a SIGTERM'd child gets to drain its "
                            "checkpoint before SIGKILL (default 15)")
    sup_p.add_argument("--healthy-window", type=_nonnegative_float,
                       default=300.0,
                       help="a child that stays up this many seconds is "
                            "considered healthy again: the crash streak "
                            "driving exponential backoff resets (default "
                            "300; 0 never resets)")
    sup_p.add_argument("--hang-timeout", type=_nonnegative_float,
                       default=None,
                       help="SIGKILL + restart the child when its "
                            "--heartbeat file goes stale for this many "
                            "seconds (default: no hang detection)")
    sup_p.add_argument("--heartbeat", default=None, metavar="FILE",
                       help="heartbeat file (auto-appended to 'run' "
                            "children; required for --hang-timeout)")
    sup_p.add_argument("--events", default=None, metavar="JSONL",
                       help="append supervisor events (child_start/"
                            "child_exit/restart) to this sink — point it "
                            "at the child's --events file for one merged "
                            "timeline")
    sup_p.add_argument("--quiet", action="store_true",
                       help="suppress supervisor status lines")
    sup_p.add_argument("child", nargs=argparse.REMAINDER,
                       help="the supervised command, after '--': e.g. "
                            "supervise -- run --rounds 100 "
                            "--checkpoint-dir d --checkpoint-every 10")

    # The chaos drill: the scenario matrix end to end, every scenario run
    # a child process; the parent stays torch-free like supervise.
    from fedtpu_torch.resilience.chaos import scenarios_help
    chaos_p = sub.add_parser("chaos",
                             help="execute the resilience scenario matrix "
                                  "(kill/preempt/NaN/dropout/straggler) "
                                  "and report per-scenario recovery")
    chaos_p.add_argument("--scenarios", default=None, metavar="A,B",
                         help=scenarios_help())
    chaos_p.add_argument("--rounds", type=_positive_int, default=10,
                         help="rounds per scenario run (default 10)")
    chaos_p.add_argument("--num-clients", type=_positive_int, default=4,
                         help="synthetic clients per run (default 4)")
    chaos_p.add_argument("--hidden-sizes", type=_hidden_sizes,
                         default=(16,),
                         help="the runs' hidden widths (default 16, "
                              "fedtpu's; 50,200 is the income presets' "
                              "full width)")
    chaos_p.add_argument("--synthetic-rows", type=_positive_int,
                         default=None,
                         help="the runs' synthetic rows (default: the "
                              "preset's)")
    chaos_p.add_argument("--workdir", default=None, metavar="DIR",
                         help="scenario artifact directory (default: a "
                              "temp dir, removed unless --keep-artifacts)")
    chaos_p.add_argument("--keep-artifacts", action="store_true",
                         help="keep per-scenario checkpoints/metrics/"
                              "events for inspection")
    chaos_p.add_argument("--timeout", type=_positive_int, default=600,
                         help="per-child-run timeout in seconds "
                              "(default 600)")
    chaos_p.add_argument("--platform", choices=["default", "cpu"],
                         default="default",
                         help="platform for the child runs (default: the "
                              "GPU; cpu runs the plain versions)")
    chaos_p.add_argument("--json", action="store_true",
                         help="print the matrix report as one JSON line")
    chaos_p.add_argument("--quiet", action="store_true",
                         help="suppress per-scenario progress lines")

    # Compositional chaos fuzzing: seeded multi-fault campaigns against
    # the deterministic in-process gang, judged by the oracle library,
    # failures ddmin-shrunk to committed reproducers
    # (fedtpu_torch.resilience.fuzz).
    fuzz_p = sub.add_parser("fuzz",
                            help="sample seeded COMPOSED fault campaigns "
                                 "(process + wire + lifecycle + poison) "
                                 "and replay each against a deterministic "
                                 "two-gateway gang, judged by the "
                                 "invariant-oracle library; failing "
                                 "campaigns are delta-debugged to minimal "
                                 "reproducers")
    fuzz_p.add_argument("--budget", type=_positive_int, default=25,
                        help="campaigns to sample and replay (default 25)")
    fuzz_p.add_argument("--seed", type=int, default=0,
                        help="campaign-generator seed (default 0): the "
                             "run is a pure function of (seed, budget)")
    fuzz_p.add_argument("--rounds", type=_positive_int, default=8,
                        help="virtual rounds per campaign (default 8)")
    fuzz_p.add_argument("--campaign", default=None, metavar="SPEC",
                        help="replay ONE campaign instead of sampling: a "
                             "manifest path or inline JSON (digest "
                             "verified when present)")
    fuzz_p.add_argument("--shrink-to", default=None, metavar="DIR",
                        help="write each failing campaign's ddmin-minimal "
                             "reproducer + bitwise verdict golden under "
                             "DIR (the tests/corpus layout)")
    fuzz_p.add_argument("--no-shrink", action="store_true",
                        help="report failures without delta-debugging "
                             "them")
    fuzz_p.add_argument("--events", default=None, metavar="PATH",
                        help="append one fuzz_campaign event per campaign "
                             "(plus the fuzz_run summary) to this JSONL "
                             "for 'report'")
    fuzz_p.add_argument("--platform", choices=["default", "cpu"],
                        default="default",
                        help="the gang's engines: default = the GPU; cpu "
                             "= the plain versions on the CPU")
    fuzz_p.add_argument("--json", action="store_true",
                        help="print the fuzz report as one JSON line")

    # Runtime probe: drives the real round step under the recompile
    # sentinel + transfer guard (fedtpu_torch.analysis), with folds.
    check_p = sub.add_parser("check",
                             help="prove the round step replays without a "
                                  "recapture (recompile sentinel + "
                                  "transfer guard)")
    check_p.add_argument("--preset", default="income-8",
                         choices=sorted(PRESETS))
    check_p.add_argument("--rounds", type=_positive_int, default=4,
                         help="steady-state steps to drive while armed "
                              "(default 4)")
    check_p.add_argument("--transfer-guard",
                         choices=["allow", "log", "disallow"], default="log",
                         help="torch.cuda.set_sync_debug_mode level (0, 1, "
                              "2) around the armed replays (default log); "
                              "does not apply on the CPU")
    check_p.add_argument("--debug-nans", action="store_true",
                         help="also check every state tensor for "
                              "finiteness after each armed step, naming "
                              "the first non-finite one")
    check_p.add_argument("--synthetic-rows", type=_positive_int, default=512,
                         help="synthetic dataset size (the check probes "
                              "capture behavior, not accuracy)")
    check_p.add_argument("--platform", choices=["default", "cpu"],
                         default="default",
                         help="default = the GPU; cpu = the plain versions "
                              "on the CPU")
    check_p.add_argument("--json", action="store_true",
                         help="print the check report as one JSON line")
    check_p.add_argument("--warmup-cache", default=None, metavar="DIR",
                         help="fedtpu's persistent compilation cache "
                              "(not ported yet: ROADMAP A11c)")
    check_p.add_argument("--audit", action="store_true",
                         help="fedtpu's static side, lint and the program "
                              "audit (not ported yet: ROADMAP A11d)")
    check_p.add_argument("--mpmd", action="store_true",
                         help="fedtpu's MPMD parity probe (not ported yet: "
                              "ROADMAP A10c)")
    check_p.add_argument("--autoscale-sim", default=None, metavar="GOLDEN",
                         help="also replay the pinned autoscale "
                              "simulation and compare its decision "
                              "sequence bitwise against this golden "
                              "JSONL, folded into the exit code")
    check_p.add_argument("--defense-sim", default=None, metavar="GOLDEN",
                         help="also replay the pinned poisoning-defense "
                              "simulation (screening engine over a seeded "
                              "adversarial trace) and compare its decision "
                              "log bitwise against this golden JSONL, "
                              "folded into the exit code")
    check_p.add_argument("--net-sim", default=None, metavar="GOLDEN",
                         help="also replay the pinned wire-fault "
                              "campaign (NetFaultPlan through the real "
                              "engine/session machinery) and compare "
                              "its decision log bitwise against this "
                              "golden JSONL, folded into the exit code")
    check_p.add_argument("--timeline-sim", default=None, metavar="GOLDEN",
                         help="also replay the pinned two-gateway causal "
                              "trace campaign and compare the merged "
                              "deterministic timeline bitwise against "
                              "this golden JSONL, folded into the exit "
                              "code")
    check_p.add_argument("--gateway-probe", default=None,
                         metavar="PORT_FILE_BASE",
                         help="also probe a live gateway fleet's health "
                              "over its port-file base (each member "
                              "answers a stats round-trip), folded into "
                              "the exit code")
    check_p.add_argument("--gateway-count", type=_positive_int, default=1,
                         help="fleet size for --gateway-probe (default 1)")
    check_p.add_argument("--lockdep", action="store_true",
                         help="fedtpu's lock-order sanitizer drills (not "
                              "ported yet: ROADMAP A11d)")
    check_p.add_argument("--lockdep-golden", default=None, metavar="GOLDEN",
                         help="golden lock graph for --lockdep")
    check_p.add_argument("--fuzz-corpus", default=None, metavar="DIR",
                         nargs="?", const="tests/corpus",
                         help="also replay every committed fuzz campaign "
                              "under DIR (default tests/corpus): digest "
                              "must match the entries, every oracle must "
                              "pass, two same-seed runs must be bitwise, "
                              "and the verdict artifact must match its "
                              "committed golden — folded into the exit "
                              "code")

    timeline_p = sub.add_parser(
        "timeline",
        help="merge events JSONL sinks + netproxy *.netlog + autoscale "
             "decision logs into one causal fleet timeline "
             "(deterministic JSONL or Chrome/Perfetto trace JSON)")
    timeline_p.add_argument(
        "artifacts", nargs="+",
        help="events JSONL path(s), *.netlog proxy logs, and/or "
             "autoscale decision JSONL — classified automatically")
    timeline_p.add_argument(
        "--format", choices=["jsonl", "chrome"], default="jsonl",
        help="'jsonl' = deterministic canonical lines (wall-clock-free, "
             "goldenable); 'chrome' = trace-event JSON for Perfetto / "
             "chrome://tracing (default jsonl)")
    timeline_p.add_argument(
        "--output", default=None, metavar="PATH",
        help="write the rendering here instead of stdout")
    timeline_p.add_argument(
        "--expand", action="store_true",
        help="also pick up sibling fleet artifacts derived from each "
             "events path (*.g<i>, *.p<i>, *.netlog)")
    return parser


def print_presets() -> None:
    """One line a preset, in ``fedtpu presets``' format."""
    for name, preset in sorted(PRESETS.items()):
        print(f"{name}: clients={preset.shard.num_clients} "
              f"model={preset.model.kind}{list(preset.model.hidden_sizes)} "
              f"rounds={preset.fed.rounds} weighting={preset.fed.weighting}")


def config_from_args(args):
    cfg = get_preset(args.preset)
    data, shard, model = cfg.data, cfg.shard, cfg.model
    optim, fed, run = cfg.optim, cfg.fed, cfg.run
    if args.csv is not None:
        # '' selects the synthetic rows; clearing dataset_name lets --csv
        # win over a preset that names a loader (cifar10-32), as in fedtpu.
        data = dataclasses.replace(data, csv_path=args.csv or None,
                                   dataset_name=None)
    if args.label_column is not None:
        data = dataclasses.replace(data, label_column=args.label_column)
    if args.synthetic_rows is not None:
        data = dataclasses.replace(data, synthetic_rows=args.synthetic_rows)
    if args.num_clients is not None:
        shard = dataclasses.replace(shard, num_clients=args.num_clients)
    if args.shard_strategy is not None:
        shard = dataclasses.replace(shard, strategy=args.shard_strategy)
    if getattr(args, "partition_clients", None) is not None:
        shard = dataclasses.replace(shard,
                                    partition_clients=args.partition_clients)
    if getattr(args, "partition_offset", None) is not None:
        shard = dataclasses.replace(shard,
                                    partition_offset=args.partition_offset)
    if args.hidden_sizes is not None:
        model = dataclasses.replace(model, hidden_sizes=args.hidden_sizes)
    if args.compute_dtype is not None:
        model = dataclasses.replace(model, compute_dtype=args.compute_dtype)
    if args.use_pallas:
        model = dataclasses.replace(model, use_pallas=True)
    if args.learning_rate is not None:
        optim = dataclasses.replace(optim, learning_rate=args.learning_rate)
    if args.rounds is not None:
        fed = dataclasses.replace(fed, rounds=args.rounds)
    if args.weighting is not None:
        fed = dataclasses.replace(fed, weighting=args.weighting)
    if args.participation_rate is not None:
        fed = dataclasses.replace(fed,
                                  participation_rate=args.participation_rate)
    if getattr(args, "aggregation", None) is not None:
        fed = dataclasses.replace(fed, aggregation=args.aggregation)
    if args.local_steps is not None:
        fed = dataclasses.replace(fed, local_steps=args.local_steps)
    if args.prox_mu is not None:
        fed = dataclasses.replace(fed, prox_mu=args.prox_mu)
    if getattr(args, "init_weights", None) is not None:
        fed = dataclasses.replace(fed, init_weights_npz=args.init_weights)
    if getattr(args, "personalize_steps", None) is not None:
        fed = dataclasses.replace(fed,
                                  personalize_steps=args.personalize_steps)
    if getattr(args, "async_mode", False):
        fed = dataclasses.replace(fed, async_mode=True)
    elif any(getattr(args, a, None) is not None
             for a in ("arrival_rate", "arrival_seed", "staleness_power",
                       "buffer_size")):
        # These exist only under the tick process: never ignored silently.
        raise SystemExit("--arrival-rate/--arrival-seed/--staleness-power/"
                         "--buffer-size require --async")
    for flag, field in (("arrival_rate", "async_arrival_rate"),
                        ("arrival_seed", "async_arrival_seed"),
                        ("staleness_power", "async_staleness_power"),
                        ("buffer_size", "async_buffer_size")):
        if getattr(args, flag, None) is not None:
            fed = dataclasses.replace(fed, **{field: getattr(args, flag)})
    if getattr(args, "cohort_size", None) is not None:
        fed = dataclasses.replace(fed, cohort_size=args.cohort_size)
    elif any(getattr(args, a, None) is not None
             for a in ("client_store", "client_store_path",
                       "cohort_sampling", "cohort_seed", "cohort_trace")):
        # As the async knobs: a flag of an engine that is off is never
        # ignored silently.
        raise SystemExit("--client-store/--client-store-path/"
                         "--cohort-sampling/--cohort-seed/--cohort-trace "
                         "require --cohort-size")
    for flag in ("client_store", "client_store_path", "cohort_sampling",
                 "cohort_seed", "cohort_trace"):
        if getattr(args, flag, None) is not None:
            fed = dataclasses.replace(fed, **{flag: getattr(args, flag)})
    for flag in ("scaffold", "dp_adaptive_clip"):
        if getattr(args, flag):
            fed = dataclasses.replace(fed, **{flag: True})
    for flag in ("server_opt", "server_lr", "server_momentum", "dp_clip_norm",
                 "dp_noise_multiplier", "dp_delta", "dp_target_quantile",
                 "dp_clip_lr", "dp_count_noise_multiplier", "compress",
                 "robust_aggregation", "trim_ratio", "krum_f",
                 "byzantine_clients"):
        if getattr(args, flag) is not None:
            fed = dataclasses.replace(fed, **{flag: getattr(args, flag)})
    if args.rounds_per_step is not None:
        run = dataclasses.replace(run, rounds_per_step=args.rounds_per_step)
    for flag in ("checkpoint_dir", "checkpoint_every", "keep_checkpoints",
                 "metrics_jsonl"):
        if getattr(args, flag) is not None:
            run = dataclasses.replace(run, **{flag: getattr(args, flag)})
    if getattr(args, "pipelined_stop", False):
        run = dataclasses.replace(run, pipelined_stop=True)
    if args.eval_test_every is not None:
        run = dataclasses.replace(run, eval_test_every=args.eval_test_every)
    if args.profile_dir is not None:
        run = dataclasses.replace(run, profile_dir=args.profile_dir)
    if args.profile_rounds is not None:
        run = dataclasses.replace(run, profile_rounds=args.profile_rounds)
    if args.events is not None:
        run = dataclasses.replace(run, telemetry=dataclasses.replace(
            run.telemetry, events_path=args.events))
    if args.log_per_client:
        run = dataclasses.replace(run, log_per_client=True)
    for flag in ("fault_plan", "on_divergence", "rollback_retries",
                 "rollback_perturb"):
        if getattr(args, flag, None) is not None:
            run = dataclasses.replace(run, **{flag: getattr(args, flag)})
    if getattr(args, "rollback_exclude", False):
        run = dataclasses.replace(run, rollback_exclude=True)
    if getattr(args, "heartbeat", None) is not None:
        run = dataclasses.replace(run, heartbeat_file=args.heartbeat)
    if getattr(args, "collective_timeout", None):
        run = dataclasses.replace(run,
                                  collective_timeout=args.collective_timeout)
    return cfg.replace(data=data, shard=shard, model=model, optim=optim,
                       fed=fed, run=run)


def sweep_main(args, cfg, device: str) -> dict:
    """``fedtpu``'s ``sweep`` handler: the grid (narrowed to one
    architecture / learning rate by ``--hidden-sizes`` /
    ``--learning-rate``), its table and weights artifact."""
    from fedtpu_torch.sweep.grid import run_grid_search, save_best_weights
    # Probe both output paths before the sweep, the weights path before
    # the table file is truncated.
    if args.save_weights:
        open(args.save_weights, "ab").close()
    table_f = open(args.table_jsonl, "w") if args.table_jsonl else None
    grid_kw = {}
    if args.hidden_sizes is not None:
        grid_kw["hidden_grid"] = (tuple(args.hidden_sizes),)
    if args.learning_rate is not None:
        grid_kw["lr_grid"] = (args.learning_rate,)
    if args.local_steps is not None:
        grid_kw["local_steps"] = args.local_steps
    try:
        summary = run_grid_search(
            cfg, vmap_lr=not args.no_vmap_lr, **grid_kw,
            keep_weights=bool(args.save_weights),
            plateau_stop=args.plateau_stop,
            bucket_pad=not args.no_bucket_pad,
            vmap_arch=not args.no_vmap_arch,
            overlap_compile=not args.no_overlap_compile,
            verbose=not args.quiet, device=device)
        if table_f is not None:
            for row in summary["table"]:
                table_f.write(json.dumps(row, default=float) + "\n")
        if args.save_weights:
            save_best_weights(args.save_weights, summary)
            summary.pop("weights", None)
    finally:
        if table_f is not None:
            table_f.close()
    return summary


def loadgen_main(args) -> int:
    """``fedtpu``'s ``loadgen`` handler: optionally synthesize the trace,
    replay it, print the summary."""
    from fedtpu_torch.serving.loadgen import run_loadgen
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    if args.synthesize:
        header, t, user, lat = synthesize_trace(
            users=args.users, arrivals=args.arrivals,
            horizon_s=args.horizon, seed=args.trace_seed,
            poison_frac=args.poison_frac, poison_scale=args.poison_scale)
        write_trace(args.trace, header, t, user, lat)
        if not args.quiet:
            tag = (f" ({args.poison_frac:.0%} poisoned, scale "
                   f"{args.poison_scale:g})" if args.poison_frac > 0 else "")
            print(f"synthesized {args.arrivals} arrivals / {args.users} "
                  f"users over {args.horizon}s{tag} -> {args.trace}")
    summary = run_loadgen(args.trace, host=args.host, port=args.port,
                          port_file=args.port_file, batch=args.batch,
                          max_events=args.max_events,
                          drain=not args.no_drain, timeout=args.timeout,
                          num_gateways=args.num_gateways,
                          retries=args.retries,
                          backoff_s=args.retry_backoff)
    if args.json:
        print(json.dumps(summary, default=float))
    elif not args.quiet:
        print(f"replayed {summary['events_sent']} events in "
              f"{summary['frames']} frames "
              f"({summary['events_per_sec']:.0f} ev/s); "
              f"admission: {summary['admission']}")
        if summary.get("retried") or summary.get("redirected"):
            print(f"delivery: attempted {summary['attempted']}, "
                  f"retried {summary['retried']}, redirected "
                  f"{summary['redirected']}, reconnects "
                  f"{summary['reconnects']}")
    return 0


def serving_config_from_args(args):
    """``fedtpu``'s ``ServingConfig`` of a ``serve`` command line."""
    from fedtpu_torch.config import ServingConfig
    return ServingConfig(
        host=args.host, port=args.port, cohort=args.cohort,
        buffer_size=args.buffer_size, staleness_power=args.staleness_power,
        tick_interval_s=args.tick_interval, flush_every=args.flush_every,
        history_window=args.history_window, rate_limit=args.rate_limit,
        rate_burst=args.rate_burst, max_pending=args.max_pending,
        stale_deprioritize=args.stale_deprioritize,
        stale_reject=args.stale_reject, seed=args.seed, screen=args.screen,
        screen_norm_mult=args.screen_norm_mult,
        screen_cos_min=args.screen_cos_min,
        screen_warmup=args.screen_warmup,
        screen_clip_norm=args.screen_clip_norm,
        quarantine_strikes=args.quarantine_strikes)


def serve_main(args) -> int:
    """``fedtpu``'s ``serve`` handler: serve until the connection closes
    (``--once``) or SIGTERM (drain, checkpoint, exit 75)."""
    from fedtpu_torch.resilience.supervisor import EXIT_PREEMPTED, Preempted
    from fedtpu_torch.serving.server import run_server
    try:
        summary = run_server(
            serving_config_from_args(args), events=args.events,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every_ticks=args.checkpoint_every_ticks,
            port_file=args.port_file, history_path=args.history,
            heartbeat=args.heartbeat, once=args.once, resume=args.resume,
            verbose=not args.quiet, net_fault_plan=args.net_fault_plan,
            device="cpu" if args.platform == "cpu" else "cuda")
    except Preempted as p:
        # SIGTERM drain completed: serving state (engine + pending queue +
        # history) is checkpointed; the supervisor's "restart me" code.
        if args.json:
            print(json.dumps({"preempted": True, "tick": p.round}))
        return EXIT_PREEMPTED
    if args.json:
        print(json.dumps(summary, default=float))
    return 0


def gateway_main(args) -> int:
    """``fedtpu``'s ``gateway`` handler: one fleet member, serve's flags
    plus the fleet's, until the connection closes (``--once``) or SIGTERM
    (drain, checkpoint, exit 75)."""
    from fedtpu_torch.resilience.supervisor import EXIT_PREEMPTED, Preempted
    from fedtpu_torch.serving.gateway import run_gateway
    try:
        summary = run_gateway(
            serving_config_from_args(args), gateway_index=args.gateway_index,
            num_gateways=args.num_gateways, port_file=args.port_file,
            events=args.events, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every_ticks=args.checkpoint_every_ticks,
            history_path=args.history, heartbeat=args.heartbeat,
            total_users=args.total_users, store_backend=args.store,
            store_path=args.store_path, once=args.once, resume=args.resume,
            verbose=not args.quiet, net_fault_plan=args.net_fault_plan,
            device="cpu" if args.platform == "cpu" else "cuda")
    except Preempted as p:
        if args.json:
            print(json.dumps({"preempted": True, "tick": p.round}))
        return EXIT_PREEMPTED
    if args.json:
        print(json.dumps(summary, default=float))
    return 0


def autoscale_main(args) -> int:
    """``fedtpu``'s ``autoscale`` handler: ``--simulate`` replays the
    pinned (or a given) trace against the policy in virtual time; live
    mode attaches a ``LiveController`` to a running server. It never
    touches the card. ``--events`` writes its decisions and acts to a
    telemetry sink."""
    from fedtpu_torch.config import AutoscaleConfig
    from fedtpu_torch.telemetry.trace import make_tracer
    acfg = AutoscaleConfig(policy=args.policy)
    over = {}
    if args.objective is not None:
        over["objective_s"] = args.objective
    if args.error_budget is not None:
        over["error_budget"] = args.error_budget
    if args.interval is not None:
        over["control_interval_s"] = args.interval
    if over:
        acfg = dataclasses.replace(acfg, **over)
    tracer = make_tracer(args.events)
    try:
        return _autoscale(args, acfg, tracer)
    finally:
        tracer.close()


def _autoscale(args, acfg, tracer) -> int:
    from fedtpu_torch.autoscale.controller import (LiveController,
                                                   compare_decisions,
                                                   simulate, write_decisions)
    if args.simulate:
        result = simulate(acfg, trace_path=args.trace, tracer=tracer)
        if args.out:
            write_decisions(args.out, result["lines"])
        ok = True
        if args.golden:
            cmp = compare_decisions(result["lines"], args.golden)
            ok = cmp["ok"]
        if args.json:
            print(json.dumps({**result["summary"], "ok": ok}, default=float))
        elif not args.quiet:
            s = result["summary"]
            print(f"simulated {s['control_ticks']} control tick(s) over "
                  f"{s['arrivals']} arrival(s): admitted {s['admitted']}, "
                  f"incorporated {s['incorporated']}, spooled "
                  f"{s['spooled']}, capacity {s['capacity_end']}, "
                  f"decisions {s['decisions']}")
            if args.out:
                print(f"decisions -> {args.out}")
            if args.golden:
                if ok:
                    print(f"golden: matches {args.golden}")
                else:
                    print(f"golden: {cmp['reason']} vs {args.golden}")
        return 0 if ok else 1
    port = args.port
    if args.port_file:
        from fedtpu_torch.serving.loadgen import read_port_file
        port = read_port_file(args.port_file)
    ctl = LiveController(
        acfg, host=args.host, port=port,
        supervisor_pid=args.supervisor_pid, heartbeat=args.heartbeat,
        process_count=args.num_processes, notice_file=args.notice_file,
        spool_path=args.spool_path, tracer=tracer)
    summary = ctl.run(duration_s=args.duration, interval_s=args.interval,
                      stop_after_notice=args.stop_after_notice)
    if args.json:
        print(json.dumps(summary, default=float))
    elif not args.quiet:
        print(f"autoscale: {summary['control_ticks']} control tick(s) in "
              f"{summary['wall_s']:.1f} s wall; acted {summary['acted']}")
    return 0


def report_main(args) -> int:
    """``fedtpu``'s ``report`` handler: the rendered report on stdout,
    the Prometheus snapshot to ``--prometheus``."""
    from fedtpu_torch.telemetry.report import render_report
    rendered, prom = render_report(args.events, fmt=args.format,
                                   heartbeat=args.heartbeat,
                                   process_count=args.num_processes)
    print(rendered)
    if args.prometheus:
        with open(args.prometheus, "w") as f:
            f.write(prom)
    return 0


def timeline_main(args) -> int:
    """``fedtpu``'s ``timeline`` handler: merge the artifacts (and, with
    ``--expand``, each events path's fleet siblings) and render."""
    from fedtpu_torch.telemetry.timeline import (default_artifacts,
                                                 render_timeline)
    paths = []
    for p in args.artifacts:
        expanded = (default_artifacts(p) if args.expand
                    and not p.endswith(".netlog") else [p])
        for q in expanded:
            if q not in paths:
                paths.append(q)
    rendered = render_timeline(paths, fmt=args.format)
    if args.output:
        with open(args.output, "w") as f:
            f.write(rendered + "\n")
    else:
        print(rendered)
    return 0


def _strip_flag(argv, flag):
    """argv minus ``flag`` (both ``--f V`` and ``--f=V`` spellings)."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == flag:
            skip = True
            continue
        if tok.startswith(flag + "="):
            continue
        out.append(tok)
    return out


def supervise_main(args) -> int:
    """``fedtpu``'s ``supervise`` handler: one child, or a gang of
    ``--num-processes`` members."""
    from fedtpu_torch.resilience.supervisor import supervise
    child = list(args.child)
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        raise SystemExit(
            "supervise: give the child command after '--', e.g. supervise "
            "-- run --rounds 100 --checkpoint-dir d --checkpoint-every 10")
    if args.num_processes > 1:
        from fedtpu_torch.resilience.supervisor import supervise_gang
        return supervise_gang(child, num_processes=args.num_processes,
                              max_restarts=args.max_restarts,
                              backoff_base=args.backoff,
                              backoff_max=args.backoff_max,
                              grace=args.grace,
                              hang_timeout=args.hang_timeout,
                              heartbeat=args.heartbeat, events=args.events,
                              healthy_window=args.healthy_window,
                              verbose=not args.quiet)
    return supervise(child, max_restarts=args.max_restarts,
                     backoff_base=args.backoff, backoff_max=args.backoff_max,
                     grace=args.grace, hang_timeout=args.hang_timeout,
                     heartbeat=args.heartbeat, events=args.events,
                     healthy_window=args.healthy_window,
                     verbose=not args.quiet)


def chaos_main(args) -> int:
    """``fedtpu``'s ``chaos`` handler: every scenario run is a child
    process (``--platform`` applies to the children)."""
    from fedtpu_torch.resilience.chaos import run_chaos
    scenarios = ([s.strip() for s in args.scenarios.split(",") if s.strip()]
                 if args.scenarios else None)
    report = run_chaos(scenarios=scenarios, rounds=args.rounds,
                       num_clients=args.num_clients,
                       hidden_sizes=args.hidden_sizes,
                       synthetic_rows=args.synthetic_rows,
                       workdir=args.workdir,
                       keep_artifacts=args.keep_artifacts,
                       timeout=args.timeout, platform=args.platform,
                       verbose=not args.quiet)
    if args.json:
        print(json.dumps(report, default=float))
    return 0 if report["ok"] else 1


def fuzz_main(args) -> int:
    """``fedtpu``'s ``fuzz`` handler: one campaign (``--campaign``) or a
    sampled run of ``--budget`` campaigns, the gang's engines on
    ``--platform``."""
    from fedtpu_torch.config import FuzzConfig
    from fedtpu_torch.resilience.fuzz import (Campaign, emit_event,
                                              run_campaign, run_fuzz)
    device = "cpu" if args.platform == "cpu" else "cuda"
    fcfg = FuzzConfig(budget=args.budget, seed=args.seed,
                      rounds=args.rounds, shrink=not args.no_shrink)
    if args.campaign:
        c = Campaign.load(args.campaign)
        res = run_campaign(c, cfg=fcfg, device=device)
        if args.events:
            emit_event(args.events, "fuzz_campaign",
                       {"name": c.name, "digest": c.digest,
                        "ok": res["ok"], "failed": res["failed"],
                        "fired": res["summary"]["fired"]})
        if args.json:
            print(json.dumps({"ok": res["ok"], "failed": res["failed"],
                              "verdicts": res["verdicts"],
                              "summary": res["summary"]}, default=float))
        else:
            s = res["summary"]
            print(f"campaign {s['digest']}: "
                  f"{'OK' if res['ok'] else 'VIOLATION'} "
                  f"({len(res['verdicts'])} oracles"
                  + (f"; failed {res['failed']}" if res["failed"] else "")
                  + ")")
            print(f"  admitted {s['client_admitted']}, incorporated "
                  f"{s['incorporated']}, screened {s['screened']}, "
                  f"lost_acked {s['lost_acked']}, retried "
                  f"{s['retried']}, restarts {s['restarts']}")
        return 0 if res["ok"] else 1
    report = run_fuzz(budget=args.budget, seed=args.seed, cfg=fcfg,
                      out_dir=args.shrink_to, events=args.events,
                      shrink=not args.no_shrink, device=device)
    if args.json:
        print(json.dumps(report, default=float))
    else:
        print(f"fuzz seed {report['seed']}: {report['passed']}/"
              f"{report['campaigns']} campaigns passed all oracles")
        for r in report["rows"]:
            if not r["ok"]:
                tail = (f" -> minimized to {r['shrunk_entries']} entries in "
                        f"{r['shrink_runs']} runs" if "minimized" in r
                        else "")
                print(f"  VIOLATION {r['name']} ({r['digest']}): "
                      f"{r.get('failed')}{tail}")
                if "reproducer" in r:
                    print(f"    reproducer: {r['reproducer']}")
    return 0 if report["ok"] else 1


def _golden_fold(report: dict, key: str, golden: str, sim: dict,
                 compare, fields: dict) -> None:
    """Fold one pinned simulation's bitwise golden comparison into the
    check ``report`` (``fedtpu``'s shape: ok, reason, golden and the
    summary ``fields``)."""
    cmp = compare(sim["lines"], golden)
    report[key] = {"ok": cmp["ok"], "reason": cmp["reason"],
                   "golden": golden, **fields}
    report["ok"] = report["ok"] and cmp["ok"]


def check_main(args) -> int:
    """``fedtpu``'s ``check`` handler: the runtime probe, then each fold
    asked for, all in one exit code. The folds that are not ported refuse
    before any work, naming their ROADMAP item."""
    from fedtpu_torch.config import _not_ported
    for flag, item in (("warmup_cache", "A11c"), ("audit", "A11d"),
                       ("mpmd", "A10c"), ("lockdep", "A11d")):
        if getattr(args, flag):
            _not_ported(f"check --{flag.replace('_', '-')}", item)
    from fedtpu_torch.analysis.check import run_check
    device = "cpu" if args.platform == "cpu" else "cuda"
    report = run_check(preset=args.preset, rounds=args.rounds,
                       transfer=args.transfer_guard, nans=args.debug_nans,
                       synthetic_rows=args.synthetic_rows, device=device)
    if args.autoscale_sim:
        from fedtpu_torch.autoscale.controller import (compare_decisions,
                                                       simulate)
        sim = simulate()
        _golden_fold(report, "autoscale_sim", args.autoscale_sim, sim,
                     compare_decisions,
                     {"control_ticks": sim["summary"]["control_ticks"]})
    if args.defense_sim:
        from fedtpu_torch.robust.defense_sim import (compare_decisions,
                                                     simulate)
        sim = simulate(device=device)
        s = sim["summary"]
        _golden_fold(report, "defense_sim", args.defense_sim, sim,
                     compare_decisions,
                     {k: s[k] for k in ("screened", "quarantined",
                                        "quarantined_honest",
                                        "eval_accuracy")})
    if args.net_sim:
        from fedtpu_torch.resilience.net_sim import (compare_decisions,
                                                     simulate)
        sim = simulate(device=device)
        s = sim["summary"]
        _golden_fold(report, "net_sim", args.net_sim, sim, compare_decisions,
                     {k: s[k] for k in ("wire_frames", "incorporated",
                                        "duplicate_drops", "lost_acked")})
    if args.timeline_sim:
        from fedtpu_torch.telemetry.timeline_sim import (compare_decisions,
                                                         simulate)
        sim = simulate(device=device)
        s = sim["summary"]
        _golden_fold(report, "timeline_sim", args.timeline_sim, sim,
                     compare_decisions,
                     {k: s[k] for k in ("chains", "retry_duplicate",
                                        "retry_stages", "incorporated")})
    if args.gateway_probe:
        from fedtpu_torch.serving.gateway import probe_fleet
        rows = probe_fleet(args.gateway_probe, args.gateway_count)
        report["gateway_probe"] = rows
        report["ok"] = report["ok"] and all(r["ok"] for r in rows)
    if args.fuzz_corpus:
        from fedtpu_torch.resilience.fuzz import run_corpus
        fc = run_corpus(args.fuzz_corpus, device=device)
        report["fuzz_corpus"] = fc
        report["ok"] = report["ok"] and fc["ok"]
    if args.json:
        print(json.dumps(report))
    else:
        for key in ("preset", "backend", "device_count", "rounds",
                    "transfer_guard", "transfer_guard_applies",
                    "debug_nans", "nonfinite", "sentinel_available",
                    "recompiles", "armed_s_per_round"):
            print(f"{key}: {report[key]}")
        if "autoscale_sim" in report:
            a = report["autoscale_sim"]
            print(f"autoscale-sim: ok={a['ok']} ({a['reason']})")
        if "defense_sim" in report:
            d = report["defense_sim"]
            print(f"defense-sim: ok={d['ok']} ({d['reason']}) "
                  f"quarantined={d['quarantined']} "
                  f"honest={d['quarantined_honest']} "
                  f"accuracy={d['eval_accuracy']:.4f}")
        if "net_sim" in report:
            n = report["net_sim"]
            print(f"net-sim: ok={n['ok']} ({n['reason']}) "
                  f"frames={n['wire_frames']} "
                  f"incorporated={n['incorporated']} "
                  f"dups={n['duplicate_drops']} "
                  f"lost_acked={n['lost_acked']}")
        if "timeline_sim" in report:
            t = report["timeline_sim"]
            print(f"timeline-sim: ok={t['ok']} ({t['reason']}) "
                  f"chains={t['chains']} "
                  f"retry_duplicate={t['retry_duplicate']}")
        for r in report.get("gateway_probe", []):
            state = "up" if r["ok"] else r.get("error", "unreachable")
            print(f"gateway {r['gateway']}: {state}")
        if "fuzz_corpus" in report:
            fc = report["fuzz_corpus"]
            print(f"fuzz-corpus: ok={fc['ok']} campaigns={fc['campaigns']} "
                  f"({fc['corpus']})")
            for r in fc["rows"]:
                if not r["ok"]:
                    print(f"  {r['name']}: {r['reason']}")
        print(f"ok: {report['ok']}")
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    # The raw argv is kept so that `run --max-restarts N` can re-issue this
    # invocation as a supervised child, the flag stripped.
    raw_argv = list(argv) if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(raw_argv)
    if args.command == "presets":
        print_presets()
        return 0
    if args.command == "report":
        return report_main(args)
    if args.command == "timeline":
        return timeline_main(args)
    if args.command == "loadgen":
        return loadgen_main(args)
    if args.command == "serve":
        return serve_main(args)
    if args.command == "gateway":
        return gateway_main(args)
    if args.command == "autoscale":
        return autoscale_main(args)
    if args.command == "supervise":
        return supervise_main(args)
    if args.command == "chaos":
        return chaos_main(args)
    if args.command == "fuzz":
        return fuzz_main(args)
    if args.command == "check":
        return check_main(args)
    if args.command == "run" and args.max_restarts:
        # Self-supervision: this run as a supervised child; stripping the
        # flag keeps the child from starting another supervisor.
        from fedtpu_torch.resilience.supervisor import supervise
        return supervise(_strip_flag(raw_argv, "--max-restarts"),
                         max_restarts=args.max_restarts,
                         heartbeat=args.heartbeat, events=args.events,
                         verbose=not args.quiet)
    from fedtpu_torch.resilience.distributed import ENV_COORDINATOR
    gang = None
    if args.command == "run":
        # A member of a gang that `supervise --num-processes N` launched
        # joins it before anything touches the device.
        from fedtpu_torch.parallel import multihost
        gang = multihost.initialize_from_env(args.platform)
    elif os.environ.get(ENV_COORDINATOR):
        from fedtpu_torch.config import _not_ported
        _not_ported(f"{args.command} in a training gang", "A10d")
    cfg = config_from_args(args)
    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.command in ("sweep", "parity"):
        if args.command == "sweep":
            summary = sweep_main(args, cfg, device)
        else:
            # Part A (the numpy MLPClassifier) runs on the host, part B
            # (the port's round) on ``device``.
            from fedtpu_torch.parity.sklearn_warmstart import run_parity_demo
            summary = run_parity_demo(cfg, verbose=not args.quiet,
                                      device=device)
        if args.json:
            print(json.dumps(summary, default=float))
        return 0
    from fedtpu_torch.orchestration.loop import run_experiment
    from fedtpu_torch.resilience.supervisor import (EXIT_DIVERGED,
                                                    EXIT_PREEMPTED, Preempted)
    # In a gang, process 0 prints the summary.
    io_proc = gang is None or gang.process_index == 0
    try:
        result = run_experiment(cfg, verbose=not args.quiet, device=device,
                                resume=args.resume)
    except Preempted as p:
        # The SIGTERM drain completed: the state is checkpointed and the
        # run resumable, the supervisor's "restart me" code.
        if args.json and io_proc:
            print(json.dumps({"preempted": True, "round": p.round}))
        return EXIT_PREEMPTED
    finally:
        if gang is not None:
            multihost.shutdown()
    summary = result.summary()
    if args.json and io_proc:
        print(json.dumps(summary, default=float))
    elif io_proc and not args.quiet:
        print(f"\nrounds run: {summary['rounds_run']}  stopped early: "
              f"{summary['stopped_early']}  mean s/round: "
              f"{summary['mean_sec_per_round']:.3e}")
    # A divergence halt replays deterministically: 3 tells a supervisor
    # not to restart it.
    return EXIT_DIVERGED if result.diverged else 0


if __name__ == "__main__":
    sys.exit(main())
