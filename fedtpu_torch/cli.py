"""``python -m fedtpu_torch.cli {run,sweep,parity,presets,serve,gateway,
loadgen,autoscale,report,timeline}``: the port's counterparts of ``fedtpu run`` (the
synchronous engine, or with ``--async`` the asynchronous FedBuff one),
``fedtpu sweep`` (the hyperparameter grid), ``fedtpu parity`` (the sklearn
``MLPClassifier`` warm-start limitation demo), ``fedtpu presets`` (the
shipped presets), ``fedtpu serve`` (the trace-driven serving front end on
the driven asynchronous tick), ``fedtpu gateway`` (one member of the
store-backed gateway fleet), ``fedtpu loadgen`` (replay an arrival trace
against a running server or fleet), ``fedtpu autoscale`` (the SLO-driven
control plane, simulated or live), and the offline readers of a telemetry
sink, ``fedtpu report`` and ``fedtpu timeline``.

Every flag is one that ``fedtpu.cli``'s parser also has, with the same
meaning; ``--platform default`` means the GPU, ``--platform cpu`` the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    ``_add_serving_flags``). ``--heartbeat`` raises when given (ROADMAP
    A11)."""
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
                   help="liveness heartbeat file (not ported yet: "
                        "ROADMAP A11)")
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
    from fedtpu_torch.serving.server import (EXIT_PREEMPTED, Preempted,
                                             run_server)
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
    from fedtpu_torch.serving.gateway import run_gateway
    from fedtpu_torch.serving.server import EXIT_PREEMPTED, Preempted
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
    result = run_experiment(cfg, verbose=not args.quiet, device=device,
                            resume=args.resume)
    summary = result.summary()
    if args.json:
        print(json.dumps(summary))
    elif not args.quiet:
        print(f"\nrounds run: {summary['rounds_run']}  stopped early: "
              f"{summary['stopped_early']}  mean s/round: "
              f"{summary['mean_sec_per_round']:.3e}")
    return 1 if result.diverged else 0


if __name__ == "__main__":
    sys.exit(main())
