"""``python -m fedtpu_torch.cli {run,sweep,parity,presets}``: the port's
counterparts of ``fedtpu run`` (the synchronous engine, or with ``--async``
the asynchronous FedBuff one), ``fedtpu sweep``
(the hyperparameter grid), ``fedtpu parity`` (the sklearn ``MLPClassifier``
warm-start limitation demo) and ``fedtpu presets`` (the shipped presets).

Every flag is one that ``fedtpu.cli``'s parser also has, with the same
meaning; ``--platform default`` means the GPU, ``--platform cpu`` the plain
versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from fedtpu_torch.config import AGGREGATIONS, PRESETS, get_preset


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
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="'default' runs on the GPU, 'cpu' on the CPU")
    p.add_argument("--log-per-client", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="print the result summary as one JSON line")


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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "presets":
        print_presets()
        return 0
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
