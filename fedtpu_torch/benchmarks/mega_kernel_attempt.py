"""The whole-round mega-kernel (K5) against the composed round
(``benchmarks/mega_kernel_attempt.py``).

The JAX package keeps its Pallas mega-kernel as a benchmark off the
production path, and so does the port: ``run_experiment`` and
``build_round_fn`` never launch K5 (``ops.cuda_kernels.fused_round``). This
module does what the script does, in the script's order, on the port's own
experiment (``build_experiment``) and its FedAvg weights:

1. One round of K5 against one composed round (``exp.make_step(1)``) from
   the same state, within ``state_faults``' limits: params, Adam moments,
   counts, loss within 1e-5, and confusion counts equal but on near-tie rows.
2. R rounds of each loop from the same state: the largest per-round loss
   difference (within 1e-4), the client-mean accuracy at round R (within
   0.01, the script's trajectory check), the fused loop's Adam counts (R
   more than at the start); the launches of each loop.
3. On the card only: the marginal s/round of each loop (``marginal_slope``),
   each guarded by ``assert_above_flops_floor`` at the card's fp32 peak. A
   CPU time is not a device time, so a CPU run reports no timing.

    python -m fedtpu_torch.benchmarks.mega_kernel_attempt [--platform cpu] \\
        [--rounds R] [--synthetic-rows N]

prints one JSON line. It runs on the card unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Sequence

import torch

from fedtpu_torch.config import ExperimentConfig, get_preset
from fedtpu_torch.models.mlp import mlp_apply, param_count, unflatten
from fedtpu_torch.models.registry import build_model, kernel_dims
from fedtpu_torch.ops import cuda_kernels as ck
from fedtpu_torch.ops.metrics import metrics_from_confusion, near_tie_rows
from fedtpu_torch.ops.optim import build_optimizer
from fedtpu_torch.orchestration.loop import build_experiment
from fedtpu_torch.parallel.round import masked_client_mean
from fedtpu_torch.training.client import make_local_train_step
from fedtpu_torch.utils.timing import assert_above_flops_floor, marginal_slope

# H100 SXM fp32 CUDA-core peak (NVIDIA data sheet, at the 700 W limit): the
# fused round runs on the CUDA cores in fp32.
PEAK_FP32_FLOPS = 67e12
# Adam's flops per parameter as the kernel computes it (two moments, two
# bias-corrected quotients, a square root, the step) plus the average's FMA.
_ADAM_FLOPS, _AVERAGE_FLOPS = 14, 2
TIMING_LENS = (100, 400)
TIMING_REPS = 4
# Limits of K5 against another round from the same state. Params: 2 * lr
# everywhere, PARAM_ATOL on all but PARAM_SHARE of the entries (Adam's first
# step sends a gradient that is rounding noise to +-lr). Adam's moments sit
# far below the params' scale (after income-8's first round nu is at most
# about 1.5e-5), so an absolute limit would pass a kernel that writes no
# moment at all: every entry of mu and nu lies within MOMENT_RTOL of its
# tensor's largest magnitude.
PARAM_ATOL, PARAM_SHARE, MOMENT_RTOL = 1e-4, 1e-3, 1e-5
LOSS_ATOL = 1e-5
MAX_LOSS_DIFF = 1e-4


def round_flops(dims: Sequence[int], real_rows: float, clients: int) -> float:
    """Operations of one fused round on ``real_rows`` unmasked rows: the
    forward, the backward (weight and bias gradients, the input gradient of
    every layer but the first, its ReLU mask) and the eval's forward, plus
    Adam and the average per parameter of every client."""
    pairs = list(zip(dims[:-1], dims[1:]))
    forward = sum(2 * i * o + o for i, o in pairs)
    backward = forward + sum(2 * i * o + i for i, o in pairs[1:])
    return (real_rows * (2 * forward + backward)
            + clients * param_count(dims) * (_ADAM_FLOPS + _AVERAGE_FLOPS))


# FedConfig's knobs of the other aggregation branches, at the values that
# leave plain FedAvg: K5 computes none of those branches.
_FEDAVG_ONLY = (("server_opt", "none"), ("dp_clip_norm", 0.0),
                ("dp_noise_multiplier", 0.0), ("dp_adaptive_clip", False),
                ("robust_aggregation", "none"), ("byzantine_clients", 0),
                ("scaffold", False), ("compress", "none"))


def check_config(cfg: ExperimentConfig) -> None:
    """Refuse what this benchmark cannot hand to K5, naming the field: a
    model other than the float32 MLP (the ConvNet, a bf16 or fp16 param
    or compute dtype), client sampling, another aggregation, more than one
    local step, FedProx, every branch other than plain FedAvg (a server
    optimizer, DP, a robust rule, Byzantine injection, SCAFFOLD, the int8
    exchange), and an optimizer state without Adam's moments. The model's
    limits are the wrapper's own (``fused_round`` raises a ``ValueError``
    that names the field on any device)."""
    kernel_dims(build_model(cfg.model), "the fused round")
    ck.check_fused_round_training(cfg.fed.local_steps, cfg.fed.prox_mu)
    for field, plain in _FEDAVG_ONLY:
        value = getattr(cfg.fed, field)
        if value != plain:
            raise ValueError(f"fed.{field}={value!r}: the fused round "
                             "computes plain FedAvg only")
    if cfg.fed.participation_rate < 1.0:
        raise ValueError(f"fed.participation_rate="
                         f"{cfg.fed.participation_rate}: the fused round "
                         "trains every client (no client sampling)")
    if cfg.fed.aggregation != "psum":
        raise ValueError(f"fed.aggregation={cfg.fed.aggregation!r}: the "
                         "fused round averages over all clients at once "
                         "('psum' only)")
    if cfg.optim.name != "adam":
        raise ValueError(f"optim.name={cfg.optim.name!r}: the fused round "
                         "computes Adam only")


def state_errors(ours: dict, ref: dict) -> dict:
    """``ours`` and ``ref`` map "params", "mu" and "nu" to tensors; per name:
    the largest abs error, the share of entries off by more than PARAM_ATOL,
    and the reference's largest magnitude."""
    out = {}
    for name in ("params", "mu", "nu"):
        err = (ours[name] - ref[name]).abs()
        out[name] = {
            "max_abs": float(err.max()),
            "share_above_1e-4": float((err > PARAM_ATOL).to(
                torch.float32).mean()),
            "ref_max_abs": float(ref[name].abs().max())}
    return out


def state_faults(errors: dict, lr: float) -> list:
    """The limits (see PARAM_ATOL) that ``state_errors``' result breaks."""
    p = errors["params"]
    faults = []
    if p["max_abs"] > 2 * lr or p["share_above_1e-4"] > PARAM_SHARE:
        faults.append(f"params {p}")
    for name in ("mu", "nu"):
        m = errors[name]
        if m["max_abs"] > MOMENT_RTOL * m["ref_max_abs"]:
            faults.append(f"{name} {m}")
    return faults


def _delta(before: dict) -> dict:
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"fused round diverged from the composed round: "
                           f"{msg}")


def make_fused_step(exp, optim):
    """``step(state) -> (state, loss (C,), conf (C, K, K))``: one round of
    ``exp`` through K5 (its plain version on the CPU), with the experiment's
    own FedAvg weights, in the composed round's state layout."""
    x, y, mask = (exp.batch[k] for k in ("x", "y", "mask"))

    def step(state):
        opt = state["opt_state"]
        params, mu, nu, count, loss, conf = ck.fused_round(
            state["params"], opt["mu"], opt["nu"], opt["count"], x, y, mask,
            exp.client_weights, exp.model, optim)
        return ({"params": params,
                 "opt_state": {"mu": mu, "nu": nu, "count": count},
                 "round": state["round"] + 1}, loss, conf)

    return step


def run(cfg: ExperimentConfig, device="cuda", rounds: int = 100) -> dict:
    """K5 against the composed round on ``cfg`` (see the module docstring);
    returns the comparisons, launches and (on the card) timings."""
    check_config(cfg)
    exp = build_experiment(cfg, device=device)
    dims = exp.dims
    x, mask = exp.batch["x"], exp.batch["mask"]
    lr = cfg.optim.learning_rate
    fused_step = make_fused_step(exp, cfg.optim)

    def accuracy(conf):
        return float(masked_client_mean(metrics_from_confusion(conf),
                                        mask)["accuracy"])

    # 1. One round from the same state.
    state0 = exp.state
    fused, loss_f, conf_f = fused_step(state0)
    composed, raw = exp.make_step(1)(state0, exp.batch)
    trained, _, _ = make_local_train_step(dims, build_optimizer(cfg.optim))(
        state0["params"], state0["opt_state"], x, exp.batch["y"], mask)
    ties = near_tie_rows(mlp_apply(unflatten(trained, dims), x)) & (mask > 0)
    one = state_errors({"params": fused["params"], **fused["opt_state"]},
                       {"params": composed["params"],
                        **composed["opt_state"]})
    faults = state_faults(one, lr)
    one["loss_max_abs"] = float((loss_f - raw["loss"][0]).abs().max())
    one["count_equal"] = bool(torch.equal(fused["opt_state"]["count"],
                                          composed["opt_state"]["count"]))
    one["conf_rows_differing"] = (
        (conf_f - raw["conf"][0]).abs().sum(dim=(1, 2)) / 2).tolist()
    one["near_tie_rows"] = ties.sum(dim=1).tolist()
    _require(not faults, f"round 1 {faults}")
    _require(one["loss_max_abs"] <= LOSS_ATOL and one["count_equal"],
             f"round 1 loss differs by {one['loss_max_abs']}, counts equal "
             f"{one['count_equal']}")
    _require(all(a <= b for a, b in zip(one["conf_rows_differing"],
                                        one["near_tie_rows"])),
             f"round 1 confusion counts differ on "
             f"{one['conf_rows_differing']} rows, near ties "
             f"{one['near_tie_rows']}")

    # 2. R rounds of each loop from the same state.
    before = dict(ck.LAUNCHES)
    state, losses, confs = state0, [], []
    for _ in range(rounds):
        state, loss, conf = fused_step(state)
        losses.append(loss)
        confs.append(conf)
    losses = torch.stack(losses)
    launches_fused = _delta(before)
    before = dict(ck.LAUNCHES)
    _, raw = exp.make_step(rounds)(state0, exp.batch)
    launches_composed = _delta(before)
    acc_f, acc_c = accuracy(confs[-1]), accuracy(raw["conf"][-1])
    trajectory = {
        "max_loss_diff": float((losses - raw["loss"]).abs().max()),
        "fused_accuracy": acc_f, "composed_accuracy": acc_c,
        "accuracy_diff": abs(acc_f - acc_c)}
    _require(trajectory["accuracy_diff"] < 0.01,
             f"client-mean accuracy after {rounds} rounds: fused {acc_f}, "
             f"composed {acc_c}")
    _require(trajectory["max_loss_diff"] <= MAX_LOSS_DIFF,
             f"per-round losses differ by up to {trajectory['max_loss_diff']}")
    _require(torch.equal(state["opt_state"]["count"],
                         state0["opt_state"]["count"] + rounds),
             f"Adam counts {state['opt_state']['count'].tolist()} after "
             f"{rounds} fused rounds")

    result = {
        "device": (torch.cuda.get_device_name(exp.device)
                   if exp.device.type == "cuda" else "cpu"),
        "dims": list(dims), "clients": x.shape[0], "rows": x.shape[1],
        "real_rows": int(mask.sum()), "rounds": rounds, "one_round": one,
        "trajectory": trajectory,
        "launches": {"fused": launches_fused, "composed": launches_composed},
        "timing": None}
    if exp.device.type != "cuda":
        return result

    # 3. Marginal s/round of each loop, on the card.
    flops = round_flops(dims, result["real_rows"], x.shape[0])

    def make_fused(length):
        def go():
            s = state0
            for _ in range(length):
                s, _, conf = fused_step(s)
            return conf
        return go

    def make_composed(length):
        step = exp.make_step(length)
        return lambda: step(state0, exp.batch)[1]["conf"]

    timing = {"lens": list(TIMING_LENS), "reps": TIMING_REPS,
              "flops_per_round": flops, "peak_flops": PEAK_FP32_FLOPS}
    for name, make in (("fused", make_fused), ("composed", make_composed)):
        sec = marginal_slope(make, TIMING_LENS, TIMING_REPS)
        timing["floor_s"] = assert_above_flops_floor(
            sec, flops, PEAK_FP32_FLOPS, label=f"{name} loop")
        timing[f"{name}_s_per_round"] = sec
    result["timing"] = timing
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fedtpu_torch.benchmarks.mega_kernel_attempt",
        description="the whole-round mega-kernel against the composed "
                    "round on income-8; prints one JSON line")
    parser.add_argument("--platform", choices=["default", "cpu"],
                        default="default",
                        help="'default' runs on the GPU, 'cpu' on the CPU")
    parser.add_argument("--rounds", type=int, default=100)
    parser.add_argument("--synthetic-rows", type=int, default=10000,
                        help="synthetic income-like rows (the income CSV "
                             "has 10,000)")
    args = parser.parse_args(argv)
    cfg = get_preset("income-8")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, synthetic_rows=args.synthetic_rows))
    out = run(cfg, device="cpu" if args.platform == "cpu" else "cuda",
              rounds=args.rounds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
