#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: compile the kernels from fedtpu_torch/csrc (one nvcc per source,
   all at once, sm_90a).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at edge shapes, two launches bitwise equal,
   and timed (CUDA events). K1 in both modes, the (D,) average and the
   broadcast into every slot with the carry-over (every weight 0: the input
   bit for bit), timed beside ``torch.matmul`` and beside the chain the
   broadcast mode replaces, at income-8's shape and at cifar10-32's (32,
   1,070,794); K3 at N = 2,000 (its plan printed), 100, 1,
   2,001 and 100,000, on two other models and on two whose parameters do
   not fit in a block ((256, 256) and (200, 200, 200): the streamed path),
   timed under its plan and its nearest tiles. The eval kernel (K2) at
   income-8's (8, 1000) batch, income-32-noniid's tail-padded (32, 1104)
   one, ten classes, a class count whose K x K tile goes to global memory
   and the two streamed models, each equal to the counts built from K3's
   logits exactly, and timed on the income and streamed shapes; the ring
   kernel (K4) must equal its plain version bit for bit, with one
   allocation and no host sync per call.
4. main path: ``run_experiment`` on income-8 (psum; synthetic data at the
   income CSV's 10,000 rows), counting each kernel's launches.
5. card vs CPU: the same run on the CPU (plain versions), same init.
6. profile: a steady-state round's host time against its device time and
   device-op count.
7. sharded round: income-32-noniid at 10,000 rows over a clients mesh of 8
   shards on the one card: ``aggregation="ring"`` (K4 once per round, K1
   never), then two shorter runs, ``ring-rsag`` (K4 never) and ``ring``
   under client sampling (participation_rate=0.5); then income-8 on the psum
   path under the same sampling (K1 once per round). Each run's launches
   are counted from zero, each run is held against the same config on the
   CPU, and the ring run is profiled as in phase 6. Then income-2 at
   hidden_sizes=(256, 256), where K2 and K3 stream the weights, against
   the CPU.
   Then (a)-(d): income-8 from a 10,000-row CSV of the income schema;
   5 local steps with FedProx on psum and ring; captured against
   uncaptured runs, bitwise; resume 20 -> 40 bitwise the uninterrupted run.
   (e) the rest of the synchronous round on income-32-noniid: fedadam,
   DP-FedAvg (clip, noise, sampling, adaptive clip with count noise), the
   median and Krum with 3 Byzantine clients, SCAFFOLD, the int8 exchange
   over 8 shards, fedavgm and the trimmed mean, each against the CPU; DP
   and SCAFFOLD captured against uncaptured at R = 10, bitwise; DP resumed
   20 -> 40 bitwise with the same privacy spend; the noise draw's host
   cost; K1's sum mode at the delta path's shape.
   (f) the hyperparameter grid: the reference's 90 configs at full width
   (400 steps, income-8 at 10,000 rows) in 2 launches, K1 and K2 once
   each a launch and held against their plain versions at the depth-2
   launch's 576 models, every padded entry of every averaged model 0.0,
   each launch's wall and device time; a reduced grid and the plateau stop
   against the CPU. (g) income-32-noniid with 5 personalize steps after
   the run, against the CPU.
8. fused round (K5): the whole-round kernel against its plain version on the
   card at income-8's experiment state, at edge shapes and at
   income-32-noniid's (32, 1104) batch, twice on the same inputs (bitwise
   equal); its launch plan; then the benchmark
   ``fedtpu_torch.benchmarks.mega_kernel_attempt.run`` on income-8 at 10,000
   rows (round 1 and 100 rounds against the composed round, launches
   counted from zero around it, marginal s/round of both loops); K5 timed
   beside its plain version and bound at both batches, with its per-phase
   windows beside the PR 4 design's; a profile of 20 fused rounds.
   Then the ConvNet family: (h) cifar10-32 at full width (32 clients x
   1,070,794 parameters, 4,096 synthetic rows, bf16 compute, 50 rounds),
   captured against uncaptured bitwise, K1 once a round and K2 = K3 = 0
   (the ConvNet is evaluated through its own forward), s/round of both, a
   20-round profile, and the same run at fp32 compute; (i) cifar10-32 at
   full width on 512 rows, 3 rounds, card against CPU at fp32 and bf16;
   (j) income-8 at bf16 compute against the CPU (K2 = K3 = 0).
   Then ``param_dtype``: (k) K1 on bfloat16 and float16 stacks at
   income-8's and cifar10-32's shapes in both modes (and a float32 stack
   into 16-bit slots, the main path's), with the carry-over and a NaN
   column, against its plain version and timed; K1-K3 at the
   sklearn-parity preset's shapes; (l) ``parity --preset sklearn-parity``
   at full width through the CLI (part A on the host, part B on the card,
   K1-K3 counted), part B against the CPU; (m) income-8 at bfloat16 params
   against the CPU (same stop round), and at float16 params, which
   diverges: card and CPU halt at the same round; (n) cifar10-32 at full
   width with bfloat16 params, 10 rounds captured, and 3 rounds on 512 rows
   against the CPU.
   Then the asynchronous FedBuff engine, (o): K1's sum mode
   (``weighted_sum_clients``) against its plain version at
   income-32-noniid's (32, 11,352) with positive weights, signed weights of
   negative total, every weight 0 (exactly 0) and a NaN in the stack, and
   at cifar10-32's (32, 1,070,794) deltas, timed beside ``torch.matmul``
   and its bound; income-32-noniid ``--async`` at full width (arrival
   0.25, staleness power 0.5, K-buffer 16, 5 local steps, FedProx 0.01),
   uncaptured at R = 1 and captured at R = 10 (bitwise equal, K1 and K2 a
   tick and in the warm-up, K3 the held-out evals), against the CPU (same
   staleness, losses within 1e-4), 20 captured ticks profiled; the driven,
   screened and clipped tick on the same data (captured bitwise
   uncaptured, K1 twice a tick, the screened flags equal the CPU's, at
   least one poisoned arrival and no honest one screened); cifar10-32
   ``--async`` at
   full width, bf16 compute, 10 ticks captured (K2 = K3 = 0), and 3 ticks
   on 512 rows against the CPU; the income run resumed 20 -> 40 with a
   pending K-buffer, bitwise.
   Then the serving front end, (p) (``phase_serve``), at the income MLP's
   full width (14 -> 50 -> 200 -> 2 on 32 slots, K-buffer 16, staleness
   power 0.5, 10,000 fixture rows) fed loadgen's ``--synthesize`` trace
   (1,000,000 users, 100,000 arrivals over 60 virtual s) in frames of
   1,024: ``run_server`` in a thread answering ``run_loadgen`` over
   localhost, launches counted from zero around it (K1's sum mode and K2
   once a non-empty tick and in the graph's warm-up, K3 once an
   ``eval_accuracy``), with events/s, ticks/s, the latency percentiles,
   the admission counts and the final version; 20 captured ticks
   profiled (device ms and ops a tick, host ms of a tick and of a frame's
   ``offer_many``, idle share); the same trace in process on the card
   captured and uncaptured (bitwise) and on the CPU in a process of its
   own (history and summary equal, global params within 1e-4, the logit
   drift within 1e-3, predictions and ``eval_accuracy`` equal but on near
   ties); K2 at the tick's (32, 328) rows and K3 at the fixture's 10,000
   on the card engine's own tensors against their plain versions, timed;
   a checkpoint at the trace's midpoint with updates pending, restored
   into a fresh engine, bitwise the uninterrupted run; ``serve --once``
   and ``loadgen --synthesize --json`` (20,000 arrivals) through the CLI
   as subprocesses; the screened cell (a v2 trace, 20 % attackers at
   scale 10, 10,000 arrivals; K1 twice a tick): the decision log and
   history equal to the CPU's, accuracy equal but on near ties, attackers
   quarantined and no honest user; ``defense_sim.simulate`` on the card
   against the CPU.
   Then the rest of the serving stack, (q) (``phase_fleet``), each gateway
   engine (p)'s, on a trace of loadgen's population at its rate cut to
   12 virtual s (20,000 arrivals from 1,000,000 users): two
   ``run_gateway`` threads (the memory store over 1,000,000 users, a
   record per user) fed by the partitioning ``GatewayClient`` with one
   misrouted frame redirected, launches counted from zero (K1's sum mode
   and K2 a non-empty tick of each gateway and a warm-up each, K3 a
   shutdown summary each), events/s, ticks/s, evictions, the host ms of
   a store swap and the touched rows; the same parts in process on the
   card uncaptured (bitwise the wire fleet's checkpoints: state and every
   store byte) and on the CPU (histories and summaries equal, global
   params and store values within 1e-4, headers equal); the flush/adopt
   failover in process (a stale generation refused, the adopted records
   bitwise the exported, the spool replayed) against the CPU's, each of
   its card ticks against the CPU's tick from the same inputs (within
   1e-4) and the survivor's state and store digest printed; K1's sum
   mode at the net sim's (8, 74); one gateway behind the wire-fault proxy
   (fedtpu's net sim plan) twice, exactly once and the decision logs
   identical; ``net_sim.simulate`` on the card against the CPU;
   ``autoscale --simulate`` through the CLI and a ``LiveController``
   against a card server under load, every action acked; and the CLI
   fleet (two ``gateway`` subprocesses, ``loadgen --num-gateways 2``)
   through the lost-ack drill: gateway 1 kills itself after its fifth
   ack and is relaunched with ``--resume``, and no acked update is lost.
   Then cohort mode, (r) (``phase_cohort``), at the income MLP's full
   width on 1,000,000 synthetic rows: income-8 at full participation
   (cohorts of 8 of 8) bitwise its synchronous run, both captured; 100,000
   clients (the memory store, about 8 train rows a client) in cohorts of
   256, 10 a chunk, 20 rounds, a held-out eval every 10, launches counted
   from zero (K1 = K2 = cohorts run + the warm-up cohort, K3 = evals):
   captured bitwise uncaptured (state and every touched store record),
   stopped at 10 on the mmap store and resumed to 20, bitwise the
   uninterrupted memory-store run; a captured chunk profiled; against the
   CPU cohort by cohort (each from the same inputs, slot params and Adam
   state within 1e-4) and as whole runs (the same ids, losses within
   1e-4, counts equal but on near-tie rows; the final params' drift
   printed); 1,000,000 clients on the memory store for 10 rounds
   (s/round, apparent against resident bytes, peak device memory beside
   the 100,000-client run's); the ring over 8 shards of the cohort (K4 a
   cohort) and the median, 5 rounds each, against the CPU; trace sampling from a
   trace the serving stack writes; K1's broadcast at (256, 11,352), K2 at
   (256, 8), K3 at the 200,000 held-out rows and K4 at the cohort ring's
   (8, 11,353) against their plain versions, timed. Each chunk prints its
   host seconds (lazy init, store read and write, the prefetch stall) and
   device milliseconds (copies in, step, copies out).
   Then the telemetry, (s) (``phase_telemetry``): income-8 at R = 10,
   captured, with the events sink off, on, on, off (bitwise the same run,
   the same K1-K3 launches; s/round of each; a tracer event's host
   microseconds), then with the sink and the profile window
   (profile_rounds 20) after the CPU's run of that same config: one
   manifest (backend cuda, the card's name, the CPU's config hash), a
   chunk span a chunk, a round event a round, one profile_window start
   and stop, a Chrome trace naming K1 and K2, the counters last before
   run_end with the card's memory gauges, ``report`` in text, JSON and
   Prometheus; income-8 for 25 rounds (a tail chunk) with the sink and
   the profiler over the whole run (profile_rounds 0, both graphs
   captured under it), bitwise the run with both off, the same K1-K3
   launches; serve, a two-gateway fleet and a gateway behind the
   wire-fault proxy writing their sinks, fed over the wire, and an
   autoscale decision log, merged by ``timeline`` (every incorporated
   update's chain complete); the timeline sim on the card (its pinned
   arrivals) against the committed golden; a small captured cohort run's
   cohort_gather / cohort_writeback spans.

   Then the single-process resilience loop, (t) (``phase_resilience``):
   income-8 at R = 10 under each fault kind (straggler, dropout against
   the CPU, a NaN rollback, exclusion, a spent budget, the drain and
   resume, a corrupt checkpoint's fallback), heartbeats, the armed-plan
   s/round pairs, and through the CLI the five single-process chaos rows,
   a diverging run under supervise and a timed supervised restart.
   Then the rest of the resilience loop, (u) (``phase_gang``): the fuzz
   corpus on the card twice (bitwise) and on the CPU, the first sampled
   campaigns card vs CPU (equal, or differing only in screen decisions
   within 1e-5 of their threshold), ``fuzz --budget 25`` through the CLI
   (every campaign passes or shrinks), ``check`` through the CLI at
   ``--transfer-guard disallow`` with the timeline sim and a live
   two-gateway fleet's probe (recompiles 0) and a recapture read by an
   armed sentinel, K1's sum mode at (8, 266) and K2/K3 at the gateway
   rows' engine, and the six fleet chaos rows through the CLI.
   Then the training gang, (v) (``phase_train_gang``): N ``run`` processes
   sharing the one H100 over gloo, launched by ``supervise_gang`` (each
   member ``gang_member``: the CLI's ``run``, then its launch counts):
   K4 across processes (each member's rows from its own and its peers'
   CUDA IPC-mapped exchange buffers) at (8, 11,353) as 2 x 4 and 4 x 2,
   bitwise the one-process K4 and the plain version, timed; income-8 psum
   K1's sum mode at a member's (4, 11,352) and (2, 11,352) and K2 at its
   (4, N) and (2, N) income-8 batch, against their plain versions and
   timed (alone on the card); income-8 psum gangs of 2 and 4 and an
   income-32-noniid ring gang of 2 x 4 shards, each against the
   one-process card run of its config (the same stop round; the history
   within 1e-5; the params within 1e-5 at the first checkpoint and 1e-4
   at every one; the members' round events equal; each member's
   K1/K2/K3/K4 launches equal one process's); an ``--async`` gang of 2
   likewise; a SIGTERM to every
   member, the drain and the gang's ``--resume``, bitwise the
   uninterrupted gang; and the four training-gang chaos rows through the
   CLI, two chaos children beside the rest.
   Later, the loop's features in a gang, (y) (``phase_feature_gangs``):
   four gangs of 2 side by side at full width (a pipelined fedadam gang
   with personalization and a warm start, the same gang without the
   pipelined stop, and psum and ring gangs under rollback with a dropout,
   a corrupt checkpoint and a NaN update of member-1 clients), each held
   to one process of the same CLI config, then the rollback's agreed walk
   timed.

The line before the last is the ``kernels`` JSON; the last line is the
result JSON. Imports nothing of JAX or of the ``fedtpu`` package (nor does
the port's serving stack, which phases (p) and (q) drive).
"""

import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit):
# HBM bytes/s and fp32 CUDA-core flop/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
INCOME_DIMS = (14, 50, 200, 2)
# Models whose parameters do not fit in one block: K2 and K3 stream them.
WIDE_DIMS = (14, 256, 256, 2)
DEEP_WIDE_DIMS = (14, 200, 200, 200, 2)
SHARDS = 8                # mesh_devices of the sharded round
# cifar10-32's ConvNet: 32x32x3 -> conv 32 -> conv 64 -> 256 -> 10.
CIFAR_PARAMS = 1_070_794
CIFAR_ROUNDS = 50
TIMING_REPS = 60
K2_REPEATS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, sleep_cycles: int = 1_000_000) -> float:
    """Median device time of one call over TIMING_REPS runs after warm-up.
    A sleep kernel queued ahead of each run keeps the host's enqueue time
    out of the measured window, so the events bracket device work only."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_back_to_back_ms(fn, k: int = 10) -> float:
    """Device time a call of ``k`` calls queued back to back in one window
    (behind a longer sleep): what a call adds to a stream of launches,
    without the fixed cost of a lone launch between two events."""
    return time_ms(lambda: [fn() for _ in range(k)], 8_000_000) / k


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mlp_flops(dims, rows: float) -> float:
    # One multiply-add (2 flops) per weight per row, plus the bias adds.
    return rows * sum(2 * i * o + o for i, o in zip(dims[:-1], dims[1:]))


# nvidia-smi's "name, power limit" of the card, printed beside every time
# the new phases report.
CARD = {"smi": ""}


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    CARD["smi"] = smi.stdout.strip().splitlines()[0]
    print(CARD["smi"], flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)}  count "
          f"{torch.cuda.device_count()}", flush=True)
    # The host's CPU sets the CPU runs' last bits (the card-vs-CPU checks).
    model = next((line.split(":", 1)[1].strip()
                  for line in open("/proc/cpuinfo")
                  if line.startswith("model name")), "unknown")
    print(f"host CPU {model}, {os.cpu_count()} cores, torch CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}", flush=True)
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from fedtpu_torch.ops._build import build, load_library
    info = build()
    load_library()
    print(f"build: {info['seconds']:.1f} s -> {info['path']}", flush=True)
    for line in info["compiler_output"].splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            print(f"  ptxas: {line.strip()}", flush=True)


def phase_kernels(gen: torch.Generator) -> dict:
    from fedtpu_torch.models.mlp import (mlp_apply, mlp_init, param_count,
                                         unflatten)
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import confusion_matrix, near_tie_rows
    dev = torch.device("cuda")
    results = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def stacked_params(c, dims):
        return torch.stack([mlp_init(gen, dims[0], dims[1:-1], dims[-1])
                            for _ in range(c)]).to(dev)

    results["weighted_average_clients"] = k1_checks(gen, dev)

    # K2 fused_eval_confusion: counts equal to those built from K3's logits
    # (same FMA order) exactly, and to the plain version's except on
    # near-tie rows.
    def k2_case(label, params, dims, x, y, mask):
        c, n = y.shape
        k = dims[-1]
        # Back-to-back launches, each held exactly: a race shows here.
        confs = [ck.fused_eval_confusion(params, dims, x, y, mask, k)
                 for _ in range(K2_REPEATS)]
        conf = confs[0]
        ref = ck.fused_eval_confusion_reference(params, dims, x, y, mask, k)
        k3_logits = torch.stack([ck.fused_mlp_forward(params[i], dims, x[i])
                                 for i in range(c)])
        from_k3 = confusion_matrix(y, torch.argmax(k3_logits, dim=-1), mask,
                                   k)
        logits = mlp_apply(unflatten(params, dims), x)
        ties = near_tie_rows(logits) & (mask > 0)
        torch.cuda.synchronize()
        for i, out in enumerate(confs):
            check(torch.equal(out, from_k3),
                  f"K2 {label}, launch {i}: counts differ from K3's logits' "
                  f"counts on {int((out - from_k3).abs().sum()) // 2} rows")
        moved = (conf - ref).abs().sum(dim=(1, 2)) / 2   # rows per client
        allowed = ties.sum(dim=1).to(torch.float32)
        tie_rows = [tuple(ix) for ix in ties.nonzero().tolist()]
        check(bool((moved <= allowed).all()),
              f"K2 {label}: counts differ on {moved.tolist()} rows per "
              f"client; near ties {tie_rows}")
        plan = ck._eval_plan(param_count(dims), tuple(dims))
        print(f"K2 fused_eval_confusion {label} C={c} N={n} dims={dims} "
              f"({'streamed' if plan.cap else 'resident'}, counts in "
              f"{'shared' if plan.shared_counts else 'global'} memory): "
              f"{K2_REPEATS} launches equal to K3's counts; rows differing "
              f"from plain {int(moved.sum())}, near-tie rows (client, row) "
              f"{tie_rows}",
              flush=True)
        return float((conf - ref).abs().max())

    def random_case(c, n, dims, masked_tail):
        params = stacked_params(c, dims)
        x = randn(c, n, dims[0])
        y = torch.randint(0, dims[-1], (c, n), generator=gen,
                          dtype=torch.int32).to(dev)
        mask = torch.ones(c, n)
        mask[-1, n - masked_tail:] = 0.0
        return params, x, y, mask.to(dev)

    # income-32-noniid's own batch: 32 Dirichlet shards (1 to ~1,100 rows)
    # padded at the tail to the longest, with random weights.
    batch = noniid_batch()
    noniid = (stacked_params(batch["x"].shape[0], INCOME_DIMS),
              batch["x"].to(dev), batch["y"].to(dev), batch["mask"].to(dev))
    income8 = random_case(8, 1000, INCOME_DIMS, 0)
    k2_err = max(k2_case("income-8", income8[0], INCOME_DIMS, *income8[1:]),
                 k2_case("income-32-noniid", noniid[0], INCOME_DIMS,
                         *noniid[1:]))
    for c, n, dims, tail in ((8, 100, INCOME_DIMS, 13),
                             (8, 1000, (14, 2), 0),
                             (4, 1000, (14, 50, 400, 2), 0),
                             (8, 1000, (14, 50, 200, 8), 0),
                             (3, 1, INCOME_DIMS, 0),
                             # Ten classes, and a K x K tile too large for
                             # shared memory (counts in global memory).
                             (8, 1000, (14, 50, 200, 10), 7),
                             (4, 1000, (14, 50, 250), 0),
                             # The streamed path: parameters too large for
                             # one block (income-2's batch at (256, 256)).
                             (2, 4000, WIDE_DIMS, 5),
                             (3, 700, DEEP_WIDE_DIMS, 0)):
        case = random_case(c, n, dims, tail)
        k2_err = max(k2_err, k2_case("edge", case[0], dims, *case[1:]))
    # All-padding tiles inside the shards (every third 32-row tile) and a
    # ragged tail: the kernel reads the mask, it does not assume a tail.
    params, x, y, mask = random_case(2, 5000, INCOME_DIMS, 13)
    mask[:, (torch.arange(5000, device=dev) // 32) % 3 == 1] = 0.0
    k2_err = max(k2_err, k2_case("holes", params, INCOME_DIMS, x, y, mask))
    by_shape = []
    for label, dims, (params, x, y, mask) in (
            ("income-8", INCOME_DIMS, income8),
            ("income-32-noniid", INCOME_DIMS, noniid),
            ("income-2 (256, 256), streamed", WIDE_DIMS,
             random_case(2, 4000, WIDE_DIMS, 0)),
            ("(200, 200, 200), streamed", DEEP_WIDE_DIMS,
             random_case(2, 4000, DEEP_WIDE_DIMS, 0))):
        live = float(mask.sum())
        din = x.shape[-1]
        k = dims[-1]
        nbytes = 4 * (params.numel() + live * (din + 1) + mask.numel()
                      + params.shape[0] * k * k)
        b, by = bound_ms(nbytes, mlp_flops(dims, live))
        by_shape.append({
            "shape": label, "dims": list(dims), "clients": x.shape[0],
            "rows": x.shape[1], "real_rows": int(live),
            "ms": time_ms(lambda: ck.fused_eval_confusion(
                params, dims, x, y, mask, k)),
            "plain_ms": time_ms(lambda: ck.fused_eval_confusion_reference(
                params, dims, x, y, mask, k)),
            "bound_ms": b, "bound_by": by})
        print(f"time fused_eval_confusion {label} {tuple(x.shape[:2])}, "
              f"{int(live)} real rows: kernel {by_shape[-1]['ms']:.4f} ms  "
              f"plain {by_shape[-1]['plain_ms']:.4f} ms  bound {b:.5f} ms "
              f"({by})", flush=True)
    results["fused_eval_confusion"] = {
        "max_abs_err": k2_err, **{key: by_shape[0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "by_shape": by_shape}

    results["fused_mlp_forward"] = k3_checks(gen, dev)
    results["ring_all_reduce_sum"] = k4_checks(gen, dev)
    # The yardstick under every kernel time: one empty kernel, timed alike.
    empty = time_ms(lambda: torch.cuda._sleep(0))
    empty_b2b = time_back_to_back_ms(lambda: torch.cuda._sleep(0))
    print(f"time of an empty kernel launch, same method: {empty:.4f} ms; "
          f"back to back {empty_b2b:.4f} ms", flush=True)
    for name, r in results.items():
        r["empty_launch_ms"] = empty
        r["empty_back_to_back_ms"] = empty_b2b
        print(f"time {name}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']}  bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    return results


def k1_checks(gen: torch.Generator, dev: torch.device) -> dict:
    """K1 weighted_average_clients in both modes against its plain version
    (1e-5): the income-8 FedAvg and edge shapes (an odd width with a zero
    weight, 32 clients, one column, client counts below, at and past a
    multiple of the 8-row unroll, every weight 0, where the broadcast mode
    must return x bit for bit);
    two launches bitwise equal. Then both modes timed at income-8 beside
    their plain versions and bounds, the (D,) mode beside ``torch.matmul``,
    the broadcast mode beside the chain it replaces in the round (the
    average, ``w.sum() > 0``, ``torch.where``), and the plan's block size
    beside a warp fewer and a warp more."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    d8 = param_count(INCOME_DIMS)
    err = 0.0
    for c, d, w in ((8, d8, [1000.0] * 8), (2, 97, [0.0, 37.0]),
                    (32, d8, [300.0 + i for i in range(32)]),
                    (3, 1, [1.0, 2.0, 3.0]), (5, 1001, [1.0, 0.0, 2.0, 3.0,
                                                        4.0]),
                    (41, 4096, [float(i % 7) for i in range(41)]),
                    (8, d8, [0.0] * 8)):
        x = torch.randn(c, d, generator=gen).to(dev)
        wt = torch.tensor(w, device=dev)
        for broadcast in (False, True):
            out = ck.weighted_average_clients(x, wt, broadcast)
            again = ck.weighted_average_clients(x, wt, broadcast)
            ref = ck.weighted_average_clients_reference(x, wt, broadcast)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            mode = "broadcast" if broadcast else "(D,)"
            check(out.shape == ref.shape and e <= 1e-5,
                  f"K1 {mode} at ({c}, {d}): max abs err {e} > 1e-5")
            check(torch.equal(out, again),
                  f"K1 {mode} at ({c}, {d}): two launches differ")
            if broadcast and not any(w):
                check(torch.equal(out, x), f"K1 broadcast at ({c}, {d}), "
                      "every weight 0: not the input bit for bit")
            print(f"K1 weighted_average_clients {mode} ({c}, {d}): max abs "
                  f"err {e:.3e}, two launches bitwise equal", flush=True)
            err = max(err, e)
    x = torch.randn(8, d8, generator=gen).to(dev)
    wt = torch.full((8,), 1000.0, device=dev)
    wn = wt / wt.sum()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, blocks = ck._wavg_plan(d8, sms)
    print(f"K1 plan at (8, {d8}): {threads} threads x {blocks} blocks on "
          f"{sms} SMs", flush=True)

    def composed():
        glob = ck.weighted_average_clients(x, wt)
        return torch.where(wt.sum() > 0, glob.expand_as(x), x)

    cifar = k1_cifar_checks(dev)
    modes = {}
    for mode, broadcast, nbytes in (
            ("average", False, 4 * (x.numel() + 8 + d8)),
            ("broadcast", True, 4 * (2 * x.numel() + 8))):
        b, by = bound_ms(nbytes, 2.0 * x.numel())
        modes[mode] = {
            "ms": time_ms(lambda: ck.weighted_average_clients(x, wt,
                                                              broadcast)),
            "plain_ms": time_ms(lambda: ck.weighted_average_clients_reference(
                x, wt, broadcast)),
            "back_to_back_ms": time_back_to_back_ms(
                lambda: ck.weighted_average_clients(x, wt, broadcast)),
            "bound_ms": b, "bound_by": by}
        out = torch.empty((8, d8) if broadcast else (d8,), device=dev)
        # The plan beside its neighbours, a warp fewer and a warp more.
        modes[mode]["ms_by_threads"] = {
            t: time_ms(lambda: ck._launch_wavg(x, wt, out, broadcast, t))
            for t in (threads - 32, threads, threads + 32)
            if 32 <= t <= ck.WAVG_MAX_THREADS}
    avg, bc = modes["average"], modes["broadcast"]
    avg["library_ms"] = time_ms(lambda: torch.matmul(wn, x))
    bc["composed_ms"] = time_ms(composed)
    for mode, r in modes.items():
        print(f"time K1 {mode} (8, {d8}): kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r.get('library_ms')}  "
              f"composed {r.get('composed_ms')}  back to back "
              f"{r['back_to_back_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}); by threads a block "
              f"{json.dumps(r['ms_by_threads'])}", flush=True)
    # The row's own numbers are the (D,) mode's, as in every earlier
    # kernels line; the broadcast mode and the chain it replaces in the
    # round sit beside them.
    return {"max_abs_err": max(err, cifar["max_abs_err"]), **avg,
            "composed_ms": bc.pop("composed_ms"),
            "modes": {"broadcast": bc},
            "plan": {"threads": threads, "blocks": blocks},
            "cifar10_32": cifar}


def k1_cifar_checks(dev: torch.device) -> dict:
    """K1 at cifar10-32's FedAvg, on the inputs that path gives it: the 32
    clients' freshly initialised (32, 1,070,794) params and their
    data-size weights. Both modes against the plain version (1e-5) and
    bitwise across two launches, then timed beside their bounds, the
    plain version, ``torch.matmul(w / w.sum(), x)`` for the (D,) mode and
    the chain the broadcast mode replaces in the round."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import build_experiment
    exp = build_experiment(cifar_config(), device="cuda")
    x, wt = exp.state["params"], exp.client_weights
    c, d = x.shape
    check((c, d) == (32, CIFAR_PARAMS), f"cifar10-32 params {tuple(x.shape)}")
    err = 0.0
    for broadcast in (False, True):
        out = ck.weighted_average_clients(x, wt, broadcast)
        again = ck.weighted_average_clients(x, wt, broadcast)
        ref = ck.weighted_average_clients_reference(x, wt, broadcast)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        check(e <= 1e-5 and torch.equal(out, again),
              f"K1 at cifar10-32's ({c}, {d}), broadcast={broadcast}: max "
              f"abs err {e}, launches equal {torch.equal(out, again)}")
        err = max(err, e)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, blocks = ck._wavg_plan(d, sms)

    def composed():
        glob = ck.weighted_average_clients(x, wt)
        return torch.where(wt.sum() > 0, glob.expand_as(x), x)

    modes = {}
    for mode, broadcast, nbytes, library in (
            ("average", False, 4 * (x.numel() + c + d),
             lambda: torch.matmul(wt / wt.sum(), x)),
            ("broadcast", True, 4 * (2 * x.numel() + c), composed)):
        b, by = bound_ms(nbytes, 2.0 * x.numel())
        modes[mode] = {
            "ms": time_ms(lambda: ck.weighted_average_clients(x, wt,
                                                              broadcast)),
            "plain_ms": time_ms(lambda: ck.weighted_average_clients_reference(
                x, wt, broadcast)),
            "library_ms": time_ms(library),
            "back_to_back_ms": time_back_to_back_ms(
                lambda: ck.weighted_average_clients(x, wt, broadcast)),
            "bound_ms": b, "bound_by": by, "bytes": nbytes}
        r = modes[mode]
        print(f"time K1 {mode} cifar10-32 ({c}, {d}): kernel {r['ms']:.4f} "
              f"ms  plain {r['plain_ms']:.4f} ms  "
              f"{'matmul' if not broadcast else 'the chain it replaces'} "
              f"{r['library_ms']:.4f} ms  back to back "
              f"{r['back_to_back_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
              f"({by}, {nbytes / 1e6:.1f} MB); plan {threads} threads x "
              f"{blocks} blocks; max abs err {err:.3e}; {CARD['smi']}",
              flush=True)
    return {"max_abs_err": err, "clients": c, "params": d, **modes,
            "plan": {"threads": threads, "blocks": blocks}}


def k3_checks(gen: torch.Generator, dev: torch.device) -> dict:
    """K3 fused_mlp_forward against its plain version (1e-4) at the
    held-out split (2,000 rows), N = 100 and 1, a ragged 2,001, 100,000
    (several waves), a one-layer model and a wide one (the plan falls to a
    smaller tile at 100,000); two launches bitwise equal. Then timed at
    2,000 rows under its plan and its nearest tiles and block sizes."""
    from fedtpu_torch.models.mlp import mlp_init, param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    models = {}
    err = 0.0
    for dims, n in ((INCOME_DIMS, 2000), (INCOME_DIMS, 100), (INCOME_DIMS, 1),
                    (INCOME_DIMS, 2001), (INCOME_DIMS, 100_000),
                    ((14, 2), 2000), ((14, 50, 400, 2), 2000),
                    ((14, 50, 400, 2), 100_000), (WIDE_DIMS, 2000),
                    (WIDE_DIMS, 2001), (DEEP_WIDE_DIMS, 2000),
                    (DEEP_WIDE_DIMS, 1)):
        if dims not in models:
            models[dims] = mlp_init(gen, dims[0], dims[1:-1], dims[-1]).to(dev)
        flat = models[dims]
        xt = torch.randn(n, dims[0], generator=gen).to(dev)
        out = ck.fused_mlp_forward(flat, dims, xt)
        again = ck.fused_mlp_forward(flat, dims, xt)
        ref = ck.fused_mlp_forward_reference(flat, dims, xt)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        check(out.shape == ref.shape and e <= 1e-4,
              f"K3 {dims} at N={n}: max abs err {e} > 1e-4")
        check(torch.equal(out, again),
              f"K3 {dims} at N={n}: two launches differ")
        rows, threads, nbytes, blocks, cap = ck._forward_plan(
            n, param_count(dims), dims, sms)
        print(f"K3 fused_mlp_forward {dims} N={n}: max abs err {e:.3e}, two "
              f"launches bitwise equal; plan {rows}-row tiles, {threads} "
              f"threads, {blocks} blocks, {nbytes} bytes, "
              f"{f'streamed, {cap}-float buffers' if cap else 'resident'}",
              flush=True)
        err = max(err, e)
    flat = models[INCOME_DIMS]
    xt = torch.randn(2000, INCOME_DIMS[0], generator=gen).to(dev)
    d = param_count(INCOME_DIMS)
    rows, threads, nbytes, blocks, _ = ck._forward_plan(2000, d, INCOME_DIMS,
                                                        sms)
    check(blocks >= 125, f"K3 plan at N=2000: {blocks} blocks < 125")
    nb = 4 * (flat.numel() + xt.numel() + 2000 * INCOME_DIMS[-1])
    b, by = bound_ms(nb, mlp_flops(INCOME_DIMS, 2000))
    out = torch.empty(2000, INCOME_DIMS[-1], device=dev)
    by_tile = {}
    # The plan beside its neighbours: half and twice the tile, and two
    # warps fewer and more.
    for r, t in ((rows, threads), (rows // 2, threads), (rows * 2, threads),
                 (rows, threads - 64), (rows, threads + 64)):
        if r >= 1 and 32 <= t <= ck.THREADS_MAX:
            by_tile[f"{r}x{t}"] = time_ms(lambda: ck._launch_forward(
                flat, INCOME_DIMS, xt, out, r, t,
                ck._forward_bytes(d, INCOME_DIMS, r)))
    row = {"max_abs_err": err,
           "ms": time_ms(lambda: ck.fused_mlp_forward(flat, INCOME_DIMS, xt)),
           "plain_ms": time_ms(lambda: ck.fused_mlp_forward_reference(
               flat, INCOME_DIMS, xt)),
           "library_ms": None, "bound_ms": b, "bound_by": by,
           "back_to_back_ms": time_back_to_back_ms(
               lambda: ck.fused_mlp_forward(flat, INCOME_DIMS, xt)),
           "plan": {"rows": rows, "threads": threads, "blocks": blocks,
                    "smem_bytes": nbytes},
           "ms_by_tile_x_threads": by_tile}
    print(f"K3 plan at N=2000: {rows}-row tiles, {threads} threads, {blocks} "
          f"blocks on {sms} SMs; kernel time by tile x threads "
          f"{json.dumps(by_tile)}", flush=True)
    # The streamed path at the held-out split's 2,000 rows.
    row["by_shape"] = []
    for label, dims in (("(256, 256), streamed", WIDE_DIMS),
                        ("(200, 200, 200), streamed", DEEP_WIDE_DIMS)):
        flat = models[dims]
        nb = 4 * (flat.numel() + xt.numel() + 2000 * dims[-1])
        b, by = bound_ms(nb, mlp_flops(dims, 2000))
        row["by_shape"].append({
            "shape": label, "dims": list(dims), "rows": 2000,
            "ms": time_ms(lambda: ck.fused_mlp_forward(flat, dims, xt)),
            "plain_ms": time_ms(lambda: ck.fused_mlp_forward_reference(
                flat, dims, xt)),
            "bound_ms": b, "bound_by": by})
        r = row["by_shape"][-1]
        print(f"time fused_mlp_forward {label} N=2000: kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{b:.5f} ms ({by})", flush=True)
    return row


def k4_checks(gen: torch.Generator, dev: torch.device) -> dict:
    """K4 ring_all_reduce_sum: bitwise equal to its plain version at the
    sharded round's payload (8 shards x income's 11,352 params + the weight
    total) and at edge shapes (2, 3 and 16 shards; lengths that are not a
    multiple of 4). Each call makes one allocation (its output: no padded
    copy) and no host synchronisation."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    payload = param_count(INCOME_DIMS) + 1
    for s, p in ((SHARDS, payload), (2, payload), (3, 1001), (16, payload),
                 (SHARDS, 7), (SHARDS, 4096)):
        x = torch.randn(s, p, generator=gen).to(dev)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ck.ring_all_reduce_sum(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        ref = ck.ring_all_reduce_sum_reference(x)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and torch.equal(out, ref),
              f"K4 at ({s}, {p}): not bitwise equal to the plain version "
              f"(max abs diff {float((out - ref).abs().max())})")
        check(allocs == 1, f"K4 at ({s}, {p}): {allocs} allocations, not 1")
        print(f"K4 ring_all_reduce_sum ({s}, {p}): bitwise equal, one "
              "allocation, no host sync", flush=True)
    with_many = torch.zeros(ck.RING_MAX_SHARDS + 1, 8, device=dev)
    try:
        ck.ring_all_reduce_sum(with_many)
        check(False, "K4 took more shards than its pointer table holds")
    except ValueError:
        pass
    x = torch.randn(SHARDS, payload, generator=gen).to(dev)
    nbytes = 2 * x.numel() * 4
    b, by = bound_ms(nbytes, float((SHARDS - 1) * x.numel()))
    return {"max_abs_err": 0.0,
            "ms": time_ms(lambda: ck.ring_all_reduce_sum(x)),
            "plain_ms": time_ms(lambda: ck.ring_all_reduce_sum_reference(x)),
            "library_ms": time_ms(lambda: x.sum(dim=0)),
            "bound_ms": b, "bound_by": by}


def noniid_batch() -> dict:
    """income-32-noniid's packed batch (CPU tensors) at 10,000 rows."""
    from fedtpu_torch.orchestration.loop import build_experiment
    return build_experiment(sharded_config("ring", 1.0, 1),
                            device="cpu").batch


def main_path_config():
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-8")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=10000),
        fed=dataclasses.replace(cfg.fed, rounds=100),
        run=dataclasses.replace(cfg.run, eval_test_every=10))


def phase_run(label: str, cfg, expect: dict, capture=None,
              min_accuracy: float = 0.9):
    """One run of ``run_experiment`` on the card with every launch count set
    to 0 just before it and read just after. ``expect`` maps a kernel to
    its launches: "rounds" (one per round trained, the graphs' warm-up
    round included, and one per round in each graph's replay), "rounds+1"
    (the same and one after the loop), "evals"
    (at least one per held-out eval, and at least one, none in a graph),
    or an exact number. ``capture``: run_experiment's (None: every chunk a
    graph replay; False: the uncaptured step). The final client-mean
    accuracy must exceed ``min_accuracy``."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(cfg, verbose=False, device="cuda", capture=capture)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    n_evals = len(res.test_metrics["accuracy"])
    print(f"{label} launches: {launches}  test evals {n_evals}; rounds "
          f"trained {res.rounds_trained}, graph warm-up rounds "
          f"{res.warmup_rounds}, launches per graph replay by chunk width "
          f"{json.dumps(res.graph_launches)}", flush=True)
    check(not res.diverged, f"{label} diverged")
    check(res.warmup_rounds == (1 if res.graph_launches else 0),
          f"{label}: {res.warmup_rounds} warm-up rounds, not one before "
          f"the first of {len(res.graph_launches)} graphs")
    check(capture is not False or not res.graph_launches,
          f"{label}: graphs captured in an uncaptured run")
    check(capture is False or bool(res.graph_launches),
          f"{label}: no graph captured on the card")
    for name, want in expect.items():
        got = launches[name]
        for width, per_replay in res.graph_launches.items():
            replay_want = (width if want in ("rounds", "rounds+1") else
                           0 if want == "evals" else None)
            check(replay_want is None or per_replay[name] == replay_want,
                  f"{label}: {name} launches {per_replay[name]} per replay "
                  f"of the {width}-round graph, not {replay_want}")
        if want in ("rounds", "rounds+1"):
            # "rounds+1": one more launch after the loop (personalization).
            extra = int(want == "rounds+1")
            check(got == res.rounds_trained + res.warmup_rounds + extra,
                  f"{label}: {name} launches {got} != rounds trained "
                  f"{res.rounds_trained} + warm-up rounds "
                  f"{res.warmup_rounds} + {extra}")
        elif want == "evals":
            check(got >= max(n_evals, 1),
                  f"{label}: {name} launches {got} fewer than the held-out "
                  f"evals ({n_evals}) or none")
        else:
            check(got == want, f"{label}: {name} launches {got} != {want}")
    for hist in (res.global_metrics, res.pooled_metrics, res.test_metrics):
        for k, v in hist.items():
            check(bool(np.all(np.isfinite(v))), f"{label}: non-finite {k}")
    check(all(np.all(np.isfinite(l)) for l in res.loss),
          f"{label}: non-finite loss")
    acc = res.global_metrics["accuracy"][-1]
    check(acc > min_accuracy, f"{label}: final client-mean accuracy {acc} "
          f"<= {min_accuracy}")
    steady = res.sec_per_round[1:] or res.sec_per_round
    print(f"{label}: rounds run {res.rounds_run}, early stop at round "
          f"{res.rounds_run if res.stopped_early else None}, final "
          f"client-mean accuracy {acc:.4f}, test accuracy "
          f"{res.test_metrics['accuracy'][-1] if n_evals else None}, "
          f"s/round {statistics.mean(steady):.6e} (mean of rounds 2..), "
          f"wall {wall:.3f} s", flush=True)
    return res, launches


# The largest card-vs-CPU logit drift the CSV phase forgives a moved row
# within: about twice the 5.44e-3 measured there on sound runs (PERF.md §6).
CSV_DRIFT_CAP = 1e-2


def replay_near_ties(cfg, rounds: set) -> dict:
    """Near-tie rows per client of the trained (pre-average) models at the
    given 0-based rounds, by replaying the run from its public pieces (the
    round step, and the train step alone with the round's participation
    mask and SCAFFOLD's correction for the pre-average models) on the CPU
    and, in lockstep, on the card (the uncaptured step, bitwise the
    captured one). Returns round ->
    (rows whose CPU-model top-two logit gap is below ``NEAR_TIE_REL`` of
    its largest logit, rows whose gap is below that or below twice the
    drift, the drift): the drift is the largest card-vs-CPU logit
    difference of that round's models, and a row inside it may be counted
    in different cells."""
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel.round import participation_mask
    from fedtpu_torch.training.client import make_local_train_step
    sides = []
    for device in ("cpu", "cuda"):
        exp = build_experiment(cfg, device=device)
        sides.append({"exp": exp, "state": exp.state,
                      "step": exp.make_step(1),
                      "train": make_local_train_step(
                          exp.model, build_optimizer(cfg.optim),
                          cfg.fed.local_steps, cfg.fed.prox_mu)})
    out = {}
    for r in range(max(rounds) + 1):
        if r in rounds:
            part = (participation_mask(
                cfg.shard.num_clients, cfg.fed.participation_rate,
                cfg.fed.participation_seed, r)
                if cfg.fed.participation_rate < 1.0 else None)
            logits = []
            for side in sides:
                b = side["exp"].batch
                p = None if part is None else part.to(b["x"].device)
                st = side["state"]
                corr = (st["server_cv"][None] - st["client_cv"]
                        if "client_cv" in st else None)
                params, _, _ = side["train"](st["params"], st["opt_state"],
                                             b["x"], b["y"], b["mask"], p,
                                             corr)
                logits.append(side["exp"].model.apply(params, b["x"]).cpu())
            out[r] = near_ties(logits, sides[0]["exp"].batch["mask"] > 0)
        for side in sides:
            side["state"], _ = side["step"](side["state"], side["exp"].batch)
    return out


def near_ties(logits: list, mask: torch.Tensor) -> tuple:
    """``replay_near_ties``' triple for one round from the CPU's and the
    card's logits of the evaluated models: near-tie rows of the CPU model,
    rows inside twice the drift too, and the drift."""
    from fedtpu_torch.ops.metrics import near_tie_rows
    drift = float(((logits[0] - logits[1]).abs().amax(dim=-1)
                   * mask).max())
    top2 = torch.topk(logits[0], 2, dim=-1).values
    ties = near_tie_rows(logits[0]) & mask
    inside = ties | ((top2[..., 0] - top2[..., 1]) < 2 * drift) & mask
    return ties.sum(dim=1).numpy(), inside.sum(dim=1).numpy(), drift


def phase_card_vs_cpu(cfg, gpu, label: str = "card vs CPU",
                      drift_cap=None, loss_tol: float = 1e-4,
                      replay=replay_near_ties):
    """The card run ``gpu`` against the same config on the CPU: the same
    stop round, the same staleness (the asynchronous engine), losses
    within ``loss_tol``, and confusion counts equal but on rows that are
    near ties of the CPU model (``replay``: the engine's replay of the
    evaluated models). With ``drift_cap`` a row also counts as a near tie
    when its gap is inside twice the two runs' logit drift, and the drift
    must stay within the cap. Returns the CPU run."""
    from fedtpu_torch.orchestration.loop import run_experiment
    cpu = run_experiment(cfg, verbose=False, device="cpu")
    check(cpu.rounds_run == gpu.rounds_run
          and cpu.stopped_early == gpu.stopped_early,
          f"early stop differs: card {gpu.rounds_run} vs cpu "
          f"{cpu.rounds_run}")
    check(len(cpu.staleness) == len(gpu.staleness) and all(
        np.array_equal(a, b) for a, b in zip(gpu.staleness, cpu.staleness)),
        f"{label}: staleness differs between card and CPU")
    loss_err = max(float(np.abs(a - b).max())
                   for a, b in zip(gpu.loss, cpu.loss))
    check(loss_err <= loss_tol,
          f"{label}: loss max abs err {loss_err} > {loss_tol}")
    moved = {r: np.abs(a - b).sum(axis=(1, 2)) / 2
             for r, (a, b) in enumerate(zip(gpu.confusion, cpu.confusion))
             if not np.array_equal(a, b)}
    ties = replay(cfg, set(moved)) if moved else {}
    for r, rows in moved.items():
        near, inside, drift = ties[r]
        allowed = near if drift_cap is None else inside
        check(bool(np.all(rows <= allowed)),
              f"round {r + 1}: confusion counts differ on {rows.tolist()} "
              f"rows per client, near-tie rows {allowed.tolist()} (card "
              f"vs CPU logit drift {drift:.3e})")
        check(drift_cap is None or drift <= drift_cap,
              f"round {r + 1}: card vs CPU logit drift {drift:.3e} above "
              f"{drift_cap}")
    print(f"{label}: same stop round {cpu.rounds_run}, loss max abs err "
          f"{loss_err:.3e}, rounds with near-tie count differences "
          f"{sorted(r + 1 for r in moved)}, rows moved "
          f"{[int(rows.sum()) for rows in moved.values()]}, card vs CPU "
          f"logit drift there {[f'{t[2]:.3e}' for t in ties.values()]}",
          flush=True)
    return cpu


def composed_round(exp):
    """One composed round of ``exp`` as ``step(state) -> (state, loss,
    conf)``."""
    step = exp.make_step(1)

    def go(state):
        state, raw = step(state, exp.batch)
        return state, raw["loss"], raw["conf"]

    return go


def captured_round(width: int = 1):
    """``make_round`` for ``phase_profile``: ``width`` rounds of ``exp`` as
    one replay of the CUDA graph the loop captures (``capture_round_step``),
    its packed outputs read once, as the loop reads them."""
    def make(exp):
        from fedtpu_torch.parallel.round import (capture_round_step,
                                                 warm_up_round)
        warm_up_round(exp.make_step(1), exp.state, exp.batch)
        graph = capture_round_step(exp.make_step(width), exp.state,
                                   exp.batch)

        def go(state):
            return state, graph()

        return go
    return make


def phase_profile(cfg, rounds: int = 20, label: str = "profile",
                  make_round=composed_round, width: int = 1) -> dict:
    """Where a steady-state round's time goes: the round step (``make_round
    (exp)``, ``width`` rounds a call) plus its outputs' fetch, timed on the
    host clock, against the device time of each kernel in it
    (torch.profiler) — the device's idle share. Returns the per-round host
    and device milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fedtpu_torch.orchestration.loop import build_experiment
    exp = build_experiment(cfg, device="cuda")
    step = make_round(exp)
    state = exp.state
    calls = max(1, rounds // width)
    rounds = calls * width

    def run(n):
        nonlocal state
        for _ in range(n):
            state, *outs = step(state)
            for out in outs:
                out.cpu()
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(calls)
    wall_ms = (time.perf_counter() - t0) / rounds * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(calls)
        traced_ms = (time.perf_counter() - t0) / rounds * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / rounds / 1e3
    ops = sum(e.count for e in dev) / rounds
    # The idle share against the untraced window's host clock, and against
    # the traced window's own (tracing slows a device-bound round, so its
    # kernels can sum past the untraced host time).
    print(f"{label}: round step + fetch {wall_ms:.4f} ms/round on the host "
          f"clock; device busy {busy_ms:.4f} ms/round in {ops:.1f} device "
          f"ops; idle share {1 - busy_ms / wall_ms:.3f}; traced window "
          f"{traced_ms:.4f} ms/round on the host clock, idle share there "
          f"{1 - busy_ms / traced_ms:.3f}", flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / rounds / 1e3:.4f} ms/round "
              f"x{e.count / rounds:.0f}  {e.key[:90]}", flush=True)
    return {"host_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ops": ops, "idle_share": 1 - busy_ms / wall_ms,
            "traced_host_ms": traced_ms,
            "traced_idle_share": 1 - busy_ms / traced_ms}


def sharded_config(aggregation: str, rate: float, rounds: int):
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-32-noniid")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=10000),
        fed=dataclasses.replace(cfg.fed, rounds=rounds,
                                aggregation=aggregation,
                                participation_rate=rate),
        run=dataclasses.replace(cfg.run, eval_test_every=10,
                                mesh_devices=SHARDS))


def wide_config():
    """income-2 at hidden_sizes=(256, 256): a model K2 and K3 stream."""
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-2")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=10000),
        model=dataclasses.replace(cfg.model, hidden_sizes=WIDE_DIMS[1:-1]),
        fed=dataclasses.replace(cfg.fed, rounds=60),
        run=dataclasses.replace(cfg.run, eval_test_every=10))


def sampled_psum_config():
    cfg = main_path_config()
    return cfg.replace(fed=dataclasses.replace(cfg.fed, rounds=30,
                                               participation_rate=0.5))


def phase_sharded() -> dict:
    """Phase 7: the sharded round's three runs, then client sampling on the
    psum path (K1 under sampling); returns each run's launches by label."""
    ring = {"ring_all_reduce_sum": "rounds", "fused_eval_confusion": "rounds",
            "fused_mlp_forward": "evals", "weighted_average_clients": 0}
    by_path = {}
    for label, cfg, expect in (
            ("income-32-noniid ring", sharded_config("ring", 1.0, 100), ring),
            ("income-32-noniid ring-rsag",
             sharded_config("ring-rsag", 1.0, 30),
             {**ring, "ring_all_reduce_sum": 0}),
            ("income-32-noniid ring sampled 0.5",
             sharded_config("ring", 0.5, 30), ring),
            ("income-8 psum sampled 0.5", sampled_psum_config(),
             {**ring, "ring_all_reduce_sum": 0,
              "weighted_average_clients": "rounds"})):
        gpu, launches = phase_run(label, cfg, expect)
        phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU")
        if label == "income-32-noniid ring":
            phase_profile(cfg, label=f"{label} profile")
        by_path[label] = launches
    return by_path

# The income CSV's schema (adult income): 6 numeric and 9 string columns,
# the label among them; the strings carry the data's leading space.
CSV_NUMERIC = ("age", "fnlwgt", "education-num", "capital-gain",
               "capital-loss", "hours-per-week")
CSV_STRINGS = {
    "workclass": ("Private", "Self-emp-not-inc", "Self-emp-inc",
                  "Federal-gov", "Local-gov", "State-gov"),
    "education": ("HS-grad", "Some-college", "Bachelors", "Masters",
                  "Assoc-voc", "11th", "Doctorate", "Prof-school"),
    "marital-status": ("Married-civ-spouse", "Never-married", "Divorced",
                       "Separated", "Widowed"),
    "occupation": ("Exec-managerial", "Prof-specialty", "Craft-repair",
                   "Adm-clerical", "Sales", "Other-service",
                   "Machine-op-inspct", "Tech-support"),
    "relationship": ("Husband", "Not-in-family", "Own-child", "Unmarried",
                     "Wife", "Other-relative"),
    "race": ("White", "Black", "Asian-Pac-Islander", "Amer-Indian-Eskimo",
             "Other"),
    "sex": ("Male", "Female"),
    "native-country": ("United-States", "Mexico", "Philippines", "Germany",
                       "India", "Canada")}
CSV_COLUMNS = ("age", "workclass", "fnlwgt", "education", "education-num",
               "marital-status", "occupation", "relationship", "race", "sex",
               "capital-gain", "capital-loss", "hours-per-week",
               "native-country", "income")


def write_income_csv(path: str, rows: int = 10000, seed: int = 0) -> str:
    """A CSV with the income data's 15 columns, made from ``seed``: the
    label " >50K" / " <=50K" follows a noisy score of education, hours, age,
    capital gain and marriage (split at its median, so the classes are
    balanced), so the model has something to learn."""
    rng = np.random.default_rng(seed)
    cols = {name: rng.integers(0, len(vals), rows)
            for name, vals in CSV_STRINGS.items()}
    edu_num = np.array([9, 10, 13, 14, 11, 7, 16, 15])[cols["education"]]
    age = rng.integers(17, 91, rows)
    hours = np.clip(rng.normal(40, 12, rows).round(), 1, 99).astype(int)
    gain = np.where(rng.random(rows) < 0.08,
                    rng.integers(3000, 99999, rows), 0)
    loss = np.where(rng.random(rows) < 0.05,
                    rng.integers(100, 4000, rows), 0)
    married = np.isin(cols["relationship"], (0, 4))
    score = (0.9 * (edu_num - 10) + 0.08 * (hours - 40) + 0.05 * (age - 38)
             + 3.0 * (gain > 0) + 1.8 * married
             + rng.normal(0.0, 0.4, rows))
    cut = np.median(score)      # balanced, as balanced_income_data.csv
    numeric = {"age": age, "fnlwgt": rng.integers(12000, 1500000, rows),
               "education-num": edu_num, "capital-gain": gain,
               "capital-loss": loss, "hours-per-week": hours}
    with open(path, "w") as f:
        f.write(",".join(CSV_COLUMNS) + "\n")
        for i in range(rows):
            cells = []
            for name in CSV_COLUMNS:
                if name in numeric:
                    cells.append(str(int(numeric[name][i])))
                elif name == "income":
                    cells.append(" >50K" if score[i] > cut else " <=50K")
                else:
                    cells.append(" " + CSV_STRINGS[name][cols[name][i]])
            f.write(",".join(cells) + "\n")
    return path


def csv_config(path: str):
    cfg = main_path_config()
    return cfg.replace(data=dataclasses.replace(cfg.data, csv_path=path))


PSUM = {"weighted_average_clients": "rounds", "fused_eval_confusion": "rounds",
        "fused_mlp_forward": "evals", "ring_all_reduce_sum": 0}
RING = {"ring_all_reduce_sum": "rounds", "fused_eval_confusion": "rounds",
        "fused_mlp_forward": "evals", "weighted_average_clients": 0}


def phase_csv(directory: str) -> dict:
    """Phase (a): income-8 from a 10,000-row CSV of the income schema, on
    the card and on the CPU."""
    from fedtpu_torch.data.tabular import load_tabular_dataset
    path = write_income_csv(os.path.join(directory, "income.csv"))
    cfg = csv_config(path)
    ds = load_tabular_dataset(cfg.data)
    check(ds.input_dim == 14 and ds.num_classes == 2
          and list(ds.label_classes) == [" <=50K", " >50K"],
          f"CSV: {ds.input_dim} features, classes {list(ds.label_classes)}")
    print(f"CSV {path}: {len(ds.y_train) + len(ds.y_test)} rows, 14 "
          f"features, label classes {list(ds.label_classes)}, share of "
          f"' >50K' {float(np.mean(ds.y_train)):.3f}", flush=True)
    gpu, launches = phase_run("income-8 from the CSV", cfg, PSUM)
    phase_card_vs_cpu(cfg, gpu, label="income-8 from the CSV card vs CPU",
                      drift_cap=CSV_DRIFT_CAP)
    return {"income-8 CSV": launches}


def local_steps_config(aggregation: str):
    cfg = sharded_config(aggregation, 1.0, 100)
    return cfg.replace(fed=dataclasses.replace(cfg.fed, local_steps=5,
                                               prox_mu=0.01))


def phase_local_steps() -> dict:
    """Phase (b): income-32-noniid with 5 local steps and FedProx (mu 0.01)
    on psum and on ring, on the card and on the CPU."""
    by_path = {}
    for aggregation, expect in (("psum", PSUM), ("ring", RING)):
        label = f"income-32-noniid {aggregation} local_steps=5 prox_mu=0.01"
        cfg = local_steps_config(aggregation)
        gpu, by_path[label] = phase_run(label, cfg, expect)
        phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU")
    return by_path


def with_run(cfg, **kw):
    return cfg.replace(run=dataclasses.replace(cfg.run, **kw))


def with_fed(cfg, **kw):
    return cfg.replace(fed=dataclasses.replace(cfg.fed, **kw))


def same_history(a, b) -> list:
    """Where two results differ: per-round losses, confusion counts and
    staleness (the asynchronous engine's), every history, the stop round
    and the final params, all bitwise."""
    diffs = []
    if (a.rounds_run, a.stopped_early) != (b.rounds_run, b.stopped_early):
        diffs.append(f"stop {a.rounds_run}/{a.stopped_early} vs "
                     f"{b.rounds_run}/{b.stopped_early}")
    for name in ("loss", "confusion", "staleness"):
        x, y = getattr(a, name), getattr(b, name)
        if len(x) != len(y) or not all(np.array_equal(p, q)
                                       for p, q in zip(x, y)):
            diffs.append(name)
    for name in ("global_metrics", "pooled_metrics", "test_metrics"):
        if getattr(a, name) != getattr(b, name):
            diffs.append(name)
    from fedtpu_torch.models.registry import tree_leaves
    pairs = zip(tree_leaves(a.final_params), tree_leaves(b.final_params))
    if not all(pa == pb and np.array_equal(x, y)
               for (pa, x), (pb, y) in pairs):
        diffs.append("final params")
    return diffs


def finite_flag_checks(cfg) -> None:
    """The round step's finiteness flag (``state_finite``) on the card:
    true on income-8's state, false with one NaN, +inf or -inf at the
    first, a middle or the last entry of params, mu or nu."""
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel.round import state_finite
    state = build_experiment(cfg, device="cuda").state
    check(bool(state_finite(state)), "finite flag false on a finite state")
    cases = 0
    for leaf in ("params", "mu", "nu"):
        for bad in (float("nan"), float("inf"), -float("inf")):
            for where in (0, state["params"].numel() // 2 + 7, -1):
                poisoned = {"params": state["params"].clone(),
                            "opt_state": {k: v.clone() for k, v in
                                          state["opt_state"].items()}}
                t = (poisoned["params"] if leaf == "params"
                     else poisoned["opt_state"][leaf])
                t.view(-1)[where] = bad
                check(not bool(state_finite(poisoned)),
                      f"finite flag true with {bad} in {leaf}[{where}]")
                cases += 1
    print(f"finite flag: true on income-8's state, false in all {cases} "
          "poisoned states (NaN, +inf, -inf at three places of params, mu "
          "and nu)", flush=True)


def phase_capture(composed: dict) -> dict:
    """Phase (c): each case run uncaptured (``capture=False``) and captured
    (every chunk a graph replay) in this one call: histories bitwise equal,
    launches per round equal, and the s/round of both (the median over the
    run's rounds: the chunks that capture a graph carry its capture time).
    Then 20 captured rounds of income-8 profiled at R = 1 and R = 10,
    beside phase 6's composed round (``composed``)."""
    base = main_path_config()
    finite_flag_checks(base)
    cases = (
        ("income-8 R=1", base, PSUM),
        # Early stopping off (patience past the rounds) so that the run
        # reaches its 5-round tail chunk, the second graph width.
        ("income-8 R=10, 95 rounds, tail chunk 5",
         with_run(with_fed(base, rounds=95, termination_patience=1000),
                  rounds_per_step=10), PSUM),
        ("income-32-noniid ring R=10",
         with_run(sharded_config("ring", 1.0, 100), rounds_per_step=10),
         RING),
        ("income-8 sampled 0.5 R=10",
         with_run(sampled_psum_config(), rounds_per_step=10), PSUM))
    by_path = {}
    for label, cfg, expect in cases:
        plain, _ = phase_run(f"{label} uncaptured", cfg, expect,
                             capture=False)
        graph, by_path[label] = phase_run(f"{label} captured", cfg, expect)
        diffs = same_history(plain, graph)
        check(not diffs, f"{label}: captured run differs from the "
              f"uncaptured one in {diffs}")
        s_plain = statistics.median(plain.sec_per_round)
        s_graph = statistics.median(graph.sec_per_round)
        print(f"{label}: captured == uncaptured bitwise (losses, confusion "
              f"counts, histories, stop round {graph.rounds_run}, final "
              f"params); s/round (median) uncaptured {s_plain:.6e}, "
              f"captured {s_graph:.6e}, ratio {s_plain / s_graph:.3f}; "
              f"{CARD['smi']}", flush=True)
    print(f"composed round profile (phase 6): host {composed['host_ms']:.4f}"
          f" ms/round, device busy {composed['device_busy_ms']:.4f} ms in "
          f"{composed['device_ops']:.1f} ops, idle share "
          f"{composed['idle_share']:.3f}; {CARD['smi']}", flush=True)
    for width in (1, 10):
        p = phase_profile(base, label=f"income-8 captured R={width} profile",
                          make_round=captured_round(width), width=width)
        print(f"income-8 captured R={width}: host {p['host_ms']:.4f} "
              f"ms/round against {composed['host_ms']:.4f} composed, idle "
              f"share {p['idle_share']:.3f} against "
              f"{composed['idle_share']:.3f}; {CARD['smi']}", flush=True)
    return by_path


def resume_is_bitwise(label: str, cfg, at_resume=None):
    """``cfg`` checkpointed every 10 rounds for 20 rounds, then resumed to
    round 40, against the uninterrupted 40 rounds: bitwise the same
    client-mean history, losses, confusion counts, staleness, held-out
    metrics (one eval every 10 rounds) and final params. ``at_resume``:
    called with the checkpoint directory before the resume. Returns the
    uninterrupted and the resumed run."""
    import tempfile
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    from fedtpu_torch.orchestration.loop import run_experiment
    full = run_experiment(with_fed(cfg, rounds=40), verbose=False,
                          device="cuda")
    with tempfile.TemporaryDirectory() as d:
        ck_cfg = with_run(cfg, checkpoint_dir=d, checkpoint_every=10)
        first = run_experiment(with_fed(ck_cfg, rounds=20), verbose=False,
                               device="cuda")
        check(complete_steps(d) == [10, 20] and first.rounds_run == 20,
              f"resume {label}: checkpoints {complete_steps(d)}")
        if at_resume is not None:
            at_resume(d)
        resumed = run_experiment(with_fed(ck_cfg, rounds=40), verbose=False,
                                 device="cuda", resume=True)
        check(complete_steps(d) == [10, 20, 30, 40],
              f"resume {label}: checkpoints {complete_steps(d)}")
    # The resumed run holds the first leg's client-mean history and its
    # own 20 rounds of everything else.
    check(resumed.global_metrics == full.global_metrics,
          f"resume {label}: client-mean history differs")
    tail = dataclasses.replace(
        full, loss=full.loss[20:], confusion=full.confusion[20:],
        staleness=full.staleness[20:],
        pooled_metrics={k: v[20:] for k, v in full.pooled_metrics.items()},
        test_metrics={k: v[2:] for k, v in full.test_metrics.items()})
    diffs = [d for d in same_history(resumed, tail)
             if d not in ("global_metrics",)]
    check(not diffs, f"resume {label}: differs from the uninterrupted run "
          f"in {diffs}")
    print(f"resume {label}: 20 rounds, checkpoint, resume to 40 == the "
          "uninterrupted 40 rounds bitwise (client-mean history, losses, "
          "confusion counts, held-out metrics, final params)", flush=True)
    return full, resumed


def phase_resume() -> None:
    """Phase (d): income-8 with checkpoints for 20 rounds, then resumed to
    round 40, bitwise the uninterrupted 40 rounds (``resume_is_bitwise``);
    synchronous at R = 1 and pipelined at R = 5, whose history also equals
    the synchronous run's. The early-stop countdown is not part of a
    checkpoint (as in fedtpu), so these runs keep early stopping out of
    their 40 rounds."""
    base = with_fed(main_path_config(), termination_patience=1000)
    sync, _ = resume_is_bitwise("synchronous R=1", base)
    piped, _ = resume_is_bitwise("pipelined R=5", with_run(
        base, pipelined_stop=True, rounds_per_step=5))
    diffs = same_history(sync, piped)
    check(not diffs, f"pipelined R=5 differs from synchronous R=1 in {diffs}")
    print("pipelined R=5 == synchronous R=1 bitwise over 40 rounds",
          flush=True)


# The A6 phase: income-32-noniid (10,000 rows, 8 shards on the card) under
# each branch of the rest of the synchronous round.
A6_ROUNDS = 40
NO_K1 = {**PSUM, "weighted_average_clients": 0}
# DP-FedAvg: uniform weights, clip (adaptive, from 1.0), noise multiplier 1
# (the delta at the split's z_delta, the count at 2), client sampling 0.5.
DP_KNOBS = dict(weighting="uniform", dp_clip_norm=1.0,
                dp_noise_multiplier=1.0, dp_adaptive_clip=True,
                dp_count_noise_multiplier=2.0)


def a6_config(rounds: int = A6_ROUNDS, rate: float = 1.0, **fed):
    return with_fed(sharded_config("psum", rate, rounds), **fed)


def a6_cases() -> dict:
    """label -> (config, expected launches) of the A6 phase; the delta
    path sums through K1's sum mode once a round, the robust rules and
    the int8 exchange never launch K1."""
    return {
        "fedadam": (a6_config(server_opt="fedadam", server_lr=0.01), PSUM),
        "DP-FedAvg": (a6_config(rate=0.5, **DP_KNOBS), PSUM),
        "median, 3 Byzantine": (a6_config(
            weighting="uniform", robust_aggregation="median",
            byzantine_clients=3), NO_K1),
        "krum, 3 Byzantine": (a6_config(
            weighting="uniform", robust_aggregation="krum", krum_f=3,
            byzantine_clients=3), NO_K1),
        "SCAFFOLD": (a6_config(weighting="uniform", scaffold=True,
                               local_steps=3), PSUM),
        "int8 over 8 shards": (a6_config(compress="int8"), NO_K1),
        "fedavgm": (a6_config(20, server_opt="fedavgm"), PSUM),
        "trimmed_mean": (a6_config(20, weighting="uniform",
                                   robust_aggregation="trimmed_mean"),
                         NO_K1)}


def noise_draw_cost(dp_cfg, width: int = 10, chunks: int = 30) -> float:
    """Host milliseconds of one chunk's DP noise on its way to the card, as
    the loop sends it: the host draw of ``width`` rounds, the pinned copy
    and the transfer (median over ``chunks`` chunks)."""
    import time as clock
    from fedtpu_torch.orchestration.loop import build_experiment
    step = build_experiment(dp_cfg, device="cuda").make_step(width)
    times = []
    for i in range(chunks):
        torch.cuda.synchronize()
        t0 = clock.perf_counter()
        host = step.draw_noise(i * width, width).pin_memory()
        host.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        times.append((clock.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"DP noise draw, income-32-noniid R={width}: {ms:.4f} ms a chunk "
          f"on the host ({host.shape[1]} floats a round: draw, pin, copy), "
          f"{ms / width:.4f} ms a round; {CARD['smi']}", flush=True)
    return ms


def phase_a6() -> dict:
    """Phase (e): the rest of the synchronous round on income-32-noniid at
    10,000 rows over 8 shards: fedadam, DP-FedAvg (clip, noise, sampling
    0.5, uniform weights, adaptive clip with count noise), the median and
    Krum with 3 Byzantine clients, SCAFFOLD (3 local steps), the int8
    exchange, and fedavgm and the trimmed mean over 20 rounds. Each run's
    launches counted from zero and held against the same config on the
    CPU; the DP and SCAFFOLD runs at R = 10 captured against uncaptured,
    bitwise, with the median s/round of both; the DP run resumed 20 -> 40
    bitwise the uninterrupted run, with the same privacy spend; the noise
    draw's host cost; K1's sum mode at the delta path's (32, 11,352)
    under 0/1 weights. Returns each run's launches by label and K1's
    row."""
    cases = a6_cases()
    by_path = {}
    for name, (cfg, expect) in cases.items():
        label = f"income-32-noniid {name}"
        card_cfg = cfg
        if name in BRANCH_GANGS:
            # Phase (x)'s oracle: this run with its checkpoints and
            # metrics (neither changes a round's math).
            d = os.path.join(branch_dir(), name.split(",")[0])
            os.makedirs(d)
            card_cfg = with_run(cfg, checkpoint_dir=os.path.join(d, "ck"),
                                checkpoint_every=TRAIN_GANG_CKPT_EVERY,
                                metrics_jsonl=os.path.join(d, "m.jsonl"))
        gpu, by_path[label] = phase_run(label, card_cfg, expect)
        if name in BRANCH_GANGS:
            BRANCH_ORACLES[name] = {"result": gpu, "launches": by_path[label],
                                    "dir": d, "cfg": cfg}
        phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU")
        if gpu.final_dp_clip is not None:
            print(f"{label}: final adaptive clip {gpu.final_dp_clip:.6e}, "
                  f"privacy spent {json.dumps(gpu.privacy_spent())}",
                  flush=True)
    for label in ("DP-FedAvg", "SCAFFOLD"):
        cfg, expect = cases[label]
        cfg = with_run(cfg, rounds_per_step=10)
        label = f"income-32-noniid {label} R=10"
        plain, _ = phase_run(f"{label} uncaptured", cfg, expect,
                             capture=False)
        graph, by_path[label] = phase_run(f"{label} captured", cfg, expect)
        diffs = same_history(plain, graph)
        if plain.final_dp_clip != graph.final_dp_clip:
            diffs.append("final clip")
        if plain.privacy_spent() != graph.privacy_spent():
            diffs.append("privacy spend")
        check(not diffs, f"{label}: captured run differs from the "
              f"uncaptured one in {diffs}")
        s_plain = statistics.median(plain.sec_per_round)
        s_graph = statistics.median(graph.sec_per_round)
        print(f"{label}: captured == uncaptured bitwise (losses, confusion "
              f"counts, histories, stop round {graph.rounds_run}, final "
              f"params and clip); s/round (median) uncaptured "
              f"{s_plain:.6e}, captured {s_graph:.6e}, ratio "
              f"{s_plain / s_graph:.3f}; {CARD['smi']}", flush=True)
    dp_cfg = cases["DP-FedAvg"][0]
    full, resumed = resume_is_bitwise(
        "income-32-noniid DP-FedAvg",
        with_fed(dp_cfg, termination_patience=1000))
    spent, again = full.privacy_spent(), resumed.privacy_spent()
    same = ("epsilon", "delta", "rdp_order", "rounds")
    check({k: again[k] for k in same} == {k: spent[k] for k in same}
          and again.get("composed_over_resumed_segments")
          and resumed.final_dp_clip == full.final_dp_clip,
          f"resumed DP run spent {again}, clip {resumed.final_dp_clip}; "
          f"uninterrupted {spent}, clip {full.final_dp_clip}")
    print(f"resume income-32-noniid DP-FedAvg: privacy spend equal "
          f"(epsilon {spent['epsilon']:.6f} at delta {spent['delta']}, "
          f"{spent['rounds']} rounds), final clip equal", flush=True)
    noise_draw_cost(dp_cfg)
    from fedtpu_torch.models.mlp import param_count
    return by_path, k1_sum_row(torch.device("cuda"), param_count(INCOME_DIMS),
                               "the one-process delta path "
                               "(income-32-noniid)", rows=32, binary=True)


def sweep_config():
    """The grid's data: income-8 at the income CSV's 10,000 synthetic rows
    (8 clients of 1,000 train rows)."""
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-8")
    return cfg.replace(data=dataclasses.replace(cfg.data,
                                                synthetic_rows=10000))


def padded_entries(true_dims, bucket_dims) -> torch.Tensor:
    """The entries of a bucket-padded flat model that lie outside the
    architecture's true dims (bool, ``(P,)`` at ``bucket_dims``)."""
    from fedtpu_torch.models.mlp import param_count, unflatten
    pad = torch.ones(param_count(bucket_dims), dtype=torch.bool)
    for lyr, i, o in zip(unflatten(pad, bucket_dims)["layers"],
                         true_dims[:-1], true_dims[1:]):
        lyr["w"][:i, :o] = False
        lyr["b"][:o] = False
    return pad


def sweep_flops(dims, model_rows: float, steps: int) -> float:
    """fp32 flops of ``steps`` full-batch training steps and one eval over
    ``model_rows`` (model, real row) pairs at ``dims``: per row and step the
    forward, the weight gradients and the input gradients of every layer
    but the first, 2 flops a multiply-add."""
    macs = [i * o for i, o in zip(dims[:-1], dims[1:])]
    per_row = 2 * sum(macs) + 2 * sum(macs) + 2 * sum(macs[1:])
    return steps * model_rows * per_row + mlp_flops(dims, model_rows)


def phase_sweep() -> tuple:
    """Phase (f): the reference's 90-config grid (fedtpu_torch.sweep.grid,
    10 architectures x 9 learning rates, 400 full-batch Adam steps, 8
    clients of income-8 at 10,000 rows) in its 2 launches on the card:
    every row present and finite, every slot's pooled counts summing to
    the 8,000 train rows, every bucket-padded entry of every averaged
    model exactly 0.0 on the card (read before unpadding), K1 and K2 once
    a launch. Then K2 against its plain version on the depth-2 launch's
    trained stack (equal but on near-tie rows) and K1 within 1e-5 of its
    plain version there, both timed at that shape beside their bounds and
    K1's library calls; each launch's wall and device time and the
    sweep's bound. Then the card against the CPU on a reduced grid:
    ((50,), (400, 200)) x (0.004, 0.05) for 10 steps (accuracies equal,
    winner weights within 1e-4), and the plateau stop on (50,) x 0.004 with
    a 400-step cap (mean steps equal, or each difference printed with the
    loss margins to the tol bar that explain it). A profile of 5 steps of
    each launch (``sweep_profile``). Returns the run's launches and the K1
    and K2 rows."""
    from fedtpu_torch.models.mlp import layer_dims, mlp_apply, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    from fedtpu_torch.sweep.grid import run_grid_search
    cfg = sweep_config()
    c, k = cfg.shard.num_clients, 2
    held, padded_zeros, flops = {}, [0], [0.0]

    def inspect(launch):
        dims, archs = launch["dims"], launch["architectures"]
        l = len(launch["learning_rates"])
        s = len(archs) * l
        avg = launch["avg"].view(s, -1)
        for a, hidden in enumerate(archs):
            pad = padded_entries(layer_dims(dims[0], hidden, dims[-1]),
                                 dims).to(avg.device)
            block = avg[a * l:(a + 1) * l][:, pad]
            nonzero = int((block != 0).sum())
            check(nonzero == 0, f"sweep launch {launch['index']}: {hidden} "
                  f"has {nonzero} non-zero padded entries after averaging")
            padded_zeros[0] += block.numel()
        sums = launch["conf"].view(c, s, k, k).sum(dim=(0, 2, 3))
        total = float(launch["mask"].view(c, s, -1)[:, 0].sum())
        check(total == 8000.0 and bool((sums == total).all()),
              f"sweep launch {launch['index']}: pooled counts {sums.tolist()}"
              f" do not each sum to the {total} train rows (8,000)")
        flops[0] += sweep_flops(dims, float(launch["mask"].sum()), 400)
        if len(dims) == 4:
            held.update(launch)

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_grid_search(cfg, verbose=False, device="cuda",
                          keep_weights=True, inspect_launch=inspect)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    print(f"sweep launches: {launches}", flush=True)
    check(launches["weighted_average_clients"] == 2
          and launches["fused_eval_confusion"] == 2
          and launches["fused_mlp_forward"] == 0,
          f"sweep: launches {launches}, not K1 = 2, K2 = 2, K3 = 0")
    table = res["table"]
    check(res["launch_count"] == 2 and len(table) == 90
          and len({(r["hidden_layer_sizes"], r["learning_rate"])
                   for r in table}) == 90,
          f"sweep: {res['launch_count']} launches, {len(table)} rows")
    check(all(np.isfinite([r[m] for m in ("accuracy", "precision",
                                          "recall", "f1",
                                          "mean_local_steps")]).all()
              for r in table), "sweep: a non-finite row")
    bound_s = flops[0] / PEAK_FP32_FLOPS
    for i, t in enumerate(res["launch_times"]):
        print(f"sweep launch {i + 1}: {t['architectures']} architectures x "
              f"{t['learning_rates']} rates, {t['models']} models: wall "
              f"{t['wall_s']:.4f} s, device {t['device_s']:.4f} s; "
              f"{CARD['smi']}", flush=True)
    print(f"sweep total: wall {wall:.4f} s, device "
          f"{sum(t['device_s'] for t in res['launch_times']):.4f} s, bound "
          f"{bound_s:.4f} s ({flops[0]:.4e} fp32 flops at 67 TFLOP/s); "
          f"{padded_zeros[0]} padded entries all exactly 0.0; winner "
          f"{res['params']} accuracy {res['accuracy']:.6f}, tie set "
          f"{len(res['tie_set'])}", flush=True)

    # The kernels against their plain versions at the depth-2 launch.
    dims = tuple(held["dims"])
    q, xm, ym, mm, conf = (held[key] for key in ("trained", "x", "y",
                                                 "mask", "conf"))
    ref = ck.fused_eval_confusion_reference(q, dims, xm, ym, mm, k)
    ties = near_tie_rows(mlp_apply(unflatten(q, dims), xm)) & (mm > 0)
    moved = (conf - ref).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties.sum(dim=1)).all()),
          f"sweep K2 at {tuple(q.shape)}: counts differ from the plain "
          f"version's on {int(moved.sum())} rows, near ties "
          f"{int(ties.sum())}")
    ones = torch.ones(c, device=q.device)
    stack = q.view(c, -1)
    avg_ref = ck.weighted_average_clients_reference(stack, ones)
    k1_err = float((held["avg"] - avg_ref).abs().max())
    check(k1_err <= 1e-5, f"sweep K1 at {tuple(stack.shape)}: max abs err "
          f"{k1_err}")
    live = float(mm.sum())
    b2, by2 = bound_ms(4 * (q.numel() + live * (dims[0] + 1) + mm.numel()
                            + q.shape[0] * k * k), mlp_flops(dims, live))
    k2_row = {"shape": f"sweep depth-2 launch, {q.shape[0]} models",
              "dims": list(dims), "clients": q.shape[0],
              "rows": xm.shape[1], "real_rows": int(live),
              "rows_moved_vs_plain": int(moved.sum()),
              "near_tie_rows": int(ties.sum()),
              "ms": time_ms(lambda: ck.fused_eval_confusion(
                  q, dims, xm, ym, mm, k)),
              "plain_ms": time_ms(lambda: ck.fused_eval_confusion_reference(
                  q, dims, xm, ym, mm, k)),
              "bound_ms": b2, "bound_by": by2, "library_ms": None}
    b1, by1 = bound_ms(4 * (stack.numel() + c + stack.shape[1]),
                       2.0 * stack.numel())
    k1_row = {"shape": list(stack.shape), "max_abs_err": k1_err,
              "ms": time_ms(lambda: ck.weighted_average_clients(stack,
                                                                ones)),
              "plain_ms": time_ms(
                  lambda: ck.weighted_average_clients_reference(stack, ones)),
              "library_ms": time_ms(lambda: torch.matmul(ones / ones.sum(),
                                                         stack)),
              "mean_ms": time_ms(lambda: stack.mean(dim=0)),
              "bound_ms": b1, "bound_by": by1}
    path = "streamed" if ck._eval_plan(q.shape[1], dims).cap else "resident"
    print(f"time K2 sweep ({q.shape[0]} models x {xm.shape[1]} rows, dims "
          f"{dims}, {path}): "
          f"kernel {k2_row['ms']:.4f} ms  plain {k2_row['plain_ms']:.4f} ms"
          f"  bound {b2:.5f} ms ({by2}); rows moved vs plain "
          f"{k2_row['rows_moved_vs_plain']}, near ties "
          f"{k2_row['near_tie_rows']}; {CARD['smi']}", flush=True)
    print(f"time K1 sweep (D,) mean {tuple(stack.shape)}: kernel "
          f"{k1_row['ms']:.4f} ms  plain {k1_row['plain_ms']:.4f} ms  "
          f"library matmul {k1_row['library_ms']:.4f} ms, mean(0) "
          f"{k1_row['mean_ms']:.4f} ms  bound {b1:.5f} ms ({by1}); max abs "
          f"err {k1_err:.3e}; {CARD['smi']}", flush=True)
    held.clear()
    del q, xm, ym, mm, conf, ref, stack, avg_ref
    profile_rows = sweep_profile(cfg)

    # Card against CPU, reduced: fixed steps.
    small = dict(hidden_grid=((50,), (400, 200)), lr_grid=(0.004, 0.05),
                 local_steps=10, keep_weights=True, verbose=False)
    card = run_grid_search(cfg, device="cuda", **small)
    cpu = run_grid_search(cfg, device="cpu", **small)
    for a, b in zip(card["table"], cpu["table"]):
        check(a["accuracy"] == b["accuracy"],
              f"sweep card vs CPU {a['hidden_layer_sizes']} lr "
              f"{a['learning_rate']}: accuracy {a['accuracy']} vs "
              f"{b['accuracy']}")
    check(card["params"] == cpu["params"],
          f"sweep card vs CPU: winner {card['params']} vs {cpu['params']}")
    w_err = max(float(np.abs(x - y).max()) for x, y in zip(
        (l[key] for l in card["weights"]["layers"] for key in ("w", "b")),
        (l[key] for l in cpu["weights"]["layers"] for key in ("w", "b"))))
    check(w_err <= 1e-4, f"sweep card vs CPU: winner weights differ by "
          f"{w_err}")
    print(f"sweep card vs CPU ((50,), (400, 200)) x (0.004, 0.05), 10 steps:"
          f" accuracies equal {[r['accuracy'] for r in card['table']]}, "
          f"winner {card['params']} weights max abs err {w_err:.3e}",
          flush=True)
    # Plateau stop, 400-step cap.
    plateau = {}
    for dev in ("cuda", "cpu"):
        got = {}
        plateau[dev] = (run_grid_search(
            cfg, device=dev, hidden_grid=((50,),), lr_grid=(0.004,),
            local_steps=400, plateau_stop=True, verbose=False,
            inspect_launch=lambda launch, got=got: got.update(
                steps=launch["steps"].cpu(),
                margin=launch["margin"].cpu())), got)
    (rc, gc), (rp, gp) = plateau["cuda"], plateau["cpu"]
    sc, sp = (r["table"][0]["mean_local_steps"] for r in (rc, rp))
    if sc != sp:
        for m in (gc["steps"] != gp["steps"]).nonzero().flatten().tolist():
            worse = (gc["margin"][:, m] > 0) != (gp["margin"][:, m] > 0)
            step = int(worse.nonzero()[0]) if bool(worse.any()) else -1
            mc, mp = (float(g["margin"][step, m]) for g in (gc, gp))
            print(f"sweep plateau model {m}: card stops after "
                  f"{int(gc['steps'][m])} steps, CPU after "
                  f"{int(gp['steps'][m])}; at step {step + 1} the loss "
                  f"margin to the tol bar is {mc:.3e} on the card, {mp:.3e} "
                  f"on the CPU", flush=True)
            check(step >= 0 and max(abs(mc), abs(mp)) <= 1e-5,
                  f"sweep plateau model {m}: a stop-step difference no "
                  "near-tie margin explains")
    print(f"sweep plateau (50,) x 0.004, cap 400: mean local steps card {sc}"
          f", CPU {sp}; per-model steps card {gc['steps'].tolist()}, CPU "
          f"{gp['steps'].tolist()}", flush=True)
    timing = {"launch_times": res["launch_times"], "wall_s": wall,
              "bound_s": bound_s, "flops": flops[0],
              "profile": profile_rows}
    return launches, {**k1_row, **timing}, {**k2_row, **timing}


def sweep_profile(cfg, steps: int = 5) -> list:
    """Where a sweep launch's device time goes: each depth class of the
    reference grid run for ``steps`` steps (and its eval and mean) at its
    full shapes, timed on the host clock to the fetch of its result, then
    under torch.profiler: device busy, device ops and the kernels that take
    most of it. Returns one row per depth class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fedtpu_torch.data.sharding import pack_clients
    from fedtpu_torch.data.tabular import load_tabular_dataset
    from fedtpu_torch.sweep import grid
    ds = load_tabular_dataset(cfg.data)
    packed = pack_clients(ds.x_train, ds.y_train, cfg.shard)
    data = [torch.from_numpy(v).cuda() for v in (packed.x, packed.y,
                                                 packed.mask)]
    fn = grid.build_sweep_fn(ds.num_classes, steps, cfg.optim)
    rows = []
    for depth in (1, 2):
        archs = [h for h in grid.HIDDEN_GRID if len(h) == depth]
        params, opt_state, lrs, dims = grid.launch_inputs(
            archs, grid.LR_GRID, grid._bucket_shape(archs[0],
                                                    grid.HIDDEN_GRID),
            ds, cfg.shard.num_clients, cfg.optim, "cuda")

        def run():
            # The host reads the pooled counts, as run_grid_search does.
            fn(params, opt_state, lrs, *data, dims)[2].cpu()

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        rows.append({"dims": list(dims), "models": params.shape[0]
                     * params.shape[1], "steps": steps, "wall_ms": wall_ms,
                     "busy_ms": busy_ms,
                     "ops": sum(e.count for e in dev),
                     "top": [(e.key[:60], e.self_device_time_total / 1e3,
                              e.count) for e in top]})
        print(f"sweep profile {dims}, {rows[-1]['models']} models, {steps} "
              f"steps + eval + mean: host {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms in {rows[-1]['ops']} device ops, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; {CARD['smi']}", flush=True)
        for name, ms, count in rows[-1]["top"]:
            print(f"  {ms:.3f} ms in {count} x {name}", flush=True)
        del params, opt_state
    return rows


def phase_personalize() -> dict:
    """Phase (g): income-32-noniid (psum, 10,000 rows) with 5 personalize
    steps after the run: K2 once a round, once in the warm-up round and
    once for the personalized models; the stop round equal to the CPU's
    and the personalized client mean within 1e-4 of it. Returns the run's
    launches by label."""
    cfg = with_fed(sharded_config("psum", 1.0, 100), personalize_steps=5)
    label = "income-32-noniid personalize 5"
    gpu, launches = phase_run(label, cfg, {
        "weighted_average_clients": "rounds",
        "fused_eval_confusion": "rounds+1", "fused_mlp_forward": "evals"})
    cpu = phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU")
    pg = gpu.personalized_metrics["client_mean"]
    pc = cpu.personalized_metrics["client_mean"]
    err = max(abs(pg[key] - pc[key]) for key in pg)
    check(err <= 1e-4, f"{label}: personalized client mean {pg} vs CPU "
          f"{pc}")
    print(f"{label}: personalized client mean {json.dumps(pg)} (global "
          f"{gpu.global_metrics['accuracy'][-1]:.4f} accuracy at the stop "
          f"round {gpu.rounds_run}); CPU max abs err {err:.3e}", flush=True)
    return {label: launches}


def k5_case(label: str, args: tuple, dims, optim) -> float:
    """K5 against its plain version on the card at one shape, and twice on
    the same inputs (bitwise equal). Loss within 1e-5; params within 1e-4
    on all but 0.1 % of entries and within 2 * lr everywhere (Adam's first
    step sends a gradient that is rounding noise to +-lr); every entry of mu
    and nu within 1e-5 of its tensor's largest magnitude (the fused-round
    benchmark's ``state_faults``); counts equal; confusion counts equal but
    on near-tie rows of the plain trained models. Returns the largest abs
    error of the float outputs."""
    from fedtpu_torch.benchmarks import mega_kernel_attempt as mega
    from fedtpu_torch.models.mlp import mlp_apply, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.training.client import make_local_train_step
    params, mu, nu, count, x, y, mask, _ = args
    out = ck.fused_round(*args, dims, optim)
    again = ck.fused_round(*args, dims, optim)
    ref = ck.fused_round_reference(*args, dims, optim)
    trained, _, _ = make_local_train_step(dims, build_optimizer(optim))(
        params, {"mu": mu, "nu": nu, "count": count}, x, y, mask)
    ties = (near_tie_rows(mlp_apply(unflatten(trained, dims), x))
            & (mask > 0)).sum(dim=1)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"K5 {label}: two launches on the same inputs differ")
    names = ("params", "mu", "nu")
    state = mega.state_errors(dict(zip(names, out)), dict(zip(names, ref)))
    faults = mega.state_faults(state, optim.learning_rate)
    check(not faults, f"K5 {label}: {faults}")
    errs = {name: state[name]["max_abs"] for name in names}
    errs["loss"] = float((out[4] - ref[4]).abs().max())
    check(errs["loss"] <= mega.LOSS_ATOL, f"K5 {label}: loss max abs err "
          f"{errs['loss']} > {mega.LOSS_ATOL}")
    check(torch.equal(out[3], ref[3]), f"K5 {label}: counts differ")
    moved = (out[5] - ref[5]).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties).all()),
          f"K5 {label}: confusion counts differ on {moved.tolist()} rows "
          f"per client; near-tie rows {ties.tolist()}")
    check(torch.equal(out[5].sum(dim=(1, 2)), mask.sum(dim=1)),
          f"K5 {label}: confusion counts do not sum to the real rows")
    print(f"K5 fused_round {label} C={x.shape[0]} N={x.shape[1]} "
          f"dims={tuple(dims)}: max abs err {errs}, largest moments mu "
          f"{state['mu']['ref_max_abs']:.3e} nu "
          f"{state['nu']['ref_max_abs']:.3e}, rows differing "
          f"{int(moved.sum())}, near-tie rows {ties.tolist()}; two launches "
          "bitwise equal", flush=True)
    return max(errs.values())


def k5_edge_args(gen: torch.Generator, dev, dims, sizes, n):
    """Random fused-round inputs of len(sizes) clients with mid-run state
    (moments, and counts around the StepLR boundaries at 30 and 60): rows
    tail-padded to ``sizes``, labels in range, data-size weights."""
    from fedtpu_torch.models.mlp import mlp_init
    c = len(sizes)
    params = torch.stack([mlp_init(gen, dims[0], dims[1:-1], dims[-1])
                          for _ in range(c)])
    mu = torch.randn(params.shape, generator=gen) * 1e-3
    nu = torch.rand(params.shape, generator=gen) * 1e-6
    count = torch.tensor([(0, 29, 30, 61)[i % 4] for i in range(c)],
                         dtype=torch.int32)
    x = torch.randn(c, n, dims[0], generator=gen)
    y = torch.randint(0, dims[-1], (c, n), generator=gen, dtype=torch.int32)
    mask = (torch.arange(n)[None, :] < torch.tensor(sizes)[:, None]).to(
        torch.float32)
    return tuple(t.to(dev) for t in (params, mu, nu, count, x, y, mask,
                                      mask.sum(dim=1)))


# K5's phases in the order its blocks stamp them (ft_fused_round's
# phase_ns): phase i runs from stamp 2i to stamp 2i + 1 of a block.
K5_PHASES = ("A forward + backward", "B partials + Adam", "C average + eval")
# The PR 4 design's windows at income-8, us after the first block's start
# (PERF.md section 6: this function on that kernel with the stamp hook,
# NVIDIA H100 80GB HBM3 at 700 W), printed beside the current ones.
K5_PR4_PHASES_US = {"A forward + backward": (0.00, 53.10),
                    "B partials + Adam": (54.00, 59.55),
                    "C average + eval": (60.45, 82.24),
                    "whole": (0.00, 82.24)}
K5_PHASE_REPS = 20


def k5_phase_times(args: tuple, dims, optim, names=K5_PHASES,
                   reps: int = K5_PHASE_REPS) -> dict:
    """Per-phase windows of K5 on ``args``, from the %globaltimer stamps
    each block writes when ``phase_ns`` is given: for each phase, the first
    block's start and the last block's end, in us after the first block's
    start, and the whole launch; medians over ``reps`` launches."""
    from fedtpu_torch.ops import cuda_kernels as ck
    stamps = torch.zeros((4096, 8), dtype=torch.int64, device="cuda")
    windows = {name: [] for name in (*names, "whole")}
    for _ in range(reps):
        stamps.zero_()
        ck.fused_round(*args, dims, optim, phase_ns=stamps)
        torch.cuda.synchronize()
        t = stamps.cpu()
        t = t[(t != 0).any(dim=1)]
        t0 = int(t[:, 0][t[:, 0] != 0].min())
        last = t0
        for i, name in enumerate(names):
            start, end = t[:, 2 * i], t[:, 2 * i + 1]
            start, end = start[start != 0], end[end != 0]
            if len(start) and len(end):
                windows[name].append(((int(start.min()) - t0) / 1e3,
                                      (int(end.max()) - t0) / 1e3))
                last = max(last, int(end.max()))
        windows["whole"].append((0.0, (last - t0) / 1e3))
    out = {}
    for name, w in windows.items():
        if w:
            out[name] = {"start_us": statistics.median(a for a, _ in w),
                         "end_us": statistics.median(b for _, b in w)}
    print("K5 per-phase windows (us after the first block's start, median "
          f"of {reps} launches): " + "; ".join(
              f"{n} {v['start_us']:.2f}-{v['end_us']:.2f}"
              for n, v in out.items()), flush=True)
    return out


def k5_noniid_args(gen: torch.Generator, dev):
    """Fused-round inputs at income-32-noniid's (32, 1104) tail-padded batch
    with mid-run state (as k5_edge_args) and data-size weights."""
    from fedtpu_torch.models.mlp import mlp_init
    batch = noniid_batch()
    c = batch["x"].shape[0]
    params = torch.stack([mlp_init(gen, 14, INCOME_DIMS[1:-1], 2)
                          for _ in range(c)])
    mu = torch.randn(params.shape, generator=gen) * 1e-3
    nu = torch.rand(params.shape, generator=gen) * 1e-6
    count = torch.tensor([(0, 29, 30, 61)[i % 4] for i in range(c)],
                         dtype=torch.int32)
    return tuple(t.to(dev) for t in (
        params, mu, nu, count, batch["x"], batch["y"], batch["mask"],
        batch["mask"].sum(dim=1)))


def phase_fused_round(gen: torch.Generator, composed: dict):
    """Phase 8: K5 against its plain version, then the benchmark's run on
    income-8 (its launches counted from zero around it), K5's time and
    bound, a profile of 20 fused rounds. ``composed`` is phase 6's profile
    of the composed round. Returns (K5's timing row, the run's launches)."""
    from fedtpu_torch.benchmarks import mega_kernel_attempt as mega
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import build_experiment
    dev = torch.device("cuda")
    cfg = main_path_config()
    exp = build_experiment(cfg, device="cuda")
    opt = exp.state["opt_state"]
    income8 = (exp.state["params"], opt["mu"], opt["nu"], opt["count"],
               exp.batch["x"], exp.batch["y"], exp.batch["mask"],
               exp.client_weights)
    err = k5_case("income-8", income8, INCOME_DIMS, cfg.optim)
    for dims, sizes, n in ((INCOME_DIMS, [1000, 1000], 1000),
                           (INCOME_DIMS, [333, 100, 0], 333),
                           ((14, 50, 200, 8), [700, 650, 200, 1], 700),
                           ((6, 8, 5, 3), [130, 57, 0], 130),
                           (INCOME_DIMS, [1], 1)):
        args = k5_edge_args(gen, dev, dims, sizes, n)
        err = max(err, k5_case("edge", args, dims, cfg.optim))
    noniid = k5_noniid_args(gen, dev)
    err = max(err, k5_case("income-32-noniid", noniid, INCOME_DIMS,
                           cfg.optim))
    d = param_count(INCOME_DIMS)
    for label, (c, n) in (("income-8", (8, 1000)),
                          ("income-32-noniid", noniid[5].shape)):
        nbytes = ck._fused_round_rows(d, INCOME_DIMS)[1]
        resident = ck._round_resident(0, nbytes)
        print(f"K5 plan {label}: "
              f"{ck._fused_round_plan(d, INCOME_DIMS, c, n, resident)}; "
              f"blocks resident at once {resident}", flush=True)

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    res = mega.run(cfg, device="cuda", rounds=cfg.fed.rounds)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    one, traj, timing = res["one_round"], res["trajectory"], res["timing"]
    rounds = res["rounds"]
    print(f"income-8 fused round launches: {launches}; by loop "
          f"{res['launches']}", flush=True)
    # run() raises where round 1 breaks a limit of k5_case, where any round's
    # losses differ by more than 1e-4, where the client-mean accuracies after
    # the last round differ by 0.01 or more, or where the fused loop's Adam
    # counts did not grow by one a round; here they are only printed.
    fused, comp = res["launches"]["fused"], res["launches"]["composed"]
    check(fused["fused_round"] == rounds and comp["fused_round"] == 0,
          f"K5 launches {fused['fused_round']} in {rounds} fused rounds, "
          f"{comp['fused_round']} in the composed loop")
    for name in ("weighted_average_clients", "fused_eval_confusion"):
        check(fused[name] == 0 and comp[name] == rounds,
              f"{name}: {fused[name]} launches in the fused loop, "
              f"{comp[name]} in {rounds} composed rounds")
    print(f"income-8 fused vs composed: round 1 {json.dumps(one)}; after "
          f"{rounds} rounds client-mean accuracy fused "
          f"{traj['fused_accuracy']:.6f} composed "
          f"{traj['composed_accuracy']:.6f}, largest per-round loss "
          f"difference {traj['max_loss_diff']:.3e}; marginal "
          f"{timing['fused_s_per_round'] * 1e6:.2f} us/round fused, "
          f"{timing['composed_s_per_round'] * 1e6:.2f} us/round composed "
          f"(lens {timing['lens']}, {timing['reps']} reps)", flush=True)

    c, n = exp.batch["y"].shape
    real = float(exp.batch["mask"].sum())
    d = param_count(INCOME_DIMS)
    nbytes = 4 * (6 * c * d + 2 * c + c * n * (INCOME_DIMS[0] + 2)
                  + 2 * c + c * INCOME_DIMS[-1] ** 2)
    b, by = bound_ms(nbytes, mega.round_flops(INCOME_DIMS, real, c))
    row = {"max_abs_err": err,
           "ms": time_ms(lambda: ck.fused_round(*income8, INCOME_DIMS,
                                                cfg.optim)),
           "plain_ms": time_ms(lambda: ck.fused_round_reference(
               *income8, INCOME_DIMS, cfg.optim)),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "composed_round_device_ms": composed["device_busy_ms"],
           "marginal_us_per_round": {
               "fused": timing["fused_s_per_round"] * 1e6,
               "composed": timing["composed_s_per_round"] * 1e6}}
    print(f"time fused_round income-8 ({c}, {n}), {int(real)} real rows: "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"bound {b:.5f} ms ({by}); composed round step device busy "
          f"{composed['device_busy_ms']:.4f} ms/round", flush=True)
    row["phases_us"] = k5_phase_times(income8, INCOME_DIMS, cfg.optim)
    print("K5 per-phase windows of the PR 4 design at income-8 (PERF.md): "
          + "; ".join(f"{name} {a:.2f}-{z:.2f}"
                      for name, (a, z) in K5_PR4_PHASES_US.items()),
          flush=True)
    c32, n32 = noniid[5].shape
    real32 = float(noniid[6].sum())
    nb32 = 4 * (6 * c32 * d + 2 * c32 + c32 * n32 * (INCOME_DIMS[0] + 2)
                + 2 * c32 + c32 * INCOME_DIMS[-1] ** 2)
    b32, by32 = bound_ms(nb32, mega.round_flops(INCOME_DIMS, real32, c32))
    row["by_shape"] = [{
        "shape": "income-32-noniid", "clients": c32, "rows": n32,
        "real_rows": int(real32),
        "ms": time_ms(lambda: ck.fused_round(*noniid, INCOME_DIMS,
                                             cfg.optim)),
        "plain_ms": time_ms(lambda: ck.fused_round_reference(
            *noniid, INCOME_DIMS, cfg.optim)),
        "bound_ms": b32, "bound_by": by32,
        "phases_us": k5_phase_times(noniid, INCOME_DIMS, cfg.optim)}]
    r = row["by_shape"][0]
    print(f"time fused_round income-32-noniid ({c32}, {n32}), {int(real32)} "
          f"real rows: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
          f"  bound {b32:.5f} ms ({by32})", flush=True)
    row["profile"] = phase_profile(
        cfg, label="income-8 fused round profile",
        make_round=lambda e: mega.make_fused_step(e, cfg.optim))
    return row, launches


def cifar_config(rows: int = 4096, rounds: int = CIFAR_ROUNDS,
                 dtype: str = "bfloat16", eval_every: int = 10):
    """The cifar10-32 preset at full width on ``rows`` synthetic rows, in
    compute ``dtype``, held-out eval every ``eval_every`` rounds."""
    from fedtpu_torch.config import get_preset
    cfg = get_preset("cifar10-32")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=rows),
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        fed=dataclasses.replace(cfg.fed, rounds=rounds),
        run=dataclasses.replace(cfg.run, eval_test_every=eval_every))


# The eval route of any model but the float32 MLP: K1 a round, never K2/K3.
SPEC_EVAL = {"weighted_average_clients": "rounds", "fused_eval_confusion": 0,
             "fused_mlp_forward": 0}


def phase_cifar() -> dict:
    """Phase (h): cifar10-32 at full width (32 clients, 4,096 synthetic
    rows, 32x32x3 images, channels (32, 64), hidden 256, 10 classes),
    bf16 compute, 50 rounds, as the preset runs it: captured (every round
    a graph replay) and uncaptured, which must agree bit for bit; K1 once
    a round and once in the warm-up, K2 = K3 = 0 though the held-out eval
    runs every 10 rounds; s/round of both; a 20-round profile of the
    captured round; then the same run at fp32 compute for the bf16/fp32
    ratio. Returns the runs' launches by label."""
    by_path = {}
    cfg = cifar_config()
    plain, _ = phase_run("cifar10-32 bf16 uncaptured", cfg, SPEC_EVAL,
                         capture=False, min_accuracy=0.1)
    graph, by_path["cifar10-32 bf16"] = phase_run(
        "cifar10-32 bf16 captured", cfg, SPEC_EVAL, min_accuracy=0.1)
    diffs = same_history(plain, graph)
    check(not diffs, f"cifar10-32: captured run differs from the "
          f"uncaptured one in {diffs}")
    s_plain = statistics.median(plain.sec_per_round)
    s_graph = statistics.median(graph.sec_per_round)
    print(f"cifar10-32 bf16: captured == uncaptured bitwise (losses, "
          f"confusion counts, histories, final params); s/round (median) "
          f"uncaptured {s_plain:.6e}, captured {s_graph:.6e}, ratio "
          f"{s_plain / s_graph:.3f}; test accuracy "
          f"{graph.test_metrics['accuracy']}; {CARD['smi']}", flush=True)
    prof = phase_profile(cfg, label="cifar10-32 bf16 captured profile",
                         make_round=captured_round(1))
    # The fp32 run is here for its time (phase (i) holds fp32 against the
    # CPU); it plateaus near chance and stops early.
    fp32, by_path["cifar10-32 fp32"] = phase_run(
        "cifar10-32 fp32 captured", cifar_config(dtype="float32"),
        SPEC_EVAL, min_accuracy=0.0)
    s_fp32 = statistics.median(fp32.sec_per_round)
    print(f"cifar10-32: s/round (median, captured) bf16 {s_graph:.6e}, fp32 "
          f"{s_fp32:.6e}, bf16/fp32 {s_graph / s_fp32:.3f}; profile: host "
          f"{prof['host_ms']:.4f} ms/round, device busy "
          f"{prof['device_busy_ms']:.4f} ms in {prof['device_ops']:.1f} "
          f"ops, idle share {prof['idle_share']:.3f} (traced window "
          f"{prof['traced_host_ms']:.4f} ms/round, idle share there "
          f"{prof['traced_idle_share']:.3f}); {CARD['smi']}", flush=True)
    return by_path


# Card against CPU at bf16: cuDNN's and oneDNN's bf16 sums round in other
# orders. The loss limit is about 5x the largest drift measured on an
# NVIDIA H100 80GB HBM3 at 700 W (3.6e-5, cifar10-32 on 512 rows over 3
# rounds; income-8 1.5e-5 over 35), below the one-bf16-ulp bound (2^-8 of
# a logit) the CPU tests hold the port to against fedtpu. The logit drift
# cap is four bf16 ulps of a logit of magnitude 3.
BF16_LOSS_TOL = 2e-4
BF16_DRIFT_CAP = 5e-2


def phase_cifar_vs_cpu() -> dict:
    """Phase (i): cifar10-32 at full width, rows cut to 512 (scale, not
    width), 3 rounds, card against CPU at fp32 (losses within 1e-4) and at
    bf16 (within BF16_LOSS_TOL), confusion counts equal up to near-tie
    rows with the logit drift capped (CSV_DRIFT_CAP, BF16_DRIFT_CAP)."""
    from fedtpu_torch.convert import params_from_jax
    from fedtpu_torch.data import load_dataset
    from fedtpu_torch.models.registry import build_model
    by_path = {}
    for dtype, tol, cap in (("float32", 1e-4, CSV_DRIFT_CAP),
                            ("bfloat16", BF16_LOSS_TOL, BF16_DRIFT_CAP)):
        cfg = cifar_config(rows=512, rounds=3, dtype=dtype, eval_every=1)
        label = f"cifar10-32 {dtype} 512 rows"
        gpu, by_path[label] = phase_run(label, cfg, SPEC_EVAL,
                                        min_accuracy=0.0)
        cpu = phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU",
                                drift_cap=cap, loss_tol=tol)
        # Whether or not a row moved: the logits of the card's and the
        # CPU's final global models on the held-out rows, both computed on
        # the CPU (the drift the params carry, without a replay).
        model = build_model(cfg.model)
        x = torch.from_numpy(load_dataset(cfg.data).x_test)
        gpu_logits, cpu_logits = (
            model.apply(params_from_jax(r.final_params), x)
            for r in (gpu, cpu))
        drift = float((gpu_logits - cpu_logits).abs().max())
        check(drift <= cap, f"{label}: logit drift {drift:.3e} above {cap}")
        print(f"{label}: final global models' logit drift, card vs CPU, on "
              f"{x.shape[0]} held-out rows {drift:.3e} (cap {cap}); "
              f"{CARD['smi']}", flush=True)
    return by_path


def phase_income_bf16() -> dict:
    """Phase (j): income-8 (main path's config) at compute_dtype bf16 on
    the card against the CPU: the same stop round, K1 once a round and in
    the warm-up, K2 = K3 = 0 (the bf16 MLP is not the model they
    compute)."""
    cfg = main_path_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    label = "income-8 bf16"
    gpu, launches = phase_run(label, cfg, SPEC_EVAL)
    phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU",
                      drift_cap=BF16_DRIFT_CAP, loss_tol=BF16_LOSS_TOL)
    return {label: launches}


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers (NaN equals itself bit for bit)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# K1's 16-bit stacks, held to the plain version: a broadcast element may
# round the other way where the two float32 averages (the kernel's FMA
# chain, torch's sum) differ in their last bits, on at most this share of
# the columns (measured: 137 of 1,070,794 at bf16, NVIDIA H100 80GB HBM3,
# 700 W).
K1_16BIT_FLIP_SHARE = 1e-3
K1_DTYPES = ("bfloat16", "float16")


def k1_16bit_checks(dev: torch.device) -> dict:
    """Phase (k): K1 on bfloat16 and float16 stacks at income-8's (8,
    11,352) with data-size weights and cifar10-32's (32, 1,070,794), both
    modes, against its plain version: the (D,) float32 average within
    1e-5, the broadcast in the stack's dtype equal but for rounding flips
    on at most K1_16BIT_FLIP_SHARE of the columns; every
    weight 0 carries the stack over bit for bit; a NaN column stays NaN;
    two launches bitwise equal; the broadcast is exactly the kernel's own
    (D,) average rounded; and the main path's float32 stack
    broadcast into 16-bit slots. Each timed single and back to back beside
    its bound, the plain version, ``torch.matmul`` in the stack's dtype
    ((D,) mode; it writes that dtype) and the chain the broadcast replaces
    in the round (the average, the cast, ``w.sum() > 0``,
    ``torch.where``)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator().manual_seed(11)
    rows = []
    err = 0.0
    for dtype_name in K1_DTYPES:
        dtype = getattr(torch, dtype_name)
        for label, c, d in (("income-8", 8, 11352),
                            ("cifar10-32", 32, CIFAR_PARAMS)):
            x32 = (torch.randn(c, d, generator=gen) * 0.05).to(dev)
            x32[:, 5] = float("nan")
            x = x32.to(dtype)
            wt = (torch.randint(100, 500, (c,), generator=gen)
                  .to(torch.float32).to(dev))
            glob = None
            for broadcast in (False, True):
                out = ck.weighted_average_clients(x, wt, broadcast)
                again = ck.weighted_average_clients(x, wt, broadcast)
                ref = ck.weighted_average_clients_reference(x, wt, broadcast)
                torch.cuda.synchronize()
                mode = "broadcast" if broadcast else "(D,)"
                check(out.dtype == ref.dtype and torch.equal(
                    torch.isnan(out), torch.isnan(ref)) and bool(
                    torch.isnan(out[..., 5]).all()),
                      f"K1 {dtype_name} {mode} {label}: dtype or NaN column")
                check(torch.equal(bits(out), bits(again)),
                      f"K1 {dtype_name} {mode} {label}: two launches differ")
                o, r = out.float(), ref.float()
                live = ~torch.isnan(r)
                e = float((o - r).abs()[live].max())
                cols = 0
                if broadcast:
                    # Every slot is the kernel's own float32 average
                    # rounded once; against the plain version's, a column
                    # may round the other way.
                    check(torch.equal(bits(out), bits(glob.to(dtype).expand(
                        c, -1).contiguous())),
                          f"K1 {dtype_name} broadcast {label}: not its (D,) "
                          "average rounded to the slot dtype")
                    cols = int(((o != r) & live).any(dim=0).sum())
                    check(cols <= K1_16BIT_FLIP_SHARE * d,
                          f"K1 {dtype_name} broadcast {label}: {cols} "
                          f"columns differ from the plain version")
                else:
                    glob = out
                    check(e <= 1e-5, f"K1 {dtype_name} (D,) {label}: max "
                          f"abs err {e} > 1e-5")
                    err = max(err, e)
                print(f"K1 {dtype_name} {mode} {label} ({c}, {d}): max abs "
                      f"err {e:.3e}, columns rounded the other way {cols}, "
                      f"NaN column NaN, two launches bitwise equal",
                      flush=True)
            zero = torch.zeros(c, device=dev)
            carried = ck.weighted_average_clients(x, zero, broadcast=True)
            check(torch.equal(bits(carried), bits(x)),
                  f"K1 {dtype_name} {label}, every weight 0: not the input "
                  "bit for bit")
            wide = ck.weighted_average_clients(x32, wt, broadcast=True,
                                               out_dtype=dtype)
            wide_ref = ck.weighted_average_clients_reference(
                x32, wt, True, dtype)
            torch.cuda.synchronize()
            wbad = (wide.float() != wide_ref.float()) & ~torch.isnan(
                wide_ref.float())
            check(wide.dtype == dtype and int(wbad.any(dim=0).sum())
                  <= K1_16BIT_FLIP_SHARE * d,
                  f"K1 float32 -> {dtype_name} slots {label}: "
                  f"{int(wbad.any(dim=0).sum())} columns differ")
            wn = wt / wt.sum()

            def chain():
                glob = ck.weighted_average_clients(x, wt).to(dtype)
                return torch.where(wt.sum() > 0, glob.expand_as(x), x)

            row = {"dtype": dtype_name, "shape": label, "clients": c,
                   "params": d, "carry_over_bitwise": True,
                   "nan_column_nan": True}
            for mode, broadcast, nbytes, library in (
                    ("average", False, 2 * c * d + 4 * c + 4 * d,
                     lambda: torch.matmul(wn.to(dtype), x)),
                    ("broadcast", True, 2 * 2 * c * d + 4 * c, chain),
                    ("broadcast from float32", True, 4 * c * d + 2 * c * d
                     + 4 * c, None)):
                src = x32 if mode == "broadcast from float32" else x
                kw = {"out_dtype": dtype} if src is x32 else {}
                b, by = bound_ms(nbytes, 2.0 * c * d)
                row[mode] = {
                    "ms": time_ms(lambda: ck.weighted_average_clients(
                        src, wt, broadcast, **kw)),
                    "back_to_back_ms": time_back_to_back_ms(
                        lambda: ck.weighted_average_clients(
                            src, wt, broadcast, **kw)),
                    "plain_ms": time_ms(
                        lambda: ck.weighted_average_clients_reference(
                            src, wt, broadcast, kw.get("out_dtype"))),
                    "library_ms": (time_ms(library) if library else None),
                    "bound_ms": b, "bound_by": by, "bytes": nbytes}
                r = row[mode]
                print(f"time K1 {dtype_name} {mode} {label} ({c}, {d}): "
                      f"kernel {r['ms']:.4f} ms  back to back "
                      f"{r['back_to_back_ms']:.4f} ms  plain "
                      f"{r['plain_ms']:.4f} ms  "
                      f"{'matmul' if mode == 'average' else 'chain'} "
                      f"{r['library_ms']}  bound {b:.5f} ms ({by}, "
                      f"{nbytes / 1e6:.2f} MB); {CARD['smi']}", flush=True)
            rows.append(row)
    return {"max_abs_err": err, "by_shape": rows}


def parity_config(eval_every: int = 1):
    """The sklearn-parity preset (4 clients, 14->50->400->2, 5 uniform
    rounds) with a held-out eval every ``eval_every`` rounds."""
    from fedtpu_torch.config import get_preset
    cfg = get_preset("sklearn-parity")
    return cfg.replace(run=dataclasses.replace(cfg.run,
                                               eval_test_every=eval_every))


def parity_kernel_rows(dev: torch.device) -> dict:
    """K1, K2 and K3 at the sklearn-parity preset's shapes, on its own
    inputs: K1's (D,) mode on the 4 clients' (4, 21,952) init with uniform
    weights,
    K2 on the 4 training shards, K3 on the held-out split; each against
    its plain version and timed beside its bound (and ``torch.matmul`` for
    K1's (D,) mode)."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import build_experiment
    exp = build_experiment(parity_config(), device="cuda")
    dims = exp.dims
    params, wt = exp.state["params"], exp.client_weights
    b = exp.batch
    x_test = torch.from_numpy(exp.dataset.x_test).to(dev)
    c, d = params.shape
    k = dims[-1]
    live = float(b["mask"].sum())
    n_test = x_test.shape[0]
    cases = {
        "weighted_average_clients": (
            lambda: ck.weighted_average_clients(params, wt),
            lambda: ck.weighted_average_clients_reference(params, wt),
            lambda: torch.matmul(wt / wt.sum(), params),
            4 * (c * d + c + d), 2.0 * c * d, 1e-5),
        "fused_eval_confusion": (
            lambda: ck.fused_eval_confusion(params, dims, b["x"], b["y"],
                                            b["mask"], k),
            lambda: ck.fused_eval_confusion_reference(
                params, dims, b["x"], b["y"], b["mask"], k),
            None, 4 * (params.numel() + live * (dims[0] + 1)
                       + b["mask"].numel() + c * k * k),
            mlp_flops(dims, live), 0.0),
        "fused_mlp_forward": (
            lambda: ck.fused_mlp_forward(params[0], dims, x_test),
            lambda: ck.fused_mlp_forward_reference(params[0], dims, x_test),
            None, 4 * (d + x_test.numel() + n_test * k),
            mlp_flops(dims, n_test), 1e-4)}
    out = {}
    for name, (kernel, plain, library, nbytes, flops, tol) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        check(e <= tol, f"{name} at sklearn-parity's shape: max abs err "
              f"{e} > {tol}")
        bnd, by = bound_ms(nbytes, flops)
        out[name] = {"shape": f"sklearn-parity C={c} D={d} dims={dims} "
                              f"train rows {int(live)} test rows {n_test}",
                     "max_abs_err": e, "ms": time_ms(kernel),
                     "plain_ms": time_ms(plain),
                     "library_ms": time_ms(library) if library else None,
                     "bound_ms": bnd, "bound_by": by}
        r = out[name]
        print(f"time {name} sklearn-parity: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']}  bound "
              f"{bnd:.5f} ms ({by}); max abs err {e:.3e}; {CARD['smi']}",
              flush=True)
    check(param_count(dims) == d == 21952, f"sklearn-parity D={d}")
    return out


def phase_parity() -> dict:
    """Phase (l): ``python -m fedtpu_torch.cli parity --preset
    sklearn-parity`` at full width, through the CLI's ``main``: part A (the
    numpy MLPClassifier) on the host, part B on the card with a held-out
    eval each round; launches counted from zero around it (K1 and K2 once
    a round and in the graphs' warm-up, K3 once an eval); the summary must
    show the limitation and part B's 5 rounds. Then part B's config on the
    card against the CPU (same rounds_run, losses within 1e-4)."""
    import contextlib
    import io
    from fedtpu_torch.cli import main as cli_main
    from fedtpu_torch.ops import cuda_kernels as ck
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["parity", "--preset", "sklearn-parity",
                       "--eval-test-every", "1", "--json", "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    check(rc == 0, f"parity exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(summary["limitation_demonstrated"] is True,
          "parity: the limitation was not demonstrated")
    rounds = summary["fedtpu"]["rounds_run"]
    check(rounds == 5, f"parity: part B ran {rounds} rounds, not 5")
    check(launches["weighted_average_clients"] == rounds + 1
          and launches["fused_eval_confusion"] == rounds + 1
          and launches["fused_mlp_forward"] >= rounds,
          f"parity launches {launches}: not K1 = K2 = rounds + warm-up, "
          f"K3 >= rounds")
    print(f"parity sklearn-parity (CLI): launches {launches}; part A pooled "
          f"accuracy {summary['sklearn']['pooled_metrics']['accuracy']}, "
          f"limitation demonstrated; part B rounds {rounds}, pooled "
          f"accuracy {summary['fedtpu']['pooled_metrics']['accuracy']}; "
          f"wall {wall:.3f} s", flush=True)
    cfg = parity_config()
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, weighting="uniform"))
    gpu, _ = phase_run("sklearn-parity part B", cfg, {
        "weighted_average_clients": "rounds",
        "fused_eval_confusion": "rounds", "fused_mlp_forward": "evals"})
    phase_card_vs_cpu(cfg, gpu, label="sklearn-parity part B card vs CPU")
    return {"sklearn-parity": launches}


def phase_param_dtype() -> dict:
    """Phase (m): income-8 (the preset's 2,048 synthetic rows, at most 40
    rounds, held-out eval every 10) at bfloat16 params on the card,
    captured, against the CPU: the same stop round,
    K1 once a round and in the warm-up, K2 = K3 = 0 (the bfloat16 MLP is
    evaluated through its own forward). Then at float16 params: Adam's eps
    is 0 in float16, the run diverges; card and CPU must halt at the same
    round with non-finite params."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    from fedtpu_torch.config import get_preset
    out = {}
    base = get_preset("income-8")
    base = base.replace(fed=dataclasses.replace(base.fed, rounds=40),
                        run=dataclasses.replace(base.run, eval_test_every=10))
    cfg = base.replace(model=dataclasses.replace(base.model,
                                                 param_dtype="bfloat16"))
    label = "income-8 bf16 params"
    gpu, out[label] = phase_run(label, cfg, SPEC_EVAL)
    phase_card_vs_cpu(cfg, gpu, label=f"{label} card vs CPU",
                      drift_cap=BF16_DRIFT_CAP, loss_tol=BF16_LOSS_TOL)
    cfg = base.replace(model=dataclasses.replace(base.model,
                                                 param_dtype="float16"))
    label = "income-8 fp16 params"
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    runs = {dev: run_experiment(cfg, verbose=False, device=dev)
            for dev in ("cuda", "cpu")}
    out[label] = {k: v for k, v in ck.LAUNCHES.items()}
    for dev, r in runs.items():
        finite = all(np.isfinite(l).all()
                     for l in param_leaves(r.final_params))
        check(r.diverged and r.stopped_early and not finite,
              f"{label} on {dev}: diverged {r.diverged}, params finite "
              f"{finite}")
    g, c = runs["cuda"], runs["cpu"]
    check(g.rounds_run == c.rounds_run,
          f"{label}: card halts at round {g.rounds_run}, CPU at "
          f"{c.rounds_run}")
    check(out[label]["weighted_average_clients"] >= 1,
          f"{label}: K1 never launched")
    print(f"{label}: card and CPU both diverge and halt at round "
          f"{g.rounds_run} with non-finite params; card launches "
          f"{out[label]}; {CARD['smi']}", flush=True)
    return out


def param_leaves(tree) -> list:
    from fedtpu_torch.models.registry import tree_leaves
    return [np.asarray(leaf) for _, leaf in tree_leaves(tree)]


def phase_cifar_param_bf16() -> dict:
    """Phase (n): cifar10-32 at full width with bfloat16 params (float32
    compute: fedtpu's convolution refuses bfloat16 params under a
    bfloat16 compute dtype of the same name), 10 rounds, captured: K1 once
    a round and in the warm-up, K2 = K3 = 0; then 3 rounds at 512 rows
    against the CPU, as phase (i)."""
    out = {}
    cfg = cifar_config(rounds=10, dtype="float32")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                param_dtype="bfloat16"))
    label = "cifar10-32 bf16 params"
    gpu, out[label] = phase_run(label, cfg, SPEC_EVAL, min_accuracy=0.0)
    print(f"{label}: s/round (median, captured) "
          f"{statistics.median(gpu.sec_per_round):.6e}; {CARD['smi']}",
          flush=True)
    small = cifar_config(rows=512, rounds=3, dtype="float32", eval_every=1)
    small = small.replace(model=dataclasses.replace(small.model,
                                                    param_dtype="bfloat16"))
    label = "cifar10-32 bf16 params 512 rows"
    gpu, out[label] = phase_run(label, small, SPEC_EVAL, min_accuracy=0.0)
    phase_card_vs_cpu(small, gpu, label=f"{label} card vs CPU",
                      drift_cap=BF16_DRIFT_CAP, loss_tol=BF16_LOSS_TOL)
    return out


# Phase (o): the asynchronous FedBuff engine (fedtpu_torch.parallel.async_fed)
# on income-32-noniid at full width (14->50->200->2, 32 Dirichlet clients,
# 10,000 synthetic rows, 8 shards of the one card), and cifar10-32.
ASYNC_TICKS = 60
# The driven, screened and clipped ticks: honest arrivals weigh 1.0, and
# from SCREEN_POISON_TICK two clients a tick submit at -8.0. The cosine
# limit sits where the screened flags do not move between -0.5 and -0.4
# (nor the norm multiple between 3.6 and 4.4) on this data: fedtpu's
# default -0.2 screens honest clients of this label skew now and then, a
# decision at the margin that the card's and the CPU's last bits could
# split.
SCREEN_TICKS, SCREEN_POISON_TICK, SCREEN_COS_MIN, SCREEN_CLIP = 24, 12, \
    -0.45, 0.5
ASYNC_EXPECT = {"weighted_average_clients": "rounds",
                "fused_eval_confusion": "rounds", "fused_mlp_forward": "evals",
                "ring_all_reduce_sum": 0, "fused_round": 0}


def async_config(rounds: int = ASYNC_TICKS, **fed):
    """income-32-noniid under ``--async``: uniform weighting, arrival rate
    0.25, staleness power 0.5, a K-buffer of 16, 5 local steps with FedProx
    0.01, a held-out eval every 10 ticks."""
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-32-noniid")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=10000),
        fed=dataclasses.replace(
            cfg.fed, **{**dict(rounds=rounds, weighting="uniform",
                               async_mode=True, async_arrival_rate=0.25,
                               async_staleness_power=0.5,
                               async_buffer_size=16, local_steps=5,
                               prox_mu=0.01), **fed}),
        run=dataclasses.replace(cfg.run, eval_test_every=10,
                                mesh_devices=SHARDS))


def k1_sum_checks(gen: torch.Generator, dev: torch.device) -> dict:
    """K1's sum mode (``weighted_sum_clients``) against its plain version,
    within 1e-5 of the output's largest magnitude (at least 1): at
    income-32-noniid's (32, 11,352) with positive weights, signed weights
    whose total is negative, every weight 0 (the output exactly 0), a NaN
    in the stack (NaN where the plain version has it), and cifar10-32's
    (32, 1,070,794) float32 delta stack with discounted arrival weights;
    two launches bitwise equal. Then timed at both shapes (CUDA events
    behind the sleep kernel, single and back to back) beside its plain
    version, ``torch.matmul(w, x)`` and its byte bound."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.ops import cuda_kernels as ck
    d32 = param_count(INCOME_DIMS)
    signed = torch.ones(32)
    signed[[1, 5, 9, 14, 20, 27]] = -8.0
    nan_x = torch.randn(32, d32, generator=gen)
    nan_x[7, ::97] = float("nan")
    stale = torch.randint(0, 12, (32,), generator=gen).to(torch.float32)
    arrive = (torch.rand(32, generator=gen) < 0.5).to(torch.float32)
    cases = {
        "(32, 11352) positive": (torch.randn(32, d32, generator=gen),
                                 torch.rand(32, generator=gen) + 0.1),
        "(32, 11352) signed, negative total": (torch.randn(32, d32,
                                                      generator=gen), signed),
        "(32, 11352) every weight 0": (torch.randn(32, d32, generator=gen),
                                       torch.zeros(32)),
        "(32, 11352) NaN in the stack": (nan_x, torch.rand(32,
                                                           generator=gen)),
        "cifar10-32 (32, 1070794) deltas": (
            torch.randn(32, CIFAR_PARAMS, generator=gen) * 1e-2,
            arrive * (1.0 + stale) ** -0.5)}
    err, shapes = 0.0, {}
    for label, (x, w) in cases.items():
        x, w = x.to(dev), w.to(dev)
        out = ck.weighted_sum_clients(x, w)
        again = ck.weighted_sum_clients(x, w)
        ref = ck.weighted_sum_clients_reference(x, w)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(out), nan),
              f"K1 sum {label}: NaN where the plain version has none, or "
              "the other way")
        fin = ~nan
        e = float((out[fin] - ref[fin]).abs().max())
        scale = max(1.0, float(ref[fin].abs().max()))
        check(e <= 1e-5 * scale, f"K1 sum {label}: max abs err {e} > "
              f"1e-5 x {scale}")
        check(torch.equal(bits(out), bits(again)),
              f"K1 sum {label}: two launches differ")
        if not w.any():
            check(not out.any(), f"K1 sum {label}: not exactly 0")
        print(f"K1 weighted_sum_clients {label}: weight total "
              f"{float(w.sum()):.3f}, max abs err {e:.3e} (limit "
              f"{1e-5 * scale:.1e}), two launches bitwise equal, NaN at "
              f"the plain version's {int(nan.sum())} entries", flush=True)
        err = max(err, e / scale)
        if "NaN" in label or "every" in label or "signed" in label:
            continue
        c, d = x.shape
        nbytes = 4 * (c * d + c + d)
        b, by = bound_ms(nbytes, 2.0 * c * d)
        row = {"ms": time_ms(lambda: ck.weighted_sum_clients(x, w)),
               "back_to_back_ms": time_back_to_back_ms(
                   lambda: ck.weighted_sum_clients(x, w)),
               "plain_ms": time_ms(
                   lambda: ck.weighted_sum_clients_reference(x, w)),
               "library_ms": time_ms(lambda: torch.matmul(w, x)),
               "bound_ms": b, "bound_by": by, "bytes": nbytes}
        shapes[f"({c}, {d})"] = row
        print(f"time K1 sum ({c}, {d}): kernel {row['ms']:.4f} ms  back to "
              f"back {row['back_to_back_ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  torch.matmul(w, x) "
              f"{row['library_ms']:.4f} ms  bound {b:.5f} ms ({by}, "
              f"{nbytes / 1e6:.2f} MB); {CARD['smi']}", flush=True)
    # The row's own numbers are income-32-noniid's shape, the tick's.
    return {"max_abs_err": err, **shapes[f"(32, {d32})"],
            "by_shape": shapes}


def replay_async_near_ties(cfg, rounds: set) -> dict:
    """``replay_near_ties`` for the asynchronous engine: the tick, one at a
    time and uncaptured (bitwise the captured run), on the CPU and the
    card in lockstep from the same init and arrivals; a tick's evaluated
    models are its post-tick params (the arrivals' adopted ones)."""
    from fedtpu_torch.orchestration.loop import build_experiment
    sides = []
    for device in ("cpu", "cuda"):
        exp = build_experiment(cfg, device=device)
        sides.append({"exp": exp, "state": exp.state,
                      "step": exp.make_step(1)})
    out = {}
    for r in range(max(rounds) + 1):
        for side in sides:
            side["state"], _ = side["step"].fn(side["state"],
                                               side["exp"].batch)
        if r in rounds:
            logits = [side["exp"].model.apply(side["state"]["params"],
                                              side["exp"].batch["x"]).cpu()
                      for side in sides]
            out[r] = near_ties(logits, sides[0]["exp"].batch["mask"] > 0)
    return out


def captured_async(width: int):
    """``make_round`` for ``phase_profile``: ``width`` ticks as one replay
    of the graph the loop captures, fed the run's first ``width`` ticks of
    arrivals."""
    def make(exp):
        from fedtpu_torch.parallel.round import (capture_round_step,
                                                 warm_up_round)
        step = exp.make_step(width)
        warm_up_round(exp.make_step(1), exp.state, exp.batch)
        graph = capture_round_step(step, exp.state, exp.batch)
        arrivals = step.draw_arrivals(0, width).to(exp.device)
        tick = torch.zeros((), dtype=torch.int32, device=exp.device)

        def go(state):
            return state, graph(arrivals, tick)

        return go
    return make


def poison_schedule(ticks: int = SCREEN_TICKS, clients: int = 32):
    """Every client arrives honest (1.0) every tick; from
    SCREEN_POISON_TICK two of them a tick (seeded) submit at -8.0."""
    rng = np.random.default_rng(0)
    arr = np.ones((ticks, clients), np.float32)
    for t in range(SCREEN_POISON_TICK, ticks):
        arr[t, rng.choice(clients, 2, replace=False)] = -8.0
    return torch.from_numpy(arr)


def phase_async_screen() -> dict:
    """The driven, screened and clipped tick (``build_async_round_fn(
    driven=True, screen=True, clip_norm=SCREEN_CLIP)``) on
    income-32-noniid's data for SCREEN_TICKS ticks of ``poison_schedule``:
    uncaptured (8 ticks a step), captured (8 ticks a graph replay) and on
    the CPU. Captured is bitwise uncaptured (state and every output), K1
    twice a tick in the graph, the screened flags equal the CPU's, at least
    one poisoned arrival is screened once the median is warm and no honest
    one is. Returns the captured run's launches."""
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel.async_fed import (build_async_round_fn,
                                                 init_async_state)
    from fedtpu_torch.parallel.round import (capture_round_step, pack_outputs,
                                             unpack_outputs, warm_up_round)
    cfg = async_config()
    arr = poison_schedule()
    width, runs = 8, {}
    for mode in ("cpu", "uncaptured", "captured"):
        dev = torch.device("cpu" if mode == "cpu" else "cuda")
        exp = build_experiment(cfg, device=dev)

        def build(ticks):
            return build_async_round_fn(
                exp.model, exp.tx, 2, 32, driven=True, screen=True,
                screen_cos_min=SCREEN_COS_MIN, clip_norm=SCREEN_CLIP,
                ticks_per_step=ticks)

        step = build(width)
        state = init_async_state(0, 32,
                                 exp.model, exp.tx, same_init=False,
                                 device=dev, screen_window=64)
        outs, graph = [], None
        for k in range(SCREEN_TICKS // width):
            a = arr[k * width:(k + 1) * width].to(dev)
            tick = torch.tensor(k * width, dtype=torch.int32, device=dev)
            if mode == "captured":
                if graph is None:
                    warm_up_round(build(1), state, exp.batch)
                    graph = capture_round_step(step, state, exp.batch)
                outs.append(graph(a, tick).clone())
            else:
                state, raw = step.fn(state, exp.batch, a, tick)
                outs.append(pack_outputs(raw, *step.outputs))
        runs[mode] = (torch.cat(outs).cpu(), [t.cpu() for t in
                                              step.state_tensors(state)],
                      step, graph)
    packed, tensors, step, graph = runs["captured"]
    check(torch.equal(bits(packed), bits(runs["uncaptured"][0]))
          and all(torch.equal(bits(a), bits(b)) for a, b in
                  zip(tensors, runs["uncaptured"][1])),
          "driven screened ticks: captured differs from uncaptured")
    check(graph.launches["weighted_average_clients"] == 2 * width,
          f"driven screened ticks: {graph.launches} per {width}-tick "
          "replay, not K1 twice a tick")
    flags = {}
    for mode in ("cpu", "captured"):
        chunks = runs[mode][0].view(SCREEN_TICKS // width, -1)
        flags[mode] = torch.cat([unpack_outputs(c, width, 32, 2,
                                                *step.outputs)["screened"]
                                 for c in chunks])
    check(torch.equal(flags["cpu"], flags["captured"]),
          "driven screened ticks: screened flags differ card vs CPU at "
          f"{(flags['cpu'] != flags['captured']).nonzero().tolist()}")
    scr = flags["captured"]
    poisoned = scr[arr < 0]
    check(poisoned.sum() >= 1 and not scr[arr > 0].any(),
          f"driven screened ticks: {int(poisoned.sum())} of "
          f"{poisoned.numel()} poisoned arrivals screened, "
          f"{int(scr[arr > 0].sum())} honest ones")
    print(f"driven screened clipped ticks ({SCREEN_TICKS} ticks, 32 "
          f"clients, poison from tick {SCREEN_POISON_TICK}): captured == "
          f"uncaptured bitwise, K1 {graph.launches['weighted_average_clients']}"
          f" per {width}-tick replay, screened flags equal card vs CPU, "
          f"{int(poisoned.sum())} of {poisoned.numel()} poisoned arrivals "
          f"screened, 0 of {int((arr > 0).sum())} honest; {CARD['smi']}",
          flush=True)
    return dict(graph.launches)


def phase_async() -> tuple:
    """Phase (o): the asynchronous engine. K1's sum mode against its plain
    version and timed (``k1_sum_checks``); income-32-noniid ``--async``
    at full width for ASYNC_TICKS ticks, uncaptured at R = 1 and captured
    at R = 10 (bitwise equal: histories, staleness, final params), launches
    counted (K1 and K2 a tick and in the warm-up, K3 the held-out evals,
    K4 = K5 = 0), against the CPU (the same staleness, losses within 1e-4,
    counts equal up to near-tie rows), s/tick of both and 20 captured
    ticks profiled; the driven, screened and clipped ticks
    (``phase_async_screen``); cifar10-32 ``--async`` at full width, bf16
    compute, 10 ticks captured (K1's sum mode at (32, 1,070,794), K2 = K3
    = 0), and 3 ticks on 512 rows against the CPU; the income run resumed
    20 -> 40 with a pending K-buffer, bitwise. Returns the runs' launches
    by label and K1's sum-mode row."""
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_raw
    timings = k1_sum_checks(torch.Generator().manual_seed(12),
                            torch.device("cuda"))
    by_path = {}
    cfg = async_config()
    plain, _ = phase_run("income-32-noniid async uncaptured R=1", cfg,
                         ASYNC_EXPECT, capture=False)
    graph, by_path["income-32-noniid async"] = phase_run(
        "income-32-noniid async captured R=10",
        with_run(cfg, rounds_per_step=10), ASYNC_EXPECT)
    diffs = same_history(plain, graph)
    check(not diffs, f"income-32-noniid async: captured R=10 differs from "
          f"uncaptured R=1 in {diffs}")
    s_plain = statistics.median(plain.sec_per_round)
    s_graph = statistics.median(graph.sec_per_round)
    print(f"income-32-noniid async: captured R=10 == uncaptured R=1 bitwise "
          f"(losses, counts, staleness, histories, stop tick "
          f"{graph.rounds_run}, final params); s/tick (median) uncaptured "
          f"{s_plain:.6e}, captured {s_graph:.6e}, ratio "
          f"{s_plain / s_graph:.3f}; summary {json.dumps(graph.summary())};"
          f" {CARD['smi']}", flush=True)
    phase_card_vs_cpu(cfg, plain, label="income-32-noniid async card vs CPU",
                      replay=replay_async_near_ties)
    prof = phase_profile(cfg, rounds=20,
                         label="income-32-noniid async captured R=10 profile",
                         make_round=captured_async(10), width=10)
    print(f"income-32-noniid async captured R=10: host {prof['host_ms']:.4f}"
          f" ms/tick, device busy {prof['device_busy_ms']:.4f} ms in "
          f"{prof['device_ops']:.1f} ops, idle share "
          f"{prof['idle_share']:.3f}; {CARD['smi']}", flush=True)
    timings["profile"] = prof
    by_path["income-32-noniid async driven screened"] = phase_async_screen()
    cifar = cifar_config(rounds=10)
    cifar = cifar.replace(fed=dataclasses.replace(
        cifar.fed, weighting="uniform", async_mode=True,
        async_arrival_rate=0.5))
    gpu, by_path["cifar10-32 async bf16"] = phase_run(
        "cifar10-32 async bf16 captured", cifar, SPEC_EVAL, min_accuracy=0.0)
    print(f"cifar10-32 async bf16: s/tick (median, captured) "
          f"{statistics.median(gpu.sec_per_round):.6e}; {CARD['smi']}",
          flush=True)
    small = cifar.replace(
        data=dataclasses.replace(cifar.data, synthetic_rows=512),
        fed=dataclasses.replace(cifar.fed, rounds=3))
    gpu, by_path["cifar10-32 async bf16 512 rows"] = phase_run(
        "cifar10-32 async bf16 512 rows", small, SPEC_EVAL, min_accuracy=0.0)
    phase_card_vs_cpu(small, gpu, label="cifar10-32 async bf16 512 rows "
                      "card vs CPU", drift_cap=BF16_DRIFT_CAP,
                      loss_tol=BF16_LOSS_TOL, replay=replay_async_near_ties)

    def pending(directory):
        raw, _, step = load_checkpoint_raw(directory)
        check(float(raw["buf_count"]) > 0,
              f"async resume: no pending K-buffer at tick {step}")
        print(f"async resume: {float(raw['buf_count']):.0f} updates pending "
              f"in the K-buffer at tick {step}", flush=True)

    resume_is_bitwise("async income-32-noniid", with_fed(
        cfg, termination_patience=1000), at_resume=pending)
    return by_path, timings


# Phase (p): the serving front end at the income MLP's full width, 14 ->
# 50 -> 200 -> 2 on 32 slots, a K-buffer of 16, fed loadgen's --synthesize
# trace (1,000,000 users, 100,000 arrivals over 60 virtual s) in frames of
# 1,024 events.
SERVE_CFG = dict(cohort=32, buffer_size=16, staleness_power=0.5,
                 local_steps=1, tick_interval_s=0.5, data_rows=10_000,
                 data_features=14, data_classes=2, model_hidden=(50, 200),
                 seed=0)
SERVE_TRACE = dict(users=1_000_000, arrivals=100_000, horizon_s=60.0, seed=0)
SERVE_FRAME = 1024
# The screened cell: a v2 trace with 20 % attackers at sign-flip scale 10,
# at loadgen's default rate (10,000 arrivals over 30 virtual s).
# flush_every = the cohort fires a tick once 32 updates pend, so one tick
# binds each slot to at most one user (at the time-driven cadence alone
# ~160 arrivals a tick evict one another on 32 slots, and an honest user
# inherits the strike of the attacker it evicted; at 64 too). The knobs'
# margins, from fedtpu_torch/benchmarks/screen_margin.py on the card
# (PERF.md §6): no honest user is quarantined for norm multiples 3.5 to 24
# (the grid's end) at every cosine limit from -0.6 to 0.0, nor for
# flush_every 16 and 32; three are at 3.0. At fedtpu's cosine -0.2 the
# decision log is one and the same from multiple 5 to 8: 6.5 is its
# middle. The trace itself depends on numpy's version (synthesize_trace's
# draws): numpy 2.3.5 and 2.0.2 write different files from the same seed.
SERVE_POISON = dict(users=1_000_000, arrivals=10_000, horizon_s=30.0, seed=0,
                    poison_frac=0.2, poison_scale=10.0)
SERVE_SCREEN = dict(screen=True, flush_every=32, screen_norm_mult=6.5,
                    screen_cos_min=-0.2)
SERVE_PROFILE_TICKS = 20


def serve_rows(path: str) -> list:
    """A trace file's events as the loadgen sends them: ``[user, t, lat]``,
    an attacker's with the version slot empty and its poison scale."""
    from fedtpu_torch.serving.traces import read_trace
    _, events = read_trace(path)
    return [[e.user, e.t, e.lat, None, e.poison] if e.poison > 0
            else [e.user, e.t, e.lat] for e in events]


def serve_engine(device: str, capture=None, **kw):
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    return ServingEngine(ServingConfig(**{**SERVE_CFG, **kw}),
                         registry=MetricsRegistry(), device=device,
                         capture=capture)


def serve_replay(eng, rows: list, drain: bool = True):
    """``rows`` through ``offer_many`` in the loadgen's frames, then the
    drain."""
    for i in range(0, len(rows), SERVE_FRAME):
        eng.offer_many(rows[i:i + SERVE_FRAME])
    if drain:
        eng.drain()
    return eng


def serve_tensors(eng) -> list:
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    return [t.cpu() for t in async_state_tensors(eng.state)]


def serve_no_wall(summary: dict) -> dict:
    return {k: v for k, v in summary.items()
            if k not in ("wall_s", "rounds_per_sec", "eval_accuracy")}


def serve_wire(directory: str, trace: str) -> tuple:
    """``run_server`` in a thread (``once``, port file, history file) fed
    by ``run_loadgen`` over localhost, launches counted from zero around
    it: K1 (sum mode) and K2 once a non-empty tick and in the graph's
    warm-up, K3 once an ``eval_accuracy`` (the loadgen's final stats and
    the shutdown summary), K4 = K5 = 0. Returns the loadgen's summary,
    the server's, the history lines and the launches."""
    import threading
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.ops.cuda_kernels import LAUNCHES, reset_launch_counts
    from fedtpu_torch.serving.loadgen import read_port_file, run_loadgen
    from fedtpu_torch.serving.server import run_server
    pf = os.path.join(directory, "serve.port")
    hist = os.path.join(directory, "serve.history.jsonl")
    box = {}

    def serve():
        try:
            box["summary"] = run_server(ServingConfig(**SERVE_CFG),
                                        port_file=pf, history_path=hist,
                                        once=True, verbose=False)
        except BaseException as e:  # reported below, on the main thread
            box["error"] = e

    reset_launch_counts()
    th = threading.Thread(target=serve)
    th.start()
    try:
        # The loadgen's clock starts once the server listens (after the
        # engine's build and capture), so events/s is the replay's.
        read_port_file(pf, timeout=300)
        res = run_loadgen(trace, port_file=pf, batch=SERVE_FRAME,
                          timeout=300)
    finally:
        th.join(timeout=600)
    check(not th.is_alive() and "error" not in box,
          f"serve: the server thread failed: {box.get('error')!r}")
    launches = dict(LAUNCHES)
    with open(hist) as fh:
        lines = fh.read().splitlines()
    ticks = sum(json.loads(line)["tick_slots"] > 0 for line in lines)
    want = {"weighted_average_clients": ticks + 1,
            "fused_eval_confusion": ticks + 1, "fused_mlp_forward": 2,
            "ring_all_reduce_sum": 0, "fused_round": 0}
    check(launches == want, f"serve: launches {launches}, expected {want} "
          f"({ticks} non-empty ticks + the warm-up, 2 evals)")
    stats = res["server_stats"]
    check(res["events_sent"] == SERVE_TRACE["arrivals"]
          and sum(res["admission"].values()) == SERVE_TRACE["arrivals"]
          and stats["ticks"] == len(lines) and stats["incorporated"] > 0,
          f"serve: loadgen {res['events_sent']} events, acks "
          f"{res['admission']}, server ticks {stats['ticks']} vs "
          f"{len(lines)} history lines")
    summary = box["summary"]
    pct = summary["update_to_incorporation"]
    print(f"serve + loadgen over localhost (income MLP 14->50->200->2, 32 "
          f"slots, K-buffer 16, {SERVE_TRACE['arrivals']} arrivals from "
          f"{SERVE_TRACE['users']} users, frames of {SERVE_FRAME}): "
          f"{res['events_per_sec']:.1f} events/s (loadgen, "
          f"{res['wall_s']:.3f} s), {summary['rounds_per_sec']:.3f} "
          f"ticks/s ({summary['ticks']} ticks, {ticks} non-empty, in "
          f"{summary['wall_s']:.3f} s), update-to-incorporation "
          f"p50/p90/p99 {pct['p50_s']:.4f}/{pct['p90_s']:.4f}/"
          f"{pct['p99_s']:.4f} virtual s, admission {res['admission']}, "
          f"version {summary['version']}, launches {launches}, "
          f"eval_accuracy {summary['eval_accuracy']}; {CARD['smi']}",
          flush=True)
    return res, summary, lines, launches


# The largest card-vs-CPU logit drift of the served global that the
# near-tie allowance accepts (the same model reached by the card's and the
# CPU's float32 sums; a wrong forward drifts by orders of magnitude more).
SERVE_DRIFT_CAP = 1e-3


def serve_eval_near_ties(label: str, card, cpu_global: torch.Tensor,
                         cpu_accuracy: float) -> dict:
    """The card's final global (its K3 forward over the fixture) against
    the CPU run's (the plain forward): the logit drift within
    SERVE_DRIFT_CAP, every row whose prediction differs a near tie of the
    CPU model's logits (``near_ties``: the CPU gap below ``NEAR_TIE_REL``
    of the row's largest logit or below twice the drift), the card's
    ``eval_accuracy`` the right-row count of its logits, and the right
    rows of the card and of the CPU's ``eval_accuracy`` apart by at most
    the moved rows. Returns the moved rows, the drift and both right-row
    counts."""
    from fedtpu_torch.ops.cuda_kernels import fused_mlp_forward
    from fedtpu_torch.parallel.async_fed import async_global_params
    dims = card.model.mlp_dims
    y = card._eval_y.cpu()
    logits = [fused_mlp_forward(cpu_global, dims, card._eval_x.cpu()),
              fused_mlp_forward(async_global_params(card.state), dims,
                                card._eval_x).cpu()]
    moved = logits[0].argmax(-1) != logits[1].argmax(-1)
    rows = torch.ones(moved.shape, dtype=torch.bool)
    _, inside, drift = near_ties([x[None] for x in logits], rows[None])
    n = int(y.shape[0])
    right = [round(cpu_accuracy * n), int((logits[1].argmax(-1) == y).sum())]
    out = {"moved": int(moved.sum()), "drift": drift, "right_cpu": right[0],
           "right_card": right[1], "rows": n}
    check(drift <= SERVE_DRIFT_CAP,
          f"{label} card vs CPU: logit drift {drift:.3e} above "
          f"{SERVE_DRIFT_CAP}")
    check(out["moved"] <= int(inside[0]),
          f"{label} card vs CPU: {out['moved']} predictions differ, "
          f"{int(inside[0])} near-tie rows (drift {drift:.3e})")
    check(card.eval_accuracy() == right[1] / n
          and abs(right[1] - right[0]) <= out["moved"],
          f"{label} card vs CPU: eval_accuracy card {card.eval_accuracy()} "
          f"CPU {cpu_accuracy}, right rows {right} of {n}, "
          f"{out['moved']} near-tie rows moved")
    return out


def serve_kernel_rows(eng) -> dict:
    """K2 and K3 at the shapes the serving path gives them, on the card
    engine's own tensors after its drain, each against its plain version
    on the same inputs and timed beside it and its bound: K2 on the
    adopted per-slot params over the slots' shards (the tick's eval, 32 x
    328 rows), counts equal but on near-tie rows of the plain logits; K3
    on the freshest global over the full fixture (``eval_accuracy``'s
    forward, N = 10,000), within 1e-4. These launches compare; they are
    made after the counted runs."""
    from fedtpu_torch.models.mlp import mlp_apply, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    from fedtpu_torch.parallel.async_fed import async_global_params
    dims = eng.model.mlp_dims
    k = dims[-1]
    params, b = eng.state["params"], eng.batch
    x, y, mask = b["x"], b["y"], b["mask"]
    glob, x_eval = async_global_params(eng.state), eng._eval_x
    c, n = y.shape
    live = float(mask.sum())
    conf = ck.fused_eval_confusion(params, dims, x, y, mask, k)
    ref = ck.fused_eval_confusion_reference(params, dims, x, y, mask, k)
    ties = near_tie_rows(mlp_apply(unflatten(params, dims), x)) & (mask > 0)
    moved = (conf - ref).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties.sum(dim=1)).all()),
          f"K2 at the serving shape ({c}, {n}): counts differ on "
          f"{moved.tolist()} rows per slot, near ties "
          f"{ties.sum(dim=1).tolist()}")
    logits = ck.fused_mlp_forward(glob, dims, x_eval)
    e3 = float((logits - ck.fused_mlp_forward_reference(glob, dims, x_eval)
                ).abs().max())
    check(e3 <= 1e-4, f"K3 at the serving shape N={x_eval.shape[0]}: max "
          f"abs err {e3} > 1e-4")
    rows = {}
    for name, kernel, plain, nbytes, flops, err, shape in (
            ("fused_eval_confusion",
             lambda: ck.fused_eval_confusion(params, dims, x, y, mask, k),
             lambda: ck.fused_eval_confusion_reference(params, dims, x, y,
                                                       mask, k),
             4 * (params.numel() + live * (dims[0] + 1) + mask.numel()
                  + c * k * k), mlp_flops(dims, live),
             float((conf - ref).abs().max()),
             f"serve tick eval ({c}, {n}), {int(live)} real rows"),
            ("fused_mlp_forward",
             lambda: ck.fused_mlp_forward(glob, dims, x_eval),
             lambda: ck.fused_mlp_forward_reference(glob, dims, x_eval),
             4 * (glob.numel() + x_eval.numel() + x_eval.shape[0] * k),
             mlp_flops(dims, x_eval.shape[0]), e3,
             f"serve eval_accuracy N={x_eval.shape[0]}")):
        bnd, by = bound_ms(nbytes, flops)
        rows[name] = {"shape": shape, "dims": list(dims),
                      "max_abs_err": err, "ms": time_ms(kernel),
                      "plain_ms": time_ms(plain), "library_ms": None,
                      "bound_ms": bnd, "bound_by": by}
        r = rows[name]
        print(f"time {name} {shape}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {bnd:.5f} ms ({by}); max abs "
              f"err {err:.3e} (K2: {int(moved.sum())} rows moved, "
              f"{int(ties.sum())} near ties; K3: max |logit| "
              f"{float(logits.abs().max()):.3e}); {CARD['smi']}",
              flush=True)
    return rows


def serve_cpu_plain(trace: str) -> dict:
    """The trace through ``offer_many`` + ``drain`` on the CPU, in a
    process of its own while the card works: the history, the summary
    without its wall-clock keys and accuracy, the final global, the
    accuracy; and ``defense_sim.simulate``'s lines on the CPU."""
    from fedtpu_torch.parallel.async_fed import async_global_params
    from fedtpu_torch.robust.defense_sim import simulate
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    cpu = serve_replay(serve_engine("cpu"), serve_rows(trace))
    return {"history": cpu.history_lines(),
            "summary": serve_no_wall(cpu.summary()),
            "global": async_global_params(cpu.state).clone(),
            "eval_accuracy": cpu.eval_accuracy(),
            "s": time.perf_counter() - t0,
            "sim": simulate(device="cpu")["lines"]}


def serve_cpu_screened(poison: str) -> dict:
    """The screened cell on the CPU, in a process of its own: the decision
    lines, the history, the final global, the accuracy."""
    from fedtpu_torch.parallel.async_fed import async_global_params
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    scr = serve_replay(serve_engine("cpu", **SERVE_SCREEN), serve_rows(poison))
    return {"log": [json.dumps(r, sort_keys=True) for r in scr.defense_log],
            "history": scr.history_lines(),
            "global": async_global_params(scr.state).clone(),
            "eval_accuracy": scr.eval_accuracy(),
            "s": time.perf_counter() - t0}


def serve_profile(rows: list) -> dict:
    """SERVE_PROFILE_TICKS captured ticks fed by the trace's frames: the
    host ms of a tick (the mask, the replay's enqueue) and of an
    ``offer_many`` of one frame on the host clock (untraced window), the
    device ms and op count of a tick under torch.profiler (the next
    window), the device's idle share against the untraced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = serve_engine("cuda")
    count = {"ticks": 0, "tick_s": 0.0}
    inner = eng._device_tick

    def timed(mask):
        t0 = time.perf_counter()
        out = inner(mask)
        count["tick_s"] += time.perf_counter() - t0
        count["ticks"] += 1
        return out

    eng._device_tick = timed
    frames = iter(range(0, len(rows), SERVE_FRAME))

    def window(ticks: int) -> tuple:
        count.update(ticks=0, tick_s=0.0)
        n = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while count["ticks"] < ticks:
            i = next(frames)
            eng.offer_many(rows[i:i + SERVE_FRAME])
            n += 1
        torch.cuda.synchronize()
        return time.perf_counter() - t0, n, dict(count)

    window(3)
    wall, n, c = window(SERVE_PROFILE_TICKS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, _, tc = window(SERVE_PROFILE_TICKS)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / tc["ticks"] / 1e3
    ops = sum(e.count for e in dev) / tc["ticks"]
    out = {"ticks": c["ticks"], "frames": n,
           "wall_ms_per_tick": wall / c["ticks"] * 1e3,
           "host_ms_per_tick": c["tick_s"] / c["ticks"] * 1e3,
           "host_ms_per_frame": wall / n * 1e3,
           "host_ms_per_frame_without_ticks": (wall - c["tick_s"]) / n * 1e3,
           "device_ms_per_tick": busy_ms, "device_ops_per_tick": ops,
           "idle_share": 1 - busy_ms / (wall / c["ticks"] * 1e3),
           "traced_wall_ms_per_tick": traced / tc["ticks"] * 1e3}
    print(f"serve captured tick profile ({c['ticks']} ticks in {n} frames "
          f"of {SERVE_FRAME} untraced, {tc['ticks']} traced): host "
          f"{out['host_ms_per_tick']:.4f} ms a tick (mask + replay), "
          f"{out['host_ms_per_frame']:.4f} ms an offer_many of a frame "
          f"({out['host_ms_per_frame_without_ticks']:.4f} ms without its "
          f"ticks), wall {out['wall_ms_per_tick']:.4f} ms a tick; device "
          f"busy {busy_ms:.4f} ms a tick in {ops:.1f} ops, idle share "
          f"{out['idle_share']:.4f}; {CARD['smi']}", flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / tc['ticks'] / 1e3:.4f} ms/tick"
              f" x{e.count / tc['ticks']:.1f}  {e.key[:90]}", flush=True)
    return out


def serve_screened(poison: str, cpu: dict, cpu_sim: list) -> dict:
    """The screened cell: SERVE_POISON's v2 trace (the file ``poison``)
    through a screening engine (SERVE_SCREEN) on the card, captured,
    launches counted from zero (K1 twice a tick and in the warm-up),
    against the CPU's run (``cpu``, from ``serve_cpu_screened``): the
    decision logs equal line for line, the histories equal, the accuracy
    equal but on near ties (``serve_eval_near_ties``), at least one
    attacker quarantined and no honest user. Then ``defense_sim.simulate``
    at its own constants on the card against the CPU's lines
    (``cpu_sim``). Returns the card run's launches."""
    from fedtpu_torch.ops.cuda_kernels import LAUNCHES, reset_launch_counts
    from fedtpu_torch.robust.defense_sim import simulate
    from fedtpu_torch.serving.traces import poisoned_user_ids
    rows = serve_rows(poison)
    attackers = set(poisoned_user_ids(SERVE_POISON["users"],
                                      SERVE_POISON["seed"],
                                      SERVE_POISON["poison_frac"]).tolist())
    reset_launch_counts()
    t0 = time.perf_counter()
    card = serve_replay(serve_engine("cuda", **SERVE_SCREEN), rows)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    ticks = sum(n > 0 for n in card.history["tick_slots"])
    check(launches["weighted_average_clients"] == 2 * (ticks + 1)
          and launches["fused_eval_confusion"] == ticks + 1,
          f"serve screened: launches {launches} for {ticks} non-empty "
          "ticks + the warm-up, not K1 twice and K2 once each")
    lines = [json.dumps(r, sort_keys=True) for r in card.defense_log]
    want = cpu["log"]
    first = next((i for i, (a, b) in enumerate(zip(lines, want)) if a != b),
                 None)
    check(lines == want, f"serve screened: decision log differs card vs "
          f"CPU ({len(lines)} vs {len(want)} lines, first at {first})")
    check(card.history_lines() == cpu["history"],
          "serve screened: history differs card vs CPU")
    tie = serve_eval_near_ties("serve screened", card, cpu["global"],
                               cpu["eval_accuracy"])
    caught = sorted(u for u in card.quarantined if u in attackers)
    honest = sorted(u for u in card.quarantined if u not in attackers)
    check(caught and not honest,
          f"serve screened: quarantined {len(caught)} attackers and honest "
          f"users {honest[:10]}")
    print(f"serve screened (v2 trace, {SERVE_POISON['arrivals']} arrivals, "
          f"{SERVE_POISON['poison_frac']:.0%} attackers at scale "
          f"{SERVE_POISON['poison_scale']:g}; {SERVE_SCREEN}): decision log "
          f"{len(lines)} lines equal card vs CPU, history equal, "
          f"{card.screened_total} screened, {len(caught)} attackers "
          f"quarantined, 0 honest; {card.tick_count} ticks ({ticks} "
          f"non-empty) in {wall:.3f} s on the card ({cpu['s']:.3f} s on "
          f"the CPU), launches {launches}; logit drift card vs CPU "
          f"{tie['drift']:.3e}, {tie['moved']} predictions moved (near "
          f"ties), right rows card {tie['right_card']} CPU "
          f"{tie['right_cpu']} of {tie['rows']}; {CARD['smi']}",
          flush=True)
    sim = simulate(device="cuda")
    check(sim["lines"] == cpu_sim,
          "defense sim: decision lines differ card vs CPU")
    summ = sim["summary"]
    print(f"defense sim (fedtpu's constants): {len(sim['lines'])} decision "
          f"lines equal card vs CPU; quarantined {summ['quarantined']} of "
          f"attackers {summ['attackers']}, honest "
          f"{summ['quarantined_honest']}; {CARD['smi']}", flush=True)
    return launches


# The CLI pair's trace: loadgen's --synthesize at its default users and
# arrival rate (100,000 arrivals over 60 s), cut to 20,000 arrivals.
SERVE_CLI_TRACE = ("--users", "1000000", "--arrivals", "20000",
                   "--horizon", "12")


def serve_cli(directory: str) -> dict:
    """``serve --once --port-file`` as a subprocess on the card, answered
    by ``loadgen --synthesize --json`` (SERVE_CLI_TRACE) as another: both
    exit 0, every event was sent and the server ticked."""
    root = os.path.dirname(os.path.abspath(__file__))
    pf = os.path.join(directory, "cli.port")
    trace = os.path.join(directory, "cli.jsonl")
    cmd = [sys.executable, "-m", "fedtpu_torch.cli"]
    t0 = time.perf_counter()
    serve = subprocess.Popen(cmd + ["serve", "--once", "--port-file", pf,
                                    "--cohort", "32", "--buffer-size", "16",
                                    "--quiet", "--json"], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        # The server writes its port file once it listens (after the
        # engine's build and capture): start the loadgen then, so its
        # events/s is the replay's.
        from fedtpu_torch.serving.loadgen import read_port_file
        read_port_file(pf, timeout=300)
        load = subprocess.run(cmd + ["loadgen", trace, "--synthesize",
                                     *SERVE_CLI_TRACE, "--port-file", pf,
                                     "--json", "--quiet"],
                              cwd=root, capture_output=True, text=True,
                              timeout=400)
        out, err = serve.communicate(timeout=300)
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait(timeout=60)
    check(serve.returncode == 0 and load.returncode == 0,
          f"serve/loadgen CLI: exit {serve.returncode}/{load.returncode}: "
          f"{err[-2000:]} {load.stderr[-2000:]}")
    res = json.loads(load.stdout.strip().splitlines()[-1])
    summary = json.loads(out.strip().splitlines()[-1])
    check(res["server_stats"]["ticks"] > 0
          and res["events_sent"] == int(SERVE_CLI_TRACE[3]),
          f"serve/loadgen CLI: {res['events_sent']} events sent, server "
          f"stats {res['server_stats']}")
    print(f"CLI serve --once + loadgen --synthesize {' '.join(SERVE_CLI_TRACE)}"
          f" --json (subprocesses, {time.perf_counter() - t0:.1f} s): "
          f"{res['events_sent']} events, {res['events_per_sec']:.1f} "
          f"events/s, server ticks {res['server_stats']['ticks']}, "
          f"{summary['rounds_per_sec']:.3f} ticks/s; {CARD['smi']}",
          flush=True)
    return res


def phase_serve() -> tuple:
    """Phase (p): the serving front end. The wire path (``serve_wire``) at
    the income MLP's full width; SERVE_PROFILE_TICKS captured ticks
    profiled; then, while the CPU runs (``serve_cpu_plain``,
    ``serve_cpu_screened``) go on in two processes of their own: the same trace in process on the card captured
    and uncaptured (bitwise) and against the CPU (history and summary
    equal, global params within 1e-4, predictions equal but on near
    ties); the run checkpointed at the trace's midpoint with updates
    pending and resumed in a fresh engine, bitwise the uninterrupted one;
    the CLI pair (``serve_cli``); the screened cell and the defense sim
    (``serve_screened``); K2 and K3 at the serving shapes against their
    plain versions (``serve_kernel_rows``). Returns the launches by path,
    the numbers for the kernels line and K2's and K3's serving rows."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from fedtpu_torch.parallel.async_fed import async_global_params
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    by_path, numbers, seconds = {}, {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    with tempfile.TemporaryDirectory() as directory:
        trace = os.path.join(directory, "trace.jsonl")
        poison = os.path.join(directory, "poison.jsonl")
        write_trace(trace, *synthesize_trace(**SERVE_TRACE))
        write_trace(poison, *synthesize_trace(**SERVE_POISON))
        rows = serve_rows(trace)
        lap("traces")
        res, summary, wire_lines, by_path["serve income MLP"] = serve_wire(
            directory, trace)
        numbers["wire"] = {k: res[k] for k in ("events_per_sec", "wall_s")}
        numbers["wire"].update(rounds_per_sec=summary["rounds_per_sec"],
                               ticks=summary["ticks"],
                               latency=summary["update_to_incorporation"])
        lap("wire")
        numbers["profile"] = serve_profile(rows)
        lap("profile")
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            cpu_screened = pool.submit(serve_cpu_screened, poison)
            cpu_side = pool.submit(serve_cpu_plain, trace)
            t0 = time.perf_counter()
            card = serve_replay(serve_engine("cuda"), rows)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            plain = serve_replay(serve_engine("cuda", capture=False), rows)
            plain_s = time.perf_counter() - t0
            check(card.history_lines() == wire_lines,
                  "serve: the in-process history differs from the wire "
                  "run's")
            check(card.history_lines() == plain.history_lines()
                  and all(torch.equal(bits(a), bits(b)) for a, b in
                          zip(serve_tensors(card), serve_tensors(plain))),
                  "serve: captured differs from uncaptured")
            half = len(rows) // 2
            first = serve_replay(serve_engine("cuda"), rows[:half],
                                 drain=False)
            check(bool(first.pending), "serve resume: nothing pending at "
                  "the checkpoint")
            ck = os.path.join(directory, "ck")
            first.checkpoint(ck)
            second = serve_engine("cuda")
            second.restore(ck)
            serve_replay(second, rows[half:])
            check(second.history_lines() == card.history_lines()
                  and all(torch.equal(bits(a), bits(b)) for a, b in
                          zip(serve_tensors(second), serve_tensors(card))),
                  "serve resume: differs from the uninterrupted run")
            print(f"serve resume: checkpoint at event {half} (tick "
                  f"{first.tick_count}, {len(first.pending)} updates "
                  f"pending, {first.nbuf_host:.0f} in the K-buffer), "
                  f"restored into a fresh captured engine, finished: "
                  f"bitwise the uninterrupted run; {CARD['smi']}",
                  flush=True)
            lap("card replays, resume")
            cli = serve_cli(directory)
            numbers["cli"] = {k: cli[k] for k in ("events_per_sec",
                                                  "events_sent")}
            lap("cli")
            cpu = cpu_side.result(timeout=900)
            cpu_scr = cpu_screened.result(timeout=900)
            lap("waiting for the CPU")
        check(cpu["history"] == card.history_lines(),
              "serve card vs CPU: history differs")
        check(cpu["summary"] == serve_no_wall(card.summary()),
              "serve card vs CPU: summary differs")
        err = float((async_global_params(card.state).cpu()
                     - cpu["global"]).abs().max())
        check(err <= 1e-4, f"serve card vs CPU: global params max abs err "
              f"{err:.3e} > 1e-4")
        tie = serve_eval_near_ties("serve", card, cpu["global"],
                                   cpu["eval_accuracy"])
        print(f"serve in process: card vs CPU history and summary (but "
              f"its wall-clock keys and eval_accuracy) equal "
              f"({len(wire_lines)} ticks, = the wire run's), global params "
              f"max abs err {err:.3e}, logit drift {tie['drift']:.3e}, "
              f"{tie['moved']} predictions moved (near ties), right rows "
              f"card {tie['right_card']} CPU {tie['right_cpu']} of "
              f"{tie['rows']}; captured == uncaptured bitwise; "
              f"replay s: card captured {card_s:.3f}, uncaptured "
              f"{plain_s:.3f}, CPU {cpu['s']:.3f}; {CARD['smi']}",
              flush=True)
        numbers.update(card_vs_cpu_max_abs_err=err, near_ties=tie,
                       replay_s={"captured": card_s, "uncaptured": plain_s,
                                 "cpu": cpu["s"]})
        kernel_rows = serve_kernel_rows(card)
        lap("kernels at the serving shapes")
        by_path["serve screened"] = serve_screened(poison, cpu_scr, cpu["sim"])
        lap("screened, defense sim")
    print(f"phase (p) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers, kernel_rows


# Phase (q): the rest of the serving stack at the income MLP's full width,
# each gateway engine phase (p)'s (SERVE_CFG): the store-backed fleet of two
# gateways over 1,000,000 users (the memory store: a record is the slot's
# four (11,352,) float32 rows, two int32s and the 32-byte header), the
# flush/adopt failover, one gateway behind the wire-fault proxy, the net
# sim, the autoscale control plane, and the CLI fleet with its lost-ack
# drill. The trace is loadgen's --synthesize population at its default
# rate (100,000 arrivals over 60 s), cut to 12 virtual s.
FLEET_TRACE = dict(users=1_000_000, arrivals=20_000, horizon_s=12.0, seed=0)
FLEET_USERS = 1_000_000
FLEET_N = 2
# The frame whose gateway-1 part is sent to gateway 0 on purpose: its
# redirect must be followed.
FLEET_MISROUTED = 3
FLEET_GEN = "fleet-gen-0"
# Card vs CPU: params and store values (float32, 24 ticks of Adam).
FLEET_TOL = 1e-4
# The lost-ack drill: gateway 1 of the CLI fleet kills itself after acking
# (processing) its fifth frame, before the ack is sent.
FLEET_KILL = "1:5"


def fleet_parts(rows: list) -> list:
    """The trace as the partitioning client sends it: frames of SERVE_FRAME
    events, each split by owner (user % 2) in trace order; per gateway,
    its part of every frame (empty parts included)."""
    parts = [[] for _ in range(FLEET_N)]
    for i in range(0, len(rows), SERVE_FRAME):
        per = [[] for _ in range(FLEET_N)]
        for r in rows[i:i + SERVE_FRAME]:
            per[r[0] % FLEET_N].append(r)
        for g in range(FLEET_N):
            parts[g].append(per[g])
    return parts


def fleet_engine(device: str, g: int, capture=None):
    """A gateway's engine (SERVE_CFG) with its shard of the memory store."""
    eng = serve_engine(device, capture=capture)
    store = eng.attach_store(FLEET_USERS, shard_index=g, num_shards=FLEET_N)
    store.generation = FLEET_GEN
    return eng


def timed_swaps(eng) -> dict:
    """Count the engine's store swaps and their host seconds (a tick's
    swaps are one call, its device read and write included)."""
    acc = {"swaps": 0, "s": 0.0}
    inner = eng._swap_slots

    def swap(swaps):
        t0 = time.perf_counter()
        inner(swaps)
        acc["s"] += time.perf_counter() - t0
        acc["swaps"] += len(swaps)

    eng._swap_slots = swap
    return acc


def fleet_replay(device: str, rows: list, directory=None, capture=None):
    """Each gateway's part of the trace in process (``offer_many`` of its
    part of every frame, then the drain; no sockets), the engine
    checkpointed (its store rides the checkpoint) under
    ``directory/g<i>`` when a directory is given. Returns the engines,
    their swap counters and the wall seconds."""
    engines, swaps = [], []
    t0 = time.perf_counter()
    for g, parts in enumerate(fleet_parts(rows)):
        eng = fleet_engine(device, g, capture)
        swaps.append(timed_swaps(eng))
        for part in parts:
            eng.offer_many(part)
        eng.drain()
        if directory:
            eng.checkpoint(os.path.join(directory, f"g{g}"))
        engines.append(eng)
    return engines, swaps, time.perf_counter() - t0


def engine_digest(eng) -> str:
    """sha256 of an engine's state bits and its store's export (the
    checkpoint arrays, its generation aside): equal digests mean the two
    runs left the same state and store, bit for bit."""
    import hashlib
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    h = hashlib.sha256()
    for t in async_state_tensors(eng.state):
        h.update(bits(t.detach().cpu().contiguous()).numpy().tobytes())
    arrays = eng.store.checkpoint_arrays()
    for key in sorted(arrays):
        if key != "store_generation":
            h.update(key.encode())
            h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()


def tick_vs_cpu(eng, label: str) -> dict:
    """Hold each tick of the card engine ``eng`` against the same tick on
    the CPU from the same inputs: before each replay the card's state is
    read to the host; a CPU twin (the same ServingConfig's step, uncaptured)
    ticks that state on the same mask; its state must be within FLEET_TOL
    of the card's after the replay (float tensors; integer ones equal).
    Wraps ``eng._device_tick``; the returned dict fills in as ticks run."""
    from fedtpu_torch.orchestration.checkpoint import _to_cpu
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    twin = serve_engine("cpu", capture=False)
    inner = eng._device_tick
    acc = {"ticks": 0, "max_abs_err": 0.0}

    def tick(mask):
        twin.state = _to_cpu(eng.state)
        out = inner(mask)
        twin._device_tick(mask)
        for a, b in zip(async_state_tensors(eng.state),
                        async_state_tensors(twin.state)):
            a = a.cpu()
            if a.is_floating_point():
                err = float((a.double() - b.double()).abs().max())
                check(err <= FLEET_TOL, f"{label} tick {acc['ticks'] + 1}: "
                      f"card vs CPU from the same inputs, max abs err "
                      f"{err:.3e} > {FLEET_TOL}")
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
            else:
                check(torch.equal(a, b), f"{label} tick {acc['ticks'] + 1}"
                      ": an integer tensor differs card vs CPU from the "
                      "same inputs")
        acc["ticks"] += 1
        return out

    eng._device_tick = tick
    return acc


def fleet_handoff(device: str, rows: list, directory: str,
                  checkpoint: bool = False) -> dict:
    """The flush/adopt failover through the gateway handler, in process:
    both gateways take their parts of the trace's first half; gateway 1
    flushes (writeback, spool, checkpoint) with its pending queue
    spooled; gateway 0 refuses the export under a stale generation, then
    adopts shard 1 under the flushed generation and replays the spool; the
    adopted records must be the exported ones, byte for byte; the rest of
    the trace goes to gateway 0 alone; gateway 0 is drained (and
    checkpointed under ``directory/final`` when ``checkpoint``; else its
    engine is returned under ``engine``)."""
    from fedtpu_torch.serving.gateway import _Gateway, _gateway_handle
    parts = fleet_parts(rows)
    half = len(parts[0]) // 2
    engines = [fleet_engine(device, g) for g in range(FLEET_N)]
    swaps = timed_swaps(engines[0])
    spans = []
    if engines[0].device.type == "cuda":
        # Gateway 0's device span of a tick (the mask's copy and the
        # graph's replay, between two CUDA events).
        inner = engines[0]._device_tick

        def tick(mask):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = inner(mask)
            end.record()
            spans.append((start, end))
            return out

        engines[0]._device_tick = tick
    # C6: each card tick of both gateways against the CPU's from the same
    # inputs (outside gateway 0's timed device span).
    same_inputs = ([tick_vs_cpu(eng, f"handoff gateway {g}")
                    for g, eng in enumerate(engines)]
                   if engines[0].device.type == "cuda" else [])
    gws = [_Gateway(g, FLEET_N, None, FLEET_GEN,
                    os.path.join(directory, f"g{g}")) for g in range(FLEET_N)]

    def send(g: int, events: list) -> None:
        if events:
            resp = _gateway_handle(gws[g], engines[g],
                                   {"op": "updates", "events": events})
            check(resp["op"] == "acks", f"handoff: gateway {g}: {resp}")

    t0 = time.perf_counter()
    for k in range(half):
        for g in range(FLEET_N):
            send(g, parts[g][k])
    fl = _gateway_handle(gws[1], engines[1], {
        "op": "flush", "path": os.path.join(directory, "spool.jsonl")})
    check(fl["op"] == "flushed" and fl["spooled"] > 0,
          f"handoff: flush {fl}")
    stale = _gateway_handle(gws[0], engines[0], {
        "op": "adopt", "shard": 1, "checkpoint_dir": gws[1].checkpoint_dir,
        "generation": "stale"})
    check(stale["op"] == "error" and "generation" in stale["reason"],
          f"handoff: a stale generation was not refused: {stale}")
    ad = _gateway_handle(gws[0], engines[0], {
        "op": "adopt", "shard": 1, "checkpoint_dir": gws[1].checkpoint_dir,
        "spool": fl["spool"], "generation": FLEET_GEN})
    exported = np.array(sorted(engines[1].store._touched), np.int64)
    check(ad["op"] == "adopted" and ad["replayed"] == fl["spooled"]
          and ad["rows"] == exported.size and ad["owned"] == [0, 1],
          f"handoff: adopt {ad}, flush {fl}, {exported.size} exported")
    check(np.array_equal(engines[0].store._fetch(exported),
                         engines[1].store._fetch(exported)),
          "handoff: the adopted records differ from the exported ones")
    for i in range(half * SERVE_FRAME, len(rows), SERVE_FRAME):
        send(0, rows[i:i + SERVE_FRAME])
    engines[0].drain()
    wall = time.perf_counter() - t0
    out = {}
    if spans:
        torch.cuda.synchronize()
        out["tick_ms"] = statistics.median(a.elapsed_time(b)
                                           for a, b in spans)
        out["ticks_timed"] = len(spans)
    if same_inputs:
        out["same_inputs"] = same_inputs
        out["digest"] = engine_digest(engines[0])
    if checkpoint:
        engines[0].checkpoint(os.path.join(directory, "final"))
    else:
        out["engine"] = engines[0]
    return {**out, "history": engines[0].history_lines(),
            "history_g1": engines[1].history_lines(),
            "summary": serve_no_wall(engines[0].summary()),
            "flush": {k: v for k, v in fl.items()
                      if k not in ("checkpoint", "spool")},
            "adopt": ad, "exported": int(exported.size), "wall_s": wall,
            "swaps": swaps["swaps"], "swap_s": swaps["s"]}


def fleet_cpu_replay(trace: str, directory: str) -> dict:
    """The CPU side of the fleet, in a process of its own while the card
    works: the fleet's parts replayed (``fleet_replay``), checkpoints
    under ``directory``."""
    torch.set_num_threads(3)
    t0 = time.perf_counter()
    engines, swaps, _ = fleet_replay("cpu", serve_rows(trace), directory)
    return {"history": [e.history_lines() for e in engines],
            "summary": [serve_no_wall(e.summary()) for e in engines],
            "s": time.perf_counter() - t0,
            "swap_ms": [1e3 * s["s"] / max(1, s["swaps"]) for s in swaps]}


def fleet_cpu_handoff(trace: str, directory: str) -> dict:
    """The CPU side of the handoff (``fleet_handoff``, checkpointed under
    ``directory/final``) and the net sim's lines, in a process of its
    own."""
    from fedtpu_torch.resilience.net_sim import simulate
    torch.set_num_threads(3)
    t0 = time.perf_counter()
    out = fleet_handoff("cpu", serve_rows(trace), directory, checkpoint=True)
    out["net_sim"] = simulate(device="cpu")["lines"]
    out["s"] = time.perf_counter() - t0
    return out


def fleet_checkpoint(directory: str) -> tuple:
    """A checkpoint's state (CPU tensors) and meta (the store's arrays)."""
    from fedtpu_torch.orchestration.checkpoint import (load_checkpoint_raw,
                                                       load_meta)
    return load_checkpoint_raw(directory)[0], load_meta(directory)


def fleet_records(state: dict, meta: dict) -> tuple:
    """The store export in ``meta``: ids, headers (the 32 bytes: version,
    participation, key, strikes, flags) and each record's leaves
    (``state_template`` of ``state``)."""
    from fedtpu_torch.cohort.store import HEADER_BYTES, _pad8, state_template
    ids = np.asarray(meta["store_ids"], np.int64)
    recs = np.asarray(meta["store_records"], np.uint8)
    leaves, off = [], HEADER_BYTES
    for shape, dtype in state_template(state, SERVE_CFG["cohort"]):
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        leaves.append(np.ascontiguousarray(recs[:, off:off + n]).view(dtype))
        off += _pad8(n)
    return ids, recs[:, :HEADER_BYTES], leaves


def fleet_same_store(label: str, card: tuple, cpu: tuple) -> dict:
    """Card vs CPU checkpoints (``fleet_checkpoint``'s pairs): the global
    params within FLEET_TOL, the same touched ids, every header equal,
    every float leaf within FLEET_TOL and every integer leaf equal."""
    from fedtpu_torch.parallel.async_fed import async_global_params
    err = float((async_global_params(card[0])
                 - async_global_params(cpu[0])).abs().max())
    check(err <= FLEET_TOL, f"{label}: global params max abs err {err:.3e}")
    (ids, head, leaves), (ids_c, head_c, leaves_c) = (fleet_records(*card),
                                                      fleet_records(*cpu))
    check(np.array_equal(ids, ids_c) and np.array_equal(head, head_c),
          f"{label}: store ids or headers differ card vs CPU ({ids.size} "
          f"vs {ids_c.size} records)")
    worst = 0.0
    for a, b in zip(leaves, leaves_c):
        if a.dtype.kind == "f":
            worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
        else:
            check(np.array_equal(a, b), f"{label}: an integer leaf differs")
    check(worst <= FLEET_TOL, f"{label}: store values max abs err "
          f"{worst:.3e} > {FLEET_TOL}")
    return {"records": int(ids.size), "global_err": err, "store_err": worst,
            "quarantined": int((head[:, 28] & 1).sum())}


def fleet_wire(directory: str, trace: str, rows: list) -> dict:
    """Two ``run_gateway`` threads on the card (the memory store over
    1,000,000 users, ``once``, port file, history and checkpoint bases)
    fed by the port's ``GatewayClient(num_gateways=2)``: each frame
    partitioned by owner, frame FLEET_MISROUTED's gateway-1 part sent to
    gateway 0 (its redirect followed), then a drain of each member.
    Launches counted from zero around the run: K1 (sum mode) and K2 once a
    non-empty tick of each gateway and in each warm-up, K3 once a gateway
    (its shutdown summary)."""
    import threading
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.ops.cuda_kernels import LAUNCHES, reset_launch_counts
    from fedtpu_torch.serving.client import GatewayClient
    from fedtpu_torch.serving.gateway import run_gateway
    from fedtpu_torch.serving.loadgen import read_port_file
    from fedtpu_torch.serving.protocol import gateway_port_file
    pf = os.path.join(directory, "fleet.port")
    hist = os.path.join(directory, "fleet.history")
    box = {}

    def member(g: int) -> None:
        try:
            box[g] = run_gateway(
                ServingConfig(**SERVE_CFG), gateway_index=g,
                num_gateways=FLEET_N, port_file=pf, history_path=hist,
                checkpoint_dir=os.path.join(directory, "fleet-ck"),
                total_users=FLEET_USERS, once=True, verbose=False)
        except BaseException as e:  # reported below, on the main thread
            box[f"error {g}"] = e

    reset_launch_counts()
    threads = [threading.Thread(target=member, args=(g,))
               for g in range(FLEET_N)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    try:
        for g in range(FLEET_N):
            read_port_file(gateway_port_file(pf, g), timeout=300)
        up_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        counts = {}
        with GatewayClient(port_file=pf, num_gateways=FLEET_N, seed=0,
                           timeout=300) as client:
            client.hello(0)
            for k, i in enumerate(range(0, len(rows), SERVE_FRAME)):
                frame = rows[i:i + SERVE_FRAME]
                if k != FLEET_MISROUTED:
                    got = client.send_events(frame)
                else:
                    got = {}
                    for g in range(FLEET_N):
                        part = [r for r in frame if r[0] % FLEET_N == g]
                        resp = client.request(client.stamped(
                            {"op": "updates", "events": part}), gateway=0)
                        check(resp["op"] == "acks", f"fleet: {resp}")
                        for v, n in resp["counts"].items():
                            got[v] = got.get(v, 0) + n
                for v, n in got.items():
                    counts[v] = counts.get(v, 0) + n
            drains = client.request_each({"op": "drain"})
            stats = dict(client.stats)
        wall = time.perf_counter() - t0
    finally:
        for th in threads:
            th.join(timeout=600)
    errors = {k: v for k, v in box.items() if str(k).startswith("error")}
    check(not errors and not any(th.is_alive() for th in threads),
          f"fleet: a gateway thread failed: {errors!r}")
    launches = dict(LAUNCHES)
    lines = []
    for g in range(FLEET_N):
        with open(f"{hist}.g{g}") as fh:
            lines.append(fh.read().splitlines())
    ticks = [sum(json.loads(x)["tick_slots"] > 0 for x in h) for h in lines]
    want = {"weighted_average_clients": sum(ticks) + FLEET_N,
            "fused_eval_confusion": sum(ticks) + FLEET_N,
            "fused_mlp_forward": FLEET_N, "ring_all_reduce_sum": 0,
            "fused_round": 0}
    check(launches == want, f"fleet: launches {launches}, expected {want} "
          f"({ticks} non-empty ticks + a warm-up each, a summary each)")
    from fedtpu_torch.serving.admission import ADMITTED
    admitted = sum(n for v, n in counts.items() if v in ADMITTED)
    incorporated = sum(d["incorporated"] for d in drains.values())
    check(sum(counts.values()) == len(rows) and admitted == incorporated
          and stats["redirected"] >= 1,
          f"fleet: acks {counts}, incorporated {incorporated}, client "
          f"{stats}")
    return {"box": box, "lines": lines, "ticks": ticks,
            "launches": launches, "wall_s": wall, "up_s": up_s,
            "events_per_sec": len(rows) / wall, "admission": counts,
            "redirected": stats["redirected"], "incorporated": incorporated}


def fleet_serve_main_thread(run, feed) -> dict:
    """``run`` (a server that stops on SIGTERM) on this, the main, thread;
    ``feed`` on another, which sends SIGTERM to this process when it is
    done. Returns ``feed``'s result; ``run``'s ``Preempted`` is its
    normal end."""
    import signal
    import threading
    from fedtpu_torch.serving.server import Preempted
    box = {}

    def side():
        try:
            box["result"] = feed()
        except BaseException as e:  # reported below, on the main thread
            box["error"] = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    th = threading.Thread(target=side)
    th.start()
    try:
        run()
        fail("a server stopped by SIGTERM returned instead")
    except Preempted:
        pass
    th.join(timeout=600)
    check("error" not in box and not th.is_alive(),
          f"a server's feeder failed: {box.get('error')!r}")
    return box["result"]


def fleet_behind_proxy(directory: str, trace: str, tag: str) -> tuple:
    """One gateway behind the wire-fault proxy, ``net_fault_plan`` =
    fedtpu's net sim campaign (SIM_PLAN), answered by ``run_loadgen``
    through ``<port_file>.net``; stopped by SIGTERM once the loadgen's
    drain and stats are back. The gateway holds no store (the fleet and
    the handoff hold theirs): this step is the wire's. Returns the
    loadgen's summary and the decision log's bytes."""
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.resilience.net_sim import SIM_PLAN
    from fedtpu_torch.serving.gateway import run_gateway
    from fedtpu_torch.serving.loadgen import read_port_file, run_loadgen
    pf = os.path.join(directory, f"net-{tag}.port")

    def feed():
        read_port_file(pf, timeout=300)
        return run_loadgen(trace, port_file=pf, batch=SERVE_FRAME,
                           timeout=300, backoff_s=0.01)

    res = fleet_serve_main_thread(lambda: run_gateway(
        ServingConfig(**SERVE_CFG), num_gateways=1, port_file=pf,
        net_fault_plan=json.dumps(SIM_PLAN), verbose=False), feed)
    with open(f"{pf}.netlog") as fh:
        return res, fh.read()


def fleet_net(directory: str, trace: str) -> dict:
    """Wire faults: the gateway behind the proxy twice
    (``fleet_behind_proxy``): every update the loadgen was told was
    admitted is incorporated once, at least one duplicate is dropped, the
    decision logs are byte-identical."""
    from fedtpu_torch.serving.admission import ADMITTED
    runs = [fleet_behind_proxy(directory, trace, tag) for tag in "ab"]
    (res, log), (res_b, log_b) = runs
    stats = res["server_stats"]
    admitted = sum(n for v, n in res["admission"].items() if v in ADMITTED)
    summary = json.loads(log.splitlines()[-1])["summary"]
    check(admitted - stats["incorporated"] == 0
          and stats["duplicate_drops"] >= 1 and res["retried"] >= 1
          and res["events_sent"] == FLEET_TRACE["arrivals"],
          f"net: admitted {admitted}, incorporated {stats['incorporated']}, "
          f"duplicate drops {stats['duplicate_drops']}, loadgen {res}")
    check(log == log_b and res_b["admission"] == res["admission"],
          "net: the decision log or the acks differ between two runs")
    print(f"net faults (one gateway behind the proxy, fedtpu's SIM_PLAN, "
          f"{FLEET_TRACE['arrivals']} arrivals at full width): lost_acked 0, "
          f"duplicate drops {stats['duplicate_drops']}, retried "
          f"{res['retried']}, reconnects {res['reconnects']}, fired "
          f"{summary['fired']}, {summary['frames']} frames on "
          f"{summary['connections']} connections, decision log identical "
          f"across two runs ({len(log.splitlines())} lines), "
          f"{res['events_per_sec']:.1f} events/s; {CARD['smi']}", flush=True)
    return {"events_per_sec": res["events_per_sec"],
            "duplicate_drops": stats["duplicate_drops"],
            "fired": summary["fired"]}


def fleet_net_sim(cpu_sim: list) -> dict:
    """``net_sim.simulate`` on the card against the CPU's lines, and
    (printed, not gated: this machine's numpy draws another trace) against
    the committed golden."""
    from fedtpu_torch.resilience.net_sim import compare_decisions, simulate
    sim = simulate(device="cuda")
    check(sim["lines"] == cpu_sim, "net sim: lines differ card vs CPU")
    golden = compare_decisions(sim["lines"], os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
        "net_sim.jsonl"))
    s = sim["summary"]
    check(s["lost_acked"] == 0, f"net sim: {s}")
    print(f"net sim: {len(sim['lines'])} lines equal card vs CPU, lost_acked "
          f"{s['lost_acked']}, duplicate drops {s['duplicate_drops']}, fired "
          f"{s['fired']}; golden {golden['ok']} ({golden['reason']}); "
          f"{CARD['smi']}", flush=True)
    return {"lines": len(sim["lines"]), "golden": golden["ok"]}


def fleet_autoscale(directory: str, trace: str) -> dict:
    """``autoscale --simulate --json --out`` through the CLI (exit 0, its
    lines the in-process ``simulate``'s; the golden printed, not gated);
    then a ``LiveController`` (no supervisor pid) stepping against a card
    ``run_server`` while ``run_loadgen`` feeds it, a preemption notice
    written before its third tick: every poll reads the signals block,
    every ``configure`` and ``pre_drain`` it sends is acked."""
    import threading
    from fedtpu_torch.autoscale.controller import (LiveController,
                                                   compare_decisions,
                                                   simulate)
    from fedtpu_torch.config import AutoscaleConfig, ServingConfig
    from fedtpu_torch.serving.loadgen import read_port_file, run_loadgen
    from fedtpu_torch.serving.server import run_server
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(directory, "autoscale.jsonl")
    proc = subprocess.run([sys.executable, "-m", "fedtpu_torch.cli",
                           "autoscale", "--simulate", "--json", "--out", out],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"autoscale --simulate: exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    sim = simulate()
    with open(out) as fh:
        check(fh.read().splitlines() == sim["lines"],
              "autoscale: the CLI's decision lines differ from simulate()'s")
    golden = compare_decisions(sim["lines"], os.path.join(
        root, "tests", "goldens", "autoscale_sim.jsonl"))
    pf = os.path.join(directory, "auto.port")
    notice = os.path.join(directory, "notice.json")
    spool = os.path.join(directory, "auto-spool.jsonl")

    def feed():
        port = read_port_file(pf, timeout=300)
        load = threading.Thread(target=run_loadgen, args=(trace,),
                                kwargs=dict(port_file=pf, batch=SERVE_FRAME,
                                            timeout=300, drain=False))
        load.start()
        ctl = LiveController(AutoscaleConfig(), port=port,
                             notice_file=notice, spool_path=spool)
        acks, steps = [], []
        conn = ctl._connection()
        request = conn.request

        def recorded(obj, *a, **kw):
            resp = request(obj, *a, **kw)
            acks.append((obj["op"], resp))
            return resp

        conn.request = recorded
        try:
            while len(steps) < 3 or (load.is_alive() and len(steps) < 200):
                if len(steps) == 2:
                    with open(notice, "w") as fh:
                        json.dump({"victim": 0}, fh)
                snap, decisions = ctl.step()
                steps.append((snap.backlog, [d.kind for d in decisions]))
                time.sleep(0.02)
        finally:
            load.join(timeout=300)
            conn.close()
        return acks, steps, dict(ctl.acted)

    acks, steps, acted = fleet_serve_main_thread(lambda: run_server(
        ServingConfig(**SERVE_CFG), port_file=pf, verbose=False), feed)
    want = {"stats": "stats", "configure": "configured",
            "pre_drain": "pre_drained"}
    bad = [(op, r.get("op")) for op, r in acks
           if op in want and r.get("op") != want[op]]
    polls = [r for op, r in acks if op == "stats"]
    check(not bad and polls and all("backlog" in (r.get("signals") or {})
                                    for r in polls)
          and acted.get("pre_drain") == 1,
          f"autoscale live: unacked {bad}, {len(polls)} polls, acted "
          f"{acted}")
    sent = {op: sum(o == op for o, _ in acks) for op in want}
    print(f"autoscale: CLI --simulate exit 0, {cli['control_ticks']} "
          f"decision lines equal to simulate()'s, golden {golden['ok']} "
          f"({golden['reason']}); live controller on the card server: "
          f"{len(steps)} control ticks while loadgen fed "
          f"{FLEET_TRACE['arrivals']} arrivals, backlog polled "
          f"{[b for b, _ in steps][:8]}..., sent {sent}, every one acked, "
          f"acted {acted}; {CARD['smi']}", flush=True)
    return {"sim_golden": golden["ok"], "control_ticks": len(steps),
            "acted": acted, "sent": sent}


def fleet_cli(directory: str, box: dict) -> None:
    """The fleet as users run it: ``python -m fedtpu_torch.cli gateway
    --num-gateways 2 --gateway-index i --total-users 1000000 --once``, two
    subprocesses on the card, gateway 1 with FEDTPU_GATEWAY_KILL_AFTER
    (FLEET_KILL); ``loadgen --num-gateways 2 --synthesize`` (FLEET_TRACE's
    size) against them. When gateway 1 kills itself, it is relaunched with
    ``--resume`` and FEDTPU_RESTARTS=1, as a gang supervisor would
    (``supervise --num-processes``). Runs on a thread of
    its own; its results land in ``box``."""
    from fedtpu_torch.serving.loadgen import read_port_file
    from fedtpu_torch.serving.protocol import gateway_port_file
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "fedtpu_torch.cli"]
    pf = os.path.join(directory, "cli-fleet.port")
    hist = os.path.join(directory, "cli-fleet.history")

    def gateway(g: int, resume: bool = False, **env):
        argv = cmd + ["gateway", "--num-gateways", str(FLEET_N),
                      "--gateway-index", str(g), "--total-users",
                      str(FLEET_USERS), "--port-file", pf, "--history", hist,
                      "--checkpoint-dir", os.path.join(directory, "cli-ck"),
                      "--cohort", "32", "--buffer-size", "16", "--once",
                      "--quiet", "--json"] + (["--resume"] if resume else [])
        return subprocess.Popen(argv, cwd=root, env={**os.environ, **env},
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    t0 = time.perf_counter()
    procs = [gateway(0), gateway(1, FEDTPU_GATEWAY_KILL_AFTER=FLEET_KILL)]
    load = None
    try:
        for g in range(FLEET_N):
            read_port_file(gateway_port_file(pf, g), timeout=300)
        load = subprocess.Popen(
            cmd + ["loadgen", os.path.join(directory, "cli-fleet.jsonl"),
                   "--synthesize", "--users", str(FLEET_TRACE["users"]),
                   "--arrivals", str(FLEET_TRACE["arrivals"]), "--horizon",
                   str(FLEET_TRACE["horizon_s"]), "--port-file", pf,
                   "--num-gateways", str(FLEET_N), "--batch",
                   str(SERVE_FRAME), "--retries", "30", "--json", "--quiet"],
            cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        first_life = None
        while load.poll() is None:
            if first_life is None and procs[1].poll() is not None:
                first_life = procs[1]
                box["killed_rc"] = first_life.returncode
                box["killed_at_s"] = time.perf_counter() - t0
                procs[1] = gateway(1, resume=True, FEDTPU_RESTARTS="1")
            time.sleep(0.05)
        out, err = load.communicate(timeout=60)
        box["load"] = (load.returncode, out, err)
        box["gateways"] = [p.communicate(timeout=300) + (p.returncode,)
                           for p in procs]
        box["first_life"] = (first_life.communicate(timeout=60)
                             if first_life is not None else None)
    except BaseException as e:  # reported on the main thread
        box["error"] = e
    finally:
        for p in procs + ([load] if load is not None else []):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        box["s"] = time.perf_counter() - t0
        box["hist"] = hist


def fleet_cli_check(box: dict) -> dict:
    """``fleet_cli``'s checks: gateway 1 died by its own SIGKILL and was
    relaunched, the loadgen exited 0, every update it was told was
    admitted is incorporated once across the fleet, the relaunched
    gateway absorbed at least one duplicate (the retry of the frame whose
    ack was lost), both gateways exited 0 and wrote their histories."""
    from fedtpu_torch.serving.admission import ADMITTED
    check("error" not in box, f"CLI fleet: {box.get('error')!r}")
    rc, out, err = box["load"]
    check(box.get("killed_rc") == -9 and rc == 0
          and all(p[2] == 0 for p in box["gateways"]),
          f"CLI fleet: gateway 1 first life exit {box.get('killed_rc')}, "
          f"loadgen exit {rc}: {err[-2000:]}; gateways "
          f"{[(p[2], p[1][-800:]) for p in box['gateways']]}")
    res = json.loads(out.strip().splitlines()[-1])
    stats = res["server_stats"]
    admitted = sum(n for v, n in res["admission"].items() if v in ADMITTED)
    incorporated = sum(s["incorporated"] for s in stats.values())
    check(admitted == incorporated and stats["1"]["duplicate_drops"] >= 1
          and res["events_sent"] == FLEET_TRACE["arrivals"],
          f"CLI fleet: admitted {admitted}, incorporated {incorporated}, "
          f"stats {stats}")
    for g in range(FLEET_N):
        check(os.path.getsize(f"{box['hist']}.g{g}") > 0,
              f"CLI fleet: gateway {g} wrote no history")
    print(f"CLI fleet (gateway --num-gateways 2 --total-users 1000000 x 2 "
          f"subprocesses, loadgen --num-gateways 2 --synthesize "
          f"{FLEET_TRACE['arrivals']} arrivals, {box['s']:.1f} s): gateway "
          f"1 killed itself after acking frame 5 (exit -9 at "
          f"{box['killed_at_s']:.1f} s), relaunched with --resume; loadgen "
          f"exit 0, {res['events_per_sec']:.1f} events/s, retried "
          f"{res['retried']}, redirected {res['redirected']}; admitted "
          f"{admitted} = incorporated {incorporated} (lost_acked 0), "
          f"duplicate drops {stats['1']['duplicate_drops']}; {CARD['smi']}",
          flush=True)
    return {"events_per_sec": res["events_per_sec"], "lost_acked": 0,
            "duplicate_drops": stats["1"]["duplicate_drops"], "s": box["s"]}


def k1_sum_row(dev: torch.device, d: int, label: str,
               rows: int = 8, binary: bool = False) -> dict:
    """K1's sum mode at (``rows``, ``d``) (cohort 8: the net sim's and the
    fuzz gang's 6 -> 8 -> 2 at 74, the gateway rows' 6 -> 16 -> 8 -> 2 at
    266; a training-gang member's 4 or 2 clients at income-8's 11,352, or
    16 at income-32-noniid's) against its plain version, timed beside it,
    ``torch.matmul`` and its bound. ``binary``: 0/1 weights (a DP member's
    uniform weights under its round's mask)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn(rows, d, generator=gen) * 1e-2).to(dev)
    w = (torch.rand(rows, generator=gen) < 0.5).to(torch.float32)
    if not binary:
        w = w * (1.0 + torch.randint(0, 6, (rows,), generator=gen)) ** -0.5
    w = w.to(dev)
    out = ck.weighted_sum_clients(x, w)
    ref = ck.weighted_sum_clients_reference(x, w)
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f"K1 sum at ({rows}, {d}): max abs err {err}")
    b, by = bound_ms(4 * (rows * d + rows + d), 2.0 * rows * d)
    row = {"shape": f"({rows}, {d})", "max_abs_err": err,
           "ms": time_ms(lambda: ck.weighted_sum_clients(x, w)),
           "plain_ms": time_ms(lambda: ck.weighted_sum_clients_reference(
               x, w)),
           "library_ms": time_ms(lambda: torch.matmul(w, x)),
           "bound_ms": b, "bound_by": by}
    print(f"time K1 sum at {label} ({rows}, {d}): kernel {row['ms']:.4f} "
          f"ms  plain {row['plain_ms']:.4f} ms  torch.matmul "
          f"{row['library_ms']:.4f} ms  bound {b:.6f} ms ({by}); max abs err "
          f"{err:.3e}; {CARD['smi']}", flush=True)
    return row


def phase_fleet() -> tuple:
    """Phase (q): the store-backed gateway fleet and the rest of the
    serving stack (see the constants above). In order: the wire fleet
    (``fleet_wire``) alone on the machine; then the CLI fleet and its
    lost-ack drill in the background (``fleet_cli``) and the CPU side
    in two processes of its own (``fleet_cpu_replay``,
    ``fleet_cpu_handoff``), while the card runs the
    fleet's parts in process uncaptured (bitwise the wire fleet's
    checkpoints: state and every store byte; and its histories), the
    handoff (``fleet_handoff``), K1's sum mode at the net sim's shape,
    autoscale (``fleet_autoscale``) and the wire faults (``fleet_net``);
    then card vs CPU (``fleet_same_store``: histories and summaries equal)
    for the fleet, the handoff and the net sim; then the CLI fleet's
    checks. Returns the launches by path, K1's sum-mode row at the net
    sim's shape and the phase's numbers."""
    import multiprocessing
    import tempfile
    import threading
    from concurrent.futures import ProcessPoolExecutor
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    seconds, numbers = {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    with tempfile.TemporaryDirectory() as directory:
        trace = os.path.join(directory, "fleet.jsonl")
        write_trace(trace, *synthesize_trace(**FLEET_TRACE))
        rows = serve_rows(trace)
        touched = [len({r[0] for r in rows if r[0] % FLEET_N == g})
                   for g in range(FLEET_N)]
        print(f"fleet trace ({FLEET_TRACE}): {len({r[0] for r in rows})} "
              f"users touched, {touched} per shard", flush=True)
        lap("trace")
        wire = fleet_wire(directory, trace, rows)
        lap("wire fleet")
        cli_box = {}
        cli = threading.Thread(target=fleet_cli, args=(directory, cli_box))
        cli.start()
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
            cpu_replay = pool.submit(fleet_cpu_replay, trace,
                                     os.path.join(directory, "cpu-replay"))
            cpu_handoff = pool.submit(fleet_cpu_handoff, trace,
                                      os.path.join(directory, "cpu-handoff"))
            plain, plain_swaps, _ = fleet_replay("cuda", rows, capture=False)
            cards = []
            for g, eng in enumerate(plain):
                card = fleet_checkpoint(os.path.join(directory, "fleet-ck",
                                                     f"g{g}"))
                cards.append(card)
                mine = eng.store.checkpoint_arrays()
                mine.pop("store_generation")   # the wire run's is its own
                check(eng.history_lines() == wire["lines"][g]
                      and all(torch.equal(bits(a.cpu()), bits(b)) for a, b in
                              zip(async_state_tensors(eng.state),
                                  async_state_tensors(card[0])))
                      and all(np.array_equal(np.asarray(card[1][k]), v)
                              for k, v in mine.items()),
                      f"fleet gateway {g}: captured (the wire run) differs "
                      "from uncaptured, in history, state or store bytes")
            evictions = [e.binder.evictions for e in plain]
            record_bytes = int(cards[0][1]["store_record_bytes"])
            del plain, mine
            lap("uncaptured")
            handoff = fleet_handoff("cuda", rows,
                                    os.path.join(directory, "handoff"))
            lap("handoff")
            k1_row = k1_sum_row(torch.device("cuda"), 74, "the net sim's")
            numbers["autoscale"] = fleet_autoscale(directory, trace)
            lap("autoscale")
            numbers["net"] = fleet_net(directory, trace)
            lap("net faults")
            cpu = cpu_replay.result(timeout=900)
            c_h = cpu_handoff.result(timeout=900)
            lap("waiting for the CPU")
        numbers["net_sim"] = fleet_net_sim(c_h["net_sim"])
        same = []
        for g in range(FLEET_N):
            check(wire["lines"][g] == cpu["history"][g],
                  f"fleet gateway {g}: history differs card vs CPU")
            check(serve_no_wall(wire["box"][g]) == cpu["summary"][g],
                  f"fleet gateway {g}: summary differs card vs CPU")
            same.append(fleet_same_store(
                f"fleet gateway {g} card vs CPU", cards[g], fleet_checkpoint(
                    os.path.join(directory, "cpu-replay", f"g{g}"))))
        del cards
        check(handoff["history"] == c_h["history"]
              and handoff["history_g1"] == c_h["history_g1"]
              and handoff["summary"] == c_h["summary"]
              and handoff["flush"] == c_h["flush"]
              and handoff["adopt"] == c_h["adopt"],
              "handoff: differs card vs CPU (history, summary, flush or "
              "adopt acks)")
        survivor = handoff.pop("engine")
        handoff_same = fleet_same_store(
            "handoff card vs CPU",
            ({k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in survivor.state.items()},
             survivor.store.checkpoint_arrays()),
            fleet_checkpoint(os.path.join(directory, "cpu-handoff",
                                          "final")))
        del survivor
        lap("net sim, card vs CPU")
        cli.join(timeout=600)
        check(not cli.is_alive(), "CLI fleet: still running")
        numbers["cli"] = fleet_cli_check(cli_box)
        lap("CLI fleet (its wait)")
    rb = [s["records"] for s in same]
    ticks_s = [wire["box"][g]["rounds_per_sec"] for g in range(FLEET_N)]
    swap_ms = [1e3 * s["s"] / max(1, s["swaps"]) for s in plain_swaps]
    handoff_ms = 1e3 * handoff["swap_s"] / max(1, handoff["swaps"])
    print(f"fleet over the wire (2 gateways x income MLP 14->50->200->2, 32 "
          f"slots, K-buffer 16, memory store over {FLEET_USERS} users, "
          f"{FLEET_TRACE['arrivals']} arrivals in frames of {SERVE_FRAME}): "
          f"{wire['events_per_sec']:.1f} events/s (client, "
          f"{wire['wall_s']:.3f} s; the members up in {wire['up_s']:.1f} s), "
          f"ticks/s {[round(t, 3) for t in ticks_s]} ({wire['ticks']} "
          f"non-empty), evictions {evictions}, store swaps "
          f"{[s['swaps'] for s in plain_swaps]} at "
          f"{[round(m, 4) for m in swap_ms]} host ms each (the uncaptured "
          f"replay; the captured handoff's gateway 0: {handoff_ms:.4f} ms), "
          f"touched rows {rb} of {record_bytes} bytes, resident "
          f"{[r * record_bytes for r in rb]} bytes, redirects "
          f"{wire['redirected']}, launches {wire['launches']}; captured == "
          f"uncaptured bitwise (state, history, every store byte); card vs "
          f"CPU: histories and summaries equal, global params max abs err "
          f"{[s['global_err'] for s in same]}, store headers equal, values "
          f"max abs err {[s['store_err'] for s in same]}; CPU replay "
          f"{cpu['s']:.1f} s (swaps "
          f"{[round(m, 4) for m in cpu['swap_ms']]} ms); {CARD['smi']}",
          flush=True)
    print(f"handoff (gateway 1 flushed at frame "
          f"{len(rows) // SERVE_FRAME // 2}, adopted by gateway 0): flushed "
          f"{handoff['flush']}, a stale generation refused, adopted "
          f"{handoff['adopt']['rows']} records, bitwise the exported "
          f"{handoff['exported']}, replayed {handoff['adopt']['replayed']} "
          f"spooled updates; card vs CPU equal (histories, summaries, acks; "
          f"params {handoff_same['global_err']:.3e}, store "
          f"{handoff_same['store_err']:.3e}, {handoff_same['records']} "
          f"records); each tick from the same inputs card vs CPU: "
          f"{[s['ticks'] for s in handoff['same_inputs']]} ticks, max abs "
          f"err {[s['max_abs_err'] for s in handoff['same_inputs']]}; the "
          f"survivor's state and store digest {handoff['digest']}; "
          f"{handoff['wall_s']:.2f} s; gateway 0's tick "
          f"{handoff.get('tick_ms', float('nan')):.4f} ms of device span "
          f"(median of {handoff.get('ticks_timed')}, CUDA events around "
          f"the mask's copy and the replay); {CARD['smi']}", flush=True)
    print(f"phase (q) seconds {json.dumps(seconds)}", flush=True)
    numbers.update(seconds=seconds, events_per_sec=wire["events_per_sec"],
                   ticks_per_s=ticks_s, swap_ms=swap_ms,
                   swap_ms_captured=handoff_ms, evictions=evictions,
                   tick_ms=handoff.get("tick_ms"),
                   touched_rows=rb, record_bytes=record_bytes,
                   handoff_store_err=handoff_same["store_err"],
                   handoff_tick_err=[s["max_abs_err"]
                                     for s in handoff["same_inputs"]],
                   handoff_digest=handoff["digest"])
    return ({"gateway fleet (2 x income MLP)": wire["launches"]}, k1_row,
            numbers)


# ------------------------------------------------ (r) the cohort engine
# income-8's model at full width (14 -> 50 -> 200 -> 2) over a population of
# 100,000 clients on 1,000,000 synthetic rows (about 8 train rows a client),
# cohorts of 256, 10 a chunk; then 1,000,000 clients on an mmap store.
COHORT_CLIENTS = 100_000
COHORT_MILLION = 1_000_000
COHORT_ROWS = 1_000_000
COHORT_K = 256
COHORT_S = 10
COHORT_ROUNDS = 20
COHORT_MMAP_STOP = 10     # the mmap run's checkpoint, its resume's start
COHORT_TOL = 1e-4
COHORT_SHORT = 5          # rounds (one chunk) of the ring, median and trace
COHORT_METRICS = ("accuracy", "precision", "recall", "f1")
COHORT_EXPECT = {"weighted_average_clients": "cohorts",
                 "fused_eval_confusion": "cohorts",
                 "fused_mlp_forward": "evals", "ring_all_reduce_sum": 0}


def cohort_config(clients: int = COHORT_CLIENTS, rounds: int = COHORT_ROUNDS,
                  run=None, **fed):
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-8")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=COHORT_ROWS),
        shard=dataclasses.replace(cfg.shard, num_clients=clients),
        fed=dataclasses.replace(cfg.fed, rounds=rounds,
                                cohort_size=COHORT_K,
                                **{"termination_patience": 1000, **fed}),
        run=dataclasses.replace(cfg.run, **{
            "rounds_per_step": COHORT_S, "eval_test_every": 10,
            **(run or {})}))


def cohort_run(label: str, cfg, ds, expect=None, device: str = "cuda",
               capture=None, resume: bool = False) -> tuple:
    """One cohort run of ``run_experiment`` on ``ds``, every launch count
    set to 0 just before it and read just after. ``expect`` maps a kernel
    to "cohorts" (one a cohort trained, the graph's warm-up cohort and one
    a cohort in each replay), "evals" (at least one a held-out eval) or an
    exact number. Prints s/round (chunks 2..), each chunk's host and
    device times, the store's bytes and the peak device memory. Returns
    (result, launches, peak device bytes)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    on_card = device == "cuda"
    base = 0
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(cfg, dataset=ds, verbose=False, device=device,
                         capture=capture, resume=resume)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    # The run's own peak: above what was allocated when it began.
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    check(not res.diverged, f"{label} diverged")
    for hist in (res.global_metrics, res.pooled_metrics, res.test_metrics):
        for k, v in hist.items():
            check(bool(np.all(np.isfinite(v))), f"{label}: non-finite {k}")
    check(all(np.all(np.isfinite(l)) for l in res.loss),
          f"{label}: non-finite loss")
    n_evals = len(res.test_metrics["accuracy"])
    for name, want in (expect or {}).items():
        got = launches[name]
        if want == "cohorts":
            check(got == res.rounds_trained + res.warmup_rounds,
                  f"{label}: {name} launches {got} != cohorts trained "
                  f"{res.rounds_trained} + warm-up {res.warmup_rounds}")
            for width, per in res.graph_launches.items():
                check(per[name] == width, f"{label}: {name} {per[name]} "
                      f"launches a replay of the {width}-cohort graph")
        elif want == "evals":
            check(got >= max(n_evals, 1), f"{label}: {name} launches {got} "
                  f"fewer than the held-out evals ({n_evals}) or none")
        else:
            check(got == want, f"{label}: {name} launches {got} != {want}")
    check(capture is False or not on_card or bool(res.graph_launches),
          f"{label}: no graph captured on the card")
    store = res.cohort["store"]
    stats = res.cohort["chunk_stats"]
    width = cfg.run.rounds_per_step
    steady = res.sec_per_round[width:] or res.sec_per_round
    print(f"{label}: rounds run {res.rounds_run}, trained "
          f"{res.rounds_trained}, s/round {statistics.mean(steady):.6e} "
          f"(mean of chunks 2..), wall {wall:.3f} s, launches {launches}, "
          f"test evals {n_evals}, final client-mean accuracy "
          f"{res.global_metrics['accuracy'][-1]:.4f}; store: "
          f"{len(store._touched)} touched records of "
          f"{store.record_bytes} bytes, resident "
          f"{store.resident_estimate_bytes()} bytes, apparent "
          f"{store.apparent_nbytes} bytes, file blocks "
          f"{store.file_block_bytes()} bytes; peak device memory {peak} "
          f"bytes above the {base} allocated before it; {CARD['smi']}",
          flush=True)
    for i, st in enumerate(stats):
        print(f"  chunk {i + 1}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()), flush=True)
    return res, launches, peak


def store_digest(res) -> tuple:
    arrays = res.cohort["store"].checkpoint_arrays()
    return arrays["store_ids"], arrays["store_digest"]


def same_cohort_runs(label: str, a, b, metrics_only: bool = False,
                     skip: int = 0, skip_evals: int = 0) -> None:
    """Bitwise: the sampled ids, every history, loss and confusion count,
    the final params and (unless ``metrics_only``) every touched store
    record (ids, header and leaf bytes, through the store's digest).
    ``a`` resumed at round ``skip`` holds ``b``'s client-mean history
    whole and the rest from there (``skip_evals`` held-out rows fewer)."""
    check(a.rounds_run == b.rounds_run, f"{label}: rounds {a.rounds_run} "
          f"vs {b.rounds_run}")
    check(not b.cohort or all(np.array_equal(x, y) for x, y in zip(
        a.cohort["ids"], b.cohort["ids"][skip:], strict=True)),
          f"{label}: sampled ids differ")
    check(a.global_metrics == b.global_metrics,
          f"{label}: client-mean histories differ")
    check(a.pooled_metrics == {k: v[skip:] for k, v in
                               b.pooled_metrics.items()}
          and a.test_metrics == {k: v[skip_evals:] for k, v in
                                 b.test_metrics.items()},
          f"{label}: pooled or held-out histories differ")
    check(all(np.array_equal(x, y) for x, y in zip(
        a.loss + a.confusion, b.loss[skip:] + b.confusion[skip:],
        strict=True)), f"{label}: losses or confusion counts differ")
    check(all(np.array_equal(x, y) for x, y in
              zip(param_leaves(a.final_params),
                  param_leaves(b.final_params))),
          f"{label}: final params differ")
    if not metrics_only:
        (ia, da), (ib, db) = store_digest(a), store_digest(b)
        check(np.array_equal(ia, ib) and np.array_equal(da, db),
              f"{label}: store records differ ({len(ia)} vs {len(ib)} "
              "touched)")
    print(f"{label}: bitwise equal (ids, histories, losses, counts, final "
          f"params{'' if metrics_only else ', every touched store record'})",
          flush=True)


def replay_cohort_ties(cfg, ds, rounds: set) -> dict:
    """``replay_near_ties`` for the cohort engine: the run replayed chunk
    by chunk on the CPU and, in lockstep, on the card (uncaptured, bitwise
    the captured run), without prefetch; at each given 0-based round its
    cohort's trained (pre-average) models are rebuilt from the chunk's
    stored optimizer records and the carry (the chunk's start state, or
    the previous cohort's written params) and their logits compared:
    round -> ``near_ties``' triple."""
    from fedtpu_torch.cohort.scheduler import build_cohort_scheduler
    from fedtpu_torch.training.client import make_local_train_step
    sides = [build_cohort_scheduler(cfg, ds, torch.device(d),
                                    prefetch=False) for d in ("cpu", "cuda")]
    s_w = sides[0].s
    train = make_local_train_step(sides[0].model, sides[0].tx,
                                  cfg.fed.local_steps, cfg.fed.prox_mu)
    out = {}
    try:
        for c in range(max(rounds) // s_w + 1):
            want = sorted(r % s_w for r in rounds if r // s_w == c)
            ids = sides[0].sampler.sample(c * s_w, s_w)
            before = []
            for side in sides:
                for s in range(s_w):
                    side.ensure_init(ids[s])
                state = side.state_for_checkpoint()
                before.append((None if state is None
                               else state["params"].clone(),
                               [side.store.read(ids[s]) for s in want]))
            for side in sides:
                side.run_chunk(prefetch_next=False)
            for s, slot in zip(want, range(len(want))):
                logits = []
                for side, (carry, recs) in zip(sides, before):
                    dev = side.device
                    rec = [torch.from_numpy(np.array(a)).to(dev)
                           for a in recs[slot]]
                    if s > 0:
                        carry = torch.from_numpy(
                            side.store.read(ids[s - 1])[-1]).to(dev)
                    elif carry is None:
                        carry = rec[-1]
                    data = side.data_fn(ids[s])
                    x, y, mask = (torch.from_numpy(data[k]).to(dev)
                                  for k in ("x", "y", "mask"))
                    opt = dict(zip(sorted(side.tx.init(carry)), rec[:-1]))
                    trained, _, _ = train(carry, opt, x, y, mask)
                    logits.append(side.model.apply(trained, x).cpu())
                mask = torch.from_numpy(side.data_fn(ids[s])["mask"]) > 0
                out[c * s_w + s] = near_ties(logits, mask)
    finally:
        for side in sides:
            side.close()
    return out


def cohort_pairs(label: str, cfg, ds) -> dict:
    """``cfg`` on the CPU, chunk by chunk without prefetch (the reference
    run), and each of its cohorts stepped again on the card and on the CPU
    from the same inputs (the carry it trained from, its members' stored
    optimizer records and rows): the one-cohort step on the card
    (uncaptured, bitwise the captured one) against its plain version,
    its post-round slot params and optimizer state within ``COHORT_TOL``
    (counts equal), losses within 1e-4 and confusion counts equal but on
    near-tie rows of the CPU models; the CPU's step equals the reference
    run's records bit for bit. Returns the reference run: each round's
    ids, losses and confusion counts, its final global and its store."""
    from fedtpu_torch.cohort.scheduler import (build_cohort_round_fn,
                                               build_cohort_scheduler)
    from fedtpu_torch.parallel.mesh import make_mesh
    from fedtpu_torch.training.client import make_local_train_step
    ref = build_cohort_scheduler(cfg, ds, torch.device("cpu"),
                                 prefetch=False)
    k = ref.k
    row_shape = ref.data_fn(np.zeros(1, np.int64))["x"].shape[1:]
    devs = (torch.device("cpu"), torch.device("cuda"))
    steps = [build_cohort_round_fn(
        ref.model, ref.tx, ds.num_classes, k, row_shape,
        mesh=make_mesh(cfg.run.mesh_devices, k, dev),
        aggregation=cfg.fed.aggregation, local_steps=cfg.fed.local_steps,
        prox_mu=cfg.fed.prox_mu, robust=cfg.fed.robust_aggregation,
        trim_ratio=cfg.fed.trim_ratio, device=dev) for dev in devs]
    train = make_local_train_step(ref.model, ref.tx, cfg.fed.local_steps,
                                  cfg.fed.prox_mu)
    out = {"ids": [], "loss": [], "confusion": []}
    worst = {"params": 0.0, "opt": 0.0, "loss": 0.0}
    moved = 0
    try:
        while ref.round < cfg.fed.rounds:
            ids = ref.sampler.sample(ref.round, ref.s)
            for s in range(ref.s):
                ref.ensure_init(ids[s])
            state = ref.state_for_checkpoint()
            carry0 = None if state is None else state["params"].clone()
            before = [ref.store.read(ids[s]) for s in range(ref.s)]
            chunk = ref.run_chunk(prefetch_next=False)
            take = min(ref.s, cfg.fed.rounds - (ref.round - ref.s))
            for key, src in (("ids", chunk["ids"]),
                             ("loss", chunk["metrics"]["loss"]),
                             ("confusion", chunk["conf"])):
                out[key] += [np.asarray(src[j]) for j in range(take)]
            for s in range(ref.s):
                recs = before[s]
                carry = (carry0 if s == 0 and carry0 is not None else
                         torch.from_numpy(recs[-1]) if s == 0 else
                         torch.from_numpy(ref.store.read(ids[s - 1])[-1]))
                data = ref.data_fn(ids[s])
                weights = (data["mask"].sum(axis=1, dtype=np.float32)
                           if cfg.fed.weighting == "data_size"
                           else np.ones(k, np.float32))
                host = ([torch.from_numpy(np.array(a))[None]
                         for a in recs[:-1]]
                        + [torch.from_numpy(data[key])[None]
                           for key in ("x", "y", "mask")]
                        + [torch.from_numpy(weights)[None]])
                raws = []
                for dev, step in zip(devs, steps):
                    _, raw = step.fn({"params": carry.to(dev), "round": 0},
                                     None, *(t.to(dev) for t in host))
                    raws.append(raw)
                cpu_raw, card_raw = raws
                after = ref.store.read(ids[s])
                check(all(np.array_equal(_numpy_leaf(cpu_raw, key), a)
                          for key, a in zip(
                              [("opt", n) for n in sorted(cpu_raw["opt"])]
                              + [("params",)], after)),
                      f"{label}: the CPU's one-cohort step is not the "
                      "reference run's records")
                worst["params"] = max(worst["params"], float(
                    (card_raw["params"].cpu() - cpu_raw["params"]).abs()
                    .max()))
                for name, t in cpu_raw["opt"].items():
                    c = card_raw["opt"][name].cpu()
                    if t.is_floating_point():
                        worst["opt"] = max(worst["opt"],
                                           float((c - t).abs().max()))
                    else:
                        check(torch.equal(c, t),
                              f"{label}: optimizer {name} differs")
                worst["loss"] = max(worst["loss"], float(
                    (card_raw["loss"].cpu() - cpu_raw["loss"]).abs().max()))
                conf_moved = ((card_raw["conf"].cpu() - cpu_raw["conf"])
                              .abs().sum(dim=(-2, -1)) / 2)[0]
                if conf_moved.any():
                    logits = []
                    for dev in devs:
                        opt = {n: v[0].to(dev) for n, v in zip(
                            sorted(cpu_raw["opt"]), host[:len(recs) - 1])}
                        trained, _, _ = train(
                            carry.to(dev), opt, host[-4][0].to(dev),
                            host[-3][0].to(dev), host[-2][0].to(dev))
                        logits.append(ref.model.apply(
                            trained, host[-4][0].to(dev)).cpu())
                    near = near_ties(logits, host[-2][0] > 0)[0]
                    check(bool((conf_moved.numpy() <= near).all()),
                          f"{label}: confusion counts differ on "
                          f"{int(conf_moved.sum())} rows, near ties "
                          f"{int(near.sum())}")
                    moved += int(conf_moved.sum())
            check(max(worst.values()) <= COHORT_TOL,
                  f"{label}: one-cohort steps card vs CPU from the same "
                  f"inputs differ by {worst} > {COHORT_TOL}")
        out["final"] = ref.state_for_checkpoint()["params"][0]
        out["store"] = ref.store
    finally:
        ref.close()
    print(f"{label}: each of {len(out['ids'])} cohorts stepped on the card "
          f"and on the CPU from the same inputs: slot params within "
          f"{worst['params']:.3e}, Adam state within {worst['opt']:.3e}, "
          f"losses within {worst['loss']:.3e}, {moved} near-tie rows "
          f"counted apart; the CPU's step is the reference run's, bit for "
          f"bit", flush=True)
    return out


def _numpy_leaf(raw: dict, key: tuple) -> np.ndarray:
    """A one-cohort step's output leaf (``("params",)`` or ``("opt",
    name)``) as the store's numpy record leaf."""
    t = raw[key[0]] if len(key) == 1 else raw[key[0]][key[1]]
    return t[0].cpu().numpy()


def cohort_vs_cpu(label: str, cfg, ds, gpu) -> None:
    """The card run ``gpu`` against the CPU: ``cohort_pairs`` (each cohort
    within ``COHORT_TOL`` from the same inputs), then the whole runs: the
    same sampled ids and rounds, losses within 1e-4, confusion counts
    equal but on near-tie rows of the CPU models (``replay_cohort_ties``),
    the same touched records with equal headers. The whole runs' final
    params and record values are printed, not held: a member's first Adam
    step is ``lr * g / (|g| + eps)``, so a gradient that is exactly 0 on
    one side and a rounding residue on the other moves that member by up
    to ``lr``, and the two runs' carries part by ~1e-5 a chunk and go on
    apart (``PERF.md`` §6)."""
    from fedtpu_torch.convert import params_from_jax
    cpu = cohort_pairs(label, cfg, ds)
    check(len(cpu["ids"]) == gpu.rounds_run and all(
        np.array_equal(a, b) for a, b in zip(gpu.cohort["ids"], cpu["ids"])),
          f"{label}: card and CPU sampled other ids or ran other rounds")
    loss_err = max(float(np.abs(a - b).max())
                   for a, b in zip(gpu.loss, cpu["loss"]))
    check(loss_err <= 1e-4, f"{label}: loss max abs err {loss_err}")
    moved = {r: np.abs(a - b).sum(axis=(1, 2)) / 2
             for r, (a, b) in enumerate(zip(gpu.confusion,
                                            cpu["confusion"]))
             if not np.array_equal(a, b)}
    ties = replay_cohort_ties(cfg, ds, set(moved)) if moved else {}
    for r, rows in moved.items():
        near, _, drift = ties[r]
        check(bool(np.all(rows <= near)),
              f"{label} round {r + 1}: confusion counts differ on "
              f"{rows.tolist()} rows per client, near-tie rows "
              f"{near.tolist()} (logit drift {drift:.3e})")
    p_err = float((params_from_jax(gpu.final_params)
                   - cpu["final"]).abs().max())
    gs, cs = gpu.cohort["store"], cpu["store"]
    ids = np.array(sorted(gs._touched), np.int64)
    check(np.array_equal(ids, np.array(sorted(cs._touched), np.int64)),
          f"{label}: card and CPU stores touched other records")
    s_err = 0.0
    for part in np.array_split(ids, max(1, len(ids) // 1024)):
        for probe in ("versions", "participation", "read_keys"):
            check(np.array_equal(getattr(gs, probe)(part),
                                 getattr(cs, probe)(part)),
                  f"{label}: store {probe} differ")
        for a, b in zip(gs.read(part), cs.read(part)):
            s_err = max(s_err, float(np.abs(a.astype(np.float64) - b).max()))
    print(f"{label} card vs CPU, whole runs: same ids and rounds "
          f"{gpu.rounds_run}, loss max abs err {loss_err:.3e}, rounds with "
          f"near-tie count differences {sorted(r + 1 for r in moved)} "
          f"(rows moved {[int(v.sum()) for v in moved.values()]}), "
          f"{len(ids)} touched records with equal headers; final params "
          f"apart by {p_err:.3e}, record values by {s_err:.3e}; "
          f"{CARD['smi']}", flush=True)


def cohort_profile(cfg, ds, chunk_ms: float) -> dict:
    """Where a captured chunk's time goes: two chunks of ``cfg`` through
    the scheduler (the first warms up and captures), the second under
    torch.profiler: its device busy time and device ops, and the device's
    idle share against ``chunk_ms`` (a steady captured chunk's host time
    in the main run, untraced) and against the traced chunk's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fedtpu_torch.cohort.scheduler import build_cohort_scheduler
    sched = build_cohort_scheduler(cfg, ds, torch.device("cuda"),
                                   capture=True)
    try:
        sched.run_chunk()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched.run_chunk(prefetch_next=False)
            traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sched.close()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ops = sum(e.count for e in dev)
    out = {"chunk_host_ms": chunk_ms, "device_busy_ms": busy_ms,
           "device_ops": ops, "idle_share": 1 - busy_ms / chunk_ms,
           "traced_host_ms": traced_ms,
           "traced_idle_share": 1 - busy_ms / traced_ms,
           "chunk_stats": sched.chunk_stats[1]}
    print(f"cohort profile (one captured chunk of {sched.s} cohorts of "
          f"{sched.k}): device busy {busy_ms:.3f} ms in {ops} device ops; "
          f"idle share {out['idle_share']:.4f} against the main run's "
          f"steady chunk ({chunk_ms:.1f} ms on the host clock), "
          f"{out['traced_idle_share']:.4f} against the traced chunk's "
          f"{traced_ms:.1f} ms; {CARD['smi']}", flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:.4f} ms x{e.count}  "
              f"{e.key[:90]}", flush=True)
    return out


def cohort_kernel_rows(res, ds, dev: torch.device) -> dict:
    """K1's broadcast mode, K2 and K3 at the cohort path's shapes, and K4
    at the cohort ring's payload, against their plain versions on the
    same inputs, timed beside them and their bounds: K1 at (256, 11,352)
    on 256 stored records' params with their data-size weights (1e-5); K2
    on those params over the members' (256, 8) rows (counts equal but on
    near-tie rows); K3 on the final global over the held-out rows (1e-4);
    K4 bitwise at (8, 11,353). These launches compare; they are made
    after the counted runs."""
    from fedtpu_torch.convert import params_from_jax
    from fedtpu_torch.data.sharding import pack_clients
    from fedtpu_torch.models.mlp import mlp_apply, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    store = res.cohort["store"]
    ids = res.cohort["ids"][-1]
    dims = INCOME_DIMS
    k = dims[-1]
    packed = pack_clients(ds.x_train, ds.y_train, res.config.shard)
    x, y, mask = (torch.from_numpy(a[ids]).to(dev)
                  for a in (packed.x, packed.y, packed.mask))
    stored = store.read(ids)[-1]
    params = torch.from_numpy(stored + np.random.default_rng(0).normal(
        0, 1e-2, stored.shape).astype(np.float32)).to(dev)
    w = mask.sum(dim=1)
    glob = params_from_jax(res.final_params).to(dev)
    x_eval = torch.from_numpy(ds.x_test).to(dev)
    c, n = y.shape
    live = float(mask.sum())
    avg = ck.weighted_average_clients(params, w, broadcast=True)
    e1 = float((avg - ck.weighted_average_clients_reference(
        params, w, broadcast=True)).abs().max())
    check(e1 <= 1e-5, f"K1 broadcast at ({c}, {params.shape[1]}): max abs "
          f"err {e1}")
    conf = ck.fused_eval_confusion(params, dims, x, y, mask, k)
    ref = ck.fused_eval_confusion_reference(params, dims, x, y, mask, k)
    ties = near_tie_rows(mlp_apply(unflatten(params, dims), x)) & (mask > 0)
    moved = (conf - ref).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties.sum(dim=1)).all()),
          f"K2 at the cohort shape ({c}, {n}): counts differ on "
          f"{int(moved.sum())} rows, near ties {int(ties.sum())}")
    logits = ck.fused_mlp_forward(glob, dims, x_eval)
    e3 = float((logits - ck.fused_mlp_forward_reference(glob, dims, x_eval)
                ).abs().max())
    check(e3 <= 1e-4, f"K3 at N={x_eval.shape[0]}: max abs err {e3}")
    ring = torch.randn(SHARDS, params.shape[1] + 1,
                       generator=torch.Generator().manual_seed(5)).to(dev)
    check(torch.equal(ck.ring_all_reduce_sum(ring),
                      ck.ring_all_reduce_sum_reference(ring)),
          "K4 at the cohort ring's payload: not bitwise its plain version")
    wn = w / w.sum()
    d = params.shape[1]
    rows = {}
    for name, kernel, plain, library, nbytes, flops, err, shape in (
            ("weighted_average_clients",
             lambda: ck.weighted_average_clients(params, w, broadcast=True),
             lambda: ck.weighted_average_clients_reference(
                 params, w, broadcast=True), None,
             4 * (2 * params.numel() + c), 2.0 * params.numel(), e1,
             f"cohort broadcast ({c}, {d}) fp32, data-size weights"),
            ("fused_eval_confusion",
             lambda: ck.fused_eval_confusion(params, dims, x, y, mask, k),
             lambda: ck.fused_eval_confusion_reference(params, dims, x, y,
                                                       mask, k), None,
             4 * (params.numel() + live * (dims[0] + 1) + mask.numel()
                  + c * k * k), mlp_flops(dims, live),
             float((conf - ref).abs().max()),
             f"cohort eval ({c}, {n}), {int(live)} real rows"),
            ("fused_mlp_forward",
             lambda: ck.fused_mlp_forward(glob, dims, x_eval),
             lambda: ck.fused_mlp_forward_reference(glob, dims, x_eval),
             None, 4 * (glob.numel() + x_eval.numel()
                        + x_eval.shape[0] * k),
             mlp_flops(dims, x_eval.shape[0]), e3,
             f"cohort held-out eval N={x_eval.shape[0]}"),
            ("ring_all_reduce_sum",
             lambda: ck.ring_all_reduce_sum(ring),
             lambda: ck.ring_all_reduce_sum_reference(ring),
             lambda: ring.sum(dim=0), 2 * ring.numel() * 4,
             float((SHARDS - 1) * ring.numel()), 0.0,
             f"cohort ring ({SHARDS}, {ring.shape[1]})")):
        bnd, by = bound_ms(nbytes, flops)
        rows[name] = {"shape": shape, "max_abs_err": err,
                      "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                      "library_ms": library and time_ms(library),
                      "bound_ms": bnd, "bound_by": by}
        r = rows[name]
        print(f"time {name} {shape}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']}  bound "
              f"{bnd:.5f} ms ({by}); max abs err {err:.3e}; {CARD['smi']}",
              flush=True)
    # K1's broadcast has no one-call counterpart; the (D,) average that
    # it broadcasts is one torch.matmul.
    rows["weighted_average_clients"]["matmul_average_ms"] = time_ms(
        lambda: torch.matmul(wn, params))
    print(f"time torch.matmul (D,) average at ({c}, {d}): "
          f"{rows['weighted_average_clients']['matmul_average_ms']:.4f} ms",
          flush=True)
    return rows


def phase_cohort() -> tuple:
    """(r): cohort mode at the income MLP's full width (see the module
    docstring). Returns (launches by path, kernel rows, numbers)."""
    import tempfile
    from fedtpu_torch.cohort.scheduler import CohortSampler
    from fedtpu_torch.data import load_dataset
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    t_phase = time.perf_counter()
    by_path, numbers = {}, {}
    # 1. income-8 at full participation: the cohort engine is the
    # synchronous run, both captured.
    from fedtpu_torch.orchestration.loop import run_experiment
    cfg8 = main_path_config()
    sync8 = run_experiment(cfg8, verbose=False, device="cuda")
    coh8, by_path["cohort income-8"], _ = cohort_run(
        "cohort income-8 (8 of 8)", cfg8.replace(fed=dataclasses.replace(
            cfg8.fed, cohort_size=8)), None, COHORT_EXPECT)
    same_cohort_runs("income-8 cohort vs the synchronous run", coh8, sync8,
                     metrics_only=True)
    ds = load_dataset(cohort_config().data)
    base = cohort_config()
    # 2. 100,000 clients: captured (the main path), uncaptured, resumed on
    # the mmap store, CPU; a profiled captured chunk.
    a, by_path["cohort 100,000"], peak_a = cohort_run(
        "cohort 100,000 captured", base, ds, COHORT_EXPECT)
    b, _, _ = cohort_run("cohort 100,000 uncaptured", base, ds,
                         COHORT_EXPECT, capture=False)
    same_cohort_runs("cohort 100,000 captured vs uncaptured", a, b)
    numbers["s_per_round"] = {
        "captured": statistics.mean(a.sec_per_round[COHORT_S:]),
        "uncaptured": statistics.mean(b.sec_per_round[COHORT_S:])}
    numbers["chunk_stats"] = {"captured": a.cohort["chunk_stats"],
                              "uncaptured": b.cohort["chunk_stats"]}
    del b
    with tempfile.TemporaryDirectory() as directory:
        # The mmap store (<checkpoint_dir>/client_store.bin), stopped at
        # round COHORT_MMAP_STOP and resumed to COHORT_ROUNDS: bitwise the
        # uninterrupted run on the memory store.
        stop, evals = COHORT_MMAP_STOP, COHORT_MMAP_STOP // 10
        mm_cfg = base.replace(
            fed=dataclasses.replace(base.fed, client_store="mmap"),
            run=dataclasses.replace(base.run, checkpoint_every=stop,
                                    checkpoint_dir=os.path.join(
                                        directory, "ckpt")))
        cohort_run(f"cohort 100,000 mmap to round {stop}", mm_cfg.replace(
            fed=dataclasses.replace(mm_cfg.fed, rounds=stop)), ds)
        steps = complete_steps(mm_cfg.run.checkpoint_dir)
        check(steps == [stop], f"cohort resume: checkpoints {steps}")
        resumed, _, _ = cohort_run(
            f"cohort 100,000 mmap resumed {stop} -> {COHORT_ROUNDS}",
            mm_cfg, ds, resume=True)
        same_cohort_runs(f"cohort 100,000 mmap resumed {stop} -> "
                         f"{COHORT_ROUNDS} vs the uninterrupted memory-store "
                         "run", resumed, a, skip=stop, skip_evals=evals)
        del resumed
    numbers["profile"] = cohort_profile(
        base, ds, numbers["s_per_round"]["captured"] * COHORT_S * 1e3)
    cohort_vs_cpu("cohort 100,000", base, ds, a)
    with tempfile.TemporaryDirectory() as directory:
        # 3. 1,000,000 clients. The memory store: calloc-backed, only the
        # touched records are resident. (A 136 GB mmap file runs the card
        # machine's sandbox out of its 96 GiB: PERF.md §6.)
        big_cfg = cohort_config(clients=COHORT_MILLION, rounds=10)
        big, by_path["cohort 1,000,000"], peak_big = cohort_run(
            "cohort 1,000,000", big_cfg, ds, COHORT_EXPECT)
        store = big.cohort["store"]
        numbers["million"] = {
            "s_per_round": statistics.mean(big.sec_per_round),
            "apparent_bytes": store.apparent_nbytes,
            "resident_bytes": store.resident_estimate_bytes(),
            "peak_device_bytes": peak_big,
            "peak_device_bytes_100k": peak_a,
            "chunk_stats": big.cohort["chunk_stats"]}
        check(abs(peak_big - peak_a) < 64 * 2**20,
              f"peak device memory {peak_big} at 1,000,000 clients vs "
              f"{peak_a} at 100,000: not cohort-sized")
        print(f"cohort 1,000,000: store {store.apparent_nbytes} bytes "
              f"apparent, {store.resident_estimate_bytes()} resident "
              f"({len(store._touched)} records); peak device memory "
              f"{peak_big} bytes vs {peak_a} at 100,000 "
              f"({(peak_big - peak_a) / 2**20:+.2f} MiB); {CARD['smi']}",
              flush=True)
        del big, store
        # 5. Trace sampling from a trace the serving stack writes.
        trace = os.path.join(directory, "trace.jsonl")
        header, t, users, lat = synthesize_trace(
            users=COHORT_CLIENTS, arrivals=40_000, seed=0)
        write_trace(trace, header, t, users, lat)
        tr_cfg = cohort_config(rounds=COHORT_SHORT, cohort_sampling="trace",
                               cohort_trace=trace,
                               run={"rounds_per_step": COHORT_SHORT,
                                    "eval_test_every": COHORT_SHORT})
        tr, by_path["cohort trace"], _ = cohort_run(
            "cohort 100,000 trace-sampled", tr_cfg, ds, COHORT_EXPECT)
        want = CohortSampler(COHORT_CLIENTS, COHORT_K, policy="trace",
                             trace_users=users % COHORT_CLIENTS).sample(
                                 0, COHORT_SHORT)
        check(all(np.array_equal(tr.cohort["ids"][r], want[r])
                  for r in range(COHORT_SHORT)),
              "trace-sampled cohorts are not the trace walk's")
        print("cohort trace-sampled: each round's cohort is the trace "
              "walk's next distinct users", flush=True)
        del tr
    # 4. The ring over 8 shards of the cohort, and the median.
    short = {"rounds_per_step": COHORT_SHORT,
             "eval_test_every": COHORT_SHORT}
    ring_cfg = cohort_config(rounds=COHORT_SHORT, aggregation="ring",
                             run={**short, "mesh_devices": SHARDS})
    ring, by_path["cohort ring"], _ = cohort_run(
        "cohort 100,000 ring over 8 shards", ring_cfg, ds,
        {"ring_all_reduce_sum": "cohorts", "weighted_average_clients": 0,
         "fused_eval_confusion": "cohorts", "fused_mlp_forward": "evals"})
    cohort_vs_cpu("cohort ring", ring_cfg, ds, ring)
    med_cfg = cohort_config(rounds=COHORT_SHORT, weighting="uniform",
                            robust_aggregation="median", run=short)
    med, by_path["cohort median"], _ = cohort_run(
        "cohort 100,000 median", med_cfg, ds,
        {"weighted_average_clients": 0, "fused_eval_confusion": "cohorts",
         "fused_mlp_forward": "evals", "ring_all_reduce_sum": 0})
    cohort_vs_cpu("cohort median", med_cfg, ds, med)
    rows = cohort_kernel_rows(a, ds, torch.device("cuda"))
    numbers["seconds"] = time.perf_counter() - t_phase
    print(f"phase (r) took {numbers['seconds']:.1f} s", flush=True)
    return by_path, rows, numbers


# ------------------------------------------------------- (s) telemetry
# income-8 at R = 10 (the main path's data, captured) with the events sink
# on and off, and with the profile window (profile_rounds 20); serve, a
# two-gateway fleet and a gateway behind the wire-fault proxy writing their
# sinks, an autoscale decision log, all merged by ``timeline``; the timeline
# sim; a small cohort run with events.
TELEMETRY_R = 10
TELEMETRY_PROFILE_ROUNDS = 20
# The whole-run profile (profile_rounds 0): 25 rounds with no early stop,
# chunks of 10, 10 and 5, so the first chunk's warm-up and capture and the
# tail chunk's capture all run under the profiler.
TELEMETRY_WHOLE_ROUNDS = 25
# The sink's cost: income-8 at R = 10, 100 rounds with no early stop, the
# sink off and on in this many alternating pairs.
TELEMETRY_PAIRS = 3
# The serving sinks' trace: loadgen's population at a tenth of its default
# arrivals and horizon.
TELEMETRY_TRACE = dict(users=1_000_000, arrivals=4_000, horizon_s=6.0,
                       seed=1)
# The small cohort run: income-8's model over 10,000 clients on 100,000
# synthetic rows, cohorts of 256, 5 a chunk, 10 rounds.
TELEMETRY_COHORT = dict(clients=10_000, rows=100_000, rounds=10, s=5)
# Where each chain of a sink must pass, in order: the gateways log each
# frame to their WAL, serve does not (fedtpu's serve has no WAL either).
CHAIN_GATEWAY = ("client_stamp", "wal", "admit", "buffer_insert",
                 "incorporate")
CHAIN_SERVE = ("client_stamp", "admit", "buffer_insert", "incorporate")


def read_sink(path: str) -> list:
    from fedtpu_torch.telemetry.report import load_events
    events, bad = load_events(path)
    check(bad == 0 and events, f"{path}: {bad} malformed lines, "
          f"{len(events)} events")
    check(all(e["v"] == 2 for e in events), f"{path}: not schema v2")
    return events


def telemetry_config(cfg, events=None, profile=None,
                     profile_rounds=TELEMETRY_PROFILE_ROUNDS):
    """``cfg`` with the events sink at ``events`` and the profile window
    (``profile_rounds``; 0 the whole run) under ``profile`` (None: off)."""
    from fedtpu_torch.config import TelemetryConfig
    return cfg.replace(run=dataclasses.replace(
        cfg.run, telemetry=TelemetryConfig(events_path=events),
        profile_dir=profile,
        profile_rounds=profile_rounds if profile else 0))


def telemetry_run(cfg, events=None, profile=None,
                  profile_rounds=TELEMETRY_PROFILE_ROUNDS):
    """One income-8 run on the card (launch counts from zero around it);
    ``events`` / ``profile`` / ``profile_rounds``: ``telemetry_config``'s.
    Returns (result, launches)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    res = run_experiment(telemetry_config(cfg, events, profile,
                                          profile_rounds),
                         verbose=False, device="cuda")
    torch.cuda.synchronize()
    return res, dict(ck.LAUNCHES)


def same_result(label: str, a, b) -> None:
    """Bitwise the same history and final params."""
    check(a.rounds_run == b.rounds_run and a.rounds_trained
          == b.rounds_trained, f"{label}: rounds differ")
    for name in a.global_metrics:
        check(a.global_metrics[name] == b.global_metrics[name]
              and a.pooled_metrics[name] == b.pooled_metrics[name]
              and a.test_metrics[name] == b.test_metrics[name],
              f"{label}: the {name} history differs")
    check(all(np.array_equal(x, y) for x, y in zip(a.loss + a.confusion,
                                                   b.loss + b.confusion)),
          f"{label}: losses or confusion counts differ")
    fa, fb = (np.concatenate([np.ravel(np.asarray(v)) for lyr in
                              r.final_params["layers"] for v in lyr.values()])
              for r in (a, b))
    check(np.array_equal(fa.view(np.int32), fb.view(np.int32)),
          f"{label}: final params differ")


def tracer_event_us(directory: str, n: int = 2000) -> dict:
    """Host microseconds of one ``round`` event (the tracer's JSON encoding,
    write and flush into a sink in ``directory``), and of its JSON encoding
    alone."""
    from fedtpu_torch.telemetry.trace import EVENT_SCHEMA_VERSION, Tracer
    path = os.path.join(directory, "tracer-bench.jsonl")
    tracer = Tracer(path)
    t0 = time.perf_counter()
    for i in range(n):
        tracer.event("round", round=i + 1, dur_s=7.5e-4, accuracy=0.8125,
                     loss_mean=0.4375)
    event_us = 1e6 * (time.perf_counter() - t0) / n
    tracer.close()
    rec = {"v": EVENT_SCHEMA_VERSION, "run_id": tracer.run_id,
           "kind": "round", "phase": None, "round": 1, "t_start": 1.0,
           "dur_s": 7.5e-4, **tracer.identity,
           "payload": {"accuracy": 0.8125, "loss_mean": 0.4375}}
    t0 = time.perf_counter()
    for _ in range(n):
        json.dumps(rec)
    encode_us = 1e6 * (time.perf_counter() - t0) / n
    os.remove(path)
    return {"event_us": event_us, "encode_us": encode_us}


def telemetry_overhead(directory: str) -> dict:
    """s/round of the main path at R = TELEMETRY_R, captured, 100 rounds
    (no early stop), with the sink off and on (in ``directory``), in
    TELEMETRY_PAIRS pairs of runs whose order alternates: each run's mean
    lap of chunks 2.., and for the sink the events a round and the host
    time a round spent inside ``Tracer.event`` (timed by a wrapper around
    it), with the median microseconds of each event kind."""
    from fedtpu_torch.telemetry import trace as trace_mod
    base = main_path_config()
    cfg = base.replace(
        fed=dataclasses.replace(base.fed, termination_patience=1000),
        run=dataclasses.replace(base.run, rounds_per_step=TELEMETRY_R))
    modes = ("off", "on")
    laps = {m: [] for m in modes}
    in_tracer, per_round = [], []
    inner = trace_mod.Tracer.event
    spent = [0.0]
    by_kind = {}

    def timed(self, kind, *args, **kw):
        t0 = time.perf_counter()
        inner(self, kind, *args, **kw)
        dt = time.perf_counter() - t0
        spent[0] += dt
        key = kind if kw.get("phase") is None else f"{kind}:{kw['phase']}"
        by_kind.setdefault(key, []).append(dt)

    trace_mod.Tracer.event = timed
    try:
        for i in range(TELEMETRY_PAIRS):
            for mode in modes[i % 2:] + modes[:i % 2]:
                path = (os.path.join(directory, f"overhead-{i}.jsonl")
                        if mode == "on" else None)
                spent[0] = 0.0
                res, _ = telemetry_run(cfg, events=path)
                laps[mode].append(statistics.mean(
                    res.sec_per_round[TELEMETRY_R:]))
                if path:
                    in_tracer.append(spent[0] / res.rounds_run)
                    per_round.append(len(read_sink(path)) / res.rounds_run)
    finally:
        trace_mod.Tracer.event = inner
    return {"s_round_off": laps["off"], "s_round_on": laps["on"],
            "cost_s_round": statistics.median(laps["on"])
            - statistics.median(laps["off"]),
            "tracer_s_round": in_tracer,
            "events_per_round": statistics.mean(per_round),
            "event_us_by_kind": {k: round(1e6 * statistics.median(v), 1)
                                 for k, v in sorted(by_kind.items())}}


def telemetry_income8(directory: str) -> tuple:
    """The main path with events off, on, on, off (bitwise the same run,
    the same K1-K3 launches; s/round of each), then with the profile
    window, after the CPU's run of that config (the same config, so the
    same config hash; its sink and trace moved aside); the sinks' checks;
    ``report`` in its three formats. Returns the launches by path and the
    numbers."""
    from fedtpu_torch.orchestration.loop import run_experiment
    from fedtpu_torch.telemetry.report import render_report
    base = main_path_config()
    cfg = base.replace(run=dataclasses.replace(
        base.run, rounds_per_step=TELEMETRY_R))
    runs, sinks = [], []
    for i, on in enumerate((False, True, True, False)):
        path = os.path.join(directory, f"income8-{i}.jsonl") if on else None
        runs.append(telemetry_run(cfg, events=path))
        sinks.append(path)
    ref, ref_launches = runs[0]
    for (res, launches), path in zip(runs[1:], sinks[1:]):
        same_result(f"income-8 R={TELEMETRY_R} events "
                    f"{'on' if path else 'off'}", ref, res)
        check(launches == ref_launches, f"income-8 events: launches "
              f"{launches} vs {ref_launches} with events off")
    for name in ("weighted_average_clients", "fused_eval_confusion",
                 "fused_mlp_forward"):
        check(ref_launches[name] > 0, f"income-8 events: {name} never "
              "launched")
    warm = TELEMETRY_R

    def s_round(res):
        return statistics.median(res.sec_per_round[warm:])

    off = [s_round(runs[0][0]), s_round(runs[3][0])]
    on = [s_round(runs[1][0]), s_round(runs[2][0])]
    per_event = tracer_event_us(directory)
    cost = telemetry_overhead(directory)
    prof_dir = os.path.join(directory, "profile")
    sink = os.path.join(directory, "income8-profile.jsonl")
    cpu = run_experiment(telemetry_config(cfg, sink, prof_dir),
                         verbose=False, device="cpu")
    cpu_sink = f"{sink}.cpu"
    os.replace(sink, cpu_sink)
    os.replace(prof_dir, f"{prof_dir}.cpu")
    prof, prof_launches = telemetry_run(cfg, events=sink, profile=prof_dir)
    same_result("income-8 with the profile window", ref, prof)
    check(prof_launches == ref_launches, "income-8 profile: launches differ")
    events = read_sink(sink)
    kinds = [e["kind"] for e in events]
    man = [e for e in events if e["kind"] == "manifest"]
    check(len(man) == 1, f"income-8 sink: {len(man)} manifests")
    man = man[0]["payload"]
    cpu_man = next(e["payload"] for e in read_sink(cpu_sink)
                   if e["kind"] == "manifest")
    check(man["backend"] == "cuda" and cpu_man["backend"] == "cpu"
          and man["device_kinds"] == [torch.cuda.get_device_name(0)]
          and man["config_hash"] == cpu_man["config_hash"],
          f"income-8 manifest: backend {man['backend']}, kinds "
          f"{man['device_kinds']}, hash {man['config_hash']} vs the CPU's "
          f"{cpu_man['config_hash']}")
    check(cpu.rounds_run == prof.rounds_run, "income-8: the CPU run "
          f"stopped at {cpu.rounds_run}, the card's at {prof.rounds_run}")
    chunks = [e for e in events if e["kind"] == "span"
              and e["phase"] == "chunk"]
    rounds = [e["round"] for e in events if e["kind"] == "round"]
    n_chunks = math.ceil(prof.rounds_run / TELEMETRY_R)
    check(len(chunks) == n_chunks and rounds == list(
        range(1, prof.rounds_run + 1)), f"income-8 sink: {len(chunks)} "
          f"chunk spans for {n_chunks} chunks, round events {rounds}")
    window = [e for e in events if e["kind"] == "profile_window"]
    check([e["phase"] for e in window] == ["start", "stop"]
          and window[1]["payload"]["rounds"] >= TELEMETRY_PROFILE_ROUNDS,
          f"income-8 sink: profile window events {window}")
    traces = sorted(os.listdir(prof_dir))
    check(len(traces) == 1, f"profile dir holds {traces}")
    with open(os.path.join(prof_dir, traces[0])) as fh:
        trace_text = fh.read()
    for kernel in ("ft_wavg_kernel", "ft_eval_confusion_kernel"):
        check(kernel in trace_text, f"the profile window's trace does not "
              f"name {kernel}")
    check(kinds[-1] == "run_end" and kinds.count("counters") == 1
          and kinds[-2] == "counters", f"income-8 sink: last kinds "
          f"{kinds[-3:]}")
    gauges = events[-2]["payload"]["gauges"]
    for name in ("device_bytes_in_use", "live_array_count",
                 "live_array_bytes"):
        check(gauges.get(name, 0) > 0, f"income-8 counters: gauge {name} "
              f"{gauges.get(name)}")
    counters = events[-2]["payload"]["counters"]
    check(counters.get("rounds") == prof.rounds_run
          and counters.get("graph_captures", 0) >= 1,
          f"income-8 counters: {counters}")
    text, prom = render_report(sink)
    as_json = json.loads(render_report(sink, fmt="json")[0])
    check("phase breakdown" in text and "fedtpu_rounds_total" in prom
          and as_json["rounds"]["count"] == prof.rounds_run,
          "income-8 report: text, JSON or Prometheus output incomplete")
    print(f"telemetry, income-8 R={TELEMETRY_R} captured ({prof.rounds_run} "
          f"rounds): events on == off bitwise (history, params), launches "
          f"{ref_launches} in each; s/round events off {off}, on {on} "
          f"(median of rounds {warm + 1}.. each, runs off, on, on, off); "
          f"a round event {per_event['event_us']:.1f} us of host time "
          f"({per_event['encode_us']:.1f} us of it its JSON encoding); "
          f"100 rounds, no early stop, the sink off / on in "
          f"{TELEMETRY_PAIRS} alternating pairs: "
          f"{json.dumps({k: v for k, v in cost.items()})} (s/round: mean "
          f"lap of chunks 2.. each; cost: median minus the median off; "
          f"tracer: host s a round inside Tracer.event); "
          f"the sink: {len(events)} events, {len(chunks)} chunk spans, "
          f"{len(rounds)} round events, profile window rounds "
          f"{window[0]['round']}-{window[1]['round']} in {traces[0]} "
          f"({len(trace_text)} bytes, K1 and K2 named), config hash "
          f"{man['config_hash']} = the CPU's, gauges {gauges}, graph "
          f"captures {counters.get('graph_captures')} in "
          f"{counters.get('graph_capture_secs', 0):.3f} s; "
          f"flops_per_round {man['profile']['flops_per_round']:.6e}, "
          f"bytes_per_round {man['profile']['bytes_per_round']:.6e}; "
          f"{CARD['smi']}", flush=True)
    return ({"income-8 psum, events on": runs[1][1],
             "income-8 psum, profile window": prof_launches},
            {"s_round_off": off, "s_round_on": on, **per_event,
             "overhead": cost,
             "s_round_profiled": s_round(prof), "events": len(events)})


def telemetry_whole_run(directory: str) -> tuple:
    """The main path at R = TELEMETRY_R, TELEMETRY_WHOLE_ROUNDS rounds with
    no early stop (a tail chunk), with the events sink and the profiler
    over the whole run (profile_rounds 0), so both graphs' warm-up and
    capture run under it; held bitwise against the same run with both
    off, with equal K1-K3 launches. Returns the launches by path."""
    base = main_path_config()
    cfg = base.replace(
        fed=dataclasses.replace(base.fed, rounds=TELEMETRY_WHOLE_ROUNDS,
                                termination_patience=1000),
        run=dataclasses.replace(base.run, rounds_per_step=TELEMETRY_R))
    ref, ref_launches = telemetry_run(cfg)
    sink = os.path.join(directory, "income8-whole.jsonl")
    prof_dir = os.path.join(directory, "profile-whole")
    res, launches = telemetry_run(cfg, events=sink, profile=prof_dir,
                                  profile_rounds=0)
    label = f"income-8 {TELEMETRY_WHOLE_ROUNDS} rounds, whole-run profile"
    check(res.rounds_trained == TELEMETRY_WHOLE_ROUNDS,
          f"{label}: {res.rounds_trained} rounds trained")
    same_result(label, ref, res)
    check(launches == ref_launches, f"{label}: launches {launches} vs "
          f"{ref_launches} with events and the profiler off")
    for name in ("weighted_average_clients", "fused_eval_confusion",
                 "fused_mlp_forward"):
        check(launches[name] > 0, f"{label}: {name} never launched")
    events = read_sink(sink)
    takes = [e["payload"]["rounds"] for e in events if e["kind"] == "span"
             and e["phase"] == "chunk"]
    want = [TELEMETRY_R] * (TELEMETRY_WHOLE_ROUNDS // TELEMETRY_R)
    want += [TELEMETRY_WHOLE_ROUNDS % TELEMETRY_R]
    check(takes == want, f"{label}: chunk spans of {takes} rounds")
    check(not any(e["kind"] == "profile_window" for e in events),
          f"{label}: profile_window events with profile_rounds 0")
    counters = [e for e in events if e["kind"] == "counters"][-1]["payload"]
    captures = counters["counters"].get("graph_captures", 0)
    check(captures == len(set(takes)), f"{label}: {captures} graph "
          f"captures for chunks of {sorted(set(takes))} rounds")
    traces = sorted(os.listdir(prof_dir))
    check(traces == [f"rounds_0-{TELEMETRY_WHOLE_ROUNDS}.{os.getpid()}"
                     ".trace.json"], f"{label}: profile dir holds {traces}")
    with open(os.path.join(prof_dir, traces[0])) as fh:
        trace_text = fh.read()
    for kernel in ("ft_wavg_kernel", "ft_eval_confusion_kernel",
                   "ft_mlp_forward_kernel"):
        check(kernel in trace_text, f"{label}: the trace does not name "
              f"{kernel}")
    print(f"telemetry, {label} (chunks {takes}, {captures} graphs "
          f"captured under the profiler): == events and profiler off "
          f"bitwise (history, params), launches {launches} in each; "
          f"{traces[0]} {len(trace_text)} bytes naming K1, K2 and K3; "
          f"{CARD['smi']}", flush=True)
    return {"income-8 psum, whole-run profile": launches}


def chains_complete(label: str, sources: list, want: tuple) -> int:
    """Every chain that incorporates an update passes ``want``'s stages in
    order; returns the incorporations the chains hold."""
    from fedtpu_torch.telemetry.timeline import trace_chains
    n = 0
    for chain in trace_chains(sources):
        stages = [s["stage"] for s in chain["stages"]]
        if "incorporate" not in stages:
            continue
        first = [stages.index(s) if s in stages else -1 for s in want]
        check(min(first) >= 0 and first == sorted(first),
              f"{label}: chain {chain['chain']} stages {stages}")
        n += stages.count("incorporate")
    return n


def telemetry_serving(directory: str) -> dict:
    """serve, a two-gateway fleet (WAL on) and a gateway behind the
    wire-fault proxy (fedtpu's net sim plan), each writing its sink on the
    card, fed by the loadgen over the wire; an autoscale decision log;
    ``timeline`` over all of them (JSONL and Chrome): every incorporated
    update's chain complete, as many incorporations in the chains as the
    servers report."""
    import threading
    from fedtpu_torch.autoscale.controller import simulate, write_decisions
    from fedtpu_torch.config import ServingConfig
    from fedtpu_torch.resilience.net_sim import SIM_PLAN
    from fedtpu_torch.serving.gateway import run_gateway
    from fedtpu_torch.serving.loadgen import read_port_file, run_loadgen
    from fedtpu_torch.serving.protocol import gateway_port_file
    from fedtpu_torch.serving.server import run_server
    from fedtpu_torch.serving.traces import synthesize_trace, write_trace
    from fedtpu_torch.telemetry.timeline import (chrome_trace,
                                                 deterministic_lines,
                                                 load_timeline)
    from fedtpu_torch.telemetry.trace import make_tracer
    trace = os.path.join(directory, "telemetry-trace.jsonl")
    write_trace(trace, *synthesize_trace(**TELEMETRY_TRACE))
    cfg = ServingConfig(**SERVE_CFG)

    def threaded(servers: list, feed) -> dict:
        box = {}

        def one(k, fn):
            try:
                box[k] = fn()
            except BaseException as e:  # reported on the main thread
                box[f"error {k}"] = e

        threads = [threading.Thread(target=one, args=(k, fn))
                   for k, fn in enumerate(servers)]
        for th in threads:
            th.start()
        try:
            box["feed"] = feed()
        finally:
            for th in threads:
                th.join(timeout=600)
        errors = {k: v for k, v in box.items() if str(k).startswith("error")}
        check(not errors and not any(th.is_alive() for th in threads),
              f"telemetry serving: {errors!r}")
        return box

    serve_ev = os.path.join(directory, "serve.jsonl")
    pf = os.path.join(directory, "serve.port")
    served = threaded([lambda: run_server(
        cfg, events=serve_ev, port_file=pf, once=True, verbose=False)],
        lambda: run_loadgen(trace, port_file=pf, timeout=300))
    fleet_ev = os.path.join(directory, "fleet.jsonl")
    fpf = os.path.join(directory, "fleet.port")

    def fleet_feed():
        for g in range(FLEET_N):
            read_port_file(gateway_port_file(fpf, g), timeout=300)
        return run_loadgen(trace, port_file=fpf, num_gateways=FLEET_N,
                           timeout=300)

    fleet = threaded([functools.partial(
        run_gateway, cfg, gateway_index=g, num_gateways=FLEET_N,
        port_file=fpf, events=fleet_ev,
        checkpoint_dir=os.path.join(directory, "fleet-ck"), once=True,
        verbose=False) for g in range(FLEET_N)], fleet_feed)
    net_ev = os.path.join(directory, "net.jsonl")
    npf = os.path.join(directory, "net.port")

    def net_feed():
        read_port_file(npf, timeout=300)
        return run_loadgen(trace, port_file=npf, timeout=300, backoff_s=0.01)

    net = fleet_serve_main_thread(lambda: run_gateway(
        cfg, num_gateways=1, port_file=npf, events=net_ev,
        checkpoint_dir=os.path.join(directory, "net-ck"),
        net_fault_plan=json.dumps(SIM_PLAN), verbose=False), net_feed)
    decisions = os.path.join(directory, "autoscale.jsonl")
    auto_ev = os.path.join(directory, "autoscale-events.jsonl")
    tracer = make_tracer(auto_ev, role="autoscale")
    sim = simulate(tracer=tracer)
    tracer.close()
    write_decisions(decisions, sim["lines"])
    fleet_sinks = [f"{fleet_ev}.g{g}" for g in range(FLEET_N)]
    for path, role in ([(serve_ev, "serve"), (net_ev, "gateway-0")]
                       + [(p, f"gateway-{g}")
                          for g, p in enumerate(fleet_sinks)]):
        roles = {e["role"] for e in read_sink(path)}
        check(roles == {role}, f"{path}: roles {roles}, not {role}")
    net_kinds = {e["kind"] for e in read_sink(net_ev)}
    check({"net_fault", "netproxy_summary"} <= net_kinds,
          f"the proxied gateway's sink lacks the proxy's events: {net_kinds}")
    check(any(e["kind"] == "autoscale_decision" for e in read_sink(auto_ev)),
          "autoscale --events: no decision event")
    paths = [serve_ev, *fleet_sinks, net_ev, f"{npf}.netlog", decisions]
    sources = load_timeline(paths)
    lines = deterministic_lines(sources)
    chrome = chrome_trace(sources)
    check(len(sources) == len(paths) and lines and chrome["traceEvents"],
          f"timeline: {len(sources)} sources of {len(paths)}")
    serve_src = [s for s in sources if s["path"] == serve_ev]
    gw_src = [s for s in sources if s["path"] in fleet_sinks + [net_ev]]
    n_serve = chains_complete("serve", serve_src, CHAIN_SERVE)
    n_gw = chains_complete("gateways", gw_src, CHAIN_GATEWAY)
    inc_serve = served["feed"]["server_stats"]["incorporated"]
    inc_fleet = sum(s["incorporated"]
                    for s in fleet["feed"]["server_stats"].values())
    inc_net = net["server_stats"]["incorporated"]
    check(n_serve == inc_serve and n_gw == inc_fleet + inc_net,
          f"timeline: chains incorporate {n_serve} (serve) and {n_gw} "
          f"(gateways), the servers report {inc_serve}, {inc_fleet} + "
          f"{inc_net}")
    print(f"telemetry, serving ({TELEMETRY_TRACE['arrivals']} arrivals each, "
          f"income MLP at full width, 32 slots): serve, the 2-gateway fleet "
          f"and a gateway behind the proxy wrote their sinks on the card "
          f"(roles checked), autoscale {len(sim['lines'])} decision lines; "
          f"timeline merged {len(sources)} sources into {len(lines)} lines "
          f"and {len(chrome['traceEvents'])} Chrome events; every "
          f"incorporated update's chain complete: {n_serve} (serve, "
          f"{' -> '.join(CHAIN_SERVE)}), {n_gw} (gateways, "
          f"{' -> '.join(CHAIN_GATEWAY)}); {CARD['smi']}", flush=True)
    return {"timeline_lines": len(lines), "chains_serve": n_serve,
            "chains_gateways": n_gw}


def telemetry_timeline_sim() -> dict:
    """The timeline sim on the card: the pinned arrivals give the committed
    golden's lines."""
    from fedtpu_torch.telemetry.timeline_sim import (compare_decisions,
                                                     simulate)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "goldens", "timeline_sim.jsonl")
    sim = simulate(device="cuda")
    res = compare_decisions(sim["lines"], golden)
    check(res["ok"], f"timeline sim on the card vs the golden: "
          f"{res['reason']}")
    print(f"telemetry, timeline sim on the card: {res['reason']}; retry "
          f"stages {sim['summary']['retry_stages']}; {CARD['smi']}",
          flush=True)
    return {"golden": res["ok"], "lines": len(sim["lines"])}


def telemetry_cohort(directory: str) -> tuple:
    """A small captured cohort run with events: a cohort_gather and a
    cohort_writeback span a chunk, a cohort_round event a round, the
    cohort_config, cohort_summary and run_end events."""
    from fedtpu_torch.config import TelemetryConfig
    from fedtpu_torch.data import load_dataset
    tc = TELEMETRY_COHORT
    cfg = cohort_config(clients=tc["clients"], rounds=tc["rounds"],
                        run={"rounds_per_step": tc["s"]})
    sink = os.path.join(directory, "cohort.jsonl")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, synthetic_rows=tc["rows"]),
        run=dataclasses.replace(cfg.run, telemetry=TelemetryConfig(
            events_path=sink)))
    res, launches, _ = cohort_run(
        "telemetry cohort", cfg, load_dataset(cfg.data),
        expect={"weighted_average_clients": "cohorts",
                "fused_eval_confusion": "cohorts"})
    events = read_sink(sink)
    spans = [e["phase"] for e in events if e["kind"] == "span"]
    chunks = res.rounds_trained // tc["s"]
    kinds = [e["kind"] for e in events]
    check(spans.count("cohort_gather") == chunks
          and spans.count("cohort_writeback") == chunks
          and spans.count("chunk") == chunks
          and kinds.count("cohort_round") == res.rounds_run
          and {"cohort_config", "cohort_summary", "run_end"} <= set(kinds),
          f"cohort sink: spans {spans}, kinds {sorted(set(kinds))}")
    print(f"telemetry, cohort ({tc['clients']} clients, cohorts of "
          f"{COHORT_K}, {tc['s']} a chunk, {res.rounds_run} rounds): "
          f"{chunks} cohort_gather and cohort_writeback spans, "
          f"{kinds.count('cohort_round')} cohort_round events; launches "
          f"{launches}; {CARD['smi']}", flush=True)
    return {"cohort, events on": launches}


def phase_telemetry() -> tuple:
    """Phase (s): the telemetry on the card (the constants above). Returns
    the launches by path and the phase's numbers."""
    import tempfile
    seconds, numbers = {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    with tempfile.TemporaryDirectory() as directory:
        by_path, numbers["income8"] = telemetry_income8(directory)
        lap("income-8")
        by_path.update(telemetry_whole_run(directory))
        lap("income-8 whole-run profile")
        numbers["serving"] = telemetry_serving(directory)
        lap("serving")
        numbers["timeline_sim"] = telemetry_timeline_sim()
        lap("timeline sim")
        by_path.update(telemetry_cohort(directory))
        lap("cohort")
    print(f"phase (s) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


# Phase (t): the single-process resilience loop on the card (income-8 at
# full width, 10,000 rows, R = RESIL_R, a checkpoint every 2 rounds).
RESIL_ROUNDS = 20
RESIL_R = 10
RESIL_FAULT = 13            # 1-based: inside the second chunk
RESIL_DELAY_S = 0.25        # the straggler's sleep
RESIL_PAIRS = 3             # armed-plan vs no-plan s/round pairs
# A card-vs-CPU loss difference forgiven the dropout run (phase 5's).
RESIL_LOSS_TOL = 1e-4


def resil_config(directory: str, tag: str, faults=None, rounds=RESIL_ROUNDS,
                 **run):
    """income-8 at full width for ``rounds`` rounds at R = RESIL_R with no
    early stop, checkpoints every 2 rounds under ``directory/tag``, the
    events sink ``directory/tag.jsonl`` and the fault plan ``faults`` (a
    list of fedtpu's plan entries; None: no plan)."""
    from fedtpu_torch.config import TelemetryConfig
    base = main_path_config()
    plan = (json.dumps({"seed": 0, "faults": faults}) if faults is not None
            else None)
    return base.replace(
        fed=dataclasses.replace(base.fed, rounds=rounds,
                                termination_patience=1000),
        run=dataclasses.replace(
            base.run, rounds_per_step=RESIL_R,
            checkpoint_dir=os.path.join(directory, tag), checkpoint_every=2,
            fault_plan=plan, telemetry=TelemetryConfig(
                events_path=os.path.join(directory, f"{tag}.jsonl")),
            **run))


def resil_run(cfg, device: str = "cuda", **kw):
    """One run with every launch count set to 0 just before it and read
    just after (the card's). Returns (result, launches)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    if device == "cuda":
        torch.cuda.synchronize()
    ck.reset_launch_counts()
    res = run_experiment(cfg, verbose=False, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, dict(ck.LAUNCHES)


def sink_kinds(path: str, kind: str) -> list:
    return [e for e in read_sink(path) if e["kind"] == kind]


def dropout_near_ties(k0: int, clients: list):
    """``phase_card_vs_cpu``'s replay for a run whose round ``k0`` (0-based)
    drops ``clients``: ``replay_near_ties`` with the dropout applied to
    both sides' mask and data-size weights for that round."""
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.resilience.faults import drop_clients
    from fedtpu_torch.training.client import make_local_train_step

    def replay(cfg, rounds: set) -> dict:
        sides = []
        for device in ("cpu", "cuda"):
            exp = build_experiment(cfg, device=device)
            sides.append({"exp": exp, "state": exp.state,
                          "step": exp.make_step(1),
                          "train": make_local_train_step(
                              exp.model, build_optimizer(cfg.optim),
                              cfg.fed.local_steps, cfg.fed.prox_mu)})
        out = {}
        for r in range(max(rounds) + 1):
            saved = []
            for side in sides:
                b, w = side["exp"].batch, side["exp"].client_weights
                saved.append((b["mask"].clone(), w.clone()))
                if r == k0:
                    drop_clients(b["mask"], clients, w)
            if r in rounds:
                logits = []
                for side in sides:
                    b, st = side["exp"].batch, side["state"]
                    params, _, _ = side["train"](st["params"],
                                                 st["opt_state"], b["x"],
                                                 b["y"], b["mask"], None)
                    logits.append(side["exp"].model.apply(params,
                                                          b["x"]).cpu())
                out[r] = near_ties(logits,
                                   sides[0]["exp"].batch["mask"] > 0)
            for side, (mask, w) in zip(sides, saved):
                side["state"], _ = side["step"](side["state"],
                                                side["exp"].batch)
                side["exp"].batch["mask"].copy_(mask)
                side["exp"].client_weights.copy_(w)
        return out
    return replay


def resil_faults(directory: str, base) -> dict:
    """Straggler, dropout (card vs CPU), NaN rollback (bitwise, launches
    counted), exclusion (against the CPU) and the spent budget. Returns
    the launches by path."""
    k = RESIL_FAULT
    # Straggler: timing only.
    res, _ = resil_run(resil_config(directory, "straggler", [
        {"kind": "straggler", "round": k, "clients": [0],
         "delay_s": RESIL_DELAY_S}]))
    diffs = same_history(base, res)
    check(not diffs, f"straggler: differs from the baseline in {diffs}")
    lap = res.sec_per_round[k - 1]
    check(lap >= RESIL_DELAY_S, f"straggler: round {k}'s lap {lap} s below "
          f"its {RESIL_DELAY_S} s delay")
    print(f"resilience straggler (round {k}, {RESIL_DELAY_S} s): bitwise "
          f"the baseline; the fault round's lap {lap:.4f} s; "
          f"{CARD['smi']}", flush=True)

    # Dropout: the card against the same plan on the CPU.
    drop = [{"kind": "client_dropout", "round": k, "clients": [1]}]
    cfg = resil_config(directory, "dropout", drop)
    gpu, _ = resil_run(cfg)
    check(not np.any(gpu.confusion[k - 1][1]),
          f"dropout: client 1 has counts in round {k}")
    prefix = all(gpu.global_metrics[m][:k - 1]
                 == base.global_metrics[m][:k - 1]
                 for m in base.global_metrics)
    moved = any(gpu.global_metrics[m][k - 1] != base.global_metrics[m][k - 1]
                for m in base.global_metrics)
    check(prefix and moved, f"dropout: prefix bitwise {prefix}, round {k} "
          f"moved {moved}")
    phase_card_vs_cpu(resil_config(directory, "dropout-cpu", drop), gpu,
                      label=f"resilience dropout (round {k}) card vs CPU",
                      loss_tol=RESIL_LOSS_TOL,
                      replay=dropout_near_ties(k - 1, [1]))

    # NaN rollback: bitwise the uninterrupted run, K1/K2 counted.
    nan = [{"kind": "nan_update", "round": k, "clients": [1]}]
    cfg = resil_config(directory, "nan", nan, on_divergence="rollback")
    res, launches = resil_run(cfg)
    diffs = same_history(base, res)
    check(not diffs, f"nan rollback: differs from the baseline in {diffs}")
    rb = sink_kinds(cfg.run.telemetry.events_path, "rollback")
    check(res.rollbacks == 1 and len(rb) == 1,
          f"nan rollback: {res.rollbacks} rollbacks, {len(rb)} events")
    replayed = rb[0]["round"] - rb[0]["payload"]["restored_round"]
    for name in ("weighted_average_clients", "fused_eval_confusion"):
        want = res.rounds_trained + replayed + res.warmup_rounds
        check(launches[name] == want,
              f"nan rollback: {name} launches {launches[name]} != rounds "
              f"trained {res.rounds_trained} + replayed {replayed} + "
              f"warm-up {res.warmup_rounds}")
    print(f"resilience nan_update (round {k}) + rollback: bitwise the "
          f"baseline, 1 rollback to round "
          f"{rb[0]['payload']['restored_round']} ({replayed} round(s) "
          f"replayed), launches {launches}, graph widths "
          f"{sorted(res.graph_launches)}; {CARD['smi']}", flush=True)

    # Exclusion: the excluded list against the CPU's.
    excl = {}
    for device in ("cuda", "cpu"):
        cfg = resil_config(directory, f"exclude-{device}", nan,
                           on_divergence="rollback", rollback_exclude=True)
        r, _ = resil_run(cfg, device=device)
        ev = sink_kinds(cfg.run.telemetry.events_path, "exclusion")
        excl[device] = (r.rollbacks, [e["payload"]["clients"] for e in ev],
                        r.rounds_run, r.diverged)
    check(excl["cuda"] == excl["cpu"] == (1, [[1]], RESIL_ROUNDS, False),
          f"rollback_exclude: card {excl['cuda']} vs CPU {excl['cpu']}")
    print(f"resilience rollback_exclude: excluded {excl['cuda'][1]} on the "
          "card and the CPU, one rollback each, no divergence", flush=True)

    # The budget spent: a second divergence with one retry halts.
    two = nan + [{"kind": "nan_update", "round": k + 4, "clients": [2]}]
    cfg = resil_config(directory, "budget", two, on_divergence="rollback",
                       rollback_retries=1)
    res, _ = resil_run(cfg)
    quarantine = os.path.join(cfg.run.checkpoint_dir, "diverged")
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    check(res.diverged and res.rollbacks == 1
          and complete_steps(quarantine),
          f"budget: diverged {res.diverged}, rollbacks {res.rollbacks}, "
          f"quarantine {complete_steps(quarantine)}")
    print(f"resilience budget spent: halted at round {res.rounds_run} "
          f"after 1 rollback, state under diverged/ round "
          f"{complete_steps(quarantine)}", flush=True)
    return {"income-8 R=10 nan_update + rollback": launches}


def resumed_is(label: str, base, res, at: int) -> None:
    """A run resumed at round ``at`` against the uninterrupted ``base``:
    the client-mean history whole, the rest from ``at`` on, bitwise."""
    check(res.global_metrics == base.global_metrics,
          f"{label}: client-mean history differs")
    tail = dataclasses.replace(
        base, loss=base.loss[at:], confusion=base.confusion[at:],
        pooled_metrics={k: v[at:] for k, v in base.pooled_metrics.items()},
        test_metrics={k: v[at // 10:] for k, v in base.test_metrics.items()})
    diffs = [d for d in same_history(res, tail) if d != "global_metrics"]
    check(not diffs, f"{label}: differs from the baseline in {diffs}")


def resil_drain_and_corrupt(directory: str, base) -> dict:
    """The in-process SIGTERM drain and resume, the corrupt checkpoint's
    fallback walk, and the heartbeat's statuses. Returns the drain
    checkpoint's ms."""
    import fedtpu_torch.orchestration.loop as loop_mod
    from fedtpu_torch.resilience.supervisor import Preempted
    k = RESIL_FAULT
    cfg = resil_config(directory, "drain", [
        {"kind": "process_kill", "round": k, "signal": "SIGTERM"}])
    got = None
    try:
        resil_run(cfg)
    except Preempted as p:
        got = p.round
    check(got == k, f"drain: Preempted at {got}, not {k}")
    spans = [e for e in read_sink(cfg.run.telemetry.events_path)
             if e["kind"] == "span" and e["phase"] == "checkpoint"
             and e["round"] == k]
    check(len(spans) == 1, f"drain: {len(spans)} checkpoints at round {k}")
    drain_ms = spans[0]["dur_s"] * 1e3
    res, _ = resil_run(with_run(cfg, fault_plan=None), resume=True)
    resumed_is("drain + resume", base, res, k)
    print(f"resilience SIGTERM drain at round {k}: checkpoint "
          f"{drain_ms:.3f} ms, Preempted({k}); resumed bitwise the "
          f"baseline; {CARD['smi']}", flush=True)

    # ckpt_corrupt on the last round's checkpoint, then a resume that
    # walks past it.
    cfg = resil_config(directory, "corrupt", [
        {"kind": "ckpt_corrupt", "round": 15}], rounds=15)
    resil_run(cfg)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, _ = resil_run(with_fed(with_run(cfg, fault_plan=None),
                                    rounds=RESIL_ROUNDS), resume=True)
    walked = [w for w in caught if "failed to restore" in str(w.message)]
    at = next(e["round"] for e in read_sink(cfg.run.telemetry.events_path)
              if e["kind"] == "resume")
    check(len(walked) == 1 and at < 14,
          f"corrupt: {len(walked)} fallback warnings, resumed at {at}")
    resumed_is("ckpt_corrupt + resume", base, res, at)
    print(f"resilience ckpt_corrupt at round 15: the resume walked past "
          f"round 14 to {at}, bitwise the baseline", flush=True)

    # The heartbeat's statuses, every write recorded.
    seen = []
    real = loop_mod.write_heartbeat

    def record(path, **payload):
        seen.append((payload["status"], payload["round"]))
        real(path, **payload)

    loop_mod.write_heartbeat = record
    try:
        hb = os.path.join(directory, "hb")
        resil_run(resil_config(directory, "heartbeat",
                               heartbeat_file=hb))
    finally:
        loop_mod.write_heartbeat = real
    want = ([("starting", 0)]
            + [("running", r) for r in range(RESIL_R, RESIL_ROUNDS + 1,
                                             RESIL_R)]
            + [("done", RESIL_ROUNDS)])
    from fedtpu_torch.resilience.supervisor import read_heartbeat
    last = read_heartbeat(hb)
    check(seen == want and last["status"] == "done",
          f"heartbeat: {seen} (last file {last}), not {want}")
    print(f"resilience heartbeat: {seen}", flush=True)
    return {"drain_checkpoint_ms": drain_ms}


def resil_numbers(directory: str) -> dict:
    """s/round with an armed plan whose faults lie past the end against no
    plan (alternating pairs, early stop on), a heartbeat write, and a
    rollback's restore-and-copy."""
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_fallback
    from fedtpu_torch.orchestration.loop import (_copy_state_into,
                                                 _restore_state,
                                                 build_experiment)
    from fedtpu_torch.resilience.supervisor import write_heartbeat
    base = with_run(main_path_config(), rounds_per_step=RESIL_R)
    last_round = base.fed.rounds
    armed = with_run(base, fault_plan=json.dumps({"seed": 0, "faults": [
        {"kind": "straggler", "round": last_round, "clients": [0],
         "delay_s": RESIL_DELAY_S}]}))
    s = {"none": [], "armed": []}
    stops = set()
    for _ in range(RESIL_PAIRS):
        for tag, cfg in (("none", base), ("armed", armed)):
            res, _ = resil_run(cfg)
            check(res.stopped_early and res.rounds_run < last_round - RESIL_R,
                  f"armed-plan pair: {tag} ran {res.rounds_run} rounds, "
                  "into the fault's chunk")
            stops.add(res.rounds_run)
            s[tag].append(statistics.median(res.sec_per_round[1:]))
    check(len(stops) == 1, f"armed-plan pairs stop at {stops}")
    print(f"resilience s/round (median of rounds 2.., R={RESIL_R}, stop "
          f"{stops}) no plan {s['none']} vs an armed plan past the end "
          f"{s['armed']}; {CARD['smi']}", flush=True)

    hb = os.path.join(directory, "hb-timing")
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        write_heartbeat(hb, status="running", round=i, restarts=0)
    hb_us = (time.perf_counter() - t0) / n * 1e6

    cfg = resil_config(directory, "restore")
    resil_run(cfg)
    exp = build_experiment(cfg, device="cuda")
    state = exp.state
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, _, _ = load_checkpoint_fallback(cfg.run.checkpoint_dir)
        _copy_state_into(state, _restore_state(raw, state, exp.device))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    restore_ms = statistics.median(times)
    print(f"resilience: heartbeat write {hb_us:.2f} us, rollback restore "
          f"and copy {restore_ms:.3f} ms (median of 5); {CARD['smi']}",
          flush=True)
    return {"sec_per_round_none": s["none"], "sec_per_round_armed": s["armed"],
            "heartbeat_us": hb_us, "rollback_restore_ms": restore_ms}


def resil_cli(directory: str) -> dict:
    """Through the CLI on the card: the chaos matrix's five rows at
    income-8's full width, beside it a diverging run under supervise (exit
    3, not restarted), then alone a supervised SIGKILL restart timed from
    the killed child's last heartbeat to the restarted child's first."""
    import subprocess
    cli = [sys.executable, "-m", "fedtpu_torch.cli"]
    wd = os.path.join(directory, "chaos")
    # The diverging run is timed by nothing: it runs beside the matrix.
    ev = os.path.join(directory, "diverge.jsonl")
    diverge = subprocess.Popen(cli + [
        "supervise", "--max-restarts", "2", "--events", ev, "--quiet", "--",
        "run", "--learning-rate", "1e38", "--rounds", "5",
        "--synthetic-rows", "10000", "--quiet", "--json"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.perf_counter()
    # The five rows as two chaos children side by side (each with its own
    # baseline), to keep the script inside its time limit.
    procs = [subprocess.Popen(cli + [
        "chaos", "--scenarios", names, "--platform", "default",
        "--num-clients", "8", "--hidden-sizes", "50,200",
        "--synthetic-rows", "10000", "--quiet", "--json", "--workdir",
        f"{wd}{i}", "--keep-artifacts"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, names in enumerate(("sigkill,preempt",
                                   "nan_rollback,dropout,straggler"))]
    rows = {}
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"chaos rc {proc.returncode}: "
              f"{out[-1500:]} {err[-1500:]}")
        report = json.loads(out.strip().splitlines()[-1])
        check(report["ok"], f"chaos: {report}")
        rows.update({r["scenario"]: r for r in report["scenarios"]})
    chaos_s = time.perf_counter() - t0
    check(sorted(rows) == sorted(
        ("sigkill", "preempt", "nan_rollback", "dropout", "straggler")),
        f"chaos: {sorted(rows)}")
    for name in ("sigkill", "preempt"):
        check(rows[name]["history_match"] and rows[name]["restarts"] >= 1,
              f"chaos {name}: {rows[name]}")
    print("resilience chaos (CLI, card, income-8 full width): "
          + ", ".join(f"{n} ok={r['ok']} restarts={r['restarts']} "
                      f"rollbacks={r['rollbacks']}" for n, r in rows.items())
          + f" in {chaos_s:.1f} s; {CARD['smi']}", flush=True)

    rc = diverge.wait(timeout=300)
    kinds = [e["kind"] for e in read_sink(ev)]
    check(rc == 3 and kinds.count("child_start") == 1
          and "restart" not in kinds,
          f"diverging run under supervise: rc {rc}, {kinds}")
    print("resilience: a diverging run under supervise exits 3, one child, "
          "no restart", flush=True)

    hb = os.path.join(directory, "restart.hb")
    proc = subprocess.Popen(cli + [
        "supervise", "--max-restarts", "1", "--backoff", "0", "--quiet",
        "--", "run", "--rounds", "10", "--synthetic-rows", "10000",
        "--quiet", "--checkpoint-dir", os.path.join(directory, "restart"),
        "--checkpoint-every", "2", "--heartbeat", hb, "--fault-plan",
        json.dumps({"seed": 0, "faults": [
            {"kind": "process_kill", "round": 6, "signal": "SIGKILL"}]})],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    beats = []
    while proc.poll() is None:
        try:
            with open(hb) as fh:
                b = json.load(fh)
        except (OSError, ValueError):
            b = None
        if b and (not beats or beats[-1] != b):
            beats.append(b)
        time.sleep(0.002)
    check(proc.returncode == 0, f"supervised restart: rc {proc.returncode}"
          f" {proc.stderr.read()[-1500:]}")
    pids = [b["pid"] for b in beats]
    first, second = pids[0], next(p for p in pids if p != pids[0])
    killed = [b for b in beats if b["pid"] == first][-1]
    back = next(b for b in beats if b["pid"] == second
                and b["status"] == "running")
    restart_s = back["time"] - killed["time"]
    check(killed["round"] == 5 and back["restarts"] == 1,
          f"supervised restart: heartbeats {beats}")
    print(f"resilience supervised restart: {restart_s:.3f} s from the killed "
          f"child's last heartbeat (round {killed['round']}) to the "
          f"restarted child's first chunk end (round {back['round']}); "
          f"{CARD['smi']}", flush=True)
    return {"chaos_cli_s": chaos_s, "supervised_restart_s": restart_s}


def phase_resilience() -> tuple:
    """Phase (t): the resilience loop on the card (the constants above).
    Returns the launches by path and the phase's numbers."""
    import tempfile
    seconds, numbers = {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    with tempfile.TemporaryDirectory() as directory:
        base, base_launches = resil_run(resil_config(directory, "base"))
        check(base.rounds_run == RESIL_ROUNDS and not base.diverged,
              f"resilience baseline: {base.rounds_run} rounds")
        by_path = resil_faults(directory, base)
        by_path["income-8 R=10 resilience baseline"] = base_launches
        lap("faults")
        numbers.update(resil_drain_and_corrupt(directory, base))
        lap("drain, corrupt, heartbeat")
        numbers.update(resil_numbers(directory))
        lap("numbers")
        numbers.update(resil_cli(directory))
        lap("CLI")
    print(f"phase (t) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


# ------------------------------------------ (u) fuzz, check and the fleets
# The rest of the resilience loop on the card: the fuzz corpus and sampled
# campaigns at fedtpu's replay frame (FuzzConfig's defaults: 8 rounds, 32
# users, 24 arrivals a round, 2 gateways, cohort 8, hidden (8,)), check's
# probe with its folds, and chaos's six fleet rows at chaos.py's constants
# (their gateways at ServingConfig's defaults: cohort 8, hidden (16, 8),
# 256 rows).
GANG_FUZZ_BUDGET = 25
GANG_FUZZ_SAME = 8          # the first sampled campaigns held card vs CPU
# A screen decision that differs card vs CPU must sit this close to its
# threshold (relative), on one device or the other.
GANG_EDGE_MARGIN = 1e-5
# The six fleet rows, as two chaos children side by side (the gateway and
# poisoning rows, the wire rows): ~100 s each alone on the card.
GANG_ROWS = (("mp_gateway_kill", "mp_store_shard_kill",
              "mp_poison_campaign"),
             ("mp_net_partition", "mp_slow_gateway", "mp_torn_frame"))
GANG_CHECK_ROUNDS = 20


def gang_campaign(spec, device: str) -> tuple:
    """One campaign through the in-process gang on ``device`` with every
    launch count set to 0 just before it and read just after; also each
    member's screened ticks (``run_campaign(screen_stats=)``). Returns
    (result, launches, screen stats, seconds)."""
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.resilience.fuzz import run_campaign
    stats = {}
    if device == "cuda":
        torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_campaign(spec, device=device, screen_stats=stats)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, dict(ck.LAUNCHES), stats, time.perf_counter() - t0


def gang_same_or_edge(label: str, card: tuple, cpu: tuple) -> dict:
    """A campaign card vs CPU: equal wire lines and verdict artifacts, or
    else every member's stream of screen decisions equal up to its first
    difference, which must be a decision within GANG_EDGE_MARGIN of its
    threshold on one device (later differences follow from it: the
    member's state diverged there). Prints each differing decision's
    statistics on both. Returns {"equal", "edges"}."""
    a, b = card[0], cpu[0]
    if a["lines"] == b["lines"] and a["artifact"] == b["artifact"]:
        return {"equal": True, "edges": []}
    edges = []
    for g in sorted(set(card[2]) | set(cpu[2])):
        ta, tb = card[2].get(g, []), cpu[2].get(g, [])
        first = next((i for i, (x, y) in enumerate(zip(ta, tb))
                      if (x["tick"], x["slots"], x["screened"])
                      != (y["tick"], y["slots"], y["screened"])), None)
        if first is None:
            check(len(ta) == len(tb), f"{label}: member {g} screened "
                  f"{len(ta)} ticks on the card, {len(tb)} on the CPU, "
                  "with no decision differing")
            continue
        x, y = ta[first], tb[first]
        check(x["tick"] == y["tick"] and x["slots"] == y["slots"],
              f"{label}: member {g}'s tick {x['tick']} differs card vs CPU "
              "before any screen decision does")
        for k, (sa, sb) in enumerate(zip(x["screened"], y["screened"])):
            if sa == sb:
                continue
            ca, cb = x["stats"][k], y["stats"][k]
            margin = min(ca["margin"], cb["margin"])
            edges.append({"member": g, "tick": x["tick"],
                          "slot": x["slots"][k], "card": ca, "cpu": cb,
                          "margin": margin})
            print(f"{label}: member {g} tick {x['tick']} slot "
                  f"{x['slots'][k]} screened {sa} on the card, {sb} on the "
                  f"CPU: norm {ca['norm']:.9g} / {cb['norm']:.9g} against "
                  f"limit {ca['limit']:.9g} / {cb['limit']:.9g}, cos "
                  f"{ca['cos']:.9g} / {cb['cos']:.9g} against "
                  f"{ca['cos_min']}; relative margin {margin:.3e}",
                  flush=True)
    check(edges and all(e["margin"] < GANG_EDGE_MARGIN for e in edges),
          f"{label}: card and CPU differ ({a['artifact'][-1]} vs "
          f"{b['artifact'][-1]}) beyond screen decisions within "
          f"{GANG_EDGE_MARGIN} of their threshold: {edges}")
    return {"equal": False, "edges": edges}


def gang_corpus() -> tuple:
    """Both corpus campaigns on the card twice (bitwise) and on the CPU
    (equal, or edge decisions only), every oracle passing; the golden
    printed, not gated (this machine's numpy draws another Zipf trace)."""
    from fedtpu_torch.resilience.fuzz import DEFAULT_CORPUS_DIR, Campaign
    root = os.path.dirname(os.path.abspath(__file__))
    launches, numbers = {}, {}
    for name in ("stale_tail", "torn_ack_short_write"):
        spec = Campaign.load(os.path.join(root, DEFAULT_CORPUS_DIR,
                                          f"{name}.json"))
        card = gang_campaign(spec, "cuda")
        again = gang_campaign(spec, "cuda")
        cpu = gang_campaign(spec, "cpu")
        res = card[0]
        check(res["ok"], f"corpus {name} on the card: {res['failed']}")
        check(res["lines"] == again[0]["lines"]
              and res["artifact"] == again[0]["artifact"]
              and card[1] == again[1],
              f"corpus {name}: two card runs differ")
        same = gang_same_or_edge(f"corpus {name}", card, cpu)
        with open(os.path.join(root, DEFAULT_CORPUS_DIR,
                               f"{name}.golden.jsonl")) as fh:
            golden = fh.read().splitlines() == res["artifact"]
        launches[f"fuzz corpus {name}"] = card[1]
        numbers[name] = {"card_s": card[3], "card_again_s": again[3],
                         "cpu_s": cpu[3], "equal_cpu": same["equal"],
                         "edges": same["edges"], "golden": golden}
        print(f"fuzz corpus {name}: every oracle passes; two card runs "
              f"bitwise; card vs CPU {'equal' if same['equal'] else 'edge'}"
              f"; golden {golden} (not gated); {res['artifact'][-1]}; "
              f"card {card[3]:.3f} s, {again[3]:.3f} s, CPU {cpu[3]:.3f} s"
              f"; launches {card[1]}; {CARD['smi']}", flush=True)
    return launches, numbers


def gang_sampled() -> tuple:
    """The first GANG_FUZZ_SAME campaigns of fuzz seed 0 on the card and on
    the CPU, under the edge rule. Returns the card's summed launches, each
    campaign's card verdict, and the per-campaign seconds."""
    from fedtpu_torch.resilience.fuzz import sample_campaign
    total = {}
    verdicts, secs = [], []
    for i in range(GANG_FUZZ_SAME):
        c = sample_campaign(0, i)
        card = gang_campaign(c, "cuda")
        cpu = gang_campaign(c, "cpu")
        gang_same_or_edge(f"fuzz campaign {c.name}", card, cpu)
        for k, v in card[1].items():
            total[k] = total.get(k, 0) + v
        verdicts.append((c.name, card[0]["ok"], card[0]["failed"],
                         card[0]["summary"]["fired"]))
        secs.append((card[3], cpu[3]))
    print(f"fuzz seed 0, campaigns 0..{GANG_FUZZ_SAME - 1}: card vs CPU "
          f"equal or edge-only; ok {[v[1] for v in verdicts]}; s card / CPU "
          f"{[(round(a, 3), round(b, 3)) for a, b in secs]}; launches "
          f"{total}; {CARD['smi']}", flush=True)
    return total, verdicts, secs


def gang_fuzz_cli_check(proc, verdicts: list) -> dict:
    """``fuzz --budget 25 --seed 0 --json``'s report: every campaign passed
    or was shrunk to a reproducer, and its first campaigns' verdicts are
    the in-process card runs'."""
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"fuzz CLI rc {proc.returncode}: "
          f"{out[-1500:]} {err[-1500:]}")
    report = json.loads(out.strip().splitlines()[-1])
    rows = report["rows"]
    check(report["ok"] and report["campaigns"] == GANG_FUZZ_BUDGET
          and all(r["ok"] or "minimized" in r for r in rows),
          f"fuzz CLI: {report}")
    for (name, ok, failed, fired), r in zip(verdicts, rows):
        check((r["name"], r["ok"], r["failed"], r["fired"])
              == (name, ok, failed, fired),
              f"fuzz CLI {name}: {r} against the in-process card run")
    return {"passed": report["passed"], "failed": report["failed"],
            "shrunk": [r["name"] for r in rows if "minimized" in r]}


def gang_check(directory: str) -> dict:
    """``check --json --transfer-guard disallow`` through the CLI on the
    card, folding the timeline sim (pinned arrivals: gated) and a probe of
    a live two-gateway fleet; then in process the armed window's s/round
    and the negative control: a recapture inside an armed sentinel reads
    > 0."""
    from fedtpu_torch.analysis.check import run_check
    from fedtpu_torch.analysis.guards import RecompileSentinel
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel.round import capture_round_step, warm_up_round
    from fedtpu_torch.serving.loadgen import read_port_file
    from fedtpu_torch.serving.protocol import gateway_port_file
    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "fedtpu_torch.cli"]
    base = os.path.join(directory, "check-fleet")
    fleet = [subprocess.Popen(cli + [
        "gateway", "--num-gateways", "2", "--gateway-index", str(g),
        "--port-file", base, "--quiet"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for g in range(2)]
    try:
        for g in range(2):
            read_port_file(gateway_port_file(base, g), timeout=300)
        t0 = time.perf_counter()
        out = subprocess.run(cli + [
            "check", "--json", "--transfer-guard", "disallow", "--rounds",
            str(GANG_CHECK_ROUNDS), "--timeline-sim",
            os.path.join(root, "tests", "goldens", "timeline_sim.jsonl"),
            "--gateway-probe", base, "--gateway-count", "2"],
            capture_output=True, text=True, timeout=600, cwd=root)
        cli_s = time.perf_counter() - t0
    finally:
        for p in fleet:
            p.terminate()
        rcs = [p.wait(timeout=120) for p in fleet]
    check(out.returncode == 0, f"check CLI rc {out.returncode}: "
          f"{out.stdout[-1500:]} {out.stderr[-1500:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    check(rep["ok"] and rep["recompiles"] == 0 and rep["backend"] == "cuda"
          and rep["transfer_guard_applies"] and rep["timeline_sim"]["ok"]
          and [r["ok"] for r in rep["gateway_probe"]] == [True, True],
          f"check CLI: {rep}")
    check(all(rc in (0, 75) for rc in rcs), f"check fleet exits {rcs}")
    mine = run_check(rounds=GANG_CHECK_ROUNDS, transfer="disallow",
                     nans=True)
    check(mine["ok"] and mine["recompiles"] == 0,
          f"check in process: {mine}")
    from fedtpu_torch.config import get_preset
    cfg = get_preset("income-8")
    exp = build_experiment(cfg.replace(data=dataclasses.replace(
        cfg.data, csv_path=None, synthetic_rows=512)), device="cuda")
    step = exp.make_step(1)
    warm_up_round(step, exp.state, exp.batch)
    capture_round_step(step, exp.state, exp.batch)
    sentinel = RecompileSentinel(label="negative control")
    with sentinel.armed():
        capture_round_step(step, exp.state, exp.batch)
    check(sentinel.count > 0, "check's negative control: a recapture "
          f"inside the armed window read {sentinel.count}")
    print(f"check (CLI, card, --transfer-guard disallow, {GANG_CHECK_ROUNDS}"
          f" rounds): recompiles {rep['recompiles']}, timeline sim "
          f"{rep['timeline_sim']['reason']}, probe "
          f"{[r['ok'] for r in rep['gateway_probe']]} of a live two-gateway"
          f" fleet, {cli_s:.1f} s; in process (with --debug-nans) armed "
          f"{mine['armed_s_per_round']:.3e} s/round; negative control: a "
          f"recapture reads {sentinel.count}; {CARD['smi']}", flush=True)
    return {"armed_s_per_round": mine["armed_s_per_round"],
            "cli_armed_s_per_round": rep["armed_s_per_round"],
            "cli_s": cli_s, "negative_control": sentinel.count}


def gang_kernel_rows() -> tuple:
    """K2/K3 (and K1's sum mode, not at the fuzz shape: phase (q) times it
    at (8, 74)) at the shapes of the two engines this phase drives: the
    gateway rows' (ServingConfig's defaults: cohort 8, 6 -> 16 -> 8 -> 2,
    256 rows, (8, 266)) and the fuzz gang's (cohort 8, 6 -> 8 -> 2, 64
    rows), each engine fed a poisoned stream until its screen is warm.
    Returns the launches of each engine's run and, by shape, the rows."""
    from fedtpu_torch.config import FuzzConfig, ServingConfig
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.resilience.fuzz import Campaign, _serving_config
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    fuzz_cfg = _serving_config(Campaign(name="rows", seed=0,
                                        poison_fraction=0.25), FuzzConfig())
    launches, out = {}, {}
    for tag, cfg in (("gateway_rows", ServingConfig(screen=True)),
                     ("fuzz_rows", fuzz_cfg)):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        eng = ServingEngine(cfg, device="cuda", registry=MetricsRegistry())
        rows = [[u % 40, 0.05 * u, 0.1]
                + ([None, 10.0] if u % 40 < 8 else []) for u in range(900)]
        serve_replay(eng, rows)
        eng.eval_accuracy()
        torch.cuda.synchronize()
        launches[f"{tag[:-5]}-shape engine"] = dict(ck.LAUNCHES)
        out[tag] = serve_kernel_rows(eng)
        print(f"{tag[:-5]}-shape engine (cohort {cfg.cohort}, hidden "
              f"{cfg.model_hidden}, {cfg.data_rows} rows, screened, 900 "
              f"arrivals, {eng.tick_count} ticks): launches "
              f"{launches[f'{tag[:-5]}-shape engine']}; {CARD['smi']}",
              flush=True)
        if tag == "gateway_rows":
            out[tag]["weighted_sum_clients"] = k1_sum_row(
                torch.device("cuda"), eng.state["params"].shape[1],
                "the gateway rows'")
    return launches, out


def gang_chaos_check(procs: list, t0: float) -> dict:
    """The six fleet rows' reports (one a chaos child): every row ok; each
    row's oracles, wall seconds and restart (mp_gateway_kill: the gang's
    relaunch to both gateways serving) or failover (mp_store_shard_kill:
    the SIGKILL to the survivor's adopt ack, each pass) printed."""
    rows = {}
    for proc, names in zip(procs, GANG_ROWS):
        out, err = proc.communicate(timeout=1100)
        check(proc.returncode == 0, f"chaos {names} rc {proc.returncode}: "
              f"{out[-2000:]} {err[-2000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        mine = {r["scenario"]: r for r in report["scenarios"]}
        check(report["ok"] and sorted(mine) == sorted(names),
              f"chaos fleet rows: {report}")
        rows.update(mine)
    total_s = time.perf_counter() - t0
    times = {}
    for name, row in rows.items():
        names = [o["oracle"] for o in row.get("oracles") or []]
        times[name] = {k: row[k] for k in ("seconds", "restart_s",
                                           "failover_s") if k in row}
        print(f"chaos {name}: ok, oracles {names or ['history_match']}; "
              + ", ".join(f"{k} {row[k]}" for k in (
                  "gang_restarts", "retried", "duplicate_drops",
                  "lost_acked", "lost_updates", "slo_burn", "spooled",
                  "replayed", "quarantined", "accuracy_defended",
                  "accuracy_undefended", "accuracy_clean", "net_faults",
                  "netlog_match") if k in row)
              + f"; {times[name]}", flush=True)
    print(f"chaos fleet rows (CLI, card): {total_s:.1f} s in all; "
          f"{CARD['smi']}", flush=True)
    return {"total_s": total_s, "rows": times}


def phase_gang() -> tuple:
    """Phase (u): the rest of the resilience loop on the card (the
    constants above). The chaos fleet rows (two children) and the fuzz
    CLI run as children from the start, beside the in-process corpus, the
    sampled
    campaigns card vs CPU, the check and the gateway-shape kernel rows.
    Returns the launches by path, the kernel rows and the phase's
    numbers."""
    import tempfile
    seconds, numbers = {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "fedtpu_torch.cli"]
    with tempfile.TemporaryDirectory() as directory:
        t_chaos = time.perf_counter()
        chaos = [subprocess.Popen(cli + [
            "chaos", "--scenarios", ",".join(names), "--platform",
            "default", "--json", "--quiet", "--workdir",
            os.path.join(directory, f"chaos{i}"), "--timeout", "540"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i, names in enumerate(GANG_ROWS)]
        t_fuzz = time.perf_counter()
        fuzz = subprocess.Popen(cli + [
            "fuzz", "--budget", str(GANG_FUZZ_BUDGET), "--seed", "0",
            "--json"], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            by_path, numbers["corpus"] = gang_corpus()
            lap("corpus")
            launches, verdicts, numbers["sampled_s"] = gang_sampled()
            by_path[f"fuzz seed 0, campaigns 0..{GANG_FUZZ_SAME - 1}"] = \
                launches
            lap("sampled")
            numbers["check"] = gang_check(directory)
            lap("check")
            engines, rows = gang_kernel_rows()
            by_path.update(engines)
            lap("kernel rows")
            numbers["fuzz_cli"] = gang_fuzz_cli_check(fuzz, verdicts)
            numbers["fuzz_cli"]["s"] = time.perf_counter() - t_fuzz
            print(f"fuzz --budget {GANG_FUZZ_BUDGET} --seed 0 (CLI, card): "
                  f"{numbers['fuzz_cli']}; {CARD['smi']}", flush=True)
            lap("fuzz CLI (its wait)")
            numbers["chaos"] = gang_chaos_check(chaos, t_chaos)
            lap("chaos (its wait)")
        finally:
            for p in chaos + [fuzz]:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    print(f"phase (u) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, rows, numbers


# ----------------------------------------------------- (v) training gang
# The training gang on the one card (``fedtpu_torch.parallel.multihost``):
# members share the H100 over gloo (NCCL refuses two ranks on one device).
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_GANG_ROUNDS = 60       # income-8 early-stops before
TRAIN_GANG_ASYNC_TICKS = 30
TRAIN_GANG_CKPT_EVERY = 5
TRAIN_GANG_DRAIN_ROUND = 12  # 1-based: the SIGTERM to every member
TRAIN_GANG_TIMEOUT = 60.0    # the members' collective watchdog
TRAIN_GANG_PARAM_TOL = 1e-5
# Every later checkpoint: float32 reassociation (psum) and a batched GEMM's
# batch count (the ring's members train 4 clients, one process 8 or 32)
# carried on by Adam, measured at 3.6e-5 by round 40; a wrong fold or a
# lost round moves the params by ~1e-2.
TRAIN_GANG_DRIFT_TOL = 1e-4
# The four training-gang chaos rows, two chaos children side by side.
TRAIN_GANG_CHAOS = (("mp_kill_worker", "mp_kill_coordinator"),
                    ("mp_hang", "mp_preempt"))
K4_GANG_SHAPE = (8, 11_353)  # income-32-noniid's ring payload, 8 shards
# Phase (v)'s uninterrupted gangs' histories (psum of 2, ring of 2 x 4),
# which phase (w) takes as its gang baselines when (v) ran first.
GANG_BASELINES: dict = {}


def gang_member() -> None:
    """A gang member of phases (v)-(y): the port's CLI on ``sys.argv[1:]``,
    then its kernel launches into ``$GANG_LAUNCHES/launches.<restart>.<i>``
    and its result's ``result_dump`` into ``result.<restart>.<i>``."""
    from fedtpu_torch.cli import main as cli_main
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration import loop
    run, results = loop.run_experiment, []

    def recorded(*args, **kw):
        results.append(run(*args, **kw))
        return results[-1]
    loop.run_experiment = recorded
    try:
        rc = cli_main(sys.argv[1:])
    except SystemExit as e:
        # A member parked by an elastic shrink leaves with 76.
        rc = e.code
    tag = f"{os.environ['FEDTPU_RESTARTS']}.{os.environ['FEDTPU_PROCESS_ID']}"
    path = os.path.join(os.environ["GANG_LAUNCHES"], f"launches.{tag}")
    with open(path, "w") as fh:
        json.dump(dict(ck.LAUNCHES, exit_code=rc), fh)
    if results:
        # The member's result (phase (y) reads it).
        with open(os.path.join(os.environ["GANG_LAUNCHES"],
                               f"result.{tag}"), "w") as fh:
            json.dump(result_dump(results[-1]), fh)
    sys.exit(rc)


def gang_cli(argv: list, n: int, directory: str, shards: int = 0,
             max_restarts: int = 0) -> dict:
    """``supervise --num-processes n -- <argv>`` as real child processes
    on the card (``supervise_gang``, each member ``gang_member``), with
    ``FEDTPU_SHARDS_PER_PROCESS = shards`` when given. Returns the rc, the
    wall seconds, process 0's summary and each member's launches (the
    last life's)."""
    os.makedirs(directory, exist_ok=True)
    code = ("import sys; from fedtpu_torch.resilience.supervisor import "
            f"supervise_gang; sys.exit(supervise_gang({argv!r}, {n}, "
            f"max_restarts={max_restarts}, grace=10, backoff_base=0.0, "
            "verbose=False, _cmd_prefix=[sys.executable, '-c', 'import "
            "chip_smoke as cs; cs.gang_member()']))")
    env = dict(os.environ, GANG_LAUNCHES=directory)
    if shards:
        env["FEDTPU_SHARDS_PER_PROCESS"] = str(shards)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    return gang_outcome(argv, n, directory, out.returncode, out.stdout,
                        out.stderr, time.perf_counter() - t0)


def gang_outcome(argv: list, n: int, directory: str, rc: int, stdout: str,
                 stderr: str, wall: float) -> dict:
    """A finished gang's rc (0 or a failed check), its wall seconds,
    process 0's summary and each member's launches (the last life's)."""
    check(rc == 0, f"gang of {n} {argv[:6]}: rc {rc}: {stdout[-2000:]} "
          f"{stderr[-3000:]}")
    summary = [json.loads(line) for line in stdout.splitlines()
               if line.startswith("{") and "rounds_run" in line]
    check(len(summary) == 1, f"gang of {n}: process 0 prints one summary, "
          f"got {stdout[-1500:]}")
    restarts = max(int(f.split(".")[1]) for f in os.listdir(directory)
                   if f.startswith("launches."))
    launches = []
    for i in range(n):
        with open(os.path.join(directory, f"launches.{restarts}.{i}")) as fh:
            launches.append(json.load(fh))
    return {"wall_s": wall, "summary": summary[0], "launches": launches,
            "restarts": restarts}


def gang_argv(directory: str, preset: str, rounds: int, *extra) -> list:
    return ["run", "--preset", preset, "--csv", "", "--synthetic-rows",
            "10000", "--rounds", str(rounds), "--checkpoint-dir",
            os.path.join(directory, "ck"), "--checkpoint-every",
            str(TRAIN_GANG_CKPT_EVERY), "--metrics-jsonl",
            os.path.join(directory, "m.jsonl"), "--events",
            os.path.join(directory, "ev.jsonl"), "--collective-timeout",
            str(TRAIN_GANG_TIMEOUT), "--quiet", "--json", *extra]


def one_process_run(directory: str, spec: tuple, shards: int = 0) -> dict:
    """The CLI config ``gang_argv(directory, *spec)`` run in this process
    on the card over ``shards`` mesh shards when given, its launches
    counted from zero: the gang's oracle."""
    from fedtpu_torch.cli import build_parser, config_from_args
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.orchestration.loop import run_experiment
    os.makedirs(directory, exist_ok=True)
    cfg = config_from_args(build_parser().parse_args(
        gang_argv(directory, *spec)))
    if shards:
        cfg = with_run(cfg, mesh_devices=shards)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    res = run_experiment(cfg, verbose=False, device="cuda")
    torch.cuda.synchronize()
    return {"result": res, "launches": dict(ck.LAUNCHES),
            "dir": directory}


def gang_history(path: str) -> dict:
    from fedtpu_torch.resilience.chaos import _history
    return _history(path)


def member_rounds(ev: str, n: int) -> list:
    """Each member's ``round`` events (round, accuracy, loss_mean) from
    process 0's sink and the peers' ``.p<i>``."""
    out = []
    for i in range(n):
        rows = read_sink(ev if i == 0 else f"{ev}.p{i}")
        # A diverged round's NaN loss mean compares as "nan" (one NaN is
        # never equal to another).
        out.append([(e["round"], e["payload"]["accuracy"],
                     e["payload"]["loss_mean"]
                     if math.isfinite(e["payload"]["loss_mean"]) else "nan")
                    for e in rows if e["kind"] == "round"])
    return out


def gang_state(ck_dir: str, step: int, n: int) -> dict:
    """The gang's round ``step``: every member's part, its tensors
    concatenated over the clients in member order."""
    from fedtpu_torch.orchestration.checkpoint import part_name
    parts = [torch.load(os.path.join(ck_dir, f"round_{step:06d}",
                                     part_name(i, n)), weights_only=True)
             for i in range(n)]
    return {k: torch.cat([p[k] for p in parts]) for k in ("params",
                                                          "anchors")
            if k in parts[0]}


def gang_vs_one(label: str, gang: dict, one: dict, directory: str, n: int,
                psum: bool, kernels: tuple) -> dict:
    """A gang's run against the one-process card run of the same config:
    the same stop round; the history within TRAIN_GANG_PARAM_TOL; every
    member's round events equal; the members' slots within
    TRAIN_GANG_PARAM_TOL of one process's at the first checkpoint both
    wrote and within TRAIN_GANG_DRIFT_TOL at every one, a ``psum``
    member's slots all one global; each member's launches of ``kernels``
    one process's."""
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    res = one["result"]
    hist = gang_history(os.path.join(directory, "m.jsonl"))
    mine = gang_history(os.path.join(one["dir"], "m.jsonl"))
    check(sorted(hist) == sorted(mine) and max(hist) == res.rounds_run,
          f"{label}: rounds {max(hist)} vs one process's {res.rounds_run}")
    hist_err = max(abs(hist[r][g][k] - mine[r][g][k])
                   for r in hist for g in ("client_mean", "pooled")
                   for k in hist[r][g])
    check(hist_err <= TRAIN_GANG_PARAM_TOL,
          f"{label}: history {hist_err:.3g} from one process's")
    rounds = member_rounds(os.path.join(directory, "ev.jsonl"), n)
    check(all(r == rounds[0] for r in rounds) and len(rounds[0]) > 0,
          f"{label}: the members' round events differ")
    steps = sorted(set(complete_steps(os.path.join(directory, "ck")))
                   & set(complete_steps(os.path.join(one["dir"], "ck"))))
    errs = {}
    for step in steps:
        got = gang_state(os.path.join(directory, "ck"), step, n)
        want = torch.load(os.path.join(one["dir"], "ck",
                                       f"round_{step:06d}", "state"),
                          weights_only=True)
        errs[step] = max(float((got[k] - want[k]).abs().max())
                         for k in got)
        check(errs[step] <= TRAIN_GANG_DRIFT_TOL,
              f"{label}: round {step} state {errs[step]:.3g} from one "
              "process's")
    # The psum members add their partial sums in another order than one
    # process's K1 (float32 reassociation), the ring's train 4 clients a
    # batch where one process trains 8 (a batched GEMM's bits on the card
    # can depend on its batch count); Adam carries the difference on.
    check(errs[steps[0]] <= TRAIN_GANG_PARAM_TOL,
          f"{label}: round {steps[0]} params {errs[steps[0]]:.3g} from one "
          "process's")
    if "anchors" not in got and psum:
        check(bool((got["params"] == got["params"][:1]).all()),
              f"{label}: a member's slots hold different globals")
    for i, mem in enumerate(gang["launches"]):
        check(all(mem[k] == one["launches"][k] for k in kernels),
              f"{label}: member {i} launches {mem} vs one process's "
              f"{one['launches']}")
    s_gang = gang["summary"]["mean_sec_per_round"]
    s_one = res.summary()["mean_sec_per_round"]
    print(f"{label}: stop round {res.rounds_run} (one process the same), "
          f"history within {hist_err:.3g}, state drift by checkpoint "
          f"{errs}, members' round events equal; s/round gang "
          f"{s_gang:.4e} vs "
          f"one process {s_one:.4e} ({s_gang / s_one:.2f}x); launches per "
          f"member {[{k: m[k] for k in kernels} for m in gang['launches']]}"
          f" (one process {({k: one['launches'][k] for k in kernels})}); "
          f"gang wall {gang['wall_s']:.1f} s; {CARD['smi']}", flush=True)
    return {"rounds": res.rounds_run, "history_err": hist_err,
            "state_err": errs, "s_round_gang": s_gang, "s_round_one": s_one,
            "wall_s": gang["wall_s"],
            "launches": [{k: m[k] for k in kernels}
                         for m in gang["launches"]]}


def k4_gang_member() -> None:
    """One member of the K4 check (``python -c "import chip_smoke as cs;
    cs.k4_gang_member()" STORE N RANK``): joins a gang of N on the card
    through the file store, exchanges K4_GANG_SHAPE's rows over CUDA IPC
    (``GangExchange``), and prints one JSON line: its rows against the
    one-process K4 and the plain version (bitwise), K4's time (CUDA events
    around the launch), the barrier's and a psum collective's host time,
    ``stack.sum(0)``'s time, its launches."""
    store, n, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.parallel import multihost
    from fedtpu_torch.parallel.mesh import make_mesh
    from fedtpu_torch.parallel.ring import GangExchange
    gang = multihost.initialize(f"file://{store}", n, rank)
    dev = gang.device
    s, p = K4_GANG_SHAPE
    mesh = make_mesh(s, s, dev, gang=gang)
    ex = GangExchange("ring", gang, mesh, p, dev)
    full = torch.randn(s, p, generator=torch.Generator().manual_seed(7)
                       ).to(dev)
    lo, hi = ex.lo, ex.hi
    ck.reset_launch_counts()
    ex.stage(full[lo:hi])
    ex.host()
    rows = ex.reduce()
    ex.after()
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    one = ck.ring_all_reduce_sum(full)[lo:hi]
    plain = ck.ring_all_reduce_sum_reference(full)[lo:hi]
    same = bool(torch.equal(rows, one)) and bool(torch.equal(rows, plain))
    err = float((rows - plain).abs().max())
    # Every member's rows stay put while each times its own launches.
    # One member at a time, the others at the barrier: processes sharing
    # the card time-slice it.
    for r in range(n):
        gang.barrier()
        if r == rank:
            kernel_ms = time_ms(lambda: ck.ring_all_reduce_sum_rows(
                ex.blocks, lo, hi))
            plain_ms = time_ms(lambda: ck.ring_all_reduce_sum_reference(
                full))
            library_ms = time_ms(lambda: full.sum(dim=0))
    gang.barrier()
    t0 = time.perf_counter()
    for _ in range(50):
        gang.barrier()
    barrier_ms = (time.perf_counter() - t0) / 50 * 1e3
    # A psum round's exchange of as many floats: the device-to-host copy,
    # the gather and the copy back.
    psum = GangExchange("psum", gang, mesh, p, dev)
    psum.stage(full[0])
    t0 = time.perf_counter()
    for _ in range(50):
        psum.host()
    collective_ms = (time.perf_counter() - t0) / 50 * 1e3
    nbytes = 4 * (s * p + (hi - lo) * p)
    bound, by = bound_ms(nbytes, (s - 1) * (hi - lo) * p)
    ex.close()
    multihost.shutdown()
    print(json.dumps({"rank": rank, "backend": gang.backend,
                      "bitwise": same, "max_abs_err": err,
                      "rows": [lo, hi], "ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound, "bound_by": by,
                      "barrier_host_ms": barrier_ms,
                      "psum_collective_host_ms": collective_ms,
                      "launches": launches}), flush=True)


def k4_gang_check(directory: str) -> dict:
    """K4 across processes at K4_GANG_SHAPE as 2 members x 4 shards and 4
    x 2, on the one card: every member's rows bitwise the one-process K4
    and the plain version."""
    out = {}
    for n in (2, 4):
        store = os.path.join(directory, f"k4.{n}.store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as cs; "
             "cs.k4_gang_member()", store, str(n), str(r)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        rows = []
        for proc in procs:
            o, e = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"K4 gang member rc "
                  f"{proc.returncode}: {o[-1000:]} {e[-2000:]}")
            rows.append(json.loads(o.strip().splitlines()[-1]))
        check(all(r["bitwise"] for r in rows), f"K4 across {n} processes "
              f"differs from the one-process K4: {rows}")
        check(all(r["launches"]["ring_all_reduce_sum"] == 1 for r in rows),
              f"K4 across {n} processes: launches {rows}")
        key = f"{n} members x {K4_GANG_SHAPE[0] // n} shards"
        out[key] = {k: statistics.median(r[k] for r in rows) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "barrier_host_ms",
            "psum_collective_host_ms")}
        out[key].update(bound_by=rows[0]["bound_by"], max_abs_err=max(
            r["max_abs_err"] for r in rows), backend=rows[0]["backend"],
            per_member_ms=[r["ms"] for r in rows])
        print(f"K4 across processes, {key} at {K4_GANG_SHAPE} "
              f"({rows[0]['backend']}, CUDA IPC): bitwise the one-process "
              f"K4 and the plain version; {json.dumps(out[key])}; "
              f"{CARD['smi']}", flush=True)
    return out


def train_gang_member_rows() -> dict:
    """K1's sum mode and K2 at a training-gang member's shapes, on the
    card with nothing else on it: income-8's 8 clients split over 2 and 4
    members. K1's sum mode at (4, 11,352) and (2, 11,352) (a psum member's
    partial sum a round, an async member's a tick) against its plain
    version (``k1_sum_row``); K2 over the member's block of income-8's own
    packed batch (clients 0-3 and 0-1) with random params, its counts the
    plain version's except on near-tie rows; each timed beside its plain
    version, with its bound."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.orchestration.loop import build_experiment
    dev = torch.device("cuda")
    batch = build_experiment(main_path_config(), device="cpu").batch
    gen = torch.Generator().manual_seed(9)
    out = {"weighted_sum_clients": {}, "fused_eval_confusion": {}}
    for members in (2, 4):
        c = batch["x"].shape[0] // members
        tag = f"member of {members}"
        out["weighted_sum_clients"][tag] = k1_sum_row(
            dev, param_count(INCOME_DIMS), f"a training-gang {tag}", rows=c)
        out["fused_eval_confusion"][tag] = k2_member_row(
            batch, c, f"a training-gang {tag}", gen)
    return out


def k2_member_row(batch: dict, c: int, tag: str, gen) -> dict:
    """K2 over the first ``c`` clients of ``batch`` (a member's block of
    its packed rows) with random params at income width, on the card:
    its counts the plain version's except on near-tie rows, timed beside
    it, with its bound."""
    from fedtpu_torch.models.mlp import mlp_apply, mlp_init, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    dev = torch.device("cuda")
    dims, k = INCOME_DIMS, INCOME_DIMS[-1]
    x, y, mask = (batch[key][:c].to(dev) for key in ("x", "y", "mask"))
    params = torch.stack([mlp_init(gen, dims[0], dims[1:-1], k)
                          for _ in range(c)]).to(dev)
    conf = ck.fused_eval_confusion(params, dims, x, y, mask, k)
    ref = ck.fused_eval_confusion_reference(params, dims, x, y, mask, k)
    ties = near_tie_rows(mlp_apply(unflatten(params, dims), x)) & (mask > 0)
    moved = (conf - ref).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties.sum(dim=1)).all()),
          f"K2 at {tag} {tuple(y.shape)}: counts differ on "
          f"{moved.tolist()} rows per client, near ties "
          f"{ties.sum(dim=1).tolist()}")
    live = float(mask.sum())
    b, by = bound_ms(4 * (params.numel() + live * (dims[0] + 1)
                          + mask.numel() + c * k * k),
                     mlp_flops(dims, live))
    row = {"shape": f"({c}, {y.shape[1]}), {int(live)} real rows",
           "max_abs_err": float((conf - ref).abs().max()),
           "ms": time_ms(lambda: ck.fused_eval_confusion(
               params, dims, x, y, mask, k)),
           "plain_ms": time_ms(lambda: ck.fused_eval_confusion_reference(
               params, dims, x, y, mask, k)),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    print(f"time fused_eval_confusion at {tag} {row['shape']}: kernel "
          f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
          f"{b:.5f} ms ({by}); rows differing from plain "
          f"{int(moved.sum())}; {CARD['smi']}", flush=True)
    return row


def train_gang_chaos(procs: list, t0: float) -> dict:
    """The four training-gang rows' reports (two a chaos child): every
    row ok; each row's seconds and restart seconds printed."""
    rows = {}
    for proc, names in zip(procs, TRAIN_GANG_CHAOS):
        out, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"chaos {names} rc {proc.returncode}: "
              f"{out[-2000:]} {err[-2000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        mine = {r["scenario"]: r for r in report["scenarios"]}
        check(report["ok"] and sorted(mine) == sorted(names),
              f"chaos training-gang rows: {report}")
        rows.update(mine)
    times = {}
    for name, row in rows.items():
        times[name] = {k: row.get(k) for k in ("seconds", "restart_s")}
        print(f"chaos {name}: ok, history bitwise the gang baseline, "
              f"gang_restarts {row['gang_restarts']}, collective_hangs "
              f"{row['collective_hangs']}, member resumes "
              f"{row['member_resumes']}; {times[name]}", flush=True)
    total = time.perf_counter() - t0
    print(f"chaos training-gang rows (CLI, card): {total:.1f} s in all; "
          f"{CARD['smi']}", flush=True)
    return {"total_s": total, "rows": times}


def phase_train_gang() -> tuple:
    """Phase (v): the training gang on the card (the constants above).
    The four chaos rows run as two children from the start, beside the
    gangs of 2 and 4 (psum), the ring gang, the asynchronous gang, the
    drain and resume, and K4 across processes."""
    import tempfile
    numbers, seconds, by_path = {}, {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    def member_paths(label: str, gang: dict) -> None:
        for i, mem in enumerate(gang["launches"]):
            by_path[f"{label}, member {i}"] = mem

    cli = [sys.executable, "-m", "fedtpu_torch.cli"]
    k123 = ("weighted_average_clients", "fused_eval_confusion",
            "fused_mlp_forward")
    numbers["member_rows"] = train_gang_member_rows()
    lap("K1 and K2 at a member's shapes")
    with tempfile.TemporaryDirectory() as directory:
        t_chaos = time.perf_counter()
        chaos = [subprocess.Popen(cli + [
            "chaos", "--scenarios", ",".join(names), "--platform",
            "default", "--num-clients", "8", "--hidden-sizes", "50,200",
            "--synthetic-rows", "10000", "--json", "--quiet", "--workdir",
            os.path.join(directory, f"chaos{i}"), "--timeout", "540"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i, names in enumerate(TRAIN_GANG_CHAOS)]
        try:
            numbers["k4"] = k4_gang_check(directory)
            lap("K4 across processes")
            spec = ("income-8", TRAIN_GANG_ROUNDS)
            one = one_process_run(os.path.join(directory, "one-psum"), spec)
            for n in (2, 4):
                d = os.path.join(directory, f"g{n}")
                gang = gang_cli(gang_argv(d, *spec), n, d)
                numbers[f"psum x{n}"] = gang_vs_one(
                    f"income-8 psum gang of {n}", gang, one, d, n, True,
                    k123)
                if n == 2:
                    GANG_BASELINES["income-8"] = gang_history(
                        os.path.join(d, "m.jsonl"))
                member_paths(f"income-8 psum gang of {n}", gang)
            lap("psum gangs")
            d = os.path.join(directory, "ring")
            spec = ("income-32-noniid", TRAIN_GANG_ROUNDS, "--aggregation",
                    "ring")
            one = one_process_run(os.path.join(directory, "one-ring"), spec,
                                  shards=8)
            gang = gang_cli(gang_argv(d, *spec), 2, d, shards=4)
            GANG_BASELINES["income-32-noniid"] = gang_history(
                os.path.join(d, "m.jsonl"))
            numbers["ring x2"] = gang_vs_one(
                "income-32-noniid ring gang of 2 (4 shards each)", gang, one,
                d, 2, False, k123[1:] + ("ring_all_reduce_sum",))
            member_paths("income-32-noniid ring gang of 2", gang)
            lap("ring gang")
            d = os.path.join(directory, "async")
            spec = ("income-8", TRAIN_GANG_ASYNC_TICKS, "--async",
                    "--weighting", "uniform")
            one = one_process_run(os.path.join(directory, "one-async"), spec)
            gang = gang_cli(gang_argv(d, *spec), 2, d)
            numbers["async x2"] = gang_vs_one(
                "income-8 --async gang of 2", gang, one, d, 2, True, k123)
            member_paths("income-8 --async gang of 2", gang)
            lap("async gang")
            d = os.path.join(directory, "drain")
            plan = json.dumps({"seed": 0, "faults": [{
                "kind": "process_kill", "round": TRAIN_GANG_DRAIN_ROUND,
                "signal": "SIGTERM", "process_index": -1}]})
            drained = gang_cli(gang_argv(d, "income-8", TRAIN_GANG_ROUNDS,
                                         "--fault-plan", plan), 2, d,
                               max_restarts=1)
            check(drained["restarts"] == 1, f"drain: {drained['restarts']} "
                  "relaunches")
            base = os.path.join(directory, "g2")
            from fedtpu_torch.orchestration.checkpoint import complete_steps
            check(gang_history(os.path.join(d, "m.jsonl"))
                  == gang_history(os.path.join(base, "m.jsonl")),
                  "drain and resume: history differs from the "
                  "uninterrupted gang's")
            last = max(complete_steps(os.path.join(d, "ck")))
            check(last == max(complete_steps(os.path.join(base, "ck"))),
                  "drain and resume: last checkpoints differ")
            a = gang_state(os.path.join(d, "ck"), last, 2)
            b = gang_state(os.path.join(base, "ck"), last, 2)
            check(torch.equal(a["params"], b["params"]),
                  "drain and resume: params differ from the uninterrupted "
                  "gang's")
            resumes = member_rounds(os.path.join(d, "ev.jsonl"), 2)
            print(f"income-8 gang of 2 drained at round "
                  f"{TRAIN_GANG_DRAIN_ROUND - 1} by SIGTERM to every member, "
                  f"resumed by a gang of 2: history and round {last} params "
                  f"bitwise the uninterrupted gang's; wall "
                  f"{drained['wall_s']:.1f} s; {CARD['smi']}", flush=True)
            numbers["drain_resume"] = {"wall_s": drained["wall_s"],
                                       "rounds": len(resumes[0])}
            lap("drain and resume")
            numbers["chaos"] = train_gang_chaos(chaos, t_chaos)
            lap("chaos (its wait)")
        finally:
            for p in chaos:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    print(f"phase (v) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


# The elastic gang (phase (w)): a live shrink and grow-back of a training
# gang on the card, the signal path, the elastic resume and the four
# reshard and autoscale chaos rows.
ELASTIC_ROUNDS = 10          # income-8 early-stops later at 10,000 rows
ELASTIC_NOTICE = 4           # 1-based: the shrink before this round
ELASTIC_CANCEL = 6           # 1-based: the grow back before this round
ELASTIC_PACE_S = 0.25        # the signal run's straggler delay a round
ELASTIC_SIGNAL_ROUNDS = 14
ELASTIC_CHAOS = (("mp_shrink", "mp_grow"), ("mp_shrink_dead",),
                 ("mp_autoscale_preempt",))
ELASTIC_TOL = 1e-4           # TRAIN_GANG_DRIFT_TOL's per-checkpoint bar


def elastic_plan(target: int, grow: bool = True) -> str:
    faults = [{"kind": "preempt_notice", "round": ELASTIC_NOTICE,
               "target_clients": target, "process_index": 1}]
    if grow:
        faults.append({"kind": "preempt_cancel", "round": ELASTIC_CANCEL})
    return json.dumps({"seed": 0, "faults": faults})


def ckpt_state(directory: str, step: int) -> dict:
    """Round ``step`` of a run whatever wrote it (one process or a gang's
    parts): the params (and anchors), every client."""
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_raw
    raw = load_checkpoint_raw(directory, step)[0]
    return {k: raw[k] for k in ("params", "anchors") if k in raw}


def sink_numbers(ev: str) -> dict:
    """A member's reshard numbers from its sink: the reshard events, the
    move and build spans (ms), the barriers (ms), the median s/round
    before, while and after the shrink, and the graph captures it
    counted."""
    rows = read_sink(ev)
    done = [e for e in rows if e["kind"] == "reshard_done"]
    spans = {}
    for e in rows:
        if e["kind"] == "span" and e["phase"] in ("reshard_move",
                                                  "reshard_build"):
            spans.setdefault(e["phase"], []).append(e["dur_s"] * 1e3)
    counters = [e for e in rows if e["kind"] == "counters"]
    rounds = [(e["round"], e["dur_s"]) for e in rows
              if e["kind"] == "round"]
    marks = [e["round"] for e in done]

    def median(sel):
        # Round 1 (the graphs' warm-up and capture) left out.
        v = [d for r, d in rounds if r > 1 and sel(r)]
        return statistics.median(v) if v else None
    first = marks[0] + 1 if marks else None
    last = marks[1] + 1 if len(marks) > 1 else None
    return {
        "modes": [(e["payload"]["mode"], e["round"],
                   e["payload"].get("target")) for e in done],
        "begin": [e["payload"] for e in rows
                  if e["kind"] == "reshard_begin"],
        "move_ms": spans.get("reshard_move", []),
        "build_ms": spans.get("reshard_build", []),
        "barrier_ms": [{k: v * 1e3 for k, v in e["payload"]["barrier_s"]
                        .items()} for e in done],
        "graph_captures": (counters[-1]["payload"]["counters"]
                           .get("graph_captures") if counters else None),
        "s_round_before": median(lambda r: first is None or r < first),
        "s_round_shrunk": median(lambda r: first is not None and r >= first
                                 and (last is None or r < last)),
        "s_round_after": median(lambda r: last is not None and r >= last)}


def gang_baseline(directory: str, spec: tuple, shards: int) -> dict:
    """The uninterrupted gang of 2 of ``spec``'s preset: phase (v)'s (its
    gang of 2 with more rounds: the same rounds up to here, since the
    round count and the checkpoints change no round's math, nor a psum
    member's shard count), or this config's own run when (v) did not
    run."""
    if spec[0] in GANG_BASELINES:
        return GANG_BASELINES[spec[0]]
    d = os.path.join(directory, f"{spec[0]}-base")
    gang_cli(gang_argv(d, *spec), 2, d, shards=shards)
    GANG_BASELINES[spec[0]] = gang_history(os.path.join(d, "m.jsonl"))
    return GANG_BASELINES[spec[0]]


def elastic_pair(directory: str, label: str, spec: tuple, shards: int,
                 target: int, kernels: tuple) -> tuple:
    """Phase (w) 1 and 2: a gang of 2 (``shards`` shards a member) with
    the notice at ELASTIC_NOTICE and the cancel at ELASTIC_CANCEL, against
    the same gang without the plan (the rounds before the notice bitwise,
    ``gang_baseline``) and the one-process card run of the same plan over
    the same shards (every checkpoint within ELASTIC_TOL); the victim
    rejoins and both exit 0, no gang restart; the survivor captured its
    graphs twice (the gang's, the shrunk round's) and the victim once: the
    grow captures none."""
    plan = elastic_plan(target)
    d_gang, d_one = (os.path.join(directory, f"{label}-{t}")
                     for t in ("gang", "one"))
    extra = ("--checkpoint-every", "2")
    before = gang_baseline(directory, spec, shards)
    gang = gang_cli(gang_argv(d_gang, *spec, *extra, "--fault-plan", plan),
                    2, d_gang, shards=shards)
    one = one_process_run(d_one, spec + extra + ("--fault-plan", plan),
                          shards=2 * shards)
    hist = gang_history(os.path.join(d_gang, "m.jsonl"))
    mine = gang_history(os.path.join(d_one, "m.jsonl"))
    check(gang["restarts"] == 0 and [m["exit_code"] for m in
                                     gang["launches"]] == [0, 0],
          f"{label}: restarts {gang['restarts']}, exit codes "
          f"{[m['exit_code'] for m in gang['launches']]}")
    check(all(hist[r] == before[r] for r in range(1, ELASTIC_NOTICE)),
          f"{label}: the rounds before the notice differ from the gang "
          "baseline's")
    check(sorted(hist) == sorted(mine), f"{label}: rounds {sorted(hist)} "
          f"vs one process's {sorted(mine)}")
    hist_err = max(abs(hist[r][g][k] - mine[r][g][k]) for r in hist
                   for g in ("client_mean", "pooled") for k in hist[r][g])
    from fedtpu_torch.orchestration.checkpoint import complete_steps
    steps = sorted(set(complete_steps(os.path.join(d_gang, "ck")))
                   & set(complete_steps(os.path.join(d_one, "ck"))))
    errs = {}
    for step in steps:
        got = ckpt_state(os.path.join(d_gang, "ck"), step)
        want = ckpt_state(os.path.join(d_one, "ck"), step)
        errs[step] = max(float((got[k] - want[k]).abs().max()) for k in got)
    check(steps and ELASTIC_NOTICE in steps and max(errs.values())
          <= ELASTIC_TOL, f"{label}: checkpoints {errs} from one process's")
    check(hist_err <= ELASTIC_TOL, f"{label}: history {hist_err:.3g} from "
          "one process's")
    ev = os.path.join(d_gang, "ev.jsonl")
    surv, vic = sink_numbers(ev), sink_numbers(f"{ev}.p1")
    check([m for m, _, _ in surv["modes"]] == ["shrink", "grow"]
          and [m for m, _, _ in vic["modes"]] == ["grow_rejoin"],
          f"{label}: reshards {surv['modes']} / {vic['modes']}")
    check(surv["graph_captures"] == 2 and vic["graph_captures"] == 1,
          f"{label}: graph captures {surv['graph_captures']} (survivor), "
          f"{vic['graph_captures']} (victim): the grow captured again")
    launches = [{k: m.get(k, 0) for k in kernels} for m in gang["launches"]]
    check(all(m[k] > 0 for m in launches for k in kernels
              if k != "fused_mlp_forward"),
          f"{label}: a kernel of the path never launched: {launches}")
    print(f"{label}: victim parked at round {ELASTIC_NOTICE - 1}, rejoined "
          f"at {ELASTIC_CANCEL - 1}, no gang restart, exit codes [0, 0]; "
          f"rounds before the notice bitwise the gang baseline; checkpoints "
          f"vs the one-process run of the plan {errs}, history within "
          f"{hist_err:.3g}; graph captures survivor "
          f"{surv['graph_captures']}, victim {vic['graph_captures']} (none "
          f"at the grow); reshard move ms {surv['move_ms']}, build ms "
          f"{surv['build_ms']}, barriers ms {surv['barrier_ms']} (victim "
          f"{vic['barrier_ms']}); s/round before {surv['s_round_before']}, "
          f"shrunk {surv['s_round_shrunk']}, after {surv['s_round_after']} "
          f"(one process {one['result'].summary()['mean_sec_per_round']}); "
          f"launches per member {launches}; {CARD['smi']}", flush=True)
    return ({"history_err": hist_err, "state_err": errs,
             "survivor": surv, "victim": vic, "launches": launches,
             "wall_s": gang["wall_s"]},
            {f"{label}, member {i}": m for i, m in
             enumerate(gang["launches"])})


def k4_elastic_member() -> None:
    """One member of the K4 park-and-rejoin check (``python -c "import
    chip_smoke as cs; cs.k4_elastic_member()" STORE RANK``): a gang of 2 on
    the card exchanges K4_GANG_SHAPE's rows over CUDA IPC; member 1 then
    parks (waits on a file, its buffer still exported) while member 0 runs
    the shrunk one-process K4 on its own (4, 11,353) rows, then rejoins,
    and the gang exchanges a new stack over the ORIGINAL buffers; every
    exchange bitwise the one-process K4 on the same stack. Prints one JSON
    line."""
    store, rank = sys.argv[1], int(sys.argv[2])
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.parallel import multihost
    from fedtpu_torch.parallel.mesh import make_mesh
    from fedtpu_torch.parallel.ring import GangExchange
    gang = multihost.initialize(f"file://{store}", 2, rank)
    dev = gang.device
    s, p = K4_GANG_SHAPE
    ex = GangExchange("ring", gang, make_mesh(s, s, dev, gang=gang), p, dev)
    lo, hi = ex.lo, ex.hi
    flag = f"{store}.rejoin"

    def exchange(seed: int) -> bool:
        full = torch.randn(s, p, generator=torch.Generator().manual_seed(
            seed)).to(dev)
        ex.stage(full[lo:hi])
        ex.host()
        rows = ex.reduce().clone()
        ex.after()
        return bool(torch.equal(rows, ck.ring_all_reduce_sum(full)[lo:hi]))

    same = [exchange(7)]
    shrunk = None
    if rank == 1:
        while not os.path.exists(flag):      # parked: no collective
            time.sleep(0.05)
    else:
        mine = torch.randn(hi - lo, p, generator=torch.Generator()
                           .manual_seed(8)).to(dev)
        shrunk = bool(torch.equal(ck.ring_all_reduce_sum(mine),
                                  ck.ring_all_reduce_sum_reference(mine)))
        with open(flag, "w") as fh:
            fh.write("1")
    gang.barrier()
    same.append(exchange(9))
    ex.close()
    multihost.shutdown()
    print(json.dumps({"rank": rank, "bitwise": same,
                      "shrunk_bitwise": shrunk}), flush=True)


def k4_elastic_check(directory: str) -> dict:
    store = os.path.join(directory, "k4e.store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as cs; "
         "cs.k4_elastic_member()", store, str(r)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    rows = []
    for proc in procs:
        o, e = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"K4 elastic member rc "
              f"{proc.returncode}: {o[-1000:]} {e[-2000:]}")
        rows.append(json.loads(o.strip().splitlines()[-1]))
    check(all(all(r["bitwise"]) for r in rows) and rows[0]["shrunk_bitwise"],
          f"K4 across a park and a rejoin: {rows}")
    print(f"K4 across processes at {K4_GANG_SHAPE} before a park and after "
          "the rejoin over the original IPC buffers: bitwise the "
          "one-process K4 on the same stack; the shrunk one-process K4 at "
          f"(4, {K4_GANG_SHAPE[1]}) bitwise its plain version; "
          f"{CARD['smi']}", flush=True)
    return {"rows": rows}


def gang_popen(argv: list, directory: str, shards: int):
    """``gang_cli``'s gang of 2 as a background process (the supervisor's
    pid is the Popen's)."""
    os.makedirs(directory, exist_ok=True)
    code = ("import sys; from fedtpu_torch.resilience.supervisor import "
            f"supervise_gang; sys.exit(supervise_gang({argv!r}, 2, "
            "max_restarts=0, grace=10, backoff_base=0.0, verbose=False, "
            "_cmd_prefix=[sys.executable, '-c', 'import chip_smoke as cs; "
            "cs.gang_member()']))")
    env = dict(os.environ, GANG_LAUNCHES=directory,
               FEDTPU_SHARDS_PER_PROCESS=str(shards))
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def elastic_signal(directory: str, base: dict) -> dict:
    """Phase (w) 3: SIGUSR1 to the supervisor of an income-8 gang of 2
    (2 shards a member, each round paced by a straggler) after round 3:
    both members shrink at the agreed round (the largest loop-top a member
    saw the notice at, plus one), the survivor onto its 4 clients; the
    victim exits 76, no gang restart; the rounds before the shrink bitwise
    the gang baseline's."""
    import signal as _signal
    d = os.path.join(directory, "signal")
    pace = [{"kind": "straggler", "round": r, "clients": [0],
             "delay_s": ELASTIC_PACE_S}
            for r in range(2, ELASTIC_SIGNAL_ROUNDS + 1)]
    proc = gang_popen(gang_argv(d, "income-8", ELASTIC_SIGNAL_ROUNDS,
                                "--checkpoint-every", "2", "--fault-plan",
                                json.dumps({"seed": 0, "faults": pace})),
                      d, 2)
    metrics = os.path.join(d, "m.jsonl")
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline and proc.poll() is None and (
            not os.path.exists(metrics) or max(gang_history(metrics) or [0])
            < 3):
        time.sleep(0.05)
    check(proc.poll() is None, "signal run ended before round 3")
    proc.send_signal(_signal.SIGUSR1)
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"signal run rc {proc.returncode}: "
          f"{out[-1500:]} {err[-3000:]}")
    launches = []
    for i in range(2):
        with open(os.path.join(d, f"launches.0.{i}")) as fh:
            launches.append(json.load(fh))
    ev = os.path.join(d, "ev.jsonl")
    surv, vic = sink_numbers(ev), sink_numbers(f"{ev}.p1")
    check([m for m, _, _ in surv["modes"]] == ["shrink"]
          and surv["modes"][0][2] == 4, f"signal: reshards {surv['modes']}")
    r = surv["modes"][0][1]
    notices = surv["begin"][0]["notices"]
    check(r == max(n for _, n in notices) + 1
          and vic["begin"][0]["notices"] == notices,
          f"signal: shrink at loop-top {r}, notices {notices} / "
          f"{vic['begin'][0]['notices']}")
    check([m["exit_code"] for m in launches] == [0, 76],
          f"signal: exit codes {[m['exit_code'] for m in launches]}")
    hist = gang_history(metrics)
    check(all(hist[k] == base[k] for k in range(1, r + 1)),
          "signal: the rounds before the shrink differ from the baseline's")
    print(f"signal path: SIGUSR1 to the supervisor; notices seen at "
          f"loop-tops {notices}, both members shrank at loop-top {r} (8 -> "
          f"4 clients); rounds 1-{r} bitwise the gang baseline; victim exit "
          f"76, survivor 0, no gang restart; move ms {surv['move_ms']}, "
          f"build ms {surv['build_ms']}, barriers ms {surv['barrier_ms']}; "
          f"{CARD['smi']}", flush=True)
    return {"round": r, "notices": notices, "survivor": surv,
            "ck": os.path.join(d, "ck"), "rounds": max(hist),
            "launches": launches}


def elastic_resume_member() -> None:
    """A member of phase (w) 4 (``python -c "import chip_smoke as cs;
    cs.elastic_resume_member()" STORE RANK SPEC``): joins a gang of 2 on
    the card and runs the port's CLI config SPEC["argv"] with ``resume``;
    the state its first round starts from (the graphs' warm-up sees it)
    is held to SPEC's rule against the saved round: "rows", each of its
    rows and moments bitwise the saved rows; "elastic", fedtpu's rule,
    every slot the saved slots' mean and every moment zero. Prints one
    JSON line."""
    store, rank, spec = sys.argv[1], int(sys.argv[2]), json.loads(
        sys.argv[3])
    os.environ["FEDTPU_SHARDS_PER_PROCESS"] = str(spec["shards"])
    from fedtpu_torch.cli import build_parser, config_from_args
    from fedtpu_torch.orchestration import loop
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_raw
    from fedtpu_torch.parallel import multihost
    gang = multihost.initialize(f"file://{store}", 2, rank)
    seen = {}
    warm = loop.warm_up_round

    def first(step, state, batch):
        if not seen:
            seen.update(params=state["params"].cpu().clone(),
                        mu=state["opt_state"]["mu"].cpu().clone(),
                        nu=state["opt_state"]["nu"].cpu().clone())
        return warm(step, state, batch)
    loop.warm_up_round = first
    cfg = config_from_args(build_parser().parse_args(spec["argv"]))
    saved = load_checkpoint_raw(cfg.run.checkpoint_dir, spec["step"])[0]
    res = loop.run_experiment(cfg, verbose=False, device="cuda",
                              resume=True)
    multihost.shutdown()
    n = seen["params"].shape[0]
    if spec["rule"] == "rows":
        rows = slice(rank * n, (rank + 1) * n)
        ok = (torch.equal(seen["params"], saved["params"][rows])
              and torch.equal(seen["mu"], saved["opt_state"]["mu"][rows])
              and torch.equal(seen["nu"], saved["opt_state"]["nu"][rows]))
    else:
        mean = torch.from_numpy(saved["params"].numpy().mean(axis=0))
        ok = (bool((seen["params"] == mean).all())
              and not seen["mu"].any() and not seen["nu"].any())
    print(json.dumps({"rank": rank, "ok": bool(ok), "slots": n,
                      "rounds_run": res.rounds_run,
                      "history": res.global_metrics["accuracy"]}),
          flush=True)


def elastic_resume(directory: str, signal_run: dict) -> dict:
    """Phase (w) 4: the survivor's one-process checkpoint (4 clients) of
    the signal run resumed by a gang of 2 at 4 clients (each member its
    rows, bitwise) and at 8 (fedtpu's elastic rule), each for two more
    rounds."""
    import shutil
    from fedtpu_torch.orchestration.checkpoint import latest_step
    step = latest_step(signal_run["ck"])
    out = {}
    for rule, clients, shards in (("rows", 4, 1), ("elastic", 8, 2)):
        d = os.path.join(directory, f"resume-{rule}")
        shutil.copytree(signal_run["ck"], os.path.join(d, "ck"))
        argv = gang_argv(d, "income-8", step + 2, "--num-clients",
                         str(clients), "--checkpoint-every", "2")
        spec = {"argv": argv, "shards": shards, "rule": rule, "step": step}
        store = os.path.join(d, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as cs; "
             "cs.elastic_resume_member()", store, str(r), json.dumps(spec)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        rows = []
        for proc in procs:
            o, e = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"resume member ({rule}) rc "
                  f"{proc.returncode}: {o[-1000:]} {e[-2000:]}")
            rows.append(json.loads(o.strip().splitlines()[-1]))
        check(all(r["ok"] and r["rounds_run"] == step + 2 for r in rows),
              f"elastic resume ({rule}): {rows}")
        out[rule] = rows
        print(f"elastic resume ({rule}): a gang of 2 at {clients} clients "
              f"resumed the survivor's one-process round {step} (4 clients)"
              f" and trained to {step + 2}: "
              + ("each member's rows and moments bitwise the saved rows"
                 if rule == "rows" else "every slot the saved slots' mean, "
                 "every moment zero (fedtpu's elastic rule)")
              + f"; {CARD['smi']}", flush=True)
    return out


def elastic_kernel_rows(signal_run: dict) -> dict:
    """K1's broadcast at (4, 11,352), K2 at the shrunk (4, 1000) batch and
    K4 at (4, 11,353), the shapes a survivor alone gives them, on the
    survivor's final params (with noise) and income-8's own packed rows of
    its clients, against their plain versions, timed beside them and
    their bounds; K4 bitwise, K1 within 1e-5, K2's counts equal but on
    near-tie rows."""
    from fedtpu_torch.models.mlp import mlp_apply, unflatten
    from fedtpu_torch.ops import cuda_kernels as ck
    from fedtpu_torch.ops.metrics import near_tie_rows
    from fedtpu_torch.orchestration.checkpoint import (latest_step,
                                                       load_checkpoint_raw)
    from fedtpu_torch.orchestration.loop import build_experiment
    dev = torch.device("cuda")
    dims, k = INCOME_DIMS, INCOME_DIMS[-1]
    saved = load_checkpoint_raw(signal_run["ck"],
                                latest_step(signal_run["ck"]))[0]
    params = (saved["params"] + 1e-2 * torch.randn(
        saved["params"].shape, generator=torch.Generator().manual_seed(6))
              ).to(dev)
    batch = build_experiment(main_path_config(), device="cpu").batch
    c, d = params.shape
    x, y, mask = (batch[key][:c].to(dev) for key in ("x", "y", "mask"))
    w = mask.sum(dim=1)
    live = float(mask.sum())
    avg = ck.weighted_average_clients(params, w, broadcast=True)
    e1 = float((avg - ck.weighted_average_clients_reference(
        params, w, broadcast=True)).abs().max())
    check(e1 <= 1e-5, f"K1 broadcast at ({c}, {d}): max abs err {e1}")
    conf = ck.fused_eval_confusion(params, dims, x, y, mask, k)
    ref = ck.fused_eval_confusion_reference(params, dims, x, y, mask, k)
    ties = near_tie_rows(mlp_apply(unflatten(params, dims), x)) & (mask > 0)
    moved = (conf - ref).abs().sum(dim=(1, 2)) / 2
    check(bool((moved <= ties.sum(dim=1)).all()),
          f"K2 at the shrunk ({c}, {y.shape[1]}): counts differ on "
          f"{int(moved.sum())} rows, near ties {int(ties.sum())}")
    ring = torch.randn(c, d + 1, generator=torch.Generator().manual_seed(
        5)).to(dev)
    check(torch.equal(ck.ring_all_reduce_sum(ring),
                      ck.ring_all_reduce_sum_reference(ring)),
          f"K4 at ({c}, {d + 1}): not bitwise its plain version")
    rows = {}
    for name, kernel, plain, library, nbytes, flops, err, shape in (
            ("weighted_average_clients",
             lambda: ck.weighted_average_clients(params, w, broadcast=True),
             lambda: ck.weighted_average_clients_reference(
                 params, w, broadcast=True), None,
             4 * (2 * params.numel() + c), 2.0 * params.numel(), e1,
             f"survivor broadcast ({c}, {d}) fp32, data-size weights"),
            ("fused_eval_confusion",
             lambda: ck.fused_eval_confusion(params, dims, x, y, mask, k),
             lambda: ck.fused_eval_confusion_reference(params, dims, x, y,
                                                       mask, k), None,
             4 * (params.numel() + live * (dims[0] + 1) + mask.numel()
                  + c * k * k), mlp_flops(dims, live),
             float((conf - ref).abs().max()),
             f"survivor eval ({c}, {y.shape[1]}), {int(live)} real rows"),
            ("ring_all_reduce_sum",
             lambda: ck.ring_all_reduce_sum(ring),
             lambda: ck.ring_all_reduce_sum_reference(ring),
             lambda: ring.sum(dim=0), 2 * ring.numel() * 4,
             float((c - 1) * ring.numel()), 0.0,
             f"survivor ring, one process ({c}, {d + 1})")):
        bnd, by = bound_ms(nbytes, flops)
        rows[name] = {"shape": shape, "max_abs_err": err,
                      "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                      "library_ms": library and time_ms(library),
                      "bound_ms": bnd, "bound_by": by}
        r = rows[name]
        print(f"time {name} {shape}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']}  bound "
              f"{bnd:.5f} ms ({by}); max abs err {err:.3e}; {CARD['smi']}",
              flush=True)
    # K1's broadcast has no one-call counterpart; the (D,) average that it
    # broadcasts is one torch.matmul.
    rows["weighted_average_clients"]["matmul_average_ms"] = time_ms(
        lambda: torch.matmul(w / w.sum(), params))
    print(f"time torch.matmul (D,) average at ({c}, {d}): "
          f"{rows['weighted_average_clients']['matmul_average_ms']:.4f} ms",
          flush=True)
    return rows


def elastic_chaos(procs: list, t0: float) -> dict:
    """The four reshard and autoscale rows' reports (two a chaos child):
    every row ok; each row's seconds, and mp_shrink_dead's restart
    seconds, printed."""
    rows = {}
    for proc, names in zip(procs, ELASTIC_CHAOS):
        out, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"chaos {names} rc {proc.returncode}: "
              f"{out[-2000:]} {err[-2000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        mine = {r["scenario"]: r for r in report["scenarios"]}
        check(report["ok"] and sorted(mine) == sorted(names),
              f"chaos elastic rows: {report}")
        rows.update(mine)
    times = {}
    for name, row in rows.items():
        times[name] = {k: row.get(k) for k in ("seconds", "restart_s")}
        print(f"chaos {name}: ok, gang_restarts {row['gang_restarts']}, "
              f"reshards {row['reshards']}, reshard_failures "
              f"{row['reshard_failures']}"
              + (f", spooled {row['spooled']}, lost_updates "
                 f"{row['lost_updates']}, backlog {row['backlog']}, "
                 f"slo_burn {row['slo_burn']}" if "spooled" in row else "")
              + f"; {times[name]}", flush=True)
    total = time.perf_counter() - t0
    print(f"chaos reshard and autoscale rows (CLI, card): {total:.1f} s in "
          f"all; {CARD['smi']}", flush=True)
    return {"total_s": total, "rows": times}


def phase_elastic_gang() -> tuple:
    """Phase (w): the elastic gang on the card (the constants above). The
    four chaos rows run as two children from the start, beside the psum
    and ring shrink-and-grow gangs, K4 across a park, the signal path and
    the elastic resume."""
    import tempfile
    numbers, seconds, by_path = {}, {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    cli = [sys.executable, "-m", "fedtpu_torch.cli"]
    k123 = ("weighted_average_clients", "fused_eval_confusion",
            "fused_mlp_forward")
    with tempfile.TemporaryDirectory() as directory:
        t_chaos = time.perf_counter()
        chaos = [subprocess.Popen(cli + [
            "chaos", "--scenarios", ",".join(names), "--platform",
            "default", "--num-clients", "8", "--hidden-sizes", "50,200",
            "--synthetic-rows", "10000", "--json", "--quiet", "--workdir",
            os.path.join(directory, f"chaos{i}"), "--timeout", "540"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i, names in enumerate(ELASTIC_CHAOS)]
        try:
            numbers["psum"], paths = elastic_pair(
                directory, "income-8 psum elastic gang",
                ("income-8", ELASTIC_ROUNDS), 2, 4, k123)
            by_path.update(paths)
            lap("psum shrink and grow")
            numbers["ring"], paths = elastic_pair(
                directory, "income-32-noniid ring elastic gang",
                ("income-32-noniid", ELASTIC_ROUNDS, "--aggregation",
                 "ring"), 4, 16, k123[1:] + ("ring_all_reduce_sum",))
            by_path.update(paths)
            numbers["k4_park"] = k4_elastic_check(directory)
            lap("ring shrink and grow, K4 across a park")
            signal_run = elastic_signal(directory,
                                        GANG_BASELINES["income-8"])
            by_path.update({f"income-8 signal shrink, member {i}": m
                            for i, m in enumerate(signal_run.pop(
                                "launches"))})
            numbers["signal"] = {k: v for k, v in signal_run.items()
                                 if k != "ck"}
            lap("signal path")
            numbers["resume"] = elastic_resume(directory, signal_run)
            lap("elastic resume")
            numbers["kernel_rows"] = elastic_kernel_rows(signal_run)
            lap("K1, K2, K4 at the survivor's shapes")
            numbers["chaos"] = elastic_chaos(chaos, t_chaos)
            lap("chaos (its wait)")
        finally:
            for p in chaos:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    print(f"phase (w) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


# The aggregation branches in a training gang (phase (x)): five psum gangs
# of 2 members x 4 shards on phase (e)'s income-32-noniid configs, each held
# to phase (e)'s one-process card run of the same config.
BRANCH_GANGS = {
    "fedadam": ("--server-opt", "fedadam", "--server-lr", "0.01"),
    "DP-FedAvg": ("--weighting", "uniform", "--participation-rate", "0.5",
                  "--dp-clip-norm", "1.0", "--dp-noise-multiplier", "1.0",
                  "--dp-adaptive-clip", "--dp-count-noise-multiplier",
                  "2.0"),
    "krum, 3 Byzantine": ("--weighting", "uniform", "--robust-aggregation",
                          "krum", "--krum-f", "3", "--byzantine-clients",
                          "3"),
    "SCAFFOLD": ("--weighting", "uniform", "--scaffold", "--local-steps",
                 "3"),
    "int8 over 8 shards": ("--compress", "int8")}
BRANCH_MEMBER_SHARDS = 4
BRANCH_EXCHANGE_REPS = 50
# The branch gang run again alone on the card after the five, for its
# s/round without the other four.
BRANCH_ALONE = "fedadam"
# Phase (e)'s card runs of BRANCH_GANGS' configs (result, launches, the
# directory of their checkpoints and metrics, config), phase (x)'s oracles.
BRANCH_ORACLES: dict = {}
_BRANCH_DIR: list = []


def branch_dir() -> str:
    """The directory phase (e) keeps its branch runs in for phase (x),
    made once and removed when the script ends."""
    if not _BRANCH_DIR:
        import atexit
        import shutil
        import tempfile
        _BRANCH_DIR.append(tempfile.mkdtemp(prefix="branch-oracles-"))
        atexit.register(shutil.rmtree, _BRANCH_DIR[0], True)
    return _BRANCH_DIR[0]


def branch_argv(directory: str, name: str) -> list:
    return gang_argv(directory, "income-32-noniid", A6_ROUNDS,
                     "--eval-test-every", "10", *BRANCH_GANGS[name])


def branch_config(name: str):
    """The CLI config of ``name``'s gang as one process runs it: 8 mesh
    shards (the gang's 2 x 4), no checkpoints, metrics or sink."""
    from fedtpu_torch.cli import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(
        branch_argv("unused", name)))
    return cfg.replace(run=dataclasses.replace(
        cfg.run, mesh_devices=2 * BRANCH_MEMBER_SHARDS, checkpoint_dir=None,
        checkpoint_every=0, metrics_jsonl=None, collective_timeout=None,
        telemetry=type(cfg.run.telemetry)()))


def branch_oracle(directory: str, name: str) -> dict:
    """Phase (e)'s card run of ``name``'s config when it ran and its
    config is the gang's, else this config's own one-process run."""
    known = BRANCH_ORACLES.get(name)
    if known is not None and known["cfg"] == branch_config(name):
        print(f"phase (x) {name}: oracle is phase (e)'s run of the same "
              "config", flush=True)
        return known
    print(f"phase (x) {name}: oracle is its own one-process run "
          f"({'phase (e) did not run' if known is None else 'config differs from phase (e)'})",
          flush=True)
    return one_process_run(os.path.join(directory, f"one-{name[:4]}"),
                           ("income-32-noniid", A6_ROUNDS, "--eval-test-every",
                            "10", *BRANCH_GANGS[name]),
                           shards=2 * BRANCH_MEMBER_SHARDS)


def branch_exchange_member() -> None:
    """One member of phase (x)'s exchange check (``python -c "import
    chip_smoke as cs; cs.branch_exchange_member()" STORE RANK``): joins a
    gang of 2 on the card, builds each BRANCH_GANGS config's experiment
    (its exchange, a ``GangExchange`` or a ``GangGather``, as the gang's
    run builds it), stages payloads that differ by member and prints one
    JSON line: each exchange's kind, the dtype, shape and bytes a member
    sends a round, the gathered or reduced result against every member's
    payload (the int8 block bitwise, as int8), and the host ms of its
    collective (median of BRANCH_EXCHANGE_REPS)."""
    store, rank = sys.argv[1], int(sys.argv[2])
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel import multihost
    os.environ["FEDTPU_SHARDS_PER_PROCESS"] = str(BRANCH_MEMBER_SHARDS)
    gang = multihost.initialize(f"file://{store}", 2, rank)
    out = {"rank": rank, "backend": gang.backend, "exchanges": {}}
    for name in BRANCH_GANGS:
        ex = build_experiment(branch_config(name), device="cuda").exchange
        send = ex.send
        gen = torch.Generator().manual_seed(100 + rank)
        payload = (torch.randint(-127, 128, send.shape, generator=gen,
                                 dtype=torch.int8)
                   if send.dtype == torch.int8
                   else torch.randn(send.shape, generator=gen))
        ex.stage(payload)
        times = []
        for _ in range(BRANCH_EXCHANGE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.host()
            times.append((time.perf_counter() - t0) * 1e3)
        got = ex.reduce().cpu()
        peers = gang.all_gather(payload)
        same = bool(torch.equal(got, peers.reshape(got.shape))
                    and got.dtype == payload.dtype if ex.kind == "gather"
                    else torch.equal(got, peers[0] + peers[1]))
        out["exchanges"][name] = {
            "kind": ex.kind, "dtype": str(send.dtype),
            "shape": list(send.shape),
            "bytes_sent": send.numel() * send.element_size(),
            "exact": same, "host_ms": statistics.median(times)}
        ex.close()
        gang.barrier()
    multihost.shutdown()
    print(json.dumps(out), flush=True)


def branch_member_rows() -> dict:
    """K1's sum mode at the DP member's (16, 11,352) under 0/1 weights and
    K2 at a member's (16, 1104) block of income-32-noniid's batch, on the
    card with nothing else on it."""
    from fedtpu_torch.models.mlp import param_count
    from fedtpu_torch.orchestration.loop import build_experiment
    c = 32 // 2
    batch = build_experiment(sharded_config("psum", 1.0, 1),
                             device="cpu").batch
    tag = "a branch-gang member (income-32-noniid over 2)"
    return {"weighted_sum_clients": k1_sum_row(
                torch.device("cuda"), param_count(INCOME_DIMS), tag, rows=c,
                binary=True),
            "fused_eval_confusion": k2_member_row(
                batch, c, tag, torch.Generator().manual_seed(9))}


def median_s_round(path: str):
    """The median s/round of a run's metrics JSONL, round 1 (the graphs'
    warm-up and capture) left out."""
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    return statistics.median(r["sec_per_round"] for r in rows[1:])


def phase_branch_gangs() -> tuple:
    """Phase (x): the aggregation branches in a training gang on the card.
    K1's sum mode and K2 at a member's shapes first, alone; then the five
    gangs (BRANCH_GANGS, 2 members x 4 shards, their members' launches
    counted) run side by side as children while the oracles are taken
    (phase (e)'s runs); each gang held to its oracle as phase (v) holds a
    gang (``gang_vs_one``: the stop round, the history, the state at every
    checkpoint, the members' round events, a member's K1/K2/K3 launches
    one process's); then BRANCH_ALONE's gang again, alone on the card, held
    the same way, for its s/round without the others; last, alone, the
    exchange check (``branch_exchange_member``)."""
    import tempfile
    numbers, seconds, by_path = {}, {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    k123 = ("weighted_average_clients", "fused_eval_confusion",
            "fused_mlp_forward")
    numbers["member_rows"] = branch_member_rows()
    lap("K1 and K2 at a member's shapes")
    with tempfile.TemporaryDirectory() as directory:
        gangs = {}
        for i, name in enumerate(BRANCH_GANGS):
            d = os.path.join(directory, f"g{i}")
            gangs[name] = (d, time.perf_counter(), gang_popen(
                branch_argv(d, name), d, BRANCH_MEMBER_SHARDS))
        members = []
        try:
            oracles = {name: branch_oracle(directory, name)
                       for name in BRANCH_GANGS}
            lap("oracles")
            for name, (d, t0, proc) in gangs.items():
                o, e = proc.communicate(timeout=900)
                gang = gang_outcome(branch_argv(d, name), 2, d,
                                    proc.returncode, o, e,
                                    time.perf_counter() - t0)
                label = f"income-32-noniid {name} gang of 2 (4 shards each)"
                row = gang_vs_one(label, gang, oracles[name], d, 2, True,
                                  k123)
                row["median_s_round"] = {
                    "gang": median_s_round(os.path.join(d, "m.jsonl")),
                    "one": median_s_round(os.path.join(oracles[name]["dir"],
                                                       "m.jsonl"))}
                numbers[name] = row
                for i, mem in enumerate(gang["launches"]):
                    by_path[f"{label}, member {i}"] = mem
                print(f"{label}: median s/round gang "
                      f"{row['median_s_round']['gang']:.4e} (five gangs "
                      f"side by side on the card) vs one process "
                      f"{row['median_s_round']['one']:.4e} (its oracle "
                      f"run); {CARD['smi']}", flush=True)
            lap("gangs")
            d = os.path.join(directory, "alone")
            gangs["alone"] = (d, time.perf_counter(), gang_popen(
                branch_argv(d, BRANCH_ALONE), d, BRANCH_MEMBER_SHARDS))
            _, t0, proc = gangs["alone"]
            o, e = proc.communicate(timeout=600)
            gang = gang_outcome(branch_argv(d, BRANCH_ALONE), 2, d,
                                proc.returncode, o, e,
                                time.perf_counter() - t0)
            label = (f"income-32-noniid {BRANCH_ALONE} gang of 2 (4 shards "
                     "each), alone on the card")
            row = gang_vs_one(label, gang, oracles[BRANCH_ALONE], d, 2, True,
                              k123)
            row["median_s_round"] = {
                "gang": median_s_round(os.path.join(d, "m.jsonl")),
                "one": median_s_round(os.path.join(
                    oracles[BRANCH_ALONE]["dir"], "m.jsonl"))}
            numbers[f"{BRANCH_ALONE}, alone"] = row
            print(f"{label}: median s/round gang "
                  f"{row['median_s_round']['gang']:.4e} vs one process "
                  f"{row['median_s_round']['one']:.4e}; {CARD['smi']}",
                  flush=True)
            lap("a gang alone")
            # The exchange check alone on the card, after the gangs.
            store = os.path.join(directory, "exchange.store")
            members = [subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as cs; "
                 "cs.branch_exchange_member()", store, str(r)], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            rows = []
            for proc in members:
                o, e = proc.communicate(timeout=300)
                check(proc.returncode == 0, f"exchange member rc "
                      f"{proc.returncode}: {o[-1000:]} {e[-2000:]}")
                rows.append(json.loads(o.strip().splitlines()[-1]))
            exchanges = {}
            for name in BRANCH_GANGS:
                mine = [r["exchanges"][name] for r in rows]
                check(all(m["exact"] for m in mine),
                      f"exchange of {name}: a member's result differs from "
                      f"its peers' payloads: {mine}")
                exchanges[name] = {**{k: mine[0][k] for k in (
                    "kind", "dtype", "shape", "bytes_sent")},
                    "host_ms": [m["host_ms"] for m in mine]}
                print(f"exchange {name}: {json.dumps(exchanges[name])} "
                      f"({rows[0]['backend']}); {CARD['smi']}", flush=True)
            check(exchanges["int8 over 8 shards"]["dtype"] == "torch.int8",
                  f"the int8 gang sends {exchanges['int8 over 8 shards']}")
            numbers["exchanges"] = exchanges
            lap("exchange check")
        finally:
            for _, _, proc in gangs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            for proc in members:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
    print(f"phase (x) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


# ------------------------------------------ (y) the loop's features
# The loop's features in a training gang on the card, three gangs of 2 at
# full width beside one another, each held to one process of the same CLI
# config: y1, income-32-noniid's fedadam psum over 2 x 4 shards under a
# pipelined stop at R = 5, personalization and a warm start (its artifact
# the final global of phase (x)'s fedadam oracle); y2, income-8 psum (4
# clients a member) at R = 1 under rollback, with a member-1 client's
# dropout, a corrupt checkpoint and a member-1 client's NaN update right
# after it, so that the rollback walks past the corrupt round; y3, y2's
# plan on income-32-noniid's ring over 2 x 4 shards. What the pipelined
# stop buys y1 is timed apart (``pipelining_pairs``): each gang alone, in
# PIPELINING_ORDER, pipelined or not.
FEATURE_R = 5
FEATURE_CKPT_EVERY = 10     # so that half the chunk ends do not drain the pipe
FEATURE_ARGS = ("--server-opt", "fedadam", "--server-lr", "0.01",
                "--rounds-per-step", str(FEATURE_R), "--personalize-steps",
                "5", "--checkpoint-every", str(FEATURE_CKPT_EVERY))
FAULT_ROUNDS = 10
FAULT_DROPOUT = 3           # 1-based rounds of the plan
FAULT_STRIKE = 7            # ckpt_corrupt of round 6, then the NaN update
FAULT_RESTORED = 4          # the round the rollback walks back to
FAULT_GANGS = {
    # name: (preset, member-1 clients (dropped, poisoned), extra args,
    #        shards a member, one process's shards)
    "income-8 psum": ("income-8", (6, 5), (), 0, 2),
    "income-32-noniid ring": ("income-32-noniid", (22, 21),
                              ("--aggregation", "ring"), 4, 8)}
WALK_REPS = 10
AGREE_REPS = 50
PIPELINING_ORDER = (True, False, False, True) * 2


def fault_plan(dropped: int, poisoned: int) -> str:
    return json.dumps({"seed": 0, "faults": [
        {"kind": "client_dropout", "round": FAULT_DROPOUT,
         "clients": [dropped]},
        {"kind": "ckpt_corrupt", "round": FAULT_STRIKE},
        {"kind": "nan_update", "round": FAULT_STRIKE,
         "clients": [poisoned]}]})


def fault_spec(name: str) -> tuple:
    preset, (dropped, poisoned), extra, _, _ = FAULT_GANGS[name]
    return (preset, FAULT_ROUNDS, *extra, "--rounds-per-step", "1",
            "--checkpoint-every", "2", "--on-divergence", "rollback",
            "--fault-plan", fault_plan(dropped, poisoned))


def feature_spec(npz: str, pipelined: bool = True) -> tuple:
    return ("income-32-noniid", A6_ROUNDS, *FEATURE_ARGS, "--init-weights",
            npz, *(("--pipelined-stop",) if pipelined else ()))


def member_results(directory: str, n: int = 2) -> list:
    """Each member's result record (``gang_member``'s dump)."""
    out = []
    for i in range(n):
        with open(os.path.join(directory, f"result.0.{i}")) as fh:
            out.append(json.load(fh))
    return out


def result_dump(res) -> dict:
    """What phase (y) reads of a run's result: per-round confusion counts,
    the rounds trained, rollbacks, personalized metrics and a digest of
    the final global model."""
    import hashlib
    leaves = [np.ascontiguousarray(x).tobytes()
              for x in param_leaves(res.final_params)]
    pm = res.personalized_metrics
    return {"confusion": [np.asarray(c).tolist() for c in res.confusion],
            "rounds_run": res.rounds_run,
            "rounds_trained": res.rounds_trained,
            "rollbacks": res.rollbacks, "diverged": res.diverged,
            "personalized": {part: {k: np.asarray(v).tolist()
                                    for k, v in pm[part].items()}
                             for part in pm},
            "params_sha": hashlib.sha256(b"".join(leaves)).hexdigest()}


def rollback_events(ev: str, n: int) -> list:
    """Each member's ``rollback`` events: (restored round, attempt)."""
    return [[(e["payload"]["restored_round"], e["payload"]["attempt"])
             for e in read_sink(ev if i == 0 else f"{ev}.p{i}")
             if e["kind"] == "rollback"] for i in range(n)]


def feature_checks(label: str, directory: str, one: dict, gang: dict) -> dict:
    """Phase (y)'s holds beyond ``gang_vs_one``: the members' results
    bitwise equal to each other; the rounds trained and rollbacks one
    process's; the personalized client mean within TRAIN_GANG_DRIFT_TOL;
    one rollback to FAULT_RESTORED on both members and in one process;
    the dropped client's counts zero in its round."""
    res = one["result"]
    mine = member_results(directory)
    for key in ("confusion", "rounds_run", "rounds_trained", "rollbacks",
                "diverged", "personalized", "params_sha"):
        check(all(m[key] == mine[0][key] for m in mine),
              f"{label}: the members' {key} differ")
    got = mine[0]
    check((got["rounds_trained"], got["rollbacks"])
          == (res.rounds_trained, res.rollbacks),
          f"{label}: rounds trained / rollbacks {got['rounds_trained']}, "
          f"{got['rollbacks']} vs one process's {res.rounds_trained}, "
          f"{res.rollbacks}")
    out = {"rounds_trained": got["rounds_trained"],
           "rollbacks": got["rollbacks"]}
    if res.personalized_metrics:
        err = max(abs(got["personalized"]["client_mean"][k] - v)
                  for k, v in res.personalized_metrics["client_mean"].items())
        check(err <= TRAIN_GANG_DRIFT_TOL, f"{label}: personalized client "
              f"mean {err:.3g} from one process's")
        out["personalized_err"] = err
    if res.rollbacks:
        rb = rollback_events(os.path.join(directory, "ev.jsonl"), 2)
        want = rollback_events(os.path.join(one["dir"], "ev.jsonl"), 1)[0]
        check(want == [(FAULT_RESTORED, 1)] and all(r == want for r in rb),
              f"{label}: rollbacks {rb} vs one process's {want}")
        dropped = json.loads(gang["argv"][gang["argv"].index(
            "--fault-plan") + 1])["faults"][0]["clients"][0]
        counts = np.asarray(got["confusion"][FAULT_DROPOUT - 1])[dropped]
        check(not counts.any(), f"{label}: client {dropped} counted "
              f"{counts.tolist()} in its dropout round")
        out["restored_round"] = want[0][0]
    return out


def rollback_walk_member() -> None:
    """One member of phase (y)'s walk timing (``python -c "import
    chip_smoke as cs; cs.rollback_walk_member()" STORE RANK DIR``): joins a
    gang of 2 on the card over income-8's main path, saves rounds 2 and 4
    collectively, has process 0 stomp round 4's largest part, then times
    the rollback's host work as the loop does it: the agreed fallback walk
    (the hit member's failed load, every member's load of round 2, the
    agreement collectives) and the restore into the live tensors, and,
    alone, the agreement collective (``all_gather`` of ``(step, ok)``).
    Prints one JSON line."""
    store, rank, directory = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import warnings
    from fedtpu_torch.orchestration.checkpoint import (
        load_checkpoint_fallback, save_checkpoint)
    from fedtpu_torch.orchestration.loop import (_copy_state_into,
                                                 _restore_state,
                                                 build_experiment)
    from fedtpu_torch.parallel import multihost
    from fedtpu_torch.resilience.faults import corrupt_checkpoint
    from fedtpu_torch.telemetry.metrics import default_registry
    gang = multihost.initialize(f"file://{store}", 2, rank)
    exp = build_experiment(main_path_config(), device="cuda")
    state, ck = exp.state, os.path.join(directory, "walk")
    for step in (2, 4):
        save_checkpoint(ck, state, {}, step, gang=gang)
    if rank == 0:
        corrupt_checkpoint(ck)
    gang.barrier()
    default_registry().reset()
    walk, copy = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(WALK_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw, _, step = load_checkpoint_fallback(ck, part=(rank, 2),
                                                    gang=gang)
            t1 = time.perf_counter()
            _copy_state_into(state, _restore_state(raw, state, exp.device))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            walk.append((t1 - t0) * 1e3)
            copy.append((t2 - t1) * 1e3)
    agree = []
    flag = torch.tensor([4, 1], dtype=torch.int64)
    for _ in range(AGREE_REPS):
        t0 = time.perf_counter()
        gang.all_gather(flag)
        agree.append((time.perf_counter() - t0) * 1e3)
    corrupt = default_registry().snapshot()["counters"].get(
        "checkpoint_restore_corrupt", 0)
    multihost.shutdown()
    print(json.dumps({"rank": rank, "step": step, "corrupt_loads": corrupt,
                      "walk_ms": statistics.median(walk),
                      "copy_ms": statistics.median(copy),
                      "restore_ms": statistics.median(
                          [a + b for a, b in zip(walk, copy)]),
                      "agree_ms": statistics.median(agree)}), flush=True)


def rollback_walk(directory: str) -> dict:
    """``rollback_walk_member`` as a gang of 2, alone on the card: both
    members restore round 2, the stomped part's member counted its failed
    load of round 4 on every walk, the other none."""
    store = os.path.join(directory, "walk.store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as cs; "
         "cs.rollback_walk_member()", store, str(r), directory], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    rows = []
    try:
        for proc in procs:
            o, e = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"walk member rc {proc.returncode}: "
                  f"{o[-1000:]} {e[-2000:]}")
            rows.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    check([r["step"] for r in rows] == [2, 2]
          and sorted(r["corrupt_loads"] for r in rows) == [0, WALK_REPS],
          f"the agreed walk: {rows}")
    print("rollback in a gang of 2 (income-8, round 4's largest part "
          "stomped): both members restore round 2; host ms (median of "
          f"{WALK_REPS}) agreed walk {[r['walk_ms'] for r in rows]}, copy "
          f"into the live tensors {[r['copy_ms'] for r in rows]}, the two "
          f"together {[r['restore_ms'] for r in rows]}; the agreement "
          f"collective alone {[r['agree_ms'] for r in rows]} (median of "
          f"{AGREE_REPS}); {CARD['smi']}", flush=True)
    return {k: [r[k] for r in rows] for k in ("walk_ms", "copy_ms",
                                              "restore_ms", "agree_ms")}


def warm_start_npz(directory: str) -> str:
    """y1's warm start: an artifact written with ``save_best_weights``
    from phase (x)'s fedadam oracle (its own run when (x) did not run)."""
    from fedtpu_torch.sweep.grid import save_best_weights
    npz = os.path.join(directory, "warm.npz")
    source = branch_oracle(directory, "fedadam")["result"]
    save_best_weights(npz, {
        "weights": source.final_params,
        "params": {"hidden_layer_sizes": list(INCOME_DIMS[1:-1]),
                   "learning_rate": source.config.optim.learning_rate},
        "metrics": source.global_metrics, "accuracy":
            source.global_metrics["accuracy"][-1]})
    return npz


def phase_feature_gangs() -> tuple:
    """Phase (y): the loop's features in a training gang on the card.
    Writes the warm start's artifact (``warm_start_npz``), starts the
    three gangs side by side (y1, y2, y3), takes the one-process oracles
    while they run, holds each gang to its oracle (``gang_vs_one`` and
    ``feature_checks``) and last, alone, times the rollback's host work
    (``rollback_walk``). What the pipelined stop buys a gang is timed
    apart, each gang alone (``pipelining_pairs``)."""
    import tempfile
    numbers, seconds, by_path = {}, {}, {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 2)
        clock[0] = now

    k123 = ("weighted_average_clients", "fused_eval_confusion",
            "fused_mlp_forward")
    with tempfile.TemporaryDirectory() as directory:
        npz = warm_start_npz(directory)
        lap("warm start artifact")
        runs = {"y1 features": (feature_spec(npz), BRANCH_MEMBER_SHARDS,
                                2 * BRANCH_MEMBER_SHARDS, True)}
        for name, (_, _, extra, shards, one_shards) in FAULT_GANGS.items():
            runs[name] = (fault_spec(name), shards, one_shards,
                          "ring" not in extra)
        gangs = {}
        try:
            for i, (name, (spec, shards, _, _)) in enumerate(runs.items()):
                d = os.path.join(directory, f"g{i}")
                argv = gang_argv(d, *spec)
                gangs[name] = (d, argv, time.perf_counter(), gang_popen(
                    argv, d, shards))
            oracles = {name: one_process_run(
                os.path.join(directory, f"one{i}"), spec, shards=one_shards)
                for i, (name, (spec, _, one_shards, _)) in enumerate(
                    runs.items())}
            lap("oracles")
            outcomes = {}
            for name, (d, argv, t0, proc) in gangs.items():
                o, e = proc.communicate(timeout=900)
                outcomes[name] = gang_outcome(argv, 2, d, proc.returncode,
                                              o, e, time.perf_counter() - t0)
                outcomes[name]["argv"] = argv
            lap("gangs")
        finally:
            for _, _, _, proc in gangs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        for name, one in oracles.items():
            d = gangs[name][0]
            psum = runs[name][3]
            kernels = k123 if psum else k123[1:] + ("ring_all_reduce_sum",)
            label = f"phase (y) {name} gang of 2"
            row = gang_vs_one(label, outcomes[name], one, d, 2, psum,
                              kernels)
            row.update(feature_checks(label, d, one, outcomes[name]))
            row["median_s_round"] = {
                "gang": median_s_round(os.path.join(d, "m.jsonl")),
                "one": median_s_round(os.path.join(one["dir"], "m.jsonl"))}
            numbers[name] = row
            for i, mem in enumerate(outcomes[name]["launches"]):
                by_path[f"{label}, member {i}"] = mem
            print(f"{label}: {json.dumps(row, default=float)}; "
                  f"{CARD['smi']}", flush=True)
        lap("holds")
        numbers["rollback_walk"] = rollback_walk(directory)
        lap("rollback walk")
    print(f"phase (y) seconds {json.dumps(seconds)}", flush=True)
    numbers["seconds"] = seconds
    return by_path, numbers


def pipelining_pairs() -> None:
    """``python3 chip_smoke.py pipelining-pairs``: phase (y)'s y1 gang
    of 2 with the pipelined stop and without it, each gang alone on the
    card, in PIPELINING_ORDER (alternating, so that drift over the call
    falls on both): every history equal, and each gang's median s/round.
    Prints the numbers as one JSON line, last. Not part of the default
    run: its four gangs run one after another."""
    import tempfile
    import fedtpu_torch  # noqa: F401  (fails outside a checkout)
    phase_device()
    phase_build()
    s_round = {True: [], False: []}
    with tempfile.TemporaryDirectory() as directory:
        npz = warm_start_npz(directory)
        history = None
        for i, pipelined in enumerate(PIPELINING_ORDER):
            d = os.path.join(directory, f"g{i}")
            argv = gang_argv(d, *feature_spec(npz, pipelined))
            t0 = time.perf_counter()
            proc = gang_popen(argv, d, BRANCH_MEMBER_SHARDS)
            try:
                o, e = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            gang_outcome(argv, 2, d, proc.returncode, o, e,
                         time.perf_counter() - t0)
            got = gang_history(os.path.join(d, "m.jsonl"))
            check(history is None or got == history,
                  f"y1 gang {i} (pipelined {pipelined}): its history "
                  "differs from the first gang's")
            history = got
            s_round[pipelined].append(median_s_round(
                os.path.join(d, "m.jsonl")))
    pipe, sync = (statistics.mean(s_round[k]) for k in (True, False))
    print(f"y1 gang of 2 alone, median s/round by gang in order "
          f"{PIPELINING_ORDER}: pipelined {s_round[True]}, not "
          f"{s_round[False]}; pipelined / not {pipe / sync:.4f} (histories "
          f"equal); {CARD['smi']}", flush=True)
    print(json.dumps({"pipelined_s_round": s_round[True],
                      "not_pipelined_s_round": s_round[False],
                      "ratio": pipe / sync, "card": CARD["smi"]}), flush=True)


def main() -> None:
    import fedtpu_torch  # noqa: F401  (fails outside a checkout)
    clock, seconds = [time.perf_counter()], {}

    def lap(phase: str) -> None:
        """The command time each phase took (the script's time budget)."""
        now = time.perf_counter()
        seconds[phase] = round(now - clock[0], 2)
        clock[0] = now

    kind = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    lap("device and build")
    timings = phase_kernels(torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    timings["weighted_average_clients"]["bf16_fp16"] = k1_16bit_checks(dev)
    for name, row in parity_kernel_rows(dev).items():
        timings[name]["sklearn_parity"] = row
    lap("kernels")
    cfg = main_path_config()
    gpu, launches = phase_run("main path income-8", cfg, {
        "weighted_average_clients": "rounds",
        "fused_eval_confusion": "rounds", "fused_mlp_forward": "evals"})
    phase_card_vs_cpu(cfg, gpu)
    composed = phase_profile(cfg)
    lap("main path, card vs CPU, profile")
    by_path = {"income-8 psum": launches, **phase_sharded()}
    # K2 and K3 on the streamed path inside a whole run.
    wide = wide_config()
    gpu, by_path["income-2 (256, 256)"] = phase_run(
        "income-2 (256, 256)", wide, {
            "weighted_average_clients": "rounds",
            "fused_eval_confusion": "rounds", "fused_mlp_forward": "evals"})
    phase_card_vs_cpu(wide, gpu, label="income-2 (256, 256) card vs CPU")
    lap("sharded, streamed")
    import tempfile
    with tempfile.TemporaryDirectory() as directory:
        by_path.update(phase_csv(directory))
    by_path.update(phase_local_steps())
    by_path.update(phase_capture(composed))
    phase_resume()
    lap("(a)-(d)")
    a6_launches, timings["weighted_average_clients"]["delta_sum"] = \
        phase_a6()
    by_path.update(a6_launches)
    lap("(e)")
    by_path["income-8 sweep"], timings["weighted_average_clients"][
        "sweep"], timings["fused_eval_confusion"]["sweep"] = phase_sweep()
    by_path.update(phase_personalize())
    lap("(f), (g)")
    timings["fused_round"], by_path["income-8 fused round"] = \
        phase_fused_round(torch.Generator().manual_seed(1), composed)
    lap("fused round")
    by_path.update(phase_cifar())
    lap("(h)")
    by_path.update(phase_cifar_vs_cpu())
    lap("(i)")
    by_path.update(phase_income_bf16())
    lap("(j)")
    by_path.update(phase_parity())
    lap("(l)")
    by_path.update(phase_param_dtype())
    lap("(m)")
    by_path.update(phase_cifar_param_bf16())
    lap("(n)")
    async_launches, timings["weighted_sum_clients"] = phase_async()
    by_path.update(async_launches)
    lap("(o)")
    serve_launches, timings["weighted_sum_clients"]["serve"], serve_rows = \
        phase_serve()
    by_path.update(serve_launches)
    for name, row in serve_rows.items():
        timings[name]["serve"] = row
    lap("(p)")
    fleet_launches, timings["weighted_sum_clients"]["net_sim"], fleet = \
        phase_fleet()
    by_path.update(fleet_launches)
    print(f"phase (q) numbers {json.dumps(fleet, default=float)}", flush=True)
    lap("(q)")
    cohort_launches, cohort_rows, cohort = phase_cohort()
    by_path.update(cohort_launches)
    for name, row in cohort_rows.items():
        timings[name]["cohort"] = row
    print(f"phase (r) numbers {json.dumps(cohort, default=float)}",
          flush=True)
    lap("(r)")
    telemetry_launches, telemetry = phase_telemetry()
    by_path.update(telemetry_launches)
    print(f"phase (s) numbers {json.dumps(telemetry, default=float)}",
          flush=True)
    lap("(s)")
    resilience_launches, resilience = phase_resilience()
    by_path.update(resilience_launches)
    print(f"phase (t) numbers {json.dumps(resilience, default=float)}",
          flush=True)
    lap("(t)")
    gang_launches, gang_rows, gang = phase_gang()
    by_path.update(gang_launches)
    timings["weighted_sum_clients"]["gateway_rows"] = gang_rows[
        "gateway_rows"].pop("weighted_sum_clients")
    for tag, by_kernel in gang_rows.items():
        for name, row in by_kernel.items():
            timings[name][tag] = row
    print(f"phase (u) numbers {json.dumps(gang, default=float)}",
          flush=True)
    lap("(u)")
    train_gang_launches, train_gang = phase_train_gang()
    by_path.update(train_gang_launches)
    timings["ring_all_reduce_sum"]["gang"] = train_gang.pop("k4")
    for name, rows in train_gang.pop("member_rows").items():
        timings[name]["train_gang_members"] = rows
    print(f"phase (v) numbers {json.dumps(train_gang, default=float)}",
          flush=True)
    lap("(v)")
    elastic_launches, elastic = phase_elastic_gang()
    by_path.update(elastic_launches)
    for name, row in elastic.pop("kernel_rows").items():
        timings[name]["elastic"] = row
    print(f"phase (w) numbers {json.dumps(elastic, default=float)}",
          flush=True)
    lap("(w)")
    branch_launches, branch = phase_branch_gangs()
    by_path.update(branch_launches)
    for name, row in branch.pop("member_rows").items():
        timings[name]["branch_gang_member"] = row
    print(f"phase (x) numbers {json.dumps(branch, default=float)}",
          flush=True)
    lap("(x)")
    feature_launches, feature = phase_feature_gangs()
    by_path.update(feature_launches)
    print(f"phase (y) numbers {json.dumps(feature, default=float)}",
          flush=True)
    lap("(y)")
    print(f"phase seconds {json.dumps(seconds)}, total "
          f"{sum(seconds.values()):.1f} s", flush=True)
    # Each kernel's launches come from the path it was ported for: K1-K3
    # from income-8, K4 from the sharded ring run, K5 from the fused-round
    # benchmark, K1's sum mode (counted under K1) from the asynchronous
    # income-32-noniid run; ``launches_by_path`` has every path's, the
    # serving phase's too.
    sources = {
        "weighted_average_clients": ("weighted_average.cu",
                                     "fedtpu/ops/pallas_kernels.py:233",
                                     "income-8 psum", None),
        "fused_eval_confusion": ("eval_confusion.cu",
                                 "fedtpu/ops/pallas_kernels.py:163",
                                 "income-8 psum", None),
        "fused_mlp_forward": ("mlp_forward.cu",
                              "fedtpu/ops/pallas_kernels.py:78",
                              "income-8 psum", None),
        "ring_all_reduce_sum": ("ring_all_reduce.cu",
                                "fedtpu/parallel/ring_pallas.py:116",
                                "income-32-noniid ring", None),
        "fused_round": ("fused_round.cu",
                        "benchmarks/mega_kernel_attempt.py:138",
                        "income-8 fused round", None),
        "weighted_sum_clients": ("weighted_average.cu",
                                 "fedtpu/parallel/async_fed.py:398-403 "
                                 "(jnp.tensordot, no Pallas)",
                                 "income-32-noniid async",
                                 "weighted_average_clients")}
    kernels = []
    for name, (src, replaces, path, counter) in sources.items():
        t = timings[name]
        counter = counter or name
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fedtpu_torch/csrc/{src}", "replaces": replaces,
            "launches": by_path[path][counter],
            "launches_by_path": {p: l[counter] for p, l in by_path.items()},
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{key: t[key] for key in (
                "by_shape", "modes", "composed_ms", "plan", "back_to_back_ms",
                "empty_launch_ms", "empty_back_to_back_ms", "ms_by_threads",
                "ms_by_tile_x_threads", "composed_round_device_ms",
                "marginal_us_per_round", "profile", "phases_us",
                "delta_sum", "sweep", "cifar10_32", "bf16_fp16",
                "sklearn_parity", "serve", "net_sim", "cohort",
                "gateway_rows", "fuzz_rows", "gang", "train_gang_members",
                "elastic", "branch_gang_member")
                if key in t},
            **({"mode": "sum: K1 unnormalised, the asynchronous tick's "
                "psum(tensordot(disc, delta))"}
               if name == "weighted_sum_clients" else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["pipelining-pairs"]:
        pipelining_pairs()
    else:
        check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}; "
              "pass none, or pipelining-pairs")
        main()
