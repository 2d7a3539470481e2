"""Wall-clock timing for the port's benchmarks (``fedtpu.utils.timing``).

PyTorch returns before the device finishes, so a host clock closed without a
synchronisation measures the enqueue, not the work. ``force_fetch`` closes a
timed window: it synchronises the device and copies one scalar of the result
to the host. ``assert_above_flops_floor`` refuses a time that beats physics,
and ``marginal_slope`` takes the per-iteration cost as the slope between two
program lengths, so fixed per-call costs cancel.

``fedtpu``'s ``Timer`` and its JAX-program tooling (``program_flops``,
``program_bytes_accessed``, ``compile_with_flops``, ``timed_rounds``,
``measured_peak_flops``) have no counterpart here yet.
"""

from __future__ import annotations

import time

import torch


def force_fetch(result: torch.Tensor) -> float:
    """Synchronise ``result``'s device and copy its last scalar to the host;
    returns that scalar."""
    if result.is_cuda:
        torch.cuda.synchronize(result.device)
    return float(result.reshape(-1)[-1]) if result.numel() else 0.0


def assert_above_flops_floor(sec_per_round: float, flops_per_round: float,
                             peak_flops: float, label: str = "") -> float:
    """Physics guard for benchmark numbers: no program runs its flops faster
    than 2x the device's peak. A violation means the timed window did not
    capture the work (an enqueue rate, not a compute rate) and raises.
    Returns the floor."""
    floor = flops_per_round / (2.0 * peak_flops)
    if sec_per_round < floor:
        raise RuntimeError(
            f"timing methodology broken{' (' + label + ')' if label else ''}:"
            f" measured {sec_per_round:.3e} s/round but the program costs "
            f"{flops_per_round:.3e} FLOPs and the device peaks at "
            f"{peak_flops:.3e} FLOP/s — physical floor {floor:.3e} s/round. "
            "The timed window is not capturing execution; close it with "
            "force_fetch.")
    return floor


def marginal_slope(make_fn, lens=(1000, 4000), reps=4) -> float:
    """Marginal seconds per iteration as the slope ``(t(lens[1]) -
    t(lens[0])) / (lens[1] - lens[0])``, each window closed by
    ``force_fetch`` and the fastest of ``reps`` kept, after one warm-up
    call. ``make_fn(R)`` returns a zero-argument callable that runs R
    iterations and returns a tensor for ``force_fetch``."""
    ts = []
    for length in lens:
        fn = make_fn(length)
        force_fetch(fn())                  # warm-up (and any build)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            force_fetch(fn())
            best = min(best, time.perf_counter() - t0)
        ts.append(best)
    return (ts[1] - ts[0]) / (lens[1] - lens[0])
