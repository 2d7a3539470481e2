"""The ``check`` driver: prove the round step is capture-free in steady
state (``fedtpu.analysis.check`` in torch terms).

Builds a small synthetic experiment, captures the round step once (the
warm-up: one eager step, then the CUDA graph capture), then replays it
``rounds`` times under an armed :class:`RecompileSentinel`. A
steady-state round loop replays its graph and builds nothing, so any
compile event observed while armed — a recapture or an nvcc build — is
the failure ``fedtpu``'s retrace check looks for: the one that silently
multiplies round latency.

The transfer guard (``torch.cuda.set_sync_debug_mode``) is armed around
each replay only — the queued work — and not over the chunk-end host
read after the window, which ``fedtpu``'s guard also allows as an
explicit ``device_get``; the sentinel stays armed over that read, the
completion proof. ``nans`` checks every state tensor for finiteness after
each armed step (``first_nonfinite``) and names the first bad one. On the
CPU the step runs eagerly: nothing is captured and the transfer guard
does not apply (``transfer_guard_applies`` False).

The check runs the real engine path (``build_experiment`` →
``make_step`` → ``capture_round_step``), not a toy model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from fedtpu_torch.analysis.guards import (RecompileSentinel, first_nonfinite,
                                          guards, transfer_guard_applies)


def run_check(*, preset: str = "income-8", rounds: int = 4,
              transfer: str = "log", nans: bool = False,
              synthetic_rows: int = 512, registry=None,
              device="cuda") -> dict:
    """Run the capture/transfer check; returns a JSON-serializable report
    with ``fedtpu``'s keys (``warmup_cache`` always None: the persistent
    compilation cache is ROADMAP A11c) and the port's own:
    ``transfer_guard_applies``, ``nonfinite`` (the first non-finite state
    tensor's name with ``nans``, else None) and ``armed_s_per_round`` (the
    armed window's host seconds a round, its final read included).

    ``recompiles`` is the armed-window compile-event count — 0 means the
    steady-state step replays its graph. ``ok`` folds that, sentinel
    availability and (with ``nans``) finiteness into one gate bit."""
    import torch

    from fedtpu_torch.config import get_preset
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.parallel.round import capture_round_step, warm_up_round

    cfg = get_preset(preset)
    # The small synthetic dataset: the check probes capture behavior, not
    # accuracy, and must run in seconds.
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, csv_path=None, dataset_name=None,
        synthetic_rows=synthetic_rows))
    exp = build_experiment(cfg, device=device)
    dev = exp.device
    step = exp.make_step(1)
    state, batch = exp.state, exp.batch
    masks = (step.draw_masks(0, 1).to(dev)
             if step.draw_masks is not None else None)
    noise = (step.draw_noise(0, 1).to(dev)
             if step.draw_noise is not None else None)

    if dev.type == "cuda":
        # The one expected compile: warm-up and capture, outside the
        # armed window.
        warm_up_round(step, state, batch)
        graph = capture_round_step(step, state, batch)

        def one_round():
            return graph(masks, noise)
    else:
        def one_round():
            nonlocal state
            state, raw = step.fn(state, batch, masks, noise)
            return raw["loss"]

    sentinel = RecompileSentinel(label=f"round_step[{preset}]",
                                 registry=registry)
    nonfinite = None
    t0 = time.perf_counter()
    with sentinel.armed():
        for _ in range(rounds):
            with guards(transfer=transfer, device=dev):
                out = one_round()
            if nans and nonfinite is None:
                nonfinite = first_nonfinite(
                    graph.state if dev.type == "cuda" else state)
        # Completion proof inside the armed window, outside the transfer
        # guard: the chunk-end host read.
        out.cpu()
    armed_s = time.perf_counter() - t0

    return {
        "preset": preset,
        "rounds": rounds,
        "transfer_guard": transfer,
        "debug_nans": nans,
        "warmup_cache": None,
        "sentinel_available": sentinel.available,
        "recompiles": sentinel.count,
        "backend": dev.type,
        "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                         else 1),
        "transfer_guard_applies": transfer_guard_applies(dev),
        "nonfinite": nonfinite,
        "armed_s_per_round": armed_s / max(1, rounds),
        "ok": bool(sentinel.available and sentinel.count == 0
                   and nonfinite is None),
    }
