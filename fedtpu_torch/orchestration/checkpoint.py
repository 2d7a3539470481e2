"""Round-indexed checkpoint and resume (``fedtpu.orchestration.checkpoint``).

The full federated state is saved: per-client params, per-client optimizer
state (Adam's moments are never averaged, so they are real per-client
state), the server optimizer's state, SCAFFOLD's variates, the adaptive DP
clip, the asynchronous engine's anchors, pull ticks and K-buffer, and the
round counter, with the client-mean metric history and the
privacy ledger's curve (``extra_meta``) in the meta file. Files
are ``torch.save`` archives of CPU tensors, read back with
``torch.load(..., weights_only=True)``; one process writes them.

Layout: ``<dir>/round_<step>/{state,meta}``, as ``fedtpu``'s. Each file is
written to a temporary name and renamed, and ``meta`` is written last, so a
round counts as committed only when both exist (``_is_complete``): a crash
mid-save leaves a round that resume does not see.

The default telemetry registry counts ``checkpoint_saves``,
``checkpoint_bytes_written`` (the saved state's tensor bytes),
``checkpoint_restores`` and ``checkpoint_restore_corrupt``, as
``fedtpu``'s layer does.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from fedtpu_torch.telemetry.metrics import default_registry, tree_nbytes


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"round_{step:06d}")


def state_file(directory: str, step: int) -> str:
    """The state archive of round ``step`` (``<dir>/round_<step>/state``):
    what a ``ckpt_corrupt`` fault truncates and the fallback walk skips."""
    return os.path.join(_ckpt_path(directory, step), "state")


def _to_cpu(tree):
    """A copy of ``tree`` with every tensor on the CPU (numbers kept)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write(obj, path: str) -> None:
    """``torch.save`` to a temporary name, then rename: a reader sees the
    whole file or none."""
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(directory: str, state: dict, history: dict,
                    step: int, extra_meta: Optional[dict] = None) -> str:
    """Write ``state`` and ``{history, step, num_clients, engine_async,
    **extra_meta}`` under ``directory/round_<step>``. ``num_clients`` lives in the small
    meta file, so elastic-resume detection reads no state. Empty metric
    lists are dropped, as ``fedtpu`` drops them. ``extra_meta``: small
    arrays and scalars (the privacy ledger's), numpy arrays stored as
    tensors."""
    path = _ckpt_path(directory, step)
    os.makedirs(path, exist_ok=True)
    state_item = _to_cpu(state)
    _write(state_item, os.path.join(path, "state"))
    # The engine that wrote the state, as fedtpu's int flag: the
    # asynchronous engine's state carries anchors, the synchronous one's
    # never does. Resume reads it before the client count, so a resume
    # under the other engine fails on the engine.
    meta = {"history": {k: torch.tensor(np.asarray(v, dtype=np.float64))
                        for k, v in history.items() if len(v)},
            "step": int(step),
            "num_clients": int(state["params"].shape[0]),
            "engine_async": int("anchors" in state)}
    for k, v in (extra_meta or {}).items():
        meta[k] = (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                   else v)
    _write(meta, os.path.join(path, "meta"))
    reg = default_registry()
    reg.counter("checkpoint_saves").inc()
    reg.counter("checkpoint_bytes_written").inc(tree_nbytes(state_item))
    return path


def _is_complete(path: str) -> bool:
    """A round is COMMITTED only when both files exist at their final
    names; ``meta`` is written last."""
    return (os.path.isfile(os.path.join(path, "state"))
            and os.path.isfile(os.path.join(path, "meta")))


def _step_of(name: str) -> Optional[int]:
    """Step of a ``round_<N>`` directory name; None for anything else."""
    if not name.startswith("round_"):
        return None
    try:
        return int(name.split("_")[1])
    except (IndexError, ValueError):
        return None


def _scan_rounds(directory: str) -> list:
    """Every round dir under ``directory`` as sorted (step, complete)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        step = _step_of(name)
        if step is not None:
            out.append((step, _is_complete(os.path.join(directory, name))))
    return sorted(out)


def complete_steps(directory: str) -> list:
    """Sorted steps of every COMPLETE checkpoint under ``directory``."""
    return [s for s, ok in _scan_rounds(directory) if ok]


def latest_step(directory: str) -> Optional[int]:
    """Largest COMPLETE checkpoint step under ``directory``."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def retain_checkpoints(directory: str, keep: int,
                       protect: Tuple[int, ...] = ()) -> list:
    """Delete all but the ``keep`` newest complete rounds (plus the
    ``protect``-ed steps; the loop protects the best-accuracy round) and
    return the deleted steps; ``keep <= 0`` keeps everything. Incomplete
    rounds older than the newest complete one are crash remnants and go
    too; one at or above it may be a writer mid-commit and stays. A round
    that cannot be deleted warns and stays: disk clean-up never stops a
    run."""
    if keep <= 0:
        return []
    rounds = _scan_rounds(directory)
    steps = [s for s, ok in rounds if ok]
    kept = set(steps[-keep:]) | {int(p) for p in protect}
    removed = []

    def _rm(step):
        try:
            shutil.rmtree(_ckpt_path(directory, step))
            removed.append(step)
        except OSError as e:
            warnings.warn(f"checkpoint retention: could not delete "
                          f"round {step} ({e}); will retry after the "
                          "next save", RuntimeWarning)

    for s in steps:
        if s not in kept:
            _rm(s)
    if steps:
        for s, ok in rounds:
            if not ok and s < steps[-1]:
                _rm(s)
    return sorted(removed)


def _history(meta: dict) -> dict:
    return {k: [float(v) for v in t.tolist()]
            for k, t in (meta.get("history") or {}).items()}


def load_meta(directory: str, step: Optional[int] = None) -> dict:
    """The meta file of a checkpoint (history, step, num_clients and the
    ``extra_meta`` it was saved with); the newest complete one by
    default."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return _read(os.path.join(_ckpt_path(directory, step), "meta"))


def load_checkpoint_raw(directory: str, step: Optional[int] = None
                        ) -> Tuple[dict, dict, int]:
    """``(state, history, step)`` of a checkpoint as saved: CPU tensors at
    the saved client count; the newest complete one by default."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _ckpt_path(directory, step)
    state = _read(os.path.join(path, "state"))
    meta = _read(os.path.join(path, "meta"))
    default_registry().counter("checkpoint_restores").inc()
    return state, _history(meta), int(meta["step"])


def saved_num_clients(raw_state: dict) -> int:
    """Client count of a raw checkpoint: the params' leading axis."""
    return int(raw_state["params"].shape[0])


def load_checkpoint_fallback(directory: str) -> Tuple[dict, dict, int]:
    """``load_checkpoint_raw`` of the NEWEST complete round that actually
    loads, walking back past rounds that fail to (a commit proves both
    files were renamed into place, not that their bytes are intact). Each
    failure warns. Raises FileNotFoundError when none loads."""
    steps = complete_steps(directory)
    last_err: Optional[Exception] = None
    for step in reversed(steps):
        try:
            return load_checkpoint_raw(directory, step)
        except Exception as e:
            last_err = e
            default_registry().counter("checkpoint_restore_corrupt").inc()
            warnings.warn(f"checkpoint round {step} failed to restore "
                          f"({type(e).__name__}: {e}); falling back to the "
                          "previous round", RuntimeWarning)
    raise FileNotFoundError(
        f"no restorable checkpoint under {directory} "
        f"({len(steps)} complete-looking round(s) all failed to load)"
    ) from last_err
