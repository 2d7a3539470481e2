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

A training gang (``fedtpu_torch.parallel.multihost``) saves collectively,
as ``fedtpu``'s orbax save does with each process persisting the client
shards it owns: member i of P writes its own clients' rows as
``state.p<i>-of-<P>``, the members meet at a barrier, and process 0 then
writes ``meta`` (the history, the gang's client count, ``num_processes``).
Such a round is complete when ``meta`` and all P parts are there, and a
gang's fallback walk past a round that fails to load is one decision of
the whole gang (``load_checkpoint_fallback(gang=)``). A gang of
the same size restores it bit for bit, each member its own part. A gang of
another size, or one process, restores it too (an elastic resume, or the
resume of a shrunk gang's round): each member reads the parts that cover
its rows and takes its rows of them, bit for bit; a one-process round
restores into a gang the same way.

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


def state_files(directory: str, step: int) -> list:
    """Every state archive of round ``step``: its one ``state``, or a gang
    round's parts ``state.p<i>-of-<P>`` in member order (``P`` from its
    meta)."""
    path = _ckpt_path(directory, step)
    procs = int(_read(os.path.join(path, "meta")).get("num_processes", 1))
    if procs == 1:
        return [os.path.join(path, "state")]
    return [os.path.join(path, part_name(i, procs)) for i in range(procs)]


def _to_cpu(tree):
    """A copy of ``tree`` with every tensor on the CPU (numbers kept)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def part_name(process_index: int, process_count: int) -> str:
    """A gang member's state file in a round directory."""
    return f"state.p{process_index}-of-{process_count}"


def _write(obj, path: str) -> None:
    """``torch.save`` to a temporary name, then rename: a reader sees the
    whole file or none."""
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(directory: str, state: dict, history: dict,
                    step: int, extra_meta: Optional[dict] = None,
                    gang=None) -> str:
    """Write ``state`` and ``{history, step, num_clients, engine_async,
    **extra_meta}`` under ``directory/round_<step>``. ``num_clients`` lives in the small
    meta file, so elastic-resume detection reads no state. Empty metric
    lists are dropped, as ``fedtpu`` drops them. ``extra_meta``: small
    arrays and scalars (the privacy ledger's), numpy arrays stored as
    tensors. In a ``gang`` every member calls it: each writes its part, and
    process 0 the meta once every part is written (a barrier)."""
    path = _ckpt_path(directory, step)
    os.makedirs(path, exist_ok=True)
    state_item = _to_cpu(state)
    procs = 1 if gang is None else gang.process_count
    _write(state_item, os.path.join(
        path, "state" if gang is None
        else part_name(gang.process_index, procs)))
    if gang is not None:
        gang.barrier()
    # The engine that wrote the state, as fedtpu's int flag: the
    # asynchronous engine's state carries anchors, the synchronous one's
    # never does. Resume reads it before the client count, so a resume
    # under the other engine fails on the engine.
    meta = {"history": {k: torch.tensor(np.asarray(v, dtype=np.float64))
                        for k, v in history.items() if len(v)},
            "step": int(step),
            "num_clients": int(state["params"].shape[0]) * procs,
            "engine_async": int("anchors" in state)}
    if gang is not None:
        meta["num_processes"] = procs
    for k, v in (extra_meta or {}).items():
        meta[k] = (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                   else v)
    if gang is None or gang.process_index == 0:
        _write(meta, os.path.join(path, "meta"))
    reg = default_registry()
    reg.counter("checkpoint_saves").inc()
    reg.counter("checkpoint_bytes_written").inc(tree_nbytes(state_item))
    return path


def _is_complete(path: str) -> bool:
    """A round is COMMITTED only when ``meta``, written last, and the
    state exist at their final names: one ``state``, or every part of a
    gang's ``state.p<i>-of-<P>``."""
    if not os.path.isfile(os.path.join(path, "meta")):
        return False
    if os.path.isfile(os.path.join(path, "state")):
        return True
    try:
        names = set(os.listdir(path))
    except OSError:
        return False
    counts = {n.rsplit("-of-", 1)[1] for n in names
              if n.startswith("state.p") and "-of-" in n}
    return any(c.isdigit() and int(c) > 0
               and all(part_name(i, int(c)) in names for i in range(int(c)))
               for c in counts)


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


def _client_rows(tree: dict, num_clients: int, pick) -> dict:
    """``tree`` with each per-client tensor (``round.per_client_view``'s
    rule at ``num_clients``) replaced by ``pick(tensor)``."""
    from fedtpu_torch.parallel.round import _per_client_slots
    flags = {path: pc for path, _, pc in _per_client_slots(tree,
                                                           num_clients)}

    def walk(t, prefix):
        return {k: (walk(v, prefix + (k,)) if isinstance(v, dict)
                    else pick(v) if flags.get(prefix + (k,)) else v)
                for k, v in t.items()}
    return walk(tree, ())


def _read_rows(path: str, saved: int, num_clients: int, lo: int,
               hi: int) -> dict:
    """Client rows ``[lo, hi)`` of a round saved by ``saved`` processes:
    the parts that cover them, each holding ``num_clients / saved`` rows,
    concatenated in member order; the replicated entries from the first
    of them."""
    held = num_clients // saved
    if saved == 1:
        parts, base = [_read(os.path.join(path, "state"))], 0
    else:
        first, last = lo // held, -(-hi // held)
        parts = [_read(os.path.join(path, part_name(j, saved)))
                 for j in range(first, last)]
        base = first * held
    # Each part's per-client tensors wrapped in a list, so that the join
    # below can tell them from the replicated ones.
    lists = [_client_rows(p, held, lambda t: [t]) for p in parts]

    def join(trees):
        return {k: (join([t[k] for t in trees])
                    if isinstance(trees[0][k], dict)
                    else torch.cat([t[k][0] for t in trees])
                    if isinstance(trees[0][k], list) else trees[0][k])
                for k in trees[0]}
    return _client_rows(join(lists), held * len(parts),
                        lambda t: t[lo - base:hi - base].clone())


def load_checkpoint_raw(directory: str, step: Optional[int] = None,
                        part: Optional[tuple] = None
                        ) -> Tuple[dict, dict, int]:
    """``(state, history, step)`` of a checkpoint as saved: CPU tensors;
    the newest complete one by default. ``part`` ``(process_index,
    process_count)``: a gang member's rows (its block of the saved client
    count), else every client. A round saved by a gang of the same size
    gives each member its own part; any other layout (one process, or a
    gang of another size) gives the rows from the parts that cover them,
    bit for bit."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _ckpt_path(directory, step)
    meta = _read(os.path.join(path, "meta"))
    saved = int(meta.get("num_processes", 1))
    procs = 1 if part is None else int(part[1])
    if saved == procs:
        state = _read(os.path.join(path, "state" if part is None
                                   else part_name(*part)))
    else:
        num_clients = int(meta["num_clients"])
        per = num_clients // procs
        lo = 0 if part is None else int(part[0]) * per
        state = _read_rows(path, saved, num_clients, lo, lo + per)
    default_registry().counter("checkpoint_restores").inc()
    return state, _history(meta), int(meta["step"])


def saved_num_clients(raw_state: dict) -> int:
    """Client count of a raw checkpoint: the params' leading axis."""
    return int(raw_state["params"].shape[0])


def load_checkpoint_fallback(directory: str, part: Optional[tuple] = None,
                             max_step: Optional[int] = None, gang=None
                             ) -> Tuple[dict, dict, int]:
    """``load_checkpoint_raw`` of the NEWEST complete round (at most
    ``max_step``: a gang's agreed step) that actually loads, walking back
    past rounds that fail to (a commit proves both files were renamed into
    place, not that their bytes are intact). Each failure warns and counts
    ``checkpoint_restore_corrupt``. Raises FileNotFoundError when none
    loads. ``part``: ``load_checkpoint_raw``'s.

    In a ``gang`` the walk is one decision, as ``fedtpu``'s one collective
    orbax read is: every member tries its own part of its newest candidate,
    and one ``all_gather`` of ``(candidate, loaded)`` bounds the next try
    by the newest step every member loaded; a member that loaded a newer
    step than that drops it. Every member returns the same step, or every
    member raises."""
    steps = [s for s in complete_steps(directory)
             if max_step is None or s <= max_step]
    last_err: Optional[Exception] = None
    bound = None
    while True:
        cand = [s for s in steps if bound is None or s <= bound]
        step = cand[-1] if cand else -1
        got = None
        if step >= 0:
            try:
                got = load_checkpoint_raw(directory, step, part=part)
            except Exception as e:
                last_err = e
                default_registry().counter("checkpoint_restore_corrupt").inc()
                warnings.warn(f"checkpoint round {step} failed to restore "
                              f"({type(e).__name__}: {e}); falling back to "
                              "the previous round", RuntimeWarning)
        # (candidate, loaded) of every member, in member order.
        tried = [(step, int(got is not None))]
        if gang is not None:
            tried = gang.all_gather(torch.tensor(tried[0])).tolist()
        if min(s for s, _ in tried) < 0:
            break
        if all(ok for _, ok in tried) and len({s for s, _ in tried}) == 1:
            return got
        # The newest step every member may still load.
        bound = min(s if ok else s - 1 for s, ok in tried)
    raise FileNotFoundError(
        f"no restorable checkpoint under {directory} "
        f"({len(steps)} complete-looking round(s) all failed to load"
        + ("" if gang is None else " on some member of the gang") + ")"
    ) from last_err
