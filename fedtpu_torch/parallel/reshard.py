"""The redistribution planner of a live reshard (``fedtpu.parallel.reshard``),
in the port's flat-state terms.

A live reshard moves a federated state between two client meshes of
different extents with no restart (``fedtpu_torch.resilience.reshard`` runs
the protocol, ``fedtpu_torch.orchestration.loop`` the rebuild). Clients
block-distribute contiguously over the shards (``fedtpu_torch.parallel.
mesh``), so the plan is WIRE-FREE, as ``fedtpu``'s: on a shrink every
survivor's target rows are rows it already holds, renumbered by the kept
block's offset; on a grow the rejoining member's rows are all JOIN rows,
filled from the values the survivors' leader spooled, never from a peer. A
row that would need a peer's tensor raises: the caller turns that into
``ReshardFailed`` and the gang-restart path.

A per-client tensor is one that ``round.per_client_view`` selects (params,
the optimizer's moments and counts, SCAFFOLD's variates, the asynchronous
anchors and ``pull_tick``); every other tensor (the server optimizer's
state, the adaptive clip, the K-buffer, a gang's asynchronous ``global``)
is replicated, and the round counter, a number, passes through. Paths are
the port's flat names (``params``, ``opt_state.mu``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from fedtpu_torch.parallel.round import _per_client_slots

__all__ = ["ReshardStep", "grow_row_map", "reshard_state", "shrink_row_map"]


@dataclasses.dataclass(frozen=True)
class ReshardStep:
    """One executed plan step, the telemetry row of one state tensor
    (``fedtpu``'s fields)."""

    path: str
    kind: str       # 'client' | 'replicated'
    rows: int       # client rows this process materialized (0: replicated)
    join_rows: int  # of those, rows filled from join values, not carried
    nbytes: int     # bytes this process placed into the target state

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def shrink_row_map(keep_offset: int, dst_clients: int) -> List[int]:
    """Target row j carries source row ``keep_offset + j`` (the survivors
    keep one contiguous block, renumbered)."""
    return [keep_offset + j for j in range(dst_clients)]


def grow_row_map(src_clients: int, dst_clients: int,
                 block_start: int = 0) -> List[int]:
    """Target row j carries source row ``j - block_start`` where the shrunk
    block ``[block_start, block_start + src_clients)`` covers it (the
    survivors' rows go back to their places); every other row is a JOIN
    row (-1)."""
    return [j - block_start
            if block_start <= j < block_start + src_clients else -1
            for j in range(dst_clients)]


def reshard_state(state: dict, *, src_rows: slice, dst_rows: slice,
                  row_map: Sequence[int],
                  join_rows: Optional[Callable] = None,
                  replicated_values: Optional[Dict[str, torch.Tensor]] = None,
                  ) -> Tuple[dict, List[ReshardStep]]:
    """Execute the plan: ``(new_state, steps)``. ``state`` holds this
    process's source rows ``src_rows`` (global client rows) of every
    per-client tensor; the new state holds its target rows ``dst_rows``.
    ``row_map[j]`` is the source row carried into target row j, or -1 for
    a join row; a carried row outside ``src_rows`` raises ``ValueError``
    (the no-wire rule). ``join_rows(path, count, row_shape, dtype)`` gives
    a join row's values (default zeros: fresh moments and variates).
    ``replicated_values``: replicated tensors by path that replace the live
    ones (a rejoining member takes the spooled values). Every tensor of the
    new state is a new tensor on the state's device."""
    src_lo, src_hi = int(src_rows.start), int(src_rows.stop)
    dst_lo, dst_hi = int(dst_rows.start), int(dst_rows.stop)
    if not 0 <= dst_lo <= dst_hi <= len(row_map):
        raise ValueError(f"target rows [{dst_lo}, {dst_hi}) outside a row "
                         f"map of {len(row_map)}")
    wanted = [row_map[j] for j in range(dst_lo, dst_hi)]
    carried = [(j, s) for j, s in enumerate(wanted) if s >= 0]
    joins = [j for j, s in enumerate(wanted) if s < 0]
    foreign = [s for _, s in carried if not src_lo <= s < src_hi]
    if foreign:
        raise ValueError(
            f"source client rows {foreign} are not held by this process "
            f"(it holds [{src_lo}, {src_hi})): the wire-free plan needs the "
            "survivors to own a contiguous block holding every carried row")
    overrides = replicated_values or {}
    steps: List[ReshardStep] = []
    moved: dict = {}
    for path, t, per_client in _per_client_slots(state, src_hi - src_lo):
        name = ".".join(path)
        if per_client:
            new = torch.empty((dst_hi - dst_lo,) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            if carried:
                pos = torch.tensor([j for j, _ in carried], device=t.device)
                src = torch.tensor([s - src_lo for _, s in carried],
                                   device=t.device)
                new[pos] = t[src]
            if joins:
                fill = (join_rows(name, len(joins), tuple(t.shape[1:]),
                                  t.dtype) if join_rows is not None else
                        torch.zeros((len(joins),) + tuple(t.shape[1:]),
                                    dtype=t.dtype))
                new[torch.tensor(joins, device=t.device)] = fill.to(
                    device=t.device, dtype=t.dtype)
            steps.append(ReshardStep(name, "client", dst_hi - dst_lo,
                                     len(joins),
                                     new.numel() * new.element_size()))
        else:
            value = overrides.get(name, t)
            new = torch.as_tensor(value).to(device=t.device, dtype=t.dtype,
                                            copy=True).reshape(t.shape)
            steps.append(ReshardStep(name, "replicated", 0, 0,
                                     new.numel() * new.element_size()))
        moved[path] = new

    def rebuild(tree, prefix):
        return {k: (rebuild(v, prefix + (k,)) if isinstance(v, dict)
                    else moved.get(prefix + (k,), v))
                for k, v in tree.items()}

    return rebuild(state, ()), steps
