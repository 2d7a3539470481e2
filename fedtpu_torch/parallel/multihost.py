"""The training gang: one program per process, over ``torch.distributed``
(``fedtpu.parallel.multihost``).

The reference runs its scripts under ``mpirun -np N``, one rank per client
and rank 0 as the server; ``fedtpu`` runs the same single-controller
program on every host, wired by ``jax.distributed.initialize``, and its
FedAvg collective crosses the process boundary. The port's gang is N
processes of ``run``, each holding a contiguous block of the clients:

- ``initialize`` builds the process group before anything touches the
  device (the CLI calls ``initialize_from_env`` first, from the variables
  ``supervise --num-processes N`` sets: ``FEDTPU_COORDINATOR``,
  ``FEDTPU_NUM_PROCESSES``, ``FEDTPU_PROCESS_ID``). A failed init raises.
- The backend is chosen by rule, before init: NCCL when every member has a
  card of its own (``process_id % device_count``), gloo when members share
  a card (NCCL refuses two ranks on one device) or run on the CPU. Under
  gloo a collective on card tensors is staged through the host. There is
  no retry on another backend.
- Each member builds only the rows of its own clients
  (``local_client_slice``, ``fedtpu``'s rule: the contiguous block of the
  member's shards), so ``fedtpu``'s ``safe_put`` has no counterpart.

After a live reshard's shrink (``fedtpu_torch.resilience.reshard``) the
survivors run as a gang over a SUBGROUP (``split``): every collective of
the loop goes to the survivors' group, since one on the world group would
wait for the parked member forever. ``torch.distributed.new_group`` must be
called by every process of the world in the same order, members or not,
so ``split`` runs after the reshard's phase-A barrier, while the departing
member is still at its loop-top. The world group is never destroyed: a
grow back takes it up again. A process that split does not destroy the
process group at its end (``shutdown``): a parked or departed member
would be waited on.

Every collective here is a host call between the round's pieces
(``fedtpu_torch.parallel.round``), never inside a CUDA graph. Members
exchange in a fixed order, so every member ends a collective with the same
bits: ``all_gather`` gives each member the same stack, and a reduction over
it is computed the same way everywhere.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

class Gang:
    """This process's membership: ``process_index`` of ``process_count``,
    the ``backend`` and the member's ``device`` (its card, or the CPU).
    ``group``: the process group its collectives use (None: the world);
    ``ranks``: the world ranks of its members, in member order."""

    def __init__(self, process_index: int, process_count: int, backend: str,
                 device: torch.device, group=None, ranks=None):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.backend = backend
        self.device = device
        self.group = group
        self.ranks = (tuple(int(r) for r in ranks) if ranks is not None
                      else tuple(range(self.process_count)))

    def __repr__(self) -> str:
        return (f"Gang(process {self.process_index} of "
                f"{self.process_count}, {self.backend}, {self.device}"
                + (f", world ranks {list(self.ranks)}"
                   if self.group is not None else "") + ")")

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: the host under gloo (staging
        a card tensor), the member's card under NCCL."""
        t = t.detach().contiguous()
        return t.to("cpu" if self.backend == "gloo" else self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(process_count, *t.shape)``: every member's ``t`` in member
        order, on ``t``'s device."""
        import torch.distributed as dist
        src = self._wire(t)
        parts = [torch.empty_like(src) for _ in range(self.process_count)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Member ``src``'s ``t`` on every member (a fresh tensor)."""
        import torch.distributed as dist
        buf = self._wire(t).clone()
        dist.broadcast(buf, src=self.ranks[src], group=self.group)
        return buf.to(t.device)

    def all_gather_object(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.process_count
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


_GANG: Optional[Gang] = None
# Set once this process took part in a split (a live reshard): its end
# does not destroy the process group.
_SPLIT = False


def current() -> Optional[Gang]:
    """The gang this process belongs to, or None (one process)."""
    return _GANG


def choose_backend(platform: str, num_processes: int) -> tuple:
    """``(backend, device_count)`` by the rule: gloo on the CPU; on the
    card, NCCL when there are at least as many cards as members, gloo when
    members share one. No card under a card platform raises."""
    if platform == "cpu":
        return "gloo", 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a gang member runs on its card unless "
            "--platform cpu asks for the CPU")
    count = torch.cuda.device_count()
    return ("nccl" if count >= num_processes else "gloo"), count


def initialize(init_method: str, num_processes: int, process_id: int,
               platform: str = "default",
               timeout_s: Optional[float] = None) -> Gang:
    """Build the process group (``torch.distributed.init_process_group``
    with ``init_method``: ``tcp://host:port`` or ``file://path``) and make
    this process a member. Call it before anything touches the device.
    ``timeout_s`` bounds every collective (torch's default otherwise). A
    failed init raises."""
    global _GANG
    import torch.distributed as dist
    if _GANG is not None:
        raise RuntimeError(f"this process is already a member: {_GANG}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of a gang of "
                         f"{num_processes}")
    backend, count = choose_backend(platform, num_processes)
    if platform == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", process_id % count)
        if backend == "nccl":
            torch.cuda.set_device(device)
    kw = ({"timeout": datetime.timedelta(seconds=timeout_s)}
          if timeout_s else {})
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    _GANG = Gang(process_id, num_processes, backend, device)
    return _GANG


def initialize_from_env(platform: str = "default") -> Optional[Gang]:
    """Join the gang ``supervise --num-processes N`` launched this process
    into (its variables, ``fedtpu_torch.resilience.distributed``), or
    return None when there is none. Peer death is bounded by the gang
    supervisor's teardown (``--grace``) and the collective watchdog, not by
    the process group."""
    from fedtpu_torch.resilience.distributed import (ENV_COORDINATOR,
                                                     ENV_NUM_PROCESSES,
                                                     ENV_PROCESS_ID)
    coord = os.environ.get(ENV_COORDINATOR, "")
    if not coord:
        return None
    return initialize(f"tcp://{coord}", int(os.environ[ENV_NUM_PROCESSES]),
                      int(os.environ[ENV_PROCESS_ID]), platform=platform)


def split(gang: Gang, members) -> Optional[Gang]:
    """The gang of ``members`` (member indices of the world gang ``gang``,
    kept in order as members ``0..k-1``) over a new process group; None for
    a process outside it, and for a lone member (one process is no gang:
    it runs the one-process round, and no group is made). Every process of
    the world calls it, in the same order, members or not
    (``torch.distributed.new_group``'s rule)."""
    global _SPLIT
    import torch.distributed as dist
    if gang.group is not None:
        raise ValueError(f"split: {gang} is not the world gang")
    members = sorted(int(m) for m in members)
    _SPLIT = True
    if len(members) < 2:
        return None
    ranks = [gang.ranks[m] for m in members]
    group = dist.new_group(ranks=ranks, backend=gang.backend)
    if gang.process_index not in members:
        return None
    return Gang(members.index(gang.process_index), len(members),
                gang.backend, gang.device, group=group, ranks=ranks)


def shutdown() -> None:
    """Leave the gang: destroys the process group, unless this process took
    part in a split (a destroy could wait on a parked or departed
    member; the group goes with the process)."""
    global _GANG, _SPLIT
    import torch.distributed as dist
    if _GANG is not None:
        _GANG = None
        if not _SPLIT:
            dist.destroy_process_group()
        _SPLIT = False


def local_client_slice(mesh) -> slice:
    """The clients of this member's shards of ``mesh`` (``fedtpu``'s
    ``local_client_slice``); every client outside a gang."""
    lo = mesh.first_shard * mesh.clients_per_shard
    return slice(lo, lo + mesh.local_shards * mesh.clients_per_shard)


def gather_rows(gang: Optional[Gang], t: torch.Tensor) -> torch.Tensor:
    """Every member's rows of ``t`` (leading axis) stacked in member order;
    ``t`` itself outside a gang."""
    if gang is None:
        return t
    return gang.all_gather(t).reshape((-1,) + tuple(t.shape[1:]))


def describe(gang: Optional[Gang]) -> dict:
    """The manifest's view of the gang."""
    if gang is None:
        return {"process_index": 0, "process_count": 1}
    return {"process_index": gang.process_index,
            "process_count": gang.process_count,
            "collective_backend": gang.backend,
            "member_device": str(gang.device)}
