"""The clients mesh (``fedtpu.parallel.mesh``): how the client axis is cut
into shards and where each shard lives.

``fedtpu`` lays a 1-D ``('clients',)`` ``jax.sharding.Mesh`` over its
devices and block-distributes the C clients, C / n per device. The port
keeps the same arithmetic in a small ``ClientMesh``: the number of shards,
the clients per shard, and the torch device of each shard. The round
(``fedtpu_torch.parallel.round``) reads it to cut the ``(C, D)`` client stack
into ``(S, C/S, D)`` shard blocks for the ring reductions.

One difference from ``fedtpu``, on purpose: ``fedtpu`` caps the mesh at the
visible devices. The port lays ``num_devices`` shards over the visible
devices of the chosen type, round-robin, several shards to a device when
there are fewer devices than shards. That is the counterpart of ``fedtpu``'s
8-device virtual CPU mesh, on which its tests run every ring schedule: with
``num_devices=8`` on one H100, the 8 shards are co-resident on the card and
the ring kernel exchanges between them there. ``num_devices=0`` gives one
shard per visible device: 1 on one H100 (or on the CPU), where the ring is
the identity, as in ``fedtpu``.

In a training gang (``fedtpu_torch.parallel.multihost``) the mesh is the
gang's: ``num_shards`` global shards, member p holding the contiguous block
``[p * local_shards, (p + 1) * local_shards)`` (``fedtpu``'s
``local_client_slice``), its shards co-resident on its own device as in one
process. ``num_devices=0`` gives each member ``FEDTPU_SHARDS_PER_PROCESS``
shards (default one per device it sees), the counterpart of the virtual
devices per process that ``fedtpu``'s gang takes from
``--xla_force_host_platform_device_count``; one process reads no such
variable.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

CLIENTS_AXIS = "clients"
# The shards a process lays over its devices when the mesh size is not
# given (num_devices=0).
ENV_SHARDS_PER_PROCESS = "FEDTPU_SHARDS_PER_PROCESS"


def trim_to_divisor(n: int, num_clients: int) -> int:
    """Largest extent <= n that divides num_clients (so the client axis
    block-distributes evenly); n unchanged when num_clients == 0."""
    if num_clients:
        while num_clients % n:
            n -= 1
    return n


def check_gang_shape(shards: int, processes: int, num_clients: int) -> None:
    """The one divisibility rule of a gang's mesh (``make_mesh``) and of a
    shrunk one (``submesh``): the clients split evenly over the shards and
    the shards over the processes. A shape that does not raises, naming
    it."""
    if shards % processes or not shards or (num_clients
                                            and num_clients % shards):
        raise ValueError(
            f"a gang of {processes} processes lays {shards} shards over "
            f"{num_clients} clients: the clients must split evenly over the "
            f"shards and the shards over the processes (clients "
            f"{num_clients} = processes {processes} x shards per process "
            f"{shards / processes:g} x clients per shard)")


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """``num_shards`` shards of ``clients_per_shard`` clients each; shard
    ``d`` holds clients ``[d * clients_per_shard, (d + 1) *
    clients_per_shard)``. In a gang of ``num_processes``, this member
    (``process_index``) holds ``local_shards`` of them from
    ``first_shard``; ``devices`` are the devices of this member's shards,
    in order (all shards in one process)."""

    num_shards: int
    clients_per_shard: int
    devices: Tuple[torch.device, ...]
    num_processes: int = 1
    process_index: int = 0

    @property
    def local_shards(self) -> int:
        return self.num_shards // self.num_processes

    @property
    def first_shard(self) -> int:
        return self.process_index * self.local_shards

    @property
    def local_clients(self) -> int:
        return self.local_shards * self.clients_per_shard


def _visible(device: torch.device) -> list:
    if device.type == "cpu":
        return [torch.device("cpu")]
    if device.type == "cuda":
        if device.index is not None:
            return [device]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    raise ValueError(f"unsupported device {device}")


def make_mesh(num_devices: int = 0, num_clients: int = 0,
              device="cuda", gang=None) -> ClientMesh:
    """A 1-D clients mesh of ``num_devices`` shards (0 = one per visible
    device of ``device``'s type, or just ``device`` when it names an
    index; in a ``gang``, ``FEDTPU_SHARDS_PER_PROCESS`` a member when set,
    the members each counting their own), trimmed to the largest extent
    that divides ``num_clients``. In a ``gang`` the extent is global and must split
    evenly over the members, and ``num_clients`` over the extent; a shape
    that does not raises, naming it."""
    visible = _visible(torch.device(device))
    if not visible:
        raise RuntimeError(f"no visible {torch.device(device).type} device")
    if num_devices < 0:
        raise ValueError("num_devices must be >= 0")
    procs = 1 if gang is None else gang.process_count
    # The members' stand-in for fedtpu's virtual devices a process; one
    # process reads no such variable.
    per_process = 0 if gang is None else int(
        os.environ.get(ENV_SHARDS_PER_PROCESS, "0") or 0)
    n = num_devices or procs * (per_process or len(visible))
    if gang is None:
        n = trim_to_divisor(n, num_clients)
    else:
        check_gang_shape(n, procs, num_clients)
    local = n // procs
    return ClientMesh(
        num_shards=n,
        clients_per_shard=num_clients // n if num_clients else 0,
        devices=tuple(visible[d % len(visible)] for d in range(local)),
        num_processes=procs,
        process_index=0 if gang is None else gang.process_index)


def submesh(mesh: ClientMesh, process_indices=None, num_shards: int = 0,
            num_clients: int = 0) -> Tuple[ClientMesh, Tuple[int, ...]]:
    """A live reshard's mesh (``fedtpu``'s ``submesh``) over a subset of
    ``mesh``'s shards, in their original order, and the source shards it
    keeps. ``process_indices``: a gang's survivors keep their own shards,
    and become members ``0..k-1`` of a gang of ``k``; this process must be
    one of them. Otherwise the first ``num_shards`` shards (all when 0).
    Either way the extent is trimmed to divide ``num_clients`` when given,
    and a gang's shrunk shape obeys ``check_gang_shape``. A shard stands
    for one of ``fedtpu``'s devices, so a target client count is a whole
    number of shards: the caller checks that the kept shards hold it."""
    local = mesh.local_shards
    if process_indices is not None:
        members = sorted(set(int(p) for p in process_indices))
        if mesh.process_index not in members:
            raise ValueError(f"submesh: process {mesh.process_index} is not "
                             f"among the survivors {members}")
        shards = [p * local + j for p in members for j in range(local)]
    else:
        members = None
        shards = list(range(mesh.num_shards))
    if not shards:
        raise ValueError("submesh: no shards left for the requested "
                         f"process set {members}")
    n = trim_to_divisor(min(num_shards or len(shards), len(shards)),
                        num_clients)
    kept = tuple(shards[:n])
    cps = num_clients // n if num_clients else mesh.clients_per_shard
    if members is not None and len(members) > 1:
        check_gang_shape(n, len(members), num_clients)
        return ClientMesh(num_shards=n, clients_per_shard=cps,
                          devices=mesh.devices[:n // len(members)],
                          num_processes=len(members),
                          process_index=members.index(mesh.process_index)
                          ), kept
    return ClientMesh(num_shards=n, clients_per_shard=cps,
                      devices=mesh.devices[:n]
                      if mesh.num_processes == 1 else
                      tuple(mesh.devices[j % len(mesh.devices)]
                            for j in range(n))), kept
