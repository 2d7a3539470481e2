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
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

CLIENTS_AXIS = "clients"


def trim_to_divisor(n: int, num_clients: int) -> int:
    """Largest extent <= n that divides num_clients (so the client axis
    block-distributes evenly); n unchanged when num_clients == 0."""
    if num_clients:
        while num_clients % n:
            n -= 1
    return n


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """``num_shards`` shards of ``clients_per_shard`` clients each; shard
    ``d`` holds clients ``[d * clients_per_shard, (d + 1) *
    clients_per_shard)`` and lives on ``devices[d]``."""

    num_shards: int
    clients_per_shard: int
    devices: Tuple[torch.device, ...]


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
              device="cuda") -> ClientMesh:
    """A 1-D clients mesh of ``num_devices`` shards (0 = one per visible
    device of ``device``'s type, or just ``device`` when it names an
    index), trimmed to the largest extent that divides ``num_clients``."""
    visible = _visible(torch.device(device))
    if not visible:
        raise RuntimeError(f"no visible {torch.device(device).type} device")
    if num_devices < 0:
        raise ValueError("num_devices must be >= 0")
    n = trim_to_divisor(num_devices or len(visible), num_clients)
    return ClientMesh(
        num_shards=n,
        clients_per_shard=num_clients // n if num_clients else 0,
        devices=tuple(visible[d % len(visible)] for d in range(n)))
