"""Client sharding and packing (``fedtpu.data.sharding``), numpy only.

Seeded numpy on both sides, so the packed arrays are bitwise ``fedtpu``'s.
Every shard is padded to the longest one (rounded up to ``pad_multiple``)
with a ``(clients, samples)`` validity mask and the true per-client counts,
which drive the data-size-weighted FedAvg.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from fedtpu_torch.config import ShardConfig


@dataclasses.dataclass
class ClientBatch:
    """Dense, padded per-client data; leading axis = clients."""

    x: np.ndarray       # (C, N_pad, ...) float32
    y: np.ndarray       # (C, N_pad) int32
    mask: np.ndarray    # (C, N_pad) float32, 1.0 for real samples
    counts: np.ndarray  # (C,) int32 true shard sizes

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]


def _contiguous_bounds(num_samples: int, num_clients: int):
    """``chunk = max(1, n // C)``; client c takes [c*chunk, (c+1)*chunk) and
    the last client the remainder."""
    chunk = max(1, num_samples // num_clients)
    bounds = []
    for c in range(num_clients):
        start = c * chunk
        end = start + chunk if c != num_clients - 1 else num_samples
        bounds.append((min(start, num_samples), min(max(end, start), num_samples)))
    return bounds


def shard_indices(y: np.ndarray, cfg: ShardConfig) -> List[np.ndarray]:
    """Return per-client index arrays into the train set."""
    n = len(y)
    c = cfg.num_clients
    rng = np.random.default_rng(cfg.shard_seed)

    if cfg.strategy == "contiguous":
        if cfg.shuffle and cfg.unseeded_per_client_bug:
            # Reference bug parity: each client draws its own unseeded
            # permutation of the full set, so shards overlap.
            return [np.random.permutation(n)[start:end]
                    for start, end in _contiguous_bounds(n, c)]
        perm = rng.permutation(n) if cfg.shuffle else np.arange(n)
        return [perm[start:end] for start, end in _contiguous_bounds(n, c)]

    if cfg.strategy == "label_sort":
        order = np.argsort(y, kind="stable")
        return [order[start:end] for start, end in _contiguous_bounds(n, c)]

    if cfg.strategy == "dirichlet":
        # Per class, split its samples across clients with Dirichlet(alpha)
        # proportions; small alpha => heavy label skew.
        classes = np.unique(y)
        client_idx = [[] for _ in range(c)]
        for k in classes:
            idx_k = rng.permutation(np.flatnonzero(y == k))
            props = rng.dirichlet(np.full(c, cfg.dirichlet_alpha))
            cuts = (np.cumsum(props)[:-1] * len(idx_k)).astype(int)
            for client, part in enumerate(np.split(idx_k, cuts)):
                client_idx[client].append(part)
        return [rng.permutation(np.concatenate(parts)) if parts else
                np.empty((0,), dtype=np.int64) for parts in client_idx]

    raise ValueError(f"unknown shard strategy {cfg.strategy!r}")


def pack_clients(x: np.ndarray, y: np.ndarray, cfg: ShardConfig,
                 pad_multiple: int = 8) -> ClientBatch:
    """Shard then pack into padded dense arrays (see module docstring)."""
    idx = shard_indices(y, cfg)
    max_n = max((len(i) for i in idx), default=0)
    max_n = max(1, -(-max_n // pad_multiple) * pad_multiple)

    c = cfg.num_clients
    xp = np.zeros((c, max_n) + x.shape[1:], dtype=np.float32)
    yp = np.zeros((c, max_n), dtype=np.int32)
    mask = np.zeros((c, max_n), dtype=np.float32)
    counts = np.zeros((c,), dtype=np.int32)
    for client, ids in enumerate(idx):
        k = len(ids)
        xp[client, :k] = x[ids]
        yp[client, :k] = y[ids]
        mask[client, :k] = 1.0
        counts[client] = k
    return ClientBatch(x=xp, y=yp, mask=mask, counts=counts)
