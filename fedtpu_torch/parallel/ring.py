"""Ring all-reduce over the clients mesh (``fedtpu.parallel.ring``).

``fedtpu`` spells its ring schedules out with ``jax.lax.ppermute`` inside
``shard_map``, one program per shard. The port holds every shard's value in
one ``(S, ...)`` stack, one row per shard, and each function here maps such
a stack to the stack of per-shard results; a hop to the right neighbour is
``torch.roll(..., 1, dims=0)``. The order of every add is ``fedtpu``'s, so
the results equal ``fedtpu``'s bit for bit:

- ``ring_all_reduce_sum``: rotate-and-accumulate, S-1 hops of the whole
  payload. Shard d adds ``x_d + x_{d-1} + ...``, in its own order, so the
  rows differ from each other in the last bits. On a CUDA stack it is K4
  (``fedtpu_torch.ops.cuda_kernels.ring_all_reduce_sum``): one launch, no
  host read and no padded copy.
- ``ring_all_reduce_sum_rsag``: reduce-scatter then all-gather, 2(S-1) hops
  of 1/S of the payload each. Each chunk is summed once, on its owner, and
  gathered verbatim, so every row is identical. ``fedtpu`` has no Pallas
  kernel for it, so it stays ordinary torch code on the card as well.
- ``make_all_reduce('psum')``: the plain sum over shards, on every row.
"""

from __future__ import annotations

from typing import Callable

import torch

from fedtpu_torch.ops import cuda_kernels


def flatten_pad(stack: torch.Tensor, multiple: int):
    """``(S, ...)`` -> ``(S, P)`` with each row flattened and zero-padded to
    a multiple of ``multiple``; returns ``(flat, pad)``."""
    flat = stack.reshape(stack.shape[0], -1)
    pad = (-flat.shape[1]) % multiple
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def unpad_reshape(flat: torch.Tensor, pad: int, shape) -> torch.Tensor:
    """Inverse of :func:`flatten_pad`: ``shape`` is the full ``(S, ...)``."""
    if pad:
        flat = flat[:, :-pad]
    return flat.reshape(shape)


def ring_all_reduce_sum(stack: torch.Tensor) -> torch.Tensor:
    """Rotate-and-accumulate ring all-reduce: after S-1 hops every shard
    holds the sum over the shards (each in its own order)."""
    if stack.shape[0] == 1:
        return stack
    flat = stack.reshape(stack.shape[0], -1).contiguous()
    return cuda_kernels.ring_all_reduce_sum(flat).reshape(stack.shape)


def ring_all_reduce_sum_rsag(stack: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter (S-1 hops; shard d ends owning the full sum of chunk
    (d+1) % S) then all-gather (S-1 hops). Each row is flattened and
    zero-padded to a multiple of S, as ``fedtpu`` chunks it."""
    n = stack.shape[0]
    if n == 1:
        return stack
    flat, pad = flatten_pad(stack, n)
    chunks = flat.reshape(n, n, -1)                  # (shard, chunk, B/n)
    me = torch.arange(n, device=stack.device)

    # Reduce-scatter: at step s, send the running sum of chunk (me - s),
    # receive chunk (me - s - 1) from the left and fold ours in.
    sending = chunks[me, me]
    for s in range(n - 1):
        sending = torch.roll(sending, 1, dims=0) + chunks[me, (me - s - 1) % n]
    owned_idx = (me + 1) % n

    # All-gather: rotate the owned chunks around the ring into their slots.
    out = torch.zeros_like(chunks)
    out[me, owned_idx] = sending
    rot = sending
    for s in range(n - 1):
        rot = torch.roll(rot, 1, dims=0)
        out[me, (owned_idx - s - 1) % n] = rot
    return unpad_reshape(out.reshape(n, -1), pad, stack.shape)


def _psum(stack: torch.Tensor) -> torch.Tensor:
    return stack.sum(dim=0, keepdim=True).expand_as(stack)


def make_all_reduce(kind: str, num_shards: int) -> Callable:
    """Reduction backend over a ``(num_shards, ...)`` stack: ``psum`` (the
    plain sum, broadcast to every shard), ``ring`` (rotate-accumulate, K4 on
    the card) or ``ring-rsag`` (reduce-scatter + all-gather)."""
    fns = {"psum": _psum, "ring": ring_all_reduce_sum,
           "ring-rsag": ring_all_reduce_sum_rsag}
    if kind not in fns:
        raise ValueError(f"unknown aggregation kind: {kind!r}")
    fn = fns[kind]

    def all_reduce(stack: torch.Tensor) -> torch.Tensor:
        if stack.shape[0] != num_shards:
            raise ValueError(f"stack of {stack.shape[0]} rows for a "
                             f"{num_shards}-shard mesh")
        return fn(stack)

    return all_reduce
