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

``GangExchange`` is the same reductions across the processes of a training
gang, each member holding its own shards' rows.
"""

from __future__ import annotations

import math
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


class GangExchange:
    """One round's exchange of a training gang's payload
    (``fedtpu_torch.parallel.multihost``), for ``kind``:

    - ``psum``: each member's ``(width,)`` partial sum; every member gets
      the members' sum, a left fold in member order over the gathered
      stack (the same bits everywhere).
    - ``ring``: each member's ``(S_local, width)`` shard rows; every member
      gets its own rows of the ring all-reduce over all ``S`` shards. On
      the card that is K4 across processes: each member's rows sit in one
      exchange buffer (``cudaMalloc``, exported once over CUDA IPC and
      mapped once by every peer), and K4 reads every shard's row through
      its pointer table, its own rows from its buffer and the peers' from
      theirs (``cuda_kernels.ring_all_reduce_sum_rows``). On the CPU the
      rows are gathered and reduced by the plain version, bitwise the one
      process's plain ring.
    - ``ring-rsag``: the rows gathered, then the plain reduce-scatter +
      all-gather (``ring_all_reduce_sum_rsag``), this member's rows kept.

    A round calls ``stage`` (device: the payload into the static send
    buffer), ``host`` (host: for K4 a stream synchronise and a barrier, so
    that every member's rows are written before anyone reads them; else
    the gather, staged through the host under gloo), ``reduce`` (device:
    the result) and ``after`` (host: for K4 the second synchronise and
    barrier, so that every peer has read the rows before anyone
    overwrites them). ``stage`` and ``reduce`` may be captured in CUDA
    graphs; ``host`` and ``after`` never are. A failed IPC open raises:
    K4 never gives way to its plain version."""

    def __init__(self, kind: str, gang, mesh, width: int,
                 device: torch.device):
        if kind not in ("psum", "ring", "ring-rsag"):
            raise ValueError(f"unknown aggregation kind: {kind!r}")
        self.kind, self.gang, self.width = kind, gang, int(width)
        self.device = device
        self.lo = mesh.first_shard
        self.hi = mesh.first_shard + mesh.local_shards
        shape = ((self.width,) if kind == "psum"
                 else (mesh.local_shards, self.width))
        self.ipc = kind == "ring" and device.type == "cuda"
        self._own_ptr, self._peer_ptrs = None, []
        if self.ipc:
            self._own_ptr, handle = cuda_kernels.ipc_alloc(
                4 * math.prod(shape), device)
            self.send = cuda_kernels.device_view(self._own_ptr, shape,
                                                 device)
            handles = gang.all_gather_object(handle)
            self.blocks = []
            for i, h in enumerate(handles):
                if i == gang.process_index:
                    self.blocks.append(self.send)
                    continue
                ptr = cuda_kernels.ipc_open(h, device)
                self._peer_ptrs.append(ptr)
                self.blocks.append(cuda_kernels.device_view(ptr, shape,
                                                            device))
        else:
            self.send = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
            self.stack = torch.zeros((gang.process_count,) + shape,
                                     dtype=torch.float32, device=device)

    def stage(self, payload: torch.Tensor) -> None:
        self.send.copy_(payload)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.gang.barrier()

    def host(self) -> None:
        if self.ipc:
            self._sync()
        else:
            self.stack.copy_(self.gang.all_gather(self.send))

    def reduce(self) -> torch.Tensor:
        if self.ipc:
            return cuda_kernels.ring_all_reduce_sum_rows(self.blocks,
                                                         self.lo, self.hi)
        if self.kind == "psum":
            acc = self.stack[0]
            for i in range(1, self.gang.process_count):
                acc = acc + self.stack[i]
            return acc
        full = self.stack.reshape(-1, self.width)
        if self.kind == "ring":
            return cuda_kernels.ring_all_reduce_sum_rows([full], self.lo,
                                                         self.hi)
        return ring_all_reduce_sum_rsag(full)[self.lo:self.hi]

    def after(self) -> None:
        if self.ipc:
            self._sync()

    def close(self) -> None:
        """Unmap the peers' buffers and free this member's, after a
        barrier (no peer still reads it). Idempotent."""
        if not self.ipc or self._own_ptr is None:
            return
        self._sync()
        self.blocks = []
        self.send = None
        for ptr in self._peer_ptrs:
            cuda_kernels.ipc_close(ptr, self.device)
        self._peer_ptrs = []
        cuda_kernels.ipc_free(self._own_ptr, self.device)
        self._own_ptr = None
