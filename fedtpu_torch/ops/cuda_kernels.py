"""The port's hand-written CUDA kernels: the three of
``fedtpu.ops.pallas_kernels`` and the ring all-reduce of
``fedtpu.parallel.ring_pallas``.

Each wrapper checks its tensors and then:

* on CPU tensors, runs its plain PyTorch version (``*_reference``), which
  the CPU tests and the card-vs-plain checks use as the oracle;
* on CUDA tensors, launches its kernel (``fedtpu_torch/csrc``) on the current
  stream, or raises. There is no fallback from the card to the plain version.

``LAUNCHES`` counts kernel launches per wrapper (never plain-version calls),
so a run can show that its main path went through the kernels.

The parameters of a model are a flat float32 buffer with ``dims =
(input_dim, *hidden_sizes, num_classes)`` (``fedtpu_torch.models.mlp``);
client-stacked as ``(C, D)``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fedtpu_torch.models.mlp import mlp_apply, param_count, unflatten
from fedtpu_torch.ops.metrics import confusion_matrix

LAUNCHES = {"weighted_average_clients": 0, "fused_eval_confusion": 0,
            "fused_mlp_forward": 0, "ring_all_reduce_sum": 0}

# Dynamic shared memory one block may opt into on sm_90 (227 KB).
SMEM_BYTES_MAX = 232_448
MAX_LAYERS = 16           # FT_MAX_LAYERS in csrc/mlp_forward.cuh
MAX_CLASSES = 8
_ROW_TILES = (32, 16, 8, 4, 2, 1)
RING_MAX_SHARDS = 64      # FT_RING_MAX_SHARDS in csrc/ring_all_reduce.cu
RING_THREADS = 256        # FT_RING_THREADS
RING_VEC = 4              # floats per float4 access of the ring kernel
RING_FLAGS_PER_BLOCK = 5  # FT_FLAGS
# The budget of one spin-wait: about 1 s of SM clock at the H100's
# 1.98 GHz boost clock.
RING_TIMEOUT_CYCLES = 2_000_000_000
RING_WAITS = {1: "start barrier", 2: "capacity credit", 3: "receive flag",
              4: "residual-credit drain"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dims(flat: torch.Tensor, dims: Sequence[int]) -> tuple:
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) - 1 <= MAX_LAYERS or min(dims) < 1:
        raise ValueError(f"dims {dims}: need 1..{MAX_LAYERS} layers of "
                         "positive width")
    if flat.shape[-1] != param_count(dims):
        raise ValueError(f"params have {flat.shape[-1]} entries, dims {dims} "
                         f"need {param_count(dims)}")
    return dims


def _rows_per_block(num_params: int, dims: tuple, extra: int) -> int:
    """Largest row tile whose parameters + two activation buffers fit in a
    block's shared memory (ft_tile_smem_bytes in mlp_forward.cuh)."""
    for rows in _ROW_TILES:
        if 4 * (num_params + 2 * rows * max(dims) + extra) <= SMEM_BYTES_MAX:
            return rows
    raise ValueError(
        f"one model's {num_params} parameters do not fit in a block's "
        f"{SMEM_BYTES_MAX} bytes of shared memory")


def _launch(entry: str, device: torch.device, *args) -> None:
    from fedtpu_torch.ops._build import load_library
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(load_library(), entry)(*args, stream)
    _raise_on(entry, err)


def _raise_on(entry: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed with "
                           f"cudaError_t {err}")


def _dims_arg(dims: tuple):
    return (ctypes.c_int * len(dims))(*dims)


# ---------------------------------------------------------------- K1: FedAvg
def weighted_average_clients_reference(stacked: torch.Tensor,
                                       weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``sum_c (w_c / max(sum w, 1e-30)) * x_c``."""
    wn = weights / weights.sum().clamp_min(1e-30)
    return (wn[:, None] * stacked).sum(dim=0)


def weighted_average_clients(stacked: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Weighted average over the clients axis of ``stacked (C, D)`` with
    ``weights (C,)`` -> ``(D,)``: the FedAvg aggregation."""
    dev = _device(stacked, weights)
    c, d = stacked.shape
    _check(stacked, "stacked", torch.float32, (c, d))
    _check(weights, "weights", torch.float32, (c,))
    if dev.type == "cpu":
        return weighted_average_clients_reference(stacked, weights)
    if 4 * (c + 1) > 48 * 1024:
        raise ValueError(f"{c} clients: the normalised weights must fit in "
                         "48 KB of shared memory")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0:
        return out
    _launch("ft_weighted_average", dev, stacked.data_ptr(),
            weights.data_ptr(), c, d, out.data_ptr())
    LAUNCHES["weighted_average_clients"] += 1
    return out


# ------------------------------------------------ K2: fused eval -> confusion
def fused_eval_confusion_reference(flat: torch.Tensor, dims: Sequence[int],
                                   x: torch.Tensor, y: torch.Tensor,
                                   mask: torch.Tensor,
                                   num_classes: int) -> torch.Tensor:
    """Plain version of K2: per-client forward, first-max argmax, masked
    confusion counts ``(C, K, K)``."""
    logits = mlp_apply(unflatten(flat, dims), x)
    return confusion_matrix(y, torch.argmax(logits, dim=-1), mask,
                            num_classes)


def fused_eval_confusion(flat: torch.Tensor, dims: Sequence[int],
                         x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """Batched-over-clients fused eval: ``(C, K, K)`` confusion matrices of
    client-stacked params ``flat (C, D)`` on ``x (C, N, dims[0])``,
    ``y (C, N)`` int32, ``mask (C, N)`` float32. ``num_classes <= 8``."""
    if num_classes > MAX_CLASSES:
        raise ValueError(f"num_classes={num_classes} > {MAX_CLASSES} "
                         "unsupported (per-block confusion tile)")
    dev = _device(flat, x, y, mask)
    dims = _check_dims(flat, dims)
    if dims[-1] != num_classes:
        raise ValueError(f"last layer width {dims[-1]} != num_classes "
                         f"{num_classes}")
    c, n = y.shape
    _check(flat, "params", torch.float32, (c, param_count(dims)))
    _check(x, "x", torch.float32, (c, n, dims[0]))
    _check(y, "y", torch.int32, (c, n))
    _check(mask, "mask", torch.float32, (c, n))
    if dev.type == "cpu":
        return fused_eval_confusion_reference(flat, dims, x, y, mask,
                                              num_classes)
    conf = torch.zeros((c, num_classes, num_classes), dtype=torch.float32,
                       device=dev)
    if c == 0 or n == 0:
        return conf
    k = num_classes
    rows = _rows_per_block(param_count(dims), dims, k * k)
    dims_arg = _dims_arg(dims)
    _launch("ft_eval_confusion", dev, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), c, n, rows, conf.data_ptr())
    LAUNCHES["fused_eval_confusion"] += 1
    return conf


# -------------------------------------------------------- K3: fused forward
def fused_mlp_forward_reference(flat: torch.Tensor, dims: Sequence[int],
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``mlp_apply`` of one model."""
    return mlp_apply(unflatten(flat, dims), x)


def fused_mlp_forward(flat: torch.Tensor, dims: Sequence[int],
                      x: torch.Tensor) -> torch.Tensor:
    """Logits ``(N, K)`` of one model ``flat (D,)`` on ``x (N, dims[0])``;
    any N."""
    dev = _device(flat, x)
    dims = _check_dims(flat, dims)
    n = x.shape[0]
    _check(flat, "params", torch.float32, (param_count(dims),))
    _check(x, "x", torch.float32, (n, dims[0]))
    if dev.type == "cpu":
        return fused_mlp_forward_reference(flat, dims, x)
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    rows = _rows_per_block(param_count(dims), dims, 0)
    dims_arg = _dims_arg(dims)
    _launch("ft_mlp_forward", dev, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(), n, rows,
            out.data_ptr())
    LAUNCHES["fused_mlp_forward"] += 1
    return out


# ------------------------------------------------ K4: ring all-reduce (sum)
# Per device: the error word, and per (shards, blocks, slice) the
# communication slots and flags, kept across launches. The kernel leaves
# every flag at zero, so a launch needs no memset; only a failed launch
# leaves them dirty, and ring_check zeroes them before it raises. One
# all-reduce at a time per device: launches go to the current stream.
_RING_ERR: dict = {}
_RING_SCRATCH: dict = {}
_RING_MAX_BLOCKS: dict = {}


def _residual_credits(axis_size: int) -> list:
    """Capacity credits left un-consumed per slot parity at the end of the
    ring (ring_pallas.py:52-62): each is drained so the flags end at zero."""
    n = axis_size
    received = [0, 0]
    consumed = [0, 0]
    for s in range(n - 1):
        received[s % 2] += 1              # right neighbour frees slot s%2
        if s >= 2:
            consumed[(s + 1) % 2] += 1    # we waited before writing it
    return [received[p] - consumed[p] for p in (0, 1)]


def ring_all_reduce_sum_reference(stack: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: rotate-and-accumulate over the shards axis,
    ``acc_d = x_d + x_{d-1} + ... + x_{d-S+1}`` in that order."""
    acc = rot = stack
    for _ in range(stack.shape[0] - 1):
        rot = torch.roll(rot, 1, dims=0)
        acc = acc + rot
    return acc


def _ring_max_blocks(dev: torch.device) -> int:
    if dev not in _RING_MAX_BLOCKS:
        from fedtpu_torch.ops._build import load_library
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = load_library().ft_ring_max_blocks(ctypes.byref(out))
        _raise_on("ft_ring_max_blocks", err)
        _RING_MAX_BLOCKS[dev] = out.value
    return _RING_MAX_BLOCKS[dev]


def _ring_scratch(dev: torch.device, shards: int, blocks: int, slice_: int):
    key = (dev, shards, blocks, slice_)
    if key not in _RING_SCRATCH:
        comm = torch.empty(shards * blocks * 2 * slice_ * RING_VEC,
                           dtype=torch.float32, device=dev)
        flags = torch.zeros(shards * blocks * RING_FLAGS_PER_BLOCK,
                            dtype=torch.int32, device=dev)
        _RING_SCRATCH[key] = (comm, flags)
    if dev not in _RING_ERR:
        _RING_ERR[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _RING_SCRATCH[key][0], _RING_SCRATCH[key][1], _RING_ERR[dev]


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_flags_clear(device) -> bool:
    """True when every ring flag and the error word on ``device`` read zero
    (the state every launch must leave). Synchronises."""
    dev = _cuda_device(device)
    words = [f for key, (_, f) in _RING_SCRATCH.items() if key[0] == dev]
    words += [_RING_ERR[dev]] if dev in _RING_ERR else []
    return all(int(w.abs().sum()) == 0 for w in words)


def ring_check(device) -> None:
    """Raise if a ring launch on ``device`` timed out in a spin-wait (reads
    the error word: synchronises with the device). The flags are zeroed
    first, so the next launch starts clean."""
    dev = _cuda_device(device)
    if dev not in _RING_ERR:
        return
    code = int(_RING_ERR[dev].item())
    if not code:
        return
    for key, (_, flags) in _RING_SCRATCH.items():
        if key[0] == dev:
            flags.zero_()
    _RING_ERR[dev].zero_()
    raise RuntimeError(
        f"ring_all_reduce_sum: block {(code & 0xFFFFFF) - 1} timed out "
        f"waiting on its {RING_WAITS.get(code >> 24, code >> 24)}: the "
        "ring's synchronisation failed")


def ring_all_reduce_sum(stack: torch.Tensor, *, check: bool = True,
                        timeout_cycles: int = RING_TIMEOUT_CYCLES,
                        _fault: int = 0) -> torch.Tensor:
    """Ring all-reduce of ``stack (S, P)`` float32, one row per shard of the
    clients mesh: row d of the result is ``x_d + x_{d-1} + ... +
    x_{d-S+1}``, summed in that order (each shard in its own order, as the
    TPU kernel does).

    On the card: one cooperative launch of S x B blocks, which raises when
    the grid cannot be co-resident. ``check`` reads the kernel's error word
    after the launch (one sync) and raises if a spin-wait ran out of its
    ``timeout_cycles`` budget; with ``check=False`` the caller calls
    ``ring_check`` itself. ``_fault=k`` makes one block skip its signal at
    hop k-1, to prove that a broken protocol raises instead of hanging."""
    dev = _device(stack)
    if stack.dim() != 2:
        raise ValueError(f"stack must be (shards, payload), got shape "
                         f"{tuple(stack.shape)}")
    s, p = stack.shape
    _check(stack, "stack", torch.float32, (s, p))
    if dev.type == "cpu":
        return ring_all_reduce_sum_reference(stack)
    if not 2 <= s <= RING_MAX_SHARDS:
        raise ValueError(f"{s} shards: the ring kernel takes 2.."
                         f"{RING_MAX_SHARDS}")
    vecs = -(-p // RING_VEC)
    x = stack
    if p % RING_VEC or x.data_ptr() % (4 * RING_VEC):
        # float4 accesses: rows padded to the vector width, 16-byte aligned.
        x = stack.new_zeros(s, vecs * RING_VEC)
        x[:, :p] = stack
    out = torch.empty_like(x)
    if p == 0:
        return out
    fit = _ring_max_blocks(dev) // s
    if fit < 1:
        raise RuntimeError(
            f"{s} shards need {s} co-resident blocks; the device holds "
            f"{_ring_max_blocks(dev)} of the ring kernel")
    blocks = min(-(-vecs // RING_THREADS), fit)
    slice_ = -(-vecs // blocks)
    comm, flags, err = _ring_scratch(dev, s, blocks, slice_)
    row = x.stride(0) * x.element_size()
    xs = (ctypes.c_void_p * s)(*(x.data_ptr() + d * row for d in range(s)))
    accs = (ctypes.c_void_p * s)(*(out.data_ptr() + d * row
                                   for d in range(s)))
    residual = _residual_credits(s)
    _launch("ft_ring_all_reduce", dev, ctypes.addressof(xs),
            ctypes.addressof(accs), s, blocks, vecs, slice_,
            comm.data_ptr(), flags.data_ptr(), err.data_ptr(), residual[0],
            residual[1], int(timeout_cycles), int(_fault))
    LAUNCHES["ring_all_reduce_sum"] += 1
    if check:
        ring_check(dev)
    return out if p % RING_VEC == 0 else out[:, :p]
