"""The port's hand-written CUDA kernels: the three of
``fedtpu.ops.pallas_kernels``, the ring all-reduce of
``fedtpu.parallel.ring_pallas`` and the whole-round mega-kernel of
``benchmarks/mega_kernel_attempt.py``.

Each wrapper checks its tensors and then:

* on CPU tensors, runs its plain PyTorch version (``*_reference``), which
  the CPU tests and the card-vs-plain checks use as the oracle;
* on CUDA tensors, launches its kernel (``fedtpu_torch/csrc``) on the current
  stream, or raises. There is no fallback from the card to the plain version.

``LAUNCHES`` counts kernel launches per wrapper (never plain-version calls),
so a run can show that its main path went through the kernels. A wrapper
called under CUDA-graph capture launches nothing then; the capturing
thread counts into its own recorder (``recording_launches``), and each
replay adds what it recorded (``count_replay``). Counts from several
threads (the gateway fleet's engines) go through one lock.

The parameters of a model are a flat float32 buffer with ``dims =
(input_dim, *hidden_sizes, num_classes)`` (``fedtpu_torch.models.mlp``);
client-stacked as ``(C, D)``. K1 also takes a bfloat16 or float16 stack
(``WAVG_DTYPES``), and has an unnormalised sum mode (``weighted_sum_clients``,
float32) for the asynchronous tick; K2, K3 and K5 compute the float32 MLP
only, as their Pallas originals.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Sequence

import torch

from fedtpu_torch.config import OptimConfig
from fedtpu_torch.models.mlp import mlp_apply, param_count, unflatten
from fedtpu_torch.models.registry import kernel_dims
from fedtpu_torch.ops.losses import masked_cross_entropy
from fedtpu_torch.ops.metrics import confusion_matrix, one_hot
from fedtpu_torch.ops.optim import build_optimizer

LAUNCHES = {"weighted_average_clients": 0, "fused_eval_confusion": 0,
            "fused_mlp_forward": 0, "ring_all_reduce_sum": 0,
            "fused_round": 0}

# Dynamic shared memory one block may opt into on sm_90 (227 KB).
SMEM_BYTES_MAX = 232_448
MAX_LAYERS = 16           # FT_MAX_LAYERS in csrc/mlp_forward.cuh (card only)
MAX_CLASSES = 8           # K5's confusion tile, as in its JAX original
_ROW_TILES = (32, 16, 8, 4, 2, 1)          # K2's row tiles
_FORWARD_TILES = (64, 32, 16, 8, 4, 2, 1)  # K3's
# K3's plan counts one block's parameter copy as this many rows of its
# forward: both grow with the parameter count (4 bytes a parameter over an
# SM's ~64 bytes/clock of L2 reads, against 2 flops a parameter a row over
# its 256 fp32 flops/clock).
_STAGING_ROWS = 8
WAVG_MAX_THREADS = 256    # FT_WAVG_MAX_THREADS in csrc/weighted_average.cu
THREADS_MAX = 256         # FT_THREADS in csrc/mlp_forward.cuh
RING_MAX_SHARDS = 64      # FT_RING_MAX_SHARDS in csrc/ring_all_reduce.cu
# K2's clients axis is its grid's y dimension (at most 65,535 blocks);
# K1 takes its width as a C int.
EVAL_MAX_CLIENTS = 65_535
WAVG_MAX_WIDTH = 2**31 - 1
# K1's element types -> the code ft_weighted_average takes.
WAVG_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# K1's modes (``mode`` of ft_weighted_average): the (D,) average, the
# broadcast into every slot, the unnormalised (D,) sum.
WAVG_AVERAGE, WAVG_BROADCAST, WAVG_SUM = 0, 1, 2


_COUNT_LOCK = threading.Lock()
# Per thread: the recorder of a graph capture under way in that thread.
_RECORDER = threading.local()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_replay(launches: dict) -> None:
    """Add one replay of a CUDA graph to ``LAUNCHES``: ``launches`` are the
    launches its capture recorded (a wrapper counts on the host, so inside
    a graph it counts once, at capture, and never at replay)."""
    with _COUNT_LOCK:
        for name, n in launches.items():
            LAUNCHES[name] += n


def _count(name: str) -> None:
    """One launch of ``name``'s kernel: into this thread's capture
    recorder while it captures a graph, else into ``LAUNCHES``."""
    recorder = getattr(_RECORDER, "launches", None)
    if recorder is not None:
        recorder[name] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches():
    """This thread's launches counted into a fresh dict (yielded) instead
    of ``LAUNCHES``, while it captures a graph: launches another thread
    makes meanwhile still count."""
    _RECORDER.launches = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _RECORDER.launches
    finally:
        _RECORDER.launches = None


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
    if len(dims) < 2 or min(dims) < 1:
        raise ValueError(f"dims {dims}: need at least one layer, every width "
                         "positive")
    if flat.shape[-1] != param_count(dims):
        raise ValueError(f"params have {flat.shape[-1]} entries, dims {dims} "
                         f"need {param_count(dims)}")
    return dims


def _check_depth(dims: tuple) -> None:
    """The kernels' limit on depth (their by-value ``MlpDims``); the plain
    versions take any depth."""
    if len(dims) - 1 > MAX_LAYERS:
        raise ValueError(f"{len(dims) - 1} layers: the kernels take at most "
                         f"{MAX_LAYERS} on the card")


def _wavg_plan(d: int, sms: int) -> tuple:
    """K1's launch: ``(threads, blocks)``, one column a thread. A block is
    whole warps (every warp reduces the weights with shuffles), as few as
    spread the columns over the most SMs, at most 256."""
    per_sm = -(-d // sms)
    threads = min(WAVG_MAX_THREADS, max(32, -(-per_sm // 32) * 32))
    return threads, -(-d // threads)


class ForwardPlan(NamedTuple):
    """K3's launch: row tile, threads, shared bytes, blocks, and the floats
    of each weight buffer of the streamed path (0: the resident path)."""
    rows: int
    threads: int
    nbytes: int
    blocks: int
    cap: int


class EvalPlan(NamedTuple):
    """K2's launch: row tile, shared bytes, the floats of each weight buffer
    of the streamed path (0: the resident path), and whether the K x K
    counts sit in shared memory (else each row adds into global memory)."""
    rows: int
    nbytes: int
    cap: int
    shared_counts: bool


def _resident_floats(num_params: int) -> int:
    """The staging layout of mlp_forward.cuh (``ft_stage_floats``): a
    4-float header and the parameters with 3 floats of alignment slack,
    rounded up to 4."""
    return 4 + (num_params + 6) // 4 * 4


def _tile_floats(dims: tuple, rows: int) -> int:
    """One x tile and two activation tiles at the widest layer's odd
    stride."""
    return rows * (dims[0] + 2 * max(d | 1 for d in dims[1:]))


def _stream_cap(free: int, dims: tuple) -> int:
    """The floats of each of the streamed path's two weight buffers in
    ``free`` floats (after its 4-float header): a multiple of 4 that holds
    one input row of the widest layer (``ft_chunk_rows``), or 0."""
    cap = free // 2 // 4 * 4
    return cap if cap - 3 >= max(dims[1:]) else 0


def _too_wide(dims: tuple) -> ValueError:
    return ValueError(
        f"a layer {max(dims[1:])} wide: a one-row tile of activations and two "
        f"buffers of one weight row each do not fit in a block's "
        f"{SMEM_BYTES_MAX} bytes of shared memory")


def _forward_plan(n: int, num_params: int, dims: tuple,
                  sms: int) -> ForwardPlan:
    """K3's schedule for N rows.

    The resident path (the whole model staged in shared memory) when one
    model and a one-row tile fit in a block, else the streamed path, chosen
    from the shapes. Of the row tiles whose block fits (the layout
    mlp_forward.cu carves, which refuses a byte count that does not hold
    it), the one whose busiest SM does the least work,
    ``ceil(blocks / sms) * (rows + _STAGING_ROWS)`` (both a block's
    parameter copy and its forward grow with the parameters), and the
    largest of equals. Threads: whole warps, at most 256, enough to run the
    widest layer's 4 x 4 micro-tiles in two passes (128 at 16 rows of
    14->50->200->2: measured fastest there, ``chip_smoke.py``); below 4
    rows, one output a thread of the widest layer. On the streamed path the
    buffers take the rest of the block's shared memory."""
    limit = SMEM_BYTES_MAX // 4
    resident = _resident_floats(num_params)
    fits = [r for r in _FORWARD_TILES
            if resident + _tile_floats(dims, r) <= limit]
    streamed = not fits
    if streamed:
        fits = [r for r in _FORWARD_TILES
                if _stream_cap(limit - 4 - _tile_floats(dims, r), dims)]
        if not fits:
            raise _too_wide(dims)

    def busiest(rows):
        blocks = -(-n // rows)
        return -(-blocks // sms) * (rows + _STAGING_ROWS)

    rows = min(fits, key=lambda r: (busiest(r), -r))
    widest = max(dims[1:])
    if rows >= 4:
        # Two passes of the widest layer's 4 x 4 micro-tiles (ft_layer_regs
        # takes 4 x 4 only when there are at least as many as threads).
        micro_tiles = -(-rows // 4) * -(-widest // 4)
        want = -(-micro_tiles // 2)
    else:
        want = rows * widest   # one output a thread: no 4-row micro-tile
    threads = min(THREADS_MAX, max(32, -(-want // 32) * 32))
    cap = _stream_cap(limit - 4 - _tile_floats(dims, rows), dims) \
        if streamed else 0
    head = 4 + 2 * cap if streamed else resident
    return ForwardPlan(rows, threads, 4 * (head + _tile_floats(dims, rows)),
                       -(-n // rows), cap)


def _forward_bytes(num_params: int, dims: tuple, rows: int) -> int:
    """Shared memory of one resident K3 block at a row tile of ``rows``."""
    return 4 * (_resident_floats(num_params) + _tile_floats(dims, rows))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _eval_plan(num_params: int, dims: tuple) -> EvalPlan:
    """K2's row tile, path and shared memory: the resident path (K3's
    layout) at the largest row tile whose block fits, else the streamed
    path at the largest row tile whose block fits with a buffer of at least
    one weight row; at that tile the K x K counts in shared memory when
    they fit beside it, else in global memory. The layout is the one
    eval_confusion.cu carves, which refuses a byte count that does not
    hold it; on the streamed path the buffers take the rest."""
    limit = SMEM_BYTES_MAX // 4
    kk = dims[-1] ** 2
    resident = _resident_floats(num_params)
    for rows in _ROW_TILES:
        for counts in (kk, 0):
            floats = resident + _tile_floats(dims, rows) + counts
            if floats <= limit:
                return EvalPlan(rows, 4 * floats, 0, counts > 0)
    for rows in _ROW_TILES:
        for counts in (kk, 0):
            rest = 4 + _tile_floats(dims, rows) + counts
            cap = _stream_cap(limit - rest, dims)
            if cap:
                return EvalPlan(rows, 4 * (rest + 2 * cap), cap, counts > 0)
    raise _too_wide(dims)


class RoundPlan(NamedTuple):
    """K5's launch: rows a chunk, shared bytes, chunks a client, work items
    (one a (chunk, client)), and the grid's blocks."""
    rows: int
    nbytes: int
    chunks: int
    items: int
    blocks: int


_ROUND_ROWS = (64, 32, 16, 8, 4, 2, 1)   # FT_ROUND_MAX_ROWS in fused_round.cu
ROUND_THREADS = 512                      # FT_ROUND_THREADS


def _round_ldr(rows: int) -> int:
    """K5's stride of its feature-major x tile and layer outputs at a chunk
    of ``rows`` (``ft_round_ldr`` in fused_round.cu)."""
    return -(-rows // 16) * 16 + 4


def _fused_round_rows(num_params: int, dims: tuple) -> tuple:
    """K5's row chunk and shared memory: ``(rows, bytes)`` for the largest
    chunk whose block fits. The layout is the one fused_round.cu carves,
    which refuses a byte count that does not hold it: K3's staging layout
    (a 4-float header, the parameters with alignment slack), the x tile and
    every layer's output feature-major (``_round_ldr`` floats a feature),
    two dz buffers (the widest odd stride), the tile's mask and labels, 32
    floats of reduction scratch and the K x K counts."""
    ldmax = max(d | 1 for d in dims[1:])
    fixed = _resident_floats(num_params) + 32 + dims[-1] ** 2
    for rows in _ROUND_ROWS:
        floats = (fixed + sum(dims) * _round_ldr(rows)
                  + rows * (2 * ldmax + 2))
        if 4 * floats <= SMEM_BYTES_MAX:
            return rows, 4 * floats
    raise ValueError(
        f"model.hidden_sizes={list(dims[1:-1])}: one model's {num_params} "
        f"parameters and a one-row chunk do not fit in a block's "
        f"{SMEM_BYTES_MAX} bytes of shared memory")


def _fused_round_plan(num_params: int, dims: tuple, clients: int, n: int,
                      resident: int) -> RoundPlan:
    """K5's launch for ``clients`` clients of ``n`` rows when ``resident``
    blocks fit on the card at once: the chunk of ``_fused_round_rows``, a
    work item per (chunk, client), and enough blocks for every item and
    for phase B's (C, D) elements (one a thread), never more than can be
    resident (a grid barrier needs all of them)."""
    rows, nbytes = _fused_round_rows(num_params, dims)
    chunks = -(-n // rows)
    items = chunks * clients
    elems = -(-clients * num_params // ROUND_THREADS)
    return RoundPlan(rows, nbytes, chunks, items,
                     min(resident, max(items, elems)))


@functools.cache
def _round_resident(index: int, nbytes: int) -> int:
    """How many K5 blocks of ``nbytes`` of shared memory the card ``index``
    holds at once (the occupancy API, asked once)."""
    from fedtpu_torch.ops._build import load_library
    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        err = load_library().ft_fused_round_resident(
            nbytes, ctypes.addressof(blocks))
    _raise_on("ft_fused_round_resident", err)
    return blocks.value


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
                                       weights: torch.Tensor,
                                       broadcast: bool = False,
                                       out_dtype=None) -> torch.Tensor:
    """Plain version of K1: ``sum_c (w_c / max(sum w, 1e-30)) * x_c`` in
    float32 (a 16-bit stack read as float32); with ``broadcast``, that
    average cast to ``out_dtype`` (default: the stack's) in every row of a
    fresh ``(C, D)``, or ``stacked`` cast to it where ``sum w`` is not
    > 0."""
    out_dtype = out_dtype or stacked.dtype
    wn = weights / weights.sum().clamp_min(1e-30)
    glob = (wn[:, None] * stacked.to(torch.float32)).sum(dim=0)
    if not broadcast:
        return glob
    return torch.where(weights.sum() > 0,
                       glob.to(out_dtype).expand_as(stacked),
                       stacked.to(out_dtype))


def weighted_average_clients(stacked: torch.Tensor, weights: torch.Tensor,
                             broadcast: bool = False,
                             out_dtype=None) -> torch.Tensor:
    """Weighted average over the clients axis of ``stacked (C, D)``
    (float32, bfloat16 or float16) with float32 ``weights (C,)``: the FedAvg
    aggregation, as a fresh float32 ``(D,)``; or, with ``broadcast``, a
    fresh ``(C, D)`` in ``out_dtype`` (default: ``stacked``'s; a float32
    stack may go to 16-bit slots) that holds it in every client slot,
    rounded once, or the zero-participant carry-over (``stacked`` itself,
    bit for bit, or rounded to the slots' dtype) when the weights sum to 0
    or less, decided on the device. The sum is float32 whatever the stack's
    dtype.

    On the card: one launch of K1 in either mode, no host read; another
    stack dtype raises, naming it."""
    dev = _device(stacked, weights)
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be (clients, D), got shape "
                         f"{tuple(stacked.shape)}")
    c, d = stacked.shape
    if stacked.dtype not in WAVG_DTYPES:
        raise TypeError(f"stacked: the FedAvg kernel takes "
                        f"{sorted(map(str, WAVG_DTYPES))}, got "
                        f"{stacked.dtype}")
    _check(stacked, "stacked", stacked.dtype, (c, d))
    _check(weights, "weights", torch.float32, (c,))
    if out_dtype is not None and (
            not broadcast or out_dtype not in WAVG_DTYPES
            or out_dtype != stacked.dtype != torch.float32):
        raise TypeError(f"out_dtype {out_dtype} for a {stacked.dtype} "
                        "stack: the (D,) mode writes float32, the broadcast "
                        "the stack's dtype or, from float32, a 16-bit one")
    out_dtype = out_dtype or stacked.dtype
    if dev.type == "cpu":
        return weighted_average_clients_reference(stacked, weights, broadcast,
                                                  out_dtype)
    if d > WAVG_MAX_WIDTH:
        raise ValueError(f"stacked of shape {(c, d)}: the FedAvg kernel "
                         f"takes at most {WAVG_MAX_WIDTH} columns on the card")
    out = torch.empty((c, d) if broadcast else (d,),
                      dtype=out_dtype if broadcast else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    threads, _ = _wavg_plan(d, _sm_count(dev.index or 0))
    _launch_wavg(stacked, weights, out,
                 WAVG_BROADCAST if broadcast else WAVG_AVERAGE, threads)
    return out


def weighted_sum_clients_reference(stacked: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's sum mode: ``sum_c w_c * x_c`` in float32, no
    normalisation."""
    return (weights[:, None] * stacked).sum(dim=0)


def weighted_sum_clients(stacked: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The unnormalised weighted sum over the clients axis of a float32
    ``stacked (C, D)`` with float32 ``weights (C,)`` of any sign and any
    total, as a fresh float32 ``(D,)``: the asynchronous tick's discounted
    arrival sum ``psum(tensordot(disc, delta))`` and its screen's direction
    (``fedtpu.parallel.async_fed``), which ``weighted_average_clients``
    cannot give once the weights sum to 0 or less.

    On the card: one launch of K1 in its sum mode, no host read, counted
    under ``weighted_average_clients``; another stack dtype raises, naming
    it."""
    dev = _device(stacked, weights)
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be (clients, D), got shape "
                         f"{tuple(stacked.shape)}")
    c, d = stacked.shape
    if stacked.dtype != torch.float32:
        raise TypeError(f"stacked: the sum mode of the FedAvg kernel takes "
                        f"torch.float32, got {stacked.dtype}")
    _check(stacked, "stacked", torch.float32, (c, d))
    _check(weights, "weights", torch.float32, (c,))
    if dev.type == "cpu":
        return weighted_sum_clients_reference(stacked, weights)
    if d > WAVG_MAX_WIDTH:
        raise ValueError(f"stacked of shape {(c, d)}: the FedAvg kernel "
                         f"takes at most {WAVG_MAX_WIDTH} columns on the card")
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    threads, _ = _wavg_plan(d, _sm_count(dev.index or 0))
    _launch_wavg(stacked, weights, out, WAVG_SUM, threads)
    return out


def _launch_wavg(stacked: torch.Tensor, weights: torch.Tensor,
                 out: torch.Tensor, mode: int, threads: int) -> None:
    """K1's launch in ``mode`` (``WAVG_*``; a bool is the broadcast flag)
    at a given block size (the wrapper's plan, or another for timing);
    every launch counts."""
    c, d = stacked.shape
    _launch("ft_weighted_average", stacked.device, stacked.data_ptr(),
            weights.data_ptr(), c, d, WAVG_DTYPES[stacked.dtype],
            WAVG_DTYPES[out.dtype], int(mode), threads, out.data_ptr())
    _count("weighted_average_clients")


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
    ``y (C, N)`` int32, ``mask (C, N)`` float32; any class count, width
    and depth (on the card: up to ``MAX_LAYERS`` layers and the width
    ``_eval_plan`` takes).

    On the card: one launch of K2 under ``_eval_plan``."""
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
    _check_depth(dims)
    if c > EVAL_MAX_CLIENTS:
        raise ValueError(f"{c} models: the eval kernel takes at most "
                         f"{EVAL_MAX_CLIENTS} on the card (its grid's y "
                         "dimension)")
    plan = _eval_plan(param_count(dims), dims)
    conf = torch.zeros((c, num_classes, num_classes), dtype=torch.float32,
                       device=dev)
    if c == 0 or n == 0:
        return conf
    dims_arg = _dims_arg(dims)
    _launch("ft_eval_confusion", dev, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), c, n, plan.rows, plan.cap,
            int(plan.shared_counts), plan.nbytes, conf.data_ptr())
    _count("fused_eval_confusion")
    return conf


# -------------------------------------------------------- K3: fused forward
def fused_mlp_forward_reference(flat: torch.Tensor, dims: Sequence[int],
                                x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``mlp_apply`` of one model."""
    return mlp_apply(unflatten(flat, dims), x)


def fused_mlp_forward(flat: torch.Tensor, dims: Sequence[int],
                      x: torch.Tensor) -> torch.Tensor:
    """Logits ``(N, K)`` of one model ``flat (D,)`` on ``x (N, dims[0])``;
    any N, width and depth (on the card: up to ``MAX_LAYERS`` layers and
    the width ``_forward_plan`` takes).

    On the card: one launch of K3 over the row tiles of ``_forward_plan``."""
    dev = _device(flat, x)
    dims = _check_dims(flat, dims)
    n = x.shape[0]
    _check(flat, "params", torch.float32, (param_count(dims),))
    _check(x, "x", torch.float32, (n, dims[0]))
    if dev.type == "cpu":
        return fused_mlp_forward_reference(flat, dims, x)
    _check_depth(dims)
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    plan = _forward_plan(n, param_count(dims), dims,
                         _sm_count(dev.index or 0))
    _launch_forward(flat, dims, x, out, plan.rows, plan.threads, plan.nbytes,
                    plan.cap)
    return out


def _launch_forward(flat: torch.Tensor, dims: tuple, x: torch.Tensor,
                    out: torch.Tensor, rows: int, threads: int,
                    nbytes: int, cap: int = 0) -> None:
    """K3's launch at a given tile, threads, shared memory and weight
    buffers (the wrapper's plan, or another for timing); every launch
    counts."""
    dims_arg = _dims_arg(dims)
    _launch("ft_mlp_forward", x.device, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(),
            x.shape[0], rows, threads, cap, nbytes, out.data_ptr())
    _count("fused_mlp_forward")


# ------------------------------------------------ K4: ring all-reduce (sum)
def ring_all_reduce_sum_reference(stack: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: rotate-and-accumulate over the shards axis,
    ``acc_d = x_d + x_{d-1} + ... + x_{d-S+1}`` in that order."""
    acc = rot = stack
    for _ in range(stack.shape[0] - 1):
        rot = torch.roll(rot, 1, dims=0)
        acc = acc + rot
    return acc


def ring_all_reduce_sum(stack: torch.Tensor) -> torch.Tensor:
    """Ring all-reduce of ``stack (S, P)`` float32, one row per shard of the
    clients mesh: row d of the result is ``x_d + x_{d-1} + ... +
    x_{d-S+1}``, summed in that order (each shard in its own order, as the
    TPU kernel does).

    On the card: one ordinary launch over the payload columns, any P, with
    no host read after it and no padded copy."""
    dev = _device(stack)
    if stack.dim() != 2:
        raise ValueError(f"stack must be (shards, payload), got shape "
                         f"{tuple(stack.shape)}")
    s, p = stack.shape
    _check(stack, "stack", torch.float32, (s, p))
    if dev.type == "cpu":
        return ring_all_reduce_sum_reference(stack)
    return ring_all_reduce_sum_rows([stack], 0, s)


def ring_all_reduce_sum_rows_reference(blocks: Sequence[torch.Tensor],
                                       lo: int, hi: int) -> torch.Tensor:
    """Plain version of K4's gang launch: rows ``lo..hi`` of
    ``ring_all_reduce_sum_reference`` of the blocks stacked in order."""
    return ring_all_reduce_sum_reference(torch.cat(list(blocks)))[lo:hi]


def ring_all_reduce_sum_rows(blocks: Sequence[torch.Tensor], lo: int,
                             hi: int) -> torch.Tensor:
    """Rows ``lo..hi`` of the ring all-reduce of the ``(S, P)`` float32 stack
    whose rows are ``blocks`` (``(S_i, P)`` each, in shard order), as a
    fresh ``(hi - lo, P)``: row d is ``x_d + x_{d-1} + ... + x_{d-S+1}`` in
    that order, bitwise ``ring_all_reduce_sum``'s row d.

    A training gang's member passes its own exchange buffer and its peers'
    IPC-mapped ones (``fedtpu_torch.parallel.ring.IpcExchange``), and asks
    for its own rows. On the card: one launch of K4 over the payload
    columns that reads every block through its pointer table and writes
    only rows ``lo..hi``."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("ring_all_reduce_sum_rows needs at least one block")
    dev = _device(*blocks)
    p = blocks[0].shape[-1]
    for i, b in enumerate(blocks):
        if b.dim() != 2:
            raise ValueError(f"block {i} must be (shards, payload), got "
                             f"shape {tuple(b.shape)}")
        _check(b, f"block {i}", torch.float32, (b.shape[0], p))
    s = sum(b.shape[0] for b in blocks)
    if not 0 <= lo < hi <= s:
        raise ValueError(f"rows {lo}..{hi} of a {s}-shard ring")
    if dev.type == "cpu":
        return ring_all_reduce_sum_rows_reference(blocks, lo, hi)
    if not 2 <= s <= RING_MAX_SHARDS:
        raise ValueError(f"{s} shards: the ring kernel takes 2.."
                         f"{RING_MAX_SHARDS}")
    out = torch.empty((hi - lo, p), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    row = 4 * p
    rows = [b.data_ptr() + r * row for b in blocks for r in range(b.shape[0])]
    xs = (ctypes.c_void_p * s)(*rows)
    accs = (ctypes.c_void_p * s)(*(
        out.data_ptr() + (d - lo) * row if lo <= d < hi else None
        for d in range(s)))
    _launch("ft_ring_all_reduce_rows", dev, ctypes.addressof(xs),
            ctypes.addressof(accs), s, p, lo, hi)
    _count("ring_all_reduce_sum")
    return out


class _DeviceBuffer:
    """``__cuda_array_interface__`` of raw float32 device memory, so that
    ``torch.as_tensor`` views it without a copy (the exchange buffers of
    ``ipc_alloc`` / ``ipc_open``)."""

    def __init__(self, ptr: int, shape: tuple):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": "<f4", "data": (ptr, False),
            "version": 2, "strides": None}


def device_view(ptr: int, shape: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``shape`` over the device memory at ``ptr``."""
    with torch.cuda.device(device):
        return torch.as_tensor(_DeviceBuffer(ptr, shape), device=device)


def _ipc_call(entry: str, device: torch.device, *args) -> None:
    from fedtpu_torch.ops._build import load_library
    with torch.cuda.device(device):
        err = getattr(load_library(), entry)(*args)
    if err:
        raise RuntimeError(f"{entry}: failed with cudaError_t {err}")


def ipc_alloc(nbytes: int, device: torch.device) -> tuple:
    """``(ptr, handle)``: ``nbytes`` of zeroed memory from ``cudaMalloc`` on
    ``device`` and its 64-byte CUDA IPC handle. A failure raises."""
    ptr = ctypes.c_void_p()
    handle = ctypes.create_string_buffer(64)
    _ipc_call("ft_ipc_alloc", device, nbytes, ctypes.byref(ptr),
              ctypes.addressof(handle))
    return ptr.value, handle.raw


def ipc_open(handle: bytes, device: torch.device) -> int:
    """A peer's buffer, from its IPC handle, mapped into this process; a
    failed open raises (there is no fallback)."""
    ptr = ctypes.c_void_p()
    buf = ctypes.create_string_buffer(bytes(handle), 64)
    _ipc_call("ft_ipc_open", device, ctypes.addressof(buf), ctypes.byref(ptr))
    return ptr.value


def ipc_close(ptr: int, device: torch.device) -> None:
    _ipc_call("ft_ipc_close", device, ptr)


def ipc_free(ptr: int, device: torch.device) -> None:
    _ipc_call("ft_ipc_free", device, ptr)


# ------------------------------------------- K5: one whole round, fused
def fused_round_reference(params: torch.Tensor, mu: torch.Tensor,
                          nu: torch.Tensor, count: torch.Tensor,
                          x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                          weights: torch.Tensor, dims: Sequence[int],
                          optim: OptimConfig) -> tuple:
    """Plain version of K5, step by step (benchmarks/mega_kernel_attempt.py
    ``kernel``): what the kernel computes, in the composed round's order."""
    layers = unflatten(params, dims)["layers"]
    k = dims[-1]
    # 1. Forward, keeping each layer's input (hs[0] = x), and the masked CE
    #    of the logits before the step.
    hs = [x]
    for i, lyr in enumerate(layers):
        z = torch.matmul(hs[-1], lyr["w"]) + lyr["b"].unsqueeze(-2)
        hs.append(torch.relu(z) if i < len(layers) - 1 else z)
    loss = masked_cross_entropy(hs[-1], y, mask)
    # 2. Backward by hand (:84-95): dz = (softmax * m - onehot * m) / denom,
    #    gW = a^T dz, gB = sum over rows of dz, dz <- (dz W^T) * (h > 0).
    m = mask.unsqueeze(-1)
    denom = mask.sum(dim=-1).clamp_min(1.0)[:, None, None]
    p = torch.exp(torch.log_softmax(hs[-1], dim=-1))
    dz = (p * m - one_hot(y, k) * m) / denom
    grads = []
    for i in reversed(range(len(layers))):
        grads[:0] = [torch.matmul(hs[i].transpose(-1, -2), dz).flatten(-2),
                     dz.sum(dim=-2)]
        if i > 0:
            dz = torch.matmul(dz, layers[i]["w"].transpose(-1, -2)) \
                * (hs[i] > 0).to(dz.dtype)
    # 3. Adam on each client's own moments and count.
    trained, state = build_optimizer(optim).update(
        torch.cat(grads, dim=-1), {"mu": mu, "nu": nu, "count": count},
        params)
    # 4. The eval of the trained, not yet averaged models.
    conf = fused_eval_confusion_reference(trained, dims, x, y, mask, k)
    # 5. The weighted average into every slot; trained params carry over
    #    when the weights sum to 0.
    new = weighted_average_clients_reference(trained, weights,
                                             broadcast=True)
    return new, state["mu"], state["nu"], state["count"], loss, conf


def check_fused_round_training(local_steps: int, prox_mu: float) -> None:
    """K5 computes one local step of plain Adam a round: refuse more steps
    and FedProx, naming the field."""
    if local_steps != 1:
        raise ValueError(f"fed.local_steps={local_steps}: the fused round "
                         "takes one local step a round")
    if prox_mu != 0:
        raise ValueError(f"fed.prox_mu={prox_mu}: the fused round has no "
                         "FedProx term")


def fused_round(params: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor, weights: torch.Tensor,
                dims, optim: OptimConfig,
                phase_ns: torch.Tensor = None, local_steps: int = 1,
                prox_mu: float = 0.0) -> tuple:
    """One whole FedAvg round of Adam clients: ``params``, ``mu``, ``nu``
    ``(C, D)``, ``count (C,)`` int32, ``x (C, N, dims[0])``, ``y (C, N)``
    int32, ``mask (C, N)``, FedAvg ``weights (C,)`` -> ``(params, mu, nu,
    count, loss (C,), conf (C, K, K))``. ``params`` is the weighted average
    of the trained models in every slot; ``conf`` is the eval of the
    trained, not yet averaged models; ``loss`` is each client's masked CE
    before the step. Every output is freshly allocated; no input is
    written. ``num_classes <= 8``. ``dims``: the MLP's widths, or a
    ``registry.FlatModel``, which must be the float32-compute MLP (another
    model raises, naming its ``model.kind`` or ``model.compute_dtype``).

    On the card: one cooperative launch of K5 (``csrc/fused_round.cu``)
    under ``_fused_round_plan``. ``phase_ns``, an int64 CUDA tensor of at
    least ``(blocks, 8)`` rows, takes each block's %globaltimer stamps of
    the round's three phases (for measurement only). ``local_steps`` and
    ``prox_mu`` are the round's local training: K5 takes only 1 and 0
    (``check_fused_round_training``)."""
    check_fused_round_training(local_steps, prox_mu)
    if optim.name != "adam":
        raise ValueError(f"optim.name={optim.name!r}: the fused round "
                         "computes Adam only")
    dev = _device(params, mu, nu, count, x, y, mask, weights)
    dims = _check_dims(params, kernel_dims(dims, "the fused round"))
    _check_depth(dims)
    if dims[-1] > MAX_CLASSES:
        raise ValueError(f"num_classes={dims[-1]} > {MAX_CLASSES} "
                         "unsupported (per-block confusion tile)")
    c, n = y.shape
    d = param_count(dims)
    # The plain version refuses what the kernel cannot hold, too.
    nbytes = _fused_round_rows(d, dims)[1]
    for t, name in ((params, "params"), (mu, "mu"), (nu, "nu")):
        _check(t, name, torch.float32, (c, d))
    _check(count, "count", torch.int32, (c,))
    _check(x, "x", torch.float32, (c, n, dims[0]))
    _check(y, "y", torch.int32, (c, n))
    _check(mask, "mask", torch.float32, (c, n))
    _check(weights, "weights", torch.float32, (c,))
    if dev.type == "cpu":
        return fused_round_reference(params, mu, nu, count, x, y, mask,
                                     weights, dims, optim)
    if c == 0 or n == 0:
        raise ValueError(f"the fused round needs clients and rows, got "
                         f"C={c}, N={n}")
    plan = _fused_round_plan(d, dims, c, n,
                             _round_resident(dev.index or 0, nbytes))
    if phase_ns is not None and (
            phase_ns.dtype != torch.int64 or phase_ns.device != dev
            or phase_ns.dim() != 2 or phase_ns.shape[0] < plan.blocks
            or phase_ns.shape[1] != 8 or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 tensor of "
                         f"({plan.blocks}, 8) or more rows on {dev}")
    scratch = torch.empty(plan.chunks * c * d + plan.chunks * c + c + c * d,
                          dtype=torch.float32, device=dev)
    outs = [torch.empty_like(params) for _ in range(3)]
    count_out = torch.empty_like(count)
    loss = torch.empty(c, dtype=torch.float32, device=dev)
    conf = torch.empty((c, dims[-1], dims[-1]), dtype=torch.float32,
                       device=dev)
    adam = (ctypes.c_float * 8)(
        optim.learning_rate, optim.steplr_gamma, optim.steplr_step_size,
        optim.b1, 1 - optim.b1, optim.b2, 1 - optim.b2, optim.eps)
    dims_arg = _dims_arg(dims)
    _launch("ft_fused_round", dev, params.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), count.data_ptr(), x.data_ptr(), y.data_ptr(),
            mask.data_ptr(), weights.data_ptr(), c, n,
            ctypes.addressof(dims_arg), len(dims) - 1, ctypes.addressof(adam),
            plan.rows, plan.nbytes, plan.blocks, scratch.data_ptr(),
            *(t.data_ptr() for t in outs), count_out.data_ptr(),
            loss.data_ptr(), conf.data_ptr(),
            None if phase_ns is None else phase_ns.data_ptr())
    _count("fused_round")
    return (*outs, count_out, loss, conf)
