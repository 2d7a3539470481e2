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
so a run can show that its main path went through the kernels.

The parameters of a model are a flat float32 buffer with ``dims =
(input_dim, *hidden_sizes, num_classes)`` (``fedtpu_torch.models.mlp``);
client-stacked as ``(C, D)``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fedtpu_torch.config import OptimConfig
from fedtpu_torch.models.mlp import mlp_apply, param_count, unflatten
from fedtpu_torch.ops.losses import masked_cross_entropy
from fedtpu_torch.ops.metrics import confusion_matrix, one_hot
from fedtpu_torch.ops.optim import build_optimizer

LAUNCHES = {"weighted_average_clients": 0, "fused_eval_confusion": 0,
            "fused_mlp_forward": 0, "ring_all_reduce_sum": 0,
            "fused_round": 0}

# Dynamic shared memory one block may opt into on sm_90 (227 KB).
SMEM_BYTES_MAX = 232_448
MAX_LAYERS = 16           # FT_MAX_LAYERS in csrc/mlp_forward.cuh
MAX_CLASSES = 8
_ROW_TILES = (32, 16, 8, 4, 2, 1)
RING_MAX_SHARDS = 64      # FT_RING_MAX_SHARDS in csrc/ring_all_reduce.cu
_ROUND_ROWS = (64, 32, 16, 8, 4, 2, 1)   # FT_ROUND_MAX_ROWS in fused_round.cu


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


def _rows_per_block(num_params: int, dims: tuple) -> int:
    """K3's row tile: the largest whose parameters + two activation buffers
    fit in a block's shared memory (ft_tile_smem_bytes in mlp_forward.cuh)."""
    for rows in _ROW_TILES:
        if 4 * (num_params + 2 * rows * max(dims)) <= SMEM_BYTES_MAX:
            return rows
    raise ValueError(
        f"one model's {num_params} parameters do not fit in a block's "
        f"{SMEM_BYTES_MAX} bytes of shared memory")


def _eval_plan(num_params: int, dims: tuple) -> tuple:
    """K2's row tile and shared memory: ``(rows, bytes)`` for the largest
    row tile whose block fits. The layout is the one eval_confusion.cu
    carves, which refuses a byte count that does not hold it: a 4-float
    header, the parameters with alignment slack, one x tile, two activation
    tiles at an odd stride, and the K x K counts."""
    params = (num_params + 3 + 3) // 4 * 4
    ld = max(d | 1 for d in dims[1:])
    for rows in _ROW_TILES:
        floats = 4 + params + rows * (dims[0] + 2 * ld) + dims[-1] ** 2
        if 4 * floats <= SMEM_BYTES_MAX:
            return rows, 4 * floats
    raise ValueError(
        f"one model's {num_params} parameters and a one-row tile do not fit "
        f"in a block's {SMEM_BYTES_MAX} bytes of shared memory")


def _fused_round_plan(num_params: int, dims: tuple) -> tuple:
    """K5's row chunk and shared memory: ``(rows, bytes)`` for the largest
    chunk whose block fits. The layout is the one fused_round.cu carves,
    which refuses a byte count that does not hold it: the parameters rounded
    up to 4 floats, the x tile, every layer's output and two dz buffers (odd
    strides), the tile's mask and labels, 32 floats of reduction scratch and
    the K x K counts."""
    lds = [d | 1 for d in dims[1:]]
    fixed = (num_params + 3) // 4 * 4 + 32 + dims[-1] ** 2
    for rows in _ROUND_ROWS:
        floats = fixed + rows * (dims[0] + sum(lds) + 2 * max(lds) + 2)
        if 4 * floats <= SMEM_BYTES_MAX:
            return rows, 4 * floats
    raise ValueError(
        f"model.hidden_sizes={list(dims[1:-1])}: one model's {num_params} "
        f"parameters and a one-row chunk do not fit in a block's "
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
    rows, nbytes = _eval_plan(param_count(dims), dims)
    dims_arg = _dims_arg(dims)
    _launch("ft_eval_confusion", dev, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(),
            y.data_ptr(), mask.data_ptr(), c, n, rows, nbytes,
            conf.data_ptr())
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
    rows = _rows_per_block(param_count(dims), dims)
    dims_arg = _dims_arg(dims)
    _launch("ft_mlp_forward", dev, flat.data_ptr(), param_count(dims),
            ctypes.addressof(dims_arg), len(dims) - 1, x.data_ptr(), n, rows,
            out.data_ptr())
    LAUNCHES["fused_mlp_forward"] += 1
    return out


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
    if not 2 <= s <= RING_MAX_SHARDS:
        raise ValueError(f"{s} shards: the ring kernel takes 2.."
                         f"{RING_MAX_SHARDS}")
    out = torch.empty_like(stack)
    if p == 0:
        return out
    row = 4 * p
    xs = (ctypes.c_void_p * s)(*(stack.data_ptr() + d * row for d in range(s)))
    accs = (ctypes.c_void_p * s)(*(out.data_ptr() + d * row for d in range(s)))
    _launch("ft_ring_all_reduce", dev, ctypes.addressof(xs),
            ctypes.addressof(accs), s, p)
    LAUNCHES["ring_all_reduce_sum"] += 1
    return out


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
    glob = weighted_average_clients_reference(trained, weights)
    new = torch.where(weights.sum() > 0, glob.expand_as(trained), trained)
    return new, state["mu"], state["nu"], state["count"], loss, conf


def fused_round(params: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor, weights: torch.Tensor,
                dims: Sequence[int], optim: OptimConfig) -> tuple:
    """One whole FedAvg round of Adam clients: ``params``, ``mu``, ``nu``
    ``(C, D)``, ``count (C,)`` int32, ``x (C, N, dims[0])``, ``y (C, N)``
    int32, ``mask (C, N)``, FedAvg ``weights (C,)`` -> ``(params, mu, nu,
    count, loss (C,), conf (C, K, K))``. ``params`` is the weighted average
    of the trained models in every slot; ``conf`` is the eval of the
    trained, not yet averaged models; ``loss`` is each client's masked CE
    before the step. Every output is freshly allocated; no input is
    written. ``num_classes <= 8``.

    On the card: one cooperative launch of K5 (``csrc/fused_round.cu``)."""
    if optim.name != "adam":
        raise ValueError(f"optim.name={optim.name!r}: the fused round "
                         "computes Adam only")
    dev = _device(params, mu, nu, count, x, y, mask, weights)
    dims = _check_dims(params, dims)
    if dims[-1] > MAX_CLASSES:
        raise ValueError(f"num_classes={dims[-1]} > {MAX_CLASSES} "
                         "unsupported (per-block confusion tile)")
    c, n = y.shape
    d = param_count(dims)
    # The plain version refuses what the kernel cannot hold, too.
    rows, nbytes = _fused_round_plan(d, dims)
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
    chunks = -(-n // rows)
    scratch = torch.empty(chunks * c * d + chunks * c + c + c * d,
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
            rows, nbytes, scratch.data_ptr(),
            *(t.data_ptr() for t in outs), count_out.data_ptr(),
            loss.data_ptr(), conf.data_ptr())
    LAUNCHES["fused_round"] += 1
    return (*outs, count_out, loss, conf)
