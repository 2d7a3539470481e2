"""The ConvNet of the CIFAR-10 FedAvg stress config (``fedtpu.models.convnet``)
on one flat parameter buffer.

Architecture, as ``fedtpu``'s: [3x3 conv, SAME, stride 1 -> ReLU -> 2x2
max-pool, VALID] once per entry of ``conv_channels``, then flatten ->
Dense(hidden) -> ReLU -> Dense(classes). ``fedtpu`` is NHWC with HWIO
kernels, and its flatten before ``dense`` is in NHWC order; the flat buffer
keeps those layouts (each leaf ``fedtpu``'s array, row-major), so converting
to and from ``fedtpu`` is a reshape, and ``convnet_apply`` permutes to
PyTorch's NCHW / OIHW inside.

Leaves, in the flat row's order: ``convs.<i>.w (3, 3, cin, cout)``,
``convs.<i>.b (cout,)``, ..., ``dense.w (flat, hidden)``, ``dense.b``,
``head.w (hidden, classes)``, ``head.b``.

Client-stacked params ``(C, D)`` run every client's convolution in one
grouped ``conv2d`` (``groups=C``): the batch's rows are the convolution's
batch, each client's channels one group, since every shard is padded to the
same row count.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def convnet_leaves(image_shape: Sequence[int], conv_channels: Sequence[int],
                   hidden: int, num_classes: int) -> tuple:
    """``((path, shape), ...)`` of the flat row, in order."""
    h, w, cin = (int(v) for v in image_shape)
    out = []
    for i, cout in enumerate(int(c) for c in conv_channels):
        out += [(f"convs.{i}.w", (3, 3, cin, cout)), (f"convs.{i}.b", (cout,))]
        cin = cout
        h, w = h // 2, w // 2           # 2x2 max-pool, VALID, per block
    flat = h * w * cin
    return tuple(out) + (("dense.w", (flat, int(hidden))),
                         ("dense.b", (int(hidden),)),
                         ("head.w", (int(hidden), int(num_classes))),
                         ("head.b", (int(num_classes),)))


def convnet_init(generator: torch.Generator, leaves: tuple,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One model's flat ``(D,)`` parameters in ``dtype`` on the generator's
    device, under ``fedtpu``'s law: each layer's ``w`` and ``b`` from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``fan_in`` the product of ``w``'s
    shape but its output axis (a conv's ``3 * 3 * cin``, ``dense``'s
    flattened width, the head's hidden width). The same law as ``fedtpu``'s
    init, not the same numbers."""
    sizes = [math.prod(shape) for _, shape in leaves]
    flat = torch.empty(sum(sizes), dtype=dtype, device=generator.device)
    parts = flat.split(sizes)
    for j in range(0, len(leaves), 2):      # (w, b) of one layer
        bound = 1.0 / math.sqrt(math.prod(leaves[j][1][:-1]))
        parts[j].uniform_(-bound, bound, generator=generator)
        parts[j + 1].uniform_(-bound, bound, generator=generator)
    return flat


def convnet_apply(params: dict, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Forward pass -> logits in the param dtype, in ``fedtpu``'s order of
    operations: ``x``, each ``w`` and each ``b`` cast to ``compute_dtype``
    (None: no cast, which ``fedtpu``'s convolution takes only when ``x``'s
    float32 is the param dtype); each conv's output rounded to it before the
    bias add, ``relu(h + b)`` and the max-pool in it; the logits cast back
    to the param dtype.

    One model: ``x (N, H, W, cin)`` or flat rows ``(N, H*W*cin)``, every
    leaf without a lead axis. Client-stacked: ``x (C, N, ...)`` and every
    leaf with a leading ``C``; one grouped convolution runs all clients."""
    convs, dense, head = params["convs"], params["dense"], params["head"]
    lead = head["b"].shape[:-1]
    if len(lead) > 1:
        raise ValueError(f"params with lead axes {tuple(lead)}: one model "
                         "or one clients axis")
    if not lead:                         # one model: a clients axis of 1
        def one(t):
            return t.unsqueeze(0)
        params = {"convs": [{k: one(v) for k, v in c.items()} for c in convs],
                  "dense": {k: one(v) for k, v in dense.items()},
                  "head": {k: one(v) for k, v in head.items()}}
        return convnet_apply(params, x.unsqueeze(0), compute_dtype)[0]
    out_dtype = head["w"].dtype
    if compute_dtype is None and x.dtype != out_dtype:
        raise TypeError(
            f"the ConvNet's convolution needs x and the params in one "
            f"dtype, got {x.dtype}, {out_dtype} (fedtpu refuses it too): "
            "set a compute_dtype apart from param_dtype")
    cast = ((lambda a: a.to(compute_dtype)) if compute_dtype is not None
            else (lambda a: a))
    c = lead[0]
    n = x.shape[1]
    if x.dim() == 3:                     # flat rows from the packed batch
        cin = convs[0]["w"].shape[-2]
        side = math.isqrt(x.shape[2] // cin)
        x = x.reshape(c, n, side, side, cin)
    # (C, N, H, W, cin) -> (N, C*cin, H, W): each client's channels a group.
    h = cast(x).permute(1, 0, 4, 2, 3).reshape(n, c * x.shape[4],
                                               x.shape[2], x.shape[3])
    for conv in convs:
        w = cast(conv["w"])              # (C, 3, 3, cin, cout), HWIO
        cout = w.shape[-1]
        weight = w.permute(0, 4, 3, 1, 2).reshape(c * cout, w.shape[3], 3, 3)
        h = F.conv2d(h, weight, padding=1, groups=c)
        hh, ww = h.shape[2], h.shape[3]
        h = torch.relu(h.reshape(n, c, cout, hh, ww)
                       + cast(conv["b"]).view(1, c, cout, 1, 1))
        h = F.max_pool2d(h.reshape(n, c * cout, hh, ww), 2, 2)
    # Flatten in NHWC order, per client: (N, C*cout, h, w) -> (C, N, h*w*cout).
    hh, ww = h.shape[2], h.shape[3]
    h = h.reshape(n, c, -1, hh, ww).permute(1, 0, 3, 4, 2).reshape(c, n, -1)
    h = torch.relu(torch.matmul(h, cast(dense["w"]))
                   + cast(dense["b"]).unsqueeze(-2))
    h = torch.matmul(h, cast(head["w"])) + cast(head["b"]).unsqueeze(-2)
    return h.to(out_dtype)
