"""Model registry (``fedtpu.models.registry``): a ``ModelConfig`` -> the
model spec the round runs on.

``fedtpu``'s ``build_model`` returns ``(init_fn, apply_fn)`` over a params
pytree. The port keeps every model's parameters as one flat buffer in the
param dtype (``ModelConfig.param_dtype``: float32, bfloat16 or float16),
``(D,)`` or client-stacked ``(C, D)``, so its spec, ``FlatModel``, also
holds that buffer's layout: ``fedtpu``'s leaves by path and shape, in the
flat row's order, and the maps to and from ``fedtpu``'s pytree. Everything
of the round (sampling, the reductions, Adam, DP, the robust rules,
SCAFFOLD, int8, checkpoints) runs on the flat buffer and takes any model;
only the forward pass and the eval route depend on the family.

The eval route is fixed here, by the config: K2 (in-round eval) and K3
(held-out forward) compute the float32 MLP only, as their Pallas
originals; ``mlp_dims`` names its widths, and is None for any other model
(the ConvNet, or an MLP under a bf16 / fp16 param or compute dtype), which
is then evaluated through its own ``apply``, as ``fedtpu`` evaluates it.

The dtype rule is ``fedtpu``'s (``fedtpu/models/mlp.py:42-56``): a compute
dtype equal to the param dtype means no cast; any other casts ``x`` and
every parameter to it, and the logits back to the param dtype. So bfloat16
params under the default float32 compute give bfloat16 logits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import torch

from fedtpu_torch.models import mlp
from fedtpu_torch.models.convnet import (convnet_apply, convnet_init,
                                         convnet_leaves)

# fedtpu's _DTYPES: the dtype names a ModelConfig takes.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _path_key(path: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in path.split("."))


def tree_leaves(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` of a params pytree (dicts and lists) in the flat
    row's order: dict keys sorted, but a layer's ``w`` before its ``b``;
    list entries in order. For ``fedtpu``'s MLP that is ``layers.<i>.w``,
    ``layers.<i>.b``; for its ConvNet ``convs.<i>.{w,b}``, ``dense``,
    ``head``."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (k != "w", k))
        items = [(k, tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def jax_order(paths) -> list:
    """``paths`` in ``jax.tree.leaves``' order (dict keys sorted, so a
    layer's ``b`` before its ``w``)."""
    return sorted(paths, key=_path_key)


def _set_path(tree: dict, path: str, value) -> None:
    parts = _path_key(path)
    node = tree
    for here, nxt in zip(parts[:-1], parts[1:]):
        if isinstance(here, int):
            while len(node) <= here:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[here]
        else:
            node = node.setdefault(here, [] if isinstance(nxt, int) else {})
    node[parts[-1]] = value


def build_tree(pairs) -> dict:
    """The pytree of ``[(path, leaf)]``: ``tree_leaves``' inverse."""
    tree: dict = {}
    for path, leaf in pairs:
        _set_path(tree, path, leaf)
    return tree


def flatten(tree) -> torch.Tensor:
    """A fresh ``(..., D)`` buffer from a params pytree of tensors, leaves
    in the flat row's order; the lead axes are those of its first bias."""
    leaves = tree_leaves(tree)
    lead = next(l for p, l in leaves if p.endswith(".b")).shape[:-1]
    return torch.cat([l.reshape(*lead, -1) for _, l in leaves],
                     dim=-1).contiguous()


@dataclasses.dataclass(frozen=True)
class FlatModel:
    """One model family on the flat parameter buffer.

    ``leaves``: ``((path, shape), ...)`` of ``fedtpu``'s pytree in the flat
    row's order; ``param_dtype``: the buffer's dtype; ``compute_dtype``:
    None when the forward computes in the param dtype, else the dtype
    ``apply`` casts to; ``mlp_dims``: the widths of a float32 MLP (the model
    K2 and K3 compute), else None."""

    kind: str
    leaves: tuple
    param_dtype: torch.dtype
    compute_dtype: Optional[torch.dtype]
    mlp_dims: Optional[tuple]
    _init: Callable = dataclasses.field(repr=False, compare=False)
    _apply: Callable = dataclasses.field(repr=False, compare=False)

    @property
    def param_count(self) -> int:
        """D: the length of one model's flat buffer."""
        return sum(math.prod(shape) for _, shape in self.leaves)

    @property
    def leaf_bounds(self) -> list:
        """``(start, end)`` of each leaf in the flat row."""
        out, off = [], 0
        for _, shape in self.leaves:
            out.append((off, off + math.prod(shape)))
            off += math.prod(shape)
        return out

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Views in ``fedtpu``'s pytree layout of a ``(..., D)`` buffer;
        writes through a view land in ``flat``."""
        if flat.shape[-1] != self.param_count:
            raise ValueError(f"flat buffer has {flat.shape[-1]} params, the "
                             f"{self.kind} needs {self.param_count}")
        lead = flat.shape[:-1]
        return build_tree(
            (path, flat[..., a:b].reshape(*lead, *shape))
            for (path, shape), (a, b) in zip(self.leaves, self.leaf_bounds))

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """One model's ``(D,)`` init in the param dtype on the generator's
        device, under ``fedtpu``'s law (U(-1/sqrt(fan_in),
        1/sqrt(fan_in)))."""
        return self._init(generator, dtype=self.param_dtype)

    def apply(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Logits in the param dtype of ``flat (D,)`` on ``x (N, ...)``,
        or client-stacked ``(C, D)`` on ``(C, N, ...)``, computed in the
        compute dtype."""
        return self._apply(self.unflatten(flat), x)


def _mlp_apply_in(params: dict, x: torch.Tensor,
                  compute_dtype: torch.dtype,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """``fedtpu``'s MLP under a compute dtype: ``x``, each ``w`` and ``b``
    cast to it, ``h @ w + b`` and the ReLU in it, the logits cast back to
    the param dtype. ``fedtpu``'s float32 ``x`` against non-float32 params
    with no compute dtype is this at float32: jnp's promotion."""
    layers = params["layers"]
    h = x.to(compute_dtype)
    for i, lyr in enumerate(layers):
        h = (torch.matmul(h, lyr["w"].to(compute_dtype))
             + lyr["b"].to(compute_dtype).unsqueeze(-2))
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.to(out_dtype)


def mlp_model(dims: Sequence[int],
              compute_dtype: Optional[torch.dtype] = None,
              param_dtype: torch.dtype = torch.float32) -> FlatModel:
    """The MLP of widths ``dims``: ``models.mlp``'s layout, init draws and
    forward, so a float32 MLP's run is the one the port ran before it had
    a spec."""
    dims = tuple(int(d) for d in dims)
    leaves = tuple(
        (f"layers.{j}.{k}", shape)
        for j, (i, o) in enumerate(zip(dims[:-1], dims[1:]))
        for k, shape in (("w", (i, o)), ("b", (o,))))
    plain = compute_dtype is None and param_dtype == torch.float32
    if plain:
        apply = mlp.mlp_apply
    else:
        apply = functools.partial(_mlp_apply_in,
                                  compute_dtype=compute_dtype or torch.float32,
                                  out_dtype=param_dtype)
    return FlatModel(
        kind="mlp", leaves=leaves, param_dtype=param_dtype,
        compute_dtype=compute_dtype, mlp_dims=dims if plain else None,
        _init=functools.partial(mlp.mlp_init, input_dim=dims[0],
                                hidden_sizes=dims[1:-1],
                                num_classes=dims[-1]),
        _apply=apply)


def convnet_model(image_shape: Sequence[int], conv_channels: Sequence[int],
                  hidden: int, num_classes: int,
                  compute_dtype: Optional[torch.dtype] = None,
                  param_dtype: torch.dtype = torch.float32) -> FlatModel:
    leaves = convnet_leaves(image_shape, conv_channels, hidden, num_classes)
    return FlatModel(
        kind="convnet", leaves=leaves, param_dtype=param_dtype,
        compute_dtype=compute_dtype, mlp_dims=None,
        _init=functools.partial(convnet_init, leaves=leaves),
        _apply=functools.partial(convnet_apply, compute_dtype=compute_dtype))


def build_model(cfg) -> FlatModel:
    """``fedtpu``'s ``build_model`` for a ``ModelConfig``: the MLP of
    ``(input_dim, *hidden_sizes, num_classes)`` or the ConvNet of
    ``image_shape``, ``conv_channels``, ``hidden_sizes[0]`` and
    ``num_classes``, with params in ``param_dtype`` and the forward in
    ``compute_dtype`` when it is not the param dtype. A dtype name other
    than ``DTYPES``' raises ``fedtpu``'s ``KeyError``."""
    param_dtype = DTYPES[cfg.param_dtype]
    compute = (None if cfg.compute_dtype == cfg.param_dtype
               else DTYPES[cfg.compute_dtype])
    if cfg.kind == "mlp":
        return mlp_model(mlp.layer_dims(cfg.input_dim, cfg.hidden_sizes,
                                        cfg.num_classes), compute,
                         param_dtype)
    if cfg.kind == "convnet":
        return convnet_model(cfg.image_shape, cfg.conv_channels,
                             cfg.hidden_sizes[0], cfg.num_classes, compute,
                             param_dtype)
    raise ValueError(f"unknown model kind {cfg.kind!r}")


def as_model(model) -> FlatModel:
    """``model`` itself, or the float32 MLP of the widths ``model``."""
    return model if isinstance(model, FlatModel) else mlp_model(model)


def kernel_dims(model, where: str) -> tuple:
    """The widths of the float32 MLP that a kernel of ``where`` computes;
    any other model raises, naming the config field that selects it."""
    model = as_model(model)
    if model.mlp_dims is not None:
        return model.mlp_dims
    if model.kind != "mlp":
        field = f"model.kind={model.kind!r}"
    elif model.param_dtype != torch.float32:
        field = f"model.param_dtype={_dtype_name(model.param_dtype)!r}"
    else:
        field = f"model.compute_dtype={_dtype_name(model.compute_dtype)!r}"
    raise ValueError(f"{field}: {where} computes the float32 MLP only")


def _dtype_name(dtype: torch.dtype) -> str:
    return next(k for k, v in DTYPES.items() if v == dtype)
