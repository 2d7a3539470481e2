"""Run manifest (the port's copy of ``fedtpu.telemetry.manifest``): the
attribution record every artifact needs.

Emitted once at run start as the sink's ``manifest`` event: the config dump
and its stable hash, the mesh shape, the backend and device kinds, the
package, torch and python versions, and a best-effort git revision.

The config hash is ``fedtpu``'s: sha256 over the sorted-key JSON of the
dataclass dump, so equal configs hash equally in both packages.

The ``profile`` entry (``profile_entry``) holds what ``fedtpu`` takes from
XLA's cost model of one round, computed here from the model spec and the
batch shape, whatever kernel does the work: ``flops_per_round``, the
matrix-product and convolution flops of one round (``round_flops``), and
``bytes_per_round``, the round's state read once and written once and its
batch read once (``round_bytes``; the rule is named in the entry).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
from typing import Optional

from fedtpu_torch.telemetry.metrics import tree_nbytes


def config_digest(cfg) -> str:
    """Stable 16-hex-char digest of an ExperimentConfig (or any dataclass
    or dict tree)."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    canon = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _git_rev() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "-C", here, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def _layer_flops(model, features: int) -> list:
    """Per-sample multiply-add flops (2 a product) of each weight layer of
    ``model`` (a ``FlatModel``) on rows of ``features`` inputs, in order."""
    leaves = [shape for path, shape in model.leaves if path.endswith(".w")]
    out = []
    if model.kind == "convnet":
        cin0 = leaves[0][2]
        side = math.isqrt(features // cin0)
        h = w = side
        for shape in leaves:
            if len(shape) == 4:         # (3, 3, cin, cout), SAME, then pool
                kh, kw, cin, cout = shape
                out.append(2 * h * w * cout * kh * kw * cin)
                h, w = h // 2, w // 2
            else:
                out.append(2 * shape[0] * shape[1])
        return out
    return [2 * a * b for a, b in leaves]


def round_flops(model, num_clients: int, rows: int, features: int,
                num_classes: int, local_steps: int = 1) -> int:
    """Matrix-product and convolution flops of one plain round over a
    ``(num_clients, rows, features)`` batch (padding rows included):
    ``local_steps`` training steps (the forward, every layer's weight
    gradient, and the input gradient of every layer but the first), then
    the in-round eval's forward and its confusion counts (one
    ``(K, rows) @ (rows, K)`` product a client). Element-wise work, the
    reductions and the aggregation are not counted."""
    per = _layer_flops(model, features)
    n = num_clients * rows
    fwd = n * sum(per)
    train = fwd + fwd + n * sum(per[1:])
    confusion = 2 * num_clients * rows * num_classes * num_classes
    return int(local_steps * train + fwd + confusion)


def round_bytes(state: dict, batch: dict) -> int:
    """The round's state read once and written once, and its batch read
    once (bytes)."""
    return 2 * tree_nbytes(state) + tree_nbytes(batch)


def profile_entry(model, state: dict, batch: dict, num_classes: int,
                  local_steps: int, profile_rounds: int) -> dict:
    """The manifest's ``profile``: ``flops_per_round``,
    ``bytes_per_round`` (with its rule), ``profile_rounds`` and, when the
    environment sets ``FEDTPU_PEAK_FLOPS``, ``peak_flops``."""
    c, rows, features = batch["x"].shape
    out = {
        "flops_per_round": float(round_flops(
            model, c, rows, features, num_classes, local_steps)),
        "bytes_per_round": float(round_bytes(state, batch)),
        "bytes_per_round_rule": "state read once and written once, batch "
                                "read once",
        "profile_rounds": int(profile_rounds),
    }
    peak_env = os.environ.get("FEDTPU_PEAK_FLOPS")
    if peak_env:
        out["peak_flops"] = float(peak_env)
    return out


def build_manifest(cfg=None, mesh=None, extra: Optional[dict] = None,
                   device=None, gang=None) -> dict:
    """The manifest payload. ``cfg``: the ExperimentConfig (or None);
    ``mesh``: the run's ``ClientMesh``; ``device``: the run's device
    (``backend`` 'cuda' or 'cpu'; the card's name in ``device_kinds``);
    ``gang``: a training gang's member (its index, the gang's size, the
    collective backend and the member's device)."""
    import torch

    import fedtpu_torch

    out: dict = {
        "package": "fedtpu_torch",
        "package_version": fedtpu_torch.__version__,
        "python_version": sys.version.split()[0],
        "git_rev": _git_rev(),
        "argv": list(sys.argv),
    }
    if cfg is not None:
        out["config"] = dataclasses.asdict(cfg) \
            if dataclasses.is_dataclass(cfg) else dict(cfg)
        out["config_hash"] = config_digest(cfg)
    dev = torch.device(device if device is not None else "cpu")
    out["torch_version"] = torch.__version__
    out["backend"] = dev.type
    if dev.type == "cuda":
        out["device_count"] = torch.cuda.device_count()
        out["device_kinds"] = sorted({torch.cuda.get_device_name(i) for i in
                                      range(torch.cuda.device_count())})
    else:
        out["device_count"] = 1
        out["device_kinds"] = ["cpu"]
    from fedtpu_torch.parallel.multihost import describe
    out.update(describe(gang))
    if mesh is not None:
        out["mesh_shape"] = {"clients": int(mesh.num_shards)}
    if extra:
        out.update(extra)
    return out
