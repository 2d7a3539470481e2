"""The synchronous federated round (``fedtpu.parallel.round``).

Per round, in the reference's order (FL_CustomMLP...:145-198):

    sample       under client sampling, a (C,) participation mask
    train        one full-batch step per client (batched over clients), or
                 ``local_steps`` of them with FedProx's ``prox_mu`` term and
                 SCAFFOLD's drift correction; absentees keep their params
                 and optimizer state
    eval         each client's TRAINED, not yet averaged model on its own
                 shard -> (C, K, K) confusion counts (K2 on the card for
                 the float32 MLP, the model's own forward for any other)
    aggregate    one of the branches below, its result broadcast back into
                 every client slot; a round whose weight total is 0 carries
                 the params over (decided on the device)

The aggregation branches, as ``fedtpu``'s ``build_round_fn`` selects them:

- **Parameter averaging** (the reference's FedAvg), data-size- or uniformly
  weighted over the round's participants, with three backends
  (``FedConfig.aggregation``). ``psum``: K1 (``weighted_average_clients``
  in broadcast mode) over the whole ``(C, D)`` stack, whatever the mesh:
  one launch writes the average into every slot and decides the
  carry-over. ``ring`` / ``ring-rsag``: ``fedtpu``'s formula over the
  clients mesh (``fedtpu_torch.parallel.mesh``): each shard's partial sum
  ``sum_{i in shard} w_i p_i`` (one batched matmul) with the shard's weight
  total appended is all-reduced in one call (``fedtpu_torch.parallel.
  ring``: K4 on the card for ``ring``), then each shard divides by its own
  total and broadcasts its own global into its own clients' slots.
- **The delta path** (a server optimizer, central DP or SCAFFOLD): the
  weighted mean of the clients' updates ``trained_i - g`` (K1 in ``(D,)``
  mode), optionally per-client clipped and noised, is a pseudo-gradient for
  a server optimizer (``fedtpu_torch.ops.server_opt``) whose state lives
  beside the params.
- **int8 exchange**: each mesh shard's weighted partial sum of updates,
  int8-quantized per leaf (``fedtpu_torch.parallel.compress``).
- **Robust rules**: coordinate-wise median / trimmed mean (mask-aware under
  sampling), Krum, or the geometric median of the submitted params.

``byzantine_clients = k`` makes the first k clients submit ``s - 10 (t -
s)`` (``s`` the round-start params, ``t`` their trained ones) to whichever
branch runs, while their local metrics stay honest.

The model is a spec (``fedtpu_torch.models.registry.FlatModel``: the MLP
or the ConvNet, in a param and a compute dtype); every branch runs on its
flat ``(C, D)`` buffer, so each takes any model. Under a bfloat16 or
float16 param dtype every per-client buffer (params, the optimizer's state,
SCAFFOLD's variates) is in that dtype, and each branch casts where
``fedtpu``'s does: every reduction over the clients is float32 (K1 takes
the 16-bit stack and accumulates in float32; the ring's partial sums, the
robust rules' order statistics, the int8 exchange and SCAFFOLD's variate
mean are taken from float32), the server optimizer's state is float32, and
a new global is cast once to the slot dtype as it is broadcast. Where
``fedtpu``'s compiled round keeps the trained params' float32 sum ``p + u``
unrounded into what follows (see ``make_local_train_step``'s ``wide``),
the port takes that float32 sum too: the eval's forward does with one
local step and every client, and so does the reduction of the plain
averaging and of the robust rules without Byzantine injection; every
other reduction takes the rounded params. The new global is rounded once
into the slots. Per-client Adam moments are
never averaged. ``fedtpu`` scans ``rounds_per_step`` rounds inside one
compiled program. Here the step is a Python loop over the chunk's rounds
with no host read and no branch on a device value; on the card
``capture_round_step`` captures it as one CUDA graph, which the host loop
replays once per chunk, and the host reads the chunk's outputs once
(``pack_outputs``). What ``fedtpu`` draws with
``jax.random`` inside its program (participation masks, the DP noise) is
drawn here on the host, a pure function of the seed, the stream and the
round, and handed to the step as a tensor.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional

import numpy as np
import torch

from fedtpu_torch.models.registry import as_model
from fedtpu_torch.ops.cuda_kernels import (count_replay, fused_mlp_forward,
                                           recording_launches,
                                           weighted_average_clients)
from fedtpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.ops.server_opt import (ServerOptimizer, clip_by_global_norm,
                                         identity_server_optimizer,
                                         unit_normals)
from fedtpu_torch.parallel.compress import quantized_weighted_mean
from fedtpu_torch.parallel.mesh import ClientMesh
from fedtpu_torch.parallel.ring import make_all_reduce
from fedtpu_torch.training.client import (make_local_eval_step,
                                          make_local_train_step)

# Domain-separation tags of the DP noise streams, fedtpu's values: the delta
# noise and the adaptive clip's count noise are drawn independently of each
# other and of the participation draws at the same seed and round.
_DP_NOISE_STREAM = 0x6E6F6973  # "nois"
_DP_COUNT_STREAM = 0x636E7420  # "cnt "

# Smoothed-Weiszfeld iterations of geometric_median, fedtpu's fixed budget.
WEISZFELD_ITERS = 16


def effective_delta_noise_multiplier(z: float, z_count: float) -> float:
    """Andrew et al. 2021's split-noise calibration: releasing the noised
    mean delta at ``z_delta = (z^-2 - (2*z_count)^-2)^-1/2`` and the
    recentred clipped count (sensitivity 1/2) at noise std ``z_count``
    costs exactly one Gaussian mechanism of multiplier ``z``, so the
    accountant keeps charging ``z``. Requires ``z_count > z/2``."""
    if z_count <= z / 2:
        raise ValueError(
            f"dp_count_noise_multiplier must exceed dp_noise_multiplier/2 "
            f"(got z_count={z_count} vs z={z}): the clipped-count release "
            "alone would exceed the per-round budget z")
    return (z ** -2 - (2.0 * z_count) ** -2) ** -0.5


def client_init_seeds(init_seed: int, num_clients: int,
                      same_init: bool = False) -> np.ndarray:
    """Per-client init seeds ``(C,)`` uint64 (``fedtpu``'s
    ``client_init_keys``): one seed for every client when ``same_init``,
    else client c's own. The table is prefix-stable (the first n seeds of a
    longer table are the n-client table), so client c's init does not
    depend on the population, nor on the clients drawn before it: the
    synchronous, the asynchronous and the cohort engine (which initialises
    a client when it is first sampled) give client c the same init."""
    words = np.random.SeedSequence([init_seed]).generate_state(
        1 if same_init else num_clients, np.uint64)
    return np.broadcast_to(words, (num_clients,)) if same_init else words


def client_inits(model, seeds) -> torch.Tensor:
    """``(len(seeds), D)`` inits, client c's drawn by ``model.init`` from a
    generator seeded with ``seeds[c]`` (``client_init_seeds``), on the
    CPU."""
    model = as_model(model)
    return torch.stack([model.init(torch.Generator().manual_seed(int(s)))
                        for s in seeds])


def init_federated_state(init_seed: Optional[int], num_clients: int,
                         model, tx: Optimizer,
                         same_init: bool = False,
                         device: torch.device = torch.device("cpu"),
                         params: torch.Tensor = None,
                         server_opt: Optional[ServerOptimizer] = None,
                         shared_start: bool = False,
                         scaffold: bool = False,
                         adaptive_clip_init: Optional[float] = None) -> dict:
    """Client-stacked params ``(C, D)`` + optimizer state on ``device``.

    ``model``: a ``registry.FlatModel``, or the float32 MLP's widths.
    Client c's init is drawn from its own seed of ``client_init_seeds
    (init_seed, C, same_init)`` (the reproducible stand-in for the
    reference's unseeded per-rank init; all clients share one draw when
    ``same_init``). ``params`` (``(C, D)``) replaces the draw, e.g. with
    ``fedtpu``'s own init through ``fedtpu_torch.convert.params_from_jax``;
    ``init_seed`` may then be None.

    As in ``fedtpu``: ``server_opt`` (the delta path) or ``shared_start``
    (the int8 exchange, which rebuilds the global as start + mean delta)
    starts every slot at ``g0``, the mean of the inits; ``server_opt`` adds
    its float32 state ``server_opt_state``. ``scaffold`` adds zero control
    variates, ``client_cv (C, D)`` and their mean ``server_cv (D,)``;
    ``adaptive_clip_init`` the adaptive DP clip ``dp_clip``, a 0-d
    float32 tensor. The params, the optimizer state and the variates are in
    the model's param dtype (``params`` are cast to it, as ``astype``
    rounds)."""
    if params is None:
        seeds = client_init_seeds(init_seed, num_clients, same_init)
        params = (client_inits(model, seeds[:1]).expand(num_clients, -1)
                  if same_init else client_inits(model, seeds))
    if tuple(params.shape[:1]) != (num_clients,):
        raise ValueError(f"params for {params.shape[0]} clients, expected "
                         f"{num_clients}")
    params = params.to(device=device,
                       dtype=as_model(model).param_dtype).contiguous()
    state = {"params": params, "round": 0}
    if server_opt is not None or shared_start:
        g0 = params.mean(dim=0)
        state["params"] = params = g0.expand(num_clients, -1).contiguous()
        # The marker a compressed round checks for (no tensor).
        state["shared_start"] = True
        if server_opt is not None:
            state["server_opt_state"] = {
                k: v.to(torch.float32)
                for k, v in server_opt.init(g0).items()}
    state["opt_state"] = tx.init(params)
    if scaffold:
        if server_opt is None:
            raise ValueError(
                "scaffold runs on the delta path — pass a server_opt "
                "(identity_server_optimizer() for the paper's plain "
                "eta_g=1 server update)")
        state["client_cv"] = torch.zeros_like(params)
        state["server_cv"] = torch.zeros_like(params[0])
    if adaptive_clip_init is not None:
        if adaptive_clip_init <= 0:
            raise ValueError(f"adaptive_clip_init must be > 0, got "
                             f"{adaptive_clip_init}")
        state["dp_clip"] = torch.tensor(adaptive_clip_init,
                                        dtype=torch.float32, device=device)
    return state


def participation_mask(num_clients: int, rate: float, seed: int,
                       rnd: int) -> torch.Tensor:
    """Round ``rnd``'s ``(C,)`` float32 mask: client c participates when its
    uniform draw is below ``rate``. Deterministic in (seed, round, client),
    from an explicit ``torch.Generator`` (not ``fedtpu``'s ``jax.random``
    stream, which torch cannot replay)."""
    key = np.random.SeedSequence([seed, rnd]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(key))
    return (torch.rand(num_clients, generator=gen) < rate).to(torch.float32)


# The state's float tensors besides params and the optimizer state, in the
# order the capture copies them back (fedtpu's state_poisoned covers the
# same entries).
_EXTRA_STATE = ("client_cv", "server_cv", "dp_clip")


def _state_tensors(state: dict) -> list:
    """Every tensor of the state that a round updates, in a fixed order."""
    opt = state["opt_state"]
    sstate = state.get("server_opt_state", {})
    return [state["params"], *(opt[k] for k in sorted(opt)),
            *(sstate[k] for k in sorted(sstate)),
            *(state[k] for k in _EXTRA_STATE if k in state)]


def tensors_finite(tensors) -> torch.Tensor:
    """A device bool: every float tensor of ``tensors`` is entirely finite
    (no host read). Each tensor's largest magnitude (its inf-norm, which
    NaN and inf carry through) is finite exactly when the whole tensor is;
    ``_foreach_norm`` takes all of them in one multi-tensor launch on the
    card."""
    leaves = [t.reshape(-1) for t in tensors if t.is_floating_point()]
    peaks = torch.stack(torch._foreach_norm(leaves, float("inf")))
    return torch.isfinite(peaks).all()


def state_finite(state: dict) -> torch.Tensor:
    """``tensors_finite`` of the round's state: params, optimizer state,
    server optimizer state, control variates, adaptive clip."""
    return tensors_finite(_state_tensors(state))


class RoundStep:
    """``step(state, batch, masks=None, noise=None) -> (state, raw)``
    running ``rounds`` rounds (``build_round_fn``). ``draw_masks(first,
    count)`` gives the ``(count, C)`` participation masks of rounds
    ``first..`` on the host, or None without client sampling;
    ``draw_noise(first, count)`` their ``(count, D + 1)`` DP noise draws, or
    None without DP noise."""

    def __init__(self, fn: Callable, rounds: int,
                 draw_masks: Optional[Callable],
                 draw_noise: Optional[Callable] = None):
        self.fn, self.rounds = fn, rounds
        self.draw_masks, self.draw_noise = draw_masks, draw_noise

    def __call__(self, state: dict, batch: dict,
                 masks: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None):
        return self.fn(state, batch, masks, noise)

    # What ``capture_round_step`` and the host loop ask of a step (the
    # asynchronous engine's ``AsyncStep`` answers the same): its per-chunk
    # inputs as zeroed device buffers, the state tensors it updates, and
    # the names of its outputs besides loss, counts and the finite flag
    # (``pack_outputs``' per-client and per-round parts).
    outputs = ((), ())
    state_tensors = staticmethod(_state_tensors)

    def pack(self, raw: dict):
        """The step's outputs as a captured graph keeps them: one packed
        buffer (``pack_outputs``)."""
        return pack_outputs(raw, *self.outputs)

    def input_buffers(self, state: dict) -> tuple:
        """Zeroed device buffers of the per-chunk inputs: the masks
        ``(R, C)`` and the noise ``(R, D + 1)``, each None when not
        drawn."""
        params = state["params"]
        widths = (params.shape[0] if self.draw_masks else None,
                  params.shape[1] + 1 if self.draw_noise else None)
        return tuple(None if w is None else
                     torch.zeros((self.rounds, w), dtype=torch.float32,
                                 device=params.device) for w in widths)


def check_knobs(weighting, participation_rate, aggregation, server_opt,
                 dp_clip_norm, dp_noise_multiplier, dp_adaptive_clip,
                 dp_target_quantile, dp_clip_lr, dp_count_noise_multiplier,
                 compress, robust_aggregation, trim_ratio, krum_f,
                 byzantine_clients, scaffold) -> tuple:
    """``fedtpu``'s refusals of knob combinations, in its order and with its
    messages (its loop's two fail-fast DP checks first,
    ``fedtpu/orchestration/loop.py:262-268``, then
    ``fedtpu/parallel/round.py:358-502``). Returns ``(delta_path,
    server_opt, dp_z_delta, dp_fixed_denom)``: the delta path's server
    optimizer is ``server_opt``, else the identity one (DP with plain
    averaging, SCAFFOLD's eta_g = 1), else None. ``build_experiment`` and
    ``build_round_fn`` both take it from here."""
    sampling = participation_rate < 1.0
    delta_path = (server_opt is not None or dp_clip_norm > 0
                  or dp_noise_multiplier > 0 or scaffold)
    if dp_noise_multiplier > 0 and dp_clip_norm <= 0:
        raise ValueError("dp_noise_multiplier requires dp_clip_norm > 0 "
                         "(noise std is noise_multiplier * clip / weight)")
    if dp_adaptive_clip and dp_clip_norm <= 0:
        raise ValueError("dp_adaptive_clip needs dp_clip_norm > 0 as the "
                         "initial clip")
    if scaffold:
        if weighting != "uniform":
            raise ValueError("scaffold is defined over the uniform client "
                             "mean (Karimireddy et al. 2020) — set "
                             "weighting='uniform'")
        if dp_clip_norm > 0 or dp_noise_multiplier > 0:
            raise ValueError("scaffold + DP is not supported: the control "
                             "variates are derived from raw local gradients "
                             "and released unclipped/unnoised — an "
                             "unaccounted privacy leak")
        if compress != "none" or robust_aggregation != "none":
            raise ValueError("scaffold composes with the plain delta path "
                             "only (not compress/robust_aggregation)")
        if aggregation != "psum":
            raise ValueError("scaffold requires aggregation='psum' (the "
                             "replicated server variate rides psum's "
                             "provable replication, like server state)")
        if byzantine_clients > 0:
            raise ValueError("byzantine injection corrupts submitted "
                             "updates but not variates — the attack model "
                             "is incoherent under scaffold; use the robust "
                             "rules to study poisoning")
    if delta_path and server_opt is None:
        server_opt = identity_server_optimizer()
    if delta_path and aggregation != "psum":
        raise ValueError("server_opt / DP aggregation requires "
                         "aggregation='psum'")
    dp_z_delta = dp_noise_multiplier
    if dp_adaptive_clip:
        if not 0.0 < dp_target_quantile < 1.0:
            raise ValueError(f"dp_target_quantile must be in (0, 1), got "
                             f"{dp_target_quantile}")
        if dp_clip_lr <= 0:
            raise ValueError(f"dp_clip_lr must be > 0, got {dp_clip_lr}")
        if dp_noise_multiplier > 0:
            dp_z_delta = effective_delta_noise_multiplier(
                dp_noise_multiplier, dp_count_noise_multiplier)
        elif dp_count_noise_multiplier != 0:
            raise ValueError("dp_count_noise_multiplier without "
                             "dp_noise_multiplier is meaningless: with no "
                             "delta noise there is no privacy budget to "
                             "split — set both or neither")
        if compress != "none" or robust_aggregation != "none":
            raise ValueError("dp_adaptive_clip composes with the plain "
                             "delta path only")
    elif dp_count_noise_multiplier != 0:
        raise ValueError("dp_count_noise_multiplier requires "
                         "dp_adaptive_clip=True")
    dp_fixed_denom = dp_clip_norm > 0 and sampling
    if dp_fixed_denom and weighting != "uniform":
        raise ValueError("DP with partial participation requires "
                         "weighting='uniform' (fixed public denominator "
                         "q*C for the sensitivity accounting)")
    if dp_noise_multiplier > 0 and weighting != "uniform":
        raise ValueError("DP noise requires weighting='uniform': the "
                         "per-client sensitivity bound (clip/denominator) "
                         "must be client-agnostic for the noise calibration "
                         "to deliver the requested privacy level")
    if compress not in ("none", "int8"):
        raise ValueError(f"unknown compress mode {compress!r}; "
                         "available: 'none', 'int8'")
    if compress != "none" and delta_path:
        raise ValueError("compress composes with plain averaging only, not "
                         "server_opt / DP aggregation")
    if compress != "none" and aggregation != "psum":
        raise ValueError("compress replaces the reduction; use "
                         "aggregation='psum' with it")
    if robust_aggregation not in ("none", "median", "trimmed_mean", "krum",
                                  "geometric_median"):
        raise ValueError(f"unknown robust_aggregation "
                         f"{robust_aggregation!r}; available: 'none', "
                         "'median', 'trimmed_mean', 'krum', "
                         "'geometric_median'")
    robust = robust_aggregation != "none"
    if robust and (delta_path or compress != "none"
                   or aggregation != "psum"):
        raise ValueError("robust_aggregation composes with the plain psum "
                         "averaging path only (not server_opt/DP/compress/"
                         "ring); for robust aggregation at scale use the "
                         "cohort robust path (cohort_size > 0 with "
                         "robust_aggregation='median'/'trimmed_mean', "
                         "fedtpu.cohort.scheduler)")
    if robust and sampling and robust_aggregation in ("krum",
                                                      "geometric_median"):
        raise ValueError(
            f"robust_aggregation={robust_aggregation!r} needs every "
            "client's update — full participation required "
            "(participation_rate=1.0); under client sampling use "
            "'median'/'trimmed_mean' here, or the cohort robust path "
            "(cohort_size > 0, fedtpu.cohort.scheduler) which samples "
            "cohorts and applies mask-aware order statistics")
    if robust and weighting != "uniform":
        raise ValueError("robust aggregation is unweighted (order "
                         "statistics have no data-size weighting) — set "
                         "weighting='uniform' to make that explicit")
    if not 0 <= trim_ratio < 0.5:
        raise ValueError(f"trim_ratio must be in [0, 0.5), got {trim_ratio}")
    if krum_f < 0:
        raise ValueError("krum_f must be >= 0")
    if byzantine_clients < 0:
        raise ValueError("byzantine_clients must be >= 0")
    return delta_path, server_opt, dp_z_delta, dp_fixed_denom


def _check_state(state: dict, delta_path: bool, compress: str,
                 scaffold: bool, dp_adaptive_clip: bool) -> None:
    """``fedtpu``'s refusals of a state built for another round function
    (``fedtpu/parallel/round.py:910-949``)."""
    if delta_path and "server_opt_state" not in state:
        raise ValueError(
            "delta aggregation (server_opt / DP) needs state from "
            "init_federated_state(..., server_opt=...) — "
            "'server_opt_state' missing")
    if not delta_path and "server_opt_state" in state:
        raise ValueError(
            "state holds 'server_opt_state' (built with server_opt=...) "
            "but this round_fn was built without server_opt / DP — the "
            "server momentum would be silently dropped; build the "
            "round_fn with the same server_opt")
    if compress != "none" and "shared_start" not in state:
        raise ValueError(
            "compressed aggregation reconstructs the global as "
            "start + mean(delta), which needs every client slot to "
            "start the round at the shared global — build the state "
            "with init_federated_state(..., shared_start=True)")
    if scaffold and "client_cv" not in state:
        raise ValueError(
            "scaffold needs control-variate state — build it with "
            "init_federated_state(..., scaffold=True)")
    if not scaffold and "client_cv" in state:
        raise ValueError(
            "state holds control variates (built with scaffold=True) "
            "but this round_fn was built without scaffold — the "
            "variates would silently stop updating; build the "
            "round_fn with scaffold=True")
    if dp_adaptive_clip and "dp_clip" not in state:
        raise ValueError(
            "dp_adaptive_clip needs the clip state — build it with "
            "init_federated_state(..., adaptive_clip_init=...)")
    if not dp_adaptive_clip and "dp_clip" in state:
        raise ValueError(
            "state carries an adaptive clip (built with "
            "adaptive_clip_init=...) but this round_fn was built "
            "without dp_adaptive_clip — the clip would silently "
            "freeze; build the round_fn with dp_adaptive_clip=True")


def _select_rows(ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t[ids]`` for a 0-d device index, with no host read."""
    return torch.index_select(t, 0, ids.reshape(1)).squeeze(0)


def _robust_global(rule: str, flat: torch.Tensor, part, trim_ratio: float,
                   k_trim: int, krum_f: int) -> torch.Tensor:
    """The global model ``(D,)`` of a robust rule over the submitted
    params ``flat (C, D)`` (``fedtpu/parallel/round.py:722-862``). ``part``:
    the round's ``(C,)`` mask under sampling (median / trimmed mean only),
    else None."""
    c = flat.shape[0]
    if rule == "geometric_median":
        # Smoothed Weiszfeld from the mean, fedtpu's fixed budget; distances
        # as fedtpu computes them (not cdist's matmul form).
        mu = flat.mean(dim=0)
        for _ in range(WEISZFELD_ITERS):
            d = torch.sqrt(torch.sum(torch.square(flat - mu), dim=1))
            wgt = 1.0 / torch.clamp(d, min=1e-8)
            mu = (wgt[:, None] * flat).sum(dim=0) / wgt.sum()
        return mu
    if rule == "krum":
        # Centred before the gram matrix, so the shared model magnitude
        # cancels exactly instead of in float32 rounding.
        cen = flat - flat.mean(dim=0, keepdim=True)
        gram = cen @ cen.T
        sq = torch.diagonal(gram)
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram
        eye = torch.eye(c, dtype=torch.bool, device=flat.device)
        d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
        k_near = c - krum_f - 2
        scores = torch.sort(d2, dim=1).values[:, :k_near].sum(dim=1)
        return _select_rows(torch.argmin(scores), flat)
    if part is None:
        srt = torch.sort(flat, dim=0).values
        if rule == "median":
            # jnp.median's midpoint: (lo + hi) * 0.5 (torch.median would
            # take the lower middle value for an even count).
            return (srt[(c - 1) // 2] + srt[c // 2]) * 0.5
        if k_trim:
            srt = srt[k_trim:c - k_trim]
        return srt.mean(dim=0)
    # Under sampling: order statistics of the participants only; absentees
    # sort past every live value as +inf, and the participant count (on the
    # device) addresses the order statistics.
    live = part > 0
    n_act = part.sum()
    n_i = n_act.to(torch.int64)
    srt = torch.sort(torch.where(live[:, None], flat,
                                 torch.full_like(flat, float("inf"))),
                     dim=0).values
    if rule == "median":
        lo = _select_rows(torch.clamp(torch.div(n_i - 1, 2,
                                                rounding_mode="floor"),
                                      min=0), srt)
        hi = _select_rows(torch.clamp(torch.div(n_i, 2, rounding_mode="floor"),
                                      min=0), srt)
        return 0.5 * (lo + hi)
    k_t = torch.round(trim_ratio * n_act).to(torch.int64)
    j = torch.arange(c, device=flat.device)[:, None]
    keep = (j >= k_t) & (j < n_i - k_t)
    denom = torch.clamp((n_i - 2 * k_t).to(torch.float32), min=1.0)
    return torch.where(keep, srt, torch.zeros_like(srt)).sum(dim=0) / denom


def broadcast_global(g: torch.Tensor, num_clients: int,
                     slot_dtype: torch.dtype) -> torch.Tensor:
    """The global ``g (D,)`` in every client slot, cast to the slots'
    dtype (``fedtpu``'s ``bcast_global``)."""
    return g.to(slot_dtype).expand(num_clients, -1).contiguous()


def check_ring_devices(aggregation: str, mesh: ClientMesh,
                       device: torch.device) -> None:
    """The ring backends reduce over shards on ``device`` only."""
    if aggregation != "psum" and any(d != device for d in mesh.devices):
        raise NotImplementedError(
            "a ring over shards on several devices is not ported to "
            "fedtpu_torch yet (ROADMAP A10): it needs the ring kernel over "
            "peer-mapped buffers")


def make_average(aggregation: str, mesh: ClientMesh, slot_dtype: torch.dtype,
                 wide_agg: bool) -> Callable:
    """The plain FedAvg of a round, ``average(params (C, D), w (C,)) ->
    (C, D)``, the new global in every slot or, where the weights sum to 0,
    the params carried over; the synchronous round and the cohort engine
    both average through it. ``psum``: K1 in broadcast mode over the whole
    stack (under ``wide_agg`` a float32 stack into 16-bit slots). ``ring``
    / ``ring-rsag``: each of the mesh's shards' weighted partial sum (one
    batched matmul) with its weight total appended, all-reduced in one call
    (K4 on the card for ``ring``); each shard divides by its own total and
    broadcasts its own global into its own slots."""
    shards, cb = mesh.num_shards, mesh.clients_per_shard
    all_reduce = make_all_reduce(aggregation, shards)

    def psum_average(params, w):
        return weighted_average_clients(
            params, w, broadcast=True,
            **({"out_dtype": slot_dtype} if wide_agg else {}))

    def ring_average(params, w):
        d = params.shape[1]
        blocks = params.view(shards, cb, d)
        partial = torch.bmm(w.view(shards, 1, cb),
                            blocks.to(torch.float32)).view(shards, d)
        total = w.view(shards, cb).sum(dim=1, keepdim=True)
        acc = all_reduce(torch.cat((partial, total), dim=1))
        tot = acc[:, d:]
        glob = (acc[:, :d] / tot.clamp_min(1.0)).to(slot_dtype)
        # Zero participants in the round: params carry over unchanged.
        return torch.where(tot[:, :, None] > 0, glob[:, None, :],
                           blocks.to(slot_dtype)).reshape(shards * cb, d)

    return psum_average if aggregation == "psum" else ring_average


def robust_average(rule: str, agg: torch.Tensor, part, trim_ratio: float,
                   k_trim: int, krum_f: int,
                   slot_dtype: torch.dtype) -> torch.Tensor:
    """A robust rule's global (``_robust_global``, in float32) of the
    submitted params ``agg (C, D)`` in every slot; with a ``(C,)`` mask
    ``part`` (median / trimmed mean over the participants only), the
    submitted params carried over when no one participates."""
    glob = _robust_global(rule, agg.to(torch.float32), part, trim_ratio,
                          k_trim, krum_f)
    out = broadcast_global(glob, agg.shape[0], slot_dtype)
    if part is None:
        return out
    return torch.where(part.sum() > 0, out, agg.to(slot_dtype))


def build_round_fn(model, tx: Optimizer, num_classes: int,
                   client_weights: torch.Tensor,
                   rounds_per_step: int = 1,
                   mesh: Optional[ClientMesh] = None,
                   aggregation: str = "psum",
                   participation_rate: float = 1.0,
                   participation_seed: int = 0,
                   participation_masks: Optional[Callable] = None,
                   local_steps: int = 1,
                   prox_mu: float = 0.0,
                   weighting: str = "data_size",
                   server_opt: Optional[ServerOptimizer] = None,
                   dp_clip_norm: float = 0.0,
                   dp_noise_multiplier: float = 0.0,
                   dp_seed: int = 0,
                   dp_adaptive_clip: bool = False,
                   dp_target_quantile: float = 0.5,
                   dp_clip_lr: float = 0.2,
                   dp_count_noise_multiplier: float = 0.0,
                   dp_noise: Optional[Callable] = None,
                   compress: str = "none",
                   robust_aggregation: str = "none",
                   trim_ratio: float = 0.1,
                   krum_f: int = 0,
                   byzantine_clients: int = 0,
                   scaffold: bool = False) -> RoundStep:
    """Returns ``round_step(state, batch, masks=None, noise=None) -> (state,
    raw)`` running ``rounds_per_step`` rounds of ``model`` (a
    ``registry.FlatModel``, or the float32 MLP's widths); ``raw`` holds the
    stacked per-round ``loss (R, C)`` and ``conf (R, C, K, K)`` and
    ``finite``, a device bool that the new state is finite
    (``state_finite``), all on the device (see ``assemble_metrics``). The
    step reads nothing back to the host, so it can be captured
    (``capture_round_step``).

    ``client_weights (C,)`` are the FedAvg base weights: true shard sizes
    under ``weighting='data_size'``, ones under 'uniform'; under sampling a
    round weighs them by its mask. ``mesh`` (default: one shard) cuts the
    clients into the shards the ring backends and the int8 exchange reduce
    over. ``participation_rate < 1`` samples clients each round
    (``participation_mask``); ``participation_masks`` (round index ->
    ``(C,)`` float32 mask) replaces those draws, e.g. with ``fedtpu``'s.
    Under sampling, ``masks (R, C)`` on the device gives the chunk's masks;
    without it the step draws them on the host (``draw_masks``) and copies
    them over. ``local_steps`` and ``prox_mu``: each round's local training
    (``make_local_train_step``).

    The other knobs are ``fedtpu``'s, with its semantics and refusals
    (``check_knobs``): ``server_opt``, the DP ones, ``compress``, the
    robust ones, ``byzantine_clients`` and ``scaffold``. Under DP noise,
    ``noise (R, D + 1)`` on the device gives each round's unit normals:
    the delta noise in the flat layout, then the count noise; without it
    the step draws them on the host (``draw_noise``: ``unit_normals`` of
    ``(dp_seed, stream, round)``, or ``dp_noise(round) -> (D + 1,)``, e.g.
    ``fedtpu``'s own draws, when given)."""
    if not 0.0 < participation_rate <= 1.0:
        raise ValueError(f"participation_rate must be in (0, 1], got "
                         f"{participation_rate}")
    num_clients = client_weights.shape[0]
    dev = client_weights.device
    if mesh is None:
        mesh = ClientMesh(1, num_clients, (dev,))
    if mesh.num_shards * mesh.clients_per_shard != num_clients:
        raise ValueError(f"a mesh of {mesh.num_shards} x "
                         f"{mesh.clients_per_shard} clients for "
                         f"{num_clients} clients")
    check_ring_devices(aggregation, mesh, dev)
    delta_path, server_opt, dp_z_delta, dp_fixed_denom = check_knobs(
        weighting, participation_rate, aggregation, server_opt,
        dp_clip_norm, dp_noise_multiplier, dp_adaptive_clip,
        dp_target_quantile, dp_clip_lr, dp_count_noise_multiplier, compress,
        robust_aggregation, trim_ratio, krum_f, byzantine_clients, scaffold)
    robust = robust_aggregation != "none"
    shards, cb = mesh.num_shards, mesh.clients_per_shard
    k_trim = int(round(trim_ratio * num_clients))
    if robust_aggregation == "trimmed_mean" and 2 * k_trim >= num_clients:
        raise ValueError(f"trim_ratio={trim_ratio} removes all "
                         f"{num_clients} clients")
    if robust_aggregation == "krum" and num_clients < 2 * krum_f + 3:
        raise ValueError(f"krum needs >= 2 * krum_f + 3 clients "
                         f"(got C={num_clients}, krum_f={krum_f})")
    sampling = participation_rate < 1.0 or participation_masks is not None
    noisy = dp_noise_multiplier > 0
    # The fixed public denominator q*C of DP under sampling, as fedtpu
    # computes it from its mesh.
    fixed_denom = participation_rate * cb * shards
    model = as_model(model)
    d_params = model.param_count
    slot_dtype = model.param_dtype
    # Where fedtpu's float32 p + u reaches a consumer unrounded (measured
    # against its round on the CPU: the eval's forward, and the plain and
    # robust reductions, when the trained params flow straight into them;
    # a select, a scan carry, the delta path's or the Byzantine rows'
    # arithmetic in between rounds them).
    wide = (slot_dtype != torch.float32 and local_steps == 1
            and not sampling)
    wide_agg = (wide and not delta_path and compress == "none"
                and byzantine_clients == 0)
    local_train = make_local_train_step(model, tx, local_steps, prox_mu,
                                        scaffold, wide=wide)
    local_eval = make_local_eval_step(model, num_classes)
    bad = (torch.arange(num_clients, device=dev)
           < byzantine_clients)[:, None]

    def draw_masks(first_round: int, count: int) -> torch.Tensor:
        def one(r):
            if participation_masks is not None:
                return torch.as_tensor(np.array(participation_masks(r),
                                                dtype=np.float32))
            return participation_mask(num_clients, participation_rate,
                                      participation_seed, r)
        return torch.stack([one(first_round + j) for j in range(count)])

    def draw_noise(first_round: int, count: int) -> torch.Tensor:
        def one(r):
            if dp_noise is not None:
                return np.asarray(dp_noise(r), dtype=np.float32)
            count_draw = (unit_normals(dp_seed, _DP_COUNT_STREAM, r, 1)
                          if dp_count_noise_multiplier > 0
                          else np.zeros(1, np.float32))
            return np.concatenate((unit_normals(dp_seed, _DP_NOISE_STREAM,
                                                r, d_params), count_draw))
        return torch.from_numpy(np.stack([one(first_round + j)
                                          for j in range(count)]))

    def broadcast(g):
        return broadcast_global(g, num_clients, slot_dtype)

    average = make_average(aggregation, mesh, slot_dtype, wide_agg)

    def delta_round(agg, start, w, sstate, dpc, noise):
        """The delta path (``fedtpu/parallel/round.py:602-705``): new
        params, server optimizer state and adaptive clip."""
        total_w = w.sum()
        delta = agg - start
        clip_t = dpc if dp_adaptive_clip else dp_clip_norm
        if dp_clip_norm > 0:
            delta, dnorms = clip_by_global_norm(delta, clip_t)
        # K1's (D,) mean divides by the realized weight total; the fixed
        # denominator q*C rescales it (sum w = 0 gives 0 either way).
        mean_delta = weighted_average_clients(delta, w)
        if dp_fixed_denom:
            denom = fixed_denom
            mean_delta = mean_delta * (total_w / fixed_denom)
        else:
            denom = torch.clamp(total_w, min=1.0)
        if noisy:
            std = dp_z_delta * clip_t / denom
            mean_delta = mean_delta + noise[:d_params] * std
        if dp_adaptive_clip:
            present = (w > 0).to(torch.float32)
            count = present.sum()
            denom_b = (fixed_denom if dp_fixed_denom
                       else torch.clamp(count, min=1.0))
            # The recentred count sum_i(indicator_i - 1/2): sensitivity 1/2.
            b_sum = (present * ((dnorms <= clip_t).to(torch.float32)
                                - 0.5)).sum()
            if dp_count_noise_multiplier > 0:
                b_sum = b_sum + dp_count_noise_multiplier * noise[d_params]
            b = b_sum / denom_b + 0.5
            dpc_new = dpc * torch.exp(-dp_clip_lr * (b - dp_target_quantile))
            if dp_count_noise_multiplier == 0:
                # A round with no participant observed nothing: hold the
                # clip (with count noise the release is consumed as drawn).
                dpc_new = torch.where(count > 0, dpc_new, dpc)
            dpc = dpc_new
        step, new_sstate = server_opt.update(mean_delta, sstate)
        if sampling and not dp_fixed_denom:
            # Plain FedOpt under sampling: a round with no participant
            # leaves the server model and its momentum untouched.
            keep = total_w > 0
            step = torch.where(keep, step, torch.zeros_like(step))
            new_sstate = {k: torch.where(keep, v, sstate[k])
                          for k, v in new_sstate.items()}
        return broadcast(start[0] + step), new_sstate, dpc

    def int8_round(agg, start, w, params):
        """The int8 exchange (``fedtpu/parallel/round.py:706-721``)."""
        mean_delta = quantized_weighted_mean(agg - start, w, shards, model)
        return torch.where(w.sum() > 0, broadcast(start[0] + mean_delta),
                           params)

    def robust_round(agg, part):
        return robust_average(robust_aggregation, agg, part, trim_ratio,
                              k_trim, krum_f, slot_dtype)

    def round_step(state, batch, masks=None, noise=None):
        _check_state(state, delta_path, compress, scaffold, dp_adaptive_clip)
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        params, opt_state = state["params"], state["opt_state"]
        sstate = state.get("server_opt_state")
        ccv, scv = state.get("client_cv"), state.get("server_cv")
        dpc = state.get("dp_clip")
        if sampling and masks is None:
            masks = draw_masks(state["round"], rounds_per_step).to(dev)
        if noisy and noise is None:
            noise = draw_noise(state["round"], rounds_per_step).to(dev)
        losses, confs = [], []
        for j in range(rounds_per_step):
            part = masks[j] if sampling else None
            # On the delta path every slot holds the server model.
            start = params
            if scaffold:
                params, opt_state, loss, new_ccv = local_train(
                    params, opt_state, x, y, mask, part, scv[None] - ccv)
                # Variates refresh to the CE gradient at the round start
                # (option I), the first update's; absentees keep theirs. c
                # moves by the mean over ALL clients of the change, so
                # c == mean_i(c_i).
                if part is not None:
                    new_ccv = torch.where(part[:, None] > 0, new_ccv, ccv)
                # The mean in float32, cast back to the variates' dtype.
                scv = (scv + (new_ccv - ccv).to(torch.float32).sum(dim=0)
                       / num_clients).to(scv.dtype)
                ccv = new_ccv
            else:
                params, opt_state, loss = local_train(params, opt_state, x,
                                                      y, mask, part)
            confs.append(local_eval(params, x, y, mask))
            losses.append(loss)
            if wide and not wide_agg:
                params = params.to(slot_dtype)
            w = client_weights * part if sampling else client_weights
            # Byzantine injection: what the first k clients submit.
            agg = (torch.where(bad, start - 10.0 * (params - start), params)
                   if byzantine_clients > 0 else params)
            if delta_path:
                params, sstate, dpc = delta_round(
                    agg, start, w, sstate, dpc,
                    noise[j] if noisy else None)
            elif compress == "int8":
                params = int8_round(agg, start, w, params)
            elif robust:
                params = robust_round(agg, part)
            else:
                params = average(agg, w)
        new_state = {"params": params, "opt_state": opt_state,
                     "round": state["round"] + rounds_per_step}
        for key, value in (("server_opt_state", sstate), ("client_cv", ccv),
                           ("server_cv", scv), ("dp_clip", dpc)):
            if value is not None:
                new_state[key] = value
        if "shared_start" in state:
            new_state["shared_start"] = True
        return new_state, {"loss": torch.stack(losses),
                           "conf": torch.stack(confs),
                           "finite": state_finite(new_state)}

    return RoundStep(round_step, rounds_per_step,
                     draw_masks if sampling else None,
                     draw_noise if noisy else None)


def pack_outputs(raw: dict, per_client: tuple = (),
                 per_round: tuple = ()) -> torch.Tensor:
    """A chunk's ``raw`` as one float32 vector: loss, confusion counts
    (exact in float32 below 2^24), the ``(R, C)`` entries named in
    ``per_client``, the ``(R,)`` entries named in ``per_round``, then the
    finite flag as 1 or 0; one buffer for the host to read."""
    return torch.cat((raw["loss"].reshape(-1), raw["conf"].reshape(-1),
                      *(raw[k].reshape(-1) for k in per_client + per_round),
                      raw["finite"].reshape(1).to(torch.float32)))


def unpack_outputs(flat: torch.Tensor, rounds: int, num_clients: int,
                   num_classes: int, per_client: tuple = (),
                   per_round: tuple = ()) -> dict:
    """Inverse of ``pack_outputs``: ``loss (R, C)``, ``conf (R, C, K,
    K)``, each ``per_client`` entry ``(R, C)``, each ``per_round`` entry
    ``(R,)``, and ``finite`` (a Python bool)."""
    shapes = {"loss": (rounds, num_clients),
              "conf": (rounds, num_clients, num_classes, num_classes),
              **{k: (rounds, num_clients) for k in per_client},
              **{k: (rounds,) for k in per_round}}
    out, at = {}, 0
    for key, shape in shapes.items():
        size = math.prod(shape)
        out[key] = flat[at:at + size].view(shape)
        at += size
    out["finite"] = bool(flat[at] > 0)
    return out


class CapturedRounds:
    """A chunk of ``rounds`` rounds captured as one CUDA graph
    (``capture_round_step``). The state lives in the static tensors of
    ``state``, which each replay updates in place; ``__call__(*inputs)``
    copies the chunk's inputs (the round's: ``(R, C)`` participation masks
    and ``(R, D + 1)`` DP noise draws, each None when not drawn) into the
    graph's input buffers, replays the graph and returns its packed outputs
    (``pack_outputs``), a static tensor the next replay overwrites.
    ``launches`` holds the kernel launches one replay makes; each replay
    adds them to ``cuda_kernels.LAUNCHES``."""

    def __init__(self, graph, state, inputs, out, launches, rounds):
        self.graph, self.state, self.inputs, self.out = (graph, state, inputs,
                                                         out)
        self.launches, self.rounds = launches, rounds

    def __call__(self, *inputs: Optional[torch.Tensor]) -> torch.Tensor:
        for buf, src in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(src, non_blocking=True)
        self.graph.replay()
        count_replay(self.launches)
        return self.out


# One CUDA-graph capture at a time in a process (``capture_round_step``);
# reentrant, so a caller may hold it around its warm-up and capture.
CAPTURE_LOCK = threading.RLock()


def _needs_the_card(state: dict) -> torch.device:
    dev = state["params"].device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
    return dev


def warm_up_round(step: RoundStep, state: dict, batch: dict) -> None:
    """Run ``step`` once, eagerly, on a side stream, its result dropped, so
    that the cuBLAS handles, kernel builds, function attributes and the
    cached SM count exist before ``capture_round_step`` captures. Once per
    run is enough, with a 1-round step: an R-round step launches the same
    kernels. Its launches are real, so they stay counted."""
    dev = _needs_the_card(state)
    live = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(live)
    with torch.cuda.stream(side):
        step.fn(state, batch, *step.input_buffers(state))
    live.wait_stream(side)


def capture_round_step(step: RoundStep, state: dict,
                       batch: dict) -> CapturedRounds:
    """``fedtpu``'s jitted scan of ``rounds_per_step`` rounds as a CUDA
    graph: the round step (a ``RoundStep``, or the asynchronous engine's
    ``AsyncStep``), its kernels (K1 or K4, and K2) and the train step's
    GEMMs, replayed with no per-op dispatch. Call ``warm_up_round``
    once before the first capture.

    ``state``'s tensors become the graph's static state: the captured step
    reads them and ends by copying the new state into them. Capture
    records the launches the step makes into its own count
    (``recording_launches``: capture launches nothing), and each replay
    adds them. A capture that fails raises.

    Several engines may capture in one process (the gateway fleet's
    threads): captures take ``CAPTURE_LOCK`` one at a time, because
    ``torch.cuda.graph`` synchronizes the device and empties the
    allocator's cache before it begins, which a capture under way in
    another thread would not survive; and each captures in the
    ``thread_local`` mode, in which only the capturing thread is barred
    from the calls a capture forbids, so another thread's replays, copies
    and allocations go on meanwhile (the capture's own stream does not
    synchronize with theirs)."""
    _needs_the_card(state)
    inputs = step.input_buffers(state)
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK, recording_launches() as launches:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            new_state, raw = step.fn(state, batch, *inputs)
            for dst, src in zip(step.state_tensors(state),
                                step.state_tensors(new_state)):
                dst.copy_(src)
            out = step.pack(raw)
    return CapturedRounds(graph, state, inputs, out, dict(launches),
                          step.rounds)


def masked_client_mean(per_client: dict, mask: torch.Tensor) -> dict:
    """Mean over clients (last axis) excluding empty shards, so a dataless
    client does not deflate the global metric / early-stop signal."""
    nonempty = (mask.sum(dim=1) > 0).to(torch.float32)
    denom = nonempty.sum().clamp_min(1.0)
    return {k: (v * nonempty).sum(dim=-1) / denom
            for k, v in per_client.items()}


def assemble_metrics(loss: torch.Tensor, conf: torch.Tensor,
                     mask: torch.Tensor) -> dict:
    """Per-round metrics of a chunk: ``loss (R, C)``, ``conf (R, C, K, K)``
    -> per-client ``(R, C)``, client-mean and pooled ``(R,)`` entries."""
    per_client = metrics_from_confusion(conf)
    return {
        "loss": loss,
        "per_client": per_client,
        "client_mean": masked_client_mean(per_client, mask),
        "pooled": metrics_from_confusion(conf.sum(dim=1)),
    }


def global_params(state: dict) -> torch.Tensor:
    """The post-average global model: every client slot holds an identical
    copy, so take slot 0."""
    return state["params"][0]


# Server state whose leading dimension may equal the client count by
# coincidence (the defense screen's (window,) norm ring): never per-client,
# by name, whatever its shape (fedtpu's _SERVER_ONLY_KEYS).
_SERVER_ONLY_KEYS = frozenset({"screen_norms", "screen_count"})


def _per_client_slots(state: dict, num_clients: int, prefix: tuple = ()):
    """``(path, tensor)`` of every tensor of ``state`` (nested dicts, keys
    sorted as ``jax.tree.flatten`` orders them), and whether it is
    per-client."""
    for key in sorted(state):
        value = state[key]
        if isinstance(value, dict):
            yield from _per_client_slots(value, num_clients, prefix + (key,))
        elif isinstance(value, torch.Tensor):
            per_client = (key not in _SERVER_ONLY_KEYS
                          and not _SERVER_ONLY_KEYS & set(prefix)
                          and value.dim() >= 1
                          and value.shape[0] == num_clients)
            yield prefix + (key,), value, per_client


def per_client_view(state: dict, num_clients: int) -> list:
    """The per-client tensors of a federated state (``fedtpu``'s
    ``per_client_view``), in its order: keys sorted, nested dicts
    flattened. The one rule, applied here only: a tensor is per-client when
    its leading dimension is ``num_clients``, except the server-only keys
    (``_SERVER_ONLY_KEYS``), whose leading dimension may equal it by
    coincidence. Numbers (the round counter) are not tensors and never
    per-client. Works on the synchronous and the asynchronous state.

    Where the flat layout differs from ``fedtpu``'s pytree: each ``(C, D)``
    buffer (params, anchors, a moment) stands for all of ``fedtpu``'s leaves
    of that quantity, which it holds in the flat row's order; the optimizer
    keeps one update count per client where optax's chain keeps two equal
    ones (Adam's and the schedule's); and a server buffer of one model's
    leaves (the asynchronous K-buffer) is one ``(D,)`` row here, so a
    leaf of it whose first width equals the client count is never taken
    for a per-client one."""
    return [t for _, t, pc in _per_client_slots(state, num_clients) if pc]


def with_per_client(state: dict, num_clients: int, new_tensors) -> dict:
    """``state`` with its per-client tensors (``per_client_view``'s
    selection, same order) replaced by ``new_tensors``; every other entry
    passes through untouched (a new dict; the tensors are not copied)."""
    it = iter(new_tensors)
    swapped = {path: next(it)
               for path, _, pc in _per_client_slots(state, num_clients)
               if pc}
    rest = list(it)
    if rest:
        raise ValueError(
            f"with_per_client: {len(rest)} replacement leaves left over — "
            "the replacement list must match per_client_view's selection")

    def rebuild(tree, prefix):
        return {k: (rebuild(v, prefix + (k,)) if isinstance(v, dict)
                    else swapped.get(prefix + (k,), v))
                for k, v in tree.items()}

    return rebuild(state, ())


def build_eval_fn(model, num_classes: int) -> Callable:
    """Held-out evaluation of the global model ``(D,)``; the forward is K3
    (``fused_mlp_forward``) on the card for the float32 MLP, the model's own
    forward for any other (``registry.FlatModel``; or the float32 MLP's
    widths)."""
    model = as_model(model)
    dims = model.mlp_dims

    def forward(params, x):
        if dims is not None:
            return fused_mlp_forward(params, dims, x)
        return model.apply(params, x)

    def eval_step(params, x, y):
        preds = torch.argmax(forward(params, x), dim=-1)
        mask = torch.ones(y.shape, dtype=torch.float32, device=y.device)
        return metrics_from_confusion(confusion_matrix(y, preds, mask,
                                                       num_classes))

    return eval_step
