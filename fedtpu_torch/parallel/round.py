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
  weighted sum of the clients' updates ``trained_i - g`` (K1's sum mode)
  over the realized weight total, or over the fixed ``q*C`` under DP with
  sampling, optionally per-client clipped and noised, is a pseudo-gradient
  for a server optimizer (``fedtpu_torch.ops.server_opt``) whose state
  lives beside the params.
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
import time
from typing import Callable, Optional

import numpy as np
import torch

from fedtpu_torch.models.registry import as_model
from fedtpu_torch.ops.cuda_kernels import (count_replay, fused_mlp_forward,
                                           recording_launches,
                                           weighted_average_clients,
                                           weighted_sum_clients)
from fedtpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from fedtpu_torch.ops.optim import Optimizer
from fedtpu_torch.ops.server_opt import (ServerOptimizer, clip_by_global_norm,
                                         identity_server_optimizer,
                                         unit_normals)
from fedtpu_torch.parallel.compress import (dequantized_mean,
                                           quantize_partials)
from fedtpu_torch.parallel.mesh import ClientMesh
from fedtpu_torch.parallel.ring import (GangExchange, GangGather,
                                       make_all_reduce)
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
                         adaptive_clip_init: Optional[float] = None,
                         g0: Optional[torch.Tensor] = None) -> dict:
    """Client-stacked params ``(C, D)`` + optimizer state on ``device``.

    ``model``: a ``registry.FlatModel``, or the float32 MLP's widths.
    Client c's init is drawn from its own seed of ``client_init_seeds
    (init_seed, C, same_init)`` (the reproducible stand-in for the
    reference's unseeded per-rank init; all clients share one draw when
    ``same_init``). ``params`` (``(C, D)``) replaces the draw, e.g. with
    ``fedtpu``'s own init through ``fedtpu_torch.convert.params_from_jax``;
    ``init_seed`` may then be None. ``g0``: the shared start in place of
    the mean of ``params``, for a gang member whose ``params`` are its
    block only (the mean over every client of the gang, on the device).

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
        if g0 is None:
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


def draw_participation(num_clients: int, rate: float, seed: int,
                       masks: Optional[Callable], first_round: int,
                       count: int) -> torch.Tensor:
    """The ``(count, C)`` participation masks of rounds ``first_round..``:
    ``masks(round)``'s (e.g. ``fedtpu``'s own draws) when given, else
    ``participation_mask``'s."""
    def one(r):
        if masks is not None:
            return torch.as_tensor(np.array(masks(r), dtype=np.float32))
        return participation_mask(num_clients, rate, seed, r)
    return torch.stack([one(first_round + j) for j in range(count)])


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
            # take the lower middle value for an even count), NaN wherever
            # a client's value is, as jnp.median's (the sort puts NaN last,
            # so the midpoint alone would pass a NaN update over).
            mid = (srt[(c - 1) // 2] + srt[c // 2]) * 0.5
            return torch.where(torch.isnan(srt[-1]),
                               torch.full_like(mid, float("nan")), mid)
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
    """The ring backends reduce over a process's shards on ``device`` only
    (a gang's members each hold theirs on their own device)."""
    if aggregation != "psum" and any(d != device for d in mesh.devices):
        raise NotImplementedError(
            "a ring over one process's shards on several devices is not "
            "ported to fedtpu_torch yet (ROADMAP A10c): it needs K4 across "
            "cards over NVLink")


def shard_partials(w: torch.Tensor, params: torch.Tensor, shards: int,
                   cb: int) -> torch.Tensor:
    """Each of ``shards`` shards' weighted partial sum ``sum_{i in shard}
    w_i p_i`` of the float32 ``params (shards * cb, D)`` with its weight
    total appended, ``(shards, D + 1)``."""
    d = params.shape[1]
    partial = torch.bmm(w.view(shards, 1, cb),
                        params.view(shards, cb, d)).view(shards, d)
    total = w.view(shards, cb).sum(dim=1, keepdim=True)
    return torch.cat((partial, total), dim=1)


def shard_globals(acc: torch.Tensor, params: torch.Tensor, shards: int,
                  cb: int, slot_dtype: torch.dtype) -> torch.Tensor:
    """The ring's ``(shards, D + 1)`` reduced partials into the slots: each
    shard's sum over its own total, cast to the slots' dtype, in every slot
    of its ``cb`` clients, or the shard's ``params`` carried over where its
    total is 0 (no participant)."""
    d = params.shape[1]
    tot = acc[:, d:]
    glob = (acc[:, :d] / tot.clamp_min(1.0)).to(slot_dtype)
    return torch.where(tot[:, :, None] > 0, glob[:, None, :],
                       params.view(shards, cb, d).to(slot_dtype)
                       ).reshape(shards * cb, d)


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
        acc = all_reduce(shard_partials(w, params.to(torch.float32), shards,
                                        cb))
        return shard_globals(acc, params, shards, cb, slot_dtype)

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


def round_branch(delta_path: bool, compress: str,
                 robust_aggregation: str) -> str:
    """The aggregation branch of a synchronous round, in ``fedtpu``'s order
    (``fedtpu/parallel/round.py:602-875``): ``delta`` (a server optimizer,
    central DP or SCAFFOLD), ``int8``, ``robust`` or the plain
    ``average``."""
    if delta_path:
        return "delta"
    if compress == "int8":
        return "int8"
    return "robust" if robust_aggregation != "none" else "average"


def build_gang_exchange(branch: str, aggregation: str, model,
                        mesh: ClientMesh, scaffold: bool, gang,
                        device: torch.device):
    """The exchange a gang member's round of ``branch`` (``round_branch``)
    goes through, the counterpart of ``fedtpu``'s collectives of that
    branch (``build_round_fn``'s ``pre`` builds the payload):

    - ``delta``: a ``GangExchange`` psum of ``D + 3`` floats, the weighted
      sum of the clipped deltas, the weight total, the participant count
      and the adaptive clip's ``b_sum`` (``fedtpu``'s four ``psum``s), and
      under SCAFFOLD ``D`` more, the sum of the variates' changes;
    - ``int8``: a ``GangGather`` of one int8 block a shard: the shard's
      int8 row, then the bytes of its float32 scales and weight total
      (``fedtpu``'s ``all_gather`` of the payloads and scales, one gather);
    - ``robust``: a ``GangGather`` of the member's submitted float32 rows;
    - ``average``: the ``aggregation`` kind's ``GangExchange`` of ``D + 1``
      floats, the psum's partial sum and total or each shard's."""
    model = as_model(model)
    d = model.param_count
    if branch == "int8":
        # The side's float32 scales (one a leaf) and total, 4 bytes each.
        side = 4 * (len(model.leaf_bounds) + 1)
        return GangGather(gang, mesh.local_shards, d + side, torch.int8,
                          device)
    if branch == "robust":
        return GangGather(gang, mesh.local_clients, d, torch.float32, device)
    width = (2 * d + 3 if scaffold else d + 3) if branch == "delta" else d + 1
    return GangExchange(aggregation, gang, mesh, width, device)


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
                   scaffold: bool = False,
                   exchange=None):
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
    ``fedtpu``'s own draws, when given).

    A round is two halves around the reduction of its payload: ``pre``
    trains and evaluates this process's clients, injects the Byzantine
    rows (those whose index in the whole mesh is below
    ``byzantine_clients``) and builds the branch's payload; ``post``
    computes the new global, the server state, SCAFFOLD's server variate
    and the clip from the reduced payload. One process reduces its payload
    in process (as it is, or the ring's all-reduce over its shards; plain
    psum FedAvg keeps K1's broadcast mode, one launch into every slot). A
    ``mesh`` of a training gang (``mesh.num_processes > 1``) makes the
    member's round, a ``GangStep`` over its block of ``client_weights``,
    the exchange between the halves (``exchange``, from
    ``build_gang_exchange``) giving every member the same reduced values,
    so that every member computes the same global, server state and clip;
    every refusal, the fixed denominator and every draw are the whole
    gang's (masks and noise: every member draws the gang's rows from the
    seed, with no collective). The exact branches (the rings, the robust
    rules, int8) reduce the same rows in the same order as one process;
    the psum and the delta path add per-member partial sums: float32
    tolerance. On the card a batched GEMM's bits can depend on its batch
    count (a member trains ``C_local`` clients a batch): float32 tolerance
    there for every branch."""
    if not 0.0 < participation_rate <= 1.0:
        raise ValueError(f"participation_rate must be in (0, 1], got "
                         f"{participation_rate}")
    dev = client_weights.device
    if mesh is None:
        mesh = ClientMesh(1, client_weights.shape[0], (dev,))
    gang = mesh.num_processes > 1
    # The whole mesh's C (a gang's); this process's clients are its block.
    num_clients = mesh.num_shards * mesh.clients_per_shard
    c_local = mesh.local_clients
    if client_weights.shape[0] != c_local:
        raise ValueError(f"a mesh of {mesh.num_shards} x "
                         f"{mesh.clients_per_shard} clients over "
                         f"{mesh.num_processes} process(es) for "
                         f"{client_weights.shape[0]} client weights")
    check_ring_devices(aggregation, mesh, dev)
    delta_path, server_opt, dp_z_delta, dp_fixed_denom = check_knobs(
        weighting, participation_rate, aggregation, server_opt,
        dp_clip_norm, dp_noise_multiplier, dp_adaptive_clip,
        dp_target_quantile, dp_clip_lr, dp_count_noise_multiplier, compress,
        robust_aggregation, trim_ratio, krum_f, byzantine_clients, scaffold)
    branch = round_branch(delta_path, compress, robust_aggregation)
    k_trim = int(round(trim_ratio * num_clients))
    if robust_aggregation == "trimmed_mean" and 2 * k_trim >= num_clients:
        raise ValueError(f"trim_ratio={trim_ratio} removes all "
                         f"{num_clients} clients")
    if robust_aggregation == "krum" and num_clients < 2 * krum_f + 3:
        raise ValueError(f"krum needs >= 2 * krum_f + 3 clients "
                         f"(got C={num_clients}, krum_f={krum_f})")
    sampling = participation_rate < 1.0 or participation_masks is not None
    noisy = dp_noise_multiplier > 0
    shards, cb = mesh.local_shards, mesh.clients_per_shard
    # The fixed public denominator q*C of DP under sampling, as fedtpu
    # computes it from its (whole) mesh.
    fixed_denom = participation_rate * cb * mesh.num_shards
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
    first = mesh.first_shard * cb
    cols = slice(first, first + c_local)
    # Byzantine injection: the clients of index below k in the whole mesh
    # submit s - 10 (t - s).
    bad = ((first + torch.arange(c_local, device=dev))
           < byzantine_clients)[:, None]
    # One process's plain psum FedAvg: K1's broadcast mode.
    average = (make_average(aggregation, mesh, slot_dtype, wide_agg)
               if not gang and branch == "average" and aggregation == "psum"
               else None)

    def draw_masks(first_round: int, count: int) -> torch.Tensor:
        # The whole mesh's masks; a gang member takes its columns.
        return draw_participation(num_clients, participation_rate,
                                  participation_seed, participation_masks,
                                  first_round, count)

    def draw_noise(first_round: int, count: int) -> torch.Tensor:
        # A pure function of the seed and the round: every member of a
        # gang draws the same rows.
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

    def pre(state, batch, part_all, noise):
        """Train, evaluate, the submitted rows and the round's payload;
        ``part_all``: the round's ``(C,)`` mask of the whole mesh, or
        None. Returns ``(carry, payload, outs)``."""
        _check_state(state, delta_path, compress, scaffold, dp_adaptive_clip)
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        part = part_all[cols] if sampling else None
        # On the delta path and under int8 every slot holds the server
        # model.
        start = state["params"]
        carry = {}
        if scaffold:
            ccv, scv = state["client_cv"], state["server_cv"]
            params, opt_state, loss, new_ccv = local_train(
                start, state["opt_state"], x, y, mask, part, scv[None] - ccv)
            # Variates refresh to the CE gradient at the round start
            # (option I), the first update's; absentees keep theirs.
            if part is not None:
                new_ccv = torch.where(part[:, None] > 0, new_ccv, ccv)
            carry["client_cv"] = new_ccv
        else:
            params, opt_state, loss = local_train(
                start, state["opt_state"], x, y, mask, part)
        conf = local_eval(params, x, y, mask)
        if wide and not wide_agg:
            params = params.to(slot_dtype)
        w = client_weights * part if sampling else client_weights
        agg = (torch.where(bad, start - 10.0 * (params - start), params)
               if byzantine_clients > 0 else params)
        carry.update(params=params, opt_state=opt_state, agg=agg, w=w)
        if branch == "delta":
            delta = agg - start
            clip_t = state["dp_clip"] if dp_adaptive_clip else dp_clip_norm
            count = b_sum = torch.zeros((), dtype=torch.float32, device=dev)
            if dp_clip_norm > 0:
                delta, dnorms = clip_by_global_norm(delta, clip_t)
                if dp_adaptive_clip:
                    # The participant count and the recentred count
                    # sum_i(indicator_i - 1/2): sensitivity 1/2.
                    present = (w > 0).to(torch.float32)
                    count = present.sum()
                    b_sum = (present * ((dnorms <= clip_t).to(torch.float32)
                                        - 0.5)).sum()
            # K1's sum mode over the clipped deltas (fedtpu's tensordot
            # before its psum); SCAFFOLD's variate change summed in float32.
            payload = torch.cat((
                weighted_sum_clients(delta.to(torch.float32), w),
                torch.stack((w.sum(), count, b_sum)),
                *(((new_ccv - ccv).to(torch.float32).sum(dim=0),)
                  if scaffold else ())))
        elif branch == "int8":
            q, scales = quantize_partials(agg - start, w, shards, model)
            side = torch.cat((scales, w.view(shards, cb).sum(
                dim=1, keepdim=True)), dim=1)
            payload = torch.cat((q, side.view(torch.int8)), dim=1)
        elif branch == "robust":
            payload = agg.to(torch.float32)
        elif aggregation != "psum":
            payload = shard_partials(w, agg.to(torch.float32), shards, cb)
        elif gang:
            payload = torch.cat((weighted_sum_clients(
                agg.to(torch.float32), w), w.sum().reshape(1)))
        else:
            payload = None
        return carry, payload, {"loss": loss, "conf": conf}

    def post(state, carry, acc, part_all, noise):
        """The new state from the reduced payload ``acc``, the same on
        every member of a gang."""
        start = state["params"]
        new_state = {k: state[k] for k in ("server_opt_state", "server_cv",
                                           "dp_clip", "shared_start")
                     if k in state}
        new_state.update(opt_state=carry["opt_state"], round=state["round"])
        if scaffold:
            new_state["client_cv"] = carry["client_cv"]
        d = d_params
        if branch == "delta":
            # fedtpu/parallel/round.py:602-705.
            total_w, count, b_sum = acc[d], acc[d + 1], acc[d + 2]
            denom = (fixed_denom if dp_fixed_denom
                     else torch.clamp(total_w, min=1.0))
            mean_delta = acc[:d] / denom
            dpc = state.get("dp_clip")
            clip_t = dpc if dp_adaptive_clip else dp_clip_norm
            if noisy:
                std = dp_z_delta * clip_t / denom
                mean_delta = mean_delta + noise[:d] * std
            if dp_adaptive_clip:
                denom_b = (fixed_denom if dp_fixed_denom
                           else torch.clamp(count, min=1.0))
                if dp_count_noise_multiplier > 0:
                    b_sum = b_sum + dp_count_noise_multiplier * noise[d]
                b = b_sum / denom_b + 0.5
                dpc_new = dpc * torch.exp(-dp_clip_lr
                                          * (b - dp_target_quantile))
                if dp_count_noise_multiplier == 0:
                    # A round with no participant observed nothing: hold
                    # the clip (with count noise the release is consumed
                    # as drawn).
                    dpc_new = torch.where(count > 0, dpc_new, dpc)
                new_state["dp_clip"] = dpc_new
            sstate = state["server_opt_state"]
            step, new_sstate = server_opt.update(mean_delta, sstate)
            if sampling and not dp_fixed_denom:
                # Plain FedOpt under sampling: a round with no participant
                # leaves the server model and its momentum untouched.
                keep = total_w > 0
                step = torch.where(keep, step, torch.zeros_like(step))
                new_sstate = {k: torch.where(keep, v, sstate[k])
                              for k, v in new_sstate.items()}
            new_state["server_opt_state"] = new_sstate
            if scaffold:
                # c moves by the mean over ALL the mesh's clients of the
                # change, so c == mean_i(c_i); cast back to its dtype.
                scv = state["server_cv"]
                new_state["server_cv"] = (scv + acc[d + 3:]
                                          / num_clients).to(scv.dtype)
            params = broadcast_global(start[0] + step, c_local, slot_dtype)
        elif branch == "int8":
            # fedtpu/parallel/round.py:706-721: every shard's int8 row and
            # side, dequantized and summed in shard order.
            side = acc[:, d:].contiguous().view(torch.float32)
            total_w = side[:, -1].sum()
            mean_delta = dequantized_mean(acc[:, :d], side[:, :-1], total_w,
                                          model)
            params = torch.where(total_w > 0, broadcast_global(
                start[0] + mean_delta, c_local, slot_dtype), carry["params"])
        elif branch == "robust":
            glob = _robust_global(robust_aggregation, acc, part_all,
                                  trim_ratio, k_trim, krum_f)
            params = broadcast_global(glob, c_local, slot_dtype)
            if sampling:
                params = torch.where(part_all.sum() > 0, params,
                                     carry["agg"].to(slot_dtype))
        elif average is not None:
            params = average(carry["agg"], carry["w"])
        elif aggregation != "psum":
            params = shard_globals(acc, carry["agg"], shards, cb, slot_dtype)
        else:
            tot = acc[d]
            glob = (acc[:d] / tot.clamp_min(1.0)).to(slot_dtype)
            params = torch.where(tot > 0, glob.expand(c_local, -1),
                                 carry["agg"].to(slot_dtype))
        new_state["params"] = params
        return new_state

    if gang:
        def round_buffers(state):
            return (torch.zeros(num_clients, dtype=torch.float32, device=dev)
                    if sampling else None,
                    torch.zeros(d_params + 1, dtype=torch.float32, device=dev)
                    if noisy else None)

        def load_round(state, bufs, j, masks, noise):
            for buf, chunk, draw in ((bufs[0], masks, draw_masks),
                                     (bufs[1], noise, draw_noise)):
                if buf is not None:
                    buf.copy_(chunk[j] if chunk is not None
                              else draw(state["round"] + j, 1)[0])

        def chunk_buffers(state):
            return tuple(None if buf is None else
                         torch.zeros((rounds_per_step,) + tuple(buf.shape),
                                     dtype=torch.float32, device=dev)
                         for buf in round_buffers(state))

        return GangStep(rounds_per_step, pre, post, exchange, round_buffers,
                        load_round, chunk_buffers, _state_tensors, ((), ()),
                        draw_masks=draw_masks if sampling else None,
                        draw_noise=draw_noise if noisy else None)

    # One process reduces in process: the ring's all-reduce over its
    # shards, every other payload as it is.
    reduce = (make_all_reduce(aggregation, shards)
              if branch == "average" and aggregation != "psum"
              else (lambda payload: payload))

    def round_step(state, batch, masks=None, noise=None):
        if sampling and masks is None:
            masks = draw_masks(state["round"], rounds_per_step).to(dev)
        if noisy and noise is None:
            noise = draw_noise(state["round"], rounds_per_step).to(dev)
        end = state["round"] + rounds_per_step
        losses, confs = [], []
        for j in range(rounds_per_step):
            part = masks[j] if sampling else None
            z = noise[j] if noisy else None
            carry, payload, outs = pre(state, batch, part, z)
            state = post(state, carry, reduce(payload), part, z)
            losses.append(outs["loss"])
            confs.append(outs["conf"])
        state = {**state, "round": end}
        return state, {"loss": torch.stack(losses),
                       "conf": torch.stack(confs),
                       "finite": state_finite(state)}

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
    from fedtpu_torch.telemetry.metrics import compile_event
    _needs_the_card(state)
    inputs = step.input_buffers(state)
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK, recording_launches() as launches:
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            new_state, raw = step.fn(state, batch, *inputs)
            for dst, src in zip(step.state_tensors(state),
                                step.state_tensors(new_state)):
                dst.copy_(src)
            out = step.pack(raw)
        # Counted after the capture has ended (graph_captures; no tracer
        # call runs inside a capture).
        compile_event("graph_capture", time.perf_counter() - t0)
    return CapturedRounds(graph, state, inputs, out, dict(launches),
                          step.rounds)


# ------------------------------------------------------------ training gang
class GangStep:
    """``rounds`` rounds of one member of a training gang
    (``fedtpu_torch.parallel.multihost``), each in two pieces around the
    exchange of the round's payload (``ring.GangExchange`` or
    ``ring.GangGather``):
    ``pre(state, batch, *round_inputs) -> (carry, payload, outs)`` (train,
    in-round eval, the partial sums) and ``post(state, carry, reduced,
    *round_inputs) -> state`` (the divide and the broadcast into the
    member's slots). A gloo collective and a host barrier cannot sit inside
    a CUDA graph, so on the card ``capture_gang_step`` captures each piece
    as its own graph and a round replays piece 1, runs the exchange's host
    part, then replays piece 2. ``fn`` runs the same rounds uncaptured. The
    host loop takes it as it takes a ``RoundStep`` (``input_buffers``,
    ``state_tensors``, ``outputs``, ``pack``); its inputs are the chunk's
    masks (the gang's whole rows) and DP noise (``draw_masks``,
    ``draw_noise``: the gang's one draw, on every member), or the member's
    columns of the arrivals."""

    def __init__(self, rounds: int, pre: Callable, post: Callable,
                 exchange, round_buffers: Callable, load_round: Callable,
                 chunk_buffers: Callable, state_tensors: Callable,
                 outputs: tuple, draw_masks: Optional[Callable] = None,
                 draw_arrivals: Optional[Callable] = None,
                 draw_noise: Optional[Callable] = None):
        self.rounds, self.pre, self.post = rounds, pre, post
        self.exchange = exchange
        self.round_buffers, self.load_round = round_buffers, load_round
        self.input_buffers = chunk_buffers
        self.state_tensors = state_tensors
        self.outputs = outputs
        self.draw_masks, self.draw_arrivals = draw_masks, draw_arrivals
        self.draw_noise = draw_noise
        self.out_keys = ("loss", "conf") + outputs[0] + outputs[1]

    def pack(self, raw: dict):
        return pack_outputs(raw, *self.outputs)

    def fn(self, state: dict, batch: dict, a=None, b=None):
        """The chunk uncaptured: ``(state, raw)`` as a ``RoundStep``'s."""
        bufs = self.round_buffers(state)
        start = state["round"]
        outs = {k: [] for k in self.out_keys}
        for j in range(self.rounds):
            self.load_round(state, bufs, j, a, b)
            carry, payload, o = self.pre(state, batch, *bufs)
            self.exchange.stage(payload)
            self.exchange.host()
            state = self.post(state, carry, self.exchange.reduce(), *bufs)
            self.exchange.after()
            for k in self.out_keys:
                outs[k].append(o[k].clone())
        raw = {k: torch.stack(v) for k, v in outs.items()}
        raw["finite"] = tensors_finite(self.state_tensors(state))
        return {**state, "round": start + self.rounds}, raw


class CapturedGang:
    """A gang chunk on the card (``capture_gang_step``): per round, piece
    1's graph, the exchange's host part, piece 2's graph and the second
    host part; the state lives in the static tensors of ``state``, as in
    ``CapturedRounds``. ``__call__(*inputs)`` takes the chunk's inputs
    (masks or arrivals, the first tick) and returns its packed outputs.
    ``launches`` holds the kernel launches a chunk makes."""

    def __init__(self, step: GangStep, graphs: tuple, bufs: tuple,
                 outs: dict, finite: torch.Tensor, piece_launches: tuple):
        self.step, self.graphs, self.bufs = step, graphs, bufs
        self.outs, self.finite = outs, finite
        self.piece_launches = piece_launches
        self.rounds = step.rounds
        self.chunk = {k: torch.empty((step.rounds,) + tuple(v.shape),
                                     dtype=v.dtype, device=v.device)
                      for k, v in outs.items()}
        self.launches = {k: step.rounds * sum(p.get(k, 0)
                                              for p in piece_launches)
                         for k in set().union(*piece_launches)}

    def __call__(self, a=None, b=None) -> torch.Tensor:
        ex = self.step.exchange
        for j in range(self.rounds):
            self.step.load_round(None, self.bufs, j, a, b)
            self.graphs[0].replay()
            count_replay(self.piece_launches[0])
            ex.host()
            self.graphs[1].replay()
            count_replay(self.piece_launches[1])
            ex.after()
            for k, v in self.outs.items():
                self.chunk[k][j].copy_(v)
        return self.step.pack({**self.chunk, "finite": self.finite})


def capture_gang_step(step: GangStep, state: dict,
                      batch: dict) -> CapturedGang:
    """``capture_round_step`` for a gang: the two pieces of one round, each
    its own CUDA graph, over the static tensors of ``state`` (piece 2 ends
    by copying the new state into them). Call ``warm_up_round`` first."""
    from fedtpu_torch.telemetry.metrics import compile_event
    _needs_the_card(state)
    bufs = step.round_buffers(state)
    pre_graph, post_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with CAPTURE_LOCK:
        t0 = time.perf_counter()
        with recording_launches() as pre_launches:
            with torch.cuda.graph(pre_graph,
                                  capture_error_mode="thread_local"):
                carry, payload, outs = step.pre(state, batch, *bufs)
                step.exchange.stage(payload)
        with recording_launches() as post_launches:
            with torch.cuda.graph(post_graph,
                                  capture_error_mode="thread_local"):
                new_state = step.post(state, carry, step.exchange.reduce(),
                                      *bufs)
                for dst, src in zip(step.state_tensors(state),
                                    step.state_tensors(new_state)):
                    dst.copy_(src)
                finite = tensors_finite(step.state_tensors(state))
        compile_event("graph_capture", time.perf_counter() - t0)
    return CapturedGang(step, (pre_graph, post_graph), bufs,
                        {k: outs[k] for k in step.out_keys}, finite,
                        (dict(pre_launches), dict(post_launches)))


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
