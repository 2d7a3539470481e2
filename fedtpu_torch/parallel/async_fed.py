"""Asynchronous federated aggregation, FedBuff-style
(``fedtpu.parallel.async_fed``).

The synchronous round waits for every client. Here the round becomes a
server TICK and clients run against the global they last pulled:

- every client carries an ANCHOR, the global it last pulled, and the tick
  it pulled it at (``pull_tick``);
- each tick a signed arrival weight per client marks who completes: a
  Bernoulli(``arrival_rate``) draw (1 or 0), or in driven mode the caller's
  weights (honest 1.0, a poisoned arrival ``-scale``);
- every client trains ``local_steps`` full-batch steps from its anchor
  (FedProx's ``prox_mu`` pulls towards it); arrivals adopt the trained
  params and optimizer state, and ship ``delta = trained - anchor`` with
  staleness ``s = tick - pull_tick``;
- the server sums ``w * (1 + s)^-p * delta`` over the arrivals (K1 in its
  sum mode, ``weighted_sum_clients``) into its buffer, and once the buffer
  holds ``buffer_size`` updates (every arrival tick below 2) moves the
  global by ``server_lr`` times the buffer's mean, and empties it;
- arrivals re-pull the new global; absentees keep aging.

``screen=True`` (driven mode) scores each submitted update ``w * delta``
before the buffer, as ``fedtpu``'s streaming screen does: a non-finite
update, a norm past ``screen_norm_mult`` times the rolling median of the
accepted norms, or a cosine below ``screen_cos_min`` against the server's
direction (the pending buffer plus this tick's norm-normalised arrivals,
a second K1 sum) is treated as if it never arrived. ``clip_norm > 0``
clips each submitted update to that norm before the sum.

Where the port differs from ``fedtpu``:

- ``fedtpu`` scans ``ticks_per_step`` ticks in one compiled program and
  draws the arrivals with ``jax.random`` inside it. Here the step is a
  Python loop over the chunk's ticks with no host read and no branch on a
  device value, so on the card the loop captures it as one CUDA graph
  (``fedtpu_torch.parallel.round.capture_round_step``); the arrivals are an
  ``(R, C)`` float32 input of the step in both modes, and in the synthetic
  mode the host draws them from its own numpy stream keyed by
  ``(arrival_seed, tick)`` (``arrival_mask``), so a resumed run draws the
  same ones. The chunk's first tick is a device input too.
- ``fedtpu`` psums per-shard contractions over its clients mesh; the
  port's clients sit on one card, so one K1 launch over all C clients in
  client order is the sum.
- The update norms and the screen's dot products are taken over each
  client's flat row, where ``fedtpu`` sums per leaf and then over leaves:
  they agree to the last bits, not bitwise.

The state is ``fedtpu``'s: ``params`` (each client's last trained model),
``anchors``, ``opt_state``, ``pull_tick (C,) int32`` and ``round``;
``buf_delta (D,)`` float32 and ``buf_count`` with ``buffer_size >= 2``;
``screen_norms (W,)`` and ``screen_count`` with ``screen_window >= 1``.
The params, anchors and optimizer state are in the model's param dtype;
the deltas, the buffer and every sum are float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fedtpu_torch.models.registry import as_model
from fedtpu_torch.ops.cuda_kernels import weighted_sum_clients
from fedtpu_torch.ops.optim import Optimizer, _in, select_participants
from fedtpu_torch.parallel.round import (RoundStep, _select_rows,
                                         assemble_metrics, client_init_seeds,
                                         client_inits, per_client_view,
                                         tensors_finite, with_per_client)
from fedtpu_torch.training.client import (make_local_eval_step,
                                          make_local_train_step)

# Domain-separation tag of the arrival draws: an arrival seed equal to a
# participation seed draws an independent stream.
_ARRIVAL_STREAM = 0x61727276  # "arrv"
# fedtpu's guard against a zero norm in the screen and the clip.
_EPS = 1e-12


def arrival_mask(num_clients: int, rate: float, seed: int,
                 tick: int) -> np.ndarray:
    """Tick ``tick``'s ``(C,)`` float32 arrivals: client c completes (1.0)
    when its uniform draw is below ``rate``, every client at rate 1, as
    ``fedtpu``'s law. Deterministic in (seed, tick, client), from numpy
    (torch cannot replay ``fedtpu``'s ``jax.random`` stream)."""
    if rate >= 1.0:
        return np.ones(num_clients, np.float32)
    rng = np.random.default_rng([_ARRIVAL_STREAM, seed, tick])
    return (rng.random(num_clients) < rate).astype(np.float32)


def init_async_state(init_seed: Optional[int], num_clients: int, model,
                     tx: Optimizer, same_init: bool = True,
                     device: torch.device = torch.device("cpu"),
                     params: Optional[torch.Tensor] = None,
                     buffer_size: int = 0, screen_window: int = 0) -> dict:
    """Every client starts having just pulled the shared initial global at
    tick 0: the mean of the clients' inits (client c's drawn from its seed
    of ``round.client_init_seeds(init_seed, C, same_init)``, one shared
    draw when ``same_init``; or ``params (C, D)``, e.g. ``fedtpu``'s own
    through ``fedtpu_torch.convert.params_from_jax``). When every slot
    already holds the same model (``same_init``, a warm start, ``fedtpu``'s
    own anchors) that model is the global as it is. ``params`` and
    ``anchors`` hold it in separate buffers, in the param dtype; the
    optimizer state is fresh. ``buffer_size >= 2`` adds the empty FedBuff
    buffer (``buf_delta (D,)`` float32, ``buf_count``), ``screen_window >=
    1`` the screen's empty norm ring (``screen_norms (W,)`` float32,
    ``screen_count`` int32), so both persist across steps and
    checkpoints."""
    model = as_model(model)
    if params is None:
        seeds = client_init_seeds(init_seed, num_clients, same_init)
        params = (client_inits(model, seeds[:1]).expand(num_clients, -1)
                  if same_init else client_inits(model, seeds))
    if tuple(params.shape[:1]) != (num_clients,):
        raise ValueError(f"params for {params.shape[0]} clients, expected "
                         f"{num_clients}")
    params = params.to(device)
    # The mean in float32, as fedtpu's of a 16-bit stack accumulates.
    g0 = (params[0] if torch.equal(params, params[:1].expand_as(params))
          else params.to(torch.float32).mean(dim=0))
    anchors = g0.to(model.param_dtype).expand(num_clients, -1).contiguous()
    state = {"params": anchors.clone(), "anchors": anchors,
             "opt_state": tx.init(anchors),
             "pull_tick": torch.zeros(num_clients, dtype=torch.int32,
                                      device=device),
             "round": 0}
    if buffer_size >= 2:
        state["buf_delta"] = torch.zeros(anchors.shape[1],
                                         dtype=torch.float32, device=device)
        state["buf_count"] = torch.zeros((), dtype=torch.float32,
                                         device=device)
    if screen_window >= 1:
        state["screen_norms"] = torch.zeros(screen_window,
                                            dtype=torch.float32,
                                            device=device)
        state["screen_count"] = torch.zeros((), dtype=torch.int32,
                                            device=device)
    return state


# The state's tensors besides params and the optimizer state that a tick
# updates, in the order the capture copies them back.
_ASYNC_STATE = ("anchors", "pull_tick", "buf_delta", "buf_count",
                "screen_norms", "screen_count")


def async_state_tensors(state: dict) -> list:
    """Every tensor of the asynchronous state that a tick updates, in a
    fixed order."""
    opt = state["opt_state"]
    return [state["params"], *(opt[k] for k in sorted(opt)),
            *(state[k] for k in _ASYNC_STATE if k in state)]


def _check_state(state: dict, buffered: bool, screen: bool,
                 screen_window: int) -> None:
    """``fedtpu``'s refusals of a state built for another tick function
    (``fedtpu/parallel/async_fed.py:475-501``)."""
    if buffered and "buf_delta" not in state:
        raise ValueError("buffer_size >= 2 needs a state initialized "
                         "with init_async_state(..., buffer_size=M)")
    if screen and "screen_norms" not in state:
        raise ValueError("screen=True needs a state initialized with "
                         "init_async_state(..., screen_window=W) — "
                         "'screen_norms' missing")
    if not screen and "screen_norms" in state:
        raise ValueError(
            "state carries the defense screen ring (built with "
            "screen_window=W) but this round_fn was built without "
            "screen=True — the rolling median would silently freeze; "
            "build the round_fn with screen=True")
    if screen and tuple(state["screen_norms"].shape) != (screen_window,):
        raise ValueError(
            f"screen ring width {tuple(state['screen_norms'].shape)} does "
            f"not match screen_window={screen_window}")


class AsyncStep:
    """``step(state, batch, arrivals=None) -> (state, metrics)`` running
    ``ticks`` ticks (``build_async_round_fn``); ``metrics`` are
    ``fedtpu``'s (``async_metrics``). ``fn(state, batch, arrivals=None,
    tick=None) -> (state, raw)`` is the step itself, with no host read:
    ``arrivals (R, C)`` and ``tick``, the chunk's first tick as a 0-d int32
    device tensor, are its inputs (drawn and made from the state on the
    host when not given); ``raw`` holds the per-tick ``loss (R, C)``,
    ``conf (R, C, K, K)``, ``staleness (R, C)``, under the screen
    ``screened``, ``update_norms (R, C)`` and ``accepted (R,)``, and
    ``finite``, a device bool that the new state is finite.
    ``draw_arrivals(first, count)`` gives the ``(count, C)`` arrivals of
    ticks ``first..`` on the host (None in driven mode). The capture and
    the host loop take it as they take a ``RoundStep``."""

    def __init__(self, fn: Callable, ticks: int, num_clients: int,
                 draw_arrivals: Optional[Callable], screen: bool):
        self.fn, self.rounds, self.num_clients = fn, ticks, num_clients
        self.draw_arrivals = draw_arrivals
        # The outputs ``pack_outputs`` packs besides loss, counts and the
        # finite flag: per-client, then per-tick.
        self.outputs = ((("staleness", "screened", "update_norms"),
                         ("accepted",)) if screen else (("staleness",), ()))

    def __call__(self, state: dict, batch: dict,
                 arrivals: Optional[torch.Tensor] = None):
        state, raw = self.fn(state, batch, arrivals)
        return state, async_metrics(raw, batch["mask"], self.rounds)

    state_tensors = staticmethod(async_state_tensors)
    pack = RoundStep.pack

    def input_buffers(self, state: dict) -> tuple:
        dev = state["params"].device
        return (torch.zeros((self.rounds, self.num_clients),
                            dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))


def async_metrics(raw: dict, mask: torch.Tensor, ticks: int) -> dict:
    """``fedtpu``'s metrics of a step: ``assemble_metrics`` of the ticks'
    losses and counts, with ``staleness`` and, under the screen,
    ``screened``, ``update_norms`` and ``accepted``; each entry's leading
    tick axis dropped when ``ticks == 1``."""
    metrics = assemble_metrics(raw["loss"], raw["conf"], mask)
    for key in ("staleness", "screened", "update_norms", "accepted"):
        if key in raw:
            metrics[key] = raw[key]
    if ticks == 1:
        metrics = _first(metrics)
    return metrics


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def build_async_round_fn(model, tx: Optimizer, num_classes: int,
                         num_clients: int,
                         arrival_rate: float = 0.5,
                         arrival_seed: int = 0,
                         staleness_power: float = 0.5,
                         server_lr: float = 1.0,
                         local_steps: int = 1,
                         prox_mu: float = 0.0,
                         buffer_size: int = 0,
                         ticks_per_step: int = 1,
                         driven: bool = False,
                         screen: bool = False,
                         screen_norm_mult: float = 4.0,
                         screen_cos_min: float = -0.2,
                         screen_warmup: int = 8,
                         screen_window: int = 64,
                         clip_norm: float = 0.0,
                         arrival_masks: Optional[Callable] = None
                         ) -> AsyncStep:
    """The asynchronous server tick of ``model`` (a ``registry.FlatModel``,
    or the float32 MLP's widths) over ``num_clients`` clients: an
    ``AsyncStep`` of ``ticks_per_step`` ticks, with ``fedtpu``'s knobs,
    semantics and argument checks (its order and messages), and its checks
    of the state (the K-buffer, the screen ring).

    ``staleness_power`` p discounts an arrival ``(1 + s)^-p``;
    ``buffer_size`` M >= 2 applies the buffer's mean once M updates sit in
    it (M = 1 is M = 0, bit for bit); ``driven=True`` takes the caller's
    signed ``(R, C)`` arrival weights; ``screen`` and ``clip_norm`` as
    the module docstring says. ``arrival_masks`` (tick -> ``(C,)``)
    replaces the synthetic draws, e.g. with ``fedtpu``'s."""
    if not 0.0 < arrival_rate <= 1.0:
        raise ValueError(f"arrival_rate must be in (0, 1], got "
                         f"{arrival_rate}")
    if staleness_power < 0:
        raise ValueError(f"staleness_power must be >= 0, got "
                         f"{staleness_power}")
    if server_lr <= 0:
        raise ValueError(f"server_lr must be > 0, got {server_lr}")
    if buffer_size < 0:
        raise ValueError(f"buffer_size must be >= 0, got {buffer_size}")
    if screen and not driven:
        raise ValueError("screen=True needs driven=True — the screen "
                         "scores externally submitted updates; the "
                         "synthetic Bernoulli completion process has "
                         "nothing to screen")
    if screen:
        if screen_window < 1:
            raise ValueError(f"screen_window must be >= 1, got "
                             f"{screen_window}")
        if not 1 <= screen_warmup <= screen_window:
            raise ValueError(f"need 1 <= screen_warmup <= screen_window, "
                             f"got warmup={screen_warmup} "
                             f"window={screen_window}")
        if screen_norm_mult <= 0:
            raise ValueError(f"screen_norm_mult must be > 0, got "
                             f"{screen_norm_mult}")
        if not -1.0 <= screen_cos_min < 1.0:
            raise ValueError(f"screen_cos_min must be in [-1, 1), got "
                             f"{screen_cos_min}")
    if clip_norm < 0:
        raise ValueError(f"clip_norm must be >= 0, got {clip_norm}")
    model = as_model(model)
    slot_dtype = model.param_dtype
    buffered = buffer_size >= 2
    apply_n = float(buffer_size if buffered else 1)
    need_norms = screen or clip_norm > 0
    # The trained params enter the delta as the update's float32 sum p + u
    # where fedtpu's compiled tick keeps it unrounded (a 16-bit param dtype,
    # one local step: make_local_train_step's ``wide``).
    wide = slot_dtype != torch.float32 and local_steps == 1
    local_train = make_local_train_step(model, tx, local_steps, prox_mu,
                                        wide=wide)
    local_eval = make_local_eval_step(model, num_classes)
    lr = _in(slot_dtype, server_lr)

    def draw_arrivals(first_tick: int, count: int) -> torch.Tensor:
        def one(t):
            if arrival_masks is not None:
                return np.asarray(arrival_masks(t), dtype=np.float32)
            return arrival_mask(num_clients, arrival_rate, arrival_seed, t)
        return torch.from_numpy(np.stack([one(first_tick + j)
                                          for j in range(count)]))

    def screen_tick(delta, arrive, arrived, norms, buf, nbuf, ring, rcount):
        """The streaming screen (``fedtpu/parallel/async_fed.py:307-374``):
        the screened flags, the arrivals left, and the ring pushed."""
        finite = torch.isfinite(delta).all(dim=1)
        w_unit = torch.where(arrived & finite,
                             arrive / torch.clamp(norms, min=_EPS),
                             torch.zeros_like(arrive))
        u = buf + weighted_sum_clients(delta, w_unit)
        unorm = torch.sqrt(torch.sum(u * u))
        cosv = arrive * torch.matmul(delta, u) / (norms * unorm + _EPS)
        # The rolling median of the ring's valid slice: padding sorts past
        # every entry as inf, the count picks the middle two on the device.
        cnt = torch.clamp(rcount, max=screen_window).to(torch.int64)
        slots = torch.arange(screen_window, device=ring.device)
        srt = torch.sort(torch.where(slots < cnt, ring,
                                     torch.full_like(ring, float("inf")))
                         ).values
        lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
        hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), min=0)
        med = 0.5 * (_select_rows(lo, srt) + _select_rows(hi, srt))
        warm = rcount >= screen_warmup
        n_tick = arrived.to(torch.float32).sum()
        dir_ok = (nbuf + n_tick) >= 2.0
        screened = arrived & (
            ~finite | (warm & (norms > screen_norm_mult * med))
            | (dir_ok & (unorm > _EPS) & (cosv < screen_cos_min)))
        arrived = arrived & ~screened
        arrive = torch.where(arrived, arrive, torch.zeros_like(arrive))
        # One push a tick: the mean accepted norm, none on a tick with no
        # accepted arrival.
        acc = arrived.to(torch.float32)
        acc_c = acc.sum()
        mean_n = (acc * norms).sum() / torch.clamp(acc_c, min=1.0)
        pos = torch.remainder(rcount, screen_window).to(torch.int64)
        pushed = ring.scatter(0, pos.reshape(1), mean_n.reshape(1))
        ring = torch.where(acc_c > 0, pushed, ring)
        rcount = rcount + (acc_c > 0).to(torch.int32)
        return screened.to(torch.float32), arrive, arrived, ring, rcount

    def fn(state, batch, arrivals=None, tick=None):
        _check_state(state, buffered, screen, screen_window)
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        params, opt_state = state["params"], state["opt_state"]
        anchors, pull = state["anchors"], state["pull_tick"]
        dev = params.device
        if arrivals is None:
            if driven:
                raise ValueError("a driven step takes the (ticks, clients) "
                                 "arrival weights: step(state, batch, "
                                 "arrivals)")
            arrivals = draw_arrivals(state["round"], ticks_per_step)
        arrivals = torch.as_tensor(arrivals, device=dev).to(torch.float32)
        if tuple(arrivals.shape) != (ticks_per_step, num_clients):
            raise ValueError(f"arrivals of shape {tuple(arrivals.shape)}, "
                             f"expected {(ticks_per_step, num_clients)}")
        if tick is None:
            tick = torch.tensor(state["round"], dtype=torch.int32,
                                device=dev)
        if buffered:
            buf, nbuf = state["buf_delta"], state["buf_count"]
        else:
            # M <= 1: an empty buffer each step that every arrival tick
            # applies and empties.
            buf = torch.zeros(params.shape[1], dtype=torch.float32,
                              device=dev)
            nbuf = torch.zeros((), dtype=torch.float32, device=dev)
        ring, rcount = state.get("screen_norms"), state.get("screen_count")
        # The current global: the freshest anchor (the first largest pull
        # tick; slot 0 at init), once per step.
        g = _select_rows(torch.argmax(pull), anchors)
        outs = {k: [] for k in ("loss", "conf", "staleness", "screened",
                                "update_norms", "accepted")}
        for j in range(ticks_per_step):
            r = tick + j
            arrive = arrivals[j]
            arrived = arrive != 0.0
            # Every client trains from its anchor; arrivals adopt below.
            trained, new_opt, loss = local_train(anchors, opt_state, x, y,
                                                 mask)
            delta = trained.to(torch.float32) - anchors.to(torch.float32)
            if need_norms:
                # The submitted update is w * delta.
                norms = torch.abs(arrive) * torch.sqrt(
                    torch.sum(delta * delta, dim=1))
            else:
                norms = torch.zeros_like(arrive)
            scr = torch.zeros_like(arrive)
            if screen:
                scr, arrive, arrived, ring, rcount = screen_tick(
                    delta, arrive, arrived, norms, buf, nbuf, ring, rcount)
            kept = select_participants(
                arrived.to(torch.float32),
                {"params": trained.to(slot_dtype), **new_opt},
                {"params": params, **opt_state})
            params = kept.pop("params")
            opt_state = kept
            stale = (r - pull).to(torch.float32)
            disc = arrive * torch.pow(1.0 + stale, -staleness_power)
            if clip_norm > 0:
                disc = disc * torch.clamp(
                    clip_norm / torch.clamp(norms, min=_EPS), max=1.0)
            n_arrived = arrived.to(torch.float32).sum()
            buf = buf + weighted_sum_clients(delta, disc)
            nbuf = nbuf + n_arrived
            apply = nbuf >= apply_n
            step_g = (buf / torch.clamp(nbuf, min=1.0)).to(g.dtype)
            g = torch.where(apply, g + lr * step_g, g)
            buf = torch.where(apply, torch.zeros_like(buf), buf)
            nbuf = torch.where(apply, torch.zeros_like(nbuf), nbuf)
            # Arrivals re-pull the new global; absentees keep aging.
            anchors = torch.where(arrived[:, None], g[None].to(slot_dtype),
                                  anchors)
            pull = torch.where(arrived, r + 1, pull)
            outs["loss"].append(loss)
            outs["conf"].append(local_eval(params, x, y, mask))
            # Arrivals report the staleness their update had, absentees
            # their current age: the same pre-update r - pull.
            outs["staleness"].append(stale)
            outs["screened"].append(scr)
            outs["update_norms"].append(norms)
            outs["accepted"].append(n_arrived)
        new_state = {"params": params, "opt_state": opt_state,
                     "anchors": anchors, "pull_tick": pull,
                     "round": state["round"] + ticks_per_step}
        if buffered:
            new_state["buf_delta"], new_state["buf_count"] = buf, nbuf
        if screen:
            new_state["screen_norms"] = ring
            new_state["screen_count"] = rcount
        keys = ("loss", "conf", "staleness") + (
            ("screened", "update_norms", "accepted") if screen else ())
        raw = {k: torch.stack(outs[k]) for k in keys}
        raw["finite"] = tensors_finite(async_state_tensors(new_state))
        return new_state, raw

    return AsyncStep(fn, ticks_per_step, num_clients,
                     None if driven else draw_arrivals, screen)


def read_client_slot(state: dict, num_clients: int, slot) -> list:
    """The per-client tensors of slot ``slot`` (an int or a 0-d device
    index: no host read), in ``per_client_view`` order, as copies."""
    idx = torch.as_tensor(slot, device=state["params"].device)
    return [_select_rows(idx.to(torch.int64), t).clone()
            for t in per_client_view(state, num_clients)]


def write_client_slot(state: dict, num_clients: int, slot, values) -> dict:
    """``state`` with slot ``slot``'s per-client tensors set to ``values``
    (``read_client_slot``'s layout, each cast to its tensor's dtype): a new
    state; the input's tensors are not written."""
    leaves = per_client_view(state, num_clients)
    idx = torch.as_tensor(slot, device=state["params"].device).to(
        torch.int64).reshape(1)
    new = [t.index_copy(0, idx, torch.as_tensor(v, device=t.device).to(
        t.dtype).reshape((1,) + tuple(t.shape[1:])))
        for t, v in zip(leaves, values)]
    return with_per_client(state, num_clients, new)


def async_global_params(state: dict) -> torch.Tensor:
    """The freshest global, ``(D,)``: the anchor of the client that pulled
    last, the first of them on a tie (``jnp.argmax``'s rule, and
    ``torch.argmax``'s), with no host read."""
    return _select_rows(torch.argmax(state["pull_tick"]), state["anchors"])
