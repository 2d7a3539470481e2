"""The port's whole slice against fedtpu on the CPU: an income-8-shaped run
(8 clients, 14->50->200->2) from fedtpu's own init must give the same
per-round confusion counts, losses, metrics, early-stop round, held-out
metrics and final params; the sharded (ring, ring-rsag over the 8-device
mesh) and sampled rounds must match fedtpu's round for round, with E local
steps and FedProx too; the fused whole round (K5's plain version) must match
both fedtpu's round and the port's composed one; and the rest of the
synchronous run (a CSV, the pipelined stop, the warm start, checkpoints and
resume, the metrics log, the CLI flags) must do what fedtpu's does; and the
rest of the synchronous round (the server optimizers, SCAFFOLD, central DP
with its privacy ledger, the robust rules under Byzantine clients, the int8
exchange, every knob combination fedtpu refuses) must match fedtpu's
build_round_fn round for round and its run_experiment run for run; the
asynchronous engine must match fedtpu's tick for tick; and the serving
front end (traces, admission, protocol, the ServingEngine, the server
loop, the defense sim) and cohort mode (run_cohort_experiment) must do
what fedtpu's does on the same inputs."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores,
# and torch's default of a thread per core oversubscribes them (its small
# ops then wait on each other's threads).
torch.set_num_threads(1)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fedtpu.config as jcfg  # noqa: E402
from fedtpu.models import build_model  # noqa: E402
from fedtpu.ops import build_optimizer  # noqa: E402
from fedtpu.ops import dp_accountant as j_acc  # noqa: E402
from fedtpu.ops.server_opt import gaussian_noise_tree  # noqa: E402
from fedtpu.orchestration.loop import (build_experiment as j_build,  # noqa: E402
                                       run_experiment as j_run)
from fedtpu.orchestration.privacy import PrivacyLedger as JLedger  # noqa: E402
from fedtpu.data.sharding import pack_clients  # noqa: E402
from fedtpu.data.tabular import synthetic_income_like  # noqa: E402
from fedtpu.parallel import async_fed as j_async  # noqa: E402
from fedtpu.serving import admission as j_adm  # noqa: E402
from fedtpu.serving import protocol as j_proto  # noqa: E402
from fedtpu.serving import traces as j_traces  # noqa: E402
from fedtpu.telemetry.metrics import MetricsRegistry as JRegistry  # noqa: E402
from fedtpu.parallel import client_sharding, make_mesh  # noqa: E402
from fedtpu.parallel.round import (_DP_COUNT_STREAM,  # noqa: E402
                                   _DP_NOISE_STREAM)
from fedtpu.training.client import (make_local_eval_step,  # noqa: E402
                                    make_local_train_step)

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.benchmarks import mega_kernel_attempt as mega  # noqa: E402
from fedtpu_torch.models.mlp import leaf_bounds, mlp_init  # noqa: E402
from fedtpu_torch.models.registry import build_model as t_model  # noqa: E402
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.ops.metrics import (METRIC_NAMES,  # noqa: E402
                                      metrics_from_confusion)
from fedtpu_torch.orchestration import checkpoint as ckpt  # noqa: E402
from fedtpu_torch.orchestration.loop import (_restore_state,  # noqa: E402
                                             build_experiment as t_build,
                                             run_experiment as t_run)
from fedtpu_torch.ops.optim import build_optimizer as t_optimizer  # noqa: E402
from fedtpu_torch.orchestration.privacy import PrivacyLedger as TLedger  # noqa: E402
from fedtpu_torch.parallel import async_fed as t_async  # noqa: E402
from fedtpu_torch.parallel import round as t_round  # noqa: E402
from fedtpu_torch.serving import admission as t_adm  # noqa: E402
from fedtpu_torch.serving import protocol as t_proto  # noqa: E402
from fedtpu_torch.serving import traces as t_traces  # noqa: E402
from fedtpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry as TRegistry)

ROWS = 512
ROUNDS = 80


def _configs(**run_kw):
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=ROWS),
        shard=jcfg.ShardConfig(num_clients=8),
        fed=jcfg.FedConfig(rounds=ROUNDS, termination_patience=10),
        run=jcfg.RunConfig(**run_kw))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=ROWS),
        shard=tcfg.ShardConfig(num_clients=8),
        fed=tcfg.FedConfig(rounds=ROUNDS, termination_patience=10),
        run=tcfg.RunConfig(**run_kw))
    return j, t


def _fedtpu_init(cfg):
    return jax.tree.map(np.asarray, j_build(cfg).state["params"])


def test_income8_slice_matches_fedtpu():
    j_cfg, t_cfg = _configs(eval_test_every=5)
    init = _fedtpu_init(j_cfg)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu", init_params=init)

    assert rj.stopped_early and rt.stopped_early
    assert rt.rounds_run == rj.rounds_run < ROUNDS
    assert len(rt.loss) == len(rj.loss) == rj.rounds_run
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-5)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-6)
        np.testing.assert_allclose(rt.pooled_metrics[name],
                                   rj.pooled_metrics[name], atol=1e-6)
        np.testing.assert_allclose(np.stack(rt.per_client_metrics[name]),
                                   np.stack(rj.per_client_metrics[name]),
                                   atol=1e-6)
        assert len(rt.test_metrics[name]) == len(rj.test_metrics[name]) > 0
        np.testing.assert_array_equal(rt.test_metrics[name],
                                      rj.test_metrics[name])
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_round_steps_match_fedtpu_round_components():
    """Round by round against fedtpu's own train/eval steps (vmapped, as
    its round body runs them) and its weighted average: equal confusion
    counts of the trained, not yet averaged models, and params after the
    average within 1e-4."""
    j_cfg, t_cfg = _configs()
    j_exp = j_build(j_cfg)
    _, apply_fn = build_model(jcfg.ModelConfig())
    train = jax.jit(jax.vmap(make_local_train_step(
        apply_fn, build_optimizer(jcfg.OptimConfig()))))
    evaluate = jax.jit(jax.vmap(make_local_eval_step(apply_fn, 2)))

    @jax.jit
    def average(p, mask):
        w = mask.sum(axis=1)
        return jax.tree.map(
            lambda l: jnp.broadcast_to(
                jnp.tensordot(w, l, axes=1) / jnp.maximum(w.sum(), 1.0),
                l.shape), p)

    xb, yb, mb = (j_exp.batch[k] for k in ("x", "y", "mask"))
    jp, js = j_exp.state["params"], j_exp.state["opt_state"]
    t_exp = t_build(t_cfg, device="cpu",
                    init_params=jax.tree.map(np.asarray, jp))
    step = t_exp.make_step(1)
    state = t_exp.state
    for _ in range(20):
        jp, js, jloss = train(jp, js, xb, yb, mb)
        jconf = evaluate(jp, xb, yb, mb)
        jp = average(jp, mb)
        state, raw = step(state, t_exp.batch)
        np.testing.assert_array_equal(raw["conf"][0].numpy(),
                                      np.asarray(jconf))
        np.testing.assert_allclose(raw["loss"][0].numpy(), np.asarray(jloss),
                                   atol=1e-5)
        np.testing.assert_allclose(
            state["params"].numpy(),
            convert.params_from_jax(jax.tree.map(np.asarray, jp)).numpy(),
            atol=1e-4)
    assert state["round"] == 20
    assert bool((state["opt_state"]["count"] == 20).all())


def test_rounds_per_step_chunks_keep_the_history():
    _, t_cfg = _configs()
    r1 = t_run(t_cfg, verbose=False, device="cpu")
    r4 = t_run(t_cfg.replace(run=tcfg.RunConfig(rounds_per_step=4)),
               verbose=False, device="cpu")
    assert r4.rounds_run == r1.rounds_run and r4.stopped_early
    np.testing.assert_array_equal(np.stack(r4.loss), np.stack(r1.loss))
    np.testing.assert_array_equal(np.stack(r4.confusion),
                                  np.stack(r1.confusion))


def test_divergence_halts_at_the_same_round_as_fedtpu():
    """A runaway learning rate: both loops halt on the non-finite guard at
    the same round."""
    j_cfg, t_cfg = _configs()
    j_cfg = j_cfg.replace(optim=jcfg.OptimConfig(name="sgd",
                                                 learning_rate=1e30))
    t_cfg = t_cfg.replace(optim=tcfg.OptimConfig(name="sgd",
                                                 learning_rate=1e30))
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    assert rj.diverged and rt.diverged and rt.stopped_early
    assert rt.rounds_run == rj.rounds_run < ROUNDS


def test_cli_run_on_cpu_prints_a_json_summary(capsys):
    from fedtpu_torch.cli import main
    rc = main(["run", "--preset", "income-2", "--platform", "cpu",
               "--rounds", "3", "--synthetic-rows", "256", "--json",
               "--quiet", "--eval-test-every", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    summary = json.loads(out[-1])
    assert summary["rounds_run"] == 3 and not summary["diverged"]


def test_cli_flags_are_fedtpu_cli_flags():
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser

    def flags(parser):
        out = set()
        for act in parser._actions:
            out.update(act.option_strings)
            if isinstance(act, argparse._SubParsersAction):
                for sub in act.choices.values():
                    out |= flags(sub)
        return out

    assert flags(t_parser()) - flags(j_parser()) == set()


def _model_configs(classes=2, hidden=(50, 200), clients=4, rows=512,
                   rounds=ROUNDS):
    """fedtpu's and the port's configs of one synthetic run."""
    def cfg(mod, data):
        return mod.ExperimentConfig(
            data=data, shard=mod.ShardConfig(num_clients=clients),
            model=mod.ModelConfig(hidden_sizes=hidden),
            fed=mod.FedConfig(rounds=rounds, termination_patience=10),
            run=mod.RunConfig(eval_test_every=5))
    return (cfg(jcfg, jcfg.DataConfig(csv_path=None, synthetic_rows=rows,
                                      synthetic_classes=classes)),
            cfg(tcfg, tcfg.DataConfig(synthetic_rows=rows,
                                      synthetic_classes=classes)))


@pytest.mark.parametrize("classes,hidden", [(10, (50, 200)),
                                            (2, (256, 256)),
                                            (2, (4,) * 16)],
                         ids=["10-classes", "hidden-256x256", "17-layers"])
def test_any_class_count_width_and_depth_match_fedtpu(classes, hidden):
    """Ten classes (refused before: K2's wrapper took at most 8), a
    (256, 256) MLP (its parameters do not fit in one block: K2 and K3
    stream them on the card) and 17 layers 4 wide (refused before: at
    most 16 layers, on the CPU too), against fedtpu with injected init:
    round for round against its build_round_fn (losses within 1e-5,
    confusion counts of the trained models equal but on near-tie rows),
    then the whole run, as test_income32_noniid_ring_run_matches_fedtpu
    holds its (the same stop round, losses and held-out metrics within
    1e-4: over 40 rounds of 10 classes the two frameworks' sums drift to
    ~5e-5)."""
    from fedtpu_torch.models.mlp import mlp_apply, unflatten
    from fedtpu_torch.ops.metrics import near_tie_rows
    j_cfg, t_cfg = _model_configs(classes=classes, hidden=hidden)
    j_exp = j_build(j_cfg)
    _, apply_fn = build_model(j_cfg.model)
    train = jax.jit(jax.vmap(make_local_train_step(
        apply_fn, build_optimizer(j_cfg.optim))))
    evaluate = jax.jit(jax.vmap(make_local_eval_step(apply_fn,
                                                     j_exp.num_classes)))
    xb, yb, mb = (j_exp.batch[k] for k in ("x", "y", "mask"))
    j_state, j_step = j_exp.state, j_exp.make_step(1)
    init = _np(j_state["params"])
    t_exp = t_build(t_cfg, device="cpu", init_params=init)
    assert t_exp.dims[-1] == classes and len(t_exp.dims) == len(hidden) + 2
    t_state, t_step = t_exp.state, t_exp.make_step(1)
    for _ in range(10):
        trained, _, jloss = train(_np(j_state["params"]),
                                  _np(j_state["opt_state"]), xb, yb, mb)
        j_conf = np.asarray(evaluate(trained, xb, yb, mb))
        j_state, _ = j_step(j_state, j_exp.batch)
        t_state, raw = t_step(t_state, t_exp.batch)
        logits = mlp_apply(unflatten(convert.params_from_jax(_np(trained)),
                                     t_exp.dims), t_exp.batch["x"])
        ties = (near_tie_rows(logits) & (t_exp.batch["mask"] > 0)).sum(dim=1)
        moved = np.abs(raw["conf"][0].numpy() - j_conf).sum(axis=(1, 2)) / 2
        assert np.all(moved <= ties.numpy()), (moved, ties)
        np.testing.assert_allclose(raw["loss"][0].numpy(), np.asarray(jloss),
                                   atol=1e-5)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu", init_params=init)
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in METRIC_NAMES:
        assert len(rt.test_metrics[name]) == len(rj.test_metrics[name]) > 0
        np.testing.assert_allclose(rt.test_metrics[name],
                                   rj.test_metrics[name], atol=1e-4)


# ----------------------------------------- sharded and sampled averaging
def _sharded_configs(aggregation, rate=1.0, rounds=3, rows=512,
                     clients=16, hidden=(16, 8), **local):
    """16 clients over fedtpu's 8-device CPU mesh: 2 clients per shard;
    ``local``: local_steps / prox_mu."""
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=rows),
        shard=jcfg.ShardConfig(num_clients=clients),
        model=jcfg.ModelConfig(hidden_sizes=hidden),
        fed=jcfg.FedConfig(rounds=rounds, aggregation=aggregation,
                           participation_rate=rate, participation_seed=5,
                           **local),
        run=jcfg.RunConfig(mesh_devices=8))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=rows),
        shard=tcfg.ShardConfig(num_clients=clients),
        model=tcfg.ModelConfig(hidden_sizes=hidden),
        fed=tcfg.FedConfig(rounds=rounds, aggregation=aggregation,
                           participation_rate=rate, participation_seed=5,
                           **local),
        run=tcfg.RunConfig(mesh_devices=8))
    return j, t


def _fedtpu_masks(cfg):
    """fedtpu's participation draws, recomputed as round.py:533-538 makes
    them: uniform(fold_in(fold_in(key(seed), round), client)) < rate."""
    return _mask_draws(cfg.fed.participation_seed,
                       cfg.fed.participation_rate, cfg.shard.num_clients)


@functools.lru_cache(maxsize=None)
def _mask_draws(seed, rate, num_clients):
    """One jitted draw per (seed, rate, client count): a worker compiles
    each once."""
    clients = jnp.arange(num_clients)

    @jax.jit
    def draw(r):
        round_key = jax.random.fold_in(jax.random.key(seed), r)
        u = jax.vmap(lambda i: jax.random.uniform(
            jax.random.fold_in(round_key, i)))(clients)
        return (u < rate).astype(jnp.float32)

    return lambda r: np.asarray(draw(r))


def _adam_leaves(opt_state):
    adam = opt_state[0]
    return (convert.params_from_jax(_np(adam.mu)),
            convert.params_from_jax(_np(adam.nu)), np.asarray(adam.count))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> np.ndarray:
    """A fedtpu params-shaped pytree in the port's flat layout (numpy),
    leaves mapped by name."""
    return convert.params_from_jax(_np(tree)).numpy()


@functools.lru_cache(maxsize=None)
def _fedtpu_local_steps(local_steps, prox_mu, scaffold):
    """fedtpu's jitted train and eval steps of ``_sharded_configs``' model,
    vmapped over clients; one pair per knob set, so a worker compiles each
    once."""
    _, apply_fn = build_model(jcfg.ModelConfig(hidden_sizes=(16, 8)))
    train = jax.jit(jax.vmap(make_local_train_step(
        apply_fn, build_optimizer(jcfg.OptimConfig()),
        local_steps=local_steps, prox_mu=prox_mu, scaffold=scaffold)))
    return train, jax.jit(jax.vmap(make_local_eval_step(apply_fn, 2)))


def _step_both(j_cfg, t_cfg, rounds, masks=None, j_losses=None,
               j_trained=None, j_exp=None, **t_kw):
    """Step fedtpu's and the port's round side by side; yields per round
    (fedtpu state, port state, port raw, fedtpu's pre-average confusion
    recomputed from its own train/eval steps, with SCAFFOLD's correction
    under ``scaffold``). ``j_losses`` / ``j_trained``: lists that take
    fedtpu's per-round losses / trained (pre-average) params. ``j_exp``:
    fedtpu's experiment, built from ``j_cfg`` when not given. ``t_kw``: more
    arguments of the port's ``build_experiment`` (``dp_noise``)."""
    j_exp = j_build(j_cfg) if j_exp is None else j_exp
    scaffold = j_cfg.fed.scaffold
    train, evaluate = _fedtpu_local_steps(j_cfg.fed.local_steps,
                                          j_cfg.fed.prox_mu, scaffold)
    xb, yb, mb = (j_exp.batch[k] for k in ("x", "y", "mask"))
    j_state, j_step = j_exp.state, j_exp.make_step(1)
    t_exp = t_build(t_cfg, device="cpu", init_params=_np(j_state["params"]),
                    participation_masks=masks, **t_kw)
    assert (t_exp.mesh.num_shards, t_exp.mesh.clients_per_shard) == (8, 2)
    t_state, t_step = t_exp.state, t_exp.make_step(1)
    for r in range(rounds):
        prev_p, prev_s = _np(j_state["params"]), _np(j_state["opt_state"])
        corr = (jax.tree.map(lambda c, ci: c[None] - ci,
                             _np(j_state["server_cv"]),
                             _np(j_state["client_cv"])),) if scaffold else ()
        j_state, _ = j_step(j_state, j_exp.batch)
        t_state, raw = t_step(t_state, t_exp.batch)
        trained, _, j_loss = train(prev_p, prev_s, xb, yb, mb, *corr)
        if j_losses is not None:
            j_losses.append(np.asarray(j_loss))
        if masks is not None:
            keep = masks(r) > 0
            trained = jax.tree.map(
                lambda a, b: np.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)),
                                      a, b), _np(trained), prev_p)
        if j_trained is not None:
            j_trained.append(_np(trained))
        yield j_state, t_state, raw, np.asarray(evaluate(trained, xb, yb, mb))


def _assert_round_matches(j_state, t_state, raw, j_conf):
    np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
    np.testing.assert_allclose(
        t_state["params"].numpy(),
        convert.params_from_jax(_np(j_state["params"])).numpy(),
        rtol=1e-5, atol=1e-6)
    mu, nu, count = _adam_leaves(j_state["opt_state"])
    np.testing.assert_allclose(t_state["opt_state"]["mu"].numpy(), mu.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_state["opt_state"]["nu"].numpy(), nu.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t_state["opt_state"]["count"].numpy(), count)


@pytest.mark.parametrize("aggregation", ["ring", "ring-rsag"])
def test_sharded_ring_rounds_match_fedtpu(aggregation):
    """Ring aggregation over 8 shards: 3 rounds at the tolerance of
    tests/test_ring.py:97-100 (rtol 1e-5, atol 1e-6) on params and Adam
    moments, equal counts and confusion counts."""
    j_cfg, t_cfg = _sharded_configs(aggregation)
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3):
        _assert_round_matches(j_state, t_state, raw, j_conf)


@pytest.mark.parametrize("aggregation", ["psum", "ring"])
def test_sampled_rounds_match_fedtpu_with_its_masks(aggregation):
    """participation_rate=0.5 with fedtpu's own draws injected: the
    absentees keep params and Adam state, the counts drift apart per
    client, and the average is over the round's participants only."""
    j_cfg, t_cfg = _sharded_configs(aggregation, rate=0.5)
    masks = _fedtpu_masks(j_cfg)
    assert 0 < masks(0).sum() < 16
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3, masks):
        _assert_round_matches(j_state, t_state, raw, j_conf)
    assert len(set(t_state["opt_state"]["count"].tolist())) > 1


@pytest.mark.parametrize("aggregation", ["psum", "ring", "ring-rsag"])
def test_round_with_no_participants_carries_everything_over(aggregation):
    """A rate so small that fedtpu's draws leave every client out: params
    and optimizer state carry over unchanged on both sides (round.py:873),
    decided on the device, and the confusion counts are still the eval of
    the unchanged models."""
    j_cfg, t_cfg = _sharded_configs(aggregation, rate=1e-9, rounds=2)
    masks = _fedtpu_masks(j_cfg)
    assert masks(0).sum() == masks(1).sum() == 0
    j_init = _np(j_build(j_cfg).state["params"])
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 2, masks):
        _assert_round_matches(j_state, t_state, raw, j_conf)
        start = convert.params_from_jax(j_init)
        assert torch.equal(t_state["params"], start)
        assert not t_state["opt_state"]["mu"].any()
        assert not t_state["opt_state"]["count"].any()


@pytest.mark.parametrize("sampled", [False, True], ids=["all", "sampled"])
@pytest.mark.parametrize("aggregation", ["psum", "ring"])
@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
@pytest.mark.parametrize("local_steps", [1, 3])
def test_local_steps_and_fedprox_rounds_match_fedtpu(local_steps, prox_mu,
                                                     aggregation, sampled):
    """E local steps with FedProx's term, against fedtpu's build_round_fn
    (its masks injected under sampling): params within 1e-5, Adam counts
    and confusion counts equal, losses (the last step's plain CE) within
    1e-4; each count grows by E a round a participant; an absentee keeps
    its moments and count bit for bit through all E steps (as in
    tests/test_local_steps.py)."""
    j_cfg, t_cfg = _sharded_configs(aggregation, rate=0.5 if sampled else 1.0,
                                    rounds=2, local_steps=local_steps,
                                    prox_mu=prox_mu)
    masks = _fedtpu_masks(j_cfg) if sampled else None
    j_losses = []
    prev = None
    for r, (j_state, t_state, raw, j_conf) in enumerate(
            _step_both(j_cfg, t_cfg, 2, masks, j_losses)):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        np.testing.assert_allclose(
            t_state["params"].numpy(),
            convert.params_from_jax(_np(j_state["params"])).numpy(),
            atol=1e-5)
        mu, nu, count = _adam_leaves(j_state["opt_state"])
        np.testing.assert_allclose(t_state["opt_state"]["mu"].numpy(),
                                   mu.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t_state["opt_state"]["nu"].numpy(),
                                   nu.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t_state["opt_state"]["count"].numpy(),
                                      count)
        np.testing.assert_allclose(raw["loss"][0].numpy(), j_losses[-1],
                                   atol=1e-4)
        part = (masks(r) > 0) if sampled else np.ones(16, bool)
        before = (prev["opt_state"] if prev is not None else
                  {"count": torch.zeros(16, dtype=torch.int32)})
        grew = (t_state["opt_state"]["count"] - before["count"]).numpy()
        np.testing.assert_array_equal(grew, np.where(part, local_steps, 0))
        if prev is not None and not part.all():
            keep = torch.from_numpy(~part)
            for k in ("mu", "nu", "count"):
                assert torch.equal(t_state["opt_state"][k][keep],
                                   prev["opt_state"][k][keep])
        prev = t_state


@pytest.mark.parametrize("rate", [1.0, 0.5, 1e-9])
def test_psum_average_is_one_broadcast_k1_call_per_round(monkeypatch, rate):
    """The psum path averages with one call of K1 in broadcast mode a
    round, which also decides the carry-over (rate 1e-9: no participant in
    any round), and the rounds still match fedtpu's, masks injected."""
    import fedtpu_torch.parallel.round as t_round
    calls = []
    real = t_round.weighted_average_clients

    def spy(stacked, weights, broadcast=False):
        calls.append(broadcast)
        return real(stacked, weights, broadcast)

    monkeypatch.setattr(t_round, "weighted_average_clients", spy)
    j_cfg, t_cfg = _sharded_configs("psum", rate=rate)
    masks = _fedtpu_masks(j_cfg) if rate < 1.0 else None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3, masks):
        _assert_round_matches(j_state, t_state, raw, j_conf)
    assert calls == [True] * 3


def test_income32_noniid_ring_run_matches_fedtpu():
    """The whole loop on a small income-32-noniid (2,048 synthetic rows,
    Dirichlet(0.5) shards) with ring aggregation over 8 shards: the same
    stop round as fedtpu and histories within 1e-4."""
    def cfgs(mod):
        p = mod.get_preset("income-32-noniid")
        return p.replace(
            data=(mod.DataConfig(csv_path=None, synthetic_rows=2048)
                  if mod is jcfg else mod.DataConfig(synthetic_rows=2048)),
            fed=dataclasses.replace(p.fed, rounds=80, aggregation="ring"),
            run=mod.RunConfig(mesh_devices=8, eval_test_every=5))
    j_cfg, t_cfg = cfgs(jcfg), cfgs(tcfg)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    assert rj.stopped_early and rt.stopped_early
    assert rt.rounds_run == rj.rounds_run < 80
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in METRIC_NAMES:
        for hist in ("global_metrics", "pooled_metrics", "test_metrics"):
            np.testing.assert_allclose(getattr(rt, hist)[name],
                                       getattr(rj, hist)[name], atol=1e-4)


# ------------------------------------------- the fused whole round (K5)
def test_fused_round_20_rounds_match_fedtpu_and_the_composed_round():
    """20 rounds of K5's plain version (the benchmark's fused step) from
    fedtpu's init against fedtpu's build_round_fn with rounds_per_step=20,
    the script's own oracle (benchmarks/mega_kernel_attempt.py:188, :251),
    and against the port's composed round: losses within 1e-5 every round,
    confusion counts equal (fedtpu's per-client metrics, which derive from
    them, within 1e-6), final params within 1e-4, Adam counts 20."""
    j_cfg, t_cfg = _configs()
    j_exp = j_build(j_cfg)
    init = _np(j_exp.state["params"])
    j_state, j_metrics = j_exp.make_step(20)(j_exp.state, j_exp.batch)
    t_exp = t_build(t_cfg, device="cpu", init_params=init)
    fused, composed = mega.make_fused_step(t_exp, t_cfg.optim), \
        t_exp.make_step(1)
    f_state = c_state = t_exp.state
    losses, confs = [], []
    for _ in range(20):
        f_state, loss, conf = fused(f_state)
        c_state, raw = composed(c_state, t_exp.batch)
        np.testing.assert_allclose(loss.numpy(), raw["loss"][0].numpy(),
                                   atol=1e-5)
        np.testing.assert_array_equal(conf.numpy(), raw["conf"][0].numpy())
        losses.append(loss.numpy())
        confs.append(conf)
    np.testing.assert_allclose(np.stack(losses), np.asarray(j_metrics["loss"]),
                               atol=1e-5)
    per_client = metrics_from_confusion(torch.stack(confs))
    for name in METRIC_NAMES:
        np.testing.assert_allclose(per_client[name].numpy(),
                                   np.asarray(j_metrics["per_client"][name]),
                                   atol=1e-6)
    np.testing.assert_allclose(f_state["params"].numpy(),
                               c_state["params"].numpy(), atol=1e-4)
    np.testing.assert_allclose(
        f_state["params"].numpy(),
        convert.params_from_jax(_np(j_state["params"])).numpy(), atol=1e-4)
    assert f_state["round"] == 20
    assert torch.equal(f_state["opt_state"]["count"],
                       torch.full((8,), 20, dtype=torch.int32))


def test_fused_round_benchmark_on_cpu_refuses_what_k5_does_not_compute(
        capsys):
    """The benchmark on the CPU (plain versions, no timing: a CPU time is not a
    device time) returns its comparisons; its CLI prints them as one JSON
    line; each config K5 does not compute raises, naming the field."""
    _, t_cfg = _configs()
    out = mega.run(t_cfg, device="cpu", rounds=5)
    assert (out["device"], out["rounds"], out["timing"]) == ("cpu", 5, None)
    one = out["one_round"]
    assert one["count_equal"] and one["loss_max_abs"] <= 1e-5
    assert one["params"]["max_abs"] <= 1e-4
    assert one["conf_rows_differing"] == [0.0] * 8
    assert out["trajectory"]["accuracy_diff"] < 0.01
    # On the CPU the wrappers take their plain versions: no launch counted.
    assert not any(out["launches"]["fused"].values())
    assert mega.main(["--platform", "cpu", "--rounds", "2",
                      "--synthetic-rows", "256"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["rounds"] == 2 and printed["clients"] == 8
    fed, data = t_cfg.fed, t_cfg.data
    for bad, field in (
            (dict(fed=dataclasses.replace(fed, participation_rate=0.5)),
             "participation_rate"),
            (dict(fed=dataclasses.replace(fed, aggregation="ring")),
             "aggregation"),
            (dict(optim=tcfg.OptimConfig(name="sgd")), "optim.name"),
            (dict(data=dataclasses.replace(data, synthetic_classes=9)),
             "num_classes"),
            (dict(model=tcfg.ModelConfig(hidden_sizes=(60000,))),
             "hidden_sizes")):
        with pytest.raises(ValueError, match=field):
            mega.run(t_cfg.replace(**bad), device="cpu", rounds=1)


@pytest.mark.parametrize("fault", ["nu zero", "nu unchanged", "nu b2 0.99",
                                   "mu unchanged", "mu x1.001",
                                   "params 3 lr", "params 0.2 % off"])
def test_fused_round_state_limits_catch_a_wrong_state(fault):
    """The limits the benchmark and chip_smoke hold K5 to (state_faults) pass
    the plain round against itself and a rounding-sized change, and catch a
    kernel that writes a wrong moment or param: nu zero, unchanged or
    decayed at the wrong rate; mu unchanged or scaled by 1.001; one param
    3 * lr off; 0.2 % of the params 2e-4 off."""
    dims, c, n = (6, 8, 5, 3), 3, 40
    gen = torch.Generator().manual_seed(7)
    params = torch.stack([mlp_init(gen, dims[0], dims[1:-1], dims[-1])
                          for _ in range(c)])
    mu = torch.randn(params.shape, generator=gen) * 1e-3
    nu = torch.rand(params.shape, generator=gen) * 1e-6
    count = torch.tensor([0, 29, 61], dtype=torch.int32)
    x = torch.randn(c, n, dims[0], generator=gen)
    y = torch.randint(0, dims[-1], (c, n), generator=gen, dtype=torch.int32)
    mask = torch.ones(c, n)
    optim = tcfg.OptimConfig()
    lr = optim.learning_rate
    out = ck.fused_round(params, mu, nu, count, x, y, mask, mask.sum(dim=1),
                         dims, optim)
    ref = dict(zip(("params", "mu", "nu"), out[:3]))
    assert mega.state_faults(mega.state_errors(ref, ref), lr) == []
    near = {k: v * (1 + 1e-7) for k, v in ref.items()}
    assert mega.state_faults(mega.state_errors(near, ref), lr) == []
    bad = dict(ref)
    if fault == "nu zero":
        bad["nu"] = torch.zeros_like(nu)
    elif fault == "nu unchanged":
        bad["nu"] = nu
    elif fault == "nu b2 0.99":
        bad["nu"] = ref["nu"] - (optim.b2 - 0.99) * nu
    elif fault == "mu unchanged":
        bad["mu"] = mu
    elif fault == "mu x1.001":
        bad["mu"] = ref["mu"] * 1.001
    elif fault == "params 3 lr":
        bad["params"] = ref["params"].clone()
        bad["params"][1, 5] += 3 * lr
    else:
        bad["params"] = ref["params"].clone()
        off = max(2, int(0.002 * bad["params"].numel()) + 1)
        bad["params"].view(-1)[:off] += 2e-4
    assert mega.state_faults(mega.state_errors(bad, ref), lr) != []


# -------------------------------------------- K5 refuses local training
@pytest.mark.parametrize("field,kw", [
    ("local_steps", dict(local_steps=2)), ("prox_mu", dict(prox_mu=0.01))])
def test_fused_round_refuses_local_steps_and_fedprox(field, kw):
    """K5 computes one plain Adam step a round: its wrapper and its
    benchmark (``mega_kernel_attempt.run``) refuse more local steps and
    FedProx, naming the field, on the CPU as on the card."""
    _, t_cfg = _configs()
    exp = t_build(t_cfg.replace(data=tcfg.DataConfig(synthetic_rows=128)),
                  device="cpu")
    opt = exp.state["opt_state"]
    args = (exp.state["params"], opt["mu"], opt["nu"], opt["count"],
            exp.batch["x"], exp.batch["y"], exp.batch["mask"],
            exp.client_weights, exp.dims, t_cfg.optim)
    with pytest.raises(ValueError, match=f"fed.{field}="):
        ck.fused_round(*args, **kw)
    with pytest.raises(ValueError, match=f"fed.{field}="):
        mega.run(t_cfg.replace(fed=dataclasses.replace(t_cfg.fed, **kw)),
                 device="cpu", rounds=1)
    ck.fused_round(*args)      # the defaults are what K5 computes


@pytest.mark.parametrize("field,value", [
    ("server_opt", "fedadam"), ("dp_clip_norm", 1.0),
    ("dp_noise_multiplier", 1.0), ("dp_adaptive_clip", True),
    ("robust_aggregation", "median"), ("byzantine_clients", 2),
    ("scaffold", True), ("compress", "int8")])
def test_fused_round_refuses_the_other_aggregation_branches(field, value):
    """K5 computes plain FedAvg: its benchmark refuses a server optimizer,
    DP, a robust rule, Byzantine injection, SCAFFOLD and the int8
    exchange, naming the field, before it builds anything."""
    _, t_cfg = _configs()
    cfg = t_cfg.replace(fed=dataclasses.replace(t_cfg.fed, **{field: value}))
    with pytest.raises(ValueError, match=f"fed.{field}="):
        mega.run(cfg, device="cpu", rounds=1)


# ------------------------------------------------------ the CSV, end to end
def _write_learnable_csv(path, rows=600, seed=11):
    """A CSV with numeric and string columns (leading spaces kept) and a
    string label that follows a noisy score of them."""
    rng = np.random.default_rng(seed)
    jobs = np.array([" Sales", " Tech-support", " Craft-repair"])
    job = rng.integers(0, 3, rows)
    hours = rng.normal(40, 10, rows)
    edu = rng.integers(1, 17, rows)
    score = 0.3 * (edu - 9) + 0.05 * (hours - 40) + 0.8 * (job == 1) \
        + rng.normal(0, 0.3, rows)
    cut = np.median(score)
    with open(path, "w") as f:
        f.write("hours,job,edu,income\n")
        for i in range(rows):
            f.write(f" {hours[i]:.3f},{jobs[job[i]]},{edu[i]},"
                    f"{' >50K' if score[i] > cut else ' <=50K'}\n")
    return str(path)


def test_csv_run_matches_fedtpu(tmp_path):
    """A whole run from a CSV (fedtpu's init injected): the same stop round
    as fedtpu's run of the same CSV, losses within 1e-4, confusion-derived
    metrics within 1e-6."""
    path = _write_learnable_csv(tmp_path / "income.csv")
    j_cfg, t_cfg = _configs()
    j_cfg = j_cfg.replace(data=jcfg.DataConfig(csv_path=path))
    t_cfg = t_cfg.replace(data=tcfg.DataConfig(csv_path=path))
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-6)


# ------------------------------------------------------- pipelined stop
@pytest.mark.parametrize("rounds_per_step", [1, 4])
def test_pipelined_stop_history_equals_the_synchronous_run(rounds_per_step):
    """pipelined_stop dispatches chunk k+1 before reading chunk k: its
    history is the synchronous run's bit for bit, it stops at fedtpu's
    pipelined round, and its state carries the overshoot chunk (the
    state's round counter, as fedtpu's rounds_trained)."""
    j_cfg, t_cfg = _configs()
    init = _fedtpu_init(j_cfg)
    piped_run = dict(pipelined_stop=True, rounds_per_step=rounds_per_step)
    sync = t_run(t_cfg.replace(run=tcfg.RunConfig(
        rounds_per_step=rounds_per_step)), verbose=False, device="cpu",
        init_params=init)
    piped = t_run(t_cfg.replace(run=tcfg.RunConfig(**piped_run)),
                  verbose=False, device="cpu", init_params=init)
    rj = j_run(j_cfg.replace(run=jcfg.RunConfig(**piped_run)), verbose=False)
    assert piped.stopped_early and sync.stopped_early
    assert piped.rounds_run == sync.rounds_run == rj.rounds_run
    assert piped.global_metrics == sync.global_metrics
    assert piped.pooled_metrics == sync.pooled_metrics
    np.testing.assert_array_equal(np.stack(piped.loss), np.stack(sync.loss))
    np.testing.assert_array_equal(np.stack(piped.confusion),
                                  np.stack(sync.confusion))
    assert piped.rounds_trained == rj.rounds_trained
    assert sync.rounds_trained == sync.rounds_run + (
        -sync.rounds_run % rounds_per_step)
    assert piped.rounds_trained > sync.rounds_trained
    for a, b in zip(jax.tree.leaves(piped.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("pipelined", [False, True])
def test_plateau_stops_at_the_reference_round(pipelined, capsys):
    """tests/test_stop_lag.py's plateau (lr 0, one shared init): detection
    at round 4 with patience 3, both of the reference's messages, and
    with pipelined_stop the same history."""
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=256),
        shard=tcfg.ShardConfig(num_clients=8),
        optim=tcfg.OptimConfig(learning_rate=0.0),
        fed=tcfg.FedConfig(rounds=20, termination_patience=3,
                           same_init=True),
        run=tcfg.RunConfig(pipelined_stop=pipelined))
    res = t_run(cfg, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert res.stopped_early and res.rounds_run == 4
    assert all(len(v) == 4 for v in res.global_metrics.values())
    assert "Early stopping triggered" in out
    assert "Training stopped early at round 4." in out
    assert res.rounds_trained == (5 if pipelined else 4)


# ------------------------------------------------ warm start from an .npz
def _best(final_params):
    return {"weights": final_params,
            "params": {"hidden_layer_sizes": [50, 200],
                       "learning_rate": 0.004},
            "metrics": {"accuracy": 0.9, "f1": 0.9}, "accuracy": 0.9}


def test_warm_start_reads_fedtpus_artifact_and_fedtpu_reads_the_ports(
        tmp_path):
    """init_weights_npz: the port warm-starts from an artifact that
    fedtpu.sweep.grid.save_best_weights wrote, every slot bitwise fedtpu's
    own warm start, and the first rounds match fedtpu's run from it;
    fedtpu reads the port's artifact back bit for bit."""
    from fedtpu.sweep.grid import load_best_weights as j_read
    from fedtpu.sweep.grid import save_best_weights as j_write
    from fedtpu_torch.sweep.grid import load_best_weights as t_read
    from fedtpu_torch.sweep.grid import save_best_weights as t_write
    j_cfg, t_cfg = _configs()
    trained = _np(j_run(j_cfg.replace(fed=jcfg.FedConfig(rounds=3)),
                        verbose=False).final_params)
    path = str(tmp_path / "best.npz")
    j_write(path, _best(trained))
    j_cfg = j_cfg.replace(fed=dataclasses.replace(
        j_cfg.fed, rounds=5, init_weights_npz=path))
    t_cfg = t_cfg.replace(fed=dataclasses.replace(
        t_cfg.fed, rounds=5, init_weights_npz=path))
    t_exp = t_build(t_cfg, device="cpu")
    want = convert.params_from_jax(trained).expand(8, -1)
    assert torch.equal(t_exp.state["params"], want)
    assert torch.equal(
        t_exp.state["params"],
        convert.params_from_jax(_np(j_build(j_cfg).state["params"])))
    rj, rt = j_run(j_cfg, verbose=False), t_run(t_cfg, verbose=False,
                                                device="cpu")
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-5)
    back = str(tmp_path / "port.npz")
    t_write(back, _best(rt.final_params))
    for a, b in ((j_read(back), t_read(back)), (t_read(path), j_read(path))):
        assert {k: v for k, v in a.items() if k != "weights"} == \
            {k: v for k, v in b.items() if k != "weights"}
        for x, y in zip(jax.tree.leaves(a["weights"]),
                        jax.tree.leaves(b["weights"])):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(j_read(back)["weights"]),
                    jax.tree.leaves(rt.final_params)):
        np.testing.assert_array_equal(x, y)


def test_warm_start_architecture_mismatch_is_fedtpus_error(tmp_path):
    """An artifact of another architecture: both packages raise the same
    ValueError, word for word."""
    from fedtpu.sweep.grid import save_best_weights as j_write
    gen = torch.Generator().manual_seed(0)
    other = convert.params_to_numpy(mlp_init(gen, 14, (16,), 2), (14, 16, 2))
    path = str(tmp_path / "small.npz")
    j_write(path, _best(other))
    j_cfg, t_cfg = _configs()
    with pytest.raises(ValueError) as j_err:
        j_build(j_cfg.replace(fed=dataclasses.replace(
            j_cfg.fed, init_weights_npz=path)))
    with pytest.raises(ValueError) as t_err:
        t_build(t_cfg.replace(fed=dataclasses.replace(
            t_cfg.fed, init_weights_npz=path)), device="cpu")
    assert str(t_err.value) == str(j_err.value)
    assert "architecture mismatch" in str(t_err.value)


# ----------------------------------------- checkpoint and resume (A5)
from fedtpu_torch.orchestration.checkpoint import (  # noqa: E402
    complete_steps, latest_step, load_checkpoint_raw, retain_checkpoints,
    save_checkpoint)


def _ck_config(tmp, rounds, clients=8, every=10, **run_kw):
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=ROWS),
        shard=tcfg.ShardConfig(num_clients=clients),
        fed=tcfg.FedConfig(rounds=rounds, termination_patience=1000),
        run=tcfg.RunConfig(checkpoint_dir=str(tmp), checkpoint_every=every,
                           **run_kw))


def test_checkpoint_roundtrip_and_bitwise_resume(tmp_path):
    """save/load of a 3-round state: tensors, history and step back as
    saved, and one more round from the restored state bitwise the round
    from the live one (tests/test_checkpoint.py)."""
    _, t_cfg = _configs()
    exp = t_build(t_cfg, device="cpu")
    step = exp.make_step(1)
    state = exp.state
    for _ in range(3):
        state, _ = step(state, exp.batch)
    history = {"accuracy": [0.5, 0.6, 0.7], "f1": []}
    save_checkpoint(str(tmp_path), state, history, step=3)
    assert latest_step(str(tmp_path)) == 3
    raw, hist, at = load_checkpoint_raw(str(tmp_path))
    assert at == 3 and hist == {"accuracy": [0.5, 0.6, 0.7]}
    assert torch.equal(raw["params"], state["params"])
    for k, v in state["opt_state"].items():
        assert torch.equal(raw["opt_state"][k], v)
    assert raw["round"] == 3
    live, _ = step(state, exp.batch)
    restored, _ = step(raw, exp.batch)
    assert torch.equal(restored["params"], live["params"])
    assert restored["round"] == 4


@pytest.mark.parametrize("run_kw", [{}, dict(pipelined_stop=True,
                                             rounds_per_step=5)],
                         ids=["synchronous", "pipelined"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, run_kw):
    """20 rounds with checkpoints, then resumed to 40: the client-mean
    history and the final params equal the uninterrupted 40 rounds bit for
    bit, and the resumed rounds' losses too. (The early-stop countdown is
    not checkpointed, as in fedtpu, so these runs do not stop early.)"""
    full = t_run(_ck_config(tmp_path / "a", 40, **run_kw).replace(
        run=tcfg.RunConfig(**run_kw)), verbose=False, device="cpu")
    ck = tmp_path / "b"
    first = t_run(_ck_config(ck, 20, **run_kw), verbose=False, device="cpu")
    assert first.rounds_run == 20 and complete_steps(str(ck)) == [10, 20]
    resumed = t_run(_ck_config(ck, 40, **run_kw), verbose=False,
                    device="cpu", resume=True)
    assert complete_steps(str(ck)) == [10, 20, 30, 40]
    assert resumed.rounds_run == 40 and len(resumed.loss) == 20
    assert resumed.global_metrics == full.global_metrics
    np.testing.assert_array_equal(np.stack(resumed.loss),
                                  np.stack(full.loss[20:]))
    for a, b in zip(jax.tree.leaves(resumed.final_params),
                    jax.tree.leaves(full.final_params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("new_clients", [4, 16])
def test_elastic_resume_matches_fedtpus_elastic_global_model(tmp_path,
                                                            new_clients):
    """An 8-client run checkpointed at round 4, resumed at another client
    count by both packages: the carried-over global model within 1e-6 of
    fedtpu's (resume at the saved round trains nothing), and two more
    rounds under the new count within 1e-5 (tests/test_checkpoint.py)."""
    def cfgs(mod, data, ck, clients, rounds):
        return mod.ExperimentConfig(
            data=data, shard=mod.ShardConfig(num_clients=clients,
                                             shuffle=False),
            model=mod.ModelConfig(input_dim=6, hidden_sizes=(8,)),
            fed=mod.FedConfig(rounds=rounds),
            run=mod.RunConfig(checkpoint_dir=str(ck), checkpoint_every=2))

    j_data = jcfg.DataConfig(csv_path=None, synthetic_rows=256,
                             synthetic_features=6)
    t_data = tcfg.DataConfig(synthetic_rows=256, synthetic_features=6)
    jd, td = tmp_path / "j", tmp_path / "t"
    j_first = cfgs(jcfg, j_data, jd, 8, 4)
    j_run(j_first, verbose=False)
    t_run(cfgs(tcfg, t_data, td, 8, 4), verbose=False, device="cpu",
          init_params=_fedtpu_init(j_first))
    for rounds, atol in ((4, 1e-6), (6, 1e-5)):
        for d in (jd, td):
            for s in complete_steps(str(d)):
                if s > 4:
                    import shutil
                    shutil.rmtree(d / f"round_{s:06d}")
        rj = j_run(cfgs(jcfg, j_data, jd, new_clients, rounds),
                   verbose=False, resume=True)
        rt = t_run(cfgs(tcfg, t_data, td, new_clients, rounds),
                   verbose=False, device="cpu", resume=True)
        assert rt.rounds_run == rj.rounds_run == rounds
        assert len(rt.global_metrics["accuracy"]) == rounds
        for a, b in zip(jax.tree.leaves(rt.final_params),
                        jax.tree.leaves(_np(rj.final_params))):
            np.testing.assert_allclose(a, b, atol=atol)


def _fake_round(root, step, files):
    d = root / f"round_{step:06d}"
    d.mkdir()
    for name in files:
        (d / name).write_bytes(b"")


def test_latest_step_skips_half_written_rounds(tmp_path):
    """A crash mid-save leaves a round with only its state (meta is
    written last) or only a temporary file: resume sees neither."""
    _fake_round(tmp_path, 2, ["state", "meta"])
    _fake_round(tmp_path, 4, ["state"])
    _fake_round(tmp_path, 6, ["state.tmp-123"])
    assert latest_step(str(tmp_path)) == 2
    assert complete_steps(str(tmp_path)) == [2]


def test_retention_keeps_k_newest_plus_protected(tmp_path):
    for s in (2, 4, 6, 8, 10):
        _fake_round(tmp_path, s, ["state", "meta"])
    _fake_round(tmp_path, 5, ["state"])       # a crash remnant: reclaimed
    _fake_round(tmp_path, 12, ["state"])      # may be mid-commit: kept
    removed = retain_checkpoints(str(tmp_path), keep=2, protect=(4,))
    assert removed == [2, 5, 6]
    assert complete_steps(str(tmp_path)) == [4, 8, 10]
    assert (tmp_path / "round_000012").is_dir()
    assert retain_checkpoints(str(tmp_path), keep=0) == []


def test_run_experiment_retention_bounds_disk_and_resumes(tmp_path):
    """keep_checkpoints=2 with a save every round: at most k + 1 rounds on
    disk (the k newest and the best-accuracy round), and a resume keeps
    the earlier history and the rule."""
    def cfg(rounds):
        return tcfg.ExperimentConfig(
            data=tcfg.DataConfig(synthetic_rows=256),
            shard=tcfg.ShardConfig(num_clients=4),
            fed=tcfg.FedConfig(rounds=rounds),
            run=tcfg.RunConfig(checkpoint_dir=str(tmp_path),
                               checkpoint_every=1, keep_checkpoints=2))

    res = t_run(cfg(6), verbose=False, device="cpu")
    steps = complete_steps(str(tmp_path))
    assert len(steps) <= 3 and steps[-1] == 6
    assert int(np.argmax(res.global_metrics["accuracy"])) + 1 in steps
    res2 = t_run(cfg(10), verbose=False, device="cpu", resume=True)
    assert res2.rounds_run == 10
    assert res2.global_metrics["accuracy"][:6] == \
        res.global_metrics["accuracy"]
    steps2 = complete_steps(str(tmp_path))
    assert len(steps2) <= 3 and steps2[-1] == 10
    assert int(np.argmax(res2.global_metrics["accuracy"])) + 1 in steps2


def test_fresh_run_refuses_dir_with_existing_rounds(tmp_path):
    cfg = _ck_config(tmp_path, 2, every=1)
    t_run(cfg, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="already holds"):
        t_run(cfg, verbose=False, device="cpu")
    assert t_run(cfg, verbose=False, device="cpu",
                 resume=True).rounds_run == 2


def test_divergence_saves_an_emergency_checkpoint_under_diverged(tmp_path):
    """A runaway learning rate with checkpoints on: the run halts at
    fedtpu's round and saves the poisoned state under diverged/, labelled
    as fedtpu labels it; resume still sees only the good periodic
    rounds."""
    j_cfg, t_cfg = _configs()
    sgd = dict(name="sgd", learning_rate=1e30)
    jd, td = tmp_path / "j", tmp_path / "t"
    j_cfg = j_cfg.replace(optim=jcfg.OptimConfig(**sgd), run=jcfg.RunConfig(
        checkpoint_dir=str(jd), checkpoint_every=1))
    t_cfg = t_cfg.replace(optim=tcfg.OptimConfig(**sgd), run=tcfg.RunConfig(
        checkpoint_dir=str(td), checkpoint_every=1))
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    from fedtpu.orchestration.checkpoint import complete_steps as j_steps
    assert rj.diverged and rt.diverged and rt.rounds_run == rj.rounds_run
    assert complete_steps(str(td / "diverged")) == \
        j_steps(str(jd / "diverged")) == [rt.rounds_run]
    assert complete_steps(str(td)) == j_steps(str(jd))
    raw, _, at = load_checkpoint_raw(str(td / "diverged"))
    assert at == complete_steps(str(td / "diverged"))[-1]
    assert not bool(torch.isfinite(raw["params"]).all() and all(
        torch.isfinite(v).all() for v in raw["opt_state"].values()
        if v.is_floating_point()))


def test_resume_walks_back_past_an_unreadable_round(tmp_path):
    """A committed round whose state file is corrupt: resume warns and
    restores the round before it."""
    cfg = _ck_config(tmp_path, 20)
    t_run(cfg, verbose=False, device="cpu")
    (tmp_path / "round_000020" / "state").write_bytes(b"not a checkpoint")
    with pytest.warns(RuntimeWarning, match="round 20 failed to restore"):
        res = t_run(_ck_config(tmp_path, 20), verbose=False, device="cpu",
                    resume=True)
    assert res.rounds_run == 20 and len(res.loss) == 10


def test_metrics_jsonl_lines_have_fedtpus_keys(tmp_path):
    """metrics_jsonl: one line a round with fedtpu's keys and values
    (fedtpu's init injected: client means within 1e-6)."""
    j_cfg, t_cfg = _configs()
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    j_cfg = j_cfg.replace(fed=jcfg.FedConfig(rounds=4),
                          run=jcfg.RunConfig(metrics_jsonl=str(jp)))
    t_cfg = t_cfg.replace(fed=tcfg.FedConfig(rounds=4),
                          run=tcfg.RunConfig(metrics_jsonl=str(tp)))
    j_run(j_cfg, verbose=False)
    res = t_run(t_cfg, verbose=False, device="cpu",
                init_params=_fedtpu_init(j_cfg))
    j_lines = [json.loads(l) for l in jp.read_text().splitlines()]
    t_lines = [json.loads(l) for l in tp.read_text().splitlines()]
    assert len(t_lines) == len(j_lines) == 4
    for a, b in zip(t_lines, j_lines):
        assert set(a) == set(b) and a["round"] == b["round"]
        for k in METRIC_NAMES:
            assert abs(a["client_mean"][k] - b["client_mean"][k]) <= 1e-6
            assert abs(a["pooled"][k] - b["pooled"][k]) <= 1e-6
        assert abs(a["loss_mean"] - b["loss_mean"]) <= 1e-5
    assert [l["client_mean"]["accuracy"] for l in t_lines] == \
        res.global_metrics["accuracy"]


def test_cli_local_training_checkpoint_resume_and_pipelined_flags(
        tmp_path, capsys):
    """fedtpu's flags on the port's CLI, on the CPU: local steps, FedProx,
    checkpoints, resume, the warm start, the metrics log and the pipelined
    stop."""
    from fedtpu_torch.cli import main
    from fedtpu_torch.sweep.grid import save_best_weights
    ck, log = tmp_path / "ck", tmp_path / "m.jsonl"
    gen = torch.Generator().manual_seed(0)
    best = convert.params_to_numpy(mlp_init(gen, 14, (50, 200), 2),
                                   (14, 50, 200, 2))
    npz = str(tmp_path / "best.npz")
    save_best_weights(npz, _best(best))
    common = ["run", "--preset", "income-2", "--platform", "cpu",
              "--synthetic-rows", "256", "--json", "--quiet",
              "--local-steps", "2", "--prox-mu", "0.01",
              "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
              "--keep-checkpoints", "2", "--metrics-jsonl", str(log),
              "--pipelined-stop", "--init-weights", npz]
    assert main(common + ["--rounds", "2"]) == 0
    assert main(common + ["--rounds", "4", "--resume"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["rounds_run"] == 4
    assert complete_steps(str(ck))[-1] == 4
    assert len(log.read_text().splitlines()) == 4


# ------------------------------------------------------ CUDA graphs
def test_capture_needs_the_card():
    """On the CPU there is no graph: run_experiment(capture=True) and
    capture_round_step refuse CPU tensors rather than run something
    else."""
    from fedtpu_torch.parallel.round import capture_round_step
    _, t_cfg = _configs()
    with pytest.raises(ValueError, match="needs the card"):
        t_run(t_cfg, verbose=False, device="cpu", capture=True)
    exp = t_build(t_cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph needs CUDA tensors"):
        capture_round_step(exp.make_step(1), exp.state, exp.batch)


def test_packed_outputs_round_trip():
    """The one buffer a chunk hands the host: loss, counts and the state's
    finiteness flag, unpacked exactly."""
    from fedtpu_torch.parallel.round import pack_outputs, unpack_outputs
    loss = torch.randn(3, 8)
    conf = torch.randint(0, 1000, (3, 8, 2, 2)).to(torch.float32)
    for finite in (True, False):
        raw = {"loss": loss, "conf": conf, "finite": torch.tensor(finite)}
        out = unpack_outputs(pack_outputs(raw), 3, 8, 2)
        assert torch.equal(out["loss"], loss)
        assert torch.equal(out["conf"], conf)
        assert out["finite"] is finite


# ------------------------------------ server optimizers and SCAFFOLD
# Adaptive server optimizers divide by sqrt(v) + tau (tau = 1e-3), which
# amplifies float32 differences of the deltas: over 3 rounds at server_lr
# 0.05 the params were measured within 7.8e-7 of fedtpu's (fedadam under
# sampling; 1.6e-7 to 4.2e-7 unsampled) and the server moments within
# 7.2e-9; held at 2e-6.
ADAPTIVE_ATOL = 2e-6
SERVER_LR = {"fedavgm": 1.0, "fedadagrad": 0.05, "fedyogi": 0.05,
             "fedadam": 0.05}


def _assert_server_state(j_state, t_state, atol):
    for k, v in t_state["server_opt_state"].items():
        np.testing.assert_allclose(
            v.numpy(), _flat(j_state["server_opt_state"][k]), rtol=0,
            atol=atol, err_msg=k)


@pytest.mark.parametrize("name,rate", [
    ("fedavgm", 1.0), ("fedadagrad", 1.0), ("fedyogi", 1.0),
    ("fedadam", 1.0), ("fedadam", 0.5)])
def test_server_optimizer_rounds_match_fedtpu(name, rate):
    """3 rounds against fedtpu's build_round_fn (its masks injected under
    sampling): confusion counts equal, params and server state within
    1e-5 (fedavgm) or ADAPTIVE_ATOL, every slot the server model."""
    atol = 1e-5 if name == "fedavgm" else ADAPTIVE_ATOL
    j_cfg, t_cfg = _sharded_configs("psum", rate=rate, server_opt=name,
                                    server_lr=SERVER_LR[name])
    masks = _fedtpu_masks(j_cfg) if rate < 1.0 else None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3, masks):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        p = t_state["params"]
        np.testing.assert_allclose(p.numpy(), _flat(j_state["params"]),
                                   rtol=0, atol=atol)
        assert torch.equal(p, p[:1].expand_as(p))
        _assert_server_state(j_state, t_state, atol)
    assert set(t_state["server_opt_state"]) == (
        {"m"} if name == "fedavgm" else {"m", "v"})


def test_zero_participant_round_holds_model_and_momentum():
    """fedavgm under sampling with no participant in either round: the
    server model and its momentum carry over on both sides
    (round.py:691-701), decided on the device."""
    j_cfg, t_cfg = _sharded_configs("psum", rate=1e-9, rounds=2,
                                    server_opt="fedavgm")
    masks = _fedtpu_masks(j_cfg)
    assert masks(0).sum() == masks(1).sum() == 0
    start = None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 2, masks):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        start = t_state["params"] if start is None else start
        assert torch.equal(t_state["params"], start)
        assert not t_state["server_opt_state"]["m"].any()
        # The start g0 is each side's mean of the inits (an ulp apart).
        np.testing.assert_allclose(t_state["params"].numpy(),
                                   _flat(j_state["params"]), rtol=0,
                                   atol=1e-7)


def test_fedavgm_without_momentum_is_plain_fedavg():
    """fedavgm(momentum=0, lr=1) from the shared start: the same confusion
    counts as plain FedAvg from that start, params within 1e-5."""
    _, t_avg = _sharded_configs("psum", rounds=3)
    _, t_m = _sharded_configs("psum", rounds=3, server_opt="fedavgm",
                              server_momentum=0.0, server_lr=1.0)
    j_cfg, _ = _sharded_configs("psum", server_opt="fedavgm")
    start = _np(j_build(j_cfg).state["params"])
    runs = []
    for cfg in (t_avg, t_m):
        exp = t_build(cfg, device="cpu", init_params=start)
        state, step, out = exp.state, exp.make_step(1), []
        for _ in range(3):
            state, raw = step(state, exp.batch)
            out.append((state["params"], raw["conf"]))
        runs.append(out)
    for (p_avg, c_avg), (p_m, c_m) in zip(*runs):
        assert torch.equal(c_avg, c_m)
        np.testing.assert_allclose(p_m.numpy(), p_avg.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("rate", [1.0, 0.5], ids=["all", "sampled"])
def test_scaffold_rounds_match_fedtpu(rate):
    """SCAFFOLD (uniform weights, 3 local steps so the correction acts)
    against fedtpu's build_round_fn: confusion counts equal; params, both
    variates and the server state within 1e-5; absentees keep their
    variate, and the server variate stays the mean of the clients'."""
    j_cfg, t_cfg = _sharded_configs("psum", rate=rate, weighting="uniform",
                                    scaffold=True, local_steps=3)
    masks = _fedtpu_masks(j_cfg) if rate < 1.0 else None
    prev = None
    for r, (j_state, t_state, raw, j_conf) in enumerate(
            _step_both(j_cfg, t_cfg, 3, masks)):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        for key in ("params", "client_cv", "server_cv"):
            np.testing.assert_allclose(t_state[key].numpy(),
                                       _flat(j_state[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
        _assert_server_state(j_state, t_state, 1e-5)
        np.testing.assert_allclose(t_state["server_cv"].numpy(),
                                   t_state["client_cv"].mean(dim=0).numpy(),
                                   rtol=0, atol=1e-6)
        if masks is not None and prev is not None:
            out = torch.from_numpy(masks(r) == 0)
            assert out.any()
            assert torch.equal(t_state["client_cv"][out],
                               prev["client_cv"][out])
        prev = t_state


# ------------------------------------------------ refusals, fedtpu's text
def _knob_configs(kw: dict):
    """``_sharded_configs`` with FedConfig knobs, the aggregation and the
    participation rate among them."""
    kw = dict(kw)
    return _sharded_configs(kw.pop("aggregation", "psum"),
                            rate=kw.pop("participation_rate", 1.0), **kw)


def _build_error(build, cfg, **kw) -> str:
    with pytest.raises(ValueError) as err:
        exp = build(cfg, **kw)
        exp.make_step(1)(exp.state, exp.batch)
    return str(err.value)


REFUSED = {
    "noise without clip": dict(dp_noise_multiplier=1.0),
    "adaptive without clip": dict(dp_adaptive_clip=True),
    "scaffold data_size": dict(scaffold=True),
    "scaffold + DP": dict(scaffold=True, weighting="uniform",
                          dp_clip_norm=1.0),
    "scaffold + int8": dict(scaffold=True, weighting="uniform",
                            compress="int8"),
    "scaffold + ring": dict(scaffold=True, weighting="uniform",
                            aggregation="ring"),
    "scaffold + byzantine": dict(scaffold=True, weighting="uniform",
                                 byzantine_clients=1),
    "server opt + ring": dict(server_opt="fedadam", aggregation="ring"),
    "unknown server opt": dict(server_opt="adam"),
    "quantile": dict(dp_clip_norm=1.0, dp_adaptive_clip=True,
                     dp_target_quantile=1.0),
    "clip lr": dict(dp_clip_norm=1.0, dp_adaptive_clip=True, dp_clip_lr=0.0),
    "count noise too small": dict(
        dp_clip_norm=1.0, dp_adaptive_clip=True, dp_noise_multiplier=1.0,
        dp_count_noise_multiplier=0.4, weighting="uniform"),
    "count noise without noise": dict(dp_clip_norm=1.0, dp_adaptive_clip=True,
                                      dp_count_noise_multiplier=1.0),
    "count noise without adaptive": dict(dp_count_noise_multiplier=1.0),
    "adaptive + int8": dict(dp_clip_norm=1.0, dp_adaptive_clip=True,
                            compress="int8"),
    "fixed denominator data_size": dict(dp_clip_norm=1.0,
                                        participation_rate=0.5),
    "noise data_size": dict(dp_clip_norm=1.0, dp_noise_multiplier=1.0),
    "unknown compress": dict(compress="zstd"),
    "int8 + server opt": dict(compress="int8", server_opt="fedavgm"),
    "int8 + ring": dict(compress="int8", aggregation="ring"),
    "unknown robust rule": dict(robust_aggregation="mean"),
    "robust + server opt": dict(robust_aggregation="median",
                                weighting="uniform", server_opt="fedavgm"),
    "krum sampled": dict(robust_aggregation="krum", weighting="uniform",
                         participation_rate=0.5),
    "geometric median sampled": dict(robust_aggregation="geometric_median",
                                     weighting="uniform",
                                     participation_rate=0.5),
    "robust data_size": dict(robust_aggregation="median"),
    "trim ratio": dict(trim_ratio=0.5),
    "krum f": dict(krum_f=-1),
    "byzantine count": dict(byzantine_clients=-1),
    "trim removes all": dict(robust_aggregation="trimmed_mean",
                             weighting="uniform", trim_ratio=0.49),
    "krum too few clients": dict(robust_aggregation="krum",
                                 weighting="uniform", krum_f=7),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_combinations_raise_fedtpus_message(case):
    """Each knob combination fedtpu refuses (its loop, build_round_fn or its
    first trace) raises ValueError in the port with the same text."""
    j_cfg, t_cfg = _knob_configs(REFUSED[case])
    j_msg = _build_error(j_build, j_cfg)
    assert _build_error(t_build, t_cfg, device="cpu") == j_msg


STATE_MISMATCH = [
    ("delta step, plain state", dict(server_opt="fedavgm"), {}),
    ("plain step, delta state", {}, dict(server_opt="fedavgm")),
    ("int8 step, unshared state", dict(compress="int8"), {}),
    ("scaffold step, no variates",
     dict(scaffold=True, weighting="uniform"),
     dict(server_opt="fedavgm", weighting="uniform")),
    ("delta step, variates", dict(server_opt="fedavgm", weighting="uniform"),
     dict(scaffold=True, weighting="uniform")),
    ("adaptive step, no clip", dict(dp_clip_norm=1.0, dp_adaptive_clip=True),
     dict(dp_clip_norm=1.0)),
    ("clip step, adaptive state", dict(dp_clip_norm=1.0),
     dict(dp_clip_norm=1.0, dp_adaptive_clip=True))]


@pytest.mark.parametrize("case,step_kw,state_kw", STATE_MISMATCH,
                         ids=[c[0] for c in STATE_MISMATCH])
def test_state_of_another_round_fn_is_fedtpus_error(case, step_kw, state_kw):
    """A state built for one set of knobs, stepped by a round function of
    another (round.py:910-949): the same error on both sides."""
    msgs = []
    for build, mod, kw in ((j_build, jcfg, {}), (t_build, tcfg,
                                                 dict(device="cpu"))):
        j_or_t = 0 if mod is jcfg else 1
        step_cfg = _knob_configs(step_kw)[j_or_t]
        state_cfg = _knob_configs(state_kw)[j_or_t]
        step = build(step_cfg, **kw)
        with pytest.raises(ValueError) as err:
            step.make_step(1)(build(state_cfg, **kw).state, step.batch)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ central DP
DP_CLIP = 0.05       # below the clients' first-round update norms (~0.08)


@functools.partial(jax.jit, static_argnums=0)
def _fedtpu_noise_draw(seed, template, r):
    key = jax.random.key(seed)
    delta = gaussian_noise_tree(jax.random.fold_in(
        jax.random.fold_in(key, _DP_NOISE_STREAM), r), template, 1.0)
    count = jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(key, _DP_COUNT_STREAM), r))
    return delta, count


def _fedtpu_noise(j_cfg):
    """fedtpu's unit-normal draws of a round (round.py:631-642, :673-677),
    mapped onto the port's flat layout by name: the delta noise of
    fold_in(fold_in(key(dp_seed), _DP_NOISE_STREAM), r), one key per leaf
    in fedtpu's leaf order, then the count noise. The draw is jitted once
    per seed and model for the worker."""
    template = jax.tree.map(lambda p: np.zeros(p.shape[1:], np.float32),
                            _np(j_build(j_cfg).state["params"]))

    def noise(r):
        delta, count = _fedtpu_noise_draw(j_cfg.fed.dp_seed, template, r)
        return np.concatenate((_flat(delta), [np.float32(count)]))

    return noise


def _dp_configs(rate=1.0, rounds=3, **fed):
    return _sharded_configs("psum", rate=rate, rounds=rounds,
                            dp_clip_norm=DP_CLIP, **fed)


DP_CASES = {
    "clip only": dict(),
    "clip and noise": dict(weighting="uniform", dp_noise_multiplier=1.0),
    "fixed denominator": dict(weighting="uniform", dp_noise_multiplier=1.0,
                              rate=0.5),
    "no participant": dict(weighting="uniform", dp_noise_multiplier=1.0,
                           rate=1e-9),
    "adaptive": dict(weighting="uniform", dp_adaptive_clip=True, rate=0.5),
    "adaptive no participant": dict(weighting="uniform",
                                    dp_adaptive_clip=True, rate=1e-9),
    "adaptive count noise": dict(
        weighting="uniform", dp_adaptive_clip=True, dp_noise_multiplier=0.5,
        dp_count_noise_multiplier=1.0, rate=0.5, dp_clip_lr=0.5),
}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_rounds_match_fedtpu(case):
    """3 rounds against fedtpu's build_round_fn, its masks and noise
    injected: confusion counts equal, params and the server state within
    1e-5 (or 1e-6 of the model's scale), the adaptive clip within 1e-6
    relative. With no participant and
    the fixed denominator the noise is still released; without count noise
    the adaptive clip holds."""
    kw = dict(DP_CASES[case])
    rate = kw.pop("rate", 1.0)
    j_cfg, t_cfg = _dp_configs(rate, **kw)
    masks = _fedtpu_masks(j_cfg) if rate < 1.0 else None
    noisy = kw.get("dp_noise_multiplier", 0) > 0
    t_kw = dict(dp_noise=_fedtpu_noise(j_cfg)) if noisy else {}
    start = clips = None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3, masks,
                                                    **t_kw):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        want = _flat(j_state["params"])
        # 1e-5, or 1e-6 of the model's scale for "no participant": its
        # denominator q*C = 1.6e-8 gives the noise a std of ~3e6.
        atol = max(1e-5, 1e-6 * float(np.abs(want).max()))
        np.testing.assert_allclose(t_state["params"].numpy(), want, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(
            t_state["server_opt_state"]["m"].numpy(),
            _flat(j_state["server_opt_state"]["m"]), rtol=0, atol=atol)
        if "dp_clip" in t_state:
            np.testing.assert_allclose(float(t_state["dp_clip"]),
                                       float(j_state["dp_clip"]), rtol=1e-6)
            clips = [] if clips is None else clips
            clips.append(float(t_state["dp_clip"]))
        start = t_state["params"] if start is None else start
    if rate == 1e-9:
        assert masks(0).sum() == masks(1).sum() == masks(2).sum() == 0
        # With the fixed denominator q*C the noise moves the model anyway;
        # without noise the model and the clip hold.
        assert noisy != torch.equal(t_state["params"], start)
        if clips:
            assert clips == [float(np.float32(DP_CLIP))] * 3
    elif clips:
        assert len(set(clips)) == 3


def _dp_fed(z, q=0.5):
    return tcfg.FedConfig(weighting="uniform", dp_clip_norm=1.0,
                          dp_noise_multiplier=z, participation_rate=q)


def _same_meta(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("scenario", [
    "fresh", "resume changes z", "resume changes q", "noise off after noise",
    "older order grid", "no curve saved", "void carried"])
def test_privacy_ledger_matches_fedtpus(scenario):
    """The port's ledger and fedtpu's, from the same config and restored
    meta: the same curve at every label, flags and checkpoint meta."""
    first = _dp_fed(1.1)
    meta, fed, start = None, first, 0
    if scenario != "fresh":
        start = 20
        meta = JLedger(first).checkpoint_meta(start)
        fed = {"resume changes z": _dp_fed(0.7),
               "resume changes q": _dp_fed(1.1, q=0.25),
               "noise off after noise": tcfg.FedConfig(),
               "older order grid": _dp_fed(0.9),
               "no curve saved": _dp_fed(0.9),
               "void carried": _dp_fed(1.3)}[scenario]
        if scenario == "older order grid":
            meta["dp_rdp"] = meta["dp_rdp"][::2]
            meta["dp_rdp_orders"] = meta["dp_rdp_orders"][::2]
        if scenario == "no curve saved":
            meta = {}
        if scenario == "void carried":
            meta["dp_guarantee_void"] = True
    t = TLedger(fed, start_round=start, restored_meta=meta)
    j = JLedger(fed, start_round=start, restored_meta=meta)
    assert (t.composed, t.base_assumed) == (j.composed, j.base_assumed)
    for label in (start, start + 1, start + 37):
        np.testing.assert_array_equal(t.rdp_at(label), j.rdp_at(label))
        assert t.void_at(label) == j.void_at(label)
        _same_meta(t.checkpoint_meta(label), j.checkpoint_meta(label))


def _loop_configs(rounds, tmp=None, **fed):
    """A DP run of 16 clients over 8 shards: uniform weights, clip, noise,
    client sampling at 0.5, adaptive clip with count noise."""
    knobs = dict(weighting="uniform", dp_noise_multiplier=0.5,
                 dp_adaptive_clip=True, dp_count_noise_multiplier=1.0)
    knobs.update(fed)
    j, t = _dp_configs(0.5, rounds, **knobs)
    run = dict(eval_test_every=4)
    if tmp is not None:
        run.update(checkpoint_dir=str(tmp), checkpoint_every=4)
    return (j.replace(run=dataclasses.replace(j.run, **run)),
            t.replace(run=dataclasses.replace(t.run, **run)))


def test_dp_run_matches_fedtpu():
    """run_experiment with DP noise, sampling and adaptive clipping against
    fedtpu's (its init, masks and noise injected): the same rounds, losses
    within 1e-4, histories within 1e-6, the final clip within 1e-5
    relative, and the same privacy spend."""
    j_cfg, t_cfg = _loop_configs(12)
    init = _np(j_build(j_cfg).state["params"])
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu", init_params=init,
               participation_masks=_fedtpu_masks(j_cfg),
               dp_noise=_fedtpu_noise(j_cfg))
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-6)
        np.testing.assert_allclose(rt.test_metrics[name],
                                   rj.test_metrics[name], atol=1e-6)
    np.testing.assert_allclose(rt.final_dp_clip, rj.final_dp_clip,
                               rtol=1e-5)
    spent = rt.privacy_spent()
    assert spent == rj.privacy_spent() and math.isfinite(spent["epsilon"])
    assert rt.summary()["dp"] == spent
    assert rt.summary()["final_dp_clip"] == rt.final_dp_clip


def test_dp_resume_is_bitwise_and_composes_a_changed_z_as_fedtpu(tmp_path):
    """8 rounds with checkpoints, then resumed to 12: bitwise the
    uninterrupted 12 rounds (losses, confusion counts, final params and
    clip; the port's own noise is a pure function of seed and round) with
    the same privacy spend. A resume that changes the noise multiplier
    reports the spend of fedtpu's ledger over the two segments. The runs
    do not stop early (a resume restarts the patience count, as in
    fedtpu, so an early stop across the resume is not the comparison)."""
    long = dict(termination_patience=100)
    _, full_cfg = _loop_configs(12, **long)
    full = t_run(full_cfg, verbose=False, device="cpu")
    _, seg = _loop_configs(8, tmp_path / "same", **long)
    t_run(seg, verbose=False, device="cpu")
    _, seg = _loop_configs(12, tmp_path / "same", **long)
    resumed = t_run(seg, verbose=False, device="cpu", resume=True)
    assert full.rounds_run == resumed.rounds_run == 12
    for a, b in zip(resumed.loss, full.loss[8:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(resumed.confusion, full.confusion[8:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(resumed.final_params),
                    jax.tree.leaves(full.final_params)):
        np.testing.assert_array_equal(a, b)
    assert resumed.final_dp_clip == full.final_dp_clip
    assert resumed.privacy_spent()["epsilon"] == \
        full.privacy_spent()["epsilon"]

    _, first = _loop_configs(8, tmp_path / "z")
    _, second = _loop_configs(12, tmp_path / "z", dp_noise_multiplier=0.7)
    t_run(first, verbose=False, device="cpu")
    spent = t_run(second, verbose=False, device="cpu",
                  resume=True).privacy_spent()
    ledger = JLedger(second.fed, start_round=8, restored_meta=JLedger(
        first.fed).checkpoint_meta(8))
    want = j_acc.epsilon_from_rdp(list(ledger.rdp_at(12)),
                                  second.fed.dp_delta)
    assert (spent["epsilon"], spent["rdp_order"]) == (want["epsilon"],
                                                      want["order"])
    assert spent["noise_multiplier"] == 0.7 and spent["rounds"] == 12
    assert spent["composed_over_resumed_segments"]


def test_checkpoint_round_trips_the_new_state_and_the_ledger(tmp_path):
    """A state with server optimizer state, control variates, an adaptive
    clip and the shared-start marker, and the ledger's meta: saved, read
    back equal, restored onto the live layout; a layout that differs
    raises fedtpu's resume mismatch."""
    _, t_cfg = _sharded_configs("psum", server_opt="fedadam",
                                weighting="uniform", scaffold=True)
    state = t_build(t_cfg, device="cpu").state
    state["client_cv"] = torch.randn(state["client_cv"].shape)
    state["server_opt_state"]["v"] = torch.rand(state["params"].shape[1])
    state["dp_clip"] = torch.tensor(0.25)
    fed = _dp_fed(1.1)
    meta = TLedger(fed).checkpoint_meta(7)
    ckpt.save_checkpoint(str(tmp_path), state, {"accuracy": [0.5]}, 7,
                         extra_meta=meta)
    raw, history, step = ckpt.load_checkpoint_raw(str(tmp_path))
    assert (history, step) == ({"accuracy": [0.5]}, 7)
    back = _restore_state(raw, state, torch.device("cpu"))
    for a, b in zip(t_round._state_tensors(back),
                    t_round._state_tensors(state)):
        assert torch.equal(a, b)
    assert back["shared_start"] and back["round"] == 0
    _same_meta({k: v for k, v in ckpt.load_meta(str(tmp_path)).items()
                if k in meta}, meta)
    resumed = TLedger(fed, start_round=7,
                      restored_meta=ckpt.load_meta(str(tmp_path)))
    np.testing.assert_allclose(resumed.rdp_at(9), TLedger(fed).rdp_at(9),
                               rtol=1e-12)
    plain = t_build(_sharded_configs("psum")[1], device="cpu").state
    with pytest.raises(ValueError, match="resume mismatch"):
        _restore_state(raw, plain, torch.device("cpu"))


# ------------------------------- robust rules, Byzantine clients, int8
SHARDED_DIMS = (14, 16, 8, 2)       # _sharded_configs' model


def _submitted(trained, start, byzantine):
    """What fedtpu's clients submit (round.py:595-600): the first k send
    ``s - 10 (t - s)``."""
    t = _flat(trained)
    bad = np.arange(t.shape[0])[:, None] < byzantine
    return np.where(bad, start - 10.0 * (t - start), t)


@pytest.mark.parametrize("byzantine", [0, 2])
@pytest.mark.parametrize("rate", [1.0, 0.5], ids=["all", "sampled"])
@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_coordinatewise_rules_match_fedtpu(rule, rate, byzantine):
    """3 rounds: confusion counts equal, params within 1e-5; with 16
    clients (an even count) the unsampled median is the mean of the two
    middle values, as jnp.median's. Under sampling the order statistics
    are those of the participants only."""
    j_cfg, t_cfg = _sharded_configs(
        "psum", rate=rate, weighting="uniform", robust_aggregation=rule,
        trim_ratio=0.2, byzantine_clients=byzantine)
    masks = _fedtpu_masks(j_cfg) if rate < 1.0 else None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3, masks):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        np.testing.assert_allclose(t_state["params"].numpy(),
                                   _flat(j_state["params"]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_sampled_rules_carry_the_params_over_without_participants(rule):
    """No participant under sampling: the median and the trimmed mean keep
    the params (round.py:857-860), decided on the device."""
    j_cfg, t_cfg = _sharded_configs("psum", rate=1e-9, rounds=2,
                                    weighting="uniform",
                                    robust_aggregation=rule)
    masks = _fedtpu_masks(j_cfg)
    start = None
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 2, masks):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        start = t_state["params"] if start is None else start
        assert torch.equal(t_state["params"], start)


@pytest.mark.parametrize("byzantine", [0, 3])
@pytest.mark.parametrize("rule", ["krum", "geometric_median"])
def test_whole_update_rules_match_fedtpu(rule, byzantine):
    """3 rounds of Krum (krum_f = 3) and the geometric median (16 smoothed
    Weiszfeld steps): confusion counts equal, params within 1e-5. Krum's
    global is one client's submitted update: the same client on both
    sides, and never a Byzantine one."""
    j_cfg, t_cfg = _sharded_configs(
        "psum", weighting="uniform", robust_aggregation=rule, krum_f=3,
        byzantine_clients=byzantine)
    j_exp = j_build(j_cfg)
    start = _flat(j_exp.state["params"])[0]
    trained = []
    for j_state, t_state, raw, j_conf in _step_both(
            j_cfg, t_cfg, 3, j_trained=trained, j_exp=j_exp):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        j_glob = _flat(j_state["params"])[0]
        t_glob = t_state["params"][0].numpy()
        np.testing.assert_allclose(t_glob, j_glob, rtol=0, atol=1e-5)
        if rule == "krum":
            sub = _submitted(trained[-1], start, byzantine)
            j_dist = np.abs(sub - j_glob).max(axis=1)
            t_dist = np.abs(sub - t_glob).max(axis=1)
            winner = int(np.argmin(j_dist))
            assert int(np.argmin(t_dist)) == winner >= byzantine
            assert j_dist[winner] < 1e-5 and t_dist[winner] < 1e-5
        start = j_glob


def test_byzantine_clients_poison_the_plain_mean_as_in_fedtpu():
    """The plain mean (K1 in broadcast mode) under Byzantine injection:
    3 rounds within 1e-5 of fedtpu's, confusion counts equal."""
    j_cfg, t_cfg = _sharded_configs("psum", byzantine_clients=3)
    for j_state, t_state, raw, j_conf in _step_both(j_cfg, t_cfg, 3):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        np.testing.assert_allclose(t_state["params"].numpy(),
                                   _flat(j_state["params"]), rtol=0,
                                   atol=1e-5)


def test_int8_exchange_matches_fedtpu_within_a_quantization_step():
    """compress='int8' over 8 shards: each round's global within one
    quantization step per element of fedtpu's (a shard's partial sum can
    round across a .5 boundary the other way: scale_s / total_w, the
    largest shard scale of the element's leaf), accumulated over the
    rounds; confusion counts equal; every slot the global."""
    j_cfg, t_cfg = _sharded_configs("psum", compress="int8")
    j_exp = j_build(j_cfg)
    w = np.asarray(j_exp.batch["mask"]).sum(axis=1)
    start = _flat(j_exp.state["params"])[0]
    bounds = leaf_bounds(SHARDED_DIMS)
    trained, slack = [], 0.0
    for j_state, t_state, raw, j_conf in _step_both(
            j_cfg, t_cfg, 3, j_trained=trained, j_exp=j_exp):
        np.testing.assert_array_equal(raw["conf"][0].numpy(), j_conf)
        delta = (_flat(trained[-1]) - start) * w[:, None]
        partial = delta.reshape(8, 2, -1).sum(axis=1)
        step = np.concatenate([
            np.full(b - a, np.abs(partial[:, a:b]).max() / 127 / w.sum())
            for a, b in bounds])
        slack = slack + step
        j_glob = _flat(j_state["params"])[0]
        p = t_state["params"]
        assert torch.equal(p, p[:1].expand_as(p))
        assert np.all(np.abs(p[0].numpy() - j_glob) <= slack + 1e-6)
        start = j_glob


# --------------------------------------------------- A6 CLI and the loop
def test_a6_cli_flags_set_fedtpus_fields():
    """fedtpu's flags for the delta path, DP, robust rules, SCAFFOLD and
    int8 give the port's FedConfig the values they give fedtpu's."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser, config_from_args
    argv = ["run", "--scaffold", "--server-opt", "fedyogi", "--server-lr",
            "0.3", "--server-momentum", "0.5", "--dp-clip-norm", "2.0",
            "--dp-noise-multiplier", "0.7", "--dp-delta", "1e-6",
            "--dp-adaptive-clip", "--dp-target-quantile", "0.4",
            "--dp-clip-lr", "0.1", "--dp-count-noise-multiplier", "0.9",
            "--compress", "int8", "--robust-aggregation", "krum",
            "--trim-ratio", "0.2", "--krum-f", "2", "--byzantine-clients",
            "3"]
    j_fed = _apply_overrides(jcfg.ExperimentConfig(),
                             j_parser().parse_args(argv)).fed
    t_fed = config_from_args(t_parser().parse_args(argv)).fed
    fields = ("scaffold", "server_opt", "server_lr", "server_momentum",
              "dp_clip_norm", "dp_noise_multiplier", "dp_delta",
              "dp_adaptive_clip", "dp_target_quantile", "dp_clip_lr",
              "dp_count_noise_multiplier", "compress", "robust_aggregation",
              "trim_ratio", "krum_f", "byzantine_clients")
    assert {f: getattr(t_fed, f) for f in fields} == {
        f: getattr(j_fed, f) for f in fields}
    with pytest.raises(SystemExit):
        t_parser().parse_args(["run", "--dp-delta", "1.0"])


def test_fedadam_run_matches_fedtpu():
    """run_experiment with fedadam (income-8-shaped, data-size weighting)
    against fedtpu's: the same stop round, histories within 1e-6, losses
    within 1e-4 (ADAPTIVE_ATOL on params), no privacy spend."""
    j_cfg, t_cfg = _sharded_configs("psum", rounds=40, server_opt="fedadam",
                                    server_lr=0.05)
    run_kw = dict(eval_test_every=10)
    j_cfg = j_cfg.replace(run=dataclasses.replace(j_cfg.run, **run_kw))
    t_cfg = t_cfg.replace(run=dataclasses.replace(t_cfg.run, **run_kw))
    init = _np(j_build(j_cfg).state["params"])
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu", init_params=init)
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-6)
        np.testing.assert_allclose(rt.test_metrics[name],
                                   rj.test_metrics[name], atol=1e-6)
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert rt.privacy_spent() == rj.privacy_spent() == {}
    assert "dp" not in rt.summary() and rt.final_dp_clip is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds_per_step,aggregation,rate", [
    (1, "psum", 1.0), (4, "psum", 1.0), (4, "ring", 1.0), (4, "psum", 0.5)])
def test_captured_run_is_bitwise_the_uncaptured_run(cuda, rounds_per_step,
                                                    aggregation, rate):
    """On the card every chunk is a graph replay: the history, the stop
    round and the final params equal the uncaptured loop's bit for bit,
    and each replay launches K1 (or K4) and K2 once a round."""
    _, t_cfg = _sharded_configs(aggregation, rate=rate, rounds=18)
    t_cfg = t_cfg.replace(run=dataclasses.replace(
        t_cfg.run, rounds_per_step=rounds_per_step))
    plain = t_run(t_cfg, verbose=False, device="cuda", capture=False)
    graph = t_run(t_cfg, verbose=False, device="cuda")
    assert graph.global_metrics == plain.global_metrics
    np.testing.assert_array_equal(np.stack(graph.loss), np.stack(plain.loss))
    np.testing.assert_array_equal(np.stack(graph.confusion),
                                  np.stack(plain.confusion))
    for a, b in zip(jax.tree.leaves(graph.final_params),
                    jax.tree.leaves(plain.final_params)):
        np.testing.assert_array_equal(a, b)
    average = ("weighted_average_clients" if aggregation == "psum"
               else "ring_all_reduce_sum")
    for width, launches in graph.graph_launches.items():
        assert launches[average] == launches["fused_eval_confusion"] == width
    assert graph.warmup_rounds == 1 and plain.warmup_rounds == 0


# ------------------------------------ the hyperparameter grid (A7's sweep)
from fedtpu_torch.sweep import grid as t_grid  # noqa: E402

SWEEP_ROWS = 256
# The reference grid's shape (10 architectures of 2 depths, so the launch
# plans give 2, 10 and 90 launches) at 1/25 of its widths, so that the CPU
# trains it in seconds.
SMALL_HIDDEN_GRID = tuple(tuple(max(1, w // 25) for w in h)
                          for h in t_grid.HIDDEN_GRID)


def _sweep_configs(clients=8):
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=SWEEP_ROWS),
        shard=jcfg.ShardConfig(num_clients=clients))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=SWEEP_ROWS),
        shard=tcfg.ShardConfig(num_clients=clients))
    return j, t


def _fedtpu_sweep_inits(hidden_grid, input_dim=14, classes=2):
    """fedtpu's seed-42 init of every architecture (its run_grid_search's
    draw), as the port's ``init_params`` mapping."""
    from fedtpu.models.mlp import mlp_init as j_mlp_init
    return {tuple(h): _np(j_mlp_init(jax.random.key(42), input_dim, h,
                                     classes))
            for h in hidden_grid}


def _sweep_inputs(hidden, lrs):
    """The same start, data and rates for fedtpu's _build_sweep_fn and the
    port's build_sweep_fn: fedtpu's seed-42 init in every (client, rate)
    slot of 8 clients."""
    import optax
    from fedtpu.data.sharding import pack_clients as j_pack
    from fedtpu.data.tabular import load_tabular_dataset as j_load
    from fedtpu.parallel.mesh import client_sharding, make_mesh
    j_cfg, _ = _sweep_configs()
    ds = j_load(j_cfg.data)
    mesh = make_mesh(num_clients=8)
    shard = client_sharding(mesh)
    packed = j_pack(ds.x_train, ds.y_train, j_cfg.shard)
    base = _fedtpu_sweep_inits([hidden])[tuple(hidden)]
    params = jax.tree.map(
        lambda p: jnp.broadcast_to(p, (8, len(lrs)) + p.shape), base)
    opt = jax.vmap(jax.vmap(
        lambda p: optax.scale_by_adam(eps_root=0.0).init(p)))(params)
    put = lambda t: jax.tree.map(lambda p: jax.device_put(p, shard), t)
    j_args = (put(params), put(opt), jnp.asarray(lrs, jnp.float32),
              *(jax.device_put(v, shard)
                for v in (packed.x, packed.y, packed.mask)))
    t_params = convert.params_from_jax(base).expand(
        8, len(lrs), -1).contiguous()
    t_args = (t_params,
              t_grid.build_sweep_adam(tcfg.OptimConfig()).init(t_params),
              torch.tensor(lrs, dtype=torch.float32),
              *(torch.from_numpy(v) for v in (packed.x, packed.y,
                                              packed.mask)),
              (ds.input_dim, *hidden, ds.num_classes))
    return mesh, j_cfg, j_args, t_args


@pytest.mark.parametrize("plateau,steps", [(False, 20), (True, 60)],
                         ids=["fixed", "plateau"])
def test_sweep_program_matches_fedtpus_build_sweep_fn(plateau, steps):
    """One launch of the sweep's training program from fedtpu's init, 8
    clients x 3 rates at (4, 4): the per-rate averaged models within 1e-5
    of fedtpu's _build_sweep_fn (measured: 6.4e-07 fixed, 2.6e-06 plateau),
    the per-(client, rate) and pooled confusion counts equal, and the
    plateau mode's mean steps (with sklearn's L2 term) exactly equal."""
    from fedtpu.sweep.grid import _build_sweep_fn
    hidden, lrs = (4, 4), (0.01, 0.05, 0.2)
    mesh, j_cfg, j_args, t_args = _sweep_inputs(hidden, lrs)
    l2 = 1e-4 if plateau else 0.0
    j_fn = _build_sweep_fn(mesh, 2, local_steps=steps,
                           optim_cfg=j_cfg.optim, plateau_stop=plateau,
                           l2_alpha=l2)
    t_fn = t_grid.build_sweep_fn(2, steps, tcfg.OptimConfig(),
                                 plateau_stop=plateau, l2_alpha=l2)
    j_avg, j_conf, j_pooled, j_steps = j_fn(*j_args)
    t_avg, t_conf, t_pooled, t_steps = t_fn(*t_args)
    np.testing.assert_allclose(t_avg.numpy(), _flat(j_avg), atol=1e-5)
    np.testing.assert_array_equal(t_conf.numpy(), np.asarray(j_conf))
    np.testing.assert_array_equal(t_pooled.numpy(), np.asarray(j_pooled))
    np.testing.assert_array_equal(t_steps.numpy(), np.asarray(j_steps))
    if plateau:
        assert np.asarray(j_steps).min() < steps   # some fits did stop


def test_sweep_plateau_freezes_exactly_at_the_plateau_point():
    """fedtpu's mechanism pin on the port: with a huge tol every step after
    the first is 'no improvement', so the counter exceeds
    n_iter_no_change=2 after step 4 and each model then coasts: the result
    equals a fixed 4-step run bit for bit, and fedtpu's plateau run within
    1e-5."""
    from fedtpu.sweep.grid import _build_sweep_fn
    mesh, j_cfg, j_args, t_args = _sweep_inputs((8,), (0.01,))
    plateau = t_grid.build_sweep_fn(2, 20, tcfg.OptimConfig(),
                                    plateau_stop=True, tol=1e9,
                                    n_iter_no_change=2)
    fixed = t_grid.build_sweep_fn(2, 4, tcfg.OptimConfig())
    p_avg, p_conf, _, p_steps = plateau(*t_args)
    f_avg, f_conf, _, f_steps = fixed(*t_args)
    assert p_steps.tolist() == f_steps.tolist() == [4.0]
    assert torch.equal(p_avg, f_avg) and torch.equal(p_conf, f_conf)
    j_avg, _, _, j_steps = _build_sweep_fn(
        mesh, 2, local_steps=20, optim_cfg=j_cfg.optim, plateau_stop=True,
        tol=1e9, n_iter_no_change=2)(*j_args)
    assert np.asarray(j_steps).tolist() == [4.0]
    np.testing.assert_allclose(p_avg.numpy(), _flat(j_avg), atol=1e-5)


def _grid_rows(res):
    return {(r["hidden_layer_sizes"], r["learning_rate"]): r
            for r in res["table"]}


def _tie_keys(res):
    return {(t["hidden_layer_sizes"], t["learning_rate"])
            for t in res["tie_set"]}


@pytest.mark.parametrize("plan,launches", [
    (dict(), 2), (dict(vmap_arch=False), 10), (dict(vmap_lr=False), 90)],
    ids=["2-launches", "10-launches", "90-launches"])
def test_grid_search_matches_fedtpus(plan, launches):
    """run_grid_search against fedtpu's on the reference grid's shape (10
    architectures, the 9 reference rates, 20 steps) from fedtpu's init, in
    each of its launch plans: the launch count equal (2, 10, 90), every
    row's pooled metrics within 1e-6 (accuracies equal), the winner and
    the tie set equal, and the winner's weights at true dims within 1e-5;
    compile_count is None (no program to compile)."""
    from fedtpu.sweep.grid import run_grid_search as j_grid
    j_cfg, t_cfg = _sweep_configs()
    kw = dict(hidden_grid=SMALL_HIDDEN_GRID, local_steps=20,
              keep_weights=True, verbose=False, **plan)
    rj = j_grid(j_cfg, **kw)
    rt = t_grid.run_grid_search(
        t_cfg, device="cpu", init_params=_fedtpu_sweep_inits(
            SMALL_HIDDEN_GRID), **kw)
    assert rt["launch_count"] == rj["launch_count"] == launches
    assert rt["compile_count"] is None
    assert len(rt["launch_times"]) == launches
    tj, tt = _grid_rows(rj), _grid_rows(rt)
    assert list(tt) == list(tj) and len(tt) == 90
    for key in tj:
        assert tt[key]["accuracy"] == tj[key]["accuracy"], key
        for m in ("precision", "recall", "f1", "mean_local_steps"):
            np.testing.assert_allclose(tt[key][m], tj[key][m], atol=1e-6)
        assert tt[key]["in_tie_set"] == tj[key]["in_tie_set"]
    assert rt["params"] == rj["params"]
    assert rt["metrics"] == pytest.approx(rj["metrics"], abs=1e-6)
    assert _tie_keys(rt) == _tie_keys(rj)
    assert rt["weight_shapes"] == rj["weight_shapes"]
    for a, b in zip(jax.tree.leaves(rt["weights"]),
                    jax.tree.leaves(_np(rj["weights"]))):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_grid_search_prints_fedtpus_winner_lines(capsys):
    """The reference's two report lines, byte for byte fedtpu's."""
    from fedtpu.sweep.grid import run_grid_search as j_grid
    j_cfg, t_cfg = _sweep_configs()
    kw = dict(hidden_grid=((8,), (4, 4)), lr_grid=(0.002, 0.05),
              local_steps=20)
    j_grid(j_cfg, **kw)
    j_out = capsys.readouterr().out
    t_grid.run_grid_search(t_cfg, device="cpu",
                           init_params=_fedtpu_sweep_inits(kw["hidden_grid"]),
                           **kw)
    t_out = capsys.readouterr().out

    def report(out):
        return [l for l in out.splitlines() if l.startswith("Best Global")]
    assert len(report(t_out)) == 2 and report(t_out) == report(j_out)


@pytest.mark.parametrize("variant,tol", [
    (dict(bucket_pad=False), 1e-6), (dict(vmap_arch=False), 1e-5),
    (dict(vmap_lr=False), 1e-5)],
    ids=["unpadded", "per-architecture", "sequential-rates"])
def test_grid_search_launch_plans_agree(variant, tol):
    """The port against itself at fedtpu's tolerances
    (tests/test_sweep.py): padded against unpadded (the zero pad is exact
    math; 1e-6), the depth class stacked into one launch against a launch
    per architecture and against a launch per rate (differently shaped
    batched products; 1e-5): the same table, winner, tie set and winner
    weights; plateau stop points unmoved by the pad."""
    _, t_cfg = _sweep_configs()
    hidden = ((8,), (16,), (4, 4), (16, 8), (8, 16))
    kw = dict(hidden_grid=hidden, lr_grid=(0.01, 0.05), local_steps=20,
              keep_weights=True, verbose=False, device="cpu")
    base = t_grid.run_grid_search(t_cfg, **kw)
    other = t_grid.run_grid_search(t_cfg, **kw, **variant)
    tb, to = _grid_rows(base), _grid_rows(other)
    assert list(tb) == list(to) and len(tb) == 10
    for key in tb:
        for m in ("accuracy", "precision", "recall", "f1"):
            np.testing.assert_allclose(tb[key][m], to[key][m], atol=tol)
    assert base["params"] == other["params"]
    assert _tie_keys(base) == _tie_keys(other)
    for a, b in zip(jax.tree.leaves(base["weights"]),
                    jax.tree.leaves(other["weights"])):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol)
    if "bucket_pad" in variant:
        kw.update(hidden_grid=((4, 4), (8, 16)), lr_grid=(0.05,),
                  local_steps=60, plateau_stop=True)
        padded = t_grid.run_grid_search(t_cfg, **kw)
        unpadded = t_grid.run_grid_search(t_cfg, **kw, **variant)
        for rb, ru in zip(padded["table"], unpadded["table"]):
            assert rb["mean_local_steps"] == ru["mean_local_steps"]
            np.testing.assert_allclose(rb["accuracy"], ru["accuracy"],
                                       atol=1e-6)


def test_grid_search_launch_plan_of_the_reference_grid(monkeypatch):
    """The reference's 90 configs: 2 launches (one per depth class: 18
    slots at fedtpu's (100,) bucket, then 72 at (400, 400)), 10 without
    stacking the architectures, 90 without the rates (a stand-in training
    program records each launch's slots and dims)."""
    calls = []

    def fake_sweep(params, opt_state, lrs, x, y, mask, dims, inspect=None):
        c, s, p = params.shape
        calls.append((s, tuple(dims)))
        conf = torch.zeros(c, s, 2, 2)
        conf[..., 0, 0] = 1.0
        return torch.zeros(s, p), conf, conf.sum(0), torch.ones(s)

    monkeypatch.setattr(t_grid, "build_sweep_fn",
                        lambda *a, **k: fake_sweep)
    _, t_cfg = _sweep_configs(clients=2)
    for plan, want in ((dict(), 2), (dict(vmap_arch=False), 10),
                       (dict(vmap_lr=False), 90)):
        calls.clear()
        res = t_grid.run_grid_search(t_cfg, local_steps=1, device="cpu",
                                     verbose=False, **plan)
        assert res["launch_count"] == len(calls) == want
        assert len(res["table"]) == 90
        if want == 2:
            assert calls == [(18, (14, 100, 2)), (72, (14, 400, 400, 2))]


def test_cli_sweep_writes_the_table_and_weights_fedtpu_reads(tmp_path,
                                                            capsys):
    """`sweep` on the port's CLI with the grid narrowed to one architecture
    and rate: one table line, a JSON summary, and a --save-weights artifact
    that fedtpu's load_best_weights reads and the port's `run
    --init-weights` warm-starts from (round 1 already far above a fresh
    start, as fedtpu's test_run_warm_starts_from_sweep_winner)."""
    from fedtpu.sweep.grid import load_best_weights as j_read
    from fedtpu_torch.cli import main
    table, npz = tmp_path / "t.jsonl", tmp_path / "w.npz"
    common = ["--platform", "cpu", "--csv", "", "--synthetic-rows",
              str(SWEEP_ROWS), "--hidden-sizes", "8", "--quiet", "--json"]
    assert main(["sweep", *common, "--learning-rate", "0.05",
                 "--local-steps", "60", "--table-jsonl", str(table),
                 "--save-weights", str(npz)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = [json.loads(l) for l in table.read_text().splitlines()]
    assert [(r["hidden_layer_sizes"], r["learning_rate"]) for r in rows] \
        == [([8], 0.05)]
    assert summary["launch_count"] == 1 and "weights" not in summary
    loaded = j_read(str(npz))
    assert tuple(loaded["params"]["hidden_layer_sizes"]) == (8,)
    assert loaded["params"]["learning_rate"] == 0.05
    assert loaded["accuracy"] == summary["accuracy"] > 0.9
    assert [l["w"].shape for l in loaded["weights"]["layers"]] == \
        [(14, 8), (8, 2)]
    run = ["run", *common, "--num-clients", "8", "--rounds", "1"]
    assert main(run) == 0
    fresh = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(run + ["--init-weights", str(npz)]) == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    acc = lambda s: s["final_global_metrics"]["accuracy"]
    assert acc(warm) > 0.85 and acc(warm) > acc(fresh) + 0.2


def test_cli_sweep_flags_are_fedtpus_sweep_flags():
    """Every flag of the port's `sweep` is one of fedtpu's `sweep`, and
    `run --personalize-steps` sets fedtpu's field."""
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser
    from fedtpu_torch.cli import config_from_args

    def sub(parser, name):
        act = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {f for a in act.choices[name]._actions
                for f in a.option_strings}
    extra = sub(t_parser(), "sweep") - sub(j_parser(), "sweep")
    assert extra == {"--synthetic-rows"}      # the port's run has it too
    for flag in ("--no-vmap-lr", "--table-jsonl", "--save-weights",
                 "--no-vmap-arch", "--no-bucket-pad", "--no-overlap-compile",
                 "--plateau-stop"):
        assert flag in sub(t_parser(), "sweep")
    args = t_parser().parse_args(["run", "--personalize-steps", "7"])
    assert config_from_args(args).fed.personalize_steps == 7
    with pytest.raises(SystemExit):
        t_parser().parse_args(["run", "--personalize-steps", "0"])


# ------------------------------------- post-training personalization (A7)
def test_personalize_matches_fedtpus_build_personalize_fn():
    """From fedtpu's state after 3 rounds of income-8-shaped training: 5
    local steps per client with a fresh Adam state, then each client's
    metrics on its own shard: per-client metrics equal, client mean and
    the last step's losses within 1e-5, personalized params within 1e-5
    of fedtpu's; steps < 1 raises fedtpu's ValueError."""
    from fedtpu.data.sharding import pack_clients as j_pack
    from fedtpu.data.tabular import load_tabular_dataset as j_load
    from fedtpu.parallel import client_sharding, make_mesh
    from fedtpu.parallel.round import build_round_fn, init_federated_state
    from fedtpu.training.personalize import build_personalize_fn as j_pers
    from fedtpu_torch.training.personalize import build_personalize_fn
    j_cfg, _ = _configs()
    ds = j_load(j_cfg.data)
    packed = j_pack(ds.x_train, ds.y_train, j_cfg.shard)
    mesh = make_mesh(num_clients=8)
    shard = client_sharding(mesh)
    batch = {k: jax.device_put(v, shard) for k, v in
             {"x": packed.x, "y": packed.y, "mask": packed.mask}.items()}
    init_fn, apply_fn = build_model(j_cfg.model)
    tx = build_optimizer(j_cfg.optim)
    state = init_federated_state(jax.random.key(0), mesh, 8, init_fn, tx,
                                 same_init=True)
    step = build_round_fn(mesh, apply_fn, tx, 2)
    for _ in range(3):
        state, _ = step(state, batch)
    j_personal, jm = j_pers(apply_fn, tx, 2, steps=5)(state["params"],
                                                      batch)
    dims = (14, 50, 200, 2)
    from fedtpu_torch.ops.optim import build_optimizer as t_build_opt
    t_tx = t_build_opt(tcfg.OptimConfig())
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    t_personal, tm = build_personalize_fn(dims, t_tx, 2, 5)(
        convert.params_from_jax(_np(state["params"])), t_batch)
    np.testing.assert_allclose(t_personal.numpy(), _flat(j_personal),
                               atol=1e-5)
    for k in METRIC_NAMES:
        np.testing.assert_array_equal(tm["per_client"][k].numpy(),
                                      np.asarray(jm["per_client"][k]))
        np.testing.assert_allclose(float(tm["client_mean"][k]),
                                   float(jm["client_mean"][k]), atol=1e-6)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=1e-5)
    # The slots started equal and trained on different shards.
    assert float((t_personal[0] - t_personal[1]).abs().max()) > 0
    with pytest.raises(ValueError) as j_err:
        j_pers(apply_fn, tx, 2, steps=0)
    with pytest.raises(ValueError) as t_err:
        build_personalize_fn(dims, t_tx, 2, 0)
    assert str(t_err.value) == str(j_err.value)


def _personalize_configs(steps):
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=512,
                             synthetic_features=6),
        shard=jcfg.ShardConfig(num_clients=8, strategy="dirichlet",
                               dirichlet_alpha=0.3, shuffle=True),
        model=jcfg.ModelConfig(input_dim=6, hidden_sizes=(8,)),
        fed=jcfg.FedConfig(rounds=10, personalize_steps=steps),
        run=jcfg.RunConfig(rounds_per_step=5))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=512, synthetic_features=6),
        shard=tcfg.ShardConfig(num_clients=8, strategy="dirichlet",
                               dirichlet_alpha=0.3, shuffle=True),
        model=tcfg.ModelConfig(input_dim=6, hidden_sizes=(8,)),
        fed=tcfg.FedConfig(rounds=10, personalize_steps=steps),
        run=tcfg.RunConfig(rounds_per_step=5))
    return j, t


def test_personalized_run_matches_fedtpus_run_experiment(capsys):
    """fedtpu's Dirichlet(0.3) non-IID config with 10 personalize steps,
    from fedtpu's init: the same history, personalized per-client metrics
    equal and client mean within 1e-6 of fedtpu's, the summary's
    personalized_client_mean and printed line as fedtpu's, and final_params
    the global model (fedtpu's within 1e-5), not a personalized one; with
    personalize_steps 0 there is no personalization."""
    j_cfg, t_cfg = _personalize_configs(10)
    rj = j_run(j_cfg, verbose=True)
    j_out = capsys.readouterr().out
    rt = t_run(t_cfg, verbose=True, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    t_out = capsys.readouterr().out
    assert rt.rounds_run == rj.rounds_run
    for k in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[k],
                                   rj.global_metrics[k], atol=1e-6)
        np.testing.assert_array_equal(
            rt.personalized_metrics["per_client"][k],
            np.asarray(rj.personalized_metrics["per_client"][k]))
        np.testing.assert_allclose(
            rt.personalized_metrics["client_mean"][k],
            rj.personalized_metrics["client_mean"][k], atol=1e-6)
    assert rt.summary()["personalized_client_mean"] == pytest.approx(
        rj.summary()["personalized_client_mean"], abs=1e-6)

    def line(out):
        return [l for l in out.splitlines() if l.startswith("Personalized")]
    assert len(line(t_out)) == 1 and line(t_out) == line(j_out)
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    exp = t_build(t_cfg, device="cpu", init_params=_fedtpu_init(j_cfg))
    assert exp.personalize_fn is not None
    off = t_run(t_cfg.replace(fed=dataclasses.replace(
        t_cfg.fed, personalize_steps=0)), verbose=False, device="cpu",
        init_params=_fedtpu_init(j_cfg))
    assert off.personalized_metrics == {}
    assert "personalized_client_mean" not in off.summary()
    for a, b in zip(jax.tree.leaves(off.final_params),
                    jax.tree.leaves(rt.final_params)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------ the ConvNet and the compute dtypes
# The CPU tests' ConvNet: 8x8x3 CIFAR-like images, channels (8, 16), hidden
# 32, 10 classes (cifar10-32's model at 1/4 of its side and channels).
CONV_IMAGE, CONV_CHANNELS, CONV_HIDDEN = (8, 8, 3), (8, 16), (32,)
CONV_ROWS = 200


@functools.lru_cache(maxsize=None)
def _conv_datasets(rows=CONV_ROWS):
    """fedtpu's and the port's Dataset of the same synthetic CIFAR-like
    8x8x3 rows (seed 11, flat NHWC), split as load_cifar10 splits them
    (the last fifth the test set)."""
    from fedtpu.data.cifar10 import synthetic_cifar_like
    from fedtpu.data.tabular import Dataset as JDataset
    from fedtpu_torch.data.tabular import Dataset as TDataset
    x, y = synthetic_cifar_like(rows, image_shape=CONV_IMAGE)
    x = x.reshape(rows, -1)
    n_test = rows // 5
    kw = dict(x_train=x[:-n_test], y_train=y[:-n_test], x_test=x[-n_test:],
              y_test=y[-n_test:], num_classes=10,
              feature_names=tuple(f"px{i}" for i in range(x.shape[1])),
              label_classes=np.arange(10))
    return JDataset(**kw), TDataset(**kw)


def _conv_configs(dtype="float32", clients=4, rounds=12, mesh=0, **fed):
    """fedtpu's and the port's config of the small ConvNet in ``dtype``;
    ``mesh`` > 0 lays the clients over that many shards on both sides."""
    def cfg(mod):
        return mod.ExperimentConfig(
            shard=mod.ShardConfig(num_clients=clients),
            model=mod.ModelConfig(kind="convnet", image_shape=CONV_IMAGE,
                                  conv_channels=CONV_CHANNELS,
                                  hidden_sizes=CONV_HIDDEN, num_classes=10,
                                  compute_dtype=dtype),
            fed=mod.FedConfig(rounds=rounds, **fed),
            run=mod.RunConfig(eval_test_every=4, mesh_devices=mesh))
    return cfg(jcfg), cfg(tcfg)


def _conv_both(j_cfg, t_cfg, **t_kw):
    """fedtpu's experiment and the port's from fedtpu's init."""
    j_ds, t_ds = _conv_datasets()
    j_exp = j_build(j_cfg, dataset=j_ds)
    t_exp = t_build(t_cfg, dataset=t_ds, device="cpu",
                    init_params=_np(j_exp.state["params"]), **t_kw)
    return j_exp, t_exp


# bf16 against fedtpu's bf16. A bf16 product or sum rounded in another
# order moves a logit by up to one bf16 ulp (2^-8 relative) and the CE loss
# by as much: BF16_LOSS_ATOL is that at logits below ~0.25 (measured:
# ConvNet 5.2e-5 over 3 rounds, 1.1e-4 over 12; income-8's MLP 1.5e-4).
# Adam turns a near-zero gradient entry of either sign into a step of up
# to lr, so a param may sit up to 2 lr off; the median param is what tells
# bf16 from fp32 (ConvNet, round 3: 3.4e-6 from fedtpu's bf16 run, 3.0e-5
# from its fp32 one).
BF16_LOSS_ATOL, BF16_MEDIAN_ATOL = 1e-3, 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnet_rounds_match_fedtpu(dtype):
    """The ConvNet (8x8x3, channels (8, 16), hidden 32, 10 classes, 4
    clients) through build_round_fn against fedtpu's round, fedtpu's init
    injected, 3 rounds: per-client metrics of the trained models equal;
    fp32: losses within 1e-6, params within 1e-5 (Adam's first step turns
    fp32 rounding noise in a near-zero gradient into ~2e-6); bf16:
    losses within BF16_LOSS_ATOL, every param within 2 lr and the median
    within BF16_MEDIAN_ATOL."""
    j_cfg, t_cfg = _conv_configs(dtype)
    j_exp, t_exp = _conv_both(j_cfg, t_cfg)
    assert t_exp.model.kind == "convnet" and t_exp.dims is None
    lr = t_cfg.optim.learning_rate
    j_state, j_step = j_exp.state, j_exp.make_step(1)
    t_state, t_step = t_exp.state, t_exp.make_step(1)
    for _ in range(3):
        j_state, jm = j_step(j_state, j_exp.batch)
        t_state, raw = t_step(t_state, t_exp.batch)
        tm = metrics_from_confusion(raw["conf"][0])
        for k in METRIC_NAMES:
            np.testing.assert_allclose(tm[k].numpy(),
                                       np.asarray(jm["per_client"][k]),
                                       atol=1e-6)
        want = _flat(j_state["params"])
        got = t_state["params"].numpy()
        loss_err = np.abs(raw["loss"][0].numpy() - np.asarray(jm["loss"]))
        if dtype == "float32":
            assert loss_err.max() <= 1e-6
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert loss_err.max() <= BF16_LOSS_ATOL
            assert np.abs(got - want).max() <= 2 * lr
            assert np.median(np.abs(got - want)) <= BF16_MEDIAN_ATOL
    assert bool((t_state["opt_state"]["count"] == 3).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnet_run_matches_fedtpu(dtype):
    """run_experiment on the small ConvNet against fedtpu's, fedtpu's init
    injected: the same stop round (both stop early on the plateau), the
    client-mean and held-out histories equal; losses and final params
    within 1e-6 / 1e-5 in fp32, and in bf16 within BF16_LOSS_ATOL and
    2 lr (12 rounds: measured 1.1e-4 and 5.9e-3)."""
    j_cfg, t_cfg = _conv_configs(dtype, rounds=30)
    j_ds, t_ds = _conv_datasets()
    init = _np(j_build(j_cfg, dataset=j_ds).state["params"])
    rj = j_run(j_cfg, dataset=j_ds, verbose=False)
    rt = t_run(t_cfg, dataset=t_ds, verbose=False, device="cpu",
               init_params=init)
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    assert rt.stopped_early and rt.rounds_run < 30
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=1e-6)
        assert len(rt.test_metrics[name]) == len(rj.test_metrics[name]) > 0
        np.testing.assert_allclose(rt.test_metrics[name],
                                   rj.test_metrics[name], atol=1e-6)
    lr = t_cfg.optim.learning_rate
    loss_tol, param_tol = ((1e-6, 1e-5) if dtype == "float32"
                           else (BF16_LOSS_ATOL, 2 * lr))
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               rtol=0, atol=loss_tol)
    assert jax.tree.structure(rt.final_params) == jax.tree.structure(
        _np(rj.final_params))
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=param_tol)


def test_convnet_int8_round_matches_fedtpu():
    """One int8-exchange round of the ConvNet over 8 shards (8 clients):
    one scale per shard and per ConvNet leaf, the global within one
    quantization step per element of fedtpu's (as
    test_int8_exchange_matches_fedtpu_within_a_quantization_step holds the
    MLP), every slot the global."""
    from fedtpu_torch.training.client import make_local_train_step
    j_cfg, t_cfg = _conv_configs(clients=8, mesh=8, compress="int8")
    j_exp, t_exp = _conv_both(j_cfg, t_cfg)
    assert t_exp.mesh.num_shards == 8
    start = t_exp.state["params"]
    trained, _, _ = make_local_train_step(t_exp.model, t_exp.tx)(
        start, t_exp.state["opt_state"], *(t_exp.batch[k] for k in (
            "x", "y", "mask")))
    w = t_exp.client_weights
    partial = ((trained - start) * w[:, None]).numpy()
    step = np.concatenate([
        np.full(b - a, np.abs(partial[:, a:b]).max() / 127 / float(w.sum()))
        for a, b in t_exp.model.leaf_bounds])
    j_state, _ = j_exp.make_step(1)(j_exp.state, j_exp.batch)
    t_state, _ = t_exp.make_step(1)(t_exp.state, t_exp.batch)
    p = t_state["params"]
    assert torch.equal(p, p[:1].expand_as(p))
    assert np.all(np.abs(p[0].numpy() - _flat(j_state["params"])[0])
                  <= step + 1e-6)


def test_convnet_dp_round_matches_fedtpu():
    """One DP-FedAvg round of the ConvNet (clip 0.05, noise multiplier 1,
    uniform weights) with fedtpu's unit normals injected, mapped onto the
    flat layout by leaf path (fedtpu orders the leaves convs.* < dense <
    head and b before w): params and the server state within 1e-5."""
    j_cfg, t_cfg = _conv_configs(clients=8, weighting="uniform",
                                 dp_clip_norm=DP_CLIP,
                                 dp_noise_multiplier=1.0)
    j_ds, _ = _conv_datasets()
    j_exp = j_build(j_cfg, dataset=j_ds)
    template = jax.tree.map(lambda p: np.zeros(p.shape[1:], np.float32),
                            _np(j_exp.state["params"]))

    def noise(r):
        delta, count = _fedtpu_noise_draw(j_cfg.fed.dp_seed, template, r)
        return np.concatenate((_flat(delta), [np.float32(count)]))

    j_exp, t_exp = _conv_both(j_cfg, t_cfg, dp_noise=noise)
    j_state, _ = j_exp.make_step(1)(j_exp.state, j_exp.batch)
    t_state, _ = t_exp.make_step(1)(t_exp.state, t_exp.batch)
    start = t_exp.state["params"][0].numpy()
    moved = np.abs(t_state["params"][0].numpy() - start).max()
    assert moved > 1e-3          # the noise (std 0.05 / 8) moved the model
    np.testing.assert_allclose(t_state["params"].numpy(),
                               _flat(j_state["params"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_state["server_opt_state"]["m"].numpy(),
                               _flat(j_state["server_opt_state"]["m"]),
                               rtol=0, atol=1e-5)


def test_income_mlp_in_bfloat16_matches_fedtpu():
    """income-8's MLP at compute_dtype='bfloat16' against fedtpu's run from
    fedtpu's init: the same stop round; the client-mean histories within
    0.01 (bf16 logits tie often: a row of a 51-row shard that crosses a tie
    moves the client mean by 0.0049, measured once), losses within
    BF16_LOSS_ATOL, final params within 2 lr; fp32 and bf16 runs differ
    (the dtype took effect)."""
    j_cfg, t_cfg = _configs()
    j_cfg = j_cfg.replace(model=jcfg.ModelConfig(compute_dtype="bfloat16"))
    t_cfg = t_cfg.replace(model=tcfg.ModelConfig(compute_dtype="bfloat16"))
    init = _fedtpu_init(j_cfg)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu", init_params=init)
    assert (rt.rounds_run, rt.stopped_early) == (rj.rounds_run,
                                                 rj.stopped_early)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(rt.global_metrics[name],
                                   rj.global_metrics[name], atol=0.01)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               rtol=0, atol=BF16_LOSS_ATOL)
    lr = t_cfg.optim.learning_rate
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)
    fp32 = t_run(t_cfg.replace(model=tcfg.ModelConfig()), verbose=False,
                 device="cpu", init_params=init)
    assert not np.array_equal(np.stack(fp32.loss[:3]),
                              np.stack(rt.loss[:3]))


@pytest.mark.parametrize("kind,dtype,kernels", [
    ("mlp", "float32", True), ("mlp", "bfloat16", False),
    ("convnet", "float32", False), ("convnet", "bfloat16", False)])
def test_eval_route_is_fixed_by_the_config(monkeypatch, kind, dtype,
                                           kernels):
    """K2 (in-round eval) and K3 (held-out forward) take only the float32
    MLP, like their Pallas originals: any other model is evaluated through
    its own forward and confusion_matrix, decided when the round is built
    (the kernels' wrappers are never called for it)."""
    from fedtpu_torch.parallel import round as round_mod
    from fedtpu_torch.training import client as client_mod
    calls = {"K2": 0, "K3": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(client_mod, "fused_eval_confusion",
                        counted("K2", client_mod.fused_eval_confusion))
    monkeypatch.setattr(round_mod, "fused_mlp_forward",
                        counted("K3", round_mod.fused_mlp_forward))
    if kind == "mlp":
        _, t_cfg = _configs(eval_test_every=1)
        t_cfg = t_cfg.replace(
            data=tcfg.DataConfig(synthetic_rows=256),
            model=tcfg.ModelConfig(compute_dtype=dtype),
            fed=tcfg.FedConfig(rounds=4))
        ds = None
    else:
        _, t_cfg = _conv_configs(dtype, rounds=4)
        ds = _conv_datasets()[1]
    res = t_run(t_cfg, dataset=ds, verbose=False, device="cpu")
    assert res.rounds_run == 4 and len(res.test_metrics["accuracy"]) > 0
    assert (calls["K2"] == 4 and calls["K3"] > 0) == kernels
    assert (calls["K2"] == calls["K3"] == 0) == (not kernels)


@pytest.mark.parametrize("field,model", [
    ("model.kind='convnet'", tcfg.ModelConfig(kind="convnet",
                                              image_shape=CONV_IMAGE,
                                              conv_channels=CONV_CHANNELS,
                                              hidden_sizes=CONV_HIDDEN)),
    ("model.compute_dtype='bfloat16'",
     tcfg.ModelConfig(compute_dtype="bfloat16"))])
def test_fused_round_refuses_other_models(field, model):
    """K5 computes the float32 MLP: its benchmark and its wrapper refuse
    the ConvNet and a bf16 compute dtype, naming the field."""
    _, t_cfg = _configs()
    cfg = t_cfg.replace(model=model)
    with pytest.raises(ValueError, match=field):
        mega.run(cfg, device="cpu", rounds=1)
    ds = _conv_datasets()[1] if model.kind == "convnet" else None
    exp = t_build(cfg.replace(data=tcfg.DataConfig(synthetic_rows=128)),
                  dataset=ds, device="cpu")
    opt = exp.state["opt_state"]
    with pytest.raises(ValueError, match=field):
        ck.fused_round(exp.state["params"], opt["mu"], opt["nu"],
                       opt["count"], exp.batch["x"], exp.batch["y"],
                       exp.batch["mask"], exp.client_weights, exp.model,
                       t_cfg.optim)


def test_compute_dtype_and_csv_flags_set_fedtpus_fields(capsys):
    """--compute-dtype sets ModelConfig.compute_dtype and --csv clears the
    preset's dataset_name, as fedtpu's flags do; cifar10-32 runs from the
    CLI on the CPU."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser, config_from_args
    from fedtpu_torch.cli import main
    for argv in (["run", "--preset", "cifar10-32", "--compute-dtype",
                  "float32"],
                 ["run", "--preset", "cifar10-32", "--csv", ""],
                 ["sweep", "--compute-dtype", "bfloat16"]):
        j = _apply_overrides(jcfg.get_preset(argv[2]) if "--preset" in argv
                             else jcfg.ExperimentConfig(),
                             j_parser().parse_args(argv))
        t = config_from_args(t_parser().parse_args(argv))
        assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
        assert (t.data.dataset_name, t.data.csv_path) == (
            j.data.dataset_name, j.data.csv_path)
    with pytest.raises(SystemExit):
        t_parser().parse_args(["run", "--compute-dtype", "float16"])
    rc = main(["run", "--preset", "cifar10-32", "--platform", "cpu",
               "--synthetic-rows", "128", "--num-clients", "4", "--rounds",
               "2", "--quiet", "--json"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["rounds_run"] == 2


# ------------------------------------------------- the sklearn parity demo
def _parity_demos(j_cfg, t_cfg, verbose=True):
    """fedtpu's and the port's ``run_parity_demo`` on the same synthetic
    rows (both packages make them bit for bit), fedtpu's init injected into
    the port's part B; each summary with its stdout."""
    import contextlib
    import io
    from fedtpu.parity.sklearn_warmstart import run_parity_demo as j_demo
    from fedtpu_torch.parity.sklearn_warmstart import (
        run_parity_demo as t_demo)
    init = _fedtpu_init(j_cfg)
    outs = []
    for demo, cfg, kw in ((j_demo, j_cfg, {}),
                          (t_demo, t_cfg, dict(device="cpu",
                                               init_params=init))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = demo(cfg, verbose=verbose, **kw)
        outs.append((summary, buf.getvalue()))
    return outs


def _parity_configs(**over):
    j_cfg = jcfg.get_preset("sklearn-parity")
    j_cfg = j_cfg.replace(data=dataclasses.replace(j_cfg.data,
                                                   csv_path=None))
    t_cfg = tcfg.get_preset("sklearn-parity")
    for key, value in over.items():
        section, field = key.split("__")
        j_cfg, t_cfg = (cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **{field: value})})
            for cfg in (j_cfg, t_cfg))
    return j_cfg, t_cfg


def _parity_lines(out: str) -> list:
    lines = out.splitlines()
    at = lines.index("Final Global Weight Statistics:")
    return lines[at - 1:at + 13]


def test_parity_demo_matches_fedtpus():
    """The sklearn-parity preset at full width (4 clients, 14->50->400->2,
    5 uniform rounds). Part A on the numpy MLPClassifier: fedtpu's pooled
    metrics per round, ``limitation_demonstrated`` and final global weight
    statistics, all exactly; the reference's "Final Global Weight
    Statistics" block and the ``[sklearn] round r`` lines byte for byte.
    Part B, the port's round from fedtpu's init: fedtpu's rounds_run, its
    pooled metrics and final weight statistics within 1e-6 (the fp32
    tolerances of ROADMAP.md)."""
    pytest.importorskip("sklearn")
    (j_sum, j_out), (t_sum, t_out) = _parity_demos(*_parity_configs())
    assert t_sum["sklearn"] == j_sum["sklearn"]
    assert t_sum["limitation_demonstrated"] is j_sum[
        "limitation_demonstrated"] is True
    assert [s["shape"] for s in t_sum["sklearn"]["global_weight_stats"]] == [
        [14, 50], [50, 400], [400, 1], [50], [400], [1]]
    assert _parity_lines(t_out) == _parity_lines(j_out)
    assert _parity_lines(t_out)[:2] == ["", "Final Global Weight Statistics:"]
    sk = [line for line in j_out.splitlines() if line.startswith("[sklearn]")]
    assert len(sk) == 5
    assert [line for line in t_out.splitlines()
            if line.startswith("[sklearn]")] == sk
    jb, tb = j_sum["fedtpu"], t_sum["fedtpu"]
    assert tb["rounds_run"] == jb["rounds_run"] == 5
    for k in METRIC_NAMES:
        np.testing.assert_allclose(tb["pooled_metrics"][k],
                                   jb["pooled_metrics"][k], atol=1e-6)
    for a, b in zip(tb["global_weight_stats"], jb["global_weight_stats"],
                    strict=True):
        assert a["shape"] == b["shape"]
        assert a["mean"] == pytest.approx(b["mean"], abs=1e-6)
        assert a["std"] == pytest.approx(b["std"], abs=1e-6)
    assert t_sum["fedtpu_uses_global_weights"] is True


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    return None


def test_cli_parity_json_has_fedtpus_keys(capsys):
    """``parity --json`` on the CPU prints one JSON line with fedtpu's
    summary keys; ``--quiet`` prints nothing else (at a reduced width: the
    keys do not depend on it)."""
    pytest.importorskip("sklearn")
    from fedtpu_torch.cli import main
    (j_sum, _), _ = _parity_demos(*_parity_configs(
        shard__num_clients=2, fed__rounds=2, model__hidden_sizes=(8,),
        data__synthetic_rows=256), verbose=False)
    assert main(["parity", "--preset", "sklearn-parity", "--platform", "cpu",
                 "--num-clients", "2", "--rounds", "2", "--hidden-sizes",
                 "8", "--synthetic-rows", "256", "--json", "--quiet"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    summary = json.loads(out[0])
    assert _key_tree(summary) == _key_tree(json.loads(json.dumps(
        j_sum, default=float)))
    assert summary["fedtpu"]["rounds_run"] == 2
    assert summary["sklearn"] == json.loads(json.dumps(j_sum["sklearn"],
                                                       default=float))


# ------------------------------------------------------------- param_dtype
def _dtype_configs(dtype, clients=8, mesh=0, optim=None, rows=ROWS,
                   rounds=3, **fed):
    optim = optim or {}
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=rows),
        shard=jcfg.ShardConfig(num_clients=clients),
        model=jcfg.ModelConfig(param_dtype=dtype),
        optim=jcfg.OptimConfig(**optim),
        fed=jcfg.FedConfig(rounds=rounds, **fed),
        run=jcfg.RunConfig(mesh_devices=mesh))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=rows),
        shard=tcfg.ShardConfig(num_clients=clients),
        model=tcfg.ModelConfig(param_dtype=dtype),
        optim=tcfg.OptimConfig(**optim),
        fed=tcfg.FedConfig(rounds=rounds, **fed),
        run=tcfg.RunConfig(mesh_devices=mesh))
    return j, t


def _leaf_ulps(ours: torch.Tensor, theirs, model) -> float:
    """The largest |ours - theirs| of each leaf in units of the param
    dtype's ulp at that leaf's largest magnitude, over the leaves; the two
    must be non-finite at the same entries."""
    a = ours.to(torch.float32).numpy()
    b = convert.params_from_jax(_np(theirs)).to(torch.float32).numpy()
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    mant = {torch.bfloat16: 7, torch.float16: 10,
            torch.float32: 23}[model.param_dtype]
    worst = 0.0
    for lo, hi in model.leaf_bounds:
        x, y = a[..., lo:hi], b[..., lo:hi]
        fin = np.isfinite(y)
        if not fin.any() or not np.abs(y[fin]).max():
            continue
        ulp = 2.0 ** (np.floor(np.log2(np.abs(y[fin]).max())) - mant)
        worst = max(worst, float(np.abs(x - y)[fin].max() / ulp))
    return worst


# Each branch fedtpu's synchronous round takes, at bfloat16 params (fedtpu's
# configs): the largest difference over 3 rounds, in bfloat16 ulps at each
# leaf's largest magnitude, of params and optimizer state, measured against
# fedtpu's build_round_fn on the CPU. The limit is ROADMAP's 4 ulps.
DTYPE_CASES = {
    # E = 1, every client: fedtpu reduces and evaluates p + u unrounded;
    # the port does too (wide), so only K1's weight normalisation is left.
    "psum": (dict(), 0.125),
    "psum sampled": (dict(participation_rate=0.5, participation_seed=5),
                     0.0),
    "ring": (dict(clients=16, mesh=8, aggregation="ring"), 0.0),
    "local steps and fedprox": (dict(local_steps=3, prox_mu=0.1), 0.0625),
    "fedavgm": (dict(weighting="uniform", server_opt="fedavgm"), 0.5),
    "dp": (dict(weighting="uniform", dp_clip_norm=DP_CLIP,
                dp_noise_multiplier=1.0), 1.5),
    # fedtpu's own pinned bf16 case (tests/test_scaffold.py).
    "scaffold sgd": (dict(weighting="uniform", scaffold=True, local_steps=2,
                          optim=dict(name="sgd", learning_rate=0.05,
                                     momentum=0.0)), 0.25),
    "int8": (dict(compress="int8", mesh=8), 1.0),
    "median": (dict(weighting="uniform", robust_aggregation="median"), 1.0),
    "krum byzantine": (dict(weighting="uniform", robust_aggregation="krum",
                            krum_f=1, byzantine_clients=1), 0.0),
}


@pytest.mark.parametrize("case", list(DTYPE_CASES))
def test_bf16_param_rounds_match_fedtpu(case):
    """3 rounds of ``case`` at bfloat16 params against fedtpu's
    build_round_fn from fedtpu's init (its masks and DP noise injected):
    every per-client buffer stays bfloat16, the server optimizer's state
    float32; params and Adam's / SGD's state within 4 bfloat16 ulps at each
    leaf's scale (the measured value is DTYPE_CASES'), SCAFFOLD's variates
    too; losses within 2e-5 (measured: 7e-6, the int8 case) and per-client
    metrics within 1e-6, so the confusion counts are equal."""
    kw, measured = DTYPE_CASES[case]
    j_cfg, t_cfg = _dtype_configs("bfloat16", **kw)
    sampled = j_cfg.fed.participation_rate < 1.0
    j_exp = j_build(j_cfg)
    j_state, j_step = j_exp.state, j_exp.make_step(1)
    t_exp = t_build(
        t_cfg, device="cpu", init_params=_np(j_state["params"]),
        participation_masks=_fedtpu_masks(j_cfg) if sampled else None,
        dp_noise=(_fedtpu_noise(j_cfg) if j_cfg.fed.dp_noise_multiplier
                  else None))
    t_state, t_step = t_exp.state, t_exp.make_step(1)
    model = t_exp.model
    worst = 0.0
    for _ in range(3):
        j_state, j_raw = j_step(j_state, j_exp.batch)
        t_state, t_raw = t_step(t_state, t_exp.batch)
        opt = t_state["opt_state"]
        pairs = [(t_state["params"], j_state["params"])]
        if "mu" in opt:
            pairs += [(opt["mu"], j_state["opt_state"][0].mu),
                      (opt["nu"], j_state["opt_state"][0].nu)]
        else:
            pairs += [(opt["trace"], j_state["opt_state"][0].trace)]
        if "client_cv" in t_state:
            pairs += [(t_state["client_cv"], j_state["client_cv"]),
                      (t_state["server_cv"], j_state["server_cv"])]
        for ours, _ in pairs:
            assert ours.dtype == torch.bfloat16
        for v in t_state.get("server_opt_state", {}).values():
            assert v.dtype == torch.float32
        worst = max(worst, *(_leaf_ulps(o, t, model) for o, t in pairs))
        np.testing.assert_allclose(t_raw["loss"][0].numpy(),
                                   np.asarray(j_raw["loss"]).reshape(-1),
                                   atol=2e-5)
        per_client = metrics_from_confusion(t_raw["conf"][0])
        for k in METRIC_NAMES:
            np.testing.assert_allclose(
                per_client[k].numpy(),
                np.asarray(j_raw["per_client"][k]).reshape(-1), atol=1e-6)
    assert worst <= 4.0, (case, worst, measured)


def _income8_16bit_runs(dtype):
    """fedtpu's and the port's income-8 runs (the synthetic 2,048 rows, 40
    rounds, a held-out eval every 5) at ``dtype`` params, fedtpu's init
    injected."""
    j_cfg, t_cfg = _dtype_configs(dtype, rows=2048, rounds=40)
    j_cfg, t_cfg = (cfg.replace(run=dataclasses.replace(
        cfg.run, eval_test_every=5)) for cfg in (j_cfg, t_cfg))
    init = _fedtpu_init(j_cfg)
    return (j_run(j_cfg, verbose=False),
            t_run(t_cfg, verbose=False, device="cpu", init_params=init))


def test_fp16_income8_diverges_where_fedtpu_does():
    """float16 params: Adam's eps (1e-8) is 0 in float16, so a second
    moment that underflows divides by 0; both runs halt after round 1
    (stopped_early, diverged) with non-finite final params, the same
    entries non-finite."""
    rj, rt = _income8_16bit_runs("float16")
    assert rj.rounds_run == rt.rounds_run == 1
    assert rj.stopped_early and rt.stopped_early
    assert rj.diverged and rt.diverged
    ours = [np.asarray(a, np.float32)
            for a in jax.tree.leaves(rt.final_params)]
    theirs = [np.asarray(b).astype(np.float32)
              for b in jax.tree.leaves(_np(rj.final_params))]
    assert not all(np.isfinite(b).all() for b in theirs)
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(rt.loss[0], rj.loss[0], atol=1e-6)


def test_bf16_income8_stops_at_fedtpus_round():
    """bfloat16 params: the early stop at fedtpu's round (15 here), the
    per-round losses within 1e-4, the per-client metrics within 1e-6 (the
    confusion counts equal in every round), the held-out metrics at rounds
    5 and 10 (the model's own bfloat16 forward, not K3; the stop comes
    before round 15's) within 1e-6, and the final
    bfloat16 params within 4 ulps at each leaf's scale."""
    rj, rt = _income8_16bit_runs("bfloat16")
    assert rt.stopped_early and rj.stopped_early and not rt.diverged
    assert rt.rounds_run == rj.rounds_run == 15
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-4)
    for k in METRIC_NAMES:
        np.testing.assert_allclose(np.stack(rt.per_client_metrics[k]),
                                   np.stack(rj.per_client_metrics[k]),
                                   atol=1e-6)
        assert len(rt.test_metrics[k]) == len(rj.test_metrics[k]) == 2
        np.testing.assert_allclose(rt.test_metrics[k], rj.test_metrics[k],
                                   atol=1e-6)
    model = t_build(_dtype_configs("bfloat16")[1], device="cpu").model
    flat = convert.params_from_jax(rt.final_params).to(torch.bfloat16)
    assert _leaf_ulps(flat, rj.final_params, model) <= 4.0


def test_bf16_personalized_run_matches_fedtpus():
    """bfloat16 params with 5 personalize steps after 3 rounds: the
    personalized per-client metrics within 1e-6 of fedtpu's (equal
    counts), fedtpu's init injected."""
    j_cfg, t_cfg = _dtype_configs("bfloat16", personalize_steps=5)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_init(j_cfg))
    for k in METRIC_NAMES:
        np.testing.assert_allclose(
            rt.personalized_metrics["per_client"][k],
            np.asarray(rj.personalized_metrics["per_client"][k]), atol=1e-6)


def test_fp32_warm_start_is_cast_into_16_bit_slots_as_fedtpus(tmp_path):
    """A float32 weights artifact (fedtpu's save_best_weights) warm-starts
    a bfloat16 and a float16 run: every slot is fedtpu's own warm start
    bit for bit, the artifact rounded once to the slot dtype."""
    from fedtpu.models.mlp import mlp_init as j_mlp_init
    from fedtpu.sweep.grid import save_best_weights as j_write
    weights = _np(j_mlp_init(jax.random.key(5), 14, (50, 200), 2))
    path = str(tmp_path / "best.npz")
    j_write(path, _best(weights))
    for dtype in ("bfloat16", "float16"):
        j_cfg, t_cfg = _dtype_configs(dtype, init_weights_npz=path)
        j_params = convert.params_from_jax(_np(j_build(j_cfg).state[
            "params"]))
        t_params = t_build(t_cfg, device="cpu").state["params"]
        assert t_params.dtype == j_params.dtype == getattr(torch, dtype)
        assert torch.equal(t_params.view(torch.int16),
                           j_params.view(torch.int16))
        assert torch.equal(t_params[0], convert.params_from_jax(
            weights).to(t_params.dtype))


def test_bf16_checkpoint_resumes_bitwise(tmp_path):
    """A bfloat16 run checkpointed at round 10 and resumed to 20: the
    checkpoint holds bfloat16 params and moments, and the resumed run's
    history and final params equal the uninterrupted 20 rounds bit for
    bit; a float32 config refuses the bfloat16 checkpoint."""
    def cfg(tmp, rounds):
        return _ck_config(tmp, rounds).replace(
            model=tcfg.ModelConfig(param_dtype="bfloat16"))

    full = t_run(cfg(tmp_path / "a", 20), verbose=False, device="cpu")
    ck = tmp_path / "b"
    t_run(cfg(ck, 10), verbose=False, device="cpu")
    raw, _, at = load_checkpoint_raw(str(ck))
    assert at == 10 and raw["params"].dtype == torch.bfloat16
    assert raw["opt_state"]["mu"].dtype == torch.bfloat16
    resumed = t_run(cfg(ck, 20), verbose=False, device="cpu", resume=True)
    assert resumed.global_metrics == full.global_metrics
    np.testing.assert_array_equal(np.stack(resumed.loss),
                                  np.stack(full.loss[10:]))
    for a, b in zip(jax.tree.leaves(resumed.final_params),
                    jax.tree.leaves(full.final_params), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="resume mismatch"):
        t_run(_ck_config(ck, 30), verbose=False, device="cpu", resume=True)


def test_grid_search_ignores_param_dtype():
    """fedtpu's grid builds its own float32 models and never reads
    ModelConfig.param_dtype; the port's neither: a bfloat16 config gives
    the float32 config's results, in both packages."""
    from fedtpu.sweep.grid import run_grid_search as j_grid
    j_cfg, t_cfg = _sweep_configs()
    kw = dict(hidden_grid=((2,),), lr_grid=(0.01,), local_steps=5,
              keep_weights=True, verbose=False)
    for grid, cfg, extra in (
            (j_grid, j_cfg, {}),
            (t_grid.run_grid_search, t_cfg, dict(device="cpu"))):
        plain = grid(cfg, **kw, **extra)
        other = grid(cfg.replace(model=dataclasses.replace(
            cfg.model, param_dtype="bfloat16")), **kw, **extra)
        assert other["metrics"] == plain["metrics"]
        for a, b in zip(jax.tree.leaves(_np(other["weights"])),
                        jax.tree.leaves(_np(plain["weights"])), strict=True):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_fused_round_refuses_16_bit_params():
    """K5's driver refuses a bfloat16 or float16 param dtype, naming the
    field, as it refuses a bfloat16 compute dtype."""
    _, t_cfg = _configs()
    for dtype in ("bfloat16", "float16"):
        cfg = t_cfg.replace(model=tcfg.ModelConfig(param_dtype=dtype))
        with pytest.raises(ValueError, match=rf"model\.param_dtype="
                                             rf"'{dtype}'"):
            mega.run(cfg, device="cpu", rounds=1)


# ------------------------------------- the asynchronous engine (A8a)
# The port's FedBuff engine (fedtpu_torch.parallel.async_fed) against
# fedtpu's on the CPU. Both sides start from fedtpu's own state (its
# anchors, params, Adam moments and pull ticks, carried across by
# fedtpu_torch.convert) and see the same arrivals: fedtpu's Bernoulli
# draws, recomputed with its own expression and injected into the port.
# Eight clients on fedtpu's 8-device CPU mesh, a (16, 8) MLP on 256
# synthetic rows, at most 24 ticks a run. The pins are fedtpu's
# (tests/test_async.py, tests/test_robust_defense.py).
C = 8
ASYNC_HIDDEN = (16, 8)
ARRIVAL_RATE, ARRIVAL_SEED = 0.4, 1


@functools.lru_cache(maxsize=None)
def _async_batches(strategy="contiguous"):
    """fedtpu's test data (256 rows, 6 features) over 8 clients: fedtpu's
    sharded batch and the port's."""
    x, y = synthetic_income_like(256, 6, 2, seed=0)
    packed = pack_clients(x, y, jcfg.ShardConfig(
        num_clients=C, shuffle=False, strategy=strategy,
        dirichlet_alpha=0.3))
    mesh = make_mesh(num_clients=C)
    arrays = {"x": packed.x, "y": packed.y, "mask": packed.mask}
    j_batch = {k: jax.device_put(v, client_sharding(mesh))
               for k, v in arrays.items()}
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    return mesh, j_batch, t_batch


@functools.lru_cache(maxsize=None)
def _async_models(dtype="float32"):
    init_fn, apply_fn = build_model(jcfg.ModelConfig(
        input_dim=6, hidden_sizes=ASYNC_HIDDEN, param_dtype=dtype))
    model = t_model(tcfg.ModelConfig(input_dim=6, hidden_sizes=ASYNC_HIDDEN,
                                     param_dtype=dtype))
    return init_fn, apply_fn, model


@functools.lru_cache(maxsize=None)
def _arrival_draws(seed, rate, num_clients=C):
    """fedtpu's synthetic arrivals, by its own expression
    (async_fed.py:279-286): uniform(fold_in(fold_in(key(seed), tick),
    client)) < rate."""
    clients = jnp.arange(num_clients)

    @jax.jit
    def draw(r):
        tick_key = jax.random.fold_in(jax.random.key(seed), r)
        u = jax.vmap(lambda i: jax.random.uniform(
            jax.random.fold_in(tick_key, i)))(clients)
        return (u < rate).astype(jnp.float32)

    return lambda r: np.asarray(draw(r))


def _j_state(dtype="float32", **kw):
    init_fn, _, _ = _async_models(dtype)
    mesh = _async_batches()[0]
    return j_async.init_async_state(
        jax.random.key(0), mesh, C, init_fn,
        build_optimizer(jcfg.OptimConfig()), **kw)


def _to_port(j_state) -> dict:
    """fedtpu's async state, every entry carried across."""
    s = _np(j_state)
    adam = s["opt_state"][0]
    out = {"params": convert.params_from_jax(s["params"]),
           "anchors": convert.params_from_jax(s["anchors"]),
           "opt_state": convert.adam_state_from_jax(adam.mu, adam.nu,
                                                    adam.count),
           "pull_tick": torch.from_numpy(np.array(s["pull_tick"])),
           "round": int(s["round"])}
    if "buf_delta" in s:
        out["buf_delta"] = convert.params_from_jax(s["buf_delta"])
        out["buf_count"] = torch.tensor(np.array(s["buf_count"]))
    if "screen_norms" in s:
        out["screen_norms"] = torch.from_numpy(np.array(s["screen_norms"]))
        out["screen_count"] = torch.tensor(np.array(s["screen_count"]))
    return out


@functools.lru_cache(maxsize=None)
def _j_step(dtype="float32", **kw):
    _, apply_fn, _ = _async_models(dtype)
    return j_async.build_async_round_fn(
        _async_batches(kw.pop("strategy", "contiguous"))[0], apply_fn,
        build_optimizer(jcfg.OptimConfig()), 2, **kw)


def _t_step(dtype="float32", **kw):
    kw.pop("strategy", None)
    if not kw.get("driven"):
        kw["arrival_masks"] = _arrival_draws(kw.get("arrival_seed", 0),
                                             kw.get("arrival_rate", 0.5))
    return t_async.build_async_round_fn(
        _async_models(dtype)[2], t_optimizer(tcfg.OptimConfig()), 2, C, **kw)


def _assert_state_matches(t_state, j_state, atol=1e-5):
    theirs = _to_port(j_state)
    for key in ("params", "anchors"):
        np.testing.assert_allclose(t_state[key].float().numpy(),
                                   theirs[key].float().numpy(), atol=atol)
    for key in ("mu", "nu"):
        np.testing.assert_allclose(
            t_state["opt_state"][key].float().numpy(),
            theirs["opt_state"][key].float().numpy(), atol=atol)
    np.testing.assert_array_equal(t_state["opt_state"]["count"].numpy(),
                                  theirs["opt_state"]["count"].numpy())
    np.testing.assert_array_equal(t_state["pull_tick"].numpy(),
                                  theirs["pull_tick"].numpy())
    assert t_state["round"] == theirs["round"]
    if "buf_delta" in theirs:
        np.testing.assert_allclose(t_state["buf_delta"].numpy(),
                                   theirs["buf_delta"].numpy(), atol=atol)
        assert float(t_state["buf_count"]) == float(theirs["buf_count"])


def _assert_metrics_match(t_m, j_m, loss_atol=1e-5):
    np.testing.assert_array_equal(t_m["staleness"].numpy(),
                                  np.asarray(j_m["staleness"]))
    np.testing.assert_allclose(t_m["loss"].numpy(), np.asarray(j_m["loss"]),
                               atol=loss_atol)
    # Per-client metrics within 1e-6: at 32 rows a client, equal counts.
    for k in METRIC_NAMES:
        np.testing.assert_allclose(t_m["per_client"][k].numpy(),
                                   np.asarray(j_m["per_client"][k]),
                                   atol=1e-6)


def _all_equal(a: dict, b: dict) -> bool:
    ta, tb = t_async.async_state_tensors(a), t_async.async_state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def test_every_tick_sums_through_k1_once_and_twice_under_the_screen(
        monkeypatch):
    """The tick's discounted sum is one K1 sum-mode call a tick; the
    screen's direction is a second."""
    calls = []
    real = t_async.weighted_sum_clients
    monkeypatch.setattr(t_async, "weighted_sum_clients",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    _, _, t_batch = _async_batches()
    for screen, per_tick in ((False, 1), (True, 2)):
        calls.clear()
        step = _t_step(driven=True, screen=screen, ticks_per_step=3,
                       screen_window=4, screen_warmup=2)
        state = _to_port(_j_state(screen_window=4 if screen else 0))
        step(state, t_batch, np.ones((3, C), np.float32))
        assert len(calls) == 3 * per_tick


# ----------------------------------------------------- the tick, against
def test_rate1_no_discount_equals_the_synchronous_delta_path():
    """fedtpu's degenerate contract (tests/test_async.py:39) on the port:
    arrival rate 1, power 0, server_lr 1 is the port's own synchronous
    uniform delta path (identity server optimizer) from the same inits,
    within 1e-6, with staleness identically 0."""
    _, _, t_batch = _async_batches()
    model = _async_models()[2]
    tx = t_optimizer(tcfg.OptimConfig())
    gen = torch.Generator().manual_seed(0)
    inits = torch.stack([model.init(gen) for _ in range(C)])
    a_state = t_async.init_async_state(None, C, model, tx, params=inits)
    a_step = t_async.build_async_round_fn(model, tx, 2, C, arrival_rate=1.0,
                                          staleness_power=0.0,
                                          server_lr=1.0, ticks_per_step=7)
    a_state, a_m = a_step(a_state, t_batch)
    assert not a_m["staleness"].any()
    server = t_round.identity_server_optimizer()
    s_state = t_round.init_federated_state(None, C, model, tx, params=inits,
                                           server_opt=server)
    s_step = t_round.build_round_fn(model, tx, 2, torch.ones(C),
                                    rounds_per_step=7, weighting="uniform",
                                    server_opt=server)
    s_state, _ = s_step(s_state, t_batch)
    np.testing.assert_allclose(t_async.async_global_params(a_state).numpy(),
                               t_round.global_params(s_state).numpy(),
                               atol=1e-6)


def test_fedtpus_masks_in_its_driven_step_are_its_synthetic_run():
    """The injected masks are fedtpu's: its own driven step on them gives
    its synthetic run bit for bit (state and metrics), so the expression
    the tests recompute is fedtpu's draw, not just something the port
    agrees with."""
    _, j_batch, _ = _async_batches()
    draws = _arrival_draws(ARRIVAL_SEED, ARRIVAL_RATE)
    arrivals = np.stack([draws(r) for r in range(10)])
    synth, synth_m = _j_step(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED,
                             ticks_per_step=10)(_j_state(), j_batch)
    driven, driven_m = _j_step(driven=True, ticks_per_step=10)(
        _j_state(), j_batch, arrivals)
    for a, b in zip(jax.tree.leaves(_np((synth, synth_m))),
                    jax.tree.leaves(_np((driven, driven_m)))):
        np.testing.assert_array_equal(a, b)
    assert 0 < arrivals.sum() < arrivals.size


TICK_CASES = {
    "M=0": dict(buffer_size=0),
    "M=1": dict(buffer_size=1),
    "M=4": dict(buffer_size=4),
    "E=3 fedprox": dict(local_steps=3, prox_mu=0.01),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_synthetic_ticks_match_fedtpu(case):
    """10 synthetic ticks at rate 0.4 from fedtpu's state with fedtpu's
    masks: params, anchors and Adam's state within 1e-5, counts, pull
    ticks, the K-buffer's count and the staleness equal, losses within
    1e-5 and the confusion counts equal; M = 1 is the port's M = 0 bit for
    bit."""
    kw = dict(TICK_CASES[case], arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED,
              ticks_per_step=10)
    _, j_batch, t_batch = _async_batches()
    m = kw.get("buffer_size", 0)
    t_state = _to_port(_j_state(buffer_size=m))
    j_state, j_m = _j_step(**kw)(_j_state(buffer_size=m), j_batch)
    t_state, t_m = _t_step(**kw)(t_state, t_batch)
    _assert_state_matches(t_state, j_state)
    _assert_metrics_match(t_m, j_m)
    if m == 1:
        zero, _ = _t_step(**dict(kw, buffer_size=0))(
            _to_port(_j_state()), t_batch)
        assert _all_equal(t_state, zero)


def test_chunked_ticks_are_bitwise_tick_at_a_time():
    """ticks_per_step 3 (three chunks) against one tick a step (nine
    steps), with a K-buffer: every state tensor and every tick's loss,
    counts and staleness bit for bit; and within 1e-5 of fedtpu's."""
    _, j_batch, t_batch = _async_batches()
    kw = dict(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED, buffer_size=4)
    outs = {}
    for width in (1, 3):
        state, raws = _to_port(_j_state(buffer_size=4)), []
        step = _t_step(**kw, ticks_per_step=width)
        for _ in range(9 // width):
            state, raw = step.fn(state, t_batch)
            raws.append(raw)
        outs[width] = (state, {k: torch.cat([r[k] for r in raws])
                               for k in ("loss", "conf", "staleness")})
    assert _all_equal(outs[1][0], outs[3][0])
    for k in ("loss", "conf", "staleness"):
        assert torch.equal(outs[1][1][k], outs[3][1][k]), k
    j_state, _ = _j_step(**kw, ticks_per_step=9)(_j_state(buffer_size=4),
                                                 j_batch)
    _assert_state_matches(outs[3][0], j_state)


def _poison_schedule(ticks, start=12, scale=-8.0):
    """Honest 1.0 arrivals at rate 0.75 (seeded), and from tick ``start``
    two poisoned clients a tick at ``scale``."""
    rng = np.random.default_rng(3)
    arr = (rng.random((ticks, C)) < 0.75).astype(np.float32)
    for t in range(start, ticks):
        bad = rng.choice(C, 2, replace=False)
        arr[t, bad] = scale
    return arr


def test_driven_signed_weights_with_poisoned_clients_match_fedtpu():
    """Driven ticks whose arrivals carry signed weights (a poisoned
    client at -8, whose update still trains and ages): state within 1e-5,
    staleness equal, losses within 1e-5, counts equal."""
    _, j_batch, t_batch = _async_batches()
    arr = _poison_schedule(16, start=6)
    kw = dict(driven=True, ticks_per_step=16, buffer_size=3)
    j_state, j_m = _j_step(**kw)(_j_state(buffer_size=3), j_batch, arr)
    t_state, t_m = _t_step(**kw)(_to_port(_j_state(buffer_size=3)), t_batch,
                                 arr)
    _assert_state_matches(t_state, j_state)
    _assert_metrics_match(t_m, j_m)


def test_screen_and_clip_match_fedtpu():
    """24 driven ticks over label-skewed shards through the streaming
    screen (window 16, warm-up 8) with per-arrival clipping: the screened
    flags equal fedtpu's, at least one poisoned arrival is screened once
    the median is warm and no honest one is; norms and the ring within
    1e-5, the ring's count, the staleness and the accepted counts
    equal."""
    _, j_batch, t_batch = _async_batches("dirichlet")
    arr = _poison_schedule(24)
    kw = dict(driven=True, screen=True, screen_window=16, screen_warmup=8,
              clip_norm=0.5, ticks_per_step=24)
    j_state, j_m = _j_step(strategy="dirichlet", **kw)(
        _j_state(screen_window=16), j_batch, arr)
    t_state, t_m = _t_step(**kw)(_to_port(_j_state(screen_window=16)),
                                 t_batch, arr)
    scr = t_m["screened"].numpy()
    np.testing.assert_array_equal(scr, np.asarray(j_m["screened"]))
    assert scr[arr < 0].sum() >= 1 and not scr[arr > 0].any()
    np.testing.assert_allclose(t_m["update_norms"].numpy(),
                               np.asarray(j_m["update_norms"]), atol=1e-5)
    np.testing.assert_array_equal(t_m["accepted"].numpy(),
                                  np.asarray(j_m["accepted"]))
    np.testing.assert_allclose(t_state["screen_norms"].numpy(),
                               np.asarray(j_state["screen_norms"]),
                               atol=1e-5)
    assert int(t_state["screen_count"]) == int(j_state["screen_count"])
    _assert_state_matches(t_state, j_state)
    _assert_metrics_match(t_m, j_m)


# The tick's branches at bfloat16 params: fedtpu's kwargs and its state's.
BF16_CASES = {
    "E=1 K-buffer": (dict(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED,
                          buffer_size=4, ticks_per_step=8),
                     dict(buffer_size=4)),
    "E=3 K-buffer": (dict(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED,
                          buffer_size=4, local_steps=3, ticks_per_step=8),
                     dict(buffer_size=4)),
    "driven screen clip": (dict(driven=True, screen=True, screen_window=16,
                                screen_warmup=8, clip_norm=0.5,
                                ticks_per_step=24, strategy="dirichlet"),
                           dict(screen_window=16)),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_ticks_match_fedtpu_within_four_ulps(case):
    """bfloat16 params on each branch of the tick: params, anchors and
    moments within 4 bfloat16 ulps at each leaf's largest magnitude,
    losses within 2e-5, per-client metrics within 1e-6 (and the screened
    flags equal). At one local step the port trains ``wide``: fedtpu's
    compiled tick takes the trained params' float32 p + u into the delta
    unrounded. Measured on this CPU: 0 ulps on every branch; without
    ``wide`` 1 to 6."""
    kw, state_kw = BF16_CASES[case]
    strategy = kw.get("strategy", "contiguous")
    _, j_batch, t_batch = _async_batches(strategy)
    model = _async_models("bfloat16")[2]
    arrivals = (_poison_schedule(24),) if kw.get("driven") else ()
    t_state = _to_port(_j_state("bfloat16", **state_kw))
    j_state, j_m = _j_step("bfloat16", **kw)(
        _j_state("bfloat16", **state_kw), j_batch, *arrivals)
    t_state, t_m = _t_step("bfloat16", **kw)(t_state, t_batch, *arrivals)
    adam = j_state["opt_state"][0]
    for ours, mine in ((t_state["params"], j_state["params"]),
                       (t_state["anchors"], j_state["anchors"]),
                       (t_state["opt_state"]["mu"], adam.mu),
                       (t_state["opt_state"]["nu"], adam.nu)):
        assert ours.dtype == torch.bfloat16
        assert _leaf_ulps(ours, mine, model) <= 4.0
    _assert_metrics_match(t_m, j_m, loss_atol=2e-5)
    if "screened" in t_m:
        np.testing.assert_array_equal(t_m["screened"].numpy(),
                                      np.asarray(j_m["screened"]))


def test_fp16_ticks_go_non_finite_where_fedtpus_do():
    """float16 params: Adam's eps is 0 in float16, so the first tick goes
    non-finite; the port's params, anchors, moments and losses are
    non-finite at fedtpu's entries, the staleness equal. The run halts
    there (run_experiment's non-finite guard), at fedtpu's tick, with the
    same non-finite final params. (Past that tick the two spread NaN
    differently through training: ROADMAP section C.)"""
    _, j_batch, t_batch = _async_batches()
    kw = dict(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED, ticks_per_step=1)
    j_state, j_m = _j_step("float16", **kw)(_j_state("float16"), j_batch)
    t_state, t_m = _t_step("float16", **kw)(_to_port(_j_state("float16")),
                                            t_batch)
    theirs = _to_port(j_state)
    assert not torch.isfinite(theirs["params"]).all()
    for ours, mine in ((t_state["params"], theirs["params"]),
                       (t_state["anchors"], theirs["anchors"]),
                       (t_state["opt_state"]["mu"], theirs["opt_state"]["mu"]),
                       (t_state["opt_state"]["nu"], theirs["opt_state"]["nu"])):
        assert ours.dtype == torch.float16
        np.testing.assert_array_equal(torch.isfinite(ours).numpy(),
                                      torch.isfinite(mine).numpy())
    np.testing.assert_array_equal(np.isfinite(t_m["loss"].numpy()),
                                  np.isfinite(np.asarray(j_m["loss"])))
    np.testing.assert_array_equal(t_m["staleness"].numpy(),
                                  np.asarray(j_m["staleness"]))
    j_cfg, t_cfg = (cfg.replace(model=dataclasses.replace(
        cfg.model, param_dtype="float16")) for cfg in _async_configs(rounds=6))
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_anchors(j_cfg),
               arrival_masks=_arrival_draws(ARRIVAL_SEED, ARRIVAL_RATE))
    assert rt.diverged and rj.diverged
    assert rt.rounds_run == rj.rounds_run
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_array_equal(np.isfinite(a),
                                      np.isfinite(np.asarray(b, np.float32)))


# ------------------------------------------------------ slots and anchor
def test_client_slots_round_trip_and_are_fedtpus_slots():
    """read_client_slot / write_client_slot round-trip bit for bit, and a
    port slot, converted, is fedtpu's read_client_slot of the same state:
    the anchors, Adam's count (optax's chain keeps it twice), moments,
    params and pull tick."""
    _, j_batch, t_batch = _async_batches()
    kw = dict(arrival_rate=ARRIVAL_RATE, arrival_seed=ARRIVAL_SEED, ticks_per_step=6)
    j_state, _ = _j_step(**kw)(_j_state(), j_batch)
    state = _to_port(j_state)
    model = _async_models()[2]
    for slot in range(C):
        ours = t_async.read_client_slot(state, C, slot)
        names = ("anchors", "count", "mu", "nu", "params", "pull_tick")
        assert len(ours) == len(names)
        mine = dict(zip(names, ours))
        leaves = lambda t: jax.tree.leaves(convert.params_to_numpy(t, model))
        want = (leaves(mine["anchors"]) + [mine["count"].numpy()]
                + leaves(mine["mu"]) + leaves(mine["nu"])
                + [mine["count"].numpy()] + leaves(mine["params"])
                + [mine["pull_tick"].numpy()])
        theirs = j_async.read_client_slot(j_state, C, slot)
        assert len(theirs) == len(want)
        for a, b in zip(want, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
    five = t_async.read_client_slot(state, C, 5)
    moved = t_async.write_client_slot(state, C, 2, five)
    for a, b in zip(t_async.read_client_slot(moved, C, 2), five):
        assert torch.equal(a, b)
    back = t_async.write_client_slot(
        moved, C, 2, t_async.read_client_slot(state, C, 2))
    assert _all_equal(back, state)
    assert _all_equal(t_async.write_client_slot(state, C, 3, [
        t.double() for t in t_async.read_client_slot(state, C, 3)]), state)


def test_per_client_view_keeps_server_state_out():
    """The rule: leading dimension C, minus the named server-only keys; a
    screen ring as wide as the client count stays server state, and
    with_per_client puts back what it is given."""
    state = _to_port(_j_state(buffer_size=2, screen_window=C))
    view = t_round.per_client_view(state, C)
    assert [tuple(t.shape) for t in view] == [
        (C, state["params"].shape[1]), (C,), *[(C, view[0].shape[1])] * 3,
        (C,)]
    assert all(v is not state["screen_norms"] for v in view)
    swapped = t_round.with_per_client(state, C, [t + 1 for t in view])
    assert torch.equal(swapped["pull_tick"], state["pull_tick"] + 1)
    assert swapped["screen_norms"] is state["screen_norms"]
    with pytest.raises(ValueError, match="left over"):
        t_round.with_per_client(state, C, view + view)


@pytest.mark.parametrize("pulls,want", [
    ([0] * C, 0), ([0, 3, 1, 3, 2, 0, 3, 1], 1), ([5, 2, 2, 2, 2, 2, 2, 9],
                                                  7)])
def test_async_global_params_is_the_first_freshest_anchor(pulls, want):
    """The freshest anchor is the first largest pull tick, fedtpu's
    jnp.argmax rule (slot 0 at init)."""
    state = _to_port(_j_state())
    state["anchors"] = torch.arange(C, dtype=torch.float32)[:, None] \
        .expand(C, 5).contiguous()
    state["pull_tick"] = torch.tensor(pulls, dtype=torch.int32)
    got = t_async.async_global_params(state)
    assert torch.equal(got, torch.full((5,), float(want)))
    assert int(jnp.argmax(jnp.asarray(pulls))) == want


def test_arrival_draws_follow_fedtpus_law():
    """The port's own draws: all ones at rate 1, Bernoulli(rate) per
    (tick, client), a pure function of (seed, tick)."""
    assert t_async.arrival_mask(C, 1.0, 3, 9).tolist() == [1.0] * C
    draws = np.stack([t_async.arrival_mask(64, 0.25, 3, t)
                      for t in range(200)])
    assert abs(draws.mean() - 0.25) < 0.02
    np.testing.assert_array_equal(draws[17], t_async.arrival_mask(64, 0.25,
                                                                  3, 17))
    assert not np.array_equal(draws[17], t_async.arrival_mask(64, 0.25, 4,
                                                              17))


# ------------------------------------------------------ argument checks
@pytest.mark.parametrize("kw", [
    dict(arrival_rate=0.0), dict(staleness_power=-1.0), dict(server_lr=0.0),
    dict(buffer_size=-1), dict(screen=True),
    dict(driven=True, screen=True, screen_window=0),
    dict(driven=True, screen=True, screen_warmup=9, screen_window=8),
    dict(driven=True, screen=True, screen_norm_mult=0.0),
    dict(driven=True, screen=True, screen_cos_min=1.0),
    dict(clip_norm=-1.0)], ids=lambda kw: ",".join(kw))
def test_argument_checks_are_fedtpus(kw):
    with pytest.raises(ValueError) as j_err:
        j_async.build_async_round_fn(_async_batches()[0], _async_models()[1],
                                     build_optimizer(jcfg.OptimConfig()), 2,
                                     **kw)
    with pytest.raises(ValueError) as t_err:
        _t_step(**kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("step_kw,state_kw,match", [
    (dict(buffer_size=4), dict(), "buffer_size >= 2 needs"),
    (dict(driven=True, screen=True), dict(), "'screen_norms' missing"),
    (dict(), dict(screen_window=4), "rolling median would silently"),
    (dict(driven=True, screen=True, screen_window=8, screen_warmup=4),
     dict(screen_window=4), "does not match screen_window=8")])
def test_a_state_of_another_tick_is_refused_as_fedtpu(step_kw, state_kw,
                                                      match):
    _, _, t_batch = _async_batches()
    step = _t_step(**step_kw)
    with pytest.raises(ValueError, match=match):
        step(_to_port(_j_state(**state_kw)), t_batch,
             np.ones((1, C), np.float32) if step_kw.get("driven") else None)


# ------------------------------------------------------------- the loop
def _async_configs(rounds=20, tmp=None, clients=C, **fed):
    """fedtpu's and the port's async experiment (tests/test_async.py's):
    512 synthetic rows, uniform weighting, arrival rate 0.4, no early
    stop; ``fed``: more FedConfig fields, ``tmp``: a checkpoint dir."""
    fed = dict(dict(rounds=rounds, weighting="uniform", async_mode=True,
                    async_arrival_rate=ARRIVAL_RATE, async_arrival_seed=ARRIVAL_SEED,
                    termination_patience=1000), **fed)
    run = dict(log_every=1000, eval_test_every=5)
    if tmp is not None:
        run.update(checkpoint_dir=str(tmp), checkpoint_every=4)
    return tuple(m.ExperimentConfig(
        data=m.DataConfig(csv_path=None, synthetic_rows=512),
        shard=m.ShardConfig(num_clients=clients),
        model=m.ModelConfig(hidden_sizes=ASYNC_HIDDEN),
        fed=m.FedConfig(**fed), run=m.RunConfig(**run))
        for m in (jcfg, tcfg))


def _anchors(j_cfg):
    """fedtpu's initial anchors (its g0 in every slot), the port's start:
    each side's mean of the inits is an ulp apart."""
    return _np(j_build(j_cfg).state["anchors"])


def test_run_experiment_async_matches_fedtpu():
    """20 ticks through run_experiment with a K-buffer of 4: the
    client-mean, pooled and per-client histories within 1e-6, the losses
    within 1e-5, each tick's staleness equal, the held-out evals of the
    freshest anchor (every 5 ticks) within 1e-6, the summary's staleness
    fields equal, the final params within 1e-5."""
    j_cfg, t_cfg = _async_configs(async_buffer_size=4)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_anchors(j_cfg),
               arrival_masks=_arrival_draws(ARRIVAL_SEED, ARRIVAL_RATE))
    assert rt.rounds_run == rj.rounds_run == 20
    assert len(rt.staleness) == 20 and rt.staleness[0].shape == (C,)
    for a, b in zip(rt.staleness, rj.staleness):
        np.testing.assert_array_equal(a, b)
    assert max(s.max() for s in rt.staleness) >= 2
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-5)
    for k in METRIC_NAMES:
        for name in ("global_metrics", "pooled_metrics", "test_metrics"):
            np.testing.assert_allclose(getattr(rt, name)[k],
                                       getattr(rj, name)[k], atol=1e-6)
        assert len(rt.test_metrics[k]) == 4
    st, sj = rt.summary(), rj.summary()
    for key in ("mean_staleness", "max_staleness", "rounds_run",
                "stopped_early", "diverged"):
        assert st[key] == sj[key], key
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_k_buffer_starvation_warns_as_fedtpu(capsys):
    """A buffer that never fills (rate 1, M = 10^6, 4 ticks of 8 clients)
    ends the run with fedtpu's warning line, the run's metrics all
    recorded; a buffer that empties every tick (M = 8) does not warn."""
    j_cfg, t_cfg = _async_configs(rounds=4, async_arrival_rate=1.0,
                            async_buffer_size=10 ** 6)
    j_run(j_cfg, verbose=True)
    j_line = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("ASYNC K-BUFFER STARVATION")]
    res = t_run(t_cfg, verbose=True, device="cpu")
    t_line = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("ASYNC K-BUFFER STARVATION")]
    assert t_line == j_line and "32 buffered update(s)" in t_line[0]
    assert res.rounds_run == 4 and len(res.global_metrics["accuracy"]) == 4
    t_run(dataclasses.replace(t_cfg, fed=dataclasses.replace(
        t_cfg.fed, async_buffer_size=8)), verbose=True, device="cpu")
    assert "STARVATION" not in capsys.readouterr().out


def test_checkpoint_resume_with_a_pending_buffer_is_bitwise(tmp_path):
    """Checkpointed every 4 ticks with a K-buffer of 6 at rate 0.3 for 8
    ticks, then resumed to 12: bitwise the uninterrupted 12 ticks (final
    params, the resumed ticks' losses, counts and staleness), the
    checkpoint meta saying the async engine wrote it, and a buffer
    pending at the resume point."""
    from fedtpu_torch.orchestration.checkpoint import (load_checkpoint_raw,
                                                       load_meta)
    _, full_cfg = _async_configs(rounds=12, tmp=tmp_path / "a",
                           async_arrival_rate=0.3, async_buffer_size=6)
    full = t_run(full_cfg, verbose=False, device="cpu")
    _, cfg = _async_configs(rounds=8, tmp=tmp_path / "b", async_arrival_rate=0.3,
                      async_buffer_size=6)
    t_run(cfg, verbose=False, device="cpu")
    raw, _, step = load_checkpoint_raw(str(tmp_path / "b"))
    assert step == 8 and float(raw["buf_count"]) > 0
    assert load_meta(str(tmp_path / "b"))["engine_async"] == 1
    resumed = t_run(dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, rounds=12)), verbose=False, device="cpu", resume=True)
    assert resumed.global_metrics == full.global_metrics
    for name in ("loss", "confusion", "staleness"):
        for a, b in zip(getattr(resumed, name), getattr(full, name)[8:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(resumed.final_params),
                    jax.tree.leaves(full.final_params)):
        np.testing.assert_array_equal(a, b)


def test_elastic_resume_repulls_the_freshest_anchor_as_fedtpu(tmp_path,
                                                              capsys):
    """8 clients at arrival rate 0.4 with a K-buffer of 2 for 4 ticks,
    checkpointed, then resumed by both packages with 4 clients to tick 8.
    At the checkpoint the slots hold distinct anchors pulled at distinct
    ticks and the buffer holds updates, so only the freshest anchor, put
    into every slot, gives fedtpu's resumed run: the port's log line is
    fedtpu's (pending updates dropped), and the resumed ticks' staleness
    equal, losses within 1e-5, the carried and resumed history and the
    held-out evals within 1e-6, the final params within 1e-5."""
    from fedtpu_torch.orchestration.checkpoint import load_checkpoint_raw
    fed = dict(async_buffer_size=2)
    j_first, _ = _async_configs(rounds=4, tmp=tmp_path / "j", **fed)
    _, t_first = _async_configs(rounds=4, tmp=tmp_path / "t", **fed)
    j_run(j_first, verbose=False)
    t_run(t_first, verbose=False, device="cpu", init_params=_anchors(j_first),
          arrival_masks=_arrival_draws(ARRIVAL_SEED, ARRIVAL_RATE))
    raw, _, _ = load_checkpoint_raw(str(tmp_path / "t"))
    assert len(set(raw["pull_tick"].tolist())) > 1
    assert float(raw["buf_count"]) > 0
    assert not torch.equal(raw["anchors"][0],
                           t_async.async_global_params(raw))
    lines, results = [], []
    for cfg, run, kw in (
            (j_first, j_run, {}),
            (t_first, t_run, dict(device="cpu", arrival_masks=_arrival_draws(
                ARRIVAL_SEED, ARRIVAL_RATE, 4)))):
        grown = cfg.replace(shard=dataclasses.replace(cfg.shard,
                                                      num_clients=4),
                            fed=dataclasses.replace(cfg.fed, rounds=8))
        results.append(run(grown, verbose=True, resume=True, **kw))
        lines.append([l for l in capsys.readouterr().out.splitlines()
                      if l.startswith("Async elastic resume")])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert "pending buffered updates dropped" in lines[0][0]
    rj, rt = results
    assert rt.rounds_run == rj.rounds_run == 8
    assert len(rt.staleness) == len(rj.staleness) == 4
    for a, b in zip(rt.staleness, rj.staleness):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-5)
    for k in METRIC_NAMES:
        for name in ("global_metrics", "pooled_metrics", "test_metrics"):
            assert len(getattr(rt, name)[k]) == len(getattr(rj, name)[k])
            np.testing.assert_allclose(getattr(rt, name)[k],
                                       getattr(rj, name)[k], atol=1e-6)
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(_np(rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("written_by", ["async", "synchronous"])
@pytest.mark.parametrize("clients", [C, 4])
def test_resume_under_the_other_engine_raises_fedtpus_error(
        tmp_path, written_by, clients):
    """A checkpoint resumed under the other engine, at the same client
    count or another: fedtpu's "engine mismatch" error, naming the engine
    that wrote it."""
    _, async_cfg = _async_configs(rounds=4, tmp=tmp_path)
    sync_cfg = async_cfg.replace(fed=dataclasses.replace(
        async_cfg.fed, async_mode=False))
    first, second = ((async_cfg, sync_cfg) if written_by == "async"
                     else (sync_cfg, async_cfg))
    t_run(first, verbose=False, device="cpu")
    second = second.replace(
        shard=tcfg.ShardConfig(num_clients=clients),
        fed=dataclasses.replace(second.fed, rounds=8))
    with pytest.raises(ValueError, match="engine mismatch: the checkpoint "
                       f"was written by the {written_by} engine"):
        t_run(second, verbose=False, device="cpu", resume=True)


def test_warm_start_goes_into_the_anchors_too(tmp_path):
    """init_weights_npz under --async: the artifact's model in every
    params AND anchor slot, bitwise fedtpu's warm-started state."""
    from fedtpu.sweep.grid import save_best_weights as j_write
    j_cfg, t_cfg = _async_configs(rounds=2)
    model = t_build(t_cfg, device="cpu").model
    weights = convert.params_to_numpy(
        model.init(torch.Generator().manual_seed(5)), model)
    path = str(tmp_path / "best.npz")
    j_write(path, {"weights": weights, "params": {"hidden_layer_sizes":
                                                  list(ASYNC_HIDDEN),
                                                  "learning_rate": 0.004},
                   "metrics": {"accuracy": 0.9}, "accuracy": 0.9})
    j_cfg, t_cfg = (cfg.replace(fed=dataclasses.replace(
        cfg.fed, init_weights_npz=path)) for cfg in (j_cfg, t_cfg))
    t_state, j_state = t_build(t_cfg, device="cpu").state, _np(
        j_build(j_cfg).state)
    want = convert.params_from_jax(weights).expand(C, -1)
    for key in ("params", "anchors"):
        assert torch.equal(t_state[key], want)
        assert torch.equal(t_state[key],
                           convert.params_from_jax(j_state[key]))


@pytest.mark.parametrize("fed_kw,match", [
    (dict(weighting="data_size"), "uniform"),
    (dict(participation_rate=0.5), "arrival"),
    (dict(server_opt="fedadam"), "server update"),
    (dict(dp_clip_norm=1.0), "DP"),
    (dict(robust_aggregation="median"), "robust"),
    (dict(byzantine_clients=1), "robust"),
    (dict(compress="int8"), "compress"),
    (dict(scaffold=True), "SCAFFOLD"),
    (dict(personalize_steps=2), "personalize_steps"),
    (dict(aggregation="ring"), "psum")], ids=lambda v: str(v))
def test_async_refusals_are_fedtpus(fed_kw, match):
    """The async engine refuses each knob of the synchronous aggregation
    stack with fedtpu's ValueError, word for word
    (tests/test_async.py:259-276, and personalize_steps)."""
    fed_kw = dict({"weighting": "uniform"}, **fed_kw)
    errors = []
    for m, build, kw in ((jcfg, j_build, {}),
                         (tcfg, t_build, {"device": "cpu"})):
        cfg = m.ExperimentConfig(
            data=m.DataConfig(csv_path=None, synthetic_rows=256),
            fed=m.FedConfig(async_mode=True, **fed_kw))
        with pytest.raises(ValueError, match=match) as err:
            build(cfg, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ------------------------------- the serving front end (A8b, first part)
# fedtpu_torch.serving against fedtpu.serving on the same inputs: traces
# (arrays and file bytes), admission verdicts, the wire protocol's framing,
# the ServingEngine's history, WAL, acks, params, accuracy and summary
# (fedtpu's initial params injected), the screen's decision log and the
# defense sim, checkpoint/restore, the wire path (each package's loadgen
# against the other's server) and the refusals of what is not ported. Small
# size throughout: fedtpu's serving tests' ``_small_cfg`` (cohort 8,
# K-buffer 2, 64 rows, one hidden layer of 8) and ``_small_trace``.

_SERVE_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Summary keys taken on the wall clock: the rest is virtual-time-derived.
_SERVE_WALL = ("wall_s", "rounds_per_sec")


def _serve_kw(**kw) -> dict:
    base = dict(cohort=8, buffer_size=2, tick_interval_s=0.5,
                data_rows=64, model_hidden=(8,), seed=0)
    base.update(kw)
    return base


def _serve_trace(arrivals=200, seed=11):
    return j_traces.synthesize_trace(users=500, arrivals=arrivals,
                                     horizon_s=10.0, seed=seed)


def _serve_poison_rows(arrivals=260, users=30, seed=5, frac=0.2, scale=10.0):
    """fedtpu's defense tests' adversarial rows: attackers ride a 5-wide
    row with the poison scale."""
    _, t, user, lat = j_traces.synthesize_trace(
        users, arrivals, 20.0, seed=seed, poison_frac=frac,
        poison_scale=scale)
    atk = {int(u) for u in j_traces.poisoned_user_ids(users, seed, frac)}
    rows = [([int(user[i]), float(t[i]), float(lat[i]), None, scale]
             if int(user[i]) in atk else
             [int(user[i]), float(t[i]), float(lat[i])])
            for i in range(len(t))]
    return rows, sorted(atk)


def _serve_rows(t, user, lat) -> list:
    return [[int(u), float(a), float(b)] for u, a, b in zip(user, t, lat)]


def _serve_j_engine(**kw):
    from fedtpu.serving.engine import ServingEngine
    return ServingEngine(jcfg.ServingConfig(**_serve_kw(**kw)),
                         registry=JRegistry())


def _serve_fedtpu_init(j_engine) -> torch.Tensor:
    return convert.params_from_jax(jax.tree.map(np.asarray,
                                                j_engine.state["params"]))


def _serve_t_engine(init=None, **kw):
    from fedtpu_torch.serving.engine import ServingEngine
    return ServingEngine(tcfg.ServingConfig(**_serve_kw(**kw)),
                         registry=TRegistry(), device="cpu",
                         init_params=init)


def _serve_j_global(j_engine) -> np.ndarray:
    from fedtpu.parallel.async_fed import async_global_params
    return convert.params_from_jax(jax.tree.map(
        np.asarray, async_global_params(j_engine.state))).numpy()


def _serve_t_global(t_engine) -> np.ndarray:
    from fedtpu_torch.parallel.async_fed import async_global_params
    return async_global_params(t_engine.state).numpy()


def _serve_no_wall(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in _SERVE_WALL + ("op",)}


# ------------------------------------------------------------------- traces

@pytest.mark.parametrize("poison_frac", [0.0, 0.2], ids=["v1", "v2"])
def test_serving_traces_equal_fedtpus_arrays_and_file_bytes(tmp_path, poison_frac):
    """synthesize_trace's header and arrays, poisoned_user_ids and the
    written file equal fedtpu's byte for byte; both readers read each
    other's files to the same arrays."""
    kw = dict(users=5000, arrivals=700, horizon_s=30.0, seed=3,
              poison_frac=poison_frac, poison_scale=8.0)
    jh, *j_arr = j_traces.synthesize_trace(**kw)
    th, *t_arr = t_traces.synthesize_trace(**kw)
    assert th.to_json() == jh.to_json()
    for a, b in zip(t_arr, j_arr):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_traces.poisoned_user_ids(5000, 3, poison_frac),
        j_traces.poisoned_user_ids(5000, 3, poison_frac))
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    j_traces.write_trace(jp, jh, *j_arr)
    t_traces.write_trace(tp, th, *t_arr)
    with open(jp, "rb") as fj, open(tp, "rb") as ft:
        assert ft.read() == fj.read()
    h, *arr = t_traces.load_trace_arrays(jp)
    assert h.to_json() == jh.to_json()
    for a, b in zip(arr, j_traces.load_trace_arrays(tp)[1:]):
        np.testing.assert_array_equal(a, b)
    t_poison = [ev.poison for ev in t_traces.read_trace(jp)[1]]
    j_poison = [ev.poison for ev in j_traces.read_trace(tp)[1]]
    assert t_poison == j_poison
    assert (max(t_poison) > 0) == (poison_frac > 0)


def test_serving_trace_refusals_match_fedtpus(tmp_path):
    bad = tmp_path / "v3.jsonl"
    bad.write_text('{"kind": "trace_header", "v": 3, "users": 1, '
                   '"arrivals": 0}\n')
    for mod in (j_traces, t_traces):
        with pytest.raises(ValueError, match="unsupported trace schema"):
            mod.read_trace(str(bad))
        with pytest.raises(ValueError, match="poison_frac"):
            mod.poisoned_user_ids(10, 0, 1.5)
        with pytest.raises(ValueError, match="poison_scale"):
            mod.synthesize_trace(10, 5, poison_frac=0.5, poison_scale=0.0)


# ---------------------------------------------------------------- admission

@pytest.mark.parametrize("policy", [
    dict(rate_limit=40.0, rate_burst=8.0),
    dict(max_pending=12),
    dict(stale_deprioritize=2, stale_reject=6),
    dict(rate_limit=60.0, rate_burst=4.0, max_pending=20,
         stale_deprioritize=1, stale_reject=3, window_s=2.0)],
    ids=["rate", "backpressure", "staleness", "all"])
def test_serving_admission_verdicts_equal_fedtpus(policy):
    """One seeded event stream through both controllers: the same
    verdicts in the same order, counts, window rates and checkpoint
    state, with the screen's recorded verdicts interleaved."""
    rng = np.random.default_rng(0)
    n = 600
    now = np.cumsum(rng.exponential(0.02, n))
    stale = rng.integers(0, 9, n)
    pending = rng.integers(0, 30, n)
    ctl = {}
    for name, mod, reg in (("j", j_adm, JRegistry()),
                           ("t", t_adm, TRegistry())):
        c = mod.AdmissionController(mod.AdmissionPolicy(**policy),
                                    registry=reg)
        out = []
        for i in range(n):
            out.append(c.decide(float(now[i]), int(stale[i]),
                                int(pending[i])))
            if i % 7 == 0:
                out.append(c.record(mod.SCREENED, float(now[i])))
        ctl[name] = (c, out, reg)
    (jc, j_out, j_reg), (tc, t_out, t_reg) = ctl["j"], ctl["t"]
    assert t_out == j_out
    assert tc.counts == jc.counts
    assert sum(v > 0 for v in tc.counts.values()) >= 3
    assert tc.window_rates() == jc.window_rates()
    assert tc.state() == jc.state()
    assert (t_reg.snapshot()["counters"] == j_reg.snapshot()["counters"])
    with pytest.raises(ValueError, match="stale_reject"):
        t_adm.AdmissionPolicy(stale_deprioritize=8, stale_reject=4)
    with pytest.raises(ValueError, match="unknown verdict"):
        tc.record("bogus")


def test_serving_metrics_and_slo_burn_equal_fedtpus():
    from fedtpu.autoscale.signals import slo_burn_from_hist as j_burn
    from fedtpu_torch.autoscale.signals import slo_burn_from_hist as t_burn
    vals = np.random.default_rng(1).lognormal(-1.0, 1.0, 300)
    bins = (0.05, 0.1, 0.5, 1.0, 5.0)
    jh = JRegistry().histogram("lat", bins=bins)
    th = TRegistry().histogram("lat", bins=bins)
    jh.observe_many(vals.tolist())
    th.observe_many(vals.tolist())
    assert th.to_dict() == jh.to_dict()
    for objective in (0.07, 1.0, 10.0):
        assert t_burn(th.to_dict(), objective, 0.1) == j_burn(
            jh.to_dict(), objective, 0.1)
    assert t_burn(None, 1.0, 0.1) == 0.0


# ----------------------------------------------------------------- protocol

class _ServeSink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def test_serving_protocol_framing_equals_fedtpus():
    """Frames are byte-equal, trace ids equal, error frames equal, and
    each side parses the other's frames."""
    msgs = [{"op": "hello", "v": 1},
            {"op": "updates", "events": [[3, 0.5, 0.25], [9, 0.75, 0.1,
                                                          None, 10.0]],
             "nonce": "abc", "seq": 4, "trace": t_proto.trace_id("abc", 4)},
            {"op": "stats"}, {"z": [1.5, None], "a": {"y": 2, "b": "x"}}]
    for m in msgs:
        js, ts = _ServeSink(), _ServeSink()
        j_proto.send_msg(js, m)
        t_proto.send_msg(ts, m)
        assert ts.data == js.data
        assert t_proto.parse_msg(js.data.rstrip(b"\n")) == m
    assert t_proto.trace_id("n", 7) == j_proto.trace_id("n", 7)
    assert t_proto.error_msg("x") == j_proto.error_msg("x")
    assert t_proto.parse_msg(b"{not json") is None
    assert t_proto.parse_msg(b"[1, 2]") is None
    assert (t_proto.PROTOCOL_VERSION, t_proto.MAX_LINE_BYTES,
            t_proto.MAX_BATCH_EVENTS) == (j_proto.PROTOCOL_VERSION,
                                          j_proto.MAX_LINE_BYTES,
                                          j_proto.MAX_BATCH_EVENTS)


@pytest.mark.parametrize("mod", [j_proto, t_proto], ids=["fedtpu", "port"])
def test_serving_protocol_refuses_an_oversized_line_and_reads_on(mod):
    """A line past MAX_LINE_BYTES is refused once (None) and the next
    line still arrives with a LineBuffer; a plain bytearray drops the
    connection, as fedtpu's does."""
    a, b = socket.socketpair()
    try:
        def feed():
            a.sendall(b"x" * (t_proto.MAX_LINE_BYTES + 10) + b"\n"
                      + b'{"op":"stats"}\n')
        th = threading.Thread(target=feed)
        th.start()
        buf, got = mod.LineBuffer(), []
        while len(got) < 2:
            got.extend(mod.recv_lines(b, buf))
        th.join(timeout=30)
        assert not th.is_alive()
        assert got[0] is None and mod.parse_msg(got[1]) == {"op": "stats"}
        assert buf.dropped == 1
        th = threading.Thread(target=lambda: a.sendall(
            b"y" * (t_proto.MAX_LINE_BYTES + 10)))
        th.start()
        with pytest.raises(ConnectionError, match="MAX_LINE_BYTES"):
            plain = bytearray()
            while True:
                list(mod.recv_lines(b, plain))
        th.join(timeout=30)
    finally:
        a.close()
        b.close()


def test_serving_handle_refuses_a_version_mismatch_as_fedtpu():
    from fedtpu.serving.server import _handle as j_handle
    from fedtpu_torch.serving.server import _handle, _safe_handle
    from fedtpu_torch.telemetry.trace import NullTracer
    bad = {"op": "hello", "v": 99}
    # fedtpu's answer comes before it touches the engine.
    assert _handle(None, bad) == j_handle(None, bad)
    assert _handle(None, bad)["op"] == "error"
    eng = _serve_t_engine()
    ok = _handle(eng, {"op": "hello", "v": 1})
    assert ok == {"op": "welcome", "v": 1, "cohort": 8, "version": 0}
    assert _handle(eng, {"op": "nope"})["op"] == "error"
    reg = TRegistry()
    resp = _safe_handle(None, {"op": "stats"}, NullTracer(), reg)
    assert resp["op"] == "error" and "AttributeError" in resp["reason"]
    assert reg.snapshot()["counters"]["serve_handler_errors"] == 1


# ------------------------------------------------------------------- engine

_SERVE_ENGINE_CASES = {
    "time-driven": {},
    "flush_every": dict(flush_every=12),
    "buffer_size 0": dict(buffer_size=0),
    "deprioritize": dict(buffer_size=0, stale_deprioritize=0,
                         stale_reject=2, rate_limit=25.0, rate_burst=6.0,
                         max_pending=10),
}


def _serve_drive(engine, handle, rows, frame=50):
    """fedtpu's server path, in process: session-stamped ``updates``
    frames, one resent (a lost ack), then drain and stats."""
    out = []
    frames = [rows[i:i + frame] for i in range(0, len(rows), frame)]
    for seq, events in enumerate(frames, start=1):
        msg = {"op": "updates", "events": events, "nonce": "s0", "seq": seq}
        out.append(handle(engine, msg))
        if seq == 2:
            out.append(handle(engine, msg))
    out.append(handle(engine, {"op": "drain"}))
    out.append(_serve_no_wall(handle(engine, {"op": "stats"})))
    return out


@pytest.mark.parametrize("case", list(_SERVE_ENGINE_CASES))
def test_serving_engine_equals_fedtpus(tmp_path, case):
    """The trace through fedtpu's server path in both packages (fedtpu's
    initial params injected): every ack, the per-tick history and the WAL
    equal as strings, the summary equal but for its wall-clock keys, the
    global params within 1e-5, eval_accuracy equal; a resent frame is
    dropped as a duplicate with its original counts."""
    from fedtpu.serving.server import _handle as j_handle
    from fedtpu_torch.serving.server import _handle as t_handle
    kw = _SERVE_ENGINE_CASES[case]
    _, t, user, lat = _serve_trace()
    rows = _serve_rows(t, user, lat)
    j = _serve_j_engine(**kw)
    eng = _serve_t_engine(_serve_fedtpu_init(j), **kw)
    j.wal_path, eng.wal_path = (str(tmp_path / "j.wal"),
                                str(tmp_path / "t.wal"))
    j_out = _serve_drive(j, j_handle, rows)
    t_out = _serve_drive(eng, t_handle, rows)
    assert t_out == j_out
    assert t_out[2]["duplicate"] and t_out[2]["counts"] == t_out[1]["counts"]
    assert eng.duplicate_drops == j.duplicate_drops == 50
    assert eng.history_lines() == j.history_lines()
    assert len(eng.history_lines()) >= 10
    with open(j.wal_path) as fj, open(eng.wal_path) as ft:
        assert ft.read() == fj.read()
    np.testing.assert_allclose(_serve_t_global(eng), _serve_j_global(j), rtol=0,
                               atol=1e-5)
    assert eng.eval_accuracy() == j.eval_accuracy()
    assert _serve_no_wall(eng.summary()) == _serve_no_wall(j.summary())
    summary = eng.summary()
    if case == "deprioritize":
        adm = summary["admission"]
        assert min(adm["deprioritize"], adm["reject_rate"],
                   adm["reject_stale"], adm["reject_backpressure"]) > 0


def test_serving_engine_offer_paths_equal_fedtpus():
    """Single offers with explicit versions and a same-user coalesce, the
    configure/pre_drain knobs and the K-buffer starvation at drain, as
    fedtpu's: the same verdicts, history and signals."""
    runs = {}
    j = _serve_j_engine(buffer_size=4, tick_interval_s=0.0)
    for name, eng in (("j", j), ("t", _serve_t_engine(_serve_fedtpu_init(j),
                                                 buffer_size=4,
                                                 tick_interval_s=0.0))):
        verdicts = [eng.offer(0.1, u, 0.0) for u in (0, 0, 1)]
        verdicts.append(eng.offer(0.2, 4, 0.05, version=0))
        applied = eng.configure(tick_interval_s=0.25, flush_every=2)
        verdicts += [eng.offer(0.3 + 0.1 * i, 10 + i, 0.0) for i in range(5)]
        eng.drain()
        runs[name] = (verdicts, applied, eng.history_lines(),
                      _serve_no_wall(eng.signals()), eng.version, eng.nbuf_host,
                      eng.binder.state()["slots"].tolist())
    assert runs["t"] == runs["j"]
    with pytest.raises(ValueError, match="tick_interval_s"):
        _serve_t_engine().configure(tick_interval_s=-1.0)


def test_serving_engine_pre_drain_spools_fedtpus_lines(tmp_path):
    j = _serve_j_engine(tick_interval_s=0.0)
    eng = _serve_t_engine(_serve_fedtpu_init(j), tick_interval_s=0.0)
    for e in (j, eng):
        for i in range(5):
            e.offer(0.1 * (i + 1), i, 0.0, poison=float(i % 2))
    nj, pj = j.pre_drain(str(tmp_path / "j.jsonl"))
    nt, pt = eng.pre_drain(str(tmp_path / "t.jsonl"))
    assert nt == nj == 5
    with open(pj) as fj, open(pt) as ft:
        assert ft.read() == fj.read()
    with pytest.raises(ValueError, match="spool_dir"):
        eng.pre_drain()


def _serve_split_run(tmp_path, rows, half, **kw):
    """Uninterrupted, and checkpointed at ``half`` into a FRESH engine
    that finishes the rows: both engines."""
    ref = _serve_t_engine(**kw)
    ref.offer_many(rows)
    ref.drain()
    first = _serve_t_engine(**kw)
    first.offer_many(rows[:half])
    assert first.pending, "no updates pending at the checkpoint"
    first.checkpoint(str(tmp_path))
    second = _serve_t_engine(**kw)
    assert second.restore(str(tmp_path)) == first.tick_count
    second.offer_many(rows[half:])
    second.drain()
    return ref, first, second


@pytest.mark.parametrize("kw", [
    dict(), dict(rate_limit=4.0, rate_burst=2.0),
    dict(buffer_size=0, flush_every=16)], ids=["plain", "rate", "flush"])
def test_serving_engine_checkpoint_restore_is_bitwise(tmp_path, kw):
    """Checkpoint mid-stream with updates pending, restore into a fresh
    engine, finish: history, params, optimizer state, latencies,
    admission and the registry's run totals are the uninterrupted run's,
    bitwise (fedtpu's test_serving_engine_checkpoint_restore_is_bitwise and its
    admission/latency twin, in the port)."""
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    _, t, user, lat = _serve_trace(arrivals=120)
    ref, _, eng = _serve_split_run(tmp_path, _serve_rows(t, user, lat), 60, **kw)
    assert eng.history_lines() == ref.history_lines()
    for a, b in zip(async_state_tensors(eng.state),
                    async_state_tensors(ref.state)):
        assert torch.equal(a, b)
    assert eng.state["round"] == ref.state["round"]
    assert eng.latencies == ref.latencies
    assert eng.admission.counts == ref.admission.counts
    assert eng._lat_hist.to_dict() == ref._lat_hist.to_dict()
    # The admission window's rates are not checkpointed (fedtpu's
    # design: they warm back up over one window_s); the rest is.
    got, want = _serve_no_wall(eng.summary()), _serve_no_wall(ref.summary())
    for s in (got, want):
        for key in ("window_decisions", "rates"):
            s["signals"].pop(key)
    assert got == want
    counters = eng.registry.snapshot()["counters"]
    assert counters["serve_updates_incorporated"] == ref.incorporated
    assert counters["serve_ticks"] == ref.tick_count
    if kw.get("rate_limit"):
        assert ref.admission.counts["reject_rate"] > 0


def test_serving_restore_refuses_another_engines_checkpoint(tmp_path):
    eng = _serve_t_engine()
    eng.offer(0.1, 1, 0.0)
    eng.checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="another engine"):
        _serve_t_engine(cohort=4).restore(str(tmp_path))


def test_serving_engine_sessions_and_wal_replay_after_restore(tmp_path):
    """A frame in the WAL but not in the checkpoint is re-offered on
    resume, one the checkpoint covers is not, and the client's retry of
    an acked frame dedups: the run ends where the uninterrupted one
    does."""
    from fedtpu_torch.serving.server import _handle
    _, t, user, lat = _serve_trace(arrivals=120)
    rows = _serve_rows(t, user, lat)
    ref = _serve_t_engine()
    for seq, k in enumerate(range(0, 120, 40), start=1):
        _handle(ref, {"op": "updates", "events": rows[k:k + 40],
                      "nonce": "c", "seq": seq})
    ref.drain()
    a = _serve_t_engine()
    a.wal_path = str(tmp_path / "wal")
    _handle(a, {"op": "updates", "events": rows[:40], "nonce": "c",
                "seq": 1})
    a.checkpoint(str(tmp_path / "ck"))
    assert os.path.getsize(a.wal_path) == 0      # durable: truncated
    _handle(a, {"op": "updates", "events": rows[40:80], "nonce": "c",
                "seq": 2})
    b = _serve_t_engine()
    b.wal_path = a.wal_path
    b.restore(str(tmp_path / "ck"))
    assert b.replay_wal() == 40
    dup = _handle(b, {"op": "updates", "events": rows[40:80], "nonce": "c",
                      "seq": 2})
    assert dup["duplicate"]
    _handle(b, {"op": "updates", "events": rows[80:], "nonce": "c",
                "seq": 3})
    b.drain()
    assert b.history_lines() == ref.history_lines()
    assert torch.equal(b.state["params"], ref.state["params"])


# ------------------------------------------------------------------- screen

def test_serving_screened_engine_decisions_equal_fedtpus():
    """fedtpu's defense tests' poisoned replay through a screening engine
    in both packages: the defense log (strikes and quarantines), the
    history and the quarantine set equal; quarantined ids are attackers
    only."""
    rows, attackers = _serve_poison_rows()
    kw = dict(screen=True, quarantine_strikes=3)
    j = _serve_j_engine(**kw)
    eng = _serve_t_engine(_serve_fedtpu_init(j), **kw)
    for e in (j, eng):
        e.offer_many(rows)
        e.drain()
    assert eng.defense_log == j.defense_log
    assert eng.history_lines() == j.history_lines()
    assert sorted(eng.quarantined) == sorted(j.quarantined)
    assert eng.quarantined and set(eng.quarantined) <= set(attackers)
    assert eng.screened_total == j.screened_total
    np.testing.assert_allclose(_serve_t_global(eng), _serve_j_global(j), rtol=0,
                               atol=1e-5)
    assert eng.eval_accuracy() == j.eval_accuracy()


def test_serving_screened_checkpoint_restore_is_bitwise(tmp_path):
    rows, _ = _serve_poison_rows()
    ref, first, eng = _serve_split_run(tmp_path, rows, len(rows) // 2,
                                 screen=True, quarantine_strikes=3)
    assert eng.defense_log == ref.defense_log[len(first.defense_log):]
    assert eng.quarantined == ref.quarantined and eng.strikes == ref.strikes
    assert eng.history_lines() == ref.history_lines()
    assert torch.equal(eng.state["screen_norms"], ref.state["screen_norms"])
    assert torch.equal(eng.state["params"], ref.state["params"])


def test_serving_defense_sim_lines_equal_fedtpus_in_process():
    """The port's simulate() at fedtpu's constants (fedtpu's initial params
    injected) writes fedtpu's decision lines, held against fedtpu's
    simulate() run here, not against the committed golden (whose line
    count this JAX build does not reproduce)."""
    from fedtpu.robust import defense_sim as j_sim
    from fedtpu.serving.engine import ServingEngine
    from fedtpu_torch.robust import defense_sim as t_sim
    for name in ("SIM_USERS", "SIM_ARRIVALS", "SIM_HORIZON_S", "SIM_SEED",
                 "SIM_POISON_FRAC", "SIM_POISON_SCALE", "SIM_COHORT",
                 "SIM_BUFFER", "SIM_TICK_INTERVAL_S",
                 "SIM_QUARANTINE_STRIKES"):
        assert getattr(t_sim, name) == getattr(j_sim, name), name
    j_init = _serve_fedtpu_init(ServingEngine(j_sim._sim_config(),
                                        registry=JRegistry()))
    want = j_sim.simulate()
    got = t_sim.simulate(device="cpu", init_params=j_init)
    assert got["lines"] == want["lines"]
    assert got["summary"] == want["summary"]
    assert got["summary"]["quarantined_honest"] == []


def test_serving_defense_sim_writes_and_compares_decisions(tmp_path):
    from fedtpu.autoscale.controller import compare_decisions as j_compare
    from fedtpu_torch.robust.defense_sim import (compare_decisions,
                                                 write_decisions)
    lines = ['{"a":1}', '{"b":2}']
    path = str(tmp_path / "d.jsonl")
    write_decisions(path, lines)
    with open(path) as fh:
        assert fh.read() == '{"a":1}\n{"b":2}\n'
    for probe in (lines, lines[:1], ['{"a":1}', '{"b":3}']):
        assert compare_decisions(probe, path) == j_compare(probe, path)
    assert not compare_decisions(lines, str(tmp_path / "none"))["ok"]


# ---------------------------------------------------------------- wire path

def _serve_in_thread(run_server, cfg, pf, **kw):
    box = {}

    def target():
        box["summary"] = run_server(cfg, port_file=pf, once=True,
                                    verbose=False, **kw)

    th = threading.Thread(target=target)
    th.start()
    return th, box


def test_serving_loadgen_localhost_smoke(tmp_path):
    """The port's run_server (a thread, once=True) fed by the port's
    run_loadgen over localhost; the history it writes is the in-process
    replay's."""
    from fedtpu_torch.serving.loadgen import run_loadgen
    from fedtpu_torch.serving.server import run_server
    header, t, user, lat = _serve_trace(arrivals=150)
    trace = str(tmp_path / "trace.jsonl")
    t_traces.write_trace(trace, header, t, user, lat)
    pf = str(tmp_path / "port")
    th, box = _serve_in_thread(run_server, tcfg.ServingConfig(**_serve_kw()),
                               pf, device="cpu",
                               history_path=str(tmp_path / "hist.jsonl"))
    try:
        res = run_loadgen(trace, port_file=pf, batch=64)
    finally:
        th.join(timeout=120)
    assert not th.is_alive()
    assert res["events_sent"] == 150 and res["frames"] == 3
    assert sum(res["admission"].values()) == 150
    stats = res["server_stats"]
    assert stats["ticks"] > 0 and stats["incorporated"] > 0
    hist = (tmp_path / "hist.jsonl").read_text().strip().splitlines()
    assert len(hist) == stats["ticks"] == box["summary"]["ticks"]
    # The events re-read from the file are the trace's to 1e-9: replaying
    # them in process gives the same history, line for line.
    _, tt, uu, ll = t_traces.load_trace_arrays(trace)
    eng = _serve_t_engine()
    eng.offer_many(_serve_rows(tt, uu, ll))
    eng.drain()
    assert eng.history_lines() == hist


@pytest.mark.parametrize("loadgen, server", [
    ("port", "fedtpu"), ("port", "port"), ("fedtpu", "port")])
def test_serving_loadgen_gets_the_same_acks_across_packages(tmp_path,
                                                            loadgen, server):
    """The port's loadgen against fedtpu's run_server and the port's, and
    fedtpu's loadgen against the port's: the same ack counts, tick count
    and history as the trace's in-process replay."""
    if loadgen == "fedtpu":
        from fedtpu.serving.loadgen import run_loadgen
    else:
        from fedtpu_torch.serving.loadgen import run_loadgen
    if server == "fedtpu":
        from fedtpu.serving.server import run_server
        cfg = jcfg.ServingConfig(**_serve_kw(buffer_size=0))
        kw = {}
    else:
        from fedtpu_torch.serving.server import run_server
        cfg = tcfg.ServingConfig(**_serve_kw(buffer_size=0))
        kw = {"device": "cpu"}
    header, t, user, lat = j_traces.synthesize_trace(
        users=200, arrivals=180, horizon_s=6.0, seed=4, poison_frac=0.1)
    trace = str(tmp_path / "trace.jsonl")
    j_traces.write_trace(trace, header, t, user, lat)
    pf, hist = str(tmp_path / "port"), str(tmp_path / "hist.jsonl")
    th, box = _serve_in_thread(run_server, cfg, pf, history_path=hist, **kw)
    try:
        res = run_loadgen(trace, port_file=pf, batch=40)
    finally:
        th.join(timeout=120)
    assert not th.is_alive()
    assert res["events_sent"] == 180 and res["frames"] == 5
    # The in-process replay of the file's events (buffer_size 0, no
    # screen: the acks and the history are host bookkeeping only).
    eng = _serve_t_engine(buffer_size=0)
    _, events = t_traces.read_trace(trace)
    eng.offer_many([[e.user, e.t, e.lat, None, e.poison] for e in events])
    eng.drain()
    assert res["admission"] == {k: v for k, v in eng.admission.counts.items()
                                if v}
    with open(hist) as fh:
        assert fh.read().splitlines() == eng.history_lines()
    assert res["server_stats"]["ticks"] == eng.tick_count
    assert res["server_stats"]["version"] == eng.version
    assert box["summary"]["ticks"] == eng.tick_count


# ------------------------------- the rest of the serving stack (A8c)
# The store-backed engine, the gateway fleet, the wire-fault proxy, the
# net and autoscale sims and the live controller against fedtpu's on the
# same inputs (fedtpu's initial params injected), at the small serving
# shape; fedtpu's tests/test_gateway.py, test_netfaults.py and
# test_autoscale.py cases as port cases.

_A8C_GOLDENS = os.path.join(_SERVE_REPO, "tests", "goldens")
# The store tests' hidden width: 16, not the serving tests' 8. fedtpu's
# per_client_view takes any state leaf whose first width equals the cohort
# for a per-client one, so at 8 slots and a hidden layer of 8 two leaves of
# its K-buffer (the (8,) bias and the (8, 2) weight) ride every store
# record, and a swap writes K-buffer rows: fedtpu's fault, which the port's
# rule (the K-buffer is one (D,) row) does not share.
_A8C_HIDDEN = (16,)


def _store_values_as_port(j_engine, store, ids) -> list:
    """fedtpu's store values for ``ids`` as the port's leaves (anchors,
    Adam's count, mu, nu, params, pull tick; each quantity's pytree leaves
    in the flat row's order)."""
    from fedtpu.parallel.round import with_per_client
    s = with_per_client(jax.tree.map(np.asarray, j_engine.state), j_engine.C,
                        store.read(ids))
    adam = s["opt_state"][0]
    return [convert.params_from_jax(s["anchors"]).numpy(),
            np.asarray(adam.count, np.int32),
            convert.params_from_jax(adam.mu).numpy(),
            convert.params_from_jax(adam.nu).numpy(),
            convert.params_from_jax(s["params"]).numpy(),
            np.asarray(s["pull_tick"], np.int32)]


def _store_headers(store, ids) -> tuple:
    strikes, quarantined = store.reputation(ids)
    return (store.versions(ids).tolist(), store.participation(ids).tolist(),
            strikes.tolist(), quarantined.tolist())


def _assert_stores_match(j_engine, js, ts, atol=1e-5) -> np.ndarray:
    """Touched ids and headers equal, values within ``atol`` under the
    leaf mapping; returns the touched ids."""
    ids = np.array(sorted(js._touched), np.int64)
    assert sorted(ts._touched) == ids.tolist() and ids.size
    assert _store_headers(ts, ids) == _store_headers(js, ids)
    for got, want in zip(ts.read(ids), _store_values_as_port(j_engine, js,
                                                             ids)):
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(got, want)
    return ids


@pytest.mark.parametrize("case", ["plain", "screened"])
def test_serving_store_engine_equals_fedtpus(case):
    """A trace whose ticks bind more users than the 8 slots (so the LRU
    binder evicts, inside a tick, a user it bound earlier in that tick)
    through fedtpu's store-backed engine and the port's: the histories and
    evictions equal, the global params within 1e-5, every touched
    record's header equal (version, participation, strikes, quarantine)
    and its values within 1e-5; under the screen the quarantine is
    durable in both stores."""
    if case == "plain":
        _, t, user, lat = _serve_trace(arrivals=300)
        rows, kw = _serve_rows(t, user, lat), {}
    else:
        rows, _ = _serve_poison_rows()
        kw = dict(screen=True, quarantine_strikes=2)
    kw["model_hidden"] = _A8C_HIDDEN
    j = _serve_j_engine(**kw)
    eng = _serve_t_engine(_serve_fedtpu_init(j), **kw)
    js, ts = j.attach_store(500), eng.attach_store(500)
    swaps = []
    inner = eng._swap_slots

    def recorded(tick_swaps):
        swaps.extend((eng.tick_count, int(ev), int(new))
                     for _, ev, new in tick_swaps)
        inner(tick_swaps)

    eng._swap_slots = recorded
    for e in (j, eng):
        e.offer_many(rows)
        e.drain()
    assert eng.history_lines() == j.history_lines()
    assert eng.binder.evictions == j.binder.evictions == len(swaps) > 0
    bound_then_evicted = [
        (k, ev) for i, (k, ev, _) in enumerate(swaps)
        if any(k2 == k and new == ev for k2, _, new in swaps[:i])]
    assert bound_then_evicted, "no user evicted in the tick that bound it"
    np.testing.assert_allclose(_serve_t_global(eng), _serve_j_global(j),
                               rtol=0, atol=1e-5)
    ids = _assert_stores_match(j, js, ts)
    assert eng.registry.snapshot()["counters"]["serve_slot_evictions"] \
        == len(swaps)
    if case == "screened":
        assert eng.quarantined == j.quarantined and eng.quarantined
        assert (ts.quarantined_ids().tolist() == js.quarantined_ids().tolist()
                == sorted(eng.quarantined))
    else:
        assert int(ts.participation(ids).max()) >= 2


def test_serving_store_never_takes_the_k_buffer_for_a_slot():
    """At 8 slots and a hidden layer of 8, fedtpu's store template holds
    two leaves of the K-buffer beside the 19 of a slot; the port's holds
    the six per-client tensors only, and a swap leaves the K-buffer as
    it was."""
    from fedtpu.cohort.store import state_template as j_template
    from fedtpu_torch.cohort.store import state_template
    j = _serve_j_engine()
    eng = _serve_t_engine(_serve_fedtpu_init(j))
    assert len(j_template(j.state, 8)) == 21
    assert len(state_template(eng.state, 8)) == 6
    eng.attach_store(100)
    eng.offer_many([[u, 0.01 * u, 0.0] for u in range(9)])
    before = eng.state["buf_delta"].clone()
    eng._swap_slots([(0, 3, 99)])
    assert torch.equal(eng.state["buf_delta"], before)
    assert eng.store.participation(np.array([3]))[0] == 1


def test_serving_store_batched_swaps_equal_one_at_a_time():
    """A tick's swaps, batched (one device read of the slots, one write),
    give every record and slot of the swaps made one at a time, bitwise,
    where a user is bound and evicted again inside the tick, a returning
    user's record is loaded, and a slot takes three users in turn."""
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    engines = []
    for _ in range(2):
        eng = _serve_t_engine(model_hidden=_A8C_HIDDEN)
        eng.attach_store(100)
        eng.offer_many([[u, 0.02 * u, 0.0] for u in range(8)])
        eng.drain()
        # Users 40 and 41 hold records from an earlier life.
        eng._swap_slots([(1, 1, 40), (2, 2, 41)])
        eng._swap_slots([(1, 40, 1), (2, 41, 2)])
        engines.append(eng)
    swaps = [(3, 3, 50), (5, 5, 40), (3, 50, 51), (6, 6, 41), (3, 51, 52),
             (5, 40, 3), (0, 0, 50)]
    engines[0]._swap_slots(swaps)
    for swap in swaps:
        engines[1]._swap_slots([swap])
    a, b = (e.store.checkpoint_arrays() for e in engines)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    for x, y in zip(*(async_state_tensors(e.state) for e in engines)):
        assert torch.equal(x, y)
    # User 50, bound in the tick, evicted in it and bound again at slot 0,
    # brings its one-tick record back: slot 3's state when it left.
    assert engines[0].store.participation(np.array([50]))[0] == 1


def test_serving_store_rides_the_checkpoint_bitwise(tmp_path):
    """Checkpoint mid-stream with a store attached, restore into a fresh
    engine and store, finish: the history, state and every store record
    byte are the uninterrupted run's; a corrupted store export refuses
    the restore."""
    from fedtpu_torch.orchestration.checkpoint import load_meta
    from fedtpu_torch.parallel.async_fed import async_state_tensors
    _, t, user, lat = _serve_trace(arrivals=200)
    rows, half = _serve_rows(t, user, lat), 100
    ref = _serve_t_engine()
    ref.attach_store(500)
    ref.offer_many(rows)
    ref.drain()
    first = _serve_t_engine()
    first.attach_store(500)
    first.offer_many(rows[:half])
    assert first.store._touched and first.pending
    first.checkpoint(str(tmp_path))
    second = _serve_t_engine()
    second.attach_store(500)
    second.restore(str(tmp_path))
    second.offer_many(rows[half:])
    second.drain()
    assert second.history_lines() == ref.history_lines()
    for a, b in zip(async_state_tensors(second.state),
                    async_state_tensors(ref.state)):
        assert torch.equal(a, b)
    got, want = (second.store.checkpoint_arrays(),
                 ref.store.checkpoint_arrays())
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    meta = load_meta(str(tmp_path))
    meta["store_records"][0, -1] ^= 1
    third = _serve_t_engine()
    store = third.attach_store(500)
    with pytest.raises(ValueError, match="digest mismatch"):
        store.restore_arrays(meta)


def _gw(pkg):
    if pkg == "fedtpu":
        from fedtpu.serving import gateway, server
    else:
        from fedtpu_torch.serving import gateway, server
    return gateway, server


def _gw_engines(**kw) -> dict:
    """fedtpu's engine and the port's (fedtpu's init injected), both at
    fedtpu's gateway tests' shape (tick_interval 0)."""
    kw = dict(tick_interval_s=0.0, model_hidden=_A8C_HIDDEN, **kw)
    j = _serve_j_engine(**kw)
    return {"fedtpu": j, "port": _serve_t_engine(_serve_fedtpu_init(j), **kw)}


def test_gateway_routing_equals_fedtpus():
    """owner_of, redirect_msg, ownership after adoption and the client's
    partition and stamp, as fedtpu's (tests/test_gateway.py:54-83)."""
    from fedtpu.serving.client import GatewayClient as JClient
    from fedtpu_torch.serving.client import GatewayClient as TClient
    (jg, _), (tg, _) = _gw("fedtpu"), _gw("port")
    for user, n in ((5, 2), (4, 2), (7, 1), (3, 0), (11, 4)):
        assert tg.owner_of(user, n) == jg.owner_of(user, n)
    for base in ("/tmp/base", None):
        assert tg.redirect_msg(5, 1, 2, base) == jg.redirect_msg(5, 1, 2,
                                                                 base)
    for mod in (jg, tg):
        gw = mod._Gateway(0, 2, None, "gen", None)
        assert gw.owns_user(0) and gw.owns_user(4) and not gw.owns_user(1)
        gw.owned.add(1)
        assert gw.owns_user(1) and gw.owns_user(3)
    c, jc = TClient(port=1, num_gateways=3), JClient(port=1, num_gateways=3)
    assert [c.owner_of(u) for u in range(12)] == [
        jc.owner_of(u) for u in range(12)] == [
        tg.owner_of(u, 3) for u in range(12)]
    a, b = c.stamped({"op": "updates"}), c.stamped({"op": "updates"})
    assert a["nonce"] == b["nonce"] == c.nonce and b["seq"] == a["seq"] + 1
    with pytest.raises(ValueError, match="re-stamp"):
        c.stamped(a)


def test_gateway_retried_frame_and_wal_replay_equal_fedtpus(tmp_path):
    """fedtpu's exactly-once and WAL cases (tests/test_gateway.py:86-138)
    in both packages: the same acks, duplicate drops, incorporations and
    history; the WAL replayed into a fresh engine dedups the retry."""
    out = {}
    for pkg in ("fedtpu", "port"):
        _, server = _gw(pkg)
        eng = _gw_engines()[pkg]
        frame = {"op": "updates", "events": [[1, 0.1, 0.0], [2, 0.2, 0.0]],
                 "nonce": "n1", "seq": 1}
        first = server._handle(eng, frame)
        second = server._handle(eng, dict(frame))
        eng.drain()
        wal = str(tmp_path / f"{pkg}.wal")
        a = _gw_engines()[pkg]
        a.wal_path = wal
        ev1, ev2 = [[1, 0.1, 0.0], [2, 0.2, 0.0]], [[3, 0.3, 0.0]]
        server._handle(a, {"op": "updates", "events": ev1, "nonce": "n",
                           "seq": 1})
        r2 = server._handle(a, {"op": "updates", "events": ev2,
                                "nonce": "n", "seq": 2})
        b = _gw_engines()[pkg]
        b.wal_path = wal
        replayed = b.replay_wal()
        r2b = server._handle(b, {"op": "updates", "events": ev2,
                                 "nonce": "n", "seq": 2})
        b.drain()
        out[pkg] = (first, second, eng.duplicate_drops, eng.incorporated,
                    dict(eng.admission.counts), replayed, r2, r2b,
                    b.incorporated, b.history_lines(), open(wal).read())
    assert out["port"] == out["fedtpu"]
    first, second, drops, incorporated = out["port"][:4]
    assert second["duplicate"] and second["counts"] == first["counts"]
    assert drops == 2 and incorporated == 2
    assert out["port"][5] == 3 and out["port"][7]["duplicate"]


def test_gateway_handle_redirects_and_batches_atomic_equal_fedtpus():
    """fedtpu's handler case (tests/test_gateway.py:141-173): the welcome,
    an owned update, a redirected one, a redirect-atomic batch (nothing
    admitted, the seq not committed) and its re-partitioned resend, in
    both packages: equal responses and counters."""
    out = {}
    for pkg in ("fedtpu", "port"):
        gateway, _ = _gw(pkg)
        eng = _gw_engines()[pkg]
        gw = gateway._Gateway(0, 2, "/tmp/pf", "gen0", None)
        frames = [{"op": "hello", "v": j_proto.PROTOCOL_VERSION},
                  {"op": "update", "user": 2, "t": 0.1},
                  {"op": "update", "user": 3, "t": 0.1},
                  {"op": "updates", "events": [[0, 0.2, 0.0], [1, 0.2, 0.0]],
                   "nonce": "x", "seq": 1},
                  {"op": "updates", "events": [[0, 0.2, 0.0]], "nonce": "x",
                   "seq": 1},
                  {"op": "update", "user": "bad"}]
        resps = [gateway._gateway_handle(gw, eng, f) for f in frames]
        out[pkg] = (resps, gw.redirects, dict(eng.admission.counts),
                    eng.registry.snapshot()["counters"]["gateway_redirects"])
    assert out["port"] == out["fedtpu"]
    resps = out["port"][0]
    assert resps[0]["owned"] == [0] and resps[0]["generation"] == "gen0"
    assert resps[2]["redirect"]["gateway"] == 1
    assert resps[3]["redirect"]["owners"] == {"1": 1}
    assert resps[4]["op"] == "acks" and "duplicate" not in resps[4]
    assert out["port"][1] == 2


def test_gateway_flush_adopt_handoff_equals_fedtpus(tmp_path):
    """fedtpu's store-shard failover (tests/test_gateway.py:176-219) in
    both packages: gateway 1 flushes (writeback, spool, digest-stamped and
    generation-fenced checkpoint), gateway 0 refuses a stale generation,
    adopts the export bitwise and replays the spool; the acks, store
    headers and spool files equal fedtpu's, the values within 1e-5."""
    out, stores = {}, {}
    for pkg in ("fedtpu", "port"):
        gateway, _ = _gw(pkg)
        e0, e1 = _gw_engines()[pkg], _gw_engines()[pkg]
        s0 = e0.attach_store(40, shard_index=0, num_shards=2)
        s1 = e1.attach_store(40, shard_index=1, num_shards=2)
        s0.generation = s1.generation = "genA"
        d = tmp_path / pkg
        gw0 = gateway._Gateway(0, 2, None, "genA", str(d / "g0"))
        gw1 = gateway._Gateway(1, 2, None, "genA", str(d / "g1"))
        for u in (1, 3, 5, 9, 11, 13, 15, 17, 19, 21):
            assert gateway._gateway_handle(
                gw1, e1, {"op": "update", "user": u, "t": 0.1})["op"] == "ack"
        e1.drain()
        gateway._gateway_handle(gw1, e1, {"op": "update", "user": 7,
                                          "t": 9.9})
        spool = str(d / "spool.jsonl")
        fl = gateway._gateway_handle(gw1, e1, {"op": "flush", "path": spool})
        bad = gateway._gateway_handle(gw0, e0, {
            "op": "adopt", "shard": 1, "checkpoint_dir": str(d / "g1"),
            "generation": "genB"})
        ad = gateway._gateway_handle(gw0, e0, {
            "op": "adopt", "shard": 1, "checkpoint_dir": str(d / "g1"),
            "spool": fl["spool"], "generation": "genA"})
        ids = np.array(sorted(s1._touched), np.int64)
        assert s0.owns(ids).all() and gw0.owns_user(3)
        for want, have in zip(s1.read(ids), s0.read(ids)):
            np.testing.assert_array_equal(want, have)   # bitwise handoff
        assert _store_headers(s0, ids) == _store_headers(s1, ids)
        assert any(p.user == 7 for p in e0.pending)
        out[pkg] = ({k: v for k, v in fl.items()
                     if k not in ("checkpoint", "spool")},
                    bad["op"], "generation" in bad["reason"], ad,
                    open(spool).read(), _store_headers(s0, ids),
                    e0.registry.snapshot()["counters"]["gateway_adoptions"])
        stores[pkg] = (e1, s0, ids)
    assert out["port"] == out["fedtpu"]
    fl, bad_op, fenced, ad = out["port"][:4]
    assert fl["spooled"] == 1 and fl["slots"] == 8 and bad_op == "error"
    assert fenced and ad["owned"] == [0, 1] and ad["replayed"] == 1
    assert ad["rows"] == 10
    (je1, js0, ids), (_, ts0, _) = stores["fedtpu"], stores["port"]
    for got, want in zip(ts0.read(ids), _store_values_as_port(je1, js0,
                                                              ids)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _gw_fleet(pkg, tmp_path, **kw):
    """Two run_gateway threads (once=True) of ``pkg`` behind one port-file
    base; the port's on the CPU."""
    gateway, _ = _gw(pkg)
    cfg_mod = jcfg if pkg == "fedtpu" else tcfg
    extra = {} if pkg == "fedtpu" else {"device": "cpu"}
    pf = str(tmp_path / "port")
    box = {}

    def run(g):
        box[g] = gateway.run_gateway(
            cfg_mod.ServingConfig(**_serve_kw()), gateway_index=g,
            num_gateways=2, port_file=pf, once=True, verbose=False,
            history_path=str(tmp_path / "hist.jsonl"), **kw, **extra)

    threads = [threading.Thread(target=run, args=(g,)) for g in (0, 1)]
    for th in threads:
        th.start()
    return pf, threads, box


@pytest.mark.parametrize("client, fleet", [("port", "port"),
                                           ("fedtpu", "port"),
                                           ("port", "fedtpu")])
def test_gateway_two_fleet_over_the_wire(tmp_path, client, fleet):
    """fedtpu's in-process fleet case (tests/test_gateway.py:222-259):
    two gateway threads behind one port-file base, fed by the
    partitioning client, a misrouted frame's redirect followed, 41
    updates incorporated exactly once; the port's client against the
    port's fleet, fedtpu's client against the port's fleet (with a store
    attached), the port's client against fedtpu's fleet."""
    if client == "fedtpu":
        from fedtpu.serving.client import GatewayClient
    else:
        from fedtpu_torch.serving.client import GatewayClient
    kw = ({"total_users": 100, "checkpoint_dir": str(tmp_path / "ck")}
          if fleet == "port" else {})
    pf, threads, box = _gw_fleet(fleet, tmp_path, **kw)
    try:
        with GatewayClient(port_file=pf, num_gateways=2, seed=0) as c:
            w = c.hello(0)
            assert w["gateway"] == 0 and w["num_gateways"] == 2
            events = [[k % 10, 0.05 * k, 0.0] for k in range(40)]
            assert sum(c.send_events(events).values()) == 40
            resp = c.request(c.stamped({"op": "update", "user": 1,
                                        "t": 5.0}), gateway=0)
            assert resp["op"] == "ack" and c.stats["redirected"] >= 1
            drains = c.request_each({"op": "drain"})
            assert sum(r["incorporated"] for r in drains.values()) == 41
    finally:
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert sum(box[g]["incorporated"] for g in (0, 1)) == 41
    for g in (0, 1):
        assert os.path.exists(f"{tmp_path / 'hist.jsonl'}.g{g}")
    if fleet == "port":
        # The drain-time checkpoint of each member carries its store.
        from fedtpu_torch.orchestration.checkpoint import load_meta
        for g in (0, 1):
            meta = load_meta(str(tmp_path / "ck" / f"g{g}"))
            assert int(meta["store_shard_index"]) == g
            assert set(np.asarray(meta["store_ids"]) % 2) <= {g}


def test_gateway_probe_fleet_equals_fedtpus(tmp_path):
    """probe_fleet, the port's and fedtpu's, each over a live port gateway
    (its first connection ends a ``once`` server, so one gateway each): a
    healthy row with the same fields; a fleet that never came up gives
    the same error rows and raises nothing."""
    from fedtpu.serving.gateway import probe_fleet as j_probe
    from fedtpu_torch.serving.gateway import probe_fleet, run_gateway
    rows = {}
    for name, probe in (("port", probe_fleet), ("fedtpu", j_probe)):
        pf = str(tmp_path / f"{name}.port")
        th = threading.Thread(target=run_gateway, kwargs=dict(
            cfg=tcfg.ServingConfig(**_serve_kw()), gateway_index=0,
            num_gateways=1, port_file=pf, once=True, verbose=False,
            device="cpu"))
        th.start()
        try:
            rows[name] = probe(pf, 1, timeout=30)[0]
        finally:
            th.join(timeout=60)
        assert not th.is_alive()
        rows[name].pop("port")
        rows[name].pop("port_file")
    assert rows["port"] == rows["fedtpu"]
    assert rows["port"] == {"gateway": 0, "ok": True, "version": 0,
                            "gateway_reported": 0, "backlog": 0}
    dead = probe_fleet(str(tmp_path / "nope"), 2, timeout=0.2)
    assert dead == j_probe(str(tmp_path / "nope"), 2, timeout=0.2)
    assert not any(r["ok"] for r in dead) and all("error" in r for r in dead)


def _net_mini_server(engine, handle, stop) -> int:
    """fedtpu's netfault tests' mini server: a thread per connection, one
    engine behind a lock (reconnects are what faults cause)."""
    import socket as _socket
    lsock = _socket.socket()
    lsock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    lsock.settimeout(0.2)
    lock = threading.Lock()

    def serve_conn(csock):
        csock.settimeout(0.2)
        buf = t_proto.LineBuffer()
        try:
            while not stop.is_set():
                try:
                    lines = list(t_proto.recv_lines(csock, buf))
                except _socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    return
                for line in lines:
                    msg = t_proto.parse_msg(line) if line else None
                    with lock:
                        resp = (handle(engine, msg) if msg is not None
                                else t_proto.error_msg("malformed"))
                    t_proto.send_msg(csock, resp)
        finally:
            csock.close()

    def accept_loop():
        while not stop.is_set():
            try:
                csock, _ = lsock.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=serve_conn, args=(csock,),
                             daemon=True).start()
        lsock.close()

    threading.Thread(target=accept_loop, daemon=True).start()
    return lsock.getsockname()[1]


_NET_CASES = {
    "torn post_ack": {"seed": 0, "faults": [
        {"kind": "net_torn_frame", "gateway": 0, "frame": 2,
         "boundary": "post_ack", "cut_bytes": 32}]},
    "dup frame": {"seed": 0, "faults": [
        {"kind": "net_dup_frame", "gateway": 0, "frame": 2}]},
    "accounting": {"seed": 0, "faults": [
        {"kind": "net_reset", "gateway": 0, "frame": 2, "phase": "accept"}]},
}


@pytest.mark.parametrize("case", list(_NET_CASES))
def test_netfault_proxy_exactly_once_equals_fedtpus(tmp_path, case):
    """fedtpu's proxy cases (tests/test_netfaults.py:307-400) through each
    package's proxy, client and engine: the torn ack is retried and
    deduplicated, the replayed frame absorbed with its original verdicts,
    the accounting and the decision log's summary; the port's numbers
    equal fedtpu's."""
    import time
    out = {}
    for pkg in ("fedtpu", "port"):
        if pkg == "fedtpu":
            from fedtpu.resilience.netfaults import NetFaultPlan
            from fedtpu.serving.client import GatewayClient
            from fedtpu.serving.netproxy import NetFaultProxy
            from fedtpu.serving.server import _handle
        else:
            from fedtpu_torch.resilience.netfaults import NetFaultPlan
            from fedtpu_torch.serving.client import GatewayClient
            from fedtpu_torch.serving.netproxy import NetFaultProxy
            from fedtpu_torch.serving.server import _handle
        d = tmp_path / pkg
        d.mkdir()
        stop = threading.Event()
        eng = _gw_engines()[pkg]
        port = _net_mini_server(eng, _handle, stop)
        plan = NetFaultPlan.load(_NET_CASES[case], num_gateways=1)
        base = str(d / "port")
        proxy = NetFaultProxy(plan, 0, port, t_proto.net_proxy_port_file(
            base)).start()
        (d / "port").write_text(str(port))
        client = GatewayClient(port_file=base, retries=8, backoff_s=0.01,
                               timeout=5.0, seed=0)
        try:
            events = [[1, 0.1, 0.0], [2, 0.2, 0.0], [3, 0.3, 0.0]]
            counts = client.send_events(events)
            deadline = time.monotonic() + 5.0
            while (case == "dup frame" and eng.duplicate_drops < 3
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            # Closed first, so the proxy's relay threads end at once.
            client.close()
            stats = proxy.finish()
            eng.drain()
            log = (d / "port.netlog").read_text().splitlines()
            out[pkg] = (counts, client.stats["retried"] >= 1, client._seq,
                        eng.duplicate_drops, eng.incorporated,
                        stats["fired"], stats["frames"],
                        stats["relayed_frames"], stats["digest"],
                        [r["at_frame"] for r in proxy.records],
                        json.loads(log[-1]))
        finally:
            stop.set()
            proxy.stop()
            client.close()
    assert out["port"] == out["fedtpu"]
    counts, retried, seq, drops, incorporated, fired = out["port"][:6]
    assert sum(counts.values()) == 3 and incorporated == 3 and seq == 1
    if case == "torn post_ack":
        assert retried and drops == 3 and fired == {"net_torn_frame": 1}
    elif case == "dup frame":
        assert not retried and drops == 3 and fired == {"net_dup_frame": 1}
    else:
        assert drops == 0 and fired == {} and out["port"][6] == 2


def test_net_sim_equals_golden_and_fedtpus():
    """The port's net sim (fedtpu's initial params injected) writes the
    committed golden's 25 lines, which fedtpu's in-process simulate()
    writes too; the summaries equal: every kind fired, no acked update
    lost, duplicates absorbed."""
    from fedtpu.resilience import net_sim as j_sim
    from fedtpu.serving.engine import ServingEngine
    from fedtpu_torch.resilience import net_sim as t_sim
    for name in ("SIM_USERS", "SIM_ARRIVALS", "SIM_HORIZON_S", "SIM_SEED",
                 "SIM_BATCH", "SIM_COHORT", "SIM_BUFFER",
                 "SIM_TICK_INTERVAL_S", "SIM_NONCE", "SIM_PLAN"):
        assert getattr(t_sim, name) == getattr(j_sim, name), name
    init = _serve_fedtpu_init(ServingEngine(j_sim._sim_config(),
                                            registry=JRegistry()))
    got = t_sim.simulate(device="cpu", init_params=init)
    cmp = t_sim.compare_decisions(got["lines"], os.path.join(
        _A8C_GOLDENS, "net_sim.jsonl"))
    assert cmp["ok"], cmp["reason"]
    want = j_sim.simulate()
    assert got["lines"] == want["lines"]
    assert got["summary"] == want["summary"]
    s = got["summary"]
    assert s["lost_acked"] == 0 and s["duplicate_drops"] > 0
    assert len(s["fired"]) == 5 and s["incorporated"] == s["arrivals"]


def _net_serve_once(tmp_path, tag, plan, trace):
    """run_server behind the proxy (a thread, once=True) fed by the port's
    loadgen through ``<port_file>.net``: the loadgen's summary, the
    server's and the decision log's bytes."""
    from fedtpu_torch.serving.loadgen import run_loadgen
    from fedtpu_torch.serving.server import run_server
    pf = str(tmp_path / f"{tag}.port")
    th, box = _serve_in_thread(run_server, tcfg.ServingConfig(**_serve_kw()),
                               pf, device="cpu", net_fault_plan=plan)
    try:
        res = run_loadgen(trace, port_file=pf, batch=40, backoff_s=0.01)
    finally:
        th.join(timeout=120)
    assert not th.is_alive()
    return res, box["summary"], (tmp_path / f"{tag}.port.netlog").read_text()


def test_netfault_serve_behind_the_proxy_is_exactly_once(tmp_path):
    """``serve --net-fault-plan`` as run_server takes it: the proxy's port
    file is found through the real one, a paced frame and a replayed one
    reach the engine, every update the loadgen was told was admitted is
    incorporated once (lost_acked 0), the duplicate is dropped, and the
    decision log is byte-identical across two runs."""
    plan = json.dumps({"seed": 5, "faults": [
        {"kind": "net_slow_link", "gateway": 0, "frame": 2, "frames": 2,
         "chunk_bytes": 256},
        {"kind": "net_dup_frame", "gateway": 0, "frame": 4}]})
    header, t, user, lat = _serve_trace(arrivals=160)
    trace = str(tmp_path / "trace.jsonl")
    t_traces.write_trace(trace, header, t, user, lat)
    runs = [_net_serve_once(tmp_path, tag, plan, trace) for tag in "ab"]
    (res, summary, log), (res_b, _, log_b) = runs
    admitted = sum(n for v, n in res["admission"].items()
                   if v in t_adm.ADMITTED)
    assert res["events_sent"] == 160 and admitted - summary[
        "incorporated"] == 0
    assert summary["duplicate_drops"] == 40 and res["retried"] == 0
    assert log == log_b and res_b["admission"] == res["admission"]
    lines = [json.loads(x) for x in log.splitlines()]
    assert lines[-1]["summary"]["fired"] == {"net_dup_frame": 1,
                                             "net_slow_link": 2}


def test_autoscale_sim_equals_golden_and_fedtpus():
    from fedtpu.autoscale import controller as j_ctl
    from fedtpu_torch.autoscale import controller as t_ctl
    got, want = t_ctl.simulate(), j_ctl.simulate()
    cmp = t_ctl.compare_decisions(got["lines"], os.path.join(
        _A8C_GOLDENS, "autoscale_sim.jsonl"))
    assert cmp["ok"], cmp["reason"]
    assert got["lines"] == want["lines"] and got["summary"] == want["summary"]
    for name in ("SIM_USERS", "SIM_ARRIVALS", "SIM_HORIZON_S", "SIM_SEED",
                 "SIM_PROCESSES", "SIM_NOTICE_AT_S", "SIM_NOTICE_VICTIM",
                 "SIM_TICK_INTERVAL_S"):
        assert getattr(t_ctl, name) == getattr(j_ctl, name), name
    assert t_ctl.SIM_ADMISSION.__dict__ == j_ctl.SIM_ADMISSION.__dict__


@pytest.mark.parametrize("controller", ["port", "fedtpu"])
def test_autoscale_live_controller_acts_on_the_port_server(tmp_path,
                                                           controller):
    """A LiveController (the port's, and fedtpu's against the port's
    server) for three control ticks on a loaded CPU server: its polls
    read the signals block (the backlog it folds is the server's), a
    preemption notice makes it pre-drain then shrink, and the server acks
    the pre_drain with the spooled backlog."""
    if controller == "fedtpu":
        from fedtpu.autoscale.controller import LiveController
        acfg = jcfg.AutoscaleConfig(hysteresis_ticks=5)
    else:
        from fedtpu_torch.autoscale.controller import LiveController
        acfg = tcfg.AutoscaleConfig(hysteresis_ticks=5)
    from fedtpu_torch.serving.loadgen import read_port_file
    from fedtpu_torch.serving.server import run_server
    pf = str(tmp_path / "port")
    th, box = _serve_in_thread(run_server, tcfg.ServingConfig(**_serve_kw(
        tick_interval_s=0.0)), pf, device="cpu")
    notice, spool = str(tmp_path / "notice.json"), str(tmp_path / "sp.jsonl")
    ctl = LiveController(acfg, port=read_port_file(pf, timeout=60),
                         notice_file=notice, spool_path=spool)
    acks = []
    try:
        conn = ctl._connection()
        request = conn.request

        def recorded(obj, *a, **kw):
            resp = request(obj, *a, **kw)
            acks.append((obj["op"], resp))
            return resp

        conn.request = recorded
        _, t, user, lat = _serve_trace(arrivals=60)
        conn.send_events(_serve_rows(t, user, lat))
        snaps = []
        for k in range(3):
            if k == 1:
                with open(notice, "w") as fh:
                    json.dump({"victim": 0}, fh)
            snaps.append(ctl.step(now=float(k)))
    finally:
        if ctl._conn is not None:
            ctl._conn.close()
        th.join(timeout=60)
    assert not th.is_alive()
    kinds = [[d.kind for d in decisions] for _, decisions in snaps]
    assert kinds == [["hold"], ["pre_drain", "shrink"], ["hold"]]
    assert snaps[0][0].backlog == 60 and snaps[1][0].notice == 0
    pre = [resp for op, resp in acks if op == "pre_drain"]
    assert len(pre) == 1 and pre[0]["op"] == "pre_drained"
    assert pre[0]["spooled"] == 60 and len(open(spool).readlines()) == 60
    assert ctl.acted == {"pre_drain": 1, "shrink": 1}
    assert box["summary"]["incorporated"] == 60


def test_cli_gateway_fleet_and_loadgen_on_cpu(tmp_path, capsys):
    """``gateway --num-gateways 2 --total-users ...`` twice (threads,
    ``--once``, ``--platform cpu``) answered by ``loadgen --num-gateways 2
    --synthesize --json``: every event sent is acked and incorporated
    once across the fleet, each member writes its history."""
    from fedtpu_torch.cli import main as t_main
    pf, hist = str(tmp_path / "port"), str(tmp_path / "hist.jsonl")
    small = ["--cohort", "8", "--buffer-size", "2", "--platform", "cpu",
             "--quiet", "--once"]
    threads = [threading.Thread(target=t_main, args=([
        "gateway", "--num-gateways", "2", "--gateway-index", str(g),
        "--total-users", "1000", "--port-file", pf, "--history", hist,
        "--checkpoint-dir", str(tmp_path / "ck")] + small,))
        for g in (0, 1)]
    for th in threads:
        th.start()
    try:
        rc = t_main(["loadgen", str(tmp_path / "t.jsonl"), "--synthesize",
                     "--users", "1000", "--arrivals", "300", "--horizon", "6",
                     "--port-file", pf, "--num-gateways", "2", "--batch",
                     "64", "--json", "--quiet"])
    finally:
        for th in threads:
            th.join(timeout=120)
    assert rc == 0 and not any(th.is_alive() for th in threads)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    stats = res["server_stats"]
    assert res["events_sent"] == 300 and set(stats) == {"0", "1"}
    admitted = sum(n for v, n in res["admission"].items()
                   if v in t_adm.ADMITTED)
    assert sum(s["incorporated"] for s in stats.values()) == admitted > 0
    for g in (0, 1):
        assert os.path.getsize(f"{hist}.g{g}") > 0


# ----------------------------------------------------------------- refusals

def test_serving_unported_paths_raise_naming_their_items():
    from fedtpu_torch.serving.gateway import run_gateway
    from fedtpu_torch.serving.server import run_server
    cfg = tcfg.ServingConfig(**_serve_kw())
    for run in (run_server, run_gateway):
        with pytest.raises(NotImplementedError, match=r"\(ROADMAP A11\)"):
            run(cfg, device="cpu", verbose=False, heartbeat="x")


def test_serving_config_has_fedtpus_fields_and_defaults():
    j_fields = [(f.name, f.default) for f in
                dataclasses.fields(jcfg.ServingConfig)]
    t_fields = [(f.name, f.default) for f in
                dataclasses.fields(tcfg.ServingConfig)]
    assert t_fields == j_fields


def test_serving_engine_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fedtpu_torch.serving.engine import ServingEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg.ServingConfig(**_serve_kw()))
    with pytest.raises(ValueError, match="CUDA graph needs CUDA tensors"):
        ServingEngine(tcfg.ServingConfig(**_serve_kw()), device="cpu",
                      capture=True)


def test_gateway_and_sims_on_the_card_need_one(tmp_path):
    """``gateway`` (the CLI and run_gateway) and the net sim run on the
    card unless asked for the CPU: without one they raise before binding
    a port; the autoscale sim needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fedtpu_torch.cli import main as t_main
    from fedtpu_torch.resilience.net_sim import simulate
    from fedtpu_torch.serving.gateway import run_gateway
    pf = str(tmp_path / "port")
    for call in (lambda: t_main(["gateway", "--num-gateways", "2",
                                 "--gateway-index", "1", "--port-file", pf,
                                 "--quiet"]),
                 lambda: run_gateway(tcfg.ServingConfig(**_serve_kw()),
                                     port_file=pf, verbose=False),
                 lambda: simulate()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(pf) and not os.path.exists(f"{pf}.g1")
    assert t_main(["autoscale", "--simulate", "--quiet"]) == 0


# --------------------------------------------- A9: the cohort engine
# A population of 16 clients (hidden (16,)) through cohorts of 4, against
# fedtpu's run_cohort_experiment from fedtpu's inits; and the port's own
# contracts: full participation is its synchronous run, a lazily
# initialised record is its slot there, mmap is memory, resume is the
# uninterrupted run.

def _cohort_configs(clients=16, cohort=4, rounds=3, rows=512, run=None,
                    **fed):
    run = run or {}

    def cfg(mod, data):
        return mod.ExperimentConfig(
            data=data, shard=mod.ShardConfig(num_clients=clients),
            model=mod.ModelConfig(hidden_sizes=(16,)),
            fed=mod.FedConfig(rounds=rounds, cohort_size=cohort, **fed),
            run=mod.RunConfig(**run))
    return (cfg(jcfg, jcfg.DataConfig(csv_path=None, synthetic_rows=rows)),
            cfg(tcfg, tcfg.DataConfig(synthetic_rows=rows)))


def _fedtpu_population_init(j_cfg):
    """fedtpu's init of every client: its cohort engine draws client c's
    from the same key table as its synchronous engine."""
    return _fedtpu_init(j_cfg.replace(fed=dataclasses.replace(
        j_cfg.fed, cohort_size=0)))


def _cohort_trace(path):
    header, t, user, lat = t_traces.synthesize_trace(users=64, arrivals=400,
                                                     seed=3)
    t_traces.write_trace(path, header, t, user, lat)
    return path


# rows=16: 12 train rows, one a client for clients 0-11; 12-15 dataless.
_COHORT_CASES = {
    "data_size-weighted-sampling": dict(
        cohort_sampling="weighted", cohort_seed=3,
        run=dict(rounds_per_step=2, eval_test_every=1)),
    "uniform-dataless": dict(rows=16, weighting="uniform",
                             run=dict(rounds_per_step=2)),
    "ring-2-shards-trace": dict(aggregation="ring", cohort_sampling="trace",
                                run=dict(mesh_devices=2,
                                         eval_test_every=2)),
    "median-dataless": dict(rows=16, weighting="uniform",
                            robust_aggregation="median"),
    "trimmed_mean": dict(weighting="uniform", cohort_seed=1,
                         robust_aggregation="trimmed_mean", trim_ratio=0.25),
}


@pytest.mark.parametrize("case", sorted(_COHORT_CASES))
def test_cohort_run_matches_fedtpu(case, tmp_path):
    """3 rounds of 4-client cohorts out of 16, from fedtpu's inits: the
    same sampled cohorts train to the same client-mean, pooled and
    per-client histories and held-out rows (the tail chunk truncated on
    the host, the eval on fedtpu's cadence), losses within 1e-5, final
    params within 1e-4 (the synchronous run's tolerances)."""
    kw = dict(_COHORT_CASES[case])
    if kw.get("cohort_sampling") == "trace":
        kw["cohort_trace"] = _cohort_trace(str(tmp_path / "trace.jsonl"))
    j_cfg, t_cfg = _cohort_configs(**kw)
    rj = j_run(j_cfg, verbose=False)
    rt = t_run(t_cfg, verbose=False, device="cpu",
               init_params=_fedtpu_population_init(j_cfg))
    assert rt.rounds_run == rj.rounds_run == 3
    assert len(rt.confusion) == 3 and rt.rounds_trained >= 3
    np.testing.assert_allclose(np.stack(rt.loss), np.stack(rj.loss),
                               atol=1e-5)
    for name in METRIC_NAMES:
        assert rt.global_metrics[name] == pytest.approx(
            rj.global_metrics[name], abs=1e-6)
        assert rt.pooled_metrics[name] == pytest.approx(
            rj.pooled_metrics[name], abs=1e-6)
        np.testing.assert_allclose(np.stack(rt.per_client_metrics[name]),
                                   np.stack(rj.per_client_metrics[name]),
                                   atol=1e-6)
        assert len(rt.test_metrics[name]) == len(rj.test_metrics[name])
        np.testing.assert_allclose(rt.test_metrics[name],
                                   rj.test_metrics[name], atol=1e-6)
    # Equal per-client accuracies are equal confusion counts' diagonals.
    for conf, acc in zip(rt.confusion, rj.per_client_metrics["accuracy"]):
        rows = conf.sum(axis=(1, 2))
        np.testing.assert_array_equal(
            np.trace(conf, axis1=1, axis2=2),
            np.round(np.asarray(acc) * np.maximum(rows, 1)))
    for a, b in zip(jax.tree.leaves(rt.final_params),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 rj.final_params))):
        np.testing.assert_allclose(a, b, atol=1e-4)
    if case.startswith("data_size"):
        # Held-out rows on fedtpu's cadence: 2 from the first chunk, and
        # round 3 only from the truncated tail chunk.
        assert len(rt.test_metrics["accuracy"]) == 3


def _assert_runs_bitwise(a, b):
    assert a.rounds_run == b.rounds_run
    for name in METRIC_NAMES:
        assert a.global_metrics[name] == b.global_metrics[name]
        assert a.pooled_metrics[name] == b.pooled_metrics[name]
        assert a.test_metrics[name] == b.test_metrics[name]
    for x, y in zip(a.loss + a.confusion, b.loss + b.confusion):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(a.final_params),
                    jax.tree.leaves(b.final_params)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_cohort_full_participation_is_the_synchronous_run(param_dtype):
    """cohort_size == num_clients, with NO injected init: the port's cohort
    engine initialises each client lazily from the seed table and gives
    the port's own synchronous run bit for bit: histories, losses,
    confusion counts, held-out rows, final params (bfloat16 records held
    as their bits)."""
    _, t_cfg = _cohort_configs(clients=8, cohort=8, run=dict(
        eval_test_every=1))
    t_cfg = t_cfg.replace(model=dataclasses.replace(
        t_cfg.model, param_dtype=param_dtype))
    sync = t_run(t_cfg.replace(fed=dataclasses.replace(t_cfg.fed,
                                                       cohort_size=0)),
                 verbose=False, device="cpu")
    coh = t_run(t_cfg, verbose=False, device="cpu")
    assert len(coh.confusion) == 3 and len(coh.test_metrics["f1"]) == 3
    _assert_runs_bitwise(coh, sync)


@pytest.mark.parametrize("same_init", [False, True])
def test_cohort_lazy_init_is_the_synchronous_slot(same_init):
    """A client first touched in a cohort gets the params its slot holds
    in init_federated_state (and a fresh optimizer state), whichever
    clients came before it; its header key is its seed."""
    from fedtpu_torch.cohort.scheduler import build_cohort_scheduler
    from fedtpu_torch.data import load_dataset
    _, t_cfg = _cohort_configs(init_seed=7, same_init=same_init)
    sched = build_cohort_scheduler(t_cfg, load_dataset(t_cfg.data),
                                   torch.device("cpu"))
    ids = np.array([13, 2, 9, 0], np.int64)
    try:
        assert sched.ensure_init(ids[:2]) == 2
        assert sched.ensure_init(ids) == 2          # 13 and 2 are kept
    finally:
        sched.close()
    state = t_round.init_federated_state(7, 16, sched.model, sched.tx,
                                         same_init=same_init)
    count, mu, nu, params = sched.store.read(ids)
    np.testing.assert_array_equal(params, state["params"][ids].numpy())
    assert not count.any() and not mu.any() and not nu.any()
    np.testing.assert_array_equal(sched.store.versions(ids), 1)
    np.testing.assert_array_equal(sched.store.participation(ids), 0)
    seeds = t_round.client_init_seeds(7, 16, same_init)
    np.testing.assert_array_equal(
        sched.store.read_keys(ids).view(np.uint64).ravel(), seeds[ids])
    # seed_from_state: slot j of an engine state becomes client ids[j].
    rev = np.arange(16)[::-1].copy()
    sched.seed_from_state(state, 16, rev)
    for got, want in zip(sched.store.read(rev),
                         t_round.per_client_view(state, 16)):
        np.testing.assert_array_equal(got, want.numpy())


def test_cohort_mmap_store_is_bitwise_memory(tmp_path):
    _, t_cfg = _cohort_configs(rounds=4, run=dict(rounds_per_step=2))
    mem = t_run(t_cfg, verbose=False, device="cpu")
    mm = t_run(t_cfg.replace(fed=dataclasses.replace(
        t_cfg.fed, client_store="mmap",
        client_store_path=str(tmp_path / "store.bin"))),
        verbose=False, device="cpu")
    _assert_runs_bitwise(mm, mem)
    assert os.path.getsize(tmp_path / "store.bin") > 0


def test_cohort_checkpoint_resume_is_bitwise(tmp_path):
    """Stop after round 4, resume to 6: the history and the final params
    of the uninterrupted 6-round run (the store's records ride the
    checkpoint)."""
    _, t_cfg = _cohort_configs(rounds=6)

    def cfg(rounds, directory):
        return t_cfg.replace(
            fed=dataclasses.replace(t_cfg.fed, rounds=rounds),
            run=dataclasses.replace(t_cfg.run, checkpoint_every=2,
                                    checkpoint_dir=str(tmp_path /
                                                       directory)))
    ref = t_run(cfg(6, "ref"), verbose=False, device="cpu")
    t_run(cfg(4, "split"), verbose=False, device="cpu")
    assert ckpt.latest_step(str(tmp_path / "split")) == 4
    resumed = t_run(cfg(6, "split"), verbose=False, device="cpu",
                    resume=True)
    assert resumed.rounds_run == 6
    for name in METRIC_NAMES:
        assert resumed.global_metrics[name] == ref.global_metrics[name]
    for x, y in zip(jax.tree.leaves(resumed.final_params),
                    jax.tree.leaves(ref.final_params)):
        np.testing.assert_array_equal(x, y)


def test_cohort_store_resident_bytes_track_touched_clients():
    """Two chunks of two 4-client cohorts: the store's resident bytes are
    the touched records' (at most the chunks' members and the next
    chunk's lazily initialised ones), the same bound at a population of
    64 and of 20,000; its apparent bytes are the population's."""
    from fedtpu_torch.cohort.scheduler import build_cohort_scheduler
    from fedtpu_torch.data import load_dataset
    for clients in (64, 20_000):
        _, t_cfg = _cohort_configs(clients=clients, run=dict(
            rounds_per_step=2))
        sched = build_cohort_scheduler(t_cfg, load_dataset(t_cfg.data),
                                       torch.device("cpu"))
        try:
            for _ in range(2):
                sched.run_chunk()
        finally:
            sched.close()
        store = sched.store
        assert store.apparent_nbytes == clients * store.record_bytes
        assert 8 <= len(store._touched) <= 3 * 2 * 4
        assert store.resident_estimate_bytes() == (len(store._touched)
                                                   * store.record_bytes)


def test_cohort_prefetch_error_propagates():
    """A chunk whose prefetch fails raises from run_chunk, and close()
    returns (the write-back event released first)."""
    from fedtpu_torch.cohort.scheduler import (CohortSampler,
                                               build_cohort_scheduler)
    from fedtpu_torch.data import load_dataset
    _, t_cfg = _cohort_configs()
    sched = build_cohort_scheduler(t_cfg, load_dataset(t_cfg.data),
                                   torch.device("cpu"))
    sched.sampler = CohortSampler(16, 4, policy="trace",
                                  trace_users=np.array([1, 1, 2], np.int64))
    with pytest.raises(ValueError, match="distinct users"):
        sched.run_chunk()
    done = threading.Event()
    closer = threading.Thread(target=lambda: (sched.close(), done.set()))
    closer.start()
    closer.join(timeout=60)
    assert done.is_set()


# -------------------------------------------------- subprocess (full tier)

@pytest.mark.slow
def test_serving_sigterm_drains_checkpoints_and_exits_75(tmp_path):
    """SIGTERM mid-serve: drain, checkpoint, exit EXIT_PREEMPTED (75)."""
    from fedtpu_torch.serving.loadgen import run_loadgen
    pf = tmp_path / "port"
    ckpt = tmp_path / "ckpt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedtpu_torch.cli", "serve", "--platform",
         "cpu", "--port-file", str(pf), "--buffer-size", "2",
         "--checkpoint-dir", str(ckpt), "--quiet"], cwd=_SERVE_REPO)
    try:
        header, t, user, lat = _serve_trace(arrivals=100)
        trace = tmp_path / "trace.jsonl"
        t_traces.write_trace(str(trace), header, t, user, lat)
        run_loadgen(str(trace), port_file=str(pf), drain=False)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == 75
    rounds = [p for p in os.listdir(ckpt) if p.startswith("round_")]
    assert rounds, "SIGTERM drain wrote no checkpoint"


# ------------------------------------------ A11a: a run's events vs fedtpu
# The same run on both packages writes the same sequence of (kind, phase,
# round) and the same payload values, clocks and host timings aside. The
# differences by design, named:
# - fedtpu's ``compile`` spans (the first dispatch at each chunk width
#   compiles its program); the port compiles none (its CUDA graphs'
#   captures count in the counters, on the card);
# - the manifest's backend fields (backend, device_count, device_kinds,
#   torch_version for jax_version, no compilation_cache), its mesh (fedtpu
#   runs its CPU tests on an 8-device virtual mesh) and its ``profile``
#   (fedtpu's is XLA's cost model, the port's counts from the shapes,
#   tests/test_torch_ops.py::test_flops_per_round_is_the_flop_counters_count)
#   and fedtpu's ``audit`` entry (ROADMAP A11d);
# - a cohort run's store bytes (the port's record layout) and touched
#   records (the port's last chunk prefetches no next chunk);
# - in the counters: fedtpu's jax_compile_events / jax_compile_secs, its
#   live_array_* gauges on the CPU (the port sets device gauges on the card
#   only) and checkpoint_bytes_written (the port's checkpoint is its flat
#   state in torch.save files, not fedtpu's orbax pytree).
_MANIFEST_SAME = ("argv", "config", "config_hash", "engine", "git_rev",
                  "package_version", "process_count", "process_index",
                  "program", "python_version", "restarts")
_COUNTERS_FEDTPU_ONLY = {"jax_compile_events", "jax_compile_secs",
                         "checkpoint_bytes_written"}
_GAUGES_FEDTPU_ONLY = {"live_array_count", "live_array_bytes"}
# Host timings, and the cohort store's bytes (its record layout), on both.
_HOST_OR_LAYOUT = {"cohort_prefetch_stalls", "cohort_prefetch_stall_s",
                   "client_store_resident_bytes",
                   "client_store_apparent_bytes"}


def _with_sink(cfg, mod, path, **run):
    return cfg.replace(run=dataclasses.replace(
        cfg.run, telemetry=mod.TelemetryConfig(events_path=path), **run))


def _sink(path):
    from fedtpu_torch.telemetry.report import load_events
    events, bad = load_events(str(path))
    assert bad == 0 and events
    return events


def _event_pair(j_cfg, t_cfg, tmp_path, **t_kw):
    """fedtpu's run and the port's of the same config (the same events
    path and checkpoint dir, each moved aside after fedtpu's run so the
    two configs hash alike); returns (fedtpu's events, the port's events,
    the port's result)."""
    sink = str(tmp_path / "events.jsonl")
    j_cfg, t_cfg = _with_sink(j_cfg, jcfg, sink), _with_sink(t_cfg, tcfg,
                                                             sink)
    j_run(j_cfg, verbose=False)
    os.replace(sink, tmp_path / "fedtpu.jsonl")
    ckdir = t_cfg.run.checkpoint_dir
    if ckdir:
        os.replace(ckdir, f"{ckdir}.fedtpu")
    rt = t_run(t_cfg, verbose=False, device="cpu", **t_kw)
    return _sink(tmp_path / "fedtpu.jsonl"), _sink(sink), rt


def _assert_events_match(j_events, t_events):
    j_events = [e for e in j_events
                if not (e["kind"] == "span" and e["phase"] == "compile")]
    key = [(e["kind"], e["phase"], e["round"]) for e in t_events]
    assert key == [(e["kind"], e["phase"], e["round"]) for e in j_events]
    for t, j in zip(t_events, j_events):
        assert (t["v"], t["role"], t["process_index"]) == (2, "run", 0)
        tp, jp = t["payload"], j["payload"]
        if t["kind"] == "manifest":
            assert {k: tp[k] for k in _MANIFEST_SAME} == \
                {k: jp[k] for k in _MANIFEST_SAME}
            assert tp["backend"] == "cpu" and tp["package"] == "fedtpu_torch"
            assert set(tp["profile"]) >= {"flops_per_round",
                                          "bytes_per_round",
                                          "profile_rounds"}
        elif t["kind"] == "counters":
            def keep(d, drop):
                return {k: v for k, v in d.items()
                        if k not in drop | _HOST_OR_LAYOUT}
            assert keep(tp["counters"], {"checkpoint_bytes_written"}) == \
                keep(jp["counters"], _COUNTERS_FEDTPU_ONLY)
            assert keep(tp["gauges"], set()) == keep(jp["gauges"],
                                                     _GAUGES_FEDTPU_ONLY)
            assert set(tp["gauges"]) == set(jp["gauges"]) \
                - _GAUGES_FEDTPU_ONLY
            assert tp["histograms"] == jp["histograms"]
        elif t["kind"] in ("round", "cohort_round"):
            assert set(tp) == set(jp)
            for k, v in jp.items():
                tol = 1e-5 if k == "loss_mean" else 1e-6
                if k not in ("store_resident_bytes", "prefetch_stall_s"):
                    assert tp[k] == pytest.approx(v, abs=tol), k
        elif t["kind"] in ("cohort_config", "cohort_summary"):
            # The store's bytes are its record layout's, and the port's
            # last chunk prefetches (lazily initialises) no next chunk's
            # members (ROADMAP §C); prefetch stalls are host timings.
            drop = ("store_apparent_bytes", "store_resident_bytes",
                    "touched_records", "prefetch_stalls")
            assert {k: v for k, v in tp.items() if k not in drop} == \
                {k: v for k, v in jp.items() if k not in drop}
        else:
            assert tp == jp, t["kind"]


@pytest.mark.parametrize("case", ["income-2-R1", "income-2-R2-stop",
                                  "async"])
def test_run_events_match_fedtpu(case, tmp_path):
    """A run's sink against fedtpu's sink of the same run (fedtpu's init,
    masks and arrivals injected): income-2 narrow at R = 1 with held-out
    evals and checkpoints, at R = 2 to an early stop, and --async."""
    if case == "async":
        j_cfg, t_cfg = _async_configs(rounds=6, async_buffer_size=4)
        t_kw = dict(init_params=_anchors(j_cfg),
                    arrival_masks=_arrival_draws(ARRIVAL_SEED, ARRIVAL_RATE))
    else:
        r2 = case.endswith("stop")
        fed = dict(rounds=8, termination_patience=3,
                   tolerance=1.0 if r2 else 1e-4)
        run = (dict(rounds_per_step=2) if r2 else
               dict(eval_test_every=4, checkpoint_every=4,
                    checkpoint_dir=str(tmp_path / "ck")))
        j_cfg, t_cfg = (m.ExperimentConfig(
            data=m.DataConfig(csv_path=None, synthetic_rows=256),
            shard=m.ShardConfig(num_clients=2),
            model=m.ModelConfig(hidden_sizes=(8,)),
            fed=m.FedConfig(**fed), run=m.RunConfig(**run))
            for m in (jcfg, tcfg))
        t_kw = dict(init_params=_fedtpu_init(j_cfg))
    j_ev, t_ev, rt = _event_pair(j_cfg, t_cfg, tmp_path, **t_kw)
    _assert_events_match(j_ev, t_ev)
    kinds = [e["kind"] for e in t_ev]
    assert kinds.count("round") == rt.rounds_run and kinds[-1] == "run_end"
    if case == "async":
        assert kinds.count("async_tick") == rt.rounds_run
    elif case.endswith("stop"):
        assert rt.stopped_early and "early_stop" in kinds
    else:
        spans = [e["phase"] for e in t_ev if e["kind"] == "span"]
        assert spans.count("eval") == spans.count("checkpoint") == 2


def test_cohort_events_match_fedtpu(tmp_path):
    """A small cohort run's sink against fedtpu's: cohort_config, the
    cohort_gather / cohort_writeback and chunk spans, a cohort_round a
    round, cohort_summary, run_end and the counters."""
    j_cfg, t_cfg = _cohort_configs(rounds=4, run=dict(rounds_per_step=2))
    j_ev, t_ev, rt = _event_pair(
        j_cfg, t_cfg, tmp_path, init_params=_fedtpu_population_init(j_cfg))
    _assert_events_match(j_ev, t_ev)
    spans = [e["phase"] for e in t_ev if e["kind"] == "span"]
    assert spans.count("cohort_gather") == spans.count(
        "cohort_writeback") == spans.count("chunk") == 2
    assert [e["kind"] for e in t_ev].count("cohort_round") == rt.rounds_run


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_events_on_is_bitwise_events_off(engine, tmp_path, capsys):
    """With the sink on, the history and the params are bitwise those of
    the run with it off, and stdout keeps every reference-parity line (the
    timing suffix of the Global Metrics lines aside); the sink mirrors the
    logger's info lines, never a parity line."""
    if engine == "async":
        _, cfg = _async_configs(rounds=6, async_buffer_size=4)
        cfg = cfg.replace(run=dataclasses.replace(cfg.run, log_every=1))
    else:
        cfg = _configs()[1].replace(fed=tcfg.FedConfig(
            rounds=12, termination_patience=3, tolerance=0.05))
    outs, results = [], []
    for path in (None, str(tmp_path / "ev.jsonl")):
        res = t_run(_with_sink(cfg, tcfg, path, log_per_client=True),
                    verbose=True, device="cpu")
        results.append(res)
        outs.append([line.split("  (")[0]
                     for line in capsys.readouterr().out.splitlines()])
    off, on = results
    assert outs[0] == outs[1] and any("Global Metrics" in x
                                      for x in outs[0])
    assert on.rounds_run == off.rounds_run
    for name in METRIC_NAMES:
        assert on.global_metrics[name] == off.global_metrics[name]
        assert on.pooled_metrics[name] == off.pooled_metrics[name]
    for a, b in zip(on.loss + on.confusion, off.loss + off.confusion):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(on.final_params),
                    jax.tree.leaves(off.final_params)):
        np.testing.assert_array_equal(a, b)
    logged = [e["payload"]["msg"] for e in _sink(tmp_path / "ev.jsonl")
              if e["kind"] == "log"]
    assert not any("Global Metrics" in m or "CLIENT" in m for m in logged)


def test_checkpoint_counters_and_the_resume_event(tmp_path):
    """Saves, restores and bytes are counted (the bytes: the saved state's
    tensors), and a resumed run's sink holds a resume event at its
    restored round."""
    from fedtpu_torch.telemetry.metrics import tree_nbytes
    ck = tmp_path / "ck"
    _, cfg = _configs(checkpoint_dir=str(ck), checkpoint_every=4)
    cfg = cfg.replace(fed=tcfg.FedConfig(rounds=8,
                                         termination_patience=100))
    first = tmp_path / "a.jsonl"
    t_run(_with_sink(cfg, tcfg, str(first)), verbose=False, device="cpu")
    counters = [e for e in _sink(first) if e["kind"] == "counters"][-1]
    state, _, _ = ckpt.load_checkpoint_raw(str(ck), 8)
    assert counters["payload"]["counters"]["checkpoint_saves"] == 2
    assert counters["payload"]["counters"]["checkpoint_bytes_written"] == \
        2 * tree_nbytes(state)
    more = cfg.replace(fed=tcfg.FedConfig(rounds=12,
                                          termination_patience=100))
    second = tmp_path / "b.jsonl"
    t_run(_with_sink(more, tcfg, str(second)), verbose=False, device="cpu",
          resume=True)
    events = _sink(second)
    assert [(e["kind"], e["round"]) for e in events
            if e["kind"] == "resume"] == [("resume", 8)]
    c = [e for e in events if e["kind"] == "counters"][-1]["payload"]
    assert c["counters"]["checkpoint_restores"] == 1
    assert c["counters"]["checkpoint_saves"] == 1
    assert [e["round"] for e in events if e["kind"] == "round"] == \
        [9, 10, 11, 12]


def test_sweep_writes_a_launch_span_per_launch(tmp_path):
    """The grid's sink: the manifest, one launch span a launch (3 here:
    vmap_arch off), the counters and sweep_end, as fedtpu's."""
    from fedtpu.sweep.grid import run_grid_search as j_grid
    from fedtpu_torch.sweep.grid import run_grid_search as t_grid
    kw = dict(hidden_grid=((8,), (4,), (6, 4)), lr_grid=(0.01, 0.1),
              local_steps=3, vmap_arch=False, overlap_compile=False,
              verbose=False)
    got = []
    for mod, grid, extra in ((jcfg, j_grid, {}), (tcfg, t_grid,
                                                  {"device": "cpu"})):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        cfg = mod.ExperimentConfig(
            data=mod.DataConfig(csv_path=None, synthetic_rows=256),
            shard=mod.ShardConfig(num_clients=2),
            run=mod.RunConfig(telemetry=mod.TelemetryConfig(
                events_path=path)))
        grid(cfg, **kw, **extra)
        got.append(_sink(path))
    j_ev, t_ev = got
    launches = [e for e in t_ev if e["phase"] == "launch"]
    assert [e["round"] for e in launches] == [1, 2, 3]
    assert [e["payload"]["architectures"] for e in launches] == [1, 1, 1]
    assert [e["kind"] for e in t_ev][-2:] == ["counters", "sweep_end"]
    counters = t_ev[-2]["payload"]["counters"]
    assert counters == {"sweep_launches": 3.0, "sweep_configs": 6.0}
    j_key = [(e["kind"], e["phase"], e["round"]) for e in j_ev
             if not (e["kind"] == "span" and e["phase"] == "compile")]
    assert [(e["kind"], e["phase"], e["round"]) for e in t_ev] == j_key
    assert t_ev[-1]["payload"]["launch_count"] == \
        j_ev[-1]["payload"]["launch_count"] == 3


@pytest.mark.parametrize("rounds_k", [3, 0])
def test_profile_window_events_and_its_chrome_trace(rounds_k, tmp_path):
    """profile_rounds K > 0: the window opens at the first chunk end and
    closes at the first chunk end covering >= K rounds, a
    profile_window start and stop event each, one Chrome trace under
    profile_dir; K = 0 traces the whole run (no window events)."""
    _, cfg = _configs()
    cfg = cfg.replace(fed=tcfg.FedConfig(rounds=10,
                                         termination_patience=100))
    path, prof = str(tmp_path / "ev.jsonl"), tmp_path / "prof"
    res = t_run(_with_sink(cfg, tcfg, path, rounds_per_step=2,
                           profile_dir=str(prof), profile_rounds=rounds_k),
                verbose=False, device="cpu")
    window = [(e["phase"], e["round"], e["payload"]["rounds"])
              for e in _sink(path) if e["kind"] == "profile_window"]
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".trace.json")
    with open(prof / traces[0]) as fh:
        assert json.load(fh)["traceEvents"]
    if rounds_k:
        assert window == [("start", 2, 3), ("stop", 6, 4)]
        assert traces[0].startswith("rounds_2-6.")
    else:
        assert window == [] and traces[0].startswith(
            f"rounds_0-{res.rounds_run}.")


def test_serve_writes_its_sink_and_flushes_the_flight_recorder(tmp_path):
    """run_server(events=...): role 'serve' on every line, the serve_start,
    the engine's trace stages, its summary and serve_stop; the crash
    barrier (_safe_handle) answers a handler's exception with an error
    frame and flushes the flight recorder to events.crash.serve.jsonl
    beside the sink."""
    from fedtpu_torch.serving import server as t_server
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.loadgen import run_loadgen
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    from fedtpu_torch.telemetry.trace import Tracer
    sink, pf = tmp_path / "serve.jsonl", tmp_path / "pf"
    trace = str(tmp_path / "t.jsonl")
    t_traces.write_trace(trace, *t_traces.synthesize_trace(
        users=100, arrivals=200, seed=0))
    box = {}
    th = threading.Thread(target=lambda: box.update(res=t_server.run_server(
        tcfg.ServingConfig(**_serve_kw()), events=str(sink),
        port_file=str(pf), once=True, verbose=False, device="cpu")))
    th.start()
    try:
        run_loadgen(trace, port_file=str(pf), timeout=60)
    finally:
        th.join(timeout=120)
    assert not th.is_alive() and "res" in box
    events = _sink(sink)
    assert {e["role"] for e in events} == {"serve"}
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "serve_start" and kinds[-1] == "counters"
    assert {"serve_summary", "serve_stop", "serve_tick"} <= set(kinds)
    stages = {e["phase"] for e in events if e["kind"] == "trace"}
    assert {"client_stamp", "admit", "buffer_insert", "incorporate"} <= stages

    def boom(engine, msg):
        raise KeyError("boom")

    tracer = Tracer(str(tmp_path / "crash-run.jsonl"), role="serve")
    engine = ServingEngine(tcfg.ServingConfig(**_serve_kw()),
                           registry=MetricsRegistry(), tracer=tracer,
                           device="cpu")
    resp = t_server._safe_handle(engine, {"op": "stats"}, tracer,
                                 MetricsRegistry(), handler=boom)
    tracer.close()
    assert resp["op"] == "error" and "KeyError" in resp["reason"]
    crash = tmp_path / "events.crash.serve.jsonl"
    lines = [json.loads(x) for x in crash.read_text().splitlines()]
    assert [x["kind"] for x in lines] == ["serve_handler_error",
                                          "crash_flush"]
    assert lines[-1]["payload"]["reason"] == "handler:'stats':KeyError"


def test_cli_gateway_and_autoscale_write_role_scoped_sinks(tmp_path,
                                                           capsys):
    """``gateway --events`` in a fleet of two writes <events>.g<i> under
    role gateway-<i>; ``autoscale --simulate --events`` writes its
    decisions to its sink; ``report`` merges the fleet's two sinks."""
    from fedtpu_torch.cli import main as t_main
    from fedtpu_torch.serving.loadgen import run_loadgen
    from fedtpu_torch.serving.protocol import gateway_port_file
    ev, pf = str(tmp_path / "fleet.jsonl"), str(tmp_path / "pf")
    trace = str(tmp_path / "t.jsonl")
    t_traces.write_trace(trace, *t_traces.synthesize_trace(
        users=100, arrivals=300, seed=1))
    threads = [threading.Thread(target=t_main, args=([
        "gateway", "--platform", "cpu", "--num-gateways", "2",
        "--gateway-index", str(g), "--port-file", pf, "--events", ev,
        "--once", "--cohort", "4", "--quiet"],)) for g in range(2)]
    for th in threads:
        th.start()
    try:
        for g in range(2):
            from fedtpu_torch.serving.loadgen import read_port_file
            read_port_file(gateway_port_file(pf, g), timeout=60)
        run_loadgen(trace, port_file=pf, num_gateways=2, timeout=60)
    finally:
        for th in threads:
            th.join(timeout=120)
    for g in range(2):
        assert {e["role"] for e in _sink(f"{ev}.g{g}")} == {f"gateway-{g}"}
    capsys.readouterr()
    assert t_main(["report", f"{ev}.g0", f"{ev}.g1", "--format",
                   "json"]) == 0
    merged = json.loads(capsys.readouterr().out)
    assert merged["gateway_fleet"]["gateways"] == [0, 1]
    auto = str(tmp_path / "auto.jsonl")
    assert t_main(["autoscale", "--simulate", "--events", auto,
                   "--quiet"]) == 0
    assert any(e["kind"] == "autoscale_decision" for e in _sink(auto))
