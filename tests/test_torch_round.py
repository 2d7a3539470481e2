"""The port's whole slice against fedtpu on the CPU: an income-8-shaped run
(8 clients, 14->50->200->2) from fedtpu's own init must give the same
per-round confusion counts, losses, metrics, early-stop round, held-out
metrics and final params; the sharded (ring, ring-rsag over the 8-device
mesh) and sampled rounds must match fedtpu's round for round; and the fused
whole round (K5's plain version) must match both fedtpu's round and the
port's composed one."""

import pytest

torch = pytest.importorskip("torch")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fedtpu.config as jcfg  # noqa: E402
from fedtpu.models import build_model  # noqa: E402
from fedtpu.ops import build_optimizer  # noqa: E402
from fedtpu.orchestration.loop import (build_experiment as j_build,  # noqa: E402
                                       run_experiment as j_run)
from fedtpu.training.client import (make_local_eval_step,  # noqa: E402
                                    make_local_train_step)

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.benchmarks import mega_kernel_attempt as mega  # noqa: E402
from fedtpu_torch.models.mlp import mlp_init  # noqa: E402
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.ops.metrics import (METRIC_NAMES,  # noqa: E402
                                      metrics_from_confusion)
from fedtpu_torch.orchestration.loop import (build_experiment as t_build,  # noqa: E402
                                             run_experiment as t_run)

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
                     clients=16, hidden=(16, 8)):
    """16 clients over fedtpu's 8-device CPU mesh: 2 clients per shard."""
    j = jcfg.ExperimentConfig(
        data=jcfg.DataConfig(csv_path=None, synthetic_rows=rows),
        shard=jcfg.ShardConfig(num_clients=clients),
        model=jcfg.ModelConfig(hidden_sizes=hidden),
        fed=jcfg.FedConfig(rounds=rounds, aggregation=aggregation,
                           participation_rate=rate, participation_seed=5),
        run=jcfg.RunConfig(mesh_devices=8))
    t = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=rows),
        shard=tcfg.ShardConfig(num_clients=clients),
        model=tcfg.ModelConfig(hidden_sizes=hidden),
        fed=tcfg.FedConfig(rounds=rounds, aggregation=aggregation,
                           participation_rate=rate, participation_seed=5),
        run=tcfg.RunConfig(mesh_devices=8))
    return j, t


def _fedtpu_masks(cfg):
    """fedtpu's participation draws, recomputed as round.py:533-538 makes
    them: uniform(fold_in(fold_in(key(seed), round), client)) < rate."""
    seed, rate = cfg.fed.participation_seed, cfg.fed.participation_rate
    clients = jnp.arange(cfg.shard.num_clients)

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


def _step_both(j_cfg, t_cfg, rounds, masks=None):
    """Step fedtpu's and the port's round side by side; yields per round
    (fedtpu state, port state, port raw, fedtpu's pre-average confusion
    recomputed from its own train/eval steps)."""
    j_exp = j_build(j_cfg)
    _, apply_fn = build_model(jcfg.ModelConfig(hidden_sizes=(16, 8)))
    train = jax.jit(jax.vmap(make_local_train_step(
        apply_fn, build_optimizer(jcfg.OptimConfig()))))
    evaluate = jax.jit(jax.vmap(make_local_eval_step(apply_fn, 2)))
    xb, yb, mb = (j_exp.batch[k] for k in ("x", "y", "mask"))
    j_state, j_step = j_exp.state, j_exp.make_step(1)
    t_exp = t_build(t_cfg, device="cpu", init_params=_np(j_state["params"]),
                    participation_masks=masks)
    assert (t_exp.mesh.num_shards, t_exp.mesh.clients_per_shard) == (8, 2)
    t_state, t_step = t_exp.state, t_exp.make_step(1)
    for r in range(rounds):
        prev_p, prev_s = _np(j_state["params"]), _np(j_state["opt_state"])
        j_state, _ = j_step(j_state, j_exp.batch)
        t_state, raw = t_step(t_state, t_exp.batch)
        trained, _, _ = train(prev_p, prev_s, xb, yb, mb)
        if masks is not None:
            keep = masks(r) > 0
            trained = jax.tree.map(
                lambda a, b: np.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)),
                                      a, b), _np(trained), prev_p)
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
