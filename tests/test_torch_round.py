"""The port's whole slice against fedtpu on the CPU: an income-8-shaped run
(8 clients, 14->50->200->2) from fedtpu's own init must give the same
per-round confusion counts, losses, metrics, early-stop round, held-out
metrics and final params."""

import pytest

torch = pytest.importorskip("torch")

import argparse  # noqa: E402
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
from fedtpu_torch.ops.metrics import METRIC_NAMES  # noqa: E402
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
    assert state["round"] == 20 and state["opt_state"]["count"] == 20


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
