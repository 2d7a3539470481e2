"""fedtpu_torch's model, loss, metrics and optimizers against fedtpu's on
the same numpy inputs; the server optimizers and the clip, the DP
accountant, the int8 quantization and the finiteness flag over every state
tensor; the converter; the no-fallback and no-JAX rules; the cohort
engine's sampler, refusals, flags and store file against fedtpu's."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores,
# and torch's default of a thread per core oversubscribes them (its small
# ops then wait on each other's threads).
torch.set_num_threads(1)

import ast  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import fedtpu.config as jcfg  # noqa: E402
from fedtpu.models.mlp import mlp_apply as j_apply, mlp_init as j_init  # noqa: E402
from fedtpu.ops import build_optimizer as j_build_optimizer  # noqa: E402
from fedtpu.ops import dp_accountant as j_acc  # noqa: E402
from fedtpu.ops import server_opt as j_sopt  # noqa: E402
from fedtpu.ops.losses import masked_cross_entropy as j_ce  # noqa: E402
from fedtpu.ops.metrics import (confusion_matrix as j_conf,  # noqa: E402
                                metrics_from_confusion as j_metrics)
from fedtpu.parallel.compress import (dequantize as j_dequantize,  # noqa: E402
                                      quantize_tensor as j_quantize_tensor)

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.models.mlp import (flatten, layer_dims,  # noqa: E402
                                     leaf_bounds, mlp_apply, mlp_init,
                                     param_count, unflatten)
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.ops import dp_accountant as t_acc  # noqa: E402
from fedtpu_torch.ops import server_opt as t_sopt  # noqa: E402
from fedtpu_torch.ops.losses import masked_cross_entropy  # noqa: E402
from fedtpu_torch.ops.metrics import (METRIC_NAMES,  # noqa: E402
                                      confusion_matrix,
                                      metrics_from_confusion)
from fedtpu_torch.ops.optim import (build_optimizer,  # noqa: E402
                                    select_participants)
from fedtpu_torch.parallel import compress as t_compress  # noqa: E402
from fedtpu_torch.parallel.round import (init_federated_state,  # noqa: E402
                                         state_finite)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INCOME_DIMS = (14, 50, 200, 2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_np(tree) -> np.ndarray:
    """A fedtpu params-shaped pytree as the port's flat rows, its leaves
    mapped by name."""
    return convert.params_from_jax(_np_tree(tree)).numpy()


def _stacked_jax_params(key, c, dims):
    keys = jax.random.split(jax.random.key(key), c)
    batched = jax.jit(jax.vmap(
        lambda k: j_init(k, dims[0], dims[1:-1], dims[-1])))
    return _np_tree(batched(keys))


@pytest.mark.parametrize("dims", [INCOME_DIMS, (6, 16, 3), (14, 2)])
def test_mlp_apply_matches_fedtpu(dims):
    rng = np.random.default_rng(0)
    params = _np_tree(j_init(jax.random.key(1), dims[0], dims[1:-1],
                             dims[-1]))
    x = rng.normal(size=(64, dims[0])).astype(np.float32)
    ref = np.asarray(j_apply(params, jnp.asarray(x)))
    flat = convert.params_from_jax(params)
    out = mlp_apply(unflatten(flat, dims), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_client_stacked_apply_matches_per_client_fedtpu():
    rng = np.random.default_rng(1)
    params = _stacked_jax_params(2, 4, INCOME_DIMS)
    x = rng.normal(size=(4, 40, 14)).astype(np.float32)
    ref = np.asarray(jax.vmap(j_apply)(params, jnp.asarray(x)))
    out = mlp_apply(unflatten(convert.params_from_jax(params), INCOME_DIMS),
                    torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_mlp_init_follows_the_linear_law():
    dims = layer_dims(14, (50, 200), 2)
    flat = mlp_init(torch.Generator().manual_seed(0), 14, (50, 200), 2)
    assert flat.shape == (param_count(dims),) == (11352,)
    for lyr in unflatten(flat, dims)["layers"]:
        bound = 1.0 / np.sqrt(lyr["w"].shape[0])
        for t in (lyr["w"], lyr["b"]):
            assert float(t.abs().max()) <= bound
            if t.numel() >= 50:      # the max of many draws nears the bound
                assert float(t.abs().max()) > 0.9 * bound
    again = mlp_init(torch.Generator().manual_seed(0), 14, (50, 200), 2)
    assert torch.equal(flat, again)


def test_masked_cross_entropy_and_grad_match_fedtpu():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(48, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, size=48).astype(np.int32)
    mask = (rng.random(48) < 0.8).astype(np.float32)
    jl, jg = jax.value_and_grad(j_ce)(jnp.asarray(logits),
                                      jnp.asarray(labels), jnp.asarray(mask))
    lt = torch.from_numpy(logits).requires_grad_(True)
    tl = masked_cross_entropy(lt, torch.from_numpy(labels),
                              torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, lt)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    # Padded rows get exactly zero gradient.
    assert np.all(tg.numpy()[mask == 0] == 0)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_confusion_and_metrics_match_fedtpu(k):
    rng = np.random.default_rng(k)
    labels = rng.integers(0, k, size=300).astype(np.int32)
    preds = rng.integers(0, k, size=300).astype(np.int32)
    preds[:40] = labels[:40]
    mask = (rng.random(300) < 0.9).astype(np.float32)
    jc = np.asarray(j_conf(jnp.asarray(labels), jnp.asarray(preds),
                           jnp.asarray(mask), k))
    tc = confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds),
                          torch.from_numpy(mask), k)
    np.testing.assert_array_equal(tc.numpy(), jc)
    jm, tm = j_metrics(jnp.asarray(jc)), metrics_from_confusion(tc)
    for name in METRIC_NAMES:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), atol=1e-6)


def test_metrics_zero_division_matches_fedtpu():
    # A class never predicted and a class never present.
    conf = np.array([[5, 0, 0], [3, 0, 0], [0, 0, 0]], np.float32)
    jm = j_metrics(jnp.asarray(conf))
    tm = metrics_from_confusion(torch.from_numpy(conf))
    for name in METRIC_NAMES:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_70_steps_across_steplr_boundaries_matches_optax(name):
    """70 updates cross the StepLR boundaries at 30 and 60."""
    cfg_kw = dict(name=name, learning_rate=0.004 if name == "adam" else 0.05)
    j_tx = j_build_optimizer(jcfg.OptimConfig(**cfg_kw))
    t_tx = build_optimizer(tcfg.OptimConfig(**cfg_kw))
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(3, 40)).astype(np.float32)
    grads = rng.normal(size=(70, 3, 40)).astype(np.float32)
    jp, js = jnp.asarray(p0), j_tx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    ts = t_tx.init(tp)
    for g in grads:
        upd, js = j_tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = t_tx.update(torch.from_numpy(g), ts, tp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-5)
    assert torch.equal(ts["count"], torch.full((3,), 70, dtype=torch.int32))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_sampled_per_client_update_matches_vmapped_optax_with_select(name):
    """Client sampling: each round only the masked-in clients step, as
    fedtpu's round selects them (round.py:576-583). 40 rounds cross the
    StepLR boundary at 30 for some clients only, so counts, schedules and
    bias corrections differ per client. Params and moments to 1e-6, counts
    exactly; absentees keep every state tensor bit for bit."""
    cfg_kw = dict(name=name, learning_rate=0.004 if name == "adam" else 0.05)
    j_tx = j_build_optimizer(jcfg.OptimConfig(**cfg_kw))
    t_tx = build_optimizer(tcfg.OptimConfig(**cfg_kw))
    rng = np.random.default_rng(7)
    c = 5
    p0 = rng.normal(size=(c, 24)).astype(np.float32)
    grads = rng.normal(size=(40, c, 24)).astype(np.float32)
    parts = (rng.random((40, c)) < 0.6).astype(np.float32)
    parts[3] = 0.0                                   # a round nobody joins

    def jstep(p, s, g, part):
        u, s2 = j_tx.update(g, s, p)
        p2 = optax.apply_updates(p, u)
        keep = part > 0                      # a scalar under vmap
        return (jnp.where(keep, p2, p),
                jax.tree.map(lambda a, b: jnp.where(keep, a, b), s2, s))

    jstep = jax.jit(jax.vmap(jstep))
    jp = jnp.asarray(p0)
    js = jax.vmap(j_tx.init)(jp)
    tp = torch.from_numpy(p0.copy())
    ts = t_tx.init(tp)
    for g, part in zip(grads, parts):
        jp, js = jstep(jp, js, jnp.asarray(g), jnp.asarray(part))
        before = {k: v.clone() for k, v in ts.items()}
        prev = tp
        new_p, new_s = t_tx.update(torch.from_numpy(g), ts, tp)
        ts = select_participants(torch.from_numpy(part),
                                 {"params": new_p, **new_s},
                                 {"params": tp, **ts})
        tp = ts.pop("params")
        out = part == 0
        assert torch.equal(tp[out], prev[out])
        for k in ts:
            assert torch.equal(ts[k][out], before[k][out])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    leaves = {type(l).__name__: l for l in js}
    counts = np.asarray(js[-1].count)
    np.testing.assert_array_equal(ts["count"].numpy(), counts)
    np.testing.assert_array_equal(counts, parts.sum(axis=0))
    assert len(set(counts.tolist())) > 1
    if name == "adam":
        adam = leaves["ScaleByAdamState"]
        np.testing.assert_allclose(ts["mu"].numpy(), np.asarray(adam.mu),
                                   atol=1e-6)
        np.testing.assert_allclose(ts["nu"].numpy(), np.asarray(adam.nu),
                                   atol=1e-6)
        np.testing.assert_array_equal(ts["count"].numpy(),
                                      np.asarray(adam.count))
    else:
        trace = leaves["TraceState"]
        np.testing.assert_allclose(ts["trace"].numpy(),
                                   np.asarray(trace.trace), atol=1e-6)


def test_convert_round_trip_is_exact():
    params = _stacked_jax_params(4, 3, INCOME_DIMS)
    flat = convert.params_from_jax(params)
    assert flat.shape == (3, 11352) and flat.dtype == torch.float32
    back = convert.params_to_numpy(flat, INCOME_DIMS)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # The flat buffer's views are fedtpu's leaves, (in, out) layout.
    view = unflatten(flat, INCOME_DIMS)
    np.testing.assert_array_equal(view["layers"][1]["w"].numpy(),
                                  params["layers"][1]["w"])
    assert torch.equal(flatten(view), flat)


def test_adam_state_round_trip_and_resume_matches_optax():
    """optax state after 3 steps -> the port -> 2 more steps on both."""
    tx = j_build_optimizer(jcfg.OptimConfig())
    t_tx = build_optimizer(tcfg.OptimConfig())
    params = _stacked_jax_params(5, 2, (6, 8, 3))
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape)
                          .astype(np.float32), params) for _ in range(5)]
    init = jax.jit(jax.vmap(tx.init))
    jp, js = params, init(params)

    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jstep = jax.jit(jax.vmap(jstep))
    for g in grads[:3]:
        jp, js = jstep(jp, js, g)
    adam = js[0]
    state = convert.adam_state_from_jax(_np_tree(adam.mu), _np_tree(adam.nu),
                                        np.asarray(adam.count))
    mu, nu, count = convert.adam_state_to_numpy(state, (6, 8, 3))
    for a, b in zip(jax.tree.leaves(_np_tree(adam.mu)), jax.tree.leaves(mu)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(_np_tree(adam.nu)), jax.tree.leaves(nu)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(count, np.asarray(adam.count))
    tp = convert.params_from_jax(_np_tree(jp))
    for g in grads[3:]:
        jp, js = jstep(jp, js, g)
        tp, state = t_tx.update(convert.params_from_jax(g), state, tp)
    np.testing.assert_allclose(tp.numpy(),
                               convert.params_from_jax(_np_tree(jp)).numpy(),
                               atol=1e-6)
    # Clients whose counts differ (client sampling) keep their own.
    state = convert.adam_state_from_jax(mu, nu, np.array([3, 4]))
    assert state["count"].dtype == torch.int32
    np.testing.assert_array_equal(
        convert.adam_state_to_numpy(state, (6, 8, 3))[2], [3, 4])


def test_cuda_entry_points_raise_without_a_gpu(monkeypatch):
    from fedtpu_torch.benchmarks import mega_kernel_attempt as mega
    from fedtpu_torch.orchestration.loop import (build_experiment,
                                                 run_experiment)
    from fedtpu_torch.sweep.grid import run_grid_search
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.ExperimentConfig(data=tcfg.DataConfig(synthetic_rows=64),
                                fed=tcfg.FedConfig(rounds=1))
    for entry in (run_experiment, build_experiment, mega.run,
                  run_grid_search):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(cfg)
    from fedtpu_torch.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "--rounds", "1", "--synthetic-rows", "64", "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--local-steps", "1", "--synthetic-rows", "64",
              "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mega.main(["--rounds", "1", "--synthetic-rows", "64"])


@pytest.mark.parametrize("kw", [
    dict(model_parallel=2), dict(mpmd=True),
    dict(overlap_compile=True), dict(compilation_cache="cache")])
def test_unported_knobs_raise_naming_their_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        tcfg.RunConfig(**kw)


# The cohort engine's knobs (fedtpu_torch.cohort.scheduler), each off its
# default: the port's FedConfig and ExperimentConfig hold it, as fedtpu's.
_COHORT_KNOB_VALUES = [
    dict(client_store="sqlite"), dict(cohort_seed=1),
    dict(cohort_sampling="weighted"), dict(cohort_trace="t.jsonl"),
    dict(cohort_size=4), dict(client_store_path="store.bin")]


@pytest.mark.parametrize("kw", _COHORT_KNOB_VALUES)
def test_cohort_knobs_reach_the_config(kw):
    (knob, value), = kw.items()
    t = tcfg.ExperimentConfig(fed=tcfg.FedConfig(**kw))
    j = jcfg.ExperimentConfig(fed=jcfg.FedConfig(**kw))
    assert getattr(t.fed, knob) == getattr(j.fed, knob) == value


_CONFIGS = ("DataConfig", "ShardConfig", "ModelConfig", "OptimConfig",
            "FedConfig", "RunConfig", "TelemetryConfig", "FuzzConfig")
# The knobs of fedtpu that the port does not run yet, and the ROADMAP item
# of each.
_UNPORTED = {
    "RunConfig": {
        **{k: "A10c" for k in ("mpmd", "model_parallel")},
        **{k: "A11c" for k in ("compilation_cache", "overlap_compile")}},
}


# The knobs of the rest of the synchronous round, which the port runs:
# server optimizers, central DP, robust rules, Byzantine injection,
# SCAFFOLD and the int8 exchange.
_A6_KNOBS = (
    "scaffold", "server_opt", "server_lr", "server_momentum", "server_b1",
    "server_b2", "server_tau", "dp_clip_norm", "dp_noise_multiplier",
    "dp_seed", "dp_adaptive_clip", "dp_target_quantile", "dp_clip_lr",
    "dp_count_noise_multiplier", "dp_delta", "robust_aggregation",
    "trim_ratio", "krum_f", "byzantine_clients", "compress")


# The asynchronous engine's knobs (fedtpu_torch.parallel.async_fed).
_ASYNC_KNOBS = ("async_mode", "async_arrival_rate", "async_arrival_seed",
                "async_staleness_power", "async_buffer_size")


@pytest.mark.parametrize("knob", _A6_KNOBS)
def test_round_knobs_take_other_values(knob):
    """Each knob of the rest of the round constructs off its default, as
    fedtpu's FedConfig does (its refusals come from build_round_fn,
    tests/test_torch_server_opt.py)."""
    field = {f.name: f for f in dataclasses.fields(tcfg.FedConfig)}[knob]
    value = _other_value(_default(field))
    assert getattr(tcfg.FedConfig(**{knob: value}), knob) == value
    assert getattr(jcfg.FedConfig(**{knob: value}), knob) == value


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    return field.default_factory()


@pytest.mark.parametrize("name", _CONFIGS)
def test_every_fedtpu_knob_is_a_port_field_with_its_default(name):
    """Each field of the dataclasses fedtpu's ExperimentConfig holds is a
    field of the port's, with fedtpu's name and default (a sub-config is
    the port's own copy, equal field for field)."""
    j = {f.name: _default(f) for f in dataclasses.fields(getattr(jcfg, name))}
    t = {f.name: _default(f) for f in dataclasses.fields(getattr(tcfg, name))}
    assert set(t) == set(j)
    for key, value in j.items():
        if dataclasses.is_dataclass(value):
            assert type(t[key]).__module__ == "fedtpu_torch.config"
            assert dataclasses.asdict(t[key]) == dataclasses.asdict(value)
        else:
            assert t[key] == value and type(t[key]) is type(value), key
    # The defaults construct, and so does every preset's config.
    getattr(tcfg, name)()


def _other_value(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, tuple):
        return value + value[-1:]
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, events_path="events.jsonl")
    return "x"      # a string, or None for an optional path


@pytest.mark.parametrize("name,knob,item", [
    (name, knob, item) for name, knobs in _UNPORTED.items()
    for knob, item in knobs.items()])
def test_unported_knob_off_its_default_raises_naming_its_item(name, knob,
                                                              item):
    cls = getattr(tcfg, name)
    field = {f.name: f for f in dataclasses.fields(cls)}[knob]
    value = _other_value(_default(field))
    with pytest.raises(NotImplementedError,
                       match=rf"{name}\.{knob}=.*\(ROADMAP {item}\)"):
        cls(**{knob: value})


_COHORT_KNOBS = ("cohort_size", "client_store", "client_store_path",
                 "cohort_sampling", "cohort_seed", "cohort_trace")


@pytest.mark.parametrize("knob", _COHORT_KNOBS)
def test_cohort_knob_off_its_default_constructs(knob):
    """Each of the cohort engine's knobs constructs off its default, as in
    fedtpu's FedConfig (their refusals come from the cohort validator,
    ``test_cohort_config_rejections``)."""
    field = {f.name: f for f in dataclasses.fields(tcfg.FedConfig)}[knob]
    value = _other_value(_default(field))
    assert getattr(tcfg.FedConfig(**{knob: value}), knob) == value
    assert getattr(jcfg.FedConfig(**{knob: value}), knob) == value


def test_ported_knobs_take_other_values():
    """Every field the port runs takes another value; use_pallas selects
    the fused held-out forward, which the port always runs."""
    for name in _CONFIGS:
        cls = getattr(tcfg, name)
        for field in dataclasses.fields(cls):
            if field.name in _UNPORTED.get(name, {}):
                continue
            assert field.name in {
                "DataConfig": {"csv_path", "label_column", "test_size",
                               "split_seed", "scale_with_mean",
                               "native_loader",
                               "scaler_leakage_parity", "synthetic_rows",
                               "synthetic_features", "synthetic_classes",
                               "dataset_name"},
                "ShardConfig": {"num_clients", "shuffle", "shard_seed",
                                "unseeded_per_client_bug", "strategy",
                                "dirichlet_alpha", "partition_clients",
                                "partition_offset"},
                "ModelConfig": {"hidden_sizes", "num_classes", "input_dim",
                                "use_pallas", "kind", "image_shape",
                                "conv_channels", "compute_dtype",
                                "param_dtype"},
                "OptimConfig": {f.name for f in dataclasses.fields(cls)},
                "FuzzConfig": {f.name for f in dataclasses.fields(cls)},
                "FedConfig": {"rounds", "weighting", "termination_patience",
                              "tolerance", "same_init", "init_seed",
                              "participation_rate", "participation_seed",
                              "aggregation", "local_steps", "prox_mu",
                              "init_weights_npz", "personalize_steps",
                              *_A6_KNOBS, *_ASYNC_KNOBS, *_COHORT_KNOBS},
                "RunConfig": {"log_every", "log_per_client",
                              "rounds_per_step", "eval_test_every",
                              "halt_on_nonfinite", "mesh_devices",
                              "checkpoint_dir", "checkpoint_every",
                              "keep_checkpoints", "metrics_jsonl",
                              "pipelined_stop", "profile_dir",
                              "profile_rounds", "telemetry", "fault_plan",
                              "on_divergence", "rollback_retries",
                              "rollback_exclude", "rollback_perturb",
                              "heartbeat_file", "collective_timeout"},
                "TelemetryConfig": {"events_path", "manifest", "log_level"},
            }[name], (name, field.name)
    assert tcfg.ModelConfig(use_pallas=True).use_pallas


@pytest.mark.parametrize("name,kw", [
    ("DataConfig", dict(native_loader=False)),
    ("FedConfig", dict(local_steps=5)), ("FedConfig", dict(prox_mu=0.01)),
    ("FedConfig", dict(init_weights_npz="best.npz")),
    ("FedConfig", dict(personalize_steps=5)),
    ("RunConfig", dict(checkpoint_dir="ck", checkpoint_every=10,
                       keep_checkpoints=2)),
    ("RunConfig", dict(metrics_jsonl="m.jsonl")),
    ("RunConfig", dict(pipelined_stop=True))])
def test_knobs_of_the_synchronous_run_construct(name, kw):
    """The CSV loader's, local training's and the host loop's knobs take
    other values, as fedtpu's do."""
    cfg = getattr(tcfg, name)(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())


@pytest.mark.parametrize("name,kw", [
    ("ModelConfig", dict(kind="convnet")),
    ("ModelConfig", dict(image_shape=(8, 8, 3))),
    ("ModelConfig", dict(conv_channels=(8, 16))),
    ("ModelConfig", dict(compute_dtype="bfloat16")),
    ("ModelConfig", dict(compute_dtype="float16")),
    ("DataConfig", dict(dataset_name="cifar10"))])
def test_model_and_dataset_knobs_construct_as_fedtpus(name, kw):
    """The ConvNet's knobs, the compute dtypes and the CIFAR-10 loader's
    name construct, as in fedtpu (whose build_model refuses a bad value)."""
    t = getattr(tcfg, name)(**kw)
    j = getattr(jcfg, name)(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_cifar10_32_preset_is_fedtpus():
    t, j = tcfg.get_preset("cifar10-32"), jcfg.get_preset("cifar10-32")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.kind == "convnet" and t.model.compute_dtype == "bfloat16"


# ------------------------------------- the ConvNet and the compute dtypes
# The CPU tests' ConvNet: 8x8x3 images, channels (8, 16), hidden 32, 10
# classes (cifar10-32's at 1/4 of the side, 1/4 of the channels, 1/8 of the
# hidden width).
SMALL_IMAGE, SMALL_CHANNELS, SMALL_HIDDEN = (8, 8, 3), (8, 16), 32
_DTYPE_PAIRS = {"float32": (None, None),
                "bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float16": (jnp.float16, torch.float16)}


def _small_convnet(dtype="float32"):
    from fedtpu_torch.models.registry import convnet_model
    return convnet_model(SMALL_IMAGE, SMALL_CHANNELS, SMALL_HIDDEN, 10,
                         _DTYPE_PAIRS[dtype][1])


def _jax_convnet_params(key, clients=None):
    from fedtpu.models.convnet import convnet_init
    init = jax.jit(lambda k: convnet_init(k, SMALL_IMAGE, SMALL_CHANNELS,
                                          SMALL_HIDDEN, 10))
    if clients is None:
        return _np_tree(init(jax.random.key(key)))
    return _np_tree(jax.vmap(init)(jax.random.split(jax.random.key(key),
                                                    clients)))


def _ulp_tol(dtype: str, ref: np.ndarray) -> float:
    """fp32: 1e-5. A 16-bit compute dtype: one ulp of it at the logits'
    largest magnitude (bf16 2^-8, fp16 2^-11 relative), for a sum that
    rounds once in another order; measured 0.0 on the CPU."""
    if dtype == "float32":
        return 1e-5
    rel = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[dtype]
    return rel * float(np.abs(ref).max())


@pytest.mark.parametrize("layout", ["nhwc", "flat", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnet_apply_matches_fedtpu(dtype, layout):
    """The port's ConvNet against fedtpu's convnet_apply on the same numpy
    params: one model on NHWC images and on flat (N, H*W*C) rows, and
    client-stacked (4 clients, the grouped convolution) against fedtpu's
    vmap. fp32 within 1e-5; bf16 within one bf16 ulp of the logits'
    scale (_ulp_tol), mirroring fedtpu's casts and rounding points."""
    from fedtpu.models.convnet import convnet_apply as j_conv_apply
    rng = np.random.default_rng(3)
    j_dtype = _DTYPE_PAIRS[dtype][0]
    model = _small_convnet(dtype)
    if layout == "stacked":
        params = _jax_convnet_params(7, clients=4)
        x = rng.normal(size=(4, 24, 192)).astype(np.float32)
        ref = np.asarray(jax.vmap(lambda p, a: j_conv_apply(
            p, a, compute_dtype=j_dtype))(params, jnp.asarray(x)))
    else:
        params = _jax_convnet_params(7)
        x = rng.normal(size=(24, 8, 8, 3)).astype(np.float32)
        if layout == "flat":
            x = x.reshape(24, -1)
        ref = np.asarray(j_conv_apply(params, jnp.asarray(x),
                                      compute_dtype=j_dtype))
    out = model.apply(convert.params_from_jax(params), torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=_ulp_tol(dtype, ref))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_mlp_in_a_compute_dtype_matches_fedtpu(dtype):
    """fedtpu's mlp_apply(compute_dtype=...) (mlp.py:43-56) against the
    port's MLP spec in that dtype, client-stacked: within one ulp of the
    logits' scale (_ulp_tol)."""
    from fedtpu_torch.models.registry import mlp_model
    rng = np.random.default_rng(4)
    params = _stacked_jax_params(8, 3, INCOME_DIMS)
    x = rng.normal(size=(3, 50, 14)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda p, a: j_apply(
        p, a, compute_dtype=_DTYPE_PAIRS[dtype][0]))(params, jnp.asarray(x)))
    model = mlp_model(INCOME_DIMS, _DTYPE_PAIRS[dtype][1])
    assert model.mlp_dims is None          # not the model K2 and K3 compute
    out = model.apply(convert.params_from_jax(params), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=_ulp_tol(dtype, ref))


def test_convnet_gradients_match_jax_grad():
    """The gradient of the summed per-client masked CE of the client-stacked
    ConvNet (what the train step differentiates) against jax.grad of
    fedtpu's masked loss, vmapped over 3 clients, fp32: rtol 1e-4, atol
    1e-6 (backward sums over 8x8 positions and the batch in another
    order)."""
    from fedtpu.models.convnet import convnet_apply as j_conv_apply
    rng = np.random.default_rng(5)
    params = _jax_convnet_params(9, clients=3)
    x = rng.normal(size=(3, 30, 192)).astype(np.float32)
    y = rng.integers(0, 10, size=(3, 30)).astype(np.int32)
    mask = np.ones((3, 30), np.float32)
    mask[2, 25:] = 0.0

    def loss(p, a, b, m):
        return j_ce(j_conv_apply(p, a), b, m)

    ref = _flat_np(jax.vmap(jax.grad(loss))(params, jnp.asarray(x),
                                            jnp.asarray(y),
                                            jnp.asarray(mask)))
    model = _small_convnet()
    flat = convert.params_from_jax(params).requires_grad_(True)
    ce = masked_cross_entropy(model.apply(flat, torch.from_numpy(x)),
                              torch.from_numpy(y), torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(ce.sum(), flat)
    np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_convnet_spec_is_fedtpus_pytree():
    """build_model on fedtpu's ModelConfig fields: the leaves are fedtpu's,
    by path and shape; cifar10-32's model has 1,070,794 parameters; the
    init follows fedtpu's law (each layer within 1/sqrt(fan_in)); the eval
    route is the model's own forward (mlp_dims None); unknown kinds are
    fedtpu's ValueError."""
    from fedtpu.models import build_model as j_build_model
    from fedtpu_torch.models.registry import build_model, tree_leaves
    cfg = dict(kind="convnet", image_shape=SMALL_IMAGE,
               conv_channels=SMALL_CHANNELS, hidden_sizes=(SMALL_HIDDEN,),
               num_classes=10)
    model = build_model(tcfg.ModelConfig(**cfg))
    j_init, _ = j_build_model(jcfg.ModelConfig(**cfg))
    tree = _np_tree(j_init(jax.random.key(0)))
    assert [(p, tuple(v.shape)) for p, v in tree_leaves(tree)] == \
        [(p, tuple(s)) for p, s in model.leaves]
    assert model.param_count == sum(v.size for v in jax.tree.leaves(tree))
    assert model.mlp_dims is None and model.compute_dtype is None
    big = build_model(tcfg.get_preset("cifar10-32").model)
    assert big.param_count == 1_070_794
    assert big.compute_dtype == torch.bfloat16
    flat = model.init(torch.Generator().manual_seed(0))
    view = model.unflatten(flat)
    for layer in (*view["convs"], view["dense"], view["head"]):
        bound = 1.0 / np.sqrt(np.prod(layer["w"].shape[:-1]))
        for leaf in (layer["w"], layer["b"]):
            assert float(leaf.abs().max()) <= bound
        assert float(layer["w"].abs().max()) > 0.9 * bound
    for bad, jbad in ((tcfg.ModelConfig(kind="x"), jcfg.ModelConfig(
            kind="x")),):
        with pytest.raises(ValueError) as t_err:
            build_model(bad)
        with pytest.raises(ValueError) as j_err:
            j_build_model(jbad)
        assert str(t_err.value) == str(j_err.value)
    assert build_model(tcfg.ModelConfig()).mlp_dims == INCOME_DIMS


def test_convnet_convert_round_trip_is_exact():
    """fedtpu's client-stacked ConvNet params and its optax Adam state
    after two steps -> the port's flat buffers -> fedtpu's layout, bit for
    bit; the flat buffer's views are fedtpu's HWIO leaves."""
    params = _jax_convnet_params(11, clients=3)
    model = _small_convnet()
    flat = convert.params_from_jax(params)
    assert flat.shape == (3, model.param_count)
    back = convert.params_to_numpy(flat, model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        model.unflatten(flat)["convs"][1]["w"].numpy(),
        params["convs"][1]["w"])
    tx = j_build_optimizer(jcfg.OptimConfig())
    rng = np.random.default_rng(6)
    state = jax.vmap(tx.init)(params)
    p = params
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape)
                         .astype(np.float32), params)
        upd, state = jax.vmap(tx.update)(g, state, p)
        p = optax.apply_updates(p, upd)
    adam = state[0]
    t_state = convert.adam_state_from_jax(_np_tree(adam.mu),
                                          _np_tree(adam.nu),
                                          np.asarray(adam.count))
    mu, nu, count = convert.adam_state_to_numpy(t_state, model)
    for want, got in ((adam.mu, mu), (adam.nu, nu)):
        assert jax.tree.structure(got) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(_np_tree(want)),
                        jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(count, np.asarray(adam.count))


def test_int8_quantization_scales_each_convnet_leaf():
    """The int8 exchange's scales follow the spec's leaves: one per conv
    w and b, dense and head, fedtpu's quantize_tensor on each."""
    model = _small_convnet()
    gen = np.random.default_rng(12)
    x = gen.standard_normal((2, model.param_count)).astype(np.float32)
    bounds = model.leaf_bounds
    assert len(bounds) == 8
    q, scales = t_compress.quantize_leaves(torch.from_numpy(x), bounds)
    for s in range(2):
        for j, (a, b) in enumerate(bounds):
            jq, js = j_quantize_tensor(x[s, a:b])
            np.testing.assert_array_equal(q[s, a:b].numpy(), np.asarray(jq))
            assert float(scales[s, j]) == float(js)


@pytest.mark.parametrize("kw,message", [
    (dict(local_steps=0), "local_steps must be >= 1"),
    (dict(prox_mu=-0.1), "prox_mu must be >= 0")])
def test_local_training_knobs_refuse_what_fedtpu_refuses(kw, message):
    with pytest.raises(ValueError, match=message):
        tcfg.FedConfig(**kw)


def test_rollback_stays_refused_naming_a11():
    """Checks that rollback constructs and that the A11c knobs (the
    compilation cache) refuse, each naming A11c. The name is the one it
    had while rollback was refused; the resilience loop lifted that."""
    run = tcfg.RunConfig(on_divergence="rollback", checkpoint_dir="ck",
                         checkpoint_every=1)
    assert run.on_divergence == "rollback"
    for kw in (dict(compilation_cache="cache"), dict(overlap_compile=True)):
        with pytest.raises(NotImplementedError, match=r"\(ROADMAP A11c\)"):
            tcfg.RunConfig(**kw)


def test_sampling_ring_and_mesh_knobs_construct():
    assert tcfg.FedConfig(participation_rate=0.5,
                          participation_seed=3).participation_rate == 0.5
    for kind in ("psum", "ring", "ring-rsag"):
        assert tcfg.FedConfig(aggregation=kind).aggregation == kind
    assert tcfg.RunConfig(mesh_devices=8).mesh_devices == 8
    preset = tcfg.get_preset("income-32-noniid")
    assert (preset.shard.num_clients, preset.shard.strategy,
            preset.shard.dirichlet_alpha, preset.fed.rounds) == (
                32, "dirichlet", 0.5, 300)
    for bad in (dict(participation_rate=0.0), dict(participation_rate=1.5),
                dict(aggregation="allgather")):
        with pytest.raises(ValueError):
            tcfg.FedConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.RunConfig(mesh_devices=-1)


def test_marginal_slope_recovers_a_linear_cost(monkeypatch):
    """fedtpu_torch.utils.timing.marginal_slope on a fake program of fixed
    cost 0.5 s plus 2 ms an iteration, on a fake clock: the slope is the
    per-iteration cost, the fixed cost cancels, and each length runs one
    warm-up and ``reps`` timed calls."""
    from fedtpu_torch.utils import timing
    clock, calls = [0.0], []
    monkeypatch.setattr(timing.time, "perf_counter", lambda: clock[0])

    def make_fn(length):
        def fn():
            calls.append(length)
            clock[0] += 0.5 + 2e-3 * length
            return torch.ones(3)
        return fn

    assert timing.marginal_slope(make_fn) == pytest.approx(2e-3, rel=1e-9)
    assert calls == [1000] * 5 + [4000] * 5
    assert timing.marginal_slope(make_fn, lens=(10, 40), reps=2) == \
        pytest.approx(2e-3, rel=1e-9)


def test_flops_floor_and_force_fetch():
    from fedtpu_torch.utils.timing import assert_above_flops_floor, force_fetch
    # 1e9 flops at a 1e12 FLOP/s peak: the floor is 0.5 ms.
    assert assert_above_flops_floor(1e-3, 1e9, 1e12) == pytest.approx(5e-4)
    with pytest.raises(RuntimeError, match="methodology broken"):
        assert_above_flops_floor(4e-4, 1e9, 1e12, label="fused")
    assert force_fetch(torch.arange(4.0).reshape(2, 2)) == 3.0
    assert force_fetch(torch.zeros(0)) == 0.0


# ------------------------------------------- server optimizers and clip
def _layers(gen, dims, lead=()):
    return {"layers": [{"w": gen.standard_normal(lead + (i, o)).astype(
        np.float32), "b": gen.standard_normal(lead + (o,)).astype(np.float32)}
        for i, o in zip(dims[:-1], dims[1:])]}


@pytest.mark.parametrize("name", t_sopt.SERVER_OPTIMIZERS)
def test_server_optimizer_updates_match_fedtpus(name):
    """Five updates on random deltas against fedtpu's optimizer (its
    pytree mapped onto the flat layout by name): steps and state within
    1e-6 relative."""
    gen = np.random.default_rng(3)
    dims = (5, 4, 3)
    kw = dict(learning_rate=0.3, momentum=0.7, b1=0.8, b2=0.95, tau=1e-2)
    j_opt = j_sopt.make_server_optimizer(name, **kw)
    t_opt = t_sopt.make_server_optimizer(name, **kw)
    g = _layers(gen, dims)
    js, ts = j_opt.init(g), t_opt.init(torch.from_numpy(_flat_np(g)))
    for _ in range(5):
        d = _layers(gen, dims)
        j_step, js = j_opt.update(jax.tree.map(np.asarray, d), js)
        t_step, ts = t_opt.update(torch.from_numpy(_flat_np(d)), ts)
        np.testing.assert_allclose(t_step.numpy(), _flat_np(j_step),
                                   rtol=1e-6, atol=1e-7)
        for k in ts:
            np.testing.assert_allclose(ts[k].numpy(), _flat_np(js[k]),
                                       rtol=1e-6, atol=1e-7)


def test_unknown_server_optimizer_is_fedtpus_error():
    with pytest.raises(ValueError) as j_err:
        j_sopt.make_server_optimizer("adam")
    with pytest.raises(ValueError) as t_err:
        t_sopt.make_server_optimizer("adam")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("clip", [0.5, 5.0, 1e3])
def test_clip_by_global_norm_matches_fedtpus(clip):
    """One joint L2 norm per client over all of its leaves (fedtpu's norm
    over the pytree equals the norm over the flat row)."""
    gen = np.random.default_rng(4)
    d = _layers(gen, (6, 5, 2), lead=(4,))
    j_clipped, j_norms = j_sopt.clip_by_global_norm(d, clip)
    t_clipped, t_norms = t_sopt.clip_by_global_norm(
        torch.from_numpy(_flat_np(d)), clip)
    np.testing.assert_allclose(t_norms.numpy(), np.asarray(j_norms),
                               rtol=1e-6)
    np.testing.assert_allclose(t_clipped.numpy(), _flat_np(j_clipped),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- DP accountant
@pytest.mark.parametrize("q,z,steps", [(1.0, 1.1, 50), (0.5, 0.8, 300),
                                       (0.01, 2.0, 10_000), (0.3, 0.4, 7)])
def test_accountant_matches_fedtpus(q, z, steps):
    assert t_acc.privacy_spent(q, z, steps, 1e-5) == j_acc.privacy_spent(
        q, z, steps, 1e-5)
    assert t_acc.rdp_vector(q, z) == j_acc.rdp_vector(q, z)
    curve = [r * steps for r in t_acc.rdp_vector(q, z)]
    assert t_acc.epsilon_from_rdp(curve, 1e-6) == j_acc.epsilon_from_rdp(
        curve, 1e-6)
    assert t_acc.DEFAULT_ORDERS == j_acc.DEFAULT_ORDERS


# ------------------------------------------------- the finiteness flag
FLAG_TENSORS = ("params", "mu", "nu", "m", "v", "client_cv", "server_cv",
                "dp_clip")


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("name", FLAG_TENSORS)
def test_state_finite_covers_every_state_tensor(name, bad):
    """state_finite covers what fedtpu's state_poisoned covers
    (loop.py:1173-1181): params, Adam, the server optimizer state, both
    control variates and the adaptive clip."""
    dims = layer_dims(6, (5,), 2)
    state = init_federated_state(
        0, 3, dims,
        build_optimizer(tcfg.OptimConfig()),
        server_opt=t_sopt.make_server_optimizer("fedadam"), scaffold=True,
        adaptive_clip_init=1.0)
    assert bool(state_finite(state))
    where = {"params": state, "mu": state["opt_state"],
             "nu": state["opt_state"], "m": state["server_opt_state"],
             "v": state["server_opt_state"], "client_cv": state,
             "server_cv": state, "dp_clip": state}[name]
    where[name] = where[name].clone()
    where[name].view(-1)[-1] = bad
    assert not bool(state_finite(state))


# ------------------------------------------------- int8 quantization
def test_int8_quantization_matches_fedtpus_per_leaf():
    """One scale per leaf (each layer's w and b), fedtpu's
    quantize_tensor / dequantize on each leaf of the same partial sums."""
    gen = np.random.default_rng(5)
    x = gen.standard_normal((3, 394)).astype(np.float32)
    x[1, 224:240] = 0.0            # an all-zero leaf: scale 0, exact zeros
    bounds = leaf_bounds((14, 16, 8, 2))
    q, scales = t_compress.quantize_leaves(torch.from_numpy(x), bounds)
    for s in range(3):
        for j, (a, b) in enumerate(bounds):
            jq, js = j_quantize_tensor(x[s, a:b])
            np.testing.assert_array_equal(q[s, a:b].numpy(), np.asarray(jq))
            assert float(scales[s, j]) == float(js)
    back = t_compress.dequantize(q, scales, bounds)
    for j, (a, b) in enumerate(bounds):
        jq, js = jax.vmap(j_quantize_tensor)(x[:, a:b])
        np.testing.assert_array_equal(back[:, a:b].numpy(),
                                      np.asarray(j_dequantize(jq, js)))
    assert not back[1, 224:240].any()


_FORBIDDEN = {"jax", "jaxlib", "optax", "pandas", "sklearn", "fedtpu"}


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_fedtpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "fedtpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = {(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in _FORBIDDEN}
    assert not bad, f"forbidden imports in the port: {sorted(bad)}"


# ------------------------------------------------- C5: fedtpu's CLI flags
# fedtpu's run / sweep / parity flags whose config field the port does not
# run yet: field path, a value off its default, the ROADMAP item the port's
# refusal names. --max-restarts is fedtpu's supervisor, no config field.
_CLI_NOT_PORTED = {
    "--model-parallel": ("run", "model_parallel", 2, "A10c"),
    "--mpmd": ("run", "mpmd", True, "A10c"),
    "--compilation-cache": ("run", "compilation_cache", "x", "A11c"),
    "--overlap-compile": ("run", "overlap_compile", True, "A11c"),
}
_SECTIONS = {"data": "DataConfig", "shard": "ShardConfig",
             "model": "ModelConfig", "fed": "FedConfig", "run": "RunConfig"}


def _subcommand_flags(parser, name):
    import argparse
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {o for a in sub.choices[name]._actions for o in a.option_strings}


@pytest.mark.parametrize("command", ["run", "sweep", "parity", "serve",
                                     "loadgen", "gateway", "autoscale"])
def test_cli_takes_every_fedtpu_flag_whose_field_it_runs(command):
    """C5: the port's parser has each of fedtpu's flags of ``command``
    whose config field the port runs; each it lacks sets a field that the
    port refuses, naming that field's ROADMAP item."""
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser
    missing = (_subcommand_flags(j_parser(), command)
               - _subcommand_flags(t_parser(), command))
    assert missing <= set(_CLI_NOT_PORTED), sorted(
        missing - set(_CLI_NOT_PORTED))
    for flag in sorted(missing):
        if _CLI_NOT_PORTED[flag] is None:
            continue
        section, field, value, item = _CLI_NOT_PORTED[flag]
        cls = getattr(tcfg, _SECTIONS[section])
        assert field in {f.name for f in dataclasses.fields(
            getattr(jcfg, _SECTIONS[section]))}
        with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\)"):
            cls(**{field: value})


# fedtpu's serve flags that are run_server arguments, not ServingConfig
# fields, each with its run_server keyword: the port's parser takes each
# and hands it on.
_SERVE_RUN_SERVER_FLAGS = {"--heartbeat": "heartbeat"}


@pytest.mark.parametrize("flag", sorted(_SERVE_RUN_SERVER_FLAGS))
def test_cli_serve_refuses_the_flags_it_does_not_run(flag, monkeypatch):
    """C5 for ``serve``: checks that each of fedtpu's serve flags that is
    a run_server argument reaches the port's run_server with its value.
    The name is the one it had while such flags were refused; none is
    refused any more."""
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import main as t_main
    from fedtpu_torch.serving import server as t_server
    argv = ["serve", "--platform", "cpu", "--quiet", flag, "x"]
    assert j_parser().parse_args(argv).cmd == "serve"
    got = {}
    monkeypatch.setattr(t_server, "run_server",
                        lambda cfg, **kw: got.update(kw) or {})
    assert t_main(argv) == 0
    assert got[_SERVE_RUN_SERVER_FLAGS[flag]] == "x"


@pytest.mark.parametrize("argv", [
    ["serve", "--cohort", "32", "--buffer-size", "16", "--tick-interval",
     "0.25", "--flush-every", "64", "--history-window", "100",
     "--rate-limit", "500", "--rate-burst", "32", "--max-pending", "4096",
     "--stale-deprioritize", "2", "--stale-reject", "8", "--seed", "3",
     "--staleness-power", "0.25", "--port", "0"],
    ["serve", "--screen", "--screen-norm-mult", "3", "--screen-cos-min",
     "-0.45", "--screen-warmup", "4", "--screen-clip-norm", "0.5",
     "--quarantine-strikes", "2"]], ids=["knobs", "screen"])
def test_cli_serve_builds_fedtpus_serving_config(argv):
    """The port's serve command line sets the ServingConfig that fedtpu's
    serve handler builds from the same flags (fedtpu/cli.py:1895)."""
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser
    from fedtpu_torch.cli import serving_config_from_args
    a = j_parser().parse_args(argv)
    want = jcfg.ServingConfig(
        host=a.host, port=a.port, cohort=a.cohort, buffer_size=a.buffer_size,
        staleness_power=a.staleness_power, tick_interval_s=a.tick_interval,
        flush_every=a.flush_every, history_window=a.history_window,
        rate_limit=a.rate_limit, rate_burst=a.rate_burst,
        max_pending=a.max_pending, stale_deprioritize=a.stale_deprioritize,
        stale_reject=a.stale_reject, seed=a.seed, screen=a.screen,
        screen_norm_mult=a.screen_norm_mult,
        screen_cos_min=a.screen_cos_min, screen_warmup=a.screen_warmup,
        screen_clip_norm=a.screen_clip_norm,
        quarantine_strikes=a.quarantine_strikes)
    got = serving_config_from_args(t_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _changed_fields(cfg, preset) -> dict:
    out = {}
    for section in _SECTIONS:
        a, b = getattr(cfg, section), getattr(preset, section)
        for f in dataclasses.fields(a):
            if getattr(a, f.name) != getattr(b, f.name):
                out[f"{section}.{f.name}"] = getattr(a, f.name)
    return out


@pytest.mark.parametrize("argv", [
    ["run", "--shard-strategy", "dirichlet"],
    ["run", "--csv", "x.csv", "--label-column", "income"],
    ["run", "--use-pallas"],
    ["sweep", "--shard-strategy", "label_sort"],
    ["run", "--preset", "sklearn-parity", "--label-column", "y",
     "--shard-strategy", "label_sort", "--use-pallas"],
    ["parity", "--preset", "sklearn-parity", "--shard-strategy",
     "dirichlet"]], ids=lambda a: " ".join(a))
def test_cli_c5_command_lines_set_fedtpus_fields(argv):
    """Each command line of ROADMAP C5 that fedtpu accepts, the port
    accepts, and it changes the same config fields to the same values."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser, config_from_args
    j_args, t_args = j_parser().parse_args(argv), t_parser().parse_args(argv)
    j_cfg = _apply_overrides(jcfg.get_preset(j_args.preset), j_args)
    t_cfg = config_from_args(t_args)
    j_changed = _changed_fields(j_cfg, jcfg.get_preset(j_args.preset))
    t_changed = _changed_fields(t_cfg, tcfg.get_preset(t_args.preset))
    # fedtpu's income presets read the income CSV, the port's synthetic
    # rows (DataConfig.csv_path=None), so --csv changes the field on one
    # side only; it sets the same path on both.
    changed = set(j_changed) | set(t_changed)
    assert changed
    for key in changed:
        section, field = key.split(".")
        assert getattr(getattr(j_cfg, section), field) == getattr(
            getattr(t_cfg, section), field), key


def test_cli_presets_prints_fedtpus_lines(capsys):
    """``presets`` prints fedtpu's line for each preset both packages
    ship, and the port ships every fedtpu preset."""
    from fedtpu.cli import main as j_main
    from fedtpu_torch.cli import main as t_main
    assert j_main(["presets"]) == 0
    j_lines = capsys.readouterr().out.splitlines()
    assert t_main(["presets"]) == 0
    t_lines = capsys.readouterr().out.splitlines()
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert t_lines == j_lines and any(
        line.startswith("sklearn-parity: clients=4 model=mlp[50, 400] "
                        "rounds=5 weighting=uniform") for line in t_lines)


# ------------------------------------------- the numpy MLPClassifier
def _sklearn_shard(rows: int = 409, classes: int = 2):
    from fedtpu_torch.data.tabular import load_tabular_dataset
    ds = load_tabular_dataset(tcfg.DataConfig(
        scale_with_mean=False, synthetic_classes=classes))
    return ds.x_train[:rows], ds.y_train[:rows], np.unique(ds.y_train)


def _assert_same_classifier(ours, theirs):
    for name in ("coefs_", "intercepts_"):
        for a, b in zip(getattr(ours, name), getattr(theirs, name),
                        strict=True):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert ours.n_iter_ == theirs.n_iter_
    assert ours.loss_curve_ == theirs.loss_curve_


@pytest.mark.parametrize("hidden,classes", [((8,), 2), ((50, 400), 2),
                                            ((8, 6), 3)])
def test_numpy_mlp_classifier_is_sklearns(hidden, classes):
    """partial_fit, then fit over assigned weights (which fit discards),
    then fit again: coefs_, intercepts_, n_iter_, loss_curve_ and predict
    exactly scikit-learn 1.9.0's on the same float32 rows (the same numpy
    operations on the same BLAS; measured difference 0). (50, 400) is the
    sklearn-parity preset's width; three classes take the softmax path."""
    import warnings
    sk = pytest.importorskip("sklearn.neural_network")
    from fedtpu_torch.parity.mlp_classifier import (ConvergenceWarning,
                                                    MLPClassifier)
    x, y, classes_all = _sklearn_shard(classes=classes)
    kw = dict(activation="relu", hidden_layer_sizes=hidden,
              learning_rate_init=0.004, max_iter=300, random_state=42)
    theirs, ours = sk.MLPClassifier(**kw), MLPClassifier(**kw)
    for m in (theirs, ours):
        m.partial_fit(x, y, classes=classes_all)
    _assert_same_classifier(ours, theirs)
    np.testing.assert_array_equal(ours.predict(x), theirs.predict(x))
    for m in (theirs, ours):
        m.coefs_ = [np.full_like(w, 0.01) for w in m.coefs_]
        m.intercepts_ = [np.zeros_like(b) for b in m.intercepts_]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            for m in (theirs, ours):
                m.fit(x, y)
            _assert_same_classifier(ours, theirs)
            np.testing.assert_array_equal(ours.predict(x), theirs.predict(x))
    # A fit that ends at max_iter warns, as scikit-learn's does.
    short = MLPClassifier(**{**kw, "max_iter": 2})
    with pytest.warns(ConvergenceWarning, match=r"Maximum iterations \(2\)"):
        short.fit(x, y)


# ------------------------------------------------ param_dtype: the pieces
def test_param_dtype_takes_fedtpus_dtypes_and_refuses_others():
    """bfloat16 and float16 params build, in that dtype, with fedtpu's
    rule for the logits; any other name is fedtpu's KeyError."""
    from fedtpu.models import build_model as j_build_model
    from fedtpu_torch.models.registry import build_model
    for name, dt in (("bfloat16", torch.bfloat16),
                     ("float16", torch.float16)):
        model = build_model(tcfg.ModelConfig(param_dtype=name))
        assert model.param_dtype == dt and model.mlp_dims is None
        flat = model.init(torch.Generator().manual_seed(0))
        assert flat.dtype == dt
        # bf16 params under the default float32 compute: bf16 logits.
        assert model.apply(flat, torch.zeros(3, 14)).dtype == dt
    for build, cfg in ((build_model, tcfg.ModelConfig),
                       (j_build_model, jcfg.ModelConfig)):
        with pytest.raises(KeyError, match="float64"):
            build(cfg(param_dtype="float64"))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlp", "convnet"])
def test_bf16_param_forward_is_fedtpus(kind, compute):
    """A bfloat16-param model's forward on fedtpu's own params: the same
    logits bit for bit, in bfloat16 (a ConvNet without a compute dtype of
    its own is refused by both)."""
    from fedtpu.models import build_model as j_build_model
    from fedtpu_torch.models.registry import build_model
    kw = dict(param_dtype="bfloat16", compute_dtype=compute)
    if kind == "convnet":
        kw.update(kind="convnet", num_classes=10, hidden_sizes=(32,),
                  conv_channels=(8, 16), image_shape=(8, 8, 3))
    j_init_fn, j_apply_fn = j_build_model(jcfg.ModelConfig(**kw))
    model = build_model(tcfg.ModelConfig(**kw))
    params = _np_tree(j_init_fn(jax.random.key(3)))
    x = np.random.default_rng(0).standard_normal(
        (5, 8 * 8 * 3 if kind == "convnet" else 14)).astype(np.float32)
    flat = convert.params_from_jax(params)
    assert flat.dtype == torch.bfloat16
    if kind == "convnet" and compute == "bfloat16":
        with pytest.raises(TypeError):
            j_apply_fn(params, jnp.asarray(x))
        with pytest.raises(TypeError, match="one dtype"):
            model.apply(flat, torch.from_numpy(x))
        return
    ours = model.apply(flat, torch.from_numpy(x))
    theirs = np.asarray(j_apply_fn(params, jnp.asarray(x)))
    assert ours.dtype == torch.bfloat16 and theirs.dtype.name == "bfloat16"
    np.testing.assert_array_equal(ours.float().numpy(),
                                  theirs.astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_convert_round_trips_16_bit_leaves(dtype):
    """fedtpu's bfloat16 / float16 leaves become tensors of that dtype bit
    for bit (bfloat16 through its bits, by the dtype's name); the way back
    gives bfloat16 as float32 exactly, and cast back it is the same bits."""
    tree = _np_tree(j_init(jax.random.key(1), 14, (50, 200), 2,
                           param_dtype=getattr(jnp, dtype)))
    flat = convert.params_from_jax(tree)
    assert flat.dtype == getattr(torch, dtype)
    back = convert.params_to_numpy(flat, INCOME_DIMS)
    for (path, a), (_, b) in zip(_tree_leaves(tree), _tree_leaves(back),
                                 strict=True):
        assert b.dtype == (np.float32 if dtype == "bfloat16" else np.float16)
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=path)
    again = convert.params_from_jax(back).to(flat.dtype)
    assert torch.equal(again.view(torch.int16), flat.view(torch.int16))


def _tree_leaves(tree):
    from fedtpu_torch.models.registry import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k1_plain_version_at_16_bit_is_fedtpus_average(dtype):
    """K1's plain version on a 16-bit stack: the broadcast is fedtpu's
    ``bcast_global(tensordot(w, p.astype(f32)) / max(sum w, 1))`` (its
    psum round's average) in the slot dtype, equal but for rounding
    flips of one ulp on at most 0.1 % of the columns (K1 divides each
    weight by the total, fedtpu the sum; measured: 1 column of 11,352 at
    bf16, 4 at fp16, none under uniform weights); the (D,) mode is that
    float32 average (within 1e-5 relative); a float32 stack broadcast into
    16-bit slots is its average rounded once; zero weights carry the stack
    over bit for bit; a NaN column stays NaN."""
    from fedtpu.parallel.round import bcast_global
    from fedtpu_torch.ops.cuda_kernels import (
        weighted_average_clients as wavg)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 11352)) * 0.1).astype(np.float32)
    x[:, 7] = np.nan
    w = rng.integers(100, 500, 8).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)

    @jax.jit
    def fedtpu_average(p, wt):
        glob = jnp.tensordot(wt, p.astype(jnp.float32), axes=1) / \
            jnp.maximum(wt.sum(), 1.0)
        return glob, bcast_global(glob, p)

    glob_j, bcast_j = (np.asarray(a.astype(jnp.float32))
                       for a in fedtpu_average(xj, jnp.asarray(w)))
    xt = convert.leaf_to_tensor(np.asarray(xj))
    bcast_t = wavg(xt, torch.from_numpy(w), broadcast=True)
    assert bcast_t.dtype == tdt
    bt = bcast_t.float().numpy()
    np.testing.assert_array_equal(np.isnan(bt), np.isnan(bcast_j))
    assert np.isnan(bt[:, 7]).all()
    off = ~np.isnan(bt) & (bt != bcast_j)
    assert off.any(axis=0).sum() <= 0.001 * x.shape[1]
    one_ulp = np.abs(bt[off] - bcast_j[off]) <= np.abs(
        bcast_j[off]) * 2.0 ** -(7 if dtype == "bfloat16" else 10)
    assert one_ulp.all()
    glob_t = wavg(xt, torch.from_numpy(w)).numpy()
    assert glob_t.dtype == np.float32
    np.testing.assert_allclose(glob_t, glob_j, rtol=1e-5, atol=1e-7)
    # A float32 stack into 16-bit slots: the float32 average rounded once.
    x32 = torch.from_numpy(x)
    wide = wavg(x32, torch.from_numpy(w), broadcast=True, out_dtype=tdt)
    assert wide.dtype == tdt and torch.isnan(wide[:, 7]).all()
    glob32 = wavg(x32, torch.from_numpy(w)).to(tdt).expand(8, -1)
    assert torch.equal(wide.view(torch.int16)[:, 8:],
                       glob32.contiguous().view(torch.int16)[:, 8:])
    zero = torch.zeros(8)
    assert torch.equal(wavg(xt, zero, broadcast=True).view(torch.int16),
                       xt.view(torch.int16))
    assert torch.equal(wavg(x32, zero, broadcast=True, out_dtype=tdt)
                       .view(torch.int16), x32.to(tdt).view(torch.int16))
    with pytest.raises(TypeError, match="float64"):
        wavg(torch.zeros(2, 3, dtype=torch.float64), torch.ones(2))
    with pytest.raises(TypeError, match="out_dtype"):
        wavg(xt, torch.from_numpy(w), broadcast=True,
             out_dtype=torch.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_16_bit_optimizer_state_is_optaxs(name, dtype):
    """Adam's moments and SGD's trace stay in the params' dtype, and three
    updates round where optax's do (each constant first in that dtype,
    each product and sum rounded, the float32 bias corrections and rate
    cast before they apply). bfloat16: bit for bit optax's. float16: XLA
    fuses optax's chain and keeps some float32 intermediates unrounded,
    which PyTorch's per-op rounding cannot follow: the same entries
    overflow (Adam's float16 eps is 0, so an underflowed second moment
    divides by 0) and the same are NaN, and the finite ones agree within
    2 float16 ulps at each tensor's largest magnitude (measured: 1)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg = tcfg.OptimConfig(name=name)
    tx_j = j_build_optimizer(jcfg.OptimConfig(name=name))
    tx_t = build_optimizer(cfg)
    rng = np.random.default_rng(7)
    p = jnp.asarray(rng.standard_normal((4, 300)) * 0.1, jdt)
    state_j = jax.vmap(tx_j.init)(p)
    pt = convert.leaf_to_tensor(np.asarray(p))
    state_t = tx_t.init(pt)

    @jax.jit
    def step_j(p, g, s):
        u, s = jax.vmap(tx_j.update)(g, s, p)
        return optax.apply_updates(p, u), s

    mant = 7 if dtype == "bfloat16" else 10
    for _ in range(3):
        g = rng.standard_normal((4, 300)) * 10.0 ** rng.uniform(
            -4, -1, (4, 300))
        gj = jnp.asarray(g, jdt)
        p, state_j = step_j(p, gj, state_j)
        pt, state_t = tx_t.update(convert.leaf_to_tensor(np.asarray(gj)),
                                  state_t, pt)
        assert pt.dtype == tdt and all(
            v.dtype == tdt for k, v in state_t.items() if k != "count")
        pairs = [(pt, p)] + ([(state_t["mu"], state_j[0].mu),
                              (state_t["nu"], state_j[0].nu)]
                             if name == "adam" else
                             [(state_t["trace"], state_j[0].trace)])
        for ours, theirs in pairs:
            a = ours.float().numpy()
            b = np.asarray(theirs).astype(np.float32)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(a, b)
            else:
                fin = np.isfinite(b)
                np.testing.assert_array_equal(np.isfinite(a), fin)
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                scale_ulp = 2.0 ** (np.floor(np.log2(np.max(
                    np.abs(b[fin])))) - mant)
                assert np.max(np.abs(a - b)[fin]) <= 2 * scale_ulp


# ------------------------------- K1's sum mode (the asynchronous tick)
@pytest.mark.parametrize("case", ["positive", "signed negative total",
                                  "all zero", "nan row"])
def test_k1_sum_mode_plain_matches_fedtpus_contraction(case):
    """The plain version of K1's sum mode against fedtpu's
    tensordot(w, x) (async_fed.py:400) on the same inputs, 1e-6; every
    weight 0 gives 0.0 exactly, a NaN row is NaN in every column where
    its weight meets it (0 * NaN too)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 301)).astype(np.float32)
    w = {"positive": rng.uniform(0.1, 1.0, 9),
         "signed negative total": np.array([1, -8, 1, 0, -8, 1, 1, 0.5,
                                            -0.25]),
         "all zero": np.zeros(9),
         "nan row": np.arange(9) - 4.0}[case].astype(np.float32)
    if case == "nan row":
        x[3, ::5] = np.nan
    ours = ck.weighted_sum_clients(torch.from_numpy(x), torch.from_numpy(w))
    theirs = np.asarray(jnp.tensordot(jnp.asarray(w), jnp.asarray(x),
                                      axes=1))
    assert ours.dtype == torch.float32 and ours.shape == (301,)
    np.testing.assert_array_equal(np.isnan(ours.numpy()), np.isnan(theirs))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6, rtol=1e-6)
    if case == "all zero":
        assert not ours.abs().max()


def test_k1_sum_mode_wrapper_rules():
    """The sum mode takes a float32 (C, D) stack only, naming what it was
    given; on the CPU it runs the plain version and counts no launch."""
    ck.reset_launch_counts()
    x, w = torch.ones(3, 5), torch.ones(3)
    assert torch.equal(ck.weighted_sum_clients(x, w), torch.full((5,), 3.0))
    assert ck.LAUNCHES["weighted_average_clients"] == 0
    with pytest.raises(TypeError, match="float32, got torch.bfloat16"):
        ck.weighted_sum_clients(x.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match=r"\(clients, D\)"):
        ck.weighted_sum_clients(torch.ones(5), w)
    with pytest.raises(ValueError, match="weights"):
        ck.weighted_sum_clients(x, torch.ones(4))


# ------------------------------------------ the asynchronous CLI flags
@pytest.mark.parametrize("argv", [
    ["run", "--async", "--arrival-rate", "0.25", "--arrival-seed", "7",
     "--staleness-power", "0", "--server-lr", "0.5", "--weighting",
     "uniform"],
    ["run", "--preset", "income-32-noniid", "--async", "--weighting",
     "uniform", "--arrival-rate", "0.25", "--buffer-size", "16"],
    ["run"]], ids=lambda a: " ".join(a))
def test_cli_async_flags_set_fedtpus_fields(argv):
    """The five flags on the port's parser set fedtpu's FedConfig fields
    to fedtpu's values (tests/test_async.py:285)."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser, config_from_args
    j_args, t_args = j_parser().parse_args(argv), t_parser().parse_args(argv)
    j_fed = _apply_overrides(jcfg.get_preset(j_args.preset), j_args).fed
    t_fed = config_from_args(t_args).fed
    for field in ("async_mode", "async_arrival_rate", "async_arrival_seed",
                  "async_staleness_power", "async_buffer_size",
                  "server_lr", "weighting"):
        assert getattr(t_fed, field) == getattr(j_fed, field), field


@pytest.mark.parametrize("flag", ["--arrival-rate", "--arrival-seed",
                                  "--staleness-power", "--buffer-size"])
def test_cli_async_knobs_without_async_are_refused(flag):
    from fedtpu_torch.cli import build_parser, config_from_args
    args = build_parser().parse_args(["run", flag, "1"])
    with pytest.raises(SystemExit, match="require --async"):
        config_from_args(args)


def test_cli_async_run_on_cpu(capsys):
    """``run --async`` through the CLI on the CPU: the summary JSON with
    the staleness fields."""
    import json

    from fedtpu_torch.cli import main
    assert main(["run", "--async", "--weighting", "uniform",
                 "--arrival-rate", "0.5", "--buffer-size", "4",
                 "--platform", "cpu", "--synthetic-rows", "256",
                 "--num-clients", "4", "--hidden-sizes", "8", "--rounds",
                 "6", "--rounds-per-step", "3", "--quiet", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["rounds_run"] == 6 and summary["max_staleness"] >= 0
    assert "mean_staleness" in summary


# -------------------------------- the rest of the serving stack (A8c)
# The port's cohort store, wire-fault plan, autoscale policy and signals
# against fedtpu's on the same numpy inputs; the gateway and autoscale
# command lines. The engine, the gateway fleet, the proxy and the sims are
# held against fedtpu in test_torch_round.py.

_NET_PLAN = {
    "seed": 3,
    "faults": [
        {"kind": "net_partition", "gateway": 0, "frame": 2, "frames": 3},
        {"kind": "net_torn_frame", "gateway": 1, "frame": 4,
         "boundary": "post_ack", "cut_bytes": 32},
        {"kind": "net_reset", "gateway": 0, "frame": 2, "phase": "accept"},
        {"kind": "net_dup_frame", "gateway": 1, "frame": 9},
        {"kind": "net_slow_link", "gateway": 0, "probability": 0.5,
         "window": [10, 17], "chunk_bytes": 256},
    ],
}


def _store_kw():
    return dict(cohort=8, buffer_size=2, tick_interval_s=0.5, data_rows=64,
                model_hidden=(8,), seed=0)


@functools.lru_cache(maxsize=None)
def _store_states():
    """fedtpu's serving engine state and the port's, at the small serving
    shape (cohort 8, one hidden layer of 8): the stores' templates."""
    from fedtpu.serving.engine import ServingEngine as JEngine
    from fedtpu.telemetry.metrics import MetricsRegistry as JRegistry

    from fedtpu_torch.serving.engine import ServingEngine as TEngine
    j = JEngine(jcfg.ServingConfig(**_store_kw()), registry=JRegistry())
    t = TEngine(tcfg.ServingConfig(**_store_kw()), device="cpu")
    return jax.tree.map(np.asarray, j.state), t.state


def _j_leaves_as_port(j_state, leaves):
    """fedtpu's store leaves (its per_client_view order, K-leading) as the
    port's: anchors, Adam's count, mu, nu, params, pull tick, each
    quantity's pytree leaves concatenated in the flat row's order."""
    from fedtpu.parallel.round import with_per_client
    s = with_per_client(j_state, 8, [np.asarray(v) for v in leaves])
    adam = s["opt_state"][0]
    return [convert.params_from_jax(s["anchors"]).numpy(),
            np.asarray(adam.count, np.int32),
            convert.params_from_jax(adam.mu).numpy(),
            convert.params_from_jax(adam.nu).numpy(),
            convert.params_from_jax(s["params"]).numpy(),
            np.asarray(s["pull_tick"], np.int32)]


def _j_random_leaves(template, k, rng):
    """Random fedtpu-layout leaves for ``k`` records; the schedule's count
    equals Adam's, as in a real state."""
    out = []
    for shape, dtype in template:
        if np.dtype(dtype).kind == "f":
            out.append(rng.normal(size=(k,) + shape).astype(dtype))
        else:
            out.append(rng.integers(0, 50, size=(k,) + shape).astype(dtype))
    counts = [i for i, (shape, dtype) in enumerate(template)
              if np.dtype(dtype).kind != "f" and shape == ()]
    out[counts[1]] = out[counts[0]].copy()   # optax's two update counts
    return out


def _store_headers(store, ids):
    strikes, quarantined = store.reputation(ids)
    return (store.versions(ids).tolist(), store.participation(ids).tolist(),
            store.read_keys(ids).tolist(), strikes.tolist(),
            quarantined.tolist())


@pytest.mark.parametrize("backend", ["memory", "mmap"])
def test_store_headers_and_values_equal_fedtpus(tmp_path, backend):
    """One sequence of writes, reads, reputation writes, checkpoint_arrays
    / restore_arrays and absorb_shard through fedtpu's ClientStateStore
    and the port's: every header equal, every value equal under the leaf
    mapping; each side's digest verifies its own export and refuses a
    corrupted record; a stale generation is refused; bad ids raise
    fedtpu's errors."""
    from fedtpu.cohort.store import ClientStateStore as JStore
    from fedtpu.cohort.store import state_template as j_template

    from fedtpu_torch.cohort.store import ClientStateStore as TStore
    from fedtpu_torch.cohort.store import state_template as t_template
    j_state, t_state = _store_states()
    jt, tt = j_template(j_state, 8), t_template(t_state, 8)
    assert [(s, d.name) for s, d in tt] == [
        ((74,), "float32"), ((), "int32"), ((74,), "float32"),
        ((74,), "float32"), ((74,), "float32"), ((), "int32")]
    rng = np.random.default_rng(0)

    def make(cls, template, shard, tag):
        path = (str(tmp_path / f"{tag}.{shard}") if backend == "mmap"
                else None)
        return cls(template, 40, backend=backend, path=path,
                   shard_index=shard, num_shards=2)

    j1, t1 = make(JStore, jt, 1, "j"), make(TStore, tt, 1, "t")
    keys = rng.integers(0, 2**32, size=(3, 2), dtype=np.uint32)
    first = _j_random_leaves(jt, 3, rng)
    second = _j_random_leaves(jt, 2, rng)
    for store, conv in ((j1, list), (t1, lambda v: _j_leaves_as_port(
            j_state, v))):
        store.write(np.array([1, 3, 5]), conv(first), keys=keys)
        store.write(np.array([3, 7]), conv(second), participated=False)
        store.set_reputation(np.array([5, 9]), np.array([2, 3], np.uint32),
                             np.array([False, True]))
    ids = np.array([1, 3, 5, 7, 9, 11])
    assert _store_headers(t1, ids) == _store_headers(j1, ids)
    assert t1.quarantined_ids().tolist() == j1.quarantined_ids().tolist()
    for got, want in zip(t1.read(ids), _j_leaves_as_port(j_state,
                                                         j1.read(ids))):
        np.testing.assert_array_equal(got, want)
    assert (t1.resident_estimate_bytes() // t1.record_bytes
            == j1.resident_estimate_bytes() // j1.record_bytes == 5)
    for store in (j1, t1):
        for bad, match in ((np.array([41]), "out of range"),
                           (np.array([2]), "not owned")):
            with pytest.raises(ValueError, match=match):
                store.read(bad)

    j1.generation = t1.generation = "genA"
    for side, (cls, template, old) in {"j": (JStore, jt, j1),
                                       "t": (TStore, tt, t1)}.items():
        arrays = old.checkpoint_arrays()
        # Restored into a fresh store of the same shard: bitwise.
        fresh = make(cls, template, 1, f"{side}-fresh")
        fresh.restore_arrays(arrays)
        assert _store_headers(fresh, ids) == _store_headers(old, ids)
        for a, b in zip(fresh.read(ids), old.read(ids)):
            np.testing.assert_array_equal(a, b)
        corrupt = dict(arrays, store_records=arrays["store_records"].copy())
        corrupt["store_records"][2, -1] ^= 1
        with pytest.raises(ValueError, match="digest mismatch"):
            make(cls, template, 1, f"{side}-bad").restore_arrays(corrupt)
        # Failover: shard 0 adopts shard 1's export.
        survivor = make(cls, template, 0, f"{side}-0")
        with pytest.raises(ValueError, match="generation"):
            survivor.absorb_shard(arrays, expected_generation="genB")
        with pytest.raises(ValueError, match="digest mismatch"):
            survivor.absorb_shard(corrupt, expected_generation="genA")
        assert survivor.absorb_shard(arrays, expected_generation="genA") == 5
        assert survivor.owns(ids).all()
        assert _store_headers(survivor, ids) == _store_headers(old, ids)
        for a, b in zip(survivor.read(ids), old.read(ids)):
            np.testing.assert_array_equal(a, b)
        # The survivor's own export carries the absorbed shard along.
        again = make(cls, template, 0, f"{side}-0b")
        again.restore_arrays(survivor.checkpoint_arrays())
        assert again.owns(np.array([1])).all()


@pytest.mark.parametrize("form", ["dict", "json", "file"])
@pytest.mark.parametrize("spec", ["fedtpu's test plan", "net sim",
                                  "probabilistic"])
def test_netfault_plan_equals_fedtpus(tmp_path, spec, form):
    """A plan in each spec form materializes to fedtpu's schedule and
    digest, bit for bit, and answers for_gateway / at_frame / at_accept
    as fedtpu's on every ordinal."""
    from fedtpu.resilience.net_sim import SIM_PLAN
    from fedtpu.resilience.netfaults import NetFaultPlan as JPlan

    from fedtpu_torch.resilience import net_sim as t_net_sim
    from fedtpu_torch.resilience.netfaults import NetFaultPlan as TPlan
    plans = {"fedtpu's test plan": _NET_PLAN, "net sim": SIM_PLAN,
             "probabilistic": {"seed": 11, "faults": [
                 {"kind": "net_partition", "gateway": 1, "probability": 0.3},
                 {"kind": "net_dup_frame", "gateway": 0, "probability": 0.2,
                  "window": [5, 30]},
                 {"kind": "net_torn_frame", "gateway": 0, "probability": 0.1,
                  "boundary": "pre_ack", "cut_bytes": 7}]}}
    assert t_net_sim.SIM_PLAN == SIM_PLAN
    raw = plans[spec]
    given = {"dict": raw, "json": json.dumps(raw)}.get(form)
    if form == "file":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps(raw))
        given = str(path)
    want, got = JPlan.load(raw, num_gateways=2), TPlan.load(given,
                                                            num_gateways=2)
    assert got.digest == want.digest and got.seed == want.seed
    assert ([dataclasses.asdict(f) for f in got.faults]
            == [dataclasses.asdict(f) for f in want.faults])
    assert [f.payload() for f in got.faults] == [f.payload()
                                                  for f in want.faults]
    for g in (0, 1):
        assert ([dataclasses.asdict(f) for f in got.for_gateway(g)]
                == [dataclasses.asdict(f) for f in want.for_gateway(g)])
        for k in range(1, 70):
            for name in ("at_frame", "at_accept"):
                a, b = getattr(got, name)(g, k), getattr(want, name)(g, k)
                assert (a and dataclasses.asdict(a)) == (
                    b and dataclasses.asdict(b)), (name, g, k)


@pytest.mark.parametrize("entry", [
    {"kind": "net_unplug", "frame": 1},
    {"kind": "net_partition", "gateway": 2, "frame": 1},
    {"kind": "net_partition"},
    {"kind": "net_partition", "frame": 0},
    {"kind": "net_dup_frame", "frame": 1, "frames": 2},
    {"kind": "net_torn_frame", "frame": 1, "cut_bytes": 0},
    {"kind": "net_torn_frame", "frame": 1, "boundary": "mid_ack"},
    {"kind": "net_slow_link", "frame": 1, "chunk_bytes": 0},
    {"kind": "net_slow_link", "frame": 1, "delay_s": -0.1},
    {"kind": "net_reset", "frame": 1, "phase": "connect"},
    {"kind": "net_partition", "probability": 1.5},
    {"kind": "net_partition", "frame": 3, "frames": 0}],
    ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_netfault_plan_refuses_what_fedtpu_refuses(entry):
    from fedtpu.resilience.netfaults import NetFaultPlan as JPlan

    from fedtpu_torch.resilience.netfaults import NetFaultPlan as TPlan
    errors = []
    for cls in (JPlan, TPlan):
        with pytest.raises(ValueError) as info:
            cls.load({"faults": [entry]}, num_gateways=2)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def _autoscale_snapshots(module, n=120, seed=0):
    """A random snapshot stream through ``module``'s SignalBus: bursts of
    backlog, burn and rejections, quiet stretches, and two preemption
    notices."""
    rng = np.random.default_rng(seed)
    bus = module.SignalBus(objective_s=1.0, error_budget=0.1)
    out = []
    for k in range(n):
        hot = (k // 10) % 3 == 1
        stats = {"backlog": int(rng.integers(200, 900) if hot
                                else rng.integers(0, 60)),
                 "incorporated": 10 * k, "admitted": 11 * k,
                 "window_decisions": int(rng.integers(0, 100)),
                 "rates": {"reject_rate": float(rng.uniform(0, 0.3)),
                           "reject_backpressure": float(
                               rng.uniform(0, 0.05))}}
        if k % 7 == 3:
            stats["slo_burn"] = float(rng.uniform(0, 2))
        hist = {"count": 10, "bins": [0.5, 1.0, 5.0],
                "bucket_counts": [int(rng.integers(0, 5)), 6, 10]}
        out.append(bus.fold(0.5 * (k + 1), stats=stats,
                            members=[(0, "serving"), (1, "parked")],
                            notice=1 if k in (40, 95) else -1,
                            latency_hist=hist))
    return out


@pytest.mark.parametrize("knobs", [dict(), dict(hysteresis_ticks=3,
                                                cooldown_ticks=0),
                                   dict(hysteresis_ticks=1,
                                        cooldown_ticks=2)],
                         ids=["default", "hysteresis 3", "cooldown 2"])
def test_autoscale_policy_and_bus_equal_fedtpus(knobs):
    """The same telemetry through fedtpu's SignalBus and threshold policy
    and the port's: every snapshot and decision line equal, byte for
    byte (hysteresis, cooldown and the notice bypass all fire)."""
    from fedtpu.autoscale import policy as j_policy, signals as j_signals

    from fedtpu_torch.autoscale import policy as t_policy
    from fedtpu_torch.autoscale import signals as t_signals
    lines, kinds = {}, set()
    for name, pol_mod, sig_mod, cfg_mod in (
            ("j", j_policy, j_signals, jcfg), ("t", t_policy, t_signals,
                                               tcfg)):
        cfg = cfg_mod.AutoscaleConfig(**knobs)
        pol = pol_mod.get_policy("threshold", cfg)
        st, out = pol.initial_state(), []
        for snap in _autoscale_snapshots(sig_mod):
            decisions, st = pol.decide(snap, st)
            out.append((json.dumps(snap.to_json(), sort_keys=True),
                        pol_mod.decision_line(snap, decisions)))
            if name == "t":
                kinds.update(d.kind for d in decisions)
        lines[name] = out
    assert lines["t"] == lines["j"]
    assert {"grow", "shrink", "pre_drain", "hold"} <= kinds


def test_autoscale_policy_pins_and_registry():
    """fedtpu's policy pins (tests/test_autoscale.py) on the port's
    policy: consecutive hot ticks, the refractory cooldown, the notice
    bypass; the registry and the closed decision shape."""
    from fedtpu_torch.autoscale.policy import (HOLD, PRE_DRAIN, SHRINK,
                                               Decision,
                                               ThresholdHysteresisPolicy,
                                               get_policy, register_policy)
    from fedtpu_torch.autoscale.signals import Snapshot

    def snap(v, backlog=0, notice=-1):
        return Snapshot(version=v, t=0.5 * v, backlog=backlog, notice=notice)

    cfg = tcfg.AutoscaleConfig(hysteresis_ticks=3, cooldown_ticks=0)
    pol = ThresholdHysteresisPolicy(cfg)
    st = pol.initial_state()
    kinds = []
    for v, backlog in enumerate((10_000, 10_000, 0, 10_000, 10_000,
                                 10_000)):
        d, st = pol.decide(snap(v, backlog), st)
        kinds.append([x.kind for x in d])
    assert kinds[:5] == [[HOLD]] * 5
    assert kinds[5] == ["grow", "set_tick_cadence", "set_cohort_size"]
    pol = ThresholdHysteresisPolicy(tcfg.AutoscaleConfig(
        hysteresis_ticks=1, cooldown_ticks=2))
    st = pol.initial_state()
    kinds = []
    for v in range(4):
        d, st = pol.decide(snap(v, 10_000), st)
        kinds.append(d[0].kind)
    assert kinds == ["grow", HOLD, HOLD, "grow"]
    pol = ThresholdHysteresisPolicy(tcfg.AutoscaleConfig(
        hysteresis_ticks=5, cooldown_ticks=3))
    d, st = pol.decide(snap(0, notice=1), pol.initial_state())
    assert [x.kind for x in d] == [PRE_DRAIN, SHRINK] and d[0].victim == 1
    assert [x.kind for x in pol.decide(snap(1, 10_000), st)[0]] == [HOLD]
    assert isinstance(get_policy("threshold", tcfg.AutoscaleConfig()),
                      ThresholdHysteresisPolicy)
    with pytest.raises(ValueError, match="already registered"):
        register_policy("threshold", ThresholdHysteresisPolicy)
    with pytest.raises(ValueError, match="unknown policy"):
        get_policy("nope", tcfg.AutoscaleConfig())
    with pytest.raises(ValueError, match="unknown decision kind"):
        Decision("explode")
    assert set(Decision(HOLD).to_json()) == {"kind", "n", "value", "victim"}


def test_autoscale_read_gang_members_equals_fedtpus(tmp_path):
    """Hand-written heartbeat files (serving, parked, garbage, missing)
    read as fedtpu reads them, fresh and aged."""
    import time

    from fedtpu.autoscale.signals import read_gang_members as j_read

    from fedtpu_torch.autoscale.signals import read_gang_members as t_read
    from fedtpu_torch.resilience.distributed import heartbeat_path_for
    base = str(tmp_path / "hb")
    now = time.time()
    beats = {0: {"status": "serving", "time": now - 1.0},
             1: {"status": "parked", "time": now - 500.0},
             2: {"status": "running", "time": now - 30.0}}
    for p, rec in beats.items():
        with open(heartbeat_path_for(base, p), "w") as fh:
            json.dump(rec, fh)
    with open(heartbeat_path_for(base, 3), "w") as fh:
        fh.write("{torn")
    for when in (now, now + 1000.0):
        got = t_read(base, 5, now=when)
        assert got == j_read(base, 5, now=when)
    assert t_read(base, 5, now=now) == (
        (0, "serving"), (1, "parked"), (2, "stale"), (3, "missing"),
        (4, "missing"))


def test_autoscale_config_has_fedtpus_fields_and_checks():
    want = [(f.name, f.default) for f in
            dataclasses.fields(jcfg.AutoscaleConfig)]
    assert [(f.name, f.default) for f in
            dataclasses.fields(tcfg.AutoscaleConfig)] == want
    for bad in (dict(objective_s=0.0), dict(control_interval_s=0.0),
                dict(backlog_low=300), dict(hysteresis_ticks=0),
                dict(min_capacity=3, max_capacity=2),
                dict(tick_fast_s=0.0)):
        errors = []
        for cfg in (jcfg, tcfg):
            with pytest.raises(ValueError) as info:
                cfg.AutoscaleConfig(**bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("argv", [
    ["gateway", "--num-gateways", "3", "--gateway-index", "2",
     "--total-users", "5000", "--store", "mmap", "--store-path", "s",
     "--cohort", "16", "--buffer-size", "4", "--flush-every", "8",
     "--net-fault-plan", "{}"],
    ["autoscale", "--simulate", "--policy", "threshold", "--objective",
     "2", "--error-budget", "0.2", "--interval", "0.25", "--trace", "t"],
    ["autoscale", "--port", "7", "--heartbeat", "hb", "--num-processes",
     "3", "--supervisor-pid", "9", "--notice-file", "n", "--spool-path",
     "sp", "--duration", "4", "--stop-after-notice"]],
    ids=["gateway", "autoscale sim", "autoscale live"])
def test_cli_gateway_and_autoscale_parse_as_fedtpus(argv):
    """Every flag of these command lines lands on the port's parser with
    fedtpu's value, and the gateway's ServingConfig is the one fedtpu's
    gateway handler builds."""
    from fedtpu.cli import build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser
    from fedtpu_torch.cli import serving_config_from_args
    j_args, t_args = j_parser().parse_args(argv), t_parser().parse_args(argv)
    j_vars = {k: v for k, v in vars(j_args).items() if k != "cmd"}
    t_vars = {k: v for k, v in vars(t_args).items() if k != "command"}
    assert t_args.command == j_args.cmd
    shared = set(j_vars) & set(t_vars)
    assert {k: t_vars[k] for k in shared} == {k: j_vars[k] for k in shared}
    if argv[0] == "gateway":
        a = j_args
        want = jcfg.ServingConfig(   # fedtpu/cli.py:1945, its gateway's
            host=a.host, port=a.port, cohort=a.cohort,
            buffer_size=a.buffer_size, staleness_power=a.staleness_power,
            tick_interval_s=a.tick_interval, flush_every=a.flush_every,
            history_window=a.history_window, rate_limit=a.rate_limit,
            rate_burst=a.rate_burst, max_pending=a.max_pending,
            stale_deprioritize=a.stale_deprioritize,
            stale_reject=a.stale_reject, seed=a.seed, screen=a.screen,
            screen_norm_mult=a.screen_norm_mult,
            screen_cos_min=a.screen_cos_min, screen_warmup=a.screen_warmup,
            screen_clip_norm=a.screen_clip_norm,
            quarantine_strikes=a.quarantine_strikes)
        got = serving_config_from_args(t_args)
        assert got.cohort == 16 and got.flush_every == 8
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv, item", [
    (["gateway", "--platform", "cpu", "--heartbeat", "x"], "heartbeat")],
    ids=["gateway --heartbeat"])
def test_cli_gateway_and_autoscale_refuse_a11_flags(argv, item,
                                                    monkeypatch):
    """Checks that gateway's A11 flag (its heartbeat) reaches run_gateway
    with its value. The name is the one it had while the flag was refused;
    the resilience loop lifted that."""
    from fedtpu_torch.cli import main as t_main
    from fedtpu_torch.serving import gateway as t_gateway
    got = {}
    monkeypatch.setattr(t_gateway, "run_gateway",
                        lambda cfg, **kw: got.update(kw) or {})
    assert t_main(argv + ["--quiet"]) == 0
    assert got[item] == "x"


def test_cli_autoscale_simulate_writes_and_gates_on_the_golden(tmp_path,
                                                               capsys):
    """``autoscale --simulate --out --golden --json`` on the committed
    golden: exit 0, ``ok`` true, the file written is the golden; a
    tampered golden fails the command with exit 1."""
    from fedtpu_torch.cli import main as t_main
    golden = os.path.join(REPO, "tests", "goldens", "autoscale_sim.jsonl")
    out = str(tmp_path / "d.jsonl")
    assert t_main(["autoscale", "--simulate", "--golden", golden, "--out",
                   out, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["control_ticks"] == 60
    with open(out) as fa, open(golden) as fb:
        assert fa.read() == fb.read()
    lines = open(golden).read().splitlines()
    lines[7] = lines[7].replace('"hold"', '"grow"', 1)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join(lines) + "\n")
    assert t_main(["autoscale", "--simulate", "--golden", str(bad),
                   "--quiet"]) == 1


def test_launch_counts_hold_across_threads():
    """Launch counting from many threads (the gateway fleet's engines):
    no count is lost under a short switch interval, and a thread that
    records a capture counts into its own recorder, never into
    ``LAUNCHES``, while the others count there."""
    import sys
    import threading
    saved = dict(ck.LAUNCHES)
    interval = sys.getswitchinterval()
    recorded = {}

    def launch(n):
        for _ in range(n):
            ck._count("weighted_average_clients")

    def capture():
        with ck.recording_launches() as rec:
            launch(500)
            recorded.update(rec)

    try:
        sys.setswitchinterval(1e-6)
        ck.reset_launch_counts()
        threads = [threading.Thread(target=launch, args=(2000,))
                   for _ in range(16)] + [threading.Thread(target=capture)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert ck.LAUNCHES["weighted_average_clients"] == 16 * 2000
        assert recorded["weighted_average_clients"] == 500
        ck.count_replay(recorded)
        assert ck.LAUNCHES["weighted_average_clients"] == 16 * 2000 + 500
    finally:
        sys.setswitchinterval(interval)
        ck.LAUNCHES.update(saved)


# ------------------------------------------- A9: the cohort engine's host side
# The sampler, the validator, the CLI flags, the seed table and the store's
# standalone file, against fedtpu's where fedtpu has them.

def _samplers(total, k, policy="uniform", seed=0, **kw):
    from fedtpu.cohort.scheduler import CohortSampler as JSampler
    from fedtpu_torch.cohort.scheduler import CohortSampler as TSampler
    return (JSampler(total, k, policy=policy, seed=seed, **kw),
            TSampler(total, k, policy=policy, seed=seed, **kw))


_SAMPLER_CASES = {
    # total, k, policy, seed, extra, chunks of (round0, num_cohorts)
    "uniform-identity": (8, 4, "uniform", 0, {}, [(0, 2), (5, 2), (3, 1)]),
    "uniform-permutation": (100, 8, "uniform", 3, {}, [(0, 2), (7, 3)]),
    "uniform-rejection": (100_000, 16, "uniform", 1, {}, [(2, 2), (9, 1)]),
    "weighted": (100, 8, "weighted", 3,
                 {"weights": np.r_[np.zeros(10), np.arange(1.0, 91.0)]},
                 [(0, 2), (4, 1)]),
    "trace": (100, 8, "trace", 0,
              {"trace_users": np.arange(300)[::-1] % 100},
              [(0, 2), (1, 3), (40, 1)]),
}


@pytest.mark.parametrize("case", sorted(_SAMPLER_CASES))
def test_cohort_sampler_ids_equal_fedtpus(case):
    """The three policies draw fedtpu's ids bit for bit, before and after
    refuse() quarantines some of them."""
    total, k, policy, seed, extra, chunks = _SAMPLER_CASES[case]
    j, t = _samplers(total, k, policy, seed, **extra)
    for round0, n in chunks:
        np.testing.assert_array_equal(t.sample(round0, n),
                                      j.sample(round0, n))
    bad = j.sample(0, 1)[0][:3]
    j.refuse(bad)
    t.refuse(bad)
    for round0, n in chunks:
        n = min(n, (total - len(bad)) // k)
        ids = t.sample(round0, n)
        np.testing.assert_array_equal(ids, j.sample(round0, n))
        assert not set(ids.ravel().tolist()) & set(bad.tolist())


@pytest.mark.parametrize("build,call,match", [
    ((4, 5), None, "cohort_size"),
    ((4, 2, "weighted"), None, "weights"),
    ((4, 2, "weighted", 0, -np.ones(4)), None, "nonnegative"),
    ((4, 2, "trace", 0, None, np.array([0, 7], np.int64)), None,
     "outside the population"),
    ((8, 3), ("sample", 0, 3), "disjoint cohorts"),
    ((10, 5, "trace", 0, None, np.array([5, 5, 3, 3, 9, 1], np.int64)),
     ("sample", 0, 1), "distinct users"),
    ((6, 4), ("refuse", [0, 1, 2]), "population exhausted"),
    ((4, 2, "mystery"), None, "cohort_sampling must be one of")])
def test_cohort_sampler_guards_equal_fedtpus(build, call, match):
    """Each guard raises in both samplers with fedtpu's message."""
    from fedtpu.cohort.scheduler import CohortSampler as JSampler
    from fedtpu_torch.cohort.scheduler import CohortSampler as TSampler
    messages = []
    for cls in (JSampler, TSampler):
        with pytest.raises(ValueError, match=match) as err:
            sampler = cls(*build)
            getattr(sampler, call[0])(*call[1:])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _cohort_cfg(**fed_kw):
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(synthetic_rows=512),
        shard=tcfg.ShardConfig(num_clients=8),
        model=tcfg.ModelConfig(hidden_sizes=(8,)),
        fed=tcfg.FedConfig(rounds=3, cohort_size=4, **fed_kw))


@pytest.mark.parametrize("row", range(21))
def test_cohort_config_rejections(row):
    """fedtpu's 21 rejection rows (tests/test_cohort.py::_REJECTIONS)
    against the port's validator, with fedtpu's words. A knob the port's
    RunConfig does not run yet (model_parallel) is refused there first,
    naming its ROADMAP item; the validator's own refusal stays reachable
    for a config built around it. on_divergence and fault_plan construct
    (the resilience loop is ported) and reach the validator."""
    from test_cohort import _REJECTIONS as rows
    from fedtpu_torch.cohort.scheduler import _validate_cohort_config
    assert len(rows) == 21
    fed_kw, run_kw, match = rows[row]
    cfg = _cohort_cfg()
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, **fed_kw))
    if set(run_kw) & {"model_parallel"}:
        with pytest.raises(NotImplementedError, match=r"ROADMAP A10"):
            dataclasses.replace(cfg.run, **run_kw)
        run = tcfg.RunConfig()
        for key, value in run_kw.items():
            object.__setattr__(run, key, value)
        cfg = cfg.replace(run=run)
    else:
        cfg = cfg.replace(run=dataclasses.replace(cfg.run, **run_kw))
    with pytest.raises(ValueError, match=match):
        _validate_cohort_config(cfg)


def test_cohort_config_valid_baseline_passes():
    """The base config every rejection row perturbs passes the port's
    validator, as fedtpu's."""
    from fedtpu_torch.cohort.scheduler import _validate_cohort_config
    _validate_cohort_config(_cohort_cfg())


_COHORT_FLAGS = {
    "--client-store": ("client_store", "mmap"),
    "--client-store-path": ("client_store_path", "store.bin"),
    "--cohort-sampling": ("cohort_sampling", "weighted"),
    "--cohort-seed": ("cohort_seed", 7),
    "--cohort-trace": ("cohort_trace", "trace.jsonl"),
}


@pytest.mark.parametrize("flag", ["--cohort-size", *sorted(_COHORT_FLAGS)])
def test_cli_cohort_flags_set_fedtpus_fields(flag):
    """``run --cohort-size`` and each cohort flag give the port's
    FedConfig the values they give fedtpu's; without --cohort-size each
    other flag is refused with fedtpu's words."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser as t_parser, config_from_args
    field, value = _COHORT_FLAGS.get(flag, ("cohort_size", 16))
    tail = [] if flag == "--cohort-size" else [flag, str(value)]
    argv = ["run", "--cohort-size", "16", *tail]
    j = _apply_overrides(jcfg.ExperimentConfig(), j_parser().parse_args(argv))
    t = config_from_args(t_parser().parse_args(argv))
    assert getattr(t.fed, field) == getattr(j.fed, field) == value
    assert t.fed.cohort_size == j.fed.cohort_size == 16
    if tail:
        said = []
        for parse, build in ((j_parser, lambda a: _apply_overrides(
                jcfg.ExperimentConfig(), a)), (t_parser, config_from_args)):
            with pytest.raises(SystemExit) as err:
                build(parse().parse_args(["run", *tail]))
            said.append(str(err.value))
        assert said[0] == said[1] and "require --cohort-size" in said[0]


def test_client_init_seeds_are_prefix_stable():
    """Client c's seed does not depend on the population; same_init gives
    every client client 0's seed."""
    from fedtpu_torch.parallel.round import client_init_seeds
    big = client_init_seeds(5, 100_000)
    assert big.dtype == np.uint64 and len(set(big[:1000].tolist())) == 1000
    np.testing.assert_array_equal(client_init_seeds(5, 8), big[:8])
    np.testing.assert_array_equal(client_init_seeds(5, 8, same_init=True),
                                  np.full(8, big[0]))
    assert not np.array_equal(client_init_seeds(6, 8), big[:8])


def test_store_save_restore_round_trips_and_refuses_a_corrupt_file(tmp_path):
    """The store's standalone file holds its touched records bit for bit;
    a flipped record byte fails the digest on restore."""
    from fedtpu_torch.cohort.store import ClientStateStore
    template = [((3, 2), np.dtype(np.float32)), ((), np.dtype(np.int32))]
    rng = np.random.default_rng(0)
    ids = np.array([9, 2, 5], np.int64)
    store = ClientStateStore(template, 12)
    store.write(ids, [rng.standard_normal((3, 3, 2)).astype(np.float32),
                      np.array([4, 5, 6], np.int32)],
                keys=rng.integers(0, 2**32, (3, 2), dtype=np.uint32))
    path = store.save(str(tmp_path / "ck"))
    again = ClientStateStore(template, 12)
    again.restore(str(tmp_path / "ck"))
    for a, b in zip(again.read(ids), store.read(ids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again.read_keys(ids), store.read_keys(ids))
    assert again.checkpoint_arrays()["store_digest"].tolist() == \
        store.checkpoint_arrays()["store_digest"].tolist()
    saved = torch.load(path, weights_only=True)
    saved["store_records"][1, -1] ^= 1
    torch.save(saved, path)
    with pytest.raises(ValueError, match="digest mismatch"):
        ClientStateStore(template, 12).restore(str(tmp_path / "ck"))


# ------------------------------------------ A11a: telemetry against fedtpu
# The port's tracer, report, timeline, config digest and manifest profile
# against fedtpu's telemetry run in this process. fedtpu's Tracer writes
# schema v2 (process_index, pid, launch_id, role), which the port follows;
# tests/test_telemetry.py::test_event_schema_roundtrip still pins v1's
# field set and is no oracle here.

# Fields of an event line that depend on the clock or the process.
_CLOCK_FIELDS = ("t_start", "dur_s", "pid")


def _tracer_script(tracer):
    """The same calls on either package's Tracer (numpy scalars and a
    histogram snapshot in the payloads)."""
    tracer.event("manifest", program="run", config_hash="0123456789abcdef")
    with tracer.span("build"):
        pass
    sp = tracer.span("chunk", round=4, rounds=4)
    sp.end(extra=np.float32(0.5))
    tracer.event("round", round=1, dur_s=0.25, accuracy=np.float64(0.75),
                 loss_mean=0.5, ids=np.arange(3))
    try:
        with tracer.span("eval", round=4):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    tracer.counters({"counters": {"rounds": 4.0}, "gauges": {},
                     "histograms": {}})
    tracer.event("run_end", round=4, stopped_early=False)


def _without_clock(line: str) -> dict:
    rec = json.loads(line)
    return {k: v for k, v in rec.items() if k not in _CLOCK_FIELDS}


@pytest.mark.parametrize("role,index", [("run", 0), ("gateway-1", 1)])
def test_tracer_lines_are_fedtpus(tmp_path, role, index):
    """The port's Tracer and fedtpu's, driven with the same calls, run_id,
    role and process index, write the same lines field by field (the
    clocks and the pid aside)."""
    from fedtpu.telemetry.trace import Tracer as JTracer
    from fedtpu_torch.telemetry.trace import Tracer as TTracer
    paths = [tmp_path / "j.jsonl", tmp_path / "t.jsonl"]
    for cls, path in zip((JTracer, TTracer), paths):
        tr = cls(str(path), run_id="r0", role=role, process_index=index)
        _tracer_script(tr)
        tr.close()
    j_lines, t_lines = (p.read_text().splitlines() for p in paths)
    assert len(t_lines) == len(j_lines) == 7
    for a, b in zip(t_lines, j_lines):
        assert _without_clock(a) == _without_clock(b)
        assert set(json.loads(a)) == set(json.loads(b))
    assert _without_clock(t_lines[0])["role"] == role


def test_flight_recorder_and_crash_flush_are_fedtpus(tmp_path):
    """The ring's bound, the crash artifact's path and its lines (the
    flush marker last) are fedtpu's."""
    from fedtpu.telemetry import trace as jt
    from fedtpu_torch.telemetry import trace as tt
    assert tt.FLIGHT_RECORDER_CAPACITY == jt.FLIGHT_RECORDER_CAPACITY == 256
    got = []
    for mod, sub in ((jt, "j"), (tt, "t")):
        d = tmp_path / sub
        d.mkdir()
        tr = mod.Tracer(str(d / "events.jsonl"), run_id="r", role="serve")
        for i in range(300):
            tr.event("tick", round=i)
        assert len(tr.flight) == 256
        path = tr.flush_crash(reason="handler:'x':KeyError")
        assert path == mod.crash_artifact_path(str(d / "events.jsonl"),
                                               "serve")
        assert os.path.basename(path) == "events.crash.serve.jsonl"
        got.append([_without_clock(x)
                    for x in open(path).read().splitlines()])
        tr.close()
    assert got[0] == got[1]
    assert got[1][0]["round"] == 45 and got[1][-1]["kind"] == "crash_flush"
    assert tt.NullTracer().flush_crash("x") is None


def test_null_tracer_and_make_tracer(tmp_path):
    """make_tracer: a Tracer with a path, else the NullTracer, whose every
    call is a no-op, as fedtpu's."""
    from fedtpu_torch.telemetry.trace import NullTracer, Tracer, make_tracer
    null = make_tracer(None)
    assert isinstance(null, NullTracer) and not null.enabled
    with null.span("x") as sp:
        assert sp.end() == 0.0 and sp.end_after_fetch(torch.ones(2)) == 0.0
    null.event("round", round=1)
    null.counters({})
    null.close()
    tr = make_tracer(str(tmp_path / "e.jsonl"), role="serve")
    assert isinstance(tr, Tracer) and tr.enabled and tr.role == "serve"
    tr.close()
    tr.event("late")                       # after close: dropped, no raise
    assert (tmp_path / "e.jsonl").read_text() == ""


def test_payloads_take_numpy_and_tensors_and_refuse_a_card_tensor(tmp_path):
    """_json_default takes numpy scalars and arrays and 0-d or CPU tensors
    (fedtpu's takes the numpy ones); a CUDA tensor is refused, never read
    (a read would synchronise the device under the tracer)."""
    from fedtpu_torch.telemetry.trace import Tracer, _json_default
    assert _json_default(np.float32(0.5)) == 0.5
    assert _json_default(torch.tensor(3)) == 3
    assert _json_default(torch.arange(3)) == [0, 1, 2]
    assert _json_default(np.arange(2)) == [0, 1]

    class OnCard:
        is_cuda = True
    with pytest.raises(TypeError, match="CUDA tensor"):
        _json_default(OnCard())
    tr = Tracer(str(tmp_path / "e.jsonl"))
    tr.event("x", a=torch.tensor(1.5), b=np.int64(2))
    tr.close()
    assert json.loads((tmp_path / "e.jsonl").read_text())["payload"] == {
        "a": 1.5, "b": 2}


def test_span_end_after_fetch_reads_the_tree_then_closes(tmp_path):
    from fedtpu_torch.telemetry.trace import Tracer
    tr = Tracer(str(tmp_path / "e.jsonl"))
    sp = tr.span("eval", round=3, n=1)
    dur = sp.end_after_fetch({"a": torch.ones(2), "b": [torch.zeros(1)]},
                             done=True)
    assert dur >= 0 and sp.end() >= dur      # idempotent: one line
    tr.close()
    (line,) = (tmp_path / "e.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert (rec["kind"], rec["phase"], rec["round"]) == ("span", "eval", 3)
    assert rec["payload"] == {"n": 1, "done": True}


def test_record_tick_telemetry_is_fedtpus(tmp_path):
    """The async tick's registry entries and event equal fedtpu's."""
    from fedtpu.parallel.async_fed import record_tick_telemetry as j_rec
    from fedtpu.telemetry.metrics import MetricsRegistry as JReg
    from fedtpu.telemetry.trace import Tracer as JTracer
    from fedtpu_torch.parallel.async_fed import record_tick_telemetry
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    from fedtpu_torch.telemetry.trace import Tracer
    out = []
    for rec, reg_cls, tr_cls, sub in ((j_rec, JReg, JTracer, "j"),
                                      (record_tick_telemetry,
                                       MetricsRegistry, Tracer, "t")):
        reg, path = reg_cls(), str(tmp_path / f"{sub}.jsonl")
        tr = tr_cls(path, run_id="r")
        for tick, s in enumerate(([0, 1, 3], [2, 0, 0], [])):
            rec(reg, tr, tick + 1, np.asarray(s, np.int32))
        tr.close()
        out.append((reg.snapshot(),
                    [_without_clock(x) for x in open(path)]))
    assert out[0] == out[1]


def _synthetic_sink(path):
    """A sink of most event kinds the report aggregates, written by
    fedtpu's Tracer (a malformed line and an unknown kind included)."""
    from fedtpu.telemetry.metrics import MetricsRegistry as JReg
    from fedtpu.telemetry.trace import Tracer as JTracer
    tr = JTracer(path, run_id="synthetic", role="run")
    tr.event("manifest", program="run", config_hash="abc", backend="cpu",
             profile={"flops_per_round": 1e6, "bytes_per_round": 2e5,
                      "profile_rounds": 0, "peak_flops": 1e9})
    tr.event("span", phase="build", dur_s=0.5)
    reg = JReg()
    for r in range(1, 9):
        if r % 4 == 1:
            tr.event("span", phase="chunk", round=r + 3, dur_s=0.04,
                     rounds=4)
        tr.event("round", round=r, dur_s=0.01 * r, accuracy=0.5 + r / 100,
                 loss_mean=1.0 / r, staleness_mean=r % 3,
                 staleness_max=r % 4)
        tr.event("async_tick", round=r, staleness_mean=r % 3,
                 staleness_max=r % 4)
        reg.histogram("staleness").observe_many([r % 3, r % 4])
        reg.counter("rounds").inc()
    tr.event("span", phase="eval", round=8, dur_s=0.02)
    tr.event("span", phase="checkpoint", round=8, dur_s=0.03)
    tr.event("early_stop", round=8)
    tr.event("log", level="warning", msg="a warning")
    tr.event("cohort_config", cohort_size=4, total_clients=16,
             store="memory", sampling="uniform", cohorts_per_step=2,
             store_apparent_bytes=1000)
    tr.event("cohort_summary", rounds=8, cohort_size=4, total_clients=16,
             touched_records=12, store_resident_bytes=600,
             store_apparent_bytes=1000, prefetch_stalls=1)
    tr.event("net_fault", fault="net_dup_frame", gateway=0, frame=3)
    tr.event("autoscale_decision", round=1,
             decisions=[{"kind": "hold", "n": 0, "reason": "steady"}])
    tr.event("brand_new_kind", x=1)
    reg.gauge("device_bytes_in_use").set(1234)
    tr.counters(reg.snapshot())
    tr.event("run_end", round=8, stopped_early=True, diverged=False)
    tr.close()
    with open(path, "a") as fh:
        fh.write('{"v": 2, "kind": "round", "trunc')


@functools.lru_cache(maxsize=None)
def _report_sinks() -> dict:
    """Sink name -> path(s): synthetic, a port run's, a fedtpu run's (the
    same small income-2 config), and the timeline sim's two gateway sinks
    (a fleet)."""
    import tempfile
    from fedtpu.orchestration.loop import run_experiment as j_run
    from fedtpu_torch.orchestration.loop import run_experiment as t_run
    from fedtpu_torch.telemetry.timeline_sim import simulate
    d = tempfile.mkdtemp(prefix="t_report_")
    _synthetic_sink(os.path.join(d, "synthetic.jsonl"))
    for mod, run, name in ((jcfg, j_run, "fedtpu_run"),
                           (tcfg, t_run, "port_run")):
        cfg = mod.ExperimentConfig(
            data=mod.DataConfig(csv_path=None, synthetic_rows=256),
            shard=mod.ShardConfig(num_clients=2),
            model=mod.ModelConfig(hidden_sizes=(8,)),
            fed=mod.FedConfig(rounds=6),
            run=mod.RunConfig(rounds_per_step=2, eval_test_every=3,
                              telemetry=mod.TelemetryConfig(
                                  events_path=os.path.join(
                                      d, f"{name}.jsonl"))))
        kw = {"device": "cpu"} if mod is tcfg else {}
        run(cfg, verbose=False, **kw)
    return {"synthetic": os.path.join(d, "synthetic.jsonl"),
            "port_run": os.path.join(d, "port_run.jsonl"),
            "fedtpu_run": os.path.join(d, "fedtpu_run.jsonl"),
            "fleet": _fleet_sinks(d)}


def _fleet_sinks(d) -> list:
    """Two gateways' sinks (roles gateway-0 and gateway-1): each port
    engine takes its shard of a small trace, drains and emits its summary
    and counters, as a gateway's shutdown does."""
    from fedtpu_torch.serving.engine import ServingEngine
    from fedtpu_torch.serving.traces import synthesize_trace
    from fedtpu_torch.telemetry.metrics import MetricsRegistry
    from fedtpu_torch.telemetry.trace import Tracer
    _, t, user, lat = synthesize_trace(200, 400, 4.0, seed=2)
    paths = []
    for g in range(2):
        path = os.path.join(d, f"fleet.jsonl.g{g}")
        tr = Tracer(path, role=f"gateway-{g}", process_index=g)
        eng = ServingEngine(tcfg.ServingConfig(
            cohort=4, buffer_size=2, data_rows=64, model_hidden=(8,)),
            registry=MetricsRegistry(), tracer=tr, device="cpu")
        tr.event("serve_start", port=0, cohort=4, buffer_size=2,
                 resume=False, gateway=g, num_gateways=2, generation="x")
        eng.offer_many([[int(u), float(a), float(b)]
                        for u, a, b in zip(user, t, lat) if u % 2 == g])
        eng.drain()
        eng.emit_summary()
        tr.close()
        paths.append(path)
    return paths


@pytest.mark.parametrize("fmt", ["text", "json", "prometheus"])
@pytest.mark.parametrize("sink", ["synthetic", "port_run", "fedtpu_run",
                                  "fleet"])
def test_report_renders_fedtpus_bytes(sink, fmt):
    """render_report gives fedtpu's bytes on the same sink(s), in each
    format (Prometheus: the second output)."""
    from fedtpu.telemetry.report import render_report as j_render
    from fedtpu_torch.telemetry.report import render_report as t_render
    path = _report_sinks()[sink]
    as_fmt = "text" if fmt == "prometheus" else fmt
    j_out, t_out = j_render(path, fmt=as_fmt), t_render(path, fmt=as_fmt)
    pick = 1 if fmt == "prometheus" else 0
    assert t_out[pick] == j_out[pick]
    assert len(t_out[pick]) > 300


@pytest.mark.parametrize("name", sorted(tcfg.PRESETS))
def test_config_digest_is_fedtpus(name):
    """Equal configs, equal digests: every preset, and one with telemetry,
    profile and cohort knobs set (no field differs by design)."""
    from fedtpu.telemetry.manifest import config_digest as j_digest
    from fedtpu_torch.telemetry.manifest import config_digest as t_digest
    assert t_digest(tcfg.get_preset(name)) == j_digest(jcfg.get_preset(name))
    kw = dict(profile_dir="p", profile_rounds=3)
    t = tcfg.get_preset(name).replace(run=tcfg.RunConfig(
        telemetry=tcfg.TelemetryConfig(events_path="e.jsonl"), **kw),
        fed=tcfg.FedConfig(cohort_size=4))
    j = jcfg.get_preset(name).replace(run=jcfg.RunConfig(
        telemetry=jcfg.TelemetryConfig(events_path="e.jsonl"), **kw),
        fed=jcfg.FedConfig(cohort_size=4))
    assert t_digest(t) == j_digest(j) != t_digest(tcfg.get_preset(name))


def _grouped_conv_backward(grad_out_shape, x_shape, w_shape, _bias,
                           _stride, _padding, _dilation, transposed,
                           _output_padding, groups, output_mask, out_shape,
                           **kw):
    """torch's convolution_backward flop formula with the weight
    gradient's term divided by ``groups``: torch's counts a grouped
    convolution's weight gradient as if every group saw every input
    channel (``groups`` times the work)."""
    from torch.utils import flop_counter
    conv_flop_count = flop_counter.conv_flop_count
    formula = flop_counter.conv_backward_flop
    flops = getattr(formula, "__wrapped__", formula)(grad_out_shape, x_shape, w_shape, _bias,
                               _stride, _padding, _dilation, transposed,
                               _output_padding, groups, output_mask,
                               out_shape)
    if output_mask[1] and groups > 1:
        def t(shape):
            return [shape[1], shape[0]] + list(shape[2:])
        wgrad = (conv_flop_count(t(grad_out_shape), t(x_shape),
                                 t(w_shape), transposed=False)
                 if transposed else
                 conv_flop_count(t(x_shape), t(grad_out_shape), t(w_shape),
                                 transposed=False))
        flops -= wgrad - wgrad // groups
    return flops


@pytest.mark.parametrize("kind,local_steps", [("mlp", 1), ("mlp", 2),
                                              ("convnet", 1),
                                              ("convnet", 2)])
def test_flops_per_round_is_the_flop_counters_count(kind, local_steps):
    """The manifest's flops_per_round equals FlopCounterMode's count over
    one plain round on the CPU (a small MLP; a small ConvNet, with the
    grouped weight-gradient formula corrected: _grouped_conv_backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    from fedtpu_torch.data.tabular import Dataset
    from fedtpu_torch.orchestration.loop import build_experiment
    from fedtpu_torch.telemetry.manifest import profile_entry
    if kind == "mlp":
        cfg = tcfg.ExperimentConfig(
            data=tcfg.DataConfig(synthetic_rows=400),
            shard=tcfg.ShardConfig(num_clients=3),
            model=tcfg.ModelConfig(hidden_sizes=(16, 8)),
            fed=tcfg.FedConfig(local_steps=local_steps))
        ds = None
    else:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((120, 8 * 8 * 3)).astype(np.float32)
        y = rng.integers(0, 10, 120).astype(np.int32)
        ds = Dataset(x_train=x[:100], y_train=y[:100], x_test=x[100:],
                     y_test=y[100:], num_classes=10,
                     feature_names=tuple(map(str, range(192))),
                     label_classes=np.arange(10))
        cfg = tcfg.ExperimentConfig(
            shard=tcfg.ShardConfig(num_clients=4),
            model=tcfg.ModelConfig(kind="convnet", image_shape=(8, 8, 3),
                                   conv_channels=(4, 8), hidden_sizes=(16,),
                                   num_classes=10),
            fed=tcfg.FedConfig(local_steps=local_steps))
    exp = build_experiment(cfg, dataset=ds, device="cpu")
    entry = profile_entry(exp.model, exp.state, exp.batch,
                          exp.dataset.num_classes, local_steps, 0)
    fix = {torch.ops.aten.convolution_backward: _grouped_conv_backward}
    with FlopCounterMode(display=False, custom_mapping=fix) as fc:
        exp.make_step(1).fn(exp.state, exp.batch, None, None)
    assert entry["flops_per_round"] == fc.get_total_flops() > 0
    assert entry["bytes_per_round_rule"] == ("state read once and written "
                                             "once, batch read once")


def test_bytes_per_round_counts_state_twice_and_batch_once():
    from fedtpu_torch.telemetry.manifest import round_bytes
    state = {"params": torch.zeros(2, 5), "opt_state": {
        "mu": torch.zeros(2, 5), "count": torch.zeros(2, dtype=torch.int32)},
        "round": 3}
    batch = {"x": torch.zeros(2, 4, 3), "mask": torch.zeros(2, 4)}
    assert round_bytes(state, batch) == 2 * (40 + 40 + 8) + (96 + 32)


def test_manifest_names_the_backend_and_keeps_fedtpus_keys():
    """build_manifest: fedtpu's keys, with torch_version in jax_version's
    place (and no compilation_cache: the port keeps no compile cache),
    backend 'cpu' on the CPU, the config hash fedtpu's."""
    from fedtpu.telemetry.manifest import build_manifest as j_build
    from fedtpu_torch.parallel.mesh import make_mesh
    from fedtpu_torch.telemetry.manifest import build_manifest
    t = build_manifest(cfg=tcfg.get_preset("income-8"),
                       mesh=make_mesh(0, 8, "cpu"), device="cpu",
                       extra={"program": "run"})
    j = j_build(cfg=jcfg.get_preset("income-8"), extra={"program": "run"})
    assert t["backend"] == "cpu" and t["device_kinds"] == ["cpu"]
    assert t["device_count"] == 1 and t["mesh_shape"] == {"clients": 1}
    assert t["package"] == "fedtpu_torch" and t["torch_version"]
    assert t["config_hash"] == j["config_hash"]
    assert t["config"] == j["config"]
    assert set(j) - set(t) == {"jax_version", "compilation_cache"}
    assert set(t) - set(j) == {"torch_version", "mesh_shape"}


def test_device_memory_gauges_and_compile_probe():
    """On the CPU there are no device gauges; compile_event counts the
    port's compile events into the default registry (graph captures and
    kernel builds, fedtpu's jax_compile_events in their place)."""
    from fedtpu_torch.telemetry import metrics
    reg = metrics.MetricsRegistry()
    metrics.device_memory_gauges(reg, "cpu")
    assert reg.snapshot()["gauges"] == {}
    default = metrics.default_registry()
    default.reset()
    metrics.compile_event("graph_capture", 0.25)
    metrics.compile_event("kernel_build", 2.0)
    metrics.compile_event("graph_capture", 0.5)
    assert default.snapshot()["counters"] == {
        "graph_captures": 2.0, "graph_capture_secs": 0.75,
        "kernel_builds": 1.0, "kernel_build_secs": 2.0}
    default.reset()


@functools.lru_cache(maxsize=None)
def _timeline_artifacts() -> list:
    """Every kind of artifact the timeline reads, named as a fleet names
    them: an autoscale controller's sink ``events.jsonl``, two gateway
    sinks ``events.jsonl.g<i>`` (the timeline sim's), a netproxy decision
    log ``events.jsonl.g0.netlog`` and an autoscale decision log."""
    import tempfile
    from fedtpu_torch.autoscale.controller import simulate as auto_sim
    from fedtpu_torch.autoscale.controller import write_decisions
    from fedtpu_torch.resilience.net_sim import simulate as net_sim
    from fedtpu_torch.telemetry.timeline_sim import simulate
    from fedtpu_torch.telemetry.trace import Tracer
    d = tempfile.mkdtemp(prefix="t_timeline_")
    base = os.path.join(d, "events.jsonl")
    simulate(events_dir=d, device="cpu")
    for g in range(2):
        os.replace(os.path.join(d, f"events.g{g}.jsonl"), f"{base}.g{g}")
    tr = Tracer(base, run_id="auto", role="autoscale")
    write_decisions(os.path.join(d, "decisions.jsonl"),
                    auto_sim(tracer=tr)["lines"])
    tr.close()
    write_decisions(f"{base}.g0.netlog", net_sim(device="cpu")["lines"])
    return [base, f"{base}.g0", f"{base}.g1", f"{base}.g0.netlog",
            os.path.join(d, "decisions.jsonl")]


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
def test_timeline_renders_fedtpus_bytes(fmt):
    """render_timeline gives fedtpu's bytes on the same files; the
    default_artifacts expansion finds the same siblings."""
    from fedtpu.telemetry.timeline import (default_artifacts as j_expand,
                                           render_timeline as j_render)
    from fedtpu_torch.telemetry.timeline import (default_artifacts,
                                                 render_timeline)
    paths = _timeline_artifacts()
    got = render_timeline(paths, fmt=fmt)
    assert got == j_render(paths, fmt=fmt) and len(got) > 1000
    expanded = default_artifacts(paths[0])
    assert expanded == j_expand(paths[0])
    assert sorted(expanded) == sorted(paths[:4])


def test_port_timeline_sim_matches_the_committed_golden():
    """The port's timeline sim (two port ServingEngines through the port's
    _handle, on the CPU, replaying the pinned arrivals) renders the
    committed golden's lines. Reads the golden."""
    from fedtpu_torch.telemetry.timeline_sim import (compare_decisions,
                                                     simulate)
    sim = simulate(device="cpu")
    res = compare_decisions(sim["lines"], os.path.join(
        REPO, "tests", "goldens", "timeline_sim.jsonl"))
    assert res["ok"], res["reason"]
    assert sim["summary"]["retry_duplicate"]
    assert sim["summary"]["retry_stages"][-2:] == ["client_stamp",
                                                   "dedup_drop"]


def test_timeline_sim_arrivals_file_is_the_synthesized_trace():
    """The pinned arrivals are synthesize_trace's draw from the SIM_*
    constants under this machine's numpy, bit for bit (the golden's)."""
    from fedtpu_torch.serving.traces import synthesize_trace
    from fedtpu_torch.telemetry import timeline_sim as ts
    _, t, user, lat = synthesize_trace(ts.SIM_USERS, ts.SIM_ARRIVALS,
                                       ts.SIM_HORIZON_S, seed=ts.SIM_SEED)
    assert ts.sim_rows() == [[int(user[i]), float(t[i]), float(lat[i])]
                             for i in range(len(t))]


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_cli_report_prints_fedtpus_report_and_writes_prometheus(
        tmp_path, capsys, fmt):
    """``report`` prints fedtpu's report and writes its Prometheus file."""
    from fedtpu.cli import main as j_main
    from fedtpu_torch.cli import main as t_main
    sink = _report_sinks()["port_run"]
    outs = []
    for main, sub in ((j_main, "j"), (t_main, "t")):
        prom = tmp_path / f"{sub}.prom"
        assert main(["report", sink, "--format", fmt,
                     "--prometheus", str(prom)]) == 0
        outs.append((capsys.readouterr().out, prom.read_text()))
    assert outs[0] == outs[1]


def test_cli_timeline_writes_fedtpus_rendering(tmp_path, capsys):
    from fedtpu.cli import main as j_main
    from fedtpu_torch.cli import main as t_main
    paths = _timeline_artifacts()
    for main, sub in ((j_main, "j"), (t_main, "t")):
        assert main(["timeline", paths[0], "--expand", "--format", "chrome",
                     "--output", str(tmp_path / f"{sub}.json")]) == 0
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert t_main(["timeline", *paths[1:3]]) == 0
    assert capsys.readouterr().out.count('"chain"') > 10


@pytest.mark.parametrize("command", ["run", "sweep", "parity"])
def test_cli_telemetry_flags_set_fedtpus_fields(command):
    """--events / --profile-dir / --profile-rounds set the same RunConfig
    fields as fedtpu's parser."""
    from fedtpu.cli import _apply_overrides, build_parser as j_parser
    from fedtpu_torch.cli import build_parser, config_from_args
    argv = [command, "--events", "ev.jsonl", "--profile-dir", "prof",
            "--profile-rounds", "7"]
    t = config_from_args(build_parser().parse_args(argv))
    j_args = j_parser().parse_args(argv)
    j = _apply_overrides(jcfg.get_preset(j_args.preset), j_args)
    assert t.run.telemetry.events_path == j.run.telemetry.events_path \
        == "ev.jsonl"
    assert (t.run.profile_dir, t.run.profile_rounds) == \
        (j.run.profile_dir, j.run.profile_rounds) == ("prof", 7)
