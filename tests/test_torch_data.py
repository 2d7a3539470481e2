"""fedtpu_torch's data pipeline against fedtpu's: bitwise-equal arrays from
the same config (the port computes the sklearn split with numpy)."""

import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

import fedtpu.config as jcfg  # noqa: E402
from fedtpu.data.sharding import pack_clients as j_pack  # noqa: E402
from fedtpu.data.tabular import load_tabular_dataset as j_load  # noqa: E402

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch.data.sharding import pack_clients as t_pack  # noqa: E402
from fedtpu_torch.data.tabular import load_tabular_dataset as t_load  # noqa: E402

DATA_CASES = [
    dict(synthetic_rows=512),
    dict(synthetic_rows=1001),
    dict(synthetic_rows=1001, scale_with_mean=False),
    dict(synthetic_rows=777, scaler_leakage_parity=False),
    dict(synthetic_rows=600, synthetic_classes=3, test_size=0.25),
]


def _assert_datasets_equal(a, b):
    for f in ("x_train", "y_train", "x_test", "y_test", "label_classes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.num_classes == b.num_classes
    assert a.feature_names == b.feature_names


@pytest.mark.parametrize("kw", DATA_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_load_tabular_dataset_bitwise_matches_fedtpu(kw):
    _assert_datasets_equal(j_load(jcfg.DataConfig(csv_path=None, **kw)),
                           t_load(tcfg.DataConfig(csv_path=None, **kw)))


SHARD_CASES = [
    dict(num_clients=8),
    dict(num_clients=8, shuffle=False),
    dict(num_clients=5, shard_seed=3),
    dict(num_clients=4, strategy="label_sort"),
    dict(num_clients=8, strategy="dirichlet", dirichlet_alpha=0.5),
    dict(num_clients=6, strategy="dirichlet", dirichlet_alpha=0.1,
         shard_seed=11),
]


@pytest.mark.parametrize("kw", SHARD_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_pack_clients_bitwise_matches_fedtpu(kw):
    ds = t_load(tcfg.DataConfig(synthetic_rows=1001))
    a = j_pack(ds.x_train, ds.y_train, jcfg.ShardConfig(**kw))
    b = t_pack(ds.x_train, ds.y_train, tcfg.ShardConfig(**kw))
    for f in ("x", "y", "mask", "counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def test_csv_path_waits_for_the_income_csv():
    with pytest.raises(NotImplementedError, match="CSV"):
        t_load(tcfg.DataConfig(csv_path="balanced_income_data.csv"))


def test_preset_fields_match_fedtpu():
    """The port's presets are fedtpu's, apart from the data source."""
    for name in ("income-2", "income-4", "income-8"):
        j, t = jcfg.get_preset(name), tcfg.get_preset(name)
        for part in ("shard", "model", "optim", "fed", "run", "data"):
            tv = dataclasses.asdict(getattr(t, part))
            jv = dataclasses.asdict(getattr(j, part))
            shared = {k: v for k, v in tv.items()
                      if k != "csv_path" and k in jv}
            assert shared == {k: jv[k] for k in shared}, (name, part)
            assert set(tv) <= set(jv), (name, part, set(tv) - set(jv))
