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


def test_csv_path_waits_for_the_income_csv(tmp_path):
    """The income CSV is not in the repository: every preset runs on the
    synthetic rows (csv_path None), and a CSV path is read, so a path that
    does not exist raises naming it."""
    for name in tcfg.PRESETS:
        assert tcfg.get_preset(name).data.csv_path is None
    missing = str(tmp_path / "balanced_income_data.csv")
    with pytest.raises(FileNotFoundError, match="balanced_income_data"):
        t_load(tcfg.DataConfig(csv_path=missing))


def _write_csv(path, rows=300, seed=3):
    """A CSV of the income data's kinds of column, from a seed: integers, a
    float column written with spaces around its numbers, strings with
    leading spaces (as adult-income's), a string label ``" <=50K"`` /
    ``" >50K"``, a numeric label ``{1, 2}``, and a quoted field holding a
    comma."""
    rng = np.random.default_rng(seed)
    work = np.array([" Private", " Self-emp", " State-gov", "Never"])
    with open(path, "w") as f:
        f.write("age,workclass,hours,city,grade,income\n")
        for _ in range(rows):
            f.write(",".join((
                str(int(rng.integers(17, 90))),
                str(rng.choice(work)),
                f" {rng.normal(40, 12):.6g} ",
                '"Paris, FR"' if rng.random() < 0.3 else "Lyon",
                str(int(rng.integers(1, 3))),
                " >50K" if rng.random() < 0.4 else " <=50K")) + "\n")
    return str(path)


@pytest.mark.parametrize("native_loader", [True, False],
                         ids=["fedtpu-native", "fedtpu-pandas"])
@pytest.mark.parametrize("kw", [
    dict(label_column="income"), dict(label_column="grade"),
    dict(label_column="income", scaler_leakage_parity=False),
    dict(label_column="income", scale_with_mean=False, test_size=0.3)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_csv_loader_bitwise_matches_both_fedtpu_loaders(tmp_path, kw,
                                                        native_loader):
    """The port's one CSV loader against each of fedtpu's (its C++ loader
    and pandas): the same arrays bit for bit, the same feature names and
    label classes (the string label keeps its leading space; the numeric
    label {1, 2} is re-encoded to 0..1)."""
    path = _write_csv(tmp_path / "income.csv")
    a = j_load(jcfg.DataConfig(csv_path=path, native_loader=native_loader,
                               **kw))
    b = t_load(tcfg.DataConfig(csv_path=path, native_loader=native_loader,
                               **kw))
    _assert_datasets_equal(a, b)
    assert b.num_classes == 2
    assert set(b.y_train.tolist()) == {0, 1}
    if kw["label_column"] == "income":
        assert list(b.label_classes) == [" <=50K", " >50K"]
    else:
        assert list(b.label_classes) == [1.0, 2.0]
        assert "income" in b.feature_names


def test_csv_loader_reads_missing_numbers_as_pandas_does(tmp_path):
    """pandas' missing-value tokens in a numeric column read as NaN, as
    fedtpu's pandas loader reads them."""
    path = tmp_path / "na.csv"
    path.write_text("a,b,label\n1,NA,x\n2,,y\n3,2.5,x\n4,nan,y\n"
                    "5,1,x\n")
    a = j_load(jcfg.DataConfig(csv_path=str(path), label_column="label",
                               native_loader=False, test_size=0.4))
    b = t_load(tcfg.DataConfig(csv_path=str(path), label_column="label",
                               test_size=0.4))
    _assert_datasets_equal(a, b)
    assert np.isnan(b.x_train).any()


def test_csv_loader_refuses_what_it_cannot_encode(tmp_path):
    """A missing label column raises fedtpu's KeyError, naming the columns;
    a string column with a missing cell, a ragged row and a dataset_name
    that no loader has raise too."""
    path = _write_csv(tmp_path / "income.csv", rows=20)
    with pytest.raises(KeyError, match="Available columns"):
        t_load(tcfg.DataConfig(csv_path=path, label_column="salary"))
    with pytest.raises(KeyError, match="Available columns"):
        j_load(jcfg.DataConfig(csv_path=path, label_column="salary"))
    holes = tmp_path / "holes.csv"
    holes.write_text("a,b,label\n1,x,0\n2,,1\n3,y,0\n")
    with pytest.raises(ValueError, match="column 'b'"):
        t_load(tcfg.DataConfig(csv_path=str(holes), label_column="label"))
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("a,b,label\n1,2,0\n1,2\n")
    with pytest.raises(ValueError, match="row 3"):
        t_load(tcfg.DataConfig(csv_path=str(ragged), label_column="label"))
    from fedtpu_torch.data import load_dataset
    with pytest.raises(ValueError, match="unknown dataset_name: 'mnist'"):
        load_dataset(tcfg.DataConfig(csv_path=path, dataset_name="mnist"))


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


# --------------------------------------------------------------- CIFAR-10
@pytest.mark.parametrize("rows", [4096, 512, 7])
def test_load_cifar10_synthetic_bitwise_matches_fedtpu(rows, monkeypatch,
                                                       tmp_path):
    """With no cifar-10-batches-py in reach, both loaders make the same
    CIFAR-shaped synthetic set from seed 11, bit for bit: flat NHWC rows,
    the last fifth the test split, 10 classes."""
    from fedtpu.data.cifar10 import load_cifar10 as j_cifar
    from fedtpu_torch.data.cifar10 import load_cifar10 as t_cifar
    monkeypatch.chdir(tmp_path)
    t = t_cifar(synthetic_rows=rows)
    _assert_datasets_equal(j_cifar(synthetic_rows=rows), t)
    assert t.x_train.shape[1] == 32 * 32 * 3 and t.num_classes == 10
    assert len(t.x_test) == max(1, rows // 5)


@pytest.mark.parametrize("shape", [(8, 8, 3), (32, 32, 3)])
def test_synthetic_cifar_like_bitwise_matches_fedtpu(shape):
    from fedtpu.data.cifar10 import synthetic_cifar_like as j_synth
    from fedtpu_torch.data.cifar10 import synthetic_cifar_like as t_synth
    for a, b in zip(j_synth(300, image_shape=shape),
                    t_synth(300, image_shape=shape)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_load_dataset_dispatches_as_fedtpus(monkeypatch, tmp_path):
    """load_dataset: 'cifar10' is the image loader, None the tabular
    pipeline, any other name fedtpu's ValueError; the cifar10-32 preset's
    packed batch is bitwise fedtpu's."""
    from fedtpu.data import load_dataset as j_load_dataset
    from fedtpu_torch.data import load_dataset as t_load_dataset
    monkeypatch.chdir(tmp_path)
    for kw in (dict(dataset_name="cifar10", synthetic_rows=600),
               dict(synthetic_rows=512)):
        _assert_datasets_equal(
            j_load_dataset(jcfg.DataConfig(csv_path=None, **kw)),
            t_load_dataset(tcfg.DataConfig(**kw)))
    msgs = []
    for load, cfg in ((j_load_dataset, jcfg.DataConfig(dataset_name="mnist")),
                      (t_load_dataset, tcfg.DataConfig(dataset_name="mnist"))):
        with pytest.raises(ValueError) as err:
            load(cfg)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    j_cfg = jcfg.get_preset("cifar10-32")
    t_cfg = tcfg.get_preset("cifar10-32")
    ds = t_load_dataset(dataclasses.replace(t_cfg.data, synthetic_rows=1000))
    a, b = (j_pack(ds.x_train, ds.y_train, j_cfg.shard),
            t_pack(ds.x_train, ds.y_train, t_cfg.shard))
    for f in ("x", "y", "mask", "counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert b.x.shape[0] == 32 and b.x.shape[2] == 3072
    assert b.counts.sum() == 800
