"""Data: the tabular pipeline, CIFAR-10, client sharding
(``fedtpu.data``)."""


def load_dataset(cfg):
    """The one dispatch on ``DataConfig.dataset_name``, through which run and
    sweep resolve their data: ``'cifar10'`` is ``data.cifar10``'s loader,
    None the tabular pipeline (a CSV, or synthetic income-like rows)."""
    if cfg.dataset_name == "cifar10":
        from fedtpu_torch.data.cifar10 import load_cifar10
        return load_cifar10(synthetic_rows=cfg.synthetic_rows)
    if cfg.dataset_name is not None:
        raise ValueError(f"unknown dataset_name: {cfg.dataset_name!r}")
    from fedtpu_torch.data.tabular import load_tabular_dataset
    return load_tabular_dataset(cfg)
