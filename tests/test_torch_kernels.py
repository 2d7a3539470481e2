"""The plain versions of fedtpu_torch's CUDA kernels against fedtpu's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them). On the CPU each
wrapper takes its plain version. The kernels themselves are held against
these plain versions on the card by chip_smoke.py: this suite needs JAX,
which the card's machine does not have."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fedtpu.models.mlp import mlp_init as j_init  # noqa: E402
from fedtpu.ops.pallas_kernels import (fused_eval_confusion as pl_eval,  # noqa: E402
                                       fused_mlp_forward as pl_mlp,
                                       weighted_average_clients as pl_wavg)

from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402

INCOME_DIMS = (14, 50, 200, 2)


def _jax_params(key, dims, clients=None):
    """fedtpu's init: one model, or ``clients`` stacked (vmapped)."""
    keys = jax.random.split(jax.random.key(key), clients or 1)
    batched = jax.jit(jax.vmap(
        lambda k: j_init(k, dims[0], dims[1:-1], dims[-1])))
    params = jax.tree.map(np.asarray, batched(keys))
    return params if clients else jax.tree.map(lambda a: a[0], params)


@pytest.mark.parametrize("c,d,zero", [(8, 96, False), (8, 11352, False),
                                      (2, 97, True)])
def test_weighted_average_plain_matches_pallas(c, d, zero):
    rng = np.random.default_rng(d)
    stacked = rng.normal(size=(c, d)).astype(np.float32)
    w = rng.integers(1, 40, size=c).astype(np.float32)
    if zero:
        w[0] = 0.0
    ref = np.asarray(pl_wavg(jnp.asarray(stacked), jnp.asarray(w),
                             interpret=True))
    before = ck.LAUNCHES["weighted_average_clients"]
    out = ck.weighted_average_clients(torch.from_numpy(stacked),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # The plain version ran: no kernel launch was counted.
    assert ck.LAUNCHES["weighted_average_clients"] == before


@pytest.mark.parametrize("dims,n,k", [((6, 16, 2), 64, 2),
                                      (INCOME_DIMS, 120, 2),
                                      ((6, 5), 40, 5)])
def test_fused_eval_confusion_plain_matches_pallas(dims, n, k):
    c = 4
    rng = np.random.default_rng(n)
    params = _jax_params(3, dims, clients=c)
    x = rng.normal(size=(c, n, dims[0])).astype(np.float32)
    y = rng.integers(0, k, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    mask[-1, n // 2:] = 0.0
    ref = np.asarray(pl_eval(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(mask), k, interpret=True))
    out = ck.fused_eval_confusion(convert.params_from_jax(params), dims,
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(mask), k)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fused_eval_confusion_rejects_wide_class_counts():
    dims = (4, 9)
    flat = torch.zeros((2, 4 * 9 + 9))
    with pytest.raises(ValueError, match="> 8"):
        ck.fused_eval_confusion(flat, dims, torch.zeros((2, 8, 4)),
                                torch.zeros((2, 8), dtype=torch.int32),
                                torch.ones((2, 8)), 9)


def test_wrappers_check_shapes_and_types():
    flat = torch.zeros(14 * 2 + 2)
    with pytest.raises(ValueError, match="shape"):
        ck.fused_mlp_forward(flat, (14, 2), torch.zeros((5, 13)))
    with pytest.raises(ValueError, match="need"):
        ck.fused_mlp_forward(flat, (14, 3), torch.zeros((5, 14)))
    with pytest.raises(TypeError, match="int32"):
        ck.fused_eval_confusion(flat[None], (14, 2), torch.zeros((1, 4, 14)),
                                torch.zeros((1, 4), dtype=torch.int64),
                                torch.ones((1, 4)), 2)


@pytest.mark.parametrize("dims,n", [(INCOME_DIMS, 64), ((6, 8, 3), 1024),
                                    ((6, 8, 3), 100), (INCOME_DIMS, 1)])
def test_fused_mlp_forward_plain_matches_pallas(dims, n):
    rng = np.random.default_rng(n)
    params = _jax_params(n, dims)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    ref = np.asarray(pl_mlp(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), interpret=True))
    out = ck.fused_mlp_forward(convert.params_from_jax(params), dims,
                               torch.from_numpy(x))
    assert out.shape == (n, dims[-1])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)

