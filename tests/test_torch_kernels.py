"""The plain versions of fedtpu_torch's CUDA kernels against fedtpu's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them). On the CPU each
wrapper takes its plain version. The tests marked ``cuda`` hold K2 itself on
the card and skip without one; chip_smoke.py holds every kernel against its
plain version at the main paths' shapes (this suite needs JAX, which the
card's machine does not have)."""

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
from fedtpu_torch.models.mlp import mlp_init  # noqa: E402
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.ops.metrics import confusion_matrix  # noqa: E402

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


@pytest.mark.parametrize("dims,k,sizes", [
    ((6, 16, 2), 2, [0, 3, 40, 17, 0, 9]),
    (INCOME_DIMS, 2, [1, 0, 197, 33, 64]),
    ((6, 5), 5, [0, 70, 0, 5, 12, 1, 33, 0]),
    (INCOME_DIMS, 2, [120, 0, 0, 7]),
])
def test_fused_eval_confusion_plain_matches_pallas_on_tail_padded_shards(
        dims, k, sizes):
    """Non-IID shards padded at the tail to the longest, as pack_clients
    lays them out: empty clients, ragged tails, and most 32-row tiles of
    the batch all padding (the tiles K2 skips on the card)."""
    c, n = len(sizes), max(sizes)
    rng = np.random.default_rng(sum(sizes))
    params = _jax_params(c, dims, clients=c)
    x = rng.normal(size=(c, n, dims[0])).astype(np.float32)
    y = rng.integers(0, k, size=(c, n)).astype(np.int32)
    mask = (np.arange(n)[None, :] < np.array(sizes)[:, None]).astype(
        np.float32)
    tiles = -(-n // 32)
    live = sum(-(-s // 32) for s in sizes)
    assert live < c * tiles / 2
    ref = np.asarray(pl_eval(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(mask), k, interpret=True))
    out = ck.fused_eval_confusion(convert.params_from_jax(params), dims,
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(mask), k)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy().sum(axis=(1, 2)), sizes)


@pytest.mark.parametrize("dims,rows", [(INCOME_DIMS, 32),
                                       ((14, 50, 400, 2), 32),
                                       ((14, 220, 200, 2), 16),
                                       ((14, 60000, 2), None)])
def test_eval_plan_picks_the_largest_fitting_tile_or_raises(dims, rows):
    """K2's host-side plan: the largest row tile whose parameters, x and
    activation tiles and counts fit in a block's shared memory; a model
    whose parameters alone do not fit raises."""
    num_params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    if rows is None:
        with pytest.raises(ValueError, match="do not fit"):
            ck._eval_plan(num_params, dims)
        return
    got, nbytes = ck._eval_plan(num_params, dims)
    assert got == rows and nbytes <= ck.SMEM_BYTES_MAX
    if rows < ck._ROW_TILES[0]:
        ld = max(d | 1 for d in dims[1:])
        bigger = 2 * rows
        assert nbytes + 4 * (bigger - rows) * (dims[0] + 2 * ld) \
            > ck.SMEM_BYTES_MAX
    if dims == INCOME_DIMS:
        # 4 + 11,356 + 32*14 + 2*32*201 + 2*2 floats.
        assert nbytes == 98_704


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,holes", [([1000] * 8, False),
                                         ([0, 3, 1097, 40, 0, 512], False),
                                         ([1, 33, 64, 65], False),
                                         ([3000, 2000], True)])
def test_eval_kernel_equals_counts_from_k3_logits(cuda, sizes, holes):
    """K2 on tail-padded shards equals, exactly, the counts built from K3's
    logits of each client (the same FMA order), launch after launch. With
    ``holes`` every third 32-row tile is all padding inside the shards: the
    kernel reads the mask, it does not assume padding at the tail."""
    c, n = len(sizes), max(sizes)
    gen = torch.Generator().manual_seed(n)
    params = torch.stack([mlp_init(gen, 14, (50, 200), 2)
                          for _ in range(c)]).to(cuda)
    x = torch.randn(c, n, 14, generator=gen).to(cuda)
    y = torch.randint(0, 2, (c, n), generator=gen, dtype=torch.int32).to(cuda)
    mask = (torch.arange(n)[None, :] < torch.tensor(sizes)[:, None]).to(
        torch.float32)
    if holes:
        mask[:, (torch.arange(n) // 32) % 3 == 1] = 0.0
    mask = mask.to(cuda)
    logits = torch.stack([ck.fused_mlp_forward(params[i], INCOME_DIMS, x[i])
                          for i in range(c)])
    want = confusion_matrix(y, torch.argmax(logits, dim=-1), mask, 2)
    before = ck.LAUNCHES["fused_eval_confusion"]
    for _ in range(5):
        got = ck.fused_eval_confusion(params, INCOME_DIMS, x, y, mask, 2)
        assert torch.equal(got, want)
    assert ck.LAUNCHES["fused_eval_confusion"] == before + 5
    np.testing.assert_array_equal(got.sum(dim=(1, 2)).cpu().numpy(),
                                  mask.sum(dim=1).cpu().numpy())


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

