"""The plain versions of fedtpu_torch's CUDA kernels against fedtpu's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them), and the fused
whole round's plain version (K5) against fedtpu's own round components; the
host-side launch plans of K1, K2 and K3. On the CPU each wrapper takes its
plain version. The tests marked ``cuda`` hold K1, K2, K3 and K5 themselves
on the card and skip without one; chip_smoke.py holds
every kernel against its plain version at the main paths' shapes (this
suite needs JAX, which the card's machine does not have)."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores,
# and torch's default of a thread per core oversubscribes them (its small
# ops then wait on each other's threads).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fedtpu.config as jcfg  # noqa: E402
from fedtpu.models.mlp import mlp_apply as j_apply, mlp_init as j_init  # noqa: E402
from fedtpu.ops import build_optimizer as j_build_optimizer  # noqa: E402
from fedtpu.ops.pallas_kernels import (fused_eval_confusion as pl_eval,  # noqa: E402
                                       fused_mlp_forward as pl_mlp,
                                       weighted_average_clients as pl_wavg)
from fedtpu.training.client import (make_local_eval_step,  # noqa: E402
                                    make_local_train_step)

import fedtpu_torch.config as tcfg  # noqa: E402
from fedtpu_torch import convert  # noqa: E402
from fedtpu_torch.models.mlp import mlp_apply, mlp_init, unflatten  # noqa: E402
from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.ops.metrics import confusion_matrix, near_tie_rows  # noqa: E402

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


@pytest.mark.parametrize("c,d,zeros", [(8, 11352, 0), (2, 97, 1),
                                       (8, 11352, 8), (3, 1, 3)])
def test_weighted_average_broadcast_plain_matches_fedtpu_formula(c, d, zeros):
    """K1's broadcast mode against fedtpu's Pallas average (interpret mode)
    followed by the round's ``jnp.where(total > 0, broadcast, p)``
    (fedtpu/parallel/round.py:874): the average in every slot, a zero
    weight included; with every weight 0, the input bit for bit."""
    rng = np.random.default_rng(c * d + zeros)
    stacked = rng.normal(size=(c, d)).astype(np.float32)
    w = rng.integers(1, 40, size=c).astype(np.float32)
    w[:zeros] = 0.0
    p = jnp.asarray(stacked)
    avg = pl_wavg(p, jnp.asarray(w), interpret=True)
    ref = np.asarray(jnp.where(jnp.asarray(w).sum() > 0,
                               jnp.broadcast_to(avg, p.shape), p))
    before = ck.LAUNCHES["weighted_average_clients"]
    x = torch.from_numpy(stacked)
    out = ck.weighted_average_clients(x, torch.from_numpy(w), broadcast=True)
    assert ck.LAUNCHES["weighted_average_clients"] == before
    assert out.shape == (c, d) and out.data_ptr() != x.data_ptr()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    if zeros == c:
        assert torch.equal(out, x)
    else:
        assert bool((out == out[0]).all())


@pytest.mark.parametrize("d,plan", [(11352, (96, 119)), (97, (32, 4)),
                                    (1, (32, 1)), (1_000_000, (256, 3907))])
def test_wavg_plan_spreads_the_columns_over_the_sms(d, plan):
    """K1's block: whole warps, as few as spread the columns (one a thread)
    over the 132 SMs, at most 256 threads."""
    threads, blocks = ck._wavg_plan(d, 132)
    assert (threads, blocks) == plan
    assert threads % 32 == 0 and threads * blocks >= d


@pytest.mark.parametrize("dims,n,plan", [
    (INCOME_DIMS, 1, (1, 224, 1)),
    (INCOME_DIMS, 2000, (16, 128, 125)),
    (INCOME_DIMS, 2001, (16, 128, 126)),
    (INCOME_DIMS, 100_000, (64, 256, 1563)),
    ((14, 2), 2000, (16, 32, 125)),
    ((14, 50, 400, 2), 100_000, (32, 256, 3125)),
    ((14, 220, 200, 2), 100_000, (16, 128, 6250)),
    ((14, 60000, 2), 2000, None),
])
def test_forward_plan_fills_the_card_or_raises(dims, n, plan):
    """K3's host-side plan: of the row tiles whose block fits in shared
    memory, the one that gives the busiest of 132 SMs the least work (a
    block's parameter copy counted as 8 rows), the largest of equals; whole
    warps of threads, at most 256, for two passes of the widest layer's
    4 x 4 micro-tiles, or one output a thread below 4 rows.
    At the held-out split's N = 2,000 the grid has at least 125 blocks; a
    wide model falls to a smaller tile; every model that fits is resident;
    a layer too wide for a one-row tile and two one-row weight buffers
    raises, naming its width."""
    num_params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    if plan is None:
        with pytest.raises(ValueError, match=f"a layer {max(dims[1:])} wide"):
            ck._forward_plan(n, num_params, dims, 132)
        return
    rows, threads, nbytes, blocks, cap = ck._forward_plan(n, num_params, dims,
                                                          132)
    assert (rows, threads, blocks, cap) == (*plan, 0)
    assert blocks == -(-n // rows) and nbytes <= ck.SMEM_BYTES_MAX
    ld = max(d | 1 for d in dims[1:])
    # 4-float header + parameters with alignment slack + x and two
    # activation tiles: the layout mlp_forward.cu refuses to go below.
    assert nbytes == 4 * (4 + (num_params + 6) // 4 * 4
                          + rows * (dims[0] + 2 * ld))
    bigger = [r for r in ck._FORWARD_TILES if r > rows]
    if n == 100_000 and bigger:
        r = min(bigger)
        assert 4 * (4 + (num_params + 6) // 4 * 4
                    + r * (dims[0] + 2 * ld)) > ck.SMEM_BYTES_MAX


_INCOME_SHAPES = [INCOME_DIMS, (14, 50, 400, 2), (14, 2), (14, 50, 200, 8)]
_WIDE_SHAPES = [(14, 256, 256, 2), (14, 200, 200, 200, 2),
                (14, 1024, 1024, 2)]


@pytest.mark.parametrize("dims", _INCOME_SHAPES + _WIDE_SHAPES)
def test_plans_stream_only_models_that_do_not_fit(dims):
    """K2's and K3's plans pick the path from the shapes: every income
    shape (and the sklearn-parity (50, 400) one) stays resident with
    today's tiles; (256, 256), (200, 200, 200) and (1024, 1024), whose
    parameters do not fit in a block, stream their weights through two
    buffers that each hold at least one input row of the widest layer,
    the layout (header, two buffers, x tile, two activation tiles, the
    K x K counts) filling the block's shared memory."""
    num_params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    k3 = ck._forward_plan(2000, num_params, dims, 132)
    k2 = ck._eval_plan(num_params, dims)
    if dims in _INCOME_SHAPES:
        assert k3.cap == 0 and k2.cap == 0 and k2.shared_counts
        if dims == INCOME_DIMS:
            assert (k3.rows, k3.threads, k3.blocks) == (16, 128, 125)
            assert (k2.rows, k2.nbytes) == (32, 98_704)
        return
    assert 4 * (4 + (num_params + 6) // 4 * 4) > ck.SMEM_BYTES_MAX
    widest = max(dims[1:])
    for plan, counts in ((k3, 0), (k2, dims[-1] ** 2)):
        assert plan.cap % 4 == 0 and plan.cap - 3 >= widest
        used = 4 * (4 + 2 * plan.cap + ck._tile_floats(dims, plan.rows)
                    + counts)
        assert plan.nbytes == used <= ck.SMEM_BYTES_MAX
        assert ck.SMEM_BYTES_MAX - used < 4 * 8   # the buffers take the rest
    assert k2.shared_counts and k2.rows == (16 if widest > 1000 else 32)
    assert k3.blocks == -(-2000 // k3.rows)


@pytest.mark.parametrize("dims,shared", [((14, 50, 250), False),
                                         ((14, 50, 120), True),
                                         ((14, 256, 256, 240), False)])
def test_eval_plan_keeps_the_counts_in_shared_memory_while_they_fit(
        dims, shared):
    """Past the K x K tile that fits beside the row tile, K2 counts
    straight into global memory (exact: 0/1 masks, counts below 2^24)."""
    num_params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    plan = ck._eval_plan(num_params, dims)
    assert plan.shared_counts == shared
    extra = dims[-1] ** 2 if shared else 0
    if plan.cap == 0:
        assert plan.nbytes == 4 * (ck._resident_floats(num_params)
                                   + ck._tile_floats(dims, plan.rows) + extra)
    else:
        assert plan.nbytes == 4 * (4 + 2 * plan.cap + extra
                                   + ck._tile_floats(dims, plan.rows))


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
    activation tiles and counts fit in a block's shared memory; a layer too
    wide for a one-row tile and two one-row weight buffers raises, naming
    its width (a model whose parameters alone do not fit streams them:
    test_plans_stream_only_models_that_do_not_fit)."""
    num_params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    if rows is None:
        with pytest.raises(ValueError, match=f"a layer {max(dims[1:])} wide"):
            ck._eval_plan(num_params, dims)
        return
    got, nbytes, cap, shared_counts = ck._eval_plan(num_params, dims)
    assert got == rows and nbytes <= ck.SMEM_BYTES_MAX
    assert cap == 0 and shared_counts
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


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,zeros", [(8, 11352, 0), (2, 97, 1),
                                       (32, 11352, 0), (3, 1, 0),
                                       (5, 1001, 0), (8, 11352, 8)])
def test_weighted_average_kernel_matches_its_plain_version(cuda, c, d, zeros):
    """K1 on the card, both modes, against the plain version at 1e-5: odd
    widths, client counts below, at and past the 8-row unroll; with
    every weight 0 the broadcast mode returns its input bit for bit; two
    launches are bitwise equal."""
    gen = torch.Generator().manual_seed(c * d)
    x = torch.randn(c, d, generator=gen).to(cuda)
    w = torch.randint(1, 40, (c,), generator=gen).to(torch.float32)
    w[:zeros] = 0.0
    w = w.to(cuda)
    for broadcast in (False, True):
        before = ck.LAUNCHES["weighted_average_clients"]
        out = ck.weighted_average_clients(x, w, broadcast)
        again = ck.weighted_average_clients(x, w, broadcast)
        assert ck.LAUNCHES["weighted_average_clients"] == before + 2
        ref = ck.weighted_average_clients_reference(x, w, broadcast)
        assert out.shape == ref.shape and torch.equal(out, again)
        assert float((out - ref).abs().max()) <= 1e-5
        if broadcast and zeros == c:
            assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n", [(INCOME_DIMS, 2000), (INCOME_DIMS, 2001),
                                    (INCOME_DIMS, 1), ((14, 2), 2000),
                                    ((14, 50, 400, 2), 5000)])
def test_forward_kernel_matches_its_plain_version(cuda, dims, n):
    """K3 on the card against its plain version at 1e-4, ragged N included;
    two launches bitwise equal."""
    gen = torch.Generator().manual_seed(n)
    flat = mlp_init(gen, dims[0], dims[1:-1], dims[-1]).to(cuda)
    x = torch.randn(n, dims[0], generator=gen).to(cuda)
    before = ck.LAUNCHES["fused_mlp_forward"]
    out = ck.fused_mlp_forward(flat, dims, x)
    again = ck.fused_mlp_forward(flat, dims, x)
    assert ck.LAUNCHES["fused_mlp_forward"] == before + 2
    ref = ck.fused_mlp_forward_reference(flat, dims, x)
    assert out.shape == (n, dims[-1]) and torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dims,sizes", [(INCOME_DIMS, [64] * 8),
                                        ((6, 8, 5, 3), [40, 23, 0]),
                                        ((4, 7, 2), [33, 33])])
def test_fused_round_kernel_matches_its_plain_version(cuda, dims, sizes):
    """K5 on the card against its plain version from mid-run state, at
    chip_smoke.py's tolerances: loss 1e-5; params within 1e-4 on all but
    0.1 % of entries and within 2 * lr everywhere; every entry of mu and nu
    within 1e-5 of its tensor's largest magnitude; counts equal; confusion
    counts equal but on near-tie rows of the plain trained models; a second
    launch bitwise equal to the first."""
    from fedtpu_torch.benchmarks import mega_kernel_attempt as mega
    from fedtpu_torch.ops.optim import build_optimizer
    from fedtpu_torch.training.client import make_local_train_step
    c, n, k = len(sizes), max(sizes), dims[-1]
    gen = torch.Generator().manual_seed(n)
    params = torch.stack([mlp_init(gen, dims[0], dims[1:-1], k)
                          for _ in range(c)])
    mu = torch.randn(params.shape, generator=gen) * 1e-3
    nu = torch.rand(params.shape, generator=gen) * 1e-6
    count = torch.tensor([(0, 29, 61)[i % 3] for i in range(c)],
                         dtype=torch.int32)
    x = torch.randn(c, n, dims[0], generator=gen)
    y = torch.randint(0, k, (c, n), generator=gen, dtype=torch.int32)
    mask = (torch.arange(n)[None, :] < torch.tensor(sizes)[:, None]).to(
        torch.float32)
    args = tuple(t.to(cuda) for t in (params, mu, nu, count, x, y, mask,
                                      mask.sum(dim=1)))
    optim = tcfg.OptimConfig()
    before = ck.LAUNCHES["fused_round"]
    out = ck.fused_round(*args, dims, optim)
    again = ck.fused_round(*args, dims, optim)
    assert ck.LAUNCHES["fused_round"] == before + 2
    ref = ck.fused_round_reference(*args, dims, optim)
    trained, _, _ = make_local_train_step(dims, build_optimizer(optim))(
        args[0], {"mu": args[1], "nu": args[2], "count": args[3]}, *args[4:7])
    ties = near_tie_rows(mlp_apply(unflatten(trained, dims), args[4])) \
        & (args[6] > 0)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    names = ("params", "mu", "nu")
    assert mega.state_faults(mega.state_errors(dict(zip(names, out)),
                                               dict(zip(names, ref))),
                             optim.learning_rate) == []
    assert float((out[4] - ref[4]).abs().max()) <= 1e-5
    assert torch.equal(out[3], ref[3])
    moved = (out[5] - ref[5]).abs().sum(dim=(1, 2)) / 2
    assert bool((moved <= ties.sum(dim=1)).all())


def test_fused_eval_confusion_rejects_wide_class_counts():
    """More than 8 classes were refused here, on the CPU too, though
    fedtpu's default in-round eval (its XLA chain) takes any K. Now the
    wrapper refuses only a last layer that is not K wide, and at K = 9, 10
    and 17 its counts equal fedtpu's eval step's on the same inputs."""
    for k in (9, 10, 17):
        dims = (4, 9, k)
        c, n = 3, 50
        rng = np.random.default_rng(k)
        params = _jax_params(k, dims, clients=c)
        x = rng.normal(size=(c, n, 4)).astype(np.float32)
        y = rng.integers(0, k, size=(c, n)).astype(np.int32)
        mask = (rng.random((c, n)) < 0.8).astype(np.float32)
        ref = np.asarray(jax.vmap(make_local_eval_step(j_apply, k))(
            params, x, y, mask))
        flat = convert.params_from_jax(params)
        out = ck.fused_eval_confusion(flat, dims, torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(mask), k)
        np.testing.assert_array_equal(out.numpy(), ref)
        with pytest.raises(ValueError, match="num_classes"):
            ck.fused_eval_confusion(flat, dims, torch.from_numpy(x),
                                    torch.from_numpy(y),
                                    torch.from_numpy(mask), k + 1)


@pytest.mark.parametrize("layers", [17, 65])
def test_eval_and_forward_take_any_depth_on_the_cpu(layers):
    """A deep MLP (4 wide) was refused before the CPU branch; the plain
    versions now take any depth and match fedtpu's forward and eval step,
    and only the card keeps the kernels' MAX_LAYERS."""
    dims = (4,) * layers + (2,)
    c, n = 2, 40
    rng = np.random.default_rng(layers)
    params = _jax_params(layers, dims, clients=c)
    x = rng.normal(size=(c, n, 4)).astype(np.float32)
    y = rng.integers(0, 2, size=(c, n)).astype(np.int32)
    mask = np.ones((c, n), np.float32)
    flat = convert.params_from_jax(params)
    conf = ck.fused_eval_confusion(flat, dims, torch.from_numpy(x),
                                   torch.from_numpy(y),
                                   torch.from_numpy(mask), 2)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jax.vmap(
        make_local_eval_step(j_apply, 2))(params, x, y, mask)))
    logits = ck.fused_mlp_forward(flat[0], dims, torch.from_numpy(x[0]))
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(j_apply(jax.tree.map(lambda a: a[0], params), x[0])),
        atol=1e-5)
    if layers <= ck.MAX_LAYERS:
        ck._check_depth(dims)
    else:
        with pytest.raises(ValueError, match=f"{layers} layers"):
            ck._check_depth(dims)


@pytest.mark.parametrize("dims,c,n,resident,plan", [
    # income-8: 128 items, one a block; phase B's 90,816 elements take
    # every SM.
    (INCOME_DIMS, 8, 1000, 132, (64, 16, 128, 132)),
    # income-32-noniid's tail-padded batch: 576 items over every SM.
    (INCOME_DIMS, 32, 1104, 132, (64, 18, 576, 132)),
    # chip_smoke's K5 edge shapes.
    (INCOME_DIMS, 2, 1000, 132, (64, 16, 32, 45)),
    (INCOME_DIMS, 3, 333, 132, (64, 6, 18, 67)),
    ((14, 50, 200, 8), 4, 700, 132, (64, 11, 44, 99)),
    ((6, 8, 5, 3), 3, 130, 132, (64, 3, 9, 9)),
    (INCOME_DIMS, 1, 1, 132, (64, 1, 1, 23)),
    # A card that holds fewer blocks: the grid shrinks, blocks loop.
    (INCOME_DIMS, 8, 1000, 60, (64, 16, 128, 60)),
])
def test_fused_round_plan_sizes_chunks_items_and_grid(dims, c, n, resident,
                                                      plan):
    """K5's launch arithmetic: the largest row chunk whose block fits (the
    layout fused_round.cu carves), a work item per (chunk, client), and a
    grid with a block for every item or for every 512 of phase B's (C, D)
    elements, whichever is more, but never more blocks than the card holds
    at once (its grid barriers need every block resident)."""
    d = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    p = ck._fused_round_plan(d, dims, c, n, resident)
    assert (p.rows, p.chunks, p.items, p.blocks) == plan
    assert p.chunks == -(-n // p.rows) and p.items == c * p.chunks
    assert p.blocks == min(resident, max(p.items, -(-c * d // 512)))
    ldmax = max(w | 1 for w in dims[1:])

    def floats(rows):   # feature-major tiles at -(-rows // 16) * 16 + 4
        return (4 + (d + 6) // 4 * 4 + 32 + dims[-1] ** 2
                + sum(dims) * (-(-rows // 16) * 16 + 4)
                + rows * (2 * ldmax + 2))
    assert p.nbytes == 4 * floats(p.rows) <= ck.SMEM_BYTES_MAX
    if p.rows < 64:
        assert 4 * floats(2 * p.rows) > ck.SMEM_BYTES_MAX


def _round_inputs(c=2, n=5, dims=(4, 3, 2)):
    """Valid inputs of the fused round: params, mu, nu, count, x, y, mask,
    weights."""
    d = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    return [torch.zeros((c, d)), torch.zeros((c, d)), torch.zeros((c, d)),
            torch.zeros(c, dtype=torch.int32), torch.zeros((c, n, dims[0])),
            torch.zeros((c, n), dtype=torch.int32), torch.ones((c, n)),
            torch.ones(c)]


def _bad_round_inputs():
    """(what is wrong, inputs, dims, exception, message) of fused_round."""
    dims = (4, 3, 2)
    cases = []
    for i, name in enumerate(("params", "mu", "nu", "count", "x", "y",
                              "mask", "weights")):
        args = _round_inputs()
        good = args[i]
        args[i] = good.to(torch.float64 if good.is_floating_point()
                          else torch.int64)
        cases.append((f"{name} dtype", args, dims, TypeError, name))
        args = _round_inputs()
        args[i] = torch.cat([good, good])
        cases.append((f"{name} shape", args, dims, ValueError, "shape"))
    args = _round_inputs()
    args[4] = torch.zeros((2, 4, 5)).transpose(1, 2)
    cases.append(("x not contiguous", args, dims, ValueError, "contiguous"))
    args = _round_inputs(dims=(4, 9))
    cases.append(("K > 8", args, (4, 9), ValueError, "> 8"))
    cases.append(("dims", _round_inputs(), (4, 5, 2), ValueError, "need"))
    return cases


def test_wrappers_check_shapes_and_types():
    flat = torch.zeros(14 * 2 + 2)
    with pytest.raises(ValueError, match="clients, D"):
        ck.weighted_average_clients(torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError, match="shape"):
        ck.weighted_average_clients(torch.zeros((3, 8)), torch.ones(4),
                                    broadcast=True)
    with pytest.raises(ValueError, match="shape"):
        ck.fused_mlp_forward(flat, (14, 2), torch.zeros((5, 13)))
    with pytest.raises(ValueError, match="need"):
        ck.fused_mlp_forward(flat, (14, 3), torch.zeros((5, 14)))
    with pytest.raises(TypeError, match="int32"):
        ck.fused_eval_confusion(flat[None], (14, 2), torch.zeros((1, 4, 14)),
                                torch.zeros((1, 4), dtype=torch.int64),
                                torch.ones((1, 4)), 2)
    # K5's wrapper: every input's dtype and shape, contiguity, K > 8, dims
    # that do not match the params, an optimizer other than Adam.
    for _, args, dims, exc, msg in _bad_round_inputs():
        with pytest.raises(exc, match=msg):
            ck.fused_round(*args, dims, tcfg.OptimConfig())
    with pytest.raises(ValueError, match="Adam only"):
        ck.fused_round(*_round_inputs(), (4, 3, 2),
                       tcfg.OptimConfig(name="sgd"))
    assert "fused_round" in ck.LAUNCHES
    # The plain version ran on the CPU: no launch counted.
    before = ck.LAUNCHES["fused_round"]
    ck.fused_round(*_round_inputs(), (4, 3, 2), tcfg.OptimConfig())
    assert ck.LAUNCHES["fused_round"] == before


@pytest.mark.parametrize("dims,c,n,sizes", [
    (INCOME_DIMS, 8, 64, None),
    # One client tail-padded, one all padding (denom 1, loss 0, zero grads).
    ((6, 8, 5, 3), 3, 40, [40, 23, 0]),
    ((4, 7, 2), 2, 33, None),
])
def test_fused_round_plain_matches_fedtpu_round_components(dims, c, n, sizes):
    """K5's plain version, one round from fedtpu's init, against fedtpu's
    own round components on the same numpy inputs: the vmapped train step
    (loss before the step, Adam), the vmapped eval of the trained models and
    the data-size-weighted average (as tests/test_torch_round.py composes
    them). Loss 1e-5, counts equal, params 1e-4, moments 1e-6, count + 1."""
    k = dims[-1]
    rng = np.random.default_rng(n)
    jp = _jax_params(n, dims, clients=c)
    x = rng.normal(size=(c, n, dims[0])).astype(np.float32)
    y = rng.integers(0, k, size=(c, n)).astype(np.int32)
    sizes = sizes or [n] * c
    mask = (np.arange(n)[None, :] < np.array(sizes)[:, None]).astype(
        np.float32)
    w = mask.sum(axis=1)
    tx = j_build_optimizer(jcfg.OptimConfig())
    train = jax.jit(jax.vmap(make_local_train_step(j_apply, tx)))
    evaluate = jax.jit(jax.vmap(make_local_eval_step(j_apply, k)))
    trained, js, jloss = train(jp, jax.vmap(tx.init)(jp), x, y, mask)
    jconf = np.asarray(evaluate(trained, x, y, mask))
    avg = jax.tree.map(lambda l: np.broadcast_to(
        np.tensordot(w, np.asarray(l), axes=1) / max(w.sum(), 1.0), l.shape),
        trained)
    adam = js[0]

    d = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    params = convert.params_from_jax(jp)
    zeros = torch.zeros((c, d))
    count = torch.zeros(c, dtype=torch.int32)
    args = (params, zeros, zeros.clone(), count, torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(w))
    before = [a.clone() for a in args]
    p2, mu, nu, count2, loss, conf = ck.fused_round(*args, dims,
                                                    tcfg.OptimConfig())
    for a, b in zip(args, before):
        assert torch.equal(a, b)          # no input is written
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-5)
    np.testing.assert_array_equal(conf.numpy(), jconf)
    np.testing.assert_array_equal(conf.numpy().sum(axis=(1, 2)), sizes)
    np.testing.assert_allclose(p2.numpy(),
                               convert.params_from_jax(avg).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(
        mu.numpy(), convert.params_from_jax(jax.tree.map(
            np.asarray, adam.mu)).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        nu.numpy(), convert.params_from_jax(jax.tree.map(
            np.asarray, adam.nu)).numpy(), atol=1e-6)
    np.testing.assert_array_equal(count2.numpy(), np.asarray(adam.count))
    np.testing.assert_array_equal(count2.numpy(), 1)
    if 0 in sizes:
        empty = sizes.index(0)
        assert float(loss[empty]) == 0.0
        assert not mu[empty].any() and not nu[empty].any()


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

