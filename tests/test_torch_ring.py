"""The port's ring all-reduce (fedtpu_torch.parallel.ring, the plain version
of K4) and clients mesh against fedtpu's on the 8-device CPU mesh.

Every add happens in fedtpu's order, so the tolerance is none: the plain
ring equals both fedtpu's XLA ring (ppermute) and its Pallas ring (interpret
mode, as tests/test_ring.py runs it) bit for bit, and ring-rsag equals
fedtpu's rsag bit for bit, identical on every shard. K4 itself is held
against this plain version on the card by the test marked ``cuda`` (skips
without a card) and by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on the cores,
# and torch's default of a thread per core oversubscribes them (its small
# ops then wait on each other's threads).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from fedtpu.parallel.mesh import trim_to_divisor as j_trim  # noqa: E402
from fedtpu.parallel.ring import (ring_all_reduce_sum as j_ring,  # noqa: E402
                                  ring_all_reduce_sum_rsag as j_rsag)
from fedtpu.parallel.ring_pallas import (  # noqa: E402
    pallas_ring_all_reduce_sum as j_pallas)

from fedtpu_torch.ops import cuda_kernels as ck  # noqa: E402
from fedtpu_torch.parallel.mesh import (CLIENTS_AXIS, make_mesh,  # noqa: E402
                                        trim_to_divisor)
from fedtpu_torch.parallel.ring import (flatten_pad, make_all_reduce,  # noqa: E402
                                        ring_all_reduce_sum,
                                        ring_all_reduce_sum_rsag,
                                        unpad_reshape)

SHAPES = [(4,), (8, 128), (3, 7, 5), (11353,)]


def _fedtpu_reduce(fn, x, pallas=False):
    """``fn`` run per shard over the rows of ``x``, one row to each of the
    first ``len(x)`` devices of the 8-device CPU mesh."""
    n = x.shape[0]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), (CLIENTS_AXIS,))
    kw = dict(check_vma=False) if pallas else {}
    body = jax.shard_map(lambda xb: fn(xb[0], CLIENTS_AXIS, n)[None],
                         mesh=mesh, in_specs=P(CLIENTS_AXIS),
                         out_specs=P(CLIENTS_AXIS), **kw)
    return np.asarray(jax.jit(body)(jnp.asarray(x)))  # fedtpu: noqa[FTP006] one-shot test launch


def _stack(shape, seed=0):
    return np.random.default_rng(seed).normal(size=(8,) + shape) \
        .astype(np.float32)


def _ring_fold(x):
    """The ring's order in numpy float32: acc_d = x_d, then += x_{(d-k) % S}
    for k = 1..S-1."""
    s = x.shape[0]
    want = x.copy()
    for d in range(s):
        for k in range(1, s):
            want[d] += x[(d - k) % s]
    return want


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ring_is_bitwise_fedtpus_xla_and_pallas_rings(shape):
    x = _stack(shape)
    out = ring_all_reduce_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, _fedtpu_reduce(j_ring, x))
    np.testing.assert_array_equal(out, _fedtpu_reduce(j_pallas, x,
                                                      pallas=True))
    # Each shard adds in its own order (fedtpu/parallel/ring.py:30-36).
    np.testing.assert_allclose(out, np.broadcast_to(x.sum(axis=0), out.shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_rsag_is_bitwise_fedtpus_and_identical_on_every_shard(shape):
    x = _stack(shape, seed=1)
    out = ring_all_reduce_sum_rsag(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, _fedtpu_reduce(j_rsag, x))
    for d in range(1, 8):
        np.testing.assert_array_equal(out[d], out[0])


@pytest.mark.parametrize("p", [7, 1001])
@pytest.mark.parametrize("s", [2, 3, 5, 16])
def test_ring_wrapper_folds_each_shard_in_ring_order(s, p):
    """K4's order at shard counts other than fedtpu's 8 and payloads that
    are not a multiple of 4: acc_d = x_d, then += x_{(d-k) % S} for k = 1..
    S-1, in float32. The card's kernel folds in this order too, so it is
    held bitwise to the same plain version."""
    x = np.random.default_rng(100 * s + p).normal(size=(s, p)) \
        .astype(np.float32)
    out = ck.ring_all_reduce_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, _ring_fold(x))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16])
def test_residual_credits_are_fedtpus(n):
    """fedtpu's Pallas ring drains its ``_residual_credits(n)`` capacity
    credits at the end of each launch, so that the launch leaves no state
    behind. The port's K4 is one pass with no credits, flags or scratch, so
    what is held at each n is the result: bitwise fedtpu's XLA and Pallas
    rings run on n of the CPU devices (at 16, more than the mesh has, the
    ring's numpy fold), the same bits from a second call, the input
    untouched."""
    assert not hasattr(ck, "_residual_credits")
    x = np.random.default_rng(n).normal(size=(n, 1001)).astype(np.float32)
    before = x.copy()
    out = ck.ring_all_reduce_sum(torch.from_numpy(x)).numpy()
    if n <= len(jax.devices()):
        np.testing.assert_array_equal(out, _fedtpu_reduce(j_ring, x))
        np.testing.assert_array_equal(out, _fedtpu_reduce(j_pallas, x,
                                                          pallas=True))
    else:
        np.testing.assert_array_equal(out, _ring_fold(x))
    np.testing.assert_array_equal(
        ck.ring_all_reduce_sum(torch.from_numpy(x)).numpy(), out)
    np.testing.assert_array_equal(x, before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,p", [(8, 11353), (2, 11353), (3, 1001),
                                 (16, 11353), (8, 7), (8, 4096)])
def test_ring_kernel_is_bitwise_its_plain_version(cuda, s, p):
    """K4 on the card: one launch, bitwise its plain version, at the sharded
    round's payload (income's 11,352 parameters plus the weight total) and
    at edge shapes."""
    x = torch.randn(s, p, generator=torch.Generator().manual_seed(s * p)) \
        .to(cuda)
    before = ck.LAUNCHES["ring_all_reduce_sum"]
    out = ck.ring_all_reduce_sum(x)
    assert ck.LAUNCHES["ring_all_reduce_sum"] == before + 1
    assert torch.equal(out, ck.ring_all_reduce_sum_reference(x))


@pytest.mark.parametrize("n,clients", [(8, 32), (8, 12), (5, 16), (3, 0),
                                       (1, 7), (16, 48)])
def test_trim_to_divisor_is_fedtpus(n, clients):
    assert trim_to_divisor(n, clients) == j_trim(n, clients)


def test_make_mesh_lays_shards_over_the_visible_devices():
    mesh = make_mesh(8, 32, "cpu")
    assert (mesh.num_shards, mesh.clients_per_shard) == (8, 4)
    assert mesh.devices == (torch.device("cpu"),) * 8   # co-resident
    assert make_mesh(0, 32, "cpu").num_shards == 1      # one per device
    assert make_mesh(8, 12, "cpu").num_shards == 6      # trimmed to divide
    assert make_mesh(8, 0, "cpu").clients_per_shard == 0


@pytest.mark.parametrize("kind", ["psum", "ring", "ring-rsag"])
def test_every_backend_sums_over_the_shards(kind):
    x = torch.from_numpy(_stack((3, 5), seed=2))
    out = make_all_reduce(kind, 8)(x)
    assert out.shape == x.shape
    torch.testing.assert_close(out, x.sum(dim=0).expand_as(x), rtol=1e-5,
                               atol=1e-5)
    # One shard: the ring is the identity, as in fedtpu.
    one = x[:1]
    assert torch.equal(make_all_reduce(kind, 1)(one), one)
    with pytest.raises(ValueError, match="8-shard"):
        make_all_reduce(kind, 8)(x[:4])


def test_flatten_pad_round_trips():
    x = torch.arange(8 * 7 * 3, dtype=torch.float32).reshape(8, 7, 3)
    flat, pad = flatten_pad(x, 8)
    assert flat.shape == (8, 24) and pad == 3
    assert torch.equal(flat[:, 21:], torch.zeros(8, 3))
    assert torch.equal(unpad_reshape(flat, pad, x.shape), x)


def test_ring_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_stack((9,), seed=3))
    before = ck.LAUNCHES["ring_all_reduce_sum"]
    out = ck.ring_all_reduce_sum(x)
    assert torch.equal(out, ck.ring_all_reduce_sum_reference(x))
    assert ck.LAUNCHES["ring_all_reduce_sum"] == before
    with pytest.raises(ValueError, match="shards, payload"):
        ck.ring_all_reduce_sum(x[:, :, None])
    with pytest.raises(TypeError, match="float32"):
        ck.ring_all_reduce_sum(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.ring_all_reduce_sum(x.t())
