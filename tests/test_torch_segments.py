"""The port's segment reductions against ``metrics_tpu/ops/segments.py``.

Sorted dense group ids and data made with numpy from a seed (up to a few
thousand rows). Counts, starts and ranks must be equal and int32; integer
sums and maxima equal; float sums, maxima and cumsums of integer-valued
data (the retrieval hits) equal bit for bit; other float cumsums agree
within rtol 1e-6 (two scan trees). A long late group in float32 shows why
the scan is segmented: the global cumsum less each group's offset loses the
late group's values, the segmented scan keeps them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops import segments as jseg
from metrics_tpu_torch.ops import segments as tseg


# the JAX scan compiled once a shape, not op by op: the same function, in far less test time
jax_cumsum = jax.jit(jseg.segment_cumsum, static_argnums=2)


def sorted_ids(n, groups, seed=0):
    rng = np.random.RandomState(seed)
    return np.sort(rng.randint(0, groups, n)).astype(np.int64)


def assert_equal(expected, got):
    e = np.asarray(expected)
    g = got.numpy()
    assert e.shape == g.shape and e.dtype == g.dtype, (e.shape, g.shape, e.dtype, g.dtype)
    np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("n,groups", [(1, 1), (10, 3), (1000, 37), (4000, 1000)])
def test_counts_starts_ranks(n, groups):
    ids = sorted_ids(n, groups, seed=n)
    num = groups + 2  # trailing empty segments
    j, t = jnp.asarray(ids), torch.from_numpy(ids)
    assert_equal(jseg.segment_count(j, num), tseg.segment_count(t, num))
    assert_equal(jseg.segment_starts(j, num), tseg.segment_starts(t, num))
    assert_equal(jseg.segment_ranks(j, num), tseg.segment_ranks(t, num))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sum_and_max(dtype):
    ids = sorted_ids(500, 20, seed=1)
    ids[ids == 7] = 8  # an empty segment in the middle
    data = (np.random.RandomState(2).rand(500) * 100).astype(dtype)
    j, t = jnp.asarray(ids), torch.from_numpy(ids)
    assert_equal(jseg.segment_sum(jnp.asarray(data), j, 22), tseg.segment_sum(torch.from_numpy(data), t, 22))
    assert_equal(jseg.segment_max(jnp.asarray(data), j, 22), tseg.segment_max(torch.from_numpy(data), t, 22))


def test_float_sums_of_hits_are_exact_and_deterministic():
    ids = sorted_ids(3000, 50, seed=3)
    hits = (np.random.RandomState(4).rand(3000) < 0.2).astype(np.float32)
    t = torch.from_numpy(ids)
    counts = tseg.segment_count(t, 50)
    first = tseg.segment_sum(torch.from_numpy(hits), t, 50, counts)
    assert torch.equal(first, tseg.segment_sum(torch.from_numpy(hits), t, 50))
    assert_equal(jseg.segment_sum(jnp.asarray(hits), jnp.asarray(ids), 50), first)


@pytest.mark.parametrize("n,groups", [(1, 1), (2, 2), (17, 3), (1024, 1), (3001, 200)])
def test_cumsum_of_hits_is_exact(n, groups):
    ids = sorted_ids(n, groups, seed=5)
    hits = (np.random.RandomState(6).rand(n) < 0.3).astype(np.float32)
    assert_equal(jax_cumsum(jnp.asarray(hits), jnp.asarray(ids), groups),
                 tseg.segment_cumsum(torch.from_numpy(hits), torch.from_numpy(ids), groups))


def test_cumsum_of_floats():
    ids = sorted_ids(2000, 30, seed=7)
    data = np.random.RandomState(8).randn(2000).astype(np.float32)
    expected = np.asarray(jax_cumsum(jnp.asarray(data), jnp.asarray(ids), 30))
    got = tseg.segment_cumsum(torch.from_numpy(data), torch.from_numpy(ids), 30).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-5)


def test_cumsum_of_no_rows():
    empty = torch.zeros(0)
    assert tseg.segment_cumsum(empty, torch.zeros(0, dtype=torch.int64), 0).shape == (0,)


def test_a_long_late_group_keeps_its_precision():
    """2**16 early rows of 1000.0 in groups of 4, then one late group of 4096 rows of 0.01.

    The global cumsum reaches 6.6e7 before the late group, where a float32
    ulp is 4 or 8: less the group's offset, the late group's cumsum is
    rounded to steps of 4, and its values are off by about 4. The segmented
    scan only adds within the late group, as JAX's does.
    """
    early = np.repeat(np.arange(2**14), 4)
    ids = np.concatenate([early, np.full(4096, 2**14)]).astype(np.int64)
    data = np.concatenate([np.full(early.size, 1000.0), np.full(4096, 0.01)]).astype(np.float32)
    late = slice(early.size, None)
    exact = np.cumsum(np.full(4096, 0.01, dtype=np.float64))

    got = tseg.segment_cumsum(torch.from_numpy(data), torch.from_numpy(ids), 2**14 + 1).numpy()
    expected = np.asarray(jax_cumsum(jnp.asarray(data), jnp.asarray(ids), 2**14 + 1))
    assert np.abs(got[late] - exact).max() < 1e-3
    np.testing.assert_allclose(got, expected, rtol=1e-6)

    glob = torch.cumsum(torch.from_numpy(data), 0)
    subtraction = (glob - glob[early.size - 1])[late].numpy()
    assert np.abs(subtraction - exact).max() > 1.0  # the refused form: off by whole units
