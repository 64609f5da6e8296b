"""The port's bincount (``metrics_tpu_torch/ops/histogram.py``) against the JAX package.

On the CPU the port's ``fused_bincount`` is its plain PyTorch version, the
function the CUDA kernel is held to on the card. It is compared with the JAX
``fused_bincount`` on its XLA path, with the Pallas kernel run in interpret
mode (as `tests/ops/test_kernels.py` runs it) and with numpy. Unweighted counts
must be exact and int32; weighted sums agree within rtol=1e-5, atol=1e-4, the
tolerance the Pallas kernel's own tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops import fused_bincount as jax_fused_bincount
from metrics_tpu.ops.histogram import _pallas_weighted_bincount
from metrics_tpu_torch.ops import histogram
from metrics_tpu_torch.ops.histogram import _bincount_plain, bincount_cuda, fused_bincount

RTOL, ATOL = 1e-5, 1e-4
LENGTHS = [7, 129, 1000, 16384]
SIZES = [100, 511, 513, 2000]


def _ids(n, length, seed):
    """Ids in [-3, length + 3): valid ones, the -1 sentinel, other negatives and ids >= length."""
    return np.random.RandomState(seed).randint(-3, length + 3, size=(n,)).astype(np.int32)


def _numpy_bincount(x, length, w=None):
    valid = (x >= 0) & (x < length)
    if w is None:
        return np.bincount(x[valid], minlength=length).astype(np.int32)
    return np.bincount(x[valid], weights=w[valid], minlength=length).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("length", LENGTHS)
def test_unweighted_matches_jax_and_numpy(length, n):
    x = _ids(n, length, seed=length + n)
    got = fused_bincount(torch.from_numpy(x), length)
    expected = np.asarray(jax_fused_bincount(jnp.asarray(x), length, force_xla=True))
    assert got.dtype == torch.int32 and expected.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), _numpy_bincount(x, length))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("length", LENGTHS)
def test_weighted_matches_jax_and_numpy(length, n):
    x = _ids(n, length, seed=length * 3 + n)
    w = np.random.RandomState(n).rand(n).astype(np.float32)
    got = fused_bincount(torch.from_numpy(x), length, weights=torch.from_numpy(w))
    expected = np.asarray(jax_fused_bincount(jnp.asarray(x), length, weights=jnp.asarray(w), force_xla=True))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _numpy_bincount(x, length, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "n,length",
    [(100, 7), (513, 129), (600, 1000), (1024, 16384), (2000, 129)],
)
def test_plain_matches_pallas_kernel_interpret(n, length):
    """The TPU kernel itself, in interpret mode, weighted and unweighted."""
    x = _ids(n, length, seed=n + 7)
    w = np.random.RandomState(n + 1).rand(n).astype(np.float32)
    pallas_w = np.asarray(_pallas_weighted_bincount(jnp.asarray(x), jnp.asarray(w), length, interpret=True))
    got_w = _bincount_plain(torch.from_numpy(x), length, torch.from_numpy(w))
    np.testing.assert_allclose(got_w.numpy(), pallas_w, rtol=RTOL, atol=ATOL)

    ones = jnp.ones((n,), jnp.float32)
    pallas_counts = np.round(np.asarray(_pallas_weighted_bincount(jnp.asarray(x), ones, length, interpret=True)))
    got = _bincount_plain(torch.from_numpy(x), length)
    np.testing.assert_array_equal(got.numpy(), pallas_counts.astype(np.int32))


def test_int64_ids_beyond_int32_are_dropped_not_wrapped():
    """2**32 + 5 is out of range for any length below 2**31: it must not land in bin 5."""
    x = np.array([2**32 + 5, 2**31, 2**31 + 3, 5, -(2**40), 5, 15, 16], dtype=np.int64)
    w = np.arange(1, x.size + 1, dtype=np.float32)
    got = fused_bincount(torch.from_numpy(x), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _numpy_bincount(x, 16))
    assert int(got[5]) == 2 and int(got.sum()) == 3
    got_w = fused_bincount(torch.from_numpy(x), 16, weights=torch.from_numpy(w))
    np.testing.assert_allclose(got_w.numpy(), _numpy_bincount(x, 16, w), rtol=RTOL, atol=ATOL)


def test_sentinel_and_negative_ids_never_reach_bin_zero():
    x = np.array([-1, -1, -2, -(2**31), 0], dtype=np.int32)
    got = fused_bincount(torch.from_numpy(x), 4)
    expected = np.asarray(jax_fused_bincount(jnp.asarray(x), 4, force_xla=True))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), [1, 0, 0, 0])


@pytest.mark.parametrize("weighted", [False, True])
def test_empty_input(weighted):
    x = torch.zeros((0,), dtype=torch.int64)
    w = torch.zeros((0,), dtype=torch.float32) if weighted else None
    got = fused_bincount(x, 9, weights=w)
    assert got.shape == (9,) and got.dtype == (torch.float32 if weighted else torch.int32)
    assert not got.any()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32, torch.int64])
def test_integer_id_dtypes_and_multidim_input(dtype):
    x = np.random.RandomState(3).randint(0, 50, size=(8, 16))
    got = fused_bincount(torch.from_numpy(x).to(dtype), 60)
    np.testing.assert_array_equal(got.numpy(), np.bincount(x.reshape(-1), minlength=60))


def test_float_ids_are_refused():
    with pytest.raises(TypeError):
        fused_bincount(torch.tensor([0.0, 1.0]), 2)


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The wrapper never runs the kernel's plain version: a CPU tensor is refused."""
    before = histogram.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        bincount_cuda(torch.zeros(4, dtype=torch.int32), 4)
    assert histogram.KERNEL_LAUNCHES == before


def test_cpu_path_counts_no_kernel_launch():
    before = histogram.KERNEL_LAUNCHES
    fused_bincount(torch.arange(10), 10)
    assert histogram.KERNEL_LAUNCHES == before


@pytest.mark.parametrize(
    "length,path",
    [
        (1, "shared"),
        (4, "shared"),  # binary confusion matrix
        (512, "shared"),  # multilabel confusion matrix, C=128
        (128**2, "shared"),  # the main path
        (histogram.SHARED_MAX_BINS - 1, "shared"),
        (histogram.SHARED_MAX_BINS, "shared"),
        (histogram.SHARED_MAX_BINS + 1, "global"),
        (2 * histogram.SHARED_MAX_BINS, "global"),
        (182**2, "global"),  # the smallest square confusion matrix past the budget: C=182
        (181**2, "shared"),
        (10**6, "global"),  # C=1000
        (2**31 - 1, "global"),
    ],
)
def test_kernel_path_by_length(length, path):
    assert histogram.kernel_path(length) == path


def test_wrapper_budget_matches_the_kernel_source():
    """The wrapper's threshold is the source's ``kSharedMaxBins`` (the binding checks it again on the card)."""
    import re
    from metrics_tpu_torch.ops import _native

    source = (_native.CSRC_DIR / histogram.SOURCE).read_text()
    built = int(re.search(r"constexpr int64_t kSharedMaxBins = (\d+);", source).group(1))
    assert built == histogram.SHARED_MAX_BINS == 32768
    assert 4 * histogram.SHARED_MAX_BINS <= 227 * 1024  # one block's shared memory on Hopper


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32, torch.bool])
def test_kernel_wrapper_refuses_bad_dtypes_without_a_launch(dtype):
    before = histogram.KERNEL_LAUNCHES
    with pytest.raises(TypeError, match="int32 or int64"):
        bincount_cuda(torch.zeros(4, dtype=dtype), 4)
    assert histogram.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("length", [0, 4, 10**6])
def test_kernel_wrapper_refuses_cpu_tensors_on_both_paths(dtype, length):
    before = histogram.KERNEL_LAUNCHES
    for shared in (False, True) if length <= histogram.SHARED_MAX_BINS else (False,):
        with pytest.raises(ValueError, match="CUDA tensor"):
            histogram._launch(torch.zeros(4, dtype=dtype), length, None, shared)
    assert histogram.KERNEL_LAUNCHES == before


def test_shared_path_refuses_more_bins_than_its_budget():
    before = histogram.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="shared-memory path"):
        histogram._launch(torch.zeros(4, dtype=torch.int64), histogram.SHARED_MAX_BINS + 1, None, True)
    with pytest.raises(ValueError, match="length"):
        bincount_cuda(torch.zeros(4, dtype=torch.int64), 2**31)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        bincount_cuda(torch.zeros(8, dtype=torch.int64)[::2], 4)
    assert histogram.KERNEL_LAUNCHES == before
