"""Tests of the port that need an NVIDIA GPU: the CUDA bincount kernel against
its plain PyTorch version on both of its paths (shared-memory and global), at
the shared-memory threshold, with hot bins and on memory full of junk; the
wrapper's checks and one launch per call; and a small suite on the card
against the same suite on the CPU.

They are marked ``cuda`` and skip where no CUDA device is present. This file
imports no JAX, so on a machine without JAX it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.ops import histogram

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,length", [(1, 3), (1000, 7), (8192, 16384), (100_000, 1000)])
def test_kernel_matches_plain(dev, dtype, n, length):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randint(-5, length + 5, (n,), generator=g, device=dev, dtype=dtype)
    w = torch.rand(n, generator=g, device=dev)
    before = histogram.KERNEL_LAUNCHES
    got = histogram.fused_bincount(x, length)
    got_w = histogram.fused_bincount(x, length, weights=w)
    torch.cuda.synchronize()
    assert histogram.KERNEL_LAUNCHES == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, histogram._bincount_plain(x, length))
    torch.testing.assert_close(got_w, histogram._bincount_plain(x, length, w), rtol=1e-5, atol=1e-4)


def _check_one_call(x, length, w=None, exact_weights=False):
    """One ``fused_bincount`` call is one launch, and it agrees with the plain version."""
    before = histogram.KERNEL_LAUNCHES
    got = histogram.fused_bincount(x, length)
    assert histogram.KERNEL_LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, histogram._bincount_plain(x, length))
    if w is not None:
        got_w = histogram.fused_bincount(x, length, weights=w)
        assert histogram.KERNEL_LAUNCHES == before + 2
        want_w = histogram._bincount_plain(x, length, w)
        if exact_weights:
            assert torch.equal(got_w, want_w)
        else:
            torch.testing.assert_close(got_w, want_w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("length", [histogram.SHARED_MAX_BINS - 1, histogram.SHARED_MAX_BINS, histogram.SHARED_MAX_BINS + 1])
def test_shared_memory_threshold(dev, length):
    g = torch.Generator(device=dev).manual_seed(length)
    x = torch.randint(-5, length + 5, (1 << 20,), generator=g, device=dev)
    _check_one_call(x, length, torch.rand(1 << 20, generator=g, device=dev))


@pytest.mark.parametrize("length", [4, 16384])
def test_hot_bins_with_dyadic_weights_are_exact(dev, length):
    """L=4: the binary confusion matrix; L=16384 with one bin: worst-case contention."""
    g = torch.Generator(device=dev).manual_seed(length)
    n = 1 << 20
    x = torch.randint(0, 4, (n,), generator=g, device=dev) if length == 4 else torch.full((n,), 7, device=dev)
    dyadic = torch.randint(1, 5, (n,), generator=g, device=dev).float() * 0.5  # sums exact in any order
    _check_one_call(x, length, dyadic, exact_weights=True)


@pytest.mark.parametrize("length", [16384, 10**6])
def test_dirty_memory_is_overwritten(dev, length):
    """The counts come from ``torch.empty``: hand the kernel a block full of junk first."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, length, (8192,), generator=g, device=dev)
    for dtype in (torch.int32, torch.float32):
        w = None if dtype == torch.int32 else torch.ones(8192, device=dev)
        junk = torch.full((length,), -12345, dtype=dtype, device=dev)
        ptr = junk.data_ptr()
        del junk
        got = histogram.fused_bincount(x, length, weights=w)
        assert got.data_ptr() == ptr, "the allocator did not hand back the junk block"
        torch.cuda.synchronize()
        want = histogram._bincount_plain(x, length, w)
        assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n", [0, 1])
def test_tiny_inputs_on_both_paths(dev, shared, n):
    x = torch.full((n,), 3, dtype=torch.int64, device=dev)
    w = torch.full((n,), 0.25, device=dev)
    before = histogram.KERNEL_LAUNCHES
    got = histogram._launch(x, 10, None, shared)
    got_w = histogram._launch(x, 10, w, shared)
    assert histogram.KERNEL_LAUNCHES == before + 2
    assert got.tolist() == [0, 0, 0, n, 0, 0, 0, 0, 0, 0]
    assert got_w.tolist() == [0.0, 0.0, 0.0, 0.25 * n, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def test_int64_ids_beyond_int32_are_dropped(dev):
    x = torch.tensor([2**32 + 5, 5, 2**31, -1], dtype=torch.int64, device=dev)
    assert histogram.fused_bincount(x, 8).tolist() == [0, 0, 0, 0, 0, 1, 0, 0]


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    with pytest.raises(TypeError):
        histogram.bincount_cuda(torch.zeros(4, dtype=torch.int16, device=dev), 4)
    with pytest.raises(ValueError):
        histogram.bincount_cuda(torch.zeros(8, dtype=torch.int32, device=dev)[::2], 4)
    with pytest.raises(ValueError):
        histogram.bincount_cuda(torch.zeros(4, dtype=torch.int32, device=dev), 2**31)
    with pytest.raises(TypeError):
        histogram.bincount_cuda(torch.zeros(4, dtype=torch.int32, device=dev), 4, weights=torch.zeros(4, device=dev).half())


def test_metric_defaults_to_the_card(dev):
    assert mt.Accuracy().device.type == "cuda"
    assert mt.ConfusionMatrix(num_classes=3).confmat.device.type == "cuda"


def test_suite_on_the_card_equals_the_cpu(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def suite(device):
        return mt.MetricCollection(
            {
                "acc": mt.Accuracy(num_classes=10, average="macro", device=device),
                "confmat": mt.ConfusionMatrix(num_classes=10, device=device),
                "f1": mt.F1Score(num_classes=10, average="macro", device=device),
            }
        )

    gpu, cpu = suite(dev), suite("cpu")
    before = histogram.KERNEL_LAUNCHES
    for _ in range(3):
        probs = torch.softmax(torch.randn(256, 10, generator=g, device=dev), dim=1)
        target = torch.randint(0, 10, (256,), generator=g, device=dev)
        gpu.update(probs, target)
        cpu.update(probs.cpu(), target.cpu())
    assert histogram.KERNEL_LAUNCHES == before + 3
    got, want = gpu.compute(), cpu.compute()
    assert torch.equal(got["confmat"].cpu(), want["confmat"])
    for key in ("acc", "f1"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-6, rtol=0)
