"""Tests of the port that need an NVIDIA GPU: the CUDA bincount kernel against
its plain PyTorch version on both of its paths (shared-memory and global), at
the shared-memory threshold, with hot bins and on memory full of junk; the
wrapper's checks and one launch per call; a small suite on the card
against the same suite on the CPU; each metric of the confusion-matrix and
stat-score families and each aggregator on the card against the CPU; the
segmentation suite's states from the class ids equal to the one-hot's at
Cityscapes shape, one bincount launch a member's update; and
Cohen's kappa at C=1000 with counts above 2048 under TF32 matmul settings;
each curve metric (the exact curves, AUROC, AveragePrecision,
CalibrationError, the binned family) on the card against the CPU, the
sort-based areas against the eager curves, CalibrationError's one bincount
launch an update, and the binned counts exact under TF32 settings; and state
sync through NCCL in a world of one process: the headline suite
bit-exact in one payload collective, and the packed layout's alignment;
the partial AUROC of a batch with no negative sample (NaN); the segment
reductions against the CPU, deterministic, their counts one bincount
launch on both kernel paths; the retrieval grouping and a retrieval suite
against the CPU, the suite's second ``compute()`` the same bits; the
ranking metrics on tied scores; and regression and pairwise functions;
SSIM, MS-SSIM and UQI on the card against the CPU with cuDNN's TF32 switched
on globally (the depthwise convolution must still run in float32, and the
switch comes back on after the call); a BootStrapper drawing on the card's
generator against a CPU twin fed the same draws; and a BootStrapper tree
synced through NCCL in one payload collective; InceptionV3's taps and the
three LPIPS networks on the card against the CPU with the same seeded
weights, with TF32 left on by the caller; FID, KID and IS from the same
features; and MeanAveragePrecision (boxes, and masks with cells on the device
route) equal to the CPU bit for bit; Perplexity (float32 and bfloat16 logits),
BERTScore's matcher under TF32 settings, SDR (the solve and conjugate
gradient) and PIT on the card against the CPU; and the text metrics' states
(float32 counts, packed uint8 sentences) on the card equal to the CPU's; a
journal round trip on the card, into a CPU twin and back; a restored
BootStrapper continuing its draws on the card; the ``sync-pack`` fault drill
in a NCCL world of one; Spearman's ranks with NaN on the card against the
CPU; the asynchronous sync with updates in flight equal to a blocking sync;
the bf16 and int8 wire bytes on the card equal to the CPU's;
``compute_on_cpu`` rows on the host after an update and on the card at the
sync; and the dispatch engine on the card (validation mode "first"): deferred
updates and forwards and ``update_many`` bit-equal to the per-call path with
one bincount launch an update, no state leaving the card, a lazy value in
torch expressions with card tensors, a host lane that declines a CPU tensor
for a card metric, and the device probe counting; the functional core on the
card: the batched bincount kernel against its plain version (its three
regimes at their edges and under every split, shared and per-row ids,
weighted, more rows than the grid's row axis), a refused launch raising,
one batched launch a vmapped call, ``apply_update`` equal to the stateful
path, captured in a CUDA graph and under ``torch.func.vmap``, the value checks
skipped while a graph is being captured, and the fused BootStrapper,
MultioutputWrapper and MinMaxMetric equal to their eager paths; the tenant
planes: a ConfusionMatrix arena's update one batched launch a chunk and equal
to a CPU twin, and a drift report counted by the plain kernel; the planes of
performance and tuning: the binned counts' ``segment_sum`` variant launching
the hand kernel bit for bit, a CUDA bincount never consulting the autotuner,
and the roofline peaks calibrated with the kernel's bytes counted.

They are marked ``cuda`` and skip where no CUDA device is present. This file
imports no JAX, so on a machine without JAX it runs alone::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import os
import time

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
    assert histogram.KERNEL_LAUNCHES == before + 9  # each member one bincount an update (its class pairs)
    got, want = gpu.compute(), cpu.compute()
    assert torch.equal(got["confmat"].cpu(), want["confmat"])
    for key in ("acc", "f1"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-6, rtol=0)


def _batches(dev, num_classes, steps=3, batch=512, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [
        (torch.softmax(torch.randn(batch, num_classes, generator=g, device=dev), dim=1),
         torch.randint(0, num_classes, (batch,), generator=g, device=dev))
        for _ in range(steps)
    ]


def _assert_equal_to_cpu(gpu, cpu, rtol=0.0):
    for name, want in cpu.metric_state.items():
        got = getattr(gpu, name)
        got, want = (got, want) if isinstance(want, list) else ([got], [want])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            g = g.cpu()
            assert g.dtype == w.dtype
            if w.is_floating_point():
                torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5, equal_nan=True)
            else:
                assert torch.equal(g, w), name
    torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), atol=1e-6, rtol=rtol, equal_nan=True)


FAMILY = [
    ("CohenKappa", dict(num_classes=10, weights="quadratic")),
    ("MatthewsCorrCoef", dict(num_classes=10)),
    ("JaccardIndex", dict(num_classes=10, ignore_index=0)),
    ("Specificity", dict(num_classes=10, average="macro")),
    ("Dice", dict(num_classes=10, average="macro")),
    ("HammingDistance", dict()),
]


@pytest.mark.parametrize("cls_name,kwargs", FAMILY, ids=[f[0] for f in FAMILY])
def test_family_on_the_card_equals_the_cpu(dev, cls_name, kwargs):
    gpu, cpu = getattr(mt, cls_name)(device=dev, **kwargs), getattr(mt, cls_name)(device="cpu", **kwargs)
    before = histogram.KERNEL_LAUNCHES
    for preds, target in _batches(dev, 10):
        gpu.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
    # one bincount per update: the confusion matrix's pairs, or the stat scores' class pairs; Hamming one-hots
    assert histogram.KERNEL_LAUNCHES - before == (0 if cls_name == "HammingDistance" else 3)
    _assert_equal_to_cpu(gpu, cpu)


@pytest.mark.parametrize("mix", ["softmax-b2", "labels-b8"])
def test_seg_states_from_class_ids_equal_the_onehot_on_the_card(dev, mix, monkeypatch):
    """One batch of each segmentation mix at Cityscapes shape (2 float32 softmax maps of 19 classes, or 8 int64
    label maps, 1024 x 2048): the JaccardIndex and Dice states from the class ids equal the one-hot path's bit
    for bit, and each member's update is one bincount launch."""
    import importlib

    from metrics_tpu_torch.utils import checks

    g = torch.Generator(device=dev).manual_seed(22)
    if mix == "softmax-b2":
        preds = torch.softmax(torch.randn((2, 19, 1024, 2048), generator=g, device=dev), dim=1)
        target = torch.randint(0, 19, (2, 1024, 2048), generator=g, device=dev)
    else:
        preds = torch.randint(0, 19, (8, 1024, 2048), generator=g, device=dev)
        target = torch.where(torch.rand(preds.shape, generator=g, device=dev) < 0.9, preds,
                             torch.randint(0, 19, preds.shape, generator=g, device=dev))

    def update():
        members = {"miou": mt.JaccardIndex(num_classes=19, device=dev),
                   "dice": mt.Dice(num_classes=19, average="macro", mdmc_average="global", device=dev)}
        launches = {}
        for name, metric in members.items():
            before = histogram.KERNEL_LAUNCHES
            metric.update(preds, target)
            launches[name] = histogram.KERNEL_LAUNCHES - before
        torch.cuda.synchronize()
        return members, launches

    prev = checks._get_validation_mode()
    checks.set_validation_mode("full")
    try:
        before = checks.canon_stats()
        ids, ids_launches = update()
        after = checks.canon_stats()
        assert ids_launches == {"miou": 1, "dice": 1}
        assert {k: after[k] - before[k] for k in after} == {"perf_canon_class_ids": 2, "perf_canon_onehot": 0}
        for name in ("stat_scores", "confusion_matrix"):  # the one-hot path, as inputs the ids do not take go
            module = importlib.import_module(f"metrics_tpu_torch.functional.classification.{name}")
            monkeypatch.setattr(module, "_takes_class_ids", lambda *a, **k: False)
        onehot, onehot_launches = update()
        assert onehot_launches == {"miou": 1, "dice": 0}
    finally:
        checks.set_validation_mode(prev)
    for name, metric in ids.items():
        for state, value in metric.metric_state.items():
            want = onehot[name].metric_state[state]
            assert value.dtype == want.dtype == torch.int32 and torch.equal(value, want), (name, state)
    assert int(ids["miou"].confmat.sum()) == target.numel()


@pytest.mark.parametrize("nan_strategy", ["error", "warn", "ignore", 0.5], ids=str)
@pytest.mark.parametrize("cls_name", ["MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"])
def test_aggregators_on_the_card_equal_the_cpu(dev, cls_name, nan_strategy):
    g = torch.Generator(device=dev).manual_seed(5)
    gpu, cpu = getattr(mt, cls_name)(nan_strategy=nan_strategy, device=dev), getattr(mt, cls_name)(nan_strategy=nan_strategy, device="cpu")
    for step in range(4):
        x = torch.rand(64, generator=g, device=dev)
        if nan_strategy != "error" and step % 2:
            x[::7] = float("nan")
        args = (x, torch.rand(64, generator=g, device=dev)) if cls_name == "MeanMetric" else (x,)
        gpu.update(*args)
        cpu.update(*(a.cpu() for a in args))
    _assert_equal_to_cpu(gpu, cpu, rtol=1e-5)


def _assert_close_tree(got, want, atol):
    """A result on the card against the CPU's: tensors, or lists and tuples of them; ``atol`` None is exact."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close_tree(g, w, atol)
        return
    g = got.cpu()
    assert g.dtype == want.dtype and g.shape == want.shape
    torch.testing.assert_close(g, want, atol=atol or 0.0, rtol=0.0, equal_nan=True)


CURVES = [
    ("PrecisionRecallCurve", dict(pos_label=1), "binary", None),
    ("ROC", dict(num_classes=10), "multiclass", None),
    ("AUROC", dict(pos_label=1), "binary", 1e-6),
    ("AUROC", dict(num_classes=10, average="weighted"), "multiclass", 1e-5),
    ("AveragePrecision", dict(num_classes=10), "multiclass", 1e-5),
    ("AveragePrecision", dict(num_classes=10, average="weighted"), "multiclass", 1e-5),
    ("CalibrationError", dict(n_bins=15), "multiclass", 1e-6),
    ("BinnedPrecisionRecallCurve", dict(num_classes=10, thresholds=50), "multiclass", 1e-6),
    ("BinnedAveragePrecision", dict(num_classes=10, thresholds=50), "multiclass", 1e-6),
    ("BinnedRecallAtFixedPrecision", dict(num_classes=1, thresholds=50, min_precision=0.3), "binary", 1e-6),
]


def _curve_batches(dev, kind, steps=3, batch=512, seed=3):
    if kind == "multiclass":
        return _batches(dev, 10, steps, batch, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    # scores on a grid of 2**-8, so that long tie runs form
    return [(torch.floor(torch.rand(batch, generator=g, device=dev) * 256) / 256,
             torch.randint(0, 2, (batch,), generator=g, device=dev)) for _ in range(steps)]


@pytest.mark.parametrize("cls_name,kwargs,kind,atol", CURVES, ids=[f"{c[0]}-{c[2]}" for c in CURVES])
def test_curve_metrics_on_the_card_equal_the_cpu(dev, cls_name, kwargs, kind, atol):
    gpu, cpu = getattr(mt, cls_name)(device=dev, **kwargs), getattr(mt, cls_name)(device="cpu", **kwargs)
    for preds, target in _curve_batches(dev, kind):
        gpu.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
    for name, want in cpu.metric_state.items():
        got = getattr(gpu, name)
        exact = not want[0].is_floating_point() if isinstance(want, list) else name != "conf_bin"
        _assert_close_tree(got, want, None if exact else 1e-4)
    _assert_close_tree(gpu.compute(), cpu.compute(), atol)


def test_calibration_error_update_is_one_bincount_launch(dev):
    metric = mt.CalibrationError(n_bins=15, device=dev)
    batches = _batches(dev, 1000, steps=4, batch=1000, seed=9)
    before = histogram.KERNEL_LAUNCHES
    for preds, target in batches:
        metric.update(preds, target)
    assert histogram.KERNEL_LAUNCHES - before == len(batches)
    assert metric.count_bin.dtype == metric.acc_bin.dtype == torch.int32
    assert int(metric.count_bin.sum()) == 4000


def test_weighted_curve_areas_count_the_support_with_the_kernel(dev):
    preds, target = _batches(dev, 10, steps=1, batch=2048, seed=11)[0]
    before = histogram.KERNEL_LAUNCHES
    got_auroc = mt.functional.auroc(preds, target, num_classes=10, average="weighted")
    got_ap = mt.functional.average_precision(preds, target, num_classes=10, average="weighted")
    assert histogram.KERNEL_LAUNCHES - before == 2
    want_auroc = mt.functional.auroc(preds.cpu(), target.cpu(), num_classes=10, average="weighted")
    want_ap = mt.functional.average_precision(preds.cpu(), target.cpu(), num_classes=10, average="weighted")
    torch.testing.assert_close(got_auroc.cpu(), want_auroc, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_ap.cpu(), want_ap, atol=1e-5, rtol=0)


def test_sorted_curves_on_the_card_equal_the_eager_path(dev):
    from metrics_tpu_torch.ops import sorted_curves

    (bp, bt), = _curve_batches(dev, "binary", steps=1, batch=4096)
    torch.testing.assert_close(sorted_curves.binary_auroc_sorted(bp, bt).cpu(),
                               mt.functional.auroc(bp.cpu(), bt.cpu(), pos_label=1), atol=1e-6, rtol=0)
    torch.testing.assert_close(sorted_curves.binary_average_precision_sorted(bp, bt).cpu(),
                               mt.functional.average_precision(bp.cpu(), bt.cpu(), pos_label=1), atol=1e-6, rtol=0)
    preds, target = _batches(dev, 10, steps=1, batch=2048, seed=12)[0]
    torch.testing.assert_close(sorted_curves.multiclass_auroc_sorted(preds, target, 10).cpu(),
                               mt.functional.auroc(preds.cpu(), target.cpu(), num_classes=10), atol=1e-5, rtol=0)
    torch.testing.assert_close(sorted_curves.multiclass_average_precision_sorted(preds, target, 10).cpu(),
                               mt.functional.average_precision(preds.cpu(), target.cpu(), num_classes=10),
                               atol=1e-5, rtol=0)


def test_binned_counts_on_the_card_are_exact_under_tf32(dev):
    """The compare and contraction give the CPU's counts with the caller's precision at "high"."""
    from metrics_tpu_torch.ops.binned import binned_curve_counts

    g = torch.Generator(device=dev).manual_seed(13)
    preds = torch.rand(3000, 64, generator=g, device=dev)
    target = (torch.rand(3000, 64, generator=g, device=dev) < 0.5).float()
    thresholds = torch.linspace(0, 1, 100, device=dev)
    torch.set_float32_matmul_precision("high")
    try:
        got = binned_curve_counts(preds, target, thresholds)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    want = binned_curve_counts(preds.cpu(), target.cpu(), thresholds.cpu())
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


def test_cohen_kappa_exact_counts_under_tf32(dev):
    """C=1000 and marginals above 2048: with the caller's matmul precision at "high"
    (TF32 on the card), the expected matrix stays the float32 product of the counts."""
    from metrics_tpu_torch.utils.compute import high_precision

    g = torch.Generator(device=dev).manual_seed(7)
    n, num_classes = 1 << 20, 1000
    hot = torch.randint(0, 10, (n,), generator=g, device=dev)  # ten classes take half the labels
    target = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, hot, torch.randint(0, num_classes, (n,), generator=g, device=dev))
    preds = torch.where(torch.rand(n, generator=g, device=dev) < 0.7, target, torch.randint(0, num_classes, (n,), generator=g, device=dev))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        gpu, cpu = mt.CohenKappa(num_classes, device=dev), mt.CohenKappa(num_classes, device="cpu")
        gpu.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
        assert int(cpu.confmat.sum(dim=0).max()) > 2048
        _assert_equal_to_cpu(gpu, cpu, rtol=1e-5)
        sum0 = gpu.confmat.sum(dim=0, keepdim=True).float()
        sum1 = gpu.confmat.sum(dim=1, keepdim=True).float()
        product = high_precision(torch.matmul)(sum1, sum0)
        assert torch.equal(product.cpu(), sum1.cpu() * sum0.cpu())
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


# ------------------------------------------------------------------ state sync
@pytest.fixture
def nccl_world(dev, tmp_path, monkeypatch):
    """A NCCL process group of one rank on the card (NCCL refuses two ranks on one device)."""
    import torch.distributed as dist

    from metrics_tpu_torch.parallel import bucketing

    monkeypatch.setitem(os.environ, "NCCL_SOCKET_IFNAME", os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
    monkeypatch.setattr(bucketing, "_MANIFEST_CACHE", {})
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def _bits(x):
    return x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x.reshape(-1).to(torch.uint8)


def test_nccl_world_of_one_syncs_the_headline_suite_bit_exact(nccl_world):
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    num_classes = 128
    suite = mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=num_classes, average="macro"),
            "f1": mt.F1Score(num_classes=num_classes, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=num_classes),
            "precision": mt.Precision(num_classes=num_classes, average="macro"),
        }
    )
    for preds, target in _batches(torch.device("cuda"), num_classes, steps=3, batch=2048):
        suite.update(preds, target)
    members = dict(suite.items(keep_base=True, copy_state=False))
    local = {name: {k: v.clone() for k, v in m.metric_state.items()} for name, m in members.items()}
    counts = []
    for _ in range(2):
        reset_collective_stats()
        suite.sync(distributed_available=lambda: True)
        stats = collective_stats()
        counts.append((stats["sync_shape_collectives"], stats["sync_payload_collectives"]))
        for name, m in members.items():
            for state, value in local[name].items():
                got = getattr(m, state)
                assert got.is_cuda and got.dtype == value.dtype and torch.equal(got, value), (name, state)
        suite.unsync()
    # the first sync of the layout checks it across the group once; then one payload collective
    assert counts == [(1, 1), (0, 1)]


def test_nccl_world_of_one_keeps_every_dtype_aligned(nccl_world, dev):
    layout = [("flag", torch.bool, (3,)), ("small", torch.int8, (5,)), ("wide", torch.int64, (2,)),
              ("byte", torch.uint8, ()), ("double", torch.float64, ()), ("brain", torch.bfloat16, (2, 3)),
              ("half", torch.float16, (3,)), ("count", torch.int32, (7,))]

    class Layout(mt.Metric):
        full_state_update = True

        def __init__(self):
            super().__init__()
            for name, dtype, shape in layout:
                self.add_state(name, torch.zeros(shape, dtype=dtype), dist_reduce_fx=None)
            self.add_state("rows", [], dist_reduce_fx="cat")

        def update(self):
            g = torch.Generator(device=dev).manual_seed(3)
            for name, dtype, shape in layout:
                setattr(self, name, (torch.randn(shape, generator=g, device=dev) * 100).to(dtype))
            self.rows.append(torch.randint(0, 100, (3,), generator=g, device=dev, dtype=torch.int8))
            self.rows.append(torch.randint(0, 100, (4,), generator=g, device=dev, dtype=torch.int8))

        def compute(self):
            return self.count

    m = Layout()
    m.update()
    local = {name: getattr(m, name) for name, _, _ in layout}
    rows = torch.cat(m.rows)
    m.sync(distributed_available=lambda: True)
    for name, value in local.items():
        got = getattr(m, name)
        assert got.shape == (1,) + value.shape and torch.equal(_bits(got[0]), _bits(value)), name
    assert torch.equal(m.rows, rows)
    m.unsync()
    assert all(getattr(m, name) is value for name, value in local.items())


# ------------------------------------------------------------------ slice 6
def test_partial_auroc_without_negatives_is_nan_on_the_card(dev):
    import warnings

    for label in (1, 0):
        preds = torch.rand(50, device=dev)
        target = torch.full((50,), label, device=dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            value = mt.functional.auroc(preds, target, pos_label=label, max_fpr=0.5)
            metric = mt.AUROC(pos_label=label, max_fpr=0.5, device=dev)
            batch = metric(preds, target)
            metric.update(preds[:7], target[:7])
            total = metric.compute()
        assert any("No negative samples" in str(w.message) for w in caught)
        assert all(bool(torch.isnan(v)) for v in (value, batch, total))


def test_segments_on_the_card_equal_the_cpu(dev):
    from metrics_tpu_torch.ops import segments

    g = torch.Generator(device=dev).manual_seed(21)
    for groups in (1000, histogram.SHARED_MAX_BINS + 7):  # the kernel's shared path, then its global path
        ids = torch.sort(torch.randint(0, groups, (200_000,), generator=g, device=dev)).values
        hits = (torch.rand(ids.shape[0], generator=g, device=dev) < 0.1).to(torch.float32)
        data = torch.randn(ids.shape[0], generator=g, device=dev)
        before = histogram.KERNEL_LAUNCHES
        counts = segments.segment_count(ids, groups)
        assert histogram.KERNEL_LAUNCHES - before == 1
        assert torch.equal(counts.cpu(), segments.segment_count(ids.cpu(), groups))
        assert torch.equal(segments.segment_starts(ids, groups, counts).cpu(), segments.segment_starts(ids.cpu(), groups))
        assert torch.equal(segments.segment_ranks(ids, groups).cpu(), segments.segment_ranks(ids.cpu(), groups))
        cum = segments.segment_cumsum(hits, ids, groups)
        assert torch.equal(cum.cpu(), segments.segment_cumsum(hits.cpu(), ids.cpu(), groups))
        sums = segments.segment_sum(data, ids, groups, counts)
        # deterministic: the same bits again, with no float atomics
        assert torch.equal(sums, segments.segment_sum(data, ids, groups, counts))
        assert torch.equal(segments.segment_cumsum(data, ids, groups), segments.segment_cumsum(data, ids, groups))
        torch.testing.assert_close(sums.cpu(), segments.segment_sum(data.cpu(), ids.cpu(), groups), atol=1e-4, rtol=1e-5)
        assert torch.equal(segments.segment_max(data, ids, groups, counts).cpu(),
                           segments.segment_max(data.cpu(), ids.cpu(), groups))


def _retrieval_rows_on(dev, queries=300, per_query=50, seed=22):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = queries * per_query
    indexes = torch.randint(0, queries, (n,), generator=g, device=dev) * 7919 + 2**40
    preds = torch.floor(torch.rand(n, generator=g, device=dev) * 64) / 64  # ties
    preds[::13] = 0.0
    preds[5::13] = -0.0
    preds[7::97] = float("nan")
    target = (torch.rand(n, generator=g, device=dev) < 0.1).to(torch.int64)
    return preds, target, indexes


def test_retrieval_grouping_on_the_card_equals_the_cpu(dev):
    from metrics_tpu_torch.retrieval.base import group_rows

    preds, target, indexes = _retrieval_rows_on(dev)
    before = histogram.KERNEL_LAUNCHES
    gpu = group_rows(indexes, preds, target)
    assert histogram.KERNEL_LAUNCHES - before == 1  # segment_count
    cpu = group_rows(indexes.cpu(), preds.cpu(), target.cpu())
    for field in ("seg", "preds", "rel", "ranks", "cumrel", "counts", "starts", "n_pos"):
        got, want = getattr(gpu, field).cpu(), getattr(cpu, field)
        assert got.dtype == want.dtype and torch.equal(got.nan_to_num(-7.0), want.nan_to_num(-7.0)), field


def test_retrieval_suite_on_the_card_equals_the_cpu_and_repeats_its_bits(dev):
    def suite(device):
        return mt.MetricCollection({
            "map": mt.RetrievalMAP(device=device), "mrr": mt.RetrievalMRR(device=device),
            "ndcg": mt.RetrievalNormalizedDCG(k=10, device=device), "p": mt.RetrievalPrecision(k=10, device=device),
            "fo": mt.RetrievalFallOut(k=10, device=device), "rprec": mt.RetrievalRPrecision(device=device),
            "curve": mt.RetrievalPrecisionRecallCurve(max_k=20, device=device),
        })

    gpu, cpu = suite(dev), suite("cpu")
    for seed in range(3):
        preds, target, indexes = _retrieval_rows_on(dev, queries=100, seed=30 + seed)
        gpu.update(preds, target, indexes)
        cpu.update(preds.cpu(), target.cpu(), indexes.cpu())
    first = gpu.compute()
    for _, m in gpu.items(keep_base=True, copy_state=False):
        m._computed = None
    again = gpu.compute()
    want = cpu.compute()
    def parts(v):
        return v if isinstance(v, tuple) else (v,)

    for key, value in want.items():
        for a, b, w in zip(parts(first[key]), parts(again[key]), parts(value)):
            assert torch.equal(a, b), key  # the same bits twice on the card
            torch.testing.assert_close(a.cpu(), w, atol=1e-6, rtol=0)


def test_ranking_metrics_with_ties_on_the_card_equal_the_cpu(dev):
    g = torch.Generator(device=dev).manual_seed(23)
    preds = torch.floor(torch.rand(300, 64, generator=g, device=dev) * 8) / 8  # long tie runs
    target = (torch.rand(300, 64, generator=g, device=dev) < 0.05).to(torch.int64)
    target[0] = 1
    weight = torch.rand(300, generator=g, device=dev)
    for name in ("coverage_error", "label_ranking_average_precision", "label_ranking_loss"):
        fn = getattr(mt.functional, name)
        torch.testing.assert_close(fn(preds, target, weight).cpu(), fn(preds.cpu(), target.cpu(), weight.cpu()),
                                   atol=1e-6, rtol=1e-6)
    # the ranking loss's double sort is stable on the card: its inverse permutation equals the CPU's
    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    assert torch.equal(inverse.cpu(), torch.argsort(torch.argsort(preds.cpu(), dim=1, stable=True), dim=1, stable=True))


def test_regression_and_pairwise_on_the_card_equal_the_cpu(dev):
    g = torch.Generator(device=dev).manual_seed(24)
    target = torch.floor(torch.rand(100_000, generator=g, device=dev) * 100) / 10
    preds = target + torch.rand(100_000, generator=g, device=dev)
    for name in ("spearman_corrcoef", "pearson_corrcoef", "r2_score", "explained_variance"):
        fn = getattr(mt.functional, name)
        torch.testing.assert_close(fn(preds, target).cpu(), fn(preds.cpu(), target.cpu()), atol=1e-5, rtol=1e-5)
    x, y = torch.randn(300, 64, generator=g, device=dev), torch.randn(500, 64, generator=g, device=dev)
    for name in ("pairwise_manhattan_distance", "pairwise_linear_similarity", "pairwise_cosine_similarity"):
        fn = getattr(mt.functional, name)
        torch.testing.assert_close(fn(x, y).cpu(), fn(x.cpu(), y.cpu()), atol=1e-4, rtol=1e-5)


# ------------------------------------------------------------------ wrappers and image metrics
def test_image_metrics_run_in_float32_under_tf32(dev):
    g = torch.Generator(device=dev).manual_seed(25)
    preds = torch.rand(4, 3, 192, 192, generator=g, device=dev)
    target = (preds * 0.8 + 0.1 + 0.05 * torch.randn(preds.shape, generator=g, device=dev)).clamp(0, 1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name in ("structural_similarity_index_measure", "multiscale_structural_similarity_index_measure",
                     "universal_image_quality_index"):
            fn = getattr(mt.functional, name)
            kwargs = {"data_range": 1.0} if "structural" in name else {}
            got = fn(preds, target, **kwargs)
            assert torch.backends.cudnn.allow_tf32, "the caller's TF32 setting was not restored"
            # TF32 (a 10-bit mantissa) moves SSIM by about 1e-3; float32 agrees to about 1e-6
            torch.testing.assert_close(got.cpu(), fn(preds.cpu(), target.cpu(), **kwargs), atol=1e-5, rtol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_bootstrapper_on_the_card_equals_a_cpu_twin_fed_the_same_draws(dev, monkeypatch):
    from metrics_tpu_torch.wrappers import bootstrapping

    real = bootstrapping._bootstrap_sampler
    draws = []

    def recording(size, num_bootstraps, strategy, generator):
        out = real(size, num_bootstraps, strategy, generator)
        draws.append([d.cpu() for d in out])
        return out

    g = torch.Generator(device=dev).manual_seed(26)
    batches = [(torch.softmax(torch.randn(512, 10, generator=g, device=dev), 1),
                torch.randint(0, 10, (512,), generator=g, device=dev)) for _ in range(3)]
    for strategy in ("poisson", "multinomial"):
        card = mt.BootStrapper(mt.Accuracy(num_classes=10, average="macro"), num_bootstraps=16,
                               sampling_strategy=strategy, quantile=[0.05, 0.95], raw=True)
        assert card.generator.device.type == "cuda"
        card.generator.manual_seed(3)
        monkeypatch.setattr(bootstrapping, "_bootstrap_sampler", recording)
        draws.clear()
        for p, t in batches:
            card.update(p, t)
        replay = iter(list(draws))
        monkeypatch.setattr(bootstrapping, "_bootstrap_sampler", lambda *a: next(replay))
        cpu = mt.BootStrapper(mt.Accuracy(num_classes=10, average="macro", device="cpu"), num_bootstraps=16,
                              sampling_strategy=strategy, quantile=[0.05, 0.95], raw=True)
        for p, t in batches:
            cpu.update(p.cpu(), t.cpu())
        for a, b in zip(card.metrics, cpu.metrics):
            for name, value in b.metric_state.items():
                assert torch.equal(getattr(a, name).cpu(), value), (strategy, name)
        want = cpu.compute()
        for key, value in card.compute().items():
            torch.testing.assert_close(value.cpu(), want[key], atol=1e-6, rtol=1e-6)


def test_nccl_world_of_one_syncs_a_bootstrapper_in_one_payload_collective(nccl_world, dev):
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    boot = mt.BootStrapper(mt.Accuracy(num_classes=100, average="macro"), num_bootstraps=50)
    for preds, target in _batches(dev, 100, steps=2, batch=1024):
        boot.update(preds, target)
    local = [{k: v.clone() for k, v in m.metric_state.items()} for m in boot.metrics]
    counts = []
    for _ in range(2):
        reset_collective_stats()
        boot.sync(distributed_available=lambda: True)
        stats = collective_stats()
        counts.append((stats["sync_shape_collectives"], stats["sync_payload_collectives"]))
        for m, want in zip(boot.metrics, local):
            assert all(torch.equal(getattr(m, k), v) for k, v in want.items())
        boot.unsync()
    assert counts == [(1, 1), (0, 1)]


def test_inception_taps_on_the_card_equal_the_cpu_under_tf32(dev):
    """The same seeded weights on the card and the CPU; the caller leaves cuDNN's TF32 and the
    matmul's TF32 on, and the network still runs in float32 (TF32 would move the taps by about 1e-3
    of their scale)."""
    from metrics_tpu_torch.models import inception

    card = inception.InceptionV3Extractor(feature="2048", seed=3, device=dev)
    cpu = inception.InceptionV3Extractor(feature="2048", seed=3, device="cpu")
    imgs = torch.randint(0, 256, (4, 3, 96, 96), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    x = inception._resize_bilinear(imgs.float()) / 255.0 * 2.0 - 1.0
    prev = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got = inception._apply(card.model, x.to(dev))
        assert torch.backends.cudnn.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    want = inception._apply(cpu.model, x)
    for tap, value in want.items():
        err = (got[tap].cpu() - value).abs().max() / (value.abs().mean() + 1e-12)
        assert err < 1e-4, (tap, float(err))
    # the extractor end to end, from the uint8 images on the card
    torch.testing.assert_close(card(imgs.to(dev)).cpu(), cpu(imgs), rtol=1e-4, atol=1e-4 * want["2048"].abs().mean())


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_on_the_card_equals_the_cpu(dev, net_type):
    from metrics_tpu_torch.models import lpips

    g = torch.Generator().manual_seed(1)
    img1, img2 = (torch.rand(3, 3, 65, 65, generator=g) * 2 - 1 for _ in range(2))
    card = lpips.LPIPSExtractor(net_type, seed=2, device=dev)
    cpu = lpips.LPIPSExtractor(net_type, seed=2, device="cpu")
    torch.testing.assert_close(card(img1.to(dev), img2.to(dev)).cpu(), cpu(img1, img2), atol=1e-5, rtol=0)


def test_fid_kid_is_on_the_card_equal_the_cpu(dev):
    feats = lambda x: x.reshape(x.shape[0], -1)[:, :32]  # noqa: E731
    g = torch.Generator().manual_seed(4)
    real, fake = torch.rand(64, 1, 8, 8, generator=g), torch.rand(64, 1, 8, 8, generator=g) * 0.9 + 0.1
    out = {}
    for device in (dev, "cpu"):
        fid = mt.FrechetInceptionDistance(feature=feats, device=device)
        kid = mt.KernelInceptionDistance(feature=feats, subsets=5, subset_size=32, device=device)
        iscore = mt.InceptionScore(feature=feats, splits=4, device=device)
        for m in (fid, kid):
            m.update(real.to(device), real=True)
            m.update(fake.to(device), real=False)
        iscore.update(fake.to(device))
        out[str(device)] = [fid.compute(), *kid.compute(), *iscore.compute()]
    # FID and KID in float64: 1e-6 relative; IS in float32: its mean within 1e-5 relative, its
    # spread (a difference of float32 values near 1, which cancels) within 1e-6 absolute
    tolerances = [(1e-6, 1e-12)] * 3 + [(1e-5, 0.0), (0.0, 1e-6)]
    for got, want, (rtol, atol) in zip(out[str(dev)], out["cpu"], tolerances):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=atol)


def _detection_scene(n_images, seed, masks=False, n_classes=3):
    g = torch.Generator().manual_seed(seed)
    preds, targets = [], []
    for _ in range(n_images):
        n_gt = int(torch.randint(0, 8, (1,), generator=g))
        xy = torch.rand(n_gt, 2, generator=g) * 400
        wh = torch.rand(n_gt, 2, generator=g) * 120 + 4
        gt = torch.cat([xy, wh], 1)
        n_det = int(torch.randint(0, 12, (1,), generator=g))
        det = torch.cat([torch.rand(n_det, 2, generator=g) * 400, torch.rand(n_det, 2, generator=g) * 120 + 4], 1)
        det[: min(n_gt, n_det)] = gt[: min(n_gt, n_det)] + torch.randn(min(n_gt, n_det), 4, generator=g) * 3
        det[:, 2:] = det[:, 2:].clamp(min=1)
        gl = torch.randint(0, n_classes, (n_gt,), generator=g)
        dl = torch.cat([gl[:n_det], torch.randint(0, n_classes, (max(n_det - n_gt, 0),), generator=g)])
        scores = torch.rand(n_det, generator=g)
        if masks:  # boxes drawn as masks on a 512 x 512 canvas: cells of 17 pairs or more take the device
            def draw(b):
                grid = torch.arange(512.0)
                x0, y0, w, h = b.unbind(-1)
                return (((grid[None, :, None] >= y0[:, None, None]) & (grid[None, :, None] < (y0 + h)[:, None, None]))
                        & ((grid[None, None, :] >= x0[:, None, None]) & (grid[None, None, :] < (x0 + w)[:, None, None])))
            preds.append(dict(masks=draw(det), scores=scores, labels=dl))
            targets.append(dict(masks=draw(gt), labels=gl))
        else:
            preds.append(dict(boxes=det, scores=scores, labels=dl))
            targets.append(dict(boxes=gt, labels=gl))
    return preds, targets


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_map_on_the_card_equals_the_cpu(dev, iou_type):
    preds, targets = _detection_scene(24, seed=5, masks=iou_type == "segm", n_classes=3 if iou_type == "bbox" else 1)
    kwargs = dict(iou_type=iou_type, class_metrics=True, **({"box_format": "xywh"} if iou_type == "bbox" else {}))
    card = mt.MeanAveragePrecision(**kwargs)
    cpu = mt.MeanAveragePrecision(device="cpu", **kwargs)
    on = lambda ds: [{k: v.to(dev) for k, v in d.items()} for d in ds]  # noqa: E731
    for i in range(0, 24, 8):
        card.update(on(preds[i : i + 8]), on(targets[i : i + 8]))
        cpu.update(preds[i : i + 8], targets[i : i + 8])
    prev = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # mask IoU stays exact under the caller's TF32
    try:
        got = card.compute()
    finally:
        torch.set_float32_matmul_precision(prev[1])
    want = cpu.compute()
    assert card.iou_cells == cpu.iou_cells
    if iou_type == "segm":
        assert card.iou_cells["device"] > 0
    for key, value in want.items():
        assert got[key].device.type == "cuda" and torch.equal(got[key].cpu(), value), key


def test_perplexity_on_the_card_equals_the_cpu(dev):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 64, 5000, generator=g) * 3
    target = torch.randint(0, 5000, (2, 64), generator=g)
    target[0, :5] = -100
    for dtype in (torch.float32, torch.bfloat16):
        card, cpu = mt.Perplexity(ignore_index=-100), mt.Perplexity(ignore_index=-100, device="cpu")
        card.update(logits.to(dtype).to(dev), target.to(dev))
        cpu.update(logits.to(dtype), target)
        assert torch.equal(card.count.cpu(), cpu.count)
        torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-5, atol=0)


def test_bert_score_matcher_on_the_card_equals_the_cpu_under_tf32(dev):
    from metrics_tpu_torch.functional.text.bert import _greedy_layerwise_scores

    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(8, 1, 20, 256, generator=g), torch.randn(8, 1, 24, 256, generator=g)
    sa, sb = torch.full((8, 20), 0.05), torch.full((8, 24), 1 / 24)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # the matcher keeps float32 under the caller's TF32
    try:
        got = _greedy_layerwise_scores(a.to(dev), sa.to(dev), b.to(dev), sb.to(dev))
    finally:
        torch.set_float32_matmul_precision(prev)
    want = _greedy_layerwise_scores(a, sa, b, sb)
    for x, y in zip(got, want):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"use_cg_iter": 10}, {"load_diag": 1e-3, "zero_mean": True}])
def test_sdr_on_the_card_equals_the_cpu(dev, kwargs):
    import metrics_tpu_torch.functional as F

    g = torch.Generator().manual_seed(2)
    target = torch.randn(4, 8000, generator=g)
    preds = target + 0.3 * torch.randn(4, 8000, generator=g)
    got = F.signal_distortion_ratio(preds.to(dev), target.to(dev), filter_length=128, **kwargs)
    want = F.signal_distortion_ratio(preds, target, filter_length=128, **kwargs)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=0)  # dB: the float32 solve rounds differently
    got64 = F.signal_distortion_ratio(preds.double().to(dev), target.double().to(dev), filter_length=128, **kwargs)
    want64 = F.signal_distortion_ratio(preds.double(), target.double(), filter_length=128, **kwargs)
    torch.testing.assert_close(got64.cpu(), want64, atol=1e-9, rtol=0)


@pytest.mark.parametrize("spk", [2, 3, 8])
def test_pit_on_the_card_equals_the_cpu(dev, spk):
    import metrics_tpu_torch.functional as F

    g = torch.Generator().manual_seed(3)
    target = torch.randn(6, spk, 2000, generator=g)
    perm = torch.argsort(torch.rand(6, spk, generator=g), dim=1)
    preds = torch.gather(target, 1, perm[:, :, None].expand(-1, -1, 2000)) + 0.3 * torch.randn(6, spk, 2000, generator=g)
    best, best_perm = F.permutation_invariant_training(preds.to(dev), target.to(dev),
                                                       F.scale_invariant_signal_distortion_ratio)
    want, want_perm = F.permutation_invariant_training(preds, target, F.scale_invariant_signal_distortion_ratio)
    assert best_perm.is_cuda and torch.equal(best_perm.cpu(), want_perm)
    assert torch.equal(want_perm, torch.argsort(perm, dim=1))
    torch.testing.assert_close(best.cpu(), want, atol=1e-4, rtol=0)
    assert torch.equal(F.pit_permutate(preds.to(dev), best_perm).cpu(), F.pit_permutate(preds, want_perm))


def test_text_states_on_the_card_equal_the_cpu(dev):
    preds = ["the cat sat on the mat", "a dog ran, fast.", "hello there world"]
    target = [["the cat is on the mat"], ["a dog runs fast."], ["hello world"]]
    for make in (lambda d: mt.BLEUScore(device=d), lambda d: mt.CHRFScore(device=d),
                 lambda d: mt.TranslationEditRate(return_sentence_level_score=True, device=d),
                 lambda d: mt.ExtendedEditDistance(device=d), lambda d: mt.ROUGEScore(device=d)):
        card, cpu = make(dev), make("cpu")
        card.update(preds, target)
        cpu.update(preds, target)
        for name, want in cpu.metric_state.items():
            got = getattr(card, name)
            got, want = (torch.cat(got), torch.cat(want)) if isinstance(want, list) else (got, want)
            assert got.is_cuda and got.dtype == want.dtype and torch.equal(got.cpu(), want), name
        got, want = card.compute(), cpu.compute()
        flat = lambda v: list(v.values()) if isinstance(v, dict) else list(v) if isinstance(v, tuple) else [v]  # noqa: E731
        for x, y in zip(flat(got), flat(want)):
            torch.testing.assert_close(x.cpu(), y, rtol=1e-6, atol=0)


# ------------------------------------------- the journal, the sync-pack drill
def _headline(device, num_classes=64):
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=num_classes, average="macro", device=device),
        "f1": mt.F1Score(num_classes=num_classes, average="macro", device=device),
        "confmat": mt.ConfusionMatrix(num_classes=num_classes, device=device),
        "precision": mt.Precision(num_classes=num_classes, average="macro", device=device),
    })


def _suite_states(suite):
    return {(name, state): value for name, m in suite.items(keep_base=True, copy_state=False)
            for state, value in m.metric_state.items()}


def test_journal_round_trip_on_the_card_and_into_a_cpu_twin(dev, tmp_path):
    from metrics_tpu_torch.ops import journal

    path = str(tmp_path / "suite.journal")
    card, cpu = _headline(dev), _headline("cpu")
    for preds, target in _batches(dev, 64, steps=4, batch=1024):
        card.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
    before = journal.journal_stats()
    card.save_state(path)
    restored, twin = _headline(dev), _headline("cpu")
    assert restored.load_state(path) == 0 and twin.load_state(path) == 0
    assert journal.journal_stats()["journal_loads"] - before["journal_loads"] == 2
    want, want_cpu = _suite_states(card), _suite_states(cpu)
    for key, value in _suite_states(restored).items():
        assert value.is_cuda and value.dtype == want[key].dtype and torch.equal(value, want[key]), key
    for key, value in _suite_states(twin).items():
        assert value.device.type == "cpu" and torch.equal(value, want_cpu[key]), key
    for got, ref in ((restored.compute(), card.compute()), (twin.compute(), cpu.compute())):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    # and the reverse: a record written on the CPU loads onto the card
    cpu.save_state(path)
    back = _headline(dev)
    back.load_state(path)
    for key, value in _suite_states(back).items():
        assert value.is_cuda and torch.equal(value.cpu(), want_cpu[key]), key


def test_restored_bootstrapper_on_the_card_continues_its_draws(dev, tmp_path):
    path = str(tmp_path / "boot.journal")
    batches = _batches(dev, 10, steps=6, batch=256, seed=3)
    make = lambda: mt.BootStrapper(mt.Accuracy(num_classes=10, average="macro", device=dev),  # noqa: E731
                                   num_bootstraps=8, raw=True)
    live = make()
    for preds, target in batches[:3]:
        live.update(preds, target)
    live.save_state(path)
    restored = make()
    restored.load_state(path)
    for preds, target in batches[3:]:
        live.update(preds, target)
        restored.update(preds, target)
    assert torch.equal(restored.compute()["raw"], live.compute()["raw"])


def test_sync_pack_drill_in_a_nccl_world_of_one(nccl_world):
    import warnings

    from metrics_tpu_torch.ops import faults
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    suite = _headline(torch.device("cuda"))
    for preds, target in _batches(torch.device("cuda"), 64, steps=3, batch=1024):
        suite.update(preds, target)
    local = {k: v.clone() for k, v in _suite_states(suite).items()}
    faults.set_recovery_policy(steps=2)
    try:
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            with faults.inject_faults("sync-pack", 5) as plan:
                reset_collective_stats()
                suite.sync(distributed_available=lambda: True)
        assert plan.fired == 5 and sum("Coalesced" in str(w.message) for w in record) == 5
        stats = collective_stats()
        assert stats["sync_coalesced_payloads"] == 0 and stats["sync_pack_fallbacks"] == 5
        assert stats["sync_shape_collectives"] == stats["sync_payload_collectives"] == len(local)
        for key, value in _suite_states(suite).items():
            assert torch.equal(value, local[key]), key
        suite.unsync()
        payloads = []
        for _ in range(3):
            reset_collective_stats()
            suite.sync(distributed_available=lambda: True)
            payloads.append(collective_stats()["sync_coalesced_payloads"])
            suite.unsync()
        # members re-promote after their second clean sync, the suite after its second
        assert payloads == [0, 4, 1], payloads
    finally:
        faults.set_recovery_policy(steps=8)


def test_spearman_with_nan_on_the_card_equals_the_cpu(dev):
    from metrics_tpu_torch.functional.regression.correlation import _rank_data

    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.round(torch.rand(100_000, generator=g, device=dev) * 512) / 512
    x[torch.rand(100_000, generator=g, device=dev) < 0.01] = float("nan")
    y = x + torch.rand(100_000, generator=g, device=dev) * 0.1
    assert torch.equal(_rank_data(x).cpu(), _rank_data(x.cpu()))
    got = mt.functional.spearman_corrcoef(x, y)
    want = mt.functional.spearman_corrcoef(x.cpu(), y.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        mt.functional.spearman_corrcoef(x[:1], y[:1])


def test_async_sync_with_updates_in_flight_equals_a_blocking_sync(nccl_world):
    """The packed buffer is a copy made at dispatch: updates on the compute stream while the collective is in
    flight change neither the forced states (those of a blocking sync at dispatch) nor come back wrong at unsync."""
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    dev = torch.device("cuda")
    batches = _batches(dev, 64, steps=8, batch=2048)
    suite, twin = _headline(dev), _headline(dev)
    for preds, target in batches[:3]:
        suite.update(preds, target)
        twin.update(preds, target)
    twin.sync(distributed_available=lambda: True)
    want = {k: v.clone() for k, v in _suite_states(twin).items()}
    twin.unsync()
    reset_collective_stats()
    fut = suite.sync_async(distributed_available=lambda: True)
    for preds, target in batches[3:]:  # in flight
        suite.update(preds, target)
    tail = {k: v.clone() for k, v in _suite_states(suite).items()}
    fut.wait()
    assert collective_stats()["sync_async_forces"] == 1 and collective_stats()["sync_payload_collectives"] == 1
    for key, value in _suite_states(suite).items():
        assert torch.equal(value, want[key]), key
    suite.unsync()
    for key, value in _suite_states(suite).items():
        assert torch.equal(value, tail[key]), key


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(1,), (3,), (1000,), (128, 128)])
def test_quantized_wire_bytes_on_the_card_equal_the_cpu(dev, tier, shape):
    from metrics_tpu_torch.parallel import bucketing

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g) * 37.5
    got = bucketing._quant_bytes(x.to(dev), tier)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), bucketing._quant_bytes(x, tier))


def test_compute_on_cpu_rows_on_the_host_after_update_on_the_card_at_sync(nccl_world):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [(torch.rand(4096, generator=g, device=dev), torch.randint(0, 2, (4096,), generator=g, device=dev))
               for _ in range(3)]
    offloaded, on_card = mt.AUROC(pos_label=1, compute_on_cpu=True, device=dev), mt.AUROC(pos_label=1, device=dev)
    for preds, target in batches:
        offloaded.update(preds, target)
        on_card.update(preds, target)
    assert all(r.device.type == "cpu" for r in offloaded.preds + offloaded.target)
    host_rows = list(offloaded.preds)
    offloaded.sync(distributed_available=lambda: True)
    synced = offloaded.preds if isinstance(offloaded.preds, list) else [offloaded.preds]
    assert all(r.device.type == "cuda" for r in synced)
    offloaded.unsync()
    assert all(a is b for a, b in zip(offloaded.preds, host_rows))
    assert torch.equal(offloaded.compute().cpu(), on_card.compute().cpu())
    assert all(r.device.type == "cpu" for r in offloaded.preds)


# ------------------------------------------------------------- the dispatch engine
@pytest.fixture
def first_mode(dev):
    from metrics_tpu_torch.ops import engine
    from metrics_tpu_torch.utils import checks

    mode = checks._get_validation_mode()
    checks.set_validation_mode("first")
    engine.set_deferred_dispatch(True)
    yield dev
    engine.set_device_probe(0)
    engine.set_deferred_dispatch(True)
    checks.set_validation_mode(mode)


def _engine_suite(dev, c=16):
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=c, average="macro", device=dev),
        "f1": mt.F1Score(num_classes=c, average="macro", device=dev),
        "confmat": mt.ConfusionMatrix(num_classes=c, device=dev),
        "precision": mt.Precision(num_classes=c, average="macro", device=dev),
    })


def _engine_batches(dev, n, c=16, b=512):
    g = torch.Generator(device=dev).manual_seed(n)
    return [(torch.softmax(torch.randn(b, c, generator=g, device=dev), 1),
             torch.randint(0, c, (b,), generator=g, device=dev)) for _ in range(n)]


def _engine_states(suite):
    return {(k, s): v for k, m in suite.items(keep_base=True, copy_state=False) for s, v in m.metric_state.items()}


@pytest.mark.parametrize("way", ["deferred", "update_many", "forward"])
def test_engine_ways_on_the_card_equal_the_per_call_path(first_mode, way):
    from metrics_tpu_torch.ops import engine

    dev = first_mode
    batches = _engine_batches(dev, 9)
    engine.set_deferred_dispatch(False)
    ref = _engine_suite(dev)
    want = [ref(p, t) if way == "forward" else ref.update(p, t) for p, t in batches]
    engine.set_deferred_dispatch(True)
    suite = _engine_suite(dev)
    if way != "forward":
        suite.update(*batches[0])
    before = histogram.KERNEL_LAUNCHES
    if way == "update_many":
        rest = batches[1:]
        stacked = (torch.stack([p for p, _ in rest]), torch.stack([t for _, t in rest]))
        suite.update_many(*stacked)  # the first sight: call by call
        launched = histogram.KERNEL_LAUNCHES - before
        for p, t in rest:
            ref.update(p, t)
        before = histogram.KERNEL_LAUNCHES
        suite.update_many(*stacked)  # the step program
        engine.flush_barrier([suite])
        # one bincount a compute group a step: acc, f1 with precision, confmat
        assert histogram.KERNEL_LAUNCHES - before == 3 * len(rest) and launched == 3 * len(rest)
    elif way == "deferred":
        for p, t in batches[1:]:
            suite.update(p, t)
        assert suite._defer_pending is not None
        assert histogram.KERNEL_LAUNCHES == before  # nothing launched yet
        engine.flush_barrier([suite])
        assert histogram.KERNEL_LAUNCHES - before == 3 * (len(batches) - 1)
    else:
        got = [suite(p, t) for p, t in batches]
        assert isinstance(got[1]["acc"], engine.LazyValue)
        for g, w in zip(got, want):
            for k in w:
                value = g[k]._force() if isinstance(g[k], engine.LazyValue) else g[k]
                assert value.device.type == "cuda" and torch.equal(value, w[k])
        assert histogram.KERNEL_LAUNCHES - before == 4 * len(batches)  # a forward updates each member
    mine, theirs = _engine_states(suite), _engine_states(ref)
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        assert mine[key].device.type == "cuda" and torch.equal(mine[key], value), key


def test_lazy_value_in_torch_expressions_on_the_card(first_mode):
    dev = first_mode
    m = mt.MeanSquaredError(device=dev)
    a, b = torch.rand(64, device=dev), torch.rand(64, device=dev)
    m(a, b)
    h1, h2 = m(a, b), m(a, b)
    stacked = torch.stack([h1, h2])
    assert stacked.device.type == "cuda" and torch.equal(stacked[0], stacked[1])
    assert torch.equal(torch.ones((), device=dev) + h1, 1 + stacked[0])


def test_host_lane_declines_a_cpu_tensor_for_a_card_metric(first_mode):
    dev = first_mode
    m = mt.AUROC(pos_label=1, device=dev)
    p, t = torch.rand(256, device=dev), torch.randint(0, 2, (256,), device=dev)
    m.update(p, t)
    m.update(p.cpu(), t.cpu())  # the full path moves it to the card
    assert all(r.device.type == "cuda" for r in m.preds + m.target)


def test_device_probe_counts_on_the_card(first_mode):
    from metrics_tpu_torch.ops import engine

    dev = first_mode
    engine.set_device_probe(1)
    m = mt.Accuracy(device=dev)
    p, t = torch.rand(256, device=dev), torch.randint(0, 2, (256,), device=dev)
    m.update(p, t)
    before = engine.engine_stats()["device_probes"]
    for _ in range(3):
        m.update(p, t)
        m.update(p, t)
        m.compute()  # a flush of two entries: one run of the program
    assert engine.engine_stats()["device_probes"] - before == 2  # the first run of its signature is not probed


# ------------------------------------------------------------------ the functional core on the card
@pytest.mark.parametrize("rows, n, length", [(1, 0, 5), (3, 1000, 361), (8, 8192, 32768), (4, 2048, 32769),
                                             (70000, 8, 4), (33, 1, 10**6)])
@pytest.mark.parametrize("shared", [False, True], ids=["per-row ids", "shared ids"])
def test_batched_kernel_equals_its_plain_version(dev, rows, n, length, shared):
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randint(-3, length + 3, (1 if shared else rows, n), generator=g, device=dev)
    w = torch.randint(1, 5, x.shape, generator=g, device=dev).float() * 0.5  # dyadic: every order exact
    for ids in (x, x.to(torch.int32)):
        for weights in (None, w):
            before = histogram.BATCHED_LAUNCHES
            got = histogram.bincount_batched_cuda(ids, length, weights, rows)
            assert histogram.BATCHED_LAUNCHES - before == (1 if rows * length else 0)
            want = histogram._bincount_batched_plain(ids, length, weights, rows)
            assert got.dtype == want.dtype and torch.equal(got, want)


def _batched_boundaries(k):
    """(rows, n, length, shared) at the edges of the batched kernel's regimes, for a largest cluster of ``k``."""
    top, pm, pi = histogram.SHARED_MAX_BINS, histogram.PACKED_ROW_MAX_BINS, histogram.PACKED_MAX_IDS
    return [(2, pi, pm, False), (2, pi + 1, pm, False), (2, pi, pm + 1, True), (4, 4096, 64, False),
            (4, 4095, 64, True), (8, 2**17, 4, False), (4, 2048, k * top, False), (4, 2048, k * top + 1, False),
            (70000, 8, 100, False), (65536, 8, 100, True), (70000, 2, 2100, False), (33, 1, 10**6, False),
            (8, 1, 16384, True), (1, 300000, 7, False), (100, 1000, 1000, True), (132, 16384, 1000, False)]


def test_batched_kernel_at_each_regime_boundary(dev):
    """Every regime's edges (k x 32768 bins and one above, more than 65,535 rows, one id a row, a shared id
    row), int32 and int64 ids, dyadic weights: bit-exact against the plain version, one launch a call."""
    k = histogram.max_cluster(torch.cuda.current_device())
    assert k in (8, 16)
    top = histogram.SHARED_MAX_BINS
    g = torch.Generator(device=dev).manual_seed(17)
    regimes = set()
    for rows, n, length, shared in _batched_boundaries(k):
        regimes.add(histogram.batched_plan(rows, n, length, k).regime)
        x = torch.randint(-3, length + 3, (1 if shared else rows, n), generator=g, device=dev)
        w = torch.randint(1, 5, x.shape, generator=g, device=dev).float() * 0.5
        for ids in (x, x.to(torch.int32)):
            for weights in (None, w):
                before = histogram.BATCHED_LAUNCHES
                got = histogram.bincount_batched_cuda(ids, length, weights, rows)
                assert histogram.BATCHED_LAUNCHES - before == 1
                want = histogram._bincount_batched_plain(ids, length, weights, rows)
                assert got.dtype == want.dtype and torch.equal(got, want), (rows, n, length, shared, ids.dtype)
    assert regimes == {"packed", "cluster", "global"}
    # the cluster regime's shared-memory edge: k x 32768 bins fit k CTAs' slices, one more bin does not
    x = torch.randint(-3, k * top + 3, (4, 2048), generator=g, device=dev)
    plan = histogram.BatchedPlan("cluster", k, 4, histogram._slice_bins(k * top, k))
    assert plan.slice == top
    got = histogram._launch_batched(x, k * top, None, 4, plan)
    assert torch.equal(got, histogram._bincount_batched_plain(x, k * top, None, 4))
    with pytest.raises(RuntimeError, match="failed to launch"):
        histogram._launch_batched(x, k * top + 1, None, 4, plan._replace(slice=top + 4))


@pytest.mark.parametrize("rows, n, length", [(8, 8192, 16384), (33, 1, 10**6), (300, 8, 100), (5, 4096, 40000),
                                             (8, 2**17, 4)])
def test_batched_kernel_under_every_split_of_its_regime(dev, rows, n, length):
    k = histogram.max_cluster(torch.cuda.current_device())
    plan = histogram.batched_plan(rows, n, length, k)
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randint(-3, length + 3, (rows, n), generator=g, device=dev)
    w = torch.randint(1, 5, x.shape, generator=g, device=dev).float() * 0.5
    if plan.regime == "packed":
        plans = [histogram.BatchedPlan("packed", s, -(-rows // s), length) for s in (1, 2, 4, 8, 16, 32, 64, 128)
                 if s * length <= histogram.PACKED_MAX_BINS]
    else:
        plans = [histogram.BatchedPlan(plan.regime, s, plan.grid,
                                       histogram._slice_bins(length, s) if plan.regime == "cluster" else length)
                 for s in (1, 2, 4, 8, 16) if s <= k and (plan.regime == "global" or
                                                          histogram._slice_bins(length, s) <= histogram.SHARED_MAX_BINS)]
    for weights in (None, w):
        want = histogram._bincount_batched_plain(x, length, weights, rows)
        for p in plans:
            assert torch.equal(histogram._launch_batched(x, length, weights, rows, p), want), p


def test_a_refused_batched_launch_raises(dev):
    x = torch.zeros((2, 4), dtype=torch.int64, device=dev)
    before = histogram.BATCHED_LAUNCHES
    for plan in (histogram.BatchedPlan("cluster", 1, 2, 40000), histogram.BatchedPlan("packed", 2, 1, 10000),
                 histogram.BatchedPlan("global", 32, 2, 10)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            histogram._launch_batched(x, plan.slice, None, 2, plan)
    assert histogram.BATCHED_LAUNCHES == before


def test_a_vmapped_bincount_is_one_batched_launch(dev):
    x = torch.randint(0, 16384, (8, 8192), device=dev)
    before, plain = histogram.BATCHED_LAUNCHES, histogram.KERNEL_LAUNCHES
    got = torch.func.vmap(lambda r: histogram.fused_bincount(r, 16384))(x)
    assert histogram.BATCHED_LAUNCHES - before == 1 and histogram.KERNEL_LAUNCHES == plain
    assert torch.equal(got, torch.stack([histogram.fused_bincount(r, 16384) for r in x]))


def _card_suite(c=16):
    return mt.MetricCollection({"acc": mt.Accuracy(num_classes=c, average="macro"),
                                "confmat": mt.ConfusionMatrix(num_classes=c),
                                "precision": mt.Precision(num_classes=c, average="macro")})


def _card_batches(dev, steps=4, n=512, c=16, seed=40):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.softmax(torch.randn(n, c, generator=g, device=dev), 1),
             torch.randint(0, c, (n,), generator=g, device=dev)) for _ in range(steps)]


def _assert_state_trees_equal(a, b):
    for name, states in b.items():
        for key, value in states.items():
            assert torch.equal(a[name][key], value), (name, key)


def test_apply_update_on_the_card_captured_and_vmapped(dev):
    from metrics_tpu_torch.utils import checks

    prev = checks._get_validation_mode()
    checks.set_validation_mode("first")
    try:
        suite, batches = _card_suite(), _card_batches(dev)
        state = suite.init()
        shell = _card_suite()
        for p, t in batches:
            state = suite.apply_update(state, p, t)
            shell.update(p, t)
        _assert_state_trees_equal(state.states, {n: dict(m.metric_state) for n, m in shell.items(keep_base=True)})
        static = suite.init()
        sp, st = batches[0][0].clone(), batches[0][1].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            suite.apply_update(static, sp, st)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new = suite.apply_update(static, sp, st)
            for name, states in static.states.items():
                for key, value in states.items():
                    value.copy_(new.states[name][key])
        for p, t in batches:
            sp.copy_(p)
            st.copy_(t)
            graph.replay()
        torch.cuda.synchronize()
        _assert_state_trees_equal(static.states, state.states)
        stacked = mt.stack_states([suite.init() for _ in batches])
        out = torch.func.vmap(lambda s, p, t: suite.apply_update(s, p, t))(
            stacked, torch.stack([p for p, _ in batches]), torch.stack([t for _, t in batches]))
        for i, (p, t) in enumerate(batches):
            _assert_state_trees_equal(mt.unstack_states(out, len(batches))[i].states,
                                      suite.apply_update(suite.init(), p, t).states)
    finally:
        checks.set_validation_mode(prev)


def test_value_checks_skip_while_a_graph_is_captured(dev):
    from metrics_tpu_torch.utils import checks

    x = torch.ones(4, device=dev)
    assert checks._is_concrete(x)
    seen = []
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        seen.append(checks._is_concrete(x))
        y = x * 2  # noqa: F841
    torch.cuda.current_stream().wait_stream(side)
    assert seen == [False] and checks._is_concrete(x)


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_fused_bootstrapper_on_the_card_equals_its_eager_path(dev, strategy):
    from metrics_tpu_torch.utils import checks

    prev = checks._get_validation_mode()
    checks.set_validation_mode("first")
    try:
        batches = _card_batches(dev, steps=5, n=256)
        for base in (lambda: mt.Accuracy(num_classes=16, average="macro"), lambda: mt.ConfusionMatrix(num_classes=16)):
            fused = mt.BootStrapper(base(), num_bootstraps=8, sampling_strategy=strategy)
            eager = mt.BootStrapper(base(), num_bootstraps=8, sampling_strategy=strategy)
            object.__setattr__(eager, "_boot_ok", False)
            fused.generator.manual_seed(4)
            eager.generator.manual_seed(4)
            for p, t in batches:
                fused.update(p, t)
                eager.update(p, t)
            assert fused._boot_program is not None and fused._boot_ok
            for a, b in zip(fused.metrics, eager.metrics):
                for name in a._defaults:
                    assert torch.equal(getattr(a, name), getattr(b, name)), name
    finally:
        checks.set_validation_mode(prev)


def test_fused_multioutput_and_minmax_on_the_card_equal_their_eager_paths(dev):
    from metrics_tpu_torch.utils import checks

    prev = checks._get_validation_mode()
    checks.set_validation_mode("first")
    try:
        g = torch.Generator(device=dev).manual_seed(9)
        preds = torch.rand(4, 256, 3, generator=g, device=dev)
        target = torch.rand(4, 256, 3, generator=g, device=dev)
        preds[:, ::17, 1] = float("nan")
        fused = mt.MultioutputWrapper(mt.R2Score(), num_outputs=3)
        eager = mt.MultioutputWrapper(mt.R2Score(), num_outputs=3)
        object.__setattr__(eager, "_mo_ok", False)
        for p, t in zip(preds, target):
            fused.update(p, t)
            eager.update(p, t)
        assert fused._mo_program is not None and fused._mo_ok
        for a, b in zip(fused.compute(), eager.compute()):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
        mm = mt.MinMaxMetric(mt.Accuracy(num_classes=3))
        mm_eager = mt.MinMaxMetric(mt.Accuracy(num_classes=3))
        object.__setattr__(mm_eager, "_mm_ok", False)
        for p in preds:
            labels = p.nan_to_num(0).argmax(dim=1)
            a, b = mm(p.nan_to_num(0), labels), mm_eager(p.nan_to_num(0), labels)
            assert torch.equal(a["raw"], b["raw"])
        assert mm._mm_program is not None
        for key, value in mm_eager.compute().items():
            assert torch.equal(mm.compute()[key], value)
    finally:
        checks.set_validation_mode(prev)


# -------------------------------------------------------------- tenant planes
def test_arena_update_is_one_batched_launch_a_chunk_on_the_card(dev):
    """A ConfusionMatrix arena on the card: its vmapped update is one launch of the batched kernel a
    pow2 chunk (100 tenants: 64, 32 and 4), none of the plain one, and its stacked counts equal a CPU
    twin's bit for bit; the stack stays on the card."""
    g = torch.Generator(device=dev).manual_seed(21)
    preds = torch.randint(0, 10, (100, 8), generator=g, device=dev)
    target = torch.randint(0, 10, (100, 8), generator=g, device=dev)
    arena = mt.MetricArena(mt.ConfusionMatrix(num_classes=10), capacity=100, slab=64)
    twin = mt.MetricArena(mt.ConfusionMatrix(num_classes=10, device="cpu"), capacity=100, slab=64)
    ids = arena.add(100)
    twin.add(100)
    before, plain = histogram.BATCHED_LAUNCHES, histogram.KERNEL_LAUNCHES
    arena.update(ids, preds, target)
    assert histogram.BATCHED_LAUNCHES - before == 3 and histogram.KERNEL_LAUNCHES == plain
    twin.update(ids, preds.cpu(), target.cpu())
    for name, leaf in arena._stacked.items():
        assert leaf.is_cuda and torch.equal(leaf.cpu(), twin._stacked[name])
    assert torch.equal(arena.compute().cpu(), twin.compute())


def test_drift_report_counts_with_the_plain_kernel_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(22)
    cur, ref = torch.randn(4096, generator=g, device=dev), torch.randn(4096, generator=g, device=dev) + 0.5
    before = histogram.KERNEL_LAUNCHES
    out = mt.drift_report(cur, ref, bins=32)
    assert histogram.KERNEL_LAUNCHES - before == 2
    twin = mt.drift_report(cur.cpu(), ref.cpu(), bins=32, device="cpu")
    assert out == twin


def test_binned_segment_sum_variant_launches_the_kernel_bit_exact(dev):
    """The autotuner's ``segment_sum`` formulation of the binned counts on the card: two launches of the
    hand kernel (weighted, (T + 1) * C bins) and TP/FP/FN equal to the compare's bit for bit, unsorted
    thresholds included; the sweep holds it to the same contract."""
    from metrics_tpu_torch.ops import autotune, binned

    g = torch.Generator(device=dev).manual_seed(30)
    preds = torch.rand(1000, 100, generator=g, device=dev)
    target = (torch.rand(1000, 100, generator=g, device=dev) < 0.1).to(torch.float32)
    thresholds = torch.rand(37, generator=g, device=dev)
    before = histogram.KERNEL_LAUNCHES
    got = binned._binned_segment_sum(preds, target, thresholds)
    assert histogram.KERNEL_LAUNCHES - before == 2
    for a, b in zip(got, binned._binned_onehot_matmul(preds, target, thresholds)):
        assert torch.equal(a, b)
    autotune.configure(enabled=True, reset=True)
    try:
        rows = {r["variant"]: r for r in autotune.sweep("binned_counts", (preds, target, thresholds))["candidates"]}
        assert rows["segment_sum"]["ok"] and rows["segment_sum"]["exact"] and rows["segment_sum"]["wall_s"] > 0
    finally:
        autotune.configure(reset=True)


def test_a_failed_segment_sum_launch_raises_out_of_the_sweep(dev, monkeypatch):
    """A hand kernel that fails to launch is no verdict on its variant: the sweep and the consult raise,
    and the card never quietly serves the reference's compare instead."""
    from metrics_tpu_torch.ops import autotune

    def failed_launch(*args, **kwargs):
        raise RuntimeError("mt_bincount failed to launch: an injected launch error")

    g = torch.Generator(device=dev).manual_seed(31)
    args = (torch.rand(512, 64, generator=g, device=dev),
            (torch.rand(512, 64, generator=g, device=dev) < 0.1).to(torch.float32), torch.linspace(0, 1, 21, device=dev))
    monkeypatch.setattr(histogram, "_launch", failed_launch)
    autotune.configure(enabled=True, reset=True)
    try:
        with pytest.raises(RuntimeError, match="failed to launch"):
            autotune.sweep("binned_counts", args)
        with pytest.raises(RuntimeError, match="failed to launch"):
            autotune.dispatch("binned_counts", args, sweep_on_miss=True)
        assert autotune.selection_table() == {} and autotune.autotune_stats()["autotune_disqualified"] == 0
    finally:
        autotune.configure(reset=True)
    torch.cuda.synchronize()


def test_the_sweep_times_device_time_not_the_host_gaps(dev):
    """A candidate whose launches wait 2 ms on the host each run is timed by its device work alone."""
    from metrics_tpu_torch.ops import autotune

    x = torch.zeros(1024, device=dev)

    def run():
        time.sleep(0.002)
        x.add_(1.0)

    assert autotune._time_candidate(run, 3, dev) < 5e-4


def test_a_cuda_bincount_never_consults_the_autotuner(dev, monkeypatch):
    from metrics_tpu_torch.ops import autotune

    x = torch.randint(0, 16, (4096,), device=dev)
    autotune.configure(enabled=True, reset=True)
    try:
        autotune._install("bincount", autotune.shape_class(x, 16), "scatter_add")
        monkeypatch.setattr(autotune, "dispatch", lambda *a, **k: pytest.fail("a CUDA bincount consulted"))
        before = histogram.KERNEL_LAUNCHES
        got = histogram.fused_bincount(x, 16)
        assert histogram.KERNEL_LAUNCHES - before == 1 and torch.equal(got, histogram._bincount_plain(x, 16))
    finally:
        autotune.configure(reset=True)


def test_roofline_peaks_calibrate_on_the_card(dev):
    from metrics_tpu_torch.ops import engine

    engine.set_roofline_peaks(None)
    peaks = engine.roofline_peaks()
    assert peaks["calibrated"] and peaks["peak_flops_per_s"] > 1e12 and peaks["peak_bytes_per_s"] > 1e11
    # the ledger counts the hand kernel's bytes itself: ids and weights read, counts written
    x = torch.randint(0, 100, (10_000,), device=dev)
    exe = engine.acquire_keyed(("ledger-bincount-card",), lambda: (lambda state, ids: histogram.fused_bincount(ids, 100)))
    exe(None, x)
    analysis = engine._analyze(exe)
    assert analysis["bytes_accessed"] >= 8 * 10_000 + 4 * 100
    engine.set_roofline_peaks(None)
