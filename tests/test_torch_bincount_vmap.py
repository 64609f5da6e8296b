"""The bincount under ``torch.func.vmap``: the operator ``metrics_tpu_torch::bincount`` and its batched form.

``fused_bincount`` is a ``torch.library.custom_op`` with a fake-tensor shape
rule, the plain version for the CPU and a vmap rule that issues ONE call of
``metrics_tpu_torch::bincount_batched`` for the batch (what ``jax.vmap`` makes
of the JAX package's ``pallas_call``: a grid axis over the batch). Held here,
on the CPU, bit for bit: the vmap rule against a loop of unbatched calls (ids
per row and shared by every row, weighted, out-of-range ids, both sides of
``SHARED_MAX_BINS``, nested vmaps), the batched plain version against the
unbatched one row by row, and the unbatched op against the JAX package's
``fused_bincount`` on the same ids. The card's batched kernel is held to the
batched plain version in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from metrics_tpu.ops import histogram as jhist
from metrics_tpu_torch.ops import histogram

SMB = histogram.SHARED_MAX_BINS


def ids(seed, shape, length, lo=-3):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(lo, length + 3, size=shape).astype(np.int64))


def weights(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed + 1).rand(*shape).astype(np.float32))


def loop(rows_x, length, rows_w=None):
    return torch.stack([histogram.fused_bincount(x, length, None if rows_w is None else w)
                        for x, w in zip(rows_x, rows_w if rows_w is not None else [None] * len(rows_x))])


@pytest.mark.parametrize("length", [1, 7, 361, SMB, SMB + 1], ids=lambda v: f"L{v}")
@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weighted"])
def test_vmap_rule_equals_a_loop_of_unbatched_calls(length, weighted):
    x = ids(length, (5, 300), length)
    w = weights(length, (5, 300)) if weighted else None
    got = torch.func.vmap(lambda a, b: histogram.fused_bincount(a, length, b))(x, w) if weighted else \
        torch.func.vmap(lambda a: histogram.fused_bincount(a, length))(x)
    want = loop(x, length, w)
    assert got.dtype == want.dtype == (torch.float32 if weighted else torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("length", [9, SMB + 1], ids=lambda v: f"L{v}")
def test_ids_shared_by_every_row_with_batched_weights(length):
    x = ids(3, (200,), length)
    w = weights(3, (4, 200))
    got = torch.func.vmap(lambda b: histogram.fused_bincount(x, length, b))(w)
    assert torch.equal(got, loop([x] * 4, length, w))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.int16])
def test_vmapped_ids_of_every_integer_dtype_and_rank(dtype):
    x = ids(5, (3, 4, 25), 10).to(dtype)  # rows of (4, 25): flattened as the unbatched call flattens
    got = torch.func.vmap(lambda a: histogram.fused_bincount(a, 10))(x)
    assert torch.equal(got, loop(x, 10))


def test_batch_on_another_axis_and_nested_vmaps():
    x = ids(7, (6, 3, 50), 12)
    inner = torch.func.vmap(lambda r: histogram.fused_bincount(r, 12))
    got = torch.func.vmap(inner, in_dims=1)(x)  # the outer batch on axis 1
    want = torch.stack([loop(x[:, j], 12) for j in range(3)])
    assert torch.equal(got, want)
    w = weights(7, (4, 50))
    shared = x[0, 0]
    got = torch.func.vmap(lambda b: torch.func.vmap(lambda r: histogram.fused_bincount(r, 12, b))(x[0]))(w)
    want = torch.stack([loop(x[0], 12, [b] * 6) for b in w])
    assert torch.equal(got, want)
    assert shared.shape == (50,)


def test_one_batched_call_per_vmapped_call(monkeypatch):
    calls = []
    real = histogram._bincount_batched_plain
    monkeypatch.setattr(histogram, "_bincount_batched_plain",
                        lambda *a: calls.append(a[3]) or real(*a))
    torch.func.vmap(lambda r: histogram.fused_bincount(r, 16))(ids(1, (9, 40), 16))
    assert calls == [9]


@pytest.mark.parametrize("rows, n, length, shared", [(1, 0, 5, False), (3, 1, 4, True), (4, 100, SMB + 1, False),
                                                     (2, 64, 1, True)])
@pytest.mark.parametrize("weighted", [False, True], ids=["counts", "weighted"])
def test_batched_plain_version_row_by_row(rows, n, length, shared, weighted):
    x = ids(rows + n, (1 if shared else rows, n), length)
    w = weights(n, x.shape) if weighted else None
    got = histogram._bincount_batched_plain(x, length, w, rows)
    assert got.shape == (rows, length)
    for r in range(rows):
        xr = x[0 if shared else r]
        want = histogram._bincount_plain(xr, length, None if w is None else w[0 if shared else r])
        assert torch.equal(got[r], want)


def test_the_operator_has_a_fake_shape_rule():
    with FakeTensorMode() as mode:
        x = mode.from_tensor(ids(0, (40,), 6))
        out = histogram.fused_bincount(x, 6)
        assert out.shape == (6,) and out.dtype == torch.int32
        out = histogram.fused_bincount(x, 6, mode.from_tensor(weights(0, (40,))))
        assert out.dtype == torch.float32
        batched = torch.ops.metrics_tpu_torch.bincount_batched(mode.from_tensor(ids(0, (1, 40), 6)), 6, None, 3)
        assert batched.shape == (3, 6)


@pytest.mark.parametrize("length", [16, 1000], ids=lambda v: f"L{v}")
def test_the_operator_equals_the_reference_on_the_same_ids(length):
    rng = np.random.RandomState(length)
    x = rng.randint(-2, length + 2, size=512)
    w = rng.rand(512).astype(np.float32)
    assert np.array_equal(np.asarray(jhist.fused_bincount(jnp.asarray(x), length)),
                          histogram.fused_bincount(torch.from_numpy(x), length).numpy())
    np.testing.assert_allclose(histogram.fused_bincount(torch.from_numpy(x), length, torch.from_numpy(w)).numpy(),
                               np.asarray(jhist.fused_bincount(jnp.asarray(x), length, jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    vmapped = torch.func.vmap(lambda r: histogram.fused_bincount(r, length))(torch.from_numpy(x).reshape(4, 128))
    for r in range(4):
        assert np.array_equal(np.asarray(jhist.fused_bincount(jnp.asarray(x.reshape(4, 128)[r]), length)),
                              vmapped[r].numpy())


def test_a_cuda_tensor_never_takes_the_plain_version():
    # the plain version serves CPU tensors only: the batched CUDA wrapper checks its device and raises
    with pytest.raises(ValueError, match="CUDA tensor"):
        histogram.bincount_batched_cuda(ids(0, (2, 5), 4), 4, None, 2)
    with pytest.raises(ValueError, match="shape"):
        histogram._row_stride(torch.zeros(3, 5), 2, "ids")


# ------------------------------------------------------------ the batched kernel's plan (no card needed)
PLAN_SHAPES = [(8, 8192, 128**2), (33, 1, 10**6), (65536, 8, 100), (32, 8, 100), (100, 1000, 1000), (1, 0, 5),
               (3, 1000, 361), (70000, 16, 4), (2, 2048, 2048), (2, 2049, 2048), (2, 2048, 2049), (8, 8192, SMB),
               (8, 8192, SMB + 1), (4, 2048, 16 * SMB), (4, 2048, 16 * SMB + 1), (4, 2048, 8 * SMB + 1),
               (1, 300000, 7), (3, 1, 1), (200000, 4, 3), (70000, 2, 10**5), (4, 4096, 64), (4, 4095, 64),
               (8, 2**17, 4), (132, 16384, 1000), (4, 64 * 16 * SMB, 16 * SMB)]


@pytest.mark.parametrize("max_cluster", [16, 8], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("rows, n, length", PLAN_SHAPES, ids=lambda v: str(v))
def test_the_batched_plan_covers_every_row_bin_and_id_once(rows, n, length, max_cluster):
    plan = histogram.batched_plan(rows, n, length, max_cluster)
    assert 1 <= plan.grid <= histogram.MAX_GRID
    counted = [r for slot in range(plan.grid) for r in plan.rows_of(slot, rows)]
    assert sorted(counted) == list(range(rows))  # every row once, the grid's row loop included
    if plan.regime == "packed":
        assert plan.split * length <= histogram.PACKED_MAX_BINS and plan.slice == length
        assert plan.smem_bytes == 4 * plan.split * length <= 64 * 1024
        assert plan.split == 1 or -(-rows // plan.split) >= histogram.MIN_BLOCKS
        return
    assert plan.split in (1, 2, 4, 8, 16) and plan.split <= max_cluster
    bins = [b for r in range(plan.split) for b in plan.bins_of(r, length)]
    assert sorted(bins) == list(range(length))  # the cluster's CTAs zero every bin of the row once
    ids = [plan.ids_of(r, n) for r in range(plan.split)]
    assert ids[0].start == 0 and ids[-1].stop == n  # ... and count its ids in order, without a gap or an overlap
    assert all(a.stop == b.start for a, b in zip(ids, ids[1:]))
    if plan.regime == "cluster":
        assert plan.slice % histogram.SLICE_ALIGN == 0 and plan.slice <= SMB and plan.smem_bytes <= 4 * SMB
        assert n >= histogram.CLUSTER_IDS_PER_BIN * length
    else:
        assert plan.smem_bytes == 0 and plan.slice == length
        assert histogram._slice_bins(length, max_cluster) > SMB or n < histogram.CLUSTER_IDS_PER_BIN * length


@pytest.mark.parametrize("rows, n, length, regime, split", [
    (8, 8192, 128**2, "global", 8), (33, 1, 10**6, "global", 16), (65536, 8, 100, "packed", 64),
    (100, 1000, 1000, "packed", 1), (132, 16384, 1000, "packed", 1), (8, 2**17, 4, "cluster", 16),
    (4, 4096, 64, "cluster", 1), (4, 4095, 64, "global", 1), (8, 8192, 16 * SMB, "global", 16),
    (4, 64 * 16 * SMB, 16 * SMB, "cluster", 16), (4, 64 * (16 * SMB + 1), 16 * SMB + 1, "global", 16),
])
def test_the_batched_plan_of_the_path_shapes(rows, n, length, regime, split):
    plan = histogram.batched_plan(rows, n, length)
    assert (plan.regime, plan.split) == (regime, split)
    assert histogram.batched_plan(4, 64 * (8 * SMB + 1), 8 * SMB + 1, max_cluster=8).regime == "global"
    with pytest.raises(ValueError, match="rows >= 1"):
        histogram.batched_plan(0, 5, 5)


def test_the_vmap_rule_keeps_its_call_shapes(monkeypatch):
    """A vmapped call over ids of (9, 40) and a shared id row with batched weights give the batched operator
    the same operands as before: (rows, n) or (1, n) ids, their weights, and the row count."""
    seen = []
    real = histogram._bincount_batched_plain
    monkeypatch.setattr(histogram, "_bincount_batched_plain",
                        lambda x, length, w, rows: seen.append((tuple(x.shape), length, None if w is None
                                                                 else tuple(w.shape), rows)) or real(x, length, w, rows))
    torch.func.vmap(lambda r: histogram.fused_bincount(r, 16))(ids(1, (9, 40), 16))
    torch.func.vmap(lambda b: histogram.fused_bincount(ids(2, (40,), 16), 16, b))(weights(2, (3, 40)))
    assert seen == [((9, 40), 16, None, 9), ((1, 40), 16, (3, 40), 3)]
