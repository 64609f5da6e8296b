"""The port's tenant arena (``metrics_tpu_torch/arena.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through both packages' arenas:
the fused lane (gather, ``torch.func.vmap`` / ``jax.vmap`` of the suite's
update, scatter) for ``Accuracy(2)`` + ``MeanMetric`` and for a
``ConfusionMatrix``; the row lane for AUROC's list states; the lifecycle (ids,
the free list, slab buckets, masked resets); slab saves and restores with a
torn slab falling back to its previous generation; the cohort views
(``cohort_values``, ``close_window``, ``window_values``, ``decay_tick``,
``cohort_drift``); and a JAX arena carried across with
``interop.arena_from_reference``. Counts are compared bit for bit, floats
within atol 1e-6 and rtol 1e-5 (float32 sums of a few dozen terms).
"""
import os
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.arena import MetricArena as JArena
from metrics_tpu.arena import arena_stats as jarena_stats
from metrics_tpu.ops import engine as jengine
from metrics_tpu_torch.arena import arena_stats
from metrics_tpu_torch.interop import arena_from_reference
from metrics_tpu_torch.ops import engine
from metrics_tpu_torch.utils.exceptions import JournalFault

ATOL, RTOL = 1e-6, 1e-5
ROWS = 8


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX engine calls; this file's
    copy of it lets the reference run. The counters of both packages start at zero."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    engine.reset_stats()
    jengine.reset_stats()
    yield


def suites(kind):
    if kind == "acc_mean":
        return (tmt.MetricCollection({"acc": tmt.Accuracy(num_classes=2, device="cpu"), "mean": tmt.MeanMetric(device="cpu")}),
                jmt.MetricCollection({"acc": jmt.Accuracy(num_classes=2), "mean": jmt.MeanMetric()}))
    if kind == "confmat":
        return tmt.ConfusionMatrix(num_classes=5, device="cpu"), jmt.ConfusionMatrix(num_classes=5)
    if kind == "mean":
        return tmt.MeanMetric(device="cpu"), jmt.MeanMetric()
    if kind == "auroc":
        return tmt.AUROC(device="cpu"), jmt.AUROC()
    raise KeyError(kind)


def batch(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "acc_mean":
        return rng.randint(0, 2, (n, ROWS)).astype(np.int32), rng.randint(0, 2, (n, ROWS)).astype(np.int32)
    if kind == "confmat":
        return rng.randint(0, 5, (n, ROWS)).astype(np.int64), rng.randint(0, 5, (n, ROWS)).astype(np.int64)
    if kind == "mean":
        return (rng.rand(n, ROWS).astype(np.float32),)
    if kind == "auroc":
        return rng.rand(n, ROWS).astype(np.float32), rng.randint(0, 2, (n, ROWS)).astype(np.int32)
    raise KeyError(kind)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def assert_trees(mine, ref):
    mine, ref = np_tree(mine), np_tree(ref)
    if isinstance(ref, dict):
        assert set(mine) == set(ref)
        for k in ref:
            assert_trees(mine[k], ref[k])
        return
    assert mine.shape == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(mine, ref)
    else:
        np.testing.assert_allclose(mine, ref, atol=ATOL, rtol=RTOL)


def both(kind, tenants, slab, **kw):
    tm, jm = suites(kind)
    mine = tmt.MetricArena(tm, capacity=tenants, slab=slab, name=f"t_{kind}", **kw)
    ref = JArena(jm, capacity=tenants, slab=slab, name=f"j_{kind}", **kw)
    return mine, ref


def feed(mine, ref, ids, cols):
    mine.update(ids, *[torch.from_numpy(c) for c in cols])
    ref.update(ids, *[jnp.asarray(c) for c in cols])


def content_of(ref):
    """A JAX arena's content as numpy arrays, the form ``arena_from_reference`` takes."""
    out = {"capacity": ref.capacity, "slab": ref.slab_size, "live": ref._live, "counts": ref._counts,
           "cohorts": ref._cohorts.tolist(), "free": list(ref._free), "watermark": ref._watermark,
           "closes": ref._closes, "ring": list(ref._ring)}
    if ref.fused:
        out["stacked"] = {k: np.asarray(v) for k, v in ref._stacked.items()}
    else:
        out["rows"] = [None if r is None else jax.tree.map(np.asarray, r) for r in ref._rows]
    return out


# ------------------------------------------------------------- the fused lane
@pytest.mark.parametrize("kind", ["acc_mean", "confmat"])
def test_fused_lane_equals_the_reference(kind):
    mine, ref = both(kind, 100, 64)
    ids = mine.add(100)
    assert ref.add(100) == ids and mine.capacity == ref.capacity == 128
    feed(mine, ref, ids, batch(kind, 100, 0))
    # 64 + 32 + 4: a ragged count runs the pow2 chunks
    assert arena_stats()["arena_update_chunks"] == jarena_stats()["arena_update_chunks"] == 3
    sub = ids[5:42]
    feed(mine, ref, sub, batch(kind, len(sub), 1))
    assert arena_stats() == {k: v for k, v in jarena_stats().items()}
    assert_trees(mine.compute(), ref.compute())
    assert_trees(mine.compute(sub[::3]), ref.compute(sub[::3]))
    assert_trees(mine.tenant_state(7), ref.tenant_state(7))
    np.testing.assert_array_equal(mine.live_ids(), ref.live_ids())


def test_fused_update_equals_one_suite_a_tenant():
    mine, _ = both("confmat", 6, 4)
    ids = mine.add(6)
    cols = batch("confmat", 6, 3)
    mine.update(ids, *map(torch.from_numpy, cols))
    for i, tid in enumerate(ids):
        single = tmt.ConfusionMatrix(num_classes=5, device="cpu")
        single.update(*(torch.from_numpy(c[i]) for c in cols))
        assert torch.equal(mine.tenant_state(tid)["confmat"], single.confmat)


def test_update_rejects_what_the_reference_rejects():
    mine, ref = both("mean", 4, 4)
    ids = mine.add(3)
    ref.add(3)
    for bad in ([0, 0], [7], []):
        with pytest.raises(ValueError):
            mine.update(bad, torch.ones(len(bad), 1))
        with pytest.raises(ValueError):
            ref.update(bad, jnp.ones((len(bad), 1)))
    mine.remove([ids[1]])
    ref.remove([ids[1]])
    with pytest.raises(ValueError, match="not live"):
        mine.update([ids[1]], torch.ones(1, 1))
    with pytest.raises(ValueError, match="not live"):
        ref.update([ids[1]], jnp.ones((1, 1)))


def test_builds_are_bounded_by_buckets_and_chunks_not_tenants():
    engine.reset_engine()  # the program cache is process-wide: an earlier test may hold these programs
    mine, _ = both("mean", 1, 4)
    b0 = engine.engine_stats()["builds"]
    caps = set()
    for i in range(33):
        (tid,) = mine.add(1)
        mine.update([tid], torch.full((1, ROWS), float(i)))
        caps.add(mine.capacity)
    assert caps == {4, 8, 16, 32, 64}
    # one update program a capacity bucket (a chunk of 1 each time), nothing a tenant
    assert engine.engine_stats()["builds"] - b0 == len(caps)
    report = mine.precompile(torch.zeros(100, ROWS))
    assert set(report["sources"]) == {"arena-update/64", "arena-update/32", "arena-update/4", "arena-compute",
                                      "arena-reset"}


# --------------------------------------------------------------- the row lane
def test_row_lane_equals_the_reference():
    mine, ref = both("auroc", 5, 4)
    assert not mine.fused and not ref.fused
    ids = mine.add(5)
    ref.add(5)
    feed(mine, ref, ids, batch("auroc", 5, 0))
    feed(mine, ref, ids[:3], batch("auroc", 3, 1))
    assert arena_stats()["arena_row_updates"] == jarena_stats()["arena_row_updates"] == 8
    assert_trees(mine.compute(), ref.compute())
    assert mine.precompile()["skipped"] == ref.precompile()["skipped"]
    with pytest.raises(ValueError, match="cat/list"):
        mine.save("unused")


# ---------------------------------------------------------------- lifecycle
def test_lifecycle_ids_free_list_and_slab_buckets_match():
    mine, ref = both("mean", 1, 4)
    for step in [("add", 6, "a"), ("remove", [1, 4]), ("add", 3, "b"), ("remove", [5, 6, 2]), ("add", 1, None),
                 ("remove", [0, 1, 3, 4])]:
        if step[0] == "add":
            assert mine.add(step[1], cohort=step[2]) == ref.add(step[1], cohort=step[2])
        else:
            mine.remove(step[1])
            ref.remove(step[1])
        assert (mine.capacity, mine.tenants, mine.slabs) == (ref.capacity, ref.tenants, ref.slabs)
        assert mine._free == ref._free and mine._watermark == ref._watermark
    assert arena_stats() == jarena_stats()


def test_masked_reset_leaves_the_other_rows_bit_exact():
    mine, ref = both("acc_mean", 8, 8)
    ids = mine.add(8)
    ref.add(8)
    feed(mine, ref, ids, batch("acc_mean", 8, 5))
    before = {k: v.clone() for k, v in mine._stacked.items()}
    mask = np.zeros(8, dtype=bool)
    mask[[1, 6]] = True
    mine.reset(mask)
    ref.reset(mask)
    for k, v in mine._stacked.items():
        assert torch.equal(v[~torch.from_numpy(mask)], before[k][~torch.from_numpy(mask)])
        assert torch.equal(v[torch.from_numpy(mask)], mine._flat_proto[k].expand(2, *v.shape[1:]))
    assert_trees(mine._stacked, {k: np.asarray(v) for k, v in ref._stacked.items()})
    np.testing.assert_array_equal(mine._counts, ref._counts)


# ---------------------------------------------------------------- durability
def test_save_restore_and_a_torn_slab_falls_back(tmp_path):
    mine, ref = both("acc_mean", 12, 4)
    ids = mine.add(12, cohort="c")
    ref.add(12, cohort="c")
    feed(mine, ref, ids, batch("acc_mean", 12, 7))
    path, jpath = str(tmp_path / "arena"), str(tmp_path / "jarena")
    first = {k: v.clone() for k, v in mine._stacked.items()}
    assert mine.save(path) > 0 and ref.save(jpath) > 0
    feed(mine, ref, ids, batch("acc_mean", 12, 8))
    mine.save(path)
    ref.save(jpath)
    assert arena_stats()["arena_slab_saves"] == jarena_stats()["arena_slab_saves"] == 2 * mine.slabs
    for p in (path, jpath):  # tear the newest record of slab 1 in both packages
        with open(f"{p}.slab1", "r+b") as fh:
            fh.seek(40)
            fh.write(b"\xff\xff\xff\xff")
    saved = {k: v.clone() for k, v in mine._stacked.items()}
    fresh, jfresh = both("acc_mean", 4, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, jout = fresh.restore(path), jfresh.restore(jpath)
    assert out == jout == {"slabs": 4, "demotions": 1, "tenants": 12}
    for k, v in fresh._stacked.items():
        assert torch.equal(v[4:8], first[k][4:8])  # slab 1: its previous generation
        assert torch.equal(v[:4], saved[k][:4]) and torch.equal(v[8:], saved[k][8:])
    assert_trees(fresh.compute(), jfresh.compute())
    assert fresh.cohort_of(3) == jfresh.cohort_of(3) == "c"
    with pytest.raises(JournalFault):
        fresh.restore(str(tmp_path / "missing"))


def test_a_layout_mismatch_demotes_and_a_shrink_prunes_stale_slabs(tmp_path):
    path = str(tmp_path / "arena")
    mean, _ = both("mean", 8, 4)
    mean.add(8)
    mean.save(path)
    other = tmt.MetricArena(tmt.SumMetric(device="cpu"), capacity=8, slab=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = other.restore(path)
    assert out["demotions"] == 2 and out["tenants"] == 0
    mean.remove(list(range(4, 8)))
    assert mean.capacity == 4
    mean.save(path)
    assert not os.path.exists(f"{path}.slab1") and arena_stats()["arena_slab_prunes"] == 1


# --------------------------------------------------------------- cohort views
def test_cohort_views_equal_the_reference():
    mine, ref = both("mean", 8, 8)
    a, b = mine.add(5, cohort="a"), mine.add(3, cohort="b")
    ref.add(5, cohort="a")
    ref.add(3, cohort="b")
    feed(mine, ref, a + b, batch("mean", 8, 11))
    assert_trees(mine.cohort_values(), ref.cohort_values())
    for step in range(3):
        feed(mine, ref, a, batch("mean", 5, 20 + step))
        out, jout = mine.close_window(), ref.close_window()
        assert out["window"] == jout["window"] and out["slots"] == jout["slots"]
        assert_trees(out["cohorts"], jout["cohorts"])
    assert_trees(mine.window_values(), ref.window_values())
    feed(mine, ref, b, batch("mean", 3, 30))
    mine.decay_tick(2.0)
    ref.decay_tick(2.0)
    assert_trees(mine._stacked, {k: np.asarray(v) for k, v in ref._stacked.items()})
    drift, jdrift = mine.cohort_drift("a", "b", bins=8), ref.cohort_drift("a", "b", bins=8)
    assert drift["n_current"] == jdrift["n_current"]
    np.testing.assert_allclose([drift["psi"], drift["ks"]], [jdrift["psi"], jdrift["ks"]], rtol=1e-6)
    snap = tmt.telemetry_snapshot()["streaming"]["arenas"][mine.name]
    assert snap["window"] == 3 and set(snap["cohorts"]) == {"a", "b"}


def test_integer_states_refuse_a_decay_in_both_packages():
    mine, ref = both("confmat", 4, 4)
    with pytest.raises(ValueError, match="sum-reduction|floating"):
        mine.decay_tick(2.0)
    with pytest.raises(ValueError, match="sum-reduction|floating"):
        ref.decay_tick(2.0)


# --------------------------------------------------------- carried across
@pytest.mark.parametrize("kind", ["acc_mean", "auroc"])
def test_a_reference_arena_carried_across_goes_on_alike(kind):
    tm, _ = suites(kind)
    _, ref = both(kind, 6, 4)
    ids = ref.add(6, cohort="x")
    ref.remove([ids[2]])
    ids = [i for i in ids if i != ids[2]]
    ref.update(ids, *[jnp.asarray(c) for c in batch(kind, len(ids), 2)])
    if kind == "acc_mean":
        ref.close_window()
        ref.update(ids, *[jnp.asarray(c) for c in batch(kind, len(ids), 3)])
    mine = arena_from_reference(content_of(ref), tm, name="carried")
    assert mine.live_ids().tolist() == ref.live_ids().tolist() and mine.add(1) == ref.add(1)
    more = batch(kind, len(ids) + 1, 4)
    feed(mine, ref, ids + [2], more)
    assert_trees(mine.compute(), ref.compute())
    if kind == "acc_mean":
        assert_trees(mine.window_values(), ref.window_values())


def test_a_collection_arena_equals_one_suite_a_tenant():
    rng = np.random.RandomState(3)
    mine, _ = both("acc_mean", 4, 4)
    ids = mine.add(4)
    oracles = [suites("acc_mean")[0] for _ in range(4)]
    for _ in range(2):
        preds, target = batch("acc_mean", 4, int(rng.randint(1 << 20)))
        mine.update(ids, torch.from_numpy(preds), torch.from_numpy(target))
        for i, m in enumerate(oracles):
            m.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    got = mine.compute(ids)
    for key in got:
        want = torch.stack([m.compute()[key] for m in oracles])
        assert torch.equal(got[key], want), key


def test_a_slab_torn_in_every_generation_resets_to_init(tmp_path):
    path = str(tmp_path / "dead")
    arena = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=4, slab=4, journal_path=path)
    arena.update(arena.add(4), torch.ones(4, 1))
    arena.save()
    with open(f"{path}.slab0", "r+b") as fh:
        fh.write(b"XXXX")  # a foreign magic: the only generation is bad
    twin = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=4, slab=4, journal_path=path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        info = twin.restore()
    assert info["demotions"] == 1 and info["tenants"] == 0


def test_a_shrink_then_save_never_revives_removed_tenants(tmp_path):
    path = str(tmp_path / "shrink")
    arena = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=8, slab=4, journal_path=path)
    ids = arena.add(8)
    arena.update(ids, torch.ones(8, 1))
    arena.save()
    arena.remove(ids[4:])
    arena.save()
    twin = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=4, slab=4, journal_path=path)
    assert twin.restore() == {"slabs": 1, "demotions": 0, "tenants": 4}


def test_knobs_and_the_autosave_cadence(tmp_path, monkeypatch):
    from metrics_tpu import arena as jarena
    from metrics_tpu_torch import arena

    for value in ("64", "0", "not-a-number"):
        monkeypatch.setenv("METRICS_TPU_ARENA_SLAB", value)
        monkeypatch.setenv("METRICS_TPU_ARENA_JOURNAL_EVERY", value.replace("64", "-3"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert arena.arena_default_slab() == jarena.arena_default_slab()
            assert arena.arena_journal_every() == jarena.arena_journal_every()
    monkeypatch.setenv("METRICS_TPU_ARENA_SLAB", "64")
    assert tmt.MetricArena(tmt.MeanMetric(device="cpu")).capacity == 64
    path = str(tmp_path / "auto")
    auto = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=4, slab=4, journal_path=path, journal_every=2)
    ids = auto.add(2)
    auto.update(ids, torch.ones(2, 1))
    assert not os.path.exists(f"{path}.slab0")
    auto.update(ids, torch.ones(2, 1))
    assert os.path.exists(f"{path}.slab0")


def test_counters_fold_into_the_engine_and_the_snapshot():
    mine, _ = both("mean", 4, 4)
    mine.update(mine.add(2), torch.ones(2, 1))
    stats = engine.engine_stats()
    assert stats["arena_updates"] == 1 and stats["arena_tenants_added"] == 2
    assert set(arena_stats()) == set(jarena_stats())
