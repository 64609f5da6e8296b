"""The port's functional core (``metrics_tpu_torch/functional_core.py``) against the JAX package's.

The contracts of JAX's ``tests/bases/test_functional_core.py``, ported (its
sharding, donation and streaming cases are not: the port has no sharding
plane yet, donates nothing and has no streaming plane): ``init`` /
``apply_update`` / ``apply_compute`` equal the stateful path bit for bit; the
epoch rides the tree spec; a stale tree fails at ``host_handoff`` with the
shell intact; the in-graph merge equals the host sync in a real two-process
Gloo world with no host collective; a merged hand-back serves without a
second merge; one export build per configuration. Then parity with JAX's own
functions on the same numpy inputs (counts bit for bit, floats within atol
1e-6 and rtol 1e-5, float32 sums of a few dozen terms), a JAX state tree
carried across (``interop.funcstate_from_reference``), ``torch.func.vmap``
over ``apply_update`` (Accuracy, ConfusionMatrix, R2Score, the headline
suite) against JAX's ``jax.vmap`` of its own, and the value checks skipped
under a transform (:func:`metrics_tpu_torch.utils.checks._is_concrete`).
"""
import copy
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch import functional_core
from metrics_tpu_torch.functional_core import FuncState, funcore_stats
from metrics_tpu_torch.interop import funcstate_from_reference
from metrics_tpu_torch.ops import engine, telemetry
from metrics_tpu_torch.parallel import collective_stats
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils import checks
from metrics_tpu_torch.utils.exceptions import EpochFault, SyncConfigFault
from tests.helpers.torch_sync import (
    SpecProbe,
    TorchFakeGather,
    funcore_world_worker,
    headline_suite,
    probe_rows,
    run_world,
    suite_batches,
)

ATOL, RTOL = 1e-6, 1e-5
DIST_ON = lambda: True  # noqa: E731
C = 8


@pytest.fixture(autouse=True)
def _clean_world(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX engine calls; this file's
    copy of it lets the reference run. Validation mode "first" on both sides, the membership registry
    and the counters clean, and everything put back after."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    prev = checks._get_validation_mode(), jax_checks._get_validation_mode()
    checks.set_validation_mode("first")
    jax_checks.set_validation_mode("first")
    psync.reset_membership()
    engine.reset_stats()
    yield
    psync.reset_membership()
    engine.reset_stats()
    checks.set_validation_mode(prev[0])
    jax_checks.set_validation_mode(prev[1])


def cls_data(n=64, c=C, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.rand(n, c).astype(np.float32)
    return (logits / logits.sum(axis=1, keepdims=True)).astype(np.float32), rng.randint(0, c, size=n)


def bin_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, size=n)


def reg_data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)


def t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def assert_close(expected, got):
    """A JAX leaf (or tree) against the port's: counts bit for bit, floats within ATOL/RTOL."""
    if isinstance(expected, dict):
        assert sorted(expected) == sorted(got), (sorted(expected), sorted(got))
        for k in expected:
            assert_close(expected[k], got[k])
        return
    if isinstance(expected, (list, tuple)):
        assert len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_close(e, g)
        return
    e, g = np.asarray(expected), got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    if np.issubdtype(e.dtype, np.floating):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)
    else:
        assert str(e.dtype) == str(g.dtype), (e.dtype, g.dtype)
        np.testing.assert_array_equal(g, e)


def assert_trees_equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


CASES = {
    "accuracy": (lambda pkg, **d: pkg.Accuracy(num_classes=C, **d), [cls_data(seed=s) for s in range(3)]),
    "mean": (lambda pkg, **d: pkg.MeanMetric(**d), [(np.asarray([float(s), float(s) + 2.0], np.float32),)
                                                     for s in range(3)]),
    "auroc-cat-lists": (lambda pkg, **d: pkg.AUROC(pos_label=1, **d), [bin_data(seed=s) for s in range(3)]),
    "cat": (lambda pkg, **d: pkg.CatMetric(**d), [(np.arange(4.0, dtype=np.float32) + s,) for s in range(3)]),
    "confmat": (lambda pkg, **d: pkg.ConfusionMatrix(num_classes=C, **d), [cls_data(seed=s) for s in range(3)]),
    "r2": (lambda pkg, **d: pkg.R2Score(**d), [reg_data(seed=s) for s in range(3)]),
    "headline": (lambda pkg, **d: headline_suite(pkg, num_classes=C), [cls_data(seed=s) for s in range(3)]),
}


def port(name):
    build, batches = CASES[name]
    return (build(tmt) if name == "headline" else build(tmt, device="cpu")), batches


def reference(name):
    build, batches = CASES[name]
    return build(jmt), batches


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("name", ["accuracy", "mean", "auroc-cat-lists", "cat"])
def test_apply_equals_the_stateful_path_bit_for_bit(name):
    m, batches = port(name)
    state = m.init()
    assert isinstance(state, FuncState)
    for batch in batches:
        state = m.apply_update(state, *t(batch))
    value = m.apply_compute(state)
    oracle, _ = port(name)
    for batch in batches:
        oracle.update(*t(batch))
    assert torch.equal(value, oracle.compute())


@pytest.mark.parametrize("name", ["accuracy", "confmat", "r2", "mean", "cat", "headline"])
def test_apply_equals_the_reference(name):
    tm, batches = port(name)
    jm, _ = reference(name)
    ts, js = tm.init(), jm.init()
    for batch in batches:
        ts = tm.apply_update(ts, *t(batch))
        js = jm.apply_update(js, *j(batch))
    assert_close(js.states, ts.states)
    assert_close(jm.apply_compute(js), tm.apply_compute(ts))


@pytest.mark.parametrize("name", ["accuracy", "headline"])
def test_a_reference_tree_carried_across_computes_the_reference_value(name):
    tm, batches = port(name)
    jm, _ = reference(name)
    js = jm.init()
    for batch in batches:
        js = jm.apply_update(js, *j(batch))
    states_np = jax.tree.map(np.asarray, js.states)
    ts = funcstate_from_reference(states_np, epoch=psync.world_epoch(), device="cpu")
    assert isinstance(ts, FuncState) and ts.epoch == psync.world_epoch()
    assert_close(jm.apply_compute(js), tm.apply_compute(ts))
    tm.host_handoff(ts)
    assert_close(jm.apply_compute(js), tm.compute())


def test_vmapped_update_equals_separate_updates():
    m, _ = port("accuracy")
    batches = [cls_data(seed=s) for s in range(3)]
    step = torch.func.vmap(lambda s, p, y: m.apply_update(s, p, y))
    stacked = tmt.stack_states([m.init() for _ in range(3)])
    stacked = step(stacked, torch.stack([t(b)[0] for b in batches]), torch.stack([t(b)[1] for b in batches]))
    for i, batch in enumerate(batches):
        oracle, _ = port("accuracy")
        oracle.update(*t(batch))
        assert torch.equal(m.apply_compute(tmt.unstack_states(stacked, 3)[i]), oracle.compute())


@pytest.mark.parametrize("name", ["accuracy", "confmat", "r2", "headline"])
def test_vmap_over_apply_update_equals_the_loop_and_the_reference_vmap(name):
    tm, batches = port(name)
    jm, _ = reference(name)
    k = len(batches)
    stacked_inputs = [np.stack([b[i] for b in batches]) for i in range(len(batches[0]))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no batching rule missing: no per-row fallback loop
        got = torch.func.vmap(lambda s, *a: tm.apply_update(s, *a))(
            tmt.stack_states([tm.init() for _ in range(k)]), *[torch.from_numpy(a) for a in stacked_inputs])
    rows = tmt.unstack_states(got, k)
    for i, batch in enumerate(batches):
        assert_trees_equal(rows[i], tm.apply_update(tm.init(), *t(batch)))
    js = jax.vmap(lambda s, *a: jm.apply_update(s, *a))(
        jax.tree.map(lambda x: jnp.stack([x] * k), jm.init()), *[jnp.asarray(a) for a in stacked_inputs])
    assert_close(js.states, got.states)


def test_compute_group_collection_parity():
    def suite():
        return tmt.MetricCollection(
            {"acc": tmt.Accuracy(num_classes=C, device="cpu"),
             "prec": tmt.Precision(num_classes=C, average="macro", device="cpu")},
            compute_groups=True,
        )

    s = suite()
    state = s.init()
    for seed in range(3):
        state = s.apply_update(state, *t(cls_data(seed=seed)))
    values = s.apply_compute(state)
    oracle = suite()
    for seed in range(3):
        oracle.update(*t(cls_data(seed=seed)))
    expected = oracle.compute()
    assert set(values) == set(expected) == {"acc", "prec"}
    for key in expected:
        assert torch.equal(values[key], expected[key])


def test_collection_naming_and_per_member_kwargs():
    s = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "total": tmt.SumMetric(device="cpu")},
                             prefix="p_", postfix="_q")
    state = s.apply_update(s.init(), torch.tensor([1.0, 3.0]), weight=torch.tensor([1.0, 3.0]))
    values = s.apply_compute(state)
    assert sorted(values) == ["p_mean_q", "p_total_q"]
    assert float(values["p_mean_q"]) == 2.5 and float(values["p_total_q"]) == 4.0


# --------------------------------------------------------------- epoch fence
def test_init_stamps_live_epoch():
    assert tmt.MeanMetric(device="cpu").init().epoch == psync.world_epoch()


def test_epoch_is_static_tree_spec_metadata():
    """A restamped tree has another spec: the epoch is the node's static context, as JAX's treedef."""
    state = tmt.SumMetric(device="cpu").init()
    leaves, spec = pytree.tree_flatten(state)
    assert len(leaves) == 1
    _, bumped_spec = pytree.tree_flatten(state.with_epoch(state.epoch + 1))
    assert spec != bumped_spec
    mapped = pytree.tree_map(lambda x: x + 1, state.with_epoch(state.epoch + 1))
    assert isinstance(mapped, FuncState) and mapped.epoch == state.epoch + 1 and float(mapped.states["value"]) == 1.0


def test_stale_handoff_classifies_epoch_fault():
    m = tmt.SumMetric(device="cpu")
    state = m.apply_update(m.init(), torch.tensor([3.0]))
    trips = collective_stats()["sync_epoch_fence_trips"]
    psync.bump_epoch("simulated membership transition")
    with pytest.raises(EpochFault):
        m.host_handoff(state)
    assert collective_stats()["sync_epoch_fence_trips"] == trips + 1
    assert float(m.compute()) == 0.0  # nothing landed
    m.host_handoff(state.with_epoch(psync.world_epoch()))
    assert float(m.compute()) == 3.0


# ------------------------------------------------------------- in-graph merge
@pytest.fixture(scope="module")
def merge_world():
    return run_world(funcore_world_worker, 2, 90, timeout=120.0)


def test_in_graph_merge_equals_sync_pytree_with_no_host_collective(merge_world):
    for rank in merge_world:
        assert rank["host_collectives"] == 0
        assert rank["suite_collectives"] == sum(len(s) for s in rank["local"].values())
        assert rank["probe_collectives"] == len(rank["probe_local"])  # one a state, the cat list included
        for name, states in rank["synced"].items():
            for key, want in states.items():
                got = rank["merged"][name][key]
                if isinstance(want, list):
                    want, got = want[0], got[0]
                if key == "s_mean":
                    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
                else:
                    assert got.dtype == want.dtype and torch.equal(got, want), (name, key)


def test_every_rank_computes_the_merged_value_by_every_axis_form(merge_world):
    first = merge_world[0]
    for rank in merge_world:
        for key, value in first["values"].items():
            assert torch.equal(rank["values"][key], value) and torch.equal(rank["mesh_values"][key], value)
        for key, value in first["probe_values"].items():
            assert torch.equal(rank["probe_values"][key], value)
            assert torch.equal(rank["mesh_dim_values"][key], value)
    probe = first["probe_values"]
    local = [r["probe_local"] for r in merge_world]
    assert torch.equal(probe["s_sum"], local[0]["s_sum"] + local[1]["s_sum"])
    assert torch.equal(probe["s_max"], torch.maximum(local[0]["s_max"], local[1]["s_max"]))
    assert torch.equal(probe["stacked"], torch.stack([local[0]["stacked"], local[1]["stacked"]]))
    assert torch.equal(probe["rows"], torch.cat(local[0]["rows"] + local[1]["rows"]))


def test_in_graph_merge_equals_the_host_sync_oracle(merge_world):
    """The zero-host-round-trip claim: the merged value of each rank equals one instance synced through
    the host gather path over both ranks' states (JAX's ``_FakeGather`` oracle)."""
    ranks = []
    for rank in range(2):
        suite = headline_suite(tmt)
        for preds, target in suite_batches(90 + rank, 2):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
        ranks.append(suite)
    for name in ("acc", "confmat", "f1", "precision"):
        members = [r[name] for r in ranks]
        with members[0].sync_context(dist_sync_fn=TorchFakeGather(members), distributed_available=DIST_ON):
            host_value = members[0].compute()
        assert torch.equal(merge_world[0]["values"][name], host_value), name
    probe = SpecProbe()
    for row in probe_rows(90, 0):
        probe.update(torch.from_numpy(row))
    assert torch.equal(merge_world[0]["probe_local"]["s_sum"], probe.s_sum)


@pytest.mark.parametrize("axis", ["dp", 3], ids=["a mesh-axis string", "an int"])
def test_an_axis_name_that_is_not_a_group_raises_naming_the_three_forms(axis):
    m = tmt.SumMetric(device="cpu")
    state = m.apply_update(m.init(), torch.tensor([1.0]))
    with pytest.raises(SyncConfigFault, match="ProcessGroup.*DeviceMesh.*DeviceMesh, dim_name"):
        m.apply_compute(state, axis_name=axis)


# ------------------------------------------------------------- handoff seam
def test_merged_handoff_serves_without_resync():
    m = tmt.SumMetric(device="cpu")
    state = m.apply_update(m.init(), torch.tensor([5.0]))
    out = m.host_handoff(state)
    assert out is m and m._is_synced
    peer = tmt.SumMetric(device="cpu")
    peer.update(torch.tensor([5.0]))
    with m.sync_context(dist_sync_fn=TorchFakeGather([m, peer]), distributed_available=DIST_ON):
        assert float(m.compute()) == 5.0  # served as landed: no gather, no second merge
    m.unsync()  # an idempotent restore of the same tree
    assert not m._is_synced and float(m.compute()) == 5.0


def test_unmerged_handoff_leaves_sync_armed():
    m = tmt.SumMetric(device="cpu")
    state = m.apply_update(m.init(), torch.tensor([2.0]))
    m.host_handoff(state, merged=False)
    assert not m._is_synced and m._cache is None
    peer = tmt.SumMetric(device="cpu")
    peer.update(torch.tensor([3.0]))
    with m.sync_context(dist_sync_fn=TorchFakeGather([m, peer]), distributed_available=DIST_ON):
        assert float(m.compute()) == 5.0  # a per-rank partial: the host sync merges
    m.update(torch.tensor([0.0]))
    assert float(m.compute()) == 2.0


def test_collection_handoff():
    suite = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "total": tmt.SumMetric(device="cpu")})
    state = suite.apply_update(suite.init(), torch.tensor([2.0, 4.0]))
    before = funcore_stats()
    suite.host_handoff(state)
    after = funcore_stats()
    assert after["funcore_handoffs"] - before["funcore_handoffs"] == 1
    assert after["funcore_handoff_nodes"] - before["funcore_handoff_nodes"] == 2
    values = suite.compute()
    assert float(values["mean"]) == 3.0 and float(values["total"]) == 6.0


def test_a_merged_suite_handoff_issues_no_collective_in_a_world_that_syncs(monkeypatch):
    from metrics_tpu_torch import metric as metric_mod

    suite = headline_suite(tmt)
    state = suite.apply_update(suite.init(), *t(cls_data(c=6)))
    monkeypatch.setattr(metric_mod, "_dist_available", DIST_ON)
    before = collective_stats()["sync_collectives_issued"]
    suite.host_handoff(state)
    values = suite.compute()
    assert collective_stats()["sync_collectives_issued"] == before
    for key, value in suite.apply_compute(state).items():
        assert torch.equal(values[key], value)


def test_handoff_flushes_queued_calls_first_and_cancels_a_pending_sync():
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    m.update(torch.tensor([1.0]))  # a seen signature under mode "first": queued
    assert m.__dict__.get("_defer_pending") is not None

    class Pending:
        cancelled = False

        def cancel(self):
            Pending.cancelled = True

    object.__setattr__(m, "_pending_sync", Pending())
    before = funcore_stats()["funcore_handoff_sync_cancels"]
    m.host_handoff(m.apply_update(m.init(), torch.tensor([7.0])))
    assert m.__dict__.get("_defer_pending") is None and m.__dict__.get("_pending_sync") is None
    assert Pending.cancelled and funcore_stats()["funcore_handoff_sync_cancels"] == before + 1
    assert float(m.compute()) == 7.0  # the queued updates ran before the tree landed, not on top of it


def test_handoff_emits_its_span_and_the_engine_folds_the_counters():
    armed = telemetry.armed
    telemetry.set_telemetry(True)
    try:
        m = tmt.MeanMetric(device="cpu")
        m.host_handoff(m.apply_update(m.init(), torch.tensor([1.0])))
        spans = [s for s in telemetry.spans() if s["site"] == "funcore-handoff"]
        assert spans and spans[-1]["attrs"]["nodes"] == 1 and spans[-1]["attrs"]["merged"] is True
    finally:
        telemetry.set_telemetry(armed)
    stats = engine.engine_stats()
    assert stats["funcore_handoffs"] == 1 and stats["funcore_updates"] == 1
    assert set(funcore_stats()) <= set(tmt.telemetry_snapshot())
    engine.reset_stats()
    assert all(v == 0 for v in funcore_stats().values())


# ------------------------------------------------------------- caching pins
def test_export_built_inside_vmap_stays_concrete():
    """The first export may be built inside ``torch.func.vmap`` (a user's first call is their vmapped
    step): the cached template must hold plain tensors, so that a later host-side ``init()`` works."""
    suite = tmt.MetricCollection({"acc": tmt.Accuracy(num_classes=4, average="macro", device="cpu"),
                                  "prec": tmt.Precision(num_classes=4, average="macro", device="cpu")})
    batches = [cls_data(n=16, c=4, seed=s) for s in range(3)]
    preds = torch.stack([t(b)[0] for b in batches])
    target = torch.stack([t(b)[1] for b in batches])
    torch.func.vmap(lambda p, y: suite.apply_update(suite.init(), p, y).states)(preds, target)
    state = suite.init()
    for leaf in pytree.tree_leaves(state):
        assert type(leaf) is torch.Tensor and not torch._C._functorch.is_functorch_wrapped_tensor(leaf)
    template = suite._funcore_export[1]
    state = suite.apply_update(state, *t(batches[0]))
    assert all(np.isfinite(float(v)) for v in suite.apply_compute(state).values())
    assert template is suite._funcore_export[1]


def test_one_export_build_per_config():
    m = tmt.Accuracy(num_classes=C, device="cpu")
    before = funcore_stats()
    state = m.init()
    for seed in range(5):
        state = m.apply_update(state, *t(cls_data(seed=seed)))
    m.apply_compute(state)
    after = funcore_stats()
    assert after["funcore_exports"] - before["funcore_exports"] == 1
    assert after["funcore_export_hits"] - before["funcore_export_hits"] == 6
    m.persistent(True)  # persistence is not fingerprinted: still cached
    m.init()
    assert funcore_stats()["funcore_exports"] - before["funcore_exports"] == 1
    m.threshold = 0.3  # a hyperparameter is: a new build
    m.init()
    assert funcore_stats()["funcore_exports"] - before["funcore_exports"] == 2


def test_export_cache_dropped_on_clone():
    m = tmt.MeanMetric(device="cpu")
    m.init()
    assert "_funcore_export" in m.__dict__
    assert "_funcore_export" not in copy.deepcopy(m).__dict__


def test_the_template_keeps_inferred_static_attributes_and_nothing_else():
    m = tmt.Accuracy(device="cpu")  # its mode is inferred by the first update
    batch = t(cls_data(c=4))
    state = m.apply_update(m.init(), *batch)
    update_fn = m._funcore_export[1][1]
    template = next(c.cell_contents for c in update_fn.__closure__ if isinstance(c.cell_contents, tmt.Metric))
    assert template.mode is not None and m.__dict__.get("mode") is None  # the owner untouched
    assert template._update_count == 0
    assert all(float(v.sum()) == 0 for v in template.metric_state.values())  # its states back at the defaults
    assert torch.equal(m.apply_compute(state), tmt.Accuracy(device="cpu")(*batch))


# ------------------------------------------------------------- transforms
def test_is_concrete_is_false_under_vmap_and_on_fake_tensors():
    x = torch.ones(3)
    assert checks._is_concrete(x, x)
    seen = []
    torch.func.vmap(lambda r: seen.append(checks._is_concrete(r)) or r)(torch.ones(2, 3))
    assert seen == [False]
    with FakeTensorMode() as mode:
        assert not checks._is_concrete(mode.from_tensor(x))


def test_value_checks_skip_under_vmap_and_keep_the_signature():
    m = tmt.Accuracy(num_classes=4, device="cpu")
    preds = torch.rand(2, 8, 4)
    bad = torch.full((2, 8), 9)  # labels beyond num_classes: an eager update raises
    torch.func.vmap(lambda s, p, y: m.apply_update(s, p, y))(tmt.stack_states([m.init()] * 2), preds, bad)
    with pytest.raises(ValueError, match="highest label"):
        m.apply_update(m.init(), preds[0], bad[0])  # the same signature, checked eagerly


def test_num_classes_inference_needs_concrete_labels():
    m = tmt.Accuracy(device="cpu")
    labels = torch.randint(0, 3, (2, 8))
    with pytest.raises(ValueError, match="num_classes"):
        torch.func.vmap(lambda s, p, y: m.apply_update(s, p, y))(tmt.stack_states([m.init()] * 2), labels, labels)


def test_compositions_and_child_holding_wrappers_do_not_export():
    with pytest.raises(NotImplementedError, match="no states of its own"):
        (tmt.MeanMetric(device="cpu") + tmt.SumMetric(device="cpu")).as_functions()
    wrapper = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=2, remove_nans=False)
    assert wrapper.as_functions()  # a wrapper with an export of its own
    with pytest.raises(NotImplementedError, match="child metrics"):
        functional_core._build_metric_functions(wrapper)  # the base export it replaces


def test_a_hyperparameter_change_bumps_the_fused_version():
    m = tmt.Accuracy(device="cpu")
    v0 = m._fused_version
    m.threshold = 0.5  # the same python scalar again: no change
    assert m._fused_version == v0
    m.threshold = 0.7
    assert m._fused_version == v0 + 1
    m.update(*t(cls_data(c=4)))  # states and inferred private bookkeeping do not count
    m.tp = m.tp + 0
    assert m._fused_version >= v0 + 1
    before = m._fused_version
    m.tp = m.tp + 0
    assert m._fused_version == before
