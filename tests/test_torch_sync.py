"""State sync of the port against the JAX package's per-state sync.

The same numpy data (made from a seed) fills N = 2 and 3 rank instances in
both packages. The JAX ranks sync through ``_FakeGather`` (an emulated
N-rank gather) and the JAX package's per-state protocol; the port's ranks
sync through its coalesced protocol (the N-rank world stood in for its two
collectives, ``tests/helpers/torch_sync.install_world``) and through its
per-state protocol (``TorchFakeGather``). Integers must agree exactly and
floats within atol 1e-6 and rtol 1e-5, as the JAX package's tests hold them.
One real world of two processes (Gloo, on the CPU) syncs the headline suite,
a ``CatMetric``, the curve suite, and the regression and retrieval suites,
and must equal the in-process results. The regression suite (Pearson's
stacked moments, Spearman's ``cat`` rows) and the retrieval suite (``None``
list states of int64 ids) must also equal one instance fed every rank's
batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats
from metrics_tpu_torch.parallel import bucketing
from metrics_tpu_torch.utils.exceptions import MetricsUserError, SyncFault
from tests.helpers.testers import _FakeGather
from tests.helpers.torch_sync import (
    TorchFakeGather,
    cat_rows,
    curve_rows,
    curve_suite,
    gloo_world_worker,
    headline_suite,
    install_world,
    regression_rows,
    regression_suite,
    retrieval_rows,
    retrieval_suite,
    run_world,
    suite_batches,
)

DIST_ON = lambda: True  # noqa: E731
C = 6

# ------------------------------------------------------------------ the probe
# One state of every spec: name -> (shape, or "list" for a list state; spec)
PROBE_STATES = {
    "s_sum": ((3,), "sum"),
    "s_mean": ((3,), "mean"),
    "s_max": ((3,), "max"),
    "s_min": ((3,), "min"),
    "scalar": ((), "sum"),  # a 0-d state
    "scalar_max": ((), "max"),
    "stacked": ((2,), None),
    "custom": ((3,), "custom"),
    "rows": ("list", "cat"),
}
DTYPES = ["bool", "int8", "int32", "int64", "float32", "float64", "bfloat16"]


def _flip_torch(stacked):
    return torch.flip(stacked, [0]).reshape(-1)


def _flip_jax(stacked):
    return jnp.flip(stacked, 0).reshape(-1)


class _TorchProbe(tmt.Metric):
    full_state_update = True

    def __init__(self, dtype, **kwargs):
        super().__init__(device="cpu", **kwargs)
        dt = getattr(torch, dtype)
        for name, (shape, spec) in PROBE_STATES.items():
            if shape == "list":
                self.add_state(name, [], dist_reduce_fx=spec)
            else:
                self.add_state(name, torch.zeros(shape, dtype=dt), dist_reduce_fx=_flip_torch if spec == "custom" else spec)

    def update(self, states):
        dt = self._defaults["s_sum"].dtype
        for name, value in states.items():
            if name == "rows":
                self.rows.extend(torch.from_numpy(v).to(dt) for v in value)
            else:
                setattr(self, name, torch.from_numpy(np.asarray(value)).to(dt))

    def compute(self):
        return self.s_sum


class _JaxProbe(jmt.Metric):
    full_state_update = True

    def __init__(self, dtype, **kwargs):
        super().__init__(**kwargs)
        for name, (shape, spec) in PROBE_STATES.items():
            if shape == "list":
                self.add_state(name, [], dist_reduce_fx=spec)
            else:
                self.add_state(name, jnp.zeros(shape, dtype=dtype), dist_reduce_fx=_flip_jax if spec == "custom" else spec)

    def update(self, states):
        dt = self._defaults["s_sum"].dtype
        for name, value in states.items():
            if name == "rows":
                self.rows.extend(jnp.asarray(v).astype(dt) for v in value)
            else:
                setattr(self, name, jnp.asarray(value).astype(dt))

    def compute(self):
        return self.s_sum


def _values(rng, shape, dtype):
    if dtype == "bool":
        return rng.rand(*shape) > 0.5
    if dtype.startswith("int"):
        return rng.randint(-50, 50, shape).astype(dtype)
    # quarter steps, float32 (numpy has no bfloat16): every sum here is exact in bfloat16 too
    return (rng.randint(-8, 8, shape) * 0.25).astype(np.float32)


def _probe_states(rank: int, dtype: str, rows: bool = True):
    rng = np.random.RandomState(100 + rank)
    out = {name: _values(rng, shape, dtype) for name, (shape, _) in PROBE_STATES.items() if shape != "list"}
    # uneven: rank r appends 1 + r rows of 2 + r values
    out["rows"] = [_values(rng, (2 + rank,), dtype) for _ in range(1 + rank)] if rows else []
    return out


def _make_probes(world, dtype, rows=True):
    jax_ranks, port_ranks = [], []
    for r in range(world):
        states = _probe_states(r, dtype, rows)
        # the JAX package runs without x64: int64 and float64 states hold int32 and float32
        jm = _JaxProbe(jax.dtypes.canonicalize_dtype(jnp.bfloat16 if dtype == "bfloat16" else dtype))
        jm.update(states)
        tm = _TorchProbe(dtype)
        tm.update(states)
        jax_ranks.append(jm)
        port_ranks.append(tm)
    return jax_ranks, port_ranks


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _assert_value(got, want, label):
    if isinstance(want, list) or isinstance(got, list):
        assert isinstance(got, list) and isinstance(want, list) and len(got) == len(want), label
        for g, w in zip(got, want):
            _assert_value(g, w, label)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, f"{label}: shape {g.shape} != {w.shape}"
    if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=label)
    else:
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5, err_msg=label)


def _assert_bit_equal(a, b, label):
    if isinstance(a, list) or isinstance(b, list):
        assert isinstance(a, list) and isinstance(b, list) and len(a) == len(b), label
        for x, y in zip(a, b):
            _assert_bit_equal(x, y, label)
        return
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), label


def _snapshot(m):
    return {k: (list(v) if isinstance(v, list) else v) for k, v in m.metric_state.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", [2, 3])
def test_every_spec_and_dtype_matches_jax(world, dtype, monkeypatch):
    jax_ranks, port_ranks = _make_probes(world, dtype)
    jax_ranks[0].sync(dist_sync_fn=_FakeGather(jax_ranks), distributed_available=DIST_ON)
    want = dict(jax_ranks[0].metric_state)

    # the port's per-state protocol
    per_state = port_ranks[0].clone()
    per_state.sync(dist_sync_fn=TorchFakeGather([per_state] + port_ranks[1:]), distributed_available=DIST_ON)
    # the port's coalesced protocol
    coalesced = port_ranks[0]
    local = _snapshot(coalesced)
    install_world(monkeypatch, port_ranks[1:])
    reset_collective_stats()
    coalesced.sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert (stats["sync_payload_collectives"], stats["sync_shape_collectives"]) == (1, 1)  # the cat state's metadata
    assert stats["sync_states_coalesced"] == len(PROBE_STATES)
    for name in PROBE_STATES:
        _assert_value(getattr(coalesced, name), want[name], f"{name} ({dtype}, world {world}) vs JAX")
        _assert_bit_equal(getattr(coalesced, name), getattr(per_state, name), f"{name}: coalesced vs per-state")
    coalesced.unsync()
    for name, value in local.items():
        after = getattr(coalesced, name)
        assert after == value if isinstance(value, list) else after is value


def test_cat_with_an_empty_rank(monkeypatch):
    """A cat state empty on one rank: the coalesced protocol carries it (the per-state one cannot),
    and the result equals the JAX per-state sync of the other ranks."""
    jax_ranks, port_ranks = [], []
    for r in (1, 2):
        jm, tm = jmt.CatMetric(), tmt.CatMetric(device="cpu")
        for row in cat_rows(7, r):
            jm.update(jnp.asarray(row))
            tm.update(torch.from_numpy(row))
        jax_ranks.append(jm)
        port_ranks.append(tm)
    jax_ranks[0].sync(dist_sync_fn=_FakeGather(jax_ranks), distributed_available=DIST_ON)
    empty = tmt.CatMetric(device="cpu")
    for m, *others in ([empty] + port_ranks, [port_ranks[0], empty, port_ranks[1]]):
        install_world(monkeypatch, others)
        m.sync(distributed_available=DIST_ON)
        _assert_value(m.value, jax_ranks[0].value, "cat with an empty rank")
        m.unsync()
    # empty on every rank: stays empty
    install_world(monkeypatch, [tmt.CatMetric(device="cpu")])
    empty.sync(distributed_available=DIST_ON)
    assert empty.value == []
    empty.unsync()


# ------------------------------------------------------------------ the suites
def _agreement_suite(pkg):
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection(
        {
            "kappa": pkg.CohenKappa(C, **dev),
            "mcc": pkg.MatthewsCorrCoef(C, **dev),
            "jaccard": pkg.JaccardIndex(C, **dev),
            "specificity": pkg.Specificity(num_classes=C, average="macro", **dev),
            "hamming": pkg.HammingDistance(**dev),
        }
    )


def _aggregator_suite(pkg):
    dev = {"device": "cpu"} if pkg is tmt else {}
    names = ("MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "CatMetric")
    return pkg.MetricCollection({n: getattr(pkg, n)(**dev) for n in names}, compute_groups=False)


SUITES = {
    "headline": (headline_suite, [["acc"], ["confmat"], ["f1", "precision"]]),
    "agreement": (_agreement_suite, [["hamming"], ["jaccard", "kappa", "mcc"], ["specificity"]]),
    "aggregators": (_aggregator_suite, None),
    "regression": (regression_suite, [["mse"], ["pearson"], ["r2"], ["spearman"], ["tweedie"]]),
}
WITH_LIST_STATES = ("aggregators", "regression")


def _feed(suite, pkg, rank, seed, kind):
    arr = jnp.asarray if pkg is jmt else torch.from_numpy
    if kind == "regression":
        for preds, target in regression_rows(seed, rank):
            suite.update(arr(preds), arr(target))
        return
    if kind == "retrieval":
        for preds, target, indexes in retrieval_rows(seed, rank):
            suite.update(arr(preds), arr(target), arr(indexes))
        return
    if kind == "aggregators":
        rng = np.random.RandomState(seed + rank)
        for row in cat_rows(seed, rank):
            suite.update(arr(row), weight=arr(rng.rand(row.shape[0]).astype(np.float32)))
        return
    for preds, target in suite_batches(seed + rank, 2 + rank, num_classes=C):
        suite.update(arr(preds), arr(target))


def _jax_per_state_values(jax_suites):
    members = [dict(s.items(keep_base=True, copy_state=False)) for s in jax_suites]
    out = {}
    for name in members[0]:
        ranks = [m[name] for m in members]
        ranks[0].sync(dist_sync_fn=_FakeGather(ranks), distributed_available=DIST_ON)
        out[name] = ranks[0].compute()
        ranks[0].unsync()
    return out


@pytest.mark.parametrize("kind", sorted(SUITES))
@pytest.mark.parametrize("world", [2, 3])
def test_suite_sync_matches_jax(kind, world, monkeypatch):
    make, groups = SUITES[kind]
    jax_suites, port_suites = [make(jmt) for _ in range(world)], [make(tmt) for _ in range(world)]
    for r in range(world):
        _feed(jax_suites[r], jmt, r, 20, kind)
        _feed(port_suites[r], tmt, r, 20, kind)
    want = _jax_per_state_values(jax_suites)
    suite = port_suites[0]
    if groups is not None:
        assert sorted(sorted(g) for g in suite.compute_groups.values()) == groups
    local = {k: _snapshot(m) for k, m in suite.items(keep_base=True, copy_state=False)}
    install_world(monkeypatch, port_suites[1:])
    reset_collective_stats()
    with suite.sync_context(distributed_available=DIST_ON):
        got = suite.compute()
    stats = collective_stats()
    # one payload collective for the whole suite; `cat` states add one metadata collective
    assert stats["sync_payload_collectives"] == 1
    assert stats["sync_shape_collectives"] == (1 if kind in WITH_LIST_STATES else 0)
    assert stats["sync_coalesced_payloads"] == 1
    for name, value in want.items():
        _assert_value(got[name], value, f"{kind} suite, {name}, world {world}")
    # unsynced: the local states, and each compute group shares its leader's tensors again
    members = dict(suite.items(keep_base=True, copy_state=False))
    for name, states in local.items():
        assert not members[name]._is_synced
        for state, value in states.items():
            after = getattr(members[name], state)
            assert after == value if isinstance(value, list) else after is value
    for group in suite.compute_groups.values():
        for state in members[group[0]]._defaults:
            assert all(getattr(members[n], state) is getattr(members[group[0]], state) for n in group[1:])


def test_synced_regression_suite_equals_one_instance_fed_every_batch(monkeypatch):
    """Two ranks synced in the coalesced protocol compute what one process fed both ranks' batches does,
    Pearson's merge of the stacked moments within atol 1e-6 and rtol 1e-5."""
    ranks, every = [regression_suite(tmt) for _ in range(2)], regression_suite(tmt)
    for r in range(2):
        _feed(ranks[r], tmt, r, 90, "regression")
        _feed(every, tmt, r, 90, "regression")
    want = every.compute()
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    with ranks[0].sync_context(distributed_available=DIST_ON):
        assert ranks[0]["pearson"].var_x.shape == (2,)  # one row of moments a rank
        got = ranks[0].compute()
    assert collective_stats()["sync_payload_collectives"] == 1
    for name, value in want.items():
        _assert_value(got[name], value, name)


@pytest.mark.parametrize("cls_name", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalRecall"])
def test_retrieval_rows_sync_row_by_row_like_jax(cls_name):
    """List states of spec None take the per-state protocol in both packages (the coalescer declines
    them): every buffered row is gathered on its own, two collectives a row, and the synced rows come
    batch by batch, each batch's ranks in turn. The port equals JAX's sync, and bit for bit one process
    fed the rows in that order."""
    kwargs = {"k": 3} if cls_name in ("RetrievalNormalizedDCG", "RetrievalRecall") else {}
    jax_ranks = [getattr(jmt, cls_name)(**kwargs) for _ in range(2)]
    port_ranks = [getattr(tmt, cls_name)(device="cpu", **kwargs) for _ in range(2)]
    for r in range(2):
        for preds, target, indexes in retrieval_rows(90, r):
            jax_ranks[r].update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
            port_ranks[r].update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    every = getattr(tmt, cls_name)(device="cpu", **kwargs)
    for step in range(2):
        for r in range(2):
            every.update(*[torch.from_numpy(a) for a in retrieval_rows(90, r)[step]])
    jax_ranks[0].sync(dist_sync_fn=_FakeGather(jax_ranks), distributed_available=DIST_ON)
    reset_collective_stats()
    port_ranks[0].sync(dist_sync_fn=TorchFakeGather(port_ranks), distributed_available=DIST_ON)
    assert [tuple(t.shape) for t in port_ranks[0].indexes] == [tuple(np.asarray(t).shape) for t in jax_ranks[0].indexes]
    assert all(t.dtype == torch.int64 for t in port_ranks[0].indexes)
    got = port_ranks[0].compute()
    _assert_value(got, jax_ranks[0].compute(), cls_name)
    want = every.compute()
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_synced_compute_then_update_and_compute_again(monkeypatch):
    """After a synced compute, the compute groups go on from the local states."""
    suites = [headline_suite(tmt) for _ in range(2)]
    every = headline_suite(tmt)  # one process fed every batch of both ranks
    for r, suite in enumerate(suites):
        for preds, target in suite_batches(30 + r, 2):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
            every.update(torch.from_numpy(preds), torch.from_numpy(target))
    install_world(monkeypatch, suites[1:])
    for step in range(2):
        with suites[0].sync_context(distributed_available=DIST_ON):
            got = suites[0].compute()
        want = every.compute()
        for key, value in want.items():
            assert torch.equal(got[key], value), (step, key)
        preds, target = suite_batches(40 + step, 1)[0]
        suites[0].update(torch.from_numpy(preds), torch.from_numpy(target))
        every.update(torch.from_numpy(preds), torch.from_numpy(target))


# ----------------------------------------------------------- the lifecycle
def test_dist_sync_on_step_forward_syncs_the_batch_value(monkeypatch):
    (p0, t0), (p1, t1) = suite_batches(50, 2)
    m = tmt.F1Score(num_classes=C, average="macro", dist_sync_on_step=True, device="cpu")
    other = tmt.F1Score(num_classes=C, average="macro", device="cpu")
    other.update(torch.from_numpy(p1), torch.from_numpy(t1))  # rank 1's batch state
    jax_batch = jmt.F1Score(num_classes=C, average="macro")(
        jnp.asarray(np.concatenate([p0, p1])), jnp.asarray(np.concatenate([t0, t1]))
    )
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    m.dist_sync_fn = TorchFakeGather([m, other])
    batch_value = m(torch.from_numpy(p0), torch.from_numpy(t0))
    _assert_value(batch_value, jax_batch, "dist_sync_on_step batch value")
    assert not m._is_synced
    local = tmt.F1Score(num_classes=C, average="macro", device="cpu")
    local.update(torch.from_numpy(p0), torch.from_numpy(t0))
    assert torch.equal(m.tp, local.tp)  # the accumulated state stays local


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_state_dict_inside_sync_context_holds_the_reduced_value(pkg):
    mod = jmt if pkg == "jax" else tmt
    dev = {} if pkg == "jax" else {"device": "cpu"}
    arr = jnp.asarray if pkg == "jax" else torch.tensor
    ranks = [mod.SumMetric(**dev) for _ in range(2)]
    for r, m in enumerate(ranks):
        m.persistent(True)
        m.update(arr([2.0 + r]))
    gather = _FakeGather(ranks) if pkg == "jax" else TorchFakeGather(ranks)
    with ranks[0].sync_context(dist_sync_fn=gather, distributed_available=DIST_ON):
        sd = ranks[0].state_dict()
    assert float(np.asarray(sd["value"])) == 5.0
    assert float(ranks[0].value) == 2.0


def test_double_sync_and_unsync_raise_and_forward_refuses_a_synced_metric():
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    m.sync(distributed_available=DIST_ON)
    with pytest.raises(MetricsUserError, match="already been synced"):
        m.sync(distributed_available=DIST_ON)
    with pytest.raises(MetricsUserError, match="shouldn't be synced"):
        m(torch.tensor([1.0]))
    m.unsync()
    with pytest.raises(MetricsUserError, match="un-synced"):
        m.unsync()
    m.sync(distributed_available=lambda: False)  # a world of one: nothing happens
    assert not m._is_synced


def test_sync_flags_are_validated():
    with pytest.raises(ValueError, match="dist_sync_on_step"):
        tmt.SumMetric(device="cpu", dist_sync_on_step=1)
    with pytest.raises(ValueError, match="sync_on_compute"):
        tmt.SumMetric(device="cpu", sync_on_compute="yes")
    with pytest.raises(ValueError, match="dist_sync_fn"):
        tmt.SumMetric(device="cpu", dist_sync_fn=3)
    with pytest.raises(ValueError, match="ProcessGroup"):
        tmt.SumMetric(device="cpu", process_group=[0, 1])


def test_sync_on_compute_false_serves_the_local_value(monkeypatch):
    m, other = tmt.SumMetric(device="cpu", sync_on_compute=False), tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    other.update(torch.tensor([5.0]))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    m.dist_sync_fn = TorchFakeGather([m, other])
    assert float(m.compute()) == 1.0


class _FailingGather(TorchFakeGather):
    def __init__(self, rank_metrics, fail_at):
        super().__init__(rank_metrics)
        self.fail_at = fail_at

    def __call__(self, tensor, group=None):
        if self._call_idx == self.fail_at:
            raise SyncFault("injected transport failure", site="sync-gather")
        return super().__call__(tensor, group)


@pytest.mark.parametrize("fail_at", [0, 3, 6])
def test_a_gather_failing_mid_walk_leaves_the_state_intact(fail_at):
    _, ranks = _make_probes(2, "float32")
    m = ranks[0]
    local = _snapshot(m)
    with pytest.raises(SyncFault, match="injected"):
        m.sync(dist_sync_fn=_FailingGather(ranks, fail_at), distributed_available=DIST_ON)
    assert not m._is_synced and m._cache is None
    for name, value in local.items():
        after = getattr(m, name)
        assert after == value if isinstance(value, list) else after is value


def test_a_failing_payload_collective_leaves_every_member_intact(monkeypatch):
    suites = [headline_suite(tmt) for _ in range(2)]
    for r, suite in enumerate(suites):
        for preds, target in suite_batches(60 + r, 2):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    local = {k: _snapshot(m) for k, m in suites[0].items(keep_base=True, copy_state=False)}

    def broken(packed, group):
        raise SyncFault("injected payload failure", site="sync-gather")

    monkeypatch.setattr(bucketing, "_payload_allgather", broken)
    with pytest.raises(SyncFault, match="injected"):
        suites[0].sync(distributed_available=DIST_ON)
    for name, m in suites[0].items(keep_base=True, copy_state=False):
        assert not m._is_synced
        for state, value in local[name].items():
            assert getattr(m, state) is value


def test_a_member_failing_after_the_suite_packed_rolls_back_every_member(monkeypatch):
    """A member with its own gather syncs after the coalesced members; its failure unsyncs them all."""
    ranks = []
    for r in range(2):
        suite = tmt.MetricCollection(
            {"sum": tmt.SumMetric(device="cpu"), "max": tmt.MaxMetric(device="cpu")}, compute_groups=False
        )
        suite.update(torch.tensor([1.0 + r, 4.0]))
        ranks.append(suite)
    members = [dict(s.items(keep_base=True, copy_state=False)) for s in ranks]
    members[0]["max"].dist_sync_fn = _FailingGather([m["max"] for m in members], fail_at=0)
    install_world(monkeypatch, [m["sum"] for m in members[1:]])
    with pytest.raises(SyncFault, match="injected"):
        ranks[0].sync(distributed_available=DIST_ON)
    assert float(members[0]["sum"].value) == 5.0 and not members[0]["sum"]._is_synced
    assert float(members[0]["max"].value) == 4.0 and not members[0]["max"]._is_synced


# ---------------------------------------------------- a real world of processes
@pytest.fixture(scope="module")
def gloo_world():
    return run_world(gloo_world_worker, 2, 70, timeout=60.0)


def _in_process_world(monkeypatch, seed=70):
    suites, cats = [], []
    for rank in range(2):
        suite = headline_suite(tmt)
        for preds, target in suite_batches(seed + rank, 3):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
        cat = tmt.CatMetric(device="cpu")
        for row in cat_rows(seed, rank):
            cat.update(torch.from_numpy(row))
        suites.append(suite)
        cats.append(cat)
    return suites, cats


def test_two_gloo_processes_equal_the_in_process_sync(gloo_world, monkeypatch):
    suites, cats = _in_process_world(monkeypatch)
    install_world(monkeypatch, suites[1:])
    with suites[0].sync_context(distributed_available=DIST_ON):
        want = suites[0].compute()
    install_world(monkeypatch, cats[1:])
    with cats[0].sync_context(distributed_available=DIST_ON):
        want_cat = cats[0].compute()
    for rank, result in enumerate(gloo_world):
        assert sorted(result["values"]) == sorted(want)
        for key, value in want.items():
            got = result["values"][key]
            assert got.dtype == value.dtype and torch.equal(got, value), (rank, key)
        assert torch.equal(result["cat"], want_cat), rank
    # compute() restored each rank's local states
    assert not torch.equal(gloo_world[0]["local_tp"], gloo_world[1]["local_tp"])


def test_two_gloo_processes_coalesce_the_suite(gloo_world):
    for result in gloo_world:
        # compute(): the suite's first sync checks the static layout once (1 + 1), CatMetric's
        # metadata and payload (1 + 1)
        stats = result["compute_stats"]
        assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (2, 2)
        assert stats["sync_coalesced_payloads"] == 2
        # the layout is cached: every later suite sync is one payload collective
        for counts in result["sync_counts"]:
            assert counts == {"sync_shape_collectives": 0, "sync_payload_collectives": 1}


def test_two_gloo_processes_gather_uneven_shapes(gloo_world):
    for result in gloo_world:
        g = result["gathered"]
        assert [t.tolist() for t in g["uneven"]] == [[0, 1], [0, 1, 2]]
        assert all(t.dtype == torch.int32 for t in g["uneven"])
        assert [t.tolist() for t in g["uneven_2d"]] == [[[0, 0, 0]], [[1, 1], [1, 1]]]
        assert [t.shape for t in g["scalar"]] == [(), ()] and [float(t) for t in g["scalar"]] == [0.5, 1.5]
        assert [t.tolist() for t in g["bool"]] == [[True, False], [True, True]]


def test_two_gloo_processes_sync_pytree_one_collective_a_spec(gloo_world):
    x0, x1 = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([2.0, 4.0, 6.0])
    want = {
        "s": x0 + x1,
        "m": (x0 + x1) / 2,
        "mx": x1,
        "mn": x0,
        "c": torch.cat([x0, x1]),
        "n": torch.stack([x0, x1]),
        "f": (x0 + x1) * 10,
    }
    for result in gloo_world:
        out = result["pytree"]
        for key, value in want.items():
            assert torch.equal(out[key], value), key
        assert len(out["rows"]) == 1 and torch.equal(out["rows"][0], torch.cat([x0, x1]))


def test_two_gloo_processes_sync_mixed_rank_curve_rows(gloo_world):
    """Rows of shapes (n,) and (m, 1) on both ranks: each rank's sync canonicalises them first."""
    every = curve_suite(tmt)
    for rank in range(2):
        for preds, target in curve_rows(70, rank):
            every.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = every.compute()
    for rank, result in enumerate(gloo_world):
        for key, value in want.items():
            np.testing.assert_allclose(result["curves"][key].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"rank {rank}, {key}")


def test_two_gloo_processes_sync_regression_and_retrieval(gloo_world):
    """Each rank's compute() equals one instance fed both ranks' batches; retrieval members sync one by one."""
    for kind, make, rows in (("regression", regression_suite, regression_rows), ("retrieval", retrieval_suite, retrieval_rows)):
        every = make(tmt)
        # in the order the sync leaves the rows: retrieval's batch by batch, regression's rank by rank
        order = [(r, b) for b in range(2) for r in range(2)] if kind == "retrieval" else [(r, b) for r in range(2) for b in range(2)]
        for rank, batch in order:
            every.update(*[torch.from_numpy(a) for a in rows(70, rank)[batch]])
        want = every.compute()
        for rank, result in enumerate(gloo_world):
            for key, value in want.items():
                got = result[kind][key]
                if kind == "retrieval":
                    assert torch.equal(got, value), (rank, key)
                else:
                    np.testing.assert_allclose(got.numpy(), value.numpy(), atol=1e-6, rtol=1e-5, err_msg=f"{rank} {key}")
    for result in gloo_world:
        # the regression suite: one metadata and one payload collective. The four retrieval members
        # leave compute() synced (as in JAX), so each syncs alone, and their list states of spec None
        # take the per-state protocol: a shape and a payload collective a row, 3 states of 2 rows each
        stats = result["new_suite_stats"]
        assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1 + 4 * 6, 1 + 4 * 6)


# ------------------------------------------------------- buffered curve rows
def _feed_curves(suite, pkg, rank, seed):
    arr = jnp.asarray if pkg is jmt else torch.from_numpy
    for preds, target in curve_rows(seed, rank):
        suite.update(arr(preds), arr(target))


@pytest.mark.parametrize("protocol", ["coalesced", "per_state"])
@pytest.mark.parametrize("world", [2, 3])
def test_mixed_rank_curve_rows_sync_matches_jax(world, protocol, monkeypatch):
    """AUROC + AveragePrecision on binary rows of shapes (n,) and (m, 1) mixed within and
    across ranks: the port's sync equals the JAX per-state sync through ``_FakeGather``."""
    jax_suites, port_suites = [curve_suite(jmt) for _ in range(world)], [curve_suite(tmt) for _ in range(world)]
    for r in range(world):
        _feed_curves(jax_suites[r], jmt, r, 80)
        _feed_curves(port_suites[r], tmt, r, 80)
    want = _jax_per_state_values(jax_suites)
    suite = port_suites[0]
    # both members buffer equal rows after the first update: one compute group, as in the JAX package
    assert sorted(sorted(g) for g in suite.compute_groups.values()) == [["ap", "auroc"]]
    assert sorted(sorted(g) for g in jax_suites[0].compute_groups.values()) == [["ap", "auroc"]]
    if protocol == "coalesced":
        install_world(monkeypatch, port_suites[1:])
        reset_collective_stats()
        with suite.sync_context(distributed_available=DIST_ON):
            got = suite.compute()
        stats = collective_stats()
        assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 1)
    else:
        members = [dict(s.items(keep_base=True, copy_state=False)) for s in port_suites]
        got = {}
        for name in members[0]:
            ranks = [m[name] for m in members]
            ranks[0].sync(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
            got[name] = ranks[0].compute()
            ranks[0].unsync()
    for name, value in want.items():
        _assert_value(got[name], value, f"curve suite, {name}, world {world}, {protocol}")
    # unsynced: the local rows, canonical (1-D) now, and still one group
    for member in dict(suite.items(keep_base=True, copy_state=False)).values():
        assert isinstance(member.preds, list) and all(p.ndim == 1 for p in member.preds)


def test_a_single_curve_metric_syncs_mixed_rows_in_one_payload(monkeypatch):
    ranks = [tmt.AUROC(pos_label=1, device="cpu") for _ in range(2)]
    jax_ranks = [jmt.AUROC(pos_label=1) for _ in range(2)]
    for r in range(2):
        for preds, target in curve_rows(90, r):
            ranks[r].update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_ranks[r].update(jnp.asarray(preds), jnp.asarray(target))
    jax_ranks[0].sync(dist_sync_fn=_FakeGather(jax_ranks), distributed_available=DIST_ON)
    want = jax_ranks[0].compute()
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    assert collective_stats()["sync_payload_collectives"] == 1
    assert ranks[0].preds.ndim == 1  # the cat reduction leaves one canonical tensor
    _assert_value(ranks[0].compute(), want, "AUROC synced")
    ranks[0].unsync()
    assert isinstance(ranks[0].preds, list)


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision", "PrecisionRecallCurve", "ROC"])
def test_mixed_rank_rows_in_state_dict_and_pickle_match_jax(name):
    import pickle

    jm, tm = getattr(jmt, name)(pos_label=1), getattr(tmt, name)(pos_label=1, device="cpu")
    for preds, target in curve_rows(95, 1):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    jm.persistent(True)
    tm.persistent(True)
    j_sd, t_sd = jm.state_dict(), tm.state_dict()
    for key in ("preds", "target"):
        assert [tuple(r.shape) for r in t_sd[key]] == [np.asarray(r).shape for r in j_sd[key]]
        for jr, tr in zip(j_sd[key], t_sd[key]):
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    clone = pickle.loads(pickle.dumps(tm))
    assert [tuple(p.shape) for p in clone.preds] == [tuple(p.shape) for p in tm.preds]
    got, want = clone.compute(), jm.compute()
    if isinstance(want, tuple):  # a curve: (x, y, thresholds)
        got, want = list(got), list(want)
    _assert_value(got, want, f"{name} after pickling")


def test_post_sync_state_dict_and_compute_on_the_reduced_cat_state():
    """Inside the sync the rows are one tensor: the hook leaves it, state_dict and compute read it."""
    import pickle

    ranks = [tmt.PrecisionRecallCurve(pos_label=1, device="cpu") for _ in range(2)]
    rng = np.random.RandomState(7)
    for rank in ranks:
        rank.update(torch.from_numpy(rng.rand(16).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 16)))
        rank.persistent(True)
    m = ranks[0]
    with m.sync_context(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON):
        assert not isinstance(m.preds, list)
        assert m.state_dict()["preds"].shape == (32,)
        pickle.dumps(m)
        p, r, _ = m.compute()
        assert p.shape[0] == r.shape[0]
    assert isinstance(m.preds, list)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none"])
def test_reduce_and_class_reduce_match_jax(reduction, class_reduction):
    from metrics_tpu.parallel import class_reduce as jax_class_reduce
    from metrics_tpu.parallel import reduce as jax_reduce
    from metrics_tpu_torch.parallel import class_reduce, reduce

    rng = np.random.RandomState(3)
    x = rng.rand(4, 5).astype(np.float32)
    num, denom = rng.randint(0, 5, 6), rng.randint(0, 9, 6)
    denom[2] = 0  # 0/0 -> 0
    weights = rng.rand(6).astype(np.float32)
    _assert_value(reduce(torch.from_numpy(x), reduction), jax_reduce(jnp.asarray(x), reduction), reduction)
    _assert_value(
        class_reduce(*map(torch.from_numpy, (num, denom, weights)), class_reduction),
        jax_class_reduce(*map(jnp.asarray, (num, denom, weights)), class_reduction),
        class_reduction,
    )
    with pytest.raises(ValueError):
        reduce(torch.from_numpy(x), "max")
