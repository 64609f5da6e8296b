"""Deferred dispatch in the port (``ops/engine.py``, ``Metric``, ``MetricCollection``).

The cases of the JAX package's ``tests/bases/test_deferred_dispatch.py``, on
the port: under validation mode "first", calls of a signature seen once
enqueue, ``forward`` returns a lazy handle, and every observation surface
flushes in enqueue order, so a deferred run equals the per-call run bit for
bit (``torch.equal``; no tolerance). The values also equal the JAX package's
on the same numpy inputs: integer states bit for bit, floats within the JAX
tests' tolerance (``FLOAT_ATOL``, ``FLOAT_RTOL``). Then what is the port's own: a caller
that writes into an input tensor after ``update()`` does not change the
queued step, and a failed flush replays eagerly on the same tensors.
"""
import copy
import os
import pickle
import tempfile
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.ops import engine as jengine
from metrics_tpu.utils import checks as jchecks
from metrics_tpu_torch.ops import engine, faults
from metrics_tpu_torch.utils import checks

# float results of the two packages: float32 sums of the same values in another order, a few ulps
# apart (the JAX package's regression edge tests hold its values within atol 1e-5, rtol 1e-4,
# tests/regression/test_edge_matrix.py:25; its deferral tests compare its own paths exactly, as this
# file compares the port's)
FLOAT_ATOL, FLOAT_RTOL = 1e-6, 1e-6

RNG = np.random.RandomState(11)
P = RNG.rand(64).astype(np.float32)
T = RNG.randint(0, 2, 64)
A = RNG.rand(48).astype(np.float32)
B = RNG.rand(48).astype(np.float32)


@pytest.fixture(autouse=True)
def _first_mode_deferred(monkeypatch):
    """Both packages in validation mode "first" with deferral on (and jax 0.9's missing
    ``jax.core.trace_state_clean`` put back for the JAX engine)."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")
    engine.set_deferred_dispatch(True, max_pending=128, max_age_ms=60_000)
    jengine.set_deferred_dispatch(True, max_pending=128, max_age_ms=60_000)
    yield
    engine.set_deferred_dispatch(True, max_pending=128, max_age_ms=250)
    jengine.set_deferred_dispatch(True, max_pending=128, max_age_ms=250)
    checks.set_validation_mode("first")
    jchecks.set_validation_mode("first")


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _eager(fn):
    """``fn()`` with the port's deferral off: the per-call oracle."""
    engine.set_deferred_dispatch(False)
    try:
        return fn()
    finally:
        engine.set_deferred_dispatch(True)


def _value(v):
    return v._force() if isinstance(v, engine.LazyValue) else v


def _assert_tree_equal(a, b):
    """Exactly: tensors by ``torch.equal`` with their dtype, dicts and lists element by element."""
    a, b = _value(a), _value(b)
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def _assert_close_to_jax(got, want):
    got = _value(got)
    want = want._force() if hasattr(want, "_force") else want
    if isinstance(want, dict):
        for k in want:
            _assert_close_to_jax(got[k], want[k])
        return
    w = np.asarray(want)
    g = got.cpu().numpy()
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=FLOAT_ATOL, rtol=FLOAT_RTOL)


class TestUpdateQueue:
    def test_updates_enqueue_and_flush_amortized(self):
        m = tmt.Accuracy(device="cpu")
        m.update(*_t(P, T))  # the first call of a signature: eager, validated
        s0 = engine.engine_stats()
        for _ in range(16):
            m.update(*_t(P, T))
        assert m._defer_pending is not None and len(m._defer_pending.entries) == 16
        assert engine.engine_stats()["deferred_steps"] - s0["deferred_steps"] == 16
        value = m.compute()  # one flush
        assert m._defer_pending is None
        assert engine.engine_stats()["deferred_flushes"] - s0["deferred_flushes"] == 1

        def oracle():
            e = tmt.Accuracy(device="cpu")
            for _ in range(17):
                e.update(*_t(P, T))
            return e.compute()

        _assert_tree_equal(value, _eager(oracle))
        jm = jmt.Accuracy()
        for _ in range(17):
            jm.update(*_j(P, T))
        _assert_close_to_jax(value, jm.compute())

    def test_direct_state_access_is_an_observation(self):
        m = tmt.MeanSquaredError(device="cpu")
        for _ in range(6):
            m.update(*_t(A, B))
        assert "sum_squared_error" not in m.__dict__  # held by the queue
        total = m.sum_squared_error  # __getattr__ flushes

        def oracle():
            e = tmt.MeanSquaredError(device="cpu")
            for _ in range(6):
                e.update(*_t(A, B))
            return e.sum_squared_error

        _assert_tree_equal(total, _eager(oracle))
        assert m.total.dtype == torch.int32 and int(m.total) == 6 * 48

    def test_signature_change_flushes_in_enqueue_order(self):
        short = RNG.rand(16).astype(np.float32)

        def run():
            m = tmt.MeanMetric(device="cpu")
            for _ in range(2):
                m.update(*_t(A))
                m.update(*_t(short))
            for _ in range(3):
                m.update(*_t(A))
                m.update(*_t(short))  # each switch flushes the queue before it
            return m.compute()

        _assert_tree_equal(run(), _eager(run))


class TestLazyForward:
    def test_forward_returns_lazy_handle_bitexact(self):
        m = tmt.Accuracy(device="cpu")
        first = m(*_t(P, T))
        assert isinstance(first, torch.Tensor)  # the first call of a signature runs now
        handles = [m(*_t(P, T)) for _ in range(5)]
        assert all(isinstance(h, engine.LazyValue) for h in handles)
        assert m._defer_pending is not None  # nothing read: nothing ran
        vals = [float(h) for h in handles]

        def oracle():
            e = tmt.Accuracy(device="cpu")
            return [float(e(*_t(P, T))) for _ in range(6)]

        assert [float(first)] + vals == _eager(oracle)
        jm = jmt.Accuracy()
        assert [float(jm(*_j(P, T))) for _ in range(6)] == [float(first)] + vals

    def test_lazy_handle_interfaces(self):
        m = tmt.Accuracy(device="cpu")
        m(*_t(P, T))
        h = m(*_t(P, T))
        assert isinstance(h, engine.LazyValue)
        as_np = np.asarray(h)
        value = _value(h)
        np.testing.assert_array_equal(as_np, value.numpy())
        assert float(h + 1.0) == float(as_np) + 1.0
        assert h.shape == value.shape and h.dtype == torch.float32
        assert bool(h <= 1.0)
        assert f"{float(h):.3f}" == f"{float(as_np):.3f}"
        h2 = m(*_t(P, T))
        assert torch.equal(torch.add(h2, 1), value + 1)  # a torch function forces through __torch_function__
        h3 = m(*_t(P, T))
        assert torch.equal(torch.ones(()) + h3, value + 1)  # a tensor operator on the left
        h4, h5 = m(*_t(P, T)), m(*_t(P, T))
        assert torch.equal(torch.stack([h4, h5]), torch.stack([value, value]))
        with pytest.raises(TypeError):
            hash(h)

    def test_unread_handles_resolve_at_state_observation(self):
        m = tmt.Accuracy(device="cpu")
        m(*_t(P, T))
        handles = [m(*_t(P, T)) for _ in range(3)]
        m.compute()
        assert all(h._ready for h in handles)
        assert m._forward_cache is handles[-1]  # as three forward calls leave it


MIX_CASES = [
    ("Accuracy", lambda pkg, **k: pkg.Accuracy(**k), (P, T)),
    ("MSE", lambda pkg, **k: pkg.MeanSquaredError(**k), (A, B)),
    ("MeanMetric", lambda pkg, **k: pkg.MeanMetric(**k), (A,)),
    ("MaxMetric", lambda pkg, **k: pkg.MaxMetric(**k), (A,)),  # an order-sensitive reduction
    ("MinMetric", lambda pkg, **k: pkg.MinMetric(**k), (A,)),
]


def _script(m, batch):
    out = []
    m.update(*batch)
    m.update(*batch)
    out.append(m.compute())  # compute mid-queue
    m.update(*batch)
    out.append(m(*batch))  # a forward in the update stream
    m.update(*batch)
    out.append(m.clone().compute())  # a copy mid-queue
    m.update(*batch)
    out.append(pickle.loads(pickle.dumps(m)).compute())  # a pickle mid-queue
    m.sync(should_sync=False)
    out.append(dict(m.metric_state))  # a state read
    m.reset()  # a reset mid-script
    m.update(*batch)
    out.append(m.compute())
    return out


class TestMidQueueObservationOrdering:
    @pytest.mark.parametrize("name,factory,batch", MIX_CASES, ids=[c[0] for c in MIX_CASES])
    def test_interleaved_script_bitexact_and_equal_to_jax(self, name, factory, batch):
        deferred = _script(factory(tmt, device="cpu"), _t(*batch))
        eager = _eager(lambda: _script(factory(tmt, device="cpu"), _t(*batch)))
        for d, e in zip(deferred, eager):
            _assert_tree_equal(d, e)
        ref = _script(factory(jmt), _j(*batch))
        for d, r in zip(deferred, ref):
            _assert_close_to_jax(d, r)

    def test_minmax_wrapper_interleaved(self):
        p2 = RNG.rand(64).astype(np.float32)

        def script(m, conv):
            out = [m(*conv(P, T)), m(*conv(p2, T)), m.compute(), m(*conv(P, T)), m.compute()]
            return out

        deferred = script(tmt.MinMaxMetric(tmt.Accuracy(device="cpu")), _t)
        eager = _eager(lambda: script(tmt.MinMaxMetric(tmt.Accuracy(device="cpu")), _t))
        for d, e in zip(deferred, eager):
            _assert_tree_equal(d, e)
        for d, r in zip(deferred, script(jmt.MinMaxMetric(jmt.Accuracy()), _j)):
            _assert_close_to_jax(d, r)

    def test_bootstrapper_draws_keep_the_eager_order(self):
        def script():
            b = tmt.BootStrapper(tmt.MeanSquaredError(device="cpu"), num_bootstraps=4, device="cpu")
            b.generator.manual_seed(3)
            out = []
            b.update(*_t(A, B))
            b.update(*_t(A, B))
            out.append(b.compute())
            b.update(*_t(A, B))
            b.update(*_t(A, B))
            out.append(b.compute())
            out.append([dict(m.metric_state) for m in b.metrics])
            return out

        deferred = script()
        eager = _eager(script)
        _assert_tree_equal(deferred, eager)


class TestCollections:
    C = 4

    def _data(self):
        rng = np.random.RandomState(5)
        probs = rng.rand(32, self.C).astype(np.float32)
        probs /= probs.sum(1, keepdims=True)
        return probs, rng.randint(0, self.C, 32)

    def _suite(self, pkg, **kw):
        # Precision and Recall share identical stat states: one compute group
        return pkg.MetricCollection({
            "prec": pkg.Precision(num_classes=self.C, average="macro", **kw),
            "rec": pkg.Recall(num_classes=self.C, average="macro", **kw),
            "acc": pkg.Accuracy(num_classes=self.C, average="macro", **kw),
            "cm": pkg.ConfusionMatrix(num_classes=self.C, **kw),
        })

    def test_update_uses_one_suite_queue(self):
        p, t = self._data()
        col = self._suite(tmt, device="cpu")
        col.update(*_t(p, t))  # member by member; the groups are found
        for _ in range(6):
            col.update(*_t(p, t))
        q = col._defer_pending
        assert q is not None and q.kind == "collection-update" and len(q.entries) == 6
        # the states of every member are held, followers' too
        assert all("tp" not in col._modules[n].__dict__ for n in ("prec", "rec", "acc"))

        def oracle():
            c = self._suite(tmt, device="cpu")
            for _ in range(7):
                c.update(*_t(p, t))
            return c.compute()

        res = col.compute()
        _assert_tree_equal(res, _eager(oracle))
        js = self._suite(jmt)
        for _ in range(7):
            js.update(*_j(p, t))
        _assert_close_to_jax(res, js.compute())

    def test_forward_interleaved_with_compute(self):
        p, t = self._data()

        def script(c, conv):
            out = [c(*conv(p, t)), c(*conv(p, t)), c.compute(), c(*conv(p, t))]
            c.reset()
            out += [c(*conv(p, t)), c.compute()]
            return out

        deferred = script(self._suite(tmt, device="cpu"), _t)
        assert isinstance(deferred[1]["acc"], engine.LazyValue)
        eager = _eager(lambda: script(self._suite(tmt, device="cpu"), _t))
        for d, e in zip(deferred, eager):
            _assert_tree_equal(d, e)
        for d, r in zip(deferred, script(self._suite(jmt), _j)):
            _assert_close_to_jax(d, r)

    def test_new_kwarg_mid_queue_is_not_dropped(self):
        x = RNG.rand(16).astype(np.float32)
        w = (RNG.rand(16) * 2).astype(np.float32)

        def script(c, conv):
            c.update(*conv(x))
            c.update(*conv(x), weight=conv(w)[0])  # both signatures validated
            for _ in range(3):
                c.update(*conv(x))  # the queue without the kwarg
            c.update(*conv(x), weight=conv(w)[0])  # a new kwarg: flush, then its own path
            c.update(*conv(x), weight=conv(w)[0])
            return c.compute()

        make = lambda pkg, **k: pkg.MetricCollection({"mean": pkg.MeanMetric(**k)})  # noqa: E731
        deferred = script(make(tmt, device="cpu"), _t)
        _assert_tree_equal(deferred, _eager(lambda: script(make(tmt, device="cpu"), _t)))
        _assert_close_to_jax(deferred, script(make(jmt), _j))

    def test_mode_switch_mid_queue_regains_full_validation(self):
        p, t = self._data()
        col = self._suite(tmt, device="cpu")
        for _ in range(4):
            col.update(*_t(p, t))
        assert col._defer_pending is not None
        checks.set_validation_mode("full")
        col.update(*_t(p, t))  # flushes the queue, runs validated
        assert col._defer_pending is None
        assert all(m._defer_pending is None for m in col._modules.values())

    def test_member_state_access_flushes_suite_queue(self):
        p, t = self._data()
        col = self._suite(tmt, device="cpu")
        for _ in range(4):
            col.update(*_t(p, t))
        assert col._defer_pending is not None
        col["acc"].compute()  # a member's observation is the whole suite's
        assert col._defer_pending is None
        for _ in range(3):
            col.update(*_t(p, t))
        assert col._defer_pending is not None
        _ = col._modules["rec"].tp  # a follower's state read, too
        assert col._defer_pending is None


# --------------------------------------------------------- observation surfaces
def _queued_sum():
    m = tmt.SumMetric(device="cpu")
    for i in range(5):
        m.update(torch.full((4,), float(i)))
    assert m._defer_pending is not None and len(m._defer_pending.entries) == 4
    return m


def _sum_oracle(n=5):
    return _eager(lambda: _fed(tmt.SumMetric(device="cpu"), n))


def _fed(m, n):
    for i in range(n):
        m.update(torch.full((4,), float(i)))
    return m


def _surface_sync(m):
    m.sync(distributed_available=lambda: True)  # a world of one syncs all the same
    value = m.value.clone()
    m.unsync()
    return value


def _surface_sync_async(m):
    fut = m.sync_async(distributed_available=lambda: True)
    m.update(torch.full((4,), 10.0))  # enqueued while the sync is in flight
    fut.wait()  # the force flushes it before it applies
    synced = m.value.clone()
    m.unsync()
    return synced


def _surface_save_state(m):
    with tempfile.TemporaryDirectory() as tmp:
        m.save_state(os.path.join(tmp, "j"))
        fresh = tmt.SumMetric(device="cpu")
        fresh.load_state(os.path.join(tmp, "j"))
        return fresh.value


SURFACES = {
    "attribute": lambda m: m.value,
    "compute": lambda m: m.compute(),
    "sync": _surface_sync,
    "sync_async": _surface_sync_async,
    "reset": lambda m: (m.reset(), m.value)[1],
    "state_dict": lambda m: (m.persistent(True), m.state_dict()["value"])[1],
    "pickle": lambda m: pickle.loads(pickle.dumps(m)).value,
    "deepcopy": lambda m: copy.deepcopy(m).value,
    "to": lambda m: m.to("cpu").value,
    "double": lambda m: m.double().value,
    "save_state": _surface_save_state,
}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_every_observation_surface_flushes_in_order(surface):
    m = _queued_sum()
    got = SURFACES[surface](m)
    assert m._defer_pending is None
    want = SURFACES[surface](_sum_oracle())
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("how", ["load_state_dict", "load_state", "load_reference_state"])
def test_loading_states_with_calls_queued_runs_them_first(how, tmp_path):
    """Loaded states are what the metric holds after the load: the calls queued before it ran
    first, and no later flush writes the old states back over the loaded ones."""
    from metrics_tpu_torch.interop import load_reference_state

    source = _sum_oracle(3)
    m = _queued_sum()
    if how == "load_state_dict":
        source.persistent(True)
        m.load_state_dict(source.state_dict())
    elif how == "load_state":
        source.save_state(str(tmp_path / "j"))
        m.load_state(str(tmp_path / "j"))
    else:
        load_reference_state(m, {"value": source.value.numpy()})
    assert m._defer_pending is None
    _assert_tree_equal(m.value, source.value)
    m.update(torch.ones(4))  # and the metric goes on from the loaded states
    _assert_tree_equal(m.compute(), source.value + 4)


def test_a_hyperparameter_change_runs_the_queued_calls_first():
    """The queued calls were enqueued under the old hyperparameters: they run before the change, as the
    JAX package's ``__setattr__`` barrier makes them (``metrics_tpu/metric.py:2664-2672``)."""
    rng = np.random.RandomState(31)
    batches = [(rng.rand(16).astype(np.float32), rng.randint(0, 2, 16)) for _ in range(3)]

    def run(pkg, **kw):
        m = pkg.Accuracy(**kw)
        for p, y in batches[:2]:
            m.update(*((torch.from_numpy(p), torch.from_numpy(y)) if pkg is tmt else (jnp.asarray(p), jnp.asarray(y))))
        if pkg is tmt:
            assert m._defer_pending is not None  # the second call is queued
        m.threshold = 0.9
        p, y = batches[2]
        m.update(*((torch.from_numpy(p), torch.from_numpy(y)) if pkg is tmt else (jnp.asarray(p), jnp.asarray(y))))
        return m.compute()

    got, want = run(tmt, device="cpu"), run(jmt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adding_members_runs_the_suite_queue_first():
    col = tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})
    for _ in range(3):
        col.update(*_t(P, T))
    assert col._defer_pending is not None
    col.add_metrics({"sum": tmt.SumMetric(device="cpu")})
    assert col._defer_pending is None
    e = _eager(lambda: _fed_suite(3))
    _assert_tree_equal(col._modules["acc"].compute(), e._modules["acc"].compute())


def _fed_suite(n):
    col = tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})
    for _ in range(n):
        col.update(*_t(P, T))
    return col


def test_collection_journal_and_save_state_flush_the_suite_queue():
    def run(tmp):
        col = tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})
        col.journal(os.path.join(tmp, "j"), every_n=3)
        for _ in range(7):
            col.update(*_t(P, T))
        fresh = tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})
        fresh.load_state(os.path.join(tmp, "j"))  # the save at the 6th call
        return fresh.compute(), col.compute()

    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        deferred, eager = run(a), _eager(lambda: run(b))
    _assert_tree_equal(deferred, eager)


def test_flush_barrier_counts_each_queue_once():
    m = _queued_sum()
    col = tmt.MetricCollection({"acc": tmt.Accuracy(device="cpu")})
    for _ in range(3):
        col.update(*_t(P, T))
    before = engine.engine_stats()["deferred_sync_barrier_flushes"]
    assert engine.flush_barrier([m, col, m]) == 2
    assert engine.engine_stats()["deferred_sync_barrier_flushes"] == before + 2
    assert m._defer_pending is None and col._defer_pending is None


# ------------------------------------------------------------ the port's own
@pytest.mark.parametrize("case", ["update", "forward", "suite"])
def test_writing_into_an_input_after_the_call_does_not_change_the_queued_step(case):
    """Tensors are mutable: the queue keeps its own copy of every input."""
    def run():
        if case == "suite":
            m = tmt.MetricCollection({"mse": tmt.MeanSquaredError(device="cpu"), "mean": tmt.MeanMetric(device="cpu")})
        else:
            m = tmt.MeanSquaredError(device="cpu")
        buf_a, buf_b = torch.empty(48), torch.empty(48)
        out = []
        for step in range(6):
            buf_a.copy_(torch.from_numpy(A) * (step + 1))
            buf_b.copy_(torch.from_numpy(B))
            out.append(m(buf_a, buf_b) if case == "forward" else m.update(buf_a, buf_b))
            buf_a.fill_(1e6)  # the caller reuses its buffer
        return [_value(v) for v in out if v is not None], m.compute()

    deferred = run()
    _assert_tree_equal(deferred, _eager(run))


class TestEscapeHatch:
    def test_defer_off_restores_per_call_dispatch(self):
        engine.set_deferred_dispatch(False)
        try:
            m = tmt.Accuracy(device="cpu")
            for _ in range(4):
                m.update(*_t(P, T))
            assert m._defer_pending is None and "tp" in m.__dict__
        finally:
            engine.set_deferred_dispatch(True)

    def test_full_validation_mode_disables_deferral(self):
        checks.set_validation_mode("full")
        m = tmt.Accuracy(device="cpu")
        for _ in range(3):
            m.update(*_t(P, T))
        assert m._defer_pending is None

    def test_flush_failure_replays_eagerly_and_disables(self, monkeypatch):
        m = tmt.MeanMetric(device="cpu")
        for _ in range(4):
            m.update(*_t(A))
        assert m._defer_pending is not None
        faults.reset_warn_dedupe()
        monkeypatch.setattr(type(m), "_many_program", lambda self, with_values: (_ for _ in ()).throw(
            RuntimeError("boom")))
        before = engine.engine_stats()
        with pytest.warns(UserWarning, match="Replaying the queue eagerly"):
            value = m.compute()
        assert not m._defer_ok
        assert engine.engine_stats()["deferred_fallbacks"] == before["deferred_fallbacks"] + 1

        def oracle():
            e = tmt.MeanMetric(device="cpu")
            for _ in range(4):
                e.update(*_t(A))
            return e.compute()

        _assert_tree_equal(value, _eager(oracle))
        m.update(*_t(A))  # later updates run per call
        assert m._defer_pending is None

    @pytest.mark.parametrize("kind", ["update", "forward", "suite"])
    def test_injected_flush_chunk_2_replays_the_rest(self, kind):
        """Chunks of 4, 2 and 1: the first two apply, the third fails before it runs and
        replays; the states equal the per-call run and the fallback is counted."""
        def run():
            m = (tmt.MetricCollection({"mse": tmt.MeanSquaredError(device="cpu")}) if kind == "suite"
                 else tmt.MeanSquaredError(device="cpu"))
            out = [m(*_t(A, B)) if kind == "forward" else m.update(*_t(A, B)) for _ in range(8)]
            return m, out

        m, out = run()
        before = engine.engine_stats()["deferred_fallbacks"]
        faults.reset_warn_dedupe()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with faults.inject_faults("flush-chunk-2", count=1) as plan:
                value = m.compute()
        assert plan.fired == 1 and engine.engine_stats()["deferred_fallbacks"] == before + 1
        e, e_out = _eager(run)
        _assert_tree_equal(value, e.compute())
        _assert_tree_equal([_value(v) for v in out if v is not None], [v for v in e_out if v is not None])

    def test_a_failing_step_surfaces_with_the_per_call_count(self, monkeypatch):
        """A call whose step raises raises at the flush, from the eager replay; the count is the
        per-call path's at that raise (the calls queued after it never ran)."""
        m = tmt.MeanMetric(device="cpu")
        real = m._inner_update

        def strict(value, *a, **k):
            if bool((value < 0).any()):
                raise ValueError("bad batch")
            return real(value, *a, **k)

        monkeypatch.setattr(m, "_inner_update", strict)
        bad = -torch.from_numpy(A)
        for x in (_t(A)[0], _t(A)[0], _t(A)[0], bad, _t(A)[0]):
            m.update(x)
        assert len(m._defer_pending.entries) == 4
        faults.reset_warn_dedupe()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="bad batch"):
                m.compute()
        assert m.update_count == 4  # three good calls, and the one that failed
        assert float(m.value) == float(_eager(lambda: _fed_mean(3)).value)


def _fed_mean(n):
    m = tmt.MeanMetric(device="cpu")
    for _ in range(n):
        m.update(*_t(A))
    return m


class TestLazyHandleCopy:
    def test_copy_and_pickle_of_unresolved_handle_resolve(self):
        m = tmt.Accuracy(device="cpu")
        m(*_t(P, T))
        h = m(*_t(P, T))
        hc = copy.deepcopy(h)  # forces the flush
        _assert_tree_equal(hc, h)
        h2 = m(*_t(P, T))
        hp = pickle.loads(pickle.dumps(h2))
        _assert_tree_equal(hp, h2)
        assert hc._queue is None and hp._queue is None


class TestProgramSharing:
    def test_flush_shares_the_forward_many_program(self):
        engine.reset_engine()
        m = tmt.Accuracy(device="cpu")
        m(*_t(P, T))
        for _ in range(4):
            m(*_t(P, T))
        m.compute()  # the flush builds the "many" program of forwards
        builds = engine.engine_stats()["builds"]
        m2 = tmt.Accuracy(device="cpu")
        stacked = (torch.stack([torch.from_numpy(P)] * 4), torch.stack([torch.from_numpy(T)] * 4))
        m2.forward_many(*stacked)  # the first chunk: call by call
        m2.forward_many(*stacked)  # the program: a cache hit
        assert engine.engine_stats()["builds"] == builds
