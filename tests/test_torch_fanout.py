"""The one-program clone fan-out (``metrics_tpu_torch/wrappers/_fanout.py``) and the wrappers' exports.

The cases of JAX's ``tests/wrappers/test_as_functions.py`` and
``tests/wrappers/test_fused_defaults.py``, ported: the wrappers' pure exports
(ClasswiseWrapper and MultioutputWrapper(remove_nans=False) export, MinMaxMetric,
BootStrapper and the compositions refuse with guidance, a collection takes
each member's own export), and the fused default configurations, each held
to a force-eager twin on the same data and draws: BootStrapper Poisson
(counts as row weights over per-row deltas, certified on its first steps)
and multinomial (``torch.func.vmap`` over the clones), MultioutputWrapper
with ``remove_nans`` (NaN rows weighted 0) and MinMaxMetric's one-step
``forward``. Then the same draws replayed into JAX's fused BootStrapper and
the port's, MultioutputWrapper and MinMaxMetric against JAX's fused paths,
the config-drift and failure demotions with JAX's warnings, and
``weighted_delta_add``'s dtype rules and the row blocks. Counts are equal
bit for bit; floats within atol 1e-6 and rtol 1e-5 (float32 sums in another
order: the weighted contraction against the eager update).
"""
import pickle

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.ops import engine, faults
from metrics_tpu_torch.utils import checks
from metrics_tpu_torch.wrappers import _fanout
from metrics_tpu_torch.wrappers import bootstrapping as torch_boot

ATOL, RTOL = 1e-6, 1e-5
_rng = np.random.RandomState(7)


@pytest.fixture(autouse=True)
def _first_mode(monkeypatch):
    """The fused paths run in validation mode "first"; ``jax.core.trace_state_clean`` (gone from jax
    0.9, called by the JAX engine) is restored for the reference's own fused paths."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    prev = checks._get_validation_mode(), jax_checks._get_validation_mode()
    checks.set_validation_mode("first")
    jax_checks.set_validation_mode("first")
    yield
    checks.set_validation_mode(prev[0])
    jax_checks.set_validation_mode(prev[1])


def t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def states_of(wrapper):
    return [{k: v.clone() for k, v in m.metric_state.items()} for m in wrapper.metrics]


def assert_states(a, b, exact=False):
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            if exact or not sa[k].is_floating_point():
                assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
            else:
                torch.testing.assert_close(sa[k], sb[k], atol=ATOL, rtol=RTOL)


def assert_like_reference(expected, got):
    e, g = np.asarray(expected), got.detach().cpu().numpy()
    assert e.shape == g.shape
    if np.issubdtype(e.dtype, np.floating):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


def pair(factory, force_eager_attr):
    fused, eager = factory(), factory()
    object.__setattr__(eager, force_eager_attr, False)
    return fused, eager


# ------------------------------------------------------------------ the exports
class TestClasswiseExport:
    def test_matches_module_api_and_the_reference(self):
        preds, target = _rng.rand(64, 3).astype(np.float32), _rng.randint(0, 3, 64)
        module = tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=3, average=None, device="cpu"))
        module.update(*t(preds, target))
        expected = module.compute()
        init, upd, cmp = tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=3, average=None, device="cpu")).as_functions()
        got = cmp(upd(init(), *t(preds, target)))
        jinit, jupd, jcmp = jmt.ClasswiseWrapper(jmt.Accuracy(num_classes=3, average=None)).as_functions()
        ref = jcmp(jupd(jinit(), jnp.asarray(preds), jnp.asarray(target)))
        assert set(got) == set(expected) == set(ref)
        for key in expected:
            torch.testing.assert_close(got[key], expected[key], atol=ATOL, rtol=0.0)
            assert_like_reference(ref[key], got[key])

    def test_labels_respected(self):
        wrapper = tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=2, average=None, device="cpu"), labels=["cat", "dog"])
        init, upd, cmp = wrapper.as_functions()
        state = upd(init(), torch.tensor([0, 1]), torch.tensor([0, 0]))
        assert set(cmp(state)) == {"accuracy_cat", "accuracy_dog"}

    def test_update_runs_again_and_under_vmap(self):
        init, upd, _ = tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=3, average=None, device="cpu")).as_functions()
        state = upd(init(), torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        state = upd(state, torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        assert state  # the child's states flow through
        stacked = torch.func.vmap(upd)(tmt.stack_states([init(), init()]), torch.tensor([[0, 1, 2]] * 2),
                                       torch.tensor([[0, 1, 1]] * 2))
        assert all(torch.equal(v[0], v[1]) for v in stacked.values())


class TestMultioutputExport:
    def test_matches_module_api(self):
        preds, target = _rng.rand(32, 4).astype(np.float32), _rng.rand(32, 4).astype(np.float32)
        module = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=4, remove_nans=False)
        module.update(*t(preds, target))
        expected = [float(v) for v in module.compute()]
        init, upd, cmp = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=4,
                                                remove_nans=False).as_functions()
        got = [float(v) for v in cmp(upd(init(), *t(preds, target)))]
        np.testing.assert_allclose(got, expected, atol=ATOL)

    def test_remove_nans_raises(self):
        with pytest.raises(NotImplementedError, match="remove_nans"):
            tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=2).as_functions()

    def test_streaming_accumulation(self):
        init, upd, cmp = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=2,
                                                remove_nans=False).as_functions()
        state = upd(init(), torch.tensor([[1.0, 2.0], [3.0, 4.0]]), torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
        state = upd(state, torch.zeros(2, 2), torch.full((2, 2), 2.0))
        np.testing.assert_allclose([float(v) for v in cmp(state)], [2.0, 2.0], atol=ATOL)


class TestCollectionWithWrapperMembers:
    """JAX's lift builds each member's base export, so these two cases fail in the JAX package; the port
    takes a member's own export or refusal, as the cases ask."""

    def test_collection_with_classwise_member_exports(self):
        coll = tmt.MetricCollection({"acc": tmt.Accuracy(num_classes=3, device="cpu"),
                                     "cw": tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=3, average=None, device="cpu"))})
        init, upd, cmp = coll.as_functions()
        out = cmp(upd(init(), *t(_rng.rand(32, 3).astype(np.float32), _rng.randint(0, 3, 32))))
        assert "acc" in out and any(k.startswith("accuracy_") for k in out)

    def test_collection_with_minmax_member_raises_from_export(self):
        coll = tmt.MetricCollection({"acc": tmt.Accuracy(num_classes=3, device="cpu"),
                                     "mm": tmt.MinMaxMetric(tmt.Accuracy(num_classes=3, device="cpu"))})
        with pytest.raises(NotImplementedError, match="stateful compute"):
            coll.as_functions()
        coll.update(*t(_rng.rand(8, 3).astype(np.float32), _rng.randint(0, 3, 8)))
        assert set(coll.compute()) >= {"acc", "raw", "max", "min"}


class TestNonExportableWrappersRaise:
    def test_minmax_raises_with_guidance(self):
        with pytest.raises(NotImplementedError, match="stateful compute"):
            tmt.MinMaxMetric(tmt.Accuracy(device="cpu")).as_functions()

    def test_bootstrapper_raises_with_guidance(self):
        with pytest.raises(NotImplementedError, match="RNG"):
            tmt.BootStrapper(tmt.MeanSquaredError(device="cpu"), num_bootstraps=4).as_functions()

    def test_tracker_has_no_export(self):
        assert not hasattr(tmt.MetricTracker(tmt.Accuracy(device="cpu")), "as_functions")

    def test_child_holding_wrappers_are_not_fusable(self):
        assert not tmt.MinMaxMetric(tmt.Accuracy(device="cpu"))._fusable_states()
        assert not tmt.BootStrapper(tmt.MeanSquaredError(device="cpu"))._fusable_states()


# ------------------------------------------------------------------ the fused defaults
class TestPoissonBootstrap:
    def _run(self, base_factory, batches, strategy="poisson", seed=3):
        fused, eager = pair(lambda: tmt.BootStrapper(base_factory(), num_bootstraps=4, sampling_strategy=strategy),
                            "_boot_ok")
        fused.generator.manual_seed(seed)
        eager.generator.manual_seed(seed)
        for b in batches:
            fused.update(*t(*b))
            eager.update(*t(*b))
        return fused, eager

    def test_fused_equals_eager_same_seed(self):
        rng = np.random.RandomState(0)
        batches = [(rng.rand(48).astype(np.float32), rng.rand(48).astype(np.float32)) for _ in range(4)]
        fused, eager = self._run(lambda: tmt.MeanSquaredError(device="cpu"), batches)
        assert fused._boot_program is not None, "poisson fused path never engaged"
        assert fused._poisson_cert_done > 0
        for key in ("mean", "std"):
            torch.testing.assert_close(fused.compute()[key], eager.compute()[key], rtol=1e-4, atol=1e-6)
        assert_states(states_of(fused), states_of(eager))
        assert [m.update_count for m in fused.metrics] == [m.update_count for m in eager.metrics]

    @pytest.mark.parametrize("base", ["accuracy", "confmat"])
    def test_integer_bases_fuse_bit_for_bit(self, base):
        rng = np.random.RandomState(1)
        if base == "accuracy":
            factory = lambda: tmt.Accuracy(device="cpu")  # noqa: E731
            batches = [(rng.rand(32).astype(np.float32), rng.randint(0, 2, 32)) for _ in range(3)]
        else:
            factory = lambda: tmt.ConfusionMatrix(num_classes=5, device="cpu")  # noqa: E731
            batches = [(rng.rand(32, 5).astype(np.float32), rng.randint(0, 5, 32)) for _ in range(3)]
        fused, eager = self._run(factory, batches)
        assert fused._boot_program is not None
        assert_states(states_of(fused), states_of(eager), exact=True)

    @pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
    def test_shape_churn_keeps_seeded_stream_parity(self, strategy):
        """Both paths draw the same (clones, N) matrix from the generator, so a fused run's states equal a
        force-eager run's on the same seed whatever the batch sizes."""
        rng = np.random.RandomState(0)
        sizes = [32, 32, 48, 48, 32, 48, 32]
        batches = [(rng.rand(s).astype(np.float32), rng.rand(s).astype(np.float32)) for s in sizes]
        fused, eager = self._run(lambda: tmt.MeanSquaredError(device="cpu"), batches, strategy=strategy, seed=9)
        assert fused._boot_program is not None
        assert_states(states_of(fused), states_of(eager))
        assert torch.equal(fused.generator.get_state(), eager.generator.get_state())

    def test_non_sum_linear_base_stays_eager(self):
        rng = np.random.RandomState(2)
        batches = [(rng.rand(16).astype(np.float32),) for _ in range(3)]
        fused, eager = self._run(lambda: tmt.MaxMetric(device="cpu"), batches)
        assert fused._boot_program is None  # "max" cannot be expressed by row weights
        torch.testing.assert_close(fused.compute()["mean"], eager.compute()["mean"])

    def test_full_mode_stays_eager(self):
        checks.set_validation_mode("full")
        rng = np.random.RandomState(4)
        batches = [(rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)) for _ in range(3)]
        fused, _ = self._run(lambda: tmt.MeanSquaredError(device="cpu"), batches)
        assert fused._boot_program is None


class TestMultioutputRemoveNans:
    def _data(self, with_nans=True):
        rng = np.random.RandomState(5)
        p = rng.rand(24, 3).astype(np.float32)
        y = rng.rand(24, 3).astype(np.float32)
        if with_nans:
            p[rng.rand(24) < 0.25, 0] = np.nan
            y[rng.rand(24) < 0.25, 2] = np.nan
        return p, y

    def test_fused_equals_eager_with_nan_rows(self):
        p, y = self._data()
        fused, eager = pair(lambda: tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=3), "_mo_ok")
        assert fused.remove_nans
        for _ in range(3):
            fused.update(*t(p, y))
            eager.update(*t(p, y))
        assert fused._mo_program is not None, "remove_nans fused path never engaged"
        assert fused._mo_cert_done > 0
        np.testing.assert_allclose([float(v) for v in fused.compute()], [float(v) for v in eager.compute()], rtol=1e-5)

    def test_all_nan_column_matches_eager(self):
        rng = np.random.RandomState(6)
        p = rng.rand(8, 2).astype(np.float32)
        y = rng.rand(8, 2).astype(np.float32)
        p[:, 1] = np.nan
        fused, eager = pair(lambda: tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=2), "_mo_ok")
        for _ in range(3):
            fused.update(*t(p, y))
            eager.update(*t(p, y))
        assert fused._mo_program is not None
        a, b = fused.compute(), eager.compute()
        np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-5)
        assert np.isnan(float(a[1])) == np.isnan(float(b[1]))

    def test_cat_state_base_stays_eager(self):
        p, y = self._data(with_nans=False)
        fused = tmt.MultioutputWrapper(tmt.SpearmanCorrCoef(device="cpu"), num_outputs=3)
        for _ in range(3):
            fused.update(*t(np.repeat(p[:, :1], 3, 1), np.repeat(y[:, :1], 3, 1)))
        assert fused._mo_program is None

    def test_pickle_drops_program(self):
        p, y = self._data()
        w = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=3)
        for _ in range(3):
            w.update(*t(p, y))
        assert w._mo_program is not None
        w2 = pickle.loads(pickle.dumps(w))
        assert w2._mo_program is None
        np.testing.assert_allclose([float(v) for v in w.compute()], [float(v) for v in w2.compute()], rtol=1e-6)

    @pytest.mark.parametrize("remove_nans", [True, False])
    def test_fused_columns_equal_the_reference_fused_columns(self, remove_nans):
        p, y = self._data(with_nans=remove_nans)
        tw = tmt.MultioutputWrapper(tmt.R2Score(device="cpu"), num_outputs=3, remove_nans=remove_nans)
        jw = jmt.MultioutputWrapper(jmt.R2Score(), num_outputs=3, remove_nans=remove_nans)
        for _ in range(3):
            tw.update(*t(p, y))
            jw.update(jnp.asarray(p), jnp.asarray(y))
        assert tw._mo_program is not None and jw._mo_program is not None
        for jm, tm in zip(jw.metrics, tw.metrics):
            for k, v in jm.metric_state.items():
                assert_like_reference(v, getattr(tm, k))
        for jv, tv in zip(jw.compute(), tw.compute()):
            assert_like_reference(jv, tv)


class TestMinMaxFusedForward:
    def test_fused_equals_eager_and_the_reference(self):
        rng = np.random.RandomState(7)
        batches = [(rng.rand(16).astype(np.float32), rng.randint(0, 2, 16)) for _ in range(4)]
        fused, eager = pair(lambda: tmt.MinMaxMetric(tmt.Accuracy(device="cpu")), "_mm_ok")
        ref = jmt.MinMaxMetric(jmt.Accuracy())
        for p, y in batches:
            rf, re_ = fused(*t(p, y)), eager(*t(p, y))
            rj = ref(jnp.asarray(p), jnp.asarray(y))
            assert torch.equal(rf["raw"], re_["raw"])
            assert_like_reference(rj["raw"], rf["raw"])
        assert fused._mm_program is not None, "minmax fused forward never engaged"
        cf, ce, cj = fused.compute(), eager.compute(), ref.compute()
        for key in ("raw", "max", "min"):
            assert torch.equal(cf[key], ce[key])
            assert_like_reference(cj[key], cf[key])
        for name in fused._base_metric._defaults:  # the child holds only the last batch, as the eager dance leaves it
            assert torch.equal(getattr(fused._base_metric, name), getattr(eager._base_metric, name))
        assert fused._update_count == eager._update_count
        assert fused._base_metric._update_count == eager._base_metric._update_count

    def test_extrema_persist_across_forwards(self):
        fused = tmt.MinMaxMetric(tmt.MeanMetric(device="cpu"))
        for v in (2.0, 5.0, 1.0, 3.0):
            fused(torch.tensor([v]))
        out = fused.compute()
        assert float(out["max"]) == 5.0 and float(out["min"]) == 1.0
        assert fused._mm_program is not None

    def test_pickle_drops_program(self):
        m = tmt.MinMaxMetric(tmt.MeanMetric(device="cpu"))
        for v in (1.0, 2.0, 3.0):
            m(torch.tensor([v]))
        assert m._mm_program is not None
        m2 = pickle.loads(pickle.dumps(m))
        assert m2._mm_program is None
        assert float(m2.compute()["max"]) == float(m.compute()["max"])

    def test_program_is_stable_across_steps(self):
        m = tmt.MinMaxMetric(tmt.MeanMetric(device="cpu"))
        for v in (1.0, 2.0):
            m(torch.tensor([v]))
        prog = m._mm_program
        assert prog is not None
        for v in (3.0, 4.0, 5.0):
            m(torch.tensor([v]))
            assert m._mm_program is prog
        m.compute()  # the extrema's advance must not invalidate it either
        m(torch.tensor([6.0]))
        assert m._mm_program is prog


# ------------------------------------------------------------------ draws replayed into both packages
class _ReplayRNG:
    """Stands in for the JAX BootStrapper's ``np.random.RandomState``: each ``poisson``/``randint`` call
    hands out the next recorded clone row; ``get_state``/``set_state`` rewind by position (the JAX
    package's lookahead prefetch snapshots the stream and may rewind it)."""

    def __init__(self, rows):
        self.rows, self.pos = rows, 0

    def _next(self, size):
        row = self.rows[self.pos]
        self.pos += 1
        assert row.shape == (size,)
        return row

    def poisson(self, lam, size):
        return self._next(size)

    def randint(self, low, high, size):
        return self._next(size)

    def get_state(self):
        return self.pos

    def set_state(self, pos):
        self.pos = pos


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("base", ["accuracy", "confmat", "mse"])
def test_the_same_draws_replayed_into_the_reference_fused_bootstrapper(strategy, base, monkeypatch):
    clones, n, steps = 5, 40, 4
    rng = np.random.RandomState(11)
    draws = [rng.poisson(1, size=(clones, n)) if strategy == "poisson" else rng.randint(0, n, size=(clones, n))
             for _ in range(steps + 1)]  # one more: the reference prefetches a step ahead
    queue = iter(draws)
    monkeypatch.setattr(torch_boot, "_draw_matrix", lambda size, b, s, g: torch.from_numpy(next(queue)).to(torch.int64))
    if base == "accuracy":
        make = lambda pkg, **d: pkg.Accuracy(num_classes=4, average="macro", **d)  # noqa: E731
        batches = [(rng.rand(n, 4).astype(np.float32), rng.randint(0, 4, n)) for _ in range(steps)]
    elif base == "confmat":
        make = lambda pkg, **d: pkg.ConfusionMatrix(num_classes=4, **d)  # noqa: E731
        batches = [(rng.rand(n, 4).astype(np.float32), rng.randint(0, 4, n)) for _ in range(steps)]
    else:
        make = lambda pkg, **d: pkg.MeanSquaredError(**d)  # noqa: E731
        batches = [(rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)) for _ in range(steps)]
    tb = tmt.BootStrapper(make(tmt, device="cpu"), num_bootstraps=clones, sampling_strategy=strategy)
    jb = jmt.BootStrapper(make(jmt), num_bootstraps=clones, sampling_strategy=strategy)
    jb._rng = _ReplayRNG([row for matrix in draws for row in matrix])
    for b in batches:
        tb.update(*t(*b))
        jb.update(*[jnp.asarray(a) for a in b])
    assert tb._boot_program is not None and jb._boot_program is not None, "a fused path never engaged"
    for jm, tm in zip(jb.metrics, tb.metrics):
        assert jm._update_count == tm._update_count == steps
        for k, v in jm.metric_state.items():
            assert_like_reference(v, getattr(tm, k))
    for k, v in jb.compute().items():
        assert_like_reference(v, tb.compute()[k])


# ------------------------------------------------------------------ demotions
def test_a_clone_whose_config_drifts_demotes_with_the_reference_warning():
    rng = np.random.RandomState(12)
    batches = [(rng.rand(32).astype(np.float32), rng.randint(0, 2, 32)) for _ in range(4)]
    fused, eager = pair(lambda: tmt.BootStrapper(tmt.Accuracy(device="cpu"), num_bootstraps=3,
                                                 sampling_strategy="multinomial"), "_boot_ok")
    fused.generator.manual_seed(1)
    eager.generator.manual_seed(1)
    for b in batches[:2]:
        fused.update(*t(*b))
        eager.update(*t(*b))
    assert fused._boot_program is not None
    fused.metrics[1].threshold = 0.9
    eager.metrics[1].threshold = 0.9
    with pytest.warns(UserWarning, match="clones are no longer identically configured"):
        fused.update(*t(*batches[2]))
    eager.update(*t(*batches[2]))
    fused.update(*t(*batches[3]))
    eager.update(*t(*batches[3]))
    assert not fused._boot_ok and fused._boot_program is None
    assert fused._fault_ladders["fanout:_boot_ok:_boot_program"].demoted
    assert_states(states_of(fused), states_of(eager), exact=True)


def test_a_failing_program_demotes_with_the_reference_warning_and_keeps_the_states(monkeypatch):
    rng = np.random.RandomState(13)
    batches = [(rng.rand(32).astype(np.float32), rng.randint(0, 2, 32)) for _ in range(4)]
    fused, eager = pair(lambda: tmt.BootStrapper(tmt.Accuracy(device="cpu"), num_bootstraps=3,
                                                 sampling_strategy="multinomial"), "_boot_ok")
    fused.generator.manual_seed(2)
    eager.generator.manual_seed(2)
    for b in batches[:3]:
        fused.update(*t(*b))
        eager.update(*t(*b))
    assert fused._boot_program is not None
    before = faults.fault_stats()["fault_demotions"]
    monkeypatch.setattr(torch_boot, "stack_states", lambda states: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.warns(UserWarning, match="Fused fan-out program for `Accuracy` raised RuntimeError: boom"):
        fused.update(*t(*batches[3]))
    eager.update(*t(*batches[3]))
    assert faults.fault_stats()["fault_demotions"] == before + 1
    assert not fused._boot_ok
    assert_states(states_of(fused), states_of(eager), exact=True)


def test_identically_configured_wrappers_share_one_program():
    rng = np.random.RandomState(14)
    batches = [(rng.rand(16).astype(np.float32), rng.randint(0, 2, 16)) for _ in range(2)]
    engine.reset_engine()
    a, b = (tmt.BootStrapper(tmt.Accuracy(device="cpu"), num_bootstraps=3, sampling_strategy="multinomial")
            for _ in range(2))
    for w in (a, b):
        for batch in batches:
            w.update(*t(*batch))
    assert a._boot_program is b._boot_program
    assert engine.engine_stats()["builds"] >= 1 and a._boot_program.runs == 2


# ------------------------------------------------------------------ the weighted rows
def test_integer_weights_times_integer_deltas_contract_exactly():
    old = torch.tensor([2**30], dtype=torch.int32)
    delta = torch.tensor([[2**24 + 1], [1]], dtype=torch.int32)
    weights = torch.tensor([[3, 5]], dtype=torch.int64)
    got = _fanout.weighted_state_apply({"s": old.unsqueeze(0)}, {"s": delta}, weights)["s"]
    assert got.dtype == torch.int32 and int(got) == 2**30 + 3 * (2**24 + 1) + 5  # float32 would lose the +1s
    mask = _fanout.weighted_delta_add(old, lambda w, d: w @ d, weights=torch.tensor([1.0, 0.0]), delta=delta)
    assert mask.dtype == torch.int32 and int(mask) == 2**30 + 2**24 + 1
    floats = _fanout.weighted_delta_add(torch.zeros(1), lambda w, d: w @ d, weights=torch.tensor([2, 1]),
                                        delta=torch.tensor([[0.5], [0.25]]))
    assert floats.dtype == torch.float32 and float(floats) == 1.25


@pytest.mark.parametrize("block_bytes", [8 * 25 * 7, 8 * 25 * 1000], ids=["blocks of 7 rows", "one block"])
def test_row_blocks_give_the_states_of_one_contraction(block_bytes, monkeypatch):
    m = tmt.ConfusionMatrix(num_classes=5, device="cpu")
    init, upd, _ = m.as_functions()
    rng = np.random.RandomState(15)
    preds, target = t(rng.rand(30, 5).astype(np.float32), rng.randint(0, 5, 30))
    weights = torch.from_numpy(rng.poisson(1, size=(4, 30)))
    monkeypatch.setattr(_fanout, "DELTA_BLOCK_BYTES", block_bytes)
    got = _fanout.weighted_rows_apply(tmt.stack_states([init()] * 4), upd, init(), weights, (preds, target), {})
    for c in range(4):
        want = upd(init(), preds[torch.repeat_interleave(torch.arange(30), weights[c])],
                   target[torch.repeat_interleave(torch.arange(30), weights[c])])
        assert torch.equal(got["confmat"][c], want["confmat"])


def test_states_allclose_compares_on_the_host():
    a = [{"s": torch.tensor([1.0, 2.0])}]
    assert _fanout.states_allclose(a, [{"s": torch.tensor([1.0, 2.00001])}])
    assert not _fanout.states_allclose(a, [{"s": torch.tensor([1.0, 2.1])}])
    assert not _fanout.states_allclose(a, [{"s": torch.tensor([1.0])}])
    assert _fanout.sum_linear_base(tmt.Accuracy(device="cpu")) and not _fanout.sum_linear_base(tmt.MaxMetric(device="cpu"))


def test_clone_config_sees_hyperparameters_and_not_states():
    a, b = tmt.Accuracy(device="cpu"), tmt.Accuracy(device="cpu")
    a.update(torch.tensor([0.2, 0.8]), torch.tensor([0, 1]))
    b.update(torch.tensor([0.9, 0.1, 0.4]), torch.tensor([1, 0, 0]))  # other states, the same inferred mode
    assert _fanout.clone_config(a) == _fanout.clone_config(b)
    b.threshold = 0.9
    assert _fanout.clone_config(a) != _fanout.clone_config(b)
