"""The port's retrieval metrics against the JAX package on the same inputs.

Every module metric, under every ``empty_target_action``, with
``ignore_index``, graded targets (NDCG), int64 query ids and several
updates, and the nine one-query functions, on rows made with numpy from a
seed (a dozen queries of up to 20 rows). Scores are rounded so that ties
form, and hold NaN and both signed zeros: the stable sort must order them
as JAX does. Top-k counts and hits are exact, so the values agree within
atol 1e-6 (float32 means over a dozen queries in two orders); ``top_k``
must be equal and int32. Also: the raw rows buffered at ``update`` and
their canonical form, and int64 ids beyond int32, which the port keeps.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu.functional as jF
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional as tF
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.utils import checks as torch_checks

ATOL = 1e-6
IGNORE = -100


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def assert_same(expected, got):
    if isinstance(expected, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_same(e, g)
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    if np.issubdtype(e.dtype, np.integer):
        assert e.dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(g, e)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=0)


def make_rows(seed=0, queries=12, graded=False, special=False):
    """(preds, target, indexes): int64 ids in a shuffled order, a query with no positive, one with no negative."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 21, queries)
    indexes = np.repeat(rng.permutation(queries * 7)[:queries] * 1000, sizes).astype(np.int64)
    n = indexes.size
    preds = np.round(rng.rand(n), 1).astype(np.float32)
    target = rng.randint(0, 4, n) if graded else (rng.rand(n) < 0.3).astype(np.int64)
    first = indexes == indexes[0]
    target[first] = 0  # no positive
    last = indexes == indexes[-1]
    target[last] = 1  # no negative
    if special:
        preds[::5] = 0.0
        preds[2::5] = -0.0
        preds[3::11] = np.nan
    order = rng.permutation(n)  # rows of a query need not be contiguous
    return preds[order], target[order], indexes[order]


def batches(steps=3, seed=10, ignore=False, **kwargs):
    """Three updates of rows. With ``ignore``, each update gets extra rows whose target is
    ``IGNORE``: dropped, they leave the rows of the same call without ``ignore`` (so the JAX
    package compiles its grouping for one shape of rows fewer)."""
    out = []
    for s in range(steps):
        preds, target, indexes = make_rows(seed=seed + s, **kwargs)
        if ignore:
            extra = np.random.RandomState(seed + 100 + s).randint(0, preds.size, 7)
            preds = np.concatenate([preds, np.full(7, 0.5, np.float32)])
            target = np.concatenate([target, np.full(7, IGNORE, target.dtype)])
            indexes = np.concatenate([indexes, indexes[extra]])
        out.append((preds, target, indexes))
    return out


MODULES = [
    ("RetrievalMRR", {}),
    ("RetrievalMAP", {}),
    ("RetrievalPrecision", {"k": 3}),
    ("RetrievalPrecision", {"k": 25, "adaptive_k": True}),
    ("RetrievalPrecision", {}),
    ("RetrievalRecall", {"k": 4}),
    ("RetrievalRecall", {}),
    ("RetrievalFallOut", {"k": 4}),
    ("RetrievalFallOut", {}),
    ("RetrievalHitRate", {"k": 2}),
    ("RetrievalNormalizedDCG", {"k": 5}),
    ("RetrievalNormalizedDCG", {}),
    ("RetrievalRPrecision", {}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 6}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 30, "adaptive_k": True}),
    ("RetrievalPrecisionRecallCurve", {}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.2, "max_k": 8}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.9}),
]
ACTIONS = ["neg", "pos", "skip"]


def run_modules(cls_name, kwargs, rows_list):
    jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
    for preds, target, indexes in rows_list:
        jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    return jm, tm


@pytest.mark.parametrize("action", ACTIONS)
@pytest.mark.parametrize("cls_name,kwargs", MODULES, ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULES)])
def test_modules_over_several_updates(cls_name, kwargs, action):
    jm, tm = run_modules(cls_name, dict(kwargs, empty_target_action=action), batches())
    assert_same(jm.compute(), tm.compute())


@pytest.mark.parametrize("cls_name,kwargs", MODULES[::2], ids=[f"{m[0]}-{2 * i}" for i, m in enumerate(MODULES[::2])])
def test_modules_with_ignore_index_and_special_scores(cls_name, kwargs):
    jm, tm = run_modules(cls_name, dict(kwargs, ignore_index=IGNORE), batches(ignore=True, special=True))
    assert_same(jm.compute(), tm.compute())


@pytest.mark.parametrize("k", [None, 3])
def test_graded_ndcg(k):
    jm, tm = run_modules("RetrievalNormalizedDCG", {"k": k}, batches(graded=True, special=True))
    assert_same(jm.compute(), tm.compute())


def test_float_relevance_counts_as_hits_where_jax_binarises():
    rows = [(p, (t * 0.5).astype(np.float32), i) for p, t, i in batches(graded=True)]
    jm, tm = run_modules("RetrievalNormalizedDCG", {}, rows)
    assert_same(jm.compute(), tm.compute())
    preds, target, _ = rows[0]
    half = np.clip(target, 0, 0.5).astype(np.float32)
    for fn in ("retrieval_average_precision", "retrieval_r_precision", "retrieval_reciprocal_rank"):
        assert_same(getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(half)),
                    getattr(tF, fn)(torch.from_numpy(preds), torch.from_numpy(half)))


@pytest.mark.parametrize("cls_name", ["RetrievalMAP", "RetrievalFallOut", "RetrievalPrecisionRecallCurve"])
def test_error_action_raises_like_jax(cls_name):
    jm, tm = run_modules(cls_name, {"empty_target_action": "error"}, batches())
    with pytest.raises(ValueError, match="no (positive|negative) target"):
        jm.compute()
    with pytest.raises(ValueError, match="no (positive|negative) target"):
        tm.compute()


def test_no_rows_compute_like_jax():
    for cls_name, kwargs in MODULES[::4]:
        jm, tm = getattr(jmt, cls_name)(**kwargs), getattr(tmt, cls_name)(device="cpu", **kwargs)
        jm._update_count = tm._update_count = 1
        assert_same(jm.compute(), tm.compute())


def test_update_misuse_raises_like_jax():
    preds, target, indexes = make_rows(seed=20)
    cases = [
        (preds, target, None),
        (preds, target, indexes[:-1]),
        (preds, target, indexes.astype(np.float32)),
        (np.round(preds * 10).astype(np.int64), target, indexes),
        (preds, target * 2, indexes),  # not binary
        (preds[:0], target[:0], indexes[:0]),
    ]
    for p, t, i in cases:
        for pkg, cv in ((jmt, jnp.asarray), (tmt, torch.from_numpy)):
            m = pkg.RetrievalMAP() if pkg is jmt else pkg.RetrievalMAP(device="cpu")
            with pytest.raises(ValueError):
                m.update(cv(p), cv(t), None if i is None else cv(i))
    everything_ignored = np.full_like(target, IGNORE)
    for pkg, cv in ((jmt, jnp.asarray), (tmt, torch.from_numpy)):
        m = pkg.RetrievalMAP(ignore_index=IGNORE) if pkg is jmt else pkg.RetrievalMAP(ignore_index=IGNORE, device="cpu")
        with pytest.raises(ValueError, match="non-empty"):
            m.update(cv(preds), cv(everything_ignored), cv(indexes))


def test_bad_arguments_raise_like_jax():
    for cls_name, kwargs in (("RetrievalMAP", {"empty_target_action": "x"}), ("RetrievalMAP", {"ignore_index": 1.5}),
                             ("RetrievalPrecision", {"k": 0}), ("RetrievalPrecision", {"adaptive_k": 1}),
                             ("RetrievalPrecisionRecallCurve", {"max_k": -1}),
                             ("RetrievalRecallAtFixedPrecision", {"min_precision": 2.0})):
        with pytest.raises(ValueError):
            getattr(jmt, cls_name)(**kwargs)
        with pytest.raises(ValueError):
            getattr(tmt, cls_name)(device="cpu", **kwargs)


def test_forward_gives_the_batch_value():
    """Each forward returns JAX's value of its batch; the accumulated value is one instance's fed every batch."""
    rows = [np.concatenate(parts) for parts in zip(*batches())]  # one batch of the shape the other tests use
    shifted = (rows[0], rows[1], rows[2] + 1)  # the same rows as other queries
    jm, tm, every = jmt.RetrievalMAP(), tmt.RetrievalMAP(device="cpu"), tmt.RetrievalMAP(device="cpu")
    for preds, target, indexes in (rows, shifted):
        assert_same(jm(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(indexes)),
                    tm(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes)))
        every.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    assert torch.equal(tm.compute(), every.compute())


def test_rows_are_buffered_raw_and_canonicalised_in_place():
    tm = tmt.RetrievalNormalizedDCG(ignore_index=IGNORE, device="cpu")
    raw = []
    for preds, target, indexes in batches(ignore=True):
        p, t, i = (torch.from_numpy(a.reshape(-1, 1)) for a in (preds, target.astype(np.int64), indexes))
        tm.update(p, t, i)
        raw.append((p, t, i))
    assert all(tm.preds[k] is raw[k][0] and tm.target[k] is raw[k][1] for k in range(3))  # raw appends
    value = tm.compute()
    tm._canonicalize_list_states()
    assert all(r.ndim == 1 for r in tm.preds + tm.target + tm.indexes)
    assert {r.dtype for r in tm.target} == {torch.int32} and {r.dtype for r in tm.indexes} == {torch.int64}
    assert all(bool((r != IGNORE).all()) for r in tm.target)
    snapshot = [list(tm.preds), list(tm.target), list(tm.indexes)]
    tm._canonicalize_list_states()
    assert all(a is b for old, new in zip(snapshot, (tm.preds, tm.target, tm.indexes)) for a, b in zip(old, new))
    tm._computed = None
    torch.testing.assert_close(tm.compute(), value)
    torch.testing.assert_close(pickle.loads(pickle.dumps(tm)).compute(), value)


def test_int32_ids_stay_int32_and_int64_ids_beyond_int32_are_kept():
    preds, target, indexes = make_rows(seed=30)
    small = tmt.RetrievalMRR(device="cpu")
    small.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes.astype(np.int32)))
    small._canonicalize_list_states()
    assert small.indexes[0].dtype == torch.int32
    wide = tmt.RetrievalMRR(device="cpu")
    shifted = indexes + 2**40  # would collide if cut to 32 bits
    wide.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(shifted))
    torch.testing.assert_close(wide.compute(), small.compute())


# -------------------------------------------------------------- functional
FUNCTIONAL = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_precision", {"k": 40, "adaptive_k": True}),
    ("retrieval_recall", {"k": 4}),
    ("retrieval_fall_out", {"k": 4}),
    ("retrieval_hit_rate", {"k": 2}),
    ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {"k": 5}),
    ("retrieval_precision_recall_curve", {"max_k": 8}),
    ("retrieval_precision_recall_curve", {"max_k": 40, "adaptive_k": True}),
]


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("fn,kwargs", FUNCTIONAL, ids=[f"{f[0]}-{i}" for i, f in enumerate(FUNCTIONAL)])
def test_functional_per_query(fn, kwargs, special):
    preds, target, indexes = make_rows(seed=40, special=special)
    for q in np.unique(indexes)[:3]:
        mask = indexes == q
        assert_same(getattr(jF, fn)(jnp.asarray(preds[mask]), jnp.asarray(target[mask]), **kwargs),
                    getattr(tF, fn)(torch.from_numpy(preds[mask]), torch.from_numpy(target[mask]), **kwargs))


def test_functional_graded_ndcg():
    preds, target, _ = make_rows(seed=41, graded=True)
    assert_same(jF.retrieval_normalized_dcg(jnp.asarray(preds), jnp.asarray(target)),
                tF.retrieval_normalized_dcg(torch.from_numpy(preds), torch.from_numpy(target)))


@pytest.mark.parametrize("fn", [f[0] for f in FUNCTIONAL[::2]])
def test_functional_misuse_raises_like_jax(fn):
    preds, target, _ = make_rows(seed=42)
    for p, t, kwargs in ((preds, target[:-1], {}), (preds[:, None], target[:, None], {}),
                         (np.round(preds).astype(np.int64), target, {}), (preds, target * 3, {}),
                         (preds, target, {"k": 0} if "curve" not in fn else {"max_k": 0})):
        if fn in ("retrieval_average_precision", "retrieval_reciprocal_rank", "retrieval_r_precision") and kwargs:
            continue  # no k to refuse
        if fn == "retrieval_normalized_dcg" and t is not target and t.shape == target.shape:
            continue  # graded gains are allowed
        with pytest.raises(ValueError):
            getattr(jF, fn)(jnp.asarray(p), jnp.asarray(t), **kwargs)
        with pytest.raises(ValueError):
            getattr(tF, fn)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)


@pytest.mark.parametrize("cls_name,kwargs", [("RetrievalMAP", {}), ("RetrievalNormalizedDCG", {"k": 4, "ignore_index": IGNORE})])
def test_load_reference_state_of_buffered_rows(cls_name, kwargs):
    """A JAX metric's buffered rows, as numpy arrays, compute the same value in the port."""
    jm = getattr(jmt, cls_name)(**kwargs)
    for preds, target, indexes in batches(ignore="ignore_index" in kwargs):
        jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    state = {k: [np.asarray(r) for r in v] for k, v in jm.metric_state.items()}
    tm = getattr(tmt, cls_name)(device="cpu", **kwargs)
    tmt.load_reference_state(tm, state, update_count=3)
    assert len(tm.preds) == 3
    assert_same(jm.compute(), tm.compute())


@pytest.mark.parametrize("ignore_index", [None, IGNORE])
def test_check_retrieval_inputs_flattens_casts_and_filters_like_jax(ignore_index):
    from metrics_tpu.utils.checks import _check_retrieval_inputs as jax_check
    from metrics_tpu_torch.utils.checks import _check_retrieval_inputs as port_check

    preds, target, indexes = batches(steps=1, ignore=ignore_index is not None)[0]
    args = (indexes.reshape(-1, 1).astype(np.int32), preds.reshape(-1, 1), target.reshape(-1, 1))
    expected = jax_check(*[jnp.asarray(a) for a in args], ignore_index=ignore_index)
    got = port_check(*[torch.from_numpy(a) for a in args], ignore_index=ignore_index)
    assert_same(expected, got)
    wide = port_check(torch.from_numpy(indexes), torch.from_numpy(preds), torch.from_numpy(target),
                      ignore_index=ignore_index)
    assert wide[0].dtype == torch.int64  # int64 ids are kept
    with pytest.raises(ValueError, match="binary"):
        port_check(*[torch.from_numpy(a) for a in (indexes, preds, target * 2)])
