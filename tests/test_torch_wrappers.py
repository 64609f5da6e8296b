"""The port's wrappers against the JAX package on the same inputs.

ClasswiseWrapper (with and without labels, in a collection), MinMaxMetric
(``forward`` and ``compute``, the extrema kept across ``reset``, the wrapped
metric left holding the last batch), MultioutputWrapper (``remove_nans``,
``squeeze_outputs``, ``output_dim``, ``forward``), BootStrapper (both
sampling strategies, every output, ``forward``, an integer base) and
MetricTracker (a metric and a collection, ``maximize`` lists,
``best_metric``). The JAX package's wrappers run their eager paths (forced
as its own tests force them: ``object.__setattr__(m, "_boot_ok", False)`` and
kin); BootStrapper's draws are injected into both packages by replacing each
package's sampler. Float values agree within atol 1e-6 and rtol 1e-5 (float32
reductions of a few dozen terms, and a bootstrap's std and quantiles of ten
clones); counts are equal and of the same dtype. Also: the port's own sampler
on a seeded device generator, the sync of wrapper trees in emulated worlds
(one payload collective, one more with ``cat`` lists; the per-state protocol
two a state), and ``load_reference_state`` from a JAX wrapper's
``state_dict()`` and a JAX tracker's steps.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu.wrappers import bootstrapping as jax_boot
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats
from metrics_tpu_torch.utils import checks as torch_checks
from metrics_tpu_torch.wrappers import bootstrapping as torch_boot
from tests.helpers.torch_sync import TorchFakeGather, install_world

ATOL, RTOL = 1e-6, 1e-5
C, N = 5, 40
DIST_ON = lambda: True  # noqa: E731


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


def assert_same(expected, got):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and sorted(expected) == sorted(got), (sorted(expected), got)
        for k in expected:
            assert_same(expected[k], got[k])
        return
    if isinstance(expected, (list, tuple)):
        assert len(expected) == len(got)
        for e, g in zip(expected, got):
            assert_same(e, g)
        return
    if isinstance(expected, (int, float)) or expected is None:
        assert type(got) is type(expected) and (expected is None or got == pytest.approx(expected, rel=RTOL, abs=ATOL))
        return
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    assert str(e.dtype) == str(got.dtype).replace("torch.", ""), (e.dtype, got.dtype)
    if np.issubdtype(e.dtype, np.floating):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


def cls_batches(seed=0, steps=3, n=N, c=C):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        logits = rng.randn(n, c).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out.append((probs.astype(np.float32), rng.randint(0, c, n)))
    return out


def feed(j, t, batches, method="update"):
    """Both packages fed the same numpy batches; the per-call results of each."""
    outs = []
    for batch in batches:
        jo = getattr(j, method)(*[jnp.asarray(a) for a in batch])
        to = getattr(t, method)(*[torch.from_numpy(np.asarray(a)) for a in batch])
        outs.append((jo, to))
    return outs


def dev(pkg):
    return {"device": "cpu"} if pkg is tmt else {}


# ------------------------------------------------------------------ ClasswiseWrapper
@pytest.mark.parametrize("labels", [None, ["cat", "dog", "fox", "owl", "yak"]])
@pytest.mark.parametrize("method", ["update", "forward"])
def test_classwise(labels, method):
    make = lambda pkg: pkg.ClasswiseWrapper(pkg.Accuracy(num_classes=C, average=None, **dev(pkg)), labels=labels)  # noqa: E731
    j, t = make(jmt), make(tmt)
    for jo, to in feed(j, t, cls_batches(), method):
        if method == "forward":
            assert_same(jo, to)
    assert_same(j.compute(), t.compute())
    assert t.device == t.metric.device
    t.reset()
    assert t.metric.update_count == 0


def test_classwise_in_a_collection_with_prefix():
    def make(pkg):
        return pkg.MetricCollection(
            {"acc_cw": pkg.ClasswiseWrapper(pkg.Accuracy(num_classes=C, average=None, **dev(pkg))),
             "rec": pkg.Recall(num_classes=C, average="macro", **dev(pkg))},
            prefix="val_",
        )

    j, t = make(jmt), make(tmt)
    feed(j, t, cls_batches(seed=1))
    assert_same(j.compute(), t.compute())


def test_classwise_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tmt.ClasswiseWrapper(object())
    with pytest.raises(ValueError):
        tmt.ClasswiseWrapper(tmt.Accuracy(device="cpu"), labels=[1, 2])


# ------------------------------------------------------------------ MinMaxMetric
def binary_batches(seed=0, steps=4, n=12):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 2, n), rng.randint(0, 2, n)) for _ in range(steps)]


def test_minmax_forward_and_compute():
    j, t = jmt.MinMaxMetric(jmt.Accuracy()), tmt.MinMaxMetric(tmt.Accuracy(device="cpu"))
    object.__setattr__(j, "_mm_ok", False)
    for jo, to in feed(j, t, binary_batches(), "forward"):
        assert_same(jo, to)
    # the wrapped metric holds the last batch only, as in JAX
    assert_same(j._base_metric.metric_state, t._base_metric.metric_state)
    assert_same(j.compute(), t.compute())
    feed(j, t, binary_batches(seed=5, steps=2))
    assert_same(j.compute(), t.compute())
    t.reset()
    j.reset()
    assert float(t.max_val) == float(j.max_val) and float(t.min_val) == float(j.min_val)
    assert "min_val" not in t.state_dict()


def test_minmax_refuses_a_value_that_is_not_scalar():
    t = tmt.MinMaxMetric(tmt.Accuracy(num_classes=C, average=None, device="cpu"))
    preds, target = cls_batches(steps=1)[0]
    t.update(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises(RuntimeError):
        t.compute()
    with pytest.raises(ValueError):
        tmt.MinMaxMetric(1.0)


# ------------------------------------------------------------------ MultioutputWrapper
def multioutput_batches(seed=0, steps=3, n=N, outputs=3, nan_rows=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        target = rng.randn(n, outputs).astype(np.float32)
        preds = (target + 0.4 * rng.randn(n, outputs)).astype(np.float32)
        for _ in range(nan_rows):  # NaNs in some rows of some columns, of preds or of target
            arr = preds if rng.rand() < 0.5 else target
            arr[rng.randint(n), rng.randint(outputs)] = np.nan
        out.append((preds, target))
    return out


@pytest.mark.parametrize("remove_nans,nan_rows", [(True, 0), (True, 4), (False, 0)])
@pytest.mark.parametrize("method", ["update", "forward"])
def test_multioutput(remove_nans, nan_rows, method):
    make = lambda pkg: pkg.MultioutputWrapper(pkg.R2Score(**dev(pkg)), num_outputs=3, remove_nans=remove_nans)  # noqa: E731
    j, t = make(jmt), make(tmt)
    object.__setattr__(j, "_mo_ok", False)
    for jo, to in feed(j, t, multioutput_batches(nan_rows=nan_rows), method):
        if method == "forward":
            assert_same(jo, to)
    assert_same(j.compute(), t.compute())
    assert [n for n, _ in t._named_child_metrics()] == ["metrics.0", "metrics.1", "metrics.2"]


def test_multioutput_output_dim_and_squeeze():
    # outputs along dim 0, columns handed to the clones unsqueezed: (1, n) rows of a CosineSimilarity
    make = lambda pkg: pkg.MultioutputWrapper(  # noqa: E731
        pkg.MeanSquaredError(**dev(pkg)), num_outputs=3, output_dim=0, squeeze_outputs=False)
    j, t = make(jmt), make(tmt)
    object.__setattr__(j, "_mo_ok", False)
    feed(j, t, [(p.T.copy(), q.T.copy()) for p, q in multioutput_batches(seed=3, nan_rows=2)])
    assert_same(j.compute(), t.compute())


def test_nan_rows_are_one_host_read_an_update():
    from metrics_tpu_torch.wrappers import multioutput

    t = tmt.MultioutputWrapper(tmt.MeanSquaredError(device="cpu"), num_outputs=4)
    preds, target = multioutput_batches(outputs=4, nan_rows=3, steps=1)[0]
    got = multioutput._get_nan_indices(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), np.isnan(preds).any(1) | np.isnan(target).any(1))
    reads = []
    real = torch.Tensor.cpu
    torch.Tensor.cpu = lambda self, *a, **k: reads.append(1) or real(self, *a, **k)
    try:
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    finally:
        torch.Tensor.cpu = real
    assert len(reads) == 1


# ------------------------------------------------------------------ BootStrapper
def draws_for(strategy, n, clones, seed):
    """One update's per-clone index draws, numpy, the second clone's Poisson draw left empty."""
    rng = np.random.RandomState(seed)
    if strategy == "multinomial":
        return [rng.randint(0, n, size=n) for _ in range(clones)]
    out = [np.repeat(np.arange(n), rng.poisson(1, size=n)) for _ in range(clones)]
    out[1] = np.zeros(0, dtype=np.int64)
    return out


def inject(monkeypatch, strategy, n, clones, updates, seed=0):
    """Both packages' samplers replaced by the same draws, update after update."""
    draws = [draws_for(strategy, n, clones, seed + u) for u in range(updates)]
    jax_queue = [d for update in draws for d in update]
    torch_queue = list(draws)

    def jax_sampler(size, sampling_strategy="poisson", rng=None):
        assert size == n and sampling_strategy == strategy
        return jax_queue.pop(0)

    def torch_sampler(size, num_bootstraps, sampling_strategy, generator):
        assert size == n and num_bootstraps == clones and sampling_strategy == strategy
        return [torch.from_numpy(d).to(torch.int64) for d in torch_queue.pop(0)]

    monkeypatch.setattr(jax_boot, "_bootstrap_sampler", jax_sampler)
    monkeypatch.setattr(torch_boot, "_bootstrap_sampler", torch_sampler)
    return jax_queue, torch_queue


def make_boot(pkg, base, strategy, **kwargs):
    m = pkg.BootStrapper(base, sampling_strategy=strategy, **kwargs)
    if pkg is jmt:
        object.__setattr__(m, "_boot_ok", False)  # the eager path, as JAX's own tests force it
    return m


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("outputs", [{}, {"quantile": 0.9, "raw": True}, {"mean": False, "std": False, "raw": True},
                                     {"quantile": np.array([0.025, 0.5, 0.975], np.float32)}], ids=str)
def test_bootstrapper(strategy, outputs, monkeypatch):
    clones, steps = 10, 3
    jq, tq = inject(monkeypatch, strategy, N, clones, steps)
    kw = dict(num_bootstraps=clones, **outputs)
    jkw = {**kw, "quantile": jnp.asarray(kw["quantile"])} if "quantile" in kw else kw
    tkw = {**kw, "quantile": torch.from_numpy(np.asarray(kw["quantile"]))} if "quantile" in kw else kw
    j = make_boot(jmt, jmt.Accuracy(num_classes=C, average="macro"), strategy, **jkw)
    t = make_boot(tmt, tmt.Accuracy(num_classes=C, average="macro", device="cpu"), strategy, **tkw)
    feed(j, t, cls_batches(seed=4, steps=steps))
    assert not jq and not tq
    for jm, tm in zip(j.metrics, t.metrics):
        assert_same(jm.metric_state, tm.metric_state)
        assert jm.update_count == tm.update_count == steps
    assert_same(j.compute(), t.compute())


def test_bootstrapper_forward(monkeypatch):
    clones, steps = 6, 2
    inject(monkeypatch, "multinomial", N, clones, 2 * steps)  # forward updates twice
    j = make_boot(jmt, jmt.MeanSquaredError(), "multinomial", num_bootstraps=clones)
    t = make_boot(tmt, tmt.MeanSquaredError(device="cpu"), "multinomial", num_bootstraps=clones)
    batches = [(p[:, 0].copy(), q[:, 0].copy()) for p, q in multioutput_batches(seed=6, steps=steps)]
    for jo, to in feed(j, t, batches, "forward"):
        assert_same(jo, to)
    assert_same(j.compute(), t.compute())


def test_bootstrapper_of_an_integer_metric(monkeypatch):
    clones = 4
    inject(monkeypatch, "poisson", N, clones, 2)
    j = make_boot(jmt, jmt.ConfusionMatrix(num_classes=C), "poisson", num_bootstraps=clones, raw=True, quantile=0.5)
    t = make_boot(tmt, tmt.ConfusionMatrix(num_classes=C, device="cpu"), "poisson", num_bootstraps=clones, raw=True,
                  quantile=0.5)
    feed(j, t, cls_batches(seed=7, steps=2))
    assert_same(j.compute(), t.compute())


def test_bootstrap_sampler_on_a_seeded_generator():
    g = torch.Generator().manual_seed(3)
    draws = torch_boot._bootstrap_sampler(50, 8, "poisson", g)
    assert len(draws) == 8 and all(d.dtype == torch.int64 for d in draws)
    for d in draws:  # each row i appears Poisson(1) times, rows in order
        assert bool((d[1:] >= d[:-1]).all()) and (d.numel() == 0 or (0 <= int(d.min()) and int(d.max()) < 50))
    total = sum(d.numel() for d in draws)
    assert 300 < total < 500  # 400 expected, sd 20
    again = torch_boot._bootstrap_sampler(50, 8, "poisson", torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    multi = torch_boot._bootstrap_sampler(50, 8, "multinomial", g)
    assert len(multi) == 8 and all(d.shape == (50,) and 0 <= int(d.min()) and int(d.max()) < 50 for d in multi)
    with pytest.raises(ValueError):
        torch_boot._bootstrap_sampler(50, 8, "binomial", g)


def test_bootstrapper_with_its_own_generator_repeats_with_the_seed():
    values = []
    for _ in range(2):
        t = tmt.BootStrapper(tmt.Accuracy(num_classes=C, average="macro", device="cpu"), num_bootstraps=5)
        assert t.generator.device == t.device
        t.generator.manual_seed(11)
        for preds, target in cls_batches(seed=8, steps=2):
            t.update(torch.from_numpy(preds), torch.from_numpy(target))
        values.append(t.compute())
    assert all(torch.equal(values[0][k], values[1][k]) for k in values[0])
    with pytest.raises(ValueError):
        tmt.BootStrapper(tmt.Accuracy(device="cpu"), sampling_strategy="binomial")


# ------------------------------------------------------------------ MetricTracker
def regression_steps(seed=0, epochs=3, steps=2, n=N):
    rng = np.random.RandomState(seed)
    out = []
    for e in range(epochs):
        epoch = []
        for _ in range(steps):
            target = rng.randn(n).astype(np.float32)
            epoch.append(((target + (0.2 + 0.3 * ((e * 7) % 3)) * rng.randn(n)).astype(np.float32), target))
        out.append(epoch)
    return out


@pytest.fixture
def jax_deepcopy_history(monkeypatch):
    """The JAX tracker's own fallback, a deep copy per step: its packed history needs the JAX
    package's state journal, which the port does not have (and which jax 0.9 cannot run)."""
    from metrics_tpu.ops import journal

    monkeypatch.setattr(journal, "journalable", lambda nodes: "history kept as deep copies")


def track(j, t, epochs):
    for epoch in epochs:
        j.increment()
        t.increment()
        feed(j, t, epoch)


@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_of_a_metric(maximize, jax_deepcopy_history):
    j = jmt.MetricTracker(jmt.MeanSquaredError(), maximize=maximize)
    t = tmt.MetricTracker(tmt.MeanSquaredError(device="cpu"), maximize=maximize)
    with pytest.raises(ValueError):
        t.update(torch.zeros(2), torch.zeros(2))
    track(j, t, regression_steps())
    assert j.n_steps == t.n_steps == 3
    assert_same(j.compute_all(), t.compute_all())
    assert_same(j.compute(), t.compute())
    assert_same(j.best_metric(), t.best_metric())
    assert_same(j.best_metric(return_step=True), t.best_metric(return_step=True))
    t.reset_all()
    assert all(t._step_metric(i).update_count == 0 for i in range(t.n_steps))


@pytest.mark.parametrize("maximize", [True, [False, True]], ids=["scalar", "list"])
def test_tracker_of_a_collection(maximize, jax_deepcopy_history):
    def make(pkg):
        return pkg.MetricTracker(
            pkg.MetricCollection([pkg.MeanSquaredError(**dev(pkg)), pkg.ExplainedVariance(**dev(pkg))]),
            maximize=maximize,
        )

    j, t = make(jmt), make(tmt)
    track(j, t, regression_steps(seed=1))
    assert_same(j.compute_all(), t.compute_all())
    assert_same(j.best_metric(return_step=True), t.best_metric(return_step=True))
    assert_same(j.best_metric(), t.best_metric())


def test_tracker_forward_and_the_checks_of_its_arguments(jax_deepcopy_history):
    j, t = jmt.MetricTracker(jmt.MeanAbsoluteError()), tmt.MetricTracker(tmt.MeanAbsoluteError(device="cpu"))
    j.increment()
    t.increment()
    for jo, to in feed(j, t, regression_steps(seed=2)[0], "__call__"):
        assert_same(jo, to)
    with pytest.raises(TypeError):
        tmt.MetricTracker([1])
    with pytest.raises(ValueError):
        tmt.MetricTracker(tmt.MeanAbsoluteError(device="cpu"), maximize=[True])
    with pytest.raises(ValueError):
        tmt.MetricTracker(tmt.MetricCollection([tmt.MeanAbsoluteError(device="cpu")]), maximize=[True, False])


# ------------------------------------------------------------------ sync of wrapper trees
def boot_rank(seed, clones=7, base=None):
    t = tmt.BootStrapper(base or tmt.Accuracy(num_classes=C, average="macro", device="cpu"), num_bootstraps=clones)
    t.generator.manual_seed(seed)
    for preds, target in cls_batches(seed=seed, steps=2):
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    return t


def node_states(m):
    return [{k: (torch.cat(v) if isinstance(v, list) else v) for k, v in n.metric_state.items()}
            for n in [m] + [c for _, c in m._named_child_metrics()]]


@pytest.mark.parametrize("world", [2, 3])
def test_a_bootstrapper_syncs_in_one_payload_collective(world, monkeypatch):
    ranks = [boot_rank(r) for r in range(world)]
    want = [node_states(r) for r in ranks]
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    stats = collective_stats()
    n_states = sum(len(m._defaults) for m in ranks[0].metrics)
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (0, 1)
    assert stats["sync_states_coalesced"] == n_states
    for i, clone in enumerate(ranks[0].metrics):
        for name, value in clone.metric_state.items():
            assert torch.equal(value, sum(w[i + 1][name] for w in want)), (i, name)
    ranks[0].unsync()
    for i, clone in enumerate(ranks[0].metrics):
        assert all(torch.equal(v, want[0][i + 1][k]) for k, v in clone.metric_state.items())


def test_a_bootstrapper_computes_synced_and_per_state_agrees(monkeypatch):
    ranks = [boot_rank(10 + r) for r in range(2)]
    per_state = [boot_rank(10 + r) for r in range(2)]
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    coalesced = ranks[0].compute()
    ranks[0].unsync()
    reset_collective_stats()
    per_state[0].sync(dist_sync_fn=TorchFakeGather(per_state), distributed_available=DIST_ON)
    for key, value in per_state[0].compute().items():
        assert torch.equal(value, coalesced[key]), key


def test_wrapper_trees_with_cat_lists_add_one_metadata_collective(monkeypatch):
    def rank(seed):
        t = tmt.MultioutputWrapper(tmt.SpearmanCorrCoef(device="cpu"), num_outputs=3)
        for preds, target in multioutput_batches(seed=seed, steps=2):
            t.update(torch.from_numpy(preds), torch.from_numpy(target))
        return t

    ranks = [rank(20 + r) for r in range(3)]
    want = [node_states(r) for r in ranks]
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 1)
    for i, clone in enumerate(ranks[0].metrics):
        assert torch.equal(clone.preds, torch.cat([w[i + 1]["preds"] for w in want]))
    ranks[0].unsync()


def test_wrappers_in_a_collection_sync_as_one_payload(monkeypatch):
    def suite(seed):
        s = tmt.MetricCollection({
            "cw": tmt.ClasswiseWrapper(tmt.Accuracy(num_classes=C, average=None, device="cpu")),
            "mm": tmt.MinMaxMetric(tmt.Precision(num_classes=C, average="macro", device="cpu")),
            "f1": 2 * tmt.Precision(num_classes=C, average="macro", device="cpu"),
        })
        for preds, target in cls_batches(seed=seed, steps=2):
            s.update(torch.from_numpy(preds), torch.from_numpy(target))
        return s

    ranks = [suite(30 + r) for r in range(2)]
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (0, 1)
    ranks[0].unsync()


# ------------------------------------------------------------------ state carried across from JAX
def test_load_a_jax_bootstrapper_state_dict(monkeypatch):
    clones = 6
    inject(monkeypatch, "poisson", N, clones, 2)
    j = make_boot(jmt, jmt.Accuracy(num_classes=C, average="macro"), "poisson", num_bootstraps=clones, quantile=0.5)
    for preds, target in cls_batches(seed=9, steps=2):
        j.update(jnp.asarray(preds), jnp.asarray(target))
    j.persistent(True)
    sd = j.state_dict()
    assert any(k.startswith("metrics.3.") for k in sd)
    t = tmt.BootStrapper(tmt.Accuracy(num_classes=C, average="macro", device="cpu"), num_bootstraps=clones, quantile=0.5)
    load_reference_state(t, sd, update_count=2, mode="multi-class")
    assert_same(j.compute(), t.compute())
    nested = tmt.BootStrapper(tmt.Accuracy(num_classes=C, average="macro", device="cpu"), num_bootstraps=clones,
                              quantile=0.5)
    load_reference_state(nested, {f"metrics.{i}": dict(m.metric_state) for i, m in enumerate(j.metrics)},
                         update_count=2, mode="multi-class")
    assert_same(j.compute(), nested.compute())


def test_load_jax_compositions_and_minmax():
    j = jmt.MinMaxMetric(jmt.Precision(num_classes=C, average="macro")) + jmt.Recall(num_classes=C, average="macro")
    object.__setattr__(j.metric_a, "_mm_ok", False)
    for preds, target in cls_batches(seed=12, steps=2):
        j.update(jnp.asarray(preds), jnp.asarray(target))
    j.persistent(True)
    t = (tmt.MinMaxMetric(tmt.Precision(num_classes=C, average="macro", device="cpu"))
         + tmt.Recall(num_classes=C, average="macro", device="cpu"))
    load_reference_state(t, j.state_dict(), update_count=2)
    jv, tv = j.metric_a.compute(), t.metric_a.compute()
    assert_same(jv, tv)
    assert_same(j.metric_b.compute(), t.metric_b.compute())


def test_load_jax_tracker_steps(jax_deepcopy_history):
    j = jmt.MetricTracker(jmt.MeanSquaredError())
    for epoch in regression_steps(seed=13):
        j.increment()
        for preds, target in epoch:
            j.update(jnp.asarray(preds), jnp.asarray(target))
    steps = [{k: np.asarray(v) for k, v in j._step_metric(i).metric_state.items()} for i in range(j.n_steps)]
    t = tmt.MetricTracker(tmt.MeanSquaredError(device="cpu"))
    load_reference_state(t, steps, update_count=2)
    assert t.n_steps == 3
    assert_same(j.compute_all(), t.compute_all())
    assert_same(j.best_metric(return_step=True), t.best_metric(return_step=True))
    with pytest.raises(TypeError):
        load_reference_state(t, {"sum_squared_error": np.zeros(())})


def test_wrapper_device_follows_the_base_metric():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for wrapper in (tmt.BootStrapper(tmt.SumMetric(device="cpu")), tmt.MinMaxMetric(tmt.SumMetric(device="cpu")),
                        tmt.MultioutputWrapper(tmt.SumMetric(device="cpu"), 2)):
            assert wrapper.device == torch.device("cpu")
            moved = wrapper.to(torch.float64)
            assert all(c.device == torch.device("cpu") for _, c in moved._named_child_metrics())
