"""The port's sharded states (``metrics_tpu_torch/parallel/sharding.py``) against the JAX package's.

The invariants of JAX's ``tests/bases/test_sharded_state.py``, in a real
four-process Gloo world (``tests/helpers/torch_sync.sharding_world_worker``,
which imports no JAX): a binned curve's ``(C, T)`` states, a macro F1's class
vectors and a ``ConfusionMatrix(1000)`` split on their class axis keep their
placements across updates, hold ``1/n`` of the state on each process, and
compute the unsharded values, which equal JAX's on the same inputs. Each case
runs with the batch replicated on every process (``Replicate()`` DTensors) and
with each process's own rows (plain tensors, checked against JAX on the rows of
every process concatenated), and the binned curve on a ``(dp, c)`` mesh as
JAX's ``test_dp_times_c``. A list state named in a spec raises, a spec key that
names no state raises and batch arguments split two ways raise. States of
another reduction update whole when they and the batch are replicated, and
merge by their sync rule under a data-parallel batch: a ``PearsonCorrCoef``
placed by ``infer_state_pspecs`` and a probe of ``mean``, ``None`` (split on its
rows) and custom states, fed each rank's own rows, equal JAX's jitted update
over the ``dp``-sharded global batch. Then the per-leaf inference rules against
JAX's on a mesh of four devices, and ``state_shardings_for`` on one process.
Values within atol 1e-6 (1e-5 for the probe's sums of 64 float32 rows, whose
order differs); the seed is 5.
"""
import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.parallel import sharding as jsharding
from metrics_tpu_torch import functional_core
from metrics_tpu_torch.parallel import sharding
from tests.helpers.torch_sync import run_world, sharding_world_worker

ATOL = 1e-6
WORLD = 4
SEED = 5


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``; this file's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


@pytest.fixture(scope="module")
def ranks():
    return run_world(sharding_world_worker, WORLD, SEED, timeout=150.0)


REFERENCE = {
    "binned": lambda: jmt.BinnedPrecisionRecallCurve(num_classes=8, thresholds=5),
    "f1": lambda: jmt.F1Score(num_classes=8, average="macro"),
    "confmat": lambda: jmt.ConfusionMatrix(num_classes=1000),
}
LOCAL = {"binned": {n: (2, 5) for n in ("TPs", "FPs", "FNs")}, "f1": {n: (2,) for n in ("tp", "fp", "tn", "fn")},
         "confmat": {"confmat": (250, 1000)}}
CASES = [(name, mode) for name in sorted(REFERENCE) for mode in ("replicated", "dp")] + [("binned", "dp_c")]


def flat(value):
    if isinstance(value, (tuple, list)):
        return np.concatenate([flat(v) for v in value])
    return np.asarray(torch.as_tensor(value).detach().cpu() if isinstance(value, torch.Tensor) else value).ravel()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_sharded_states_keep_their_placement_and_equal_the_reference(ranks, case):
    name, mode = case
    placements = [("Replicate", None), ("Shard", 0)] if mode == "dp_c" else [("Shard", 0)]
    local = {k: (v[0] * 2,) + v[1:] for k, v in LOCAL[name].items()} if mode == "dp_c" else LOCAL[name]
    for rank in ranks:
        got = rank[case]
        assert got["states_equal"]
        assert all(p == placements for p in got["placements"].values()), got["placements"]
        assert got["local_shapes"] == local
        np.testing.assert_allclose(flat(got["value"]), flat(got["plain_value"]), atol=ATOL)
        np.testing.assert_allclose(flat(got["value"]), flat(ranks[0][case]["value"]), atol=0)
    preds, target = (t.numpy() for t in ranks[0][case]["inputs"])
    ref = REFERENCE[name]()
    for step in range(2):
        ref.update(jnp.asarray(preds[step]), jnp.asarray(target[step]))
    np.testing.assert_allclose(flat(ranks[0][case]["value"]), flat(ref.compute()), atol=ATOL)
    if mode == "dp_c":  # JAX's own dp x c program on the same rows
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2), ("dp", "c"))
        init, update, compute = REFERENCE[name]().as_functions()
        states = jsharding.shard_states(init(), mesh, {n: JP("c", None) for n in ("TPs", "FPs", "FNs")})
        for step in range(2):
            states = jax.jit(update)(states, jax.device_put(preds[step], NamedSharding(mesh, JP("dp", None))),
                                     jax.device_put(target[step], NamedSharding(mesh, JP("dp"))))
        np.testing.assert_allclose(flat(ranks[0][case]["value"]), flat(compute(states)), atol=ATOL)


def test_the_helpers_raise_as_the_reference(ranks):
    errors = ranks[0]["errors"]
    assert "cat" in errors["list"] and "tps" in errors["unknown"] and "disagree" in errors["mixed_batch"]
    mesh = Mesh(np.array(jax.devices()[:1]), ("c",))
    with pytest.raises(ValueError, match="cat"):
        jsharding.state_shardings(jmt.AUROC().as_functions()[0](), mesh, {"preds": JP("c")})
    with pytest.raises(ValueError, match="tps"):
        jsharding.state_shardings(jmt.BinnedPrecisionRecallCurve(num_classes=8, thresholds=5).as_functions()[0](),
                                  mesh, {"tps": JP("c", None)})


def _jax_dp_update(make, specs, steps):
    """JAX's jitted update of ``make()``'s states, placed by ``specs`` on a ``dp`` mesh of four devices, over
    each step's arguments as global batches sharded on their rows over ``dp``; the computed value."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    init, update, compute = make().as_functions()
    states = jsharding.shard_states(init(), mesh, specs(init(), mesh))
    for args in steps:
        states = jax.jit(update)(states, *(jax.device_put(a, NamedSharding(mesh, JP("dp"))) for a in args))
    return compute(states)


def test_states_of_other_reductions_update_when_replicated_and_raise_under_a_data_parallel_batch(ranks):
    other = ranks[0]["replicated_other"]
    assert other["probe"]
    xs, ys = (t.numpy() for t in other["pearson_inputs"])
    got, twin = other["pearson"]
    ref = jmt.PearsonCorrCoef()
    for step in range(2):
        ref.update(jnp.asarray(xs[step]), jnp.asarray(ys[step]))
    np.testing.assert_allclose(flat(got), flat(twin), atol=0)
    np.testing.assert_allclose(flat(got), flat(ref.compute()), atol=ATOL)
    for rank in ranks:  # under a data-parallel batch a None and a mean state merge now: nothing raises
        assert rank["errors"]["mean_spec"] is None and rank["errors"]["pearson_dp"] is None
    # each rank's own rows, the six moments (spec None) placed by infer_state_pspecs: JAX's update of the
    # dp-sharded global batch
    xs, ys = (t.numpy() for t in ranks[0]["dp_other"]["pearson_inputs"])
    want = _jax_dp_update(jmt.PearsonCorrCoef, lambda states, mesh: {k: v for k, v in jsharding.infer_state_pspecs(
        states, mesh, jmt.PearsonCorrCoef()._reduction_specs).items() if v is not None}, [(xs[s], ys[s]) for s in range(2)])
    for rank in ranks:
        dp = rank["dp_other"]
        assert all(p == ["Replicate"] for p in dp["pearson_placements"].values()), dp["pearson_placements"]
        np.testing.assert_allclose(flat(dp["pearson"]), flat(want), atol=ATOL)


def _jax_sum_rows(stacked):
    return stacked.sum(axis=0)


class _JaxRowProbe(jmt.Metric):
    """``tests/helpers/torch_sync.RowProbe`` in the JAX package."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", jnp.zeros(3), "mean")
        self.add_state("per_slot", jnp.zeros((4, 3)), None)
        self.add_state("folded", jnp.zeros(3), _jax_sum_rows)
        self.add_state("total", jnp.zeros(3), "sum")

    def update(self, x):
        self.avg = self.avg + x.mean(axis=0)
        self.per_slot = self.per_slot + x.reshape(-1, 4, 3).sum(axis=0)
        self.folded = self.folded + 2 * x.sum(axis=0)
        self.total = self.total + x.sum(axis=0)

    def compute(self):
        return {k: getattr(self, k) for k in ("avg", "per_slot", "folded", "total")}


def test_mean_none_and_custom_states_under_a_data_parallel_batch_equal_the_reference(ranks):
    rows = ranks[0]["dp_other"]["rows_inputs"].numpy()
    want = _jax_dp_update(_JaxRowProbe, lambda states, mesh: {"per_slot": JP("dp")}, [(rows[s],) for s in range(2)])
    for i, rank in enumerate(ranks):
        dp = rank["dp_other"]
        assert dp["rows_placements"] == ["Shard"] and tuple(dp["rows_local"].shape) == (1, 3)
        for key, value in want.items():
            np.testing.assert_allclose(flat(dp["rows"][key]), flat(value), atol=1e-5, err_msg=key)
        np.testing.assert_allclose(flat(dp["rows_local"]), np.asarray(want["per_slot"])[i], atol=1e-5)
    # the spec probe (its own x on each rank, every state replicated): each reduction's merge of the ranks'
    x = np.stack([np.arange(3, dtype=np.float32) + r for r in range(WORLD)])
    got = ranks[0]["dp_other"]["probe"]
    expect = {"s_sum": x.sum(0), "s_mean": (x / 4).mean(0), "s_max": np.maximum(x.max(0), 0),
              "s_min": np.minimum(x.min(0), 0), "stacked": x[:, :2].sum(0), "custom": 2 * x.sum(0)}
    for key, value in expect.items():
        np.testing.assert_allclose(flat(got[key]), value, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(flat(got["rows"]), x[0], atol=0)  # a plain list state keeps this rank's rows


def test_inferred_specs_equal_the_reference(ranks):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("c",))
    states = {"rows": jnp.zeros((8, 3)), "empty": jnp.zeros((0,)), "odd": jnp.zeros((5, 4)), "total": jnp.zeros(()),
              "pairs": jnp.zeros((3, 2)), "buffered": [jnp.zeros(2)]}
    specs = {"rows": "cat", "empty": "cat", "odd": None, "total": "sum", "pairs": "max", "buffered": "cat"}
    ref = jsharding.infer_state_pspecs(states, mesh, specs)
    assert ranks[0]["inferred"] == {k: None if v is None else tuple(v) for k, v in ref.items()}
    assert ranks[0]["inferred"]["rows"] == ("c",) and ranks[0]["inferred"]["odd"] == (None, "c")


class _Mesh:
    """A stand-in with a ``DeviceMesh``'s names and sizes, for the inference on one process."""

    mesh_dim_names = ("dp",)
    ndim = 1

    def size(self, dim=None):
        return 2


def test_state_shardings_for_a_collection_and_the_spec_forms():
    suite = tmt.MetricCollection({"acc": tmt.Accuracy(num_classes=4, device="cpu"), "cat": tmt.CatMetric(device="cpu")})
    out = functional_core.state_shardings_for(suite, suite.init(), _Mesh())
    assert out.states["cat"]["value"] is None
    assert {k: v.spec for k, v in out.states["acc"].items()} == {k: sharding.PartitionSpec() for k in out.states["acc"]}
    assert repr(sharding.PartitionSpec("c", None)) == repr(JP("c", None)).replace("PartitionSpec", "PartitionSpec")
    assert tmt.infer_state_pspecs({"x": torch.zeros(4)}, _Mesh(), {"x": "cat"}) == {"x": sharding.PartitionSpec("dp")}
    assert tmt.infer_state_shardings({"x": torch.zeros(4)}, _Mesh(), {"x": "sum"})["x"].spec == sharding.PartitionSpec()
