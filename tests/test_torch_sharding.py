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
names no state raises, batch arguments split two ways raise, and a state of
another reduction updates only when it and the batch are replicated: JAX
updates a ``PearsonCorrCoef`` under a data-parallel batch where the port raises
(``ROADMAP.md`` Queue 3). Then the per-leaf inference rules against JAX's on a
mesh of four devices, and ``state_shardings_for`` on one process. Values within
atol 1e-6; the seed is 5.
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
    for rank in ranks:  # the gap against JAX: the port raises for a replicated None/mean state under a dp batch
        assert "mean" in rank["errors"]["mean_spec"] and "None" in rank["errors"]["pearson_dp"]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    init, update, compute = jmt.PearsonCorrCoef().as_functions()
    states = jsharding.shard_states(init(), mesh, {k: v for k, v in jsharding.infer_state_pspecs(
        init(), mesh, jmt.PearsonCorrCoef()._reduction_specs).items() if v is not None})
    rows = [jax.device_put(a[0], NamedSharding(mesh, JP("dp"))) for a in (xs, ys)]
    oracle = jmt.PearsonCorrCoef()
    oracle.update(jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    np.testing.assert_allclose(flat(compute(jax.jit(update)(states, *rows))), flat(oracle.compute()), atol=ATOL)


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
