"""The port's metric arithmetic (``CompositionalMetric``) against the JAX package on the same inputs.

Every binary operator with a metric, a Python scalar and a tensor as the
other operand, each reflected form, the comparisons, the unary operators
(``+`` is ``abs``, ``-`` is ``-abs``, ``~`` is a logical not) and ``[idx]``;
``forward``, ``compute`` and ``reset`` of compositions of real metrics;
hashing by identity, a metric that is not iterable, the ``state_dict`` keys
of the children, a scalar operand that follows ``.to()``, pickling, and the
sync of a composition tree in one payload collective. Values agree within
atol 1e-6 and rtol 1e-6 (one float32 operation on each side); integer and
boolean results are equal, of the same dtype.
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.utils import checks as jax_checks
from metrics_tpu_torch.metric import CompositionalMetric
from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats
from metrics_tpu_torch.utils import checks as torch_checks
from tests.helpers.torch_sync import install_world

ATOL, RTOL = 1e-6, 1e-6

FLOAT_A, FLOAT_B = [2.0, -3.5, 0.25], [3.0, 1.5, -2.0]
INT_A, INT_B = [6, -7, 12], [5, 2, 7]


@pytest.fixture(autouse=True)
def _full_validation():
    jax_prev, torch_prev = jax_checks._get_validation_mode(), torch_checks._get_validation_mode()
    jax_checks.set_validation_mode("full")
    torch_checks.set_validation_mode("full")
    yield
    jax_checks.set_validation_mode(jax_prev)
    torch_checks.set_validation_mode(torch_prev)


class JaxValue(jmt.Metric):
    """The running sum of what it is fed, in its dtype."""

    full_state_update = False

    def __init__(self, dtype=jnp.float32, shape=(3,)):
        super().__init__()
        self.add_state("x", jnp.zeros(shape, dtype), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + jnp.asarray(x, self.x.dtype)

    def compute(self):
        return self.x


class TorchValue(tmt.Metric):
    full_state_update = False

    def __init__(self, dtype=torch.float32, shape=(3,), **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.zeros(shape, dtype=dtype), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=self.x.dtype)

    def compute(self):
        return self.x


def pair(kind, values=None):
    """Fed JAX and port metrics: ``kind`` "float" or "int", first operand's values unless given."""
    jdt, tdt = (jnp.float32, torch.float32) if kind == "float" else (jnp.int32, torch.int32)
    j, t = JaxValue(jdt), TorchValue(tdt)
    values = values if values is not None else (FLOAT_A if kind == "float" else INT_A)
    j.update(np.asarray(values))
    t.update(np.asarray(values))
    return j, t


def assert_same(expected, got):
    e = np.asarray(expected)
    assert isinstance(got, torch.Tensor), type(got)
    g = got.detach().cpu().numpy()
    assert e.shape == g.shape, (e.shape, g.shape)
    assert str(e.dtype) == str(got.dtype).replace("torch.", ""), (e.dtype, got.dtype)
    if np.issubdtype(e.dtype, np.floating):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


BINARY = ["add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "matmul", "and", "or", "xor",
          "eq", "ne", "lt", "le", "gt", "ge"]
BITWISE = {"and", "or", "xor"}
COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge"}


def kinds(op):
    return ["int"] if op in BITWISE else ["float", "int"]


@pytest.mark.parametrize("op,kind", [(op, k) for op in BINARY for k in kinds(op)])
def test_metric_with_metric(op, kind):
    ja, ta = pair(kind)
    jb, tb = pair(kind, FLOAT_B if kind == "float" else INT_B)
    if op == "pow" and kind == "int":
        jb, tb = pair(kind, [2, 0, 3])  # an integer power takes no negative exponent
    comp = getattr(ta, f"__{op}__")(tb)
    assert isinstance(comp, CompositionalMetric)
    assert_same(getattr(ja, f"__{op}__")(jb).compute(), comp.compute())


SCALARS = {"float": [2, 0.5, np.array([1.5, -1.0, 4.0], dtype=np.float32)],
           "int": [3, np.array([2, 5, 3], dtype=np.int32)]}


@pytest.mark.parametrize("reflected", [False, True], ids=["plain", "reflected"])
@pytest.mark.parametrize("op,kind", [(op, k) for op in BINARY for k in kinds(op)])
def test_metric_with_scalar_and_tensor(op, kind, reflected):
    name = f"__r{op}__" if reflected and op not in COMPARISONS else f"__{op}__"
    for operand in SCALARS[kind]:
        if op == "matmul" and np.ndim(operand) == 0:
            continue  # a product of matrices takes no scalar, in either package
        if op in BITWISE and isinstance(operand, float):
            continue
        ja, ta = pair(kind)
        if reflected and op == "pow" and kind == "int":
            ja, ta = pair(kind, [1, 0, 2])
        expected = getattr(ja, name)(jnp.asarray(operand) if isinstance(operand, np.ndarray) else operand).compute()
        comp = getattr(ta, name)(torch.from_numpy(operand) if isinstance(operand, np.ndarray) else operand)
        assert_same(expected, comp.compute())


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("op", ["abs", "neg", "pos", "invert"])
def test_unary(op, kind):
    ja, ta = pair(kind)
    assert_same(getattr(ja, f"__{op}__")().compute(), getattr(ta, f"__{op}__")().compute())


@pytest.mark.parametrize("idx", [0, -1, slice(1, None), slice(None, None, 2)], ids=str)
def test_getitem(idx):
    ja, ta = pair("float")
    assert_same(ja[idx].compute(), ta[idx].compute())


def test_nested_compositions():
    ja, ta = pair("float")
    jb, tb = pair("float", FLOAT_B)
    assert_same(((ja + jb) * 2 - abs(jb) / 4).compute(), ((ta + tb) * 2 - abs(tb) / 4).compute())


def classification_batches(seed=0, steps=3, n=32, c=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, c).astype(np.float32), rng.randint(0, c, n)) for _ in range(steps)]


def f1_composition(pkg):
    dev = {"device": "cpu"} if pkg is tmt else {}
    p = pkg.Precision(num_classes=4, average="macro", **dev)
    r = pkg.Recall(num_classes=4, average="macro", **dev)
    return 2 * p * r / (p + r)


def test_forward_compute_and_reset_follow_the_children():
    j = jmt.Accuracy(num_classes=4) + jmt.Precision(num_classes=4, average="macro")
    t = tmt.Accuracy(num_classes=4, device="cpu") + tmt.Precision(num_classes=4, average="macro", device="cpu")
    for preds, target in classification_batches():
        assert_same(j(jnp.asarray(preds), jnp.asarray(target)), t(torch.from_numpy(preds), torch.from_numpy(target)))
    assert_same(j.compute(), t.compute())
    t.reset()
    assert t.metric_a.update_count == 0 and t.metric_b.update_count == 0
    j.reset()
    preds, target = classification_batches(seed=1, steps=1)[0]
    j.update(jnp.asarray(preds), jnp.asarray(target))
    t.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(j.compute(), t.compute())


def test_f1_of_precision_and_recall():
    j, t = f1_composition(jmt), f1_composition(tmt)
    for preds, target in classification_batches(seed=2):
        j.update(jnp.asarray(preds), jnp.asarray(target))
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(j.compute(), t.compute())


def test_kwargs_are_filtered_per_child():
    j = jmt.MeanMetric() + jmt.SumMetric()
    t = tmt.MeanMetric(device="cpu") + tmt.SumMetric(device="cpu")
    x, w = np.array([1.0, 2.0, 4.0], np.float32), np.array([1.0, 0.0, 3.0], np.float32)
    j.update(jnp.asarray(x), weight=jnp.asarray(w))
    t.update(torch.from_numpy(x), weight=torch.from_numpy(w))
    assert_same(j.compute(), t.compute())


def test_metrics_hash_by_identity_and_are_not_iterable():
    a, b = TorchValue(), TorchValue()
    assert hash(a) != hash(b) and hash(a) == hash(a)
    assert {a: 1, b: 2}[a] == 1
    comp = a + b
    modules = list(comp.named_modules())
    assert [m for _, m in modules][1] is a
    with pytest.raises(TypeError):
        iter(a)
    assert isinstance(a == b, CompositionalMetric)


def test_state_dict_keys_of_the_children_match_jax():
    j, t = f1_composition(jmt), f1_composition(tmt)
    j.persistent(True)
    t.persistent(True)
    for preds, target in classification_batches(seed=3, steps=1):
        j.update(jnp.asarray(preds), jnp.asarray(target))
        t.update(torch.from_numpy(preds), torch.from_numpy(target))
    jsd, tsd = j.state_dict(), t.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for key, value in jsd.items():
        np.testing.assert_array_equal(tsd[key].numpy(), np.asarray(value))


def test_scalar_operand_follows_to_and_pickles():
    ja, ta = pair("float")
    comp = ta * 0.5
    assert comp.metric_b.dtype == torch.float32 and comp.metric_b.device.type == "cpu"
    assert "metric_b" not in comp.state_dict()
    comp64 = copy.deepcopy(comp).to(torch.float64)
    assert comp64.metric_b.dtype == torch.float64 and comp64.metric_a.x.dtype == torch.float64
    restored = pickle.loads(pickle.dumps(comp))
    assert_same((ja * 0.5).compute(), restored.compute())


def test_composition_tree_syncs_in_one_payload_collective(monkeypatch):
    ranks = [f1_composition(tmt) for _ in range(3)]
    for r, comp in enumerate(ranks):
        for preds, target in classification_batches(seed=10 + r, steps=2):
            comp.update(torch.from_numpy(preds), torch.from_numpy(target))
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    # the composition computes unsynced: each operand syncs in its own compute(); a sync of the
    # whole tree is one payload collective
    ranks[0].sync(distributed_available=lambda: True)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (0, 1)
    precision = ranks[0].metric_a.metric_a.metric_b
    want_tp = sum(r.metric_a.metric_a.metric_b.tp for r in ranks[1:]) + precision._cache["tp"]
    assert torch.equal(precision.tp, want_tp)
    ranks[0].unsync()
    assert not precision._is_synced
