"""The port's coalesced sync protocol (``metrics_tpu_torch/parallel/bucketing.py``).

Packing and unpacking are exact for every dtype, whatever precedes an entry
in the buffer; a suite sync on the static lane is one payload collective and
no shape collective, and ``cat`` states add one metadata collective; the
coalesced states equal the per-state protocol's bit for bit; a tree that
cannot be packed takes the per-state protocol; processes whose layouts
differ raise. Counts come from the port's own ``collective_stats()``; the
world of N processes is stood in for the two collectives
(``tests/helpers/torch_sync.install_world``), and is marked live where the
test needs the first-sync layout check.
"""
import pytest
import torch

import metrics_tpu_torch as tmt
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel import bucketing, collective_stats, gather_all_tensors, reset_collective_stats
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import SyncConfigFault
from tests.helpers.torch_sync import TorchFakeGather, headline_suite, install_world, suite_batches

DIST_ON = lambda: True  # noqa: E731

# every packable dtype, in an order that puts 1- and 2-byte states before 8-byte ones
LAYOUT = [
    ("flag", torch.bool, (3,)),
    ("small", torch.int8, (5,)),
    ("wide", torch.int64, (2,)),
    ("half", torch.float16, (3,)),
    ("byte", torch.uint8, ()),
    ("double", torch.float64, ()),  # 0-d, after a 1-byte 0-d state
    ("brain", torch.bfloat16, (2, 3)),
    ("short", torch.int16, (1,)),
    ("single", torch.float32, (4,)),
    ("count", torch.int32, (3,)),
    ("cplx", torch.complex64, (2,)),
]


def _bits(x):
    return x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x.reshape(-1).to(torch.uint8)


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _fill(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_complex:
        return torch.randn(shape, generator=g, dtype=dtype)
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=g).to(dtype)
        if x.numel() > 1:  # bits the arithmetic would not keep: NaN and -0.0
            x.view(-1)[0], x.view(-1)[-1] = float("nan"), -0.0
        return x
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -(2**40)), min(info.max, 2**40), shape, generator=g, dtype=dtype)


class _Layout(Metric):
    """One stacked (``None``-spec) state of every dtype, then two ``cat`` states."""

    full_state_update = True

    def __init__(self, spec=None, **kwargs):
        super().__init__(device="cpu", **kwargs)
        for name, dtype, shape in self.layout(spec):
            self.add_state(name, torch.zeros(shape, dtype=dtype), dist_reduce_fx=spec)
        self.add_state("rows_i8", [], dist_reduce_fx="cat")
        self.add_state("rows_i64", [], dist_reduce_fx="cat")

    @staticmethod
    def layout(spec=None):
        # complex numbers have no order: no max or min state of them
        return [(n, dt, s) for n, dt, s in LAYOUT if not (dt.is_complex and spec in ("max", "min"))]

    def update(self, seed, finite=False):
        for i, (name, dtype, shape) in enumerate(LAYOUT):
            if name in self._defaults:
                value = _fill(dtype, shape, seed * 100 + i)
                # NaN would spread through an arithmetic reduction
                setattr(self, name, torch.nan_to_num(value) if finite and value.is_floating_point() else value)
        self.rows_i8.append(_fill(torch.int8, (seed + 1,), seed))
        self.rows_i64.append(_fill(torch.int64, (seed + 2, 2), seed))

    def compute(self):
        return self.count


def _snapshot(m):
    return {k: (list(v) if isinstance(v, list) else v) for k, v in m.metric_state.items()}


@pytest.mark.parametrize("name,dtype,shape", LAYOUT)
def test_bytes_round_trip_every_dtype(name, dtype, shape):
    x = _fill(dtype, shape, 1)
    assert _bit_equal(bucketing._from_bytes(bucketing._to_bytes(x), shape, dtype), x)


@pytest.mark.parametrize("world", [1, 3])
def test_pack_then_unpack_is_bit_exact_at_every_offset(world, monkeypatch):
    ranks = [_Layout() for _ in range(world)]
    for r, m in enumerate(ranks):
        m.update(r)
    m = ranks[0]
    local = _snapshot(m)
    entries, values = bucketing._collect([m])
    _, meta, static_total = bucketing._pack(entries, values, torch.device("cpu"))
    assert static_total % bucketing.ALIGN == 0 and meta[-1] % bucketing.ALIGN == 0
    if world > 1:
        install_world(monkeypatch, ranks[1:])
    m.sync(distributed_available=DIST_ON)
    for name, dtype, shape in LAYOUT:
        stacked = getattr(m, name)
        assert stacked.shape == (world,) + shape
        for r, rank in enumerate(ranks):
            want = local[name] if r == 0 else getattr(rank, name)
            assert _bit_equal(stacked[r], want), (name, r)
    for name in ("rows_i8", "rows_i64"):
        want = torch.cat([local[name][0]] + [getattr(rank, name)[0] for rank in ranks[1:]])
        assert _bit_equal(getattr(m, name), want), name
    m.unsync()
    assert all(getattr(m, k) is v for k, v in local.items() if not isinstance(v, list))


def test_static_lane_is_one_payload_collective_a_suite_sync(monkeypatch):
    suites = [headline_suite(tmt) for _ in range(3)]
    for r, suite in enumerate(suites):
        for preds, target in suite_batches(r, 2):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    install_world(monkeypatch, suites[1:])
    n_states = sum(len(m._defaults) for _, m in suites[0].items(keep_base=True, copy_state=False))
    for _ in range(3):
        reset_collective_stats()
        suites[0].sync(distributed_available=DIST_ON)
        stats = collective_stats()
        assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (0, 1)
        assert stats["sync_states_coalesced"] == n_states and stats["sync_coalesce_ratio"] == n_states
        suites[0].unsync()


def test_cat_states_add_one_metadata_collective(monkeypatch):
    ranks = [_Layout() for _ in range(2)]
    for r, m in enumerate(ranks):
        m.update(r)
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 1)


@pytest.mark.parametrize("spec", ["sum", "mean", "max", "min", None])
def test_coalesced_equals_per_state_bit_for_bit(spec, monkeypatch):
    ranks = [_Layout(spec) for _ in range(3)]
    for r, m in enumerate(ranks):
        m.update(r + 5, finite=spec is not None)
    per_state = ranks[0].clone()
    reset_collective_stats()
    per_state.sync(dist_sync_fn=TorchFakeGather([per_state] + ranks[1:]), distributed_available=DIST_ON)
    install_world(monkeypatch, ranks[1:])
    ranks[0].sync(distributed_available=DIST_ON)
    for name in ranks[0]._defaults:
        assert _bit_equal(getattr(ranks[0], name), getattr(per_state, name)), name


def test_forced_per_state_protocol_costs_two_collectives_a_state():
    suite = headline_suite(tmt)
    for preds, target in suite_batches(3, 2):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    coalesced = suite.clone()
    n_states = sum(len(m._defaults) for _, m in suite.items(keep_base=True, copy_state=False))
    reset_collective_stats()
    suite.sync(dist_sync_fn=lambda t, group=None: gather_all_tensors(t, group), distributed_available=DIST_ON)
    stats = collective_stats()
    assert stats["sync_shape_collectives"] == stats["sync_payload_collectives"] == n_states
    assert stats["sync_coalesced_payloads"] == 0
    coalesced.sync(distributed_available=DIST_ON)
    for name, m in suite.items(keep_base=True, copy_state=False):
        other = coalesced._modules[name]
        for state in m._defaults:
            assert _bit_equal(getattr(m, state), getattr(other, state)), (name, state)


class _ListOfRows(Metric):
    """A ``None``-spec list state: the per-element gather walk, never packed."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("rows", [], dist_reduce_fx=None)

    def update(self, x):
        self.rows.append(x)

    def compute(self):
        return self.rows


class _OwnGather(tmt.SumMetric):
    """Overrides ``_sync_dist``: its own gather semantics, never packed."""

    def _sync_dist(self, dist_sync_fn=gather_all_tensors, process_group=None):
        self.value = self.value * 100


def test_trees_that_cannot_be_packed_take_the_per_state_protocol():
    rows = _ListOfRows()
    rows.update(torch.tensor([1.0, 2.0]))
    rows.update(torch.tensor([3.0]))
    own = _OwnGather(device="cpu")
    own.update(torch.tensor([2.0]))
    assert not bucketing.coalescible([rows]) and not bucketing.coalescible([own])
    assert bucketing.coalescible([tmt.SumMetric(device="cpu")])
    reset_collective_stats()
    rows.sync(distributed_available=DIST_ON)
    stats = collective_stats()
    # one gather per row, two collectives each, nothing coalesced
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"], stats["sync_coalesced_payloads"]) == (
        2,
        2,
        0,
    )
    assert len(rows.rows) == 2 and torch.equal(rows.rows[1], torch.tensor([3.0]))
    rows.unsync()
    own.sync(distributed_available=DIST_ON)
    assert float(own.value) == 200.0
    own.unsync()
    assert float(own.value) == 2.0


def test_a_suite_packs_the_members_it_can_and_syncs_the_rest_alone():
    rows = _ListOfRows()
    suite = tmt.MetricCollection({"rows": rows, "sum": tmt.SumMetric(device="cpu"), "max": tmt.MaxMetric(device="cpu")})
    suite.update(torch.tensor([1.0, 2.0]))
    reset_collective_stats()
    suite.sync(distributed_available=DIST_ON)
    stats = collective_stats()
    # sum and max in one payload; the list member's one row alone, two collectives
    assert stats["sync_coalesced_payloads"] == 1 and stats["sync_states_coalesced"] == 2
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 2)
    assert all(m._is_synced for m in suite.values(copy_state=False))
    suite.unsync()
    assert not any(m._is_synced for m in suite.values(copy_state=False))


def test_layouts_that_differ_across_processes_raise_and_keep_the_state(monkeypatch):
    def suite(num_classes):
        s = tmt.MetricCollection(
            {"cat": tmt.CatMetric(device="cpu"), "cm": tmt.ConfusionMatrix(num_classes=num_classes, device="cpu")}
        )
        s["cat"].update(torch.tensor([1.0]))
        return s

    mine, theirs = suite(3), suite(5)
    local = {k: _snapshot(m) for k, m in mine.items(keep_base=True, copy_state=False)}
    install_world(monkeypatch, [theirs])
    with pytest.raises(SyncConfigFault, match="differ across processes"):
        mine.sync(distributed_available=DIST_ON)
    for name, m in mine.items(keep_base=True, copy_state=False):
        assert not m._is_synced
        for state, value in local[name].items():
            after = getattr(m, state)
            assert after == value if isinstance(value, list) else after is value


def test_a_cat_state_with_another_dtype_elsewhere_raises(monkeypatch):
    mine, theirs = tmt.CatMetric(device="cpu"), tmt.CatMetric(device="cpu")
    mine.update(torch.tensor([1.0, 2.0]))
    theirs.value.append(torch.tensor([1.0], dtype=torch.float64))
    install_world(monkeypatch, [theirs])
    with pytest.raises(SyncConfigFault, match="dtypes"):
        mine.sync(distributed_available=DIST_ON)
    assert not mine._is_synced and len(mine.value) == 1


def test_live_world_checks_a_static_layout_once(monkeypatch):
    """In a live process group the first sync of a static layout exchanges the
    packed totals once; the layout is then cached and a sync is one collective."""
    suites = [headline_suite(tmt, num_classes=7) for _ in range(2)]
    for r, suite in enumerate(suites):
        for preds, target in suite_batches(r, 1, num_classes=7):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    install_world(monkeypatch, suites[1:])
    monkeypatch.setattr(psync, "_live", lambda: True)
    monkeypatch.setattr(bucketing, "_MANIFEST_CACHE", {})
    counts = []
    for _ in range(3):
        reset_collective_stats()
        suites[0].sync(distributed_available=DIST_ON)
        stats = collective_stats()
        counts.append((stats["sync_shape_collectives"], stats["sync_payload_collectives"]))
        suites[0].unsync()
    assert counts == [(1, 1), (0, 1), (0, 1)]
    # a process whose static layout differs is caught by the first check
    monkeypatch.setattr(bucketing, "_MANIFEST_CACHE", {})
    install_world(monkeypatch, [headline_suite(tmt, num_classes=8)])
    with pytest.raises(SyncConfigFault):
        suites[0].sync(distributed_available=DIST_ON)
    assert not any(m._is_synced for m in suites[0].values(copy_state=False))


def test_regression_suite_packs_pearson_moments_and_spearman_rows(monkeypatch):
    """Pearson's six moments (spec None) ride the packed lane and come back stacked, one row a process;
    Spearman's ``cat`` rows add the one metadata collective."""
    from tests.helpers.torch_sync import regression_rows, regression_suite

    ranks = [regression_suite(tmt) for _ in range(3)]
    for r, suite in enumerate(ranks):
        for preds, target in regression_rows(5, r):
            suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    local = {name: getattr(ranks[0]["pearson"], name) for name in ("mean_x", "var_x", "n_total")}
    install_world(monkeypatch, ranks[1:])
    reset_collective_stats()
    ranks[0].sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert (stats["sync_shape_collectives"], stats["sync_payload_collectives"]) == (1, 1)
    pearson = ranks[0]["pearson"]
    for name, value in local.items():
        synced = getattr(pearson, name)
        assert synced.shape == (3,) and torch.equal(synced[0], value)
        assert all(torch.equal(synced[r], getattr(ranks[r]["pearson"], name)) for r in (1, 2))
    assert ranks[0]["spearman"].preds.shape == (sum(2 * (40 + 9 * r) for r in range(3)),)
    ranks[0].unsync()
    assert torch.equal(ranks[0]["pearson"].var_x, local["var_x"])


def test_retrieval_rows_decline_the_packed_lane():
    """List states of spec None are gathered row by row (as the JAX coalescer declines them too)."""
    from tests.helpers.torch_sync import retrieval_rows

    metric = tmt.RetrievalMAP(device="cpu")
    for preds, target, indexes in retrieval_rows(6, 0):
        metric.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    assert not bucketing.coalescible(bucketing.tree_nodes(metric))
    reset_collective_stats()
    before = metric.compute()
    metric._computed = None
    metric.sync(distributed_available=DIST_ON)
    stats = collective_stats()
    assert stats["sync_coalesced_payloads"] == 0
    assert stats["sync_payload_collectives"] == stats["sync_shape_collectives"] == 3 * 2  # 3 states, 2 rows
    assert torch.equal(metric.compute(), before)
