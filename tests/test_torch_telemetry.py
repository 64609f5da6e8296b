"""The port's flight recorder (``metrics_tpu_torch/ops/telemetry.py``) against the JAX package's.

``LatencyHistogram`` gives equal bucket counts and quantiles for the same
durations; ``prometheus_text(d)`` and ``trace_events(rows)`` are byte-identical
for the same dict and rows; ``snapshot()`` has the JAX snapshot's keys, and
the port's own (:data:`PORT_KEYS`).
Then the recorder's contracts on the port's own planes: the sync phases and
suite calls emit their spans, a disarmed recorder emits nothing, budgets
count violations and warn once, the ring bounds itself and says so, resets
keep the monotonic step, and the trace export is valid JSON. Exact
comparisons throughout.
"""
import json

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from metrics_tpu.ops import telemetry as jtelemetry
from metrics_tpu_torch.ops import faults, telemetry
from tests.helpers.torch_sync import headline_suite, suite_batches
import metrics_tpu_torch as tmt

DIST_ON = lambda: True  # noqa: E731

# Keys of the JAX snapshot whose planes the port has not yet: key -> the plane that brings them. Every
# plane is ported, so the port's snapshot has exactly the JAX snapshot's keys.
PENDING_KEYS: dict = {}
PENDING_PREFIXES: dict = {}
# Keys of the port's snapshot that the JAX package has not: its canonicalizations by form (utils/checks.py).
PORT_KEYS = {"perf_canon_class_ids", "perf_canon_onehot"}


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run.
    Both recorders are armed, and left as they were."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    armed = (telemetry.armed, jtelemetry.armed)
    telemetry.set_telemetry(True)
    jtelemetry.set_telemetry(True)
    yield
    telemetry.set_telemetry(armed[0])
    jtelemetry.set_telemetry(armed[1])


# --------------------------------------------------------------- histograms
DURATIONS = {
    "spread": np.random.default_rng(0).lognormal(-7.0, 2.5, 500),
    "edges": np.asarray([1e-6, 2e-6, 1.0000001e-6, 134.217728, 500.0, 0.0, -1.0, 3e-7]),
    "one": np.asarray([0.002]),
    "none": np.asarray([]),
}


@pytest.mark.parametrize("case", sorted(DURATIONS))
def test_latency_histogram_matches_the_reference(case):
    mine, ref = telemetry.LatencyHistogram(), jtelemetry.LatencyHistogram()
    for d in DURATIONS[case].tolist():
        mine.observe(d)
        ref.observe(d)
    assert mine.counts == ref.counts
    assert mine.stats() == ref.stats()
    assert telemetry._HIST_BOUNDS_S == jtelemetry._HIST_BOUNDS_S and len(telemetry._HIST_BOUNDS_S) == 28


# ------------------------------------------------------------ exposition
def _suite_activity():
    """Some of every kind of span, counter and fault on the port's planes: a
    demoted suite sync (per-state), a member-wise one, then a coalesced one."""
    suite = headline_suite(tmt)
    for preds, target in suite_batches(1, 2):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    faults.set_recovery_policy(steps=1)
    try:
        with faults.inject_faults("sync-pack", 5):
            with pytest.warns(UserWarning):
                suite.sync(distributed_available=DIST_ON)
        suite.unsync()
        for _ in range(2):
            suite.sync(distributed_available=DIST_ON)
            suite.unsync()
    finally:
        faults.set_recovery_policy(steps=8)
    return suite


SNAPSHOT_DICTS = {
    "scalars": {"fault_runtime": 3, "sync_coalesce_ratio": 0.25, "telemetry_armed": True, "spans_dropped": 0,
                "span_ring_cap": 4096, "journal_bytes_written": 12345678901, "weird-key.x": 1.5, "text": "skip",
                "failure_log": [{"step": 1}], "none": None, "nested": {"a": {"b": 2, "c": False}},
                "sync_health": {"monotonic_step": 7, "last_good_sync_step": -1, "fault_domain_counts": {"sync": 2}},
                "latency_stats_fake_count": 3},
    "histograms": {"latency_stats": {"sync-pack": {"count": 2, "sum_s": 0.003, "max_s": 0.002, "p50_s": 0.001,
                                                   "p95_s": 0.0019, "p99_s": 0.00199,
                                                   "buckets": {"0.001024": 1, "0.002048": 1}},
                                     "suite-sync": {}}, "slo_violations": {"total": 0}},
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_DICTS) + ["port_snapshot", "reference_snapshot"])
def test_prometheus_text_is_byte_identical(case):
    if case == "port_snapshot":
        _suite_activity()
        data = telemetry.snapshot()
    elif case == "reference_snapshot":
        data = jtelemetry.snapshot()
    else:
        data = SNAPSHOT_DICTS[case]
    assert telemetry.prometheus_text(data) == jtelemetry.prometheus_text(data)


def test_counter_classification_matches_the_reference():
    _suite_activity()
    keys = [k for k, _ in telemetry._flat_numeric("", jtelemetry.snapshot())]
    keys += [k for k, _ in telemetry._flat_numeric("", telemetry.snapshot())]
    keys += ["latency_stats_sync-pack_buckets_0.001", "latency_stats_x_sum_s", "sync_health_epoch", "x_ratio"]
    for key in keys:
        assert telemetry.is_counter_key(key) == jtelemetry.is_counter_key(key), key


def _rows():
    rng = np.random.default_rng(3)
    rows = []
    t = 1000.0
    for i in range(40):
        t += float(rng.random()) * 1e-3
        rows.append({"step": i // 3, "owner": [None, "MetricCollection", "Accuracy"][i % 3],
                     "lane": [None, "sync", "journal"][i % 3], "site": ["sync-pack", "fault", "journal-save"][i % 3],
                     "t_start": t, "dur": float(rng.random()) * 1e-3 if i % 4 else 0.0,
                     "attrs": {"bytes": np.int64(i), "w": np.float32(0.5), "o": object} if i % 5 == 0 else None})
    return rows


@pytest.mark.parametrize("case", ["synthetic", "recorded", "empty"])
def test_trace_events_are_identical(case):
    if case == "synthetic":
        rows = _rows()
    elif case == "recorded":
        telemetry.clear_spans()
        _suite_activity()
        rows = telemetry.spans()
        assert rows
    else:
        rows = []
    mine, ref = telemetry.trace_events(rows), jtelemetry.trace_events(rows)
    assert json.dumps(mine) == json.dumps(ref)


def test_snapshot_keys_are_the_reference_keys_less_the_pending_planes():
    _suite_activity()
    mine, ref = telemetry.snapshot(), jtelemetry.snapshot()
    pending = {k for k in ref if k in PENDING_KEYS or k.startswith(tuple(PENDING_PREFIXES))}
    assert PORT_KEYS <= set(mine) and not PORT_KEYS & set(ref)
    assert set(mine) - PORT_KEYS == set(ref) - pending
    assert set(mine["sync_health"]) == set(ref["sync_health"])
    assert set(mine["sync_health"]["inflight"]) == set(ref["sync_health"]["inflight"])
    assert set(mine["sync_phase_stats"]) == set(ref["sync_phase_stats"])
    for key in ("sync_phase_stats", "slo_violations"):
        for site, block in mine[key].items():
            assert type(block) is type(ref[key][site])
    assert mine["snapshot_schema"] == ref["snapshot_schema"] == 1
    assert telemetry.SPAN_SITES.keys() == jtelemetry.SPAN_SITES.keys()
    assert telemetry.SYNC_PHASE_SITES == jtelemetry.SYNC_PHASE_SITES


# ---------------------------------------------------------- port contracts
def test_sync_and_suite_calls_emit_their_spans():
    telemetry.clear_spans()
    suite = _suite_activity()
    sites = [r["site"] for r in telemetry.spans()]
    for site in ("suite-step", "suite-sync", "sync-pack", "sync-payload-gather", "sync-unpack", "sync-gather",
                 "fault", "ladder-demote"):
        assert site in sites, site
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    m.sync(distributed_available=DIST_ON)
    m.unsync()
    suite.update(*map(torch.from_numpy, suite_batches(2, 1)[0]))
    stats = telemetry.sync_phase_stats()
    assert stats["sync-pack"]["count"] >= 2 and stats["sync-gather"]["count"] >= 15
    assert stats["sync-pack"]["mean_s"] == stats["sync-pack"]["total_s"] / stats["sync-pack"]["count"]
    lat = telemetry.latency_stats()
    assert lat["suite-step"]["count"] >= 3 and lat["suite-sync"]["count"] >= 2
    payload = [r for r in telemetry.spans() if r["site"] == "sync-payload-gather"][-1]
    assert payload["owner"] == "SumMetric" and payload["attrs"]["world"] == 1


def test_disarmed_recorder_emits_nothing():
    telemetry.set_telemetry(False)
    telemetry.clear_spans()
    before = {site: list(h.counts) for site, h in telemetry._site_hists.items()}
    _suite_activity()
    assert telemetry.spans() == [] and telemetry.telemetry_stats()["spans_recorded"] == 0
    assert {site: list(h.counts) for site, h in telemetry._site_hists.items()} == before
    assert telemetry.snapshot()["telemetry_armed"] is False


def test_slo_budget_counts_violations_and_warns_once(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SLO_SUITE_SYNC_MS", "0.000001")
    monkeypatch.setenv("METRICS_TPU_SLO_SYNC_PACK_MS", "not-a-number")
    telemetry.reset_latency()
    faults.reset_warn_dedupe()
    with pytest.warns(UserWarning) as record:
        telemetry.emit("suite-sync", "MetricCollection", "sync", telemetry.now(), 0.5)
        telemetry.emit("suite-sync", "MetricCollection", "sync", telemetry.now(), 0.5)
        telemetry.emit("sync-pack", None, "sync", telemetry.now(), 0.5)
    messages = [str(w.message) for w in record]
    assert sum("over its declared" in m for m in messages) == 1
    assert sum("not a number" in m for m in messages) == 1
    assert telemetry.slo_violations() == {"total": 2, "suite-sync": 2}
    assert telemetry.slo_limit_s("suite-sync") == 0.000001 / 1000.0 and telemetry.slo_limit_s("sync-pack") is None
    assert telemetry.snapshot()["sync_health"]["slo_violations"] == 2
    telemetry.reset_latency()
    assert telemetry.slo_violations() == {"total": 0}


def test_span_ring_bounds_itself_and_warns_once():
    cap = telemetry._ring.maxlen
    try:
        telemetry.set_telemetry(True, span_cap=16)
        telemetry.clear_spans()
        telemetry._reset_overflow_warning()
        faults.reset_warn_dedupe()
        with pytest.warns(UserWarning, match="overflowed its 16-span capacity"):
            for i in range(40):
                telemetry.emit("fault", None, "sync", attrs={"i": i})
        stats = telemetry.telemetry_stats()
        assert (stats["spans_recorded"], stats["spans_retained"], stats["spans_dropped"]) == (40, 16, 24)
        assert [r["attrs"]["i"] for r in telemetry.spans()] == list(range(24, 40))
    finally:
        telemetry.set_telemetry(True, span_cap=cap)


def test_reset_all_zeroes_every_plane_and_keeps_the_step():
    _suite_activity()
    step = faults.current_step()
    telemetry.reset_all()
    snap = telemetry.snapshot()
    assert snap["spans_recorded"] == 0 and snap["latency_stats"] == {}
    assert snap["fault_demotions"] == 0 and snap["failure_log"] == []
    assert snap["sync_payload_collectives"] == 0 and snap["journal_saves"] == 0
    assert snap["monotonic_step"] == step


def test_export_trace_writes_the_spans_and_the_snapshot(tmp_path):
    telemetry.clear_spans()
    _suite_activity()
    path = tmp_path / "trace.json"
    n = telemetry.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert n == len(telemetry.spans()) > 0
    events = doc["traceEvents"]
    assert [e for e in events if e["ph"] != "M"] == telemetry.trace_events()[-n:]
    assert doc["snapshot"]["spans_recorded"] == len(telemetry.spans())
    assert "failure_log" not in doc["snapshot"]
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_span_cap_from_the_environment_warns_on_garbage(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_TELEMETRY_SPANS", "lots")
    assert telemetry._env_cap() == telemetry._DEFAULT_CAP
    faults.reset_warn_dedupe()
    with pytest.warns(UserWarning, match="is not an integer"):
        telemetry.latency_stats()
    monkeypatch.setenv("METRICS_TPU_TELEMETRY_SPANS", "3")
    assert telemetry._env_cap() == 16


# ------------------------------------------------------------ profiler ranges
def _seg_suite():
    return tmt.MetricCollection({
        "miou": tmt.JaccardIndex(num_classes=3, device="cpu"),
        "dice": tmt.Dice(num_classes=3, average="macro", mdmc_average="global", device="cpu"),
    })


def _seg_batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(2, 3, 4, 5, generator=g).softmax(1), torch.randint(0, 3, (2, 4, 5), generator=g)


def _ctr_suite():
    return tmt.MetricCollection({
        "auroc": tmt.AUROC(pos_label=1, device="cpu"),
        "ap": tmt.AveragePrecision(pos_label=1, device="cpu"),
        "ece": tmt.CalibrationError(n_bins=15, norm="l1", device="cpu"),
    })


def _ctr_batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(64, generator=g), torch.randint(0, 2, (64,), generator=g)


def _suite_calls():
    """A Jaccard+Dice suite's updates, an AUROC+AP+CE suite's updates and compute, and a suite sync."""
    seg = _seg_suite()
    for seed in range(2):
        seg.update(*_seg_batch(seed))
    ctr = _ctr_suite()
    for seed in range(2):
        ctr.update(*_ctr_batch(seed))
    ctr.compute()
    seg.sync(distributed_available=DIST_ON)
    seg.unsync()


class _CountingRange(torch.autograd.profiler.record_function):
    opened = 0

    def __init__(self, *args, **kwargs):
        type(self).opened += 1
        super().__init__(*args, **kwargs)


def _ring_rows():
    return [(r["owner"], r["lane"], r["site"], r["attrs"]) for r in telemetry.spans()]


def _profiled_ranges(prof):
    """The port's ranges of a finished profile: (name without the prefix, start ns, end ns), by start."""
    prefix = telemetry.RANGE_PREFIX
    return sorted(((e.name()[len(prefix):], e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefix)), key=lambda r: (r[1], -r[2]))


def _encloses(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_range_is_opened_while_no_profiler_records(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _CountingRange)
    _CountingRange.opened = 0
    telemetry.clear_spans()
    _suite_calls()
    assert _CountingRange.opened == 0
    assert telemetry.trace_range("update", "JaccardIndex") is telemetry._NO_RANGE
    assert {r["site"] for r in telemetry.spans()} <= set(telemetry.SPAN_SITES)


def test_ranges_nest_under_the_profiler_and_leave_the_ring_as_it_was():
    from torch.profiler import ProfilerActivity, profile

    telemetry.reset_all()  # the counters that span attributes carry start from zero each time
    _suite_calls()
    unprofiled = _ring_rows()
    telemetry.reset_all()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _suite_calls()
    assert _ring_rows() == unprofiled
    ranges = _profiled_ranges(prof)
    names = {name for name, _, _ in ranges}
    assert {n.split(":", 1)[0] for n in names} <= set(telemetry.RANGE_SITES) | set(telemetry.SPAN_SITES)
    assert {"suite-step", "suite-sync", "sync-pack", "update:JaccardIndex", "update:Dice", "validate",
            "host-read:value-stats", "canonicalize", "counts", "stat-scores", "update:CalibrationError",
            "calibration-bins", "compute:AUROC", "compute:AveragePrecision", "state-cat", "curve-sort",
            "curve-ties", "curve-area", "host-read:curve-thresholds"} <= names

    def chain(*sites):
        """Some range of each site, each inside the one before."""
        found = [r for r in ranges if r[0] == sites[0]]
        for site in sites[1:]:
            found = [r for r in ranges if r[0] == site and any(_encloses(o, r) for o in found)]
        return found

    assert chain("suite-step", "update:JaccardIndex", "validate", "host-read:value-stats")
    assert chain("update:Dice", "canonicalize") and chain("update:JaccardIndex", "counts")
    assert chain("update:Dice", "stat-scores", "counts")
    assert chain("compute:AUROC", "curve-sort") and chain("compute:AveragePrecision", "curve-ties")
    assert chain("update:CalibrationError", "calibration-bins", "counts")


def test_export_trace_clock_lays_the_ring_on_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    telemetry.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("outer"):
            _seg_suite().update(*_seg_batch())
    path = tmp_path / "trace.json"
    telemetry.export_trace(str(path))
    doc = json.loads(path.read_text())
    clock = doc["otherData"]["clock"]
    (outer,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    (step,) = [e for e in doc["traceEvents"] if e.get("name") == "suite-step"]
    start_ns = clock["ts_zero_unix_ns"] + step["ts"] * 1e3
    end_ns = start_ns + step["dur"] * 1e3
    assert outer.start_ns() - 1e6 <= start_ns and end_ns <= outer.end_ns() + 1e6
    ring = [r for r in telemetry.spans() if r["site"] == "suite-step"][0]
    assert abs(ring["t_start"] * 1e9 + clock["ring_to_unix_ns"] - start_ns) < 1e3


def _raises_inside(block):
    with pytest.raises(RuntimeError, match="planted"):
        with block:
            raise RuntimeError("planted")


@pytest.mark.parametrize("attrs_up_front", [True, False])
def test_a_timed_site_closes_its_range_on_a_fault(attrs_up_front):
    from torch.profiler import ProfilerActivity, profile

    telemetry.clear_spans()
    attrs = {"api": "update"} if attrs_up_front else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("outer"):
            _raises_inside(telemetry.timed("suite-step", "Doc", "suite", attrs))
            with telemetry.timed("sync-pack", "Doc", "sync") as span:
                span.attrs = {"states": 1}
    events = prof.profiler.kineto_results.events()
    (outer,) = [(e.start_ns(), e.end_ns()) for e in events if e.name() == "outer"]
    ranges = _profiled_ranges(prof)
    assert [name for name, _, _ in ranges] == ["suite-step", "sync-pack"]
    step, pack = ranges
    assert outer[0] <= step[1] <= step[2] <= pack[1] <= pack[2] <= outer[1]
    # a block that raised leaves a span only where its attributes were given up front
    expected = (["suite-step"] if attrs_up_front else []) + ["sync-pack"]
    assert [r["site"] for r in telemetry.spans()] == (expected if telemetry.armed else [])


def test_a_ranged_function_closes_its_range_on_a_fault():
    from torch.profiler import ProfilerActivity, profile

    @telemetry.ranged("validate")
    def check(fail):
        if fail:
            raise RuntimeError("planted")
        return "ok"

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="planted"):
            check(True)
        assert check(False) == "ok"
    ranges = _profiled_ranges(prof)
    assert [name for name, _, _ in ranges] == ["validate", "validate"]
    assert ranges[0][2] <= ranges[1][1]
    assert check.__name__ == "check" and check(False) == "ok"


def test_a_warning_inside_a_ranged_update_or_compute_points_at_the_caller():
    metric = tmt.SumMetric(device="cpu")
    with pytest.warns(UserWarning, match="called before the ``update``") as record:
        metric.compute()
    assert [w.filename for w in record if "before the ``update``" in str(w.message)] == [__file__]
