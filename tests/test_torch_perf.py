"""The port's performance attribution (``metrics_tpu_torch/ops/perf.py``) against the JAX package's.

The same synthetic span rings (nested suite steps, flushes, dispatches with
their probed device siblings, blocking and in-flight syncs, journal saves)
go through both packages' exclusive nesting scan, phase columns, wire
evidence, reconciliation and ranked opportunities, and give equal results.
Then the port's own plane: every span site it emits maps to JAX's phase, a
live suite loop's spans cover the measured wall within ``TOLERANCE``, and a
disarmed recorder leaves the report empty.
"""
import copy
import time

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from metrics_tpu.ops import engine as jengine
from metrics_tpu.ops import perf as jperf
from metrics_tpu.ops import telemetry as jtelemetry
from metrics_tpu_torch.ops import engine, perf, telemetry
from tests.helpers.torch_sync import headline_suite, suite_batches
import metrics_tpu_torch as tmt

DIST_ON = lambda: True  # noqa: E731


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """The JAX planes run with ``jax.core.trace_state_clean`` restored; both recorders armed and emptied."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    armed = (telemetry.armed, jtelemetry.armed)
    for t in (telemetry, jtelemetry):
        t.set_telemetry(True)
        t.clear_spans()
    yield
    engine.set_device_probe(None)
    telemetry.set_telemetry(armed[0])
    jtelemetry.set_telemetry(armed[1])


def _ring(seed: int) -> list:
    """A synthetic span ring: suite steps holding flushes of dispatches (every third probed:
    a device-dispatch sibling from the same start, longer), blocking suite syncs with their
    phases, async syncs whose in-flight gathers overlap the host, journal saves, instants."""
    rng = np.random.default_rng(seed)
    rows, t = [], 100.0

    def span(site, start, dur, attrs=None, owner="MetricCollection"):
        rows.append({"step": len(rows), "owner": owner, "lane": None, "site": site, "t_start": start, "dur": dur,
                     "attrs": attrs})

    for i in range(int(rng.integers(4, 9))):
        step = float(rng.uniform(2e-3, 6e-3))
        span("suite-step", t, step, {"api": "update"})
        inner = t + step * 0.1
        flush = step * 0.7
        span("engine-flush", inner, flush, {"kind": "collection-update", "entries": 4})
        d0 = inner + flush * 0.1
        for k in range(int(rng.integers(1, 4))):
            host = flush * 0.15
            span("engine-dispatch", d0, host, {"async_host_wall": True})
            if (i + k) % 3 == 0:
                span("device-dispatch", d0, host * float(rng.uniform(1.2, 2.0)))
            d0 += flush * 0.3
        if i % 2:
            span("engine-compile", t + step * 0.85, step * 0.1, {"signature": 1})
        t += step + float(rng.uniform(1e-4, 1e-3))
        if i % 3 == 1:
            sync = float(rng.uniform(1e-3, 4e-3))
            span("suite-sync", t, sync, {"members": 4})
            a = t + sync * 0.05
            for site, share, attrs in (("sync-pack", 0.2, None), ("sync-metadata", 0.1, {"bytes": 64}),
                                       ("sync-payload-gather", 0.4, {"bytes": int(rng.integers(1000, 90000)), "seq": i}),
                                       ("sync-unpack", 0.15, None)):
                span(site, a, sync * share, attrs)
                a += sync * share
            t += sync + 1e-4
        if i % 4 == 2:
            d = float(rng.uniform(5e-4, 2e-3))
            span("sync-dispatch", t, d * 0.3)
            span("sync-payload-gather", t + d * 0.1, d * 2.0, {"bytes": 4096, "overlapped": True, "seq": 100 + i})
            span("sync-force", t + d * 2.5, d * 0.5, {"waited_s": d * 0.2})
            t += d * 3.2
        if i % 5 == 3:
            span("journal-save", t, 1e-3, {"bytes": 123})
            t += 1.1e-3
        span("fault", t, 0.0, {"domain": "sync"})
    return rows


CASES = [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("seed", CASES)
def test_exclusive_spans_match_the_reference(seed):
    rows = _ring(seed)
    assert perf._exclusive_spans(copy.deepcopy(rows)) == jperf._exclusive_spans(copy.deepcopy(rows))


def _fed_report(monkeypatch, pkg_perf, pkg_telemetry, pkg_engine, rows, **kwargs):
    monkeypatch.setattr(pkg_telemetry, "spans", lambda: copy.deepcopy(rows))
    monkeypatch.setattr(pkg_engine, "program_report", lambda analyze=True: [])
    monkeypatch.setattr(pkg_engine, "device_probe_every", lambda: 8)
    monkeypatch.setattr(pkg_engine, "engine_stats", lambda: {"device_probes": 3})
    return pkg_perf.perf_report(**kwargs)


@pytest.mark.parametrize("seed", CASES)
@pytest.mark.parametrize("measured", [None, 0.02, 1.0])
def test_perf_report_matches_the_reference(monkeypatch, seed, measured):
    rows = _ring(seed)
    kwargs = {} if measured is None else {"measured_wall_s": measured}
    mine = _fed_report(monkeypatch, perf, telemetry, engine, rows, **kwargs)
    ref = _fed_report(monkeypatch, jperf, jtelemetry, jengine, rows, **kwargs)
    assert mine == ref
    assert mine["reconciliation"]["tolerance"] == perf.TOLERANCE == 0.15


def test_the_phase_tables_are_the_reference_tables():
    assert perf.PHASES == jperf.PHASES
    assert perf.SITE_PHASES == jperf.SITE_PHASES
    assert perf.TOLERANCE == jperf.TOLERANCE
    assert perf._STEP_PHASES == jperf._STEP_PHASES and perf._SYNC_PHASES == jperf._SYNC_PHASES


def _latency_block(rng, sites):
    return {s: {"count": int(rng.integers(1, 50)), "sum_s": float(rng.random())} for s in sites}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase_columns_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    sites = list(perf.SITE_PHASES) + ["journal-save", "device-dispatch:many:1234abcd", "fleet-gather"]
    before = _latency_block(rng, sites[::2])
    after = {s: {"count": 60, "sum_s": float(before.get(s, {}).get("sum_s", 0.0) + rng.random())} for s in sites}
    after["sync-pack"]["sum_s"] = before.get("sync-pack", {"sum_s": 0.0})["sum_s"]  # no change: no column
    assert perf.phase_columns(before, after) == jperf.phase_columns(before, after)


def _suite_activity():
    suite = headline_suite(tmt)
    for preds, target in suite_batches(1, 4):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    suite.sync(distributed_available=DIST_ON)
    suite.unsync()
    suite.compute()
    return suite


def test_every_site_the_port_emits_has_the_reference_phase():
    engine.set_device_probe(2)
    _suite_activity()
    sites = {r["site"] for r in telemetry.spans()}
    assert {"suite-step", "suite-sync", "sync-pack", "sync-payload-gather", "sync-unpack"} <= sites
    for site in sites | {"engine-build", "engine-compile", "engine-dispatch", "engine-flush", "device-dispatch",
                         "sync-gather", "sync-metadata", "sync-dispatch", "sync-force", "sync-quantize"}:
        assert perf._phase_of(site) == jperf._phase_of(site), site


def test_a_live_suite_loop_is_covered_within_the_tolerance():
    suite = headline_suite(tmt)
    batches = [tuple(map(torch.from_numpy, b)) for b in suite_batches(2, 24)]
    suite.update(*batches[0])  # first calls validated, programs built: outside the window
    suite.update(*batches[1])
    telemetry.clear_spans()
    t0 = time.perf_counter()
    for preds, target in batches[2:]:
        suite.update(preds, target)
    engine.flush_barrier([suite, *suite.values()])  # the queued work lands inside the window, in a flush span
    wall = time.perf_counter() - t0
    report = perf.perf_report(measured_wall_s=wall)
    rec = report["reconciliation"]
    assert rec["within_tolerance"], rec
    assert report["step"]["steps"] == len(batches) - 2
    assert report["perf_schema"] == 1 and sorted(report["phases"]) == sorted(perf.PHASES)
    assert [o["phase"] for o in report["opportunities"]][0] in perf.PHASES
    assert perf.perf_stats()["perf_reports"] >= 1


def test_a_disarmed_recorder_reports_nothing():
    telemetry.set_telemetry(False)
    telemetry.clear_spans()
    _suite_activity()
    report = perf.perf_report()
    assert report["spans_decomposed"] == 0 and report["opportunities"] == []
    assert all(b["total_s"] == 0.0 for b in report["phases"].values())
    perf.reset_perf_stats()
    assert perf.perf_stats() == {"perf_reports": 0}
