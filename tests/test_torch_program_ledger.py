"""The port's program ledger (``metrics_tpu_torch/ops/engine.py``: ``program_report``,
``program_summary``, the roofline peaks and bound classes) against the JAX package's.

The bound classes on pinned peaks are JAX's ``_roofline_row`` on the same
numbers; the rows, the summary and the pinned peaks have JAX's keys. The
analysis counts a step's FLOPs and bytes in PyTorch's terms, runs once per
signature (memoized, failures too, ``program_analyses`` counting them) on a
copy of the owner whose states it never touches, and reports None where it
cannot run.
"""
import json
import os
import tempfile

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from metrics_tpu.ops import engine as jengine
from metrics_tpu.ops import telemetry as jtelemetry
from metrics_tpu_torch.ops import engine, telemetry
from metrics_tpu_torch.utils import checks
from tests.helpers.torch_sync import headline_suite, suite_batches
import metrics_tpu as jmt
import metrics_tpu_torch as tmt


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    armed = (telemetry.armed, jtelemetry.armed)
    telemetry.set_telemetry(True)
    jtelemetry.set_telemetry(True)
    mode = checks._get_validation_mode()
    checks.set_validation_mode("first")
    yield
    checks.set_validation_mode(mode)
    engine.set_device_probe(None)
    engine.set_roofline_peaks(None)
    jengine.set_roofline_peaks(None)
    telemetry.set_telemetry(armed[0])
    jtelemetry.set_telemetry(armed[1])


PEAKS = [(None, None), (6.7e13, 3.35e12), (1e9, 0.0), (0.0, 1e9), (2e12, 5e10)]
ANALYSES = [None, {"flops": 0.0, "bytes_accessed": 0.0}, {"flops": 4e9, "bytes_accessed": 0.0},
            {"flops": 0.0, "bytes_accessed": 3e8}, {"flops": 2e6, "bytes_accessed": 4e8},
            {"flops": 8e10, "bytes_accessed": 1e6}]
DEVICES = [None, {"count": 0}, {"count": 4, "p50_s": 2e-3, "sum_s": 9e-3}, {"count": 3, "p50_s": 0.0, "sum_s": 3e-4},
           {"count": 9, "p50_s": 1e-5, "sum_s": 1e-4}]
HOSTS = [0.0, 5e-6, 1.5e-3]


@pytest.mark.parametrize("peaks", PEAKS, ids=str)
def test_bound_classes_match_the_reference(peaks):
    engine.set_roofline_peaks(*peaks)
    jengine.set_roofline_peaks(*peaks)
    if peaks == (None, None):
        mine = ref = {"calibrated": False, "ridge_flops_per_byte": 0.0}
    else:
        mine, ref = engine.roofline_peaks(), jengine.roofline_peaks()
        assert mine == ref
    classes = set()
    for analysis in ANALYSES:
        for device in DEVICES:
            for host in HOSTS:
                got = engine._roofline_row(analysis, device, host, mine)
                assert got == jengine._roofline_row(analysis, device, host, ref)
                classes.add(got["bound"])
    assert {"unprobed", "host-bound"} <= classes
    assert engine._DISPATCH_BOUND_UTILIZATION == jengine._DISPATCH_BOUND_UTILIZATION == 0.05
    assert engine._HOST_BOUND_SHARE == jengine._HOST_BOUND_SHARE == 0.6


def _drive(pkg, to, steps=6):
    suite = headline_suite(pkg)
    for preds, target in suite_batches(4, steps):
        suite.update(to(preds), to(target))
    suite.compute()
    return suite


def test_rows_and_summary_have_the_reference_keys():
    engine.set_device_probe(1)
    jengine.set_device_probe(1)
    try:
        suites = (_drive(tmt, torch.from_numpy), _drive(jmt, np.asarray))  # noqa: F841 - the states the analysis copies
        mine, ref = engine.program_report(analyze=True), jengine.program_report(analyze=True)
    finally:
        jengine.set_device_probe(None)
    assert mine and ref
    assert set(mine[0]) == set(ref[0]) and set(mine[0]["roofline"]) == set(ref[0]["roofline"])
    analysed = [r for r in mine if r["analysis"] is not None]
    assert analysed and set(analysed[0]["analysis"]) == set(next(r["analysis"] for r in ref if r["analysis"]))
    assert set(engine.program_summary()) == set(jengine.program_summary())
    assert set(engine.program_report(analyze=False)[0]) == set(jengine.program_report(analyze=False)[0])


def test_the_analysis_is_memoized_and_touches_no_state():
    engine.reset_engine()  # no program analysed by an earlier test
    suite = _drive(tmt, torch.from_numpy)
    states = {name: {k: (v.clone() if isinstance(v, torch.Tensor) else [t.clone() for t in v])
                     for k, v in m.metric_state.items()} for name, m in suite.items(keep_base=True, copy_state=False)}
    counts = {name: m._update_count for name, m in suite.items(keep_base=True, copy_state=False)}
    before = engine.engine_stats()["program_analyses"]
    rows = engine.program_report(analyze=True)
    performed = engine.engine_stats()["program_analyses"] - before
    assert performed >= 1
    engine.program_report(analyze=True)
    assert engine.engine_stats()["program_analyses"] - before == performed  # memoized, failures included
    many = [r for r in rows if r["kind"] == "suite-many"]
    assert many and many[0]["analysis"]["bytes_accessed"] > 0 and many[0]["analysis"]["argument_bytes"] > 0
    for name, m in suite.items(keep_base=True, copy_state=False):
        assert m._update_count == counts[name]
        for k, v in m.metric_state.items():
            want = states[name][k]
            assert (torch.equal(v, want) if isinstance(v, torch.Tensor)
                    else all(torch.equal(a, b) for a, b in zip(v, want))), (name, k)


def test_flops_and_bytes_are_counted_in_torch_terms():
    m, k, n = 64, 32, 16
    exe = engine.acquire_keyed(("ledger-matmul", m, k, n), lambda: (lambda state, a, b: a @ b + 1.0))
    exe(None, torch.ones(m, k), torch.ones(k, n))
    analysis = engine._analyze(exe)
    assert analysis["flops"] == 2 * m * k * n
    # the product reads a and b and writes (m, n); the add reads it and writes (m, n)
    assert analysis["bytes_accessed"] == 4 * (m * k + k * n + m * n) + 4 * (2 * m * n)
    assert analysis["argument_bytes"] == 4 * (m * k + k * n) and analysis["output_bytes"] == 4 * m * n


def test_a_step_that_cannot_run_reports_none_once():
    calls = []

    def build():
        def step(state, x):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("no second run")
            return x

        return step

    exe = engine.acquire_keyed(("ledger-once",), build)
    exe(None, torch.ones(3))
    before = engine.engine_stats()["program_analyses"]
    assert engine._analyze(exe) is None and engine._analyze(exe) is None
    assert engine.engine_stats()["program_analyses"] - before == 1


def test_a_new_signature_drops_the_memo():
    exe = engine.acquire_keyed(("ledger-sig",), lambda: (lambda state, x: x * 2))
    exe(None, torch.ones(4))
    first = engine._analyze(exe)
    exe(None, torch.ones(8))
    second = engine._analyze(exe)
    assert second["bytes_accessed"] == 2 * first["bytes_accessed"] and exe.compiles == 2


def test_the_cpu_calibrates_when_asked():
    engine.set_roofline_peaks(None)
    peaks = engine.roofline_peaks("cpu")
    assert peaks["calibrated"] and peaks["peak_flops_per_s"] > 0 and peaks["peak_bytes_per_s"] > 0
    assert peaks["ridge_flops_per_byte"] == peaks["peak_flops_per_s"] / peaks["peak_bytes_per_s"]
    assert engine.roofline_peaks() is peaks  # once a process


def test_the_trace_export_carries_the_ledger():
    _drive(tmt, torch.from_numpy)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        telemetry.export_trace(path)
        doc = json.load(open(path))
    assert isinstance(doc["programLedger"], list) and doc["programLedger"]
    assert set(doc["snapshot"]["programs"]) == set(jengine.program_summary())
