"""The metric arithmetic: the p95 over every update, rooflines from counted bytes, the idle share and the
breakdown from synthetic intervals, the host reads inside compute spans."""
import importlib.util
from pathlib import Path

import pytest
import torch

import devtrace
import work

BENCH = Path(__file__).resolve().parents[1]


def reader(kind, name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), BENCH / kind / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_p95_is_the_nearest_rank_over_every_update():
    assert work.p95(range(1, 101)) == 95
    assert work.p95([5.0]) == 5.0
    assert work.p95(list(range(20, 0, -1))) == 19
    with pytest.raises(ValueError):
        work.p95([])


def test_spread_is_the_interquartile_range_over_the_median():
    assert work.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    values = [98.0, 99.0, 100.0, 101.0, 102.0, 103.0]
    q1, q3 = 98.75, 102.25  # statistics.quantiles, exclusive method
    assert abs(work.spread(values) - (q3 - q1) / 100.5) < 1e-12


def test_rooflines_come_from_the_bytes_the_inputs_fix():
    preds = torch.zeros(2, 19, 4, 8)  # float32: 4864 bytes
    target = torch.zeros(2, 4, 8, dtype=torch.int64)  # 512 bytes
    assert work.step_bytes((preds, target), 100) == 4864 + 512 + 100
    assert work.compute_bytes([(torch.zeros(10), torch.zeros(10, dtype=torch.int64))] * 3, 3) == 3 * 120 + 12
    # 3.35e9 bytes in 2 ms at 3.35e12 B/s: 1 ms of 2, 50%
    assert work.roofline_share(3.35e9, 2e-3, 3.35e12) == pytest.approx(50.0)
    roof = reader("layers", "seg_update_roofline")
    tr = devtrace.Trace([("k", 0, 1_000_000), ("k", 1_500_000, 2_000_000)], [],
                        {"update": [(0, 100)], "sync": [(100, 2_000_000)]}, (0, 4_000_000))
    window = {"update_bytes": [3.35e12 * 1.5e-3], "peaks": work.DEFAULT_PEAKS}
    assert roof.read(tr, window) == pytest.approx(100.0)  # 1.5 ms of device time, 1.5 ms least
    assert roof.read(None, window) is None


def test_idle_share_and_busy_time_from_synthetic_intervals():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 40, 50), ("d", 90, 130)]  # the last one runs past the window
    tr = devtrace.Trace(ops, [], {"update": [(0, 35)], "compute": [(35, 100)]}, (0, 100))
    assert tr.busy == [(0, 20), (40, 50), (90, 100)]
    assert tr.busy_s == pytest.approx(40e-9) and tr.window_s == pytest.approx(100e-9)
    assert reader("layers", "idle_share").read(tr, {}) == pytest.approx(60.0)
    assert tr.device_s_within([(10, 45)]) == pytest.approx(15e-9)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "b" and len(bd["device_ops"]) == 4
    # each gap goes to the span open at its middle: 20-40 to update, 50-90 to compute
    assert bd["idle_gaps"] == [["compute", pytest.approx(40e-9)], ["update", pytest.approx(20e-9)]]
    assert reader("layers", "idle_share").read(devtrace.Trace([], [], {}, (0, 10)), {}) is None


def test_host_reads_are_counted_inside_compute_spans_only():
    host = [("aten::item", 5), ("aten::_local_scalar_dense", 6), ("aten::nonzero", 50), ("aten::item", 150)]
    tr = devtrace.Trace([], host, {"compute": [(0, 10), (40, 60)]}, (0, 200))
    assert reader("layers", "compute_host_reads.ctr").read(tr, {}) == 1.5


def test_end_to_end_readers_take_the_whole_window():
    window = {"samples": 500, "seconds": 2.0, "update_ms": [1.0] * 19 + [9.0], "compute_ms": [10.0, 30.0],
              "peak_extra_bytes": 3 * 2**30, "setup_s": 12.5}
    assert reader("end_to_end", "samples_per_s").read(window) == 250.0
    assert reader("end_to_end", "update_ms_p95").read(window) == 1.0
    assert reader("end_to_end", "compute_ms").read(window) == 20.0
    assert reader("end_to_end", "peak_extra_mem_gib").read(window) == 3.0
    assert reader("end_to_end", "setup_s").read(window) == 12.5
    assert reader("end_to_end", "compute_ms").read(dict(window, compute_ms=[])) is None
