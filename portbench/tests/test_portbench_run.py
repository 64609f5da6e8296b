"""A run's last line and its refusals: the schema, no result without a card or without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, REPO, SMALL, SMALL_BATCH

import harness

WORKLOADS = ["seg19.softmax-b2", "ctr.epoch-89m", "seg19.labels-b8"]  # the one-chip cells


def small_run(spec, workload, trace, seed=2**31 + 5):
    config = next(w for w in spec["workloads"] if w["name"] == workload)["config"]
    spec = json.loads(json.dumps(spec))
    if config in SMALL_BATCH:  # the batch is the traffic's; a test copy of the spec cannot carry it, so patch
        original = harness.Cell.__init__

        def init(self, *a, **k):
            original(self, *a, **k)
            self.traffic = dict(self.traffic, batch=SMALL_BATCH[config])
        harness.Cell.__init__ = init
        try:
            return harness.run_cell(spec, workload, seed, 2.0, trace, "cpu", data_overrides=SMALL[config])
        finally:
            harness.Cell.__init__ = original
    return harness.run_cell(spec, workload, seed, 2.0, trace, "cpu", data_overrides=SMALL[config])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_last_line_has_the_contract_keys_and_the_check_last(spec, workload, trace):
    result = small_run(spec, workload, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    entries = {m["name"]: m for m in spec["per_layer" if trace else "end_to_end"]}
    listed = {n for n, m in entries.items() if "workloads" not in m or workload in m["workloads"]}
    assert set(result["metrics"]) <= listed
    for name, metric in result["metrics"].items():
        assert metric["unit"] == entries[name]["unit"] and isinstance(metric["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert all(len(v) <= 10 for v in result["breakdown"].values())
    else:
        assert listed == set(result["metrics"])  # a CPU run reads every end-to-end metric but the card's
    assert list(result)[-2] == "setup" and isinstance(result["setup"]["built"], list)
    assert all(v >= 0 for k, v in result["setup"].items() if k != "built")
    for number in result["check"].values():
        assert set(number) == {"value", "limit"}
    json.dumps(result)


def test_a_run_without_a_card_exits_with_2_and_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "seg19.softmax-b2", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_a_run_beside_no_program_fails_and_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import json, sys; sys.path.insert(0, 'portbench'); import harness; "
            "spec = json.load(open('BENCHMARK.json')); "
            "print(json.dumps(harness.run_cell(spec, 'ctr.epoch-89m', 1, 0.2, False, 'cpu', "
            "data_overrides={'rows_per_epoch': 1000})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "metrics_tpu_torch" in proc.stderr


@pytest.mark.parametrize("workload, pinned", [("ctr.epoch-89m", True), ("seg19.softmax-b2", True), ("no-such-cell", False)])
def test_a_one_chip_run_is_pinned_to_two_fixed_cores(spec, workload, pinned):
    code = ("import json, os, sys; sys.path.insert(0, 'portbench'); import run; "
            "before = sorted(os.sched_getaffinity(0)); "
            f"run.pin_host_cpus(json.load(open('BENCHMARK.json')), {workload!r}); "
            "print(json.dumps([before, sorted(os.sched_getaffinity(0))]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    before, after = json.loads(proc.stdout.strip().splitlines()[-1])
    import run
    if not run.HOST_CPUS <= set(before):
        pytest.skip("this machine has fewer than four cores")
    assert after == (sorted(run.HOST_CPUS) if pinned else before)
