"""A cell, a traffic mix, a per-layer metric and a configuration of a new data kind are added by new files
and entries alone."""
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, REPO, SMALL


def test_a_new_cell_mix_and_metric_run_from_files_and_entries(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    # a new traffic mix: one softmax image a step
    (tmp_path / "portbench" / "traffic" / "softmax-b1.json").write_text(json.dumps(
        {"input": "softmax", "batch": 1, "warm": "shapes", "loop": "closed"}))
    # a new per-layer metric: the updates the window made
    (tmp_path / "portbench" / "layers" / "updates_made.py").write_text(
        "def read(trace, window):\n    return float(window['updates'])\n")
    spec["workloads"].append({"name": "seg19.softmax-b1", "config": "cityscapes-seg19", "traffic": "softmax-b1",
                              "chips": 1, "why": "one image a step"})
    spec["per_layer"].append({"name": "updates_made", "unit": "updates", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "samples_per_s",
                              "workloads": ["seg19.softmax-b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, 'portbench'); import harness; "
            "spec = json.load(open('BENCHMARK.json')); "
            f"r = harness.run_cell(spec, 'seg19.softmax-b1', 3, 0.5, True, 'cpu', data_overrides={SMALL['cityscapes-seg19']!r}); "
            "print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["updates_made"]["value"] > 0
    assert "seg_update_roofline" not in result["metrics"]  # not listed for the new cell


NEW_KIND_GENERATOR = """
import torch
from generate import seeded_generator


def make_inputs(data, traffic, seed, device):
    g = seeded_generator(seed, device)
    n = data["rows_per_epoch"]
    target = torch.randn(n, generator=g, device=device)
    preds = target + data["noise"] * torch.randn(n, generator=g, device=device)
    return [(preds, target)]


def epoch_steps(data, traffic, inputs):
    preds, target = inputs[0]
    return list(zip(torch.split(preds, traffic["batch"]), torch.split(target, traffic["batch"])))
"""

NEW_KIND_REFERENCE = """
import torch


def accumulate(steps, config, dtype):
    preds = torch.cat([p for p, _ in steps]) if steps else torch.zeros(0)
    target = torch.cat([t for _, t in steps]) if steps else torch.zeros(0)
    return {"sse": float(((preds.to(dtype) - target.to(dtype)) ** 2).sum()), "total": preds.numel()}


def canonical(program_states, config):
    st = program_states["mse"]
    return {"sse": float(st["sum_squared_error"]), "total": int(st["total"])}


def compare_states(candidate, expected):
    gap = abs(candidate["sse"] - expected["sse"]) / max(abs(expected["sse"]), 1e-30)
    return {"total_off": float(abs(candidate["total"] - expected["total"])), "sse_gap": gap}


def values(state, config, dtype):
    return {"mse": state["sse"] / state["total"]}
"""


def test_a_configuration_of_a_new_data_kind_runs_from_files_and_entries(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "portbench"
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (bench / "generators" / "paired_values.py").write_text(NEW_KIND_GENERATOR)
    (bench / "reference" / "toy-mse.py").write_text(NEW_KIND_REFERENCE)
    (bench / "configs" / "toy-mse.json").write_text(json.dumps({
        "name": "toy-mse", "suite": {"mse": {"class": "MeanSquaredError", "args": {}}},
        "data": {"kind": "paired_values", "rows_per_epoch": 5000, "noise": 0.1},
        "limits": {"total_off": 0, "sse_gap": 1e-4, "mse_gap": 1e-4}}))
    (bench / "traffic" / "pairs-b1000.json").write_text(json.dumps({"batch": 1000, "warm": "shapes"}))
    spec["configs"].append({"name": "toy-mse", "source": "https://example.org/toy", "file": "portbench/configs/toy-mse.json",
                            "reduced": [], "why": "a configuration of a data kind the benchmark did not have"})
    spec["workloads"].append({"name": "toy.mse", "config": "toy-mse", "traffic": "pairs-b1000", "chips": 1,
                              "why": "paired values, 1000 a step"})
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["toy.mse"]) if m["name"] == "samples_per_s" else m
                          for m in spec["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, 'portbench'); import harness; "
            "spec = json.load(open('BENCHMARK.json')); "
            "r = harness.run_cell(spec, 'toy.mse', 2**31 + 11, 0.5, False, 'cpu'); print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert set(result["check"]) == {"total_off", "sse_gap", "mse_gap"}
    assert result["metrics"]["samples_per_s"]["value"] > 0
