"""Shared pieces of the benchmark's CPU tests: the spec, and sizes a test run can hold."""
import json
import os
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for path in (str(REPO), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

# one intra-op thread a test process, and in the processes it starts: several test processes with a thread
# a core each would contend for the cores, and a short window would then finish no epoch
os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)

# every cell of BENCHMARK.json at a size a CPU test holds: the same kinds, batches and loop
SMALL = {
    "cityscapes-seg19": {"height": 64, "width": 128, "distinct_batches": 3, "images_per_epoch": 7,
                         "region_cells": [4, 8], "error_cells": [8, 16]},
    "criteo1tb-ctr": {"rows_per_epoch": 600_000},
}
SMALL_BATCH = {"criteo1tb-ctr": 65_536}


@pytest.fixture(scope="session")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def small_cell(spec, workload):
    """The cell's harness objects at the small size (the batch of a CTR mix cut to keep several steps)."""
    import harness

    config = next(w for w in spec["workloads"] if w["name"] == workload)["config"]
    cell = harness.Cell(spec, workload, data_overrides=SMALL[config])
    if config in SMALL_BATCH:
        cell.traffic = dict(cell.traffic, batch=SMALL_BATCH[config])
    return cell
