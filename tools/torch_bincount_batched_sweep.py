"""The batched bincount kernel (``mt_bincount_batched``) on the card: every regime and split against its
plain version, then the time of each candidate split at the shapes the port's paths give it.

Run on a machine with an NVIDIA GPU, from the root of the repository::

    python3 tools/torch_bincount_batched_sweep.py [--out build/bincount_batched_sweep.json]

It builds ``metrics_tpu_torch/csrc/bincount.cu`` (the nvcc log, with each kernel's registers and shared
memory, is printed), prints the largest cluster the card takes, holds the kernel bit for bit against
``_bincount_batched_plain`` (int32 and int64 ids, ids per row and shared, no weights and dyadic weights:
every float sum is exact in any order) at each regime's boundaries and under every split a regime takes,
checks that a launch the kernel refuses raises, and times each split at the path shapes with CUDA events
(mean of 200 calls after 20: host-bound below some 20 us a call) and with torch.profiler (device time of
50 calls), under every regime and split that can take each shape, in turns (``--repeats``), beside the
plan's own choice, the plain version, one ``torch.bincount`` over
ids offset by ``row * length``, the device time of ``torch.zeros`` of the counts (writing them once) and the
bytes bound at 3.35 TB/s. Exits 1 when there is no GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metrics_tpu_torch.ops import _native, histogram  # noqa: E402
from metrics_tpu_torch.ops.histogram import BatchedPlan, _slice_bins, batched_plan  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# (name, rows, ids a row, bins, ids shared by every row): the shapes the port's paths give the kernel
PATH_SHAPES = [("vmap_suites", 8, 8192, 128**2, False), ("row_deltas_confmat", 33, 1, 10**6, False),
               ("shared_ids", 100, 1000, 1000, True), ("arena_chunk", 65536, 8, 100, False)]
# shapes off the paths that decide the plan's rule between the cluster and global regimes: many ids into
# few bins (contention), as many ids as bins, and a row wider than one CTA's shared memory
RULE_SHAPES = [("dense_4096", 8, 65536, 4096, False), ("dense_4", 8, 131072, 4, False),
               ("even_16384", 8, 16384, 16384, False), ("wide_100000", 8, 8192, 100000, False),
               ("dense_rows_1000", 132, 16384, 1000, False)]


def boundary_shapes(k: int) -> list:
    """(rows, n, length) at each regime's edges for a largest cluster of ``k``."""
    top = histogram.SHARED_MAX_BINS
    pm, pi = histogram.PACKED_ROW_MAX_BINS, histogram.PACKED_MAX_IDS
    return [(1, 0, 5), (3, 1000, 361), (2, pi, pm), (2, pi + 1, pm), (2, pi, pm + 1), (8, 8192, top),
            (8, 8192, top + 1), (4, 2048, k * top), (4, 2048, k * top + 1), (5, 4096, 10**6), (33, 1, 10**6),
            (70000, 16, 4), (65536, 8, 100), (100, 1000, 1000), (1, 300000, 7), (3, 1, 1)]


def splits_of(regime: str, length: int, k: int) -> list:
    if regime == "packed":
        return [s for s in (1, 2, 4, 8, 16, 32, 64, 128, 256) if s * length <= histogram.PACKED_MAX_BINS]
    out = [s for s in (1, 2, 4, 8, 16) if s <= k]
    return [s for s in out if regime == "global" or _slice_bins(length, s) <= histogram.SHARED_MAX_BINS]


def forced(plan: BatchedPlan, split: int, rows: int, length: int) -> BatchedPlan:
    if plan.regime == "packed":
        return BatchedPlan("packed", split, min(-(-rows // split), histogram.MAX_GRID), length)
    return BatchedPlan(plan.regime, split, plan.grid, _slice_bins(length, split) if plan.regime == "cluster" else length)


def check(k: int, g: torch.Generator) -> dict:
    dev = torch.device("cuda")
    checked = 0
    for rows, n, length in boundary_shapes(k):
        default = batched_plan(rows, n, length, k)
        for shared in (False, True):
            x = torch.randint(-3, length + 3, (1 if shared else rows, n), generator=g, device=dev)
            w = torch.randint(1, 5, x.shape, generator=g, device=dev).float() * 0.5
            for ids in (x, x.to(torch.int32)):
                for weights in (None, w):
                    want = histogram._bincount_batched_plain(ids, length, weights, rows)
                    plans = [default] + [forced(default, s, rows, length) for s in splits_of(default.regime, length, k)
                                         if s != default.split and rows * length <= 2**25]
                    for plan in plans:
                        got = histogram._launch_batched(ids, length, weights, rows, plan)
                        torch.cuda.synchronize()
                        assert torch.equal(got, want), (rows, n, length, shared, ids.dtype, weights is None, plan)
                        checked += 1
        print(f"check rows={rows} n={n} L={length}: {default} exact, every split of its regime", flush=True)
    refused = {}
    x = torch.zeros((2, 4), dtype=torch.int64, device=dev)
    for label, plan in (("cluster slice above 32768", BatchedPlan("cluster", 1, 2, 40000)),
                        ("packed above 16384 bins", BatchedPlan("packed", 2, 1, 10000)),
                        ("split of 32", BatchedPlan("global", 32, 2, 10))):
        length = plan.slice
        try:
            histogram._launch_batched(x, length, None, 2, plan)
            refused[label] = None
        except RuntimeError as err:
            refused[label] = str(err)
    assert all(refused.values()), refused
    print(f"refused launches raise: {json.dumps(refused)}", flush=True)
    return {"cases": checked, "refused": refused}


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 50) -> float:
    """Device time of one call from torch.profiler: the device-side rows of ``calls`` calls (after two
    traced in the warm-up cycle) over ``calls``; None where the session recorded fewer operations."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn(), fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    rows = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0
            and e.self_cpu_time_total == 0 and not e.key.startswith("ProfilerStep")]
    if sum(e.count for e in rows) < calls:
        return None
    return sum(e.self_device_time_total for e in rows) / calls / 1e3


def regimes_of(length: int, k: int) -> list:
    """The regimes that can take a row of ``length`` bins."""
    out = ["packed"] if length <= histogram.PACKED_MAX_BINS else []
    return out + (["cluster"] if _slice_bins(length, k) <= histogram.SHARED_MAX_BINS else []) + ["global"]


def sweep(k: int, g: torch.Generator, repeats: int) -> list:
    """Each path shape (and each of ``RULE_SHAPES``) under the plan's choice and under every regime and split
    that can take it, ``repeats`` times in turn (device ms from the profiler; CUDA-event ms, host-bound below some 20 us a call)."""
    dev = torch.device("cuda")
    out = []
    for name, rows, n, length, shared in PATH_SHAPES + RULE_SHAPES:
        x = torch.randint(0, length, (1 if shared else rows, n), generator=g, device=dev)
        default = batched_plan(rows, n, length, k)
        bytes_moved = x.numel() * x.element_size() + 4 * rows * length
        row = {"shape": name, "rows": rows, "n": n, "length": length, "plan": default._asdict(),
               "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "splits": {}}
        plans = {"plan": default}
        for regime in regimes_of(length, k):
            base = BatchedPlan(regime, 1, min(rows, histogram.MAX_GRID), length)
            for split in splits_of(regime, length, k):
                plans[f"{regime}/{split}"] = forced(base, split, rows, length)
        for label in plans:
            row["splits"][label] = {"device_ms": [], "ms": []}
        for _ in range(repeats):
            for label, plan in plans.items():
                call = lambda: histogram._launch_batched(x, length, None, rows, plan)  # noqa: E731
                row["splits"][label]["device_ms"].append(device_ms(call))
                row["splits"][label]["ms"].append(time_ms(call))
        # the floor of writing the counts once: torch's fill of as many int32 zeros (device time)
        row["fill_device_ms"] = device_ms(lambda: torch.zeros(rows * length, dtype=torch.int32, device=dev))
        row["plain_ms"] = time_ms(lambda: histogram._bincount_batched_plain(x, length, None, rows), 50, 5)
        flat = (x.expand(rows, n) + torch.arange(rows, device=dev).unsqueeze(1) * length).reshape(-1)
        row["library_ms"] = time_ms(lambda: torch.bincount(flat, minlength=rows * length), 50, 5)
        out.append(row)
        print(f"sweep {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/bincount_batched_sweep.json")
    parser.add_argument("--repeats", type=int, default=3, help="turns over the plans of each shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the batched bincount kernel runs only on the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    path = _native.build(histogram.SOURCE)
    print(path.with_suffix(".log").read_text().strip(), flush=True)
    k = histogram.max_cluster(0)
    print(f"largest cluster: {k}  [{card}]", flush=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    result = {"card": card, "max_cluster": k, "check": check(k, g), "sweep": sweep(k, g, args.repeats)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
