#!/usr/bin/env python3
"""Drive metrics_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA device

Phases, each of which raises on failure (exit code 1):

1. The card's name and power limit (nvidia-smi), and the build of every CUDA
   kernel from ``metrics_tpu_torch/csrc`` with nvcc.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it and at edge shapes: the bincount on its dispatched
   path and on each of its two paths (shared-memory, global), at the
   shared-memory threshold and one bin above it, with hot bins, on memory
   full of junk, at N=0 and N=1. Then a sweep of six shapes the port gives
   the bincount (main, large-L, multilabel, binary, one-bin, segmentation),
   both paths:
   device time and device operations per call (torch.profiler; a session that
   records fewer device operations than calls is tried again, and after three
   such sessions the row's device time is null), one launch per call (the wrapper's counter),
   wrapper time (CUDA events) and host time per call, beside the plain
   version, ``torch.bincount`` and the bound. One JSON line
   ``{"bincount_sweep": ...}``.
3. The main path: the headline suite of ``bench.py`` (Accuracy, F1Score,
   ConfusionMatrix, Precision; macro, C=128) on batches of B=8192 softmax
   rows, 5 warm-up and 50 timed ``update`` steps, then ``compute()``, in
   validation modes "first" and "full". Every state and value must equal the
   same suite run on the CPU on the same batches, the kernel launch count
   must equal the ConfusionMatrix update count, and F1Score and Precision
   must share a compute group.
4. The large-L path: the same suite at C=1000 (L = 10**6 bins), B=4096, 10 steps,
   checked against the CPU the same way.
5. The multilabel path: ConfusionMatrix(multilabel=True) at B=8192, C=128
   (2**20 ids into 512 bins a step), 10 steps, its state equal to the CPU's
   and one kernel launch per update.
6. The agreement path, ImageNet-1k width: CohenKappa, MatthewsCorrCoef,
   JaccardIndex (C=1000, L = 10**6 bins), Specificity (macro) and
   HammingDistance in one collection, B=4096 softmax rows a step. The three
   confusion-matrix metrics must share one compute group: the first update
   runs every member to find the groups (three launches), every later one
   launches the kernel once.
7. The segmentation path, Cityscapes width: JaccardIndex (mIoU) and Dice
   (macro, global) with C=19 on B=2 images of 1024 x 2048, preds a float32
   softmax (2, 19, 1024, 2048): N = 4,194,304 ids into L = 361 bins a step,
   one launch a step.
8. The aggregation path: MeanMetric (weighted), SumMetric, MaxMetric,
   MinMetric and CatMetric on per-step loss tensors with NaNs, under each
   ``nan_strategy`` and validation mode, against the CPU; then the five in
   one collection, timed.
9. The curve paths. ``curves_binary``: AUROC, AveragePrecision, ROC and
   PrecisionRecallCurve (binary) in one collection over 64 updates of
   262,144 scores (2**24 in all; Bernoulli(0.03) labels, scores rounded to
   multiples of 2**-12, so long tie runs form), one ``compute()``.
   ``curves_imagenet``: AUROC and AveragePrecision (macro, C=1000),
   CalibrationError (15 bins) and BinnedAveragePrecision (100 thresholds)
   over 50 updates of 1000 softmax rows (the 50,000 ImageNet-1k validation
   rows), one ``compute()``, then the weighted functional AUROC and AP on the
   same arrays (one bincount each). Each is held against the same suite on
   the CPU: states, counts and curves bit for bit, areas within
   ``CURVE_AREA_ATOL``; the binned updates' CPU twin runs every batch only if
   it takes about ``CPU_TWIN_BINNED_S``, else the first 5. Reported: update
   ms per step (median of 3 runs, mode "first"), ``compute()`` ms, device
   busy time and idle share of both, the host reads of the device a
   ``compute()`` makes, the 2**24 sort's device time and the binned update's
   (with bounds and peak memory). Then ``sorted_curves``: the sort-based
   binary and multi-class AUROC and AP on both paths' arrays against the
   eager values (``SORTED_AREA_ATOL``), timed against the eager calls.
10. The sync path: the headline, agreement, segmentation and aggregator suites
   (full width, two updates each), a binary AUROC + AveragePrecision suite
   buffering rows of shapes (n,) and (n, 1), a regression suite (Pearson's
   moments of spec None, stacked by the sync; Spearman's ``cat`` rows) and a
   retrieval suite (rows of int64 query ids in list states of spec None, which
   decline the packed lane and sync row by row, as in JAX) synced across
   processes. First through
   NCCL in a process group of one rank, the sync forced: every state after a
   sync equals the state before it bit for bit, ``unsync`` puts the local
   states back, a coalesced sync is one payload collective (plus one metadata
   collective where a ``cat`` state is packed), and the per-state protocol,
   forced with an explicit ``dist_sync_fn``, gives the same states with two
   collectives a state; both protocols timed. Then two spawned ranks on the
   one card joined by Gloo with CUDA tensors (NCCL refuses two ranks on one
   device), each fed its own batches and losses of an uneven length: their
   ``compute()`` (which syncs) must equal one CPU instance fed every batch of
   both, counts bit-exact and values within atol 1e-6 and rtol 1e-5.
11. ``ranking_imagenet`` (run after phase 9, before the sync): CoverageError,
   LabelRankingAveragePrecision and LabelRankingLoss on multi-label targets
   (1 to 3 positives a row), HingeLoss (Crammer-Singer and one-vs-all, the
   first positive as the class) and KLDivergence (against a second model's
   softmax) over 50 updates of (1000, 1000) softmax rows, one update's scores
   rounded to 2**-12 for ties. LRAP's compare runs in blocks under 256 MiB.
12. ``regression_2p24``: all twelve regression metrics (Tweedie at power 1.5)
   in one collection over 64 updates of 262,144 rows (2**24; targets >= 0
   with 30% zeros, preds > 0), one ``compute()`` (Spearman sorts 2**24 twice);
   then R2Score, ExplainedVariance and MeanSquaredError per output over 16
   updates of (65,536, 16).
13. ``pairwise_embeddings``: the four pairwise functions on x (4096, 768)
   against y (8192, 768), reduction None and "mean", then x against itself
   (zero diagonal); Manhattan in row blocks under 256 MiB. The CPU twin
   computes the first ``PAIRWISE_CPU_ROWS`` rows.
14. ``retrieval_msmarco``: ten retrieval metrics in one collection over
   6,980 queries x 1,000 candidates (MS MARCO dev-small re-ranking; 70
   updates of 100 queries, the last of 80; scores rounded to 2**-10; about 1% of queries
   with no relevant passage), one ``compute()`` and a second that must give
   the same bits; a graded NDCG (0 to 3); the nine one-query functions on
   100 queries. Each query grouping counts its rows with the bincount kernel.
   The CPU twin computes all 70 updates only if that takes about
   ``RETRIEVAL_CPU_TWIN_S``, else the first 10 against a card suite fed the
   same 10.

Paths 6 and 7 run in validation modes "first" and "full" (3 alternating
trials each), equal the CPU on the same batches (counts bit-exact, values
within rtol 1e-5) and report steps/s, device ms/step by kernel and the
device's idle share. Paths 11 to 14 hold every state and value against a CPU
twin fed the same batches (counts, ranks and hits bit for bit; floats within
the tolerances stated beside their constants) and report update ms per step
(median of 3 runs, mode "first"), ``compute()`` ms (the first and the next),
device time and idle share (torch.profiler), the host reads a ``compute()``
makes, peak extra device memory and bincount launches, and the device time
of the grouping sort, the segmented scan, the LRAP compare and the Spearman
sort beside their bounds.

Output: labelled lines, then a JSON line ``{"kernels": [...]}``, then the
nvidia-smi line, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4  # weighted bincount: float32 atomics in run-dependent order
PROFILE_ATTEMPTS = 3  # profiler sessions tried before a sweep row's device time is "not measured"


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call of ``fn`` on the card, from CUDA events around ``iters`` calls."""
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


# ------------------------------------------------------------------ phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels(native, histogram) -> float:
    t0 = time.perf_counter()
    path = native.build(histogram.SOURCE)
    seconds = time.perf_counter() - t0
    log(f"build: {histogram.SOURCE} -> {path.relative_to(HERE)} in {seconds:.2f} s")
    log(path.with_suffix(".log").read_text().strip())
    return seconds


# ------------------------------------------------------------------ phase 2
def multilabel_ids(g, batch: int, num_classes: int):
    """The multilabel ConfusionMatrix's ids: ``(2*target + preds) + 4*class``, N = B*C into L = 4C."""
    dev = torch.device("cuda")
    target = torch.randint(0, 2, (batch, num_classes), generator=g, device=dev)
    preds = torch.randint(0, 2, (batch, num_classes), generator=g, device=dev)
    return ((2 * target + preds) + 4 * torch.arange(num_classes, device=dev)).reshape(-1)


def dirty_call(histogram, x, length, weights):
    """``fused_bincount`` on memory full of junk: a same-size block is filled,
    freed and handed back by the allocator as the counts."""
    dtype = torch.int32 if weights is None else torch.float32
    junk = torch.full((length,), -12345, dtype=dtype, device=x.device)
    ptr = junk.data_ptr()
    del junk
    got = histogram.fused_bincount(x, length, weights=weights)
    assert got.data_ptr() == ptr, "dirty memory: the allocator did not hand back the junk block"
    return got


def check_bincount(histogram) -> float:
    """Hold the kernel against its plain version on both paths at every shape.
    Returns the largest |error| of a weighted sum."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []  # (label, ids, length, weights, weighted sums exact)

    def rand_ids(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dtype)

    def rand_w(n):
        return torch.rand(n, generator=g, device=dev)

    def dyadic(n):  # multiples of 1/2: every partial sum here is exact in float32, in any order
        return torch.randint(1, 5, (n,), generator=g, device=dev).float() * 0.5

    big = 1 << 20
    top = histogram.SHARED_MAX_BINS
    # the main path's shape and dtype: ConfusionMatrix, C=128, B=8192, argmax labels (int64)
    main_x = rand_ids(8192, 0, 128**2)
    cases.append(("main N=8192 L=16384 int64", main_x, 128**2, rand_w(8192), False))
    cases.append(("main N=8192 L=16384 int32", main_x.to(torch.int32), 128**2, rand_w(8192), False))
    cases.append(("imagenet N=8192 L=1e6", rand_ids(8192, 0, 10**6), 10**6, rand_w(8192), False))
    cases.append((f"threshold L={top}", rand_ids(big, -5, top + 5), top, rand_w(big), False))
    cases.append((f"threshold+1 L={top + 1}", rand_ids(big, -5, top + 6), top + 1, rand_w(big), False))
    cases.append(("multilabel N=2**20 L=512", multilabel_ids(g, 8192, 128), 512, rand_w(big), False))
    cases.append(("binary N=2**20 L=4", rand_ids(big, 0, 4), 4, dyadic(big), True))
    # one bin takes every id: worst-case contention
    same = torch.full((big,), 7, dtype=torch.int64, device=dev)
    cases.append(("contention N=2**20 one bin", same, 128**2, dyadic(big), True))
    cases.append(("out of range N=8192", rand_ids(8192, -(128**2), 2 * 128**2, torch.int32), 128**2, rand_w(8192), False))
    wide = torch.tensor([2**32 + 5, 2**31, 2**31 + 7, -(2**40), 5, 2**33], dtype=torch.int64, device=dev)
    wide = torch.cat([wide, rand_ids(4096, 0, 64)])
    cases.append(("int64 beyond 2**31", wide, 64, rand_w(wide.numel()), False))
    cases.append(("N=1", rand_ids(1, 0, 10), 10, rand_w(1), False))
    cases.append(("N=0", rand_ids(0, 0, 10), 10, rand_w(0), False))

    max_abs_err = 0.0
    for label, x, length, w, exact in cases:
        want = histogram._bincount_plain(x, length)
        want_w = histogram._bincount_plain(x, length, w)
        # the dispatched path (what the main path calls), then the global path at the same shape
        runs = [("dispatched", lambda w_: histogram.fused_bincount(x, length, weights=w_))]
        runs.append(("global", lambda w_: histogram._launch(x, length, w_, False)))
        if length <= histogram.SHARED_MAX_BINS:
            runs.append(("shared", lambda w_: histogram._launch(x, length, w_, True)))
        errs = []
        for path, run in runs:
            before = histogram.KERNEL_LAUNCHES
            got, got_w = run(None), run(w)
            assert histogram.KERNEL_LAUNCHES == before + 2, f"bincount {label} ({path}): not one launch per call"
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), f"bincount {label} ({path}): counts differ"
            if exact:
                assert torch.equal(got_w, want_w), f"bincount {label} ({path}): dyadic weighted sums differ"
            else:
                torch.testing.assert_close(got_w, want_w, rtol=RTOL, atol=ATOL, msg=f"bincount {label} ({path})")
            errs.append(float((got_w - want_w).abs().max()) if length else 0.0)
        max_abs_err = max(max_abs_err, *errs)
        log(f"bincount {label}: unweighted exact on {len(runs)} paths, weighted max |err| {max(errs):.3g}"
            + (" (dyadic: exact)" if exact else ""))
    wide_counts = histogram.fused_bincount(wide, 64)
    assert int(wide_counts[5]) == 1 + int((wide[6:] == 5).sum()), "an int64 id beyond 2**31 was counted"

    # dirty memory: the counts come from torch.empty, so the kernel must write every bin
    for label, x, length in (("main (shared path)", main_x, 128**2), ("L=1e6 (global path)", cases[2][1], 10**6)):
        for w in (None, torch.ones(x.numel(), device=dev)):
            got = dirty_call(histogram, x, length, w)
            torch.cuda.synchronize()
            assert torch.equal(got, histogram._bincount_plain(x, length, w)), f"dirty memory {label}: differs"
        log(f"bincount dirty memory {label}: the junk block was handed back and overwritten exactly")
    return max_abs_err


def host_us_per_call(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host microseconds per call of ``fn`` over ``iters`` calls that end in one synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def sweep_bincount(histogram, card: str) -> list:
    """Both paths of the kernel, the plain version and torch.bincount at the shapes the port
    gives it, unweighted and with int64 ids, as the ConfusionMatrix calls it."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    big = 1 << 20
    shapes = [
        ("main", torch.randint(0, 128**2, (8192,), generator=g, device=dev), 128**2),
        ("large-L", torch.randint(0, 10**6, (4096,), generator=g, device=dev), 10**6),
        ("multilabel", multilabel_ids(g, 8192, 128), 512),
        ("binary", torch.randint(0, 4, (big,), generator=g, device=dev), 4),
        ("one-bin", torch.full((big,), 7, dtype=torch.int64, device=dev), 128**2),
        # JaccardIndex at Cityscapes width: 2 x 1024 x 2048 pixel ids into 19**2 bins
        ("segmentation", torch.randint(0, 19**2, (2 * 1024 * 2048,), generator=g, device=dev), 19**2),
    ]
    rows = []
    for name, x, length in shapes:
        bytes_moved = x.numel() * x.element_size() + 4 * length  # ids read once, counts written once
        # bytes bound it: a compare and an add an id are far below the card's operation rate
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, 2 * x.numel() / FP32_OPS_PER_S) * 1e3
        row = {"shape": name, "n": x.numel(), "length": length, "bytes": bytes_moved, "bound_ms": bound_ms,
               "dispatched_path": histogram.kernel_path(length)}
        paths = [("dispatched", lambda: histogram.fused_bincount(x, length))]
        if row["dispatched_path"] != "global":
            paths.append(("global", lambda: histogram._launch(x, length, None, False)))
        for path, fn in paths:
            # A profiler session now and then records no device rows, or loses some of them
            # (fewer device operations than calls: every call launches once, as the launch
            # counter, not the profiler, proves); such a session is taken again.
            for attempt in range(1, PROFILE_ATTEMPTS + 1):
                before = histogram.KERNEL_LAUNCHES
                prof = device_profile([fn] * 52)
                assert histogram.KERNEL_LAUNCHES - before == 52, f"bincount sweep {name} ({path}): not one launch per call"
                seen = sum(k for _, k in prof.values())
                if seen >= 50:
                    break
                log(f"bincount sweep {name} ({path}): the profiler saw {seen} device operations of 50 calls "
                    f"(attempt {attempt})")
                prof = {}
            # None: no session recorded every call's device operation, so it was not measured
            device_ms = sum(ms for ms, _ in prof.values()) / 50 if prof else None
            ops = sum(k for _, k in prof.values()) / 50 if prof else None
            if prof and path == "dispatched":
                assert ops == 1.0, f"bincount sweep {name}: {ops} device operations per call, not 1: {prof}"
            row[path] = {
                "device_ms": device_ms,
                "device_ops_per_call": ops,
                "share_of_bound": bound_ms / device_ms if device_ms else None,
                "wrapper_ms": cuda_time_ms(fn),
                "host_us_per_call": host_us_per_call(fn),
                "device_rows": {k[:60]: v for k, v in prof.items()},
            }
        row["plain_ms"] = cuda_time_ms(lambda: histogram._bincount_plain(x, length))
        # every swept id is in range, so torch.bincount computes the same function on them
        row["library_ms"] = cuda_time_ms(lambda: torch.bincount(x, minlength=length))
        rows.append(row)
        summary = {p: {k: row[p][k] for k in ("device_ms", "device_ops_per_call", "wrapper_ms", "host_us_per_call")}
                   for p in ("dispatched", "global") if p in row}
        log(f"bincount sweep {name} N={x.numel()} L={length}: {json.dumps(summary)}, plain {row['plain_ms']:.5f} ms, "
            f"torch.bincount {row['library_ms']:.5f} ms, bound {bound_ms:.6f} ms  [{card}]")
    return rows


def kernel_entry(sweep: list, max_abs_err: float) -> dict:
    """The kernels line's entry: the dispatched path at the main-path shape."""
    main = next(r for r in sweep if r["shape"] == "main")
    return {
        "name": "bincount",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/bincount.cu",
        "replaces": "metrics_tpu/ops/histogram.py:36",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_abs_err,
        "ms": main["dispatched"]["wrapper_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }


# ------------------------------------------------------------------ phases 3 and 4
def make_suite(mt, num_classes: int, device: str):
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=num_classes, average="macro", device=device),
            "f1": mt.F1Score(num_classes=num_classes, average="macro", device=device),
            "confmat": mt.ConfusionMatrix(num_classes=num_classes, device=device),
            "precision": mt.Precision(num_classes=num_classes, average="macro", device=device),
        }
    )


def make_batches(batch: int, num_classes: int, steps: int, seed: int, signal: float = 0.0, spatial=()):
    """Softmax preds (B, C, *spatial) and int64 targets (B, *spatial); ``signal`` is
    added to the target's logit, so that preds agree with targets more than by chance."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(steps):
        logits = torch.randn((batch, num_classes) + tuple(spatial), generator=g, device="cuda")
        target = torch.randint(0, num_classes, (batch,) + tuple(spatial), generator=g, device="cuda")
        if signal:
            logits.scatter_add_(1, target.unsqueeze(1), torch.full(target.unsqueeze(1).shape, signal, device="cuda"))
        out.append((torch.softmax(logits, dim=1), target))
        del logits
    return out


def run_suite(suite, batches, warmup: int) -> float:
    """Update over every batch; returns the seconds of the steps after ``warmup``."""
    for preds, target in batches[:warmup]:
        suite.update(preds, target)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for preds, target in batches[warmup:]:
        suite.update(preds, target)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def assert_suites_equal(gpu_suite, cpu_suite, label: str, rtol: float = 0.0) -> dict:
    """Every state bit-exact, every value within atol 1e-6 (and ``rtol``); returns the values."""
    gpu_members = dict(gpu_suite.items(keep_base=True, copy_state=False))
    for name, cpu_m in cpu_suite.items(keep_base=True, copy_state=False):
        for state, value in cpu_m.metric_state.items():
            got = getattr(gpu_members[name], state).cpu()
            assert got.dtype == value.dtype and torch.equal(got, value), f"{label}: state {name}.{state} differs"
    gpu_res, cpu_res = gpu_suite.compute(), cpu_suite.compute()
    for key, want in cpu_res.items():
        got = gpu_res[key].cpu()
        assert torch.isfinite(got.float()).all(), f"{label}: {key} is not finite"
        if want.is_floating_point():
            torch.testing.assert_close(got, want, atol=1e-6, rtol=rtol, msg=f"{label}: {key}")
        else:
            assert got.dtype == torch.int32 and torch.equal(got, want), f"{label}: {key} differs"
    return {k: v.cpu().tolist() for k, v in gpu_res.items()}


def device_us(event) -> float:
    """A profiler row's own device time in µs, under the name this torch gives it."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0.0)


def device_profile(steps, warmup: int = 2) -> dict:
    """Device-side time by kernel over ``steps`` (callables), from torch.profiler.

    The first ``warmup`` steps run in the profiler's warm-up cycle, which
    traces and discards them: device events launched just after tracing
    starts can be lost, whole sessions of short calls among them. Only
    device-side rows (kernels, memsets, copies: rows with device time and
    no CPU time of their own) are kept, so no time is counted twice.
    Returns key -> [device ms, count].
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in steps[:warmup]:
            step()
        torch.cuda.synchronize()
        prof.step()
        for step in steps[warmup:]:
            step()
        torch.cuda.synchronize()
        prof.step()

    rows = prof.key_averages()
    # "ProfilerStep*" is the schedule's own span, mirrored on the device timeline
    kept = {e.key: [device_us(e) / 1e3, e.count] for e in rows
            if device_us(e) > 0 and e.self_cpu_time_total == 0 and not e.key.startswith("ProfilerStep")}
    if not kept:
        seen = [(e.key[:50], e.self_cpu_time_total, device_us(e)) for e in rows][:15]
        log(f"profiler: no device-side rows; {len(rows)} rows, first ones (key, self cpu us, device us): {seen}")
    return kept


def profile_steps(update, batches, warmup: int = 2) -> dict:
    """Device time per steady step ``update(*batch)``, in all and by kernel."""
    active = len(batches) - warmup
    rows = device_profile([lambda b=b: update(*b) for b in batches], warmup)
    busy_ms = sum(ms for ms, _ in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "steps": active,
        # None: the profiler saw no device time, so device busy time was not measured
        "device_ms_per_step": busy_ms / active if busy_ms else None,
        "device_ops_per_step": sum(n for _, n in rows.values()) / active,
        "top_device_ms_per_step": {k[:80]: [ms / active, n / active] for k, (ms, n) in top},
    }


def member_breakdown(suite, batches) -> dict:
    """Milliseconds per update of each member alone (a clone, so the suite is untouched)."""
    out = {}
    for name, member in suite.items(keep_base=True, copy_state=False):
        clone = member.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for preds, target in batches:
            clone.update(preds, target)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / len(batches) * 1e3
    return out


def main_path(mt, checks, histogram, card: str, trials: int = 3) -> dict:
    """The headline suite, timed ``trials`` times in each validation mode, the modes alternating."""
    batch, num_classes, warmup, timed = 8192, 128, 5, 50
    batches = make_batches(batch, num_classes, warmup + timed, seed=0)
    reference = make_suite(mt, num_classes, "cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    result = {"batch": batch, "num_classes": num_classes, "timed_steps": timed, "trials": trials, "card": card}
    seconds = {"first": [], "full": []}
    for trial in range(trials):
        for mode in ("first", "full"):
            checks.set_validation_mode(mode)
            suite = make_suite(mt, num_classes, "cuda")
            histogram.KERNEL_LAUNCHES = 0
            seconds[mode].append(run_suite(suite, batches, warmup))
            launches = histogram.KERNEL_LAUNCHES
            assert launches == warmup + timed, f"{mode}: {launches} kernel launches for {warmup + timed} updates"
            if trial == 0:
                groups = sorted(sorted(g) for g in suite.compute_groups.values())
                assert groups == [["acc"], ["confmat"], ["f1", "precision"]], groups
                assert_suites_equal(suite, reference, f"main path ({mode})")
                result[mode] = {"kernel_launches": launches}
                if mode == "first":
                    first_suite = suite
    for mode, runs in seconds.items():
        per_step = sorted(s / timed * 1e3 for s in runs)
        median = per_step[len(per_step) // 2]
        result[mode].update(
            ms_per_step_runs=per_step,
            ms_per_step=median,
            steps_per_s=1e3 / median,
            samples_per_s=batch * 1e3 / median,
        )
        log(f"main path B={batch} C={num_classes} mode={mode}: {1e3 / median:.2f} steps/s, "
            f"{batch * 1e3 / median:.1f} samples/s (median of {trials}; ms/step {per_step}), "
            f"{result[mode]['kernel_launches']} launches  [{card}]")
    checks.set_validation_mode("first")
    prof = profile_steps(first_suite.update, batches[:12])
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / result["first"]["ms_per_step"]
    result["profile_first"] = prof
    result["member_ms_per_update_first"] = member_breakdown(first_suite, batches[warmup:warmup + 20])
    log(f"profile (mode=first): {json.dumps(prof)}")
    log(f"member ms per update (mode=first): {json.dumps(result['member_ms_per_update_first'])}")
    return result


def large_l_path(mt, histogram) -> dict:
    batch, num_classes, steps = 4096, 1000, 10
    batches = make_batches(batch, num_classes, steps, seed=1)
    suite = make_suite(mt, num_classes, "cuda")
    histogram.KERNEL_LAUNCHES = 0
    seconds = run_suite(suite, batches, 0)
    assert histogram.KERNEL_LAUNCHES == steps, f"large-L path: {histogram.KERNEL_LAUNCHES} launches for {steps}"
    reference = make_suite(mt, num_classes, "cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    assert_suites_equal(suite, reference, "large-L path")
    log(f"large-L path B={batch} C={num_classes}: {steps / seconds:.2f} steps/s")
    return {"batch": batch, "num_classes": num_classes, "steps": steps, "steps_per_s": steps / seconds}


def multilabel_path(mt, histogram) -> dict:
    """ConfusionMatrix(multilabel=True) at B=8192, C=128: N = 2**20 ids into L = 512 bins a step."""
    batch, num_classes, steps = 8192, 128, 10
    g = torch.Generator(device="cuda").manual_seed(3)
    batches = [
        (torch.rand(batch, num_classes, generator=g, device="cuda"),
         torch.randint(0, 2, (batch, num_classes), generator=g, device="cuda"))
        for _ in range(steps)
    ]
    metric = mt.ConfusionMatrix(num_classes=num_classes, multilabel=True, device="cuda")
    histogram.KERNEL_LAUNCHES = 0
    seconds = run_suite(metric, batches, 0)
    assert histogram.KERNEL_LAUNCHES == steps, f"multilabel path: {histogram.KERNEL_LAUNCHES} launches for {steps}"
    reference = mt.ConfusionMatrix(num_classes=num_classes, multilabel=True, device="cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    got, want = metric.confmat.cpu(), reference.confmat
    assert got.dtype == torch.int32 and torch.equal(got, want), "multilabel path: confmat differs from the CPU"
    assert int(got.sum()) == steps * batch * num_classes
    assert torch.equal(metric.compute().cpu(), reference.compute())
    log(f"multilabel path B={batch} C={num_classes}: {steps / seconds:.2f} steps/s, state equals the CPU")
    return {"batch": batch, "num_classes": num_classes, "steps": steps, "steps_per_s": steps / seconds}


# ------------------------------------------------------------------ phases 6 and 7
def agreement_suite(mt, device: str, num_classes: int = 1000):
    return mt.MetricCollection(
        {
            "kappa": mt.CohenKappa(num_classes, device=device),
            "mcc": mt.MatthewsCorrCoef(num_classes, device=device),
            "jaccard": mt.JaccardIndex(num_classes, device=device),
            "specificity": mt.Specificity(num_classes=num_classes, average="macro", device=device),
            "hamming": mt.HammingDistance(device=device),
        }
    )


def segmentation_suite(mt, device: str, num_classes: int = 19):
    return mt.MetricCollection(
        {
            "miou": mt.JaccardIndex(num_classes=num_classes, device=device),
            "dice": mt.Dice(num_classes=num_classes, average="macro", mdmc_average="global", device=device),
        }
    )


def confmat_path(label, make_suite_fn, checks, histogram, batches, cpu_steps, warmup, timed, confmat_group, card,
                 trials: int = 3) -> dict:
    """A collection whose confusion-matrix members share one compute group, on the card.

    Equality: the suite on the card and on the CPU over the first ``cpu_steps``
    batches. Then ``trials`` timed runs in each validation mode, the modes
    alternating: ``warmup`` + ``timed`` updates cycling over ``batches``. The
    launch count is set to 0 before each run and read after its first update
    (every member updates once, to find the groups: one launch per member of
    ``confmat_group``) and after the rest (one launch a step)."""
    checks.set_validation_mode("full")
    gpu, cpu = make_suite_fn("cuda"), make_suite_fn("cpu")
    for preds, target in batches[:cpu_steps]:
        gpu.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
    groups = sorted(sorted(g) for g in gpu.compute_groups.values())
    assert sorted(confmat_group) in groups, f"{label}: {confmat_group} do not share a compute group: {groups}"
    values = assert_suites_equal(gpu, cpu, label, rtol=1e-5)
    del gpu, cpu
    log(f"{label}: states equal the CPU over {cpu_steps} steps, values within rtol 1e-5; groups {groups}")

    steps = warmup + timed
    stream = [batches[i % len(batches)] for i in range(steps)]
    result = {"steps": steps, "timed_steps": timed, "trials": trials, "cpu_steps": cpu_steps, "groups": groups,
              "values": values, "card": card}
    seconds = {"first": [], "full": []}
    for trial in range(trials):
        for mode in ("first", "full"):
            checks.set_validation_mode(mode)
            suite = make_suite_fn("cuda")
            histogram.KERNEL_LAUNCHES = 0
            suite.update(*stream[0])
            first_launches = histogram.KERNEL_LAUNCHES
            histogram.KERNEL_LAUNCHES = 0
            seconds[mode].append(run_suite(suite, stream[1:], warmup - 1))
            rest_launches = histogram.KERNEL_LAUNCHES
            assert first_launches == len(confmat_group), f"{label} ({mode}): {first_launches} launches on the first update"
            assert rest_launches == steps - 1, f"{label} ({mode}): {rest_launches} launches in {steps - 1} steps"
            if trial == 0:
                result[mode] = {"kernel_launches": first_launches + rest_launches,
                                "first_update_launches": first_launches,
                                "launches_per_step_after_first": rest_launches / (steps - 1)}
                if mode == "first":
                    first_suite = suite
            del suite
    for mode, runs in seconds.items():
        per_step = sorted(t / timed * 1e3 for t in runs)
        median = per_step[len(per_step) // 2]
        result[mode].update(ms_per_step_runs=per_step, ms_per_step=median, steps_per_s=1e3 / median)
    checks.set_validation_mode("first")
    prof = profile_steps(first_suite.update, stream[:8])
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / result["first"]["ms_per_step"]
    result["profile_first"] = prof
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first_suite.update(*stream[0])
    torch.cuda.synchronize()
    result["peak_device_bytes_one_step"] = torch.cuda.max_memory_allocated()
    log(f"profile {label} (mode=first): {json.dumps(prof)}")
    return result


def layer_profile(histogram, preds, target, num_classes: int, calls: int = 10) -> dict:
    """Device ms per call of each layer a member's update runs, on one batch of a path
    (torch.profiler, ``calls`` calls after 2 untimed): input canonicalisation (each
    group leader runs it once a step), the confusion matrix's pair ids, the bincount
    kernel, and the macro stat scores with the (N, C, X) -> (N*X, C) layout copy."""
    from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores
    from metrics_tpu_torch.utils.checks import _input_format_classification

    p, t, _ = _input_format_classification(preds, target)
    ids = t.argmax(dim=1).reshape(-1) * num_classes + p.argmax(dim=1).reshape(-1)
    stages = {
        "canonicalise": lambda: _input_format_classification(preds, target),
        "pair_ids": lambda: t.argmax(dim=1).reshape(-1) * num_classes + p.argmax(dim=1).reshape(-1),
        "bincount": lambda: histogram.fused_bincount(ids, num_classes**2),
        "stat_scores": lambda: _stat_scores(p.movedim(1, -1).reshape(-1, num_classes),
                                            t.movedim(1, -1).reshape(-1, num_classes), reduce="macro"),
    }
    out = {}
    for name, fn in stages.items():
        rows = device_profile([fn] * (calls + 2))
        # None: the profiler saw no device time, so it was not measured
        out[name] = {"device_ms": sum(ms for ms, _ in rows.values()) / calls if rows else None,
                     "device_ops": sum(n for _, n in rows.values()) / calls if rows else None}
    return out


def agreement_path(mt, checks, histogram, card) -> dict:
    """ImageNet-1k width: C=1000, B=4096 softmax rows a step; the confusion matrix has 10**6 bins."""
    batch, num_classes = 4096, 1000
    batches = make_batches(batch, num_classes, 8, seed=5, signal=4.0)
    result = confmat_path("agreement path", lambda dev: agreement_suite(mt, dev, num_classes), checks, histogram,
                          batches, cpu_steps=8, warmup=4, timed=20, confmat_group=["jaccard", "kappa", "mcc"],
                          card=card)
    result.update(batch=batch, num_classes=num_classes,
                  device_ms_per_call_by_layer=layer_profile(histogram, *batches[0], num_classes))
    log(f"agreement path, device ms per call by layer: {json.dumps(result['device_ms_per_call_by_layer'])}  [{card}]")
    for mode in ("first", "full"):
        r = result[mode]
        r["samples_per_s"] = batch * r["steps_per_s"]
        log(f"agreement path B={batch} C={num_classes} mode={mode}: {r['steps_per_s']:.2f} steps/s, "
            f"{r['samples_per_s']:.1f} samples/s (ms/step {r['ms_per_step_runs']}), launches {r['kernel_launches']} "
            f"(first update {r['first_update_launches']}, then {r['launches_per_step_after_first']} a step)  [{card}]")
    return result


def segmentation_path(mt, checks, histogram, card) -> dict:
    """Cityscapes width: C=19, B=2 images of 1024 x 2048; 4,194,304 pixel ids into 361 bins a step."""
    batch, num_classes, spatial = 2, 19, (1024, 2048)
    batches = make_batches(batch, num_classes, 3, seed=6, signal=3.0, spatial=spatial)
    result = confmat_path("segmentation path", lambda dev: segmentation_suite(mt, dev, num_classes), checks,
                          histogram, batches, cpu_steps=3, warmup=2, timed=10, confmat_group=["miou"], card=card)
    pixels = batch * spatial[0] * spatial[1]
    result.update(batch=batch, num_classes=num_classes, spatial=list(spatial), pixels_per_step=pixels,
                  device_ms_per_call_by_layer=layer_profile(histogram, *batches[0], num_classes))
    log(f"segmentation path, device ms per call by layer: {json.dumps(result['device_ms_per_call_by_layer'])}  [{card}]")
    for mode in ("first", "full"):
        r = result[mode]
        r["pixels_per_s"] = pixels * r["steps_per_s"]
        log(f"segmentation path B={batch} {spatial[0]}x{spatial[1]} C={num_classes} mode={mode}: "
            f"{r['steps_per_s']:.2f} steps/s, {r['pixels_per_s']:.4g} pixels/s (ms/step {r['ms_per_step_runs']}), "
            f"launches {r['kernel_launches']}  [{card}]")
    return result


# ------------------------------------------------------------------ phase 8
AGGREGATORS = ("MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "CatMetric")


def _update_outcome(metric, args) -> str:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            metric.update(*args)
        except RuntimeError as err:
            return f"RuntimeError: {err}"
    return "ok"


def aggregation_path(mt, checks, card) -> dict:
    """Per-step loss tensors (B=4096) with NaNs in some steps' values and others' weights:
    every aggregator under every nan_strategy and validation mode, on the card and on the CPU."""
    batch, steps = 4096, 12
    g = torch.Generator(device="cuda").manual_seed(7)
    stream = []
    for step in range(steps):
        loss = torch.rand(batch, generator=g, device="cuda") * 3
        weight = torch.rand(batch, generator=g, device="cuda")
        if step % 3 == 1:
            loss[::97] = float("nan")
        if step % 4 == 2:
            weight[::89] = float("nan")
        stream.append((loss, weight))
    checked = 0
    for mode in ("full", "first", "off"):
        checks.set_validation_mode(mode)
        for strategy in ("error", "warn", "ignore", 0.5):
            for name in AGGREGATORS:
                gpu = getattr(mt, name)(nan_strategy=strategy, device="cuda")
                cpu = getattr(mt, name)(nan_strategy=strategy, device="cpu")
                for loss, weight in stream:
                    args = (loss, weight) if name == "MeanMetric" else (loss,)
                    outcome = _update_outcome(gpu, args)
                    assert outcome == _update_outcome(cpu, [a.cpu() for a in args]), f"{name}/{strategy}/{mode}: {outcome}"
                for state, want in cpu.metric_state.items():
                    got = getattr(gpu, state)
                    got = torch.cat([v.cpu() for v in got]) if isinstance(got, list) else got.cpu()
                    want = torch.cat(want) if isinstance(want, list) else want
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True,
                                               msg=f"aggregation {name}/{strategy}/{mode}: state {state}")
                torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-6, equal_nan=True,
                                           msg=f"aggregation {name}/{strategy}/{mode}: compute")
                checked += 1
    log(f"aggregation path: {checked} aggregator x nan_strategy x mode runs of {steps} steps equal the CPU")

    checks.set_validation_mode("first")
    suite = mt.MetricCollection({name: getattr(mt, name)(device="cuda") for name in AGGREGATORS}, compute_groups=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for loss, weight in stream[:2]:
            suite.update(loss, weight=weight)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for loss, weight in stream[2:]:
            suite.update(loss, weight=weight)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        values = {k: (v.numel() if k == "CatMetric" else float(v)) for k, v in suite.compute().items()}
        prof = profile_steps(lambda loss, weight: suite.update(loss, weight=weight), stream[:8])
    ms = seconds / (steps - 2) * 1e3
    assert all(v == v for k, v in values.items()), f"aggregation suite: NaN in {values}"
    result = {"batch": batch, "steps": steps, "runs_checked": checked, "ms_per_step": ms, "steps_per_s": 1e3 / ms,
              "values": values, "profile_first": prof, "card": card}
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / ms
    log(f"aggregation path (mode=first, default nan_strategy 'warn'): {1e3 / ms:.2f} steps/s; "
        f"profile {json.dumps(prof)}  [{card}]")
    return result


# ------------------------------------------------------------------ phase 9
CURVE_AREA_ATOL = {"binary": 1e-6, "multiclass": 1e-5}  # eager areas, card against CPU (the JAX tests' tolerances)
SORTED_AREA_ATOL = {"binary": 1e-4, "multiclass": 1e-5}  # sort-based areas against the eager curves on the card
CONF_SUM_RTOL = 1e-5  # CalibrationError's float32 confidence sums: another order of addition on each side
CPU_TWIN_BINNED_S = 20.0  # the CPU twin of the binned updates runs all batches only if it takes about this long
HOST_READ_OPS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero")
CURVES_DEVICE = "cuda"  # where the curve paths run
CURVES_BINARY_SHAPE = (64, 262_144)  # updates, scores an update: 2**24 scores
CURVES_IMAGENET_SHAPE = (50, 1000, 1000)  # updates, rows an update, classes: the ImageNet-1k validation set


def curves_binary_suite(mt, device: str):
    """A CTR or fraud model's evaluation metrics: exact AUROC, AP, ROC and PR curve over every score."""
    return mt.MetricCollection(
        {
            "auroc": mt.AUROC(pos_label=1, device=device),
            "ap": mt.AveragePrecision(pos_label=1, device=device),
            "roc": mt.ROC(pos_label=1, device=device),
            "pr_curve": mt.PrecisionRecallCurve(pos_label=1, device=device),
        }
    )


def curves_imagenet_suite(mt, device: str, num_classes: int, binned: bool = True):
    """The ImageNet-1k validation pass's ranking and calibration metrics."""
    members = {
        "auroc": mt.AUROC(num_classes=num_classes, average="macro", device=device),
        "ap": mt.AveragePrecision(num_classes=num_classes, average="macro", device=device),
        "ece": mt.CalibrationError(n_bins=15, norm="l1", device=device),
    }
    if binned:
        members["binned_ap"] = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device=device)
    return mt.MetricCollection(members)


def curves_binary_batches(seed: int = 20) -> list:
    """Bernoulli(0.03) labels (int64) and float32 scores with signal, rounded to multiples
    of 2**-12, so that long tie runs form: ``steps * batch`` = 2**24 scores."""
    steps, batch = CURVES_BINARY_SHAPE
    g = torch.Generator(device=CURVES_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        target = (torch.rand(batch, generator=g, device=CURVES_DEVICE) < 0.03).to(torch.int64)
        logits = torch.randn(batch, generator=g, device=CURVES_DEVICE) + 2.0 * target - 1.5
        out.append((torch.round(torch.sigmoid(logits) * 4096) / 4096, target))
    return out


def curves_imagenet_batches(seed: int = 21) -> list:
    """Softmax rows (B, C) and int64 labels: the row's arg-max 75% of the time, else uniform."""
    steps, batch, num_classes = CURVES_IMAGENET_SHAPE
    g = torch.Generator(device=CURVES_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        probs = torch.softmax(torch.randn(batch, num_classes, generator=g, device=CURVES_DEVICE) * 2.0, dim=1)
        uniform = torch.randint(0, num_classes, (batch,), generator=g, device=CURVES_DEVICE)
        keep = torch.rand(batch, generator=g, device=CURVES_DEVICE) < 0.75
        out.append((probs, torch.where(keep, probs.argmax(dim=1), uniform)))
    return out


def compute_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler, after one call in the warm-up cycle: device ms and
    operations, and the host ops that read the device (``HOST_READ_OPS``) with their counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()

    rows = [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")]
    device = [e for e in rows if device_us(e) > 0 and e.self_cpu_time_total == 0]
    counts = {e.key: e.count for e in rows}
    return {
        # None: the profiler saw no device time, so it was not measured
        "device_ms": sum(device_us(e) for e in device) / 1e3 if device else None,
        "device_ops": sum(e.count for e in device),
        "host_reads": {k: counts.get(k, 0) for k in HOST_READ_OPS},
        "top_device_ms": {e.key[:60]: [device_us(e) / 1e3, e.count]
                          for e in sorted(device, key=lambda e: -device_us(e))[:8]},
    }


def timed_ms(fn, repeats: int = 1) -> float:
    """Host milliseconds of ``fn`` (the best of ``repeats``), each run ending in a synchronise."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def fresh_compute(suite):
    """``suite.compute()`` with every member's cached value dropped, so that it computes again."""
    for _, m in suite.items(keep_base=True, copy_state=False):
        m._computed = None
    return suite.compute()


def assert_curve_close(got, want, label: str, atol, rtol: float = 0.0) -> float:
    """A result on the card against the CPU's, recursing into lists and tuples: bit for bit when
    ``atol`` and ``rtol`` are 0 or None, else within them. Returns the largest |difference| of the
    finite values."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), f"{label}: {type(got)} of {len(got)}"
        return max([assert_curve_close(g, w, label, atol, rtol) for g, w in zip(got, want)], default=0.0)
    g = got.cpu()
    assert g.dtype == want.dtype and g.shape == want.shape, f"{label}: {g.dtype} {tuple(g.shape)}"
    torch.testing.assert_close(g, want, atol=atol or 0.0, rtol=rtol, equal_nan=True, msg=lambda m: f"{label}: {m}")
    finite = torch.isfinite(want)
    return float((g[finite].double() - want[finite].double()).abs().max()) if finite.any() else 0.0


def assert_state_close(got, want, label: str, rtol: float = 0.0, atol: float = 0.0) -> None:
    """A state (a tensor or a list of rows) on the card against the CPU's: bit for bit, or for
    floats within ``rtol``/``atol`` where they are given."""
    got, want = (got, want) if isinstance(want, list) else ([got], [want])
    assert len(got) == len(want), f"{label}: {len(got)} rows, not {len(want)}"
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {g.dtype} {tuple(g.shape)}"
        if w.is_floating_point() and (rtol or atol):
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True, msg=lambda m: f"{label}: {m}")
        else:
            assert torch.equal(g, w), f"{label}: differs from the CPU"


def assert_member_states_equal(gpu_members: dict, cpu_members: dict, label: str) -> None:
    """Every state of every CPU member's twin on the card bit for bit; a float sum state
    (CalibrationError's ``conf_bin``) within ``CONF_SUM_RTOL``."""
    for name, cpu_m in cpu_members.items():
        for state, want in cpu_m.metric_state.items():
            assert_state_close(getattr(gpu_members[name], state), want, f"{label}: {name}.{state}",
                               rtol=CONF_SUM_RTOL if state == "conf_bin" else 0.0)


def time_runs(make, update, batches, checks, histogram, trials: int = 3) -> tuple:
    """``trials`` runs of ``update(obj, batch)`` over every batch on a new ``make()``, mode "first":
    (ms per step of each run, sorted; bincount launches of the first run; the first run's object)."""
    checks.set_validation_mode("first")
    runs, launches, first = [], None, None
    for trial in range(trials):
        obj = make()
        histogram.KERNEL_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            update(obj, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / len(batches) * 1e3)
        if trial == 0:
            launches, first = histogram.KERNEL_LAUNCHES, obj
    return sorted(runs), launches, first


def update_batch(metric, batch) -> None:
    metric.update(*batch)


def peak_extra_bytes(fn) -> int:
    """Device memory ``fn`` allocates above what was allocated before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def op_profile(fn, bytes_moved: int, ops: int) -> dict:
    """Device ms per call of ``fn`` (5 calls after 2 in the warm-up cycle) beside its bound: the
    larger of its bytes at the memory rate and its operations at the float32 rate."""
    rows = device_profile([fn] * 7)
    device_ms = sum(ms for ms, _ in rows.values()) / 5 if rows else None
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    return {"device_ms": device_ms, "bytes": bytes_moved, "ops": ops, "bound_ms": bound_ms,
            "bound_by": "operations" if ops / FP32_OPS_PER_S > bytes_moved / HBM_BYTES_PER_S else "bytes",
            "share_of_bound": bound_ms / device_ms if device_ms else None,
            "device_rows": {k[:60]: v for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]}}


def sort_profile(preds) -> dict:
    """The eager curve's descending stable argsort of ``preds``, beside its bound from bytes (the
    float32 keys read once, the int64 indices written once)."""
    return {"n": preds.numel(),
            **op_profile(lambda: torch.argsort(-preds, stable=True), bytes_moved=12 * preds.numel(), ops=0)}


def binned_profile(preds, target, thresholds) -> dict:
    """One binned update's compare and contraction beside its bound, and its peak extra memory."""
    from metrics_tpu_torch.ops.binned import binned_curve_counts, threshold_chunk

    n, c = preds.shape
    t = thresholds.numel()
    t01 = (target == 1).to(torch.float32)
    run = lambda: binned_curve_counts(preds, t01, thresholds)  # noqa: E731
    # scores and 0/1 targets read, three (C, T) counts written; a compare, a multiply and an add for
    # TP, an add for the >= total
    out = {"n": n, "c": c, "t": t, "threshold_chunk": threshold_chunk(n, c, t),
           **op_profile(run, bytes_moved=4 * (2 * n * c + t + 3 * c * t), ops=4 * n * c * t)}
    out["peak_extra_bytes"] = peak_extra_bytes(run)
    return out


def curves_binary_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9a: AUROC, AP, ROC and the PR curve over 2**24 binary scores in 64 updates, one compute."""
    batches = curves_binary_batches()
    n = sum(p.numel() for p, _ in batches)
    runs, launches, suite = time_runs(lambda: curves_binary_suite(mt, CURVES_DEVICE), update_batch, batches, checks,
                                      histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert groups == [["ap", "auroc", "pr_curve", "roc"]], f"curves_binary: groups {groups}"
    assert launches == 0, f"curves_binary: {launches} bincount launches in its updates"
    # on a suite of its own: the profiled updates must not reach the suite held against the CPU
    update_prof = profile_steps(curves_binary_suite(mt, CURVES_DEVICE).update, batches[:10])
    result = {"n": n, "batch": batches[0][0].numel(), "steps": len(batches), "groups": groups, "card": card,
              "update_ms_per_step_runs": runs, "update_ms_per_step": runs[len(runs) // 2],
              "update_profile": update_prof, "kernel_launches": launches}
    if update_prof["device_ms_per_step"] is not None:
        update_prof["device_idle_share"] = 1.0 - update_prof["device_ms_per_step"] / result["update_ms_per_step"]
    leader = dict(suite.items(keep_base=True, copy_state=False))["ap"]
    result["state_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: fresh_compute(suite))  # the allocator warm from the first
    prof = compute_profile(lambda: fresh_compute(suite))
    result["compute_profile"] = prof
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_ms"]

    cpu = curves_binary_suite(mt, "cpu")
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    assert_member_states_equal(dict(suite.items(keep_base=True, copy_state=False)),
                               dict(cpu.items(keep_base=True, copy_state=False)), "curves_binary")
    t0 = time.perf_counter()
    want = cpu.compute()
    result["cpu_compute_ms"] = (time.perf_counter() - t0) * 1e3
    err = {}
    for key in ("roc", "pr_curve"):
        err[key] = assert_curve_close(values[key], want[key], f"curves_binary {key}", None)
    for key in ("auroc", "ap"):
        err[key] = assert_curve_close(values[key], want[key], f"curves_binary {key}", CURVE_AREA_ATOL["binary"])
    result.update(values={k: float(values[k]) for k in ("auroc", "ap")}, curve_points=values["roc"][0].numel(),
                  max_abs_err_vs_cpu=err)
    all_preds = torch.cat([p for p, _ in batches])
    result["sort"] = sort_profile(all_preds)
    log(f"curves_binary N={n} ({len(batches)} x {result['batch']}): update {result['update_ms_per_step']:.4f} ms/step "
        f"(runs {runs}), compute {result['compute_ms']:.2f} ms (again {result['compute_again_ms']:.2f} ms; CPU "
        f"{result['cpu_compute_ms']:.1f} ms), "
        f"values {result['values']}, {result['curve_points']} ROC points, curves bit for bit and areas within "
        f"{CURVE_AREA_ATOL['binary']} of the CPU (max |err| {err})  [{card}]")
    log(f"curves_binary profiles: update {json.dumps(update_prof)}; compute {json.dumps(prof)}; "
        f"sort {json.dumps(result['sort'])}  [{card}]")
    return result, batches, values


def curves_imagenet_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9b: AUROC, AP (macro, C=1000), CalibrationError and BinnedAveragePrecision (T=100)
    over the 50,000 ImageNet-1k validation rows in 50 updates, one compute, then the weighted
    functional AUROC and AP on the same arrays."""
    num_classes = CURVES_IMAGENET_SHAPE[2]
    batches = curves_imagenet_batches()
    n = sum(p.shape[0] for p, _ in batches)
    runs, launches, suite = time_runs(lambda: curves_imagenet_suite(mt, CURVES_DEVICE, num_classes), update_batch,
                                      batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert groups == [["ap", "auroc"], ["binned_ap"], ["ece"]], f"curves_imagenet: groups {groups}"
    assert launches == len(batches), f"curves_imagenet: {launches} bincount launches in {len(batches)} updates"
    update_prof = profile_steps(curves_imagenet_suite(mt, CURVES_DEVICE, num_classes).update, batches[:8])
    result = {"n": n, "batch": batches[0][0].shape[0], "num_classes": num_classes, "steps": len(batches),
              "groups": groups, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": runs[len(runs) // 2], "update_profile": update_prof, "kernel_launches": launches}
    if update_prof["device_ms_per_step"] is not None:
        update_prof["device_idle_share"] = 1.0 - update_prof["device_ms_per_step"] / result["update_ms_per_step"]
    leader = dict(suite.items(keep_base=True, copy_state=False))["ap"]
    result["state_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: fresh_compute(suite))  # the allocator warm from the first
    prof = compute_profile(lambda: fresh_compute(suite))
    result["compute_profile"] = prof
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_ms"]

    # the CPU twin: every batch through the exact and calibration members, the binned member's
    # batches only as far as CPU_TWIN_BINNED_S allows
    cpu = curves_imagenet_suite(mt, "cpu", num_classes, binned=False)
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    cpu_binned = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device="cpu")
    t0 = time.perf_counter()
    cpu_binned.update(batches[0][0].cpu(), batches[0][1].cpu())
    per_update_s = time.perf_counter() - t0
    binned_steps = len(batches) if per_update_s * len(batches) <= CPU_TWIN_BINNED_S else 5
    for preds, target in batches[1:binned_steps]:
        cpu_binned.update(preds.cpu(), target.cpu())
    gpu_binned = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device=CURVES_DEVICE)
    for preds, target in batches[:binned_steps]:
        gpu_binned.update(preds, target)
    gpu_members = dict(suite.items(keep_base=True, copy_state=False))
    if binned_steps == len(batches):
        for state in ("TPs", "FPs", "FNs"):  # the suite's member ran the same updates on the card
            assert torch.equal(getattr(gpu_members["binned_ap"], state), getattr(gpu_binned, state))
    for state in ("TPs", "FPs", "FNs"):
        assert torch.equal(getattr(gpu_binned, state).cpu(), getattr(cpu_binned, state)), f"binned {state} differs"
    assert_member_states_equal(gpu_members, dict(cpu.items(keep_base=True, copy_state=False)), "curves_imagenet")
    t0 = time.perf_counter()
    want = cpu.compute()
    result["cpu_compute_ms"] = (time.perf_counter() - t0) * 1e3
    err = {k: assert_curve_close(values[k], want[k], f"curves_imagenet {k}", CURVE_AREA_ATOL["multiclass"])
           for k in ("auroc", "ap")}
    err["ece"] = assert_curve_close(values["ece"], want["ece"], "curves_imagenet ece", CURVE_AREA_ATOL["binary"])
    err["binned_ap"] = assert_curve_close(gpu_binned.compute(), cpu_binned.compute(), "curves_imagenet binned_ap",
                                          CURVE_AREA_ATOL["binary"])
    assert len(values["binned_ap"]) == num_classes and all(torch.isfinite(v) for v in values["binned_ap"][:10])
    result.update(values={k: float(values[k]) for k in ("auroc", "ap", "ece")},
                  binned_ap_mean=float(torch.stack(values["binned_ap"]).mean()), max_abs_err_vs_cpu=err,
                  cpu_twin_binned_steps=binned_steps, cpu_binned_s_per_update=per_update_s)

    # the weighted functional areas on the same arrays: the class support is one bincount each
    all_preds = torch.cat([p for p, _ in batches])
    all_target = torch.cat([t for _, t in batches])
    histogram.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_auroc = mt.functional.auroc(all_preds, all_target, num_classes=num_classes, average="weighted")
    w_ap = mt.functional.average_precision(all_preds, all_target, num_classes=num_classes, average="weighted")
    torch.cuda.synchronize()
    result["weighted_ms"] = (time.perf_counter() - t0) * 1e3
    result["weighted_launches"] = histogram.KERNEL_LAUNCHES
    assert result["weighted_launches"] == 2, f"weighted areas: {result['weighted_launches']} bincount launches"
    cpu_preds, cpu_target = all_preds.cpu(), all_target.cpu()
    err["weighted_auroc"] = assert_curve_close(
        w_auroc, mt.functional.auroc(cpu_preds, cpu_target, num_classes=num_classes, average="weighted"),
        "weighted auroc", CURVE_AREA_ATOL["multiclass"])
    err["weighted_ap"] = assert_curve_close(
        w_ap, mt.functional.average_precision(cpu_preds, cpu_target, num_classes=num_classes, average="weighted"),
        "weighted ap", CURVE_AREA_ATOL["multiclass"])
    result["weighted_values"] = {"auroc": float(w_auroc), "ap": float(w_ap)}

    thresholds = torch.from_numpy(gpu_binned.thresholds).to(CURVES_DEVICE)
    onehot = torch.nn.functional.one_hot(batches[0][1], num_classes)
    result["binned"] = binned_profile(batches[0][0], onehot, thresholds)
    log(f"curves_imagenet N={n} C={num_classes}: update {result['update_ms_per_step']:.4f} ms/step (runs {runs}), "
        f"{launches} bincount launches; compute {result['compute_ms']:.1f} ms (again {result['compute_again_ms']:.1f} "
        f"ms; CPU {result['cpu_compute_ms']:.1f} ms); "
        f"values {result['values']}, binned AP mean {result['binned_ap_mean']:.6f}; weighted AUROC and AP "
        f"{result['weighted_values']} in {result['weighted_ms']:.1f} ms, 2 launches; CPU twin of the binned updates "
        f"over {binned_steps} of {len(batches)} batches ({per_update_s:.2f} s an update on the CPU); max |err| vs "
        f"CPU {err}  [{card}]")
    log(f"curves_imagenet profiles: update {json.dumps(update_prof)}; compute {json.dumps(prof)}; "
        f"binned update {json.dumps(result['binned'])}  [{card}]")
    return result, (all_preds, all_target), values


def sorted_curves_path(binary, imagenet, binary_values, imagenet_values, card: str) -> dict:
    """Phase 9c: the sort-based exact areas on both paths' arrays, each against the eager curve's
    value on the card, each timed against the eager path's functional call."""
    import metrics_tpu_torch.functional as F
    from metrics_tpu_torch.ops import sorted_curves

    (bp, bt), (mp, mt_) = binary, imagenet
    num_classes = mp.shape[1]
    cases = {
        "binary_auroc_sorted": (lambda: sorted_curves.binary_auroc_sorted(bp, bt),
                                lambda: F.auroc(bp, bt, pos_label=1), binary_values["auroc"], "binary"),
        "binary_average_precision_sorted": (lambda: sorted_curves.binary_average_precision_sorted(bp, bt),
                                            lambda: F.average_precision(bp, bt, pos_label=1), binary_values["ap"],
                                            "binary"),
        "multiclass_auroc_sorted": (lambda: sorted_curves.multiclass_auroc_sorted(mp, mt_, num_classes, "macro"),
                                    lambda: F.auroc(mp, mt_, num_classes=num_classes), imagenet_values["auroc"],
                                    "multiclass"),
        "multiclass_average_precision_sorted": (
            lambda: sorted_curves.multiclass_average_precision_sorted(mp, mt_, num_classes, "macro"),
            lambda: F.average_precision(mp, mt_, num_classes=num_classes), imagenet_values["ap"], "multiclass"),
    }
    out = {"card": card}
    for name, (fn, eager_fn, eager_value, kind) in cases.items():
        got = fn()
        err = abs(float(got) - float(eager_value))
        assert err <= SORTED_AREA_ATOL[kind], f"{name}: {float(got)} against the eager {float(eager_value)}"
        ms = timed_ms(fn, repeats=3)
        eager_ms = timed_ms(eager_fn, repeats=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[name] = {"value": float(got), "eager_value": float(eager_value), "abs_err": err,
                     "atol": SORTED_AREA_ATOL[kind], "ms": ms, "eager_ms": eager_ms,
                     "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
        log(f"sorted_curves {name}: {float(got):.8f} (eager {float(eager_value):.8f}, |err| {err:.3g} <= "
            f"{SORTED_AREA_ATOL[kind]}), {ms:.3f} ms against the eager path's {eager_ms:.1f} ms  [{card}]")
    return out


def curves_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9: the two curve paths and the sort-based areas on their arrays."""
    binary, binary_batches, binary_values = curves_binary_path(mt, checks, histogram, card)
    imagenet, imagenet_arrays, imagenet_values = curves_imagenet_path(mt, checks, histogram, card)
    binary_arrays = (torch.cat([p for p, _ in binary_batches]), torch.cat([t for _, t in binary_batches]))
    del binary_batches
    sorted_result = sorted_curves_path(binary_arrays, imagenet_arrays, binary_values, imagenet_values, card)
    return {"curves_binary": binary, "curves_imagenet": imagenet, "sorted_curves": sorted_result,
            "kernel_launches": binary["kernel_launches"] + imagenet["kernel_launches"] + imagenet["weighted_launches"]}


# ------------------------------------------------------------------ phases 11 to 14
EVAL_DEVICE = "cuda"  # where phases 11 to 14 run
CPU_TWIN_S = 15.0  # a CPU twin runs every batch where that takes about this long, else the first ones that fit
RANKING_SHAPE = (50, 1000, 1000)  # updates, rows an update, labels: the ImageNet-1k validation set
RANKING_RTOL = 1e-5  # float sums of per-row values (LRAP, ranking loss, hinge, KL) in another order on each side
REGRESSION_SHAPE = (64, 262_144)  # updates, rows an update: 2**24 rows
MULTIOUTPUT_SHAPE = (16, 65_536, 16)  # updates, rows an update, outputs
# float32 sums of 2**24 terms, in another order on each side, through moment formulas that subtract
# such sums (E[x²] - E[x]²), which multiplies their relative error
REGRESSION_RTOL = 1e-4
# Spearman: both sides rank alike (the same integer positions, made float32 the same way), but the
# means and products of 2**24 ranks near 8.4e6 (a float32 ulp of 1 there) are summed in another order
SPEARMAN_ATOL = 1e-4
PAIRWISE_SHAPE = (4096, 8192, 768)  # rows of x, rows of y, width: sentence embeddings of BERT-base width
PAIRWISE_CPU_ROWS = 256  # rows of x the CPU twin computes, all columns
# float32 sums of 768 products in another order on each side (|values| up to about 1e3 for Manhattan,
# 40 for Euclidean); Euclidean's expansion cancels only where rows coincide, whose zeroed diagonal is exact
PAIRWISE_ATOL, PAIRWISE_RTOL = 1e-3, 1e-5
RETRIEVAL_SHAPE = (6980, 100, 1000)  # queries, queries an update, candidates a query: MS MARCO dev-small re-ranking
RETRIEVAL_ATOL = 1e-6  # means over queries of exact per-query values, in another order on each side
RETRIEVAL_CPU_TWIN_S = 30.0  # the retrieval CPU twin computes all 70 updates only if that takes about this long


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def cpu_twin_steps(update_cpu_once_s: float, steps: int) -> int:
    """Every step if the CPU twin takes about ``CPU_TWIN_S`` for them, else the first ones that fit (at least 2)."""
    return steps if update_cpu_once_s * steps <= CPU_TWIN_S else max(2, int(CPU_TWIN_S / update_cpu_once_s))


def compute_all(members: dict) -> dict:
    """Every member's ``compute()``, its cached value dropped first."""
    out = {}
    for name, m in members.items():
        m._computed = None
        out[name] = m.compute()
    return out


def timed_compute(members: dict, result: dict) -> dict:
    """The first ``compute()`` of every member timed, then again, then profiled; the values of the first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = compute_all(members)
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: compute_all(members))
    prof = compute_profile(lambda: compute_all(members))
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_again_ms"]
    result["compute_profile"] = prof
    return values


def update_profile(make, update, batches, ms_per_step: float) -> dict:
    """Device time per update step on a new ``make()`` (the first 2 steps in the profiler's warm-up)."""
    obj = make()
    prof = profile_steps(lambda *b: update(obj, b), batches)
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / ms_per_step
    return prof


# ---- phase 11: ranking_imagenet
def ranking_batches(seed: int = 30) -> list:
    """ImageNet-1k validation rows as softmax scores (B, C) with multi-label targets of 1 to 3
    positives a row (the ImageNet-ReaL relabelling gives some images several), the first positive
    (the row's arg-max 75% of the time) as the class, and a second seeded model's softmax as ``q``.
    Update 7's scores are rounded to multiples of 2**-12, so that tie runs form."""
    steps, batch, labels = RANKING_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    rows = torch.arange(batch, device=EVAL_DEVICE)
    out = []
    for step in range(steps):
        logits = torch.randn(batch, labels, generator=g, device=EVAL_DEVICE) * 2.0
        uniform = torch.randint(0, labels, (batch,), generator=g, device=EVAL_DEVICE)
        keep = torch.rand(batch, generator=g, device=EVAL_DEVICE) < 0.75
        cls = torch.where(keep, logits.argmax(dim=1), uniform)
        n_pos = torch.randint(1, 4, (batch, 1), generator=g, device=EVAL_DEVICE)
        extra = torch.randint(0, labels, (batch, 2), generator=g, device=EVAL_DEVICE)
        target = torch.zeros(batch, labels, dtype=torch.int64, device=EVAL_DEVICE)
        target[rows, cls] = 1
        target.scatter_reduce_(1, extra, (n_pos > torch.arange(1, 3, device=EVAL_DEVICE)).to(torch.int64), "amax")
        preds = torch.softmax(logits, dim=1)
        if step == 7:
            preds = torch.round(preds * 4096) / 4096
        q = torch.softmax(logits * 0.5 + torch.randn(batch, labels, generator=g, device=EVAL_DEVICE), dim=1)
        out.append((preds, target, cls, q))
    return out


def ranking_members(mt, device) -> dict:
    return {
        "coverage": mt.CoverageError(device=device),
        "lrap": mt.LabelRankingAveragePrecision(device=device),
        "ranking_loss": mt.LabelRankingLoss(device=device),
        "hinge_cs": mt.HingeLoss(multiclass_mode="crammer-singer", device=device),
        "hinge_ova": mt.HingeLoss(multiclass_mode="one-vs-all", device=device),
        "kl": mt.KLDivergence(device=device),
    }


def ranking_update(members: dict, batch) -> None:
    preds, target, cls, q = batch
    for name in ("coverage", "lrap", "ranking_loss"):
        members[name].update(preds, target)
    members["hinge_cs"].update(preds, cls)
    members["hinge_ova"].update(preds, cls)
    members["kl"].update(preds, q)


def ranking_path(mt, checks, histogram, card: str) -> dict:
    """Phase 11: the multi-label ranking metrics, HingeLoss (both modes) and KLDivergence over the
    50,000 ImageNet-1k validation rows in 50 updates."""
    from metrics_tpu_torch.functional.classification import ranking as ranking_fn

    batches = ranking_batches()
    steps, batch, labels = RANKING_SHAPE
    make = lambda: ranking_members(mt, EVAL_DEVICE)  # noqa: E731
    runs, launches, members = time_runs(make, ranking_update, batches, checks, histogram)
    result = {"n": steps * batch, "labels": labels, "steps": steps, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs), "kernel_launches": launches}
    result["update_profile"] = update_profile(make, ranking_update, batches[:8], result["update_ms_per_step"])
    result["update_peak_extra_bytes"] = peak_extra_bytes(lambda: ranking_update(make(), batches[0]))
    preds, target = batches[0][0], batches[0][1]
    result["lrap_block_rows"] = max(1, ranking_fn.LRAP_BLOCK_BYTES // (2 * labels * labels))  # int16 counts
    result["lrap_peak_extra_bytes"] = peak_extra_bytes(lambda: ranking_fn._lrap_rank_counts(preds, target == 1))
    assert result["lrap_block_rows"] * 2 * labels * labels <= 256 * 2**20, "an LRAP block over 256 MiB"
    result["lrap_compare"] = op_profile(lambda: ranking_fn._lrap_rank_counts(preds, target == 1),
                                        bytes_moved=batch * labels * (4 + 8 + 2 * 4), ops=4 * batch * labels * labels)
    values = timed_compute(members, result)

    # the CPU twin: every batch if it fits CPU_TWIN_S, else the first ones against a card twin fed the same
    cpu = ranking_members(mt, "cpu")
    cpu_batches = [tuple(t.cpu() for t in b) for b in batches[:1]]
    t0 = time.perf_counter()
    ranking_update(cpu, cpu_batches[0])
    once = time.perf_counter() - t0
    twin_steps = cpu_twin_steps(once, steps)
    for b in batches[1:twin_steps]:
        ranking_update(cpu, tuple(t.cpu() for t in b))
    card_twin = members
    if twin_steps < steps:
        card_twin = ranking_members(mt, EVAL_DEVICE)
        for b in batches[:twin_steps]:
            ranking_update(card_twin, b)
    for name, cpu_m in cpu.items():
        for state, want in cpu_m.metric_state.items():
            # counts and the coverage sums (integers below 2**24 in every order) bit for bit
            exact = state in ("total", "sample_weight") or name == "coverage"
            assert_state_close(getattr(card_twin[name], state), want, f"ranking {name}.{state}",
                               rtol=0.0 if exact else RANKING_RTOL, atol=0.0 if exact else 1e-6)
    err = {name: assert_curve_close(compute_all(card_twin)[name], value, f"ranking {name}", atol=1e-6, rtol=RANKING_RTOL)
           for name, value in compute_all(cpu).items()}
    result.update(values={k: (float(v) if v.numel() == 1 else float(v.mean())) for k, v in values.items()},
                  cpu_twin_steps=twin_steps, cpu_s_per_update=once, max_abs_err_vs_cpu=err)
    assert launches == 0, f"ranking: {launches} bincount launches"
    log(f"ranking_imagenet N={result['n']} L={labels}: update {result['update_ms_per_step']:.3f} ms/step (runs {runs}), "
        f"compute {result['compute_ms']:.3f} ms (again {result['compute_again_ms']:.3f}); values {result['values']}; "
        f"peak extra {result['update_peak_extra_bytes']} bytes an update (LRAP blocks of {result['lrap_block_rows']} "
        f"rows, {result['lrap_peak_extra_bytes']} bytes); CPU twin over {twin_steps} of {steps} updates "
        f"({once:.2f} s an update on the CPU), max |err| {err}  [{card}]")
    log(f"ranking_imagenet profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; LRAP compare {json.dumps(result['lrap_compare'])}  [{card}]")
    return result


# ---- phase 12: regression_2p24
def regression_batches(seed: int = 31, shape=None) -> list:
    """The evaluation shard of a demand-forecasting or claims model: targets >= 0 with about 30%
    exact zeros, predictions > 0 (a Tweedie objective with 1 < power < 2 is the usual loss)."""
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    steps, rows = (shape or REGRESSION_SHAPE)[0], (shape or REGRESSION_SHAPE)[1:]
    out = []
    for _ in range(steps):
        level = torch.exp(torch.randn(rows, generator=g, device=EVAL_DEVICE) * 0.8)
        zero = torch.rand(rows, generator=g, device=EVAL_DEVICE) < 0.3
        target = torch.where(zero, 0.0, level * torch.exp(torch.randn(rows, generator=g, device=EVAL_DEVICE) * 0.3))
        out.append((level * 0.7 + 0.05, target))
    return out


def regression_suite(mt, device):
    return mt.MetricCollection({
        "mse": mt.MeanSquaredError(device=device),
        "mae": mt.MeanAbsoluteError(device=device),
        "msle": mt.MeanSquaredLogError(device=device),
        "mape": mt.MeanAbsolutePercentageError(device=device),
        "smape": mt.SymmetricMeanAbsolutePercentageError(device=device),
        "wmape": mt.WeightedMeanAbsolutePercentageError(device=device),
        "cosine": mt.CosineSimilarity(device=device),
        "explained_variance": mt.ExplainedVariance(device=device),
        "r2": mt.R2Score(device=device),
        "pearson": mt.PearsonCorrCoef(device=device),
        "spearman": mt.SpearmanCorrCoef(device=device),
        "tweedie": mt.TweedieDevianceScore(power=1.5, device=device),
    })


def multioutput_suite(mt, device):
    outputs = MULTIOUTPUT_SHAPE[2]
    return mt.MetricCollection({
        "r2": mt.R2Score(num_outputs=outputs, multioutput="raw_values", device=device),
        "explained_variance": mt.ExplainedVariance(multioutput="raw_values", device=device),
        "mse": mt.MeanSquaredError(num_outputs=outputs, device=device),
    })


def regression_path(mt, checks, histogram, card: str) -> dict:
    """Phase 12: all twelve regression metrics over 2**24 rows in 64 updates, one compute; then
    R2Score, ExplainedVariance and MeanSquaredError per output over 16 updates of (65,536, 16)."""
    from metrics_tpu_torch.functional.regression.correlation import _rank_data

    batches = regression_batches()
    n = sum(p.numel() for p, _ in batches)
    make = lambda: regression_suite(mt, EVAL_DEVICE)  # noqa: E731
    runs, launches, suite = time_runs(make, update_batch, batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert ["cosine", "spearman"] in groups, f"regression: groups {groups}"
    result = {"n": n, "steps": len(batches), "groups": groups, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs), "kernel_launches": launches}
    result["update_profile"] = update_profile(make, update_batch, batches[:10], result["update_ms_per_step"])
    members = dict(suite.items(keep_base=True, copy_state=False))
    spearman = members["spearman"]
    result["buffered_bytes_on_card"] = sum(t.numel() * t.element_size() for t in spearman.preds + spearman.target)
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all(members))
    values = timed_compute(members, result)
    all_preds = torch.cat([p for p, _ in batches])
    result["spearman_sort"] = op_profile(lambda: torch.sort(all_preds), bytes_moved=(4 + 4 + 8) * n, ops=0)
    result["spearman_rank"] = op_profile(lambda: _rank_data(all_preds), bytes_moved=(4 + 4) * n, ops=0)

    cpu = regression_suite(mt, "cpu")
    t0 = time.perf_counter()
    for p, t in batches:
        cpu.update(p.cpu(), t.cpu())
    result["cpu_update_s"] = time.perf_counter() - t0
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, cpu_m in cpu_members.items():
        for state, want in cpu_m.metric_state.items():
            exact = isinstance(want, list) or not want.is_floating_point() or state == "n_obs"
            assert_state_close(getattr(members[name], state), want, f"regression {name}.{state}",
                               rtol=0.0 if exact else REGRESSION_RTOL, atol=0.0 if exact else 1e-6)
    t0 = time.perf_counter()
    want = {k: m.compute() for k, m in cpu_members.items()}
    result["cpu_compute_s"] = time.perf_counter() - t0
    err = {k: assert_curve_close(values[k], w, f"regression {k}", atol=SPEARMAN_ATOL if k == "spearman" else 1e-6,
                                 rtol=0.0 if k == "spearman" else REGRESSION_RTOL) for k, w in want.items()}
    result.update(values={k: float(v) for k, v in values.items()}, max_abs_err_vs_cpu=err)

    mo_batches = regression_batches(seed=32, shape=MULTIOUTPUT_SHAPE)
    mo = multioutput_suite(mt, EVAL_DEVICE)
    mo_cpu = multioutput_suite(mt, "cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, t in mo_batches:
        mo.update(p, t)
    torch.cuda.synchronize()
    result["multioutput_update_ms_per_step"] = (time.perf_counter() - t0) / len(mo_batches) * 1e3
    for p, t in mo_batches:
        mo_cpu.update(p.cpu(), t.cpu())
    mo_values, mo_want = mo.compute(), mo_cpu.compute()
    result["multioutput_max_abs_err_vs_cpu"] = {
        k: assert_curve_close(mo_values[k], w, f"multioutput {k}", atol=1e-6, rtol=REGRESSION_RTOL) for k, w in mo_want.items()}
    assert all(v.shape == (MULTIOUTPUT_SHAPE[2],) for v in mo_values.values())
    assert launches == 0, f"regression: {launches} bincount launches"
    log(f"regression_2p24 N={n}: update {result['update_ms_per_step']:.4f} ms/step (runs {runs}), compute "
        f"{result['compute_ms']:.2f} ms (again {result['compute_again_ms']:.2f}; CPU {result['cpu_compute_s']:.1f} s), "
        f"peak extra {result['compute_peak_extra_bytes']} bytes; values {result['values']}; max |err| vs CPU {err}; "
        f"multi-output (16 x 65,536 x 16) {result['multioutput_update_ms_per_step']:.4f} ms/step, max |err| "
        f"{result['multioutput_max_abs_err_vs_cpu']}  [{card}]")
    log(f"regression_2p24 profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; sort {json.dumps(result['spearman_sort'])}; ranks "
        f"{json.dumps(result['spearman_rank'])}  [{card}]")
    return result


# ---- phase 13: pairwise_embeddings
def pairwise_path(mt, card: str) -> dict:
    """Phase 13: the four pairwise functions on x (4096, 768) against y (8192, 768), reduction None
    and "mean", then x against itself with its zero diagonal; Manhattan in its row blocks."""
    from metrics_tpu_torch.functional.pairwise import distances

    n, m, d = PAIRWISE_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(33)
    x = torch.randn(n, d, generator=g, device=EVAL_DEVICE)
    y = torch.randn(m, d, generator=g, device=EVAL_DEVICE)
    x_cpu, y_cpu = x.cpu(), y.cpu()
    rows = PAIRWISE_CPU_ROWS
    result = {"n": n, "m": m, "d": d, "cpu_rows": rows, "card": card}
    block_rows = max(1, distances.MANHATTAN_BLOCK_BYTES // (4 * m * d))
    assert block_rows * m * d * 4 <= 256 * 2**20, "a Manhattan block over 256 MiB"
    result["manhattan_block_rows"] = block_rows
    for name in ("cosine_similarity", "euclidean_distance", "linear_similarity", "manhattan_distance"):
        fn = getattr(mt.functional, f"pairwise_{name}")
        out = {}
        for label, args, cpu_args in (("xy", (x, y), (x_cpu[:rows], y_cpu)), ("xx", (x,), (x_cpu[:rows], x_cpu))):
            full = fn(*args)
            want = fn(*cpu_args, zero_diagonal=True) if label == "xx" else fn(*cpu_args)
            err = assert_curve_close(full[:rows], want, f"pairwise {name} {label}", atol=PAIRWISE_ATOL, rtol=PAIRWISE_RTOL)
            mean = fn(*args, reduction="mean")
            torch.testing.assert_close(mean, full.mean(dim=-1), rtol=1e-5, atol=1e-5, msg=f"pairwise {name} mean")
            if label == "xx":
                assert bool((torch.diagonal(full) == 0).all()), f"pairwise {name}: the diagonal is not zero"
            out[label] = {"ms": timed_ms(lambda: fn(*args), repeats=3),
                          "mean_ms": timed_ms(lambda: fn(*args, reduction="mean"), repeats=3),
                          "max_abs_err_vs_cpu": err,
                          "peak_extra_bytes": peak_extra_bytes(lambda: fn(*args))}
            del full
        cols = m
        flops = (3 if name == "manhattan_distance" else 2) * n * cols * d
        out["xy"]["profile"] = op_profile(lambda: fn(x, y), bytes_moved=4 * (n * d + m * d + n * m), ops=flops)
        result[name] = out
        log(f"pairwise {name}: x·y {out['xy']['ms']:.3f} ms (mean {out['xy']['mean_ms']:.3f}), x·x "
            f"{out['xx']['ms']:.3f} ms, peak extra {out['xy']['peak_extra_bytes']} bytes, max |err| vs CPU "
            f"({rows} rows) {out['xy']['max_abs_err_vs_cpu']:.3g} / {out['xx']['max_abs_err_vs_cpu']:.3g}; device "
            f"{json.dumps(out['xy']['profile'])}  [{card}]")
    return result


# ---- phase 14: retrieval_msmarco
def retrieval_batches(seed: int = 34, graded: bool = False, steps: int = 0) -> list:
    """MS MARCO passage re-ranking, dev-small shape: 6,980 queries of 1,000 candidates, 100 queries
    an update (the last 80), int64 query ids, float32 scores rounded to multiples of 2**-10 (ties),
    int64 relevance: one relevant passage for most queries, two for about 5%, none for about 1%
    (graded 0 to 3, as in the TREC DL qrels, with ``graded``). ``steps`` cuts it to the first ones."""
    total, per_update, cands = RETRIEVAL_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    out = []
    for step in range(steps or -(-total // per_update)):
        queries = min(per_update, total - step * per_update)
        qid = torch.arange(step * per_update, step * per_update + queries, device=EVAL_DEVICE) * 1009 + 524_288
        indexes = qid.repeat_interleave(cands)
        scores = torch.randn(queries, cands, generator=g, device=EVAL_DEVICE)
        first = torch.randint(0, cands, (queries,), generator=g, device=EVAL_DEVICE)
        second = torch.randint(0, cands, (queries,), generator=g, device=EVAL_DEVICE)
        u = torch.rand(queries, generator=g, device=EVAL_DEVICE)
        rel = torch.zeros(queries, cands, dtype=torch.int64, device=EVAL_DEVICE)
        rows = torch.arange(queries, device=EVAL_DEVICE)
        rel[rows, first] = (u >= 0.01).to(torch.int64)
        rel[rows, second] = torch.maximum(rel[rows, second], (u >= 0.95).to(torch.int64))
        if graded:
            rel = rel * torch.randint(1, 4, rel.shape, generator=g, device=EVAL_DEVICE)
            rel = torch.maximum(rel, (torch.rand(rel.shape, generator=g, device=EVAL_DEVICE) < 0.01).to(torch.int64))
        scores = scores + 2.0 * (rel > 0)
        preds = torch.round(torch.sigmoid(scores) * 1024) / 1024
        out.append((preds.reshape(-1), rel.reshape(-1), indexes))
    return out


def retrieval_suite(mt, device):
    return mt.MetricCollection({
        "mrr": mt.RetrievalMRR(device=device),
        "map": mt.RetrievalMAP(device=device),
        "ndcg@10": mt.RetrievalNormalizedDCG(k=10, device=device),
        "p@10": mt.RetrievalPrecision(k=10, device=device),
        "r@100": mt.RetrievalRecall(k=100, device=device),
        "hit@10": mt.RetrievalHitRate(k=10, device=device),
        "r_precision": mt.RetrievalRPrecision(device=device),
        "fallout@10": mt.RetrievalFallOut(k=10, device=device),
        "pr_curve": mt.RetrievalPrecisionRecallCurve(max_k=100, device=device),
        "recall@p0.1": mt.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, device=device),
    })


def retrieval_path(mt, checks, histogram, card: str) -> dict:
    """Phase 14: ten retrieval metrics in one collection over 6,980 queries x 1,000 candidates in
    70 updates, one compute (twice: the same bits), graded NDCG, and the nine one-query functions."""
    from metrics_tpu_torch.functional.retrieval.kernels import _descending_order
    from metrics_tpu_torch.ops import segments
    from metrics_tpu_torch.retrieval.base import group_rows

    batches = retrieval_batches()
    total, queries, cands = RETRIEVAL_SHAPE
    steps, n = len(batches), total * cands
    make = lambda: retrieval_suite(mt, EVAL_DEVICE)  # noqa: E731
    runs, _, suite = time_runs(make, update_batch, batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert len(groups) == 1, f"retrieval: groups {groups}"
    result = {"n": n, "queries": total, "steps": steps, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs)}
    result["update_profile"] = update_profile(make, update_batch, batches[:10], result["update_ms_per_step"])
    members = dict(suite.items(keep_base=True, copy_state=False))
    leader = members["mrr"]
    result["buffered_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target + leader.indexes)

    histogram.KERNEL_LAUNCHES = 0
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all(members))
    result["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert result["kernel_launches"] == len(members), f"retrieval: {result['kernel_launches']} bincount launches"
    values = timed_compute(members, result)
    again = compute_all(members)
    for k, v in values.items():  # a second compute() gives the same bits
        for a, b in zip(v if isinstance(v, tuple) else (v,), again[k] if isinstance(v, tuple) else (again[k],)):
            assert a.dtype == b.dtype and torch.equal(a, b), f"retrieval {k}: a second compute() differs"

    graded = mt.RetrievalNormalizedDCG(k=10, device=EVAL_DEVICE)
    graded_batches = retrieval_batches(seed=35, graded=True)
    for b in graded_batches:
        graded.update(*b)
    histogram.KERNEL_LAUNCHES = 0
    graded_value = graded.compute()
    result["kernel_launches"] += histogram.KERNEL_LAUNCHES
    graded._computed = None
    assert torch.equal(graded.compute(), graded_value), "graded NDCG: a second compute() differs"

    # the grouping's sort, its counts and the segmented scan on every row, beside their bounds
    preds = torch.cat([b[0] for b in batches])
    target = torch.cat([b[1] for b in batches])
    indexes = torch.cat([b[2] for b in batches])
    ctx = group_rows(indexes, preds, target)
    seg_raw = torch.unique(indexes, return_inverse=True)[1]

    def lexsort():
        order1 = _descending_order(preds)
        return order1[torch.argsort(seg_raw[order1], stable=True)]

    result["grouping_sort"] = op_profile(lexsort, bytes_moved=(4 + 8 + 8) * n, ops=0)
    result["segmented_scan"] = op_profile(lambda: segments.segment_cumsum(ctx.rel, ctx.seg, ctx.num_groups),
                                          bytes_moved=(4 + 8 + 4) * n, ops=n * max(1, (n - 1).bit_length()))
    result["segment_count"] = op_profile(lambda: segments.segment_count(ctx.seg, ctx.num_groups),
                                         bytes_moved=8 * n + 4 * ctx.num_groups, ops=0)

    # the CPU twin: every update if that fits RETRIEVAL_CPU_TWIN_S, else the first 10, against a
    # card suite fed the same 10
    cpu = retrieval_suite(mt, "cpu")
    twin = retrieval_suite(mt, EVAL_DEVICE)
    for b in batches[:10]:
        cpu.update(*(t.cpu() for t in b))
        twin.update(*b)
    t0 = time.perf_counter()
    want = cpu.compute()
    cpu_once = time.perf_counter() - t0
    twin_steps = 10
    if cpu_once * steps / 10 <= RETRIEVAL_CPU_TWIN_S:
        cpu, twin_steps = retrieval_suite(mt, "cpu"), steps
        for b in batches:
            cpu.update(*(t.cpu() for t in b))
        want = cpu.compute()
        got = values
    else:
        got = twin.compute()
    err = {k: assert_curve_close(got[k], w, f"retrieval {k}", atol=RETRIEVAL_ATOL) for k, w in want.items()}
    if twin_steps == steps:
        cpu_graded = mt.RetrievalNormalizedDCG(k=10, device="cpu")
        for b in graded_batches:
            cpu_graded.update(*(t.cpu() for t in b))
        err["graded_ndcg@10"] = assert_curve_close(graded_value, cpu_graded.compute(), "graded ndcg", atol=RETRIEVAL_ATOL)
    cpu_ctx = group_rows(indexes[: 10 * queries * cands].cpu(), preds[: 10 * queries * cands].cpu(),
                         target[: 10 * queries * cands].cpu())
    twin_ctx = group_rows(indexes[: 10 * queries * cands], preds[: 10 * queries * cands], target[: 10 * queries * cands])
    for field in ("seg", "preds", "rel", "ranks", "cumrel", "counts", "starts", "n_pos"):
        assert torch.equal(getattr(twin_ctx, field).cpu(), getattr(cpu_ctx, field)), f"retrieval grouping {field} differs"

    # the nine one-query functions on 100 queries, against the CPU
    functional = {
        "retrieval_average_precision": {}, "retrieval_reciprocal_rank": {}, "retrieval_precision": {"k": 10},
        "retrieval_recall": {"k": 100}, "retrieval_fall_out": {"k": 10}, "retrieval_hit_rate": {"k": 10},
        "retrieval_r_precision": {}, "retrieval_normalized_dcg": {"k": 10},
        "retrieval_precision_recall_curve": {"max_k": 100},
    }
    q_preds, q_target = batches[0][0].reshape(queries, cands), batches[0][1].reshape(queries, cands)
    t0 = time.perf_counter()
    fn_err = {}
    for name, kwargs in functional.items():
        fn = getattr(mt.functional, name)
        for q in range(queries):
            fn_err[name] = max(fn_err.get(name, 0.0), assert_curve_close(
                fn(q_preds[q], q_target[q], **kwargs), fn(q_preds[q].cpu(), q_target[q].cpu(), **kwargs),
                f"{name} query {q}", atol=RETRIEVAL_ATOL))
    result["functional_s"] = time.perf_counter() - t0
    result.update(values={k: (float(v) if not isinstance(v, tuple) else [float(x.float().mean()) for x in v])
                          for k, v in values.items()},
                  graded_ndcg=float(graded_value), cpu_twin_steps=twin_steps, cpu_compute_s_10_updates=cpu_once,
                  max_abs_err_vs_cpu=err, functional_max_abs_err=fn_err, deterministic=True)
    log(f"retrieval_msmarco {total} queries x {cands} in {steps} updates: update {result['update_ms_per_step']:.4f} ms/step "
        f"(runs {runs}), compute {result['compute_ms']:.1f} ms (again {result['compute_again_ms']:.1f}), "
        f"{result['kernel_launches']} bincount launches, peak extra {result['compute_peak_extra_bytes']} bytes; "
        f"a second compute() the same bits; values {result['values']}; graded NDCG@10 {result['graded_ndcg']:.6f}; "
        f"CPU twin over {twin_steps} of {steps} updates (10 updates: {cpu_once:.1f} s to compute on the CPU); "
        f"max |err| {err}; functional on {queries} queries {fn_err}  [{card}]")
    log(f"retrieval_msmarco profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; grouping sort {json.dumps(result['grouping_sort'])}; segmented scan "
        f"{json.dumps(result['segmented_scan'])}; segment count {json.dumps(result['segment_count'])}  [{card}]")
    return result


def eval_paths(mt, checks, histogram, card: str) -> dict:
    """Phases 11 to 14."""
    out = {"ranking_imagenet": ranking_path(mt, checks, histogram, card),
           "regression_2p24": regression_path(mt, checks, histogram, card),
           "pairwise_embeddings": pairwise_path(mt, card),
           "retrieval_msmarco": retrieval_path(mt, checks, histogram, card)}
    out["kernel_launches"] = sum(out[k]["kernel_launches"] for k in ("ranking_imagenet", "regression_2p24",
                                                                     "retrieval_msmarco"))
    return out


# ------------------------------------------------------------------ phase 10
SYNC_SUITES = ("headline", "agreement", "segmentation", "aggregators", "curves", "regression", "retrieval")
SYNC_REGRESSION_ROWS = 65_536  # rows of each regression update on each rank
SYNC_STEPS = 2  # updates of each suite on each rank
SYNC_TRIALS = 5  # timed syncs of each protocol, alternating, after one untimed sync
SYNC_WORLD_S = 600  # wall-clock limit of the two-rank world
SYNC_DEVICE = "cuda"  # where the synced suites live


def sync_suite(mt, name: str, device: str):
    if name == "headline":
        return make_suite(mt, 128, device)
    if name == "agreement":
        return agreement_suite(mt, device, 1000)
    if name == "segmentation":
        return segmentation_suite(mt, device, 19)
    if name == "curves":
        return mt.MetricCollection({"auroc": mt.AUROC(pos_label=1, device=device),
                                    "ap": mt.AveragePrecision(pos_label=1, device=device)})
    if name == "regression":  # Pearson's moments of spec None, stacked; Spearman's `cat` rows
        return mt.MetricCollection({"mse": mt.MeanSquaredError(device=device), "r2": mt.R2Score(device=device),
                                    "pearson": mt.PearsonCorrCoef(device=device),
                                    "spearman": mt.SpearmanCorrCoef(device=device),
                                    "tweedie": mt.TweedieDevianceScore(power=1.5, device=device)})
    if name == "retrieval":  # rows of int64 query ids in list states of spec None
        return mt.MetricCollection({"map": mt.RetrievalMAP(device=device), "mrr": mt.RetrievalMRR(device=device),
                                    "ndcg@10": mt.RetrievalNormalizedDCG(k=10, device=device),
                                    "r@100": mt.RetrievalRecall(k=100, device=device)})
    return mt.MetricCollection({n: getattr(mt, n)(device=device) for n in AGGREGATORS}, compute_groups=False)


def sync_batches(name: str, rank: int, steps: int = SYNC_STEPS) -> list:
    """Rank ``rank``'s updates of suite ``name`` on the card, ``(args, kwargs)`` each, from a seed
    of the suite and the rank: full-width batches, and per-sample losses of an uneven length."""
    seed = 100 + 10 * rank + SYNC_SUITES.index(name)
    if name == "headline":
        return [((p, t), {}) for p, t in make_batches(8192, 128, steps, seed)]
    if name == "agreement":
        return [((p, t), {}) for p, t in make_batches(4096, 1000, steps, seed, signal=4.0)]
    if name == "segmentation":
        return [((p, t), {}) for p, t in make_batches(2, 19, steps, seed, signal=3.0, spatial=(1024, 2048))]
    if name == "regression":
        return [(b, {}) for b in regression_batches(seed, shape=(steps, SYNC_REGRESSION_ROWS))]
    if name == "retrieval":  # the ranks hold rows of the same queries
        return [(b, {}) for b in retrieval_batches(seed, steps=steps)]
    g = torch.Generator(device=SYNC_DEVICE).manual_seed(seed)
    if name == "curves":
        # binary rows of shapes (n,) and (n, 1) in turn, rank 1's in the other order: each sync
        # must bring them to one rank before it packs them
        out = []
        for step in range(steps):
            n = 65536 + 4096 * rank
            preds = torch.round(torch.rand(n, generator=g, device=SYNC_DEVICE) * 4096) / 4096
            target = (torch.rand(n, generator=g, device=SYNC_DEVICE) < 0.3).to(torch.int64)
            if (step + rank) % 2:
                preds, target = preds[:, None], target[:, None]
            out.append(((preds, target), {}))
        return out
    batch = 4096 + 1000 * rank  # CatMetric holds an uneven number of rows on each rank
    return [((torch.rand(batch, generator=g, device=SYNC_DEVICE) * 3,),
             {"weight": torch.rand(batch, generator=g, device=SYNC_DEVICE)}) for _ in range(steps)]


def per_state_gather(tensor, group=None):
    """``gather_all_tensors`` behind another name: a ``dist_sync_fn`` that forces the per-state protocol."""
    from metrics_tpu_torch.parallel import gather_all_tensors

    return gather_all_tensors(tensor, group)


def suite_states(suite) -> dict:
    """(member, state) -> the state, a list state concatenated as a sync leaves it."""
    out = {}
    for name, m in suite.items(keep_base=True, copy_state=False):
        for state, value in m.metric_state.items():
            out[(name, state)] = torch.cat(value) if isinstance(value, list) else value
    return out


def timed_sync(suite, protocol: str) -> tuple:
    """One suite sync by ``protocol``: (ms on the host clock, ending in a synchronise; collective counts)."""
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    kwargs = {"dist_sync_fn": per_state_gather} if protocol == "per_state" else {}
    reset_collective_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    suite.sync(distributed_available=lambda: True, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = collective_stats()
    return ms, {k: stats[k] for k in ("sync_shape_collectives", "sync_payload_collectives", "sync_bytes_gathered",
                                      "sync_states_coalesced")}


def sync_trials(suite, check=None) -> dict:
    """One untimed coalesced sync (a live group checks a new static layout once), then
    ``SYNC_TRIALS`` syncs of each protocol, alternating; ``check(suite)`` after each sync."""
    out = {"first": None, "coalesced": [], "per_state": []}
    order = ["coalesced"] + ["coalesced", "per_state", "per_state", "coalesced"] * ((SYNC_TRIALS + 1) // 2)
    for i, protocol in enumerate(order):
        ms, counts = timed_sync(suite, protocol)
        if check is not None:
            check(suite)
        suite.unsync()
        if i == 0:
            out["first"] = counts
        elif len(out[protocol]) < SYNC_TRIALS:
            out[protocol].append((ms, counts))
    result = {"first_sync_counts": out["first"]}
    for protocol in ("coalesced", "per_state"):
        times = sorted(ms for ms, _ in out[protocol])
        counts = [c for _, c in out[protocol]]
        assert all(c == counts[0] for c in counts), f"{protocol}: the collective counts differ between syncs: {counts}"
        result[protocol] = {"sync_ms_median": times[len(times) // 2], "sync_ms": times, "counts": counts[0]}
    return result


def sync_profile(suite, protocol: str, syncs: int = 3) -> dict:
    """Where a suite sync's time goes (torch.profiler, ``syncs`` syncs after one in the warm-up
    cycle): device ms and device operations per sync, and per sync the host ops with the most
    self CPU time, each with its calls. Host times are taken under the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kwargs = {"dist_sync_fn": per_state_gather} if protocol == "per_state" else {}

    def one_sync():
        suite.sync(distributed_available=lambda: True, **kwargs)
        torch.cuda.synchronize()
        suite.unsync()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        one_sync()
        prof.step()
        for _ in range(syncs):
            one_sync()
        prof.step()

    rows = [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")]
    device = [e for e in rows if device_us(e) > 0 and e.self_cpu_time_total == 0]
    host = sorted((e for e in rows if e.self_cpu_time_total > 0), key=lambda e: -e.self_cpu_time_total)
    return {
        "device_ms_per_sync": sum(device_us(e) for e in device) / 1e3 / syncs if device else None,
        "device_ops_per_sync": sum(e.count for e in device) / syncs,
        "host_op_ms_per_sync": sum(e.self_cpu_time_total for e in host) / 1e3 / syncs,
        "top_host_ops_per_sync": {e.key[:60]: [e.self_cpu_time_total / 1e3 / syncs, e.count / syncs] for e in host[:8]},
    }


def assert_sync_counts(label: str, result: dict, n_states: int, has_cat: bool, row_gathers: int = 0) -> None:
    """A coalesced sync is one payload collective (plus one metadata collective for ``cat`` states),
    the per-state protocol two collectives a state. List states of spec None (the retrieval rows,
    ``row_gathers`` rows in all) decline the packed lane in both packages: two collectives a row."""
    co, ps = result["coalesced"]["counts"], result["per_state"]["counts"]
    if row_gathers:
        for counts in (co, ps):
            assert counts["sync_shape_collectives"] == counts["sync_payload_collectives"] == row_gathers, (
                f"{label}: {counts} for {row_gathers} buffered rows")
        return
    assert co["sync_payload_collectives"] == 1, f"{label}: {co} payload collectives per coalesced sync"
    assert co["sync_shape_collectives"] == int(has_cat), f"{label}: {co} metadata collectives per coalesced sync"
    assert co["sync_states_coalesced"] == n_states, f"{label}: {co['sync_states_coalesced']} of {n_states} states packed"
    assert ps["sync_shape_collectives"] == ps["sync_payload_collectives"] == n_states, (
        f"{label}: the per-state protocol issued {ps} for {n_states} states")


def sync_world_of_one(mt, histogram, name: str, card: str) -> dict:
    """Suite ``name`` updated on the card, then synced through NCCL in a world of one rank: every
    state bit-exact after each sync, the local states back after each unsync, the collective
    counts of both protocols, and their sync times."""
    suite = sync_suite(mt, name, SYNC_DEVICE)
    histogram.KERNEL_LAUNCHES = 0
    for args, kwargs in sync_batches(name, 0):
        suite.update(*args, **kwargs)
    torch.cuda.synchronize()
    launches = histogram.KERNEL_LAUNCHES
    members = dict(suite.items(keep_base=True, copy_state=False))
    if name in ("curves", "retrieval"):
        # buffered raw rows (shapes (n,) and (n, 1); int64 targets): the first sync brings them to their
        # canonical form in place (Metric._canonicalize_list_states) before it packs them; the local
        # states are read after it
        suite.sync(distributed_available=lambda: True)
        suite.unsync()
        assert all(r.ndim == 1 for m in members.values() for r in m.preds + m.target), "rows not canonicalised"
    local = {(m, s): v for m, member in members.items() for s, v in member.metric_state.items()}
    want = {k: v.clone() for k, v in suite_states(suite).items()}
    has_cat = any(isinstance(v, list) for v in local.values())
    row_gathers = sum(len(v) for (m, s), v in local.items() if isinstance(v, list) and members[m]._reduction_specs[s] is None)

    def check(synced):
        for (m, s), value in want.items():
            got = getattr(members[m], s)
            if isinstance(got, list):  # rows of spec None, gathered row by row
                got = torch.cat(got)
            elif members[m]._reduction_specs[s] is None:
                assert got.shape == (1,) + value.shape, f"sync {name}: {m}.{s} not stacked"  # one row a process
                got = got[0]
            assert got.device == value.device and got.dtype == value.dtype and torch.equal(got, value), (
                f"sync {name}: {m}.{s} changed in a world of one")

    result = sync_trials(suite, check)
    for (m, s), value in local.items():  # unsync put back the very same local states
        got = getattr(members[m], s)
        assert (got == value) if isinstance(value, list) else (got is value), f"sync {name}: {m}.{s} not restored"
    assert_sync_counts(f"sync {name} (NCCL, world of one)", result, len(want), has_cat, row_gathers)
    # the first update of a collection runs every member: each confusion-matrix member launches once
    expected = {"headline": SYNC_STEPS, "agreement": 3 + SYNC_STEPS - 1, "segmentation": SYNC_STEPS}.get(name, 0)
    assert launches == expected, f"sync {name}: {launches} bincount launches in {SYNC_STEPS} updates, not {expected}"
    packed = result["coalesced"]["counts"]["sync_bytes_gathered"]
    result.update(states=len(want), bytes_packed=packed, kernel_launches=launches, card=card)
    result["profile"] = {protocol: sync_profile(suite, protocol) for protocol in ("coalesced", "per_state")}
    log(f"sync {name} (NCCL, world of one): {len(want)} states, {packed} bytes packed; collectives a sync: coalesced "
        f"{result['coalesced']['counts']['sync_shape_collectives']} metadata + "
        f"{result['coalesced']['counts']['sync_payload_collectives']} payload (first sync "
        f"{result['first_sync_counts']['sync_shape_collectives']} + "
        f"{result['first_sync_counts']['sync_payload_collectives']}), per-state "
        f"{result['per_state']['counts']['sync_shape_collectives']} shape + "
        f"{result['per_state']['counts']['sync_payload_collectives']} payload; sync ms (median of {SYNC_TRIALS}): "
        f"coalesced {result['coalesced']['sync_ms_median']:.4f}, per-state {result['per_state']['sync_ms_median']:.4f}"
        f"  [{card}]")
    log(f"sync {name} profile: {json.dumps(result['profile'])}  [{card}]")
    return result


def gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of the two-rank world on the one card (Gloo, CUDA tensors): each suite fed this
    rank's batches and computed (``compute()`` syncs), then timed syncs of both protocols."""
    import torch.distributed as dist

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    result: dict = {}
    try:
        probe = torch.full((4,), rank, dtype=torch.int32, device=SYNC_DEVICE)
        rows = [torch.empty_like(probe) for _ in range(world)]
        try:
            dist.all_gather(rows, probe)
            result["gloo_cuda"] = [r.tolist() for r in rows] == [[r] * 4 for r in range(world)]
        except RuntimeError as err:
            result["gloo_cuda"], result["gloo_cuda_error"] = False, str(err)
        for name in SYNC_SUITES if result["gloo_cuda"] else ():
            suite = sync_suite(mt, name, SYNC_DEVICE)
            for args, kwargs in sync_batches(name, rank):
                suite.update(*args, **kwargs)
            reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values = suite.compute()
            torch.cuda.synchronize()
            compute_ms = (time.perf_counter() - t0) * 1e3
            stats = collective_stats()
            suite.unsync()  # the retrieval members leave compute() synced, as in JAX
            n_states = len(suite_states(suite))
            row_gathers = sum(len(getattr(m, s)) for _, m in suite.items(keep_base=True, copy_state=False)
                              for s, spec in m._reduction_specs.items() if spec is None and isinstance(getattr(m, s), list))
            result[name] = {
                "values": {k: v.cpu() for k, v in values.items()},
                "compute_ms": compute_ms,
                "compute_counts": {k: stats[k] for k in ("sync_shape_collectives", "sync_payload_collectives",
                                                         "sync_bytes_gathered")},
                "states": n_states,
                "has_cat": name in ("aggregators", "curves", "regression"),
                "row_gathers": row_gathers,
                **sync_trials(suite),
            }
            del suite
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()


def run_two_ranks(world: int = 2) -> list:
    """Spawn the two ranks of the Gloo world; kill them at ``SYNC_WORLD_S`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=gloo_rank, args=(rank, world, init_method, tmp)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SYNC_WORLD_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise RuntimeError(f"two-rank sync world: exit codes {codes}, {len(hung)} killed at {SYNC_WORLD_S} s")
        return [torch.load(os.path.join(tmp, f"{rank}.pt")) for rank in range(world)]


def sync_two_ranks(mt, card: str) -> dict:
    """Two ranks on the one card over Gloo: both ranks' synced values equal one CPU instance
    fed every batch of both (counts bit-exact, values within atol 1e-6 and rtol 1e-5)."""
    results = run_two_ranks()
    if not all(r["gloo_cuda"] for r in results):
        log(f"sync two ranks: torch's Gloo refused CUDA tensors for all_gather: {results[0].get('gloo_cuda_error')}")
        return {"gloo_cuda": False, "error": results[0].get("gloo_cuda_error"), "card": card}
    out = {"gloo_cuda": True, "card": card}
    for name in SYNC_SUITES:
        reference = sync_suite(mt, name, "cpu")
        ranks_batches = [sync_batches(name, rank) for rank in range(len(results))]
        # rows in the order the sync leaves them: rank by rank, but the retrieval rows (spec None,
        # gathered row by row) batch by batch, each batch's ranks in turn
        if name == "retrieval":
            order = [ranks_batches[r][b] for b in range(SYNC_STEPS) for r in range(len(results))]
        else:
            order = [batch for batches in ranks_batches for batch in batches]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for args, kwargs in order:
                reference.update(*(a.cpu() for a in args), **{k: v.cpu() for k, v in kwargs.items()})
            want = reference.compute()
        for rank, result in enumerate(results):
            got = result[name]["values"]
            assert sorted(got) == sorted(want), f"sync {name}, rank {rank}: keys {sorted(got)}"
            for key, value in want.items():
                g = got[key]
                assert torch.isfinite(g.float()).all(), f"sync {name}, rank {rank}: {key} is not finite"
                if value.is_floating_point():
                    torch.testing.assert_close(g, value, atol=1e-6, rtol=1e-5, msg=f"sync {name}, rank {rank}: {key}")
                else:
                    assert g.dtype == value.dtype and torch.equal(g, value), f"sync {name}, rank {rank}: {key} differs"
            assert_sync_counts(f"sync {name} (Gloo, rank {rank})", result[name], result[name]["states"],
                               result[name]["has_cat"], result[name]["row_gathers"])
        r0 = results[0][name]
        out[name] = {k: [r[name][k] for r in results] for k in ("compute_ms", "compute_counts")}
        out[name].update({p: [r[name][p] for r in results] for p in ("coalesced", "per_state", "first_sync_counts")})
        out[name]["states"] = r0["states"]
        log(f"sync {name} (Gloo, two ranks on one card, CUDA tensors): both ranks equal the CPU fed every batch; "
            f"compute() with its sync {[round(r[name]['compute_ms'], 4) for r in results]} ms; sync ms (median of "
            f"{SYNC_TRIALS}, rank 0): coalesced {r0['coalesced']['sync_ms_median']:.4f} "
            f"({r0['coalesced']['counts']['sync_shape_collectives']} metadata + "
            f"{r0['coalesced']['counts']['sync_payload_collectives']} payload, "
            f"{r0['coalesced']['counts']['sync_bytes_gathered']} bytes gathered), per-state "
            f"{r0['per_state']['sync_ms_median']:.4f} ({r0['per_state']['counts']['sync_payload_collectives']} x 2)"
            f"  [{card}]")
    return out


def sync_path(mt, histogram, card: str) -> dict:
    """Phase 10: every suite synced through NCCL in a world of one rank, then two ranks over Gloo."""
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the machine has no network: bootstrap over loopback
    torch.cuda.set_device(0)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0, world_size=1)
        try:
            for name in SYNC_SUITES:
                result[name] = sync_world_of_one(mt, histogram, name, card)
        finally:
            dist.destroy_process_group()
    result["kernel_launches"] = sum(result[name]["kernel_launches"] for name in SYNC_SUITES)
    result["two_ranks_gloo"] = sync_two_ranks(mt, card)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _native, histogram
    from metrics_tpu_torch.utils import checks

    if HERE not in Path(mt.__file__).resolve().parents:
        raise RuntimeError(f"metrics_tpu_torch was imported from {mt.__file__}, not from this checkout")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, device {kind}")
    build_s = build_kernels(_native, histogram)

    max_abs_err = check_bincount(histogram)
    sweep = sweep_bincount(histogram, card)
    log(json.dumps({"bincount_sweep": sweep, "card": card}))
    kernel = kernel_entry(sweep, max_abs_err)
    main = main_path(mt, checks, histogram, card)
    large = large_l_path(mt, histogram)
    multilabel = multilabel_path(mt, histogram)
    agreement = agreement_path(mt, checks, histogram, card)
    segmentation = segmentation_path(mt, checks, histogram, card)
    aggregation = aggregation_path(mt, checks, card)
    curves = curves_path(mt, checks, histogram, card)
    evaluation = eval_paths(mt, checks, histogram, card)
    sync = sync_path(mt, histogram, card)
    # each path's first timed run in mode "first", the curve paths' first runs and weighted areas, the
    # retrieval path's first compute() and graded NDCG, and the sync phase's updates, counted from 0
    # just before each
    kernel["launches"] = sum(p["first"]["kernel_launches"] for p in (main, agreement, segmentation))
    kernel["launches"] += curves["kernel_launches"] + evaluation["kernel_launches"] + sync["kernel_launches"]

    log(json.dumps({"build_s": build_s, "main_path": main, "large_l_path": large, "multilabel_path": multilabel,
                    "agreement_path": agreement, "segmentation_path": segmentation, "aggregation_path": aggregation,
                    "curves_path": curves, "eval_paths": evaluation, "sync_path": sync}))
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
