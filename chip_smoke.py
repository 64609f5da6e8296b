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
   full of junk, at N=0 and N=1. Then a sweep of five shapes the port gives
   the bincount (main, large-L, multilabel, binary, one-bin), both paths:
   device time and device operations per call (torch.profiler), wrapper time
   (CUDA events) and host time per call, beside the plain version,
   ``torch.bincount`` and the bound. One JSON line ``{"bincount_sweep": ...}``.
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

Output: labelled lines, then a JSON line ``{"kernels": [...]}``, then the
nvidia-smi line, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4  # weighted bincount: float32 atomics in run-dependent order


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
            prof = device_profile([fn] * 52)
            device_ms = sum(ms for ms, _ in prof.values()) / 50
            ops = sum(k for _, k in prof.values()) / 50
            if path == "dispatched":
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


def make_batches(batch: int, num_classes: int, steps: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(steps):
        logits = torch.randn(batch, num_classes, generator=g, device="cuda")
        target = torch.randint(0, num_classes, (batch,), generator=g, device="cuda")
        out.append((torch.softmax(logits, dim=1), target))
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


def assert_suites_equal(gpu_suite, cpu_suite, label: str) -> None:
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
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0, msg=f"{label}: {key}")
        else:
            assert got.dtype == torch.int32 and torch.equal(got, want), f"{label}: {key} differs"


def device_profile(steps, warmup: int = 2) -> dict:
    """Device-side time by kernel over ``steps`` (callables), from torch.profiler.

    The first ``warmup`` steps run before the profiler starts. Only
    device-side rows (kernels, memsets, copies: rows with device time and
    no CPU time of their own) are kept, so no time is counted twice.
    Returns key -> [device ms, count].
    """
    from torch.profiler import ProfilerActivity, profile

    for step in steps[:warmup]:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in steps[warmup:]:
            step()
        torch.cuda.synchronize()

    def device_us(event) -> float:
        return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0.0)

    rows = prof.key_averages()
    kept = {e.key: [device_us(e) / 1e3, e.count] for e in rows if device_us(e) > 0 and e.self_cpu_time_total == 0}
    if not kept:
        seen = [(e.key[:50], e.self_cpu_time_total, device_us(e)) for e in rows][:15]
        log(f"profiler: no device-side rows; {len(rows)} rows, first ones (key, self cpu us, device us): {seen}")
    return kept


def profile_steps(suite, batches, warmup: int = 2) -> dict:
    """Device time per steady suite step, in all and by kernel."""
    active = len(batches) - warmup
    rows = device_profile([lambda p=p, t=t: suite.update(p, t) for p, t in batches], warmup)
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
    prof = profile_steps(first_suite, batches[:12])
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
    kernel["launches"] = main["first"]["kernel_launches"]
    large = large_l_path(mt, histogram)
    multilabel = multilabel_path(mt, histogram)

    log(json.dumps({"build_s": build_s, "main_path": main, "large_l_path": large, "multilabel_path": multilabel}))
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
