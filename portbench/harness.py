"""One run of one cell: set-up, the timed window, the check against the plain reference, the result line.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:

- ``configs/<config>.json``: the suite (metric classes and their arguments), the data's parameters, the
  limits of the comparison; ``reference/<config>.py``: the plain reference of that suite;
- ``generators/<kind>.py``: the seeded inputs of a configuration's data kind (``generate.py`` finds it);
  ``traffic/<mix>.json``: the batch, the input kind and the warm-up, which that generator reads;
- ``end_to_end/<metric>.py`` and ``layers/<metric>.py``: one reader each, over the window's record or
  its trace. A reader that finds nothing to read returns None and its metric is left out.

The loop is closed with one caller, an evaluation loop: each step ``suite.update(*batch)`` then a
synchronize; at each epoch's end ``suite.compute()``, its values to the host, then ``suite.reset()``;
epochs repeat until the window's seconds run out.
"""
from __future__ import annotations

import datetime
import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import generate  # noqa: E402
import devtrace  # noqa: E402
import work  # noqa: E402

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")
RUN_LIMIT_S = 330  # a run of several ranks is ended, and fails, past this (a run has 360 s)
RANK_TIMEOUT_S = 120  # a collective that waits longer on a peer raises
REFERENCE_DTYPE = torch.float64
CONTROL_DTYPE = torch.bfloat16


class RunError(RuntimeError):
    """A run that may print no result."""


def load_module(path: Path):
    """A module from a file whose name need not be an identifier (``reference/cityscapes-seg19.py``)."""
    if not path.is_file():
        raise RunError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}".replace("-", "_")
                                                  .replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"missing file {path}")
    return json.loads(path.read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic, reference and metric entries."""

    def __init__(self, spec: dict, workload: str, data_overrides: Optional[dict] = None):
        entries = [w for w in spec["workloads"] if w["name"] == workload]
        if not entries:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = entries[0]
        self.chips = self.workload["chips"]
        config_file = next(c["file"] for c in spec["configs"] if c["name"] == self.workload["config"])
        root = HERE
        self.config = load_json(root.parent / config_file)
        self.data = dict(self.config["data"], **(data_overrides or {}))
        self.traffic = load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        # loaded anew for each cell: what the reference remembers of one run's inputs goes with it
        self.reference = load_module(root / "reference" / f"{self.workload['config']}.py")
        self.limits = self.config["limits"]
        applies = lambda m: "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]
        self.readers = {m["name"]: load_module(root / "end_to_end" / f"{m['name']}.py") for m in self.end_to_end}
        self.readers.update({m["name"]: load_module(root / "layers" / f"{m['name']}.py") for m in self.per_layer})


def build_suite(mt, config: dict, device: str):
    """The configuration's ``MetricCollection``, on ``device``, with the program's defaults."""
    members = {}
    for key, member in config["suite"].items():
        members[key] = getattr(mt, member["class"])(**member["args"], device=device)
    return mt.MetricCollection(members)


def built_libraries() -> set:
    """The libraries in the program's build directory: a run's set-up that adds one built a kernel, which
    only the first run in a checkout does."""
    build_dir = HERE.parent / "build" / "metrics_tpu_torch"
    return {p.name for p in build_dir.glob("*.so")} if build_dir.is_dir() else set()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN_MODULES})


class Clock:
    """Times a call on the card by CUDA events (start recorded on the idle stream, end after the work),
    or by the host's clock where there is no card (CPU tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.pairs: list = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, started) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append((started, ev))
        else:
            self.pairs.append((started, time.perf_counter()))

    def ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number without a limit, or not a number, fails."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value is not None and not math.isnan(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def value_gaps(epoch_values: List[Dict[str, float]], expected: Dict[str, float]) -> Dict[str, float]:
    """``<member>_gap``: the largest relative gap of a member's value over every epoch computed."""
    gaps = {}
    for key, want in expected.items():
        each = [abs(got.get(key, math.nan) - want) / max(abs(want), 1e-30) for got in epoch_values]
        gaps[f"{key}_gap"] = math.nan if any(math.isnan(g) for g in each) else max(each, default=0.0)
    return gaps


def check(cell: Cell, program: dict, done: List[tuple], epoch: List[tuple],
          epoch_values: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers compared: the states at the window's close (``program``, in the reference's form)
    against the reference's over the steps of the open epoch, and every epoch's values against the
    reference's values of a whole epoch."""
    ref = cell.reference
    numbers = ref.compare_states(program, ref.accumulate(done, cell.config, REFERENCE_DTYPE))
    expected = ref.values(ref.accumulate(epoch, cell.config, REFERENCE_DTYPE), cell.config, REFERENCE_DTYPE)
    numbers.update(value_gaps(epoch_values, expected))
    if not epoch_values:
        numbers["epochs_computed"] = 0.0
    return numbers


def control_numbers(cell: Cell, epoch: List[tuple], done: List[tuple]) -> Dict[str, float]:
    """The control: the reference computed in the precision below the configuration's, put in the program's
    place and judged by the same comparison."""
    ref = cell.reference
    numbers = ref.compare_states(ref.accumulate(done, cell.config, CONTROL_DTYPE),
                                 ref.accumulate(done, cell.config, REFERENCE_DTYPE))
    got = ref.values(ref.accumulate(epoch, cell.config, CONTROL_DTYPE), cell.config, CONTROL_DTYPE)
    expected = ref.values(ref.accumulate(epoch, cell.config, REFERENCE_DTYPE), cell.config, REFERENCE_DTYPE)
    numbers.update(value_gaps([got], expected))
    return numbers


def _host_values(values: dict) -> Dict[str, float]:
    return {k: float(v) for k, v in values.items()}


def _rank_run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0_wall: float,
              rank: int = 0, world: int = 1) -> dict:
    """One process's part of a run: its set-up, its window over its share of each epoch's updates (every
    ``world``-th step from ``rank``), its check, and its readers' values. Returns plain numbers only."""
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    distributed = world > 1
    if distributed:
        import torch.distributed as dist

    phases = {"to_rank_s": time.time() - t0_wall}
    lap = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal lap
        now = time.perf_counter()
        phases[name] = now - lap
        lap = now

    libraries = built_libraries()
    import metrics_tpu_torch as mt

    phase("import_s")
    inputs = generate.make_inputs(cell.data, cell.traffic, seed, device)
    epoch = generate.epoch_steps(cell.data, cell.traffic, inputs)
    mine = epoch[rank::world]
    sync()
    phase("inputs_s")
    suite = build_suite(mt, cell.config, device)
    phase("suite_s")

    # warm-up: every shape the traffic feeds, and the compute at an epoch's size where rows are buffered
    if cell.traffic["warm"] == "epoch":
        warm = mine
    else:
        shapes = {}
        for step in mine:
            shapes.setdefault(tuple(step[0].shape), step)
        warm = [s for s in shapes.values() for _ in range(2)]
    for step in warm:
        suite.update(*step)
    sync()
    _host_values(suite.compute())
    suite.reset()
    sync()
    phase("warm_s")
    built = sorted(built_libraries() - libraries)

    update_clock = Clock(cuda)
    compute_s: List[float] = []
    host_update_s: List[float] = []
    epoch_values: List[Dict[str, float]] = []
    samples = 0
    done: List[tuple] = []
    state_bytes = sum(work.tensor_bytes(v) for m in suite.values() for v in m.metric_state.values()
                      if isinstance(v, torch.Tensor))
    step_bytes = [work.step_bytes(s, state_bytes) for s in mine]
    update_bytes: List[int] = []
    flag = torch.ones(1, dtype=torch.int32, device=device) if distributed else None

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    span = (lambda name: torch.profiler.record_function(devtrace.SPAN_PREFIX + name)) if trace else \
        (lambda name: nullcontext())

    # set-up's objects (inputs, modules, the warm-up's garbage) leave the collector's scans: the window's
    # collections see the loop's own objects only, as in a long-running evaluation loop
    gc.collect()
    gc.freeze()
    if distributed:
        dist.barrier()  # every rank's window opens together
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated() if cuda else 0
    setup_s = time.time() - t0_wall
    window_span = span("window")
    window_span.__enter__()
    start = time.perf_counter()
    deadline = start + seconds
    finished = False
    while not finished:
        done = []
        for i, step in enumerate(mine):
            if time.perf_counter() >= deadline:
                finished = True
                break
            t = update_clock.start()
            h = time.perf_counter()
            with span("update"):
                suite.update(*step)
            host_update_s.append(time.perf_counter() - h)
            with span("sync"):
                update_clock.stop(t)
                sync()
            samples += generate.step_samples(step)
            update_bytes.append(step_bytes[i])
            done.append(step)
        if distributed:  # the epoch ends for every rank, or for none: compute() is collective
            flag.fill_(0 if finished else 1)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            finished = int(flag.item()) == 0
        if not finished:
            t = time.perf_counter()
            with span("compute"):
                values = _host_values(suite.compute())  # the values on the host: the card's work is done
            compute_s.append(time.perf_counter() - t)
            epoch_values.append(values)
            with span("reset"):
                suite.reset()
            sync()
    elapsed = time.perf_counter() - start
    window_span.__exit__(None, None, None)
    gc.unfreeze()
    sync()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    window = {
        "seconds": elapsed, "samples": samples, "setup_s": setup_s,
        "update_ms": update_clock.ms(), "compute_ms": [1e3 * t for t in compute_s], "host_update_s": host_update_s,
        "peak_extra_bytes": peak - base_bytes, "updates": len(host_update_s), "computes": len(epoch_values),
        "update_bytes": update_bytes,
        "compute_bytes": work.compute_bytes(epoch, len(cell.config["suite"])),
        "peaks": work.peaks(torch.cuda.get_device_name(device) if cuda else "cpu"),
    }
    tr = devtrace.from_profiler(prof) if prof is not None else None
    del prof
    layer_values = {}
    for entry in cell.per_layer if trace else []:
        value = cell.readers[entry["name"]].read(tr, window)
        if value is not None:
            layer_values[entry["name"]] = value

    # the check: the program's states at the close and every epoch's values, against the plain reference
    # (the program's states are read into the reference's form, the program is freed, then the reference runs)
    program = cell.reference.canonical({k: m.metric_state for k, m in suite.items()}, cell.config)
    del suite
    numbers = check(cell, program, done, epoch, epoch_values)
    del program, inputs, epoch, mine, done
    return {
        "window": window, "layers": layer_values, "numbers": numbers, "epochs": len(epoch_values),
        "peak": peak, "setup": dict(phases, built=built),
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "busy_s": tr.busy_s if tr is not None else None, "window_s": tr.window_s if tr is not None else None,
        "breakdown": tr.breakdown() if tr is not None else None,
        "forbidden": forbidden_modules(),
    }


def _merge_numbers(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """Counts of what is off add up over the ranks; gaps take the largest."""
    out: Dict[str, float] = {}
    for numbers in parts:
        for k, v in numbers.items():
            if k not in out:
                out[k] = v
            elif k.endswith("_gap"):
                out[k] = v if math.isnan(v) else max(out[k], v)
            else:
                out[k] += v
    return out


def _merge_windows(parts: List[dict]) -> dict:
    """The whole run's record from each rank's: all ranks' samples over the longest window, the slowest
    rank's computes, the largest peak, the latest set-up."""
    slowest = max(parts, key=lambda w: (sum(w["compute_ms"]) / len(w["compute_ms"])) if w["compute_ms"] else 0.0)
    merged = dict(parts[0])
    merged.update(
        seconds=max(w["seconds"] for w in parts), samples=sum(w["samples"] for w in parts),
        setup_s=max(w["setup_s"] for w in parts), update_ms=[t for w in parts for t in w["update_ms"]],
        compute_ms=slowest["compute_ms"], host_update_s=[t for w in parts for t in w["host_update_s"]],
        peak_extra_bytes=max(w["peak_extra_bytes"] for w in parts), updates=sum(w["updates"] for w in parts),
        computes=min(w["computes"] for w in parts))
    return merged


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, spec: dict, workload: str, seed: int, seconds: float,
                trace: bool, device: str, t0_wall: float, data_overrides: Optional[dict],
                rank_setup: Optional[Callable[[], None]], queue) -> None:
    """A rank's process: its device, the process group over a TCP store on localhost, its part of the run."""
    import torch.distributed as dist

    try:
        if rank_setup is not None:
            rank_setup()
        cell = Cell(spec, workload, data_overrides=data_overrides)
        if device == "cuda":
            torch.cuda.set_device(rank)
            rank_device, backend = f"cuda:{rank}", "nccl"
        else:
            rank_device, backend = device, "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            queue.put((rank, _rank_run(cell, seed, seconds, trace, rank_device, t0_wall, rank, world)))
        finally:
            dist.destroy_process_group()
    except BaseException as err:  # the parent reports it; no rank is left waiting on a dead peer
        import traceback
        queue.put((rank, {"error": f"{type(err).__name__}: {err}\n{traceback.format_exc()}"}))
        raise


def _run_ranks(cell: Cell, spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
               t0_wall: float, data_overrides: Optional[dict], rank_setup) -> List[dict]:
    """Run a cell of ``cell.chips`` ranks, one process each (spawned), and gather their parts."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    world, port = cell.chips, _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(rank, world, port, spec, workload, seed, seconds, trace, device,
                                                   t0_wall, data_overrides, rank_setup, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    parts: Dict[int, dict] = {}
    try:
        while len(parts) < world and time.time() - t0_wall < RUN_LIMIT_S:
            try:
                rank, part = results.get(timeout=5.0)
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            parts[rank] = part
    finally:
        for p in procs:
            p.join(timeout=30 if len(parts) == world else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}: {p['error']}" for r, p in sorted(parts.items()) if "error" in p]
    if errors or len(parts) < world:
        raise RunError("; ".join(errors) or f"{world - len(parts)} rank(s) ended without a result")
    return [parts[r] for r in range(world)]


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0_wall: Optional[float] = None, data_overrides: Optional[dict] = None,
             rank_setup: Optional[Callable[[], None]] = None) -> dict:
    """Run one cell once; returns the result (the last line's object) with the check under ``check``.

    A cell of one chip runs in this process. A cell of several runs one spawned process a rank (``rank_setup``,
    if given, is called first in each: the tests plant faults with it), and this process merges their parts."""
    t0_wall = time.time() if t0_wall is None else t0_wall
    marks = {"imports_s": time.time() - t0_wall}
    cuda = device == "cuda"
    cell = Cell(spec, workload, data_overrides=data_overrides)
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise RunError(f"{workload} needs {cell.chips} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if cell.chips > 1:
        parts = _run_ranks(cell, spec, workload, seed, seconds, trace, device, t0_wall, data_overrides, rank_setup)
    else:
        if cuda:
            torch.cuda.set_device(0)
            torch.empty(0, device="cuda:0")  # the CUDA context
        marks["cuda_start_s"] = time.time() - t0_wall - marks["imports_s"]
        parts = [_rank_run(cell, seed, seconds, trace, "cuda:0" if cuda else device, t0_wall)]
    found = sorted({m for p in parts for m in p["forbidden"]} | set(forbidden_modules()))
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")

    window = _merge_windows([p["window"] for p in parts])
    numbers = _merge_numbers([p["numbers"] for p in parts])
    verdict = judge(numbers, dict(cell.limits, epochs_computed=-1.0))
    correct = all(v["ok"] for v in verdict.values())
    # failed: every compute of the window where a value is off, the open epoch's updates where a state is
    off = {k for k, v in verdict.items() if not v["ok"]}
    failed = (window["computes"] if any(k.endswith("_gap") for k in off) else 0) + \
        (window["updates"] if any(not k.endswith("_gap") for k in off) else 0)
    failed = max(failed, 0 if correct else 1)

    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        if trace:  # each rank's reading, averaged over the ranks that have one
            got = [p["layers"][entry["name"]] for p in parts if entry["name"] in p["layers"]]
            value = sum(got) / len(got) if got else None
        else:
            value = cell.readers[entry["name"]].read(window)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    result = {
        "correct": correct,
        "attempted": window["updates"] + window["computes"],
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": parts[0]["kind"],
            "count": cell.chips,
            "memory_peak_bytes": max(p["peak"] for p in parts),
        },
    }
    if trace and all(p["busy_s"] is not None for p in parts):
        result["device"]["busy_s"] = sum(p["busy_s"] for p in parts) / len(parts)
        result["device"]["window_s"] = max(p["window_s"] for p in parts)
        result["breakdown"] = parts[0]["breakdown"]
    # the set-up's phases of the slowest rank, and the kernels it built: apart from setup_s, so that the
    # first run in a checkout, which builds, shows as such
    result["setup"] = dict(marks, **max((p["setup"] for p in parts),
                                        key=lambda ph: sum(v for k, v in ph.items() if k != "built")))
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in verdict.items()}
    return result
