"""Roofline-guided kernel autotuner: variant sweeps for the heavy metrics.

JAX counterpart: `metrics_tpu/ops/autotune.py`, with the same registry,
consult, sweep, selection table, digest, counters, knob and fault site:

- **Registry**: each heavy kernel declares named variants, equivalent
  formulations with an exactness contract against the reference variant
  (``tolerance=None``: bit for bit; a float ``t``: ``allclose(rtol=t,
  atol=t)``). The reference is the floor: never disqualified, and it serves
  whenever no winner is installed.
- **Sweep** (:func:`sweep`): each candidate runs through a real
  :class:`~metrics_tpu_torch.ops.engine.Executable` (so its first run, its
  dispatches and its device time land in the program ledger), is checked
  against the reference under its contract, and is timed on the device: best
  of ``trials`` runs, each between two CUDA events on the card, queued back to
  back behind a spin kernel so that no span holds the host's gaps between
  launches (a host clock alone would time the enqueue); the host clock on the
  CPU and for host variants. Its score is its utilization of
  :func:`engine.roofline_peaks` for the reference program's counted work. A
  variant that fails its check, or meets an injected fault at the
  ``autotune-sweep`` site, is disqualified through the ``autotune`` ladder
  lane and never installed. An error while running a variant (a hand kernel
  that does not build or launch) is not a verdict on the variant: it
  propagates out of the sweep and the consult, so the reference never hides a
  broken kernel.
- **Selection table**: winners per ``(kernel, shape class)``, the class
  :func:`shape_class`'s power-of-two buckets with JAX's spelling
  (``float32[1024x1024]``), so that the keys of both packages read the same.
  While the autotuner is armed the table's digest is appended to the
  engine's acquire keys.
- **Persistence**: with the program cache on (:mod:`.progcache`), the
  table is written into its store as a CRC-stamped JSON sidecar, and an armed
  process restores it before its first consult: a warm boot sweeps nothing.

Off by default: ``METRICS_TPU_AUTOTUNE`` gates the plane, read once through
the warn-once parser; off, a consult is one predicate. A consult sees no
concrete tensor under ``torch.func.vmap``, on fake tensors or while a CUDA
graph is being captured, and never sweeps there.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.exceptions import JournalFault, RuntimeFault

__all__ = [
    "autotune_stats",
    "configure",
    "dispatch",
    "enabled",
    "ensure",
    "kernels",
    "load_registrations",
    "register_kernel",
    "register_variant",
    "selection_digest",
    "selection_table",
    "shape_class",
    "sweep",
    "variants",
]

# ------------------------------------------------------------------ counters
_counters: Dict[str, int] = {
    "autotune_sweeps": 0,
    "autotune_candidates": 0,
    "autotune_installs": 0,
    "autotune_disqualified": 0,
    "autotune_hits": 0,
    "autotune_persists": 0,
    "autotune_restores": 0,
}


def autotune_stats() -> Dict[str, int]:
    """The counters, merged into ``engine.engine_stats()``: ``autotune_sweeps``,
    ``autotune_candidates`` (variants timed), ``autotune_installs``,
    ``autotune_disqualified``, ``autotune_hits`` (consults served from the
    table), ``autotune_persists`` and ``autotune_restores`` (table writes to,
    and entries restored from, the program cache's store)."""
    return dict(_counters)


def _zero_counters() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("autotune", _zero_counters)


class _AutotuneOwner:
    """Ladder and warn-once anchor (one ``autotune`` lane a process: the table is process-wide)."""


_OWNER = _AutotuneOwner()
_ENABLE_WARN_OWNER = _AutotuneOwner()
_PERSIST_WARN_OWNER = _AutotuneOwner()


# ------------------------------------------------------------------- registry
class _Variant:
    __slots__ = ("name", "fn", "tolerance", "reference", "host")

    def __init__(self, name: str, fn: Callable, tolerance: Optional[float], reference: bool, host: bool):
        self.name = name
        self.fn = fn
        self.tolerance = tolerance  # None: bit for bit
        self.reference = reference
        self.host = host  # a host numpy variant: run on the arguments as given, timed on the host clock


class _Kernel:
    __slots__ = ("name", "variants", "reference", "classify")

    def __init__(self, name: str, classify: Optional[Callable]):
        self.name = name
        self.variants: Dict[str, _Variant] = {}
        self.reference: Optional[str] = None
        self.classify = classify


_KERNELS: Dict[str, _Kernel] = {}


def register_kernel(name: str, *, classify: Optional[Callable] = None) -> None:
    """Declare a tunable kernel family; ``classify(args) -> str`` replaces :func:`shape_class`."""
    if name not in _KERNELS:
        _KERNELS[name] = _Kernel(name, classify)
    elif classify is not None:
        _KERNELS[name].classify = classify


def register_variant(kernel: str, name: str, fn: Callable, *, tolerance: Optional[float] = None,
                     reference: bool = False, host: bool = False) -> None:
    """Register one variant of ``kernel``. Exactly one is the ``reference``: it defines
    the right output and is the floor. ``tolerance=None`` declares a bit-exact
    contract, a float ``t`` ``allclose(rtol=t, atol=t)`` against the reference."""
    register_kernel(kernel)
    k = _KERNELS[kernel]
    if reference:
        if k.reference is not None and k.reference != name:
            raise ValueError(f"kernel {kernel!r} already has reference {k.reference!r}")
        k.reference = name
    k.variants[name] = _Variant(name, fn, tolerance, reference, host)


def kernels() -> Tuple[str, ...]:
    """The registered kernel families."""
    return tuple(_KERNELS)


def load_registrations() -> Tuple[str, ...]:
    """Import every module that registers variants; returns :func:`kernels`."""
    import metrics_tpu_torch.detection.mean_ap  # noqa: F401 - map_box_iou
    import metrics_tpu_torch.image.generative  # noqa: F401 - fid_sqrtm
    import metrics_tpu_torch.ops.binned  # noqa: F401 - binned_counts
    import metrics_tpu_torch.ops.histogram  # noqa: F401 - bincount
    import metrics_tpu_torch.ops.sorted_curves  # noqa: F401 - auroc_sort, ap_sort

    return kernels()


def variants(kernel: str) -> Tuple[str, ...]:
    """The variants of ``kernel``, the reference first."""
    k = _KERNELS[kernel]
    return tuple(sorted(k.variants, key=lambda n: (not k.variants[n].reference, n)))


# ------------------------------------------------------------------- the gate
_TRUE_TOKENS = ("1", "true", "on", "yes")
_FALSE_TOKENS = ("0", "false", "off", "no")


def _parse_bool(raw: str) -> bool:
    token = raw.strip().lower()
    if token in _TRUE_TOKENS:
        return True
    if token in _FALSE_TOKENS:
        return False
    raise ValueError(raw)


#: The hot-path guard: a consult reads this one module attribute.
active: bool = False
_enabled_known: bool = False
_override: Dict[str, Any] = {}


def _init_enabled() -> None:
    global active, _enabled_known
    if "enabled" in _override:
        val = bool(_override["enabled"])
    else:
        from metrics_tpu_torch.parallel import sync as _psync

        val = bool(_psync._env_parse("METRICS_TPU_AUTOTUNE", False, _parse_bool, "a boolean (0/1/on/off)",
                                     owner=_ENABLE_WARN_OWNER))
    active = val
    _enabled_known = True
    _sync_engine_hooks()


def enabled() -> bool:
    """Whether the autotuner is armed (``METRICS_TPU_AUTOTUNE``, default off; read once a process)."""
    if not _enabled_known:
        _init_enabled()
    return active


def configure(*, enabled: Optional[bool] = None, reset: bool = False) -> None:  # noqa: A002 - the knob's name
    """Set the knob at run time. ``reset=True`` first clears the override, the table,
    the swept classes, the restore attempt and the ladder lane (not the counters)."""
    global _enabled_known, active
    if reset:
        _override.clear()
        _SELECTIONS.clear()
        _SWEPT.clear()
        _SWEEP_RESULTS.clear()
        _restore_state[0] = False
        _digest_cache[0] = None
        _OWNER.__dict__.pop("_fault_ladders", None)
        _enabled_known = False
        active = False
    if enabled is not None:
        _override["enabled"] = bool(enabled)
        _enabled_known = False
    if not _enabled_known:
        _init_enabled()
    else:
        _sync_engine_hooks()


# ----------------------------------------------------------- selection table
_SELECTIONS: Dict[Tuple[str, str], str] = {}
_SWEPT: set = set()
_SWEEP_RESULTS: Dict[Tuple[str, str], Dict[str, Any]] = {}
_digest_cache: list = [None]
_restore_state: list = [False]
#: kernel -> variant consulted during a program's first run of a signature
_trace_consults: Dict[str, str] = {}


def selection_table() -> Dict[str, str]:
    """The installed selections, ``"kernel|shape_class" -> variant``."""
    return {f"{k}|{sc}": v for (k, sc), v in sorted(_SELECTIONS.items())}


def selection_digest() -> str:
    """Digest of the selection table, appended to the engine's acquire keys while armed."""
    if _digest_cache[0] is None:
        blob = json.dumps(selection_table(), sort_keys=True).encode()
        _digest_cache[0] = hashlib.sha1(blob).hexdigest()[:12]
    return _digest_cache[0]


def _engine_key_suffix() -> tuple:
    return ("autotune", selection_digest())


def _engine_note_compile(exe: Any) -> None:
    """Name the variants a program's first run consulted in its ledger row."""
    if _trace_consults:
        exe.variant = ",".join(f"{k}={v}" for k, v in sorted(_trace_consults.items()))
        _trace_consults.clear()


def _sync_engine_hooks() -> None:
    from metrics_tpu_torch.ops import engine as _engine

    _engine._autotune_key = _engine_key_suffix if active else None
    _engine._autotune_note = _engine_note_compile if active else None


# --------------------------------------------------------------- shape class
def _pow2(n: int) -> int:
    return max(1, 1 << (int(n) - 1).bit_length()) if n > 0 else 0


def _dtype_str(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def shape_class(*args: Any) -> str:
    """The default shape class: a tensor or array as ``dtype[pow2-dims]`` (``float32[1024x1024]``,
    JAX's spelling), anything else by ``repr``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.autotune import shape_class
        >>> shape_class(torch.zeros(1000, 1000), torch.zeros(100, dtype=torch.int64), 7)
        'float32[1024x1024],int64[128],7'
    """
    parts: List[str] = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            parts.append(f"{_dtype_str(dtype)}[{'x'.join(str(_pow2(d)) for d in shape)}]")
        else:
            parts.append(repr(a))
    return ",".join(parts)


def _classify(kernel: str, args: tuple) -> str:
    k = _KERNELS[kernel]
    if k.classify is not None:
        return str(k.classify(args))
    return shape_class(*args)


# ------------------------------------------------------------------ consults
def _concrete(args: tuple) -> bool:
    """Whether every tensor argument holds values: not under a transform, not a fake
    tensor, not inside a CUDA-graph capture (where a sweep's reads would break it)."""
    for a in args:
        if not isinstance(a, torch.Tensor):
            continue
        if type(a) is not torch.Tensor or torch._C._functorch.is_functorch_wrapped_tensor(a):
            return False
        if a.is_cuda and torch.cuda.is_current_stream_capturing():
            return False
    return True


def dispatch(kernel: str, args: tuple, *, sweep_on_miss: bool = False, device: Any = None) -> Optional[str]:
    """The call-site consult: which variant serves this call? ``None`` means the
    reference: always while disarmed, with no selection for the shape class, and
    when the winner is the reference. ``sweep_on_miss=True`` lets a call with
    concrete inputs sweep a class seen for the first time (not while the
    ``autotune`` lane is demoted); ``device`` is where that sweep runs the
    variants that are not host variants (default: the first tensor's device,
    else the card)."""
    if not active:
        if _enabled_known:
            return None
        _init_enabled()
        if not active:
            return None
    if kernel not in _KERNELS:
        return None
    _maybe_restore()
    sc = _classify(kernel, args)
    name = _SELECTIONS.get((kernel, sc))
    if name is None:
        if sweep_on_miss and (kernel, sc) not in _SWEPT and _lane_clean() and _concrete(args):
            sweep(kernel, args, device=device)  # an error running a variant propagates: see sweep
            name = _SELECTIONS.get((kernel, sc))
        if name is None:
            return None
    _counters["autotune_hits"] += 1
    k = _KERNELS[kernel]
    if name not in k.variants:
        return None  # a restored selection this build does not register: the reference serves
    from metrics_tpu_torch.ops import engine as _engine

    if _engine._first_runs[0]:
        _trace_consults[kernel] = name
    if k.variants[name].reference:
        return None
    return name


def ensure(kernel: str, *args: Any, device: Any = None) -> Optional[str]:
    """Sweep ``(kernel, shape_class(args))`` if it never was, and return its winner (None while disarmed)."""
    if not enabled():
        return None
    _maybe_restore()
    sc = _classify(kernel, args)
    if (kernel, sc) not in _SWEPT:
        sweep(kernel, args, device=device)
    return _SELECTIONS.get((kernel, sc))


def _lane_clean() -> bool:
    lad = _faults.ladder(_OWNER, "autotune")
    if not lad.demoted:
        return True
    if lad.note_clean():
        lad.promote()
        return True
    return False


# -------------------------------------------------------------- the harness
def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _outputs_match(ref: Any, out: Any, tolerance: Optional[float]) -> bool:
    """The contract: ``tolerance=None`` bit for bit (NaNs equal); a float ``t``
    ``allclose(rtol=t, atol=t, equal_nan=True)`` leaf by leaf. Structures, shapes and dtypes must agree."""
    if isinstance(ref, (list, tuple)) or isinstance(out, (list, tuple)):
        if not (isinstance(ref, (list, tuple)) and isinstance(out, (list, tuple))) or len(ref) != len(out):
            return False
        return all(_outputs_match(a, b, tolerance) for a, b in zip(ref, out))
    a = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    b = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if tolerance is None:
        if np.issubdtype(a.dtype, np.floating):
            return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))
        return bool(np.array_equal(a, b))
    return bool(np.allclose(b, a, rtol=tolerance, atol=tolerance, equal_nan=True))


#: cycles of the spin kernel that holds the stream while the timed runs are enqueued (about 10 ms on an
#: H100), and how many times a hold that ended before the enqueue did is made 4x longer
_HOLD_CYCLES = 20_000_000
_HOLD_ATTEMPTS = 3


def _time_candidate(run: Callable[[], Any], trials: int, device: Optional[torch.device]) -> float:
    """Best of ``trials`` runs in seconds. On the card, device time: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues every run, each
    between two CUDA events, so the runs execute back to back and no span holds the
    host's gaps between launches. A hold that ended before the enqueue did is made
    longer and the runs queued again; a run that reads the device on the host cannot
    be held, and its span then includes that read. On the CPU and for host variants,
    the host clock."""
    n = max(1, trials)
    if device is None or device.type != "cuda":
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    cycles = _HOLD_CYCLES
    with torch.cuda.device(device):
        for _ in range(_HOLD_ATTEMPTS):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n)]
            held = torch.cuda.Event()
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            held.record()
            for i in range(n):
                events[2 * i].record()
                run()
                events[2 * i + 1].record()
            covered = not held.query()  # the hold outlasted the enqueue: the runs went back to back
            events[-1].synchronize()
            best = min(events[2 * i].elapsed_time(events[2 * i + 1]) for i in range(n)) / 1e3
            if covered:
                break
            cycles *= 4
    return best


def _sweep_device(args: tuple, device: Any) -> torch.device:
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def sweep(kernel: str, args: tuple, *, trials: int = 3, device: Any = None) -> Dict[str, Any]:
    """Sweep ``(kernel, shape_class(args))`` on concrete inputs and install the winner.

    Every variant is built as an :class:`~metrics_tpu_torch.ops.engine.Executable`
    of kind ``autotune:<kernel>`` (host variants run on the arguments as given),
    run once, checked against the reference's output under its contract (the
    ``autotune-sweep`` fault site fires before each check), and timed best of
    ``trials``; its score is its utilization of the calibrated peaks for the
    reference's counted FLOPs and bytes (``1 / wall`` without them). A variant
    that fails its check, or meets an injected ``autotune-sweep`` fault, is
    disqualified and demotes the lane; the reference is the floor. An error
    while building, running or timing any variant propagates (see
    :func:`_judge`). Returns the sweep's report; a class is swept once."""
    from metrics_tpu_torch.ops import engine as _engine

    if not enabled():
        raise RuntimeError("autotune.sweep requires METRICS_TPU_AUTOTUNE (or configure(enabled=True))")
    k = _KERNELS[kernel]
    if k.reference is None:
        raise ValueError(f"kernel {kernel!r} has no reference variant")
    sc = _classify(kernel, args)
    if (kernel, sc) in _SWEPT:
        return _SWEEP_RESULTS[(kernel, sc)]
    t_sweep = time.perf_counter()
    _counters["autotune_sweeps"] += 1
    dev = _sweep_device(args, device)
    array_idx = [i for i, a in enumerate(args) if _is_array(a)]
    dev_args = tuple(torch.as_tensor(np.asarray(args[i]) if isinstance(args[i], np.generic) else args[i]).to(dev)
                     for i in array_idx)

    def _make_step(fn: Callable) -> Callable:
        def step(state: Any, *arrs: Any) -> Any:
            full = list(args)
            for i, arr in zip(array_idx, arrs):
                full[i] = arr
            return fn(*full)

        return step

    static_key = tuple(repr(args[i]) for i in range(len(args)) if i not in array_idx)
    peaks = _engine.roofline_peaks(dev if dev.type == "cpu" else None)
    rows: List[Dict[str, Any]] = []
    ref_out: Any = None
    ref_analysis: Optional[Dict[str, Any]] = None
    disqualified = 0
    for name in variants(kernel):
        v = k.variants[name]
        _counters["autotune_candidates"] += 1
        row: Dict[str, Any] = {"variant": name, "reference": v.reference, "ok": False, "exact": None, "wall_s": None,
                               "score": 0.0, "compute_utilization": 0.0, "memory_utilization": 0.0}
        if v.host:
            run = lambda fn=v.fn: fn(*args)  # noqa: E731
            out = run()
            timer_device = None
        else:
            exe = _engine.acquire_keyed((f"autotune:{kernel}", name, sc, str(dev)) + static_key,
                                        lambda fn=v.fn: _make_step(fn))
            exe.variant = name
            run = lambda e=exe: e(None, *dev_args)  # noqa: E731
            out = run()  # its first run: one-time costs land in the ledger, not in the timing
            timer_device = dev
        if v.reference:
            ref_out = out
            if not v.host:
                ref_analysis = _engine._analyze(exe)
        else:
            # the reference is banked before any candidate is judged: the floor is never at risk
            err = _judge(kernel, name, v, k.reference, ref_out, out, row)
            if err is not None:
                disqualified += 1
                _counters["autotune_disqualified"] += 1
                row["error"] = f"{type(err).__name__}: {str(err)[:160]}"
                _faults.demote(
                    _OWNER, "autotune", err, default_domain="runtime", site="autotune-sweep",
                    warn=f"autotune variant {kernel}:{name} disqualified ({type(err).__name__}: {str(err)[:120]}); "
                    "the reference variant remains the floor",
                )
                rows.append(row)
                continue
        t0 = time.perf_counter()
        wall = _time_candidate(run, trials, timer_device)
        if not v.host:
            # the sweep's device walls feed the probed plane: the candidates classify like probed programs
            _telemetry.observe_device_dispatch(exe.probe_key, t0, wall)
        row["wall_s"] = wall
        flops = float((ref_analysis or {}).get("flops", 0.0) or 0.0)
        nbytes = float((ref_analysis or {}).get("bytes_accessed", 0.0) or 0.0)
        if peaks.get("calibrated") and wall > 0 and (flops > 0 or nbytes > 0):
            u_c = flops / wall / peaks["peak_flops_per_s"]
            u_m = nbytes / wall / peaks["peak_bytes_per_s"]
            row["compute_utilization"] = round(u_c, 6)
            row["memory_utilization"] = round(u_m, 6)
            row["score"] = max(u_c, u_m)
        elif wall > 0:
            row["score"] = 1.0 / wall  # the same argmax: the work is the same for every variant
        row["ok"] = True
        rows.append(row)

    winner = k.reference
    best = next(r for r in rows if r["reference"])
    for row in rows:
        if row["ok"] and not row["reference"] and row["score"] > best["score"]:
            winner = row["variant"]
            best = row
    _install(kernel, sc, winner)
    report = {"kernel": kernel, "shape_class": sc, "winner": winner, "reference": k.reference, "candidates": rows,
              "disqualified": disqualified, "device": str(dev)}
    _SWEPT.add((kernel, sc))
    _SWEEP_RESULTS[(kernel, sc)] = report
    if _telemetry.armed:
        _telemetry.emit("autotune-sweep", kernel, "autotune", t_sweep, time.perf_counter() - t_sweep,
                        {"shape_class": sc, "winner": winner, "candidates": len(rows), "disqualified": disqualified})
    return report


def _judge(kernel: str, name: str, v: _Variant, reference: str, ref_out: Any, out: Any,
           row: Dict[str, Any]) -> Optional[Exception]:
    """The verdict on a candidate that ran: the fault that disqualifies it, or None.
    Only its contract judges it: an injected fault at the ``autotune-sweep`` site,
    or outputs off the reference's (``row["exact"]``). An error from running it is
    no verdict: the sweep lets it propagate."""
    if _faults.armed:
        try:
            _faults.maybe_fail("autotune-sweep")
        except Exception as err:  # noqa: BLE001 - an injected plan raises the type it was armed with
            return err
    row["exact"] = _outputs_match(ref_out, out, v.tolerance)
    if row["exact"]:
        return None
    return RuntimeFault(f"autotune variant {kernel}:{name} failed its exactness contract "
                        f"(tolerance={v.tolerance!r}) vs reference {reference!r}", site="autotune-sweep")


def _install(kernel: str, sc: str, winner: str) -> None:
    _SELECTIONS[(kernel, sc)] = winner
    _digest_cache[0] = None
    _counters["autotune_installs"] += 1
    if _telemetry.armed:
        _telemetry.emit("autotune-install", kernel, "autotune", time.perf_counter(), 0.0,
                        {"shape_class": sc, "variant": winner})
    _persist()


# --------------------------------------------------------------- persistence
_TABLE_FILE = "autotune_selections.json"
_TABLE_VERSION = 1


def _table_path() -> str:
    from metrics_tpu_torch.ops import progcache as _progcache

    return os.path.join(_progcache.cache_dir(), _TABLE_FILE)


def _table_stamp() -> Dict[str, Any]:
    from metrics_tpu_torch.ops import progcache as _progcache

    st = _progcache.stamp()
    return {"device": st["device"], "torch": st["torch_version"]}


def _persist() -> None:
    """Write the selection table into the program cache's store (atomic, CRC-stamped).
    Nothing while the store is off; a failure demotes, and the in-memory table serves on."""
    from metrics_tpu_torch.ops import progcache as _progcache

    if not _progcache.enabled():
        return
    try:
        sel_blob = json.dumps(selection_table(), sort_keys=True)
        doc = {"magic": "MTAT", "version": _TABLE_VERSION, **_table_stamp(), "selections": json.loads(sel_blob),
               "crc": zlib.crc32(sel_blob.encode())}
        path = _table_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _counters["autotune_persists"] += 1
    except Exception as err:  # noqa: BLE001 - persistence is best effort
        _faults.demote(
            _PERSIST_WARN_OWNER, "autotune", err, default_domain="journal", site="autotune-sweep",
            warn=f"could not persist the autotune selection table ({type(err).__name__}: {str(err)[:120]}); "
            "selections stay in-memory only",
        )


def _maybe_restore() -> None:
    """Load the persisted table at an armed process's first consult (a warm boot sweeps
    nothing). A corrupt table demotes and is ignored; another card's or torch's is a cold start."""
    if _restore_state[0]:
        return
    _restore_state[0] = True
    from metrics_tpu_torch.ops import progcache as _progcache

    if not _progcache.enabled():
        return
    path = _table_path()
    if not os.path.exists(path):
        return
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if doc.get("magic") != "MTAT" or int(doc.get("version", -1)) != _TABLE_VERSION:
            raise JournalFault(f"autotune selection table {path} has unknown framing "
                               f"(magic={doc.get('magic')!r}, version={doc.get('version')!r})", site="autotune-sweep")
        selections = doc.get("selections", {})
        if zlib.crc32(json.dumps(selections, sort_keys=True).encode()) != int(doc.get("crc", -1)):
            raise JournalFault(f"autotune selection table {path} CRC mismatch", site="autotune-sweep")
        if any(doc.get(k) != v for k, v in _table_stamp().items()):
            return  # another card's winners: sweep fresh, never mis-serve
        restored = 0
        for key, variant in selections.items():
            kernel, _, sc = key.partition("|")
            if not kernel or not sc:
                continue
            _SELECTIONS[(kernel, sc)] = str(variant)
            _SWEPT.add((kernel, sc))
            restored += 1
        if restored:
            _digest_cache[0] = None
            _counters["autotune_restores"] += restored
    except Exception as err:  # noqa: BLE001 - a suspect table is never served
        _faults.demote(
            _OWNER, "autotune", err, default_domain="journal", site="autotune-sweep",
            warn=f"could not restore the autotune selection table ({type(err).__name__}: {str(err)[:120]}); "
            "sweeping fresh",
        )
