"""The dispatch engine in PyTorch's eager terms: cached step programs and deferred dispatch.

JAX counterpart: `metrics_tpu/ops/engine.py`. PyTorch runs eagerly, so a
"program" here is an eager step function, not a compiled one. What the engine
does for a user stays, under the JAX package's names and counters:

- :func:`acquire` / :func:`acquire_keyed` (`:722-790`): a cross-instance cache
  of step programs keyed by ``(kind, config fingerprint, extras)``, with an LRU
  of 256 and the ``compile`` fault site on a miss. A second instance of the
  same configuration builds nothing (``builds``/``hits`` in
  :func:`engine_stats`). A step program takes its owner as an argument, so
  the cache never keeps the acquiring instance alive.
- :class:`Executable` (`:324-706`): one cached step. ``compiled_signatures``
  counts the distinct input signatures it has run, the counterpart of jit's
  signature cache. Every Nth run (``METRICS_TPU_DEVICE_PROBE_EVERY=N``,
  :func:`set_device_probe`) synchronises the device and records the
  device-inclusive wall in the ``device-dispatch:<program>`` family.
- Deferred dispatch (`:1297-1712`): under validation modes other than
  ``full``, an ``update`` or ``forward`` whose input signature has passed one
  eager call enqueues into a :class:`PendingQueue` instead of running. The
  queue copies every input tensor at enqueue (a caller may reuse its buffer;
  1 GiB of copies flushes it),
  pops the owner's states out of its ``__dict__`` (so any read of a state
  flushes, in enqueue order), and flushes in :func:`pow2_chunks` chunks at
  ``METRICS_TPU_DEFER_MAX`` entries, at ``METRICS_TPU_DEFER_AGE_MS`` of age
  (checked at the next enqueue) or at the next observation. ``forward``
  returns a :class:`LazyValue`. A flush runs the same eager code the per-call
  path runs, step by step, so its states equal the per-call ones bit for bit.

What the JAX engine has that this one has not: buffer donation (no eager op
consumes its input: :func:`donation_supported` answers False) and XLA's
cost analysis, persistent cache and warm-up (``program_report``,
``program_summary``, ``roofline_peaks``, ``warm_programs``), which come with
the program cache and the autotuner.
"""
from __future__ import annotations

import enum
import hashlib
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry

__all__ = [
    "Executable",
    "LazyValue",
    "PendingQueue",
    "acquire",
    "acquire_keyed",
    "config_fingerprint",
    "defer_enabled",
    "defer_max_age_s",
    "defer_max_pending",
    "device_probe_every",
    "donation_supported",
    "engine_stats",
    "export_trace",
    "flush_barrier",
    "pow2_chunks",
    "reset_engine",
    "reset_stats",
    "set_deferred_dispatch",
    "set_device_probe",
]


def donation_supported() -> bool:
    """Whether a step consumes its state buffers in place of copying them.

    Always False: an eager PyTorch op never consumes its input, so there is
    nothing for the ``donation`` fault site to fire on. In-place state
    updates come with the CUDA-graph lane (ROADMAP)."""
    return False


# ---------------------------------------------------------- device-time probes
class _EngineWarnOwner:
    """Warn-once anchor for this module's environment-knob warnings."""


_ENV_WARN_OWNER = _EngineWarnOwner()

#: resolved ``METRICS_TPU_DEVICE_PROBE_EVERY`` (None: not read yet; 0: off)
_probe_every: Optional[int] = None
_probe_countdown: List[int] = [0]


def device_probe_every() -> int:
    """The device-probe period: every Nth :class:`Executable` run synchronises
    its device and lands the device-inclusive wall in the
    ``device-dispatch:<program>`` family (``METRICS_TPU_DEVICE_PROBE_EVERY=N``).

    0 or unset (the default) disarms the probe: a run pays one integer
    compare. A value that is not an integer warns once and leaves it off."""
    global _probe_every
    if _probe_every is None:
        raw = os.environ.get("METRICS_TPU_DEVICE_PROBE_EVERY")
        if raw is None or not raw.strip():
            _probe_every = 0
        else:
            try:
                _probe_every = max(0, int(raw))
            except ValueError:
                _probe_every = 0
                _faults.warn_fault(
                    _ENV_WARN_OWNER,
                    "env:METRICS_TPU_DEVICE_PROBE_EVERY",
                    f"METRICS_TPU_DEVICE_PROBE_EVERY={raw!r} is not an integer; device-time probes stay OFF.",
                )
    return _probe_every


def set_device_probe(every: Optional[int]) -> None:
    """Set the probe period at run time (0 disarms; None re-reads the
    environment at the next run). Takes precedence over the environment."""
    global _probe_every
    _probe_every = None if every is None else max(0, int(every))
    _probe_countdown[0] = 0


# ----------------------------------------------------------------- fingerprints
def _value_digest(value: Any, depth: int = 0) -> Any:
    """A digest of one hyperparameter that two different values never share.

    Tensors and arrays digest by their full content (a repr truncates long
    arrays); an enum by its value (a journal restores enum hyperparameters as
    plain values); a ``torch.Generator`` by its device type (a sampler's
    stream is not configuration); containers recurse, three levels deep;
    anything else by its repr."""
    if isinstance(value, enum.Enum):
        return _value_digest(value.value, depth)
    if isinstance(value, torch.Generator):  # a sampler's stream, not what a step computes
        return ("generator", value.device.type)
    if isinstance(value, torch.Tensor):
        flat = value.detach().reshape(-1).contiguous().cpu()
        raw = flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
        return ("array", tuple(value.shape), str(value.dtype), hashlib.sha1(raw).hexdigest())
    if isinstance(value, (np.ndarray, np.generic)):
        host = np.ascontiguousarray(value)
        return ("array", host.shape, str(host.dtype), hashlib.sha1(host.tobytes()).hexdigest())
    if depth < 3 and isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_value_digest(v, depth + 1) for v in value))
    if depth < 3 and isinstance(value, dict):
        return ("dict", tuple(sorted((repr(k), _value_digest(v, depth + 1)) for k, v in value.items())))
    return repr(value)


_FINGERPRINT_SKIP = ("update", "compute", "compute_on_cpu", "process_group", "dist_sync_fn", "training")


def config_fingerprint(metric: Any) -> tuple:
    """A hashable digest of everything that decides what a metric's step computes.

    The class, every public attribute that is not a state (tensors and arrays
    by content, see :func:`_value_digest`), the state registry (names,
    reduction specs, default shapes and dtypes) and, recursively, every child
    metric. The transport knobs are left out: they decide whether a sync runs,
    not what a step computes."""
    cls = type(metric)
    defaults = getattr(metric, "_defaults", {})
    attrs = tuple(
        (k, _value_digest(v))
        for k, v in sorted(metric.__dict__.items())
        if not k.startswith("_") and k not in defaults and k not in _FINGERPRINT_SKIP
    )
    states = tuple(
        (
            name,
            metric._reduction_specs.get(name),
            "list" if isinstance(default, list) else (tuple(default.shape), str(default.dtype)),
        )
        for name, default in sorted(defaults.items())
    )
    children = tuple((name, config_fingerprint(child)) for name, child in metric._named_child_metrics())
    return (cls.__module__, cls.__qualname__, attrs, states, children)


def _call_signature(tree: Any) -> Any:
    """What a run's one-time costs depend on: the shapes, dtypes and devices of
    its tensors, the values of its flags and strings, the types of its numbers
    (an update count changes every run) and of its other objects."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_call_signature(v) for v in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _call_signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, np.ndarray):
        return (tree.shape, str(tree.dtype))
    if tree is None or isinstance(tree, (bool, str)):
        r = repr(tree)
        return r if len(r) <= 64 else hash(r)
    return type(tree).__qualname__


def _call_device(tree: Any) -> Optional[torch.device]:
    """The device of the first tensor in a call (None when it holds none)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = _call_device(v)
            if d is not None:
                return d
    elif isinstance(tree, dict):
        for v in tree.values():
            d = _call_device(v)
            if d is not None:
                return d
    return None


# --------------------------------------------------------------- program cache
_SIGNATURE_CAP = 4096


class Executable:
    """One cached step program: ``step(state, *args, **kwargs)``.

    ``state`` is the object whose states the step advances (a metric, or a
    collection); the step keeps no reference to it. Each run counts in
    ``runs``; ``compiled_signatures()`` is the number of distinct input
    signatures run so far. A run of a signature seen before is the one the
    device probe may sample (a first run pays one-time costs, as a compile
    does in the JAX package)."""

    __slots__ = ("step", "kind", "key_digest", "probe_key", "hits", "runs", "_signatures", "__weakref__")

    def __init__(self, step: Callable):
        self.step = step
        self.kind = "anonymous"
        self.key_digest = ""
        self.probe_key = "anonymous"
        self.hits = 0
        self.runs = 0
        self._signatures: "OrderedDict[Any, None]" = OrderedDict()

    def _dispatch(self, state: Any, args: tuple, kwargs: dict, record_span: bool) -> Any:
        every = _probe_every if _probe_every is not None else device_probe_every()
        sig = _call_signature((args, kwargs))
        new = sig not in self._signatures
        if new:
            self._signatures[sig] = None
            while len(self._signatures) > _SIGNATURE_CAP:
                self._signatures.popitem(last=False)
        t0 = time.perf_counter()
        out = self.step(state, *args, **kwargs)
        self.runs += 1
        host_dur = time.perf_counter() - t0
        if _telemetry.armed:
            if new:
                _telemetry.emit("engine-compile", self.kind, "engine", t0, host_dur, {"signature": len(self._signatures)})
            elif record_span:
                # ends when the launches return, not when the device finishes
                _telemetry.emit("engine-dispatch", self.kind, "engine", t0, host_dur, {"async_host_wall": True})
        if every and not new:
            n = _probe_countdown[0] + 1
            if n >= every:
                n = 0
                device = _call_device((args, kwargs))
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
                _stats["device_probes"] += 1
                _telemetry.observe_device_dispatch(self.probe_key, t0, time.perf_counter() - t0)
            _probe_countdown[0] = n
        return out

    def __call__(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        return self._dispatch(state, args, kwargs, record_span=False)

    def run(self, state: Any, args: tuple = (), kwargs: Optional[dict] = None) -> Any:
        """Run the step on ``state`` with ``args``/``kwargs`` (a dispatch span when armed)."""
        return self._dispatch(state, args, kwargs or {}, record_span=True)

    def compiled_signatures(self) -> int:
        """The distinct input signatures this program has run."""
        return len(self._signatures)


_PROGRAM_CACHE: "OrderedDict[tuple, Executable]" = OrderedDict()
_CACHE_CAP = 256
_stats = {
    "builds": 0,
    "hits": 0,
    "device_probes": 0,
    "deferred_steps": 0,
    "deferred_flushes": 0,
    "deferred_fallbacks": 0,
    "deferred_sync_barrier_flushes": 0,
}


def acquire(owner: Any, kind: str, build: Callable[[], Callable], *, extra_key: tuple = ()) -> Executable:
    """The step program of ``kind`` for ``owner``'s configuration, built once.

    ``build()`` returns the step, which takes the state owner as its first
    argument and must not close over ``owner``. Cached under ``(kind,
    config_fingerprint(owner), *extra_key)``."""
    return acquire_keyed((kind, config_fingerprint(owner)) + tuple(extra_key), build)


def acquire_keyed(key: tuple, build: Callable[[], Callable]) -> Executable:
    """:func:`acquire` under a key the caller assembles (a collection keys by its members' fingerprints)."""
    exe = _PROGRAM_CACHE.get(key)
    if exe is not None:
        _stats["hits"] += 1
        exe.hits += 1
        _PROGRAM_CACHE.move_to_end(key)
        return exe
    # the "compile" fault site fires on a miss only: a hit builds nothing
    if _faults.armed:
        _faults.maybe_fail("compile")
    _stats["builds"] += 1
    t0 = time.perf_counter()
    exe = Executable(build())
    exe.kind = str(key[0])
    exe.key_digest = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
    exe.probe_key = f"{exe.kind}:{exe.key_digest[:8]}"
    if _telemetry.armed:
        _telemetry.emit("engine-build", exe.kind, "engine", t0, time.perf_counter() - t0, {"key": exe.key_digest})
    _PROGRAM_CACHE[key] = exe
    while len(_PROGRAM_CACHE) > _CACHE_CAP:
        _PROGRAM_CACHE.popitem(last=False)
    return exe


def engine_stats() -> Dict[str, Any]:
    """The engine's counters under the JAX package's names: ``builds`` (programs
    built), ``hits`` (acquisitions served from the cache), ``cached`` (live),
    ``deferred_steps`` (calls enqueued), ``deferred_flushes`` (queues flushed),
    ``deferred_fallbacks`` (flushes replayed eagerly),
    ``deferred_sync_barrier_flushes`` (queues flushed by :func:`flush_barrier`)
    and ``device_probes``; then the fault, sync and journal planes' counters,
    the streaming plane's ``window_*``/``drift_*``, the functional core's
    ``funcore_*``, the arenas' ``arena_*`` and the gateway's ``ingest_*``."""
    from metrics_tpu_torch import arena as _arena
    from metrics_tpu_torch import functional_core as _funcore
    from metrics_tpu_torch import ingest as _ingest
    from metrics_tpu_torch import streaming as _streaming
    from metrics_tpu_torch.ops import journal as _journal
    from metrics_tpu_torch.parallel import sync as _psync

    out: Dict[str, Any] = {
        "builds": _stats["builds"],
        "hits": _stats["hits"],
        "cached": len(_PROGRAM_CACHE),
        "deferred_steps": _stats["deferred_steps"],
        "deferred_flushes": _stats["deferred_flushes"],
        "deferred_fallbacks": _stats["deferred_fallbacks"],
        "deferred_sync_barrier_flushes": _stats["deferred_sync_barrier_flushes"],
        "device_probes": _stats["device_probes"],
    }
    out.update(_faults.fault_stats())
    out.update(_psync.collective_stats())
    out.update(_journal.journal_stats())
    out.update(_streaming.streaming_stats())
    out.update(_funcore.funcore_stats())
    out.update(_arena.arena_stats())
    out.update(_ingest.ingest_stats())
    return out


def export_trace(path: str) -> int:
    """The recorded spans as Chrome-trace/Perfetto JSON (:func:`metrics_tpu_torch.ops.telemetry.export_trace`)."""
    return _telemetry.export_trace(path)


def _zero_engine_counters() -> None:
    for key in _stats:
        _stats[key] = 0


_telemetry.register_reset("engine", _zero_engine_counters)


def reset_stats(reset_warnings: bool = False) -> None:
    """Zero every counter :func:`engine_stats` reports, and the span ring, keeping
    every cached program and the monotonic step (one walk of the telemetry
    reset registry). ``reset_warnings=True`` also clears the warn-once marks."""
    from metrics_tpu_torch.ops import journal as _journal  # noqa: F401 - registers its reset
    from metrics_tpu_torch.parallel import sync as _psync  # noqa: F401 - registers its reset

    _telemetry.reset_all(reset_warnings=reset_warnings)


def reset_engine() -> None:
    """Drop every cached program and zero the counters."""
    _PROGRAM_CACHE.clear()
    reset_stats()


def flush_barrier(owners) -> int:
    """Flush every owner's pending work before something observes them all: the
    sync's pack, an async sync's force, the journal, a tracker's history. Each
    distinct queue flushes once even where owners share one; then each owner's
    host buffers fold. Runs on the caller's thread. Returns the queues flushed
    (counted in ``deferred_sync_barrier_flushes``)."""
    seen = set()
    flushed = 0
    for owner in owners:
        q = owner.__dict__.get("_defer_pending")
        if q is not None and id(q) not in seen:
            seen.add(id(q))
            flushed += 1
        owner._defer_barrier()
    if flushed:
        _stats["deferred_sync_barrier_flushes"] += flushed
    return flushed


# ------------------------------------------------------------- deferred dispatch
_defer_enabled: Optional[bool] = None  # resolved from METRICS_TPU_DEFER at first use
_defer_max_pending: Optional[int] = None
_defer_max_age_s: Optional[float] = None


def defer_enabled() -> bool:
    """Whether eligible calls enqueue instead of running (``METRICS_TPU_DEFER``, on by default)."""
    global _defer_enabled
    if _defer_enabled is None:
        _defer_enabled = os.environ.get("METRICS_TPU_DEFER", "1") not in ("0", "false", "off")
    return _defer_enabled


def defer_max_pending() -> int:
    """Entries that flush a queue (``METRICS_TPU_DEFER_MAX``, default 128)."""
    global _defer_max_pending
    if _defer_max_pending is None:
        try:
            _defer_max_pending = max(1, int(os.environ.get("METRICS_TPU_DEFER_MAX", "128")))
        except ValueError:
            _defer_max_pending = 128
    return _defer_max_pending


def defer_max_age_s() -> float:
    """A queue's age that flushes it at its next enqueue (``METRICS_TPU_DEFER_AGE_MS``,
    default 250 ms). No thread watches the clock: an observation flushes regardless."""
    global _defer_max_age_s
    if _defer_max_age_s is None:
        try:
            _defer_max_age_s = max(0.0, float(os.environ.get("METRICS_TPU_DEFER_AGE_MS", "250"))) / 1000.0
        except ValueError:
            _defer_max_age_s = 0.25
    return _defer_max_age_s


def set_deferred_dispatch(enabled: Optional[bool] = None, *, max_pending: Optional[int] = None,
                          max_age_ms: Optional[float] = None) -> None:
    """Set the deferral policy at run time (None leaves a knob as it is; takes
    precedence over the environment). Queues already open are not flushed:
    turning deferral off stops new enqueues only."""
    global _defer_enabled, _defer_max_pending, _defer_max_age_s
    if enabled is not None:
        _defer_enabled = bool(enabled)
    if max_pending is not None:
        _defer_max_pending = max(1, int(max_pending))
    if max_age_ms is not None:
        _defer_max_age_s = max(0.0, float(max_age_ms)) / 1000.0


def pow2_chunks(n: int) -> List[int]:
    """Power-of-two chunk lengths covering ``n`` steps in order (23 -> [16, 4, 2, 1])."""
    out = []
    while n:
        c = 1 << (n.bit_length() - 1)
        out.append(c)
        n -= c
    return out


#: The device bytes of a queue's input copies that flush it at the next enqueue: the copies
#: are the queue's cost in memory (at the headline shape 128 calls hold 0.55 GB; a call of
#: a (2, 19, 1024, 2048) segmentation batch holds 0.32 GB on its own).
QUEUE_MAX_BYTES = 1 << 30


def _copy_leaf(value: Any, sizes: List[int]) -> Any:
    if isinstance(value, torch.Tensor):
        sizes.append(value.numel() * value.element_size())
        return value.detach().clone()
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, tuple)):
        return type(value)(_copy_leaf(v, sizes) for v in value)
    if isinstance(value, dict):
        return {k: _copy_leaf(v, sizes) for k, v in value.items()}
    return value


class PendingQueue:
    """One owner's (or one suite's) queue of deferred calls of one kind and signature.

    ``entries`` holds each call's copied ``(args, kwargs)`` in order,
    ``handles`` the :class:`LazyValue` of each forward entry (None for an
    update). ``backing`` maps ``id(owner)`` to the states popped out of that
    owner's ``__dict__`` while the queue is pending: a read of any of them
    reaches the owner's ``__getattr__``, which flushes. ``flush_fn(queue)`` is
    the owner's; it releases the states before it runs the entries."""

    __slots__ = ("kind", "signature", "entries", "handles", "nbytes", "backing", "owners", "flush_fn", "created",
                 "meta", "_flushing")

    def __init__(self, kind: str, signature: Any, flush_fn: Callable[["PendingQueue"], None]):
        self.kind = kind
        self.signature = signature
        self.entries: list = []
        self.handles: list = []
        self.nbytes = 0  # the tensor bytes of the entries' copies
        self.backing: Dict[int, Dict[str, Any]] = {}
        self.owners: list = []
        self.flush_fn: Optional[Callable[["PendingQueue"], None]] = flush_fn
        self.created = time.monotonic()
        self.meta: Any = None  # the creator's context (a suite's members)
        self._flushing = False

    def adopt(self, owner: Any, state_names: Any) -> None:
        """Pop ``owner``'s states into the backing store and mark the owner pending."""
        d = owner.__dict__
        self.backing[id(owner)] = {name: d.pop(name) for name in state_names if name in d}
        self.owners.append(owner)
        object.__setattr__(owner, "_defer_pending", self)

    def enqueue(self, args: tuple, kwargs: dict, handle: Any = None) -> None:
        """Queue one call with its own copy of its inputs (a caller may write into
        its tensors once the call returns, and the step must see what the call saw)."""
        sizes: List[int] = []
        with torch.no_grad():
            self.entries.append((_copy_leaf(args, sizes), _copy_leaf(kwargs, sizes)))
        self.handles.append(handle)
        self.nbytes += sum(sizes)
        note_deferred_steps(1)

    def has_state(self, owner: Any, name: str) -> bool:
        b = self.backing.get(id(owner))
        return b is not None and name in b

    def matches(self, kind: str, signature: Any) -> bool:
        return self.kind == kind and self.signature == signature

    def should_flush(self) -> bool:
        return (len(self.entries) >= defer_max_pending() or self.nbytes >= QUEUE_MAX_BYTES
                or (time.monotonic() - self.created) > defer_max_age_s())

    def release(self) -> None:
        """Put the backing states back and clear the pending marks, without running anything."""
        for owner in self.owners:
            taken = self.backing.pop(id(owner), None)
            if taken:
                for name, value in taken.items():
                    object.__setattr__(owner, name, value)
            if owner.__dict__.get("_defer_pending") is self:
                object.__setattr__(owner, "_defer_pending", None)
        self.owners = []

    def flush(self) -> None:
        """Run the queued calls (once: a flush reached from inside this flush, or
        of a drained queue, does nothing)."""
        if self._flushing or self.flush_fn is None:
            return
        fn, self.flush_fn = self.flush_fn, None
        self._flushing = True
        t0 = time.perf_counter() if _telemetry.armed else 0.0
        owner_label = type(self.owners[0]).__name__ if self.owners else None
        n_entries = len(self.entries)
        try:
            fn(self)
        finally:
            self._flushing = False
            self.release()  # a no-op where the flush already released
            if t0 and _telemetry.armed:
                _telemetry.emit("engine-flush", owner_label, "defer", t0, time.perf_counter() - t0,
                                {"kind": self.kind, "entries": n_entries})


def _force_tree(tree: Any) -> Any:
    if isinstance(tree, LazyValue):
        return tree._force()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_force_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _force_tree(v) for k, v in tree.items()}
    return tree


class LazyValue:
    """A deferred ``forward``'s batch value: its queue flushes when the value is read.

    Reading is anything that needs the value: a torch function or operator
    (``torch.add(h, 1)``, ``h + t``, ``torch.stack([h, ...])``, through
    ``__torch_function__``), ``float()``/``int()``/``bool()``, ``np.asarray``,
    indexing, or an attribute (``.shape``, ``.cpu()``). Until then the handle
    holds nothing. A copy or a pickle of a handle forces it and carries the
    value. Like the tensor it stands for, a handle does not hash.
    """

    __slots__ = ("_queue", "_value", "_ready")

    def __init__(self, queue: Optional[PendingQueue]):
        self._queue = queue
        self._value = None
        self._ready = False

    def _set_value(self, value: Any) -> None:
        self._value = value
        self._ready = True
        self._queue = None

    def _force(self) -> Any:
        if not self._ready:
            q = self._queue
            if q is not None:
                q.flush()
            if not self._ready:
                raise RuntimeError(
                    "deferred forward value was never resolved (its metric's queue was dropped without a flush)"
                )
        return self._value

    def __reduce__(self):
        q = self._queue
        if not self._ready and q is not None and q._flushing:
            return (LazyValue, (None,))  # copied mid-flush: a detached stub, never read
        return (_resolved_lazy_value, (self._force(),))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_force_tree(args), **_force_tree(kwargs or {}))

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(self._force(), name)

    def __array__(self, dtype=None, copy=None):
        value = self._force()
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self._force())

    def __int__(self):
        return int(self._force())

    def __bool__(self):
        return bool(self._force())

    def __index__(self):
        return self._force().__index__()

    def __len__(self):
        return len(self._force())

    def __iter__(self):
        return iter(self._force())

    def __getitem__(self, item):
        return self._force()[item]

    def __repr__(self):
        return repr(self._force())

    def __format__(self, spec):
        return format(self._force(), spec)

    __hash__ = None  # type: ignore[assignment]

    def __eq__(self, other):
        return self._force() == _force_tree(other)

    def __ne__(self, other):
        return self._force() != _force_tree(other)

    def __lt__(self, other):
        return self._force() < _force_tree(other)

    def __le__(self, other):
        return self._force() <= _force_tree(other)

    def __gt__(self, other):
        return self._force() > _force_tree(other)

    def __ge__(self, other):
        return self._force() >= _force_tree(other)

    def __add__(self, other):
        return self._force() + _force_tree(other)

    def __radd__(self, other):
        return other + self._force()

    def __sub__(self, other):
        return self._force() - _force_tree(other)

    def __rsub__(self, other):
        return other - self._force()

    def __mul__(self, other):
        return self._force() * _force_tree(other)

    def __rmul__(self, other):
        return other * self._force()

    def __truediv__(self, other):
        return self._force() / _force_tree(other)

    def __rtruediv__(self, other):
        return other / self._force()

    def __floordiv__(self, other):
        return self._force() // _force_tree(other)

    def __rfloordiv__(self, other):
        return other // self._force()

    def __mod__(self, other):
        return self._force() % _force_tree(other)

    def __rmod__(self, other):
        return other % self._force()

    def __pow__(self, other):
        return self._force() ** _force_tree(other)

    def __rpow__(self, other):
        return other ** self._force()

    def __matmul__(self, other):
        return self._force() @ _force_tree(other)

    def __rmatmul__(self, other):
        return other @ self._force()

    def __neg__(self):
        return -self._force()

    def __pos__(self):
        return +self._force()

    def __abs__(self):
        return abs(self._force())


def _resolved_lazy_value(value: Any) -> LazyValue:
    """Rebuild a copied or pickled handle: detached and resolved."""
    lv = LazyValue(None)
    lv._set_value(value)
    return lv


def note_deferred_steps(n: int) -> None:
    _stats["deferred_steps"] += n
    if _telemetry.armed:
        _telemetry.emit("engine-enqueue", None, "defer")


def note_deferred_flush(fallback: bool = False) -> None:
    _stats["deferred_flushes"] += 1
    if fallback:
        _stats["deferred_fallbacks"] += 1
