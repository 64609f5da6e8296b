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

- The program ledger (`:895-1190`): :func:`program_report` and
  :func:`program_summary`, one row per program with JAX's columns, and the
  roofline join against :func:`roofline_peaks` with JAX's bound classes and
  thresholds. Without XLA's cost analysis the facts are counted in PyTorch's
  terms (:func:`_analyze`): FLOPs by ``FlopCounterMode``, bytes by a
  dispatch mode over every operator (the hand bincount reports its own), the
  peak by the caching allocator, from one run on zero-filled inputs and a
  copy of the state, once a signature. Device times come from the probes.
- The persistent tier (:mod:`.progcache`): a program's first run of a
  signature stores its abstract signature (:func:`encode_call`) or counts a
  hit where the store holds it; :func:`warm_programs` runs the stored
  signatures not yet run.

What the JAX engine has that this one has not: buffer donation (no eager op
consumes its input: :func:`donation_supported` answers False).
"""
from __future__ import annotations

import copy
import enum
import hashlib
import json
import os
import sys
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import progcache as _progcache
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
    "program_report",
    "program_summary",
    "reset_engine",
    "reset_stats",
    "roofline_peaks",
    "set_deferred_dispatch",
    "set_device_probe",
    "set_roofline_peaks",
    "warm_programs",
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


class _Unencodable(TypeError):
    """A call leaf the abstract signature cannot describe (no analysis, no stored entry)."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _module_paths(owner: Any) -> Dict[int, str]:
    """``id(module) -> path`` of every module under ``owner`` (the owner itself at ``""``)."""
    if not isinstance(owner, torch.nn.Module):
        return {}
    return {id(m): name for name, m in owner.named_modules(remove_duplicate=False)}


def _encode_leaf(tree: Any, modules: Dict[int, str]) -> Any:
    if isinstance(tree, torch.Tensor):
        return {"t": [list(tree.shape), _dtype_name(tree.dtype), str(tree.device)]}
    if isinstance(tree, torch.nn.Module):
        if id(tree) not in modules:
            raise _Unencodable(f"a {type(tree).__name__} that is not part of the step's state")
        return {"m": modules[id(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"v": tree}
    if isinstance(tree, (list, tuple)):
        return {"l" if isinstance(tree, list) else "u": [_encode_leaf(v, modules) for v in tree]}
    if isinstance(tree, dict) and all(isinstance(k, str) for k in tree):
        return {"d": [[k, _encode_leaf(v, modules)] for k, v in tree.items()]}
    raise _Unencodable(f"a {type(tree).__name__} argument")


def encode_call(state: Any, args: tuple, kwargs: dict) -> Dict[str, Any]:
    """The abstract signature of one run, as JSON-ready data: every tensor as its
    shape, dtype and device, every module of the state owner by its path in the
    owner, Python scalars and strings by value, containers recursively. Raises
    :class:`TypeError` for a leaf it cannot describe (the run is then neither
    analysed nor stored)."""
    modules = _module_paths(state)
    return {
        "state": "none" if state is None else ("module" if modules else "object"),
        "args": _encode_leaf(list(args), modules),
        "kwargs": _encode_leaf(dict(kwargs), modules),
    }


def _typed(enc: Any) -> Any:
    """``enc`` with numbers by type (an update count changes every run): what the signature digest reads."""
    if isinstance(enc, dict):
        if "v" in enc and isinstance(enc["v"], (int, float)) and not isinstance(enc["v"], bool):
            return {"v": type(enc["v"]).__name__}
        return {k: _typed(v) for k, v in enc.items()}
    if isinstance(enc, list):
        return [_typed(v) for v in enc]
    return enc


def signature_digest(encoded: Dict[str, Any]) -> str:
    """Stable digest of an :func:`encode_call` signature, the same in every process."""
    return hashlib.sha1(json.dumps(_typed(encoded), sort_keys=True).encode()).hexdigest()[:16]


def _decode_leaf(enc: Any, owner: Any) -> Any:
    if "t" in enc:
        shape, dtype, device = enc["t"]
        return torch.zeros(tuple(shape), dtype=getattr(torch, dtype), device=device)
    if "m" in enc:
        return owner.get_submodule(enc["m"]) if enc["m"] else owner
    if "v" in enc:
        return enc["v"]
    if "l" in enc:
        return [_decode_leaf(v, owner) for v in enc["l"]]
    if "u" in enc:
        return tuple(_decode_leaf(v, owner) for v in enc["u"])
    return {k: _decode_leaf(v, owner) for k, v in enc["d"]}


def decode_call(encoded: Dict[str, Any], owner: Any) -> Tuple[tuple, dict]:
    """``(args, kwargs)`` of an :func:`encode_call` signature: zero-filled tensors, and
    the modules of ``owner`` (a copy of the state) where the run had the original's."""
    return tuple(_decode_leaf(encoded["args"], owner)), _decode_leaf(encoded["kwargs"], owner)


def _copy_owner(owner: Any) -> Any:
    """A throwaway copy of a step's state owner: its states are never touched."""
    if owner is None:
        return None
    if hasattr(owner, "_defer_barrier"):
        flush_barrier([owner])
    return copy.deepcopy(owner)


class Executable:
    """One cached step program: ``step(state, *args, **kwargs)``.

    ``state`` is the object whose states the step advances (a metric, or a
    collection); the step keeps no reference to it, the program a weak one to
    the last state it ran (the ledger's analysis and :func:`warm_programs` run
    on copies of it). Each run counts in ``runs`` (all ``plain_runs``: nothing
    is donated); ``compiled_signatures()`` is the number of distinct input
    signatures run so far. The first run of a signature is the program's
    counterpart of a compile: its wall lands in ``compile_time_s`` (or, served
    from the persistent store, in ``cache_load_time_s``), and the device probe
    never samples it. Later runs add their host wall to ``dispatch_time_s``."""

    __slots__ = ("step", "kind", "key_digest", "probe_key", "hits", "runs", "_signatures", "compiles",
                 "compile_time_s", "cache_load_time_s", "cache_source", "dispatch_time_s", "variant", "arg_structs",
                 "analysis", "analysis_failed", "pc_sigs", "_digests", "_owner_ref", "__weakref__")

    def __init__(self, step: Callable):
        self.step = step
        self.kind = "anonymous"
        self.key_digest = ""
        self.probe_key = "anonymous"
        self.hits = 0
        self.runs = 0
        self._signatures: "OrderedDict[Any, None]" = OrderedDict()
        self.compiles = 0
        self.compile_time_s = 0.0
        self.cache_load_time_s = 0.0
        self.cache_source: Optional[str] = None
        self.dispatch_time_s = 0.0
        self.variant: Optional[str] = None
        self.arg_structs: Optional[Dict[str, Any]] = None  # the newest signature, abstract
        self.analysis: Optional[Dict[str, Any]] = None
        self.analysis_failed = False
        self.pc_sigs: Optional[set] = None  # signature digests the persistent store holds
        self._digests: set = set()  # digests of the signatures this process has run
        self._owner_ref: Optional[Callable[[], Any]] = None

    @property
    def plain_runs(self) -> int:
        return self.runs

    @property
    def donated_runs(self) -> int:
        return 0

    def _capture(self, state: Any, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
        """Remember this new signature for the ledger (memos dropped) and the owner it ran on."""
        self.analysis, self.analysis_failed = None, False
        try:
            self._owner_ref = (lambda: None) if state is None else weakref.ref(state)
        except TypeError:
            self._owner_ref = None
        try:
            self.arg_structs = encode_call(state, args, kwargs)
        except TypeError:
            self.arg_structs = None
        return self.arg_structs

    def _first_run(self, state: Any, args: tuple, kwargs: dict) -> Any:
        encoded = self._capture(state, args, kwargs)
        sig = None
        loaded = False
        if encoded is not None and _progcache.enabled():
            self._attach_cache_lane()
            sig = signature_digest(encoded)
            self._digests.add(sig)
            if sig in self.pc_sigs:
                loaded = _progcache.load_program(self.kind, self.key_digest, sig) is not None
                if not loaded:
                    self.pc_sigs.discard(sig)
        _first_runs[0] += 1
        t0 = time.perf_counter()
        try:
            if loaded:
                out = self.step(state, *args, **kwargs)
            else:
                with _telemetry.trace_range("engine-compile", self.kind):
                    out = self.step(state, *args, **kwargs)
        finally:
            _first_runs[0] -= 1
        dur = time.perf_counter() - t0
        self.runs += 1
        if _autotune_note is not None:
            _autotune_note(self)
        if loaded:
            self.cache_load_time_s += dur
            self.cache_source = "progcache"
        else:
            self.compiles += 1
            self.compile_time_s += dur
            if _telemetry.armed:
                _telemetry.emit("engine-compile", self.kind, "engine", t0, dur, {"signature": len(self._signatures)})
            if sig is not None:
                _progcache.note_miss()
                if _progcache.store_program(self.kind, self.key_digest, sig, encoded) is not None:
                    self.pc_sigs.add(sig)
        return out

    def _dispatch(self, state: Any, args: tuple, kwargs: dict, record_span: bool) -> Any:
        sig = _call_signature((args, kwargs))
        if sig not in self._signatures:
            self._signatures[sig] = None
            while len(self._signatures) > _SIGNATURE_CAP:
                self._signatures.popitem(last=False)
            return self._first_run(state, args, kwargs)
        every = _probe_every if _probe_every is not None else device_probe_every()
        if state is not None and self._owner_ref is not None and self._owner_ref() is None:
            self._owner_ref = weakref.ref(state)  # the state it last ran died: follow the live one
        t0 = time.perf_counter()
        if record_span:
            with _telemetry.trace_range("engine-dispatch", self.kind):
                out = self.step(state, *args, **kwargs)
        else:
            out = self.step(state, *args, **kwargs)
        self.runs += 1
        host_dur = time.perf_counter() - t0
        self.dispatch_time_s += host_dur
        if record_span and _telemetry.armed:
            # ends when the launches return, not when the device finishes
            _telemetry.emit("engine-dispatch", self.kind, "engine", t0, host_dur, {"async_host_wall": True})
        if every:
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

    def _attach_cache_lane(self) -> None:
        """Index the signatures the persistent store holds for this program (once)."""
        if self.pc_sigs is None:
            self.pc_sigs = set(_progcache.stored_sigs(self.kind, self.key_digest))

    def warm_from_store(self) -> int:
        """Run every signature the persistent store holds for this program and this
        process has not run yet, once, on zero-filled inputs and a throwaway copy of
        the last state it ran: the one-time costs of those shapes (CUDA's lazy module
        loading, library handles, the allocator's blocks) are paid here instead of
        at the first served step. Each becomes a known signature, its wall
        ``cache_load_time_s``. Returns the signatures warmed."""
        if not _progcache.enabled():
            return 0
        self._attach_cache_lane()
        owner = self._owner_ref() if self._owner_ref is not None else None
        if owner is None and (self.arg_structs is None or self.arg_structs["state"] != "none"):
            return 0  # no live state to copy: the program's first real run warms it
        warmed = 0
        for sig in sorted(self.pc_sigs - self._digests):
            encoded = _progcache.load_program(self.kind, self.key_digest, sig)
            if encoded is None:
                self.pc_sigs.discard(sig)
                continue
            t0 = time.perf_counter()
            try:
                copy_state = _copy_owner(owner)
                args, kwargs = decode_call(encoded, copy_state)
                with torch.no_grad():
                    self.step(copy_state, *args, **kwargs)
                device = _call_device((args, kwargs))
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
            except Exception as err:  # noqa: BLE001 - a stored shape this configuration cannot run
                _progcache.note_unrunnable(self.kind, self.key_digest, sig, err)
                self.pc_sigs.discard(sig)
                continue
            self._signatures[_call_signature((args, kwargs))] = None
            self._digests.add(sig)
            self.cache_load_time_s += time.perf_counter() - t0
            self.cache_source = "progcache"
            warmed += 1
        return warmed


_PROGRAM_CACHE: "OrderedDict[tuple, Executable]" = OrderedDict()
_CACHE_CAP = 256
_stats = {
    "builds": 0,
    "hits": 0,
    "device_probes": 0,
    "program_analyses": 0,
    "deferred_steps": 0,
    "deferred_flushes": 0,
    "deferred_fallbacks": 0,
    "deferred_sync_barrier_flushes": 0,
}


#: First runs of a signature in progress (the autotuner's consults inside one name the program's variants).
_first_runs = [0]

#: The autotuner's hooks (``ops/autotune.py``), set only while it is armed: ``_autotune_key()``
#: is the selection table's digest, appended to every acquire key (an installed winner builds
#: new programs), and ``_autotune_note(exe)`` names the variants a first run consulted in the
#: program's ledger row. Both None while it is off: one predicate each.
_autotune_key: Optional[Callable[[], tuple]] = None
_autotune_note: Optional[Callable[[Any], None]] = None


def acquire(owner: Any, kind: str, build: Callable[[], Callable], *, extra_key: tuple = ()) -> Executable:
    """The step program of ``kind`` for ``owner``'s configuration, built once.

    ``build()`` returns the step, which takes the state owner as its first
    argument and must not close over ``owner``. Cached under ``(kind,
    config_fingerprint(owner), *extra_key)``."""
    return acquire_keyed((kind, config_fingerprint(owner)) + tuple(extra_key), build)


def acquire_keyed(key: tuple, build: Callable[[], Callable]) -> Executable:
    """:func:`acquire` under a key the caller assembles (a collection keys by its members' fingerprints)."""
    if _autotune_key is not None:
        key = key + _autotune_key()
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
    with _telemetry.timed("engine-build", str(key[0]), "engine", detail=str(key[0])) as span:
        exe = Executable(build())
        exe.kind = str(key[0])
        exe.key_digest = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
        exe.probe_key = f"{exe.kind}:{exe.key_digest[:8]}"
        span.attrs = {"key": exe.key_digest}
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
    ``device_probes`` and ``program_analyses``; then the fault, sync and journal
    planes' counters, the streaming plane's ``window_*``/``drift_*``, the
    functional core's ``funcore_*``, the arenas' ``arena_*``, the program
    cache's ``progcache_*``, the gateway's ``ingest_*``, the autotuner's
    ``autotune_*`` and, once the image stack is loaded, FID's ``fid_*``."""
    from metrics_tpu_torch import arena as _arena
    from metrics_tpu_torch import functional_core as _funcore
    from metrics_tpu_torch import ingest as _ingest
    from metrics_tpu_torch import streaming as _streaming
    from metrics_tpu_torch.ops import autotune as _autotune
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
        "program_analyses": _stats["program_analyses"],
    }
    out.update(_faults.fault_stats())
    out.update(_psync.collective_stats())
    out.update(_journal.journal_stats())
    out.update(_streaming.streaming_stats())
    out.update(_funcore.funcore_stats())
    out.update(_arena.arena_stats())
    out.update(_progcache.progcache_stats())
    out.update(_ingest.ingest_stats())
    out.update(_autotune.autotune_stats())
    # FID's host route counters, where the image stack is loaded (it is heavy)
    generative = sys.modules.get("metrics_tpu_torch.image.generative")
    if generative is not None:
        out.update(generative.fid_stats())
    return out


def warm_programs() -> int:
    """Run every signature the persistent store holds for every cached program,
    once, on zero-filled inputs and throwaway copies of the states (see
    :meth:`Executable.warm_from_store`): the rolling-restart warm boot. Acquire
    the suite's programs first (``MetricCollection.precompile`` drives the real
    call paths), then call this before traffic. 0 while the persistent cache
    is off. Returns the signatures warmed."""
    if not _progcache.enabled():
        return 0
    return sum(exe.warm_from_store() for exe in list(_PROGRAM_CACHE.values()))


# ------------------------------------------------------------- program ledger
class _ByteCounter(TorchDispatchMode):
    """Bytes every dispatched operator reads and writes: its tensor inputs and
    outputs, each counted once a call. Views move nothing and an uninitialised
    allocation writes nothing, so neither counts. The hand-written bincount
    kernels are launched through ctypes, past the dispatcher: their wrappers
    report their own bytes (ids and weights read, counts written) through
    :data:`metrics_tpu_torch.ops.histogram.BYTES_HOOK`."""

    _FREE = ("aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty", "aten::new_empty_strided")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.out_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False) or func._schema.name in self._FREE:
            return out
        written = _tensor_bytes(out)
        self.bytes += _tensor_bytes((args, kwargs)) + written
        self.out_bytes += written
        return out

    def add(self, nbytes: int) -> None:
        self.bytes += int(nbytes)


def _tensor_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return 0


def _state_bytes(owner: Any) -> int:
    """Bytes of every state tensor under ``owner`` (its own and its members')."""
    if owner is None:
        return 0
    mods = owner.modules() if isinstance(owner, torch.nn.Module) else (owner,)
    seen, total = set(), 0
    for m in mods:
        for name in getattr(m, "_defaults", {}):
            value = getattr(m, name, None)
            for t in value if isinstance(value, list) else [value]:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    total += t.numel() * t.element_size()
    return total


def _analyze(exe: Executable) -> Optional[Dict[str, Any]]:
    """The program's counted facts at its newest signature: FLOPs
    (``torch.utils.flop_counter.FlopCounterMode``), bytes accessed (every
    dispatched operator's tensor inputs and outputs, :class:`_ByteCounter`, and
    the bincount kernels' own count), argument, output and temporary bytes, and
    the peak: the caching allocator's peak above its start around the run on
    the card, arguments plus every operator output on the CPU (no frees
    counted: an upper bound). One run of the step on zero-filled inputs and a
    throwaway copy of the last state it ran: the owner's states are never
    touched. Never on a dispatch path; memoized per signature, a failure too
    (``program_analyses`` counts the analyses performed). ``None`` where the
    program cannot be analysed: no signature recorded, a run that raises, or
    no live state to copy (then nothing is memoized, and the next run of a
    live state makes the analysis possible)."""
    if exe.analysis is not None:
        return exe.analysis
    if exe.arg_structs is None or exe.analysis_failed or exe._owner_ref is None:
        return None
    owner = exe._owner_ref()
    if owner is None and exe.arg_structs["state"] != "none":
        return None  # the state it ran is gone: nothing to copy until a live one runs it
    _stats["program_analyses"] += 1
    from torch.utils.flop_counter import FlopCounterMode

    from metrics_tpu_torch.ops import histogram as _histogram

    try:
        state = _copy_owner(owner)
        args, kwargs = decode_call(exe.arg_structs, state)
        device = _call_device((args, kwargs))
        on_card = device is not None and device.type == "cuda"
        arg_b = _state_bytes(state) + _tensor_bytes((args, kwargs))
        counter = _ByteCounter()
        flops = FlopCounterMode(display=False)
        if on_card:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        previous_hook = _histogram.BYTES_HOOK
        _histogram.BYTES_HOOK = counter.add
        try:
            with torch.no_grad(), flops, counter:
                out = exe.step(state, *args, **kwargs)
        finally:
            _histogram.BYTES_HOOK = previous_hook
        out_b = _tensor_bytes(out)
        if on_card:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - base + arg_b
        else:
            peak = arg_b + counter.out_bytes
        exe.analysis = {
            "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes),
            "argument_bytes": int(arg_b),
            "output_bytes": int(out_b),
            "temp_bytes": int(max(0, peak - arg_b - out_b)),
            "generated_code_bytes": 0,
            "peak_bytes": int(peak),
        }
    except Exception:  # noqa: BLE001 - a report must never raise
        exe.analysis_failed = True  # memoized: no second attempt per report
        return None
    return exe.analysis


# ----------------------------------------------------------- roofline ledger
#: Utilization below which a probed program is bound by launch latency, by neither roof.
_DISPATCH_BOUND_UTILIZATION = 0.05
#: Share of the device-inclusive wall the host dispatch must reach for a program to be host-bound.
_HOST_BOUND_SHARE = 0.6

_roofline_peaks: Optional[Dict[str, Any]] = None

#: (matmul side, chained products, streamed float32 elements, adds) of the calibration, by device type
_CALIBRATION = {"cuda": (4096, 8, 1 << 26, 8), "cpu": (512, 4, 1 << 22, 4)}


def _best_of(fn: Callable[[], Any], device: torch.device, trials: int = 3) -> float:
    best = float("inf")
    for _ in range(trials):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def roofline_peaks(device: Optional[Any] = None) -> Dict[str, Any]:
    """The machine roofline this process classifies against, calibrated once and cached.

    JAX's method on the card: peak FLOP/s from a best-of-3 chain of 8 float32
    products of 4096 x 4096 matrices with TF32 off (under
    :func:`~metrics_tpu_torch.utils.compute.high_precision`; 1.1 TFLOP a
    trial), peak bytes/s from a best-of-3 run of 8 streaming adds over 2**26
    float32 (256 MiB read and 256 MiB written each), both timed on the host
    clock between two synchronizes. JAX's 384 x 384 chain and 32 MiB add
    would time the H100's launch latency. ``device`` None means the card;
    ``"cpu"`` calibrates the CPU at 512 x 512 and 2**22 floats. A calibration
    that fails (no card) gives ``calibrated=False``, and the reports fall back to
    classifying without peaks. ``ridge_flops_per_byte`` is the quotient of the
    two. Pin with :func:`set_roofline_peaks`."""
    global _roofline_peaks
    if _roofline_peaks is not None:
        return _roofline_peaks
    peaks: Dict[str, Any] = {"peak_flops_per_s": 0.0, "peak_bytes_per_s": 0.0, "ridge_flops_per_byte": 0.0,
                             "calibrated": False}
    try:
        from metrics_tpu_torch.utils.compute import high_precision

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        n, reps, m, adds = _CALIBRATION["cuda" if dev.type == "cuda" else "cpu"]
        a = torch.full((n, n), 1.0 / n, dtype=torch.float32, device=dev)

        @high_precision
        def chain():
            out = a
            for _ in range(reps):
                out = out @ a
            return out

        chain()
        peak_flops = 2.0 * n * n * n * reps / _best_of(chain, dev)
        x = torch.ones(m, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)

        def stream():
            for _ in range(adds):
                torch.add(x, 1.0, out=y)

        stream()
        peak_bytes = 2.0 * 4 * m * adds / _best_of(stream, dev)
        del a, x, y
        if peak_flops > 0 and peak_bytes > 0:
            peaks = {"peak_flops_per_s": peak_flops, "peak_bytes_per_s": peak_bytes,
                     "ridge_flops_per_byte": peak_flops / peak_bytes, "calibrated": True}
    except Exception:  # noqa: BLE001 - a report must never raise
        pass
    _roofline_peaks = peaks
    return peaks


def set_roofline_peaks(flops_per_s: Optional[float] = None, bytes_per_s: Optional[float] = None) -> None:
    """Pin the machine roofline instead of calibrating (both None: the next report calibrates again)."""
    global _roofline_peaks
    if flops_per_s is None and bytes_per_s is None:
        _roofline_peaks = None
        return
    f = float(flops_per_s or 0.0)
    b = float(bytes_per_s or 0.0)
    _roofline_peaks = {"peak_flops_per_s": f, "peak_bytes_per_s": b, "ridge_flops_per_byte": (f / b) if b > 0 else 0.0,
                       "calibrated": bool(f > 0 and b > 0)}


def _roofline_row(analysis: Optional[Dict[str, Any]], device: Optional[Dict[str, Any]], host_mean_s: float,
                  peaks: Dict[str, Any]) -> Dict[str, Any]:
    """One program's counted work joined with its probed device times: achieved
    rates and a bound class, JAX's classes and thresholds. ``unprobed`` without
    device samples; ``host-bound`` when the host dispatch wall is at least
    ``_HOST_BOUND_SHARE`` of the device-inclusive p50; against calibrated peaks
    ``dispatch-bound`` when neither utilization reaches
    ``_DISPATCH_BOUND_UTILIZATION``, else ``compute-bound`` or ``memory-bound``
    by the higher one; without peaks, by the counted work alone."""
    row: Dict[str, Any] = {
        "bound": "unprobed",
        "device_p50_s": 0.0,
        "host_dispatch_mean_s": round(host_mean_s, 9),
        "host_share": 0.0,
        "achieved_flops_per_s": 0.0,
        "achieved_bytes_per_s": 0.0,
        "arithmetic_intensity": 0.0,
        "compute_utilization": 0.0,
        "memory_utilization": 0.0,
        "probes": 0,
    }
    if not device or not device.get("count"):
        return row
    p50 = float(device.get("p50_s", 0.0)) or (float(device.get("sum_s", 0.0)) / max(1, int(device.get("count", 0))))
    if p50 <= 0:
        return row
    row["probes"] = int(device["count"])
    row["device_p50_s"] = round(p50, 9)
    flops = float((analysis or {}).get("flops", 0.0) or 0.0)
    nbytes = float((analysis or {}).get("bytes_accessed", 0.0) or 0.0)
    row["achieved_flops_per_s"] = flops / p50
    row["achieved_bytes_per_s"] = nbytes / p50
    row["arithmetic_intensity"] = (flops / nbytes) if nbytes > 0 else 0.0
    host_share = min(1.0, host_mean_s / p50) if host_mean_s > 0 else 0.0
    row["host_share"] = round(host_share, 4)
    if host_share >= _HOST_BOUND_SHARE:
        row["bound"] = "host-bound"
        return row
    if peaks.get("calibrated"):
        u_c = row["achieved_flops_per_s"] / peaks["peak_flops_per_s"]
        u_m = row["achieved_bytes_per_s"] / peaks["peak_bytes_per_s"]
        row["compute_utilization"] = round(u_c, 6)
        row["memory_utilization"] = round(u_m, 6)
        if max(u_c, u_m) < _DISPATCH_BOUND_UTILIZATION:
            row["bound"] = "dispatch-bound"
        elif u_c >= u_m:
            row["bound"] = "compute-bound"
        else:
            row["bound"] = "memory-bound"
    elif flops == 0 and nbytes == 0:
        row["bound"] = "dispatch-bound"
    elif nbytes == 0:
        row["bound"] = "compute-bound"
    elif flops == 0:
        row["bound"] = "memory-bound"
    else:
        ridge = peaks.get("ridge_flops_per_byte") or 4.0
        row["bound"] = "compute-bound" if row["arithmetic_intensity"] >= ridge else "memory-bound"
    return row


def program_report(analyze: bool = True) -> List[Dict[str, Any]]:
    """The program ledger: one row per cached program, JAX's columns. Kind,
    cache-key digest, acquisition ``hits``, ``donated_runs`` (always 0) and
    ``plain_runs``, first runs of a signature (``compiles``) and their wall
    (``compile_time_s``; ``cache_load_time_s`` for signatures the persistent
    store served), ``compiled_signatures``, the host dispatch wall, the
    probed device-time block (``device``, from the
    ``device-dispatch:<program>`` family) and the autotuner's ``variant``.
    With ``analyze=True`` each row also carries the counted facts
    (:func:`_analyze`) and the ``roofline`` join against
    :func:`roofline_peaks`, calibrated only where some program was probed.
    ``analyze=False`` costs no run and no calibration."""
    device_stats = _telemetry.device_dispatch_stats()
    peaks = roofline_peaks() if (analyze and device_stats) else {"calibrated": False, "ridge_flops_per_byte": 0.0}
    rows: List[Dict[str, Any]] = []
    for exe in list(_PROGRAM_CACHE.values()):
        device = device_stats.get(exe.probe_key)
        row: Dict[str, Any] = {
            "kind": exe.kind,
            "key": exe.key_digest,
            "program": exe.probe_key,
            "hits": exe.hits,
            "donated_runs": exe.donated_runs,
            "plain_runs": exe.plain_runs,
            "compiles": exe.compiles,
            "compile_time_s": round(exe.compile_time_s, 6),
            "cache_load_time_s": round(exe.cache_load_time_s, 6),
            "cache_source": exe.cache_source,
            "compiled_signatures": exe.compiled_signatures(),
            "dispatch_time_s": round(exe.dispatch_time_s, 6),
            "device": device,
            "variant": exe.variant,
        }
        analysis = _analyze(exe) if analyze else None
        row["analysis"] = analysis
        if analyze:
            # the dispatch wall accumulates on the runs after a signature's first only
            dispatch_runs = max(0, exe.runs - exe.compiles)
            host_mean = exe.dispatch_time_s / dispatch_runs if dispatch_runs else 0.0
            row["roofline"] = _roofline_row(analysis, device, host_mean, peaks)
        rows.append(row)
    rows.sort(key=lambda r: r["compile_time_s"], reverse=True)
    return rows


def program_summary() -> Dict[str, Any]:
    """Ledger totals, the ``programs`` block of ``telemetry.snapshot()``: the cached
    programs, their first runs and wall, cache loads, hits and runs."""
    out = {"count": len(_PROGRAM_CACHE), "compiles": 0, "compile_time_s": 0.0, "cache_load_time_s": 0.0, "hits": 0,
           "donated_runs": 0, "plain_runs": 0}
    for exe in _PROGRAM_CACHE.values():
        out["compiles"] += exe.compiles
        out["compile_time_s"] += exe.compile_time_s
        out["cache_load_time_s"] += exe.cache_load_time_s
        out["hits"] += exe.hits
        out["plain_runs"] += exe.plain_runs
    out["compile_time_s"] = round(out["compile_time_s"], 6)
    out["cache_load_time_s"] = round(out["cache_load_time_s"], 6)
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
        owner_label = type(self.owners[0]).__name__ if self.owners else None
        attrs = {"kind": self.kind, "entries": len(self.entries)}
        with _telemetry.timed("engine-flush", owner_label, "defer", attrs, detail=owner_label):
            try:
                fn(self)
            finally:
                self._flushing = False
                self.release()  # a no-op where the flush already released


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
